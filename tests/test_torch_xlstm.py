"""The xLSTM family (xlstm-350m-smoke) in the port, on the CPU against the
reference on the same weights (``bridge.params_from_jax``).

* The config equals the reference's field by field, published and smoke.
* ``mlstm_decode`` / ``mlstm_forward`` (two chunks, with and without an
  incoming state) and ``slstm_decode`` / ``slstm_forward`` match the
  reference's on the same inputs: outputs within 2e-2 of max(1, |ref|)
  (bf16, one ulp at |y| < 4 is 2^-7 ~ 7.8e-3, and the port contracts the
  three-operand einsums in another order); fp32 states within 1e-5 of
  max(1, |ref|) after a decode step from the same state, and within 1e-3
  after a forward: about ten of 65,536 bf16 projections (up, q, k, v)
  round one ulp (2^-8) apart from the reference's, and those enter the
  states unchanged, summed over the sequence.  The port's own chunked mLSTM equals its recurrence, and
  its sLSTM forward its decode, within the reference's own 2e-2
  (``tests/test_model_units.py``).
* ``init_slstm_state`` gives four distinct tensors (the port stores state
  rows in place, so shared storage would alias them).
* ``decode_step`` logits within 2e-2 and exit entropies within 5e-3,
  greedy equal or tied; segments compose to ``decode_step`` bit for bit;
  exited rows keep their hidden state and every state row.
* ``Model.forward`` matches the reference's (logits within 4e-2, as the
  other untied-head configs).
* The paged and contiguous schedulers give the reference's greedy tokens
  under the tie rule, with slot reuse; an xLSTM paged arena has no pools
  and no prefix cache, and admission zeroes its state rows.
* Migration mid-flight continues bit for bit (raw), and the int8 snapshot
  equals the reference's bit for bit on the same rows.
* Async windows equal the sync poll bit for bit.
* Pools, pairs, the cluster and the engine: ``test_torch_xlstm_serving.py``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_config
from repro.models import Model as RefModel
from repro.models import attention as ref_attn
from repro.models import xlstm as ref_xlstm
from repro.serving import ContinuousBatchScheduler as RefScheduler
from repro.serving import Request as RefRequest
from repro.serving import SchedulerConfig as RefConfig
from repro_torch.bridge import params_from_jax
from repro_torch.configs import get_config
from repro_torch.models import Model
from repro_torch.models import xlstm
from repro_torch.models.attention import PagedKV
from repro_torch.models.common import tree_leaves
from repro_torch.serving import (ContinuousBatchScheduler, Request,
                                 SchedulerConfig, SlotSnapshot)

ARCH = "xlstm-350m-smoke"
GRANITE = "granite-3-2b-smoke"
OUT_TOL = 2e-2      # of max(1, |ref|): bf16 outputs
STATE_TOL = 1e-5    # of max(1, |ref|): fp32 states after a decode step
FWD_STATE_TOL = 1e-3   # of max(1, |ref|): fp32 states after a forward
OWN_TOL = 2e-2      # the reference's own chunked-vs-recurrent tolerance
LOGIT_ATOL = 2e-2
FWD_ATOL = 4e-2
ENT_ATOL = 5e-3
TIE = 1e-2
D = 256             # smoke d_model; d_in 512, 4 heads of P 128


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread while this module runs: its tensors are small,
    and parallel test workers share the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _pair(arch, seed):
    rm = RefModel(ref_config(arch))
    rp = rm.init(jax.random.PRNGKey(seed))
    tm = Model(get_config(arch), device="cpu")
    return rm, rp, tm, params_from_jax(jax.tree.map(np.asarray, rp))


@pytest.fixture(scope="module")
def xl():
    return _pair(ARCH, 0)


@pytest.fixture(scope="module")
def granite():
    return _pair(GRANITE, 1)


def _close(got, want, tol):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    err = np.abs(got - want) / np.maximum(1.0, np.abs(want))
    assert np.isfinite(got).all() and err.max() <= tol, err.max()


def _f32(a):
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def _bf16(a):
    """A numpy float array as the same bf16 values in both frameworks."""
    j = jnp.asarray(a, jnp.bfloat16)
    return j, torch.from_numpy(np.array(_f32(j))).bfloat16()


def _tie_or_equal(rm, rp, prompt, got, want):
    """Equal streams, or a first difference at a top-2 tie of the
    reference's replay logits: both tokens within 1e-2 of the top logit.
    Returns whether they were equal."""
    got, want = [int(t) for t in got], [int(t) for t in want]
    if got == want:
        return True
    seq = np.concatenate([prompt, np.asarray(want[:-1], np.int32)])
    logits, _ = rm.prefill(rp, {"tokens": jnp.asarray(seq)[None]})
    logs = np.asarray(logits[0, prompt.size - 1:])
    k = next(i for i, (a, b) in enumerate(zip(got, want)) if a != b)
    top = float(logs[k].max())
    gaps = [top - float(logs[k][t]) for t in (got[k], want[k])]
    assert max(gaps) < TIE, f"token {k}: ref logit gaps {gaps}"
    return False


def _cfg(cls, **kw):
    base = dict(n_slots=2, max_len=64, prefill_chunk=8, page_size=16,
                exit_threshold=0.5)
    base.update(kw)
    return cls(**base)


def _serve(sched, req_cls, prompts, max_new, **kw):
    reqs = [req_cls(tokens=np.asarray(p, np.int32),
                    max_new=max_new[i] if isinstance(max_new, list)
                    else max_new, req_id=i, **kw)
            for i, p in enumerate(prompts)]
    for r in reqs:
        sched.submit(r)
    sched.run()
    return [list(r.out_tokens) for r in reqs]


def _prompts(seed, lens, vocab=1024):
    rs = np.random.RandomState(seed)
    return [rs.randint(0, vocab, n).astype(np.int32) for n in lens]


# ---------------------------------------------------------------------------
# config and cells
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("smoke", [False, True], ids=["full", "smoke"])
def test_config_fields_equal_reference(smoke):
    name = "xlstm-350m" + ("-smoke" if smoke else "")
    assert dataclasses.asdict(get_config(name)) \
        == dataclasses.asdict(ref_config(name))
    cfg = get_config(name)
    assert cfg.family == "ssm" and cfg.rope == "none"
    m = Model(cfg, device="cpu")
    assert m.plan == RefModel(ref_config(name)).plan
    assert not m.all_cache_paged()
    _, d_in, h, p = xlstm._dims(cfg)
    if smoke:
        assert m.scan_block_kinds() == ["mlstm", "slstm"]
        assert (d_in, h, p, cfg.ssm.chunk_size) == (512, 4, 128, 32)
    else:
        assert (d_in, h, p) == (2048, 4, 512) and m.n_exits == 2
        assert m.scan_block_kinds().count("slstm") == 4


def _cell(pair, kind):
    """Layer 0 of the first block of ``kind``: (reference, port) params."""
    rm, rp, tm, tp = pair
    bi = tm.scan_block_kinds().index(kind)
    return (jax.tree.map(lambda a: a[0], rp["blocks"][bi][kind]),
            {k: v[0] for k, v in tp["blocks"][bi][kind].items()})


def test_mlstm_decode_matches_reference(xl):
    """Four steps of the O(1) update from a random state: outputs, C and
    n (both take the reference's state each step: the step's own
    arithmetic, not the drift of bf16 projections an ulp apart)."""
    rm, _, tm, _ = xl
    lr, lt = _cell(xl, "mlstm")
    rs = np.random.RandomState(1)
    sr = (jnp.asarray(0.1 * rs.randn(3, 4, 128, 128).astype(np.float32)),
          jnp.asarray(rs.randn(3, 4, 128).astype(np.float32)))
    for _ in range(4):
        st = tuple(torch.from_numpy(np.array(a)) for a in sr)
        xr, xt = _bf16(rs.randn(3, 1, D))
        yr, sr = ref_xlstm.mlstm_decode(rm.cfg, lr, xr, sr)
        yt, st = xlstm.mlstm_decode(tm.cfg, lt, xt, st)
        _close(yt.float().numpy(), _f32(yr), OUT_TOL)
        for a, b in zip(st, sr):
            _close(a.numpy(), np.asarray(b), STATE_TOL)


@pytest.mark.parametrize("carried", [False, True], ids=["zero", "carried"])
def test_mlstm_forward_matches_reference(xl, carried):
    """The chunk-parallel dual over 2 x 64 tokens (two chunks of 32), with
    a zero or a random incoming state: outputs and the final C and n.  A
    sequence that is not a multiple of the chunk is refused."""
    rm, _, tm, _ = xl
    lr, lt = _cell(xl, "mlstm")
    rs = np.random.RandomState(2)
    xr, xt = _bf16(rs.randn(2, 64, D))
    sr = st = None
    if carried:
        c = 0.1 * rs.randn(2, 4, 128, 128).astype(np.float32)
        n = rs.randn(2, 4, 128).astype(np.float32)
        sr = (jnp.asarray(c), jnp.asarray(n))
        st = (torch.from_numpy(c), torch.from_numpy(n))
    yr, (cr, nr) = ref_xlstm.mlstm_forward(rm.cfg, lr, xr, sr)
    yt, (ct, nt) = xlstm.mlstm_forward(tm.cfg, lt, xt, st)
    _close(yt.float().numpy(), _f32(yr), OUT_TOL)
    _close(ct.numpy(), np.asarray(cr), FWD_STATE_TOL)
    _close(nt.numpy(), np.asarray(nr), FWD_STATE_TOL)
    with pytest.raises(AssertionError, match="not divisible"):
        xlstm.mlstm_forward(tm.cfg, lt, xt[:, :40])


def test_mlstm_chunked_matches_recurrent(xl):
    """The port's chunked mLSTM against its own token-by-token decode on
    2 x 64 tokens: outputs and the final matrix memory C."""
    _, _, tm, _ = xl
    _, lt = _cell(xl, "mlstm")
    x = (0.1 * torch.randn(2, 64, D,
                           generator=torch.Generator().manual_seed(1)))
    y_chunk, (c_chunk, _) = xlstm.mlstm_forward(tm.cfg, lt, x)
    st = xlstm.init_mlstm_state(tm.cfg, 2)
    ys = []
    for t in range(64):
        y1, st = xlstm.mlstm_decode(tm.cfg, lt, x[:, t:t + 1], st)
        ys.append(y1)
    np.testing.assert_allclose(y_chunk.numpy(), torch.cat(ys, 1).numpy(),
                               rtol=OWN_TOL, atol=OWN_TOL)
    np.testing.assert_allclose(c_chunk.numpy(), st[0].numpy(),
                               rtol=OWN_TOL, atol=OWN_TOL)


def test_slstm_matches_reference(xl):
    """``slstm_decode`` four steps from a random state, and
    ``slstm_forward`` over 2 x 24 tokens: outputs and the four state
    tensors."""
    rm, _, tm, _ = xl
    lr, lt = _cell(xl, "slstm")
    rs = np.random.RandomState(3)
    sr = tuple(jnp.asarray(a) for a in (
        rs.randn(3, 4, 128).astype(np.float32),
        np.abs(rs.randn(3, 4, 128)).astype(np.float32) + 1.0,
        0.5 * rs.randn(3, 4, 128).astype(np.float32),
        rs.randn(3, 4, 128).astype(np.float32)))
    for _ in range(4):
        st = tuple(torch.from_numpy(np.array(a)) for a in sr)
        xr, xt = _bf16(rs.randn(3, 1, D))
        yr, sr = ref_xlstm.slstm_decode(rm.cfg, lr, xr, sr)
        yt, st = xlstm.slstm_decode(tm.cfg, lt, xt, st)
        _close(yt.float().numpy(), _f32(yr), OUT_TOL)
        for a, b in zip(st, sr):
            _close(a.numpy(), np.asarray(b), STATE_TOL)
    xr, xt = _bf16(rs.randn(2, 24, D))
    yr, sr = ref_xlstm.slstm_forward(rm.cfg, lr, xr)
    yt, st = xlstm.slstm_forward(tm.cfg, lt, xt)
    _close(yt.float().numpy(), _f32(yr), OUT_TOL)
    for a, b in zip(st, sr):
        _close(a.numpy(), np.asarray(b), FWD_STATE_TOL)


def test_slstm_forward_matches_decode(xl):
    """The port's own sLSTM forward against its decode, 2 x 16 tokens:
    outputs and the final state."""
    _, _, tm, _ = xl
    _, lt = _cell(xl, "slstm")
    x = (0.1 * torch.randn(2, 16, D,
                           generator=torch.Generator().manual_seed(1)))
    y_fwd, s_fwd = xlstm.slstm_forward(tm.cfg, lt, x)
    st = xlstm.init_slstm_state(tm.cfg, 2)
    ys = []
    for t in range(16):
        y1, st = xlstm.slstm_decode(tm.cfg, lt, x[:, t:t + 1], st)
        ys.append(y1)
    np.testing.assert_allclose(y_fwd.numpy(), torch.cat(ys, 1).numpy(),
                               rtol=OWN_TOL, atol=OWN_TOL)
    for a, b in zip(s_fwd, st):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=OWN_TOL,
                                   atol=OWN_TOL)


def test_slstm_state_tensors_are_distinct(xl):
    """The four sLSTM state tensors, and the cache leaves made from them,
    live in four distinct storages: an in-place store into ``c`` leaves
    ``n``, ``h`` and ``m`` alone."""
    _, _, tm, _ = xl
    st = xlstm.init_slstm_state(tm.cfg, 2)
    assert len({t.untyped_storage().data_ptr() for t in st}) == 4
    cache = tm.init_decode_cache(2, 16)["blocks"][1]
    assert len({t.untyped_storage().data_ptr() for t in cache}) == 4
    cache[0].fill_(1.0)
    assert not any(t.any() for t in cache[1:])


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------

def _decode_caches(rm, tm, arena, b):
    if arena == "paged":
        tbl = np.random.RandomState(0).permutation(2 * b).reshape(
            b, 2).astype(np.int32)
        return (rm.init_decode_cache_paged(b, 2 * b, 16),
                tm.init_decode_cache_paged(b, 2 * b, 16), tbl)
    return rm.init_decode_cache(b, 32), tm.init_decode_cache(b, 32), None


@pytest.mark.parametrize("arena", ["contiguous", "paged"])
def test_decode_step_matches_reference(xl, arena):
    """Eight decode steps at ragged per-slot positions: logits, exit
    entropies, greedy choices, and every state row non-zero after."""
    rm, rp, tm, tp = xl
    b = 3
    rc, tc, tbl = _decode_caches(rm, tm, arena, b)
    pos = np.array([0, 3, 9], np.int32)
    rs = np.random.RandomState(1)
    for _ in range(8):
        toks = rs.randint(0, 1024, (b, 1)).astype(np.int32)
        kw_r, kw_t = {}, {}
        if tbl is not None:
            mask = np.ones(b, bool)
            kw_r["paged"] = ref_attn.PagedKV(jnp.asarray(tbl),
                                             jnp.asarray(mask))
            kw_t["paged"] = PagedKV(torch.from_numpy(tbl),
                                    torch.from_numpy(mask))
        rl, ree, rc = rm.decode_step(rp, rc, jnp.asarray(toks),
                                     jnp.asarray(pos), **kw_r)
        tl, tee, tc = tm.decode_step(tp, tc, torch.from_numpy(toks).long(),
                                     torch.from_numpy(pos), **kw_t)
        rl = np.asarray(rl)
        np.testing.assert_allclose(tl.numpy(), rl, rtol=0, atol=LOGIT_ATOL)
        np.testing.assert_allclose(tee.numpy(), np.asarray(ree), rtol=0,
                                   atol=ENT_ATOL)
        for g, w in zip(tl.numpy(), rl):
            a, c = int(g.argmax()), int(w.argmax())
            assert a == c or 0.0 <= w[c] - w[a] < TIE
        pos = pos + 1
    for leaf, want in zip(tree_leaves(tc), jax.tree.leaves(rc)):
        assert leaf.shape == want.shape and leaf.dtype == torch.float32
        assert bool((leaf.reshape(leaf.shape[0], b, -1).abs().amax(-1)
                     > 0).all())


@pytest.mark.parametrize("arena", ["contiguous", "paged"])
def test_segments_compose_to_decode_step(xl, arena):
    """Every row alive: the segment chain is ``decode_step`` bit for bit,
    logits and every cache leaf."""
    rm, _, tm, tp = xl
    b = 3
    caches = [_decode_caches(rm, tm, arena, b)[1:] for _ in range(2)]
    alive = torch.ones(b, dtype=torch.bool)
    pos = torch.tensor([0, 2, 5], dtype=torch.int32)
    rs = np.random.RandomState(3)
    for _ in range(4):
        toks = torch.from_numpy(rs.randint(0, 1024, (b, 1))).long()
        (c1, tbl), (c2, _) = caches
        paged = None if tbl is None else PagedKV(torch.from_numpy(tbl),
                                                 alive)
        want, _, _ = tm.decode_step(tp, c1, toks, pos, paged=paged)
        x = tm.embed_decode_tokens(tp, toks)
        for seg in tm.decode_segments:
            x, _ = tm.decode_segment(tp, c2, x, seg, pos, alive, paged=paged)
        got = tm.finalize_decode(tp, x)
        assert torch.equal(got, want)
        for a, c in zip(tree_leaves(c1), tree_leaves(c2)):
            assert torch.equal(a, c)
        pos = pos + 1


@pytest.mark.parametrize("arena", ["contiguous", "paged"])
def test_exited_rows_freeze_hidden_and_state_rows(xl, arena):
    """A row that is not alive in the second segment (the sLSTM block)
    passes its hidden state through and keeps its four sLSTM state rows;
    alive rows update theirs, and the mLSTM block is untouched."""
    rm, _, tm, tp = xl
    b = 3
    cache, tbl = _decode_caches(rm, tm, arena, b)[1:]
    pos = torch.tensor([1, 4, 6], dtype=torch.int32)
    ones = torch.ones(b, dtype=torch.bool)
    paged = None if tbl is None else PagedKV(torch.from_numpy(tbl), ones)
    tm.decode_step(tp, cache, torch.tensor([[5], [7], [9]]), pos,
                   paged=paged)                   # non-zero rows
    before = [tuple(t.clone() for t in c) for c in cache["blocks"]]
    alive = torch.tensor([True, False, True])
    seg = tm.decode_segments[1]
    assert [st[1:] for st in seg.steps] == [("slstm", 1)]
    x_in = torch.randn(b, 1, D,
                       generator=torch.Generator().manual_seed(0)).bfloat16()
    paged = None if tbl is None else PagedKV(torch.from_numpy(tbl), alive)
    x, _ = tm.decode_segment(tp, cache, x_in, seg, pos + 1, alive,
                             paged=paged)
    assert torch.equal(x[1], x_in[1]) and not torch.equal(x[0], x_in[0])
    for a, c in zip(before[0], cache["blocks"][0]):
        assert torch.equal(a, c)
    for a, c in zip(before[1], cache["blocks"][1]):  # stacked: batch axis 1
        assert torch.equal(a[:, 1], c[:, 1])
        assert not torch.equal(a[:, 0], c[:, 0])
        assert not torch.equal(a[:, 2], c[:, 2])


def test_forward_matches_reference(xl):
    """``Model.forward`` on 2 x 64 tokens (the mLSTM in two chunks, the
    sLSTM stepping 64 times): logits and the exit logits; and the forward
    against the port's own decode replay."""
    rm, rp, tm, tp = xl
    toks = np.random.RandomState(3).randint(0, 1024, (2, 64)).astype(
        np.int32)
    want = rm.forward(rp, {"tokens": jnp.asarray(toks)})
    got = tm.forward(tp, {"tokens": torch.from_numpy(toks).long()})
    np.testing.assert_allclose(got.logits.numpy(), np.asarray(want.logits),
                               rtol=0, atol=FWD_ATOL)
    assert len(got.exit_logits) == len(want.exit_logits) == 1
    np.testing.assert_allclose(got.exit_logits[0].numpy(),
                               np.asarray(want.exit_logits[0]), rtol=0,
                               atol=FWD_ATOL)
    replay, _ = tm.prefill(tp, {"tokens": torch.from_numpy(toks).long()})
    np.testing.assert_allclose(got.logits.numpy(), replay.numpy(), rtol=0,
                               atol=FWD_ATOL)


# ---------------------------------------------------------------------------
# the scheduler's state arenas
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("segmented", [True, False], ids=["seg", "mono"])
@pytest.mark.parametrize("paged", [False, True], ids=["contig", "paged"])
def test_scheduler_greedy_matches_reference(xl, paged, segmented):
    """Five prompts through two slots (slots reused), segmented or
    monolithic: the reference scheduler's greedy tokens under the tie
    rule, equal exit counts and served tokens."""
    rm, rp, tm, tp = xl
    prompts = _prompts(4, (5, 20, 33, 9, 14))
    kw = dict(paged=paged, segmented=segmented)
    s = ContinuousBatchScheduler(tm, tp, _cfg(SchedulerConfig, **kw),
                                 device="cpu")
    ref = RefScheduler(rm, rp, _cfg(RefConfig, **kw))
    got = _serve(s, Request, prompts, 6)
    want = _serve(ref, RefRequest, prompts, 6)
    for p, g, w in zip(prompts, got, want):
        assert len(g) == 6
        _tie_or_equal(rm, rp, p, g, w)
    assert s.prefix_cache is None and ref.prefix_cache is None
    assert s.tokens_served == ref.tokens_served
    assert s.flush_counters().tolist() == ref.flush_counters().tolist()
    if paged:
        assert s.page_alloc.free_count == s.page_alloc.n_pages


def test_no_pools_no_prefix_cache_and_admission_zeroes_state(xl, granite):
    """An xLSTM paged arena holds no pool at all, only the block table and
    state rows, and runs without the prefix cache (a granite one keeps
    it); three requests through two slots: admitting into a reused slot
    zeroes its state rows in place before the replay writes them."""
    _, _, tm, tp = xl
    _, _, gm, gp = granite
    kw = dict(paged=True)
    assert ContinuousBatchScheduler(gm, gp, _cfg(SchedulerConfig, **kw),
                                    device="cpu").prefix_cache is not None
    s = ContinuousBatchScheduler(tm, tp, _cfg(SchedulerConfig, **kw),
                                 device="cpu")
    states = tree_leaves(s.cache)
    assert len(states) == 6 and all(t.shape[1] == 2 for t in states)
    _serve(s, Request, _prompts(5, (7, 9)), 4)
    ptrs = [t.data_ptr() for t in states]
    assert all(t[:, 0].abs().max() > 0 for t in states)
    s.submit(Request(tokens=_prompts(6, (11,))[0], max_new=3))
    admitted = s._begin_admit()
    assert admitted and admitted[0].slot == 0
    assert all(not t[:, 0].any() and t[:, 1].abs().max() > 0
               for t in states)
    assert [t.data_ptr() for t in tree_leaves(s.cache)] == ptrs
    s.run()
    assert admitted[0].done and len(admitted[0].out_tokens) == 3
    assert s.prefix_hit_tokens == 0


def _mid_flight(tm, tp, prompt, paged, n_slots=2, polls=5, max_new=10):
    s = ContinuousBatchScheduler(tm, tp, _cfg(SchedulerConfig, paged=paged,
                                              n_slots=n_slots),
                                 device="cpu")
    r = Request(tokens=prompt.copy(), max_new=max_new)
    s.submit(r)
    for _ in range(polls):
        s.poll()
    assert not r.done and s.active[r.slot]
    return s, r


@pytest.mark.parametrize("paged", [False, True], ids=["contig", "paged"])
def test_raw_migration_continues_bit_identically(xl, paged):
    """Exported mid-flight (every leaf a state row, shipped whole),
    released, imported into a three-slot arena beside a neighbour: the
    greedy continuation equals the unmigrated run's."""
    _, _, tm, tp = xl
    prompt = _prompts(7, (9,))[0]
    ded = ContinuousBatchScheduler(tm, tp, _cfg(SchedulerConfig,
                                                paged=paged), device="cpu")
    want = _serve(ded, Request, [prompt], 10)[0]
    src, req = _mid_flight(tm, tp, prompt, paged)
    snap = src.export_slot(req.slot)
    assert src._row_axes_flat == [-1] * 6
    assert snap.payload_bytes == src.slot_payload_bytes(req.slot) == sum(
        int(np.prod(sh)) * 4 for sh, _ in src._row_struct_flat)
    src.release_slot(req.slot)
    src.submit(Request(tokens=_prompts(8, (6,))[0], max_new=4))
    src.run()                           # the slot's next occupant
    dst = ContinuousBatchScheduler(tm, tp, _cfg(SchedulerConfig, paged=paged,
                                                n_slots=3), device="cpu")
    dst.submit(Request(tokens=_prompts(9, (5,))[0], max_new=4))
    dst.poll()
    dst.import_slot(snap)
    dst.run()
    assert req.done and req.out_tokens == want


def _to_torch(a):
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def _bits(t):
    view = {torch.bfloat16: torch.int16, torch.float32: torch.int32}
    return (t.view(view[t.dtype]) if t.dtype in view else t).numpy()


@pytest.mark.parametrize("paged", [False, True], ids=["contig", "paged"])
def test_int8_snapshot_matches_reference_bitwise(xl, paged):
    """The reference's raw snapshot imported into the port: the port's
    compressed export equals the reference's ``compress=True`` export bit
    for bit (the mLSTM's C in rows of P, every fp32 leaf quantized);
    dequantized rows sit within amax / 127 of the raw ones, and the int8
    payload continues decoding elsewhere."""
    rm, rp, tm, tp = xl
    prompt = _prompts(10, (9,))[0]
    ref = RefScheduler(rm, rp, _cfg(RefConfig, paged=paged))
    r = RefRequest(tokens=prompt.copy(), max_new=10)
    ref.submit(r)
    for _ in range(5):
        ref.poll()
    raw = ref.export_slot(r.slot)
    want = ref.export_slot(r.slot, compress=True)
    port = ContinuousBatchScheduler(tm, tp, _cfg(SchedulerConfig,
                                                 paged=paged), device="cpu")
    req = Request(tokens=prompt.copy(), max_new=10, req_id=r.req_id,
                  out_tokens=list(r.out_tokens))
    slot = port.import_slot(SlotSnapshot(
        req=req, position=raw.position, current_tok=raw.current_tok,
        steps_taken=raw.steps_taken, compressed=False,
        payload=[_to_torch(a) for a in raw.payload],
        scales=[None] * len(raw.payload), payload_bytes=raw.payload_bytes,
        paged=paged, page_skip=raw.page_skip, page_used=raw.page_used,
        page_digests=list(raw.page_digests)))
    same = port.export_slot(slot)
    for a, b in zip(same.payload, raw.payload):
        np.testing.assert_array_equal(_bits(a), _bits(_to_torch(b)))
    got = port.export_slot(slot, compress=True)
    assert got.payload_bytes == want.payload_bytes
    assert got.payload[0].shape == (1, 4, 128, 128)    # C: rows of P
    for q, s, wq, ws, a in zip(got.payload, got.scales, want.payload,
                               want.scales, same.payload):
        np.testing.assert_array_equal(q.numpy(), np.asarray(wq))
        np.testing.assert_array_equal(_bits(s), _bits(_to_torch(ws)))
        x = q.float() * s
        amax = a.float().abs().amax(-1, keepdim=True)
        assert bool(((x - a.float()).abs() <= amax / 127.0 + 1e-6).all())
    port.release_slot(slot)
    dst = ContinuousBatchScheduler(tm, tp, _cfg(SchedulerConfig, paged=paged,
                                                n_slots=3), device="cpu")
    dst.import_slot(got)
    dst.run()
    assert got.req.done and len(got.req.out_tokens) == 10


@pytest.mark.parametrize("paged", [False, True], ids=["contig", "paged"])
def test_async_windows_equal_sync_poll(xl, paged):
    """Six requests through three slots, max_new 3 to 11, windows of 4:
    rows finish mid-window, slots are reused and their state rows reset
    (paged) or merged (contiguous); tokens equal the sync monolithic
    poll's bit for bit, with one window build."""
    _, _, tm, tp = xl
    prompts = _prompts(11, (5, 12, 7, 20, 3, 9))
    max_new = [3, 11, 6, 8, 5, 10]
    outs = []
    for async_decode in (False, True):
        s = ContinuousBatchScheduler(tm, tp, _cfg(
            SchedulerConfig, n_slots=3, paged=paged, segmented=False,
            async_decode=async_decode, readback_interval=4), device="cpu")
        outs.append(_serve(s, Request, prompts, max_new))
    assert outs[0] == outs[1]
    assert s.jit_cache_sizes() == {"decode_window": 1}
