"""The hybrid Mamba2 family (zamba2-1.2b-smoke) in the port, on the CPU
against the reference on the same weights (``bridge.params_from_jax``).

* The config equals the reference's field by field, published and smoke.
* ``mamba2_decode`` / ``mamba2_forward`` match the reference's on the same
  inputs: outputs within 2e-2 of max(1, |ref|) (bf16, one ulp at |y| < 4
  is 2^-7 ~ 7.8e-3 and the port contracts the three-operand einsums in
  another order), fp32 states within 1e-5 of max(1, |ref|).
* ``decode_step`` logits within 2e-2 and exit entropies within 5e-3, greedy
  equal or tied; segments compose to ``decode_step`` bit for bit at
  threshold 0; exited rows keep their hidden state and their state rows.
* The paged and contiguous schedulers give the reference's greedy tokens
  under the tie rule, with slot reuse; a hybrid arena has no prefix cache
  and admission zeroes its state rows.
* Migration mid-flight continues bit for bit (raw), and the int8 snapshot
  equals the reference's bit for bit on the same rows.
* Async windows equal the sync poll bit for bit; sampled sync and async
  draws agree when their ticks align.
* Pools, pairs, the cluster and the engine: ``test_torch_hybrid_serving.py``.
* ``Model.forward`` matches the reference's (logits within 4e-2, as the
  other untied-head configs).
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
from repro.models import ssm as ref_ssm
from repro.serving import ContinuousBatchScheduler as RefScheduler
from repro.serving import Request as RefRequest
from repro.serving import SchedulerConfig as RefConfig
from repro_torch.bridge import params_from_jax
from repro_torch.configs import get_config
from repro_torch.models import Model
from repro_torch.models import ssm
from repro_torch.models.attention import PagedKV
from repro_torch.serving import (ContinuousBatchScheduler, Request,
                                 SchedulerConfig, SlotSnapshot)

ARCH = "zamba2-1.2b-smoke"
DRAFT = "granite-3-2b-smoke"
OUT_TOL = 2e-2      # of max(1, |ref|): bf16 outputs
STATE_TOL = 1e-5    # of max(1, |ref|): fp32 states
LOGIT_ATOL = 2e-2
FWD_ATOL = 4e-2
ENT_ATOL = 5e-3
TIE = 1e-2


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
def hybrid():
    return _pair(ARCH, 0)


@pytest.fixture(scope="module")
def granite():
    return _pair(DRAFT, 1)


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
    reference's replay logits: both tokens within 1e-2 of the top logit
    (the reference's own batched run may take either side of such a tie).
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
# config, layer and model
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("smoke", [False, True], ids=["full", "smoke"])
def test_config_fields_equal_reference(smoke):
    name = "zamba2-1.2b" + ("-smoke" if smoke else "")
    assert dataclasses.asdict(get_config(name)) \
        == dataclasses.asdict(ref_config(name))
    cfg = get_config(name)
    assert cfg.family == "hybrid" and not cfg.tie_embeddings
    if not smoke:
        m = Model(cfg, device="cpu")
        assert [s[1] for s in m.plan if s[0] == "shared_attn"] \
            == list(range(6))
        assert m.n_exits == 2 and not m.all_cache_paged()


def _mixer(rm, rp, tm, tp):
    return (jax.tree.map(lambda a: a[0], rp["blocks"][0]["mamba"]),
            {k: v[0] for k, v in tp["blocks"][0]["mamba"].items()})


def test_mamba2_decode_matches_reference(hybrid):
    """Four steps of the O(1) update from a random state and conv window:
    outputs, states and windows."""
    rm, rp, tm, tp = hybrid
    lr, lt = _mixer(*hybrid)
    rs = np.random.RandomState(1)
    st = rs.randn(3, 16, 32, 16).astype(np.float32)
    cr, _ = _bf16(rs.randn(3, 3, 544))
    sr = jnp.asarray(st)
    for _ in range(4):
        # both take the reference's state and window: the step's own
        # arithmetic, not the drift of bf16 projections an ulp apart
        stt = torch.from_numpy(np.array(sr))
        ct = torch.from_numpy(np.array(_f32(cr))).bfloat16()
        xr, xt = _bf16(rs.randn(3, 1, 256))
        yr, sr, cr = ref_ssm.mamba2_decode(rm.cfg, lr, xr, sr, cr)
        yt, stt, ct = ssm.mamba2_decode(tm.cfg, lt, xt, stt, ct)
        _close(yt.float().numpy(), _f32(yr), OUT_TOL)
        _close(stt.numpy(), np.asarray(sr), STATE_TOL)
        _close(ct.float().numpy(), _f32(cr), OUT_TOL)


def test_mamba2_forward_matches_reference(hybrid):
    """The chunked SSD over 2 x 96 tokens (three chunks of 32), and its
    final state against the port's own token-by-token decode."""
    rm, rp, tm, tp = hybrid
    lr, lt = _mixer(*hybrid)
    xr, xt = _bf16(np.random.RandomState(2).randn(2, 96, 256))
    yr, sr = ref_ssm.mamba2_forward(rm.cfg, lr, xr)
    yt, stt = ssm.mamba2_forward(tm.cfg, lt, xt)
    _close(yt.float().numpy(), _f32(yr), OUT_TOL)
    _close(stt.numpy(), np.asarray(sr), STATE_TOL)
    s, c = ssm.init_mamba2_state(tm.cfg, 2)
    for t in range(96):
        _, s, c = ssm.mamba2_decode(tm.cfg, lt, xt[:, t:t + 1], s, c)
    _close(s.numpy(), stt.numpy(), STATE_TOL)
    with pytest.raises(AssertionError, match="not divisible"):
        ssm.mamba2_forward(tm.cfg, lt, xt[:, :40])


def _decode_caches(rm, tm, arena, b):
    if arena == "paged":
        tbl = np.random.RandomState(0).permutation(2 * b).reshape(
            b, 2).astype(np.int32)
        return (rm.init_decode_cache_paged(b, 2 * b, 16),
                tm.init_decode_cache_paged(b, 2 * b, 16), tbl)
    return rm.init_decode_cache(b, 32), tm.init_decode_cache(b, 32), None


@pytest.mark.parametrize("arena", ["contiguous", "paged"])
def test_decode_step_matches_reference(hybrid, arena):
    """Eight decode steps at ragged per-slot positions: logits, exit
    entropies, greedy choices and the state rows."""
    rm, rp, tm, tp = hybrid
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
    assert all(tb[0].abs().min(dim=-1).values.max() > 0
               for tb in tc["blocks"])


@pytest.mark.parametrize("arena", ["contiguous", "paged"])
def test_segments_compose_to_decode_step(hybrid, arena):
    """At threshold 0 (every row alive) the segment chain, shared-attention
    sites included, is ``decode_step`` bit for bit: logits and every
    cache leaf."""
    _, _, tm, tp = hybrid
    b = 3
    caches = [_decode_caches(RefModel(ref_config(ARCH)), tm, arena, b)[1:]
              for _ in range(2)]
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
        for a, c in zip(_leaves(c1), _leaves(c2)):
            assert torch.equal(a, c)
        pos = pos + 1


def _leaves(cache):
    from repro_torch.models.common import tree_leaves
    return tree_leaves(cache)


@pytest.mark.parametrize("arena", ["contiguous", "paged"])
def test_exited_rows_freeze_hidden_and_state_rows(hybrid, arena):
    """A row that is not alive in a segment passes its hidden state
    through and keeps its mamba state rows and its shared-attention K/V
    (contiguous row, or its page of the pool); alive rows update theirs,
    and the other segment's leaves stay as they were."""
    _, _, tm, tp = hybrid
    b = 3
    cache, tbl = _decode_caches(RefModel(ref_config(ARCH)), tm, arena, b)[1:]
    pos = torch.tensor([1, 4, 6], dtype=torch.int32)
    ones = torch.ones(b, dtype=torch.bool)
    paged = None if tbl is None else PagedKV(torch.from_numpy(tbl), ones)
    tm.decode_step(tp, cache, torch.tensor([[5], [7], [9]]), pos,
                   paged=paged)                   # non-zero rows
    before = {"blocks": [tuple(t.clone() for t in c)
                         for c in cache["blocks"]],
              "shared_attn": [tuple(t.clone() for t in c)
                              for c in cache["shared_attn"]]}
    alive = torch.tensor([True, False, True])
    seg = tm.decode_segments[1]
    x_in = torch.randn(b, 1, tm.cfg.d_model,
                       generator=torch.Generator().manual_seed(0)).bfloat16()
    paged = None if tbl is None else PagedKV(torch.from_numpy(tbl), alive)
    x, _ = tm.decode_segment(tp, cache, x_in, seg, pos + 1, alive,
                             paged=paged)
    assert torch.equal(x[1], x_in[1]) and not torch.equal(x[0], x_in[0])
    touched = {st[0] + str(st[-1]) for st in seg.steps}
    assert touched == {"scan1", "shared_attn1"}
    for kind in ("blocks", "shared_attn"):
        for i, (old, new) in enumerate(zip(before[kind], cache[kind])):
            for a, c in zip(old, new):
                if kind + str(i) not in {"blocks1", "shared_attn1"}:
                    assert torch.equal(a, c)
                elif kind == "blocks":       # stacked: batch axis 1
                    assert torch.equal(a[:, 1], c[:, 1])
                    assert not torch.equal(a[:, 0], c[:, 0])
                elif tbl is None:            # contiguous K/V rows
                    assert torch.equal(a[1], c[1])
                    assert not torch.equal(a[0], c[0])
                else:                        # pools: the rows' pages
                    page = tbl[:, int(pos[1] + 1) // 16]
                    assert torch.equal(a[page[1]], c[page[1]])
                    assert not torch.equal(a[page[0]], c[page[0]])


def test_forward_matches_reference(hybrid):
    """``Model.forward`` on 2 x 64 tokens (the SSD in two chunks, flash's
    plain version at both shared-attention sites): logits and the exit
    logits; and the forward against the port's own decode replay."""
    rm, rp, tm, tp = hybrid
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

@pytest.mark.parametrize("paged", [False, True], ids=["contig", "paged"])
def test_scheduler_greedy_matches_reference(hybrid, paged):
    """Five prompts through two slots (slots reused), segmented decode:
    the reference scheduler's greedy tokens under the tie rule, equal
    exit counts and served tokens."""
    rm, rp, tm, tp = hybrid
    prompts = _prompts(4, (5, 20, 33, 9, 14))
    kw = dict(paged=paged)
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


def test_no_prefix_cache_and_admission_zeroes_state_rows(hybrid, granite):
    """A hybrid paged arena runs without the prefix cache (a granite one
    keeps it), and admitting into a reused slot zeroes its state rows in
    place before the replay writes them."""
    _, _, tm, tp = hybrid
    _, _, gm, gp = granite
    kw = dict(paged=True)
    assert ContinuousBatchScheduler(gm, gp, _cfg(SchedulerConfig, **kw),
                                    device="cpu").prefix_cache is not None
    s = ContinuousBatchScheduler(tm, tp, _cfg(SchedulerConfig, **kw),
                                 device="cpu")
    _serve(s, Request, _prompts(5, (7, 9)), 4)
    states = [c for kind, blk in zip(tm.scan_block_kinds(),
                                     s.cache["blocks"]) for c in blk]
    ptrs = [t.data_ptr() for t in states]
    assert all(t[:, 0].abs().max() > 0 for t in states)
    s.submit(Request(tokens=_prompts(6, (11,))[0], max_new=3))
    admitted = s._begin_admit()
    assert admitted and admitted[0].slot == 0
    assert all(not t[:, 0].any() and t[:, 1].abs().max() > 0
               for t in states)
    assert [t.data_ptr() for t in _leaves(s.cache)[:len(ptrs)]] == ptrs
    s.run()
    assert admitted[0].done and len(admitted[0].out_tokens) == 3


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
def test_raw_migration_continues_bit_identically(hybrid, paged):
    """Exported mid-flight (state rows whole, K/V cut to the written
    prefix or pages), released, imported into a three-slot arena beside a
    neighbour: the greedy continuation equals the unmigrated run's."""
    _, _, tm, tp = hybrid
    prompt = _prompts(7, (9,))[0]
    ded = ContinuousBatchScheduler(tm, tp, _cfg(SchedulerConfig,
                                                paged=paged), device="cpu")
    want = _serve(ded, Request, [prompt], 10)[0]
    src, req = _mid_flight(tm, tp, prompt, paged)
    snap = src.export_slot(req.slot)
    # state rows ship whole; shared-attention K/V rows cut on axis 0
    # (tokens, or pages)
    n_state = 2 * len(src.cache["blocks"])
    assert src._row_axes_flat == [-1] * n_state + [0] * (
        len(src._row_axes_flat) - n_state)
    assert snap.payload_bytes == src.slot_payload_bytes(req.slot)
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
def test_int8_snapshot_matches_reference_bitwise(hybrid, paged):
    """The reference's raw snapshot imported into the port: the port's
    compressed export equals the reference's ``compress=True`` export bit
    for bit, every float leaf quantized (fp32 state rows and bf16 conv
    windows included); dequantized rows sit within amax / 127 of the raw
    ones, and the int8 payload continues decoding elsewhere."""
    rm, rp, tm, tp = hybrid
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
    assert all(s is not None for s in got.scales)
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
def test_async_windows_equal_sync_poll(hybrid, paged):
    """Six requests through three slots, max_new 3 to 11, windows of 4:
    rows finish mid-window, slots are reused and their state rows reset
    (paged) or merged (contiguous); tokens equal the sync monolithic
    poll's bit for bit, with one window build."""
    _, _, tm, tp = hybrid
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


def test_sampled_sync_equals_async(hybrid):
    """Two requests admitted together, max_new a multiple of R, T 0.7 from
    one generator seed: the sync step and the window draw at the same
    ticks, so the samples agree."""
    _, _, tm, tp = hybrid
    outs = []
    for async_decode in (False, True):
        s = ContinuousBatchScheduler(tm, tp, _cfg(
            SchedulerConfig, paged=True, exit_threshold=0.0,
            temperature=0.7, segmented=not async_decode,
            async_decode=async_decode, readback_interval=3), device="cpu")
        reqs = [Request(tokens=p, max_new=6) for p in _prompts(12, (5, 5))]
        for r in reqs:
            s.submit(r)
        s.run(rng=torch.Generator().manual_seed(5))
        outs.append([r.out_tokens for r in reqs])
    assert outs[0] == outs[1]
    greedy = _serve(ContinuousBatchScheduler(
        tm, tp, _cfg(SchedulerConfig, paged=True), device="cpu"),
        Request, _prompts(12, (5, 5)), 6)
    assert greedy != outs[0]
