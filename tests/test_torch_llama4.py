"""llama4-maverick-400b-a17b-smoke (GQA attention, ``pair`` units of a
dense layer then a 4-expert top-1 MoE layer with a shared expert) through
the port against the reference package on the same weights (reference
``Model.init`` bridged to torch), with bf16 experts and with the W8A8
experts of ``quantize_model_moe``.

The smoke config has 2 layers, one pair unit, and its exit at layer 1 is
dropped (it would split the unit).  ``CUT`` is the same model cut as the
card runs it: 4 layers, two pair units, the exit at 2, so the segmented
path crosses a unit boundary and the probe reads a pair unit's output.

Tolerances, as tests/test_torch_deepseek.py: decode logits atol 2e-2 on
the smoke config, exit entropies 5e-3; on the 4-layer cut decode logits
4e-2, the forwards' (untied head) 4e-2: two pair units carry the residual
stream to |x| ~ 8.6 (4.8 after one), where a bf16 ulp is 0.0625, and the
gaps to the jitted reference measure 0.015-0.020 there; exit logits
6e-2, as tests/test_torch_cuda.py holds granite's: the exit head's W is
N(0, 1/d), 3x the LM head's 0.02 (gaps of 0.047 measured); the forward
against the port's own decode replay 0.1 at capacity 8.0, as the
reference's ``test_decode_replay_matches_forward_moe`` holds its own.

Router ties.  The router picks one expert from the bf16 hidden state, and
the two packages' hidden states differ by a bf16 ulp here and there.
Where the reference's top two probabilities lie within ``ROUTE_TIE`` the
choice can flip, and that row's MoE output then differs by far more than
the logit tolerance.  Every router call of both packages is recorded; a
choice that differs must be such a tie.  A flip in the first unit reaches
the second unit's cache rows, so a tied row stays excused for the rest of
its sequence ("tainted"); serving runs at most 4 slots, where the
capacity (at least 4 rows an expert) never drops and rows do not couple.
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
from repro.models import ffn as ref_ffn
from repro.serving import ContinuousBatchScheduler as RefScheduler
from repro.serving import Request as RefRequest
from repro.serving import SchedulerConfig as RefConfig
from repro_torch.bridge import params_from_jax
from repro_torch.configs import get_config
from repro_torch.models import Model
from repro_torch.models import blocks
from repro_torch.models import ffn
from repro_torch.models.attention import PagedKV
from repro_torch.models.common import tree_leaves
from repro_torch.serving import (ContinuousBatchScheduler, Request,
                                 SchedulerConfig)
from repro_torch.serving.scheduler import SlotSnapshot

ARCH = "llama4-maverick-400b-a17b-smoke"
LOGIT_ATOL = 2e-2
CUT_LOGIT_ATOL = 4e-2
EXIT_ATOL = 6e-2
FWD_ATOL = 4e-2
ENT_ATOL = 5e-3
ROUTE_TIE = 1e-2      # router probabilities closer than this are a tie
LOGIT_TIE = 1e-2      # top-2 logits closer than this are an argmax tie


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cut(cfg, capacity_factor=None):
    """The card's cut: 4 layers (two pair units), the exit at 2."""
    moe = cfg.moe if capacity_factor is None else dataclasses.replace(
        cfg.moe, capacity_factor=capacity_factor)
    return dataclasses.replace(
        cfg, num_layers=4, moe=moe,
        exits=dataclasses.replace(cfg.exits, exit_layers=(2,)))


def _models(cut=True, w8a8=False, capacity_factor=None, seed=0):
    rc, tc = ref_config(ARCH), get_config(ARCH)
    if cut:
        rc, tc = _cut(rc, capacity_factor), _cut(tc, capacity_factor)
    rm = RefModel(rc)
    rp = rm.init(jax.random.PRNGKey(seed))
    tm = Model(tc, device="cpu")
    tp = params_from_jax(jax.tree.map(np.asarray, rp))
    if w8a8:
        rp = ref_ffn.quantize_model_moe(rp)
        ffn.quantize_model_moe(tp)
    return rm, rp, tm, tp


@pytest.fixture(scope="module")
def cut_bf16():
    return _models()


@pytest.fixture(scope="module")
def cut_w8a8():
    return _models(w8a8=True)


@pytest.fixture(scope="module")
def smoke_models():
    return {False: _models(cut=False), True: _models(cut=False, w8a8=True)}


class Routes:
    """Records every router call of both packages: (idx [T,k], probs
    [T,E]) in call order."""

    def __init__(self, monkeypatch):
        self.ref, self.port = [], []
        ref_route, port_route = ref_ffn._route, ffn._route

        def rec_ref(x2d, w, k):
            out = ref_route(x2d, w, k)
            jax.debug.callback(
                lambda i, p: self.ref.append((np.asarray(i), np.asarray(p))),
                out[1], out[2], ordered=True)
            return out

        def rec_port(x2d, w, k):
            out = port_route(x2d, w, k)
            self.port.append((out[1].numpy(), out[2].numpy()))
            return out
        monkeypatch.setattr(ref_ffn, "_route", rec_ref)
        monkeypatch.setattr(ffn, "_route", rec_port)

    def tied_rows(self, start=0):
        """Rows whose choice differs in any call from ``start`` on; asserts
        each one is a tie of the reference's router probabilities."""
        jax.effects_barrier()
        assert len(self.ref) == len(self.port)
        rows = set()
        for (ri, rp), (ti, _) in zip(self.ref[start:], self.port[start:]):
            for row in np.nonzero((ri != ti).any(1))[0]:
                gap = np.abs(rp[row][ri[row]] - rp[row][ti[row]]).max()
                assert gap < ROUTE_TIE, (row, ri[row], ti[row], rp[row])
                rows.add(int(row))
        return rows


@pytest.fixture
def routes(monkeypatch):
    return Routes(monkeypatch)


def _leaves_by_path(tree, pre=""):
    if isinstance(tree, dict):
        return [x for k in sorted(tree)
                for x in _leaves_by_path(tree[k], f"{pre}/{k}")]
    if isinstance(tree, (list, tuple)):
        return [x for i, v in enumerate(tree)
                for x in _leaves_by_path(v, f"{pre}/{i}")]
    return [(pre, tree)]


# ---------------------------------------------------------------------------
# Config, plan, init
# ---------------------------------------------------------------------------

def test_config_matches_reference():
    for arch in (ARCH, "llama4-maverick-400b-a17b"):
        assert dataclasses.asdict(get_config(arch)) == dataclasses.asdict(
            ref_config(arch))
    full = get_config("llama4-maverick-400b-a17b")
    assert (full.num_layers, full.d_model, full.num_heads,
            full.num_kv_heads, full.head_dim, full.vocab_size,
            full.d_ff) == (48, 5120, 40, 8, 128, 202_048, 16_384)
    assert (full.moe.num_experts, full.moe.top_k, full.moe.d_ff_expert,
            full.moe.layer_period) == (128, 1, 8192, 2)
    assert not full.tie_embeddings


@pytest.mark.parametrize("arch,cut,exits", [
    (ARCH, False, None), ("llama4-maverick-400b-a17b", False, None),
    (ARCH, True, (2,)), (ARCH, True, (3,)), (ARCH, True, (1, 2))])
def test_plan_keeps_pair_units_whole(arch, cut, exits):
    """The port's plan equals the reference's; an exit that would split a
    pair unit (the smoke config's at 1, a cut's at 3) is dropped."""
    from repro.models.blocks import build_plan as ref_plan
    rc, tc = ref_config(arch), get_config(arch)
    if cut:
        rc, tc = _cut(rc), _cut(tc)
        rc = dataclasses.replace(rc, exits=dataclasses.replace(
            rc.exits, exit_layers=exits))
        tc = dataclasses.replace(tc, exits=dataclasses.replace(
            tc.exits, exit_layers=exits))
    plan = blocks.build_plan(tc)
    assert plan == ref_plan(rc)
    assert {s[1] for s in plan if s[0] == "scan"} == {"pair"}
    assert "pair" in blocks.PORTED_KINDS
    m = Model(tc, device="cpu")
    assert m.n_exits == RefModel(rc).n_exits
    if not cut:
        assert m.n_exits == (0 if arch == ARCH else 2)
    else:
        assert m.n_exits == (0 if exits == (3,) else 1)
        assert sum(s.layers for s in m.decode_segments) == 4


def test_init_tree_matches_reference_and_bridge_is_exact(cut_bf16):
    rm, rp, tm, tp = cut_bf16
    own = _leaves_by_path(tm.init(0))
    ref = _leaves_by_path(jax.tree.map(np.asarray, rp))
    assert [p for p, _ in own] == [p for p, _ in ref]
    assert any(p.startswith("/blocks/1/b/moe/wg") for p, _ in own)
    for (path, t), (_, r) in zip(own, ref):
        assert tuple(t.shape) == r.shape, path
        assert str(t.dtype).split(".")[-1] == r.dtype.name, path
    for (path, t), (_, r) in zip(_leaves_by_path(tp), ref):
        np.testing.assert_array_equal(
            t.view(torch.int16 if t.dtype == torch.bfloat16
                   else t.dtype).numpy(),
            r.view(np.int16) if r.dtype.name == "bfloat16" else r,
            err_msg=path)


def test_pair_cache_trees_match_reference(cut_bf16):
    """A pair unit's cache is {"a": (k, v), "b": (k, v)}, contiguous and
    paged, leaf for leaf the reference's shapes in its flatten order."""
    rm, _, tm, _ = cut_bf16
    for t, r in ((tm.init_decode_cache(3, 40), rm.init_decode_cache(3, 40)),
                 (tm.init_decode_cache_paged(3, 9, 16),
                  rm.init_decode_cache_paged(3, 9, 16))):
        assert set(t["blocks"][0]) == {"a", "b"}
        tl, rl = tree_leaves(t), jax.tree.leaves(r)
        assert len(tl) == len(rl) == 8
        assert [tuple(a.shape) for a in tl] == [a.shape for a in rl]
        assert all(a.dtype == torch.bfloat16 for a in tl)


# ---------------------------------------------------------------------------
# Decode
# ---------------------------------------------------------------------------

def _paged_table(b, pps, n_pages, seed):
    perm = np.random.RandomState(seed).permutation(n_pages)
    tbl = perm[:b * pps].reshape(b, pps).astype(np.int32)
    tbl[-1, pps // 2:] = n_pages
    return tbl


@pytest.mark.parametrize("depth", ["smoke", "cut"])
@pytest.mark.parametrize("w8a8", [False, True], ids=["bf16", "w8a8"])
@pytest.mark.parametrize("arena", ["contiguous", "paged"])
def test_decode_step_matches_reference(cut_bf16, cut_w8a8, smoke_models,
                                       routes, w8a8, arena, depth):
    """Six decode steps at ragged per-slot positions, against the jitted
    reference: the smoke config's one pair unit (no exit) and the cut's
    two (the exit between them): logits and exit entropies of every
    untainted row allclose."""
    if depth == "smoke":
        rm, rp, tm, tp = smoke_models[w8a8]
        atol = LOGIT_ATOL
    else:
        rm, rp, tm, tp = cut_w8a8 if w8a8 else cut_bf16
        atol = CUT_LOGIT_ATOL
    b, page, pps = 3, 16, 2
    n_pages = b * pps + 2
    pos = np.array([0, 3, 9], np.int32)
    if arena == "paged":
        tbl = _paged_table(b, pps, n_pages, 0)
        rc = rm.init_decode_cache_paged(b, n_pages, page)
        tc = tm.init_decode_cache_paged(b, n_pages, page)
    else:
        rc = rm.init_decode_cache(b, 40)
        tc = tm.init_decode_cache(b, 40)
    # jitted, as the reference's scheduler runs it (W8A8 rows quantize in
    # their jitted form)
    step = jax.jit(lambda p, c, t, q, tb, m: rm.decode_step(
        p, c, t, q, paged=None if tb is None else ref_attn.PagedKV(tb, m)))
    rs = np.random.RandomState(1)
    tainted, compared = set(), 0
    for _ in range(6):
        toks = rs.randint(0, tm.cfg.vocab_size, (b, 1)).astype(np.int32)
        kw_t, tb, m = {}, None, None
        if arena == "paged":
            mask = np.ones(b, bool)
            tb, m = jnp.asarray(tbl), jnp.asarray(mask)
            kw_t["paged"] = PagedKV(torch.from_numpy(tbl),
                                    torch.from_numpy(mask))
        start = len(routes.port)
        rl, ree, rc = step(rp, rc, jnp.asarray(toks), jnp.asarray(pos), tb,
                           m)
        tl, tee, tc = tm.decode_step(tp, tc, torch.from_numpy(toks).long(),
                                     torch.from_numpy(pos), **kw_t)
        tainted |= routes.tied_rows(start)
        keep = [i for i in range(b) if i not in tainted]
        compared += len(keep)
        np.testing.assert_allclose(tl.numpy()[keep], np.asarray(rl)[keep],
                                   rtol=0, atol=atol)
        assert tee.shape == (tm.n_exits, b)
        np.testing.assert_allclose(tee.numpy()[:, keep],
                                   np.asarray(ree)[:, keep], rtol=0,
                                   atol=ENT_ATOL)
        pos = pos + 1
    assert compared >= 12


@pytest.mark.parametrize("w8a8", [False, True], ids=["bf16", "w8a8"])
def test_segments_equal_monolithic_step(cut_bf16, cut_w8a8, w8a8):
    """embed -> decode_segment x 2 (the exit between the two pair units)
    -> finalize with every slot alive is the monolithic decode_step bit
    for bit in the paged arena, caches included; the probe's entropy is
    the step's exit entropy."""
    _, _, tm, tp = cut_w8a8 if w8a8 else cut_bf16
    b, page, pps = 2, 16, 2
    n_pages = b * pps
    tbl = torch.from_numpy(_paged_table(b, pps, n_pages, 3))
    toks = torch.from_numpy(np.random.RandomState(2).randint(
        0, tm.cfg.vocab_size, (b, 1)))
    pos = torch.tensor([3, 5], dtype=torch.int32)
    alive = torch.ones(b, dtype=torch.bool)
    mono = tm.init_decode_cache_paged(b, n_pages, page)
    logits, ee, _ = tm.decode_step(tp, mono, toks, pos,
                                   paged=PagedKV(tbl, alive))
    cache = tm.init_decode_cache_paged(b, n_pages, page)
    x = tm.embed_decode_tokens(tp, toks)
    assert [s.layers for s in tm.decode_segments] == [2, 2]
    for seg in tm.decode_segments:
        x, cache = tm.decode_segment(tp, cache, x, seg, pos, alive,
                                     paged=PagedKV(tbl, alive))
        if seg.exit_index is not None:
            ent = tm.exit_probe_entropy(tp, seg.exit_index, x)
            np.testing.assert_allclose(ent.numpy(),
                                       ee[seg.exit_index].numpy(), rtol=0,
                                       atol=ENT_ATOL)
    assert torch.equal(tm.finalize_decode(tp, x), logits)
    assert all(torch.equal(u, v) for u, v in zip(tree_leaves(mono),
                                                 tree_leaves(cache)))


def test_smoke_config_decode_matches_reference(routes):
    """The registered smoke config itself (one pair unit, no exit)."""
    rm, rp, tm, tp = _models(cut=False)
    assert tm.n_exits == 0
    toks = np.random.RandomState(5).randint(
        0, tm.cfg.vocab_size, (2, 7)).astype(np.int32)
    rl, _ = rm.prefill(rp, {"tokens": jnp.asarray(toks)})
    tl, _ = tm.prefill(tp, {"tokens": torch.from_numpy(toks).long()})
    tainted = routes.tied_rows()
    keep = [i for i in range(2) if i not in tainted]
    np.testing.assert_allclose(tl.numpy()[keep], np.asarray(rl)[keep],
                               rtol=0, atol=LOGIT_ATOL)


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("w8a8", [False, True], ids=["bf16", "w8a8"])
def test_forward_matches_reference_and_own_replay(routes, w8a8):
    """``Model.forward`` at capacity 8.0 (no drop in the batched forward):
    against the reference's forward on the same weights (4e-2, rows of
    untainted routing), and against the port's own token-by-token decode
    replay (0.1), as the reference's
    ``test_decode_replay_matches_forward_moe`` holds its own."""
    rm, rp, tm, tp = _models(w8a8=w8a8, capacity_factor=8.0)
    toks = np.random.RandomState(1).randint(
        0, tm.cfg.vocab_size, (2, 16)).astype(np.int32)
    tb = {"tokens": torch.from_numpy(toks).long()}
    out = tm.forward(tp, tb)
    w_logits, w_exits, w_aux = jax.jit(lambda p, t: dataclasses.astuple(
        rm.forward(p, {"tokens": t}))[:3])(rp, jnp.asarray(toks))
    tied = routes.tied_rows()
    # a forward's router rows are the flattened [B*S] tokens; a tied token
    # taints the rest of its row (the second unit reads its keys)
    bad = {r // 16 for r in tied}
    keep = [i for i in range(2) if i not in bad]
    assert keep
    np.testing.assert_allclose(out.logits.numpy()[keep],
                               np.asarray(w_logits)[keep], rtol=0,
                               atol=FWD_ATOL)
    assert len(out.exit_logits) == len(w_exits) == 1
    np.testing.assert_allclose(out.exit_logits[0].numpy()[keep],
                               np.asarray(w_exits[0])[keep], rtol=0,
                               atol=EXIT_ATOL)
    np.testing.assert_allclose(float(out.aux_loss), float(w_aux), rtol=0,
                               atol=1e-2)
    replay, _ = tm.prefill(tp, tb)
    np.testing.assert_allclose(out.logits.numpy(), replay.numpy(), rtol=0.1,
                               atol=0.1)


# ---------------------------------------------------------------------------
# Scheduler: both schedulers in lockstep, phase by phase
# ---------------------------------------------------------------------------

MAX_NEW = 6


def _prompts(vocab, lengths):
    """Mixed lengths; the last prompt shares its first page with the
    second, so the paged arena's prefix cache hits."""
    rs = np.random.RandomState(0)
    ps = [rs.randint(0, vocab, n).astype(np.int32) for n in lengths]
    ps.append(np.concatenate([ps[1][:16], rs.randint(0, vocab, 6)]).astype(
        np.int32))
    return ps


class _RefLogits:
    """The reference scheduler's logits per phase: each admitted slot's
    first-token logits, and each decode step's finalize logits."""

    def __init__(self, sched, model):
        self.step = []
        first = sched._sample_first
        slots = []

        def sample_first(row):
            slots.append(row)
            return first(row)
        sched._sample_first = sample_first
        self._slots = slots
        finalize = model.finalize_decode

        def finalize_rec(params, x):
            logits = finalize(params, x)
            jax.debug.callback(lambda a: self.step.append(np.asarray(a)),
                               logits, ordered=True)
            return logits
        model.finalize_decode = finalize_rec

    def take_first(self, slots):
        rows, self._slots[:] = list(self._slots), []
        return dict(zip(slots, rows))


def _lockstep(rm, rp, tm, tp, cfg_kw, prompts, routes):
    """Run both schedulers phase by phase (admission + prefill, then one
    decode step).  A token that differs is forced to the reference's when
    the reference's top-2 logits tie or its request is tainted by a router
    tie; anything else fails.  Returns (ref scheduler, port scheduler, port
    requests, forced count, tainted request ids)."""
    rs_ = RefScheduler(rm, rp, RefConfig(**cfg_kw))
    ts_ = ContinuousBatchScheduler(tm, tp, SchedulerConfig(**cfg_kw),
                                   device="cpu")
    logs = _RefLogits(rs_, rm)
    rreqs = [RefRequest(tokens=p, max_new=MAX_NEW, req_id=i)
             for i, p in enumerate(prompts)]
    treqs = [Request(tokens=p, max_new=MAX_NEW, req_id=i)
             for i, p in enumerate(prompts)]
    for a, b in zip(rreqs, treqs):
        rs_.submit(a)
        ts_.submit(b)
    forced, tainted = 0, set()

    def taint(rows):
        for s in rows:
            if ts_.slot_req[s] is not None:
                tainted.add(ts_.slot_req[s].req_id)

    def reconcile(ref_logits):
        nonlocal forced
        for a, b in zip(rreqs, treqs):
            assert len(a.out_tokens) == len(b.out_tokens)
            if not b.out_tokens or a.out_tokens[-1] == b.out_tokens[-1]:
                continue
            want, got = a.out_tokens[-1], b.out_tokens[-1]
            lg = ref_logits.get(a.slot)
            tie = lg is not None and lg[want] - lg[got] < LOGIT_TIE
            assert tie or b.req_id in tainted, (a.req_id, want, got)
            b.out_tokens[-1] = want
            if ts_.slot_req[b.slot] is b:
                ts_.current_tok[b.slot] = want
            forced += 1

    def changed(reqs, before):
        return [r.slot for r, n in zip(reqs, before)
                if len(r.out_tokens) != n]

    while rs_.has_work or ts_.has_work:
        before = [len(r.out_tokens) for r in rreqs]
        start = len(routes.port)
        rs_.prefill_poll()
        ts_.prefill_poll()
        taint(routes.tied_rows(start))
        reconcile(logs.take_first(changed(rreqs, before)))
        start, n_steps = len(routes.port), len(logs.step)
        stepped = rs_.step()
        assert ts_.step() == stepped
        taint(routes.tied_rows(start))
        if stepped:
            jax.effects_barrier()
            lg = logs.step[n_steps]
            reconcile({r.slot: lg[r.slot] for r in rreqs})
    rs_.flush_counters()
    ts_.flush_counters()
    return rs_, ts_, treqs, forced, tainted


@pytest.mark.parametrize("w8a8", [False, True], ids=["bf16", "w8a8"])
def test_scheduler_greedy_matches_reference(routes, w8a8):
    """Paged, segmented serving of the 4-layer cut (the exit probe between
    the two pair units), 3 slots, slot reuse and a prefix hit, bf16 and
    W8A8 experts: tokens equal under the tie rule, the same exit counts,
    token counts and stage calls."""
    rm, rp, tm, tp = _models(w8a8=w8a8)
    prompts = _prompts(tm.cfg.vocab_size, (5, 20, 33, 9, 12))
    cfg_kw = dict(n_slots=3, max_len=64, prefill_chunk=8, paged=True,
                  page_size=16, segmented=True, exit_threshold=0.5)
    rs_, ts_, treqs, forced, tainted = _lockstep(rm, rp, tm, tp, cfg_kw,
                                                 prompts, routes)
    assert ts_.n_admitted == len(prompts) and not ts_.has_work
    for r in treqs:
        assert len(r.out_tokens) == MAX_NEW
    # a flip is rare, its taint is not: most requests are held untainted
    assert forced <= 2 and len(tainted) <= len(prompts) // 2
    assert max(np.bincount([r.slot for r in treqs])) >= 2  # a slot reused
    assert ts_.prefix_hit_tokens == rs_.prefix_hit_tokens > 0
    np.testing.assert_array_equal(ts_.exit_counts, rs_.exit_counts)
    assert ts_.tokens_served == rs_.tokens_served
    assert ts_.stage_calls == rs_.stage_calls
    assert ts_.stage_calls["probe0"] > 0
    assert ts_.stage_calls["segment1"] > 0


# ---------------------------------------------------------------------------
# Migration of a pair slot
# ---------------------------------------------------------------------------

MIG_NEW = 10


def _mig_cfg(cls, n_slots):
    return cls(n_slots=n_slots, max_len=32, prefill_chunk=4,
               exit_threshold=0.6, paged=True, page_size=16)


def _mid_flight(sched_cls, req_cls, cfg_cls, model, params, prompt, **kw):
    sched = sched_cls(model, params, _mig_cfg(cfg_cls, 2), **kw)
    req = req_cls(tokens=prompt.copy(), max_new=MIG_NEW)
    sched.submit(req)
    for _ in range(5):
        sched.poll()
    assert not req.done and sched.active[req.slot]
    return sched, req


def _to_torch(a):
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def _bits(t):
    view = {torch.bfloat16: torch.int16, torch.float32: torch.int32}
    return (t.view(view[t.dtype]) if t.dtype in view else t).numpy()


def _prompt(seed, n=9):
    return np.random.RandomState(seed).randint(0, 1000, n).astype(np.int32)


@pytest.mark.parametrize("w8a8", [False, True], ids=["bf16", "w8a8"])
def test_raw_migration_of_a_pair_slot_continues(cut_bf16, cut_w8a8, w8a8):
    """A live slot of the 4-layer cut exported raw from a 2-slot paged
    arena (eight leaves: each unit's dense and MoE k and v) and imported
    into a 3-slot arena beside a neighbour continues with the greedy
    tokens of an unmigrated run."""
    _, _, tm, tp = cut_w8a8 if w8a8 else cut_bf16
    prompt = _prompt(0)
    ref_s = ContinuousBatchScheduler(tm, tp, _mig_cfg(SchedulerConfig, 2),
                                     device="cpu")
    ref_r = Request(tokens=prompt.copy(), max_new=MIG_NEW)
    ref_s.submit(ref_r)
    ref_s.run()
    src, req = _mid_flight(ContinuousBatchScheduler, Request, SchedulerConfig,
                           tm, tp, prompt, device="cpu")
    snap = src.export_slot(req.slot)
    assert len(snap.payload) == 8 and snap.payload_bytes > 0
    assert src.slot_payload_bytes(req.slot) == snap.payload_bytes
    src.release_slot(req.slot)
    dst = ContinuousBatchScheduler(tm, tp, _mig_cfg(SchedulerConfig, 3),
                                   device="cpu")
    dst.submit(Request(tokens=_prompt(1, 5), max_new=4))
    dst.poll()
    slot = dst.import_slot(snap)
    assert dst.active[slot] and dst.slot_req[slot] is req
    again = dst.export_slot(slot)
    for a, b in zip(again.payload, snap.payload):
        np.testing.assert_array_equal(_bits(a), _bits(b))
    dst.run()
    assert req.done and req.out_tokens == ref_r.out_tokens


def test_int8_migration_of_a_pair_slot_matches_reference(cut_bf16):
    """Given the same rows (the reference's raw snapshot imported into the
    port), the port's int8 export of a pair slot equals the reference's
    ``export_slot(compress=True)`` leaf for leaf, int8 and scales bit for
    bit, in the reference's leaf order; it continues decoding elsewhere."""
    rm, rp, tm, tp = cut_bf16
    ref_src, ref_req = _mid_flight(RefScheduler, RefRequest, RefConfig, rm,
                                   rp, _prompt(2))
    raw = ref_src.export_slot(ref_req.slot)
    want = ref_src.export_slot(ref_req.slot, compress=True)
    r = raw.req
    port_req = Request(tokens=np.asarray(r.tokens, np.int32),
                       max_new=r.max_new, req_id=r.req_id,
                       out_tokens=list(r.out_tokens))
    snap = SlotSnapshot(
        req=port_req, position=raw.position, current_tok=raw.current_tok,
        steps_taken=raw.steps_taken, compressed=False,
        payload=[_to_torch(a) for a in raw.payload],
        scales=[None] * len(raw.payload), payload_bytes=raw.payload_bytes,
        paged=raw.paged, page_skip=raw.page_skip, page_used=raw.page_used,
        page_digests=list(raw.page_digests))
    port = ContinuousBatchScheduler(tm, tp, _mig_cfg(SchedulerConfig, 2),
                                    device="cpu")
    slot = port.import_slot(snap)
    got = port.export_slot(slot, compress=True)
    assert got.compressed and got.payload_bytes == want.payload_bytes
    assert len(got.payload) == len(want.payload) == 8
    assert got.payload_bytes < 0.7 * raw.payload_bytes
    for q, s, wq, ws in zip(got.payload, got.scales, want.payload,
                            want.scales):
        assert q.dtype == torch.int8 and s.dtype == torch.float32
        np.testing.assert_array_equal(q.numpy(), np.asarray(wq))
        np.testing.assert_array_equal(_bits(s), _bits(_to_torch(ws)))
    port.release_slot(slot)
    dst = ContinuousBatchScheduler(tm, tp, _mig_cfg(SchedulerConfig, 3),
                                   device="cpu")
    dst.import_slot(got)
    dst.run()
    assert got.req.done and len(got.req.out_tokens) == MIG_NEW
