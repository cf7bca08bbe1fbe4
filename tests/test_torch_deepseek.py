"""deepseek-v3-671b-smoke (MLA attention, a dense layer then a 4-expert
top-2 MoE layer with a shared expert, one exit head) through the port
against the reference package on the same weights (reference
``Model.init`` bridged to torch).

Tolerances, as tests/test_torch_model.py: logits atol 2e-2 (bf16 matmul
results one or two ulps apart), exit entropies atol 5e-3.

Router ties.  The MoE router makes a discrete choice from the bf16 hidden
state, and the two packages' hidden states differ by a bf16 ulp here and
there.  Where two experts' probabilities lie within ``ROUTE_TIE`` of each
other that can flip the top-k choice or its order, and the MoE output of
that row then differs by up to about 0.2.  Every router call of both
packages is recorded; a choice that differs must be such a tie of the
reference's probabilities, and only then may that row's logits (decode
tests) or that phase's tokens (scheduler tests) differ.  The MoE layer is
the smoke model's last, so a flip never reaches a cache.
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
from repro_torch.models import common
from repro_torch.models import ffn
from repro_torch.models.attention import PagedKV
from repro_torch.models.common import tree_leaves
from repro_torch.serving import (ContinuousBatchScheduler, Request,
                                 SchedulerConfig)

ARCH = "deepseek-v3-671b-smoke"
LOGIT_ATOL = 2e-2
ENT_ATOL = 5e-3
ROUTE_TIE = 1e-2      # router probabilities closer than this are a tie
LOGIT_TIE = 1e-2      # top-2 logits closer than this are an argmax tie


def _configs(capacity_factor=None):
    rc, tc = ref_config(ARCH), get_config(ARCH)
    if capacity_factor is not None:
        rc = dataclasses.replace(rc, moe=dataclasses.replace(
            rc.moe, capacity_factor=capacity_factor))
        tc = dataclasses.replace(tc, moe=dataclasses.replace(
            tc.moe, capacity_factor=capacity_factor))
    return rc, tc


@pytest.fixture(scope="module")
def pair():
    rc, tc = _configs()
    rm = RefModel(rc)
    rp = rm.init(jax.random.PRNGKey(0))
    tm = Model(tc, device="cpu")
    tp = params_from_jax(jax.tree.map(np.asarray, rp))
    return rm, rp, tm, tp


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
        """Rows whose choice differs, per call from ``start`` on; asserts
        each one is a tie of the reference's router probabilities."""
        jax.effects_barrier()
        assert len(self.ref) == len(self.port)
        out = []
        for (ri, rp), (ti, _) in zip(self.ref[start:], self.port[start:]):
            rows = set()
            for row in np.nonzero((ri != ti).any(1))[0]:
                gap = np.abs(rp[row][ri[row]] - rp[row][ti[row]]).max()
                assert gap < ROUTE_TIE, (row, ri[row], ti[row], rp[row])
                rows.add(int(row))
            out.append(rows)
        return out


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


def test_config_matches_reference():
    for arch in (ARCH, "deepseek-v3-671b"):
        assert dataclasses.asdict(get_config(arch)) == dataclasses.asdict(
            ref_config(arch))


def test_init_tree_matches_reference_and_bridge_is_exact(pair):
    """The port's own init (mtp included) has the reference's tree, shapes
    and dtypes leaf for leaf, and every bridged leaf is bit-exact."""
    rm, rp, tm, tp = pair
    own = _leaves_by_path(tm.init(0))
    ref = _leaves_by_path(jax.tree.map(np.asarray, rp))
    assert [p for p, _ in own] == [p for p, _ in ref]
    assert any(p.startswith("/mtp/layer/") for p, _ in own)
    for (path, t), (_, r) in zip(own, ref):
        assert tuple(t.shape) == r.shape, path
        assert str(t.dtype).split(".")[-1] == r.dtype.name, path
    for (path, t), (_, r) in zip(_leaves_by_path(tp), ref):
        np.testing.assert_array_equal(
            t.view(torch.int16 if t.dtype == torch.bfloat16
                   else t.dtype).numpy(),
            r.view(np.int16) if r.dtype.name == "bfloat16" else r,
            err_msg=path)


def test_init_makes_each_leaf_in_place(monkeypatch):
    """No fp32 copy of a weight and no stack copy of a block: every random
    draw is at most ``DRAW_CHUNK`` elements, nothing is stacked, and each
    leaf is allocated once in its final dtype (the rule that lets a
    full-width MoE layer be made on one card)."""
    draws = []
    real_randn = torch.randn

    def randn(*a, **kw):
        out = real_randn(*a, **kw)
        draws.append(out.numel())
        return out

    def no_stack(*a, **kw):
        raise AssertionError("Model.init stacked a copy of a block")
    monkeypatch.setattr(common, "DRAW_CHUNK", 1000)
    monkeypatch.setattr(torch, "randn", randn)
    monkeypatch.setattr(torch, "stack", no_stack)
    params = Model(get_config(ARCH), device="cpu").init(0)
    assert draws and max(draws) <= 1000
    leaves = tree_leaves(params)
    assert sum(draws) == sum(t.numel() for t in leaves
                             if t.dtype == torch.bfloat16
                             and t.float().std() > 0)
    assert all(t.dtype == (torch.bfloat16 if t.ndim >= 2 else torch.float32)
               for t in leaves)


def _paged_table(b, pps, n_pages, seed):
    perm = np.random.RandomState(seed).permutation(n_pages)
    tbl = perm[:b * pps].reshape(b, pps).astype(np.int32)
    tbl[-1, pps // 2:] = n_pages
    return tbl


@pytest.mark.parametrize("arena", ["contiguous", "paged", "ring"])
def test_decode_step_matches_reference(pair, routes, arena):
    """Six decode steps at ragged per-slot positions: logits (of rows
    without a router tie) and exit entropies allclose.  ``ring`` is the
    long-mode latent ring buffer (window 64 at smoke size), with positions
    that have wrapped around it."""
    rm, rp, tm, tp = pair
    b, page, pps = 3, 16, 2
    n_pages = b * pps + 2
    pos = np.array([0, 3, 9], np.int32)
    long_mode = arena == "ring"
    if arena == "paged":
        tbl = _paged_table(b, pps, n_pages, 0)
        rc = rm.init_decode_cache_paged(b, n_pages, page)
        tc = tm.init_decode_cache_paged(b, n_pages, page)
        assert tc["blocks"][0][0].shape == (1, n_pages, page,
                                            tm.cfg.kv_lora_rank)
    else:
        rc = rm.init_decode_cache(b, 200, long_mode=long_mode)
        tc = tm.init_decode_cache(b, 200, long_mode=long_mode)
        if long_mode:
            assert tc["blocks"][0][0].shape == (1, b, 64,
                                                tm.cfg.kv_lora_rank)
            pos = np.array([70, 130, 5], np.int32)
    rs = np.random.RandomState(1)
    compared = 0
    for _ in range(6):
        toks = rs.randint(0, tm.cfg.vocab_size, (b, 1)).astype(np.int32)
        kw_r, kw_t = {"long_mode": long_mode}, {"long_mode": long_mode}
        if arena == "paged":
            mask = np.ones(b, bool)
            kw_r["paged"] = ref_attn.PagedKV(jnp.asarray(tbl),
                                             jnp.asarray(mask))
            kw_t["paged"] = PagedKV(torch.from_numpy(tbl),
                                    torch.from_numpy(mask))
        start = len(routes.port)
        rl, ree, rc = rm.decode_step(rp, rc, jnp.asarray(toks),
                                     jnp.asarray(pos), **kw_r)
        tl, tee, tc = tm.decode_step(tp, tc, torch.from_numpy(toks).long(),
                                     torch.from_numpy(pos), **kw_t)
        (tied,) = routes.tied_rows(start)
        keep = [i for i in range(b) if i not in tied]
        compared += len(keep)
        np.testing.assert_allclose(tl.numpy()[keep], np.asarray(rl)[keep],
                                   rtol=0, atol=LOGIT_ATOL)
        np.testing.assert_allclose(tee.numpy(), np.asarray(ree), rtol=0,
                                   atol=ENT_ATOL)
        pos = pos + 1
    assert compared >= 15


def test_segments_equal_monolithic_step(pair):
    """embed -> decode_segment* -> finalize with every slot alive is the
    monolithic decode_step bit for bit, in the paged arena; the fused
    probe's entropy matches the step's exit entropy (which
    ``test_decode_step_matches_reference`` holds to the reference)."""
    _, _, tm, tp = pair
    b, page, pps = 2, 16, 2
    n_pages = b * pps
    tbl = torch.from_numpy(_paged_table(b, pps, n_pages, 3))
    rs = np.random.RandomState(2)
    toks = torch.from_numpy(rs.randint(0, tm.cfg.vocab_size, (b, 1)))
    pos = torch.tensor([3, 5], dtype=torch.int32)
    alive = torch.ones(b, dtype=torch.bool)
    mono_cache = tm.init_decode_cache_paged(b, n_pages, page)
    logits, ee, _ = tm.decode_step(tp, mono_cache, toks, pos,
                                   paged=PagedKV(tbl, alive))
    cache = tm.init_decode_cache_paged(b, n_pages, page)
    x = tm.embed_decode_tokens(tp, toks)
    probes = 0
    for seg in tm.decode_segments:
        x, cache = tm.decode_segment(tp, cache, x, seg, pos, alive,
                                     paged=PagedKV(tbl, alive))
        if seg.exit_index is not None:
            ent = tm.exit_probe_entropy(tp, seg.exit_index, x)
            np.testing.assert_allclose(ent.numpy(),
                                       ee[seg.exit_index].numpy(), rtol=0,
                                       atol=ENT_ATOL)
            probes += 1
    assert probes == tm.n_exits == 1
    assert torch.equal(tm.finalize_decode(tp, x), logits)
    for a, bb in zip(mono_cache["blocks"], cache["blocks"]):
        assert all(torch.equal(u, v) for u, v in zip(a, bb))


def test_prefill_logits_match_reference(pair, routes):
    rm, rp, tm, tp = pair
    toks = np.random.RandomState(5).randint(
        0, tm.cfg.vocab_size, (2, 7)).astype(np.int32)
    rl, _ = rm.prefill(rp, {"tokens": jnp.asarray(toks)})
    tl, _ = tm.prefill(tp, {"tokens": torch.from_numpy(toks).long()})
    assert tl.shape == (2, 7, tm.cfg.vocab_size)
    tied = routes.tied_rows()
    assert len(tied) == 7
    for t, rows in enumerate(tied):
        keep = [i for i in range(2) if i not in rows]
        np.testing.assert_allclose(tl.numpy()[keep, t],
                                   np.asarray(rl)[keep, t], rtol=0,
                                   atol=LOGIT_ATOL)


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
        self.first, self.step = {}, []
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
    the reference's top-2 logits tie or a router tie fell in that phase;
    anything else fails.  Returns (ref scheduler, port scheduler, port
    requests, forced count)."""
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
    forced = 0

    def reconcile(ref_logits, router_tie):
        nonlocal forced
        for a, b in zip(rreqs, treqs):
            assert len(a.out_tokens) == len(b.out_tokens)
            if not b.out_tokens or a.out_tokens[-1] == b.out_tokens[-1]:
                continue
            want, got = a.out_tokens[-1], b.out_tokens[-1]
            lg = ref_logits.get(a.slot)
            tie = lg is not None and lg[want] - lg[got] < LOGIT_TIE
            assert tie or router_tie, (a.req_id, want, got)
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
        tied = routes.tied_rows(start)
        first = logs.take_first(changed(rreqs, before))
        reconcile(first, any(tied))
        start, n_steps = len(routes.port), len(logs.step)
        stepped = rs_.step()
        assert ts_.step() == stepped
        tied = routes.tied_rows(start)
        if stepped:
            jax.effects_barrier()
            lg = logs.step[n_steps]
            reconcile({r.slot: lg[r.slot] for r in rreqs}, any(tied))
    rs_.flush_counters()
    ts_.flush_counters()
    return rs_, ts_, treqs, forced


@pytest.mark.parametrize("capacity_factor,slots,lengths", [
    (None, 2, (5, 20, 33, 9)),
    (0.25, 8, (5, 20, 33, 9, 12, 17, 25, 7))],
    ids=["paged-seg-2slots", "paged-seg-8slots-drops"])
def test_scheduler_greedy_matches_reference(routes, capacity_factor, slots,
                                            lengths):
    """Paged, segmented serving with slot reuse and a prefix hit.  The
    second run lowers the capacity factor on both configs and serves 8
    slots: every decode step has 16 assignments for 4 experts of capacity
    4, so the capacity drops some, and rows couple through it."""
    rc, tc = _configs(capacity_factor)
    rm = RefModel(rc)
    rp = rm.init(jax.random.PRNGKey(0))
    tm = Model(tc, device="cpu")
    tp = params_from_jax(jax.tree.map(np.asarray, rp))
    prompts = _prompts(tc.vocab_size, lengths)
    cfg_kw = dict(n_slots=slots, max_len=64, prefill_chunk=8, paged=True,
                  page_size=16, segmented=True, exit_threshold=0.5)
    rs_, ts_, treqs, forced = _lockstep(rm, rp, tm, tp, cfg_kw, prompts,
                                        routes)
    assert ts_.n_admitted == len(prompts) and not ts_.has_work
    for r in treqs:
        assert len(r.out_tokens) == MAX_NEW
    assert forced <= 2
    slots_used = [r.slot for r in treqs]
    assert max(np.bincount(slots_used)) >= 2            # a slot was reused
    assert ts_.prefix_hit_tokens == rs_.prefix_hit_tokens > 0
    np.testing.assert_array_equal(ts_.exit_counts, rs_.exit_counts)
    assert ts_.tokens_served == rs_.tokens_served
    assert ts_.stage_calls == rs_.stage_calls
    m = tc.moe
    drops = 0
    for idx, _ in routes.port:
        cap = ffn._capacity(idx.shape[0], m.num_experts, m.top_k,
                            m.capacity_factor)
        _, kept = ffn._slots(torch.from_numpy(idx), 0, m.num_experts, cap)
        drops += int((~kept).sum())
    assert (drops > 0) == (capacity_factor is not None)
