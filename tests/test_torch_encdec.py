"""The encoder-decoder family (whisper-base-smoke) in the port, on the CPU
against the reference on the same weights (``bridge.params_from_jax``)
and the same seeded numpy frames (``0.02 N(0, 1)`` [Tenc, D], the stub
front end the reference's own tests feed).

* The config equals the reference's field by field, published and smoke.
* ``Model.encode`` (unmasked self-attention through flash's plain
  version) and ``Model.forward`` with frames: bf16 encoder outputs within
  4e-2 of max(1, |ref|) (the two packages round about half of a layer's
  bf16 outputs an ulp apart, and the frames' 0.02 scale grows to about 3
  in the first layer, where an ulp is 2^-6: 3.1e-2 measured at its
  largest); logits within 2e-2 (tied head) and exit logits
  within 4e-2 (the exit head's W has std D^-1/2, so the same hidden-state
  differences move them further, as ``tests/test_torch_forward.py`` holds
  them); ``resilient_forward`` with frames likewise.
* Cross-attention through ``gqa_forward(kv_x=)`` (Sq 24 against Skv 32,
  no mask) and ``cross_decode`` match the reference's on one layer.
* ``prime_whisper_cross_cache`` fills the cross rows as the reference's
  does (bf16, 4e-2 of max(1, |ref|), from those encoder outputs);
  ``decode_step`` after it: logits
  within 2e-2, exit entropies within 5e-3, greedy equal or tied.
* The contiguous scheduler, segmented and monolithic, with slots
  re-admitted mid-run: the reference's greedy tokens under the parity
  contract (a first difference only at a top-2 tie within 1e-2 of the
  reference's replay over primed cross rows); async windows equal the
  port's sync poll bit for bit.
* Paged arenas and ``SpecPair`` refuse encdec as the reference does; a
  request without frames is refused.
* Migration carries the cross rows whole: raw continues bit for bit, and
  the int8 snapshot equals the reference's bit for bit.
* The engine (with and without a scenario), the cluster with frames and
  ``serve_poisson`` / ``serve`` run the family.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import core as ref_core
from repro.configs import get_config as ref_config
from repro.core import resilience as ref_res
from repro.models import Model as RefModel
from repro.models import attention as ref_attn
from repro.serving import ClusterConfig as RefClusterConfig
from repro.serving import ContinuousBatchScheduler as RefScheduler
from repro.serving import Request as RefRequest
from repro.serving import SchedulerConfig as RefConfig
from repro.serving import TieredServingCluster as RefCluster
from repro.serving import prime_whisper_cross_cache as ref_prime
from repro_torch import core
from repro_torch.bridge import params_from_jax
from repro_torch.configs import get_config
from repro_torch.core import resilience
from repro_torch.launch.serve import serve, serve_poisson
from repro_torch.models import Model
from repro_torch.models import attention
from repro_torch.models.common import tree_map
from repro_torch.serving import (ClusterConfig, ContinuousBatchScheduler,
                                 ModelGroup, Request, SchedulerConfig,
                                 SlotSnapshot, SpecPair, TieredServingCluster,
                                 prime_whisper_cross_cache)

ARCH = "whisper-base-smoke"
DRAFT = "granite-3-2b-smoke"
OUT_TOL = 4e-2      # of max(1, |ref|): bf16 encoder outputs and cross rows
LOGIT_ATOL = 2e-2
EXIT_ATOL = 4e-2
ENT_ATOL = 5e-3
TIE = 1e-2
T_ENC = 32          # the smoke encoder's frames
SEQ = 24            # decoder tokens of a forward row


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread while this module runs: its tensors are small,
    and parallel test workers share the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def wh():
    rm = RefModel(ref_config(ARCH))
    rp = rm.init(jax.random.PRNGKey(0))
    tm = Model(get_config(ARCH), device="cpu")
    return rm, rp, tm, params_from_jax(jax.tree.map(np.asarray, rp))


def _f32(a):
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def _close(got, want, tol=OUT_TOL):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    err = np.abs(got - want) / np.maximum(1.0, np.abs(want))
    assert np.isfinite(got).all() and err.max() <= tol, err.max()


def _frames(rs, *lead, d=256):
    """0.02 N(0, 1) fp32 frames [*lead, Tenc, D] from ``rs``."""
    return 0.02 * rs.randn(*lead, T_ENC, d).astype(np.float32)


def _bf16(a):
    """A numpy float array as the same bf16 values in both frameworks."""
    j = jnp.asarray(a, jnp.bfloat16)
    return j, torch.from_numpy(np.array(_f32(j))).bfloat16()


def _batch(cfg, seed, b=2):
    rs = np.random.RandomState(seed)
    toks = rs.randint(0, cfg.vocab_size, (b, SEQ)).astype(np.int32)
    jf, tf = _bf16(_frames(rs, b))
    return ({"tokens": jnp.asarray(toks), "frames": jf},
            {"tokens": torch.from_numpy(toks).long(), "frames": tf})


@pytest.mark.parametrize("smoke", [False, True], ids=["full", "smoke"])
def test_config_fields_equal_reference(smoke):
    name = "whisper-base" + ("-smoke" if smoke else "")
    assert dataclasses.asdict(get_config(name)) \
        == dataclasses.asdict(ref_config(name))
    cfg = get_config(name)
    assert (cfg.family, cfg.rope, cfg.norm, cfg.tie_embeddings) == (
        "encdec", "none", "layernorm", True)
    assert (cfg.encdec.num_encoder_layers, cfg.encdec.encoder_seq_len) == (
        (2, 32) if smoke else (6, 1500))


def test_encode_and_forward_match_reference(wh):
    rm, rp, tm, tp = wh
    jb, tb = _batch(tm.cfg, 1)
    enc = tm.encode(tp, tb["frames"])
    assert enc.dtype == torch.bfloat16 and tuple(enc.shape) == (
        2, T_ENC, tm.cfg.d_model)
    _close(enc.float().numpy(), _f32(rm.encode(rp, jb["frames"])))
    want = rm.forward(rp, jb)
    got = tm.forward(tp, tb)
    assert torch.isfinite(got.logits).all()
    np.testing.assert_allclose(got.logits.numpy(), np.asarray(want.logits),
                               rtol=0, atol=LOGIT_ATOL)
    assert len(got.exit_logits) == len(want.exit_logits) == 1
    np.testing.assert_allclose(got.exit_logits[0].numpy(),
                               np.asarray(want.exit_logits[0]), rtol=0,
                               atol=EXIT_ATOL)


def test_cross_attention_matches_reference(wh):
    """Layer 0's cross-attention over the full sequence (24 queries
    against 32 encoder rows, unmasked) and at one decode token, each
    against the reference's on the same bf16 inputs."""
    rm, rp, tm, tp = wh
    rs = np.random.RandomState(2)
    jx, tx = _bf16(rs.randn(2, SEQ, 256))
    je, te = _bf16(rs.randn(2, T_ENC, 256))
    jl = jax.tree.map(lambda a: a[0], rp["blocks"][0]["cross_attn"])
    tl = tree_map(lambda a: a[0], tp["blocks"][0]["cross_attn"])
    pos = tm.positions_for(2, SEQ)
    want, (wk, wv) = ref_attn.gqa_forward(rm.cfg, jl, jx,
                                          rm.positions_for(2, SEQ), kv_x=je)
    got, (gk, gv) = attention.gqa_forward(tm.cfg, tl, tx, pos, kv_x=te)
    _close(got.float().numpy(), _f32(want))
    _close(gk.float().numpy(), _f32(wk))
    want = ref_attn.cross_decode(rm.cfg, jl, jx[:, :1], wk, wv)
    got = attention.cross_decode(tm.cfg, tl, tx[:, :1], gk, gv)
    _close(got.float().numpy(), _f32(want))


@pytest.mark.parametrize("dead", ["none", "first"])
def test_resilient_forward_with_frames(wh, dead):
    rm, rp, tm, tp = wh
    n = resilience.n_scan_blocks(tm)
    alive = np.ones(n, np.float32)
    if dead == "first":
        alive[0] = 0.0
    jb, tb = _batch(tm.cfg, 3)
    want, want_ee = ref_res.resilient_forward(rm, rp, jb, jnp.asarray(alive))
    got, got_ee = resilience.resilient_forward(tm, tp, tb,
                                               torch.from_numpy(alive))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=LOGIT_ATOL)
    np.testing.assert_allclose(got_ee[0].numpy(), np.asarray(want_ee[0]),
                               rtol=0, atol=EXIT_ATOL)
    if dead == "none":
        np.testing.assert_allclose(got.numpy(),
                                   tm.forward(tp, tb).logits.numpy(),
                                   rtol=0, atol=1e-3)


def test_primed_decode_matches_reference(wh):
    """Cross rows primed from the same frames, then eight decode steps at
    ragged per-slot positions."""
    rm, rp, tm, tp = wh
    b = 3
    rs = np.random.RandomState(4)
    jf, tf = _bf16(_frames(rs, b))
    rc = ref_prime(rm, rp, rm.init_decode_cache(b, 40), jf)
    tc = tm.init_decode_cache(b, 40)
    assert prime_whisper_cross_cache(tm, tp, tc, tf) is tc
    for (gk, gv), (wk, wv) in zip(
            [c["cross"] for c in tc["blocks"]],
            [c["cross"] for c in rc["blocks"]]):
        assert gk.dtype == torch.bfloat16 and tuple(gk.shape) == wk.shape
        _close(gk.float().numpy(), _f32(wk))
        _close(gv.float().numpy(), _f32(wv))
    pos = np.array([0, 3, 9], np.int32)
    for _ in range(8):
        toks = rs.randint(0, tm.cfg.vocab_size, (b, 1)).astype(np.int32)
        rl, ree, rc = rm.decode_step(rp, rc, jnp.asarray(toks),
                                     jnp.asarray(pos))
        tl, tee, tc = tm.decode_step(tp, tc, torch.from_numpy(toks).long(),
                                     torch.from_numpy(pos))
        rl = np.asarray(rl)
        np.testing.assert_allclose(tl.numpy(), rl, rtol=0, atol=LOGIT_ATOL)
        np.testing.assert_allclose(tee.numpy(), np.asarray(ree), rtol=0,
                                   atol=ENT_ATOL)
        for g, w in zip(tl.numpy(), rl):
            a, c = int(g.argmax()), int(w.argmax())
            assert a == c or 0.0 <= w[c] - w[a] < TIE
        pos = pos + 1


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------

KW = dict(n_slots=2, max_len=48, prefill_chunk=8, exit_threshold=0.5)
LENS = (5, 14, 9, 3, 11)
MAX_NEW = [3, 9, 5, 7, 4]      # slot 0 frees early: slots re-admitted


def _requests(cls, seed, lens=LENS, max_new=MAX_NEW):
    rs = np.random.RandomState(seed)
    out = []
    for i, (n, m) in enumerate(zip(lens, max_new)):
        toks = rs.randint(0, 1024, n).astype(np.int32)
        out.append(cls(tokens=toks, max_new=m, req_id=i,
                       frames=_frames(rs)))
    return out


def _serve(sched, reqs):
    for r in reqs:
        sched.submit(r)
    sched.run()
    return [list(r.out_tokens) for r in reqs]


def _ref_replay(rm, rp, frames, seq):
    """The reference's logits at each position of ``seq``, decoded one
    token at a time over cross rows primed from ``frames`` [Tenc, D]."""
    cache = ref_prime(rm, rp, rm.init_decode_cache(1, len(seq)),
                      jnp.asarray(frames[None], jnp.bfloat16))
    step = jax.jit(rm.decode_step)
    out = []
    for t, tok in enumerate(seq):
        lg, _, cache = step(rp, cache, jnp.asarray([[tok]], jnp.int32),
                            jnp.int32(t))
        out.append(np.asarray(lg[0]))
    return np.stack(out)


def _tie_or_equal(rm, rp, req, got, want):
    got, want = [int(t) for t in got], [int(t) for t in want]
    assert len(got) == len(want)
    if got == want:
        return True
    seq = np.concatenate([req.tokens, np.asarray(want[:-1], np.int32)])
    logs = _ref_replay(rm, rp, req.frames, seq)[req.tokens.size - 1:]
    k = next(i for i, (a, b) in enumerate(zip(got, want)) if a != b)
    top = float(logs[k].max())
    gaps = [top - float(logs[k][t]) for t in (got[k], want[k])]
    assert max(gaps) < TIE, f"token {k}: ref logit gaps {gaps}"
    return False


@pytest.fixture(scope="module")
def ref_streams(wh):
    rm, rp, _, _ = wh
    ref = RefScheduler(rm, rp, RefConfig(**KW))
    reqs = _requests(RefRequest, 5)
    return _serve(ref, reqs), ref.tokens_served, ref.exit_counts.copy()


@pytest.mark.parametrize("segmented", [True, False], ids=["seg", "mono"])
def test_scheduler_greedy_matches_reference(wh, ref_streams, segmented):
    """Five requests through two contiguous slots (a slot freed after
    three tokens is re-admitted while the other decodes)."""
    rm, rp, tm, tp = wh
    want, served, counts = ref_streams
    s = ContinuousBatchScheduler(tm, tp, SchedulerConfig(
        segmented=segmented, **KW), device="cpu")
    reqs = _requests(Request, 5)
    got = _serve(s, reqs)
    for r, g, w in zip(reqs, got, want):
        _tie_or_equal(rm, rp, r, g, w)
    assert s.tokens_served == served
    np.testing.assert_array_equal(s.exit_counts, counts)
    assert s.n_admitted == len(LENS)


def test_async_windows_equal_sync_poll(wh):
    """Seven requests through three slots, windows of 4: rows finish
    mid-window and their slots are re-admitted with other frames; tokens
    equal the sync monolithic poll's bit for bit, with one build."""
    _, _, tm, tp = wh
    lens = (5, 12, 7, 20, 3, 9, 6)
    max_new = [3, 11, 6, 8, 5, 10, 4]
    outs = []
    for async_decode in (False, True):
        s = ContinuousBatchScheduler(tm, tp, SchedulerConfig(
            n_slots=3, max_len=48, prefill_chunk=8, segmented=False,
            async_decode=async_decode, readback_interval=4), device="cpu")
        outs.append(_serve(s, _requests(Request, 6, lens, max_new)))
    assert outs[0] == outs[1]
    assert s.jit_cache_sizes() == {"decode_window": 1}


def test_paged_spec_pair_and_missing_frames_are_refused(wh):
    rm, rp, tm, tp = wh
    kw = dict(n_slots=2, max_len=48, paged=True, page_size=16)
    with pytest.raises(ValueError, match="encdec"):
        ContinuousBatchScheduler(tm, tp, SchedulerConfig(**kw), device="cpu")
    with pytest.raises(AssertionError):
        RefScheduler(rm, rp, RefConfig(**kw))
    with pytest.raises(ValueError, match="encdec"):
        tm.init_decode_cache_paged(2, 4, 16)
    with pytest.raises(AssertionError):
        rm.init_decode_cache_paged(2, 4, 16)
    s = ContinuousBatchScheduler(tm, tp, SchedulerConfig(**KW), device="cpu")
    with pytest.raises(ValueError, match="frames"):
        s.submit(Request(tokens=np.arange(4), max_new=2))
    gm = Model(get_config(DRAFT), device="cpu")
    pair = SpecPair(ModelGroup([(DRAFT, gm, gm.init(1)), (ARCH, tm, tp)]),
                    SchedulerConfig(**dict(KW, exit_threshold=0.0)), k=2)
    req = _requests(Request, 7, (4,), [3])[0]
    with pytest.raises(ValueError, match="encdec"):
        pair.submit(req)


def _mid_flight(tm, tp, req, polls=4, n_slots=2):
    s = ContinuousBatchScheduler(tm, tp, SchedulerConfig(
        **dict(KW, n_slots=n_slots)), device="cpu")
    s.submit(req)
    for _ in range(polls):
        s.poll()
    assert not req.done and s.active[req.slot]
    return s


def test_raw_migration_carries_cross_rows(wh):
    """Exported mid-flight (cross rows whole, self rows cut to the written
    prefix), released, the slot re-admitted with other frames, imported
    into a three-slot arena beside a neighbour: the greedy continuation
    equals the unmigrated run's."""
    _, _, tm, tp = wh
    want = _serve(ContinuousBatchScheduler(
        tm, tp, SchedulerConfig(**KW), device="cpu"),
        _requests(Request, 8, (9,), [10]))[0]
    req = _requests(Request, 8, (9,), [10])[0]
    src = _mid_flight(tm, tp, req)
    # per decx block: cross (k, v) ship whole, self (k, v) cut on axis 1
    assert src._row_axes_flat == [-1, -1, 1, 1] * len(src.cache["blocks"])
    snap = src.export_slot(req.slot)
    assert snap.payload_bytes == src.slot_payload_bytes(req.slot)
    src.release_slot(req.slot)
    _serve(src, _requests(Request, 9, (6,), [4]))   # the slot's next occupant
    dst = ContinuousBatchScheduler(tm, tp, SchedulerConfig(
        **dict(KW, n_slots=3)), device="cpu")
    dst.submit(_requests(Request, 10, (5,), [4])[0])
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


def test_int8_snapshot_matches_reference_bitwise(wh):
    """The reference's raw snapshot (cross rows included) imported into
    the port: the port's raw export equals it bit for bit, its int8
    export equals the reference's ``compress=True`` export bit for bit,
    and the int8 payload continues decoding elsewhere."""
    rm, rp, tm, tp = wh
    ref = RefScheduler(rm, rp, RefConfig(**KW))
    r = _requests(RefRequest, 11, (9,), [10])[0]
    ref.submit(r)
    for _ in range(5):
        ref.poll()
    raw = ref.export_slot(r.slot)
    want = ref.export_slot(r.slot, compress=True)
    port = ContinuousBatchScheduler(tm, tp, SchedulerConfig(**KW),
                                    device="cpu")
    req = Request(tokens=r.tokens.copy(), max_new=10, req_id=r.req_id,
                  frames=r.frames, out_tokens=list(r.out_tokens))
    slot = port.import_slot(SlotSnapshot(
        req=req, position=raw.position, current_tok=raw.current_tok,
        steps_taken=raw.steps_taken, compressed=False,
        payload=[_to_torch(a) for a in raw.payload],
        scales=[None] * len(raw.payload), payload_bytes=raw.payload_bytes,
        paged=False))
    same = port.export_slot(slot)
    assert [tuple(a.shape) for a in same.payload] \
        == [tuple(np.shape(a)) for a in raw.payload]
    for a, b in zip(same.payload, raw.payload):
        np.testing.assert_array_equal(_bits(a), _bits(_to_torch(b)))
    got = port.export_slot(slot, compress=True)
    assert got.payload_bytes == want.payload_bytes
    for q, s, wq, ws in zip(got.payload, got.scales, want.payload,
                            want.scales):
        np.testing.assert_array_equal(q.numpy(), np.asarray(wq))
        np.testing.assert_array_equal(_bits(s), _bits(_to_torch(ws)))
    port.release_slot(slot)
    dst = ContinuousBatchScheduler(tm, tp, SchedulerConfig(
        **dict(KW, n_slots=3)), device="cpu")
    dst.import_slot(got)
    dst.run()
    assert got.req.done and len(got.req.out_tokens) == 10


def test_engine_with_and_without_scenario(wh):
    """``ServingEngine.generate(frames=)`` equals a scheduler run bit for
    bit and the reference engine's tokens under the tie rule; the tiered
    engine equals the single pool bit for bit and routes as the
    reference's."""
    from repro.serving import ServeConfig as RefServeConfig
    from repro.serving import ServingEngine as RefEngine
    from repro_torch.serving import ServeConfig, ServingEngine
    rm, rp, tm, tp = wh
    rs = np.random.RandomState(12)
    prompts = rs.randint(0, 1024, (4, 10)).astype(np.int32)
    frames = _frames(rs, 4)
    single = ServingEngine(tm, tp, ServeConfig(exit_threshold=0.5))
    with pytest.raises(ValueError, match="frames"):
        single.generate(prompts, max_new=6)
    got = single.generate(prompts, max_new=6, frames=frames)
    s = ContinuousBatchScheduler(tm, tp, SchedulerConfig(
        n_slots=4, max_len=16, exit_threshold=0.5), device="cpu")
    reqs = [Request(tokens=p, max_new=6, frames=f)
            for p, f in zip(prompts, frames)]
    assert got.tolist() == _serve(s, reqs)
    ref = RefEngine(rm, rp, RefServeConfig(exit_threshold=0.5))
    want = np.asarray(ref.generate(jnp.asarray(prompts), max_new=6,
                                   frames=jnp.asarray(frames)))
    for r, g, w in zip(reqs, got.tolist(), want.tolist()):
        _tie_or_equal(rm, rp, r, g, w)
    tiered = ServingEngine(tm, tp, ServeConfig(exit_threshold=0.5),
                           scenario=core.Scenario.default(),
                           plan_cfg=get_config("whisper-base"))
    assert tiered.generate(prompts, max_new=6,
                           frames=frames).tolist() == got.tolist()
    ref_t = RefEngine(rm, rp, RefServeConfig(exit_threshold=0.5),
                      scenario=ref_core.Scenario.default(),
                      plan_cfg=ref_config("whisper-base"))
    ref_t.generate(jnp.asarray(prompts), max_new=6,
                   frames=jnp.asarray(frames))
    assert tiered.route_counts == ref_t.route_counts
    assert sum(tiered.route_counts.values()) == 4


def _run_cluster(cls, cfg_cls, mod, model, params, plan):
    cl = cls(model, params, scenario=mod.Scenario.tier_outage("edge",
                                                              at=0.02),
             plan_cfg=plan,
             cfg=cfg_cls(base_slots=2, max_len=48, prefill_chunk=8,
                         kv_handoff="raw"))
    rs = np.random.RandomState(13)
    crs = []
    for i in range(6):
        toks = rs.randint(0, 1024, int(rs.randint(3, 12)))
        crs.append(cl.submit(toks, max_new=5, arrival=0.01 * i,
                             deadline=0.05, frames=_frames(rs)))
    cl.run()
    return cl, crs


def test_cluster_with_frames_matches_reference(wh):
    """whisper smoke behind the tiered cluster with an edge outage,
    planned as the published whisper-base: routes, the migration ledger
    and per-tier counts equal the reference cluster's, and every stream
    its tokens under the tie rule."""
    rm, rp, tm, tp = wh
    cl, crs = _run_cluster(TieredServingCluster, ClusterConfig, core, tm, tp,
                           get_config("whisper-base"))
    ref_cl, ref_crs = _run_cluster(RefCluster, RefClusterConfig, ref_core,
                                   rm, rp, ref_config("whisper-base"))
    st, want = cl.stats(), ref_cl.stats()
    assert st["completed"] == 6
    for key in ("requests", "completed", "splits", "route_counts",
                "migration", "dead_tiers"):
        assert st.get(key) == want.get(key), key
    for cr, rc in zip(crs, ref_crs):
        assert (cr.decision.tier, cr.final_tier, cr.migrations,
                cr.handoff_bytes) == (rc.decision.tier, rc.final_tier,
                                      rc.migrations, rc.handoff_bytes)
        _tie_or_equal(rm, rp, cr.req, cr.req.out_tokens, rc.req.out_tokens)


def test_serve_poisson_and_batch_drive(wh):
    """``serve_poisson`` (contiguous, segmented; frames drawn per request
    from the seeded generator) and the batch mode's ``serve``."""
    _, _, tm, tp = wh
    st = serve_poisson(ARCH, rate=200.0, n_requests=4, slots=2,
                       prompt_len=12, max_new=4, params=tp, device="cpu",
                       quiet=True)
    assert st["tokens"] == 16
    assert all(len(o) == 4 and all(0 <= t < 1024 for t in o)
               for o in st["outputs"])
    out, stats = serve(ARCH, 2, 8, 3, params=tp, device="cpu", quiet=True)
    assert tuple(out.shape) == (2, 3) and stats["tokens"] == 6
