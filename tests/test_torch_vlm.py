"""The vision-language family (qwen2-vl-2b-smoke: M-RoPE positions and
vision-patch inputs) in the port, on the CPU against the reference on the
same weights (``bridge.params_from_jax``) and the same seeded numpy
inputs.

* The config equals the reference's field by field, published and smoke.
* ``positions_for`` equals the reference's exactly for no patches, 16
  patches and more patches than tokens, with and without an offset
  (quirk included: text-only forward positions start at 1, decode
  positions at 0).
* ``embed_inputs`` merges the patch embeddings as the reference does, bit
  for bit.
* ``Model.forward`` with patch embeddings (and text only): logits and exit
  logits within 4e-2, the bound of the other untied-head configs
  (``tests/test_torch_dense_configs.py``); ``resilient_forward`` with
  patches likewise, all blocks alive or block 0 dead.
* ``decode_step`` on the contiguous and the paged arena: logits within
  2e-2, exit entropies within 5e-3, greedy equal or tied.
* The scheduler's greedy tokens (paged and contiguous, segmented and
  monolithic) equal the reference's under the parity contract (a first
  difference only at a top-2 tie within 1e-2 of the reference's replay
  logits); async windows equal the port's sync poll bit for bit.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_config
from repro.core import resilience as ref_res
from repro.models import Model as RefModel
from repro.models import attention as ref_attn
from repro.serving import ContinuousBatchScheduler as RefScheduler
from repro.serving import Request as RefRequest
from repro.serving import SchedulerConfig as RefConfig
from repro_torch.bridge import params_from_jax
from repro_torch.configs import get_config
from repro_torch.core import resilience
from repro_torch.models import Model
from repro_torch.models.attention import PagedKV
from repro_torch.serving import (ContinuousBatchScheduler, Request,
                                 SchedulerConfig)

ARCH = "qwen2-vl-2b-smoke"
LOGIT_ATOL = 2e-2
FWD_ATOL = 4e-2
ENT_ATOL = 5e-3
TIE = 1e-2
SEQ = 40            # forward tokens a row (16 patches + 24 text)


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread while this module runs: its tensors are small,
    and parallel test workers share the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def vlm():
    rm = RefModel(ref_config(ARCH))
    rp = rm.init(jax.random.PRNGKey(0))
    tm = Model(get_config(ARCH), device="cpu")
    return rm, rp, tm, params_from_jax(jax.tree.map(np.asarray, rp))


def _f32(a):
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def _batch(cfg, seed, patches=True):
    """The same batch for both packages: tokens, and 0.02 N(0, 1) bf16
    patch embeddings [B, Tf, D] (the reference's own smoke batch)."""
    rs = np.random.RandomState(seed)
    toks = rs.randint(0, cfg.vocab_size, (2, SEQ)).astype(np.int32)
    jb = {"tokens": jnp.asarray(toks)}
    tb = {"tokens": torch.from_numpy(toks).long()}
    if patches:
        pe = jnp.asarray(0.02 * rs.randn(2, cfg.frontend_tokens, cfg.d_model),
                         jnp.bfloat16)
        jb["patch_embeds"] = pe
        tb["patch_embeds"] = torch.from_numpy(np.array(_f32(pe))).bfloat16()
    return jb, tb


@pytest.mark.parametrize("smoke", [False, True], ids=["full", "smoke"])
def test_config_fields_equal_reference(smoke):
    name = "qwen2-vl-2b" + ("-smoke" if smoke else "")
    assert dataclasses.asdict(get_config(name)) \
        == dataclasses.asdict(ref_config(name))
    cfg = get_config(name)
    assert (cfg.family, cfg.rope, cfg.frontend) == ("vlm", "mrope",
                                                    "vision_patches")
    assert cfg.frontend_tokens == (16 if smoke else 1024)


@pytest.mark.parametrize("offset", [0, 5])
@pytest.mark.parametrize("tf", [0, 16, 50])
def test_positions_for_equals_reference(vlm, tf, offset):
    """[3, B, S] (t, h, w) exactly as the reference's, for S = 40: no
    patches (text from 1), a 4 x 4 patch grid, and more patches than
    tokens (an 8 x 8 grid cut at 40)."""
    rm, _, tm, _ = vlm
    want = np.asarray(rm.positions_for(2, SEQ, tf, offset))
    got = tm.positions_for(2, SEQ, tf, offset)
    assert got.dtype == torch.int32 and tuple(got.shape) == (3, 2, SEQ)
    np.testing.assert_array_equal(got.numpy(), want)
    if tf == 0:
        assert int(got[0, 0, 0]) == 1 + offset


def test_embed_inputs_merges_patches_bitwise(vlm):
    rm, rp, tm, tp = vlm
    jb, tb = _batch(tm.cfg, 1)
    want = _f32(rm.embed_inputs(rp, jb))
    got = tm.embed_inputs(tp, tb)
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(), want)
    np.testing.assert_array_equal(got[:, :16].float().numpy(),
                                  tb["patch_embeds"].float().numpy())


@pytest.mark.parametrize("patches", [True, False], ids=["patches", "text"])
def test_forward_matches_reference(vlm, patches):
    """``Model.forward`` on 2 x 40 tokens: logits and the exit head's
    logits within 4e-2 (untied head), every value finite."""
    rm, rp, tm, tp = vlm
    jb, tb = _batch(tm.cfg, 2, patches)
    want = rm.forward(rp, jb)
    got = tm.forward(tp, tb)
    assert torch.isfinite(got.logits).all()
    np.testing.assert_allclose(got.logits.numpy(), np.asarray(want.logits),
                               rtol=0, atol=FWD_ATOL)
    assert len(got.exit_logits) == len(want.exit_logits) == 1
    np.testing.assert_allclose(got.exit_logits[0].numpy(),
                               np.asarray(want.exit_logits[0]), rtol=0,
                               atol=FWD_ATOL)


@pytest.mark.parametrize("dead", ["none", "first"])
def test_resilient_forward_with_patches(vlm, dead):
    rm, rp, tm, tp = vlm
    n = resilience.n_scan_blocks(tm)
    alive = np.ones(n, np.float32)
    if dead == "first":
        alive[0] = 0.0
    jb, tb = _batch(tm.cfg, 3)
    want, want_ee = ref_res.resilient_forward(rm, rp, jb, jnp.asarray(alive))
    got, got_ee = resilience.resilient_forward(tm, tp, tb,
                                               torch.from_numpy(alive))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=FWD_ATOL)
    np.testing.assert_allclose(got_ee[0].numpy(), np.asarray(want_ee[0]),
                               rtol=0, atol=FWD_ATOL)
    if dead == "none":
        full = tm.forward(tp, tb)
        np.testing.assert_allclose(got.numpy(), full.logits.numpy(),
                                   rtol=0, atol=1e-3)


@pytest.mark.parametrize("arena", ["contiguous", "paged"])
def test_decode_step_matches_reference(vlm, arena):
    """Eight steps at ragged per-slot positions: scalar positions take
    M-RoPE's three equal components on both sides."""
    rm, rp, tm, tp = vlm
    b = 3
    pos = np.array([0, 3, 9], np.int32)
    if arena == "paged":
        page, pps = 16, 2
        n_pages = b * pps
        tbl = np.random.RandomState(0).permutation(n_pages).reshape(
            b, pps).astype(np.int32)
        rc = rm.init_decode_cache_paged(b, n_pages, page)
        tc = tm.init_decode_cache_paged(b, n_pages, page)
    else:
        rc, tc = rm.init_decode_cache(b, 64), tm.init_decode_cache(b, 64)
    rs = np.random.RandomState(4)
    for _ in range(8):
        toks = rs.randint(0, tm.cfg.vocab_size, (b, 1)).astype(np.int32)
        kw_r, kw_t = {}, {}
        if arena == "paged":
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


def _prompts(seed, lens, vocab):
    rs = np.random.RandomState(seed)
    return [rs.randint(0, vocab, n).astype(np.int32) for n in lens]


def _serve(sched, cls, prompts, max_new):
    reqs = [cls(tokens=p, max_new=max_new, req_id=i)
            for i, p in enumerate(prompts)]
    for r in reqs:
        sched.submit(r)
    sched.run()
    return [list(r.out_tokens) for r in reqs]


def _assert_tie_or_equal(rm, rp, prompts, got_all, want_all):
    for p, got, want in zip(prompts, got_all, want_all):
        assert len(got) == len(want)
        if got == want:
            continue
        seq = np.concatenate([p, np.asarray(want[:-1], np.int32)])
        logits, _ = rm.prefill(rp, {"tokens": jnp.asarray(seq)[None]})
        logs = np.asarray(logits[0, p.size - 1:])
        k = next(i for i, (a, b) in enumerate(zip(got, want)) if a != b)
        gap = float(logs[k][want[k]] - logs[k][got[k]])
        assert 0.0 <= gap < TIE, f"token {k}: ref logit gap {gap:.3e}"


KW = dict(n_slots=2, max_len=64, prefill_chunk=8, page_size=16,
          exit_threshold=0.5)
LENS = (5, 20, 33, 9)
MAX_NEW = 6


@pytest.fixture(scope="module")
def ref_streams(vlm):
    """The reference scheduler's streams, paged segmented and contiguous
    monolithic (four prompts through two slots, slots reused)."""
    rm, rp, tm, _ = vlm
    prompts = _prompts(5, LENS, tm.cfg.vocab_size)
    out = {}
    for paged in (True, False):
        ref = RefScheduler(rm, rp, RefConfig(paged=paged, segmented=paged,
                                             **KW))
        out[paged] = (_serve(ref, RefRequest, prompts, MAX_NEW),
                      ref.tokens_served, ref.exit_counts.copy())
    return prompts, out


@pytest.mark.parametrize("paged", [True, False], ids=["paged", "contig"])
@pytest.mark.parametrize("segmented", [True, False], ids=["seg", "mono"])
def test_scheduler_greedy_matches_reference(vlm, ref_streams, paged,
                                            segmented):
    """The port's streams against the reference's on the same arena
    (paged segmented, contiguous monolithic; the step's form moves no
    token while no exit fires): the parity contract's tie rule is the
    only excuse."""
    rm, rp, tm, tp = vlm
    prompts, ref = ref_streams
    want, served, counts = ref[paged]
    s = ContinuousBatchScheduler(tm, tp, SchedulerConfig(
        paged=paged, segmented=segmented, **KW), device="cpu")
    got = _serve(s, Request, prompts, MAX_NEW)
    _assert_tie_or_equal(rm, rp, prompts, got, want)
    assert s.tokens_served == served
    np.testing.assert_array_equal(s.exit_counts, counts)
    if paged:
        assert s.prefix_cache is not None


@pytest.mark.parametrize("paged", [True, False], ids=["paged", "contig"])
def test_async_windows_equal_sync_poll(vlm, paged):
    """Six requests through three slots, max_new 3 to 11, windows of 4:
    tokens equal the sync monolithic poll's bit for bit, one build."""
    _, _, tm, tp = vlm
    prompts = _prompts(6, (5, 12, 7, 20, 3, 9), tm.cfg.vocab_size)
    max_new = [3, 11, 6, 8, 5, 10]
    outs = []
    for async_decode in (False, True):
        s = ContinuousBatchScheduler(tm, tp, SchedulerConfig(
            n_slots=3, max_len=64, prefill_chunk=8, page_size=16,
            paged=paged, segmented=False, async_decode=async_decode,
            readback_interval=4), device="cpu")
        reqs = [Request(tokens=p, max_new=n, req_id=i)
                for i, (p, n) in enumerate(zip(prompts, max_new))]
        for r in reqs:
            s.submit(r)
        s.run()
        outs.append([list(r.out_tokens) for r in reqs])
    assert outs[0] == outs[1]
    assert s.jit_cache_sizes() == {"decode_window": 1}
