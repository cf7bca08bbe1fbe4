"""The port's other dense configs against the reference package on the
same weights, at smoke widths on the CPU: yi-6b (G 2 at smoke size),
starcoder2-3b (LayerNorm, tanh GELU, a native sliding window of 64 at
smoke size on the contiguous ring cache) and mistral-nemo-12b (an explicit
head dim; 64 at smoke size).

Tolerances as in ``tests/test_torch_model.py``: decode logits are bf16
matmul results (atol 2e-2), exit entropies come from them (atol 5e-3).
The full-sequence forward rounds in other places than the reference's
(XLA keeps fused elementwise chains in fp32, eager torch rounds after each
op, so about half of a layer's bf16 outputs are an ulp apart), and these
models read logits through an untied head: forward logits and exit
logits atol 4e-2, the bound ``tests/test_torch_forward.py`` holds the
forward's exit logits to.  Greedy
tokens follow the parity contract: equal, except at a bf16 top-2 tie of
the reference's logits (within 1e-2), after which the comparison of that
stream stops.  Starcoder2 runs past its window (more than 64 tokens) in
every check, as the reference's own ring-cache tests do.
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
from repro.serving import ContinuousBatchScheduler as RefScheduler
from repro.serving import Request as RefRequest
from repro.serving import SchedulerConfig as RefConfig
from repro_torch.bridge import params_from_jax
from repro_torch.configs import get_config
from repro_torch.models import Model
from repro_torch.models.attention import PagedKV
from repro_torch.serving import (ContinuousBatchScheduler, Request,
                                 SchedulerConfig)

ARCHS = ["yi-6b", "starcoder2-3b", "mistral-nemo-12b"]
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


@pytest.fixture(scope="module", params=ARCHS)
def pair(request):
    arch = request.param + "-smoke"
    rm = RefModel(ref_config(arch))
    rp = rm.init(jax.random.PRNGKey(0))
    tm = Model(get_config(arch), device="cpu")
    return rm, rp, tm, params_from_jax(jax.tree.map(np.asarray, rp))


def _windowed(tm) -> bool:
    return tm.cfg.attention == "sliding"


@pytest.mark.parametrize("smoke", [False, True], ids=["full", "smoke"])
@pytest.mark.parametrize("arch", ARCHS)
def test_config_fields_equal_reference(arch, smoke):
    name = arch + ("-smoke" if smoke else "")
    assert dataclasses.asdict(get_config(name)) \
        == dataclasses.asdict(ref_config(name))
    cfg = get_config(arch)
    if arch == "mistral-nemo-12b":
        assert cfg.num_heads * cfg.resolved_head_dim == 4096 != cfg.d_model
    if arch == "starcoder2-3b":
        assert (cfg.attention, cfg.sliding_window, cfg.norm, cfg.act,
                cfg.num_heads // cfg.num_kv_heads) == (
            "sliding", 4096, "layernorm", "gelu", 12)
        assert get_config(name).sliding_window == (64 if smoke else 4096)


def test_decode_step_matches_reference(pair):
    """Eight decode steps at ragged per-slot positions, contiguous and
    (yi, nemo) paged: logits and exit entropies allclose, greedy equal or
    tied.  Starcoder2's positions start past its window of 64, so its ring
    slots wrap."""
    rm, rp, tm, tp = pair
    b = 3
    arenas = ["contiguous"] if _windowed(tm) else ["contiguous", "paged"]
    for arena in arenas:
        pos = np.array([0, 3, 9], np.int32)
        if _windowed(tm):
            assert tm.init_decode_cache(b, 200)["blocks"][0][0].shape[2] \
                == 64
            pos = np.array([60, 130, 5], np.int32)
        if arena == "paged":
            page, pps = 16, 2
            n_pages = b * pps
            tbl = np.random.RandomState(0).permutation(n_pages).reshape(
                b, pps).astype(np.int32)
            rc = rm.init_decode_cache_paged(b, n_pages, page)
            tc = tm.init_decode_cache_paged(b, n_pages, page)
        else:
            rc, tc = rm.init_decode_cache(b, 200), tm.init_decode_cache(b, 200)
        rs = np.random.RandomState(1)
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
            tl, tee, tc = tm.decode_step(tp, tc,
                                         torch.from_numpy(toks).long(),
                                         torch.from_numpy(pos), **kw_t)
            rl = np.asarray(rl)
            np.testing.assert_allclose(tl.numpy(), rl, rtol=0,
                                       atol=LOGIT_ATOL)
            np.testing.assert_allclose(tee.numpy(), np.asarray(ree),
                                       rtol=0, atol=ENT_ATOL)
            for g, w in zip(tl.numpy(), rl):
                a, c = int(g.argmax()), int(w.argmax())
                assert a == c or 0.0 <= w[c] - w[a] < TIE
            pos = pos + 1


def test_exit_probe_and_prefill_match_reference(pair):
    """The fused exit probe's entropy, and the decode replay
    (``Model.prefill``) over 72 tokens, past starcoder2's window: every
    position's logits allclose."""
    rm, rp, tm, tp = pair
    toks = np.random.RandomState(2).randint(
        0, tm.cfg.vocab_size, (2, 72)).astype(np.int32)
    rl, _ = rm.prefill(rp, {"tokens": jnp.asarray(toks)})
    tl, _ = tm.prefill(tp, {"tokens": torch.from_numpy(toks).long()})
    np.testing.assert_allclose(tl.numpy(), np.asarray(rl), rtol=0,
                               atol=LOGIT_ATOL)
    x = tm.embed_decode_tokens(tp, torch.from_numpy(toks[:, :1]).long())
    rx = rm.embed_decode_tokens(rp, jnp.asarray(toks[:, :1]))
    np.testing.assert_allclose(
        tm.exit_probe_entropy(tp, 0, x).numpy(),
        np.asarray(rm.exit_probe_entropy(rp, 0, rx)), rtol=0, atol=ENT_ATOL)


def test_forward_matches_reference(pair):
    """``Model.forward`` on 2 x 80 tokens (starcoder2: flash's sliding
    window of 64 through its plain version): logits and exit logits."""
    rm, rp, tm, tp = pair
    toks = np.random.RandomState(3).randint(
        0, tm.cfg.vocab_size, (2, 80)).astype(np.int32)
    want = rm.forward(rp, {"tokens": jnp.asarray(toks)})
    got = tm.forward(tp, {"tokens": torch.from_numpy(toks).long()})
    np.testing.assert_allclose(got.logits.numpy(), np.asarray(want.logits),
                               rtol=0, atol=FWD_ATOL)
    assert len(got.exit_logits) == len(want.exit_logits) == 1
    for g, w in zip(got.exit_logits, want.exit_logits):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                   atol=FWD_ATOL)


def test_scheduler_greedy_matches_reference(pair):
    """Four prompts through two slots (slots reused): yi and nemo on the
    paged arena, starcoder2 on the contiguous ring with prompts and
    continuations past its window.  Greedy tokens under the parity
    contract, equal exit counts and served tokens."""
    rm, rp, tm, tp = pair
    windowed = _windowed(tm)
    rs = np.random.RandomState(4)
    lens = (60, 70, 9, 33) if windowed else (5, 20, 33, 9)
    prompts = [rs.randint(0, tm.cfg.vocab_size, n).astype(np.int32)
               for n in lens]
    max_new = 12 if windowed else 6
    kw = dict(n_slots=2, max_len=96, prefill_chunk=8, paged=not windowed,
              page_size=16, exit_threshold=0.5)
    s = ContinuousBatchScheduler(tm, tp, SchedulerConfig(**kw),
                                 device="cpu")
    ref = RefScheduler(rm, rp, RefConfig(**kw))
    outs = []
    for sched, cls in ((s, Request), (ref, RefRequest)):
        reqs = [cls(tokens=p, max_new=max_new, req_id=i)
                for i, p in enumerate(prompts)]
        for r in reqs:
            sched.submit(r)
        sched.run()
        outs.append([list(r.out_tokens) for r in reqs])
    for p, got, want in zip(prompts, *outs):
        assert len(got) == max_new
        if got == want:
            continue
        seq = np.concatenate([p, np.asarray(want[:-1], np.int32)])
        logits, _ = rm.prefill(rp, {"tokens": jnp.asarray(seq)[None]})
        logs = np.asarray(logits[0, p.size - 1:])
        k = next(i for i, (a, b) in enumerate(zip(got, want)) if a != b)
        gap = float(logs[k][want[k]] - logs[k][got[k]])
        assert 0.0 <= gap < TIE, f"token {k}: ref logit gap {gap:.3e}"
    assert s.tokens_served == ref.tokens_served
    np.testing.assert_array_equal(s.exit_counts, ref.exit_counts)


def test_starcoder2_paged_arena_is_rejected():
    """Both packages refuse a ring window in a paged arena."""
    arch = "starcoder2-3b-smoke"
    tm = Model(get_config(arch), device="cpu")
    rm = RefModel(ref_config(arch))
    kw = dict(n_slots=2, max_len=64, paged=True, page_size=16)
    with pytest.raises(ValueError, match="ring-buffer"):
        ContinuousBatchScheduler(tm, None, SchedulerConfig(**kw),
                                 device="cpu")
    with pytest.raises(AssertionError):
        RefScheduler(rm, None, RefConfig(**kw))
