"""The forward's log-sum-exp and the backward that takes it, on the CPU.

``ref.flash_attention_lse_ref`` (what the forward kernel writes for the
backward when a gradient will be taken) against ``jax.nn.logsumexp`` of
the reference's masked, scaled scores, and ``ops.flash_attention``'s
autograd path (the log-sum-exp saved with q, k, v and the output, the
plain backward taking it) against ``jax.vjp`` of the reference's
``_sdpa``.  Also the dK/dV kernel's split of G over blocks, which is
decided from shapes alone.

Tolerances.  The log-sum-exp: both sides sum the same fp32 exponentials
in another order, 1e-5.  The gradients: PERF.md §2's, 1e-5 of max(1,
|want|) in fp32 and 2e-2 in bf16 (the outputs round to bf16 once, and D
is taken from the forward's bf16 output).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import attention as ref_attn
from repro_torch.kernels import flash_attention as flash
from repro_torch.kernels import ops, ref

torch.set_num_threads(1)

FP32_TOL = 1e-5
BF16_TOL = 2e-2

LSE_CASES = [  # (causal, window, G, Sq, Skv, H)
    (True, 0, 1, 24, 24, 64),
    (True, 0, 4, 24, 24, 128),
    (True, 7, 1, 30, 30, 128),
    (True, 7, 4, 30, 30, 64),
    (True, 1, 4, 9, 9, 64),        # every row sees a single key
    (False, 0, 1, 12, 40, 64),     # cross-attention: no mask
    (False, 0, 4, 40, 12, 128),    # Skv < Sq, no mask
    (True, 0, 4, 20, 33, 64),      # ragged, causal, Sq < Skv
    (True, 0, 1, 33, 20, 128),     # ragged, causal, Sq > Skv
]

GRAD_CASES = [  # (causal, window, G, Sq, Skv, H)
    (True, 0, 1, 24, 24, 64),
    (True, 0, 4, 20, 20, 128),
    (True, 7, 4, 30, 30, 64),
    (True, 1, 1, 9, 9, 64),
    (False, 0, 4, 12, 40, 64),
    (True, 0, 4, 21, 33, 128),
]


def _inputs(dtype, g, sq, skv, h, b=2, nkv=2, seed=0):
    rs = np.random.RandomState(seed)
    q = rs.randn(b, sq, nkv * g, h).astype(np.float32)
    k = rs.randn(b, skv, nkv, h).astype(np.float32)
    v = rs.randn(b, skv, nkv, h).astype(np.float32)
    do = rs.randn(b, sq, nkv * g, h).astype(np.float32)
    return [torch.from_numpy(a).to(dtype) for a in (q, k, v, do)]


def _rel(got, want):
    got, want = got.float(), want.float()
    return ((got - want).abs() / want.abs().clamp(min=1)).max().item()


def _jax(t):
    return jnp.asarray(t.float().numpy()).astype(
        jnp.bfloat16 if t.dtype == torch.bfloat16 else jnp.float32)


@pytest.mark.parametrize("causal,window,g,sq,skv,h", LSE_CASES)
def test_lse_ref_matches_jax_logsumexp(causal, window, g, sq, skv, h):
    q, k, _, _ = _inputs(torch.float32, g, sq, skv, h)
    b, _, nq, _ = q.shape
    nkv = k.shape[2]
    mask = ref_attn.make_mask(sq, skv, causal=causal, window=window)
    qg = jnp.asarray(q.numpy()).reshape(b, sq, nkv, g, h)
    scores = jnp.einsum("bsngh,btnh->bngst", qg, jnp.asarray(k.numpy())) \
        * (1.0 / np.sqrt(h))
    scores = jnp.where(mask[None, None, None], scores, ref_attn.NEG_INF)
    want = np.asarray(jax.nn.logsumexp(scores, axis=-1)).reshape(b, nq, sq)
    got = ref.flash_attention_lse_ref(q, k, causal=causal, window=window)
    assert got.shape == (b, nq, sq) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=FP32_TOL)


def test_forward_with_lse_is_the_plain_pair():
    """On the CPU ``flash_attention_with_lse`` is the plain forward and the
    plain log-sum-exp, bit for bit, and counts no launch."""
    q, k, v, _ = _inputs(torch.bfloat16, 4, 17, 17, 64)
    ops.reset_launches()
    out, lse = ops.flash_attention_with_lse(q, k, v, causal=True, window=5)
    assert torch.equal(out, ref.flash_attention_ref(q, k, v, causal=True,
                                                    window=5))
    assert torch.equal(lse, ref.flash_attention_lse_ref(q, k, causal=True,
                                                        window=5))
    assert ops.LAUNCHES["flash_attention"] == 0


@pytest.mark.parametrize("dtype,tol", [(torch.float32, FP32_TOL),
                                       (torch.bfloat16, BF16_TOL)])
@pytest.mark.parametrize("causal,window,g,sq,skv,h", GRAD_CASES)
def test_function_backward_matches_jax_vjp_of_reference_sdpa(
        dtype, tol, causal, window, g, sq, skv, h):
    """Autograd through ``ops.flash_attention`` (forward with the
    log-sum-exp saved, the plain backward taking it) against ``jax.vjp``
    of the reference's ``_sdpa`` on the same inputs."""
    q, k, v, do = _inputs(dtype, g, sq, skv, h, seed=1)
    mask = ref_attn.make_mask(sq, skv, causal=causal, window=window)
    scale = 1.0 / np.sqrt(h)
    out, vjp = jax.vjp(lambda a, b, c: ref_attn._sdpa(a, b, c, mask, scale),
                       *(_jax(t) for t in (q, k, v)))
    want = vjp(_jax(do))
    for t in (q, k, v):
        t.requires_grad_(True)
    got_out = ops.flash_attention(q, k, v, causal=causal, window=window)
    got = torch.autograd.grad(got_out, (q, k, v), do)
    assert _rel(got_out.detach(),
                torch.from_numpy(np.array(out, np.float32))) <= tol
    for name, a, w in zip("qkv", got, want):
        assert a.dtype == dtype, name
        w = torch.from_numpy(np.array(w, np.float32))
        assert a.shape == w.shape, name
        assert _rel(a, w) <= tol, (name, _rel(a, w))


def test_function_saves_the_lse_only_under_grad():
    """The forward asks for the log-sum-exp only when a gradient will be
    taken: with grad its saved tensors hold it (fp32 [B, Nq, Sq], the
    plain log-sum-exp); without grad mode, or with no input requiring
    grad, nothing is saved."""
    q, k, v, _ = _inputs(torch.bfloat16, 4, 16, 16, 64)
    for t in (q, k, v):
        t.requires_grad_(True)
    out = ops.flash_attention(q, k, v, causal=True)
    saved = out.grad_fn.saved_tensors
    assert len(saved) == 5
    assert torch.equal(saved[4], ref.flash_attention_lse_ref(q, k,
                                                             causal=True))
    with torch.no_grad():
        assert ops.flash_attention(q, k, v, causal=True).grad_fn is None
    plain = [t.detach() for t in (q, k, v)]
    assert ops.flash_attention(*plain, causal=True).grad_fn is None


@pytest.mark.parametrize("b,skv,nkv,group,want", [
    (4, 1024, 8, 4, 1),      # granite-3-2b's training shape: 256 blocks
    (2, 2048, 2, 6, 3),      # qwen2-vl-2b's: 64 blocks, 3 shares
    (16, 1500, 8, 1, 1),     # whisper's cross-attention, G 1
    (2, 200, 2, 6, 6),       # too few blocks at any share: each its head
    (1, 256, 1, 16, 16),
])
def test_bwd_splits_fill_the_card(b, skv, nkv, group, want):
    """The dK/dV kernel's shares of G: the least divisor of G that gives
    at least one block an SM (132 on an H100), else G."""
    assert flash.bwd_splits(b, skv, nkv, group, 132) == want


def test_bwd_host_constants_match_the_cuda_source():
    """The host sizes the statistics' padding and counts dK/dV blocks with
    the CUDA source's tiles: the constants must agree."""
    import re
    src = (flash.build.CSRC / "flash_attention_bwd.cu").read_text()

    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))
    assert const("BK") == flash.BWD_KEY_TILE
    assert const("SPAD") == flash.BWD_STAT_PAD
