"""Flash attention: the reference's ``flash_attention_bshd`` (its Pallas
kernel in interpret mode on the CPU, as tests/test_kernels.py runs it)
against the port's ``kernels.ops.flash_attention`` on CPU tensors, which
run its plain version ``kernels.ref.flash_attention_ref``.  The kernel
itself runs only on the card (tests/test_torch_cuda.py, chip_smoke.py).

Tolerances: fp32 1e-5 (the same fp32 softmax, sums in another order);
bf16 2e-2 (both round the fp32 result to bf16 once; one bf16 ulp at
|out| < 4 is 2^-6).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as ref_ops
from repro.models import attention as ref_attn
from repro_torch.kernels import ops, ref
from repro_torch.models import attention as attn

TOL = {"float32": 1e-5, "bfloat16": 2e-2}


def _inputs(seed, b, sq, nq, nkv, h, dtype):
    rs = np.random.RandomState(seed)
    q, k, v = (rs.randn(b, sq, n, h).astype(np.float32)
               for n in (nq, nkv, nkv))
    jx = [jnp.asarray(a, getattr(jnp, dtype)) for a in (q, k, v)]
    tx = [torch.from_numpy(a).to(getattr(torch, dtype)) for a in (q, k, v)]
    return jx, tx


def _np(t):
    return t.float().numpy()


# (causal, window, G, Sq, H, dtype): every value of each axis appears, and
# ragged Sq = 24 runs with block_q 16 (the reference pads it to 32)
CASES = [
    (True, 0, 1, 32, 32, "float32"),
    (True, 0, 2, 32, 64, "float32"),
    (True, 16, 4, 32, 32, "float32"),
    (True, 16, 1, 24, 64, "float32"),
    (False, 0, 4, 32, 64, "float32"),
    (False, 16, 2, 24, 32, "float32"),
    (True, 0, 4, 24, 64, "bfloat16"),
    (True, 16, 2, 32, 64, "bfloat16"),
    (False, 0, 1, 32, 32, "bfloat16"),
    (False, 16, 4, 32, 32, "bfloat16"),
]


@pytest.mark.parametrize("causal,window,group,sq,h,dtype", CASES)
def test_plain_matches_reference_kernel(causal, window, group, sq, h, dtype):
    (jq, jk, jv), (tq, tk, tv) = _inputs(sq + h + group, 2, sq, 2 * group, 2,
                                         h, dtype)
    want = ref_ops.flash_attention_bshd(jq, jk, jv, causal=causal,
                                        window=window, block_q=16,
                                        block_k=16, interpret=True)
    n0 = ops.LAUNCHES["flash_attention"]
    got = ops.flash_attention(tq, tk, tv, causal=causal, window=window)
    assert ops.LAUNCHES["flash_attention"] == n0      # CPU calls never count
    assert got.dtype == tq.dtype and got.shape == tq.shape
    np.testing.assert_allclose(_np(got), np.asarray(want, np.float32),
                               rtol=0, atol=TOL[dtype])


@pytest.mark.parametrize("causal,window", [(True, 0), (True, 5), (False, 7)])
def test_plain_is_sdpa_with_make_mask(causal, window):
    """The plain version computes the reference's ``_sdpa`` under its
    ``make_mask`` (the attention of ``gqa_forward``), and the port's
    ``make_mask`` is the reference's."""
    (jq, jk, jv), (tq, tk, tv) = _inputs(3, 2, 20, 8, 2, 32, "float32")
    mask = ref_attn.make_mask(20, 20, causal=causal, window=window)
    np.testing.assert_array_equal(
        attn.make_mask(20, 20, causal=causal, window=window).numpy(),
        np.asarray(mask))
    want = ref_attn._sdpa(jq, jk, jv, mask, 1.0 / np.sqrt(32))
    got = ref.flash_attention_ref(tq, tk, tv, causal=causal, window=window)
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=0, atol=1e-5)


def test_card_wrapper_checks_before_launch():
    """Mixed devices raise before anything is built or launched."""
    q = torch.zeros(1, 4, 2, 64)
    with pytest.raises(ValueError, match="devices"):
        ops.flash_attention(q, q.to("meta"), q)
