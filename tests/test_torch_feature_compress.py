"""The port's int8 row compression (``kernels.ops.compress_rows`` /
``decompress_rows``) on the CPU against the reference kernels run as the
reference serving path runs them (Pallas, interpret mode) and against the
reference's plain oracle (``repro.kernels.ref``).

The bar against the reference kernel is bit for bit: int8 values, fp32
scales and dequantized rows.  The reference's oracle divides ``amax /
127.0`` while its kernel, compiled by XLA, multiplies by the rounded
reciprocal (``test_reference_kernel_scales_by_reciprocal`` shows it); the
port follows the kernel, so against the oracle the scales agree to one
fp32 ulp and the int8 values to one step.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as ref_ops
from repro.kernels import ref as ref_oracle
from repro_torch.kernels import ops, ref

CASES = [(64, np.float32), (64, "bfloat16"), (100, np.float32),
         (100, "bfloat16"), (2048, np.float32), (2048, "bfloat16")]


def _rows(d, seed):
    """Rows of mixed magnitude (per-row scales spread over decades), the
    first row zero, as numpy float32."""
    rs = np.random.RandomState(seed)
    x = rs.randn(96, d) * rs.exponential(1.0, (96, 1)) \
        * 10.0 ** rs.randint(-3, 3, (96, 1))
    x[0] = 0.0
    return x.astype(np.float32)


def _pair(d, dtype, seed=0):
    """The same rows as a JAX array and a torch tensor of one dtype."""
    x = _rows(d, seed + d)
    if dtype == "bfloat16":
        xj = jnp.asarray(x).astype(jnp.bfloat16)
        xt = torch.from_numpy(np.array(xj.astype(jnp.float32))).bfloat16()
    else:
        xj = jnp.asarray(x)
        xt = torch.from_numpy(x.copy())
    return xj, xt


def _bits(a):
    """Raw bits of a numpy array or a torch tensor, for exact comparison."""
    if isinstance(a, torch.Tensor):
        view = {torch.bfloat16: torch.int16, torch.float32: torch.int32}
        a = a.view(view[a.dtype]) if a.dtype in view else a
        return a.numpy()
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return a.view(np.int16)
    return a.view(np.int32) if a.dtype == np.float32 else a


@pytest.fixture(scope="module")
def reference_kernel():
    """The reference kernels' outputs, interpreted on the CPU, per case."""
    out = {}
    for d, dtype in CASES:
        xj, _ = _pair(d, dtype)
        q, s = ref_ops.compress_rows(xj, interpret=True)
        deq = {name: ref_ops.decompress_rows(q, s, dtype=jdt,
                                             interpret=True)
               for name, jdt in (("bfloat16", jnp.bfloat16),
                                 ("float32", jnp.float32))}
        out[(d, dtype)] = (np.asarray(q), np.asarray(s), deq)
    return out


@pytest.mark.parametrize("d,dtype", CASES)
def test_quantize_matches_reference_kernel_bitwise(reference_kernel, d,
                                                   dtype):
    _, xt = _pair(d, dtype)
    q, s = ops.compress_rows(xt)
    rq, rs_, _ = reference_kernel[(d, dtype)]
    np.testing.assert_array_equal(q.numpy(), rq)
    np.testing.assert_array_equal(_bits(s), _bits(rs_.astype(np.float32)))
    assert s[0].item() == np.float32(1e-8) and not q[0].any()


@pytest.mark.parametrize("d,dtype", CASES)
@pytest.mark.parametrize("out", ["bfloat16", "float32"])
def test_dequantize_matches_reference_kernel_bitwise(reference_kernel, d,
                                                     dtype, out):
    rq, rs_, deq = reference_kernel[(d, dtype)]
    got = ops.decompress_rows(torch.from_numpy(rq.copy()),
                              torch.from_numpy(rs_.copy()),
                              dtype=getattr(torch, out))
    np.testing.assert_array_equal(_bits(got), _bits(deq[out]))


@pytest.mark.parametrize("d,dtype", CASES)
def test_quantize_against_reference_oracle(d, dtype):
    """One fp32 ulp on the scale, one int8 step on the values (the
    oracle's IEEE division against the kernel's reciprocal)."""
    xj, xt = _pair(d, dtype)
    q, s = ops.compress_rows(xt)
    oq, os_ = ref_oracle.quantize_rows_ref(xj)
    np.testing.assert_array_max_ulp(s.numpy(), np.asarray(os_), maxulp=1)
    assert np.abs(q.numpy().astype(np.int32)
                  - np.asarray(oq).astype(np.int32)).max() <= 1
    same = (_bits(s) == _bits(np.asarray(os_)))[:, 0]
    np.testing.assert_array_equal(q.numpy()[same], np.asarray(oq)[same])


def test_reference_kernel_scales_by_reciprocal():
    """Why the port's scale is amax * fl(1/127): the reference kernel,
    jitted by XLA, computes exactly that, and its eager oracle computes
    amax / 127; the two differ on some rows of these inputs."""
    x = _rows(64, 7)
    amax = np.abs(x).max(axis=-1, keepdims=True)
    recip = np.maximum(amax * (np.float32(1) / np.float32(127)),
                       np.float32(1e-8))
    divided = np.maximum(amax / np.float32(127), np.float32(1e-8))
    _, ks = ref_ops.compress_rows(jnp.asarray(x), interpret=True)
    _, os_ = ref_oracle.quantize_rows_ref(jnp.asarray(x))
    np.testing.assert_array_equal(_bits(np.asarray(ks)), _bits(recip))
    np.testing.assert_array_equal(_bits(np.asarray(os_)), _bits(divided))
    assert (recip != divided).any()
    assert float(np.float32(ref.INV127)) == ref.INV127 \
        == float(np.float32(1) / np.float32(127))


def test_quantization_error_within_half_step():
    _, xt = _pair(100, np.float32, seed=3)
    q, s = ops.compress_rows(xt)
    back = ops.decompress_rows(q, s, dtype=torch.float32)
    assert bool(((back - xt).abs() <= s * 0.5 * (1 + 1e-6)).all())


def test_leading_axes_and_empty_rows():
    """A stacked cache leaf quantizes per row of its last axis; a leaf
    with no rows passes through."""
    x = torch.randn(3, 2, 16, 4, 64).bfloat16()
    q, s = ops.compress_rows(x)
    assert q.shape == x.shape and s.shape == (3, 2, 16, 4, 1)
    q2, s2 = ops.compress_rows(x.reshape(-1, 64))
    assert torch.equal(q.reshape(-1, 64), q2)
    assert torch.equal(s.reshape(-1, 1), s2)
    qe, se = ops.compress_rows(torch.zeros(2, 0, 8, 64))
    assert qe.shape == (2, 0, 8, 64) and se.shape == (2, 0, 8, 1)
    assert ops.decompress_rows(qe, se).shape == (2, 0, 8, 64)


def test_cpu_tensors_never_count_launches():
    n0 = dict(ops.LAUNCHES)
    q, s = ops.compress_rows(torch.randn(8, 64))
    ops.decompress_rows(q, s)
    assert ops.LAUNCHES == n0
    assert ops.LAUNCHES["quantize_rows"] == 0
    assert ops.LAUNCHES["dequantize_rows"] == 0
