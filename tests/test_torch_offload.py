"""The runtime ops of ``repro_torch.core.offload`` and the staged
boundary's quantizer (``core.hierarchy._quantize_int8`` /
``_dequantize_int8``) against the reference, on the CPU.

Rounding.  The reference computes scale = amax / qmax.  Under ``jax.jit``
XLA turns that into amax * fl(1/qmax); eager JAX divides.  The port takes
the jitted form, as its int8 kernel does, and is held bit for bit against
the reference under ``jax.jit``, q and scale.  Against the eager
reference a row's scale may be one ulp apart where the two forms round
apart, and then a q of that row may be one step apart; the counts on the
seeded input are asserted as measured.

``shard_map``.  The reference's staged boundary quantizes inside a
``shard_map`` body.  Compiled (``jax.jit`` around the ``shard_map``, how
a jitted step runs it) the body multiplies, and the port's boundary
quantizer equals it bit for bit.  Called eagerly, as
``tests/test_multidevice.py`` calls ``staged_forward``, JAX 0.9 runs the
body op by op and divides: the same one-ulp rows as the eager reference.

``decompress_boundary`` is exact; ``compression_error`` is within 1e-6
(fp32 sums in another order).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from repro.core import hierarchy as ref_hier
from repro.core import offload as ref_off
from repro_torch.core import hierarchy, offload
from repro_torch.kernels import ops as kops

try:                                     # jax >= 0.8 exports it at the top
    _shard_map = jax.shard_map
except AttributeError:                   # pragma: no cover
    from jax.experimental.shard_map import shard_map as _shard_map

SHAPE = (4, 96, 256)     # [B, S, D] boundary rows: 384 rows of 256


def _x(dtype=np.float32, seed=0):
    x = np.random.RandomState(seed).randn(*SHAPE).astype(np.float32)
    x *= np.random.RandomState(seed + 1).uniform(0.1, 8.0, SHAPE[:-1] + (1,))
    if dtype == "bf16":
        xj = jnp.asarray(x, jnp.bfloat16)
        return xj, torch.from_numpy(np.asarray(xj.astype(jnp.float32))
                                    ).bfloat16()
    return jnp.asarray(x), torch.from_numpy(x)


def _np(t):
    return t.float().numpy() if t.dtype == torch.bfloat16 else t.numpy()


def _bits(a):
    return np.asarray(a, np.float32).view(np.int32)


@pytest.mark.parametrize("dtype", [np.float32, "bf16"])
@pytest.mark.parametrize("bits", [8, 4])
def test_compress_boundary_matches_jitted_reference(bits, dtype):
    xj, xt = _x(dtype)
    qr, sr = jax.jit(lambda a: ref_off.compress_boundary(a, bits))(xj)
    q, s = offload.compress_boundary(xt, bits)
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    assert s.shape == SHAPE[:-1] + (1,)
    assert np.array_equal(q.numpy(), np.asarray(qr))
    assert np.array_equal(_bits(s.numpy()), _bits(sr))
    qmax = 2 ** (bits - 1) - 1
    assert q.abs().max() == qmax


# rows (of 384) whose scale rounds apart, and q elements one step apart,
# on the seeded fp32 input against the eager (dividing) reference
EAGER_APART = {8: (15, 0), 4: (207, 0)}


@pytest.mark.parametrize("bits", [8, 4])
def test_compress_boundary_against_eager_reference(bits):
    xj, xt = _x()
    qr, sr = ref_off.compress_boundary(xj, bits)
    q, s = offload.compress_boundary(xt, bits)
    srow = _bits(s.numpy()) != _bits(sr)
    assert np.abs(_bits(s.numpy()).astype(np.int64)
                  - _bits(sr).astype(np.int64)).max() <= 1       # one ulp
    dq = q.numpy().astype(int) - np.asarray(qr).astype(int)
    assert np.abs(dq).max() <= 1
    assert not (dq != 0)[~np.broadcast_to(srow, dq.shape)].any(), \
        "a q differs in a row whose scale agrees"
    assert (int(srow.sum()), int((dq != 0).sum())) == EAGER_APART[bits]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_decompress_boundary_exact(dtype):
    xj, xt = _x()
    q, s = offload.compress_boundary(xt)
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    want = ref_off.decompress_boundary(jnp.asarray(q.numpy()),
                                       jnp.asarray(s.numpy()), jdt)
    got = offload.decompress_boundary(q, s, dtype)
    assert got.dtype == dtype
    assert np.array_equal(_bits(_np(got)), _bits(np.asarray(
        want.astype(jnp.float32))))


@pytest.mark.parametrize("bits", [8, 4])
def test_compression_error(bits):
    xj, xt = _x()
    got = float(offload.compression_error(xt, bits))
    want = float(jax.jit(lambda a: ref_off.compression_error(a, bits))(xj))
    assert abs(got - want) <= 1e-6
    assert got > 0
    if bits == 4:       # int4 loses more than int8
        assert got > float(offload.compression_error(xt, 8))


def _in_shard_map(fn, *args):
    mesh = jax.make_mesh((1,), ("pod",))
    return _shard_map(fn, mesh=mesh, in_specs=tuple(P() for _ in args),
                      out_specs=P(), check_vma=False)(*args)


def test_boundary_quantizer_matches_reference_inside_shard_map():
    """``hierarchy._quantize_int8`` (``kops.compress_rows``, the kernel's
    plain version on the CPU) against the reference's ``_quantize_int8``
    inside a compiled ``shard_map``, bit for bit, bf16 activations as the
    staged boundary ships them; and the dequantizer."""
    xj, xt = _x("bf16")
    qr, sr = jax.jit(lambda a: _in_shard_map(ref_hier._quantize_int8, a))(xj)
    q, s = hierarchy._quantize_int8(xt)
    assert np.array_equal(q.numpy(), np.asarray(qr))
    assert np.array_equal(_bits(s.numpy()), _bits(sr))
    # the same function as compress_boundary at 8 bits, and as the kernel
    # wrapper called directly
    qb, sb = offload.compress_boundary(xt, 8)
    assert torch.equal(q, qb) and torch.equal(s, sb)
    qk, sk = kops.compress_rows(xt)
    assert torch.equal(q, qk) and torch.equal(s, sk)
    xr = jax.jit(lambda a, b: _in_shard_map(
        lambda u, v: ref_hier._dequantize_int8(u, v, jnp.bfloat16), a, b))(
        jnp.asarray(q.numpy()), jnp.asarray(s.numpy()))
    x2 = hierarchy._dequantize_int8(q, s, torch.bfloat16)
    assert np.array_equal(_bits(_np(x2)), _bits(np.asarray(
        xr.astype(jnp.float32))))


def test_boundary_quantizer_against_eager_shard_map():
    """The reference's staged_forward called without jit runs the
    shard_map body eagerly, which divides: one-ulp scale rows, as against
    the eager reference."""
    xj, xt = _x("bf16")
    qr, sr = _in_shard_map(ref_hier._quantize_int8, xj)
    qe, se = ref_hier._quantize_int8(xj)              # eager, no shard_map
    assert np.array_equal(np.asarray(qr), np.asarray(qe))
    assert np.array_equal(_bits(sr), _bits(se))
    q, s = hierarchy._quantize_int8(xt)
    srow = _bits(s.numpy()) != _bits(sr)
    dq = q.numpy().astype(int) - np.asarray(qr).astype(int)
    assert np.abs(dq).max() <= 1
    assert not (dq != 0)[~np.broadcast_to(srow, dq.shape)].any()
    assert 0 < int(srow.sum()) < srow.size // 10
