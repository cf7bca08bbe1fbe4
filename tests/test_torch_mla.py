"""The port's MLA decode attention (DeepSeek-V3) against the reference
package: the paged-MLA plain version against the reference kernel and its
oracle, ``mla_decode`` (full cache and ring window) and ``mla_decode_paged``
on the same weights, and the cache writes on MLA's 3-D latent leaves.

Tolerances.  The paged-MLA plain version and the reference kernel (run in
interpret mode on the CPU, as tests/test_paged.py runs it) take the same
inputs and compute in fp32; only the order of the fp32 sums differs, over
R + Hr = 48 products and the softmax terms: atol 2e-5, as the reference's
own kernel test.  The decode functions carry bf16 activations: XLA and
torch sum the bf16 products in another order, so an output lands a bf16
ulp or two apart (|y| < 2, one ulp is 2^-7 = 0.0078): atol 2e-2, as
tests/test_torch_model.py.  Cache writes copy bf16 values: compared bit
for bit where the values are given, allclose where each package computed
them.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_config
from repro.kernels import ops as ref_ops
from repro.kernels import ref as ref_ref
from repro.models import Model as RefModel
from repro.models import attention as ref_attn
from repro_torch.bridge import params_from_jax
from repro_torch.configs import get_config
from repro_torch.kernels import ops, ref
from repro_torch.models import attention as attn

ARCH = "deepseek-v3-671b-smoke"
ATOL = 2e-2


def _tbl(b, pps, n_pages, used, seed):
    """Shuffled pages for each row's ``used`` count, sentinel n_pages
    after them."""
    perm = np.random.RandomState(seed).permutation(n_pages)
    tbl = np.full((b, pps), n_pages, np.int32)
    k = 0
    for i, u in enumerate(used):
        tbl[i, :u] = perm[k:k + u]
        k += u
    return tbl


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_paged_mla_ref_matches_reference_kernel_and_oracle(dtype):
    rs = np.random.RandomState(5)
    b, n, r, hr, n_pages, page, pps = 3, 4, 32, 16, 10, 16, 3
    ql = rs.randn(b, 1, n, r).astype(np.float32)
    qr = rs.randn(b, 1, n, hr).astype(np.float32)
    pc = rs.randn(n_pages, page, r).astype(np.float32)
    pk = rs.randn(n_pages, page, hr).astype(np.float32)
    pos = np.array([0, 9, 40], np.int32)          # ragged, sentinel tails
    tbl = _tbl(b, pps, n_pages, [1, 1, 3], 0)
    scale = 1.0 / np.sqrt(r + hr)
    jd = jnp.dtype(dtype)
    td = getattr(torch, dtype)
    j_args = [jnp.asarray(a, jd) for a in (ql, qr, pc, pk)] + [
        jnp.asarray(tbl), jnp.asarray(pos)]
    t_args = [torch.from_numpy(np.array(jnp.asarray(a, jd), np.float32)
                               ).to(td) for a in (ql, qr, pc, pk)] + [
        torch.from_numpy(tbl), torch.from_numpy(pos)]
    got = ops.paged_mla_attention(*t_args, scale=scale)
    assert got.dtype == torch.float32 and got.shape == (b, 1, n, r)
    kernel = ref_ops.paged_mla_attention(*j_args, scale=scale)
    oracle = ref_ref.paged_mla_attention_ref(*j_args, scale=scale)
    np.testing.assert_allclose(got.numpy(), np.asarray(kernel), atol=2e-5,
                               rtol=2e-5)
    np.testing.assert_allclose(got.numpy(), np.asarray(oracle), atol=2e-5,
                               rtol=2e-5)
    # the CPU wrapper is the plain version, and launches nothing
    assert torch.equal(got, ref.paged_mla_attention_ref(*t_args,
                                                        scale=scale))
    assert ops.LAUNCHES["paged_mla_attention"] == 0


@pytest.fixture(scope="module")
def layer():
    """One MLA layer's weights from the reference init, bridged."""
    cfg = ref_config(ARCH)
    rp = RefModel(cfg).init(jax.random.PRNGKey(3))
    r_attn = jax.tree.map(lambda a: a[0], rp["blocks"][0]["attn"])
    t_attn = params_from_jax(jax.tree.map(np.asarray, r_attn))
    return cfg, get_config(ARCH), r_attn, t_attn


def _x(rs, b, d):
    x = rs.randn(b, 1, d).astype(np.float32)
    return jnp.asarray(x, jnp.bfloat16), torch.from_numpy(x).bfloat16()


def _close(t, r):
    np.testing.assert_allclose(t.float().numpy(), np.asarray(r, np.float32),
                               rtol=0, atol=ATOL)


@pytest.mark.parametrize("window", [0, 16])
def test_mla_decode_matches_reference(layer, window):
    """Six steps at ragged positions; ``window`` 16 makes the latent cache
    a ring buffer that the positions wrap around."""
    rcfg, tcfg, r_attn, t_attn = layer
    b = 3
    smax = window or 48
    rc = (jnp.zeros((b, smax, rcfg.kv_lora_rank), jnp.bfloat16),
          jnp.zeros((b, smax, rcfg.qk_rope_head_dim), jnp.bfloat16))
    tc = tuple(torch.zeros(a.shape, dtype=torch.bfloat16) for a in rc)
    pos = np.array([0, 7, 30], np.int32)
    rs = np.random.RandomState(1)
    for _ in range(6):
        xj, xt = _x(rs, b, rcfg.d_model)
        ry, rc = ref_attn.mla_decode(rcfg, r_attn, xj, rc[0], rc[1],
                                     jnp.asarray(pos), window=window)
        ty, tc = attn.mla_decode(tcfg, t_attn, xt, tc[0], tc[1],
                                 torch.from_numpy(pos), window=window)
        _close(ty, ry)
        for t_leaf, r_leaf in zip(tc, rc):
            _close(t_leaf, r_leaf)
        pos = pos + 1


def test_mla_decode_paged_matches_reference(layer):
    """The paged step (its attention through ``ops.paged_mla_attention``,
    the plain version on the CPU) against the reference's default jnp
    gather-view route, with one row whose write is masked."""
    rcfg, tcfg, r_attn, t_attn = layer
    b, page, pps = 3, 16, 3
    n_pages = b * pps + 1
    tbl = _tbl(b, pps, n_pages, [1, 2, 3], 2)
    shapes = [(n_pages, page, rcfg.kv_lora_rank),
              (n_pages, page, rcfg.qk_rope_head_dim)]
    rp_ = [jnp.zeros(s, jnp.bfloat16) for s in shapes]
    tp_ = [torch.zeros(s, dtype=torch.bfloat16) for s in shapes]
    pos = np.array([3, 20, 35], np.int32)
    mask = np.array([True, False, True])
    rs = np.random.RandomState(2)
    for _ in range(4):
        xj, xt = _x(rs, b, rcfg.d_model)
        ry, rp_ = ref_attn.mla_decode_paged(
            rcfg, r_attn, xj, rp_[0], rp_[1], jnp.asarray(pos),
            ref_attn.PagedKV(jnp.asarray(tbl), jnp.asarray(mask)))
        ty, tp_ = attn.mla_decode_paged(
            tcfg, t_attn, xt, tp_[0], tp_[1], torch.from_numpy(pos),
            attn.PagedKV(torch.from_numpy(tbl), torch.from_numpy(mask)))
        _close(ty, ry)
        for t_pool, r_pool in zip(tp_, rp_):
            r_np = np.asarray(r_pool, np.float32)
            _close(t_pool, r_pool)
            assert (t_pool.float().numpy() == 0).sum() == (r_np == 0).sum()
        pos = pos + 1


@pytest.mark.parametrize("trailing", [(32,), (16,), (2, 8)])
def test_paged_write_takes_any_trailing_rank(trailing):
    """One token per row into its page: MLA's [n_pages, P, R] pools (and
    GQA's [.., Nkv, H]) against the reference's scatter with drop mode,
    bit for bit; masked rows and rows whose page is a sentinel write
    nothing."""
    rs = np.random.RandomState(4)
    b, page, pps = 4, 16, 2
    n_pages = 7
    pool = rs.randn(n_pages, page, *trailing).astype(np.float32)
    val = rs.randn(b, *trailing).astype(np.float32)
    tbl = _tbl(b, pps, n_pages, [2, 1, 2, 0], 5)
    pos = np.array([17, 3, 30, 5], np.int32)
    for mask in ([True, False, True, True], [False] * 4):
        mask = np.array(mask)
        want = ref_attn.paged_write(
            jnp.asarray(pool, jnp.bfloat16),
            ref_attn.PagedKV(jnp.asarray(tbl), jnp.asarray(mask)),
            jnp.asarray(pos), jnp.asarray(val, jnp.bfloat16))
        got = attn.paged_write(
            torch.from_numpy(pool).bfloat16(),
            attn.PagedKV(torch.from_numpy(tbl), torch.from_numpy(mask)),
            torch.from_numpy(pos), torch.from_numpy(val).bfloat16())
        np.testing.assert_array_equal(got.float().numpy(),
                                      np.asarray(want, np.float32))


@pytest.mark.parametrize("trailing", [(32,), (2, 8)])
def test_masked_row_write_takes_any_trailing_rank(trailing):
    """cache[b, slot[b]] = val[b] on rows with the mask, on a 3-D latent
    cache [B, S, R] as on a 4-D one."""
    rs = np.random.RandomState(6)
    b, s = 3, 5
    cache = torch.from_numpy(rs.randn(b, s, *trailing).astype(np.float32))
    want = cache.clone()
    val = torch.from_numpy(rs.randn(b, *trailing).astype(np.float32))
    slot = torch.tensor([4, 0, 2])
    mask = torch.tensor([True, False, True])
    attn._masked_row_write(cache, torch.arange(b), slot, val, mask)
    for i in range(b):
        if mask[i]:
            want[i, slot[i]] = val[i]
    assert torch.equal(cache, want)
