"""The port's CUDA kernels against their plain PyTorch versions, on the
card.  Imports only torch and the port, so it runs where JAX is absent:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_cuda.py

Every test is marked ``gpu`` and skips where there is no card; whether
there is one is decided when a test runs, never at import.

Tolerances: the paged attention output is bf16 and both versions
accumulate in fp32 and round once (one bf16 ulp at |out| < 4 is 2^-6; the
kernel feeds P to the tensor cores as a bf16 high part plus a bf16 low
part, so only the order of the fp32 sums differs); the paged MLA output is fp32 from the same bf16 inputs, and
differs by the order of fp32 sums of R + Hr <= 576 products and of the
softmax terms, and by P, which the kernel feeds to the tensor cores as a
bf16 high part plus a bf16 low part (about 2^-16 relative; a single bf16
P would miss 1e-3 at full width, see tests/test_torch_paged_plan.py):
1e-3, against outputs that are convex combinations of latents |c| < 5;
the flash backward's bf16 gradients 2e-2 of max(1, |plain|) (P and dS
enter the tensor cores in bf16); the entropy is fp32 summed in another
order (1e-4 at small D,
1e-3 at D >= 2048).  The int8 kernels are held bit for bit: one IEEE division and
one rounding per element, and a max that no order changes.  So is the
W8A8 expert GEMM: its int32 sum is exact in any order, and its two scale
products are the plain version's, rounded once each.
"""
import math

import pytest
import torch

from repro_torch.kernels import ops, ref

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    """The card, or a skip."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (torch.cuda.is_available() is False)")
    return torch.device("cuda")


def _paged(dev, b, nq, nkv, hd, page=16, pps=8, seed=0, pos0=False):
    g = torch.Generator(device=dev).manual_seed(seed)
    n_pages = b * pps + 3
    pos = torch.randint(0, pps * page, (b,), generator=g, device=dev,
                        dtype=torch.int32)
    if pos0:
        pos[0] = 0                             # a one-token sequence
    perm = torch.randperm(n_pages, generator=g, device=dev).to(torch.int32)
    tbl = perm[:b * pps].reshape(b, pps).clone()
    cols = torch.arange(pps, device=dev)[None, :]
    tbl = torch.where(cols < (pos.long() // page + 1)[:, None], tbl,
                      torch.full_like(tbl, n_pages))
    q = torch.randn(b, 1, nq, hd, generator=g, device=dev).bfloat16()
    pk = torch.randn(n_pages, page, nkv, hd, generator=g,
                     device=dev).bfloat16()
    pv = torch.randn(n_pages, page, nkv, hd, generator=g,
                     device=dev).bfloat16()
    return q, pk, pv, tbl, pos


def _check_paged_gqa(args):
    n0 = ops.LAUNCHES["paged_gqa_attention"]
    got = ops.paged_gqa_attention(*args)
    want = ref.paged_gqa_attention_ref(*args)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["paged_gqa_attention"] == n0 + 1
    assert got.dtype == torch.bfloat16 and got.shape == args[0].shape
    assert (got.float() - want.float()).abs().max().item() <= 2 ** -6


@pytest.mark.parametrize("group", [1, 2, 4, 5, 6, 8])
@pytest.mark.parametrize("hd", [64, 128])
def test_paged_gqa_kernel_matches_plain(cuda, group, hd):
    """Every group size up to 8 (llama4 runs 5, qwen2-vl 6) at both head
    dims; tables of 8 pages, split in two or more."""
    _check_paged_gqa(_paged(cuda, 5, 2 * group, 2, hd, seed=group + hd))


@pytest.mark.parametrize("b,nkv,group,hd,pps", [
    (16, 8, 4, 64, 128),       # granite-3-2b, positions up to 2047
    (16, 8, 4, 64, 18),        # ... at serving's table length
    (3, 12, 4, 128, 37),       # two kv-head groups, the second part-full
    (1, 8, 5, 128, 128),       # one sequence spread over many splits
    (16, 32, 1, 64, 128),      # zamba2-1.2b's shared attention (G 1)
    (16, 2, 6, 128, 128)])     # qwen2-vl-2b: 12 heads over 2 (G 6)
def test_paged_gqa_kernel_long_tables(cuda, b, nkv, group, hd, pps):
    """Tables long enough for several splits (merged by the combine
    launch), with a one-token sequence (pos 0) in the first row."""
    _check_paged_gqa(_paged(cuda, b, nkv * group, nkv, hd, pps=pps,
                            seed=b + pps, pos0=True))


@pytest.mark.parametrize("b,nkv,group,pps", [
    (32, 32, 1, 256),          # Zamba2-7B's sites: 32 rows to 4,096 tokens
    (2, 32, 1, 256),           # ... two rows over many splits (combine)
    (3, 6, 2, 40)])            # G 2, a part-full block of kv heads
def test_paged_gqa_kernel_head_224(cuda, b, nkv, group, pps):
    """The H 224 instance (448-byte rows, the last TMA box of a head half
    outside it) at Zamba2's score scale (224 / 2)^-0.5: a one-token
    sequence, a full table and a ragged last page among the rows."""
    q, pk, pv, tbl, pos = _paged(cuda, b, nkv * group, nkv, 224, pps=pps,
                                 seed=b + pps, pos0=True)
    n_pages, page = pk.shape[0], pk.shape[1]
    pos[-1] = pps * page - 1                   # the whole table
    if b > 2:
        pos[1] = pps * page - 6                # a ragged last page
    rows = torch.arange(pps, device=cuda)[None, :]
    tbl = torch.where(rows < (pos.long() // page + 1)[:, None],
                      torch.arange(b * pps, device=cuda, dtype=torch.int32)
                      .reshape(b, pps) % n_pages,
                      torch.full_like(tbl, n_pages))
    _check_paged_gqa((q, pk, pv, tbl, pos, (224 / 2) ** -0.5))


def _paged_mla(dev, b, n, r, hr, page=16, pps=8, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    n_pages = b * pps + 3
    pos = torch.randint(0, pps * page, (b,), generator=g, device=dev,
                        dtype=torch.int32)
    pos[0] = 0                                 # a one-token sequence
    perm = torch.randperm(n_pages, generator=g, device=dev).to(torch.int32)
    tbl = perm[:b * pps].reshape(b, pps).clone()
    cols = torch.arange(pps, device=dev)[None, :]
    tbl = torch.where(cols < (pos.long() // page + 1)[:, None], tbl,
                      torch.full_like(tbl, n_pages))
    ql = torch.randn(b, 1, n, r, generator=g, device=dev).bfloat16()
    qr = torch.randn(b, 1, n, hr, generator=g, device=dev).bfloat16()
    pc = torch.randn(n_pages, page, r, generator=g, device=dev).bfloat16()
    pk = torch.randn(n_pages, page, hr, generator=g, device=dev).bfloat16()
    return ql, qr, pc, pk, tbl, pos


@pytest.mark.parametrize("b,n,r,hr,pps", [
    (5, 4, 32, 16, 8), (5, 4, 32, 16, 40), (16, 128, 512, 64, 9),
    (16, 128, 512, 64, 128), (3, 128, 512, 64, 37), (1, 128, 512, 64, 128),
    (1, 4, 32, 16, 37)])
def test_paged_mla_kernel_matches_plain(cuda, b, n, r, hr, pps):
    """deepseek-v3 smoke and full widths, with one split of pages (the
    serving path's tables of 9) and with several merged by the combine
    pass (40 pages; 128 at 16 slots and positions up to 2047, the chip
    smoke's phase 2); 37 pages are no whole number of splits, and one
    sequence (B 1) spreads a long table over few blocks."""
    args = _paged_mla(cuda, b, n, r, hr, pps=pps, seed=n + r)
    scale = 1.0 / math.sqrt(3 * hr)            # 1 / sqrt(nope + rope)
    n0 = ops.LAUNCHES["paged_mla_attention"]
    got = ops.paged_mla_attention(*args, scale=scale)
    want = ref.paged_mla_attention_ref(*args, scale=scale)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["paged_mla_attention"] == n0 + 1
    assert got.dtype == torch.float32 and got.shape == (b, 1, n, r)
    assert (got - want).abs().max().item() <= 1e-3


def test_paged_mla_wrapper_raises_instead_of_falling_back(cuda):
    ql, qr, pc, pk, tbl, pos = _paged_mla(cuda, 2, 4, 32, 16)
    with pytest.raises(ValueError):             # CPU / CUDA mix
        ops.paged_mla_attention(ql, qr, pc.cpu(), pk, tbl, pos, scale=0.1)
    with pytest.raises(ValueError):             # fp32 queries
        ops.paged_mla_attention(ql.float(), qr, pc, pk, tbl, pos, scale=0.1)
    with pytest.raises(ValueError):             # int64 table
        ops.paged_mla_attention(ql, qr, pc, pk, tbl.long(), pos, scale=0.1)
    with pytest.raises(ValueError):             # no instance for 8 heads
        ops.paged_mla_attention(ql.repeat(1, 1, 2, 1), qr.repeat(1, 1, 2, 1),
                                pc, pk, tbl, pos, scale=0.1)
    with pytest.raises(ValueError):             # no instance for page 8
        ops.paged_mla_attention(ql, qr, pc[:, :8].contiguous(),
                                pk[:, :8].contiguous(), tbl, pos, scale=0.1)
    with pytest.raises(ValueError):             # a non-contiguous query
        ops.paged_mla_attention(torch.cat([ql, ql], -1)[..., :32], qr, pc,
                                pk, tbl, pos, scale=0.1)


def _exit_inputs(dev, t, d, v, offset=0):
    """x [t, d] and W [d, v] placed ``offset`` elements into its
    allocation (so with offset 1 its rows miss 16-byte alignment)."""
    g = torch.Generator(device=dev).manual_seed(t + d + v)
    x = torch.randn(t, d, generator=g, device=dev).bfloat16()
    w = (torch.randn(d * v + offset, generator=g, device=dev)
         / math.sqrt(d)).bfloat16()[offset:].view(d, v)
    return x, w


def _check_exit(x, w, instance):
    from repro_torch.kernels import exit_head
    t, d = x.shape
    assert exit_head.plan(t, d, w.shape[1], w.data_ptr())["instance"] == \
        instance
    n0 = ops.LAUNCHES["exit_head_entropy"]
    got = ops.exit_head_entropy(x, w)
    want = ref.exit_head_entropy_ref(x, w)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["exit_head_entropy"] == n0 + 1
    tol = 1e-3 if d >= 2048 else 1e-4       # deepseek-v3's exit head last
    assert (got - want).abs().max().item() <= tol


@pytest.mark.parametrize("t,d,v", [
    (16, 2048, 49155), (37, 96, 1000), (1, 300, 513), (16, 256, 1024),
    (16, 7168, 129280),
    (40, 2048, 49155),        # odd pitch, three 16-row groups
    (17, 512, 8192),          # aligned, one row past a 16-row group
    (16, 1000, 4099),         # D no multiple of the 64-row stage
    (16, 2048, 32000),        # zamba2-1.2b's exit probes
    (16, 1024, 50304),        # xlstm-350m's exit probes
    (16, 1536, 151936),       # qwen2-vl-2b's exit probes (aligned)
    (16, 512, 51865)])        # whisper-base's exit probes (odd pitch)
def test_exit_head_kernel_matches_plain(cuda, t, d, v):
    x, w = _exit_inputs(cuda, t, d, v)
    _check_exit(x, w, "aligned" if v % 8 == 0 else "odd_pitch")


def test_exit_head_misaligned_w_takes_odd_pitch(cuda):
    """V % 8 == 0 but W starts 2 bytes past 16: the odd-pitch instance
    takes it, reading the granule before W's first byte."""
    x, w = _exit_inputs(cuda, 16, 256, 1024, offset=1)
    _check_exit(x, w, "odd_pitch")


def test_wrappers_raise_instead_of_falling_back(cuda):
    q, pk, pv, tbl, pos = _paged(cuda, 2, 4, 2, 64)
    with pytest.raises(ValueError):
        ops.paged_gqa_attention(q.float(), pk, pv, tbl, pos)
    with pytest.raises(ValueError):
        ops.paged_gqa_attention(q, pk, pv, tbl.long(), pos)
    with pytest.raises(ValueError):             # no instance for page 8
        ops.paged_gqa_attention(q, pk[:, :8].contiguous(),
                                pv[:, :8].contiguous(), tbl, pos)
    with pytest.raises(ValueError):             # no instance for group 9
        ops.paged_gqa_attention(q[:, :, :2].repeat(1, 1, 9, 1), pk, pv, tbl,
                                pos)
    x = torch.zeros(2, 8, device=cuda)
    with pytest.raises(ValueError):
        ops.exit_head_entropy(x, torch.zeros(8, 5, device=cuda))


def _bits(t):
    view = {torch.bfloat16: torch.int16, torch.float32: torch.int32}
    return t.view(view[t.dtype]) if t.dtype in view else t


@pytest.mark.parametrize("rows,d,dtype", [
    (40 * 4 * 16 * 8, 64, torch.bfloat16),     # a paged granite slot leaf
    (4096, 2048, torch.float32), (777, 100, torch.bfloat16),
    (3, 31, torch.float32), (1, 64, torch.bfloat16),
    (5 * 4 * 512, 512, torch.float32)])        # an xlstm-350m mLSTM C leaf
@pytest.mark.parametrize("out_dtype", [torch.bfloat16, torch.float32])
def test_int8_kernels_match_plain_bitwise(cuda, rows, d, dtype, out_dtype):
    g = torch.Generator(device=cuda).manual_seed(rows + d)
    x = (torch.randn(rows, d, generator=g, device=cuda)
         * torch.rand(rows, 1, generator=g, device=cuda) * 10).to(dtype)
    x[0] = 0                                   # scale exactly 1e-8, q 0
    n0 = (ops.LAUNCHES["quantize_rows"], ops.LAUNCHES["dequantize_rows"])
    q, s = ops.compress_rows(x)
    y = ops.decompress_rows(q, s, dtype=out_dtype)
    qr, sr = ref.quantize_rows_ref(x)
    yr = ref.dequantize_rows_ref(qr, sr, out_dtype)
    torch.cuda.synchronize()
    assert (ops.LAUNCHES["quantize_rows"],
            ops.LAUNCHES["dequantize_rows"]) == (n0[0] + 1, n0[1] + 1)
    assert torch.equal(q, qr)
    assert torch.equal(_bits(s), _bits(sr))
    assert torch.equal(_bits(y), _bits(yr))
    assert s[0].item() == torch.tensor(1e-8).item() and not q[0].any()


def test_int8_kernels_take_leading_axes(cuda):
    """A stacked cache leaf [layers, pages, P, Nkv, H] quantizes per row
    of H, as its [-1, H] reshape does."""
    g = torch.Generator(device=cuda).manual_seed(5)
    x = torch.randn(3, 2, 16, 8, 64, generator=g, device=cuda).bfloat16()
    q, s = ops.compress_rows(x)
    assert q.shape == x.shape and s.shape == (3, 2, 16, 8, 1)
    q2, s2 = ops.compress_rows(x.reshape(-1, 64))
    assert torch.equal(q.reshape(-1, 64), q2)
    assert torch.equal(s.reshape(-1, 1), s2)


def test_int8_wrappers_raise_instead_of_falling_back(cuda):
    with pytest.raises(ValueError):
        ops.compress_rows(torch.zeros(4, 8, dtype=torch.float16,
                                      device=cuda))
    with pytest.raises(ValueError):
        ops.compress_rows(torch.zeros(8, 4, device=cuda).t())
    q = torch.zeros(4, 8, dtype=torch.int8, device=cuda)
    with pytest.raises(ValueError):
        ops.decompress_rows(q, torch.ones(4, 1, device=cuda).double())
    with pytest.raises(ValueError):
        ops.decompress_rows(q, torch.ones(3, 1, device=cuda))
    with pytest.raises(ValueError):
        ops.decompress_rows(q, torch.ones(4, 1, device=cuda),
                            dtype=torch.float16)


def _int8_rows(dev, rows, d, dtype, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    x = (torch.randn(rows, d, generator=g, device=dev)
         * torch.rand(rows, 1, generator=g, device=dev) * 10).to(dtype)
    x[0] = 0                                   # scale exactly 1e-8, q 0
    return x


def _check_int8(x, out_dtype, q_in=None):
    """Both wrappers (dequantize on ``q_in`` when given, a view of q)
    against the plain versions, bit for bit, one launch each."""
    n0 = (ops.LAUNCHES["quantize_rows"], ops.LAUNCHES["dequantize_rows"])
    q, s = ops.compress_rows(x)
    y = ops.decompress_rows(q if q_in is None else q_in(q), s,
                            dtype=out_dtype)
    qr, sr = ref.quantize_rows_ref(x)
    yr = ref.dequantize_rows_ref(qr, sr, out_dtype)
    torch.cuda.synchronize()
    assert (ops.LAUNCHES["quantize_rows"],
            ops.LAUNCHES["dequantize_rows"]) == (n0[0] + 1, n0[1] + 1)
    assert torch.equal(q, qr)
    assert torch.equal(_bits(s), _bits(sr))
    assert torch.equal(_bits(y), _bits(yr))
    assert s[0].item() == torch.tensor(1e-8).item() and not q[0].any()


@pytest.mark.parametrize("d", [64, 100, 128, 192, 512, 2048, 7168])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("out_dtype", [torch.bfloat16, torch.float32])
def test_int8_instances_match_plain_bitwise(cuda, d, dtype, out_dtype):
    """Each D through the instance the plan picks (vec where a float row
    is whole 16-byte vectors of at most 8 KB: D 100 bf16 is not, D 7168
    quantizes on the scalar instance; D 192 and 7168 dequantize through
    the magic divide), on a row count that is no multiple of any warp's
    rows."""
    from repro_torch.kernels import feature_compress as fc
    rows = 1001 if d < 7168 else 67
    x = _int8_rows(cuda, rows, d, dtype, seed=d)
    eq, eo = x.element_size(), torch.tensor([], dtype=out_dtype)
    want_q = "vec" if d * eq % 16 == 0 and d * eq <= 8192 else "scalar"
    want_d = "vec" if d * eo.element_size() % 16 == 0 else "scalar"
    assert fc.plan(rows, d, eq, (x.data_ptr(),))["instance"] == want_q
    assert fc.plan(rows, d, eo.element_size(), (0,),
                   kernel="dequantize")["instance"] == want_d
    _check_int8(x, out_dtype)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_int8_offset_views_take_scalar(cuda, dtype):
    """Contiguous views whose data start off 16 bytes (x by one element,
    q by one byte) take the scalar instances, bit for bit."""
    from repro_torch.kernels import feature_compress as fc
    rows, d = 513, 64
    x = _int8_rows(cuda, rows, d, dtype, seed=3)
    buf = torch.empty(rows * d + 1, dtype=dtype, device=cuda)
    buf[1:] = x.reshape(-1)
    xv = buf[1:].view(rows, d)
    assert fc.plan(rows, d, xv.element_size(),
                   (xv.data_ptr(),))["instance"] == "scalar"

    def q_view(q):
        qb = torch.empty(rows * d + 1, dtype=torch.int8, device=cuda)
        qb[1:] = q.reshape(-1)
        qv = qb[1:].view(rows, d)
        assert fc.plan(rows, d, 2, (qv.data_ptr(),),
                       kernel="dequantize")["instance"] == "scalar"
        return qv
    _check_int8(xv, torch.bfloat16, q_in=q_view)


def _qkv(dev, b, sq, skv, nq, nkv, hd, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    q = torch.randn(b, sq, nq, hd, generator=g, device=dev).bfloat16()
    k = torch.randn(b, skv, nkv, hd, generator=g, device=dev).bfloat16()
    v = torch.randn(b, skv, nkv, hd, generator=g, device=dev).bfloat16()
    return q, k, v


@pytest.mark.parametrize("b,s,nq,nkv,hd,causal,window", [
    (2, 512, 32, 8, 64, True, 0),       # granite-3-2b's heads
    (2, 1000, 32, 8, 64, True, 256),    # ragged S, sliding window
    (2, 512, 16, 16, 128, False, 0),    # G 1, head dim 128, non-causal
    (1, 77, 4, 4, 64, True, 0),         # shorter than one query tile
    (1, 300, 8, 2, 128, True, 64),
    (2, 128, 8, 2, 64, True, 0),        # exactly one 128-row query tile
    (2, 129, 8, 2, 64, True, 0),        # one row past it
    (2, 128, 4, 4, 128, True, 0),
    (2, 129, 8, 2, 128, False, 0),
    (2, 2048, 32, 32, 64, True, 0)])    # zamba2-1.2b's shared attention
def test_flash_kernel_matches_plain(cuda, b, s, nq, nkv, hd, causal, window):
    """bf16 output of unit-normal inputs, held to 1e-2 of max(1, |plain|):
    both accumulate in fp32 and round once, so they may sit one bf16 ulp
    apart, and that ulp is 2^-6 > 1e-2 where |out| >= 2 (rows that attend
    to a few keys); the kernel also rounds P to bf16 before P V (2^-9
    relative on probabilities that sum to 1)."""
    q, k, v = _qkv(cuda, b, s, s, nq, nkv, hd, seed=s + hd)
    n0 = ops.LAUNCHES["flash_attention"]
    got = ops.flash_attention(q, k, v, causal=causal, window=window)
    want = ref.flash_attention_ref(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["flash_attention"] == n0 + 1
    assert got.dtype == torch.bfloat16 and got.shape == q.shape
    assert torch.isfinite(got.float()).all()
    err = (got.float() - want.float()).abs() / want.float().abs().clamp(min=1)
    assert err.max().item() <= 1e-2


@pytest.mark.parametrize("b,sq,skv,nq,nkv,hd,causal", [
    (2, 1500, 1500, 8, 8, 64, False),   # whisper-base's encoder
    (2, 24, 1500, 8, 8, 64, False),     # its cross-attention, Sq < 128
    (2, 200, 1500, 8, 8, 64, False),    # ... Sq past one query tile
    (1, 130, 100, 4, 2, 128, False),    # Skv < Sq, both ragged
    (2, 300, 200, 8, 2, 64, True)])     # causal, Skv < Sq
def test_flash_kernel_sq_ne_skv(cuda, b, sq, skv, nq, nkv, hd, causal):
    """Queries and keys of different lengths: keys past Skv on the last
    tile (1,500 = 11 x 128 + 92) are masked, query rows past Sq are not
    stored; held as ``test_flash_kernel_matches_plain``."""
    q, k, v = _qkv(cuda, b, sq, skv, nq, nkv, hd, seed=sq + skv)
    n0 = ops.LAUNCHES["flash_attention"]
    got = ops.flash_attention(q, k, v, causal=causal)
    want = ref.flash_attention_ref(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["flash_attention"] == n0 + 1
    assert got.dtype == torch.bfloat16 and got.shape == q.shape
    assert torch.isfinite(got.float()).all()
    err = (got.float() - want.float()).abs() / want.float().abs().clamp(min=1)
    assert err.max().item() <= 1e-2


def test_flash_wrapper_raises_instead_of_falling_back(cuda):
    q, k, v = _qkv(cuda, 1, 64, 64, 4, 2, 64)
    with pytest.raises(ValueError):             # fp32 inputs
        ops.flash_attention(q.float(), k.float(), v.float())
    with pytest.raises(ValueError):             # no instance for head dim 32
        ops.flash_attention(q[..., :32].contiguous(), k[..., :32].contiguous(),
                            v[..., :32].contiguous())
    with pytest.raises(ValueError):             # a transposed (BHSD) view
        ops.flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                            v.transpose(1, 2))
    with pytest.raises(ValueError):             # CPU / CUDA mix
        ops.flash_attention(q, k.cpu(), v)


BWD_TOL = 2e-2      # of max(1, |plain|): bf16 gradients; the kernel
                    # feeds P and dS to the tensor cores in bf16 (2^-9
                    # relative each) and sums in fp32 in another order


def _check_flash_bwd(q, k, v, causal, window, drop_d=False):
    """dq, dk, dv of the backward kernels against the plain backward on the
    same o, dO and log-sum-exp (the forward kernel's); returns the worst
    error of max(1, |plain|).  With ``drop_d`` the kernels are handed a
    zero o, so their D = rowsum(dO o O) is 0 and dS = P o dP: the planted
    control."""
    g = torch.Generator(device=q.device).manual_seed(q.shape[1])
    do = torch.randn(q.shape, generator=g, device=q.device).bfloat16()
    o, lse = ops.flash_attention_with_lse(q, k, v, causal=causal,
                                          window=window)
    n0 = ops.LAUNCHES["flash_attention_bwd"]
    got = ops.flash_attention_bwd(q, k, v,
                                  torch.zeros_like(o) if drop_d else o, do,
                                  lse, causal=causal, window=window)
    assert ops.LAUNCHES["flash_attention_bwd"] == n0 + 1
    want = ref.flash_attention_bwd_ref(q, k, v, o, do, lse, causal=causal,
                                       window=window)
    torch.cuda.synchronize()
    worst = 0.0
    for a, w in zip(got, want):
        assert a.dtype == torch.bfloat16 and a.shape == w.shape
        assert torch.isfinite(a.float()).all()
        err = (a.float() - w.float()).abs() / w.float().abs().clamp(min=1)
        worst = max(worst, err.max().item())
    return worst


@pytest.mark.parametrize("b,sq,skv,nq,nkv,hd,causal,window", [
    (2, 256, 256, 32, 8, 64, True, 0),      # granite-3-2b's heads
    (2, 300, 300, 32, 8, 64, True, 64),     # ragged, sliding window
    (1, 70, 70, 4, 4, 64, True, 1),         # every row sees one key
    (1, 5, 5, 2, 1, 64, True, 0),           # shorter than a tile
    (2, 64, 64, 8, 2, 64, True, 0),         # exactly one tile
    (2, 65, 65, 8, 2, 64, True, 0),         # one row past it
    (2, 200, 200, 12, 2, 128, True, 0),     # qwen2-vl's heads of 128, G 6
    (1, 130, 130, 4, 4, 128, True, 17),
    (2, 45, 130, 8, 8, 64, False, 0),       # cross-attention, no mask
    (2, 200, 1500, 8, 8, 64, False, 0),     # whisper's 1,500 frames
    (1, 130, 100, 4, 2, 128, False, 0),     # Skv < Sq, both ragged
    (1, 256, 256, 16, 1, 64, True, 0),      # G 16 split over blocks, H 64
    (1, 77, 93, 8, 2, 64, True, 0)])        # no length a tile's multiple
def test_flash_bwd_kernel_matches_plain(cuda, b, sq, skv, nq, nkv, hd,
                                        causal, window):
    q, k, v = _qkv(cuda, b, sq, skv, nq, nkv, hd, seed=sq + skv + hd)
    assert _check_flash_bwd(q, k, v, causal, window) <= BWD_TOL


@pytest.mark.parametrize("b,sq,skv,nq,nkv,hd", [
    (2, 200, 200, 12, 2, 128),      # qwen2-vl's heads: G 6 in 6 shares
    (1, 256, 256, 16, 1, 64)])      # G 16 in 16 shares
def test_flash_bwd_takes_the_g_split(cuda, b, sq, skv, nq, nkv, hd):
    """These shapes give fewer dK/dV blocks than SMs, so the kernel splits
    G over blocks and sums fp32 partials (held in the test above)."""
    from repro_torch.kernels import flash_attention as flash
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    assert flash.bwd_splits(b, skv, nkv, nq // nkv, sms) > 1


@pytest.mark.parametrize("b,sq,skv,nq,nkv,hd,causal,window", [
    (2, 300, 300, 32, 8, 64, True, 64),
    (2, 200, 200, 12, 2, 128, True, 0),
    (2, 45, 1500, 8, 8, 64, False, 0),
    (1, 77, 93, 8, 2, 128, True, 0)])
def test_flash_forward_lse(cuda, b, sq, skv, nq, nkv, hd, causal, window):
    """The forward's output is the same bits with and without the
    log-sum-exp output, and the kernel's log-sum-exp is the plain one's
    within 1e-3 (fp32; the kernel's exp2 is the MUFU approximation and
    its scores sum in another order)."""
    q, k, v = _qkv(cuda, b, sq, skv, nq, nkv, hd, seed=sq + hd)
    n0 = ops.LAUNCHES["flash_attention"]
    out, lse = ops.flash_attention_with_lse(q, k, v, causal=causal,
                                            window=window)
    plain = ops.flash_attention(q, k, v, causal=causal, window=window)
    want = ref.flash_attention_lse_ref(q, k, causal=causal, window=window)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["flash_attention"] == n0 + 2
    assert torch.equal(out, plain)
    assert lse.dtype == torch.float32 and lse.shape == (b, nq, sq)
    assert (lse - want).abs().max().item() <= 1e-3


def test_flash_kernels_launch_from_another_thread(cuda):
    """The kernels' shared-memory attribute is set on every launch: one set
    from the main thread is not in effect on another host thread, where
    autograd runs the backward (the launch was refused there)."""
    import threading
    q, k, v = _qkv(cuda, 2, 100, 100, 8, 2, 64, seed=7)
    o, lse = ops.flash_attention_with_lse(q, k, v)
    errors = []

    def work():
        try:
            ops.flash_attention(q, k, v)
            ops.flash_attention_bwd(q, k, v, o, o, lse)
            torch.cuda.synchronize()
        except Exception as exc:       # reported on the main thread below
            errors.append(exc)
    worker = threading.Thread(target=work)
    worker.start()
    worker.join()
    assert errors == []


def test_serving_kernels_launch_from_another_thread(cuda):
    """Paged GQA, paged MLA and both exit-head instances set their
    shared-memory attribute on every launch too: launched first from the
    main thread, then from a second host thread, each gives the same
    bits there."""
    from repro_torch.launch.kernel_ab import launch_in_thread
    paged = _paged(cuda, 4, 8, 2, 64, pps=18, seed=11)
    mla = _paged_mla(cuda, 4, 128, 512, 64, pps=9, seed=12)
    scale = 1.0 / math.sqrt(192)
    odd = _exit_inputs(cuda, 16, 512, 4099)
    aligned = _exit_inputs(cuda, 16, 512, 4096)
    calls = {
        "paged_gqa_attention": lambda: ops.paged_gqa_attention(*paged),
        "paged_mla_attention": lambda: ops.paged_mla_attention(
            *mla, scale=scale),
        "exit_head odd_pitch": lambda: ops.exit_head_entropy(*odd),
        "exit_head aligned": lambda: ops.exit_head_entropy(*aligned)}
    main = {name: fn() for name, fn in calls.items()}
    torch.cuda.synchronize()
    got, errors = launch_in_thread(calls)
    assert errors == {}
    for name in calls:
        assert torch.equal(got[name], main[name]), name


def test_flash_bwd_is_deterministic(cuda):
    """No atomics: two backward calls give the same bits, at a shape that
    splits G over blocks and at one that does not."""
    for shape in ((2, 200, 200, 12, 2, 128), (2, 300, 300, 32, 8, 64)):
        q, k, v = _qkv(cuda, *shape, seed=5)
        g = torch.Generator(device=cuda).manual_seed(6)
        do = torch.randn(q.shape, generator=g, device=cuda).bfloat16()
        o, lse = ops.flash_attention_with_lse(q, k, v, causal=True)
        first = ops.flash_attention_bwd(q, k, v, o, do, lse, causal=True)
        second = ops.flash_attention_bwd(q, k, v, o, do, lse, causal=True)
        torch.cuda.synchronize()
        assert all(torch.equal(a, b) for a, b in zip(first, second))


@pytest.mark.parametrize("causal,window", [(True, 0), (True, 64),
                                           (False, 0)])
def test_flash_bwd_without_d_fails_the_check(cuda, causal, window):
    """The planted control (D zeroed, dS = P o dP) misses the tolerance."""
    q, k, v = _qkv(cuda, 2, 200, 200, 8, 2, 64, seed=3)
    assert _check_flash_bwd(q, k, v, causal, window, drop_d=True) > BWD_TOL


def test_flash_function_backward_launches_the_kernel(cuda, monkeypatch):
    """Autograd through ``ops.flash_attention`` on the card runs the
    forward and backward kernels once each and no plain version."""
    def refuse(*a, **kw):
        raise AssertionError("a plain version ran on the card")
    q, k, v = _qkv(cuda, 2, 100, 100, 8, 2, 64, seed=4)
    for t in (q, k, v):
        t.requires_grad_(True)
    monkeypatch.setattr(ref, "flash_attention_ref", refuse)
    monkeypatch.setattr(ref, "flash_attention_bwd_ref", refuse)
    n0 = dict(ops.LAUNCHES)
    out = ops.flash_attention(q, k, v, causal=True)
    dq, dk, dv = torch.autograd.grad(out, (q, k, v), torch.ones_like(out))
    torch.cuda.synchronize()
    assert ops.LAUNCHES["flash_attention"] == n0["flash_attention"] + 1
    assert ops.LAUNCHES["flash_attention_bwd"] == \
        n0["flash_attention_bwd"] + 1
    assert dq.shape == q.shape and dk.shape == k.shape and dv.shape == v.shape


def test_flash_bwd_wrapper_raises_instead_of_falling_back(cuda):
    q, k, v = _qkv(cuda, 1, 64, 64, 4, 2, 64)
    o, lse = ops.flash_attention_with_lse(q, k, v)
    with pytest.raises(ValueError):             # fp32 dO
        ops.flash_attention_bwd(q, k, v, o, o.float(), lse)
    with pytest.raises(ValueError):             # a window without causal
        ops.flash_attention_bwd(q, k, v, o, o, lse, causal=False, window=8)
    with pytest.raises(ValueError):             # CPU / CUDA mix
        ops.flash_attention_bwd(q, k, v, o.cpu(), o, lse)
    with pytest.raises(ValueError):             # a bf16 log-sum-exp
        ops.flash_attention_bwd(q, k, v, o, o, lse.bfloat16())


def test_smoke_train_step_card_matches_cpu(cuda):
    """One granite-3-2b-smoke ``compute_loss`` gradient on the card (flash
    kernels, cuBLAS) against the CPU's (plain versions) on the same
    weights and batch: every leaf within 5e-2 relative L2 (PERF.md §2,
    the gradient tolerance), the loss within 1e-3 relative; then a
    ``train_step`` on each moves the loss the same way."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import InputShape
    from repro_torch.data import batch_for_model
    from repro_torch.models import Model
    from repro_torch.models.common import tree_leaves, tree_map
    from repro_torch.training import (OptimizerConfig, TrainConfig,
                                      compute_loss, init_optimizer,
                                      make_train_step)
    cfg = get_config("granite-3-2b-smoke")
    shape = InputShape("t", 128, 4, "train")
    runs = {}
    for dev in ("cpu", "cuda"):
        model = Model(cfg, device=dev)
        params = tree_map(lambda t: t.to(dev), Model(cfg, "cpu").init(0))
        batch = batch_for_model(cfg, shape, 0, device=dev)
        leaves = tree_leaves(params)
        for p in leaves:
            p.requires_grad_(True)
        loss, _ = compute_loss(model, params, batch, tcfg=TrainConfig())
        grads = torch.autograd.grad(loss, leaves)
        for p in leaves:
            p.requires_grad_(False)
        step = make_train_step(model, OptimizerConfig(lr=1e-3,
                                                      warmup_steps=1))
        opt = init_optimizer(params)
        losses = []
        for i in range(3):
            params, opt, met = step(params, opt, batch_for_model(
                cfg, shape, i, device=dev))
            losses.append(float(met["loss"]))
        runs[dev] = (loss.item(), [g.float().cpu() for g in grads], losses)
    (l_cpu, g_cpu, s_cpu), (l_card, g_card, s_card) = runs["cpu"], \
        runs["cuda"]
    assert abs(l_card - l_cpu) <= 1e-3 * abs(l_cpu)
    for a, w in zip(g_card, g_cpu):
        assert (a - w).norm() <= 5e-2 * w.norm()
    assert s_card[-1] < s_card[0] and s_cpu[-1] < s_cpu[0]
    for a, w in zip(s_card, s_cpu):
        assert abs(a - w) <= 1e-2 * abs(w)


@pytest.mark.parametrize("long_mode", [False, True])
def test_smoke_forward_card_matches_cpu(cuda, long_mode):
    """granite-3-2b-smoke ``Model.forward`` on the card (flash kernel,
    cuBLAS) against the CPU (plain versions) on the same weights, 2 x 128
    tokens (long mode: the 64-token window): logits within 3e-2 (cuBLAS
    and the CPU round bf16 matmul results a few ulps apart), exit logits
    within 6e-2 (the exit head's W is ~3x the embedding's scale, but it
    reads the hidden state after one layer)."""
    from repro_torch.configs import get_config
    from repro_torch.models import Model
    from repro_torch.models.common import tree_map
    cfg = get_config("granite-3-2b-smoke")
    cpu = Model(cfg, device="cpu")
    params = cpu.init(0)
    card = Model(cfg, device="cuda")
    g = torch.Generator().manual_seed(1)
    toks = torch.randint(0, cfg.vocab_size, (2, 128), generator=g)
    want = cpu.forward(params, {"tokens": toks}, long_mode=long_mode)
    n0 = ops.LAUNCHES["flash_attention"]
    got = card.forward(tree_map(lambda t: t.cuda(), params),
                       {"tokens": toks.cuda()}, long_mode=long_mode)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["flash_attention"] == n0 + cfg.num_layers
    assert (got.logits.cpu() - want.logits).abs().max().item() <= 3e-2
    assert len(got.exit_logits) == len(want.exit_logits) == 1
    for e_got, e_want in zip(got.exit_logits, want.exit_logits):
        assert (e_got.cpu() - e_want).abs().max().item() <= 6e-2


def _smoke_pool(dev, async_decode, slots=4, max_new=9, R=4, paged=True,
                arch="granite-3-2b-smoke", w8a8=False):
    """A smoke-width paged monolithic pool on the card (granite-3-2b by
    default), six requests through four slots (two re-admissions);
    ``w8a8`` quantizes the MoE experts."""
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.models import Model, ffn
    from repro_torch.serving import (ContinuousBatchScheduler, Request,
                                     SchedulerConfig)
    model = Model(get_config(arch), device=dev)
    params = model.init(0)
    if w8a8:
        ffn.quantize_model_moe(params)
    max_len = 16 + max_new
    max_len += (-max_len) % 16
    sched = ContinuousBatchScheduler(model, params, SchedulerConfig(
        n_slots=slots, max_len=max_len, prefill_chunk=8, exit_threshold=0.0,
        segmented=False, paged=paged, async_decode=async_decode,
        readback_interval=R), device=dev)
    rs = np.random.RandomState(2)
    reqs = [Request(tokens=rs.randint(0, model.cfg.vocab_size,
                                      int(rs.randint(4, 17))),
                    max_new=max_new, req_id=j) for j in range(6)]
    if model.cfg.family == "encdec":
        for r in reqs:         # frames far apart, so stale rows would show
            r.frames = rs.randn(model.cfg.encdec.encoder_seq_len,
                                model.cfg.d_model).astype(np.float32)
    for r in reqs:
        sched.submit(r)
    return sched, reqs


@pytest.mark.parametrize("paged", [True, False], ids=["paged", "contig"])
def test_decode_window_graph_matches_eager_sync(cuda, paged):
    """The window's CUDA graph (R 4, which does not divide the 8 decode
    steps after the first token) against the eager sync monolithic step on
    the same weights and requests: the same greedy tokens, one capture."""
    s_sync, r_sync = _smoke_pool(cuda, False, paged=paged)
    s_sync.run()
    s_win, r_win = _smoke_pool(cuda, True, paged=paged)
    s_win.run()
    torch.cuda.synchronize()
    assert [r.out_tokens for r in r_win] == [r.out_tokens for r in r_sync]
    assert s_win.jit_cache_sizes() == {"decode_window": 1}
    assert s_win._window.graph is not None
    assert s_win.tokens_served == s_sync.tokens_served


@pytest.mark.parametrize("paged", [True, False], ids=["paged", "contig"])
def test_hybrid_window_graph_matches_eager_sync(cuda, paged):
    """zamba2-1.2b-smoke through the window's CUDA graph against the eager
    sync monolithic step: slots are reused, so state rows are reset
    (paged) or merged (contiguous) between occupants, and frozen rows must
    not advance a live slot's state; the same greedy tokens, one capture,
    and the shared-attention sites' paged kernel in every replay."""
    arch = "zamba2-1.2b-smoke"
    s_sync, r_sync = _smoke_pool(cuda, False, paged=paged, arch=arch)
    s_sync.run()
    s_win, r_win = _smoke_pool(cuda, True, paged=paged, arch=arch)
    s_win.run()
    torch.cuda.synchronize()
    assert [r.out_tokens for r in r_win] == [r.out_tokens for r in r_sync]
    assert s_win.jit_cache_sizes() == {"decode_window": 1}
    if paged:
        assert s_win._window.per_replay["paged_gqa_attention"] == 2


@pytest.mark.parametrize("paged", [True, False], ids=["paged", "contig"])
def test_xlstm_window_graph_matches_eager_sync(cuda, paged):
    """xlstm-350m-smoke through the window's CUDA graph against the eager
    sync monolithic step: every cache leaf is a state row (a paged arena
    holds no pool), slots are reused, so rows are zeroed (paged) or merged
    (contiguous) between occupants, and frozen rows must not advance a
    live slot's state; the same greedy tokens, one capture, no port
    kernel in a replay (the exit probes' full logits are plain matmuls
    in the monolithic step)."""
    arch = "xlstm-350m-smoke"
    s_sync, r_sync = _smoke_pool(cuda, False, paged=paged, arch=arch)
    s_sync.run()
    s_win, r_win = _smoke_pool(cuda, True, paged=paged, arch=arch)
    s_win.run()
    torch.cuda.synchronize()
    assert [r.out_tokens for r in r_win] == [r.out_tokens for r in r_sync]
    assert s_win.jit_cache_sizes() == {"decode_window": 1}
    assert not any(s_win._window.per_replay.values())


@pytest.mark.parametrize("w8a8", [False, True], ids=["bf16", "w8a8"])
def test_llama4_window_graph_matches_eager_sync(cuda, w8a8):
    """llama4-maverick-smoke (one pair unit) through the window's CUDA
    graph against the eager sync monolithic step, bf16 and W8A8 experts:
    the same greedy tokens, one capture, and in every replay the paged
    kernel for both layers of the unit and (W8A8) the expert GEMM for its
    three products, with ``_quant_rows`` inside the graph."""
    arch = "llama4-maverick-400b-a17b-smoke"
    s_sync, r_sync = _smoke_pool(cuda, False, arch=arch, w8a8=w8a8)
    s_sync.run()
    s_win, r_win = _smoke_pool(cuda, True, arch=arch, w8a8=w8a8)
    s_win.run()
    torch.cuda.synchronize()
    assert [r.out_tokens for r in r_win] == [r.out_tokens for r in r_sync]
    assert s_win.jit_cache_sizes() == {"decode_window": 1}
    per = s_win._window.per_replay
    assert per["paged_gqa_attention"] == 2
    assert per["w8a8_expert_matmul"] == (3 if w8a8 else 0)


def _w8a8_inputs(dev, e, c, k, n, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    aq = torch.randint(-127, 128, (e, c, k), generator=g, device=dev,
                       dtype=torch.int16).to(torch.int8)
    wq = torch.randint(-127, 128, (e, k, n), generator=g, device=dev,
                       dtype=torch.int16).to(torch.int8)
    aq[0, 0] = 127                  # the largest |sum| the kernel meets
    wq[0, :, :4] = 127
    a_s = torch.rand(e, c, 1, generator=g, device=dev) * 0.05 + 1e-4
    w_s = torch.rand(e, 1, n, generator=g, device=dev) * 0.05 + 1e-4
    return aq, a_s, wq, w_s


@pytest.mark.parametrize("e,c,k,n", [
    (8, 4, 5120, 8192),      # llama4-maverick's gate/up at decode (C 4)
    (8, 40, 8192, 5120),     # its down product at a 2 x 2048 forward
    (4, 4, 256, 128),        # llama4-smoke
    (3, 5, 64, 300),         # ragged C, N no multiple of the 128 tile
    (2, 13, 272, 388),       # two row groups, the second ragged
    (1, 1, 16, 4)])          # one row, one step, one lane's columns
def test_w8a8_kernel_matches_plain_bitwise(cuda, e, c, k, n):
    args = _w8a8_inputs(cuda, e, c, k, n, seed=e + c + k + n)
    n0 = ops.LAUNCHES["w8a8_expert_matmul"]
    got = ops.w8a8_expert_matmul(*args)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["w8a8_expert_matmul"] == n0 + 1
    want = ref.w8a8_expert_matmul_ref(*args)
    assert got.dtype == torch.float32 and got.shape == (e, c, n)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    # the card's plain version (fp64 sums) against the CPU's int32 bmm
    host = ref.w8a8_expert_matmul_ref(*(t.cpu() for t in args))
    assert torch.equal(want.cpu().view(torch.int32), host.view(torch.int32))


def test_w8a8_wrapper_raises_instead_of_falling_back(cuda):
    aq, a_s, wq, w_s = _w8a8_inputs(cuda, 2, 4, 64, 128)
    with pytest.raises(ValueError, match="no instance"):
        ops.w8a8_expert_matmul(aq[:, :, :40].contiguous(), a_s,
                               wq[:, :40].contiguous(), w_s)
    with pytest.raises(ValueError, match="no instance"):
        ops.w8a8_expert_matmul(aq, a_s, wq[:, :, :6].contiguous(),
                               w_s[:, :, :6].contiguous())
    with pytest.raises(ValueError, match="int8"):
        ops.w8a8_expert_matmul(aq.float(), a_s, wq, w_s)
    with pytest.raises(ValueError, match="devices"):
        ops.w8a8_expert_matmul(aq, a_s, wq.cpu(), w_s)


def test_w8a8_moe_layer_card_matches_cpu(cuda):
    """A llama4-smoke MoE layer with W8A8 experts on the card against the
    CPU on the same weights and input: the quantized weights bit for bit
    (one IEEE division per element on both), the output within 2e-2
    (cuBLAS and the CPU round the shared expert's bf16 products
    differently)."""
    from repro_torch.configs import get_config
    from repro_torch.models import ffn
    from repro_torch.models.common import materialize
    cfg = get_config("llama4-maverick-400b-a17b-smoke")
    p = materialize(torch.Generator().manual_seed(0), ffn.init_moe(cfg),
                    "cpu")
    pq = ffn.quantize_expert_weights(p)
    pq_card = ffn.quantize_expert_weights(
        {k: (v.cuda() if isinstance(v, torch.Tensor) else
             {kk: vv.cuda() for kk, vv in v.items()}) for k, v in p.items()})
    for key in ("wg_q", "wg_s", "wu_q", "wu_s", "wd_q", "wd_s"):
        a, b = pq[key], pq_card[key].cpu()
        assert torch.equal(a.view(torch.int32) if a.dtype == torch.float32
                           else a, b.view(torch.int32)
                           if b.dtype == torch.float32 else b), key
    x = (0.5 * torch.randn(2, 16, cfg.d_model,
                           generator=torch.Generator().manual_seed(1))
         ).bfloat16()
    n0 = ops.LAUNCHES["w8a8_expert_matmul"]
    y_card, _ = ffn.moe_ffn(pq_card, x.cuda(), cfg)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["w8a8_expert_matmul"] == n0 + 3
    y_cpu, _ = ffn.moe_ffn(pq, x, cfg)
    assert (y_card.cpu().float() - y_cpu.float()).abs().max().item() <= 2e-2


def test_whisper_window_graph_reads_readmitted_cross_rows(cuda):
    """whisper-base-smoke through the window's CUDA graph against the
    eager sync monolithic step: six requests through four contiguous
    slots, so two slots are re-admitted after the capture with other
    frames.  Admission writes their cross rows into the arena's own
    tensors in place (every cache leaf keeps its storage from the capture
    on), so the graph's next replay reads them: the same greedy tokens,
    one capture."""
    from repro_torch.models.common import tree_leaves
    arch = "whisper-base-smoke"
    s_sync, r_sync = _smoke_pool(cuda, False, paged=False, arch=arch)
    s_sync.run()
    s_win, r_win = _smoke_pool(cuda, True, paged=False, arch=arch)
    ptrs = [t.data_ptr() for t in tree_leaves(s_win.cache)]
    s_win.run()
    torch.cuda.synchronize()
    assert s_win.n_admitted == 6 > s_win.cfg.n_slots
    assert [t.data_ptr() for t in tree_leaves(s_win.cache)] == ptrs
    assert [r.out_tokens for r in r_win] == [r.out_tokens for r in r_sync]
    assert s_win.jit_cache_sizes() == {"decode_window": 1}


def test_decode_polls_read_no_counters_on_the_card(cuda):
    """Windows of 4 over 33 tokens, past the 32 steps between the counter
    flushes polls once made: no poll reads the exit counters or waits in
    a read, and the tokens and final counts equal those of a run whose
    counters are read exactly after every poll."""
    runs = []
    for exact in (False, True):
        sched, reqs = _smoke_pool(cuda, True, max_new=33)
        while sched.has_work:
            n0 = sched.flushes
            rep = sched.poll()
            if exact:
                sched.exit_stats()
            else:
                assert sched.flushes == n0 and rep.flush_wait_ms == 0.0
        assert sched._step_idx > 32
        if not exact:
            assert sched.flushes == 0 and sched.flush_wait_ms_total == 0.0
        sched.flush_counters()
        runs.append(([r.out_tokens for r in reqs], sched.exit_counts.copy(),
                     sched.tokens_served))
    assert runs[0][0] == runs[1][0]
    assert runs[0][2] == runs[1][2] == runs[0][1].sum()
    assert runs[0][1].tolist() == runs[1][1].tolist()


def test_window_threshold_moves_without_recapture(cuda):
    """An adaptive controller moves the exit threshold every 4 tokens: the
    window writes its device threshold before the next dispatch and
    replays the one graph; the counters see the new threshold."""
    from repro_torch.serving import AdaptiveExitController
    sched, _ = _smoke_pool(cuda, True, max_new=17)
    sched.controller = AdaptiveExitController(0.01, threshold=0.3)
    sched.adaptive_every = 4
    sched.run()
    torch.cuda.synchronize()
    w = sched._window
    assert sched.controller.threshold > 0.3 and w.captures == 1
    assert 0.3 < w.threshold <= sched.controller.threshold
    assert float(w.thr.item()) == pytest.approx(w.threshold, rel=1e-6)


def test_decode_window_counts_replayed_launches(cuda):
    """A replay makes no Python call, so the window adds the launches one
    step made during capture times R: after the first window the paged
    kernel's count is layers x (warm-up steps + R), and each later window
    adds layers x R."""
    sched, _ = _smoke_pool(cuda, True, R=4)
    sched.prefill_poll()                          # four slots admitted
    assert sched._pending is None and sched.active.all()
    layers = sched.model.cfg.num_layers
    ops.reset_launches()
    sched.poll()                                  # capture + window 1
    w = sched._window
    assert w.captures == 1 and w.replays == 4
    assert w.per_replay["paged_gqa_attention"] == layers
    assert ops.LAUNCHES["paged_gqa_attention"] == layers * w.steps_run
    sched.poll()                                  # window 2, commit 1
    assert w.replays == 8 and w.captures == 1
    assert ops.LAUNCHES["paged_gqa_attention"] == layers * w.steps_run
    sched.sync()


def test_decode_window_capture_failure_raises(cuda, monkeypatch):
    """A step that cannot be captured (here one that synchronizes the
    card) makes the dispatch raise; the window never runs eagerly on the
    card instead."""
    from repro_torch.serving import window as win
    sched, _ = _smoke_pool(cuda, True, R=4)
    sched.prefill_poll()
    real_step = win.DecodeWindow._step

    def syncing_step(self):
        real_step(self)
        torch.cuda.synchronize()
    monkeypatch.setattr(win.DecodeWindow, "_step", syncing_step)
    with pytest.raises(RuntimeError):
        sched.poll()
    assert sched._window.graph is None and sched._window.replays == 0
    assert not sched._win_q


def _spec_models(dev):
    from repro_torch.configs import get_config
    from repro_torch.models import Model
    model = Model(get_config("granite-3-2b-smoke"), device=dev)
    return model, model.init(0), model.init(7)


@pytest.mark.parametrize("draft_seed", [0, 7], ids=["agreeable", "rejecting"])
def test_spec_pair_matches_target_only_on_card(cuda, draft_seed):
    """A SpecPair at granite-3-2b-smoke on the card (paged GQA through the
    kernel) against the port's target-only monolithic greedy pool on the
    card: the same streams, bit for bit; every page back in the pool or
    held by the prefix cache alone."""
    import numpy as np
    from repro_torch.serving import (ContinuousBatchScheduler, ModelGroup,
                                     Request, SchedulerConfig, SpecPair)
    model, params, other = _spec_models(cuda)
    draft = params if draft_seed == 0 else other
    cfg = SchedulerConfig(n_slots=4, max_len=48, prefill_chunk=8,
                          exit_threshold=0.0, segmented=False, paged=True)
    rs = np.random.RandomState(3)
    prompts = [rs.randint(0, 1024, int(n)) for n in (5, 12, 9, 16, 7)]
    outs = []
    for sched in (ContinuousBatchScheduler(model, params, cfg, device=cuda),
                  SpecPair(ModelGroup([("d", model, draft),
                                       ("t", model, params)]), cfg, k=4)):
        reqs = [Request(tokens=p, max_new=12, req_id=i)
                for i, p in enumerate(prompts)]
        for r in reqs:
            sched.submit(r)
        n0 = ops.LAUNCHES["paged_gqa_attention"]
        sched.run()
        torch.cuda.synchronize()
        assert ops.LAUNCHES["paged_gqa_attention"] > n0
        outs.append([list(r.out_tokens) for r in reqs])
    assert outs[0] == outs[1]
    st = sched.spec_stats()
    assert (st["acceptance_len"] >= 3.0) == (draft_seed == 0)
    for pool in sched.pools.values():
        assert pool.page_alloc.free_count + len(pool.prefix_cache) \
            == pool.page_alloc.n_pages


def test_spec_verify_round_on_card(cuda):
    """One verify round on the card: a window whose second draft is
    wrong commits two tokens (the accepted draft and the correction),
    equal to target-only greedy, and the round runs k steps of the paged
    kernel (one launch a layer a step)."""
    import numpy as np
    from repro_torch.serving import (ContinuousBatchScheduler, Request,
                                     SchedulerConfig)
    model, params, _ = _spec_models(cuda)
    cfg = SchedulerConfig(n_slots=1, max_len=32, prefill_chunk=8,
                          exit_threshold=0.0, segmented=False, paged=True)
    prompt = np.random.RandomState(4).randint(0, 1024, 8)
    ref = ContinuousBatchScheduler(model, params, cfg, device=cuda)
    want = Request(tokens=prompt, max_new=8)
    ref.submit(want)
    ref.run()
    s = ContinuousBatchScheduler(model, params, cfg, device=cuda)
    s.ensure_spec(4)
    r = Request(tokens=prompt.copy(), max_new=8)
    s.submit(r)
    s.prefill_poll()
    drafts = np.asarray([[want.out_tokens[1],
                          (want.out_tokens[2] + 1) % 1024, 0]], np.int32)
    n0 = ops.LAUNCHES["paged_gqa_attention"]
    committed = s.spec_verify(drafts, s.spec_window_lens())
    torch.cuda.synchronize()
    assert int(committed[0]) == 2
    assert r.out_tokens == want.out_tokens[:3]
    assert ops.LAUNCHES["paged_gqa_attention"] - n0 \
        == 4 * model.cfg.num_layers
