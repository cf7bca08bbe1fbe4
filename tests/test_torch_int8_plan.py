"""Host-side planning of the int8 handoff kernels
(``kernels/feature_compress.py``): the choice between the ``vec`` and the
``scalar`` instance, the lane layout and the persistent grid, the
constants the CUDA source shares with the plan, and CPU emulations of the
``vec`` instance's arithmetic and layout (the magic-number rounding, the
lane groups' max, the packed q bytes and the scale stores; the row of a
dequantized vector), each held bit for bit against the plain versions.
Runs on the CPU: nothing here launches a kernel."""
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.kernels import feature_compress as fc
from repro_torch.kernels import ref

CSRC = (Path(__file__).resolve().parents[1] / "src" / "repro_torch"
        / "kernels" / "csrc" / "feature_compress.cu")
ALIGNED = (0, 4096, 1 << 20)          # three 16-byte aligned addresses


def _constant(name, kind="int"):
    pat = {"int": r"(\d+)", "float": r"([0-9.]+)f"}[kind]
    m = re.search(rf"constexpr {kind} {name} = {pat};", CSRC.read_text())
    assert m, f"{name} not found in {CSRC.name}"
    return (int if kind == "int" else float)(m.group(1))


def test_constants_match_the_cuda_source():
    assert fc.WARPS == _constant("kWarpsPerBlock")
    assert fc.LOADS == _constant("kLoads")
    assert fc.DEQ_LOADS == _constant("kDeqLoads")
    assert fc.MAX_VECTORS == _constant("kMaxVectors")
    assert fc.SCALAR_THREADS == _constant("kScalarThreads")
    assert _constant("kRoundMagic", "float") == 1.5 * 2 ** 23
    m = re.search(r"constexpr int blocks_per_sm\(int v\) \{ return v >= "
                  r"(\d+) \? (\d+) : v >= (\d+) \? (\d+) : (\d+); \}",
                  CSRC.read_text())
    assert m, "blocks_per_sm not found"
    v1, b1, v2, b2, b3 = map(int, m.groups())
    for v in (1, 2, 4, 8, 16):
        assert fc.blocks_per_sm(v) == (b1 if v >= v1 else b2 if v >= v2
                                       else b3)


@pytest.mark.parametrize("kernel,d,elem,offset,want", [
    ("quantize", 64, 2, 0, "vec"),       # granite-3-2b's kv heads, bf16
    ("quantize", 128, 2, 0, "vec"),
    ("quantize", 512, 2, 0, "vec"),      # deepseek-v3's c_kv
    ("quantize", 2048, 4, 0, "vec"),     # fp32 hidden rows
    ("quantize", 2048, 2, 0, "vec"),
    ("quantize", 100, 2, 0, "scalar"),   # 200-byte rows: not whole vectors
    ("quantize", 100, 4, 0, "vec"),      # 400-byte rows are (25 vectors)
    ("quantize", 64, 2, 2, "scalar"),    # a view 2 bytes off 16
    ("quantize", 64, 4, 8, "scalar"),
    ("dequantize", 64, 2, 0, "vec"),     # bf16 out: rows of 8 vectors
    ("dequantize", 100, 2, 0, "scalar"),
    ("dequantize", 100, 4, 0, "vec"),
    ("dequantize", 36, 4, 0, "vec"),
    ("dequantize", 64, 2, 1, "scalar")])  # q a view 1 byte off 16
def test_instance_by_row_width_and_alignment(kernel, d, elem, offset, want):
    ptrs = (ALIGNED[0] + offset, ALIGNED[1], ALIGNED[2])
    assert fc.plan(1000, d, elem, ptrs, kernel=kernel)["instance"] == want
    # every pointer counts, inputs and outputs alike
    assert fc.plan(1000, d, elem, (0, 0, 4),
                   kernel=kernel)["instance"] == "scalar"


@pytest.mark.parametrize("rows,d,elem,g,v,u,grid", [
    (655360, 64, 2, 8, 1, 4, 528),      # the granite slot leaf
    (124928, 512, 2, 32, 2, 2, 528),    # the deepseek-v3 c_kv leaf
    (4096, 2048, 4, 32, 16, 1, 132),    # fp32 hidden rows: 1 block/SM
    (1000, 2048, 2, 32, 8, 1, 125),     # bf16 hidden rows: 2 blocks/SM
    (1001, 128, 2, 16, 1, 4, 16),       # 8 rows a warp iteration
    (777, 100, 4, 32, 1, 4, 25),        # 25 vectors: 7 lanes idle
    (99, 8, 2, 1, 1, 4, 1),             # one vector a row, 128 rows
    (333, 4096, 2, 32, 16, 1, 42)])     # 8 KB rows, the widest
def test_quantize_layout_and_grid(rows, d, elem, g, v, u, grid):
    p = fc.plan(rows, d, elem, ALIGNED, sms=132)
    assert (p["g"], p["v"], p["u"], p["grid"]) == (g, v, u, grid)
    chunks = d * elem // 16
    assert p["rows_per_warp"] == 32 // g and g & (g - 1) == 0
    assert g * v >= chunks                          # the row is covered
    assert g * v < 2 * chunks or v == 1             # no lane idles twice
    assert v <= fc.MAX_VECTORS
    assert u * v >= fc.LOADS                        # loads in flight
    assert grid <= 132 * fc.blocks_per_sm(v)        # persistent


def test_rows_wider_than_a_warps_registers_take_scalar():
    """A row over 32 x 16 vectors (8 KB) does not fit in a warp's
    registers: bf16 D 7168 (deepseek-v3's hidden rows), fp32 D 4096."""
    assert fc.plan(16, 4096, 2, ALIGNED)["instance"] == "vec"
    for d, elem in ((4104, 2), (7168, 2), (2056, 4), (4096, 4)):
        assert fc.plan(16, d, elem, ALIGNED)["instance"] == "scalar"


@pytest.mark.parametrize("rows,d,elem,shift,grid", [
    (655360, 64, 2, 3, 528),      # the granite leaf: 8 pieces a row
    (124928, 512, 2, 6, 528),     # the deepseek-v3 c_kv leaf
    (4096, 2048, 4, 9, 528),      # fp32 hidden rows
    (100, 192, 2, -1, 2),         # 24 pieces a row: the magic divide
    (3, 16, 2, 1, 1), (3, 4, 4, 0, 1),
    (1000, 7168, 2, -1, 438)])
def test_dequantize_plan(rows, d, elem, shift, grid):
    p = fc.plan(rows, d, elem, ALIGNED, sms=132, kernel="dequantize")
    assert p["instance"] == "vec" and p["shift"] == shift
    assert p["elems"] == 16 // elem
    assert p["grid"] == grid and p["pieces"] == rows * d // p["elems"]
    assert grid <= 132 * fc.blocks_per_sm(1)
    if shift < 0:
        assert (p["mul"], p["shr"]) == fc.divide_magic(d // p["elems"])


def test_dequantize_plan_keeps_piece_indices_in_31_bits():
    """256 bf16 are 32 pieces a row: 2^26 rows make 2^31 pieces."""
    assert fc.plan(2 ** 26, 256, 2, ALIGNED,
                   kernel="dequantize")["instance"] == "scalar"
    assert fc.plan(2 ** 26 - 1, 256, 2, ALIGNED,
                   kernel="dequantize")["instance"] == "vec"


@pytest.mark.parametrize("c", [3, 5, 6, 7, 12, 25, 100, 448, 896, 1792,
                               12345, 1000003])
def test_fast_divide_is_exact_below_2_31(c):
    """The 32-bit multiply-high divide that finds a vector's row when D /
    16 is not a power of two, on every boundary i = k c - 1, k c and on
    seeded draws up to 2^31 - 1."""
    mul, shr = fc.divide_magic(c)
    assert 0 < mul < 2 ** 32 and 0 <= shr <= 31
    rs = np.random.RandomState(c)
    ks = np.arange(1, 2000, dtype=np.uint64)
    i = np.concatenate([ks * c - 1, ks * c, rs.randint(0, 2 ** 31, 20000,
                                                       dtype=np.int64),
                        [0, 2 ** 31 - 1, 2 ** 31 - 2]]).astype(np.uint64)
    i = i[i < 2 ** 31]
    got = (((i * np.uint64(mul)) >> np.uint64(32)) + i) >> np.uint64(shr)
    np.testing.assert_array_equal(got, i // np.uint64(c))


def _f32(a):
    return np.asarray(a, dtype=np.float32)


def _round_magic(y):
    """The kernel's clip(round_half_even(y), +-127) as an int8: the low
    byte of the bits of fl(clip(y) + 1.5 * 2^23)."""
    t = _f32(np.clip(_f32(y), -127, 127)) + np.float32(1.5 * 2 ** 23)
    return (_f32(t).view(np.uint32) & 0xff).astype(np.uint8).view(np.int8)


def test_magic_rounding_is_rint_then_clip():
    """Every quarter in [-140, 140], the fp32 neighbours of every
    half-integer there, and seeded draws, against rint and clip."""
    q = _f32(np.arange(-560, 561) / 4)
    halves = _f32(np.arange(-280, 281) + 0.5)
    near = np.concatenate([np.nextafter(halves, np.float32(np.inf)),
                           np.nextafter(halves, np.float32(-np.inf)),
                           halves, -np.zeros(1, np.float32)])
    draws = _f32(np.random.RandomState(0).uniform(-130, 130, 10 ** 6))
    for y in (q, near, draws):
        want = np.clip(np.rint(y), -127, 127).astype(np.int8)
        np.testing.assert_array_equal(_round_magic(y), want)


def _byte_perm(a, b, sel):
    """CUDA's __byte_perm on uint32 arrays."""
    src = [(a >> np.uint32(8 * i)) & np.uint32(0xff) for i in range(4)] + \
          [(b >> np.uint32(8 * i)) & np.uint32(0xff) for i in range(4)]
    out = np.zeros_like(a)
    for n in range(4):
        out |= src[(sel >> (4 * n)) & 7] << np.uint32(8 * n)
    return out


def emulate_vec_quantize(x: torch.Tensor, p: dict):
    """The vec instance on the CPU, lane by lane as the plan lays it out:
    lane k of a row's group of g holds the row's 16-byte vectors c = j g +
    k; the lanes' maxima meet in an xor butterfly over the group; each
    vector's q goes out as little-endian words packed with __byte_perm, the
    group's lane 0 writes the scale.  Returns (q, scale) and checks that
    every q byte and every scale is written exactly once."""
    rows, d = x.shape
    e = 16 // x.element_size()
    chunks = d // e
    g = p["g"]
    xf = x.float().numpy()
    vecs = xf.reshape(rows, chunks, e)
    lane_max = np.zeros((rows, g), np.float32)
    for c in range(chunks):
        lane_max[:, c % g] = np.maximum(lane_max[:, c % g],
                                        np.abs(vecs[:, c]).max(axis=1))
    o = g // 2
    while o:
        lane_max = np.maximum(lane_max, lane_max[:, np.arange(g) ^ o])
        o //= 2
    assert (lane_max == lane_max[:, :1]).all()   # every lane has the max
    s = np.maximum(lane_max[:, 0] * np.float32(ref.INV127),
                   np.float32(1e-8)).astype(np.float32)
    q_bytes = np.zeros(rows * d, np.uint8)
    written = np.zeros(rows * d, np.int32)
    for c in range(chunks):
        y = _f32(vecs[:, c] / s[:, None])              # IEEE fp32 division
        t = _f32(np.clip(y, -127, 127)) + np.float32(1.5 * 2 ** 23)
        raw = _f32(t).view(np.uint32)                  # [rows, e]
        words = [_byte_perm(_byte_perm(raw[:, 4 * i], raw[:, 4 * i + 1],
                                       0x0040),
                            _byte_perm(raw[:, 4 * i + 2], raw[:, 4 * i + 3],
                                       0x0040), 0x5410)
                 for i in range(e // 4)]
        packed = np.stack(words, axis=1).astype("<u4").view(np.uint8)
        at = np.arange(rows)[:, None] * d + c * e + np.arange(e)[None, :]
        q_bytes[at] = packed
        written[at] += 1
    assert (written == 1).all()
    q = torch.from_numpy(q_bytes.view(np.int8).reshape(rows, d).copy())
    return q, torch.from_numpy(s.reshape(rows, 1))


def _rows(rows, d, dtype, seed):
    """Rows of mixed magnitude, a zero row, and a row whose scale is 1 so
    that half-integers in it are exact ties."""
    rs = np.random.RandomState(seed)
    x = rs.randn(rows, d) * rs.exponential(1.0, (rows, 1)) \
        * 10.0 ** rs.randint(-3, 3, (rows, 1))
    x[0] = 0.0
    x[1] = np.resize([127.0, 0.5, -0.5, 1.5, -2.5, 126.5, -126.5, 3.25], d)
    return torch.from_numpy(x.astype(np.float32)).to(dtype)


@pytest.mark.parametrize("rows,d,dtype", [
    (37, 64, torch.bfloat16), (21, 128, torch.bfloat16),
    (9, 512, torch.bfloat16), (5, 2048, torch.float32),
    (13, 100, torch.float32), (17, 8, torch.bfloat16),
    (3, 4096, torch.bfloat16)])
def test_vec_emulation_matches_plain_bitwise(rows, d, dtype):
    x = _rows(rows, d, dtype, seed=d)
    p = fc.plan(rows, d, x.element_size(), ALIGNED)
    assert p["instance"] == "vec"
    q, s = emulate_vec_quantize(x, p)
    qr, sr = ref.quantize_rows_ref(x)
    assert torch.equal(q, qr)
    assert torch.equal(s.view(torch.int32), sr.view(torch.int32))
    assert s[0].item() == np.float32(1e-8) and not q[0].any()


@pytest.mark.parametrize("rows,d,out", [
    (37, 64, torch.bfloat16), (37, 64, torch.float32),
    (11, 192, torch.bfloat16), (11, 192, torch.float32),
    (5, 7168, torch.bfloat16), (5, 7168, torch.float32),
    (40, 16, torch.bfloat16), (40, 16, torch.float32),
    (9, 36, torch.float32), (9, 100, torch.float32)])
def test_dequantize_emulation_matches_plain_bitwise(rows, d, out):
    """Piece i (the lane's 16-byte output vector) takes the scale of the
    plan's row of i (shift or magic divide), and each element float(q) *
    scale rounds once."""
    elem = torch.tensor([], dtype=out).element_size()
    rs = np.random.RandomState(d)
    q = torch.from_numpy(rs.randint(-127, 128, (rows, d)).astype(np.int8))
    s = torch.from_numpy(rs.exponential(1.0, (rows, 1)).astype(np.float32))
    p = fc.plan(rows, d, elem, ALIGNED, kernel="dequantize")
    assert p["instance"] == "vec"
    i = np.arange(p["pieces"], dtype=np.uint64)
    if p["shift"] >= 0:
        row = i >> np.uint64(p["shift"])
    else:
        row = (((i * np.uint64(p["mul"])) >> np.uint64(32)) + i) \
            >> np.uint64(p["shr"])
    scale = s.numpy()[row.astype(np.int64), 0]
    y = q.numpy().reshape(-1, p["elems"]).astype(np.float32) \
        * scale[:, None]
    got = torch.from_numpy(_f32(y).reshape(rows, d)).to(out)
    want = ref.dequantize_rows_ref(q, s, out)
    view = {torch.bfloat16: torch.int16, torch.float32: torch.int32}[out]
    assert torch.equal(got.view(view), want.view(view))
