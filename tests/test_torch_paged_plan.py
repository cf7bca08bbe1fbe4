"""Host-side planning of the paged decode kernels (``kernels/paged_mla.py``,
``kernels/paged_attention.py``): how a page table is split across blocks,
the scratch each split needs, the constants shared with the CUDA sources,
and, in plain torch on the CPU, the arithmetic the kernels run: the
two-level merge of per-split partials and, for paged MLA, P as a bf16 high
and low part.  Nothing here launches a kernel."""
import math
import re
from pathlib import Path

import pytest
import torch

from repro_torch.kernels import paged_attention, paged_mla, ref

CSRC = (Path(__file__).resolve().parents[1] / "src" / "repro_torch"
        / "kernels" / "csrc")
H100_SMS = 132
PAGE = 16


def _constant(name, source):
    m = re.search(rf"constexpr int {name} = (\d+);",
                  (CSRC / source).read_text())
    assert m, f"{name} not found in {source}"
    return int(m.group(1))


def test_constants_match_the_cuda_sources():
    assert paged_mla.HEADS_PER_BLOCK == _constant("BH", "paged_mla.cu")
    assert paged_mla.PAGES_PER_STAGE == _constant("PAGES", "paged_mla.cu")
    assert _constant("P", "paged_mla.cu") == PAGE
    assert paged_attention.KV_HEADS_PER_BLOCK == _constant(
        "KVB", "paged_attention.cu")
    assert paged_attention.KV_HEADS_PER_BLOCK_WIDE == _constant(
        "KVB_WIDE", "paged_attention.cu")
    assert [paged_attention.kv_heads_per_block(h)
            for h in (64, 128, 224)] == [8, 8, 4]
    assert _constant("P", "paged_attention.cu") == PAGE


@pytest.mark.parametrize("source", ["paged_mla.cu", "paged_attention.cu"])
def test_masked_sentinel_is_the_references(source):
    """The finite NEG_INF of the reference (-1e30), not -inf: a row whose
    first tokens are masked must not turn into NaN."""
    text = (CSRC / source).read_text()
    m = re.search(r"constexpr float kNegInf = ([-0-9.e]+)f;", text)
    assert m and float(m.group(1)) == ref.NEG_INF
    assert "1e-30f" in text                  # the floor of l


def _covers_exactly_once(p, pps):
    owner = [z for z in range(p["splits"])
             for _ in range(z * p["split_pages"],
                            min((z + 1) * p["split_pages"], pps))]
    assert len(owner) == pps                 # every page, once, in order
    assert (p["splits"] - 1) * p["split_pages"] < pps \
        <= p["splits"] * p["split_pages"]


@pytest.mark.parametrize("b,n,pps,splits,split_pages", [
    (16, 128, 9, 1, 10),       # phase 6's live tables: one launch
    (16, 128, 18, 1, 18),
    (16, 128, 128, 5, 26),     # phase 2's shape: one wave of 160 blocks
    (1, 128, 128, 8, 16),      # one sequence: splits of the minimum size
    (3, 128, 37, 2, 20),       # a table that is no whole number of splits
    (5, 4, 8, 1, 8),           # smoke width
    (5, 4, 40, 2, 20)])
def test_mla_plan(b, n, pps, splits, split_pages):
    p = paged_mla.plan(b, n, pps, H100_SMS)
    assert (p["splits"], p["split_pages"]) == (splits, split_pages)
    assert p["split_pages"] % paged_mla.PAGES_PER_STAGE == 0
    assert p["grid"] == (-(-n // 64), b, splits)
    assert p["launches"] == (1 if splits == 1 else 2)
    if pps >= paged_mla.MIN_SPLIT_PAGES:
        assert p["split_pages"] >= paged_mla.MIN_SPLIT_PAGES
    assert p["splits"] <= -(-H100_SMS // (b * p["tiles"]))    # one wave
    _covers_exactly_once(p, pps)


@pytest.mark.parametrize("b,nkv,hd,pps,splits,split_pages", [
    (16, 8, 64, 18, 9, 2),     # phase 4's live tables (granite-3-2b)
    (16, 8, 64, 128, 9, 15),   # phase 2's shape
    (16, 8, 64, 9, 3, 3),
    (1, 8, 64, 2, 1, 2),       # one split: one launch
    (5, 2, 128, 8, 4, 2),
    (3, 12, 128, 37, 13, 3),   # two kv-head groups
    (64, 8, 64, 128, 3, 43),   # many sequences: fewer, longer splits
    (32, 32, 224, 256, 1, 256),    # Zamba2-7B's sites: 8 blocks of 4
    (2, 32, 224, 256, 9, 29)])     # ... two rows: splits fill the wave
def test_gqa_plan(b, nkv, hd, pps, splits, split_pages):
    p = paged_attention.plan(b, nkv, pps, H100_SMS, hd)
    assert (p["splits"], p["split_pages"]) == (splits, split_pages)
    kvb = 8 if hd <= 128 else 4
    assert p["grid"] == (-(-nkv // kvb), b, splits)
    assert p["launches"] == (1 if splits == 1 else 2)
    assert p["split_pages"] >= min(pps, paged_attention.MIN_SPLIT_PAGES)
    _covers_exactly_once(p, pps)


@pytest.mark.parametrize("kind,b,heads,width,pps", [
    ("mla", 16, 128, 512, 128), ("mla", 16, 128, 512, 9),
    ("gqa", 16, 32, 64, 18), ("gqa", 16, 32, 64, 9)])
def test_split_scratch_sizes(kind, b, heads, width, pps):
    """The fp32 scratch a call allocates: per split, each head's context
    (or output) and its (m, l); none with one split."""
    if kind == "mla":
        p = paged_mla.plan(b, heads, pps, H100_SMS)
    else:
        p = paged_attention.plan(b, heads // 4, pps, H100_SMS, width)
    acc = b * p["splits"] * heads * width * 4 if p["splits"] > 1 else 0
    ml = b * p["splits"] * heads * 2 * 4 if p["splits"] > 1 else 0
    want = {("mla", 128): (20_971_520, 81_920), ("mla", 9): (0, 0),
            ("gqa", 18): (1_179_648, 36_864), ("gqa", 9): (393_216, 12_288)}
    assert (acc, ml) == want[(kind, pps)]


def _table(gen, b, pps, pos_max):
    pos = torch.randint(0, pos_max, (b,), generator=gen, dtype=torch.int32)
    pos[0] = 0                                  # a one-token sequence
    n_pages = b * pps + 3
    perm = torch.randperm(n_pages, generator=gen).to(torch.int32)
    tbl = perm[:b * pps].reshape(b, pps).clone()
    cols = torch.arange(pps)[None, :]
    tbl = torch.where(cols < (pos.long() // PAGE + 1)[:, None], tbl,
                      torch.full_like(tbl, n_pages))   # sentinel tails
    return tbl, pos, n_pages


def _split_partials(s_log2, v, pos, pps, split_pages):
    """What the kernels' partial pass computes, in fp32: s_log2 [B, H, T]
    scores already scaled into base 2, v [B, T, W] -> per split the
    unnormalised output [B, S, H, W] and (m, l) [B, S, H]; splits past a
    sequence's last page are marked unused."""
    b, h, t = s_log2.shape
    splits = -(-pps // split_pages)
    n_iter = torch.clamp(pos.long() // PAGE + 1, max=pps)
    acc = torch.zeros(b, splits, h, v.shape[-1])
    m = torch.full((b, splits, h), ref.NEG_INF)
    l = torch.zeros(b, splits, h)
    used = torch.zeros(b, splits, dtype=torch.bool)
    tok = torch.arange(t)
    for z in range(splits):
        lo = z * split_pages * PAGE
        for i in range(b):
            hi = min((z + 1) * split_pages, int(n_iter[i])) * PAGE
            if lo >= hi:
                continue
            used[i, z] = True
            keep = (tok >= lo) & (tok < hi) & (tok <= pos[i])
            x = s_log2[i][:, keep]
            m[i, z] = x.max(dim=-1).values
            p = torch.exp2(x - m[i, z][:, None])
            l[i, z] = p.sum(-1)
            acc[i, z] = p @ v[i][keep]
    return acc, m, l, used


def _merge(acc, m, l, used):
    """paged_*_combine: M = max m_s, sum_s acc_s 2^(m_s - M) /
    max(sum_s l_s 2^(m_s - M), 1e-30), over the used splits."""
    m = torch.where(used[..., None], m, torch.full_like(m, ref.NEG_INF))
    mx = m.max(dim=1, keepdim=True).values
    w = torch.where(used[..., None], torch.exp2(m - mx), torch.zeros_like(m))
    num = (acc * w[..., None]).sum(1)
    den = torch.clamp((l * w).sum(1), min=1e-30)
    return num / den[..., None]


@pytest.mark.parametrize("b,n,r,hr,pps", [(5, 4, 32, 16, 40),
                                          (3, 8, 64, 16, 37)])
def test_mla_merge_of_splits_matches_plain(b, n, r, hr, pps):
    gen = torch.Generator().manual_seed(n + pps)
    tbl, pos, n_pages = _table(gen, b, pps, pps * PAGE)
    ql = torch.randn(b, 1, n, r, generator=gen).bfloat16()
    qr = torch.randn(b, 1, n, hr, generator=gen).bfloat16()
    pc = torch.randn(n_pages, PAGE, r, generator=gen).bfloat16()
    pk = torch.randn(n_pages, PAGE, hr, generator=gen).bfloat16()
    scale = 1.0 / math.sqrt(3 * hr)
    want = ref.paged_mla_attention_ref(ql, qr, pc, pk, tbl, pos, scale=scale)
    tblc = tbl.long().clamp(0, n_pages - 1)
    ckv = pc[tblc].reshape(b, -1, r).float()
    kr = pk[tblc].reshape(b, -1, hr).float()
    s = (torch.einsum("bnr,btr->bnt", ql[:, 0].float(), ckv)
         + torch.einsum("bnh,bth->bnt", qr[:, 0].float(), kr))
    p = paged_mla.plan(b, n, pps, H100_SMS)
    assert p["splits"] > 1
    got = _merge(*_split_partials(s * scale * math.log2(math.e), ckv, pos,
                                  pps, p["split_pages"]))
    assert (got - want[:, 0]).abs().max().item() <= 1e-3


@pytest.mark.parametrize("g,hd,pps", [(4, 64, 18), (5, 64, 37), (6, 128, 9)])
def test_gqa_merge_of_splits_matches_plain(g, hd, pps):
    b, nkv = 4, 2
    gen = torch.Generator().manual_seed(g + hd + pps)
    tbl, pos, n_pages = _table(gen, b, pps, pps * PAGE)
    q = torch.randn(b, 1, nkv * g, hd, generator=gen).bfloat16()
    pk = torch.randn(n_pages, PAGE, nkv, hd, generator=gen).bfloat16()
    pv = torch.randn(n_pages, PAGE, nkv, hd, generator=gen).bfloat16()
    want = ref.paged_gqa_attention_ref(q, pk, pv, tbl, pos).float()
    p = paged_attention.plan(b, nkv, pps, H100_SMS, hd)
    assert p["splits"] > 1
    tblc = tbl.long().clamp(0, n_pages - 1)
    got = torch.empty(b, nkv * g, hd)
    for kvh in range(nkv):
        k = pk[tblc][:, :, :, kvh].reshape(b, -1, hd).float()
        v = pv[tblc][:, :, :, kvh].reshape(b, -1, hd).float()
        qk = q[:, 0, kvh * g:(kvh + 1) * g].float()
        s = torch.einsum("bgh,bth->bgt", qk, k) / math.sqrt(hd)
        got[:, kvh * g:(kvh + 1) * g] = _merge(*_split_partials(
            s * math.log2(math.e), v, pos, pps, p["split_pages"]))
    got = got.bfloat16().float()               # rounded once, at the end
    assert (got - want[:, 0]).abs().max().item() <= 2 ** -6


def _mla_context_with_p(p_of, b=16, n=128, r=512, hr=64, pps=9, seed=0):
    """The latent context of one split at deepseek-v3's full width, with
    the unnormalised P [B, N, T] (fp32) handed to the context product as
    ``p_of(p)`` and l from the unrounded p, against the plain version."""
    gen = torch.Generator().manual_seed(seed)
    tbl, pos, n_pages = _table(gen, b, pps, pps * PAGE)
    ql = torch.randn(b, 1, n, r, generator=gen).bfloat16()
    qr = torch.randn(b, 1, n, hr, generator=gen).bfloat16()
    pc = torch.randn(n_pages, PAGE, r, generator=gen).bfloat16()
    pk = torch.randn(n_pages, PAGE, hr, generator=gen).bfloat16()
    scale = 1.0 / math.sqrt(128 + hr)
    want = ref.paged_mla_attention_ref(ql, qr, pc, pk, tbl, pos, scale=scale)
    tblc = tbl.long().clamp(0, n_pages - 1)
    ckv = pc[tblc].reshape(b, -1, r).float()
    kr = pk[tblc].reshape(b, -1, hr).float()
    s = (torch.einsum("bnr,btr->bnt", ql[:, 0].float(), ckv)
         + torch.einsum("bnh,bth->bnt", qr[:, 0].float(), kr)) * scale
    valid = torch.arange(s.shape[-1])[None, None, :] <= pos[:, None, None]
    s = s.masked_fill(~valid, ref.NEG_INF)
    p = torch.exp(s - s.max(dim=-1, keepdim=True).values)
    ctx = torch.einsum("bnt,btr->bnr", p_of(p), ckv) / p.sum(-1)[..., None]
    return (ctx - want[:, 0]).abs().max().item()


def test_mla_p_as_bf16_hi_plus_lo_holds_the_tolerance():
    """The paged-MLA kernel feeds P to the tensor cores as bf16 hi + lo
    (two products into one fp32 accumulator).  At full width that stays
    within the kernel's 1e-3; a single bf16 P does not, so the second
    product must not be "simplified" away."""
    def hi_lo(p):
        hi = p.bfloat16().float()
        return hi + (p - hi).bfloat16().float()

    def single(p):
        return p.bfloat16().float()
    assert _mla_context_with_p(hi_lo) <= 1e-4
    assert _mla_context_with_p(single) > 1e-3
