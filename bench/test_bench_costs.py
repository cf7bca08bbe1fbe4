"""The yardstick's counts against hand counts at small shapes."""
import pytest

from bench import costs

CFG = {"hidden_size": 8, "intermediate_size": 16, "num_hidden_layers": 2,
       "num_attention_heads": 4, "num_key_value_heads": 2, "head_dim": 2,
       "vocab_size": 10, "exit_layers": [1]}


def test_matmul_params_by_hand():
    # a layer: wq 8x4x2 = 64, wk, wv 8x2x2 = 32 each, wo 64; FFN 3x8x16
    layer = 64 + 32 + 32 + 64 + 3 * 8 * 16
    # the final head and one exit head, 8 x 10 each
    assert costs.matmul_params(CFG) == 2 * layer + 2 * 80


def test_decode_flops_by_hand():
    p = costs.matmul_params(CFG)
    # contexts 3 and 5: 4 heads x 2 dims x 4 flops a pair, 2 layers
    assert costs.decode_flops(CFG, 2, 3 + 5) == 2 * p * 2 + 4 * 4 * 2 * 8 * 2


def test_forward_flops_by_hand():
    p = costs.matmul_params(CFG)
    # batch 2 of 3 tokens: 6 causal pairs a row
    assert costs.causal_pairs(3) == 6
    assert costs.forward_flops(CFG, 2, 3) == 2 * p * 6 + 4 * 4 * 2 * 12 * 2
    assert costs.flash_fwd_flops(CFG, 2, 3) == 4 * 4 * 2 * 12 * 2


def test_paged_gqa_bytes_by_hand():
    # contexts 3 and 5: K and V rows 2 heads x 2 dims x 2 bytes each,
    # q and out 4 x 2 x 2 bytes each a row, 2 layers
    want = 2 * (2 * 2 * 2 * 2 * 8 + 2 * 4 * 2 * 2 * 2)
    assert costs.paged_gqa_bytes(CFG, [3, 5]) == want


def test_flash_fwd_bytes_by_hand():
    # q and o 4 heads, k and v 2 heads, 2 dims, bf16, 2 x 3 tokens, 2 layers
    assert costs.flash_fwd_bytes(CFG, 2, 3) == 2 * 6 * 2 * 2 * (8 + 4)


def test_roofline_takes_the_larger_bound():
    pk = costs.peaks("NVIDIA H100 80GB HBM3")
    assert pk == {"bf16_flops": 989e12, "hbm_bytes_s": 3.35e12}
    assert costs.roofline_s(989e12, 0, pk) == pytest.approx(1.0)
    assert costs.roofline_s(0, 6.7e12, pk) == pytest.approx(2.0)
    assert costs.peaks("cpu") is None


def test_granite_counts():
    import json
    from pathlib import Path
    cfg = json.loads((Path(__file__).parent / "configs/granite-3-2b.json")
                     .read_text())
    # 2.73 B matmul parameters with the three vocabulary projections
    assert costs.matmul_params(cfg) == pytest.approx(2.7341e9, rel=1e-3)
