"""starcoder2-3b — dense GQA decoder with NATIVE sliding-window attention.

[arXiv:2402.19173] StarCoder 2 and The Stack v2.  30L, d_model=3072,
24 heads, GQA kv=2, d_ff=12288, vocab=49152, RoPE, sliding window 4096
(faithful to StarCoder2).
"""
from repro_torch.configs.base import ExitConfig, ModelConfig

CONFIG = ModelConfig(
    name="starcoder2-3b",
    family="dense",
    num_layers=30,
    d_model=3072,
    num_heads=24,
    num_kv_heads=2,
    d_ff=12_288,
    vocab_size=49_152,
    attention="sliding",
    sliding_window=4096,
    long_context_window=4096,
    rope="rope",
    rope_theta=999_999.4,
    norm="layernorm",
    act="gelu",
    exits=ExitConfig(exit_layers=(10, 20), entropy_threshold=0.5),
    source="arXiv:2402.19173",
)
