"""yi-6b — llama-architecture dense GQA decoder.

[arXiv:2403.04652] Yi: Open Foundation Models by 01.AI.  32L, d_model=4096,
32 heads, GQA kv=4, d_ff=11008, vocab=64000.
"""
from repro_torch.configs.base import ExitConfig, ModelConfig

CONFIG = ModelConfig(
    name="yi-6b",
    family="dense",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=4,
    d_ff=11_008,
    vocab_size=64_000,
    attention="full",
    long_context_window=8192,
    rope="rope",
    rope_theta=5_000_000.0,
    exits=ExitConfig(exit_layers=(10, 21), entropy_threshold=0.5),
    source="arXiv:2403.04652",
)
