"""granite-3-2b — dense GQA decoder.

[hf:ibm-granite/granite-3.0-2b-base] 40L, d_model=2048, 32 heads
(head_dim=64), GQA kv=8, d_ff=8192, vocab=49155.
"""
from repro_torch.configs.base import ExitConfig, ModelConfig

CONFIG = ModelConfig(
    name="granite-3-2b",
    family="dense",
    num_layers=40,
    d_model=2048,
    num_heads=32,
    num_kv_heads=8,
    head_dim=64,
    d_ff=8192,
    vocab_size=49_155,
    attention="full",
    long_context_window=8192,
    rope="rope",
    rope_theta=10_000.0,
    tie_embeddings=True,
    exits=ExitConfig(exit_layers=(13, 26), entropy_threshold=0.5),
    source="hf:ibm-granite/granite-3.0-2b-base",
)
