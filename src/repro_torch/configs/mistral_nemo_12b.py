"""mistral-nemo-12b — dense GQA decoder, 128k context.

[hf:mistralai/Mistral-Nemo-Base-2407] 40L, d_model=5120, 32 heads with
EXPLICIT head_dim=128 (q width 4096 != d_model — faithful to Nemo),
GQA kv=8, d_ff=14336, vocab=131072.
"""
from repro_torch.configs.base import ExitConfig, ModelConfig

CONFIG = ModelConfig(
    name="mistral-nemo-12b",
    family="dense",
    num_layers=40,
    d_model=5120,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,
    d_ff=14_336,
    vocab_size=131_072,
    attention="full",
    long_context_window=8192,
    rope="rope",
    rope_theta=1_000_000.0,
    exits=ExitConfig(exit_layers=(13, 26), entropy_threshold=0.5),
    source="hf:mistralai/Mistral-Nemo-Base-2407",
)
