"""zamba2-1.2b — hybrid Mamba2 backbone with a shared attention block.

[arXiv:2411.15242] Zamba2 suite.  38 Mamba2 (SSD) layers, d_model=2048,
ssm_state=64, plus ONE weight-shared attention+MLP block (32H, d_ff=8192)
applied every `shared_attn_period` layers — the Zamba2 signature.
"""
from repro_torch.configs.base import ExitConfig, ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="zamba2-1.2b",
    family="hybrid",
    num_layers=38,
    d_model=2048,
    num_heads=32,
    num_kv_heads=32,
    d_ff=8192,
    vocab_size=32_000,
    attention="full",
    long_context_window=4096,
    rope="rope",
    ssm=SSMConfig(state_size=64, conv_width=4, expand=2, head_dim=64,
                  chunk_size=256),
    shared_attn_period=6,
    exits=ExitConfig(exit_layers=(12, 24), entropy_threshold=0.5),
    source="arXiv:2411.15242",
)
