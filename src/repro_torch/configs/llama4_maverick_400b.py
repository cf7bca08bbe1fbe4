"""llama4-maverick-400b-a17b — MoE decoder, 128 routed experts top-1 + shared.

[hf:meta-llama/Llama-4-Scout-17B-16E family card] 48L, d_model=5120, 40 heads,
GQA kv=8, expert d_ff=8192, vocab=202048, MoE 128 experts top-1 with one
shared expert (Llama-4 style), MoE on every other layer interleaved with
dense FFN layers (d_ff 16384).

long_500k runs via chunked/sliding attention (Llama-4 uses chunked attention
for long context).
"""
from repro_torch.configs.base import ExitConfig, ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="llama4-maverick-400b-a17b",
    family="moe",
    num_layers=48,
    d_model=5120,
    num_heads=40,
    num_kv_heads=8,
    head_dim=128,
    d_ff=16_384,                    # dense (non-MoE) interleaved layers
    vocab_size=202_048,
    attention="full",
    long_context_window=8192,
    rope="rope",
    rope_theta=500_000.0,
    moe=MoEConfig(
        num_experts=128,
        top_k=1,
        num_shared_experts=1,
        d_ff_expert=8192,
        capacity_factor=1.25,
        layer_period=2,             # every other layer MoE
        first_dense_layers=0,
    ),
    exits=ExitConfig(exit_layers=(16, 32), entropy_threshold=0.5),
    source="hf:meta-llama/Llama-4-Scout-17B-16E",
)
