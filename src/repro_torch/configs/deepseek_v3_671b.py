"""deepseek-v3-671b — MLA + fine-grained MoE (1 shared + 256 routed, top-8) + MTP.

[arXiv:2412.19437] DeepSeek-V3 Technical Report.  61L, d_model=7168,
128 heads, MLA (q_lora=1536, kv_lora=512, nope=128, rope=64, v=128),
expert d_ff=2048, 256 routed experts top-8 + 1 shared expert, first 3
layers dense (d_ff 18432), vocab=129280, multi-token prediction depth 1.
"""
from repro_torch.configs.base import ExitConfig, ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="deepseek-v3-671b",
    family="moe",
    num_layers=61,
    d_model=7168,
    num_heads=128,
    num_kv_heads=128,
    d_ff=18_432,                   # first_dense_layers FFN width
    vocab_size=129_280,
    attention="mla",
    long_context_window=8192,
    rope="rope",
    rope_theta=10_000.0,
    q_lora_rank=1536,
    kv_lora_rank=512,
    qk_nope_head_dim=128,
    qk_rope_head_dim=64,
    v_head_dim=128,
    moe=MoEConfig(
        num_experts=256,
        top_k=8,
        num_shared_experts=1,
        d_ff_expert=2048,
        capacity_factor=1.25,
        layer_period=1,
        first_dense_layers=3,
    ),
    exits=ExitConfig(exit_layers=(20, 40), entropy_threshold=0.5),
    mtp_depth=1,
    source="arXiv:2412.19437",
)
