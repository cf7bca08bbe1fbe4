"""qwen2-vl-2b — VLM language backbone with M-RoPE.

[arXiv:2409.12191] Qwen2-VL.  28 layers, d_model=1536, 12 heads, GQA kv=2,
d_ff=8960, vocab=151936.  M-RoPE: the rotary embedding is split across
(temporal, height, width) position components.  The ViT vision encoder and
projector are a stub, as in the reference: the caller hands the model
patch embeddings [B, frontend_tokens, D], which take the first positions
of the token stream.
"""
from repro_torch.configs.base import ExitConfig, ModelConfig

CONFIG = ModelConfig(
    name="qwen2-vl-2b",
    family="vlm",
    num_layers=28,
    d_model=1536,
    num_heads=12,
    num_kv_heads=2,
    d_ff=8960,
    vocab_size=151_936,
    attention="full",
    long_context_window=8192,
    rope="mrope",
    rope_theta=1_000_000.0,
    exits=ExitConfig(exit_layers=(9, 18), entropy_threshold=0.5),
    frontend="vision_patches",
    frontend_tokens=1024,          # patch-embedding positions per request
    source="arXiv:2409.12191",
)
