"""whisper-base — encoder-decoder audio transformer backbone.

[arXiv:2212.04356] Robust Speech Recognition via Large-Scale Weak
Supervision.  6-layer encoder + 6-layer decoder, d_model=512, 8 heads (MHA,
kv=8), d_ff=2048, vocab=51865.  The mel-spectrogram and conv front end are
a stub, as in the reference: the caller hands the model frame embeddings
[B, 1500, 512].  The decoder's layers (``decx``) run causal
self-attention, cross-attention over the encoder output, then the FFN.
"""
from repro_torch.configs.base import EncDecConfig, ExitConfig, ModelConfig

CONFIG = ModelConfig(
    name="whisper-base",
    family="encdec",
    num_layers=6,                 # decoder layers
    d_model=512,
    num_heads=8,
    num_kv_heads=8,
    d_ff=2048,
    vocab_size=51_865,
    attention="full",
    rope="none",                  # whisper uses learned/sinusoidal positions
    norm="layernorm",
    act="gelu",
    tie_embeddings=True,
    encdec=EncDecConfig(num_encoder_layers=6, encoder_seq_len=1500),
    exits=ExitConfig(exit_layers=(2, 4), entropy_threshold=0.5),
    frontend="audio_frames",
    frontend_tokens=1500,
    source="arXiv:2212.04356",
)
