"""xlstm-350m — xLSTM stack (mLSTM matrix-memory + sLSTM scalar-memory blocks).

[arXiv:2405.04517] xLSTM: Extended Long Short-Term Memory.  24 layers,
d_model=1024, 4 heads, d_ff=0 (xLSTM blocks use an internal up-projection
instead of a separate FFN), vocab=50304.  sLSTM blocks at layers 5/11/17/23
(xLSTM[7:1]-style ratio), the rest mLSTM.  The blocks' head width is
d_in / heads = 2048 / 4 = 512 (``models/xlstm.py: _dims``); ``head_dim``
below is not read by them.
"""
from repro_torch.configs.base import ExitConfig, ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="xlstm-350m",
    family="ssm",
    num_layers=24,
    d_model=1024,
    num_heads=4,
    num_kv_heads=4,
    d_ff=0,
    vocab_size=50_304,
    attention="full",   # unused by the ssm family
    rope="none",
    ssm=SSMConfig(
        state_size=64,
        head_dim=256,
        chunk_size=256,
        slstm_layers=(5, 11, 17, 23),
        proj_factor=2.0,
    ),
    exits=ExitConfig(exit_layers=(8, 16), entropy_threshold=0.5),
    source="arXiv:2405.04517",
)
