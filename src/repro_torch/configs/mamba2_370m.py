"""mamba2-370m  [arXiv:2405.21060; hf:state-spaces/mamba2-370m; unverified]

48L d_model=1024, attention-free SSD (state-space duality), ssm_state=128,
vocab=50280.  d_inner = 2*d_model = 2048, head_dim 64 -> 32 SSD heads,
depthwise conv width 4, chunked scan with Q=256.
"""

from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-370m",
    family="ssm",
    n_layers=48,
    d_model=1024,
    n_heads=0,
    n_kv_heads=0,
    d_ff=0,
    vocab_size=50280,
    ssm_state=128,
    ssm_expand=2,
    ssm_head_dim=64,
    ssm_chunk=256,
)

SMOKE = CONFIG.replace(
    n_layers=3, d_model=64, ssm_state=16, ssm_head_dim=16, ssm_chunk=8,
    vocab_size=503, dtype="float32", param_dtype="float32",
)
