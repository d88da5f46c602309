"""stablelm-1.6b  [hf:stabilityai/stablelm-2-1_6b; unverified]

24L d_model=2048 32H (kv=32) d_ff=5632 vocab=100352.  LayerNorm (not RMS),
partial rotary (25% of head dim), QKV bias per the HF config.
"""

from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="stablelm-1.6b",
    family="dense",
    n_layers=24,
    d_model=2048,
    n_heads=32,
    n_kv_heads=32,
    d_ff=5632,
    vocab_size=100352,
    norm="layer",
    rope_fraction=0.25,
    qkv_bias=True,
    rope_theta=10000.0,
)

SMOKE = CONFIG.replace(
    n_layers=3, d_model=64, n_heads=8, n_kv_heads=8, d_ff=160,
    vocab_size=503, dtype="float32", param_dtype="float32",
)
