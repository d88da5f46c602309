"""qwen1.5-0.5b  [hf:Qwen/Qwen1.5-0.5B; hf]

24L d_model=1024 16H (kv=16) d_ff=2816 vocab=151936.  QKV bias enabled
(the Qwen1.5 signature).
"""

from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen1.5-0.5b",
    family="dense",
    n_layers=24,
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    d_ff=2816,
    vocab_size=151936,
    qkv_bias=True,
    rope_theta=1000000.0,
)

SMOKE = CONFIG.replace(
    n_layers=3, d_model=64, n_heads=8, n_kv_heads=8, d_ff=160,
    vocab_size=503, dtype="float32", param_dtype="float32",
)
