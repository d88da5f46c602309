"""qwen3-32b  [hf:Qwen/Qwen3-32B (per Qwen3-8B family card); hf]

64L d_model=5120 64H (GQA kv=8) d_ff=25600 vocab=151936.  QK-norm per head
(RMS over head dim), explicit head_dim=128, no QKV bias (Qwen3 dropped it).
"""

from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-32b",
    family="dense",
    n_layers=64,
    d_model=5120,
    n_heads=64,
    n_kv_heads=8,
    d_ff=25600,
    vocab_size=151936,
    head_dim=128,
    qk_norm=True,
    rope_theta=1000000.0,
)

SMOKE = CONFIG.replace(
    n_layers=3, d_model=64, n_heads=8, n_kv_heads=2, head_dim=16,
    d_ff=160, vocab_size=503, dtype="float32", param_dtype="float32",
)
