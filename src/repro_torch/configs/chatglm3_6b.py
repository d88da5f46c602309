"""chatglm3-6b  [arXiv:2406.12793; hf:THUDM/chatglm3-6b]

28L d_model=4096 32H (multi-query GQA kv=2) d_ff=13696 vocab=65024.
2D RoPE: rotation applied to half of each head dim (rope_fraction=0.5);
QKV bias enabled (add_qkv_bias=true in the HF config).
"""

from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="chatglm3-6b",
    family="dense",
    n_layers=28,
    d_model=4096,
    n_heads=32,
    n_kv_heads=2,
    d_ff=13696,
    vocab_size=65024,
    head_dim=128,
    rope_fraction=0.5,
    qkv_bias=True,
    rope_theta=10000.0,
)

SMOKE = CONFIG.replace(
    n_layers=3, d_model=64, n_heads=8, n_kv_heads=2, head_dim=8,
    d_ff=160, vocab_size=503, dtype="float32", param_dtype="float32",
)
