"""llava-next-34b  [hf:llava-hf/llava-v1.6-34b-hf (Yi-34B backbone); unverified]

60L d_model=7168 56H (GQA kv=8) d_ff=20480 vocab=64000.  The vision tower
and anyres tiling are a STUB per the assignment: ``input_specs`` provides
precomputed patch embeddings (B, n_patches=2880, d_model) -- 5 anyres tiles
x 576 CLIP patches -- that are prepended to the text embeddings.  Text
positions follow the patch positions; logits/loss cover text only.
"""

from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="llava-next-34b",
    family="vlm",
    n_layers=60,
    d_model=7168,
    n_heads=56,
    n_kv_heads=8,
    d_ff=20480,
    vocab_size=64000,
    head_dim=128,
    n_patches=2880,
    rope_theta=5000000.0,
)

SMOKE = CONFIG.replace(
    n_layers=3, d_model=64, n_heads=7, n_kv_heads=7, head_dim=8,
    d_ff=160, vocab_size=503, n_patches=8,
    dtype="float32", param_dtype="float32",
)
