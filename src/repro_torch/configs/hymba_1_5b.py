"""hymba-1.5b  [arXiv:2411.13676; hf:nvidia/Hymba-1.5B-Base]

32L d_model=1600 25H (GQA kv=5) d_ff=5504 vocab=32001, ssm_state=16.
Hybrid heads: every block runs attention and Mamba(-2 style) SSM heads in
parallel on the same input and averages the branch outputs.  Sliding-window
attention (W=1024) keeps the attention branch sub-quadratic, which is what
qualifies this arch for the ``long_500k`` shape.  Deviations from the HF
release (meta tokens, per-layer full-attn exceptions, learned branch
scales) are documented in DESIGN.md SectionArch-applicability.
"""

from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="hymba-1.5b",
    family="hybrid",
    hybrid=True,
    n_layers=32,
    d_model=1600,
    n_heads=25,
    n_kv_heads=5,
    d_ff=5504,
    vocab_size=32001,
    head_dim=64,
    sliding_window=1024,
    ssm_state=16,
    ssm_expand=2,
    ssm_head_dim=64,
    rope_theta=10000.0,
)

SMOKE = CONFIG.replace(
    n_layers=3, d_model=64, n_heads=5, n_kv_heads=5, head_dim=8,
    d_ff=160, vocab_size=503, sliding_window=16, ssm_state=8,
    ssm_head_dim=16, dtype="float32", param_dtype="float32",
)
