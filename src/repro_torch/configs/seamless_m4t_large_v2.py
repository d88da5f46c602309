"""seamless-m4t-large-v2  [arXiv:2308.11596; hf:facebook/seamless-m4t-v2-large]

Encoder-decoder backbone: 24 encoder + 24 decoder layers, d_model=1024,
16H (kv=16), d_ff=8192, vocab=256206 (padded to 256256 for TP sharding).
The speech frontend (fbank + conformer conv subsampling) is a STUB:
``input_specs`` provides precomputed frame embeddings (B, S, d_model).
Decoder decode steps cache self-attention KV plus the cross-attention K/V
computed once from the encoder output.
"""

from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="seamless-m4t-large-v2",
    family="encdec",
    n_layers=24,
    n_encoder_layers=24,
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    d_ff=8192,
    vocab_size=256206,
    norm="layer",
    frontend="audio",
    rope_theta=10000.0,
)

SMOKE = CONFIG.replace(
    n_layers=2, n_encoder_layers=2, d_model=64, n_heads=8, n_kv_heads=8,
    d_ff=160, vocab_size=503, dtype="float32", param_dtype="float32",
)
