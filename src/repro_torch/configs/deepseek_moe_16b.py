"""deepseek-moe-16b  [arXiv:2401.06066; hf:deepseek-ai/deepseek-moe-16b-base]

28L d_model=2048 16H (GQA kv=16) vocab=102400.  Fine-grained MoE: 2 shared +
64 routed experts, top-6, expert d_ff=1408.  Layer 0 is a dense-FFN layer
(first_k_dense_replace=1, dense d_ff=10944 per the HF config); the
assignment line's d_ff=1408 is the per-expert (moe_intermediate) width.

I/O-pattern note (paper technique): expert-sharded checkpoints write shard
offsets linear in (rank, expert_id) -- the nested IterPattern/RankPattern
case of paper Fig 3(c).
"""

from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-moe-16b",
    family="moe",
    n_layers=28,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=1408,                   # per-expert width (assignment)
    vocab_size=102400,
    head_dim=128,
    n_shared_experts=2,
    n_routed_experts=64,
    moe_top_k=6,
    d_ff_expert=1408,
    first_k_dense=1,
    first_dense_ff=10944,
    rope_theta=10000.0,
)

SMOKE = CONFIG.replace(
    n_layers=3, d_model=64, n_heads=4, n_kv_heads=4, head_dim=16,
    d_ff=32, d_ff_expert=32, n_routed_experts=8, moe_top_k=2,
    n_shared_experts=1, first_k_dense=1, first_dense_ff=128,
    vocab_size=503, dtype="float32", param_dtype="float32",
)
