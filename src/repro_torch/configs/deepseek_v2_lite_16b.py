"""deepseek-v2-lite-16b  [arXiv:2405.04434; hf:deepseek-ai/DeepSeek-V2-Lite]

27L d_model=2048 16H vocab=102400.  MLA attention with kv_lora_rank=512
(qk_nope=128, qk_rope=64, v=128; no q-LoRA in the Lite variant).  MoE:
2 shared + 64 routed top-6 experts (d_ff_expert=1408); layer 0 dense
(d_ff=10944).  The assignment note mentions "160 routed" (the full V2
number); V2-*Lite* ships 64 routed experts, matching the assignment header
"MoE 64e top-6" -- we implement 64 and expose ``n_routed_experts`` as a
plain config field (160 divides the 16-way expert axis too).
"""

from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-v2-lite-16b",
    family="moe",
    n_layers=27,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=1408,
    vocab_size=102400,
    mla=True,
    kv_lora_rank=512,
    qk_nope_dim=128,
    qk_rope_dim=64,
    v_head_dim=128,
    n_shared_experts=2,
    n_routed_experts=64,
    moe_top_k=6,
    d_ff_expert=1408,
    first_k_dense=1,
    first_dense_ff=10944,
    rope_theta=10000.0,
)

SMOKE = CONFIG.replace(
    n_layers=3, d_model=64, n_heads=4, kv_lora_rank=32, qk_nope_dim=16,
    qk_rope_dim=8, v_head_dim=16, d_ff=32, d_ff_expert=32,
    n_routed_experts=8, moe_top_k=2, n_shared_experts=1,
    first_k_dense=1, first_dense_ff=128, vocab_size=503,
    dtype="float32", param_dtype="float32",
)
