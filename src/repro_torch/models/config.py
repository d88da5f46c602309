"""Model configuration.

One ``ModelConfig`` covers every assigned architecture family:

  dense   GQA transformer (chatglm3, stablelm, qwen3, qwen1.5)
  moe     fine-grained MoE with shared experts (deepseek-moe, deepseek-v2-lite)
  mla     multi-head latent attention (deepseek-v2-lite)
  ssm     Mamba-2 / SSD, attention-free (mamba2-370m)
  hybrid  parallel attention+SSM heads with sliding-window attn (hymba)
  encdec  encoder-decoder backbone (seamless-m4t; audio frontend stubbed)
  vlm     decoder backbone consuming precomputed patch embeddings (llava-next)

The config records the *published* numbers; derived fields (padded vocab,
head dims, expert dims) are computed here so configs/<arch>.py stay literal.

This is the JAX package's ``ModelConfig`` field for field, except for
the port's two path selectors: ``attn_impl`` names the two attention
paths, ``"cuda"`` (the hand-written flash-attention kernel, the default)
and ``"torch"`` (the chunked online-softmax attention in plain PyTorch);
``ssm_impl``, a field of the port alone, names the two SSD chunk-scan
paths, ``"cuda"`` (the hand-written chunk-scan kernel, the default) and
``"torch"`` (the kernel's plain version, which computes the JAX
package's ``chunk_step`` loop in plain PyTorch).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional, Tuple


def pad_to(n: int, m: int) -> int:
    return ((n + m - 1) // m) * m


@dataclass(frozen=True)
class ModelConfig:
    name: str = "model"
    family: str = "dense"          # dense | moe | ssm | hybrid | encdec | vlm

    # -- core transformer dims ------------------------------------------------
    n_layers: int = 4
    d_model: int = 256
    n_heads: int = 4
    n_kv_heads: int = 4
    d_ff: int = 1024
    vocab_size: int = 1024
    head_dim: Optional[int] = None          # default d_model // n_heads
    max_seq_len: int = 532480               # rope table upper bound (>=512k+pad)

    # attention flavor
    qk_norm: bool = False                   # qwen3
    qkv_bias: bool = False                  # qwen1.5
    rope_theta: float = 10000.0
    rope_fraction: float = 1.0              # chatglm 2d-RoPE: 0.5; stablelm: 0.25
    sliding_window: int = 0                 # 0 = full attention; >0 = SWA width
    causal: bool = True
    norm: str = "rms"                       # rms | layer (stablelm, seamless)

    # mlp flavor
    mlp_gated: bool = True                  # SwiGLU (all assigned LMs)

    # -- MoE ------------------------------------------------------------------
    n_shared_experts: int = 0
    n_routed_experts: int = 0
    moe_top_k: int = 0
    d_ff_expert: int = 0
    first_k_dense: int = 0                  # deepseek: first k layers are dense
    moe_capacity_factor: float = 1.25
    router_aux_coef: float = 0.001
    first_dense_ff: int = 0                 # dense FFN width of first-k layers

    # -- MLA (deepseek-v2) ----------------------------------------------------
    mla: bool = False
    kv_lora_rank: int = 0                   # 512 for v2-lite
    qk_nope_dim: int = 128
    qk_rope_dim: int = 64
    v_head_dim: int = 128

    # -- SSM (mamba2 / SSD) ---------------------------------------------------
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_chunk: int = 256
    conv_width: int = 4

    # -- hybrid (hymba): parallel attn + ssm heads in one block ---------------
    hybrid: bool = False

    # -- encoder-decoder (seamless) -------------------------------------------
    n_encoder_layers: int = 0               # 0 = decoder-only
    frontend: str = "none"                  # none | audio | vision (stubbed)
    n_patches: int = 0                      # vlm: patch embeddings per sample

    # -- numerics / runtime ---------------------------------------------------
    dtype: str = "bfloat16"                 # activation/param compute dtype
    param_dtype: str = "bfloat16"
    norm_eps: float = 1e-5
    remat: str = "block"                    # none | block  (scan remat policy)
    loss_chunk: int = 1024                  # CE over seq chunks (0 = off)
    unroll_scans: bool = False              # unroll all lax.scans (roofline
                                            # cost-exact small-L compiles)
    attn_q_chunk: int = 512                 # flash attention block sizes
    attn_kv_chunk: int = 1024
    decode_kv_chunk: int = 2048
    attn_impl: str = "cuda"                 # cuda | torch
    ssm_impl: str = "cuda"                  # cuda | torch (the port's own)
    logical_batch_axes: Tuple[str, ...] = ("pod", "data")
    tp_axis: str = "model"

    # ------------------------------------------------------------------------

    @property
    def hd(self) -> int:
        if self.head_dim is not None:
            return self.head_dim
        return self.d_model // self.n_heads if self.n_heads else 0

    @property
    def padded_vocab(self) -> int:
        """Vocab padded to 256 for clean TP sharding (production practice;
        padded logits are masked in the loss)."""
        return pad_to(self.vocab_size, 256)

    @property
    def is_moe(self) -> bool:
        return self.n_routed_experts > 0

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    @property
    def kv_groups(self) -> int:
        return self.n_heads // self.n_kv_heads

    @property
    def attn_kind(self) -> str:
        if self.family == "ssm":
            return "none"
        if self.mla:
            return "mla"
        return "gqa"

    @property
    def decode_cache_kind(self) -> str:
        if self.family == "ssm":
            return "ssm"
        if self.hybrid:
            return "hybrid"
        if self.mla:
            return "mla"
        return "kv"

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    # param count (for MODEL_FLOPS = 6 N D roofline term) ---------------------

    def param_counts(self) -> dict:
        """Analytic parameter counts: total and active-per-token."""
        d, hd = self.d_model, self.hd
        nl = self.n_layers
        emb = self.padded_vocab * d
        if self.family == "ssm":
            di, ns, nh = self.d_inner, self.ssm_state, self.ssm_heads
            # in_proj: d -> 2*di + 2*ns + nh ; out_proj: di -> d
            per_layer = d * (2 * di + 2 * ns + nh) + di * d \
                + self.conv_width * (di + 2 * ns) + 2 * nh + di
            tot = emb * 2 + nl * per_layer
            return {"total": tot, "active": tot, "embedding": emb}

        def attn_params() -> int:
            if self.mla:
                q = d * (self.n_heads * (self.qk_nope_dim + self.qk_rope_dim))
                kv = d * (self.kv_lora_rank + self.qk_rope_dim)
                up = self.kv_lora_rank * self.n_heads * (
                    self.qk_nope_dim + self.v_head_dim)
                o = self.n_heads * self.v_head_dim * d
                return q + kv + up + o
            qkv = d * hd * (self.n_heads + 2 * self.n_kv_heads)
            return qkv + self.n_heads * hd * d

        def mlp_params(dff: int) -> int:
            return d * dff * (3 if self.mlp_gated else 2)

        a = attn_params()
        dense_mlp = mlp_params(self.d_ff)
        if self.is_moe:
            shared = mlp_params(self.d_ff_expert * self.n_shared_experts)
            routed_all = self.n_routed_experts * mlp_params(self.d_ff_expert)
            routed_act = self.moe_top_k * mlp_params(self.d_ff_expert)
            router = d * self.n_routed_experts
            n_moe = nl - self.first_k_dense
            tot = nl * a + self.first_k_dense * dense_mlp \
                + n_moe * (shared + routed_all + router)
            act = nl * a + self.first_k_dense * dense_mlp \
                + n_moe * (shared + routed_act + router)
        elif self.hybrid:
            di, ns, nh = self.d_inner, self.ssm_state, self.ssm_heads
            ssm = d * (2 * di + 2 * ns + nh) + di * d \
                + self.conv_width * (di + 2 * ns) + 2 * nh + di
            tot = act = nl * (a + dense_mlp + ssm)
        else:
            tot = act = nl * (a + dense_mlp)
        enc = 0
        if self.n_encoder_layers:
            # encoder self-attn + mlp; decoder adds cross-attn
            enc = self.n_encoder_layers * (a + dense_mlp)
            tot += enc + nl * a  # cross-attention blocks
            act += enc + nl * a
        tot += emb * 2  # tied-off embed + lm head (counted separately)
        act += emb * 2
        return {"total": tot, "active": act, "embedding": emb}
