"""The port's attention and RMSNorm against the JAX package, on the CPU.

On CPU tensors the flash-attention and RMSNorm wrappers run their plain
PyTorch versions; these are held against the Pallas kernels in interpret
mode and the JAX oracles (``attention_ref``, ``rmsnorm_ref``,
``rms_norm_head``), and the port's chunked ``"torch"`` path and decode
attention against ``flash_attention_xla`` and ``decode_attention``.
Inputs are made with numpy from seeds; bf16 inputs are rounded once by
JAX and carried to torch bit for bit.  Tolerances are those of
``tests/test_kernels.py``: f32 2e-5, bf16 2e-2 (atol and rtol).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.ops import flash_attention as fa_pallas
from repro.kernels.flash_attention.ref import attention_ref
from repro.kernels.rmsnorm.ops import rmsnorm as rmsnorm_pallas
from repro.kernels.rmsnorm.ref import rmsnorm_ref as rmsnorm_jax_ref
from repro.models import layers as JL
from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.flash_attention.ref import attention_mask
from repro_torch.kernels.rmsnorm import rmsnorm
from repro_torch.models import layers as TL
from repro_torch.models.convert import tensor_from_numpy

TOL = {"float32": 2e-5, "bfloat16": 2e-2}
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}

# (B, S, H, KVH, D): the sweep of tests/test_kernels.py, then prime S, an S
# that is not a multiple of the kernel's 64-row q tile, GQA group 8, D 128
SHAPES = [(1, 32, 2, 2, 16), (2, 64, 4, 2, 32), (1, 128, 8, 1, 64),
          (2, 96, 6, 3, 32)]
ODD_SHAPES = [(1, 37, 8, 1, 16), (2, 131, 4, 2, 32), (1, 100, 2, 2, 64),
              (1, 65, 16, 2, 128)]
MASKS = [(True, 0), (False, 0), (True, 24)]

_attention_ref = jax.jit(attention_ref, static_argnames=("causal", "window"))
_xla = jax.jit(JL.flash_attention_xla,
               static_argnames=("causal", "window", "q_chunk", "kv_chunk"))
_decode = jax.jit(JL.decode_attention, static_argnames=("kv_chunk",))


def _pair(shape, dtype, seed):
    """The same values as a jax array and a torch tensor."""
    x = np.random.RandomState(seed).randn(*shape).astype(np.float32)
    j = jnp.asarray(x, JDT[dtype])
    return j, tensor_from_numpy(np.asarray(j), "cpu")


def _close(got: torch.Tensor, want, dtype):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               atol=TOL[dtype], rtol=TOL[dtype])


def _qkv(B, S, H, KVH, D, dtype, seed):
    return (_pair((B, S, H, D), dtype, seed),
            _pair((B, S, KVH, D), dtype, seed + 1),
            _pair((B, S, KVH, D), dtype, seed + 2))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal,window", MASKS)
@pytest.mark.parametrize("B,S,H,KVH,D", SHAPES + ODD_SHAPES)
def test_flash_attention_plain_matches_pallas(B, S, H, KVH, D, causal,
                                              window, dtype):
    (jq, tq), (jk, tk), (jv, tv) = _qkv(B, S, H, KVH, D, dtype, S + D)
    got = flash_attention(tq, tk, tv, causal=causal, window=window)
    assert got.dtype == tq.dtype and got.shape == tq.shape
    if (B, S, H, KVH, D) in SHAPES:
        want = fa_pallas(jq, jk, jv, causal=causal, window=window,
                         q_block=32, kv_block=32, interpret=True)
        _close(got, want, dtype)
    # the odd lengths against the oracle only: the Pallas divisor search
    # falls to one row per grid step at a prime S
    ref = _attention_ref(jnp.swapaxes(jq, 1, 2), jnp.swapaxes(jk, 1, 2),
                         jnp.swapaxes(jv, 1, 2), causal=causal,
                         window=window)
    _close(got, jnp.swapaxes(ref, 1, 2), dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal,window", MASKS)
@pytest.mark.parametrize("B,S,H,KVH,D,q_chunk,kv_chunk", [
    s + (16, 32) for s in SHAPES] + [s + (512, 1024) for s in ODD_SHAPES])
def test_chunked_torch_path_matches_xla(B, S, H, KVH, D, q_chunk, kv_chunk,
                                        causal, window, dtype):
    (jq, tq), (jk, tk), (jv, tv) = _qkv(B, S, H, KVH, D, dtype, S + H)
    got = TL.flash_attention_torch(tq, tk, tv, causal=causal, window=window,
                                   q_chunk=q_chunk, kv_chunk=kv_chunk)
    want = _xla(jq, jk, jv, causal=causal, window=window, q_chunk=q_chunk,
                kv_chunk=kv_chunk)
    _close(got, want, dtype)


def _p_in_bf16(q, k, v, causal, window):
    """Attention with p = exp(s - max) rounded to bf16 before p @ v and the
    denominator summed from the unrounded p: the rounding points of the
    CUDA kernel's bf16 path (emulated in f32 on the CPU)."""
    B, Sq, H, D = q.shape
    Skv, KVH = k.shape[1], k.shape[2]
    G = H // KVH
    s = torch.einsum("bqhgd,bkhd->bhgqk", q.float().reshape(B, Sq, KVH, G, D),
                     k.float()) / np.sqrt(D)
    s = s.masked_fill(~attention_mask(Sq, Skv, causal, window, "cpu"),
                      float("-inf"))
    p = torch.exp(s - s.amax(-1, keepdim=True))
    out = torch.einsum("bhgqk,bkhd->bqhgd", p.to(torch.bfloat16).float(),
                       v.float()) / p.sum(-1)[..., None].permute(0, 3, 1, 2, 4)
    return out.reshape(B, Sq, H, D).to(q.dtype)


@pytest.mark.parametrize("causal,window", MASKS)
def test_p_rounded_to_bf16_stays_within_the_bf16_tolerance(causal, window):
    """The bf16 kernel rounds p to bf16 before P V, as the JAX XLA path
    does (Pallas keeps p in f32): at qwen3's head dim, GQA 8 and S 300 that
    stays within bf16 2e-2 of the JAX oracle and of the XLA path."""
    (jq, tq), (jk, tk), (jv, tv) = _qkv(1, 300, 8, 1, 128, "bfloat16", 11)
    got = _p_in_bf16(tq, tk, tv, causal, window)
    ref = jnp.swapaxes(_attention_ref(
        jnp.swapaxes(jq, 1, 2), jnp.swapaxes(jk, 1, 2),
        jnp.swapaxes(jv, 1, 2), causal=causal, window=window), 1, 2)
    assert bool((got.float().numpy()
                 != np.asarray(ref, np.float32)).any())   # it does round
    _close(got, ref, "bfloat16")
    _close(got, _xla(jq, jk, jv, causal=causal, window=window), "bfloat16")


def test_fully_masked_rows_are_zero():
    """Non-causal window over a short kv: late queries see no key."""
    (_, tq), (_, tk), (_, tv) = _qkv(1, 37, 2, 1, 16, "float32", 3)
    got = flash_attention(tq, tk[:, :5], tv[:, :5], causal=False, window=4)
    assert torch.count_nonzero(got[:, 8:]) == 0
    assert torch.count_nonzero(got[:, :8]) > 0


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("S,cur,kv_chunk", [(64, 37, 16), (131, 131, 2048),
                                            (48, 1, 16)])
@pytest.mark.parametrize("H,KVH", [(8, 1), (4, 4)])
def test_decode_attention_matches_jax(S, cur, kv_chunk, H, KVH, dtype):
    (jq, tq) = _pair((2, 1, H, 32), dtype, S)
    (jk, tk) = _pair((2, S, KVH, 32), dtype, S + 1)
    (jv, tv) = _pair((2, S, KVH, 32), dtype, S + 2)
    got = TL.decode_attention(tq, tk, tv, cur, kv_chunk=kv_chunk)
    want = _decode(jq, jk, jv, jnp.int32(cur), kv_chunk=kv_chunk)
    _close(got, want, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(8, 64), (3, 5, 128), (1, 256), (37, 128),
                                   (131, 16), (2, 7, 8, 128)])
def test_rmsnorm_plain_matches_pallas(shape, dtype):
    jx, tx = _pair(shape, dtype, shape[0] * 7)
    w = np.random.RandomState(1).rand(shape[-1]).astype(np.float32)
    got = rmsnorm(tx, torch.from_numpy(w), eps=1e-5)
    assert got.dtype == tx.dtype and got.shape == tx.shape
    rows = int(np.prod(shape[:-1]))
    want = rmsnorm_pallas(jx, jnp.asarray(w), eps=1e-5,
                          block_rows=4 if rows % 4 == 0 else rows,
                          interpret=True)
    _close(got, want, dtype)
    _close(got, rmsnorm_jax_ref(jx, jnp.asarray(w)), dtype)
    _close(TL.rms_norm_head(tx, torch.from_numpy(w), 1e-6),
           JL.rms_norm_head(jx, jnp.asarray(w), 1e-6), dtype)


def test_plain_versions_count_no_launches():
    _build.reset_launches()
    (_, tq), (_, tk), (_, tv) = _qkv(1, 16, 2, 1, 8, "float32", 0)
    flash_attention(tq, tk, tv)
    rmsnorm(tq, torch.ones(8))
    assert _build.launch_counts() == {}


def _attn_inputs(**over):
    base = dict(q=torch.zeros(1, 4, 2, 16), k=torch.zeros(1, 4, 1, 16),
                v=torch.zeros(1, 4, 1, 16))
    base.update(over)
    return base


@pytest.mark.parametrize("over,err", [
    ({"q": torch.zeros(1, 4, 2, 16, dtype=torch.float16)}, TypeError),
    ({"k": torch.zeros(1, 4, 1, 16, dtype=torch.bfloat16)}, TypeError),
    ({"k": torch.zeros(1, 4, 3, 16), "v": torch.zeros(1, 4, 3, 16)},
     ValueError),                                          # H % KVH
    ({"q": torch.zeros(1, 4, 2, 24), "k": torch.zeros(1, 4, 1, 24),
      "v": torch.zeros(1, 4, 1, 24)}, ValueError),          # head dim
    ({"q": torch.zeros(1, 4, 16, 2).transpose(2, 3)}, ValueError),
    ({"v": torch.zeros(1, 5, 1, 16)}, ValueError),
    ({"q": torch.zeros(4, 2, 16)}, ValueError),
])
def test_flash_attention_rejects_bad_inputs(over, err):
    a = _attn_inputs(**over)
    with pytest.raises(err):
        flash_attention(a["q"], a["k"], a["v"])
    with pytest.raises(ValueError):
        flash_attention(*_attn_inputs().values(), window=-1)


@pytest.mark.parametrize("x,w,err", [
    (torch.zeros(4, 8, dtype=torch.float16), torch.ones(8), TypeError),
    (torch.zeros(4, 8), torch.ones(8, dtype=torch.bfloat16), TypeError),
    (torch.zeros(4, 8), torch.ones(7), ValueError),
    (torch.zeros(8, 4).t(), torch.ones(8), ValueError),
])
def test_rmsnorm_rejects_bad_inputs(x, w, err):
    with pytest.raises(err):
        rmsnorm(x, w)
