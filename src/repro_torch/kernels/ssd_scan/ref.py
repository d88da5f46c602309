"""Plain PyTorch versions of the SSD chunk-scan kernel.

``ssd_scan_chunked_ref`` is the kernel's function in its chunked form,
the arithmetic of the JAX package's ``_ssd_kernel``
(``kernels/ssd_scan/ssd_scan.py:25-60``) and of its model's
``chunk_step`` loop (``models/ssm.py:110-137``) for every (batch, head) at
once, and also returns the state after the last chunk.  The wrapper in
``ops.py`` runs it for tensors on the CPU, the models'
``ssm_impl="torch"`` path runs it on any device, and ``chip_smoke.py``
holds the CUDA kernel against it on the card.

``ssd_scan_passes_ref`` is the same function regrouped as the bf16 CUDA
kernels compute it, in three passes over all chunks at once: the chunk
states, the state passing, the chunk outputs.  It lets the CPU tests prove
the regrouping, also over groups of chunks with the state carried between
them (``group``, as the wrapper bounds its scratch), and emulate the
kernels' bf16 operands (``operand``).

``ssd_scan_token_ref`` is the token-by-token recurrence, a port of the JAX
package's oracle ``ssd_scan_ref`` (``kernels/ssd_scan/ref.py:10``).
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch


def ssd_scan_chunked_ref(x: torch.Tensor, b: torch.Tensor, c: torch.Tensor,
                         dt: torch.Tensor, da: torch.Tensor
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (B, nc, Q, nh, hd); b, c (B, nc, Q, ns); dt, da (B, nc, Q, nh) ->
    (y with x's shape and dtype, the f32 state (B, nh, ns, hd) after the
    last chunk).  Per chunk, with cs the cumulative sum of da:

      y[q] = exp(cs_q) c_q . h
             + sum_{p <= q} (c_q . b_p) exp(cs_q - cs_p) dt_p x_p
      h'   = exp(cs_Q) h  +  sum_q b_q (outer) dt_q exp(cs_Q - cs_q) x_q

    all in f32, or in f64 when x is f64 (a yardstick for the f32 versions
    where strong decays make them ill-conditioned).  The decay above the
    diagonal (q < p) would overflow to inf: its exponent is masked to -inf
    first, so the decay there is 0 and so is its gradient (an inf selected
    away after the exponential would make the backward 0 * inf = NaN), and
    the weights there are selected away, never multiplied by 0."""
    B, nc, Q, nh, hd = x.shape
    ns = b.shape[-1]
    dev = x.device
    acc = torch.float64 if x.dtype == torch.float64 else torch.float32
    h = torch.zeros((B, nh, ns, hd), dtype=acc, device=dev)
    y = torch.empty(x.shape, dtype=x.dtype, device=dev)
    causal = torch.tril(torch.ones((Q, Q), dtype=torch.bool, device=dev))
    for ci in range(nc):
        xb = x[:, ci].to(acc).permute(0, 2, 1, 3)        # (B, nh, Q, hd)
        bb = b[:, ci].to(acc)                            # (B, Q, ns)
        cb = c[:, ci].to(acc)                            # (B, Q, ns)
        dtb = dt[:, ci].to(acc).transpose(1, 2)          # (B, nh, Q)
        cs = torch.cumsum(da[:, ci].to(acc), dim=1).transpose(1, 2)
        tot = cs[..., -1:]                               # (B, nh, 1)
        y_inter = torch.exp(cs)[..., None] * torch.einsum(
            "bqs,bhsd->bhqd", cb, h)
        scores = (cb @ bb.transpose(1, 2))[:, None]      # (B, 1, Q, Q)
        ldecay = torch.exp(torch.where(
            causal, cs[..., :, None] - cs[..., None, :], float("-inf")))
        w = torch.where(causal, scores * ldecay * dtb[..., None, :], 0.0)
        y_intra = w @ xb                                 # (B, nh, Q, hd)
        y[:, ci] = (y_inter + y_intra).permute(0, 2, 1, 3).to(x.dtype)
        sdecay = (dtb * torch.exp(tot - cs))[..., None] * xb
        h = torch.exp(tot)[..., None] * h + torch.einsum(
            "bqs,bhqd->bhsd", bb, sdecay)
    return y, h


def ssd_scan_passes_ref(x: torch.Tensor, b: torch.Tensor, c: torch.Tensor,
                        dt: torch.Tensor, da: torch.Tensor,
                        operand: Optional[Callable] = None,
                        group: Optional[int] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The chunked SSD in the three passes of ``csrc/ssd_scan.cu``, in f32;
    same arguments and results as :func:`ssd_scan_chunked_ref`.

      A  per chunk: cs = cumsum(da), tot = cs[Q-1],
         S_c = sum_q b_q (outer) dt_q exp(tot - cs_q) x_q
      B  h_0 = 0, h_{c+1} = exp(tot_c) h_c + S_c  (h_nc is the final state)
      C  y[q] = exp(cs_q) c_q . h_c
                + sum_{p <= q} (c_q . b_p) exp(cs_q - cs_p) dt_p x_p

    ``group``, if given, runs the three passes over groups of at most that
    many chunks, one group after another, as the wrapper does when its
    scratch budget cuts the chunks: pass B of a group starts from the f32
    state the previous group's pass B ended with.

    ``operand``, if given, is applied to the three f32 operands the kernels
    take into the tensor cores -- the decay-scaled x of A, the entering
    states h_c and the weights W of C -- before their products (the tests
    pass bf16 rounding)."""
    op = operand if operand is not None else (lambda t: t)
    B, nc, Q, nh, hd = x.shape
    G = nc if group is None else group
    if G < 1:
        raise ValueError(f"group must be >= 1, got {group}")
    h = torch.zeros((B, nh, b.shape[-1], hd), dtype=torch.float32,
                    device=x.device)
    ys = []
    for c0 in range(0, nc, G):
        g = slice(c0, c0 + G)
        y, h = _passes(x[:, g], b[:, g], c[:, g], dt[:, g], da[:, g], h, op)
        ys.append(y)
    return torch.cat(ys, dim=1), h


def _passes(x, b, c, dt, da, h, op):
    """Passes A, B and C of :func:`ssd_scan_passes_ref` over the chunks
    given, pass B starting from the state ``h``."""
    B, nc, Q, nh, hd = x.shape
    xf = x.float().permute(0, 1, 3, 2, 4)                 # (B, nc, nh, Q, hd)
    bf, cf = b.float(), c.float()                        # (B, nc, Q, ns)
    dtf = dt.float().permute(0, 1, 3, 2)                 # (B, nc, nh, Q)
    cs = torch.cumsum(da.float(), dim=2).permute(0, 1, 3, 2)
    tot = cs[..., -1:]                                   # (B, nc, nh, 1)
    # A: each chunk's own contribution to the state
    xs = (dtf * torch.exp(tot - cs))[..., None] * xf
    S = torch.einsum("bcqs,bchqd->bchsd", bf, op(xs))    # (B, nc, nh, ns, hd)
    # B: the state entering each chunk
    entering = []
    for ci in range(nc):
        entering.append(h)
        h = torch.exp(tot[:, ci])[..., None] * h + S[:, ci]
    H = torch.stack(entering, dim=1)
    # C: the chunk outputs
    y_inter = torch.exp(cs)[..., None] * torch.einsum(
        "bcqs,bchsd->bchqd", cf, op(H))
    causal = torch.tril(torch.ones((Q, Q), dtype=torch.bool,
                                   device=x.device))
    scores = (cf @ bf.transpose(2, 3))[:, :, None]       # (B, nc, 1, Q, Q)
    ldecay = torch.exp(torch.where(
        causal, cs[..., :, None] - cs[..., None, :], float("-inf")))
    w = torch.where(causal, scores * ldecay * dtf[..., None, :], 0.0)
    y = y_inter + op(w) @ xf
    return y.permute(0, 1, 3, 2, 4).to(x.dtype), h


def ssd_scan_token_ref(x: torch.Tensor, b: torch.Tensor, c: torch.Tensor,
                       dt: torch.Tensor, da: torch.Tensor) -> torch.Tensor:
    """Token-by-token SSD recurrence (the definitional form):

       h_t = exp(da_t) h_{t-1} + dt_t * b_t (outer) x_t
       y_t = c_t . h_t

    x (B, nc, Q, nh, hd); b, c (B, nc, Q, ns); dt, da (B, nc, Q, nh).
    """
    B, nc, Q, nh, hd = x.shape
    ns = b.shape[-1]
    T = nc * Q
    xf = x.reshape(B, T, nh, hd).float()
    bf = b.reshape(B, T, ns).float()
    cf = c.reshape(B, T, ns).float()
    dtf = dt.reshape(B, T, nh).float()
    daf = da.reshape(B, T, nh).float()
    h = torch.zeros((B, nh, ns, hd), dtype=torch.float32, device=x.device)
    ys = []
    for t in range(T):
        h = torch.exp(daf[:, t])[..., None, None] * h + torch.einsum(
            "bs,bh,bhd->bhsd", bf[:, t], dtf[:, t], xf[:, t])
        ys.append(torch.einsum("bs,bhsd->bhd", cf[:, t], h))
    return torch.stack(ys, dim=1).reshape(x.shape).to(x.dtype)
