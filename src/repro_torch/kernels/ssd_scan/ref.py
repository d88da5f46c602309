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

``ssd_scan_bwd_passes_ref`` is the gradient of the same function, in
the passes of the backward kernels (``csrc/ssd_scan_bwd.cu``): the
entering states recomputed, a reverse pass over the chunks for the
states' gradients, and a pass per chunk for the inputs' gradients.  Only
the tests run it.

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


def ssd_scan_bwd_passes_ref(x: torch.Tensor, b: torch.Tensor,
                            c: torch.Tensor, dt: torch.Tensor,
                            da: torch.Tensor, dy: torch.Tensor,
                            dh: Optional[torch.Tensor] = None,
                            group: Optional[int] = None
                            ) -> Tuple[torch.Tensor, ...]:
    """The gradient of :func:`ssd_scan_chunked_ref` given dy (x's shape)
    and the final state's gradient dh ((B, nh, ns, hd) or None), in the
    passes of ``csrc/ssd_scan_bwd.cu``: (dx, db, dc) in the inputs' dtypes
    and (ddt, dda) in f32 -- in f64 throughout when x is f64.  Per chunk,
    with H_c the state entering it and D_c the gradient of the state
    leaving it:

      a  cs, tot and S_c as pass A of :func:`ssd_scan_passes_ref`, and
         R_c = sum_q exp(cs_q) c_q (outer) dy_q;
         H_0 = 0, H_{c+1} = exp(tot_c) H_c + S_c
      b  D_{nc-1} = dh, D_{c-1} = exp(tot_c) D_c + R_c
      c  with W = (c b^T) exp(cs_q - cs_p) dt_p on p <= q and
         dW = dy x^T there, u_p = b_p . D_c, s_p = dt_p exp(tot - cs_p)
         u_p . x_p:
           dx_p  = sum_q W_qp dy_q + dt_p exp(tot - cs_p) u_p
           ddt_p = sum_q dW_qp (c_q . b_p) exp(cs_q - cs_p)
                   + exp(tot - cs_p) u_p . x_p
           dcs_q = exp(cs_q) (c_q . H_c) . dy_q + sum_p dW_qp W_qp
                   - sum_q' dW_q'q W_q'q - s_q,
           dcs_{Q-1} += exp(tot) <D_c, H_c> + sum_q s_q,
           dda = the reverse cumulative sum of dcs over the chunk
         and, summed over the heads, with M = sum_h dW exp(cs_q - cs_p)
         dt_p on p <= q:
           dc_q = sum_p M_qp b_p + sum_h exp(cs_q) H_c dy_q
           db_p = sum_q M_qp c_q + sum_h dt_p exp(tot - cs_p) D_c x_p

    The decay is selected on p <= q before its exponential, so a decay
    that overflows above the diagonal gives a gradient of 0 there.
    ``group``, if given, runs (a)-(c) over groups of at most that many
    chunks, the last group first, as the kernel's wrapper bounds its
    scratch: a first walk over the groups keeps the state entering each,
    and D crosses a group boundary as it crosses a chunk boundary."""
    B, nc, Q, nh, hd = x.shape
    ns = b.shape[-1]
    acc = torch.float64 if x.dtype == torch.float64 else torch.float32
    G = nc if group is None else group
    if G < 1:
        raise ValueError(f"group must be >= 1, got {group}")
    groups = [slice(c0, c0 + G) for c0 in range(0, nc, G)]
    h = torch.zeros((B, nh, ns, hd), dtype=acc, device=x.device)
    starts = []
    for g in groups:
        starts.append(h)
        _, tot, S = _bwd_states(x[:, g], b[:, g], dt[:, g], da[:, g], acc)
        for ci in range(S.shape[1]):
            h = torch.exp(tot[:, ci])[..., None] * h + S[:, ci]
    d = torch.zeros_like(h) if dh is None else dh.to(acc)
    parts = []
    for g, h0 in reversed(list(zip(groups, starts))):
        out, d = _bwd_group(x[:, g], b[:, g], c[:, g], dt[:, g], da[:, g],
                            dy[:, g], h0, d, acc)
        parts.append(out)
    dx, db, dc, ddt, dda = (torch.cat(t[::-1], dim=1)
                            for t in zip(*parts))
    return (dx.to(x.dtype), db.to(b.dtype), dc.to(c.dtype),
            ddt.to(torch.float32) if acc == torch.float32 else ddt,
            dda.to(torch.float32) if acc == torch.float32 else dda)


def _bwd_states(x, b, dt, da, acc):
    """cs (B, nc, nh, Q), tot (B, nc, nh, 1) and each chunk's own state
    contribution S_c (B, nc, nh, ns, hd)."""
    xf = x.to(acc).permute(0, 1, 3, 2, 4)                 # (B, nc, nh, Q, hd)
    dtf = dt.to(acc).permute(0, 1, 3, 2)                 # (B, nc, nh, Q)
    cs = torch.cumsum(da.to(acc), dim=2).permute(0, 1, 3, 2)
    tot = cs[..., -1:]
    xs = (dtf * torch.exp(tot - cs))[..., None] * xf
    return cs, tot, torch.einsum("bcqs,bchqd->bchsd", b.to(acc), xs)


def _bwd_group(x, b, c, dt, da, dy, h0, d, acc):
    """Passes (a)-(c) of :func:`ssd_scan_bwd_passes_ref` over the chunks
    given, entered with the state h0, left with the state's gradient d:
    ((dx, db, dc, ddt, dda), the gradient of the state entering them)."""
    B, nc, Q, nh, hd = x.shape
    cs, tot, S = _bwd_states(x, b, dt, da, acc)
    xf = x.to(acc).permute(0, 1, 3, 2, 4)
    dyf = dy.to(acc).permute(0, 1, 3, 2, 4)
    bf, cf = b.to(acc), c.to(acc)
    dtf = dt.to(acc).permute(0, 1, 3, 2)
    etot = torch.exp(tot)                                # (B, nc, nh, 1)
    R = torch.einsum("bcqs,bchqd->bchsd", cf, torch.exp(cs)[..., None] * dyf)
    # a, b: the states entering each chunk, the gradients leaving each
    H, D = [], [None] * nc
    for ci in range(nc):
        H.append(h0)
        h0 = etot[:, ci][..., None] * h0 + S[:, ci]
    for ci in reversed(range(nc)):
        D[ci] = d
        d = etot[:, ci][..., None] * d + R[:, ci]
    H, D = torch.stack(H, dim=1), torch.stack(D, dim=1)
    # c: the chunk
    causal = torch.tril(torch.ones((Q, Q), dtype=torch.bool,
                                   device=x.device))
    scores = (cf @ bf.transpose(2, 3))[:, :, None]       # (B, nc, 1, Q, Q)
    dec = torch.exp(torch.where(causal, cs[..., :, None] - cs[..., None, :],
                                float("-inf")))
    dW = torch.where(causal, dyf @ xf.transpose(3, 4), 0.0)
    W = torch.where(causal, scores * dec * dtf[..., None, :], 0.0)
    Gp = torch.where(causal, dW * scores * dec, 0.0)
    M = torch.where(causal, dW * dec * dtf[..., None, :], 0.0).sum(2)
    u = torch.einsum("bcqs,bchsd->bchqd", bf, D)
    sdec = torch.exp(tot - cs)                           # (B, nc, nh, Q)
    ux = (u * xf).sum(-1)
    s = dtf * sdec * ux
    dx = W.transpose(3, 4) @ dyf + (dtf * sdec)[..., None] * u
    ddt = Gp.sum(3) + sdec * ux
    v = torch.einsum("bcqs,bchsd->bchqd", cf, H)
    dcs = torch.exp(cs) * (v * dyf).sum(-1) + (Gp * dtf[..., None, :]).sum(4) \
        - dtf * Gp.sum(3) - s
    dcs[..., -1] += etot[..., 0] * (D * H).sum((-2, -1)) + s.sum(-1)
    dda = torch.flip(torch.cumsum(torch.flip(dcs, [-1]), -1), [-1])
    dc = M @ bf + torch.einsum("bchqd,bchsd->bcqs",
                               torch.exp(cs)[..., None] * dyf, H)
    db = M.transpose(2, 3) @ cf + torch.einsum(
        "bchqd,bchsd->bcqs", (dtf * sdec)[..., None] * xf, D)
    return (dx.permute(0, 1, 3, 2, 4), db, dc, ddt.permute(0, 1, 3, 2),
            dda.permute(0, 1, 3, 2)), d


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
