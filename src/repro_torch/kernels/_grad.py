"""Gradients through the model kernels: forward on the kernel, backward by
recomputing the plain version.

The JAX package's Pallas kernels have no backward (it trains through
XLA).  Flash attention and RMSNorm keep this plain backward; the SSD chunk
scan has a backward kernel of its own (``ssd_scan/ops.py``,
``ssd_scan_with_grad``), whose CPU route is :func:`plain_backward`.
:func:`apply` runs a kernel's
wrapper in the forward pass -- the hand kernel for CUDA tensors, the plain
version for CPU tensors -- and saves the inputs; the backward pass
recomputes the plain version (``ref.py`` beside the wrapper) from the saved
inputs under ``torch.enable_grad()`` and returns its gradients.  So the
gradients are the plain version's, bit for bit, on either device, and the
CPU tests exercise the same autograd route as the card.

A wrapper writes its output into a tensor from ``torch.empty`` through
``ctypes``, so a direct call on the card returns a tensor without a
``grad_fn``: gradients would stop there.  The model's call sites therefore
call flash attention and RMSNorm through :func:`apply`, which goes
through the Function only when a gradient is needed and calls the wrapper
directly otherwise (serving saves nothing).
"""

from __future__ import annotations

from typing import Callable, Dict, Tuple, Union

import torch


class _KernelWithPlainBackward(torch.autograd.Function):
    """``kernel(*inputs, **kwargs)`` forward; the gradient of
    ``plain(*inputs, **kwargs)`` backward.  Outputs are one tensor or a
    tuple of tensors; an output whose upstream gradient is None (unused,
    as the SSD scan's final state in training) is left out of the
    backward."""

    @staticmethod
    def forward(ctx, kernel: Callable, plain: Callable, kwargs: Dict,
                *inputs: torch.Tensor):
        ctx.plain, ctx.kwargs = plain, kwargs
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(*inputs)
        return kernel(*inputs, **kwargs)     # autograd is off in forward

    @staticmethod
    def backward(ctx, *grads):
        return (None, None, None,
                *plain_backward(ctx.plain, ctx.kwargs, ctx.saved_tensors,
                                ctx.needs_input_grad[3:], grads))


def plain_backward(plain: Callable, kwargs: Dict, saved, wanted, grads
                   ) -> Tuple:
    """The gradients of ``plain(*saved, **kwargs)`` with respect to the
    ``wanted`` inputs (None for the others), given its outputs' upstream
    gradients ``grads`` (None for an unused output): ``plain`` recomputed
    from the saved inputs under ``torch.enable_grad()``."""
    inputs = [t.detach().requires_grad_(w) for t, w in zip(saved, wanted)]
    with torch.enable_grad():
        out = plain(*inputs, **kwargs)
    outs = out if isinstance(out, tuple) else (out,)
    pairs = [(o, g) for o, g in zip(outs, grads) if g is not None]
    wrt = [t for t in inputs if t.requires_grad]
    if not pairs or not wrt:
        return (None,) * len(inputs)
    got = iter(torch.autograd.grad([o for o, _ in pairs], wrt,
                                   [g for _, g in pairs], allow_unused=True))
    return tuple(next(got) if t.requires_grad else None for t in inputs)


def apply(kernel: Callable, plain: Callable, *inputs: torch.Tensor,
          **kwargs) -> Union[torch.Tensor, Tuple[torch.Tensor, ...]]:
    """``kernel(*inputs, **kwargs)``, with the gradient of ``plain`` when
    autograd is on and some input requires a gradient."""
    if not (torch.is_grad_enabled()
            and any(t.requires_grad for t in inputs)):
        return kernel(*inputs, **kwargs)
    return _KernelWithPlainBackward.apply(kernel, plain, kwargs, *inputs)
