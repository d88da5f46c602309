"""Framework event layer (paper §2.2 CUDA-kernel analogue).

The original Recorder optionally traces CUDA kernel launches via CUPTI,
"treating kernel invocations as ordinary I/O calls".  The framework
analogue is the dispatch of compiled steps and pipeline events:

    step(step_idx)         one optimizer step dispatch
    serve_step(step_idx)   one decode step dispatch
    fetch_batch(step_idx)  one data-pipeline batch
    ckpt_begin/ckpt_end    checkpoint bracket (async thread shows its own tid)

``step_idx`` is OFFSET-role: the intra-process pattern pass recognizes the
``i*1 + 0`` progression, so an arbitrarily long step loop compresses to a
constant-size grammar -- the paper's technique applied to the training loop
itself.
"""

from __future__ import annotations

from ..specs import REGISTRY, Arg, FnSpec, Role
from ..wrappers import generate_wrappers

_L = "frame"


def _noop(*a, **k):
    return 0


SPECS = [
    FnSpec("step", _L, [Arg("step_idx", Role.OFFSET)], impl=_noop),
    FnSpec("serve_step", _L, [Arg("step_idx", Role.OFFSET)], impl=_noop),
    FnSpec("fetch_batch", _L, [Arg("step_idx", Role.OFFSET),
                               Arg("nbytes", Role.SIZE)], impl=_noop),
    FnSpec("ckpt_begin", _L, [Arg("step_idx", Role.OFFSET)], impl=_noop),
    FnSpec("ckpt_end", _L, [Arg("step_idx", Role.OFFSET),
                            Arg("nbytes", Role.SIZE)], impl=_noop),
]

_api = generate_wrappers(SPECS, REGISTRY)

step = _api.step
serve_step = _api.serve_step
fetch_batch = _api.fetch_batch
ckpt_begin = _api.ckpt_begin
ckpt_end = _api.ckpt_end
