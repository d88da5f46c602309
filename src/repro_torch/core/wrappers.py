"""Automatic tracing-wrapper generation (paper §2.1, Listing 1).

The original Recorder generates a C wrapper per function from a signature
file and loads them as plugins via GOTCHA.  Here ``generate_wrappers``
*generates Python source* for a three-phase wrapper per ``FnSpec`` and
``exec``s it -- the Python analogue of code generation + plugin compilation.
The generated wrapper is:

    def <name>(<args...>):
        rec = _active[0]
        if rec is None or not <layer enabled>:
            return _impl(<args...>)          # tracing off: passthrough
        t0 = rec.now()                        # -- prologue
        depth = rec.enter()
        try:
            ret = _impl(<args...>)            # -- the real call
        except BaseException as e:
            rec.exit(); t1 = rec.now()
            rec.record(FID, (<args...>), ('err', type(e).__name__), depth, t0, t1)
            raise
        rec.exit()
        t1 = rec.now()                        # -- epilogue
        rec.record(FID, (<args...>), ret, depth, t0, t1)
        return ret

Handle lifetime: wrappers for specs named ``close*`` also drop the handle
mapping after recording.
"""

from __future__ import annotations

from types import SimpleNamespace
from typing import Callable, Dict, List, Optional

from .recorder import _active
from .specs import REGISTRY, FnSpec, FunctionRegistry


_TEMPLATE = '''
def {name}({params}):
    rec = _active[0]
    if rec is None or not rec.layer_enabled({layer!r}):
        return _impl({params})
    t0 = rec.now()
    depth = rec.enter()
    try:
        ret = _impl({params})
    except BaseException as e:
        rec.exit()
        t1 = rec.now()
        rec.record({fid}, ({argtuple}), ("err", type(e).__name__), depth, t0, t1)
        raise
    rec.exit()
    t1 = rec.now()
    rec.record({fid}, ({argtuple}), ret, depth, t0, t1)
    {post}
    return ret
'''


def generate_wrapper(spec: FnSpec, fid: int, impl: Callable) -> Callable:
    params = ", ".join(a.name for a in spec.args)
    argtuple = ", ".join(a.name for a in spec.args)
    if len(spec.args) == 1:
        argtuple += ","
    post = ""
    if spec.name.startswith("close") or spec.name.endswith("close") or \
            "_close" in spec.name:
        first_handle = next((a.name for a in spec.args), None)
        if first_handle:
            post = f"rec.forget_handle({first_handle})"
    src = _TEMPLATE.format(name=spec.name, params=params, fid=fid,
                           argtuple=argtuple, layer=spec.layer,
                           post=post or "pass")
    ns: Dict[str, object] = {"_active": _active, "_impl": impl}
    code = compile(src, f"<recorder-wrapper:{spec.name}>", "exec")
    exec(code, ns)  # noqa: S102 - code generation is the point (paper §2.1)
    fn = ns[spec.name]
    fn.__recorder_spec__ = spec  # type: ignore[attr-defined]
    return fn  # type: ignore[return-value]


def generate_wrappers(specs: List[FnSpec],
                      registry: FunctionRegistry = REGISTRY,
                      impls: Optional[Dict[str, Callable]] = None
                      ) -> SimpleNamespace:
    """Register specs and generate one wrapper per function.

    ``impls`` overrides per-function implementations (used by the simulated
    I/O layers in benchmarks); otherwise ``spec.impl`` is used.
    """
    ns = SimpleNamespace()
    for spec in specs:
        impl = (impls or {}).get(spec.name, spec.impl)
        if impl is None:
            raise ValueError(f"no implementation for {spec.name}")
        fid = registry.id_of(spec.name) if spec.name in registry._by_name \
            else registry.register(spec)
        setattr(ns, spec.name, generate_wrapper(spec, fid, impl))
    return ns
