"""The two packages behind one namespace each, for parity scenarios that
run the same calls through the JAX package ``repro`` and the port
``repro_torch``.

``REF`` is the reference on its ``numpy`` encode backend; ``port(b)`` is
the port on encode backend ``b`` (``numpy`` or ``torch``).  A scenario
takes one namespace and only touches the package through it, so one
function drives both; ``active(P)`` points the port's module default
backend (grammar and ``cfg_index`` packing, stitched reads) at ``P``'s
backend while a scenario runs.
"""

import contextlib
import os
from types import SimpleNamespace

import repro.core.apis  # noqa: F401  (populate the reference registry)
import repro_torch.core.apis  # noqa: F401  (populate the port's registry)
from benchmarks.workloads import synth_rank_states as ref_synth
from repro.core import comm as ref_comm
from repro.core import faults as ref_faults
from repro.core import interprocess as ref_ip
from repro.core import patterns as ref_patterns
from repro.core import reader as ref_reader
from repro.core import recorder as ref_recorder
from repro.core import sequitur as ref_sequitur
from repro.core import specs as ref_specs
from repro.core import streaming as ref_streaming
from repro.core import timestamps as ref_ts
from repro.core import trace_format as ref_tf
from repro_torch import workloads as port_workloads
from repro_torch.core import comm as port_comm
from repro_torch.core import encode_backend as eb
from repro_torch.core import faults as port_faults
from repro_torch.core import interprocess as port_ip
from repro_torch.core import patterns as port_patterns
from repro_torch.core import reader as port_reader
from repro_torch.core import recorder as port_recorder
from repro_torch.core import sequitur as port_sequitur
from repro_torch.core import specs as port_specs
from repro_torch.core import streaming as port_streaming
from repro_torch.core import timestamps as port_ts
from repro_torch.core import trace_format as port_tf

BACKENDS = ("numpy", "torch")


def _pkg(name, backend, recorder, comm, faults, ip, patterns, reader,
         sequitur, specs, streaming, ts, tf, synth):
    def cfg(**kw):
        kw.setdefault("encode_backend", backend)
        return recorder.RecorderConfig(**kw)
    return SimpleNamespace(
        name=name, backend=backend, recorder=recorder,
        Recorder=recorder.Recorder, RecorderConfig=recorder.RecorderConfig,
        cfg=cfg, comm=comm, faults=faults, FaultPlan=faults.FaultPlan,
        SimulatedCrash=faults.SimulatedCrash, ip=ip,
        IntraPatternTracker=patterns.IntraPatternTracker,
        TraceReader=reader.TraceReader, Sequitur=sequitur.Sequitur,
        specs=specs, REGISTRY=specs.REGISTRY, streaming=streaming, ts=ts,
        tf=tf, TraceFormatError=tf.TraceFormatError,
        SegmentWriteError=tf.SegmentWriteError, synth=synth)


REF = _pkg("repro", "numpy", ref_recorder, ref_comm, ref_faults, ref_ip,
           ref_patterns, ref_reader, ref_sequitur, ref_specs, ref_streaming,
           ref_ts, ref_tf, ref_synth)


def port(backend):
    return _pkg("repro_torch", backend, port_recorder, port_comm,
                port_faults, port_ip, port_patterns, port_reader,
                port_sequitur, port_specs, port_streaming, port_ts, port_tf,
                port_workloads.synth_rank_states)


@contextlib.contextmanager
def active(P):
    """Run the port with ``P``'s backend as its module default (a no-op
    for the reference); restores the default after."""
    saved = eb.default_backend()
    if P.name == "repro_torch":
        eb.set_default_backend(P.backend)
    try:
        yield P
    finally:
        eb.set_default_backend(saved)


def bin_files(root):
    """{relative path: bytes} of every ``*.bin`` under ``root``."""
    out = {}
    for dirpath, _dirs, files in os.walk(root):
        for f in files:
            if f.endswith(".bin"):
                p = os.path.join(dirpath, f)
                with open(p, "rb") as fh:
                    out[os.path.relpath(p, root)] = fh.read()
    return out


def parity():
    """A ``both(name, scenario, backend, *args)`` with a cache of its own:
    runs ``scenario(REF, *args)`` once per (name, args) and
    ``scenario(port(backend), *args)``, and asserts the two results are
    equal; returns the port's."""
    cache = {}

    def both(name, scenario, backend, *args):
        key = (name,) + args
        if key not in cache:
            with active(REF):
                cache[key] = scenario(REF, *args)
        P = port(backend)
        with active(P):
            got = scenario(P, *args)
        assert got == cache[key]
        return got
    return both
