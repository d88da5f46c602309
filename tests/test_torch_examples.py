"""The port's examples against the JAX package's, on the CPU.

``examples/torch_quickstart.py`` (4 steps) and
``examples/torch_workflow_analysis.py`` (its fixed 20 steps and 12 served
tokens, as the JAX example has no step option) run with ``--device cpu
--encode-backend numpy`` in a subprocess, and their JAX counterparts with
the same arguments.  Each trace must read back, and each traced function
must have as many records in the port's trace as in the JAX package's.
The JAX examples write under ``tempfile.mkdtemp``, which follows
``TMPDIR``; the port's take ``--work-dir``.
"""

import collections
import glob
import os
import subprocess
import sys

import pytest

from repro.core.reader import TraceReader as RefReader
from repro_torch.core.reader import TraceReader

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXAMPLES = {
    # name: (the JAX example's arguments, its temporary directory prefix)
    "quickstart": (["--steps", "4"], "repro_quickstart_"),
    "workflow_analysis": ([], "repro_workflow_"),
}


def _run(script: str, args, tmp) -> str:
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               TMPDIR=str(tmp), JAX_PLATFORMS="cpu")
    proc = subprocess.run([sys.executable, os.path.join(ROOT, "examples",
                                                        script)] + args,
                          env=env, capture_output=True, text=True,
                          timeout=600, cwd=str(tmp))
    assert proc.returncode == 0, proc.stderr[-4000:]
    return proc.stdout


def _by_function(reader) -> collections.Counter:
    return collections.Counter(r.func for _, r in reader.all_records(
        timestamps=False))


@pytest.mark.parametrize("name", sorted(EXAMPLES))
def test_example_traces_what_the_jax_example_traces(name, tmp_path):
    args, prefix = EXAMPLES[name]
    (tmp_path / "jax").mkdir()
    _run(f"{name}.py", args, tmp_path / "jax")
    [ref_dir] = glob.glob(str(tmp_path / "jax" / f"{prefix}*"))
    want = _by_function(RefReader(os.path.join(ref_dir, "trace")))

    work = tmp_path / "port"
    out = _run(f"torch_{name}.py", args + [
        "--device", "cpu", "--encode-backend", "numpy",
        "--work-dir", str(work)], tmp_path)
    got = _by_function(TraceReader(str(work / "trace")))
    assert got == want
    assert "unique signatures" in out
    if name == "quickstart":
        assert got["step"] == 4 and f"captured {sum(got.values())} " in out
    else:
        assert got["step"] == 20 and got["serve_step"] == 11
        assert f"chrome timeline: {sum(got.values())} events" in out
        assert f"columnar read: {sum(got.values())} rows" in out
        assert os.path.getsize(work / "timeline.json") > 0
