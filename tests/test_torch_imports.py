"""The port stands alone: no module of ``repro_torch`` and nothing in
``chip_smoke.py`` imports ``jax`` or the JAX package ``repro``, and
importing the port's Recorder, its read side, its trace service, its
models, serving engine and configs leaves ``jax`` unloaded."""

import ast
import os
import subprocess
import sys

import pytest

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_PORT = os.path.join(_REPO, "src", "repro_torch")


def _sources():
    paths = [os.path.join(_REPO, "chip_smoke.py")]
    for root, _dirs, files in os.walk(_PORT):
        paths += [os.path.join(root, f) for f in files if f.endswith(".py")]
    return sorted(paths)


def _imported_roots(path):
    """Top-level package of every absolute import in ``path``."""
    with open(path) as f:
        tree = ast.parse(f.read(), filename=path)
    roots = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            roots += [a.name.split(".")[0] for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.append(node.module.split(".")[0])
    return roots


def test_port_sources_found():
    names = {os.path.relpath(p, _REPO) for p in _sources()}
    assert "chip_smoke.py" in names
    assert os.path.join("src", "repro_torch", "core", "recorder.py") in names
    assert os.path.join("src", "repro_torch", "distributed",
                        "sharding.py") in names
    assert len(names) > 20


@pytest.mark.parametrize("path", _sources(),
                         ids=lambda p: os.path.relpath(p, _REPO))
def test_no_jax_or_reference_import(path):
    bad = [r for r in _imported_roots(path) if r in ("jax", "jaxlib", "repro")]
    assert not bad, f"{path} imports {bad}"


def test_recorder_import_leaves_jax_unloaded():
    code = ("import sys, repro_torch.core.recorder, repro_torch.core.reader, "
            "repro_torch.core.apis, repro_torch.core.traceview, "
            "repro_torch.core.analysis, repro_torch.core.converters, "
            "repro_torch.traceserve, repro_torch.launch.traceserve, "
            "repro_torch.models, repro_torch.models.convert, "
            "repro_torch.serve, repro_torch.launch.serve, "
            "repro_torch.configs, repro_torch.kernels.flash_attention, "
            "repro_torch.kernels.rmsnorm, repro_torch.kernels.ssd_scan, "
            "repro_torch.models.ssm, repro_torch.distributed, "
            "repro_torch.distributed.sharding, repro_torch.core.comm; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'repro')]; print(bad); sys.exit(1 if bad else 0)")
    env = dict(os.environ, PYTHONPATH=os.path.join(_REPO, "src"))
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
