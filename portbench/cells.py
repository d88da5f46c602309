"""Finds the pieces of a cell by name.

A cell (``workloads/<cell>.json``) names a configuration
(``configs/<config>.json``) and a traffic mix (``traffic/<traffic>.json``);
the mix names its job (``jobs/<job>.py``), the one generator of
that kind of traffic.  Per-layer metrics are ``metrics/<metric>.py``, one
reader each.  Nothing here lists the cells, mixes or metrics: a later cell,
mix or metric is a new file and no edit.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import re
from pathlib import Path
from types import ModuleType
from typing import Any, Dict, List

ROOT = Path(__file__).resolve().parent
JOBS = ROOT / "jobs"
NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}")


def check_name(name: str, what: str = "name") -> str:
    """``name`` if it is a name the benchmark takes (letters, digits, ``_``,
    ``.`` and ``-``, at most 64, not starting with ``.`` or ``-``), else
    ValueError."""
    if not isinstance(name, str) or not NAME.fullmatch(name):
        raise ValueError(f"{what} {name!r} is not a benchmark name "
                         f"([A-Za-z0-9_][A-Za-z0-9_.-]{{0,63}})")
    return name


def load_json(folder: str, name: str) -> Dict[str, Any]:
    check_name(name, folder[:-1] if folder.endswith("s") else folder)
    path = ROOT / folder / f"{name}.json"
    if not path.is_file():
        raise FileNotFoundError(f"no {folder} file {path.name} under "
                                f"{ROOT.name}/{folder}")
    with open(path) as f:
        return json.load(f)


def load_cell(name: str) -> Dict[str, Any]:
    """The cell with its configuration and traffic mix resolved:
    ``{"name", "config", "traffic", "limits", "model", "mix"}``."""
    cell = dict(load_json("workloads", name))
    cell["name"] = name
    cell["model"] = load_json("configs", cell["config"])
    cell["mix"] = load_json("traffic", cell["traffic"])
    cell.setdefault("limits", {})
    return cell


def load_job(kind: str) -> ModuleType:
    check_name(kind, "job")
    if not (JOBS / f"{kind}.py").is_file():
        raise FileNotFoundError(f"no job jobs/{kind}.py")
    return importlib.import_module(f"portbench.jobs.{kind}")


def metric_names() -> List[str]:
    return sorted(p.stem for p in (ROOT / "metrics").glob("*.py")
                  if not p.stem.startswith("_"))


def load_metric(name: str) -> ModuleType:
    """``metrics/<name>.py``: its ``LAYER``, ``UNIT``, ``MOVES`` and
    ``read(ctx)``, which returns a number or None where it finds nothing
    to read."""
    check_name(name, "metric")
    path = ROOT / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "portbench_metric_" + re.sub(r"[^A-Za-z0-9_]", "_", name), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod
