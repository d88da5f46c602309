"""Build the port's CUDA sources with ``nvcc`` and load them with ``ctypes``.

Every ``csrc/<name>.cu`` exposes a plain C interface (pointers, sizes and
the CUDA stream as ``void*``/``int64_t``; each entry point returns
``cudaGetLastError()``), so the build needs no PyTorch headers and takes
seconds.  A source is compiled at first use into
``<checkout>/build/kernels/<name>-<hash>.so``: the hash covers the source,
the shared headers and the compiler flags, so an edited kernel is rebuilt
and a stale library is never loaded.  Compilation writes to a temporary
name and renames it into place, so concurrent builders never see a
half-written library.

The wrappers (``delta_encode/ops.py``, ``grammar_stats/ops.py``,
``flash_attention/ops.py``, ``rmsnorm/ops.py``, ``ssd_scan/ops.py``) call
:func:`launch`, which raises on a nonzero CUDA error and adds one to the
kernel's launch count -- the count that shows a run really went through
the kernel.  ThreadComm ranks launch from several threads, so the counts
and the library cache are guarded by locks.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Dict, List, Sequence

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
SOURCES = ("delta_encode", "grammar_stats", "flash_attention", "rmsnorm",
           "ssd_scan")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

_lib_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
_count_lock = threading.Lock()
_launches: Dict[str, int] = {}


def nvcc() -> str:
    """Path of the CUDA compiler: ``nvcc`` on PATH, else under CUDA_HOME."""
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    path = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError(
            "cannot build the CUDA kernels: nvcc is neither on PATH nor "
            f"at {path} (set CUDA_HOME)")
    return path


def library_path(name: str) -> Path:
    """Where ``csrc/<name>.cu`` builds to: the hash covers the source, the
    shared headers (``csrc/*.cuh``) and the compiler flags."""
    src = (CSRC / f"{name}.cu").read_bytes()
    src += b"".join(p.read_bytes() for p in sorted(CSRC.glob("*.cuh")))
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"{name}-{digest[:16]}.so"


def compile_source(name: str) -> Path:
    """Compile ``csrc/<name>.cu`` unless a library of the same hash exists;
    returns the library's path.  Raises with the compiler's output on
    failure."""
    out = library_path(name)
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.{threading.get_ident()}")
    cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed on {name}.cu "
                           f"(exit {proc.returncode}):\n{proc.stderr}")
    os.replace(tmp, out)
    return out


def build_all(names: Sequence[str] = SOURCES) -> List[Path]:
    """Compile every source at once, one ``nvcc`` process each."""
    with ThreadPoolExecutor(max_workers=len(names)) as pool:
        return list(pool.map(compile_source, names))


def library(name: str, signatures: Dict[str, list]) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu`` with ``argtypes`` set from
    ``signatures`` (every entry point returns a CUDA error code)."""
    with _lib_lock:
        lib = _libs.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(compile_source(name)))
            for fn, argtypes in signatures.items():
                f = getattr(lib, fn)
                f.argtypes = argtypes
                f.restype = ctypes.c_int
            lib.repro_error_string.argtypes = [ctypes.c_int]
            lib.repro_error_string.restype = ctypes.c_char_p
            _libs[name] = lib
        return lib


def check(t: torch.Tensor, what: str, dtype: torch.dtype, ndim: int,
          rows: bool = False) -> None:
    """Raise unless ``t`` is a contiguous ``dtype`` tensor of rank ``ndim``
    on the CPU or a CUDA device; with ``rows``, a matrix whose values lie
    at stride 1 and whose rows may lie at any stride past their length (a
    column slice)."""
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{what} must be a torch.Tensor, got {type(t)}")
    if t.dtype != dtype:
        raise TypeError(f"{what} must be {dtype}, got {t.dtype}")
    if t.dim() != ndim:
        raise ValueError(f"{what} must have {ndim} dimension(s), "
                         f"got shape {tuple(t.shape)}")
    if rows and ndim == 2:
        if t.stride(1) != 1 or (t.shape[0] > 1 and t.stride(0) < t.shape[1]):
            raise ValueError(f"{what} must have its values at stride 1 and "
                             f"its rows at a stride >= its row length")
    elif not t.is_contiguous():
        raise ValueError(f"{what} must be contiguous")
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{what} must lie on the CPU or a CUDA device, "
                         f"got {t.device}")


def launch(lib: ctypes.CDLL, kernel: str, device: torch.device,
           *args) -> None:
    """Call entry point ``kernel`` on ``device``'s current stream; raise
    if the launch reported a CUDA error, else count one launch."""
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = getattr(lib, kernel)(*args, ctypes.c_void_p(stream))
    if err != 0:
        msg = lib.repro_error_string(err).decode()
        raise RuntimeError(f"CUDA kernel {kernel} failed to launch: "
                           f"error {err} ({msg})")
    count_launch(kernel)


def ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def launch_counts() -> Dict[str, int]:
    """Kernel launches since the last :func:`reset_launches`."""
    with _count_lock:
        return dict(_launches)


def reset_launches() -> None:
    with _count_lock:
        _launches.clear()


def count_launch(kernel: str) -> None:
    """Add one launch of ``kernel`` (what :func:`launch` does after a
    successful launch)."""
    with _count_lock:
        _launches[kernel] = _launches.get(kernel, 0) + 1
