"""Build `graphgpt_torch/csrc/*.cu` with nvcc and load them with ctypes.

Each source becomes its own shared library with a plain C interface,
compiled for `sm_90a` into `build/graphgpt_torch/` beside the package,
named by a hash of the source and of the headers (`*.cuh`) beside it so
that an edit rebuilds it. `build_all()`
starts one nvcc per source, all at once. Every C entry returns its
`cudaGetLastError()`; `check()` raises when that is not 0. A missing nvcc or
a failed build raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Iterable

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "graphgpt_torch"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

_libs: Dict[str, ctypes.CDLL] = {}
_logs: Dict[str, str] = {}
_lock = threading.Lock()


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and Path(root, "bin", "nvcc").exists():
            return str(Path(root, "bin", "nvcc"))
    raise RuntimeError("graphgpt_torch: nvcc not found; the CUDA kernels cannot be built")


def _target(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    src += b"".join(h.read_bytes() for h in sorted(CSRC.glob("*.cuh")))
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}_{digest}.so"


def build_all(names: Iterable[str] = ()) -> Dict[str, str]:
    """Compile the named sources (default: all of csrc/) in parallel, one
    nvcc each; returns each one's compiler log (ptxas register and spill
    report). Sources already built with the same hash are not rebuilt."""
    names = list(names) or sorted(p.stem for p in CSRC.glob("*.cu"))
    todo = {n: _target(n) for n in names if n not in _libs and not _target(n).exists()}
    if todo:
        nvcc = _nvcc()
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        procs = {}
        for n, out in todo.items():
            tmp = out.with_suffix(f".{os.getpid()}.tmp")
            cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{n}.cu")]
            procs[n] = (subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
            ), tmp, out)
        failed = []
        for n, (proc, tmp, out) in procs.items():
            log, _ = proc.communicate()
            _logs[n] = log
            if proc.returncode != 0:
                failed.append(f"{n}.cu:\n{log}")
            else:
                os.replace(tmp, out)
        if failed:
            raise RuntimeError("graphgpt_torch: nvcc failed\n" + "\n".join(failed))
    return {n: _logs.get(n, "(already built)") for n in names}


def lib(name: str) -> ctypes.CDLL:
    """The loaded library of csrc/<name>.cu, built at first use."""
    with _lock:
        if name not in _libs:
            build_all([name])
            _libs[name] = ctypes.CDLL(str(_target(name)))
        return _libs[name]


def entry(name: str, symbol: str, argtypes) -> ctypes._CFuncPtr:
    """The C function `symbol` of csrc/<name>.cu with its argtypes set."""
    fn = getattr(lib(name), symbol)
    if fn.argtypes is None:
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return fn


def check(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"graphgpt_torch: {what} launch failed with CUDA error {err}")


def ptr(t) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def stream_ptr(device) -> ctypes.c_void_p:
    import torch

    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)
