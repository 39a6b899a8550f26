"""ctypes binding for the C++ graph kernels (`euler.cpp`): the Euler walk
and ego-k-hop node sampling.

Counterpart of `graphgpt_tpu/native/euler_native.py` (`graph_to_walk` :77,
`ego_k_hop` :94), over a copy of its `euler.cpp`. At first use g++ compiles
the source with the JAX package's flags, so that both libraries draw the
same walks, into `build/graphgpt_torch/native/` beside the package, named
by a hash of the source and the flags. The library is written under a name
of this process's own and then moved into place, so that concurrent
builders (test workers, loader workers) never load a half-written file.

A failed build raises with the compiler's output. The JAX binding falls
back to the numpy walk instead; here that would change every tokenized row
with the presence of a compiler. This module imports no torch: the loader's
spawned workers load it.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Optional

import numpy as np

SRC = Path(__file__).resolve().parent / "euler.cpp"
BUILD_DIR = SRC.parent.parent.parent / "build" / "graphgpt_torch" / "native"
CXX = "g++"
CXX_FLAGS = ["-O3", "-std=c++17", "-shared", "-fPIC"]

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def library_path() -> Path:
    """Where the library of this source and these flags lives."""
    digest = hashlib.sha256(SRC.read_bytes() + " ".join(CXX_FLAGS).encode()).hexdigest()[:16]
    return Path(BUILD_DIR) / f"libggtnative_{digest}.so"


def build() -> Path:
    """Compile the library unless it is there; returns its path."""
    out = library_path()
    if out.exists():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = [CXX, *CXX_FLAGS, str(SRC), "-o", str(tmp)]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
    except (OSError, subprocess.TimeoutExpired) as e:
        raise RuntimeError(f"graphgpt_torch: the C++ walk cannot be built ({' '.join(cmd)}): "
                           f"{e}") from e
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"graphgpt_torch: g++ failed on {SRC.name} (exit "
                           f"{proc.returncode}, {' '.join(cmd)}):\n{proc.stderr}")
    os.replace(tmp, out)
    return out


def load() -> ctypes.CDLL:
    """The library, built at the first call of this process."""
    global _lib
    if _lib is not None:
        return _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            i64, p64 = ctypes.c_int64, ctypes.POINTER(ctypes.c_int64)
            lib.ggt_euler_walk.restype = i64
            lib.ggt_euler_walk.argtypes = [i64, i64, p64, p64, ctypes.c_uint64, p64]
            lib.ggt_ego_k_hop.restype = i64
            lib.ggt_ego_k_hop.argtypes = [p64, p64, p64, i64, i64, i64, i64, ctypes.c_uint64,
                                          p64, i64]
            _lib = lib
    return _lib


def _ptr(arr: np.ndarray):
    return arr.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))


def graph_to_walk(num_nodes: int, edge_index: np.ndarray,
                  rng: np.random.Generator) -> np.ndarray:
    """The C++ Euler walk (components shuffled, each eulerized and toured,
    joined by jumps) as an int64 node array. It draws one 63-bit seed from
    `rng`."""
    lib = load()
    src = np.ascontiguousarray(edge_index[0], np.int64)
    dst = np.ascontiguousarray(edge_index[1], np.int64)
    m = src.shape[0]
    out = np.empty(2 * m + num_nodes + 2, np.int64)
    seed = int(rng.integers(0, 2**63 - 1))
    n = lib.ggt_euler_walk(num_nodes, m, _ptr(src), _ptr(dst), seed, _ptr(out))
    if n < 0:
        raise RuntimeError(f"ggt_euler_walk failed ({n}) on a graph of {num_nodes} nodes")
    return out[:n]


def ego_k_hop(indptr, indices, seeds, depth: int, fanout: int, rng, replace=False):
    """C++ ego-k-hop over CSR: the sorted nodes within `depth` hops of
    `seeds`, at most `fanout` neighbours a node (as the JAX binding, whose
    output buffer this first sizes the same way). It draws one 63-bit seed
    from `rng`. Where the nodes pass that first guess (a fanout < 0, many
    hops), the sampler runs again from the same seed with room for every
    node, where the JAX binding returns None and its caller samples in
    numpy."""
    lib = load()
    indptr = np.ascontiguousarray(indptr, np.int64)
    indices = np.ascontiguousarray(indices, np.int64)
    seeds = np.ascontiguousarray(seeds, np.int64)
    # generous capacity bound: seeds + sum over hops of fanout growth
    cap = int(len(seeds) * max(fanout, 1) ** max(depth, 1) * 2 + len(seeds) + 16)
    full = min(len(indices), len(indptr) - 1) + len(seeds) + 1
    seed = int(rng.integers(0, 2**63 - 1))
    for size in (min(cap, len(indices) + len(seeds) + 1), full):
        out = np.empty(size, np.int64)
        n = lib.ggt_ego_k_hop(
            _ptr(indptr), _ptr(indices), _ptr(seeds), len(seeds), depth, fanout,
            1 if replace else 0, seed, _ptr(out), size,
        )
        if n >= 0:
            return out[:n]
    raise RuntimeError(f"ggt_ego_k_hop found more than {full} nodes")
