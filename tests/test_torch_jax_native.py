"""The JAX package's C++ library, built and loaded safely for the port's
parity tests; and the race it repairs, rebuilt on a copy.

`graphgpt_tpu/native/euler_native.py` (`_build` :26-36) compiles
`libggtnative.so` beside its source through one shared temporary name,
`libggtnative.so.tmp`, and then moves it into place. Processes that build
at once (the test workers of one run) write that one file together: one
may move another's half-written library into place and load it ("file too
short"), or get None from `_build`, which sets `_build_failed` and sends
that process to the numpy walk and numpy sampler for good. A parity test in
such a worker then holds the port's C++ walk against JAX's numpy walk.

`private_jax_native()` makes the calling process's JAX binding use a
library nobody else writes: under an `fcntl` lock it compiles JAX's own
`euler.cpp` with the binding's flags under a name of this process's own,
moves it to a path named by a hash of the source and the flags (under
`build/graphgpt_tpu_native/`, outside the JAX package), and loads that path
through the binding's own `_load`. A spawned loader worker of the JAX
package imports the binding afresh and loads the shared library, so under
the same lock the helper also checks that the shared library is complete
and loads, and rebuilds it through a name of its own where it does not.
A library that cannot be built fails the test with g++'s output.

Every port test module that holds the port's C++ walk or sampler against
the JAX package's takes the module-scoped autouse fixture
`jax_native_library`: `from test_torch_jax_native import
jax_native_library  # noqa: F401`.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import importlib.util
import json
import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

ROOT = Path(__file__).resolve().parent.parent
BUILD_DIR = ROOT / "build" / "graphgpt_tpu_native"
# the binding's flags (`_build` :29-31), as the port's copy of the binding
# keeps them (pinned in test_torch_native_walk.py)
JAX_FLAGS = ["-O3", "-std=c++17", "-shared", "-fPIC"]


def _compile(src: Path, out: Path) -> None:
    """g++ with the binding's flags to a name of this process's own, then
    moved to `out`; fails the test with g++'s output."""
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    proc = subprocess.run(["g++", *JAX_FLAGS, str(src), "-o", str(tmp)], capture_output=True,
                          text=True, timeout=300)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        pytest.fail(f"g++ cannot build {src} (exit {proc.returncode}):\n{proc.stderr}")
    os.replace(tmp, out)


def _loads(path: Path) -> bool:
    try:
        ctypes.CDLL(str(path))
        return True
    except OSError:
        return False


def private_jax_native(mod=None, build_dir: Path = BUILD_DIR):
    """Make `mod` (the JAX binding `graphgpt_tpu.native.euler_native` by
    default) load a library of its source that no other process writes,
    and leave its shared library complete for spawned workers; returns
    `mod`, its library loaded."""
    if mod is None:
        from graphgpt_tpu.native import euler_native as mod
    src = Path(mod._SRC)
    digest = hashlib.sha256(src.read_bytes() + " ".join(JAX_FLAGS).encode()).hexdigest()[:16]
    build_dir = Path(build_dir)
    build_dir.mkdir(parents=True, exist_ok=True)
    private = build_dir / f"libggtnative_{digest}.so"
    shared = Path(mod._LIB_PATH)
    with open(build_dir / "lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            if not private.exists() or not _loads(private):
                _compile(src, private)
            # the binding's `_build` takes a library older than its source
            # for stale and rebuilds it through the shared temporary name
            if private.stat().st_mtime < src.stat().st_mtime:
                os.utime(private)
            fresh = shared.exists() and shared.stat().st_mtime >= src.stat().st_mtime
            if not (fresh and _loads(shared)):
                tmp = shared.with_name(f"{shared.name}.{os.getpid()}.tmp")
                shutil.copyfile(private, tmp)
                os.replace(tmp, shared)
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)
    saved = mod._LIB_PATH
    mod._lib, mod._build_failed, mod._LIB_PATH = None, False, str(private)
    try:
        if mod._load() is None:
            pytest.fail(f"the JAX binding did not load {private}")
    finally:
        mod._LIB_PATH = saved
    return mod


@pytest.fixture(scope="module", autouse=True)
def jax_native_library():
    """The JAX binding on a library of this process's own, before the
    module's first JAX walk or sampler."""
    return private_jax_native()


# ---- the race, on a copy of graphgpt_tpu/native/

_PLAIN = """
import importlib.util, sys
spec = importlib.util.spec_from_file_location("euler_native", sys.argv[1])
mod = importlib.util.module_from_spec(spec)
spec.loader.exec_module(mod)
try:
    print("loaded" if mod.available() else "None (_build_failed set: the numpy walk)")
except OSError as e:
    print(f"OSError: {e}")
"""

_HELPED = """
import importlib.util, json, sys
import numpy as np
spec = importlib.util.spec_from_file_location("euler_native", sys.argv[1])
mod = importlib.util.module_from_spec(spec)
spec.loader.exec_module(mod)
sys.path.insert(0, sys.argv[2])
from test_torch_jax_native import private_jax_native
private_jax_native(mod, sys.argv[3])
edges = np.asarray([[0, 1, 1, 2, 3, 4, 4], [1, 2, 3, 0, 4, 5, 6]])
walk = mod.graph_to_walk(8, edges, np.random.default_rng(7))
print(json.dumps({"lib": mod._lib._name, "walk": walk.tolist()}))
"""


def _copy_binding(dst: Path) -> Path:
    from graphgpt_tpu.native import euler_native as jnative

    dst.mkdir()
    here = Path(jnative._SRC).parent
    for name in ("__init__.py", "euler.cpp", "euler_native.py"):
        shutil.copy(here / name, dst / name)
    return dst / "euler_native.py"


def _at_once(code: str, *args: str, n: int = 6):
    procs = [subprocess.Popen([sys.executable, "-c", code, *args], stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True) for _ in range(n)]
    return [p.communicate(timeout=300) + (p.returncode,) for p in procs]


def test_six_processes_get_one_loadable_library_and_one_walk(tmp_path):
    """Six plain processes on a copy of the binding without its library
    race on the shared temporary name (what each gets is printed, not
    asserted: the race need not show on every run); six processes through
    the helper, on a fresh copy, each load a library and walk a fixed graph
    to one walk."""
    plain = _copy_binding(tmp_path / "plain")
    got = [out.strip() or err.strip().splitlines()[-1] for out, err, _ in _at_once(
        _PLAIN, str(plain))]
    print("six plain processes on a copy without the library:", got)

    helped = _copy_binding(tmp_path / "helped")
    results = _at_once(_HELPED, str(helped), str(Path(__file__).parent),
                       str(tmp_path / "private"))
    for out, err, rc in results:
        assert rc == 0, err
    runs = [json.loads(out.strip().splitlines()[-1]) for out, _, _ in results]
    assert len({tuple(r["walk"]) for r in runs}) == 1
    assert len({r["lib"] for r in runs}) == 1
    assert all(Path(r["lib"]).parent == tmp_path / "private" for r in runs)
    assert len(runs[0]["walk"]) >= 8  # every node of the graph
    # the shared library beside the copy is complete for spawned workers
    assert _loads(helped.with_name("libggtnative.so"))
    assert not [*(tmp_path / "helped").glob("*.tmp"), *(tmp_path / "private").glob("*.tmp")]


def test_the_helper_repairs_a_lost_race_and_a_truncated_library(tmp_path):
    """A binding left as a lost race leaves it (`_build_failed` set, the
    shared library cut short) loads the private library again and finds
    the shared one rebuilt."""
    path = _copy_binding(tmp_path / "copy")
    spec = importlib.util.spec_from_file_location("euler_native_copy", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    shared = Path(mod._LIB_PATH)
    shared.write_bytes(b"\x7fELF")  # a half-written library, newer than the source
    mod._build_failed = True
    assert not mod.available()
    private_jax_native(mod, tmp_path / "private")
    assert mod.available() and mod._lib._name.startswith(str(tmp_path / "private"))
    assert mod._LIB_PATH == str(shared) and _loads(shared)
    edges = np.asarray([[0, 1, 2], [1, 2, 0]])
    want = mod.graph_to_walk(3, edges, np.random.default_rng(1))
    from graphgpt_tpu.native import euler_native as jnative

    assert np.array_equal(jnative.graph_to_walk(3, edges, np.random.default_rng(1)), want)


def test_the_fixture_left_this_process_on_its_private_library():
    from graphgpt_tpu.native import euler_native as jnative

    assert jnative._lib is not None and not jnative._build_failed
    assert Path(jnative._lib._name).parent == BUILD_DIR
    assert jnative._LIB_PATH == os.path.join(os.path.dirname(jnative._SRC), "libggtnative.so")


def test_the_flags_are_the_bindings():
    """The helper compiles with the flags the binding's `_build` passes."""
    import inspect

    from graphgpt_tpu.native import euler_native as jnative

    cmd = re.search(r"cmd = \[(.*?)\]", inspect.getsource(jnative._build), re.S).group(1)
    assert re.findall(r'"(-[^"]+)"', cmd) == JAX_FLAGS + ["-o"]
