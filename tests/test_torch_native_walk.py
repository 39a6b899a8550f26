"""The port's C++ graph kernels against the JAX package's, on the CPU.

`graphgpt_torch/native/euler.cpp` is a copy of the JAX package's source,
built with the same g++ flags, so on the same numpy generator the port's
`graph_to_walk` and `ego_k_hop` must give the JAX native binding's bits, on
connected and disconnected graphs. The port's `data/euler.py` walks in C++
by default, as the JAX package does, and a failed build raises instead of
falling back to the numpy walk.
"""

import numpy as np
import pytest

from graphgpt_tpu.data import datasets as jdatasets
from graphgpt_tpu.data import euler as jeuler
from graphgpt_tpu.native import euler_native as jnative
from graphgpt_torch.data import datasets as tdatasets
from graphgpt_torch.data import euler as teuler
from graphgpt_torch.data.graph import CSR, Graph, connected_components
from graphgpt_torch.native import euler_native as tnative


def _graphs():
    """Molecules (connected), sparse Erdos-Renyi graphs (several components,
    isolated nodes), and the degenerate ones: one node, no edges, two
    2-cliques, a self-loop."""
    rng = np.random.default_rng(3)
    out = [tdatasets.random_molecule_graph(rng, 2, 40) for _ in range(40)]
    out += [jdatasets.erdos_renyi_graph(rng, int(rng.integers(5, 40)), 0.06) for _ in range(20)]
    out += [
        Graph(1, np.zeros((2, 0), np.int32)),
        Graph(4, np.zeros((2, 0), np.int32)),
        Graph(4, np.asarray([[0, 1, 2, 3], [1, 0, 3, 2]], np.int32)),
        Graph(3, np.asarray([[0, 1, 1, 1, 2], [1, 0, 1, 2, 1]], np.int32)),
    ]
    return out


def _csr(g):
    order = np.lexsort((g.edge_index[1], g.edge_index[0]))
    src, dst = g.edge_index[0][order], g.edge_index[1][order]
    indptr = np.concatenate([[0], np.cumsum(np.bincount(src, minlength=g.num_nodes))])
    return indptr.astype(np.int64), dst.astype(np.int64)


def test_the_source_is_the_jax_packages():
    with open(jnative._SRC, "rb") as f:
        assert tnative.SRC.read_bytes() == f.read()
    assert tnative.CXX_FLAGS == ["-O3", "-std=c++17", "-shared", "-fPIC"]
    assert jnative.available()


def test_walks_equal_jax_native_bit_for_bit():
    for i, g in enumerate(_graphs()):
        want = jnative.graph_to_walk(g.num_nodes, g.edge_index, np.random.default_rng(i))
        got = tnative.graph_to_walk(g.num_nodes, g.edge_index, np.random.default_rng(i))
        assert got.dtype == want.dtype == np.int64
        np.testing.assert_array_equal(got, want, err_msg=f"graph {i}")


def test_walks_cover_every_node_and_edge():
    """Each step is an edge or a jump between components; every node and
    every undirected edge (self-loops dropped) is visited."""
    for i, g in enumerate(_graphs()):
        walk = tnative.graph_to_walk(g.num_nodes, g.edge_index, np.random.default_rng(i))
        assert set(walk.tolist()) == set(range(g.num_nodes))
        edges = {(min(a, b), max(a, b)) for a, b in g.edge_index.T.tolist() if a != b}
        steps = {(min(a, b), max(a, b)) for a, b in zip(walk[:-1].tolist(), walk[1:].tolist())}
        assert edges <= steps
        comp = connected_components(CSR(g.num_nodes, g.edge_index))
        assert all(comp[a] != comp[b] for a, b in steps - edges)  # jumps join components


@pytest.mark.parametrize("depth,fanout,replace", [(1, 5, False), (2, 3, False), (2, 3, True),
                                                  (3, -1, False), (6, 40, False)])
def test_ego_k_hop_equals_jax_native(depth, fanout, replace):
    rng = np.random.default_rng(5)
    g = jdatasets.erdos_renyi_graph(rng, 120, 0.05)
    indptr, indices = _csr(g)
    for s in range(6):
        seeds = np.random.default_rng(s).choice(120, size=1 + s % 3, replace=False)
        want = jnative.ego_k_hop(indptr, indices, seeds, depth, fanout,
                                 np.random.default_rng(s), replace=replace)
        got = tnative.ego_k_hop(indptr, indices, seeds, depth, fanout,
                                np.random.default_rng(s), replace=replace)
        if want is None:
            # past the JAX binding's first buffer (fanout < 0): it leaves the
            # sample to numpy, the port's binding samples again with room for
            # every node; with no fanout both give the whole neighbourhood
            from graphgpt_torch.data.sampling import ego_k_hop_numpy

            assert fanout < 0
            np.testing.assert_array_equal(got, ego_k_hop_numpy(
                indptr, indices, seeds, depth, fanout, np.random.default_rng(s), replace))
        else:
            np.testing.assert_array_equal(got, want)


def test_the_default_walk_is_the_jax_packages_default():
    """Neither package's walk pinned: both take C++, and the tokenizer's
    walks agree; the numpy walk draws other ones."""
    assert teuler._native() is tnative and jeuler._native() is jnative
    differ = 0
    for i, g in enumerate(_graphs()[:30]):
        want = jeuler.graph_to_walk(g, np.random.default_rng(i))
        np.testing.assert_array_equal(teuler.graph_to_walk(g, np.random.default_rng(i)), want)
    saved = (teuler._NATIVE_CHECKED, teuler._NATIVE)
    teuler._NATIVE_CHECKED, teuler._NATIVE = True, None
    try:
        for i, g in enumerate(_graphs()[:30]):
            numpy_walk = teuler.graph_to_walk(g, np.random.default_rng(i))
            differ += not np.array_equal(numpy_walk,
                                         jeuler.graph_to_walk(g, np.random.default_rng(i)))
    finally:
        teuler._NATIVE_CHECKED, teuler._NATIVE = saved
    assert differ > 20


def test_a_failed_build_raises(monkeypatch, tmp_path):
    """g++ replaced by `false`, a fresh build directory: loading raises with
    the compiler's exit, and the walk raises too instead of walking in
    numpy."""
    monkeypatch.setattr(tnative, "CXX", "false")
    monkeypatch.setattr(tnative, "BUILD_DIR", tmp_path / "native")
    monkeypatch.setattr(tnative, "_lib", None)
    monkeypatch.setattr(teuler, "_NATIVE_CHECKED", False)
    monkeypatch.setattr(teuler, "_NATIVE", None)
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        tnative.load()
    g = _graphs()[0]
    for _ in range(2):  # each call again, never a silent fallback
        with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
            teuler.graph_to_walk(g, np.random.default_rng(0))
    assert teuler._NATIVE_CHECKED is False
    assert not list((tmp_path / "native").iterdir())  # no half-written library


def test_the_library_is_named_by_its_source_and_flags(monkeypatch, tmp_path):
    """A build in a fresh directory lands under the hash name, with no
    temporary file left; other flags give another name."""
    monkeypatch.setattr(tnative, "BUILD_DIR", tmp_path)
    path = tnative.build()
    assert path.parent == tmp_path and path.name.startswith("libggtnative_")
    assert sorted(p.name for p in tmp_path.iterdir()) == [path.name]
    monkeypatch.setattr(tnative, "CXX_FLAGS", tnative.CXX_FLAGS + ["-g"])
    assert tnative.library_path() != path
