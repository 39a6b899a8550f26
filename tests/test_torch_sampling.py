"""The port's big-graph sampling (`graphgpt_torch/data/sampling.py`,
`data/partition.py`'s random subgraphs) against the JAX package's
(`graphgpt_tpu/data/sampling.py`, `data/partition.py`) on the same numpy
inputs, all bit for bit: the directed CSR, ego-k-hop on both routes (the
C++ sampler, and the JAX numpy fallback against the port's copy of it),
induced subgraphs of graphs with multi-edges, self loops and isolated
nodes, positive subsets over a percent-50 cycle, global negatives below and
above 1M existing edges, local negatives with relation attributes, and
every item of `EgoNodeDataset` and `EgoEdgeDataset` over two epochs.
"""

import numpy as np
import pytest

from graphgpt_tpu import readers as jreaders
from graphgpt_tpu.data import graph as jgraph
from graphgpt_tpu.data import partition as jpartition
from graphgpt_tpu.data import sampling as jsampling
from graphgpt_tpu.native import euler_native as jnative
from graphgpt_torch import readers as treaders
from graphgpt_torch.data import graph as tgraph
from graphgpt_torch.data import partition as tpartition
from graphgpt_torch.data import sampling as tsampling
from test_torch_readers import assert_graphs_equal
from test_torch_jax_native import jax_native_library  # noqa: F401  (autouse: JAX's C++ library)


def random_big_graph(n, m, seed, node_cols=3, edge_cols=2, y_cols=4, isolated=5,
                     self_loops=4, multi=6):
    """(JAX Graph, port Graph) over the same arrays: m random undirected
    edges in both directions among the first n - isolated nodes, plus self
    loops and repeated edges."""
    rng = np.random.default_rng(seed)
    live = n - isolated
    a, b = rng.integers(0, live, m), rng.integers(0, live, m)
    keep = a != b
    a, b = a[keep], b[keep]
    loops = rng.integers(0, live, self_loops)
    rep = rng.integers(0, len(a), multi)
    src = np.concatenate([a, b, loops, a[rep]])
    dst = np.concatenate([b, a, loops, b[rep]])
    ei = np.stack([src, dst]).astype(np.int32)
    e = ei.shape[1]
    kw = dict(num_nodes=n, edge_index=ei,
              node_attr=rng.integers(0, 9, (n, node_cols)).astype(np.int32),
              edge_attr=rng.integers(0, 5, (e, edge_cols)).astype(np.int32),
              y=rng.integers(0, 2, (n, y_cols)).astype(np.int64))
    return jgraph.Graph(**kw), tgraph.Graph(**kw)


def spy(monkeypatch, module, name, result=...):
    """Count the calls of module.name; return `result` instead where given."""
    calls = []
    real = getattr(module, name)

    def fn(*a, **kw):
        calls.append(1)
        return real(*a, **kw) if result is ... else result

    monkeypatch.setattr(module, name, fn)
    return calls


def test_csr_equals_jax():
    jbig, tbig = random_big_graph(300, 1500, 0)
    for got, want in zip(tsampling.build_csr_directed(tbig.num_nodes, tbig.edge_index),
                         jsampling.build_csr_directed(jbig.num_nodes, jbig.edge_index)):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("depth,fanout,replace", [(1, 14, False), (2, 3, False), (2, 3, True),
                                                  (1, 1000, False), (3, 1, False)])
def test_ego_k_hop_cpp_route_equals_jax(monkeypatch, depth, fanout, replace):
    jbig, tbig = random_big_graph(400, 2500, 1)
    indptr, indices, _ = tsampling.build_csr_directed(tbig.num_nodes, tbig.edge_index)
    calls = spy(monkeypatch, jnative, "ego_k_hop")
    for s in range(40):
        seeds = [s, (7 * s + 3) % 395] if s % 2 else [s]
        want = jsampling.ego_k_hop(indptr, indices, seeds, depth, fanout,
                                   np.random.default_rng(s), replace)
        got = tsampling.ego_k_hop(indptr, indices, seeds, depth, fanout,
                                  np.random.default_rng(s), replace)
        np.testing.assert_array_equal(got, want)
    assert len(calls) == 40  # the JAX function took its C++ route


@pytest.mark.parametrize("depth,fanout,replace", [(1, 14, False), (2, 3, False), (2, 3, True),
                                                  (2, -1, False)])
def test_ego_k_hop_numpy_route_equals_jax(monkeypatch, depth, fanout, replace):
    """The JAX binding made to return None, as where its library is missing
    or its buffer too small: the JAX function samples in numpy, as the
    port's `ego_k_hop_numpy` does."""
    jbig, tbig = random_big_graph(400, 2500, 2)
    indptr, indices, _ = tsampling.build_csr_directed(tbig.num_nodes, tbig.edge_index)
    calls = spy(monkeypatch, jnative, "ego_k_hop", result=None)
    for s in range(30):
        seeds = [s, s + 100] if s % 3 else [s]
        want = jsampling.ego_k_hop(indptr, indices, seeds, depth, fanout,
                                   np.random.default_rng(s), replace)
        got = tsampling.ego_k_hop_numpy(indptr, indices, seeds, depth, fanout,
                                        np.random.default_rng(s), replace)
        np.testing.assert_array_equal(got, want)
    assert len(calls) == 30


def test_ego_k_hop_past_the_first_buffer_keeps_every_node():
    """fanout < 0 over a dense graph passes the binding's first buffer; the
    port samples again with room for every node (the JAX binding returns
    None there): the full 2-hop neighbourhood."""
    _, tbig = random_big_graph(120, 3000, 3, isolated=0)
    indptr, indices, _ = tsampling.build_csr_directed(tbig.num_nodes, tbig.edge_index)
    got = tsampling.ego_k_hop(indptr, indices, [0], 2, -1, np.random.default_rng(0))
    want = tsampling.ego_k_hop_numpy(indptr, indices, [0], 2, -1, np.random.default_rng(0))
    np.testing.assert_array_equal(got, want)
    assert jnative.ego_k_hop(indptr, indices, np.asarray([0]), 2, -1,
                             np.random.default_rng(0)) is None


def test_induced_subgraph_equals_jax():
    """Random node sets, sorted, of graphs with multi-edges, self loops and
    isolated nodes; with a repeated node (two equal seeds)."""
    for seed in range(4):
        jbig, tbig = random_big_graph(250, 900, 10 + seed)
        csr = tsampling.build_csr_directed(tbig.num_nodes, tbig.edge_index)
        rng = np.random.default_rng(seed)
        for k in (1, 2, 17, 80, 250):
            nodes = np.sort(rng.choice(250, size=k, replace=False)).astype(np.int64)
            cases = [nodes, np.sort(np.concatenate([nodes, nodes[:1]]))]
            for case in cases:
                want = jsampling.induced_subgraph(jbig, case)
                got = tsampling.induced_subgraph(csr, case)
                for g, w in zip(got, want):
                    assert g.dtype == w.dtype and g.shape == w.shape
                    np.testing.assert_array_equal(g, w)


def test_positive_subsets_over_a_percent_cycle():
    rng = np.random.default_rng(0)
    pos = rng.integers(0, 1000, (101, 2))
    attr = rng.integers(0, 50, (101, 2))
    for percent in (50, 30, 100):
        for epoch in range(7):
            want = jsampling.sample_pos_edges(pos, percent, epoch, 42, attr)
            got = tsampling.sample_pos_edges(pos, percent, epoch, 42, attr)
            for g, w in zip(got, want):
                np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("big", [False, True], ids=["below_1M", "above_1M"])
def test_global_negatives_equal_jax(big):
    """Below 1M distinct existing edges each draw is checked against them;
    from 1M on (a graph of 1,050,000 directed edges) only self loops go."""
    rng = np.random.default_rng(5)
    if big:
        n = 3000
        keys = rng.permutation(np.unique(rng.integers(0, n * n, 1_200_000)))[:1_050_000]
        existing = np.stack([keys // n, keys % n]).astype(np.int32)
        count = 20_000
    else:
        n = 60
        existing = rng.integers(0, n, (2, 2000)).astype(np.int32)  # dense: many hits
        count = 3000
    keys = tsampling.existing_edge_keys(n, existing)
    assert (keys[1] is None) == big
    for s in range(3):
        want = jsampling.sample_neg_edges_global(n, existing, count, np.random.default_rng(s))
        got = tsampling.sample_neg_edges_global(n, existing, count, np.random.default_rng(s),
                                                keys)
        np.testing.assert_array_equal(got, want)
    if not big:
        k = got[:, 0] * n + got[:, 1]
        assert not np.isin(k, existing[0].astype(np.int64) * n + existing[1]).any()


def test_local_negatives_with_relations_equal_jax():
    rng = np.random.default_rng(6)
    pos = rng.integers(0, 500, (80, 2))
    rel = np.stack([np.ones(80, np.int64), rng.integers(0, 12, 80)], axis=1)
    cands = np.stack([np.ones(12, np.int64), np.arange(12)], axis=1)
    for kw in (dict(), dict(sample_edges=True), dict(sample_heads=False)):
        for ratio in (1, 2):
            want = jsampling.sample_neg_edges_local(pos, 500, ratio, np.random.default_rng(1),
                                                    pos_edge_attr=rel,
                                                    neg_edge_attr_candidates=cands, **kw)
            got = tsampling.sample_neg_edges_local(pos, 500, ratio, np.random.default_rng(1),
                                                   pos_edge_attr=rel,
                                                   neg_edge_attr_candidates=cands, **kw)
            for g, w in zip(got, want):
                np.testing.assert_array_equal(g, w)


def _all_items(jds, tds, tag):
    assert len(tds) == len(jds), tag
    for i in range(len(jds)):
        assert_graphs_equal(tds[i], jds[i], f"{tag} item {i}")


@pytest.mark.parametrize("pretrain_mode", [False, True])
def test_ego_node_dataset_items_equal_jax(pretrain_mode):
    """Depth-2 ego subgraphs with a mixed (depth, fanout) list, the species
    mask over a node table with label-as-feature columns, x_mask on the
    root (fine-tune mode only), node_species riding along; two epochs."""
    jbig, tbig = random_big_graph(300, 1200, 20, node_cols=4)
    species = np.random.default_rng(0).integers(0, 3, 300).astype(np.int64)
    jbig.extra["node_species"] = tbig.extra["node_species"] = species
    x_mask = np.asarray([1, 1, 0, 1], np.int64)
    idx = np.random.default_rng(1).choice(300, 60, replace=False)
    common = dict(depth_neighbors=((2, 4), (1, 6)), sample_idx=idx, seed=3,
                  pretrain_mode=pretrain_mode, root_attr_mask=x_mask)
    jds = jsampling.EgoNodeDataset(jbig, task_mask_func=jreaders._make_species_mask_func("p"),
                                   **common)
    tds = tsampling.EgoNodeDataset(tbig, task_mask_func=treaders.SpeciesMask(), **common)
    for epoch in range(2):
        jds.reset_samples(epoch, 5)
        tds.reset_samples(epoch, 5)
        _all_items(jds, tds, f"epoch {epoch}")


EDGE_CASES = {
    "global": dict(neg_ratio=2, percent=50),
    "structured": dict(neg_edges="structured"),
    "wikikg2": dict(method="local", relations=True, sample_wgt=True, neg_edges="structured"),
    "local_edges": dict(method="local", relations=True, sample_edges=True),
    "from_edge_index": dict(pos_edges=None),
}


@pytest.mark.parametrize("pretrain_mode", [False, True])
@pytest.mark.parametrize("case", list(EDGE_CASES))
def test_ego_edge_dataset_items_equal_jax(case, pretrain_mode):
    """Every item over two epochs (reset with seed 9): global negatives at
    neg_ratio 2 over a percent-50 positive cycle, structured eval negatives
    [P, K, 2] with their groups, the wikikg2 setting (relations, local
    negatives, inverse-frequency weights), relation corruption, positives
    from edge_index; the target edge removed in fine-tune mode."""
    jbig, tbig = random_big_graph(200, 700, 30, edge_cols=2)
    rng = np.random.default_rng(4)
    kw = dict(EDGE_CASES[case])
    relations = kw.pop("relations", False)
    pos = jbig.edge_index[:, jbig.edge_index[0] < jbig.edge_index[1]].T[:40].astype(np.int64)
    kw.setdefault("pos_edges", pos)
    if kw.get("neg_edges") == "structured":
        kw["neg_edges"] = np.stack([np.repeat(pos[:, :1], 3, 1),
                                    rng.integers(0, 200, (40, 3))], axis=2)
    if relations:
        rel = rng.integers(0, 6, 40)
        kw["pos_edge_attr"] = np.stack([np.ones_like(rel), rel], axis=1)
        kw["neg_edge_attr_candidates"] = np.stack([np.ones(6, np.int64), np.arange(6)], 1)
    common = dict(depth_neighbors=((1, 5),), seed=11, pretrain_mode=pretrain_mode, **kw)
    jds = jsampling.EgoEdgeDataset(jbig, **common)
    tds = tsampling.EgoEdgeDataset(tbig, **common)
    for epoch in range(2):
        if epoch:
            jds.reset_samples(epoch, 9)
            tds.reset_samples(epoch, 9)
        np.testing.assert_array_equal(tds.edges_with_y, jds.edges_with_y)
        for name in ("wgt", "group_idx", "all_edge_attr"):
            a, b = getattr(tds, name), getattr(jds, name)
            assert (a is None) == (b is None), name
            if a is not None:
                assert a.dtype == b.dtype
                np.testing.assert_array_equal(a, b)
        _all_items(jds, tds, f"{case} epoch {epoch}")
    if case == "wikikg2" and not pretrain_mode:
        assert tds.wgt is not None and len(np.unique(tds.wgt)) > 1


@pytest.mark.parametrize("kind", ["nodes", "edges"])
def test_random_subgraph_datasets_equal_jax(kind):
    jbig, tbig = random_big_graph(150, 600, 40)
    cls = "RandomNodesDataset" if kind == "nodes" else "RandomEdgesDataset"
    jds = getattr(jpartition, cls)(jbig, 25, 12, seed=2)
    tds = getattr(tpartition, cls)(tbig, 25, 12, seed=2)
    for epoch in range(2):
        jds.reset_samples(epoch)
        tds.reset_samples(epoch)
        _all_items(jds, tds, f"{kind} epoch {epoch}")
    jens = jpartition.EnsembleDataset([jpartition.RandomNodesDataset(jbig, 10, 5, seed=1), jds])
    tens = tpartition.EnsembleDataset([tpartition.RandomNodesDataset(tbig, 10, 5, seed=1), tds])
    jens.reset_samples(1, 3)
    tens.reset_samples(1, 3)
    _all_items(jens, tens, f"{kind} ensemble")
