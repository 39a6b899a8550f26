"""The port's graph-level readers against the JAX package's, on the CPU.

Each test writes its own stores in the readers' npz contract: random
molecules in PCQM4M-v2's schema (9 node and 3 edge columns) for pcqm4m-v2
and ogbg-molpcba (128 labels with gaps), attribute-free threads for
reddit_threads and one node column for spice-circuit, each with a
single-node, an edge-free and a disconnected graph, as
`tests/test_partition_readers.py` writes them. The stores, graphs, node
permutations, split policies, auxiliary corpora, position bounds and index
samplers are numpy on both sides, so they must be equal bit for bit; so
must the tokenizer's rows and the scanned vocab under both packages'
default (C++) walks. Last, a spawned worker pool over two epochs gives the
in-process loader's batches bit for bit, its node permutations following
the dataset's epoch, and closing the pool mid-pass ends its workers.
"""

import os
import pickle

import numpy as np
import pytest

from graphgpt_tpu import config as jconfig
from graphgpt_tpu import readers as jreaders
from graphgpt_tpu.data import datasets as jdatasets
from graphgpt_tpu.data import graph as jgraph
from graphgpt_tpu.data import mol3d as jmol3d
from graphgpt_tpu.training import pipeline as jpipeline
from graphgpt_torch import config as tconfig
from graphgpt_torch import readers as treaders
from graphgpt_torch.data import datasets as tdatasets
from graphgpt_torch.data import graph as tgraph
from graphgpt_torch.data import mol3d as tmol3d
from graphgpt_torch.data.loader import GraphTokenLoader
from graphgpt_torch.training import pipeline as tpipeline
from test_torch_jax_native import jax_native_library  # noqa: F401  (autouse: JAX's C++ library)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# name -> (node columns' cardinalities, edge columns', labels, label kind)
SCHEMAS = {
    "pcqm4m-v2": (tdatasets.MOL_NODE_CARD, tdatasets.MOL_EDGE_CARD, 1, "float"),
    "ogbg-molpcba": (tdatasets.MOL_NODE_CARD, tdatasets.MOL_EDGE_CARD, 128, "binary-nan"),
    "reddit_threads": ((), (), 1, "class2"),
    "spice-circuit": ((20,), (), 1, "class14"),
}
# the nine graph-level configs and the dataset each reads
CONFIGS = {
    "pcqm4m_v2_pretrain": "pcqm4m-v2", "pcqm4m_v2_pretrain_long": "pcqm4m-v2",
    "pcqm4m_v2_supervised": "pcqm4m-v2", "ogbg_molpcba_pretrain": "ogbg-molpcba",
    "ogbg_molpcba_supervised": "ogbg-molpcba", "reddit_pretrain": "reddit_threads",
    "reddit_supervised": "reddit_threads", "spice_circuit_pretrain": "spice-circuit",
    "spice_circuit_supervised": "spice-circuit",
}


def write_store(path, name="pcqm4m-v2", n_graphs=48, seed=0, splits=(32, 8, 8), pos=False,
                y_cols=None, compressed=False, attr_dtype=np.int32, edge_free=True):
    """A graphs.npz of `n_graphs` in `name`'s schema: graph 1 has one node,
    2 four nodes and no edge (unless not `edge_free`), 3 two 2-cliques; the
    rest are random molecules (spanning tree + extra edges, both
    directions). Splits are the first `splits[0]`, the next `splits[1]` and
    the next `splits[2]` graphs; None writes no split."""
    node_card, edge_card, n_labels, kind = SCHEMAS[name]
    n_labels = y_cols or n_labels
    rng = np.random.default_rng(seed)
    cols = {k: [] for k in ("node_attr", "edge_attr", "edge_index", "pos")}
    node_ptr, edge_ptr = [0], [0]
    for g in range(n_graphs):
        if g == 1:
            n, ei = 1, np.zeros((2, 0), np.int64)
        elif g == 2 and edge_free:
            n, ei = 4, np.zeros((2, 0), np.int64)
        elif g == 3:
            n, ei = 4, np.asarray([[0, 1, 2, 3], [1, 0, 3, 2]], np.int64)
        else:
            mol = tdatasets.random_molecule_graph(rng, 2, 30)
            n, ei = mol.num_nodes, mol.edge_index.astype(np.int64)
        cols["node_attr"].append(np.stack([rng.integers(0, c, size=n) for c in node_card], 1)
                                 if node_card else np.zeros((n, 0), np.int64))
        e = ei.shape[1]
        cols["edge_attr"].append(np.stack([rng.integers(0, c, size=e) for c in edge_card], 1)
                                 if edge_card else np.zeros((e, 0), np.int64))
        cols["edge_index"].append(ei + node_ptr[-1])
        cols["pos"].append(rng.normal(size=(n, 3)) * 3)
        node_ptr.append(node_ptr[-1] + n)
        edge_ptr.append(edge_ptr[-1] + e)
    if kind == "float":
        y = rng.normal(5.0, 1.0, size=(n_graphs, n_labels))
    elif kind == "binary-nan":
        y = rng.integers(0, 2, size=(n_graphs, n_labels)).astype(np.float64)
        y[rng.random(y.shape) < 0.3] = np.nan
    else:
        y = rng.integers(0, int(kind[5:]), size=(n_graphs, n_labels)).astype(np.float64)
    data = dict(
        edge_index=np.concatenate(cols["edge_index"], axis=1).astype(np.int32),
        node_ptr=np.asarray(node_ptr, np.int64),
        edge_ptr=np.asarray(edge_ptr, np.int64),
        y=y.astype(np.float32),
    )
    if node_card:
        data["node_attr"] = np.concatenate(cols["node_attr"]).astype(attr_dtype)
    if edge_card:
        data["edge_attr"] = np.concatenate(cols["edge_attr"]).astype(attr_dtype)
    if pos:
        data["pos"] = np.concatenate(cols["pos"]).astype(np.float32)
    if splits is not None:
        a, b, c = splits
        data.update(train_idx=np.arange(0, a), valid_idx=np.arange(a, a + b),
                    test_idx=np.arange(a + b, a + b + c))
    os.makedirs(os.path.dirname(str(path)), exist_ok=True)
    (np.savez_compressed if compressed else np.savez)(path, **data)
    return str(path)


def cfg_pair(data_dir, name, seed=0, **policy):
    """The JAX package's and the port's Config reading `name` from data_dir."""
    out = []
    for mod in (jconfig, tconfig):
        cfg = mod.Config()
        cfg.tokenization.dataset, cfg.tokenization.data_dir = name, str(data_dir)
        cfg.tokenization.dataset_policy = dict(policy)
        cfg.training.seed = seed
        out.append(cfg)
    return out


def assert_graphs_equal(got, want, tag=""):
    for f in ("num_nodes", "idx", "wgt"):
        assert getattr(got, f) == getattr(want, f), (tag, f)
    for f in ("edge_index", "node_attr", "edge_attr", "y", "pos", "node_embed", "root_n_id",
              "tgt_edge_attr"):
        a, b = getattr(got, f), getattr(want, f)
        assert (a is None) == (b is None), (tag, f)
        if a is not None:
            a, b = np.asarray(a), np.asarray(b)
            assert a.dtype == b.dtype and a.shape == b.shape, (tag, f, a.dtype, b.dtype)
            np.testing.assert_array_equal(a, b, err_msg=f"{tag} {f}")
    assert sorted(got.extra) == sorted(want.extra), tag
    for k in want.extra:
        np.testing.assert_array_equal(np.asarray(got.extra[k]), np.asarray(want.extra[k]))


def assert_splits_equal(got, want):
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        g, w = np.asarray(g), np.asarray(w)
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g, w)


def _read_both(data_dir, name, **policy):
    jcfg, tcfg = cfg_pair(data_dir, name, **policy)
    return jreaders.read_dataset(name, jcfg), treaders.read_dataset(name, tcfg)


@pytest.mark.parametrize("name", list(SCHEMAS))
def test_stores_graphs_and_permutations_equal_jax(tmp_path, name):
    """Every graph of the store, of the map dataset with its permutation at
    epochs 0 and 1, and the splits, bit for bit; a compressed store and
    64-bit attributes (read and converted, not mapped) too."""
    for variant, kw in (("", {}), ("-packed", dict(compressed=True, attr_dtype=np.int64))):
        d = tmp_path / variant
        write_store(d / name / "graphs.npz", name, pos=True, **kw)
        jds, tds = _read_both(d, name)
        js, ts = jds.store, tds.store
        for attr in ("_node_ptr", "_edge_ptr", "edge_index", "node_attr", "edge_attr", "_ys",
                     "_pos", "_a2d", "_a2d_ptr", "_key_type"):
            a, b = getattr(ts, attr), getattr(js, attr)
            assert (a is None) == (b is None), attr
            if a is not None:
                assert a.dtype == b.dtype, attr
                np.testing.assert_array_equal(a, b)
        assert isinstance(ts.edge_index, np.memmap) != bool(variant)
        assert len(tds) == len(jds) == 48
        for i in range(len(js)):
            assert_graphs_equal(ts.get(i), js.get(i), f"{name} store {i}")
        for epoch in (0, 1):
            jds.reset_samples(epoch, 0)
            tds.reset_samples(epoch, 0)
            for i in range(len(jds)):
                assert_graphs_equal(tds[i], jds[i], f"{name} epoch {epoch} graph {i}")
        assert_splits_equal(tds.splits(), jds.splits())
    # no split in the file: the random 80/10/10 fallback
    write_store(tmp_path / "nosplit" / name / "graphs.npz", name, splits=None)
    jds, tds = _read_both(tmp_path / "nosplit", name)
    assert_splits_equal(tds.splits(), jds.splits())


def test_permute_nodes_equals_jax():
    """Node-aligned arrays reordered, edge ids, a2d ids and root ids
    remapped, node-level y permuted, graph-level y kept."""
    rng = np.random.default_rng(0)
    for n, node_y in ((7, True), (12, False), (1, False)):
        ei = rng.integers(0, n, size=(2, 3 * n)).astype(np.int32)
        kw = dict(num_nodes=n, edge_index=ei,
                  node_attr=rng.integers(0, 9, size=(n, 3)).astype(np.int32),
                  edge_attr=rng.integers(0, 5, size=(3 * n, 2)).astype(np.int32),
                  y=rng.normal(size=n if node_y else 2).astype(np.float32),
                  pos=rng.normal(size=(n, 3)).astype(np.float32),
                  node_embed=rng.normal(size=(n, 4)).astype(np.float32),
                  root_n_id=np.asarray([0, n - 1]), tgt_edge_attr=np.asarray([1, 2]),
                  wgt=0.5, idx=3)
        extra = {"a2d": rng.integers(0, n, size=(4, 2)), "key_type": np.asarray(1)}
        jg = jgraph.Graph(**kw, extra=dict(extra))
        tg = tgraph.Graph(**kw, extra=dict(extra))
        for seed in range(3):
            assert_graphs_equal(tg.permute_nodes(np.random.default_rng(seed)),
                                jg.permute_nodes(np.random.default_rng(seed)), f"n {n}")


def test_graph_batch_store_collate_equals_jax():
    """Collated from a list: global edge ids (graph i's offset by
    node_ptr[i]), and get() with the a2d and key_type columns."""
    rng = np.random.default_rng(1)
    graphs = [jdatasets.random_molecule_graph(rng, 1, 12, with_pos=True) for _ in range(9)]
    a2d_ptr = np.concatenate([[0], np.cumsum([g.num_nodes // 2 for g in graphs])])
    a2d = np.concatenate([rng.integers(0, g.num_nodes, size=(g.num_nodes // 2, 2))
                          for g in graphs]).astype(np.int64)
    key_type = rng.integers(0, 3, size=len(graphs))
    stores = []
    for mod in (tgraph, jgraph):
        s = mod.GraphBatchStore([mod.Graph(**{k: v for k, v in vars(g).items()}) for g in graphs])
        s._a2d, s._a2d_ptr, s._key_type = a2d, a2d_ptr, key_type
        stores.append(s)
    ts, js = stores
    np.testing.assert_array_equal(ts.edge_index, js.edge_index)
    assert ts.edge_index.max() == sum(g.num_nodes for g in graphs) - 1  # global ids
    for i in range(len(graphs)):
        got = ts.get(i)
        assert_graphs_equal(got, js.get(i), f"graph {i}")
        np.testing.assert_array_equal(got.edge_index, graphs[i].edge_index)
    assert len(tgraph.GraphBatchStore([])) == len(jgraph.GraphBatchStore([])) == 0


def test_a_store_pickles_as_its_path(tmp_path):
    """A pickled store is a few hundred bytes; the reopened one maps the
    same file and gives the same arrays, with the splits a policy rewrote
    and a y column rewritten after loading."""
    path = write_store(tmp_path / "pcqm4m-v2" / "graphs.npz", n_graphs=200,
                       splits=(150, 30, 20))
    store = treaders.NpzGraphStore(path)
    blob = pickle.dumps(store)
    assert len(blob) < 1000 and path.encode() in blob
    back = pickle.loads(blob)
    assert isinstance(back.edge_index, np.memmap)
    for attr in ("_node_ptr", "_edge_ptr", "edge_index", "node_attr", "edge_attr", "_ys"):
        np.testing.assert_array_equal(getattr(back, attr), getattr(store, attr))
    assert sorted(back.splits) == ["test", "train", "valid"]
    store.splits["train"] = store.splits["train"][::2]
    store.splits.pop("test")
    store._ys = store._ys * 2
    back = pickle.loads(pickle.dumps(store))
    assert sorted(back.splits) == ["train", "valid"]
    np.testing.assert_array_equal(back.splits["train"], np.arange(0, 150, 2))
    np.testing.assert_array_equal(back.splits["valid"], np.arange(150, 180))
    np.testing.assert_array_equal(back._ys, store._ys)
    # a reader's dataset with rewritten splits, as a worker unpickles it
    jcfg, tcfg = cfg_pair(tmp_path, "pcqm4m-v2", true_valid=True, num_remained=10)
    ds = pickle.loads(pickle.dumps(treaders.read_dataset("pcqm4m-v2", tcfg)))
    assert_splits_equal(ds.splits(), jreaders.read_dataset("pcqm4m-v2", jcfg).splits())


POLICIES = {
    "remove_special": dict(remove_special=True),
    "edge0": dict(remove_special={"edge0": True}),
    "node1": dict(remove_special={"node1": True}),
    "node2": dict(remove_special={"node2": True}),
    "disconnected": dict(remove_special={"disconnected": True}),
    "all_flags_true_valid": dict(remove_special={"edge0": True, "node1": True, "node2": True,
                                                 "disconnected": True},
                                 true_valid=True, num_remained=20),
    "true_valid": dict(true_valid=True, num_remained=25),
    "test_large": dict(test_large=True, large_threshold=12),
    "test_large_default": dict(test_large=True),
    "duplicate_train": dict(duplicate_train=3),
    "everything": dict(remove_special=True, true_valid=True, num_remained=30, test_large=True,
                       duplicate_train=2),
}


@pytest.mark.parametrize("policy", list(POLICIES))
def test_split_policies_equal_jax(tmp_path, policy):
    write_store(tmp_path / "pcqm4m-v2" / "graphs.npz", n_graphs=160, splits=(100, 40, 20))
    jds, tds = _read_both(tmp_path, "pcqm4m-v2", **POLICIES[policy])
    assert_splits_equal(tds.splits(), jds.splits())
    assert_splits_equal(
        treaders.apply_split_policies(tds.store, [np.arange(100), np.arange(100, 140),
                                                  np.arange(140, 160)], POLICIES[policy]),
        jreaders.apply_split_policies(jds.store, [np.arange(100), np.arange(100, 140),
                                                  np.arange(140, 160)], POLICIES[policy]))
    for kw in ({"edge0": True, "node1": True, "node2": True, "disconnected": True}, {}):
        np.testing.assert_array_equal(treaders._special_molecule_idx(tds.store, **kw),
                                      jreaders._special_molecule_idx(jds.store, **kw))


def test_aux_corpora_ensemble_equals_jax(tmp_path):
    """CEPDB and ZINC appended to the train split only, their y column
    picked with the gaps zeroed, each graph with its idx_of_ds."""
    write_store(tmp_path / "pcqm4m-v2" / "graphs.npz", n_graphs=40, splits=(24, 8, 8))
    for k, aux in enumerate(("CEPDB", "ZINC")):
        write_store(tmp_path / aux / "graphs.npz", "ogbg-molpcba", n_graphs=12 + 4 * k,
                    seed=7 + k, y_cols=6, splits=None)
    jds, tds = _read_both(tmp_path, "pcqm4m-v2", add_cepdb=True, add_zinc=True)
    assert isinstance(tds, treaders.EnsembleSplitDataset)
    assert len(tds) == len(jds) == 40 + 12 + 16
    assert_splits_equal(tds.splits(), jds.splits())
    for epoch in (0, 2):
        jds.reset_samples(epoch, 0)
        tds.reset_samples(epoch, 0)
        assert tds.epoch == epoch
        for i in range(len(jds)):
            assert_graphs_equal(tds[i], jds[i], f"epoch {epoch} graph {i}")
    assert {int(tds[i].extra["idx_of_ds"]) for i in (0, 45, 60)} == {0, 1, 2}
    assert not np.isnan(tds.datasets[1].store._ys).any()


def test_position_bounds_and_their_cache_equal_jax(tmp_path):
    """pos_percentile_bounds: the four bin counts' boundaries, cached as npz
    beside the store under the JAX package's names, read back from there."""
    dirs = []
    for tag in ("jax", "port"):
        write_store(tmp_path / tag / "pcqm4m-v2" / "graphs.npz", n_graphs=60, pos=True)
        dirs.append(tmp_path / tag)
    jcfg, _ = cfg_pair(dirs[0], "pcqm4m-v2", pos_percentile_bounds=True)
    _, tcfg = cfg_pair(dirs[1], "pcqm4m-v2", pos_percentile_bounds=True)
    want = jreaders.read_dataset("pcqm4m-v2", jcfg).dict_bounds
    got = treaders.read_dataset("pcqm4m-v2", tcfg).dict_bounds
    assert sorted(got) == sorted(want) == [128, 256, 512, 1024]
    for k in want:
        assert got[k].dtype == want[k].dtype
        np.testing.assert_array_equal(got[k], want[k])
    names = sorted(os.listdir(dirs[1] / "pcqm4m-v2"))
    assert names == sorted(os.listdir(dirs[0] / "pcqm4m-v2"))
    assert "pos_1024percentile_eps0.0001_boundaries.npz" in names
    for n in names:
        if n != "graphs.npz":
            np.testing.assert_array_equal(np.load(dirs[1] / "pcqm4m-v2" / n)["boundaries"],
                                          np.load(dirs[0] / "pcqm4m-v2" / n)["boundaries"])
    # a cache file is read, not recomputed
    np.savez(dirs[1] / "pcqm4m-v2" / "pos_128percentile_eps0.0001_boundaries.npz",
             boundaries=np.arange(129, dtype=np.float32))
    again = tmol3d.build_dict_bounds(np.zeros((5, 3)), cache_dir=str(dirs[1] / "pcqm4m-v2"))
    np.testing.assert_array_equal(again[128], np.arange(129))
    pos = np.random.default_rng(0).normal(size=(500, 3))
    for k, v in jmol3d.build_dict_bounds(pos).items():
        np.testing.assert_array_equal(tmol3d.build_dict_bounds(pos)[k], v)


def test_index_samplers_equal_jax(tmp_path):
    write_store(tmp_path / "g.npz", n_graphs=120)
    js, ts = jreaders.NpzGraphStore(str(tmp_path / "g.npz")), treaders.NpzGraphStore(
        str(tmp_path / "g.npz"))
    train, target = np.arange(0, 90), np.arange(90, 120)
    for seed in range(3):
        for fn, args in (("size_weighted_indices", (train, 50)),
                         ("shift_distribution_indices", (train, target, 70))):
            want = getattr(jdatasets, fn)(js, *args, np.random.default_rng(seed))
            got = getattr(tdatasets, fn)(ts, *args, np.random.default_rng(seed))
            np.testing.assert_array_equal(got, want)
        for rank, world in ((0, 1), (1, 3), (2, 4)):
            np.testing.assert_array_equal(tdatasets.strided_shard(train, rank, world),
                                          jdatasets.strided_shard(train, rank, world))
            np.testing.assert_array_equal(
                tdatasets.epoch_shuffled_indices(50, seed, 7, rank, world),
                jdatasets.epoch_shuffled_indices(50, seed, 7, rank, world))


def test_missing_stores_and_big_graph_names_raise(tmp_path):
    """A missing store raises, graph-level or big-graph; structure_er needs
    no store (its graphs are seeded: tests/test_torch_gst_tokenizer.py
    holds them to JAX); the eight OGB edge- and node-level names read their
    big_graph.npz (tests/test_torch_big_graph.py holds them to JAX)."""
    from test_torch_big_graph import EDGE_LEVEL, NODE_LEVEL, write_big_store

    _, tcfg = cfg_pair(tmp_path, "pcqm4m-v2")
    with pytest.raises(FileNotFoundError, match="graphs.npz"):
        treaders.read_dataset("pcqm4m-v2", tcfg)
    tcfg.tokenization.dataset = "structure_er"
    ds = tpipeline.build_dataset(tcfg)
    assert len(ds) == 20000 and ds[0].num_nodes >= 8 and ds[0].node_attr is None
    for name in EDGE_LEVEL + NODE_LEVEL:
        tcfg.tokenization.dataset = name
        with pytest.raises(FileNotFoundError, match="big_graph.npz"):
            tpipeline.build_dataset(tcfg)
        write_big_store(tmp_path, name, n=60, m=150)
        ds = tpipeline.build_dataset(tcfg)
        assert len(ds) > 0 and ds[0].num_nodes >= 1 and ds.big.num_nodes == 60
    with pytest.raises(KeyError):
        treaders.read_dataset("no-such-set", tcfg)


@pytest.mark.parametrize("config", list(CONFIGS))
def test_the_nine_graph_level_configs_read_and_tokenize_as_jax(tmp_path, config):
    """Each graph-level config as shipped, its data_dir pointed at a store in
    its dataset's schema: `build_dataset` gives the JAX reader's graphs and
    splits, `build_tokenizer` writes the same scanned vocab file, and the
    tokenizer's rows under both default (C++) walks are the same."""
    name = CONFIGS[config]
    write_store(tmp_path / "data" / name / "graphs.npz", name, n_graphs=40, splits=(28, 6, 6))
    path = os.path.join(ROOT, "configs", f"{config}.yaml")
    over = [f"tokenization.data_dir={tmp_path / 'data'}"]
    jcfg = jconfig.load_config(path, over + [f"training.output_dir={tmp_path / 'jax'}"])
    tcfg = tconfig.load_config(path, over + [f"training.output_dir={tmp_path / 'port'}"])
    jds, tds = jpipeline.build_dataset(jcfg), tpipeline.build_dataset(tcfg)
    assert_splits_equal(tds.splits(), jds.splits())
    for i in range(len(jds)):
        assert_graphs_equal(tds[i], jds[i], f"{config} graph {i}")
    jtok, ttok = jpipeline.build_tokenizer(jcfg, jds), tpipeline.build_tokenizer(tcfg, tds)
    vocab = tcfg.tokenization.vocab_file
    with open(tmp_path / "jax" / vocab) as f, open(tmp_path / "port" / vocab) as g:
        assert g.read() == f.read()
    for i in range(len(jds)):
        got = ttok(tds[i], np.random.default_rng((1, i)))
        if ttok.edge_dim and jds[i].num_edges == 0 and jds[i].num_nodes > 1:
            # repair: an edge-free graph of several nodes walks by jumps only;
            # the JAX tokenizer indexes its empty edge_attr and raises, the
            # port gives each jump the default edge ids
            with pytest.raises(IndexError):
                jtok(jds[i], np.random.default_rng((1, i)))
            ids, walk, _ = ttok.tokenize(tds[i], np.random.default_rng((1, i)))
            assert len(walk) == jds[i].num_nodes and got.seq_len > len(walk)
            np.testing.assert_array_equal(ids[: len(walk), -ttok.edge_dim:],
                                          np.tile(ttok.edge_lookup.default_ids, (len(walk), 1)))
            continue
        want = jtok(jds[i], np.random.default_rng((1, i)))
        for key in ("input_ids", "labels", "position_ids", "attention_mask", "graph_labels",
                    "wgt"):
            a, b = getattr(got, key), getattr(want, key)
            assert (a is None) == (b is None), key
            if a is not None:
                np.testing.assert_array_equal(np.asarray(a), np.asarray(b), err_msg=key)


def _epoch_batches(loader, ds, idx, epoch):
    ds.reset_samples(epoch, 0)
    return [b.data for b in loader.epoch_batches(idx, epoch=0)]


def test_a_spawned_pool_follows_the_epoch(tmp_path):
    """Two epochs of the reader's dataset through a 2-worker spawned pool
    (workers unpickle the store by its path, the library built once in the
    parent) give the in-process loader's batches bit for bit; the loader's
    own epoch is held at 0, so only the dataset's epoch (its node
    permutations) moves the rows."""
    write_store(tmp_path / "pcqm4m-v2" / "graphs.npz", n_graphs=96, splits=(64, 16, 16))
    _, tcfg = cfg_pair(tmp_path, "pcqm4m-v2")
    tcfg.training.output_dir = str(tmp_path / "out")
    ds = tpipeline.build_dataset(tcfg)
    tok = tpipeline.build_tokenizer(tcfg, ds)
    idx = ds.splits()[0]
    kw = dict(batch_size=8, mpe=256)
    inproc = GraphTokenLoader(ds, tok, num_workers=0, **kw)
    want = [_epoch_batches(inproc, ds, idx, e) for e in (0, 1)]
    ds.reset_samples(0, 0)
    pool = GraphTokenLoader(ds, tok, num_workers=2, **kw).start()
    try:
        got = [_epoch_batches(pool, ds, idx, e) for e in (0, 1)]
        got.append(_epoch_batches(pool, ds, idx, 0))  # and back
        left = pool.epoch_batches(idx)  # a pass left early: chunks in flight
        next(left)
        workers = list(pool._pool._pool)
    finally:
        pool.close()
    # the workers finished their chunks and exited
    assert all(w.exitcode is not None for w in workers) and pool._pool is None
    for e, (g_ep, w_ep) in enumerate(zip(got, want + want[:1])):
        assert len(g_ep) == len(w_ep) == 8
        for g, w in zip(g_ep, w_ep):
            assert sorted(g) == sorted(w)
            for k in w:
                np.testing.assert_array_equal(g[k], w[k], err_msg=f"epoch {e} {k}")
    assert any(not np.array_equal(a["input_ids"], b["input_ids"])
               for a, b in zip(want[0], want[1]))
