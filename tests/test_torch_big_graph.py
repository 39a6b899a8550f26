"""The port's big-graph readers, vocab, long stacking and loader against
the JAX package's on small stores in the npz contract, on the CPU with
both packages' default (C++) samplers and walks.

- The eight edge- and node-level readers: every item of every split's
  dataset (and the pretrain-mode ensembles) over two epochs, bit for bit.
- A reader's dataset pickles as its path and state: small, and equal item
  for item after unpickling, also past a reset.
- The big-graph vocab from the full attribute tables against JAX
  `build_tokenizer`, the vocab files byte for byte.
- `StackedGSTTokenizerLong` rows (node, edge and pretrain-mlm) bit for bit.
- The loader's batches with 0 and 2 spawned workers across two epochs,
  bit for bit with each other and with the JAX loader (0 workers): the
  workers follow the dataset's reset seed, not only its epoch; the file
  that carries the dataset to them goes also when the loader is not closed.
"""

import os
import pickle
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from graphgpt_tpu import config as jconfig
from graphgpt_tpu import readers as jreaders
from graphgpt_tpu.data import loader as jloader
from graphgpt_tpu.data import tokenizer as jtok
from graphgpt_tpu.training import pipeline as jpipeline
from graphgpt_torch import config as tconfig
from graphgpt_torch import readers as treaders
from graphgpt_torch.data import loader as tloader
from graphgpt_torch.data import tokenizer as ttok
from graphgpt_torch.training import pipeline as tpipeline
from test_torch_readers import assert_graphs_equal
from test_torch_jax_native import jax_native_library  # noqa: F401  (autouse: JAX's C++ library)

EDGE_LEVEL = ("ogbl-ppa", "ogbl-citation2", "ogbl-ddi", "ogbl-wikikg2")
NODE_LEVEL = ("ogbn-products", "ogbn-arxiv", "ogbn-papers100M", "ogbn-proteins")
SPECIES = np.asarray([3702, 4932, 6239, 7227, 9606])


def write_big_store(data_dir, name, n=150, m=520, seed=0):
    """<data_dir>/<name>/big_graph.npz in the schema `tools/convert_ogb.py`
    writes for `name`: m distinct undirected edges (70/20/10 into train,
    valid, test; the graph holds the train edges in both directions, as
    OGB's does), the dataset's node table, eval negatives and labels."""
    rng = np.random.default_rng(seed)
    a, b = rng.integers(0, n - 3, 4 * m), rng.integers(0, n - 3, 4 * m)  # 3 isolated nodes
    keys = np.unique(np.minimum(a, b)[a != b] * n + np.maximum(a, b)[a != b])
    edges = rng.permutation(np.stack([keys // n, keys % n], axis=1))[:m].astype(np.int64)
    n_tr, n_va = int(0.7 * m), int(0.2 * m)
    train, valid, test = edges[:n_tr], edges[n_tr:n_tr + n_va], edges[n_tr + n_va:]
    ei = np.concatenate([train, train[:, ::-1]]).T.astype(np.int32)
    data = dict(edge_index=ei, num_nodes=np.int64(n))
    if name in EDGE_LEVEL:
        for split, pos in (("train", train), ("valid", valid), ("test", test)):
            data[f"{split}_edge"] = pos
            if split == "train":
                continue
            if name in ("ogbl-citation2", "ogbl-wikikg2"):  # structured [P, K, 2]
                data[f"{split}_edge_neg"] = np.stack(
                    [np.repeat(pos[:, :1], 4, 1), rng.integers(0, n, (len(pos), 4))], axis=2)
            else:
                data[f"{split}_edge_neg"] = rng.integers(0, n, (len(pos), 2))
            if name == "ogbl-wikikg2":
                data[f"{split}_relation"] = rng.integers(0, 7, len(pos))
        if name == "ogbl-wikikg2":
            data["train_relation"] = rng.integers(0, 7, len(train))
        if name == "ogbl-ppa":  # [global id, species]
            data["node_attr"] = np.stack([np.arange(n), rng.integers(0, 6, n)], 1)
        elif name == "ogbl-citation2":
            data["node_attr"] = rng.integers(0, 9, (n, 2))
        elif name == "ogbl-wikikg2":
            data["node_attr"] = rng.integers(0, 5, (n, 1))
    else:
        order = rng.permutation(n)
        data.update(train_idx=order[:90], valid_idx=order[90:120], test_idx=order[120:])
        if name == "ogbn-proteins":
            species = SPECIES[rng.integers(0, len(SPECIES), n)]
            local = np.zeros(n, np.int64)
            for s in SPECIES:
                local[species == s] = np.arange(1, (species == s).sum() + 1)
            data["node_attr"] = np.stack([species, local], 1)
            data["node_species"] = species
            e_attr = rng.integers(0, 1000, (ei.shape[1] // 2, 8))
            data["edge_attr"] = np.concatenate([e_attr, e_attr])
            data["y"] = rng.integers(0, 2, (n, 112))
            data["x_mask"] = np.ones(2, np.int64)
        else:
            data["node_attr"] = rng.integers(0, 11, (n, 2))
            data["y"] = (rng.normal(size=(n, 1)).astype(np.float32) if name == "ogbn-papers100M"
                         else rng.integers(0, 5, (n, 1)))
    for k in ("node_attr", "edge_attr"):
        if k in data:
            data[k] = data[k].astype(np.int32)
    path = os.path.join(str(data_dir), name, "big_graph.npz")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    np.savez(path, **data)
    return path


SEMANTICS = {  # (node dim, edge dim) of the dataset's shipped config
    "ogbl-ppa": (2, 0), "ogbl-citation2": (2, 0), "ogbl-ddi": (0, 0), "ogbl-wikikg2": (1, 0),
    "ogbn-products": (2, 0), "ogbn-arxiv": (2, 0), "ogbn-papers100M": (2, 0),
    "ogbn-proteins": (2, 8),
}


def cfg_pair(data_dir, name, out=None, task="node", stack="short", seed=7):
    """The JAX package's and the port's Config over the store of `name`."""
    cfgs = []
    for tag, mod in (("jax", jconfig), ("port", tconfig)):
        cfg = mod.Config()
        tok = cfg.tokenization
        tok.dataset, tok.data_dir, tok.stack_method = name, str(data_dir), stack
        tok.attr_world_identifier = name
        dn, de = SEMANTICS[name]
        tok.semantics.node.discrete, tok.semantics.node.dim = ("node_attr" if dn else None), dn
        tok.semantics.edge.discrete, tok.semantics.edge.dim = ("edge_attr" if de else None), de
        cfg.training.seed, cfg.training.task_type = seed, task
        if out is not None:
            cfg.training.output_dir = os.path.join(str(out), tag)
            os.makedirs(cfg.training.output_dir, exist_ok=True)
        cfgs.append(cfg)
    return cfgs


def assert_datasets_equal(tds, jds, tag):
    assert len(tds) == len(jds), tag
    for name in ("edges_with_y", "wgt", "group_idx", "all_edge_attr", "sample_idx"):
        a, b = getattr(tds, name, None), getattr(jds, name, None)
        assert (a is None) == (b is None), (tag, name)
        if a is not None:
            np.testing.assert_array_equal(a, b, err_msg=f"{tag} {name}")
    for i in range(len(jds)):
        assert_graphs_equal(tds[i], jds[i], f"{tag} item {i}")


@pytest.mark.parametrize("name", EDGE_LEVEL + NODE_LEVEL)
def test_the_eight_readers_equal_jax(tmp_path, name):
    """Each split (and the train split in pretrain mode, the node readers'
    ensemble with random-edge subgraphs) at epoch 0 and after a reset to
    epoch 1 with the training seed; the CSR cache written beside the store
    and read back."""
    write_big_store(tmp_path, name)
    jcfg, tcfg = cfg_pair(tmp_path, name)
    for split, pretrain in (("train", False), ("valid", False), ("test", False),
                            ("train", True)):
        jds = jreaders.read_dataset(name, jcfg, data_split=split, pretrain_mode=pretrain)
        tds = treaders.read_dataset(name, tcfg, data_split=split, pretrain_mode=pretrain)
        for epoch in range(2):
            if epoch:
                jds.reset_samples(epoch, 7)
                tds.reset_samples(epoch, 7)
            assert_datasets_equal(tds, jds, f"{name} {split} pretrain={pretrain} epoch {epoch}")
    assert os.path.exists(tmp_path / name / "big_graph.csr.npz")
    again = treaders.read_dataset(name, tcfg)
    inner = again.datasets[0] if hasattr(again, "datasets") else again
    assert all(isinstance(a, np.memmap) for a in inner.csr)
    assert isinstance(inner.big.edge_index, np.memmap)


@pytest.mark.parametrize("name", ["ogbl-ppa", "ogbn-proteins"])
def test_a_reader_dataset_pickles_as_its_path_and_state(tmp_path, name):
    write_big_store(tmp_path, name, n=400, m=2000)
    _, tcfg = cfg_pair(tmp_path, name, seed=3)
    ds = treaders.read_dataset(name, tcfg)
    ds.reset_samples(1, 9)
    raw = pickle.dumps(ds)
    # no array of the store goes along; the sorted keys of the existing
    # edges do below 1M of them (global negatives are checked against them)
    keys = getattr(ds, "_neg_keys", None)
    assert len(raw) - (0 if keys is None else keys[1].nbytes) < 4096, len(raw)
    back = pickle.loads(raw)
    assert (back.epoch, back.reset_seed) == (1, 9)
    assert_datasets_equal(back, ds, f"{name} unpickled")


@pytest.mark.parametrize("name,stack", [("ogbl-ppa", "short"), ("ogbn-proteins", "long")])
def test_big_graph_vocab_equals_jax(tmp_path, monkeypatch, name, stack):
    """The vocab from the full node and edge tables, a column at a time: the
    same file as JAX `build_tokenizer`'s. The JAX pipeline builds the short
    tokenizer for any stack_method (which asserts on long), so its tokenizer
    class is patched to the long one there."""
    monkeypatch.setattr(jpipeline, "_tokenizer_cls", lambda tok_cfg: (
        jtok.StackedGSTTokenizerLong if tok_cfg.stack_method == "long"
        else jtok.StackedGSTTokenizer))
    write_big_store(tmp_path / "data", name)
    jcfg, tcfg = cfg_pair(tmp_path / "data", name, tmp_path, stack=stack)
    jds, tds = jpipeline.build_dataset(jcfg), tpipeline.build_dataset(tcfg)
    jt, tt = jpipeline.build_tokenizer(jcfg, jds), tpipeline.build_tokenizer(tcfg, tds)
    vocab = tcfg.tokenization.vocab_file
    with open(tmp_path / "jax" / vocab) as f, open(tmp_path / "port" / vocab) as g:
        assert g.read() == f.read()
    assert type(tt).__name__ == type(jt).__name__
    assert tt.vocab_size == jt.vocab_size and tt.stacked_feat == jt.stacked_feat
    assert tcfg.tokenization.structure.edge.remove_edge_type_token  # the port leaves it as given


def _assert_same_sample(got, want, tag):
    for key in ("input_ids", "labels", "position_ids", "attention_mask", "node_labels",
                "edge_labels", "graph_labels"):
        a, b = getattr(got, key), getattr(want, key)
        assert (a is None) == (b is None), (tag, key)
        if a is not None:
            assert a.dtype == b.dtype, (tag, key)
            np.testing.assert_array_equal(a, b, err_msg=f"{tag} {key}")
    assert got.wgt == want.wgt, tag
    assert list(got.segment_lengths) == list(want.segment_lengths), tag
    assert sorted(got.extras) == sorted(want.extras), tag


@pytest.mark.parametrize("name,task", [("ogbn-proteins", "node"), ("ogbn-proteins", "pretrain-mlm"),
                                       ("ogbn-proteins", "pretrain"), ("ogbl-ppa", "edge")])
def test_long_stacked_rows_equal_jax(tmp_path, name, task):
    """`StackedGSTTokenizerLong` on the reader's samples: alternating node
    and edge rows, the edge types, the target rows of node and edge tasks,
    pretrain-mlm's label padding by row parity."""
    write_big_store(tmp_path / "data", name)
    jcfg, tcfg = cfg_pair(tmp_path / "data", name, tmp_path, task=task, stack="long")
    jds, tds = jreaders.read_dataset(name, jcfg), treaders.read_dataset(name, tcfg)
    vocab = tpipeline.build_tokenizer(tcfg, tds).vocab_map
    kw = dict(task_type=task, mlm_cfg=tcfg.training.pretrain_mlm)
    jt = jtok.StackedGSTTokenizerLong(jcfg.tokenization, vocab, **kw)
    tt = ttok.StackedGSTTokenizerLong(tcfg.tokenization, vocab, **kw)
    for i in range(min(len(jds), 60)):
        want = jt(jds[i], np.random.default_rng(i))
        got = tt(tds[i], np.random.default_rng(i))
        _assert_same_sample(got, want, f"{name} {task} {i}")
        assert got.input_ids.shape[1] == tt.stacked_feat


def _loader_batches(loader, ds, epochs, seed):
    out = []
    idx = np.arange(len(ds))
    for epoch in range(epochs):
        ds.reset_samples(epoch, seed)
        out.append([b.data for b in loader.epoch_batches(
            np.random.default_rng((seed, epoch)).permutation(idx)[:80], epoch, drop_last=False)])
    loader.close()
    return out


def _assert_batches_equal(got, want, tag):
    assert len(got) == len(want), tag
    for e, (ge, we) in enumerate(zip(got, want)):
        assert len(ge) == len(we), (tag, e)
        for b, (g, w) in enumerate(zip(ge, we)):
            assert sorted(g) == sorted(w), (tag, e, b)
            for k in w:
                np.testing.assert_array_equal(np.asarray(g[k]), np.asarray(w[k]),
                                              err_msg=f"{tag} epoch {e} batch {b} {k}")


@pytest.mark.parametrize("name,task", [("ogbl-ppa", "edge"), ("ogbn-proteins", "node")])
def test_loader_batches_with_spawned_workers_equal_jax(tmp_path, name, task):
    """Two epochs, each after `reset_samples(epoch, 7)` as FinetunePipeline
    resets the dataset with a training seed other than 42: the loader with 2
    spawned workers gives the batches of 0 workers, and of the JAX loader
    (0 workers). The workers unpickle the dataset as its path and state and
    follow the parent's reset seed along with its epoch (ogbl-ppa's edges
    and negatives of epoch 1 depend on it)."""
    write_big_store(tmp_path / "data", name, n=300, m=1500)
    stack = "long" if name == "ogbn-proteins" else "short"
    jcfg, tcfg = cfg_pair(tmp_path / "data", name, tmp_path, task=task, stack=stack)
    tds = tpipeline.build_dataset(tcfg)
    tok = tpipeline.build_tokenizer(tcfg, tds)
    jds = jreaders.read_dataset(name, jcfg)
    jt = getattr(jtok, type(tok).__name__)(jcfg.tokenization, tok.vocab_map, task_type=task)
    kw = dict(batch_size=16, mpe=512, seed=7, pack=False)
    want = _loader_batches(jloader.GraphTokenLoader(jds, jt, num_workers=0, **kw), jds, 2, 7)
    for workers in (0, 2):
        loader = tloader.GraphTokenLoader(tds, tok, num_workers=workers, **kw).start()
        if workers:  # the workers read the dataset and tokenizer from one file
            payload = loader._drop_payload.peek()[2][0]
            assert os.path.exists(payload)
        got = _loader_batches(loader, tds, 2, 7)
        _assert_batches_equal(got, want, f"{name} {workers} workers")
    assert not os.path.exists(payload)  # close removed it


_RAISES_WITH_A_POOL = """
from graphgpt_torch.data import loader
ld = loader.GraphTokenLoader(list(range(40)), None, batch_size=4, num_workers=1).start()
print(ld._drop_payload.peek()[2][0], flush=True)
raise RuntimeError("the pipeline failed")
"""


def test_loader_payload_goes_when_the_pipeline_raises(tmp_path):
    """A process whose pipeline raised with the pool started and the loader
    never closed leaves no payload file in its temporary directory."""
    root = Path(__file__).resolve().parents[1]
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(PYTHONPATH=str(root), TMPDIR=str(tmp_path))
    proc = subprocess.run([sys.executable, "-c", _RAISES_WITH_A_POOL], cwd=root, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 1 and "the pipeline failed" in proc.stderr, proc.stderr
    payload = proc.stdout.split()[0]
    assert payload.startswith(str(tmp_path)) and not os.path.exists(payload)
    assert not list(tmp_path.glob("ggt_loader_*"))
