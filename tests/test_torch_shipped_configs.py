"""The shipped configs the card had not run, on the CPU against the JAX
package: ogbn-products, ogbl-citation2, ogbl-ppa pretraining and
ogbl-wikikg2, on tiny seeded stores of the writers `chip_smoke.py` drives
them with, in the schema `tools/convert_ogb.py` writes.

- Each store writer's store reads the same graphs and splits through both
  packages' readers.
- `ogbn_products_supervised`, `ogbl_citation2_supervised` and
  `ogbl_ppa_pretrain`, read from their files, build the same vocab file and
  tokenize the same rows in both packages.
- ogbl-wikikg2 (a repair of the port): the store has no node or edge table,
  and the JAX tokenizer raises its TypeError on the shipped config. The
  port's reader builds the tables (each graph edge its train triple's
  relation, every node the attribute 0) and pairs each target edge with its
  relation alone, the config's one edge column. JAX's own reader on a copy
  of the store that carries those tables still pairs the relation with a
  column of ones, two columns where the config has one, and its tokenizer
  raises there too; so the JAX side of the comparison is JAX's
  `EgoEdgeDataset` built with the one-column relation the repair uses.
- The MRR datasets (a repair of the port): JAX's pipeline evaluates valid
  and test on `train_valid_split` samples of the train split, which carry
  no groups, and its `reformat_mrr_inputs` raises; the port evaluates the
  reader's own valid and test splits, each positive with its negatives.
"""

import importlib.util
import os
from pathlib import Path

import numpy as np
import pytest

from graphgpt_tpu import config as jconfig
from graphgpt_tpu import readers as jreaders
from graphgpt_tpu.data import sampling as jsampling
from graphgpt_tpu.training import pipeline as jpipeline
from graphgpt_tpu.utils import ogb_eval as jogb
from graphgpt_torch import config as tconfig
from graphgpt_torch import readers as treaders
from graphgpt_torch.training import pipeline as tpipeline
from test_torch_big_graph import _assert_same_sample, assert_datasets_equal
from test_torch_jax_native import jax_native_library  # noqa: F401  (autouse: JAX's C++ library)

ROOT = Path(__file__).resolve().parent.parent
SIZES = dict(n_nodes=400, n_edges=1200, n_eval=3)


@pytest.fixture(scope="module")
def cs():
    """chip_smoke.py as a module (its stores are these tests' stores), with
    6 negatives a positive in place of OGB's 1,000."""
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    mod.MRR_NEGATIVES = 6
    return mod


def _cfgs(data_dir, cfg_file, out=None, *extra):
    """The shipped config read by both packages' load_config."""
    over = [f"tokenization.data_dir={data_dir}", *extra]
    res = []
    for tag, mod in (("jax", jconfig), ("port", tconfig)):
        o = over + ([f"training.output_dir={os.path.join(str(out), tag)}"] if out else [])
        res.append(mod.load_config(str(ROOT / "configs" / cfg_file), o))
    return res


@pytest.mark.parametrize("name", ["ogbn-products", "ogbl-citation2", "ogbl-wikikg2"])
def test_the_store_writers_read_the_same_through_both_readers(tmp_path, cs, name):
    """Every split of the store (train, valid, test; the node reader's
    split indices) at epoch 0 and after a reset; the edge columns off for
    wikikg2, whose tables only the port's repair builds (below)."""
    cs.write_shipped_store(str(tmp_path), name, **SIZES)
    cfg_file = {"ogbn-products": "ogbn_products_supervised.yaml",
                "ogbl-citation2": "ogbl_citation2_supervised.yaml",
                "ogbl-wikikg2": "ogbl_wikikg2_supervised.yaml"}[name]
    extra = (("tokenization.semantics.node.discrete=null",
              "tokenization.semantics.edge.discrete=null") if name == "ogbl-wikikg2" else ())
    jcfg, tcfg = _cfgs(tmp_path, cfg_file, None, *extra)
    for split in ("train", "valid", "test"):
        jds = jreaders.read_dataset(name, jcfg, data_split=split)
        tds = treaders.read_dataset(name, tcfg, data_split=split)
        for epoch in range(2):
            if epoch:
                jds.reset_samples(epoch, 7)
                tds.reset_samples(epoch, 7)
            assert_datasets_equal(tds, jds, f"{name} {split} epoch {epoch}")
    data = np.load(tmp_path / name / "big_graph.npz")
    if name == "ogbn-products":
        assert data["x"].shape == (400, 100) and data["x"].dtype == np.float32
        assert data["node_attr"].shape == (400, 2) and int(data["y"].max()) < 47
    else:
        assert data["valid_edge_neg"].shape == (3, cs.MRR_NEGATIVES, 2)
        assert "edge_attr" not in data
        assert ("node_attr" in data) == (name == "ogbl-citation2")


@pytest.mark.parametrize("cfg_file,name,store", [
    ("ogbn_products_supervised.yaml", "ogbn-products", "shipped"),
    ("ogbl_citation2_supervised.yaml", "ogbl-citation2", "shipped"),
    ("ogbl_ppa_pretrain.yaml", "ogbl-ppa", "big"),
])
def test_the_shipped_configs_tokenize_as_jax(tmp_path, cs, cfg_file, name, store):
    """The config as shipped: the vocab file from the full tables, the
    tokenizer, and the rows of 24 samples of the train split."""
    if store == "big":
        cs.write_big_graph_store(str(tmp_path / "data"), name, 400, 1200)
    else:
        cs.write_shipped_store(str(tmp_path / "data"), name, **SIZES)
    jcfg, tcfg = _cfgs(tmp_path / "data", cfg_file, tmp_path)
    jds, tds = jpipeline.build_dataset(jcfg), tpipeline.build_dataset(tcfg)
    jt, tt = jpipeline.build_tokenizer(jcfg, jds), tpipeline.build_tokenizer(tcfg, tds)
    vocab = tcfg.tokenization.vocab_file
    with open(tmp_path / "jax" / vocab) as f, open(tmp_path / "port" / vocab) as g:
        assert g.read() == f.read()
    assert tt.vocab_size == jt.vocab_size and tt.stacked_feat == jt.stacked_feat
    for i in range(24):
        _assert_same_sample(tt(tds[i], np.random.default_rng(i)),
                            jt(jds[i], np.random.default_rng(i)), f"{name} sample {i}")


def test_wikikg2_tokenizes_through_the_port_repair(tmp_path, cs):
    """The shipped config on a wikikg2 store: JAX's tokenizer raises its
    TypeError; the port's reader builds the node and edge tables and its
    rows equal JAX's tokenizer over JAX's `EgoEdgeDataset` of a copy of
    the store that carries those tables, the target edges paired with the
    relation alone (the repair; see the module docstring)."""
    name = "ogbl-wikikg2"
    cs.write_shipped_store(str(tmp_path / "data"), name, **SIZES)
    jcfg, tcfg = _cfgs(tmp_path / "data", "ogbl_wikikg2_supervised.yaml", tmp_path)
    jds = jpipeline.build_dataset(jcfg)
    jt = jpipeline.build_tokenizer(jcfg, jds)
    with pytest.raises(TypeError, match="not subscriptable"):
        jt(jds[0], np.random.default_rng(0))

    tds = tpipeline.build_dataset(tcfg)
    tt = tpipeline.build_tokenizer(tcfg, tds)
    data = dict(np.load(tmp_path / "data" / name / "big_graph.npz"))
    rel = data["train_relation"]
    assert tds.big.edge_attr.shape == (data["edge_index"].shape[1], 1)
    np.testing.assert_array_equal(tds.big.edge_attr[:, 0], rel)  # the triples, in order
    assert not tds.big.node_attr.any() and tds.big.node_attr.shape == (data["num_nodes"], 1)
    assert tds.relation_col == 0 and tds.pos_edge_attr_all.shape[1] == 1

    # the copy carrying the repair's tables, through JAX's classes
    copy = tmp_path / "copy"
    (copy / name).mkdir(parents=True)
    data.update(edge_attr=rel[:, None].astype(np.int32),
                node_attr=np.zeros((int(data["num_nodes"]), 1), np.int32))
    np.savez(copy / name / "big_graph.npz", **data)
    jcfg2, _ = _cfgs(copy, "ogbl_wikikg2_supervised.yaml", tmp_path / "copy_out")
    with pytest.raises(ValueError, match="broadcast"):  # JAX's reader: [ones, rel] targets
        jpipeline.build_tokenizer(jcfg2, jpipeline.build_dataset(jcfg2))(
            jpipeline.build_dataset(jcfg2)[0], np.random.default_rng(0))
    big = jreaders._load_big_graph(str(copy / name / "big_graph.npz"))
    uniq = np.unique(rel)
    jds2 = jsampling.EgoEdgeDataset(
        big, depth_neighbors=((1, 8),), pos_edges=data["train_edge"], neg_edges=None,
        neg_ratio=1, percent=100, method="local", seed=jcfg2.training.seed,
        pretrain_mode=False, pos_edge_attr=rel[:, None], neg_edge_attr_candidates=uniq[:, None],
        sample_wgt=True, relation_col=0)
    jt2 = jpipeline.build_tokenizer(jcfg2, jds2)
    with open(tmp_path / "copy_out" / "jax" / jcfg2.tokenization.vocab_file) as f, \
            open(tmp_path / "port" / tcfg.tokenization.vocab_file) as g:
        assert g.read() == f.read()
    assert_datasets_equal(tds, jds2, "wikikg2 train")
    for i in range(24):
        _assert_same_sample(tt(tds[i], np.random.default_rng(i)),
                            jt2(jds2[i], np.random.default_rng(i)), f"wikikg2 sample {i}")


@pytest.mark.parametrize("name,cfg_file", [("ogbl-citation2", "ogbl_citation2_supervised.yaml"),
                                           ("ogbl-wikikg2", "ogbl_wikikg2_supervised.yaml")])
def test_the_mrr_datasets_evaluate_the_readers_own_splits(tmp_path, cs, name, cfg_file):
    """The config through the port's FinetunePipeline (tiny widths, one
    epoch of two steps, predictions saved). Valid and test are the reader's
    splits: the positives, then each positive's negatives in the store's
    order (citation2: the source kept, the target replaced; wikikg2: the
    head replaced, then the tail). The valid MRR in result.csv (the name
    JAX's pipeline writes) equals JAX's `evaluate_ogb` on the scores of
    valid_results.csv grouped by that order, each positive against its own
    negatives; a few items tokenized alone (with the loader's draws for
    their place in the pass) and scored in a batch of their own give the
    scores written for them. The train-subset eval gives no MRR, and
    what JAX's pipeline hands its `reformat_mrr_inputs` (the labels of
    `train_valid_split` samples, no groups) raises."""
    import csv

    from graphgpt_torch.data.collator import collate
    from graphgpt_torch.synthetic import to_torch
    from graphgpt_torch.training.finetune import FinetunePipeline

    cs.write_shipped_store(str(tmp_path / "data"), name, **SIZES)
    _, tcfg = _cfgs(tmp_path / "data", cfg_file, tmp_path,
                    "model.hidden_size=64", "model.num_hidden_layers=1", "training.batch_size=8",
                    "training.batch_size_eval=32", "model.dtype=float32",
                    "training.pretrain_cpt=", "training.k_samplers=8", "training.num_workers=2",
                    "training.save_pred=true")
    pipe = FinetunePipeline(tcfg, device="cpu").setup()
    data = np.load(tmp_path / "data" / name / "big_graph.npz")
    pos, neg = data["valid_edge"], data["valid_edge_neg"]
    n, k = neg.shape[:2]
    assert (n, k) == (3, cs.MRR_NEGATIVES)
    if name == "ogbl-citation2":
        assert (neg[:, :, 0] == pos[:, :1]).all()
    else:
        assert (neg[:, : k // 2, 1] == pos[:, 1:]).all()  # the head replaced
        assert (neg[:, k // 2:, 0] == pos[:, :1]).all()  # then the tail
    ds = pipe.eval_loaders["valid"].dataset
    np.testing.assert_array_equal(ds.edges_with_y[:, :2],
                                  np.concatenate([pos, neg.reshape(-1, 2)]))
    assert len(pipe.valid_idx) == len(pipe.test_idx) == n * (1 + k)
    pipe.train_idx, pipe.epochs = pipe.train_idx[:16], 1
    pipe.run()
    out = tmp_path / "port"
    with open(out / "result.csv") as f:
        last = list(csv.DictReader(f))[-1]
    assert "valid_mrr" in last and "test_mrr" in last and "train_mrr" not in last
    with open(out / "valid_results.csv") as f:
        rows = np.asarray([[float(x) for x in r] for r in list(csv.reader(f))[1:]])
    scores, labels = rows[:, 1] - rows[:, 0], rows[:, 2]
    np.testing.assert_array_equal(labels, np.r_[np.ones(n), np.zeros(n * k)])
    want = jogb.evaluate_ogb(name, {"y_pred_pos": scores[:n],
                                    "y_pred_neg": scores[n:].reshape(n, k)})["mrr"]
    assert float(last["valid_mrr"]) == pytest.approx(want, rel=1e-12, abs=1e-12)
    assert 0 < want <= 1
    tc = tcfg.training
    for i in (0, n - 1, n, n + k + 1, n * (1 + k) - 1):
        # the loader's draws for index i at place i of the pass (data/loader.py)
        sample = pipe.tokenizer(ds[i], np.random.default_rng((tc.seed, 0, i, i)))
        batch = collate([sample], mpe=tc.max_length, bucket=tc.pad_to_multiple_of)
        logits = pipe.eval_step(pipe.state, to_torch(batch.data, "cpu"))["task_logits"]
        got = float(logits[0, 1] - logits[0, 0])
        assert got == pytest.approx(scores[i], rel=1e-4, abs=1e-5), i
    labels = np.tile([1, 0], 8)  # a train-split eval: one negative a positive
    with pytest.raises(ValueError):
        jogb.reformat_mrr_inputs(np.zeros(16), labels, np.arange(16))


def test_a_binding_logits_cap_keeps_the_sweeps_cells(tmp_path, monkeypatch):
    """The port's generation sweep caps its batch at LOGITS_BUDGET logits
    [b, P * F, V] (at ogbl-ppa's vocab one row is 3.3 times the budget: b
    = 1). On the smoke config at hidden 64 and one layer (vocab 755, rows
    of 128 x 13), with the budget made small: where the cap leaves the
    draws alone (four graphs, the budget exactly four rows' logits) the
    sweep equals the uncapped one bit for bit; where it binds (b 3, then b
    1) the batches shrink, every band's cell is still there in the same
    order with a finite accuracy, and the tail that fills no batch is left
    out (b 3: the fourth graph). There the port differs from the JAX
    package, which asks for the whole softmax of every batch: the batches,
    the generators' seeds (band * 100003 + the batch's start), the order of
    the mask draws and the graphs left out all change, so gen_acc is not
    JAX's."""
    from graphgpt_torch.training.pipeline import PretrainPipeline, smoke_config

    cfg = smoke_config(str(tmp_path))
    cfg.generation.steps, cfg.training.batch_size_eval = 1, 4
    cfg.model.hidden_size, cfg.model.num_hidden_layers = 64, 1
    pipe = PretrainPipeline(cfg, device="cpu").setup()
    sizes = []
    real = tpipeline.collate
    monkeypatch.setattr(tpipeline, "collate", lambda s, **kw: sizes.append(len(s)) or real(s, **kw))
    row = cfg.training.max_length * pipe.tokenizer.stacked_feat * pipe.tokenizer.vocab_size

    def sweep(budget, n):
        sizes.clear()
        monkeypatch.setattr(tpipeline, "LOGITS_BUDGET", budget)
        return pipe.evaluate_generation(n_samples=n, n_bands=2), list(sizes)

    free, free_b = sweep(1 << 40, 4)
    assert free_b == [4]
    assert sweep(4 * row, 4) == (free, [4])  # the budget exactly fits: the same draws
    for budget, want_b in ((4 * row - 1, [3]), (row - 1, [1, 1, 1, 1])):
        capped, got_b = sweep(budget, 4)
        assert got_b == want_b
        assert list(capped) == list(free)  # the same cells, in the same order
        assert all(0.0 <= v <= 1.0 for v in capped.values())


def test_wikikg2_takes_an_eval_relation_that_no_train_triple_has(tmp_path, cs):
    """A valid triple whose relation no train triple has (OGB does not
    promise that every eval relation occurs in train): the port's vocab
    takes the relations of every split's triples, so the triple tokenizes
    and the valid split evaluates (its MRR in result.csv). A vocab built
    from the graph's edge table alone, train's relations, as JAX builds
    it, raises the KeyError on that triple."""
    from graphgpt_torch.training.finetune import FinetunePipeline

    name = "ogbl-wikikg2"
    cs.write_shipped_store(str(tmp_path / "data"), name, **SIZES)
    path = tmp_path / "data" / name / "big_graph.npz"
    data = dict(np.load(path))
    unseen = int(max(data[f"{sp}_relation"].max() for sp in ("train", "valid", "test"))) + 1
    data["valid_relation"] = data["valid_relation"].copy()
    data["valid_relation"][0] = unseen
    np.savez(path, **data)
    over = ("model.hidden_size=64", "model.num_hidden_layers=1", "training.batch_size=8",
            "training.batch_size_eval=32", "model.dtype=float32", "training.pretrain_cpt=",
            "training.k_samplers=8", "training.num_workers=0")
    _, tcfg = _cfgs(tmp_path / "data", "ogbl_wikikg2_supervised.yaml", tmp_path, *over)
    pipe = FinetunePipeline(tcfg, device="cpu").setup()
    valid = pipe.eval_loaders["valid"].dataset
    assert unseen not in set(pipe.dataset.big.edge_attr[:, 0].tolist())
    assert unseen in set(pipe.dataset.relation_values.tolist())
    pipe.tokenizer(valid[0], np.random.default_rng(0))  # the triple with the unseen relation

    # the vocab of the edge table alone (train's relations) misses it
    _, tcfg2 = _cfgs(tmp_path / "data", "ogbl_wikikg2_supervised.yaml", tmp_path / "train_only",
                     *over)
    ds = tpipeline.build_dataset(tcfg2)
    ds.relation_values = None
    with pytest.raises(KeyError):
        tpipeline.build_tokenizer(tcfg2, ds)(valid[0], np.random.default_rng(0))

    pipe.train_idx, pipe.epochs = pipe.train_idx[:16], 1
    pipe.run()
    import csv

    with open(tmp_path / "port" / "result.csv") as f:
        last = list(csv.DictReader(f))[-1]
    assert 0 < float(last["valid_mrr"]) <= 1
