"""The port's copies of the host-side fine-tune modules against the JAX
package's originals, on the CPU: config loading, vocab, the stacked
tokenizer's task rows, the collator, the loader, the metrics and the OGB
evaluators. These are numpy code on both sides, so the results must be
equal (metrics to 1e-12: the same float64 formulas).

Both packages walk in C++ by default; here both are held to the numpy
walk (`euler._NATIVE_CHECKED = True`, `_NATIVE = None` in each package's
`data/euler.py`). `tests/test_torch_readers.py` holds the two default (C++)
walks against each other.
"""

import glob
import os

import numpy as np
import pytest

from graphgpt_tpu import config as jconfig
from graphgpt_tpu.data import collator as jcollator
from graphgpt_tpu.data import datasets as jdatasets
from graphgpt_tpu.data import euler as jeuler
from graphgpt_tpu.data import loader as jloader
from graphgpt_tpu.data import tokenizer as jtok
from graphgpt_tpu.data import vocab as jvocab
from graphgpt_tpu.utils import metrics as jmetrics
from graphgpt_tpu.utils import ogb_eval as jogb
from graphgpt_torch import config as tconfig
from graphgpt_torch.data import collator as tcollator
from graphgpt_torch.data import datasets as tdatasets
from graphgpt_torch.data import euler as teuler
from graphgpt_torch.data import loader as tloader
from graphgpt_torch.data import tokenizer as ttok
from graphgpt_torch.data import vocab as tvocab
from graphgpt_torch.utils import metrics as tmetrics
from graphgpt_torch.utils import ogb_eval as togb
from test_torch_jax_native import jax_native_library  # noqa: F401  (autouse: JAX's C++ library)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = sorted(glob.glob(os.path.join(ROOT, "configs", "*.yaml")))


@pytest.fixture(autouse=True)
def numpy_walk(monkeypatch):
    monkeypatch.setattr(jeuler, "_NATIVE_CHECKED", True)
    monkeypatch.setattr(jeuler, "_NATIVE", None)
    monkeypatch.setattr(teuler, "_NATIVE_CHECKED", True)
    monkeypatch.setattr(teuler, "_NATIVE", None)


def _shared_fields(a, b, path=""):
    """(path, value_a, value_b) for every field the port's dataclass shares
    with the JAX package's."""
    import dataclasses

    for f in dataclasses.fields(b):
        va, vb = getattr(a, f.name), getattr(b, f.name)
        if dataclasses.is_dataclass(vb):
            yield from _shared_fields(va, vb, path + f.name + ".")
        else:
            yield path + f.name, va, vb


@pytest.mark.parametrize("path", CONFIGS, ids=os.path.basename)
def test_every_config_file_loads_as_in_jax(path):
    """Every shared field as the JAX package loads it, but for one repair:
    YAML 1.1 reads a float written with an unsigned exponent (the pretrain
    configs' `total_tokens: 2.0e11`) as a string, which the JAX loader keeps
    and the port makes the float the field holds
    (tests/test_torch_pretrain_data.py::test_a_token_budget_in_yaml_loads_as_a_float)."""
    want = jconfig.load_config(path, ["training.seed=7"])
    got = tconfig.load_config(path, ["training.seed=7"])
    for group in ("tokenization", "model", "training", "generation"):
        for name, w, g in _shared_fields(getattr(want, group), getattr(got, group)):
            if isinstance(w, str) and isinstance(g, float):
                assert g == float(w), f"{group}.{name}"
            else:
                assert g == w, f"{group}.{name}"


def _vocab_map(task="graph"):
    cfg = tconfig.TokenizationConfig()
    cfg.semantics.node.discrete, cfg.semantics.node.dim = "node_attr", 9
    cfg.semantics.edge.discrete, cfg.semantics.edge.dim = "edge_attr", 3
    node = [np.arange(c) for c in tdatasets.MOL_NODE_CARD]
    edge = [np.arange(c) for c in tdatasets.MOL_EDGE_CARD]
    jcfg = jconfig.TokenizationConfig()
    jcfg.semantics.node.discrete, jcfg.semantics.node.dim = "node_attr", 9
    jcfg.semantics.edge.discrete, jcfg.semantics.edge.dim = "edge_attr", 3
    vocab = tvocab.build_vocab(cfg, node, edge)
    assert vocab == jvocab.build_vocab(jcfg, node, edge)
    return cfg, jcfg, tvocab.vocab_map_from_list(vocab)


def _task_graph(task, i):
    g = tdatasets.SyntheticMolDataset(64, seed=3)[i]
    rng = np.random.default_rng(i)
    if task == "node":
        g.root_n_id = np.asarray([int(rng.integers(g.num_nodes))])
        g.y = rng.integers(0, 5, size=(g.num_nodes, 1)).astype(np.float32)
    elif task == "edge":
        g.root_n_id = g.edge_index[:, int(rng.integers(g.num_edges))].copy()
        g.y = np.asarray([1.0], np.float32)
    elif task == "nodev2":
        g.y = rng.integers(0, 3, size=(g.num_nodes, 1))
    return g


@pytest.mark.parametrize("task", ["graph", "edge", "node", "nodev2"])
def test_tokenizer_task_rows_match_jax(task):
    cfg, jcfg, vm = _vocab_map()
    n_cls = 3 if task == "nodev2" else 0
    port = ttok.StackedGSTTokenizer(cfg, vm, task_type=task, num_intra_cls=n_cls)
    ref = jtok.StackedGSTTokenizer(jcfg, vm, task_type=task, num_intra_cls=n_cls)
    for i in range(12):
        g = _task_graph(task, i)
        got = port(g, np.random.default_rng((1, i)))
        want = ref(g, np.random.default_rng((1, i)))
        for key in ("input_ids", "labels", "position_ids", "attention_mask", "graph_labels",
                    "node_labels", "edge_labels"):
            a, b = getattr(got, key), getattr(want, key)
            assert (a is None) == (b is None), key
            if a is not None:
                np.testing.assert_array_equal(a, b, err_msg=key)
        assert got.wgt == want.wgt and sorted(got.extras) == sorted(want.extras)
        for key in got.extras:
            np.testing.assert_array_equal(got.extras[key], want.extras[key], err_msg=key)


@pytest.mark.parametrize("task", ["pretrain-cl", "pretrain-smtp", "pretrain-coord",
                                  "pretrain-mlm-coord", "pretrain-ltp", "pretrain-euler"])
def test_tokenizer_refuses_the_pretrain_tasks(task):
    """The stacked tokenizer refuses a pretrain task exactly where the JAX
    one does: the flat tokenizer's pretrain-ltp and pretrain-euler raise in
    both when called; the other tasks' rows are JAX's
    (tests/test_torch_pretrain_tasks.py holds them in full)."""
    cfg, jcfg, vm = _vocab_map()
    port = ttok.StackedGSTTokenizer(cfg, vm, task_type=task)
    ref = jtok.StackedGSTTokenizer(jcfg, vm, task_type=task)
    g = _task_graph("graph", 1)
    if task in ("pretrain-ltp", "pretrain-euler"):
        for tok in (port, ref):
            with pytest.raises(NotImplementedError, match="pretrain"):
                tok(g, np.random.default_rng(0))
        return
    got, want = port(g, np.random.default_rng(0)), ref(g, np.random.default_rng(0))
    for key in ("input_ids", "labels", "position_ids"):
        np.testing.assert_array_equal(getattr(got, key), getattr(want, key), err_msg=key)
    assert sorted(got.extras) == sorted(want.extras)


def _loaders(bs=8, **kw):
    cfg, jcfg, vm = _vocab_map()
    ds = tdatasets.SyntheticMolDataset(500, seed=11)
    port = tloader.GraphTokenLoader(ds, ttok.StackedGSTTokenizer(cfg, vm), batch_size=bs,
                                    mpe=40, bucket=8, seed=5, **kw)
    ref = jloader.GraphTokenLoader(jdatasets.SyntheticMolDataset(500, seed=11),
                                   jtok.StackedGSTTokenizer(jcfg, vm, task_type="graph"),
                                   batch_size=bs, mpe=40, pack=False, bucket=8, seed=5,
                                   num_workers=0, **kw)
    return port, ref


def _assert_same_batches(got, want):
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert sorted(g.keys()) == sorted(w.keys())
        for key in w.keys():
            assert g[key].dtype == w[key].dtype, key
            np.testing.assert_array_equal(g[key], w[key], err_msg=key)


@pytest.mark.parametrize("drop_last", [True, False])
def test_loader_batches_equal_jax_bit_for_bit(drop_last):
    """Batches of 8 rows padded to multiples of 8 and capped at 40 positions
    (longer walks keep their head and eos row), over a permutation with a
    ragged end."""
    port, ref = _loaders()
    idx = np.random.default_rng(0).permutation(500)[:61]
    got = list(port.epoch_batches(idx, epoch=2, drop_last=drop_last))
    want = list(ref.epoch_batches(idx, epoch=2, drop_last=drop_last))
    _assert_same_batches(got, want)
    assert len(got) == (7 if drop_last else 8)
    assert max(b["input_ids"].shape[1] for b in got) == 40  # the mpe cap took effect
    _assert_same_batches(list(port.prefetched(idx, epoch=2)), want[:7])


class _Failing:
    """A dataset whose 20th graph cannot be read."""

    def __init__(self, base):
        self.base = base

    def __len__(self):
        return len(self.base)

    def __getitem__(self, i):
        if i == 20:
            raise OSError("unreadable graph")
        return self.base[i]


@pytest.mark.filterwarnings("ignore::pytest.PytestUnhandledThreadExceptionWarning")
def test_loader_prefetch_raises_what_the_producer_raised():
    """The JAX package's `prefetched` ends the epoch early and quietly when
    its producer thread fails (here before the first of 8 batches: it
    tokenizes 32 graphs at a time), and its pipeline goes on to checkpoint
    and evaluate; the port's raises the producer's error."""
    port, ref = _loaders()
    port.dataset, ref.dataset = _Failing(port.dataset), _Failing(ref.dataset)
    idx = np.arange(64)
    assert len(list(ref.prefetched(idx))) == 0
    with pytest.raises(OSError, match="unreadable"):
        list(port.prefetched(idx))


def test_collate_and_bucket_length_match_jax():
    cfg, jcfg, vm = _vocab_map()
    tok = ttok.StackedGSTTokenizer(cfg, vm)
    samples = [tok(tdatasets.SyntheticMolDataset(32, seed=2)[i], np.random.default_rng(i))
               for i in range(6)]
    for kw in (dict(mpe=1024, bucket=8), dict(mpe=24, bucket=8), dict(fixed_length=64)):
        _assert_same_batches([tcollator.collate(samples, **kw)],
                             [jcollator.collate(samples, **kw)])
    for lengths in ((3, 9), (17,), (64, 1)):
        assert tcollator.bucket_length(lengths, 8, 40) == jcollator.bucket_length(lengths, 8, 40)


def test_datasets_and_split_match_jax():
    for i in (0, 7, 31):
        a = tdatasets.SyntheticMolDataset(40, seed=4)[i]
        b = jdatasets.SyntheticMolDataset(40, seed=4)[i]
        for key in ("edge_index", "node_attr", "edge_attr", "y"):
            np.testing.assert_array_equal(getattr(a, key), getattr(b, key))
    for got, want in zip(tdatasets.train_valid_split(1000, 0.1, 3),
                         jdatasets.train_valid_split(1000, 0.1, 3)):
        np.testing.assert_array_equal(got, want)


# ---------------------------------------------------------------------------
# metrics and OGB evaluators
# ---------------------------------------------------------------------------
def _scores(seed=0, n=200, c=2):
    rng = np.random.default_rng(seed)
    scores = np.round(rng.normal(size=(n, c)), 1)  # rounded: ties
    return rng, scores


@pytest.mark.parametrize("problem", ["regression", "single_label_classification",
                                     "multi_label_classification", "graph_clustering"])
def test_compute_metrics_matches_jax(problem):
    rng, scores = _scores(c=5 if problem != "single_label_classification" else 2)
    if problem == "regression":
        scores, labels = scores[:, 0], rng.normal(size=200)
    elif problem == "multi_label_classification":
        labels = (rng.random(scores.shape) < 0.4).astype(np.float64)
        labels[rng.random(scores.shape) < 0.1] = np.nan
        labels[:, 4] = 1.0  # a task with one class only: skipped
    else:
        labels = rng.integers(0, scores.shape[1], size=200)
        labels[:5] = -100
    got = tmetrics.compute_metrics(problem, scores, labels)
    want = jmetrics.compute_metrics(problem, scores, labels)
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-12, err_msg=k)


def test_metric_selection_matches_jax():
    res = [{"ema_valid_mae": 0.5}, {"ema_valid_mae": 0.4, "ema_valid_mse": 0.2},
           {"ema_auroc": 0.7, "ema_acc": 0.9}, {"ema_hits@20": 0.3, "ema_hits@100": 0.5},
           {"ema_hits@20": 0.1, "ema_hits@100": 0.6}]
    prev_t = prev_j = {}
    for r in res:
        ft, prev_t = tmetrics.compare_metrics_res(r, prev_t)
        fj, prev_j = jmetrics.compare_metrics_res(r, prev_j)
        assert ft == fj and prev_t == prev_j
    for new, best, key in (({"valid_mae": 1.0}, {"valid_mae": 2.0}, "valid_mae"),
                           ({"valid_auroc": 0.6}, {"valid_auroc": 0.7}, "valid_auroc"),
                           ({"valid_hits@50": 0.6}, {}, "valid_hits@50")):
        assert tmetrics.is_better(new, best, key) == jmetrics.is_better(new, best, key)
    keys = ["ema_hits@20", "ema_hits@100", "ema_mrr", "ema_acc"]
    assert tmetrics.primary_metric_key(keys) == jmetrics.primary_metric_key(keys)


def test_ogb_evaluators_match_jax():
    rng, scores = _scores(seed=3, n=300, c=6)
    y = (rng.random((300, 6)) < 0.3).astype(np.float64)
    y[rng.random((300, 6)) < 0.1] = np.nan
    flat = scores[:, 0]
    labels = (rng.random(300) < 0.2).astype(np.float64)
    idx = np.repeat(np.arange(60), 5)
    lab_mrr = np.tile([1.0, 0, 0, 0, 0], 60)
    inputs = {
        "ogbl-ppa": jogb.reformat_hits_inputs(flat, labels),
        "ogbl-ddi": togb.reformat_hits_inputs(flat, labels),
        "ogbl-collab": jogb.reformat_hits_inputs(flat, labels),
        "ogbl-citation2": togb.reformat_mrr_inputs(flat, lab_mrr, idx, num_neg=4),
        "ogbl-wikikg2": togb.reformat_mrr_inputs(flat, lab_mrr, idx, num_neg=4),
        "pcqm4m-v2": {"y_pred": flat, "y_true": scores[:, 1]},
        "ogbg-molhiv": {"y_pred": flat, "y_true": labels},
        "ogbg-molpcba": {"y_pred": scores, "y_true": y},
    }
    assert sorted(togb._ogb.keys()) == sorted(jogb._ogb.keys()) == sorted(inputs)
    for name, d in inputs.items():
        got, want = togb.evaluate_ogb(name, d), jogb.evaluate_ogb(name, d)
        assert got.keys() == want.keys()
        for k in want:
            np.testing.assert_allclose(got[k], want[k], rtol=1e-12, err_msg=f"{name} {k}")
    for a, b in zip(togb.reformat_mrr_inputs(flat, lab_mrr, idx, 4).values(),
                    jogb.reformat_mrr_inputs(flat, lab_mrr, idx, 4).values()):
        np.testing.assert_array_equal(a, b)


def test_the_flagship_vocab_is_one_short_of_the_molecule_tokenizer(tmp_path):
    """The JAX package's GraphGPT-base entry config (`_flagship_cfg`, copied
    as `flagship_config`) has vocab_size 754: the number of tokens of the
    PCQM4M-v2 schema. Ids start at 1 (0 is pad), so the tokenizer's largest
    id is 754 and its model needs 755 rows; a 754-row table cannot embed
    that token, and its checkpoint cannot warm-start a fine-tune
    embedding."""
    from graphgpt_torch.config import flagship_config
    from graphgpt_torch.training.pipeline import build_tokenizer

    cfg = tconfig.Config()
    cfg.tokenization.semantics.node.discrete, cfg.tokenization.semantics.node.dim = "node_attr", 9
    cfg.tokenization.semantics.edge.discrete, cfg.tokenization.semantics.edge.dim = "edge_attr", 3
    cfg.training.task_type, cfg.training.output_dir = "graph", str(tmp_path)
    tok = build_tokenizer(cfg.sync(), None)
    assert max(tok.vocab_map.values()) == 754 and tok.vocab_size == 755
    assert flagship_config(layers=1).vocab_size == 754


def test_a_finetune_config_with_the_tensorboard_writer_raises(tmp_path):
    """JAX's FinetunePipeline writes event files under use_tb_writer (unless
    eval_only); the port has no writer yet, so its FinetunePipeline raises
    at setup, before it writes anything, as its PretrainPipeline does,
    rather than run without them."""
    from graphgpt_torch.training.finetune import FinetunePipeline

    cfg = tconfig.load_config(os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "configs", "pcqm4m_v2_supervised.yaml"), [
        f"training.output_dir={tmp_path / 'ft'}", "training.use_tb_writer=true"])
    assert jconfig.load_config(os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "configs", "pcqm4m_v2_supervised.yaml"),
        ["training.use_tb_writer=true"]).training.use_tb_writer
    with pytest.raises(NotImplementedError, match="TensorBoard"):
        FinetunePipeline(cfg, device="cpu").setup()
    assert not (tmp_path / "ft").exists()
