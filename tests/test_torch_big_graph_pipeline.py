"""The port's pipelines against the JAX package's on big-graph stores, on
the CPU, with both packages' default (C++) samplers and walks, from the
same weights (the JAX pipeline's initial parameters loaded into the port's
model), hidden 64, 2 layers, fp32, batches of 8 (the JAX CPU mesh has 8
devices).

- Edge level: `FinetunePipeline` on an ogbl-ppa-schema store (the reader's
  train split, percent-50 positives with global negatives redrawn each
  epoch with the training seed, AUC loss, EMA), two epochs: the splits of
  `train_valid_split` over that dataset, the per-step losses and the eval
  metrics (ogbl-ppa's hits@K) of each epoch.
- Node level, long stacking: `FinetunePipeline` on an ogbn-proteins-schema
  store (species mask, x_mask, 112 labels, gated aggregation, LayerScale),
  two epochs, the same comparisons (ROC-AUC over the 112 labels).
- `PretrainPipeline` on the proteins-schema store: three packed
  pretrain-mlm steps of long rows.

The JAX `build_tokenizer` builds the short tokenizer whatever the
stack_method (which asserts on long); its tokenizer class is patched to the
long one for the long runs. The AUC loss pairs each position with random
negatives: the port takes the JAX train step's draw (`PRNGKey(0)`, its
step passes no loss key), as `tests/test_torch_task_heads.py` does. Losses
and metrics agree to 1e-4 relative (fp32 sums in another order through two
layers and the AdamW steps), gradient norms to 1e-3.
"""

import jax
import numpy as np
import pytest
import torch

from graphgpt_tpu.config import Config as JConfig
from graphgpt_tpu.data import tokenizer as jtok
from graphgpt_tpu.training import finetune as jft
from graphgpt_tpu.training import pipeline as jpipeline
from graphgpt_torch.config import Config as TConfig
from graphgpt_torch.models import heads as theads
from graphgpt_torch.training import finetune as tft
from graphgpt_torch.training import pipeline as tpipeline
from test_torch_big_graph import write_big_store
from test_torch_graph_finetune import _close, _port_from_jax, _rows, few_threads  # noqa: F401
from test_torch_readers import assert_splits_equal


@pytest.fixture(autouse=True)
def long_tokenizer_for_jax(monkeypatch):
    monkeypatch.setattr(jpipeline, "_tokenizer_cls", lambda tok_cfg: (
        jtok.StackedGSTTokenizerLong if tok_cfg.stack_method == "long"
        else jtok.StackedGSTTokenizer))


def _cfg(cls, data_dir, out_dir, name, stack="short"):
    cfg = cls()
    tok = cfg.tokenization
    tok.dataset, tok.data_dir, tok.stack_method = name, str(data_dir), stack
    tok.attr_world_identifier = name
    tok.semantics.node.discrete, tok.semantics.node.dim = "node_attr", 2
    m = cfg.model
    m.hidden_size, m.num_hidden_layers, m.head_dim, m.dtype = 64, 2, 16, "float32"
    t = cfg.training
    t.num_workers, t.output_dir, t.seed = 0, str(out_dir), 5
    return cfg


def _edge_cfg(cls, data_dir, out_dir):
    cfg = _cfg(cls, data_dir, out_dir, "ogbl-ppa")
    m = cfg.model
    m.problem_type, m.loss_type, m.num_labels, m.num_neg = (
        "single_label_classification", "auc", 2, 1)
    t = cfg.training
    t.task_type, t.batch_size, t.max_length, t.valid_percent = "edge", 8, 64, 0.2
    t.pad_to_multiple_of = 64  # one shape: one JAX compile
    t.schedule.epochs, t.schedule.logging_steps = 2, 1
    t.optimizer.use_ema, t.k_samplers = True, 16
    return cfg


def _node_cfg(cls, data_dir, out_dir):
    cfg = _cfg(cls, data_dir, out_dir, "ogbn-proteins", stack="long")
    cfg.tokenization.semantics.edge.discrete, cfg.tokenization.semantics.edge.dim = (
        "edge_attr", 8)
    m = cfg.model
    m.problem_type, m.num_labels = "multi_label_classification", 112
    m.stacked_feat_agg_method, m.layer_scale_init_value = "gated", 1.0
    t = cfg.training
    t.task_type, t.batch_size, t.max_length, t.valid_percent = "node", 8, 128, 0.2
    t.pad_to_multiple_of = 128  # one shape (rows cut at 128): one JAX compile
    t.schedule.epochs, t.schedule.logging_steps = 2, 1
    t.optimizer.use_ema, t.k_samplers = True, 16
    return cfg


def _pt_cfg(cls, data_dir, out_dir):
    cfg = _node_cfg(cls, data_dir, out_dir)
    m = cfg.model
    m.problem_type, m.layer_scale_init_value = "regression", 0.0
    t = cfg.training
    t.task_type, t.pack_tokens, t.max_length = "pretrain-mlm", 1, 256
    t.schedule.total_num_steps, t.schedule.warmup_num_steps = 3, 1
    t.schedule.steps_per_saving = 0
    t.valid_percent, t.do_valid, t.gen_eval_bands = 0.01, False, 0
    return cfg


def _run_both(tmp, name, make_cfg, **store):
    write_big_store(tmp / "data", name, **store)
    jpipe = jft.FinetunePipeline(make_cfg(JConfig, tmp / "data", tmp / "jax")).setup()
    params = jax.tree_util.tree_map(np.asarray, jpipe.state.params)
    jpipe.run()
    tpipe = tft.FinetunePipeline(make_cfg(TConfig, tmp / "data", tmp / "port"),
                                 device="cpu").setup()
    _port_from_jax(tpipe, params)
    tpipe.run()
    return jpipe, tpipe


def _assert_runs_match(tmp, jpipe, tpipe, steps, metrics):
    assert_splits_equal((tpipe.train_idx, tpipe.valid_idx, tpipe.test_idx),
                        (jpipe.train_idx, jpipe.valid_idx, jpipe.test_idx))
    assert tpipe.dataset.epoch == jpipe.dataset.epoch == 1
    want, got = _rows(tmp / "jax" / "loss.csv"), _rows(tmp / "port" / "loss.csv")
    assert len(got) == len(want) == steps
    for w, g in zip(want, got):
        assert g["step"] == w["step"] and g["epoch"] == w["epoch"]
        for key in ("loss", "lr"):
            _close(g, w, key)
        _close(g, w, "grad_norm", 1e-3)
    want, got = _rows(tmp / "jax" / "result.csv"), _rows(tmp / "port" / "result.csv")
    assert len(got) == len(want) == 2
    assert list(got[0]) == list(want[0])
    assert set(metrics) <= set(got[0]), sorted(got[0])
    for w, g in zip(want, got):
        for key in w:
            _close(g, w, key)


def test_edge_level_finetune_matches_jax(tmp_path, monkeypatch):
    """ogbl-ppa: 70 train edges -> 35 positives a percent-50 epoch and 35
    global negatives, 56 of the 70 samples trained, 14 valid (= test)."""
    monkeypatch.setattr(theads, "auc_neg_idx", lambda n, k, gen, device: torch.from_numpy(
        np.asarray(jax.random.randint(jax.random.PRNGKey(0), (n, k), 0, n))).long().to(device))
    jpipe, tpipe = _run_both(tmp_path, "ogbl-ppa", _edge_cfg, n=80, m=100)
    assert len(tpipe.dataset) == 70 and len(tpipe.train_idx) == 56
    _assert_runs_match(tmp_path, jpipe, tpipe, 14,
                       ("valid_hits@100", "valid_ema_hits@100", "test_hits@100"))


def test_long_stacked_node_level_finetune_matches_jax(tmp_path):
    """ogbn-proteins: the reader's 90 train nodes, 72 trained, 18 valid."""
    jpipe, tpipe = _run_both(tmp_path, "ogbn-proteins", _node_cfg, n=150, m=420)
    assert type(tpipe.tokenizer).__name__ == "StackedGSTTokenizerLong"
    assert tpipe.cfg.model.stacked_feat == 12 and len(tpipe.train_idx) == 72
    _assert_runs_match(tmp_path, jpipe, tpipe, 18, ("valid_auroc", "valid_ema_auroc"))


def test_long_stacked_pretrain_matches_jax(tmp_path):
    write_big_store(tmp_path / "data", "ogbn-proteins", n=150, m=420)
    jpipe = jpipeline.PretrainPipeline(_pt_cfg(JConfig, tmp_path / "data",
                                               tmp_path / "jax")).setup()
    params = jax.tree_util.tree_map(np.asarray, jpipe.state.params)
    jpipe.run()
    tpipe = tpipeline.PretrainPipeline(_pt_cfg(TConfig, tmp_path / "data", tmp_path / "port"),
                                       device="cpu").setup()
    np.testing.assert_array_equal(tpipe.train_idx, jpipe.train_idx)
    _port_from_jax(tpipe, params)
    tpipe.run()
    want, got = _rows(tmp_path / "jax" / "log.csv"), _rows(tmp_path / "port" / "log.csv")
    assert len(got) == len(want) == 3
    for w, g in zip(want, got):
        assert g["step"] == w["step"]
        for key in ("loss", "lr"):
            _close(g, w, key)
        _close(g, w, "grad_norm", 1e-3)
