"""The port's pipelines against the JAX package's on a graph-level reader's
store, on the CPU, with both packages' default (C++) walks.

`FinetunePipeline`: both read the same pcqm4m-v2 npz store (hidden 64, 2
layers, fp32, LayerScale on, embeddings frozen, EMA on, two epochs of 6
steps) from the same weights, the JAX pipeline's initial parameters loaded
into the port's model. Their three splits are the store's, equal as integer
arrays; each epoch resets the dataset's node permutations. The per-step
losses agree to 1e-4 relative (fp32 sums in another order through two
layers and twelve AdamW steps), and the eval metrics of each epoch to 1e-4
relative. `PretrainPipeline` on an ogbg-molpcba store: three packed steps,
per-step losses to 1e-4 relative.

The stores hold a single-node and a disconnected molecule but no edge-free
molecule of several nodes: the JAX tokenizer raises on one (it indexes its
empty edge_attr), which the port repairs (`tests/test_torch_readers.py`).
"""

import csv

import jax
import numpy as np
import pytest
import torch

from graphgpt_tpu.config import Config as JConfig
from graphgpt_tpu.training import finetune as jft
from graphgpt_tpu.training import pipeline as jpipeline
from graphgpt_torch.config import Config as TConfig
from graphgpt_torch.training import finetune as tft
from graphgpt_torch.training import pipeline as tpipeline
from graphgpt_torch.training.steps import init_train_state
from graphgpt_torch.utils.convert import params_from_jax
from test_torch_readers import assert_splits_equal, write_store
from test_torch_jax_native import jax_native_library  # noqa: F401  (autouse: JAX's C++ library)

REL = 1e-4


def _cfg(cls, data_dir, out_dir, name):
    cfg = cls()
    tok = cfg.tokenization
    tok.dataset, tok.data_dir = name, str(data_dir)
    tok.semantics.node.discrete, tok.semantics.node.dim = "node_attr", 9
    tok.semantics.edge.discrete, tok.semantics.edge.dim = "edge_attr", 3
    m = cfg.model
    m.hidden_size, m.num_hidden_layers, m.head_dim, m.dtype = 64, 2, 16, "float32"
    t = cfg.training
    t.num_workers, t.output_dir = 0, str(out_dir)
    return cfg


def _ft_cfg(cls, data_dir, out_dir):
    cfg = _cfg(cls, data_dir, out_dir, "pcqm4m-v2")
    m = cfg.model
    m.problem_type, m.loss_type, m.num_labels = "regression", "l1", 1
    m.layer_scale_init_value = 1.0
    t = cfg.training
    t.task_type = "graph"
    t.batch_size, t.max_length = 8, 128
    t.schedule.epochs, t.schedule.logging_steps = 2, 1
    t.optimizer.use_ema, t.freeze, t.k_samplers = True, 0, 16
    return cfg


def _pt_cfg(cls, data_dir, out_dir):
    cfg = _cfg(cls, data_dir, out_dir, "ogbg-molpcba")
    t = cfg.training
    t.batch_size, t.max_length, t.pack_tokens = 8, 256, 1
    t.schedule.total_num_steps, t.schedule.warmup_num_steps = 3, 1
    t.schedule.logging_steps, t.schedule.steps_per_saving = 1, 0
    t.valid_percent, t.do_valid, t.gen_eval_bands = 0.01, False, 0
    t.inspect_tokenization = False
    return cfg


def _rows(path):
    with open(path) as f:
        return list(csv.DictReader(f))


def _close(got, want, key, rel=REL):
    g, w = float(got[key]), float(want[key])
    assert abs(g - w) <= rel * abs(w) + 1e-9, (key, g, w)


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    """Two intra-op threads: the test workers share the machine's cores."""
    saved = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(saved)


def _port_from_jax(tpipe, params):
    model = tpipe.state.model
    model.load_state_dict(params_from_jax(params, device="cpu"))
    tpipe.state = init_train_state(model, tpipe.tx, use_ema=tpipe.cfg.training.optimizer.use_ema)


@pytest.fixture(scope="module")
def finetune_runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("graph_ft")
    write_store(tmp / "data" / "pcqm4m-v2" / "graphs.npz", n_graphs=72, splits=(48, 12, 12),
                edge_free=False)
    jpipe = jft.FinetunePipeline(_ft_cfg(JConfig, tmp / "data", tmp / "jax")).setup()
    params = jax.tree_util.tree_map(np.asarray, jpipe.state.params)
    jpipe.run()
    tpipe = tft.FinetunePipeline(_ft_cfg(TConfig, tmp / "data", tmp / "port"),
                                 device="cpu").setup()
    _port_from_jax(tpipe, params)
    tpipe.run()
    return tmp / "jax", tmp / "port", jpipe, tpipe


def test_finetune_splits_are_the_stores(finetune_runs):
    _, _, jpipe, tpipe = finetune_runs
    assert_splits_equal((tpipe.train_idx, tpipe.valid_idx, tpipe.test_idx),
                        (jpipe.train_idx, jpipe.valid_idx, jpipe.test_idx))
    np.testing.assert_array_equal(tpipe.train_idx, np.arange(48))
    np.testing.assert_array_equal(tpipe.test_idx, np.arange(60, 72))
    assert tpipe.dataset.epoch == jpipe.dataset.epoch == 1


def test_finetune_per_step_losses_match_jax(finetune_runs):
    jdir, tdir, _, _ = finetune_runs
    want, got = _rows(jdir / "loss.csv"), _rows(tdir / "loss.csv")
    assert len(got) == len(want) == 12
    for w, g in zip(want, got):
        assert g["step"] == w["step"] and g["epoch"] == w["epoch"]
        for key in ("loss", "task_loss", "lr"):
            _close(g, w, key)
        _close(g, w, "grad_norm", 1e-3)


def test_finetune_result_csv_matches_jax(finetune_runs):
    jdir, tdir, _, _ = finetune_runs
    want, got = _rows(jdir / "result.csv"), _rows(tdir / "result.csv")
    assert len(got) == len(want) == 2
    assert list(got[0]) == list(want[0])
    for w, g in zip(want, got):
        for key in w:
            _close(g, w, key)
    assert {"train_mae", "valid_mae", "valid_ema_mae", "test_mae"} <= set(got[0])


def test_pretrain_per_step_losses_match_jax(tmp_path):
    write_store(tmp_path / "data" / "ogbg-molpcba" / "graphs.npz", "ogbg-molpcba",
                n_graphs=400, splits=None, edge_free=False)
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
