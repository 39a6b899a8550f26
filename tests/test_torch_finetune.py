"""The port's fine-tune pipeline against the JAX package's, on the CPU.

Both pipelines run the same config on `synthetic_mol` (hidden 64, 2 layers,
fp32, dropout 0, LayerScale on, embeddings frozen, EMA on, two epochs of 6
steps) from the same weights: the JAX pipeline's initial parameters are
loaded into the port's model. Both walk in numpy (both packages' C++
walks are switched off), so the batches are the same. The per-step losses
agree to 1e-4 relative (fp32 sums in another order through two layers and
twelve AdamW steps), and the eval metrics of each epoch to 1e-4 relative.
"""

import csv
import os

import jax
import numpy as np
import pytest
import torch

from graphgpt_tpu.config import Config as JConfig
from graphgpt_tpu.data import euler as jeuler
from graphgpt_tpu.training import finetune as jft
from graphgpt_torch.config import Config as TConfig
from graphgpt_torch.data import euler as teuler
from graphgpt_torch.models.heads import GraphGPTPretrain, GraphGPTTask
from graphgpt_torch.training import finetune as tft
from graphgpt_torch.training.checkpoint import Checkpointer, restore_params_warmstart
from graphgpt_torch.training.optimizer import make_optimizer
from graphgpt_torch.training.steps import init_train_state
from graphgpt_torch.utils.convert import params_from_jax

REL = 1e-4


def _cfg(cls, out_dir, **training):
    cfg = cls()
    cfg.tokenization.semantics.node.discrete = "node_attr"
    cfg.tokenization.semantics.node.dim = 9
    cfg.tokenization.semantics.edge.discrete = "edge_attr"
    cfg.tokenization.semantics.edge.dim = 3
    m = cfg.model
    m.hidden_size, m.num_hidden_layers, m.head_dim, m.dtype = 64, 2, 16, "float32"
    m.problem_type, m.loss_type, m.num_labels = "regression", "l1", 1
    m.layer_scale_init_value = 1.0
    t = cfg.training
    t.task_type = "graph"
    t.batch_size, t.max_length, t.num_workers = 8, 128, 0
    t.schedule.epochs, t.schedule.logging_steps = 2, 1
    t.optimizer.use_ema, t.freeze, t.k_samplers = True, 0, 16
    t.output_dir = str(out_dir)
    for k, v in training.items():
        setattr(t, k, v)
    return cfg


def _shrink(pipe):
    pipe.dataset.size = 96
    pipe.train_idx = pipe.train_idx[pipe.train_idx < 96][:48]
    pipe.valid_idx = pipe.valid_idx[pipe.valid_idx < 96][:16]
    pipe.test_idx = pipe.valid_idx


def _rows(path):
    with open(path) as f:
        return list(csv.DictReader(f))


@pytest.fixture(scope="module")
def port_numpy_walk():
    """The port's walk pinned to numpy for the module, as the JAX package's
    is around its runs below."""
    saved = (teuler._NATIVE_CHECKED, teuler._NATIVE)
    teuler._NATIVE_CHECKED, teuler._NATIVE = True, None
    yield
    teuler._NATIVE_CHECKED, teuler._NATIVE = saved


@pytest.fixture(scope="module")
def runs(tmp_path_factory, port_numpy_walk):
    """Both pipelines run from the same weights: (jax dir, port dir, port
    pipeline, initial port state dict)."""
    tmp = tmp_path_factory.mktemp("ft")
    saved = (jeuler._NATIVE_CHECKED, jeuler._NATIVE)
    jeuler._NATIVE_CHECKED, jeuler._NATIVE = True, None  # the numpy walk
    try:
        jpipe = jft.FinetunePipeline(_cfg(JConfig, tmp / "jax")).setup()
        _shrink(jpipe)
        params = jax.tree_util.tree_map(np.asarray, jpipe.state.params)
        jpipe.run()
    finally:
        jeuler._NATIVE_CHECKED, jeuler._NATIVE = saved
    tpipe = tft.FinetunePipeline(_cfg(TConfig, tmp / "port"), device="cpu").setup()
    _shrink(tpipe)
    model = tpipe.state.model
    model.load_state_dict(params_from_jax(params, device="cpu"))
    tpipe.state = init_train_state(model, tpipe.tx, use_ema=True)
    init = {k: v.clone() for k, v in model.state_dict().items()}
    tpipe.run()
    return tmp / "jax", tmp / "port", tpipe, init


def test_per_step_losses_match_jax(runs):
    jdir, tdir, _, _ = runs
    want, got = _rows(jdir / "loss.csv"), _rows(tdir / "loss.csv")
    assert len(got) == len(want) == 12
    for w, g in zip(want, got):
        assert g["step"] == w["step"]
        for key in ("loss", "task_loss", "lr"):
            assert abs(float(g[key]) - float(w[key])) <= REL * abs(float(w[key])) + 1e-9, key
        assert abs(float(g["grad_norm"]) - float(w["grad_norm"])) <= 1e-3 * float(w["grad_norm"])


def test_result_csv_matches_jax(runs):
    jdir, tdir, _, _ = runs
    want, got = _rows(jdir / "result.csv"), _rows(tdir / "result.csv")
    assert len(got) == len(want) == 2
    assert list(got[0]) == list(want[0])  # the same columns in the same order
    for w, g in zip(want, got):
        for key in w:
            assert abs(float(g[key]) - float(w[key])) <= REL * abs(float(w[key])) + 1e-9, key
    assert {"train_mae", "valid_mae", "valid_ema_mae", "test_mae"} <= set(got[0])


def test_frozen_embeddings_stay_and_the_rest_trains(runs):
    _, tdir, tpipe, init = runs
    sd = tpipe.state.model.state_dict()
    assert torch.equal(sd["model.embed_tokens.weight"], init["model.embed_tokens.weight"])
    assert not torch.equal(sd["model.layers.0.mlp.gate_proj.weight"],
                           init["model.layers.0.mlp.gate_proj.weight"])
    assert not torch.equal(sd["score.weight"], init["score.weight"])


def test_checkpoints_and_eval_only_sweep(runs, tmp_path):
    """One checkpoint per epoch and one EMA-best; eval_only restores each
    epoch and gives that epoch's valid metrics again."""
    _, tdir, tpipe, _ = runs
    assert Checkpointer(str(tdir / "ckpt")).all_steps() == [0, 1]
    assert len(Checkpointer(str(tdir / "ckpt_ema_best")).all_steps()) == 1
    cfg = _cfg(TConfig, tmp_path / "eval_only", eval_only=True, k_samplers=0,
               pretrain_cpt=str(tdir))
    pipe = tft.FinetunePipeline(cfg, device="cpu").setup()
    pipe.valid_idx = tpipe.valid_idx
    pipe.test_idx = np.asarray([], dtype=np.int64)
    pipe.run()
    rows, trained = _rows(tmp_path / "eval_only" / "result.csv"), _rows(tdir / "result.csv")
    assert [int(r["epoch"]) for r in rows] == [0, 1]
    for r, t in zip(rows, trained):
        for key in ("valid_mae", "valid_ema_mae"):
            assert float(r[key]) == pytest.approx(float(t[key]), rel=1e-9)
    assert not os.listdir(tmp_path / "eval_only" / "ckpt_ema_best")


def test_warm_start_takes_the_backbone_and_skips_the_heads(tmp_path):
    """A pretrain checkpoint's backbone goes in; a head of the same name and
    shape in it (score) is skipped, as are the NTP heads."""
    cfg = _cfg(TConfig, tmp_path / "ft", pretrain_cpt=str(tmp_path / "pt"))
    probe = tft.FinetunePipeline(_cfg(TConfig, tmp_path / "probe"), device="cpu").setup()
    src = GraphGPTTask(probe.cfg.model, device="cpu", seed=7)
    tx = make_optimizer(probe.cfg.training.optimizer, 10, 1)
    Checkpointer(str(tmp_path / "pt" / "ckpt")).save(3, init_train_state(src, tx))
    pipe = tft.FinetunePipeline(cfg, device="cpu").setup()
    got = pipe.state.model.state_dict()
    fresh = GraphGPTTask(pipe.cfg.model, device="cpu", seed=cfg.training.seed).state_dict()
    for name, val in got.items():
        want = fresh[name] if name.startswith("score") else src.state_dict()[name]
        assert torch.equal(val, want), name
    # a pretrain model's lm_head and n_token_proj are never taken
    pt = GraphGPTPretrain(pipe.cfg.model, device="cpu", seed=5)
    Checkpointer(str(tmp_path / "pt2" / "ckpt")).save(0, init_train_state(pt, tx))
    template = {"lm_head.weight": torch.zeros_like(pt.lm_head.weight),
                "model.norm.weight": torch.zeros(64)}
    out = restore_params_warmstart(str(tmp_path / "pt2" / "ckpt"), template,
                                   skip_prefixes=tft.HEAD_PREFIXES)
    assert not out["lm_head.weight"].any() and torch.equal(out["model.norm.weight"],
                                                           pt.model.norm.weight)
