"""The port's pretraining pipeline against the JAX package's, on the CPU.

Both `PretrainPipeline`s run the same config on `synthetic_mol` (hidden 64,
2 layers of 4 heads, fp32, max_length 256 with packing, batch 8 (the JAX
package's CPU test mesh has 8 devices), EMA, four steps with save points at
steps 2 and 4, a generation sweep of 2 bands over 8 graphs) from the same
weights: the JAX pipeline's initial
parameters are loaded into the port's model. Both walk in numpy (both
packages' C++ walks are switched off), so the batches are the same (the
loaders tokenize in their own thread: the worker pool's batches are held
to JAX's in tests/test_torch_pretrain_data.py). The per-step
losses, learning rates and gradient norms agree to 1e-4 relative (fp32
sums in another order through two layers and four AdamW steps), and so do
result.csv's valid and EMA-valid losses; the generation accuracies are
counts of argmax picks from near-equal logits and agree to GEN_ATOL. The
valid set packs into exactly one eval batch here, so that the JAX loader,
which drops a partial eval batch, evaluates every row too; a test below
shows that difference.
"""

import csv
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from graphgpt_tpu.config import Config as JConfig
from graphgpt_tpu.data import euler as jeuler
from graphgpt_tpu.training import pipeline as jpipeline
from graphgpt_torch.config import Config as TConfig
from graphgpt_torch.data import euler as teuler
from graphgpt_torch.training import pipeline as tpipeline
from graphgpt_torch.training.checkpoint import Checkpointer
from graphgpt_torch.training.steps import init_train_state
from graphgpt_torch.utils.convert import params_from_jax
from test_torch_jax_native import jax_native_library  # noqa: F401  (autouse: JAX's C++ library)

REL = 1e-4
# a generation accuracy is a count over ~4,800 masked cells of argmax picks
# (and confidence orderings) from logits that agree to ~1e-6; at random
# weights near-ties are many, and a flipped one moves the count by a cell
# or a few: 1e-3 is about five cells
GEN_ATOL = 1e-3
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _cfg(cls, out_dir, **training):
    cfg = cls()
    sem = cfg.tokenization.semantics
    sem.node.discrete, sem.node.dim = "node_attr", 9
    sem.edge.discrete, sem.edge.dim = "edge_attr", 3
    m = cfg.model
    m.hidden_size, m.num_hidden_layers, m.head_dim, m.dtype = 64, 2, 16, "float32"
    t = cfg.training
    t.batch_size, t.max_length, t.pack_tokens = 8, 256, 1
    t.num_workers = 0
    t.schedule.total_num_steps, t.schedule.warmup_num_steps = 4, 1
    t.schedule.logging_steps, t.schedule.steps_per_saving = 1, 2
    # 70 graphs: exactly 8 packed rows, one whole eval batch on both sides
    t.valid_percent, t.do_valid = 0.0014, True
    t.gen_eval_bands, t.gen_eval_samples = 2, 8
    t.optimizer.use_ema, t.optimizer.ema_decay = True, 0.9
    t.inspect_tokenization = False
    cfg.generation.steps = 4
    t.output_dir = str(out_dir)
    for k, v in training.items():
        setattr(t, k, v)
    return cfg


def _rows(path):
    with open(path) as f:
        return list(csv.DictReader(f))


def _close(got, want, key, rel=REL):
    g, w = float(got[key]), float(want[key])
    assert abs(g - w) <= rel * abs(w) + 1e-9, (key, g, w)


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    """Two intra-op threads for this module's torch work: the test workers
    share the machine's cores."""
    saved = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(saved)


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
    """Both pipelines from the same weights: (jax dir, port dir, JAX
    pipeline, port pipeline)."""
    tmp = tmp_path_factory.mktemp("pt")
    saved = (jeuler._NATIVE_CHECKED, jeuler._NATIVE)
    jeuler._NATIVE_CHECKED, jeuler._NATIVE = True, None  # the numpy walk
    try:
        jpipe = jpipeline.PretrainPipeline(_cfg(JConfig, tmp / "jax")).setup()
        params = jax.tree_util.tree_map(np.asarray, jpipe.state.params)
        jpipe.run()
    finally:
        jeuler._NATIVE_CHECKED, jeuler._NATIVE = saved
    tpipe = tpipeline.PretrainPipeline(_cfg(TConfig, tmp / "port"), device="cpu").setup()
    model = tpipe.state.model
    model.load_state_dict(params_from_jax(params, device="cpu"))
    tpipe.state = init_train_state(model, tpipe.tx, use_ema=True)
    tpipe.run()
    return tmp / "jax", tmp / "port", jpipe, tpipe


def test_schedule_and_model_fields_follow_jax(runs):
    _, _, jpipe, tpipe = runs
    assert (tpipe.total_steps, tpipe.warmup_steps) == (jpipe.total_steps, jpipe.warmup_steps)
    for key in ("vocab_size", "mask_token_id", "eos_token_id", "bos_token_id", "attn_block",
                "stacked_feat", "next_n_token", "causal_attention"):
        assert getattr(tpipe.cfg.model, key) == getattr(jpipe.cfg.model, key), key
    np.testing.assert_array_equal(tpipe.valid_idx, jpipe.valid_idx)
    # the token budget decides when no step count is given
    cfg = _cfg(TConfig, "unused")
    cfg.training.schedule.total_num_steps = cfg.training.schedule.warmup_num_steps = 0
    want = jpipeline.opt_lib.compute_total_steps(
        cfg.training.schedule.total_tokens, cfg.training.schedule.warmup_tokens, 256.0, 4)
    assert tpipeline.opt_lib.compute_total_steps(
        cfg.training.schedule.total_tokens, cfg.training.schedule.warmup_tokens, 256.0, 4) == want


def test_per_step_losses_match_jax(runs):
    jdir, tdir, _, _ = runs
    want, got = _rows(jdir / "log.csv"), _rows(tdir / "log.csv")
    assert len(got) == len(want) == 4
    for w, g in zip(want, got):
        assert g["step"] == w["step"] and g["epoch"] == w["epoch"]
        for key in ("loss", "gen_loss", "lr"):
            _close(g, w, key)
        _close(g, w, "grad_norm", 1e-3)
        assert float(g["tokens_per_s"]) > 0 and float(g["tflops_per_s"]) > 0
        assert "mfu" not in g  # no card, no peak: as the JAX package off a TPU


def test_result_csv_matches_jax(runs):
    jdir, tdir, _, _ = runs
    want, got = _rows(jdir / "result.csv"), _rows(tdir / "result.csv")
    assert [r["step"] for r in got] == [r["step"] for r in want] == ["2", "4", "4"]
    assert list(got[0]) == list(want[0])  # the same columns in the same order
    for w, g in zip(want, got):
        assert g["epoch"] == w["epoch"]
        for key in ("valid_loss", "ema_valid_loss"):
            _close(g, w, key)
        for key in w:
            if key.startswith("gen_acc"):
                assert abs(float(g[key]) - float(w[key])) <= GEN_ATOL, key
    assert {"valid_loss", "ema_valid_loss", "gen_acc@umr_0.0-0.5",
            "gen_acc@umr_0.5-1.0"} <= set(got[0])


def test_checkpoints_and_auto_resume(runs, tmp_path):
    """A second pipeline on the same output_dir resumes at step 4 with the
    trained weights, takes two more steps and logs them."""
    _, tdir, _, tpipe = runs
    assert Checkpointer(str(tdir / "ckpt")).all_steps() == [2, 4]
    trained = {k: v.clone() for k, v in tpipe.state.model.state_dict().items()}
    cfg = _cfg(TConfig, tdir, gen_eval_bands=0)
    cfg.training.schedule.total_num_steps = 6
    pipe = tpipeline.PretrainPipeline(cfg, device="cpu").setup()
    assert (pipe.start_step, pipe.state.step) == (4, 4)
    for k, v in pipe.state.model.state_dict().items():
        assert torch.equal(v, trained[k]), k
    pipe.run()
    assert pipe.state.step == 6
    assert [r["step"] for r in _rows(tdir / "log.csv")] == ["1", "2", "3", "4", "5", "6"]
    assert Checkpointer(str(tdir / "ckpt")).latest_step() == 6


def test_eval_keeps_the_last_partial_batch(runs):
    """Repair: from 20 valid graphs (about three packed rows, fewer than the
    batch of 8) the JAX pipeline's save-point eval gets no batch, so its
    result.csv would have no valid loss at all; the port evaluates every
    row, in one partial batch."""
    _, _, jpipe, tpipe = runs
    vidx = tpipe.valid_idx[:20]
    saved = (jeuler._NATIVE_CHECKED, jeuler._NATIVE)
    jeuler._NATIVE_CHECKED, jeuler._NATIVE = True, None
    try:
        want = list(jpipe._eval_batches(vidx))
    finally:
        jeuler._NATIVE_CHECKED, jeuler._NATIVE = saved
    got = list(tpipe._eval_batches(vidx))
    assert want == []
    assert len(got) == 1 and 0 < got[0]["input_ids"].shape[0] < 8
    losses, ema = tpipe._eval_losses(vidx, ema=True)
    assert len(losses) == len(ema) == 1 and np.isfinite(losses[0])


def test_the_tensorboard_writer_raises(tmp_path):
    cfg = _cfg(TConfig, tmp_path, use_tb_writer=True)
    with pytest.raises(NotImplementedError, match="TensorBoard"):
        tpipeline.PretrainPipeline(cfg, device="cpu").setup()


def test_smoke_cli_runs(tmp_path):
    """`python -m graphgpt_torch.training.pipeline --smoke --device cpu`:
    the JAX package's smoke run end to end, its log and result files."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(PYTHONPATH=ROOT, SMOKE_DIR=str(tmp_path / "smoke"), OMP_NUM_THREADS="2")
    proc = subprocess.run(
        [sys.executable, "-m", "graphgpt_torch.training.pipeline", "--smoke", "--device", "cpu"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    assert "smoke test done" in proc.stdout
    log = _rows(tmp_path / "smoke" / "log.csv")
    assert [r["step"] for r in log] == ["10", "20", "30"]
    assert all(np.isfinite(float(r["loss"])) for r in log)
    res = _rows(tmp_path / "smoke" / "result.csv")
    assert len(res) == 1 and np.isfinite(float(res[0]["valid_loss"]))
