"""`configs/toy_pretrain.yaml`, the README's quick start, through the port's
`PretrainPipeline` against the JAX package's, on the CPU.

The config as shipped (hidden 128, 2 layers of 2 heads of 64, FFN 512,
float32, pretrain-mlm on `synthetic_mol`, 128 packed positions, batch 8,
no worker processes) read by both packages' `load_config`, with four
steps, a log row a step, no save-point eval and the output directory by
override. Both start from the same weights (the JAX pipeline's initial
parameters carried into the port's model by `utils/convert.py`) and walk
in numpy (both C++ walks off), so they see the same batches. The per-step
losses agree to 1e-5 relative: fp32 through two layers and four AdamW
steps, sums in another order (read: at most 6e-7). On the card the same
model runs the fp32 forms of kernels #1, #2, #3 and #13 (`chip_smoke.py`'s
phase L); here the wrappers take their plain versions, which those forms
are held to. The port's run again under GGT_FLASH_MODE=skip (the port's
`_MODE`), which sends every P to the streamed kernels #6-#8 (their fp32
forms on the card, phase O) with q and k rotated outside, holds the same
losses: the JAX pipeline on the CPU takes its XLA attention whatever its
mode (`ops/attention.py`, "auto" below a TPU), the function both modes
compute.
"""

import csv
import os

import jax
import numpy as np
import pytest
import torch

from graphgpt_tpu.config import load_config as jload
from graphgpt_tpu.data import euler as jeuler
from graphgpt_tpu.training import pipeline as jpipeline
from graphgpt_torch.config import load_config as tload
from graphgpt_torch.data import euler as teuler
from graphgpt_torch.ops import flash_attention as tfa
from graphgpt_torch.training import pipeline as tpipeline
from graphgpt_torch.training.steps import init_train_state
from graphgpt_torch.utils.convert import params_from_jax
from test_torch_jax_native import jax_native_library  # noqa: F401  (autouse: JAX's C++ library)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG = os.path.join(ROOT, "configs", "toy_pretrain.yaml")
STEPS = 4
REL = 1e-5


def _overrides(out_dir):
    """Four steps, a log row each; no save-point eval (the valid loss and the
    generation sweep are held to JAX's in test_torch_pretrain_pipeline.py)."""
    return [f"training.output_dir={out_dir}", f"training.schedule.total_num_steps={STEPS}",
            "training.schedule.logging_steps=1", "training.do_valid=false"]


def _rows(path):
    with open(path) as f:
        return list(csv.DictReader(f))


def _port_run(cfg_dir, params):
    """The port's pipeline on the shipped config from JAX's initial weights:
    (its log rows, the pipeline)."""
    tpipe = tpipeline.PretrainPipeline(tload(CONFIG, _overrides(cfg_dir)), device="cpu").setup()
    tpipe.state.model.load_state_dict(params_from_jax(params, device="cpu"))
    tpipe.state = init_train_state(tpipe.state.model, tpipe.tx,
                                   use_ema=tpipe.cfg.training.optimizer.use_ema)
    tpipe.run()
    return _rows(cfg_dir / "log.csv"), tpipe


@pytest.fixture(scope="module")
def numpy_walks():
    """Both packages walk in numpy (both C++ walks off), on two threads."""
    saved_threads = torch.get_num_threads()
    torch.set_num_threads(2)
    saved = (jeuler._NATIVE_CHECKED, jeuler._NATIVE, teuler._NATIVE_CHECKED, teuler._NATIVE)
    jeuler._NATIVE_CHECKED, jeuler._NATIVE = True, None
    teuler._NATIVE_CHECKED, teuler._NATIVE = True, None
    yield
    jeuler._NATIVE_CHECKED, jeuler._NATIVE, teuler._NATIVE_CHECKED, teuler._NATIVE = saved
    torch.set_num_threads(saved_threads)


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory, numpy_walks):
    """The JAX pipeline on the shipped config: (its initial parameters, its
    log rows)."""
    tmp = tmp_path_factory.mktemp("toy_jax")
    jpipe = jpipeline.PretrainPipeline(jload(CONFIG, _overrides(tmp))).setup()
    params = jax.tree_util.tree_map(np.asarray, jpipe.state.params)
    jpipe.run()
    return params, _rows(tmp / "log.csv")


@pytest.fixture(scope="module")
def runs(tmp_path_factory, jax_run):
    """Both pipelines on the shipped config from the same weights: (JAX's
    log rows, the port's, the port's pipeline)."""
    params, want = jax_run
    got, tpipe = _port_run(tmp_path_factory.mktemp("toy_port"), params)
    return want, got, tpipe


@pytest.fixture(scope="module")
def skip_run(tmp_path_factory, jax_run):
    """The port's run under skip from the same weights: (JAX's log rows, the
    port's, the calls of each streamed wrapper and of #1's and #3's)."""
    params, want = jax_run
    names = ("flash_fwd_stream", "flash_dq_stream", "flash_dkv_stream", "flash_attention_ref",
             "flash_bwd_ref")
    calls = {n: 0 for n in names}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tfa, "_MODE", "skip")
        for n in names:
            def wrapped(*a, _fn=getattr(tfa, n), _n=n, **k):
                calls[_n] += 1
                return _fn(*a, **k)

            mp.setattr(tfa, n, wrapped)
        got, _ = _port_run(tmp_path_factory.mktemp("toy_skip"), params)
    return want, got, calls


def test_the_shipped_toy_model_is_the_fp32_kernels_path(runs):
    """What the card's fp32 forms take from this config: fp32, heads of 64
    (the kernels' width), D and F multiples of 64, P within MAX_P, no
    LayerScale, DropPath or MLP dropout (which would take the split MLP)."""
    m = runs[2].cfg.model
    assert (m.dtype, m.hidden_size, m.num_hidden_layers, m.num_attention_heads, m.head_dim,
            m.intermediate_size) == ("float32", 128, 2, 2, 64, 512)
    assert runs[2].cfg.training.max_length == 128 and not m.causal_attention
    assert not (m.layer_scale_init_value or m.path_dropout or m.mlp_dropout)


def _assert_losses_match(want, got):
    assert [r["step"] for r in got] == [r["step"] for r in want] == [str(i + 1)
                                                                     for i in range(STEPS)]
    for w, g in zip(want, got):
        for key in ("loss", "lr"):
            a, b = float(g[key]), float(w[key])
            assert abs(a - b) <= REL * abs(b), (g["step"], key, a, b)


def test_the_per_step_losses_match_jax(runs):
    want, got, _ = runs
    _assert_losses_match(want, got)


def test_the_per_step_losses_under_skip_match_jax(skip_run):
    """Under skip the port's steps go through the streamed route only: #6,
    #7 and #8 once a layer a step (with remat off, as shipped), the
    whole-row plain attention (#1's route) and the fused backward never."""
    want, got, calls = skip_run
    _assert_losses_match(want, got)
    L = 2
    assert calls["flash_fwd_stream"] == calls["flash_dq_stream"] == STEPS * L
    assert calls["flash_dkv_stream"] == STEPS * L
    assert calls["flash_bwd_ref"] == 0
    # flash_fwd_stream's plain version is flash_attention_ref in REF_ROWS chunks
    assert calls["flash_attention_ref"] == calls["flash_fwd_stream"]
