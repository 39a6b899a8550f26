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
are held to.
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


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both pipelines on the shipped config from the same weights: (JAX's
    log rows, the port's, the port's pipeline)."""
    tmp = tmp_path_factory.mktemp("toy")
    saved_threads = torch.get_num_threads()
    torch.set_num_threads(2)
    saved = (jeuler._NATIVE_CHECKED, jeuler._NATIVE, teuler._NATIVE_CHECKED, teuler._NATIVE)
    jeuler._NATIVE_CHECKED, jeuler._NATIVE = True, None  # the numpy walks
    teuler._NATIVE_CHECKED, teuler._NATIVE = True, None
    try:
        jpipe = jpipeline.PretrainPipeline(jload(CONFIG, _overrides(tmp / "jax"))).setup()
        params = jax.tree_util.tree_map(np.asarray, jpipe.state.params)
        jpipe.run()
        tpipe = tpipeline.PretrainPipeline(tload(CONFIG, _overrides(tmp / "port")),
                                           device="cpu").setup()
        tpipe.state.model.load_state_dict(params_from_jax(params, device="cpu"))
        tpipe.state = init_train_state(tpipe.state.model, tpipe.tx,
                                       use_ema=tpipe.cfg.training.optimizer.use_ema)
        tpipe.run()
    finally:
        jeuler._NATIVE_CHECKED, jeuler._NATIVE, teuler._NATIVE_CHECKED, teuler._NATIVE = saved
        torch.set_num_threads(saved_threads)
    return _rows(tmp / "jax" / "log.csv"), _rows(tmp / "port" / "log.csv"), tpipe


def test_the_shipped_toy_model_is_the_fp32_kernels_path(runs):
    """What the card's fp32 forms take from this config: fp32, heads of 64
    (the kernels' width), D and F multiples of 64, P within MAX_P, no
    LayerScale, DropPath or MLP dropout (which would take the split MLP)."""
    m = runs[2].cfg.model
    assert (m.dtype, m.hidden_size, m.num_hidden_layers, m.num_attention_heads, m.head_dim,
            m.intermediate_size) == ("float32", 128, 2, 2, 64, 512)
    assert runs[2].cfg.training.max_length == 128 and not m.causal_attention
    assert not (m.layer_scale_init_value or m.path_dropout or m.mlp_dropout)


def test_the_per_step_losses_match_jax(runs):
    want, got, _ = runs
    assert [r["step"] for r in got] == [r["step"] for r in want] == [str(i + 1)
                                                                     for i in range(STEPS)]
    for w, g in zip(want, got):
        for key in ("loss", "lr"):
            a, b = float(g[key]), float(w[key])
            assert abs(a - b) <= REL * abs(b), (g["step"], key, a, b)
