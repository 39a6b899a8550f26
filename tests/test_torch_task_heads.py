"""The port's fine-tune task model against the JAX package's, on the CPU.

`GraphGPTTask` against `task_forward` for each problem type and head: the
same JAX-initialised weights (`init_task_params` through `params_from_jax`),
the same numpy batch, fp32, the JAX package's plain XLA path. The loss
agrees to 1e-5 and every gradient to 2e-4 in the relative Frobenius norm
(and elementwise to 1e-6 + 1e-3 * |g|): fp32 sums in another order through
two layers and the head. The AUC loss draws its negatives at random: the
port is handed the JAX draws. Also here: the fine-tune losses, the weight
converter's score heads and the freeze transform.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from graphgpt_tpu.config import ModelConfig as JConfig
from graphgpt_tpu.config import OptimizerConfig as JOptConfig
from graphgpt_tpu.models import heads as jheads
from graphgpt_tpu.ops import losses as jlosses
from graphgpt_tpu.training import optimizer as jopt
from graphgpt_tpu.training.finetune import make_freeze_transform as jfreeze
from graphgpt_torch.config import ModelConfig as TConfig
from graphgpt_torch.config import OptimizerConfig as TOptConfig
from graphgpt_torch.models import heads as theads
from graphgpt_torch.models.heads import GraphGPTTask
from graphgpt_torch.ops import losses as tlosses
from graphgpt_torch.synthetic import to_torch
from graphgpt_torch.training.finetune import make_freeze_transform as tfreeze
from graphgpt_torch.training.optimizer import make_optimizer
from graphgpt_torch.utils.convert import params_from_jax, params_to_jax, tree_from_jax

COMMON = dict(vocab_size=50, hidden_size=128, num_hidden_layers=2, stacked_feat=3,
              next_n_token=1, mask_token_id=1, dtype="float32", use_generative=False,
              attn_impl="xla", mlp_kernel="off", task_type="graph")
REL, ATOL, RTOL = 2e-4, 1e-6, 1e-3
B, P, F = 4, 64, 3
LENGTHS = (64, 50, 33, 20)

CASES = {
    "regression-l1": dict(problem_type="regression", loss_type="l1"),
    "regression-mse-mean": dict(problem_type="regression", loss_type="mse", pooling_method="mean"),
    "regression-sum": dict(problem_type="regression", loss_type="l1", pooling_method="sum"),
    "regression-score-mlp": dict(problem_type="regression", loss_type="l1", mlp=(32,)),
    "single-label-ce": dict(problem_type="single_label_classification", num_labels=2),
    "single-label-sample-wgt": dict(problem_type="single_label_classification", num_labels=2),
    "single-label-score-mlp": dict(problem_type="single_label_classification", num_labels=3,
                                   mlp=(32, 16)),
    "single-label-auc": dict(problem_type="single_label_classification", num_labels=2,
                             loss_type="auc", num_neg=3),
    "multi-label": dict(problem_type="multi_label_classification", num_labels=4),
    "nodev2-token-ce": dict(task_type="nodev2", loss_type="token_ce", num_labels=3),
    "nodev2-token-ce-intra": dict(task_type="nodev2", loss_type="token_ce_intra", num_labels=3),
    "regression-aux-ntp": dict(problem_type="regression", loss_type="l1", use_aux=True,
                               next_n_token=3),
}


def _batch(case: str):
    """One graph per row (the task loader's rows), padded tails."""
    rng = np.random.default_rng(3)
    seg = np.zeros((B, P), np.int32)
    for r, n in enumerate(LENGTHS):
        seg[r, :n] = 1
    ids = np.where(seg[..., None] > 0, rng.integers(2, 50, size=(B, P, F)), 0).astype(np.int32)
    nb = {"input_ids": ids, "position_ids": np.tile(np.arange(P, dtype=np.int32), (B, 1)),
          "segment_ids": seg}
    kw = CASES[case]
    if kw.get("task_type") == "nodev2":
        lab = rng.integers(0, kw["num_labels"], size=(B, P))
        nb["nodev2_labels"] = np.where((seg > 0) & (rng.random((B, P)) < 0.5), lab, -100)
        nb["cls_idx"] = np.asarray([[10], [20], [5], [15]], np.int64)
    elif kw["problem_type"] == "regression":
        nb["graph_labels"] = rng.normal(5.0, 1.0, size=(B, 1)).astype(np.float32)
    elif kw["problem_type"] == "single_label_classification":
        nb["graph_labels"] = np.asarray([0, 1, 1, 0][:B] if kw["num_labels"] == 2 else
                                        [0, 2, 1, 2], np.float32)
    else:
        y = (rng.random((B, kw["num_labels"])) < 0.5).astype(np.float32)
        y[0, 1] = y[2, 3] = np.nan  # unlabelled tasks
        nb["graph_labels"] = y
    if case == "single-label-sample-wgt":
        nb["wgt"] = np.asarray([4.0, 0.1, 0.5, 1.0], np.float32)
    if case == "multi-label":
        nb["sample_wgt"] = np.asarray([1.0, 2.0, 0.5, 1.0], np.float32)
    if kw.get("use_aux"):
        nb["labels"] = np.where(rng.random((B, P, F)) < 0.3, ids, -100).astype(np.int32)
    return nb


@functools.lru_cache(maxsize=None)
def _jax_loss_and_grads(case: str):
    jcfg = JConfig(**{**COMMON, **CASES[case]}).finalize()
    params = jheads.init_task_params(jcfg, jax.random.PRNGKey(0))
    if "score_b" in params:  # off zero, so that the bias enters the check
        params["score_b"] = params["score_b"] + 0.3
    nb = {k: jnp.asarray(v) for k, v in _batch(case).items()}
    rng_loss = jax.random.PRNGKey(9)

    def loss_fn(p):
        out = jheads.task_forward(p, jcfg, nb, rng_loss=rng_loss)
        return out["loss"], out["task_logits"]

    (loss, logits), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(params)
    to_np = functools.partial(jax.tree_util.tree_map, np.asarray)
    return to_np(params), float(loss), to_np(grads), np.asarray(logits)


@pytest.mark.parametrize("case", sorted(CASES))
def test_task_model_loss_and_every_gradient_match_jax(case, monkeypatch):
    params, want_loss, want_grads, want_logits = _jax_loss_and_grads(case)
    if CASES[case].get("loss_type") == "auc":
        idx = np.array(jax.random.randint(jax.random.PRNGKey(9), (B, 3), 0, B))
        monkeypatch.setattr(theads, "auc_neg_idx", lambda *a: torch.from_numpy(idx).long())
    model = GraphGPTTask(TConfig(**{k: v for k, v in {**COMMON, **CASES[case]}.items()
                                    if k not in ("attn_impl", "mlp_kernel")}).finalize(),
                         device="cpu")
    model.load_state_dict(params_from_jax(params, device="cpu"))
    out = model(to_torch(_batch(case), "cpu"), train=True)
    np.testing.assert_allclose(out["task_logits"].detach().numpy(), want_logits, atol=1e-5,
                               rtol=1e-5)
    out["loss"].backward()
    assert abs(out["loss"].item() - want_loss) < 1e-5 * max(1.0, abs(want_loss))
    if CASES[case].get("use_aux"):
        assert out["pretrain_loss"].item() > 0 and "task_loss" in out
    want = tree_from_jax(want_grads, device="cpu")
    got = {k: p.grad if p.grad is not None else torch.zeros_like(p)
           for k, p in model.named_parameters()}
    assert set(got) == set(want)
    for name in sorted(got):
        g, w = got[name].numpy(), want[name].numpy()
        assert np.linalg.norm(g - w) <= REL * np.linalg.norm(w) + 1e-9, name
        np.testing.assert_allclose(g, w, atol=ATOL, rtol=RTOL, err_msg=name)


def test_score_heads_cross_the_converter_both_ways():
    for case in ("regression-score-mlp", "regression-l1", "single-label-ce"):
        params = _jax_loss_and_grads(case)[0]
        back = params_to_jax(params_from_jax(params, device="cpu"))
        for key in ("score_w", "score_b"):
            assert (key in back) == (key in params)
            if key in params:
                np.testing.assert_array_equal(back[key], params[key])
        for a, b in zip(back.get("score_mlp", []), params.get("score_mlp", [])):
            assert set(a) == set(b) and all(np.array_equal(a[k], b[k]) for k in a)


def test_auc_without_a_generator_draws_the_same_negatives():
    """The JAX train step passes no loss key, so the AUC loss pairs the same
    positions at every step; the port does the same without a generator."""
    a = theads.auc_neg_idx(16, 3, None, "cpu")
    b = theads.auc_neg_idx(16, 3, None, "cpu")
    c = theads.auc_neg_idx(16, 3, torch.Generator().manual_seed(1), "cpu")
    assert torch.equal(a, b) and not torch.equal(a, c) and int(a.max()) < 16


def test_head_dropout_masks_follow_the_generator():
    cfg = TConfig(**{k: v for k, v in {**COMMON, **CASES["regression-score-mlp"]}.items()
                     if k not in ("attn_impl", "mlp_kernel")}, head_dropout=0.5).finalize()
    model = GraphGPTTask(cfg, device="cpu", seed=1)
    batch = to_torch(_batch("regression-score-mlp"), "cpu")

    def loss(seed):
        return model(batch, generator=torch.Generator().manual_seed(seed), train=True)["loss"].item()

    assert loss(3) == loss(3) != loss(4)
    assert model(batch)["loss"].item() == model(batch)["loss"].item()


# ---------------------------------------------------------------------------
# the losses alone
# ---------------------------------------------------------------------------
def test_fine_tune_losses_match_jax():
    rng = np.random.default_rng(5)
    preds = rng.normal(size=(8, 1)).astype(np.float32)
    targets = rng.normal(size=(8,)).astype(np.float32)
    w = rng.random(8).astype(np.float32) + 0.1
    logits = rng.normal(size=(8, 5)).astype(np.float32)
    labels = rng.integers(0, 5, size=8)
    ml = (rng.random((8, 5)) < 0.5).astype(np.float32)
    ml[1, 2] = ml[4, 0] = np.nan
    t, j = torch.from_numpy, jnp.asarray
    pairs = [
        (tlosses.regression_loss(t(preds), t(targets), "l1"),
         jlosses.regression_loss(j(preds), j(targets), "l1")),
        (tlosses.regression_loss(t(preds), t(targets), "mse", t(w)),
         jlosses.regression_loss(j(preds), j(targets), "mse", j(w))),
        (tlosses.single_label_ce(t(logits), t(labels)), jlosses.single_label_ce(j(logits), j(labels))),
        (tlosses.single_label_ce(t(logits), t(labels), t(w)),
         jlosses.single_label_ce(j(logits), j(labels), j(w))),
        (tlosses.multi_label_bce(t(logits), t(ml), t(w)),
         jlosses.multi_label_bce(j(logits), j(ml), j(w))),
        (tlosses.pairwise_auc_loss(t(logits[:, 0]), None, 3),
         jlosses.pairwise_auc_loss(j(logits[:, 0]), None, 3)),
    ]
    for got, want in pairs:
        assert np.isfinite(got.item())
        np.testing.assert_allclose(got.item(), float(want), rtol=1e-6, atol=1e-7)


# ---------------------------------------------------------------------------
# the freeze transform
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("freeze", [0, 1, 2])
def test_freeze_transform_matches_jax(freeze):
    """The updates of a step through AdamW (with weight decay) and the freeze
    transform, against `optax.chain(tx, make_freeze_transform)`."""
    jcfg = JConfig(**{**COMMON, **CASES["regression-l1"]}, layer_scale_init_value=1.0).finalize()
    params = jheads.init_task_params(jcfg, jax.random.PRNGKey(1))
    grads = jax.tree_util.tree_map(lambda p: jnp.full_like(p, 0.01), params)
    ocfg = dict(lr=1e-2, min_lr=1e-2, scheduler="lr_range_test")
    jtx = optax.chain(jopt.make_optimizer(JOptConfig(**ocfg), 10, 1), jfreeze(freeze, 2))
    jupd, _ = jax.jit(jtx.update)(grads, jax.jit(jtx.init)(params), params)
    tp = params_from_jax(jax.tree_util.tree_map(np.asarray, params), device="cpu")
    tg = tree_from_jax(jax.tree_util.tree_map(np.asarray, grads), device="cpu")
    ttx = make_optimizer(TOptConfig(**ocfg), 10, 1, post_update=tfreeze(freeze, 2))
    tupd, _ = ttx.update(tg, ttx.init(tp), tp)
    want = tree_from_jax(jax.tree_util.tree_map(np.asarray, jupd), device="cpu")
    assert set(tupd) == set(want)
    for name in tupd:
        np.testing.assert_allclose(tupd[name].numpy(), want[name].numpy(), rtol=1e-5, atol=1e-9,
                                   err_msg=name)
        frozen = "embed_tokens" in name or any(f"layers.{i}." in name for i in range(freeze))
        assert (not tupd[name].any()) == frozen, name
