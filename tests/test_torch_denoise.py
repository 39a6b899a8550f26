"""The port's denoise model (`GraphGPTDenoise`) against the JAX package's
`denoise_forward`, on the CPU.

A tiny model (hidden 64, 2 layers, 2 heads of 32, gated aggregation over
13 stacked features) in fp32 on rows of `mol3d_batch` (four molecules, one
of them without coordinates), the JAX init's weights carried across by
`params_from_jax`, and the JAX package's own random draws handed to the
port (`draws=`). Loss, task loss, denoise loss, 3D-SMTP loss, task logits
and EVERY gradient leaf, by parameter name, on the plain XLA path and on
the Pallas path run in the interpreter (GGT_PALLAS_INTERPRET=1,
attn_impl="pallas", mlp_kernel="on"), each test naming its path. Cases: no
split and a 16-slot bi-causal split (binary-energy decoding); 3D-SMTP with
and without `smtp_denoise`; the schedule powers -1, -2 and 1; train and
eval. Then three steps of the port's `make_train_step` against the JAX
`make_train_step`.

Tolerances: the two sides differ in the order of fp32 sums through two
layers and three heads: losses to 1e-5, each gradient to 2e-4 in the
relative Frobenius norm and elementwise to 1e-6 + 1e-3 * |g|; the decoded
energies (sums of k/1000 over the bits whose logit is positive) to 1e-6.
"""

import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from graphgpt_tpu.config import ModelConfig as JConfig
from graphgpt_tpu.config import OptimizerConfig as JOptConfig
from graphgpt_tpu.models import denoise as jden
from graphgpt_tpu.ops import losses as jlosses
from graphgpt_tpu.training import optimizer as jopt
from graphgpt_tpu.training import steps as jsteps
from graphgpt_torch.config import ModelConfig as TConfig
from graphgpt_torch.config import OptimizerConfig as TOptConfig
from graphgpt_torch.models import denoise as tden
from graphgpt_torch.models.pos_pretrain import take_rows
from graphgpt_torch.ops import losses as tlosses
from graphgpt_torch.synthetic import mol3d_batch, mol3d_tokenizer, to_torch
from graphgpt_torch.training import optimizer as topt
from graphgpt_torch.training import steps as tsteps
from graphgpt_torch.utils.convert import params_from_jax, tree_from_jax

COMMON = dict(
    vocab_size=755, hidden_size=64, num_hidden_layers=2, head_dim=32, num_attention_heads=2,
    intermediate_size=128, stacked_feat=13, next_n_token=1, mask_token_id=1, dtype="float32",
    stacked_feat_agg_method="gated", task_type="graph", problem_type="regression",
    loss_type="l1", num_labels=1, pos_num_bins=16,
)
JAX_PATHS = {"xla": dict(attn_impl="xla", mlp_kernel="off"),
             "pallas": dict(attn_impl="pallas", mlp_kernel="on")}
CASES = {
    "plain": {},
    "bicausal": dict(bi_causal_split=16),
    "smtp3d": dict(smtp_3d=True, smtp_vocab=32, smtp_wgt=0.5),
    "smtp3d-denoise": dict(smtp_3d=True, smtp_vocab=32, smtp_denoise=True),
    "sched-cos": dict(denoise_schedule_pow=-1.0),
    "sched-arccos": dict(denoise_schedule_pow=-2.0),
    "sched-poly": dict(denoise_schedule_pow=1.0, bi_causal_split=16),
}
B, P = 4, 48
LOSS_TOL, REL, ATOL, RTOL = 1e-5, 2e-4, 1e-6, 1e-3


@functools.lru_cache(maxsize=None)
def _batch(bi_split: int):
    nb = mol3d_batch(B, P, seed=1, bi_split=bi_split, tokenizer=mol3d_tokenizer())
    nb["pos"][2] = 0.0  # a molecule without coordinates: a 2D-only sample
    # a wide molecule, whose top bins give 3D-SMTP labels past the head
    nb["pos"][3] *= 3.0
    return nb


def jax_draws(key, b: int, p: int) -> dict:
    """The JAX package's draws of `denoise_forward` for `key` (:117), as the
    port's `denoise_draws` names them."""
    r_mode, r_noise, _, r_sched, r_node = jax.random.split(key, 5)
    return {
        "mode": jax.random.uniform(r_mode, (b, 1, 1)),
        "noise": jax.random.normal(r_noise, (b, p, 3)),
        "sched": jax.random.uniform(r_sched, (b, 1, 1)),
        "node": jax.random.uniform(r_node, (b, p, 1)),
    }


def _torch_draws(d):
    return {k: torch.from_numpy(np.array(v)) for k, v in d.items()}


def _cfgs(path: str, case: str):
    kw = {**COMMON, **CASES[case]}
    return JConfig(**{**kw, **JAX_PATHS[path]}).finalize(), TConfig(**kw).finalize()


@functools.lru_cache(maxsize=None)
def _jax_run(path: str, case: str, train: bool):
    """(params, outputs, grads) of the JAX package as numpy trees."""
    jcfg, _ = _cfgs(path, case)
    os.environ["GGT_PALLAS_INTERPRET"] = "1"
    try:
        params = jden.init_denoise_params(jcfg, jax.random.PRNGKey(0))
        nb = _batch(jcfg.bi_causal_split)
        rng = jax.random.PRNGKey(3) if train else None

        def loss_fn(p):
            out = jden.denoise_forward(p, jcfg, nb, rng=rng, train=train)
            out.pop("hidden_states")
            return out["loss"], out

        (_, out), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(params)
    finally:
        del os.environ["GGT_PALLAS_INTERPRET"]
    to_np = functools.partial(jax.tree_util.tree_map, np.asarray)
    return to_np(params), to_np(out), to_np(grads)


def _port_run(path: str, case: str, train: bool):
    params, _, _ = _jax_run(path, case, train)
    _, tcfg = _cfgs(path, case)
    model = tden.GraphGPTDenoise(tcfg, device="cpu")
    model.load_state_dict(params_from_jax(params, device="cpu"))  # strict: every key
    key = jax.random.PRNGKey(3 if train else 0)  # eval: the JAX fallback key
    draws = _torch_draws(jax_draws(key, B, P))
    out = model(to_torch(_batch(tcfg.bi_causal_split), "cpu"), train=train, draws=draws)
    out["loss"].backward()
    return out, {k: p.grad for k, p in model.named_parameters()}


def _check(path, case, train):
    _, want, jgrads = _jax_run(path, case, train)
    got, grads = _port_run(path, case, train)
    assert set(got) - {"hidden_states"} == set(want), case
    for key in ("loss", "task_loss", "pretrain_loss", "smtp_loss"):
        if key in want:
            assert got[key].item() == pytest.approx(float(want[key]), abs=LOSS_TOL), key
    np.testing.assert_allclose(got["task_logits"].detach().numpy(), want["task_logits"],
                               atol=1e-6, rtol=1e-6)
    jg = tree_from_jax(jgrads, device="cpu")
    assert set(jg) == set(grads)
    for name, g in grads.items():
        w = jg[name].numpy()
        g = np.zeros_like(w) if g is None else g.numpy()
        np.testing.assert_allclose(g, w, atol=ATOL, rtol=RTOL, err_msg=f"{case} {name}")
        if np.linalg.norm(w) > 0:
            assert np.linalg.norm(g - w) / np.linalg.norm(w) < REL, (case, name)
    return got


@pytest.mark.parametrize("path", sorted(JAX_PATHS))
@pytest.mark.parametrize("case", sorted(CASES))
def test_denoise_train_forward_and_grads_match_jax(path, case):
    got = _check(path, case, train=True)
    if "smtp" in case:
        assert "smtp_loss" in got
    if CASES[case].get("bi_causal_split"):
        assert got["task_logits"].shape == (B, 1)


@pytest.mark.parametrize("path", sorted(JAX_PATHS))
@pytest.mark.parametrize("case", ["plain", "bicausal", "smtp3d"])
def test_denoise_eval_forward_matches_jax(path, case):
    """Eval: no noise added and no 2D/3D mode draw, but the JAX function
    still draws noise and schedule from PRNGKey(0) and scores the denoise
    head against that noise (ROADMAP.md section 3); the port does the same
    with the draws it is handed."""
    _check(path, case, train=False)


def test_energy_bits_decode_and_bce():
    """16 bits, most significant first, in thousandths: logits of the label's
    own bits decode to the label truncated to 1/1000."""
    y = torch.tensor([[5.4321], [0.001]])
    powers = 2.0 ** torch.arange(15, -1, -1).float()
    bits = (torch.floor(y * 1000.0 / powers) % 2) * 2 - 1  # +-1
    energy, loss = tden.energy_bits(bits * 10.0, y)
    torch.testing.assert_close(energy, torch.tensor([5.432, 0.001]), atol=1e-6, rtol=0)
    assert loss.item() < 1e-3


def test_smtp_labels_reach_past_the_head():
    """The 3D-SMTP labels are bins + 2 of `smtp_vocab` bins, but the head
    has `smtp_vocab` outputs (denoise.py:190-199): the two top bins fall
    past it. The wide molecule of the batch reaches them."""
    nb = _batch(0)
    lo, hi = tden.pos_range(TConfig(**COMMON), "cpu")
    lab = tden.discrete_pos(torch.from_numpy(nb["pos"]), 32, lo, hi) + 2
    assert int(lab.max()) >= 32


def test_ce_of_a_label_past_the_head_matches_jax():
    """The JAX CE picks a label's logit by compare-select, so a label past
    the last class picks none and costs the logsumexp alone; the port's
    gather does the same (it raised before)."""
    rng = np.random.default_rng(0)
    hidden = rng.normal(size=(2, 8, 16)).astype(np.float32)
    head = (rng.normal(size=(16, 6)) * 0.3).astype(np.float32)
    labels = rng.integers(0, 8, size=(2, 8, 1)).astype(np.int32)  # 6, 7: past the head
    labels[0, :2] = -100

    def jloss(h, w):
        return jlosses.chunked_stacked_ce(h, labels, None, w)

    want, (wh, ww) = jax.value_and_grad(jloss, argnums=(0, 1))(hidden, head)
    th = torch.from_numpy(hidden).requires_grad_()
    tw = torch.from_numpy(head.T.copy()).requires_grad_()
    got = tlosses.chunked_stacked_ce(th, torch.from_numpy(labels), None, tw)
    got.backward()
    assert got.item() == pytest.approx(float(want), abs=1e-6)
    np.testing.assert_allclose(th.grad.numpy(), np.asarray(wh), atol=1e-6)
    np.testing.assert_allclose(tw.grad.numpy().T, np.asarray(ww), atol=1e-6)


def test_take_rows_is_the_jax_gather():
    """Node indices past either end clamp, negative ones count from the end:
    what `x[bz_idx, node_idx]` gives in JAX (the batches of test_denoise.py
    index one past the last row)."""
    x = np.arange(2 * 5 * 3, dtype=np.float32).reshape(2, 5, 3)
    idx = np.array([[0, 4, 5, 7, -1], [-6, 2, 9, 1, -2]], np.int32)
    want = np.asarray(jnp.asarray(x)[jnp.arange(2)[:, None], jnp.asarray(idx)])
    np.testing.assert_array_equal(take_rows(torch.from_numpy(x), torch.from_numpy(idx)).numpy(),
                                  want)


def test_the_force_head_softmax_spans_padded_keys():
    """`atom_task_head` normalises over every key of the row, padding
    included (denoise.py:78-79): a padded key's hidden state moves a real
    position's force. The port does the same."""
    _, tcfg = _cfgs("xla", "plain")
    model = tden.GraphGPTDenoise(tcfg, device="cpu")
    rng = np.random.default_rng(0)
    hidden = torch.from_numpy(rng.normal(size=(1, 8, 64)).astype(np.float32))
    pos = torch.from_numpy(rng.normal(size=(1, 8, 3)).astype(np.float32))
    d = pos[:, :, None] - pos[:, None]
    d = d / (d.norm(dim=-1, keepdim=True) + 1.0)
    pids = torch.arange(8)[None]
    with torch.no_grad():
        f1 = model.denoise(hidden, pids, d, tcfg)
        hidden2 = hidden.clone()
        hidden2[0, -1] += 1.0  # say position 7 is padding
        f2 = model.denoise(hidden2, pids, d, tcfg)
    assert not torch.allclose(f1[0, 0], f2[0, 0])


@pytest.fixture(scope="module")
def steps3():
    """Three steps of both train steps (XLA path), AdamW with warm-up 1 of
    10, clip and EMA; the port's model takes at each call the draws that
    the JAX step makes at that step (fold_in of the step's key)."""
    jcfg, tcfg = _cfgs("xla", "bicausal")
    nb = _batch(16)
    params = jden.init_denoise_params(jcfg, jax.random.PRNGKey(0))
    params_np = jax.tree_util.tree_map(np.asarray, params)
    opt = dict(lr=3e-3, use_ema=True, ema_decay=0.9)
    jo = JOptConfig(**opt)
    sched = jopt.make_schedule(jo, 10, 1)
    tx = jopt.make_optimizer(jo, 10, 1, schedule=sched)
    jstate = jsteps.init_train_state(params, tx, use_ema=True)
    jstep = jsteps.make_train_step(jden.denoise_forward, jcfg, tx, jo, sched, donate=False)
    key = jax.random.PRNGKey(5)
    jm = []
    for _ in range(3):
        jstate, m = jstep(jstate, nb, key)
        jm.append({k: float(v) for k, v in m.items()})

    class JaxDrawsDenoise(tden.GraphGPTDenoise):
        calls = 0

        def forward(self, batch, generator=None, train=False, draws=None):
            if train:
                draws = _torch_draws(jax_draws(jax.random.fold_in(key, self.calls), B, P))
                self.calls += 1
            return super().forward(batch, generator, train, draws)

    model = JaxDrawsDenoise(tcfg, device="cpu")
    model.load_state_dict(params_from_jax(params_np, device="cpu"))
    to = TOptConfig(**opt)
    tsched = topt.make_schedule(to, 10, 1)
    ttx = topt.make_optimizer(to, 10, 1, schedule=tsched)
    tstate = tsteps.init_train_state(model, ttx, use_ema=True)
    tstep = tsteps.make_train_step(ttx, to, tsched)
    batch = to_torch(nb, "cpu")
    tm = []
    for _ in range(3):
        tstate, m = tstep(tstate, batch, seed=0)
        tm.append({k: float(v) for k, v in m.items()})
    return jm, tm, jstate, tstate, jcfg, nb


def test_three_train_steps_track_the_jax_step(steps3):
    jm, tm, jstate, tstate, _, _ = steps3
    for i, (j, t) in enumerate(zip(jm, tm)):
        assert set(t) == set(j) == {"loss", "grad_norm", "lr", "task_loss", "pretrain_loss"}
        for k in ("loss", "task_loss", "pretrain_loss"):
            assert t[k] == pytest.approx(j[k], abs=2e-5), (i, k)
        assert t["grad_norm"] == pytest.approx(j["grad_norm"], rel=1e-4), i
    to_np = functools.partial(jax.tree_util.tree_map, np.asarray)
    want = tree_from_jax(to_np(jstate.params), device="cpu")
    want_ema = tree_from_jax(to_np(jstate.ema_params), device="cpu")
    for name, p in tstate.model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(), atol=2e-5, rtol=0,
                                   err_msg=name)
        np.testing.assert_allclose(tstate.ema_params[name].numpy(), want_ema[name].numpy(),
                                   atol=2e-5, rtol=0, err_msg=name)


def test_the_ema_eval_step_decodes_energies_as_jax(steps3):
    _, _, jstate, tstate, jcfg, nb = steps3
    want = jsteps.make_eval_step(jden.denoise_forward, jcfg, use_ema=True)(jstate, nb)
    got = tsteps.make_eval_step(use_ema=True)(tstate, to_torch(nb, "cpu"))
    assert set(got) == {"loss", "task_loss", "task_logits", "hidden_states"}
    np.testing.assert_allclose(got["task_logits"].numpy(), np.asarray(want["task_logits"]),
                               atol=1e-6)
    # eval without draws: the port's fixed generator, not PRNGKey(0)'s numbers,
    # so the denoise term differs; the task loss does not depend on it
    assert got["task_loss"].item() == pytest.approx(float(want["task_loss"]), abs=1e-5)
