"""Values and gradients of the port's losses against the JAX package's.

fp32 on the CPU; both sides form the logits chunk by chunk and recompute
them in the backward. They differ in the order of fp32 sums: 1e-5 on the
value, 2e-6 absolute on gradients whose entries are ~1e-3 (rtol 1e-4).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from graphgpt_tpu.ops import losses as jlosses
from graphgpt_torch.ops import losses as tlosses

CASES = {
    "plain": dict(),
    "dlm-weighted": dict(wgt=True),
    "focal": dict(focal_gamma=2.0),
    "label-smoothing": dict(label_smoothing=0.1),
    "single-head": dict(next_n=1),
    "weighted-focal-smoothing": dict(wgt=True, focal_gamma=1.5, label_smoothing=0.05),
}


def _inputs(kw):
    rng = np.random.default_rng(3)
    b, p, d, v = 2, 64, 32, 40
    n = kw.get("next_n", 3)
    hidden = rng.normal(size=(b, p, d)).astype(np.float32)
    labels = rng.integers(0, v, size=(b, p, n)).astype(np.int32)
    labels[rng.random((b, p, n)) < 0.4] = -100
    proj = (rng.normal(size=(d, n * d)) * 0.2).astype(np.float32) if n > 1 else None
    head = (rng.normal(size=(d, v)) * 0.2).astype(np.float32)
    wgt = dlm = None
    if kw.get("wgt"):
        wgt = np.broadcast_to(rng.random((b, 1, 1)).astype(np.float32), (b, p, n)).copy()
        dlm = float(b * p * n)
    return hidden, labels, proj, head, wgt, dlm


@pytest.mark.parametrize("case", sorted(CASES))
def test_chunked_stacked_ce_value_and_grads_match_jax(case):
    kw = CASES[case]
    hidden, labels, proj, head, wgt, dlm = _inputs(kw)
    opts = dict(focal_gamma=kw.get("focal_gamma", 0.0),
                label_smoothing=kw.get("label_smoothing", 0.0), chunk=16)

    def f(hidden, proj, head):
        return jlosses.chunked_stacked_ce(
            hidden, jnp.asarray(labels), proj, head,
            token_wgt=None if wgt is None else jnp.asarray(wgt), dlm_normalizer=dlm, **opts,
        )

    jproj = None if proj is None else jnp.asarray(proj)
    argnums = (0, 2) if proj is None else (0, 1, 2)
    want, want_grads = jax.value_and_grad(f, argnums=argnums)(
        jnp.asarray(hidden), jproj, jnp.asarray(head)
    )

    t = torch.from_numpy
    th = t(hidden).requires_grad_()
    tp = None if proj is None else t(proj.T.copy()).requires_grad_()
    thead = t(head.T.copy()).requires_grad_()
    got = tlosses.chunked_stacked_ce(
        th, t(labels), tp, thead, token_wgt=None if wgt is None else t(wgt),
        dlm_normalizer=dlm, **opts,
    )
    got.backward()
    assert abs(got.item() - float(want)) < 1e-5
    got_grads = [th.grad.numpy()]
    if proj is not None:
        got_grads.append(tp.grad.numpy().T)
    got_grads.append(thead.grad.numpy().T)
    for g, w in zip(got_grads, want_grads):
        np.testing.assert_allclose(g, np.asarray(w), atol=2e-6, rtol=1e-4)


@pytest.mark.parametrize("case", ["plain", "dlm-weighted", "single-head"])
def test_a_logits_budget_cuts_the_chunk_and_keeps_the_value(monkeypatch, case):
    """Where B * chunk * N * V would pass LOGITS_BUDGET the chunk shrinks (a
    large vocab), the last one ragged: against `jax.value_and_grad` at the
    JAX package's chunk of 16, as above."""
    kw = CASES[case]
    hidden, labels, proj, head, wgt, dlm = _inputs(kw)
    n = labels.shape[-1]
    monkeypatch.setattr(tlosses, "LOGITS_BUDGET", 2 * n * 40 * 5)  # 5 positions: 64 = 12 x 5 + 4

    def f(hidden, proj, head):
        return jlosses.chunked_stacked_ce(
            hidden, jnp.asarray(labels), proj, head,
            token_wgt=None if wgt is None else jnp.asarray(wgt), dlm_normalizer=dlm, chunk=16)

    argnums = (0, 2) if proj is None else (0, 1, 2)
    want, want_grads = jax.value_and_grad(f, argnums=argnums)(
        jnp.asarray(hidden), None if proj is None else jnp.asarray(proj), jnp.asarray(head))
    t = torch.from_numpy
    th = t(hidden).requires_grad_()
    tp = None if proj is None else t(proj.T.copy()).requires_grad_()
    thead = t(head.T.copy()).requires_grad_()
    saved = []
    with torch.autograd.graph.saved_tensors_hooks(lambda s: saved.append(tuple(s.shape)) or s,
                                                  lambda s: s):
        got = tlosses.chunked_stacked_ce(th, t(labels), tp, thead,
                                         token_wgt=None if wgt is None else t(wgt),
                                         dlm_normalizer=dlm, chunk=16)
    # the chunks' hidden slices, saved for the recompute: 5 positions, the last 4
    assert {s[1] for s in saved if len(s) == 3 and s[0] == 2 and s[-1] == 32} >= {5, 4}
    got.backward()
    assert abs(got.item() - float(want)) < 1e-5
    got_grads = [th.grad.numpy()] + ([] if proj is None else [tp.grad.numpy().T])
    got_grads.append(thead.grad.numpy().T)
    for g, w in zip(got_grads, want_grads):
        np.testing.assert_allclose(g, np.asarray(w), atol=2e-6, rtol=1e-4)


def test_chunks_are_rematerialised():
    """No [B, c, N, V] logits tensor is kept for the backward."""
    hidden, labels, proj, head, _, _ = _inputs({})
    t = torch.from_numpy
    th = t(hidden).requires_grad_()
    saved = []
    with torch.autograd.graph.saved_tensors_hooks(lambda s: saved.append(tuple(s.shape)) or s, lambda s: s):
        tlosses.chunked_stacked_ce(th, t(labels), t(proj.T.copy()), t(head.T.copy()), chunk=16)
    assert not any(len(shape) == 4 and shape[-1] == 40 for shape in saved), saved


def test_masked_mean_ce_matches_jax():
    rng = np.random.default_rng(5)
    logits = rng.normal(size=(12, 7)).astype(np.float32)
    labels = rng.integers(0, 7, size=12).astype(np.int32)
    labels[::4] = -100
    wgt = rng.random(12).astype(np.float32)
    for w in (None, wgt):
        want = jlosses.masked_mean_ce(jnp.asarray(logits), jnp.asarray(labels),
                                      None if w is None else jnp.asarray(w))
        got = tlosses.masked_mean_ce(torch.from_numpy(logits), torch.from_numpy(labels),
                                     None if w is None else torch.from_numpy(w))
        assert abs(got.item() - float(want)) < 1e-6


def test_info_nce_value_and_grads_match_jax():
    rng = np.random.default_rng(6)
    left = rng.normal(size=(6, 16)).astype(np.float32)
    right = rng.normal(size=(6, 16)).astype(np.float32)
    left /= np.linalg.norm(left, axis=-1, keepdims=True)
    right /= np.linalg.norm(right, axis=-1, keepdims=True)
    want, (wl, wr) = jax.value_and_grad(jlosses.info_nce, argnums=(0, 1))(
        jnp.asarray(left), jnp.asarray(right)
    )
    tl, tr = torch.from_numpy(left).requires_grad_(), torch.from_numpy(right).requires_grad_()
    got = tlosses.info_nce(tl, tr)
    got.backward()
    assert abs(got.item() - float(want)) < 1e-5
    np.testing.assert_allclose(tl.grad.numpy(), np.asarray(wl), atol=1e-5, rtol=1e-4)
    np.testing.assert_allclose(tr.grad.numpy(), np.asarray(wr), atol=1e-5, rtol=1e-4)
