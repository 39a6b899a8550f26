"""The port's split MLP (kernel #11's plain version and its backward) and
the LayerScale backbone against the JAX package, on the CPU.

The JAX kernel (`_mlp_kernel`, through `fused_mlp`) runs in the Pallas
interpreter; the port runs the kernel's plain version (CPU tensors). The
Pallas kernel's gelu uses an approximate erf (|error| <= 1.5e-7), the port
the exact one: fp32 outputs agree to 2e-6, and to 1e-5 with the plain XLA
path (`xla_mlp`, the exact erf, another order of sums). In bf16 both round
xg, xu, a and g at the same points: they differ where a rounding near a
tie flips (a bf16 ulp of the output, 2**-7 relative).
"""

import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from graphgpt_tpu.config import ModelConfig as JConfig
from graphgpt_tpu.models import heads as jheads
from graphgpt_tpu.ops import mlp as jmlp
from graphgpt_torch.config import ModelConfig as TConfig
from graphgpt_torch.models.heads import GraphGPTPretrain
from graphgpt_torch.ops import mlp as tmlp
from graphgpt_torch.synthetic import fake_batch, to_torch
from graphgpt_torch.utils.convert import params_from_jax, tree_from_jax

ACTS = ["gelu", "gelu_pytorch_tanh", "silu"]


def _inputs(n=64, d=128, f=512, seed=0):
    """x [N, D], wg, wu [D, F], wd [F, D] (the JAX layout), dout [N, D]."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, d)).astype(np.float32)
    wg = (rng.normal(size=(d, f)) * 0.05).astype(np.float32)
    wu = (rng.normal(size=(d, f)) * 0.05).astype(np.float32)
    wd = (rng.normal(size=(f, d)) * 0.05).astype(np.float32)
    dout = rng.normal(size=(n, d)).astype(np.float32)
    return x, wg, wu, wd, dout


def _linear_layout(*ws):
    return [torch.from_numpy(w.T.copy()) for w in ws]


@pytest.mark.parametrize("act", ACTS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mlp_kernel_ref_matches_interpreted_kernel(act, dtype, monkeypatch):
    monkeypatch.setenv("GGT_PALLAS_INTERPRET", "1")
    x, wg, wu, wd, _ = _inputs()
    jdt, tdt = (jnp.float32, torch.float32) if dtype == "float32" else (jnp.bfloat16, torch.bfloat16)
    want = jmlp.fused_mlp(jnp.asarray(x, jdt), *(jnp.asarray(w) for w in (wg, wu, wd)), act)
    tw = [w.to(tdt) for w in _linear_layout(wg, wu, wd)]
    got = tmlp.mlp(torch.from_numpy(x).to(tdt), *tw, act)
    assert got.dtype == tdt
    tol = 2e-6 if dtype == "float32" else 2e-2
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32), atol=tol, rtol=tol)


@pytest.mark.parametrize("act", ACTS)
def test_mlp_kernel_ref_matches_xla_mlp(act):
    x, wg, wu, wd, _ = _inputs(seed=1)
    want = np.asarray(jmlp.xla_mlp(*(jnp.asarray(a) for a in (x, wg, wu, wd)), act))
    got = tmlp.mlp_kernel_ref(torch.from_numpy(x), *_linear_layout(wg, wu, wd), act).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)


def test_mlp_kernel_ref_rounds_where_the_kernel_does():
    """In bf16 the plain version equals a hand-rounded fp64 evaluation of
    the kernel's formula: xg, xu, a and g rounded, the down product rounded
    once."""
    x, wg, wu, wd, _ = _inputs(n=16, seed=4)
    xb = torch.from_numpy(x).to(torch.bfloat16)
    wgb, wub, wdb = (w.to(torch.bfloat16) for w in _linear_layout(wg, wu, wd))
    got = tmlp.mlp_kernel_ref(xb, wgb, wub, wdb, "silu")

    def r(a):
        return a.to(torch.bfloat16).double()

    x64 = xb.double()
    xg = r(x64 @ wgb.double().t())
    xu = r(x64 @ wub.double().t())
    g = r(r(xg * torch.sigmoid(xg)) * xu)
    want = (g @ wdb.double().t()).to(torch.bfloat16)
    assert (got.float() != want.float()).float().mean() < 0.02
    torch.testing.assert_close(got.float(), want.float(), atol=2e-2, rtol=1e-2)


@pytest.mark.parametrize("act", ACTS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fused_mlp_backward_matches_jax_vjp(act, dtype, monkeypatch):
    """`_FusedMLP`'s backward (`mlp_bwd_ref`) against `jax.vjp(fused_mlp)`
    with the kernel interpreted, fp32 master weights under x's dtype. fp32:
    2e-5 (the forward's approximate erf, another order of sums). bf16: both
    round xg, xu, a, g, dg and dxg at the same points and sum the weight
    gradients in fp32; a rounding near a tie moves an entry by 1 ulp: 1e-2
    in the relative Frobenius norm."""
    monkeypatch.setenv("GGT_PALLAS_INTERPRET", "1")
    x, wg, wu, wd, dout = _inputs(seed=2)
    jdt, tdt = (jnp.float32, torch.float32) if dtype == "float32" else (jnp.bfloat16, torch.bfloat16)
    args = (jnp.asarray(x, jdt), *(jnp.asarray(w) for w in (wg, wu, wd)))
    _, vjp = jax.vjp(lambda *a: jmlp.fused_mlp(*a, act), *args)
    want = [np.asarray(g, np.float32) for g in vjp(jnp.asarray(dout, jdt))]
    xt = torch.from_numpy(x).to(tdt).requires_grad_()
    ws = [w.requires_grad_() for w in _linear_layout(wg, wu, wd)]
    out = tmlp.fused_mlp(xt, *ws, act)
    got = torch.autograd.grad(out, [xt, *ws], torch.from_numpy(dout).to(tdt))
    assert got[0].dtype == tdt and all(g.dtype == torch.float32 for g in got[1:])
    got = [got[0].float().numpy()] + [g.numpy().T for g in got[1:]]
    for name, g, w in zip(("dx", "dwg", "dwu", "dwd"), got, want):
        if dtype == "float32":
            np.testing.assert_allclose(g, w, atol=2e-5, rtol=2e-5, err_msg=name)
        else:
            assert np.linalg.norm(g - w) <= 1e-2 * np.linalg.norm(w), name


def test_cpu_mlp_wrapper_counts_no_launch():
    x, wg, wu, wd, _ = _inputs(n=8)
    before = tmlp.mlp.launches
    out = tmlp.fused_mlp(torch.from_numpy(x), *_linear_layout(wg, wu, wd), "gelu")
    assert out.shape == x.shape and tmlp.mlp.launches == before


# ---------------------------------------------------------------------------
# the LayerScale backbone: loss and every gradient against jax.grad
# ---------------------------------------------------------------------------
COMMON = dict(
    vocab_size=50, hidden_size=128, num_hidden_layers=2, stacked_feat=3, next_n_token=3,
    mask_token_id=1, dtype="float32", layer_scale_init_value=0.5,
)
REL, ATOL, RTOL = 2e-4, 1e-6, 1e-3


def _batch(b=2, p=128, seed=1):
    nb = fake_batch(b, p, 3, 50, np.random.default_rng(seed))
    nb["segment_ids"][-1, p - 32 :] = 0
    nb["input_ids"][-1, p - 32 :] = 0
    nb["labels"][-1, p - 32 :] = -100
    return nb


@functools.lru_cache(maxsize=None)
def _jax_loss_and_grads(train: bool):
    """The JAX package on its Pallas path, interpreted: with LayerScale the
    backbone takes `_mlp_kernel`."""
    os.environ["GGT_PALLAS_INTERPRET"] = "1"
    try:
        jcfg = JConfig(**COMMON, attn_impl="pallas", mlp_kernel="on").finalize()
        params = jheads.init_pretrain_params(jcfg, jax.random.PRNGKey(0))
        # lambda off its init value, so that its gradient is not the only check
        params["layers"]["ls2"] = params["layers"]["ls2"] * jnp.linspace(0.5, 1.5, 128)
        nb = _batch()

        def loss_fn(p):
            return jheads.pretrain_forward(p, jcfg, nb, train=train)["loss"]

        loss, grads = jax.jit(jax.value_and_grad(loss_fn))(params)
    finally:
        del os.environ["GGT_PALLAS_INTERPRET"]
    to_np = functools.partial(jax.tree_util.tree_map, np.asarray)
    return to_np(params), float(loss), to_np(grads)


@pytest.mark.parametrize("remat", ["off", "pairs"])
@pytest.mark.parametrize("train", [True, False], ids=["train-rates-0", "eval"])
def test_layer_scale_backbone_matches_jax(train, remat):
    params, want_loss, want_grads = _jax_loss_and_grads(train)
    kw = dict(remat=remat != "off", remat_policy="pairs")
    model = GraphGPTPretrain(TConfig(**COMMON, **kw).finalize(), device="cpu")
    model.load_state_dict(params_from_jax(params, device="cpu"))
    nb = _batch()
    calls = []
    real = tmlp.mlp
    try:
        tmlp.mlp = lambda *a: calls.append(1) or real(*a)
        out = model(to_torch(nb, "cpu"), generator=torch.Generator().manual_seed(0), train=train)
        out["loss"].backward()
    finally:
        tmlp.mlp = real
    assert len(calls) == 2 * (2 if remat == "pairs" else 1)  # the split kernel, each layer
    assert abs(out["loss"].item() - want_loss) < 1e-5
    want = tree_from_jax(want_grads, device="cpu")
    grads = {k: p.grad for k, p in model.named_parameters()}
    assert set(grads) == set(want) and "model.layers.1.lambda_2" in grads
    for name in sorted(grads):
        g, w = grads[name].numpy(), want[name].numpy()
        assert np.linalg.norm(g - w) <= REL * np.linalg.norm(w) + 1e-9, name
        np.testing.assert_allclose(g, w, atol=ATOL, rtol=RTOL, err_msg=name)


def test_mlp_dropout_takes_xla_mlp_and_layer_scale_the_kernel(monkeypatch):
    """The JAX dispatch: MLP dropout -> the plain `xla_mlp`; LayerScale or
    DropPath without it -> the split kernel; neither -> the norm-fused one."""
    from graphgpt_torch.models import modeling as tmod

    seen = []
    for name in ("fused_mlp", "fused_norm_mlp", "xla_mlp"):
        real = getattr(tmod, name)
        monkeypatch.setattr(tmod, name, (lambda n, f: lambda *a: seen.append(n) or f(*a))(name, real))
    batch = to_torch(_batch(), "cpu")
    base = {k: v for k, v in COMMON.items() if k != "layer_scale_init_value"}
    for kw, want in ((dict(mlp_dropout=0.1, path_dropout=0.1), "xla_mlp"),
                     (dict(path_dropout=0.1), "fused_mlp"),
                     (dict(layer_scale_init_value=0.5), "fused_mlp"),
                     (dict(), "fused_norm_mlp")):
        seen.clear()
        model = GraphGPTPretrain(TConfig(**base, **kw).finalize(), device="cpu")
        model(batch, generator=torch.Generator().manual_seed(0), train=True)
        assert seen == [want, want], (kw, seen)
