"""The port's embedding and backbone against the JAX package's, on the CPU.

Weights come from the JAX init and cross over as numpy arrays through
`params_from_jax`. fp32 comparisons hold to 1e-4 (sums in another order
through two layers); bf16 ones to 5e-2 on unit-scale final hidden states,
where one bf16 ulp is 2**-7 to 2**-6 and roundings flip where the two
frameworks sum in another order.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from graphgpt_tpu.config import ModelConfig as JConfig
from graphgpt_tpu.models import heads as jheads
from graphgpt_tpu.models import modeling as jmod
from graphgpt_tpu.utils.convert import params_to_flat_state_dict
from graphgpt_torch.config import ModelConfig as TConfig
from graphgpt_torch.models import modeling as tmod
from graphgpt_torch.models.heads import GraphGPTPretrain
from graphgpt_torch.synthetic import fake_batch, to_torch
from graphgpt_torch.utils.convert import params_from_jax, params_to_jax

COMMON = dict(
    vocab_size=50, hidden_size=128, num_hidden_layers=2, stacked_feat=3,
    next_n_token=3, mask_token_id=1,
)


def _configs(jkw=None, **kw):
    jcfg = JConfig(**COMMON, **kw, **(jkw or {})).finalize()
    tcfg = TConfig(**COMMON, **kw).finalize()
    return jcfg, tcfg


def _params(jcfg, seed=0):
    tree = jheads.init_pretrain_params(jcfg, jax.random.PRNGKey(seed))
    return jax.tree_util.tree_map(np.asarray, tree)


def _port(tcfg, params):
    model = GraphGPTPretrain(tcfg, device="cpu")
    model.load_state_dict(params_from_jax(params, device="cpu"))
    return model


def _batch(b=2, p=128, seed=1, pad_tail=32):
    nb = fake_batch(b, p, 3, 50, np.random.default_rng(seed))
    if pad_tail:
        for key in ("input_ids", "segment_ids"):
            nb[key][-1, p - pad_tail :] = 0
        nb["labels"][-1, p - pad_tail :] = -100
    return nb


@pytest.mark.parametrize(
    "kw",
    [
        dict(),
        dict(stack_method="long"),
        dict(stacked_feat_agg_method="gated"),
        dict(stacked_feat_agg_method="gated", stack_method="long"),
    ],
    ids=["sum", "long", "gated", "gated-long"],
)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_embed_inputs_matches_jax(kw, dtype):
    jcfg, tcfg = _configs(dtype=dtype, **kw)
    params = _params(jcfg)
    nb = _batch(seed=2)
    nb["input_ids"][0, :5, 1:] = 0  # cells with zero ids: the `long` scaling
    want = jmod.embed_inputs(params, jcfg, jnp.asarray(nb["input_ids"]))
    model = _port(tcfg, params)
    with torch.no_grad():
        got = tmod.embed_inputs(
            model.model.embed_tokens.weight, tcfg, torch.from_numpy(nb["input_ids"]),
            model._agg_w(),
        )
    assert got.dtype == (torch.bfloat16 if dtype == "bfloat16" else torch.float32)
    tol = 1e-6 if dtype == "float32" else 1e-2
    np.testing.assert_allclose(
        got.float().numpy(), np.asarray(want, np.float32), atol=tol, rtol=tol
    )


def test_embed_inputs_unstacked_ids():
    jcfg, tcfg = _configs()
    params = _params(jcfg)
    ids = np.random.default_rng(3).integers(0, 50, size=(2, 16)).astype(np.int32)
    want = jmod.embed_inputs(params, jcfg, jnp.asarray(ids))
    model = _port(tcfg, params)
    with torch.no_grad():
        got = tmod.embed_inputs(model.model.embed_tokens.weight, tcfg, torch.from_numpy(ids))
    np.testing.assert_array_equal(got.float().numpy(), np.asarray(want, np.float32))


def test_rms_norm_matches_jax():
    rng = np.random.default_rng(4)
    x = rng.normal(size=(8, 128)).astype(np.float32)
    w = (1 + 0.1 * rng.normal(size=128)).astype(np.float32)
    for dt, jdt in ((torch.float32, jnp.float32), (torch.bfloat16, jnp.bfloat16)):
        want = jmod._rms_norm_ref(jnp.asarray(x, jdt), jnp.asarray(w), 1e-6)
        got = tmod.rms_norm(torch.from_numpy(x).to(dt), torch.from_numpy(w), 1e-6)
        np.testing.assert_allclose(
            got.float().numpy(), np.asarray(want, np.float32), atol=1e-2 if dt != torch.float32 else 1e-6
        )


def _hidden_pair(jcfg, tcfg, nb, monkeypatch=None):
    params = _params(jcfg)
    model = _port(tcfg, params)
    want = jax.jit(
        lambda p, b: jmod.model_hidden_states(
            p, jcfg, b["input_ids"], b["position_ids"], b["segment_ids"]
        )
    )(params, nb)
    got = model.hidden_states(to_torch(nb, "cpu"))
    return got.float().numpy(), np.asarray(want, np.float32)


@pytest.mark.parametrize(
    "path", ["xla-off", "pallas-on"], ids=["xla-path", "interpreted-kernels"]
)
def test_model_hidden_states_fp32(path, monkeypatch):
    if path == "pallas-on":
        monkeypatch.setenv("GGT_PALLAS_INTERPRET", "1")
        jkw = dict(attn_impl="pallas", mlp_kernel="on")
    else:
        jkw = dict(attn_impl="xla", mlp_kernel="off")
    jcfg, tcfg = _configs(jkw=jkw, dtype="float32")
    got, want = _hidden_pair(jcfg, tcfg, _batch())
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)


def test_model_hidden_states_bf16_interpreted_kernels(monkeypatch):
    monkeypatch.setenv("GGT_PALLAS_INTERPRET", "1")
    jcfg, tcfg = _configs(
        jkw=dict(attn_impl="pallas", mlp_kernel="on"), dtype="bfloat16"
    )
    got, want = _hidden_pair(jcfg, tcfg, _batch(seed=5))
    np.testing.assert_allclose(got, want, atol=5e-2, rtol=5e-2)
    assert np.abs(got - want).mean() < 5e-3


def test_model_hidden_states_layer_scale_attn_block_causal():
    """LayerScale (the split MLP path), attn_block windows and causal NTP
    attention, through the plain paths in fp32."""
    jcfg, tcfg = _configs(
        jkw=dict(attn_impl="xla", mlp_kernel="off"), dtype="float32",
        layer_scale_init_value=0.5, attn_block=64, task_type="pretrain-ntp",
        causal_attention=True, rope_range=48, rope_resonance=True,
    )
    assert jcfg.causal_attention and tcfg.causal_attention
    from graphgpt_torch.synthetic import packed_segments

    nb = _batch(seed=6, pad_tail=0)
    nb["segment_ids"] = packed_segments(2, 128, np.random.default_rng(7), block=64)
    got, want = _hidden_pair(jcfg, tcfg, nb)
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)


def test_params_from_jax_names_and_round_trip():
    jcfg, tcfg = _configs(stacked_feat_agg_method="gated", layer_scale_init_value=0.1)
    params = _params(jcfg)
    sd = params_from_jax(params, device="cpu")
    want = params_to_flat_state_dict(params, jcfg.num_hidden_layers)
    assert set(sd) == set(want)
    for name, arr in want.items():
        np.testing.assert_array_equal(sd[name].numpy(), arr, err_msg=name)
    # the port's module takes exactly these names
    model = GraphGPTPretrain(tcfg, device="cpu")
    assert set(model.state_dict()) == set(sd)
    back = params_to_jax(sd)
    flat_a = jax.tree_util.tree_leaves_with_path(params)
    flat_b = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(flat_a) == len(flat_b)
    for path, leaf in flat_a:
        np.testing.assert_array_equal(flat_b[path], leaf)


def test_mlp_kernel_auto_is_on_for_cuda_only(monkeypatch):
    """Every layer without LayerScale goes through the kernel's wrapper; on a
    CPU tensor the wrapper runs the plain version and launches nothing. A
    LayerScale layer takes the plain split path on the CPU (on a CUDA tensor
    it raises: tests/test_torch_gpu.py)."""
    from graphgpt_torch.ops import mlp as tmlp

    calls = []
    real = tmod.fused_norm_mlp
    monkeypatch.setattr(tmod, "fused_norm_mlp", lambda *a: calls.append(1) or real(*a))
    batch = to_torch(_batch(b=1, p=32, pad_tail=0), "cpu")
    launches = tmlp.norm_mlp.launches
    for ls, want in ((0.0, COMMON["num_hidden_layers"]), (0.1, 0)):
        calls.clear()
        tcfg = TConfig(**COMMON, layer_scale_init_value=ls).finalize()
        out = GraphGPTPretrain(tcfg, device="cpu", seed=0).hidden_states(batch)
        assert len(calls) == want and bool(torch.isfinite(out).all())
    assert tmlp.norm_mlp.launches == launches
    assert not hasattr(tcfg, "mlp_kernel")


def test_raw_embed_branch_raises():
    """The raw-embedding branch (embed_dim > 0), which raised until it was
    ported, against JAX `add_raw_embeds` through the pretrain
    forward in fp32: the loss, every gradient (the branch's three weights
    among them) with mask-token substitution at the masked rows, and the
    hidden states without labels; its three weights map through the
    converter both ways under the HF names of `params_to_flat_state_dict`
    (emb_mask_token flat in the port, [1, 1, E] there)."""
    jcfg, tcfg = _configs(embed_dim=8, dtype="float32", jkw=dict(attn_impl="xla",
                                                                 mlp_kernel="off"))
    params = _params(jcfg)
    assert {"embed_layernorm", "embed_proj", "emb_mask_token"} <= set(params)
    model = _port(tcfg, params)
    nb = _batch(b=2, p=64, pad_tail=8)
    nb["embed"] = np.random.default_rng(3).normal(size=(2, 64, 8)).astype(np.float32)

    def loss_fn(p):
        return jheads.pretrain_forward(p, jcfg, nb, rng=None, train=True)["loss"]

    want_loss, want_grads = jax.jit(jax.value_and_grad(loss_fn))(params)
    out = model(to_torch(nb, "cpu"), train=True)
    out["loss"].backward()
    assert abs(out["loss"].item() - float(want_loss)) < 1e-5
    from graphgpt_torch.utils.convert import tree_from_jax

    want = tree_from_jax(jax.tree_util.tree_map(np.asarray, want_grads), device="cpu")
    grads = {k: q.grad for k, q in model.named_parameters()}
    assert set(grads) == set(want)
    for name in ("embed_layernorm.weight", "embed_proj.weight", "emb_mask_token",
                 "model.embed_tokens.weight", "model.layers.0.self_attn.q_proj.weight"):
        g, w = grads[name].numpy(), want[name].numpy()
        assert np.abs(w).max() > 0, name
        assert np.linalg.norm(g - w) <= 2e-4 * np.linalg.norm(w), name
    hidden_want = jax.jit(lambda p, b: jmod.model_hidden_states(
        p, jcfg, b["input_ids"], b["position_ids"], b["segment_ids"], raw_embeds=b["embed"]))(
        params, nb)
    hidden = model.hidden_states(to_torch(nb, "cpu"))
    np.testing.assert_allclose(hidden.numpy(), np.asarray(hidden_want), atol=1e-4, rtol=1e-4)
    # without `embed` in the batch the branch is not taken
    del nb["embed"]
    assert not np.allclose(model.hidden_states(to_torch(nb, "cpu")).numpy(),
                           np.asarray(hidden_want), atol=1e-3)
    # the converter, both ways
    sd = params_from_jax(params, device="cpu")
    flat = params_to_flat_state_dict(params, jcfg.num_hidden_layers)
    for name in ("embed_layernorm.weight", "embed_proj.weight", "emb_mask_token"):
        np.testing.assert_array_equal(sd[name].numpy().reshape(flat[name].shape), flat[name])
    assert set(model.state_dict()) == set(sd)
    back = params_to_jax(sd)
    for key in ("embed_layernorm", "embed_proj", "emb_mask_token"):
        np.testing.assert_array_equal(back[key], params[key])
