"""The training forward and backward of the port against the JAX package.

A tiny model (hidden 128, 2 layers, P 128, stacked_feat 3, packed rows with
a padded tail) in fp32 on the CPU: the loss and EVERY gradient leaf against
`jax.grad(pretrain_forward)`, on the plain XLA path and on the Pallas path
run in the interpreter (GGT_PALLAS_INTERPRET=1, attn_impl="pallas",
mlp_kernel="on"), with rematerialisation off and for each policy the port
takes. The gradients cross through `tree_from_jax`, so they are compared by
parameter name. The two sides differ in the order of fp32 sums through two
layers and the heads: the loss agrees to 1e-5 and each gradient to 2e-4 in
the relative Frobenius norm (and elementwise to 1e-6 + 1e-3 * |g|).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from graphgpt_tpu.config import ModelConfig as JConfig
from graphgpt_tpu.models import heads as jheads
from graphgpt_torch.config import ModelConfig as TConfig
from graphgpt_torch.models import heads as theads
from graphgpt_torch.models import modeling as tmod
from graphgpt_torch.models.heads import GraphGPTPretrain
from graphgpt_torch.synthetic import fake_batch, to_torch
from graphgpt_torch.utils.convert import params_from_jax, tree_from_jax

COMMON = dict(
    vocab_size=50, hidden_size=128, num_hidden_layers=2, stacked_feat=3,
    next_n_token=3, mask_token_id=1, dtype="float32",
)
JAX_PATHS = {"xla": dict(attn_impl="xla", mlp_kernel="off"),
             "pallas": dict(attn_impl="pallas", mlp_kernel="on")}
REL, ATOL, RTOL = 2e-4, 1e-6, 1e-3


def _batch(b=2, p=128, seed=1):
    nb = fake_batch(b, p, 3, 50, np.random.default_rng(seed))
    nb["segment_ids"][-1, p - 32 :] = 0  # a padded tail on the last row
    nb["input_ids"][-1, p - 32 :] = 0
    nb["labels"][-1, p - 32 :] = -100
    nb["wgt"] = np.linspace(1.0, 0.6, b).astype(np.float32)
    return nb


def _freeze(kw):
    return tuple(sorted(kw.items()))


@functools.lru_cache(maxsize=None)
def _jax_loss_and_grads(path: str, frozen_kw=(), rng_seed=None, b=2):
    """(params, loss, grads as numpy trees) of the JAX package."""
    import os

    kw = dict(frozen_kw)
    os.environ["GGT_PALLAS_INTERPRET"] = "1"
    try:
        jcfg = JConfig(**{**COMMON, **JAX_PATHS[path], **kw}).finalize()
        params = jheads.init_pretrain_params(jcfg, jax.random.PRNGKey(0))
        nb = _batch(b=b)
        if jcfg.smtp_inside:
            nb["node_idx"] = _node_idx(nb)
        rng = None if rng_seed is None else jax.random.PRNGKey(rng_seed)

        def loss_fn(p):
            return jheads.pretrain_forward(p, jcfg, nb, rng=rng, train=True)["loss"]

        loss, grads = jax.jit(jax.value_and_grad(loss_fn))(params)
    finally:
        del os.environ["GGT_PALLAS_INTERPRET"]
    to_np = functools.partial(jax.tree_util.tree_map, np.asarray)
    return to_np(params), float(loss), to_np(grads)


def _node_idx(nb):
    """Each token draws its mask at a slot of its own row: here the first
    position of its segment (all tokens of a segment share one mask)."""
    seg = nb["segment_ids"]
    idx = np.zeros_like(seg)
    for r in range(seg.shape[0]):
        first = {}
        for p, s in enumerate(seg[r]):
            idx[r, p] = first.setdefault(int(s), p)
    return idx.astype(np.int32)


def _port(params, **kw):
    model = GraphGPTPretrain(TConfig(**{**COMMON, **kw}).finalize(), device="cpu")
    model.load_state_dict(params_from_jax(params, device="cpu"))
    return model


def _port_loss_and_grads(model, nb, generator=None):
    model.zero_grad(set_to_none=True)
    out = model(to_torch(nb, "cpu"), generator=generator, train=True)
    out["loss"].backward()
    return out["loss"].item(), {k: p.grad.clone() for k, p in model.named_parameters()}


def _assert_grads_match(got, want_tree):
    want = tree_from_jax(want_tree, device="cpu")
    assert set(got) == set(want)
    for name in sorted(got):
        g, w = got[name].numpy(), want[name].numpy()
        assert g.shape == w.shape, name
        assert np.linalg.norm(g - w) <= REL * np.linalg.norm(w) + 1e-9, name
        np.testing.assert_allclose(g, w, atol=ATOL, rtol=RTOL, err_msg=name)


REMAT = {
    "off": dict(remat=False),
    "full": dict(remat=True, remat_policy="full"),
    "pairs": dict(remat=True, remat_policy="pairs"),
    "save_attn": dict(remat=True, remat_policy="save_attn"),
}


@pytest.mark.parametrize("remat", sorted(REMAT))
@pytest.mark.parametrize("path", sorted(JAX_PATHS))
def test_loss_and_every_gradient_match_jax(path, remat):
    params, want_loss, want_grads = _jax_loss_and_grads(path)
    model = _port(params, **REMAT[remat])
    loss, grads = _port_loss_and_grads(model, _batch())
    assert abs(loss - want_loss) < 1e-5
    _assert_grads_match(grads, want_grads)


def test_quads_on_four_layers_gives_the_gradients_of_no_remat():
    cfg = dict(num_hidden_layers=4)
    base = GraphGPTPretrain(TConfig(**{**COMMON, **cfg}).finalize(), device="cpu", seed=3)
    loss0, g0 = _port_loss_and_grads(base, _batch())
    for policy in ("quads", "pairs", "save_attn", "full"):
        model = GraphGPTPretrain(
            TConfig(**{**COMMON, **cfg, "remat": True, "remat_policy": policy}).finalize(),
            device="cpu", seed=3,
        )
        loss, g = _port_loss_and_grads(model, _batch())
        assert loss == loss0
        for name in g0:  # the same operations in the same order: the same bits
            assert torch.equal(g[name], g0[name]), (policy, name)


@pytest.mark.parametrize("policy", ["dots", "save_attn_mlp"])
def test_unported_remat_policies_raise(policy):
    model = GraphGPTPretrain(
        TConfig(**{**COMMON, "remat": True, "remat_policy": policy}).finalize(), device="cpu"
    )
    with pytest.raises(NotImplementedError, match="remat_policy"):
        model(to_torch(_batch(), "cpu"), train=True)


def test_save_attn_recompute_does_not_run_the_flash_forward(monkeypatch):
    """One flash forward a layer in the whole step under save_attn, two
    under full rematerialisation."""
    from graphgpt_torch.ops import flash_attention as tfa

    calls = []
    real = tfa.flash_fwd
    monkeypatch.setattr(tfa, "flash_fwd", lambda *a, **kw: calls.append(1) or real(*a, **kw))
    for policy, want in (("save_attn", 2), ("full", 4)):
        calls.clear()
        model = GraphGPTPretrain(
            TConfig(**{**COMMON, "remat": True, "remat_policy": policy}).finalize(), device="cpu"
        )
        _port_loss_and_grads(model, _batch())
        assert len(calls) == want, policy


@pytest.mark.parametrize(
    "kw",
    [dict(stacked_feat_agg_method="gated"), dict(stack_method="long"),
     dict(stacked_feat_agg_method="gated", stack_method="long")],
    ids=["gated", "long", "gated-long"],
)
def test_embedding_variants_match_jax(kw):
    """The embedding gradient through the one-hot product (gated) and the
    count-matrix product (sum), with the `long` scaling."""
    params, want_loss, want_grads = _jax_loss_and_grads("xla", _freeze(kw))
    loss, grads = _port_loss_and_grads(_port(params, **kw), _batch())
    assert abs(loss - want_loss) < 1e-5
    _assert_grads_match(grads, want_grads)


@pytest.mark.parametrize(
    "kw",
    [dict(), dict(stacked_feat_agg_method="gated"), dict(stack_method="long")],
    ids=["sum", "gated", "long"],
)
def test_segment_sum_route_matches_jax(monkeypatch, kw):
    """The embedding gradient by the sorted segment sum, the route of a large
    vocab (the switch point set to 0 here; blocks of 8 and chunks of 64
    sorted slots, so that the runs cross blocks and chunks and take several
    levels), against `jax.grad`, at the tolerance of the test above."""
    monkeypatch.setattr(tmod, "SEGMENT_FIXED", 0)
    monkeypatch.setattr(tmod, "SEGMENT_PER_ID", 0)
    monkeypatch.setattr(tmod, "SEGMENT_BLOCK", 8)
    monkeypatch.setattr(tmod, "SEGMENT_CHUNK", 64)
    routes = []
    for name in ("_segment_sum_grad", "_count_matrix_grad"):
        real = getattr(tmod, name)
        monkeypatch.setattr(tmod, name, lambda *a, _r=real, _n=name: routes.append(_n) or _r(*a))
    params, want_loss, want_grads = _jax_loss_and_grads("xla", _freeze(kw))
    loss, grads = _port_loss_and_grads(_port(params, **kw), _batch())
    assert routes == ["_segment_sum_grad"]
    assert abs(loss - want_loss) < 1e-5
    _assert_grads_match(grads, want_grads)


@pytest.mark.parametrize("f", [1, 3, 13])
def test_segment_sum_is_the_scatter_add(monkeypatch, f):
    """Both routes against a float64 index_add_: a run of 700 equal ids (as
    the <bi> token of long rows), ids absent from the rows, a bf16
    cotangent summed in fp32; the segment sum the same on a second call."""
    monkeypatch.setattr(tmod, "SEGMENT_BLOCK", 16)
    monkeypatch.setattr(tmod, "SEGMENT_CHUNK", 256)
    rng = np.random.default_rng(f)
    ids = torch.from_numpy(rng.integers(0, 400, size=(900, f)))
    ids[:700, 0] = 5
    g = torch.from_numpy(rng.normal(size=(900, 16)).astype(np.float32))
    want = torch.zeros(401, 16, dtype=torch.float64)
    for c in range(f):
        want.index_add_(0, ids[:, c], g.double())
    got = tmod._segment_sum_grad(ids, g, 401)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-4)
    assert torch.equal(got, tmod._segment_sum_grad(ids, g, 401))
    np.testing.assert_allclose(tmod._count_matrix_grad(ids, g, 401, 128).numpy(), want.numpy(),
                               atol=1e-4)
    got16 = tmod._segment_sum_grad(ids, g.bfloat16(), 401)
    assert got16.dtype == torch.float32
    np.testing.assert_allclose(got16.numpy(), want.numpy(), atol=0.3)
    assert tmod._segment_sum_grad(ids[:0], g[:0], 401).abs().sum() == 0


@pytest.mark.parametrize(
    "blk, ids",
    [(2, [3, 7, 7, 9]), (128, list(range(128)) + [127] + list(range(128, 255)))],
    ids=["block2", "block128"],
)
def test_segment_sum_merges_a_run_split_across_blocks(monkeypatch, blk, ids):
    """A level that leaves two rows of one run in two blocks (sorted slots
    blk - 1 and blk: [a, b | b, c] at blocks of 2, a pair at slots 127/128
    at blocks of 128, every other id once) reduces nothing; the next level
    moves the boundaries and merges them. Held to a float64 index_add_, in
    few levels (a level that repeated itself forever fails here)."""
    monkeypatch.setattr(tmod, "SEGMENT_BLOCK", blk)
    levels = []
    real = tmod._block_run_sums

    def counted(*a):
        levels.append(len(a[0]))
        assert len(levels) <= 8, f"the segment sum's levels do not reduce: {levels}"
        return real(*a)

    monkeypatch.setattr(tmod, "_block_run_sums", counted)
    rng = np.random.default_rng(blk)
    ids = torch.as_tensor(rng.permutation(ids))[:, None]
    g = torch.from_numpy(rng.normal(size=(len(ids), 16)).astype(np.float32))
    want = torch.zeros(300, 16, dtype=torch.float64).index_add_(0, ids[:, 0], g.double())
    got = tmod._segment_sum_grad(ids, g, 300)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-5)


def test_the_route_switch():
    """The count matrix at a small vocab, the segment sum at a large one; the
    switch point falls with the rows and rises with the ids a row."""
    assert not tmod.segment_route(65536, 13, 755)  # a training batch of molecules
    assert tmod.segment_route(28672, 3, 576906)  # an ogbl-ppa fine-tune batch
    assert tmod.segment_route(995328, 1, 33254)  # ogbn-proteins, gated
    assert not tmod.segment_route(28672, 3, 16384) and tmod.segment_route(28672, 3, 65536)
    assert tmod.segment_route(995328, 1, 4096) and not tmod.segment_route(995328, 1, 1024)


def test_count_matrix_grad_is_the_scatter_add():
    rng = np.random.default_rng(0)
    ids = torch.from_numpy(rng.integers(0, 11, size=(300, 3)))
    g = torch.from_numpy(rng.normal(size=(300, 8)).astype(np.float32))
    want = torch.zeros(11, 8, dtype=torch.float64)
    for f in range(3):
        want.index_add_(0, ids[:, f], g.double())
    got = tmod._count_matrix_grad(ids, g, 11, chunk=128)  # a ragged last chunk
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-5)
    got16 = tmod._count_matrix_grad(ids, g.bfloat16(), 11, chunk=128)
    assert got16.dtype == torch.float32  # summed in fp32 whatever the cotangent's dtype
    np.testing.assert_allclose(got16.numpy(), want.numpy(), atol=0.15)


def test_contrastive_branch_matches_jax():
    kw = dict(use_discriminative=True)
    params, want_loss, want_grads = _jax_loss_and_grads("xla", _freeze(kw), b=4)
    assert "cl_proj" in params
    model = _port(params, **kw)
    out = model(to_torch(_batch(b=4), "cpu"), train=True)
    assert set(out) >= {"gen_loss", "dis_loss", "loss"}
    loss, grads = _port_loss_and_grads(model, _batch(b=4))
    assert abs(loss - want_loss) < 1e-5
    assert grads["cl_proj.weight"].abs().max() > 0
    _assert_grads_match(grads, want_grads)


def _jax_smtp_draws(rng, b, p, f):
    """The uniforms `smtp_inside_mask` draws from the key it is handed."""
    k_t, k_m, _, _ = jax.random.split(rng, 4)
    return (np.array(jax.random.uniform(k_t, (b, 1, 1))),
            np.array(jax.random.uniform(k_m, (b, p, f))))


@pytest.mark.parametrize("replace_rate", [0.0, 0.3], ids=["mask-only", "with-replacement"])
def test_smtp_inside_mask_from_the_jax_draws(replace_rate):
    nb = _batch()
    node_idx = _node_idx(nb)
    rng = jax.random.PRNGKey(11)
    want_masked, want_labels = jheads.smtp_inside_mask(
        jnp.asarray(nb["input_ids"]), jnp.asarray(node_idx), rng, power=0.7, mask_token_id=1,
        replace_rate=replace_rate, vocab_size=50,
    )
    shape = nb["input_ids"].shape
    t, u = _jax_smtp_draws(rng, *shape)
    _, _, k_r, k_tok = jax.random.split(rng, 4)
    ru = np.array(jax.random.uniform(k_r, shape))
    rtok = np.array(jax.random.randint(k_tok, shape, 1, 50))
    masked, labels = theads.smtp_inside_mask_from_draws(
        torch.from_numpy(nb["input_ids"]), torch.from_numpy(node_idx), torch.from_numpy(t),
        torch.from_numpy(u), power=0.7, mask_token_id=1, replace_rate=replace_rate,
        replace_u=torch.from_numpy(ru), replace_tokens=torch.from_numpy(rtok),
    )
    np.testing.assert_array_equal(masked.numpy(), np.asarray(want_masked))
    np.testing.assert_array_equal(labels.numpy(), np.asarray(want_labels))
    assert (labels.numpy() != -100).any() and (labels.numpy() == -100).any()
    if replace_rate:  # some masked cells carry a random token, not the mask id
        assert ((labels.numpy() != -100) & (masked.numpy() != 1)).any()


def test_smtp_inside_mask_wrapper_draws_replacements():
    nb = _batch()
    ids, idx = torch.from_numpy(nb["input_ids"]), torch.from_numpy(_node_idx(nb))
    masked, labels = theads.smtp_inside_mask(
        ids, idx, torch.Generator().manual_seed(0), replace_rate=0.5, vocab_size=50
    )
    on = labels != -100
    assert on.any() and bool((labels[on] == ids[on]).all()) and bool((masked[~on] == ids[~on]).all())
    assert bool(((masked[on] >= 1) & (masked[on] < 50)).all()) and bool((masked[on] != 1).any())


def test_smtp_inside_forward_matches_jax_with_its_draws(monkeypatch):
    """smtp_inside: the masks from the JAX draws, and the loss normalised by
    the weights' sum (no dLM normaliser), as `pretrain_forward` does."""
    kw = dict(smtp_inside=True, smtp_power=0.7)
    params, want_loss, want_grads = _jax_loss_and_grads("xla", _freeze(kw), rng_seed=5)
    nb = _batch()
    nb["node_idx"] = _node_idx(nb)
    _, r_smtp = jax.random.split(jax.random.PRNGKey(5))
    t, u = _jax_smtp_draws(r_smtp, *nb["input_ids"].shape)

    def with_jax_draws(input_ids, node_idx, generator, **opts):
        opts.pop("vocab_size")
        return theads.smtp_inside_mask_from_draws(
            input_ids, node_idx, torch.from_numpy(t), torch.from_numpy(u), **opts
        )

    monkeypatch.setattr(theads, "smtp_inside_mask", with_jax_draws)
    model = _port(params, **kw)
    loss, grads = _port_loss_and_grads(model, nb, generator=torch.Generator().manual_seed(0))
    assert abs(loss - want_loss) < 1e-5
    _assert_grads_match(grads, want_grads)


def test_smtp_inside_draws_from_the_generator():
    nb = _batch()
    nb["node_idx"] = _node_idx(nb)
    model = GraphGPTPretrain(TConfig(**{**COMMON, "smtp_inside": True}).finalize(), device="cpu")
    batch = to_torch(nb, "cpu")
    a = model(batch, generator=torch.Generator().manual_seed(1))["loss"]
    b = model(batch, generator=torch.Generator().manual_seed(1))["loss"]
    c = model(batch, generator=torch.Generator().manual_seed(2))["loss"]
    assert a.item() == b.item() != c.item()
    with pytest.raises(ValueError, match="generator"):
        model(batch)


def test_dlm_normaliser_only_without_smtp_inside():
    """With per-row weights the loss is sum / (B*P*N) unless smtp_inside."""
    nb = _batch()
    params, want_loss, _ = _jax_loss_and_grads("xla")
    model = _port(params)
    got = model.loss(to_torch(nb, "cpu")).item()
    assert abs(got - want_loss) < 1e-5
    no_wgt = {k: v for k, v in nb.items() if k != "wgt"}
    assert abs(model.loss(to_torch(no_wgt, "cpu")).item() - got) > 1e-3


# ---------------------------------------------------------------------------
# dropout and DropPath: held by their contracts (torch's generator does not
# give jax.random's bits)
# ---------------------------------------------------------------------------
def test_dropout_contract():
    x = torch.randn(64, 256, generator=torch.Generator().manual_seed(0)) + 3.0
    gen = torch.Generator().manual_seed(1)
    assert tmod._dropout(x, 0.0, gen, True) is x  # rate 0 is the identity
    assert tmod._dropout(x, 0.25, gen, False) is x  # eval is the identity
    assert tmod._dropout(x, 0.25, None, True) is x
    y = tmod._dropout(x, 0.25, gen, True)
    kept = y != 0
    assert abs(kept.float().mean().item() - 0.75) < 0.02
    torch.testing.assert_close(y[kept], (x / 0.75)[kept])  # kept values scaled by 1/keep
    y2 = tmod._dropout(x, 0.25, torch.Generator().manual_seed(1), True)
    assert torch.equal(y, y2)  # the same generator state gives the same mask


def test_drop_path_contract():
    x = torch.randn(512, 4, 8, generator=torch.Generator().manual_seed(0)) + 3.0
    gen = torch.Generator().manual_seed(2)
    torch.testing.assert_close(tmod._drop_path(x, 0.0, gen, True), x)  # rate 0 keeps all
    assert tmod._drop_path(x, 0.3, gen, False) is x
    y = tmod._drop_path(x, 0.3, gen, True)
    dropped = (y.reshape(512, -1) == 0).all(dim=1)
    assert abs(dropped.float().mean().item() - 0.3) < 0.06  # whole samples
    torch.testing.assert_close(y[~dropped], (x / 0.7)[~dropped])


@pytest.mark.parametrize(
    "rates",
    [dict(attention_dropout=0.2, embed_dropout=0.1),
     dict(path_dropout=0.3, mlp_dropout=0.2, attention_dropout=0.1)],
    ids=["fused-mlp", "split-mlp"],
)
def test_recompute_repeats_the_dropout_masks(rates):
    """The same step seed gives the same masks in the first pass and in the
    rematerialised one: remat on and off give the same bits."""
    nb = _batch(b=4)
    nb["wgt"] = np.ones(4, np.float32)
    ref = GraphGPTPretrain(TConfig(**{**COMMON, **rates}).finalize(), device="cpu", seed=1)
    loss0, g0 = _port_loss_and_grads(ref, nb, torch.Generator().manual_seed(7))
    eval_loss = ref.loss(to_torch(nb, "cpu")).item()
    assert loss0 != eval_loss  # the masks are on
    for policy in ("full", "save_attn", "pairs"):
        model = GraphGPTPretrain(
            TConfig(**{**COMMON, **rates, "remat": True, "remat_policy": policy}).finalize(),
            device="cpu", seed=1,
        )
        loss, g = _port_loss_and_grads(model, nb, torch.Generator().manual_seed(7))
        assert loss == loss0, policy
        for name in g0:
            assert torch.equal(g[name], g0[name]), (policy, name)
    other, _ = _port_loss_and_grads(ref, nb, torch.Generator().manual_seed(8))
    assert other != loss0  # another seed, other masks


def test_zero_rates_need_no_generator():
    """Static gating: with every rate at 0 training equals eval and no
    generator is read."""
    model = GraphGPTPretrain(TConfig(**COMMON).finalize(), device="cpu", seed=1)
    batch = to_torch(_batch(), "cpu")
    gen = torch.Generator().manual_seed(3)
    state = gen.get_state()
    train_loss = model(batch, generator=gen, train=True)["loss"].item()
    assert torch.equal(gen.get_state(), state)
    assert train_loss == model.loss(batch).item()


def test_eval_entry_points_build_no_graph():
    model = GraphGPTPretrain(TConfig(**COMMON).finalize(), device="cpu", seed=1)
    batch = to_torch(_batch(), "cpu")
    assert not model.loss(batch).requires_grad
    assert not model.logits(batch).requires_grad
    assert not model.hidden_states(batch).requires_grad
    assert model(batch)["loss"].requires_grad
