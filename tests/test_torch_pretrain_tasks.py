"""The other pretraining tasks of the stacked tokenizer and of
`PretrainPipeline` against the JAX package's, on the CPU.

The stacked rows of `pretrain-cl` (the trailing `<gsum>` row, its label
padded; the long stacking's label padding too), `pretrain-mlm-coord`,
`pretrain-smtp`, `pretrain-coord` and `pretrain-smtp-3d` (next-row labels
and the extras `node_idx`, `pos_type`, `pos`, under both rotations), and
the a2d instruction rows, bit for bit from the same seed;
`pretrain-coord-cl` raises in both packages. `rope_3d_cos_sin` and
`step_pos_emb` against JAX's. Then the pipeline of each task on a seeded
PCQM4M-v2-schema store with coordinates (hidden 64, 2 layers, fp32): the
model fields (`use_discriminative`, `smtp_inside`, `stacked_feat`,
`causal_attention`), the model family, the `pos_boundaries_{bins}` tables
of `pos_percentile_bounds` in every batch, the first two batches bit for
bit against JAX's `_device_batches` host arrays, and one step's loss and
gradients to 1e-4 relative from the same weights, on the JAX draws where
the step draws (`smtp_inside_mask_from_draws`, the position model's
`draws=`). A packed `pretrain-mlm-coord` row keeps its extras in the port
(each segment's `node_idx` shifted by its start), where the JAX
`_merge_packed` drops them: JAX's batch has no `pos_type`, so its step
there is taken on the port's batch. Under pretrain-cl the eval keeps each
view pair in one batch, the last partial one too.
"""

import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from graphgpt_tpu.config import Config as JConfig
from graphgpt_tpu.config import TokenizationConfig as JTok
from graphgpt_tpu.data import datasets as jdatasets
from graphgpt_tpu.data import euler as jeuler
from graphgpt_tpu.data import tokenizer as jtok
from graphgpt_tpu.data import vocab as jvocab
from graphgpt_tpu.models import rope as jrope
from graphgpt_tpu.training import pipeline as jpipeline
from graphgpt_torch.config import Config as TConfig
from graphgpt_torch.config import TokenizationConfig as TTok
from graphgpt_torch.data import euler as teuler
from graphgpt_torch.data import tokenizer as ttok
from graphgpt_torch.models import heads as theads
from graphgpt_torch.models import rope as trope
from graphgpt_torch.training import pipeline as tpipeline
from graphgpt_torch.utils.convert import params_from_jax, tree_from_jax
from test_torch_gst_tokenizer import assert_samples_equal
from test_torch_pos_pretrain import jax_draws

REL = 1e-4
MOL_CARDS = ([np.arange(c) for c in jdatasets.MOL_NODE_CARD],
             [np.arange(c) for c in jdatasets.MOL_EDGE_CARD])


@pytest.fixture(scope="module", autouse=True)
def numpy_walks():
    """Both packages' walks pinned to numpy, two torch threads."""
    saved = [(m._NATIVE_CHECKED, m._NATIVE) for m in (jeuler, teuler)]
    for m in (jeuler, teuler):
        m._NATIVE_CHECKED, m._NATIVE = True, None
    saved_threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(saved_threads)
    for m, s in zip((jeuler, teuler), saved):
        m._NATIVE_CHECKED, m._NATIVE = s


def _tok_cfgs(stack="short", **kw):
    out = []
    for cls in (JTok, TTok):
        cfg = cls()
        cfg.semantics.node.discrete, cfg.semantics.node.dim = "node_attr", 9
        cfg.semantics.edge.discrete, cfg.semantics.edge.dim = "edge_attr", 3
        cfg.stack_method = stack
        for k, v in kw.items():
            setattr(cfg, k, v)
        out.append(cfg)
    vm = jvocab.vocab_map_from_list(jvocab.build_vocab(out[0], *MOL_CARDS))
    return out[0], out[1], vm


def _molecules(n=5, with_pos=True):
    return [jdatasets.random_molecule_graph(np.random.default_rng(50 + i), 4, 16,
                                            with_pos=with_pos and i != 2) for i in range(n)]


@pytest.mark.parametrize("task,stack,rotation", [
    ("pretrain-cl", "short", "anchor_rotate"),
    ("pretrain-cl", "long", "anchor_rotate"),
    ("pretrain-mlm-coord", "short", "anchor_rotate"),
    ("pretrain-mlm-coord", "short", "trans_rotate"),
    ("pretrain-smtp", "short", "anchor_rotate"),
    ("pretrain-coord", "short", "anchor_rotate"),
    ("pretrain-coord", "short", "trans_rotate"),
    ("pretrain-smtp-3d", "short", "trans_rotate"),
])
def test_stacked_rows_match_jax(task, stack, rotation):
    """Each row, label and extra bit for bit (the third molecule has no
    coordinates: no `pos` extra)."""
    jcfg, tcfg, vm = _tok_cfgs(stack, rotation=rotation)
    jcls = jtok.StackedGSTTokenizerLong if stack == "long" else jtok.StackedGSTTokenizer
    tcls = ttok.StackedGSTTokenizerLong if stack == "long" else ttok.StackedGSTTokenizer
    jt, tt = jcls(jcfg, vm, task_type=task), tcls(tcfg, vm, task_type=task)
    for i, g in enumerate(_molecules()):
        want, got = jt(g, np.random.default_rng(i)), tt(g, np.random.default_rng(i))
        assert_samples_equal(got, want, f"{task} graph {i}")
        if task == "pretrain-cl":
            assert (got.input_ids[-1] == tt.gsum_id).all() and (got.labels[-1] == -100).all()
        if task != "pretrain-cl":
            assert {"node_idx", "pos_type"} <= set(got.extras)
            assert ("pos" in got.extras) == (g.pos is not None)


def test_a2d_rows_and_coord_cl_as_jax():
    """The a2d instruction rows (a header row of the key type's reserved
    token, then a full row a node) bit for bit; `pretrain-coord-cl` has no
    rows in either package."""
    jcfg, tcfg, vm = _tok_cfgs()
    jcfg.semantics.instruct_funcs = tcfg.semantics.instruct_funcs = ("a2d",)
    for task in ("pretrain", "pretrain-mlm", "graph"):
        jt = jtok.StackedGSTTokenizer(jcfg, vm, task_type=task)
        tt = ttok.StackedGSTTokenizer(tcfg, vm, task_type=task)
        for i, g in enumerate(_molecules(with_pos=False)):
            rng = np.random.default_rng(i)
            g.extra["a2d"] = np.stack([rng.choice(g.num_nodes, 2, replace=False)
                                       for _ in range(3)]).astype(np.int64)
            g.extra["key_type"] = np.int64(i % 4)
            want, got = jt(g, np.random.default_rng(i)), tt(g, np.random.default_rng(i))
            assert_samples_equal(got, want, f"{task} graph {i}")
            if task == "pretrain":
                assert (got.input_ids[-7] == vm[f"semantics_{i % 4}"]).all()
    for mod, cfg in ((jtok, jcfg), (ttok, tcfg)):
        tok = mod.StackedGSTTokenizer(cfg, vm, task_type="pretrain-coord-cl")
        with pytest.raises(NotImplementedError, match="pretrain-coord-cl"):
            tok(_molecules()[0], np.random.default_rng(0))


@pytest.mark.parametrize("head_dim", [32, 64, 40])
def test_rope_3d_and_step_table_match_jax(head_dim):
    pos = np.random.default_rng(head_dim).integers(0, 256, (2, 24, 3)).astype(np.int32)
    want = jrope.rope_3d_cos_sin(jnp.asarray(pos), head_dim)
    got = trope.rope_3d_cos_sin(torch.from_numpy(pos), head_dim)
    for g, w in zip(got, want):
        assert g.shape == (2, 24, head_dim) and g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=2e-6, rtol=0)
    np.testing.assert_array_equal(trope.step_pos_emb(head_dim, 300),
                                  jrope.step_pos_emb(head_dim, 300))


# ---------------------------------------------------------------------------
# the pipelines
# ---------------------------------------------------------------------------
def write_pos_store(root, n_graphs=96):
    """A PCQM4M-v2-schema store (9 node, 3 edge attributes, one target) with
    coordinates, seeded; splits 64/16/16."""
    d = os.path.join(root, "pcqm4m-v2")
    os.makedirs(d, exist_ok=True)
    gs = [jdatasets.random_molecule_graph(np.random.default_rng(i), 4, 18, with_pos=True)
          for i in range(n_graphs)]

    def ptr(xs):
        return np.concatenate([[0], np.cumsum(xs)]).astype(np.int64)

    node_ptr = ptr([g.num_nodes for g in gs])
    np.savez(os.path.join(d, "graphs.npz"),
             node_attr=np.concatenate([g.node_attr for g in gs]),
             edge_attr=np.concatenate([g.edge_attr for g in gs]),
             edge_index=np.concatenate([g.edge_index + o for g, o in zip(gs, node_ptr)], axis=1),
             node_ptr=node_ptr, edge_ptr=ptr([g.num_edges for g in gs]),
             y=np.stack([g.y for g in gs]).astype(np.float32),
             pos=np.concatenate([g.pos for g in gs]).astype(np.float32),
             train_idx=np.arange(64), valid_idx=np.arange(64, 80), test_idx=np.arange(80, 96))
    return root


TASKS = {  # task: (packed, model family)
    "pretrain-cl": (False, "GraphGPTPretrain"),
    "pretrain-smtp": (False, "GraphGPTPretrain"),
    "pretrain-coord": (False, "GraphGPTPosPred"),
    "pretrain-mlm-coord": (True, "GraphGPTPosPred"),
}


def _cfg(cls, out_dir, data_dir, task):
    cfg = cls()
    tok = cfg.tokenization
    tok.dataset, tok.data_dir = "pcqm4m-v2", data_dir
    tok.semantics.node.discrete, tok.semantics.node.dim = "node_attr", 9
    tok.semantics.edge.discrete, tok.semantics.edge.dim = "edge_attr", 3
    tok.dataset_policy = {"pos_percentile_bounds": True}
    m = cfg.model
    m.hidden_size, m.num_hidden_layers, m.head_dim, m.dtype = 64, 2, 16, "float32"
    m.pos_num_bins, m.pos_problem_type = 128, "pos-smtp-line"
    t = cfg.training
    t.task_type = task
    t.batch_size, t.max_length, t.num_workers = 8, 128, 0
    t.pack_tokens = 1 if TASKS[task][0] else 0
    t.schedule.total_num_steps, t.schedule.warmup_num_steps = 2, 1
    t.do_valid, t.inspect_tokenization, t.tot_samples = False, False, 16
    t.output_dir = str(out_dir)
    return cfg


@functools.lru_cache(maxsize=None)
def _jax_side(task, root):
    """The JAX pipeline's model fields, family, constant tables, first two
    batches (the tables taken out) and initial parameters."""
    jpipe = jpipeline.PretrainPipeline(
        _cfg(JConfig, os.path.join(root, "jax", task), os.path.join(root, "jdata"), task)).setup()
    try:
        batches = [{k: np.asarray(v) for k, v in b.items() if not k.startswith("_")}
                   for b, _ in zip(jpipe._device_batches(0), range(2))]
    finally:
        jpipe.loader.close()
    consts = {k: np.asarray(v) for k, v in jpipe._const_batch.items()}
    for b in batches:  # JAX merges the tables into its device batches
        for key, table in consts.items():
            np.testing.assert_array_equal(b.pop(key), table)
    params = jax.tree_util.tree_map(np.asarray, jpipe.state.params)
    return jpipe.cfg.model, jpipe.forward_fn.__name__, consts, batches, params


@pytest.fixture(scope="module")
def stores(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("pos_store"))
    for sub in ("jdata", "tdata"):  # each package builds its own boundary tables
        write_pos_store(os.path.join(root, sub))
    return root


def _jax_loss_and_grads(forward_name, jm, params, batch, key):
    from graphgpt_tpu.models import heads as jheads
    from graphgpt_tpu.models import pos_pretrain as jpos

    fwd = jpos.pos_pred_forward if forward_name == "pos_pred_forward" else jheads.pretrain_forward

    def loss_fn(p):
        return fwd(p, jm, batch, rng=key, train=True)["loss"]

    loss, grads = jax.jit(jax.value_and_grad(loss_fn))(params)
    return float(loss), tree_from_jax(jax.tree_util.tree_map(np.asarray, grads), device="cpu")


@pytest.mark.parametrize("task", list(TASKS))
def test_pipeline_matches_jax(task, stores, tmp_path, monkeypatch):
    jm, forward_name, consts, want, params = _jax_side(task, stores)
    tpipe = tpipeline.PretrainPipeline(
        _cfg(TConfig, tmp_path, os.path.join(stores, "tdata"), task), device="cpu").setup()
    try:
        m = tpipe.cfg.model
        for key in ("use_discriminative", "smtp_inside", "stacked_feat", "next_n_token",
                    "causal_attention", "vocab_size"):
            assert getattr(m, key) == getattr(jm, key), key
        assert m.use_discriminative == (task == "pretrain-cl")
        assert m.smtp_inside == (task == "pretrain-smtp")
        assert type(tpipe.state.model).__name__ == TASKS[task][1]
        assert forward_name == ("pos_pred_forward" if "coord" in task else "pretrain_forward")
        # pos_num_bins 128, pos_num_bins_line 256 (its default); no 32 table
        assert sorted(tpipe._const_batch) == sorted(consts) == [
            "pos_boundaries_128", "pos_boundaries_256"]
        for key, table in consts.items():
            np.testing.assert_array_equal(tpipe._const_batch[key].numpy(), table)
        got = [b for b, _ in zip(tpipe._device_batches(0), range(2))]
        for (g, n), w in zip(got, want):
            for key in w:
                np.testing.assert_array_equal(g[key], w[key], err_msg=key)
            assert n == int((w["segment_ids"] > 0).sum())
            if task == "pretrain-mlm-coord":  # the port keeps the packed extras
                assert {"node_idx", "pos_type", "pos"} <= set(g) - set(w)
            else:
                assert sorted(g) == sorted(w)
        # the step's batch: on the device (the CPU here) with the tables
        batch, _ = next(tpipe._device_prefetch(iter(got[:1])))
        assert "pos_boundaries_128" in batch
        nb = {k: v.numpy() for k, v in batch.items()}
        model = tpipe.state.model
        model.load_state_dict(params_from_jax(params, device="cpu"))
        key = jax.random.PRNGKey(3)
        want_loss, want_grads = _jax_loss_and_grads(forward_name, jm, params, nb, key)
        kw = {}
        if "coord" in task:
            b, p, f = nb["input_ids"].shape
            kw["draws"] = {k: torch.from_numpy(np.array(v))
                           for k, v in jax_draws(key, b, p, f).items()}
        if task == "pretrain-smtp":
            _, r_smtp = jax.random.split(key)
            k_t, k_m, _, _ = jax.random.split(r_smtp, 4)
            shape = nb["input_ids"].shape
            t = torch.from_numpy(np.array(jax.random.uniform(k_t, (shape[0], 1, 1))))
            u = torch.from_numpy(np.array(jax.random.uniform(k_m, shape)))

            def with_jax_draws(input_ids, node_idx, generator, **opts):
                opts.pop("vocab_size")
                return theads.smtp_inside_mask_from_draws(input_ids, node_idx, t, u, **opts)

            monkeypatch.setattr(theads, "smtp_inside_mask", with_jax_draws)
        model.zero_grad(set_to_none=True)
        out = model(batch, generator=torch.Generator().manual_seed(0), train=True, **kw)
        out["loss"].backward()
        assert abs(out["loss"].item() - want_loss) <= REL * abs(want_loss)
        if task == "pretrain-cl":
            assert out["dis_loss"].item() > 0
        for name, p in model.named_parameters():
            w = want_grads[name].numpy()
            g = np.zeros_like(w) if p.grad is None else p.grad.numpy()
            assert np.linalg.norm(g - w) <= REL * np.linalg.norm(w) + 1e-9, name
        # a step and an eval (in-model SMTP and the position model draw from
        # a generator seeded 0 there)
        tpipe.state, metrics = tpipe.train_step(tpipe.state, batch, seed=0)
        assert np.isfinite(float(metrics["loss"]))
        losses, _ = tpipe._eval_losses(tpipe.train_idx[:11])
        assert losses and all(np.isfinite(losses))
    finally:
        tpipe.loader.close()


def test_cl_eval_keeps_view_pairs(stores, tmp_path):
    """Eleven graphs at batch 8: the eval asks the loader for two adjacent
    views of each and gets batches of 8, 8 and 6 rows, so that no pair is
    split (an odd batch_size_eval is taken down to even); an odd training
    batch raises."""
    cfg = _cfg(TConfig, tmp_path, os.path.join(stores, "tdata"), "pretrain-cl")
    cfg.training.batch_size_eval = 9
    pipe = tpipeline.PretrainPipeline(cfg, device="cpu").setup()
    asked = []
    epoch_batches = pipe.loader.epoch_batches

    def spy(idx, **kw):
        asked.append((np.asarray(idx), kw["batch_size"]))
        return epoch_batches(idx, **kw)

    pipe.loader.epoch_batches = spy
    try:
        vidx = pipe.train_idx[:11]
        batches = list(pipe._eval_batches(vidx))
        np.testing.assert_array_equal(asked[0][0], np.repeat(vidx, 2))
        assert asked[0][1] == 8
        assert [b["input_ids"].shape[0] for b in batches] == [8, 8, 6]
    finally:
        pipe.loader.close()
    cfg = _cfg(TConfig, tmp_path / "odd", os.path.join(stores, "tdata"), "pretrain-cl")
    cfg.training.batch_size = 7
    with pytest.raises(ValueError, match="even"):
        tpipeline.PretrainPipeline(cfg, device="cpu").setup()
