"""The port's flat `GSTTokenizer`, its structure and instruction streams and
the `structure_er` reader against the JAX package's, on the CPU.

Every task branch of the flat tokenizer gives the JAX tokenizer's ids,
labels, position ids, labels of the fine-tune tasks and extras bit for bit
from the same seed: under each `attr_assignment` mode, cyclic 0/1/2,
two-level node ids, the edge-type tokens kept, shuffled attribute columns,
continuous attributes, `label_tokens_to_pad`, and the nx and instruction
streams (one case a row of CASES, every task in it). Both walk in numpy.
Then the streams alone on `structure_er` graphs, the reader's graphs,
`erdos_renyi_graph`, `rebase_index_tokens` and the vocab file of a GST
config; then `PretrainPipeline` with the flat tokenizer (causal next-token
pretraining unpacked, and pretrain-euler on structure_er with all four nx
streams) and `FinetunePipeline` on flat graph rows, each against the JAX
pipeline from the same weights: the model fields, the first batches bit for
bit and four steps' losses to 1e-4 relative. A packed flat row keeps each
segment's cyclic position ids (shifted by the segment's start), where the
JAX `_merge_packed` numbers the row 0..P-1. Flat rows take the masking
after packing and the generation sweep (port only: the JAX functions take
[P, F] rows). A `GSTTokenizer` and the structure_er dataset go through the
loader's spawned workers.
"""

import csv
import os
import pickle

import jax
import numpy as np
import pytest
import torch

from graphgpt_tpu import readers as jreaders
from graphgpt_tpu.config import Config as JConfig
from graphgpt_tpu.config import MlmScheduleConfig as JMlm
from graphgpt_tpu.config import TokenizationConfig as JTok
from graphgpt_tpu.data import datasets as jdatasets
from graphgpt_tpu.data import euler as jeuler
from graphgpt_tpu.data import gst_tokenizer as jgst
from graphgpt_tpu.data import structure_tasks as jst
from graphgpt_tpu.data import vocab as jvocab
from graphgpt_tpu.data.graph import Graph as JGraph
from graphgpt_tpu.training import finetune as jft
from graphgpt_tpu.training import pipeline as jpipeline
from graphgpt_torch import readers as treaders
from graphgpt_torch.config import Config as TConfig
from graphgpt_torch.config import MlmScheduleConfig as TMlm
from graphgpt_torch.config import TokenizationConfig as TTok
from graphgpt_torch.data import datasets as tdatasets
from graphgpt_torch.data import euler as teuler
from graphgpt_torch.data import gst_tokenizer as tgst
from graphgpt_torch.data import structure_tasks as tst
from graphgpt_torch.data.collator import pack_samples
from graphgpt_torch.data.graph import CSR
from graphgpt_torch.data.graph import Graph as TGraph
from graphgpt_torch.data.loader import GraphTokenLoader
from graphgpt_torch.training import finetune as tft
from graphgpt_torch.training import pipeline as tpipeline
from graphgpt_torch.training.steps import init_train_state
from graphgpt_torch.utils.convert import params_from_jax

REL = 1e-4
MOL_CARDS = ([np.arange(c) for c in jdatasets.MOL_NODE_CARD],
             [np.arange(c) for c in jdatasets.MOL_EDGE_CARD])
NX = ("degree", "triangles", "shortest_path", "shortest_path_length")
TASKS = ("pretrain", "pretrain-ltp", "pretrain-euler", "pretrain-mlm", "pretrain-cl", "graph",
         "node", "edge", "nodev2")
# tokenization settings of each case (dotted paths into TokenizationConfig)
CASES = {
    "first-cyclic": {},
    "last-normal": {"semantics.attr_assignment": "last", "structure.node.cyclic": 0},
    "random-random-ids": {"semantics.attr_assignment": "random", "structure.node.cyclic": 2},
    "all-shuffled": {"semantics.attr_assignment": "all", "semantics.attr_shuffle": True},
    "mix": {"semantics.attr_assignment": "mix"},
    "two-level-ids": {"structure.node.scope_base": 16, "structure.node.cyclic": 2},
    "edge-types": {"structure.edge.remove_edge_type_token": False, "structure.node.cyclic": 0},
    "nx-streams": {"structure.nx_funcs": NX},
    "instructions": {"semantics.instruct_funcs": ("homo_lumo", "cepdb_prop_all", "a2d"),
                     "semantics.attr_assignment": "mix"},
    "label-pad-euler": {"label_tokens_to_pad": ("<eos>",),
                        "semantics.instruct_funcs": ("homo_lumo",), "structure.nx_funcs": NX},
    "continuous": {"attr_world_identifier": "prot", "semantics.node.discrete": None,
                   "semantics.node.continuous": "node_cont", "semantics.node.dim": 2,
                   "semantics.edge.discrete": None, "semantics.edge.dim": 0},
}


@pytest.fixture(scope="module", autouse=True)
def numpy_walks():
    """Both packages' walks pinned to numpy for the module."""
    saved = [(m._NATIVE_CHECKED, m._NATIVE) for m in (jeuler, teuler)]
    for m in (jeuler, teuler):
        m._NATIVE_CHECKED, m._NATIVE = True, None
    saved_threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(saved_threads)
    for m, s in zip((jeuler, teuler), saved):
        m._NATIVE_CHECKED, m._NATIVE = s


def _set(cfg, settings):
    for path, val in settings.items():
        obj, parts = cfg, path.split(".")
        for p in parts[:-1]:
            obj = getattr(obj, p)
        setattr(obj, parts[-1], val)
    return cfg


def _tok_cfgs(settings):
    """(JAX tokenization config, port's, vocab map) of a case: the molecule
    schema (9 node, 3 edge attributes), then the case's settings."""
    out = []
    for cls in (JTok, TTok):
        cfg = cls()
        cfg.semantics.node.discrete, cfg.semantics.node.dim = "node_attr", 9
        cfg.semantics.edge.discrete, cfg.semantics.edge.dim = "edge_attr", 3
        out.append(_set(cfg, settings))
    discrete = out[0].semantics.node.discrete is not None
    vm = jvocab.vocab_map_from_list(jvocab.build_vocab(out[0], *(MOL_CARDS if discrete else ())))
    return out[0], out[1], vm


def _graphs(case, task, n=4):
    """Pairs of equal graphs (JAX's, port's) for a case and task: synthetic
    molecules with a2d pairs, seven targets for cepdb_prop_all, the nodes'
    classes for nodev2, seeds for node and edge; or small continuous-attribute
    graphs."""
    out = []
    for i in range(n):
        rng = np.random.default_rng(100 + i)
        if case == "continuous":
            m = int(rng.integers(3, 7))
            src = np.arange(m - 1)
            kw = dict(num_nodes=m, edge_index=np.stack(
                [np.r_[src, src + 1], np.r_[src + 1, src]]).astype(np.int32))
            cont = np.asarray([[int(rng.integers(0, 900)), round(float(rng.random()), 2)]
                               for _ in range(m)], object)
            extra = {"node_cont": cont}
            y = np.asarray([1.5], np.float32)
        else:
            g = jdatasets.random_molecule_graph(rng, 5, 14)
            kw = dict(num_nodes=g.num_nodes, edge_index=g.edge_index, node_attr=g.node_attr,
                      edge_attr=g.edge_attr)
            pairs = np.stack([rng.choice(g.num_nodes, 2, replace=False) for _ in range(2)])
            extra = {"a2d": pairs.astype(np.int64), "key_type": np.int64(i % 3)}
            y = (np.round(rng.normal(size=7), 3).astype(np.float32) if i % 2
                 else np.asarray([round(float(rng.normal(5, 1)), 3)], np.float32))
        if task == "nodev2" or task == "node":
            y = (np.arange(kw["num_nodes"]) % 3).reshape(-1, 1)
        root = None
        if task == "node":
            root = np.asarray([i % kw["num_nodes"]])
        elif task == "edge":
            root = np.asarray([0, kw["num_nodes"] - 1])
            y = np.asarray([1.0], np.float32)
        out.append(tuple(cls(**kw, y=y, root_n_id=root, extra=dict(extra))
                         for cls in (JGraph, TGraph)))
    return out


def assert_samples_equal(got, want, tag=""):
    for key in ("input_ids", "labels", "position_ids", "attention_mask", "graph_labels",
                "node_labels", "edge_labels"):
        a, b = getattr(got, key), getattr(want, key)
        assert (a is None) == (b is None), (tag, key)
        if a is not None:
            np.testing.assert_array_equal(a, b, err_msg=f"{tag} {key}")
    assert got.wgt == want.wgt and got.segment_lengths == want.segment_lengths, tag
    assert sorted(got.extras) == sorted(want.extras), tag
    for key in got.extras:
        np.testing.assert_array_equal(got.extras[key], want.extras[key], err_msg=f"{tag} {key}")


@pytest.mark.parametrize("case", list(CASES))
def test_every_task_tokenizes_as_jax(case):
    jcfg, tcfg, vm = _tok_cfgs(CASES[case])
    for task in TASKS:
        if case == "continuous" and task in ("node", "nodev2", "edge"):
            continue  # the seeds' and classes' rows are the molecule cases'
        n_cls = 3 if task == "nodev2" and case == "mix" else 0
        jt = jgst.GSTTokenizer(jcfg, vm, task_type=task, mlm_cfg=JMlm(), num_intra_cls=n_cls)
        tt = tgst.GSTTokenizer(tcfg, vm, task_type=task, mlm_cfg=TMlm(), num_intra_cls=n_cls)
        for i, (jg, tg) in enumerate(_graphs(case, task)):
            want = jt(jg, np.random.default_rng(i))
            got = tt(tg, np.random.default_rng(i))
            assert_samples_equal(got, want, f"{case} {task} graph {i}")
            assert got.input_ids.ndim == 1
    if case in ("nx-streams", "instructions"):  # the streams are there
        got = tgst.GSTTokenizer(tcfg, vm)(_graphs(case, "pretrain")[1][1],
                                         np.random.default_rng(0))
        marks = ({vm[f"structure_{k}"] for k in range(4)} if case == "nx-streams"
                 else {vm["semantics_0"], vm["semantics_1"]})
        assert marks & set(got.input_ids.tolist())


def test_occurrence_mask_and_the_unknown_task_as_jax():
    keys = ["a", "b", "a", "c", "b", "a"]
    for mode in ("first", "last", "random", "all", "mix"):
        for seed in range(4):
            np.testing.assert_array_equal(
                tgst.occurrence_mask(keys, mode, np.random.default_rng(seed)),
                jgst.occurrence_mask(keys, mode, np.random.default_rng(seed)))
    jcfg, tcfg, vm = _tok_cfgs({})
    jg, tg = _graphs("first-cyclic", "pretrain")[0]
    for mod, cfg, g in ((jgst, jcfg, jg), (tgst, tcfg, tg)):
        with pytest.raises(NotImplementedError, match="pretrain-coord"):
            mod.GSTTokenizer(cfg, vm, task_type="pretrain-coord")(g, np.random.default_rng(0))
        with pytest.raises(ValueError, match="reserved"):
            mod.GSTTokenizer(cfg, vm, task_type="nodev2", num_intra_cls=11)


def test_structure_streams_on_er_graphs_match_jax():
    """Each nx stream alone and all four shuffled together on structure_er
    graphs (disconnected ones among them: shortest_path_length's -1), and
    the BFS path against JAX's."""
    jcfg, tcfg, vm = _tok_cfgs({})
    jds = jreaders.read_dataset("structure_er", JConfig(), size=40)
    tds = treaders.read_dataset("structure_er", TConfig(), size=40)
    unreachable = 0
    for i in range(40):
        jg, tg = jds[i], tds[i]
        ids = np.asarray(vm["0"] + np.arange(jg.num_nodes) % 50, np.int32)
        for funcs in [(f,) for f in NX] + [NX]:
            want = jst.structure_task_tokens(jg, list(funcs), ids, jcfg, vm, 2,
                                             np.random.default_rng(i))
            got = tst.structure_task_tokens(tg, list(funcs), ids, tcfg, vm, 2,
                                            np.random.default_rng(i))
            assert got == want, (i, funcs)
        csr = CSR(tg.num_nodes, tg.edge_index)
        for dst in range(1, tg.num_nodes):
            path = tst._bfs_path(csr, 0, dst)
            assert path == jst._bfs_path(CSR(jg.num_nodes, jg.edge_index), 0, dst)
            unreachable += not path
    assert unreachable > 0


def test_er_graphs_reader_and_rebase_tokens_match_jax():
    for seed in range(6):
        n, p = 5 + seed * 4, 0.1 + 0.05 * seed
        want = jdatasets.erdos_renyi_graph(np.random.default_rng(seed), n, p)
        got = tdatasets.erdos_renyi_graph(np.random.default_rng(seed), n, p)
        assert got.num_nodes == want.num_nodes and got.node_attr is None
        np.testing.assert_array_equal(got.edge_index, want.edge_index)
    cfg_j, cfg_t = JConfig(), TConfig()
    cfg_j.training.seed = cfg_t.training.seed = 3
    jds = jreaders.read_dataset("structure_er", cfg_j)
    tds = pickle.loads(pickle.dumps(treaders.read_dataset("structure_er", cfg_t)))
    assert len(tds) == len(jds) == 20000
    for i in (0, 1, 7, 19999):
        assert tds[i].num_nodes == jds[i].num_nodes and tds[i].idx == i
        np.testing.assert_array_equal(tds[i].edge_index, jds[i].edge_index)
    for idx, base in ((0, 16), (15, 16), (16, 16), (255, 16), (37, 0), (511, 512)):
        assert teuler.rebase_index_tokens(idx, base) == jeuler.rebase_index_tokens(idx, base)


def test_gst_vocab_file_matches_jax(tmp_path):
    """The vocab file of a flat config with two-level ids (the k*base high
    tokens, the edge-type tokens, the digit tokens) byte for byte."""
    files = []
    for cls, mod in ((JConfig, jpipeline), (TConfig, tpipeline)):
        cfg = cls()
        tok = cfg.tokenization
        tok.tokenizer_class = "GSTTokenizer"
        tok.semantics.node.discrete, tok.semantics.node.dim = "node_attr", 9
        tok.semantics.edge.discrete, tok.semantics.edge.dim = "edge_attr", 3
        tok.structure.node.node_scope, tok.structure.node.scope_base = 512, 32
        cfg.training.output_dir = str(tmp_path / cls.__module__)
        t = mod.build_tokenizer(cfg, mod.build_dataset(cfg))
        assert type(t).__name__ == "GSTTokenizer"
        with open(os.path.join(cfg.training.output_dir, "vocab"), "rb") as f:
            files.append(f.read())
    assert files[0] == files[1]
    text = files[1].decode()
    assert "15*32 " in text and "<edge_jump> " in text and "<7> " in text


# ---------------------------------------------------------------------------
# the pipelines
# ---------------------------------------------------------------------------
PIPES = {
    # causal next-token pretraining, unpacked (the JAX packing renumbers the
    # rows' position ids: see test_packed_flat_rows_keep_their_segments_ids)
    "pretrain-causal": dict(task="pretrain", dataset="synthetic_mol", causal=True),
    "euler-structure-er": dict(task="pretrain-euler", dataset="structure_er", causal=True,
                               tok={"structure.nx_funcs": NX, "label_tokens_to_pad": ("<eos>",),
                                    "semantics.node.discrete": None, "semantics.node.dim": 0,
                                    "semantics.edge.discrete": None, "semantics.edge.dim": 0}),
}


def _pipe_cfg(cls, out_dir, spec):
    cfg = cls()
    tok = cfg.tokenization
    tok.tokenizer_class, tok.dataset = "GSTTokenizer", spec["dataset"]
    tok.semantics.node.discrete, tok.semantics.node.dim = "node_attr", 9
    tok.semantics.edge.discrete, tok.semantics.edge.dim = "edge_attr", 3
    _set(tok, spec.get("tok", {}))
    m = cfg.model
    m.hidden_size, m.num_hidden_layers, m.head_dim, m.dtype = 64, 2, 16, "float32"
    m.causal_attention = spec["causal"]
    t = cfg.training
    t.task_type = spec["task"]
    t.batch_size, t.max_length, t.pack_tokens, t.num_workers = 8, 128, 0, 0
    t.schedule.total_num_steps, t.schedule.warmup_num_steps = 4, 1
    t.schedule.logging_steps, t.schedule.steps_per_saving = 1, 0
    t.do_valid, t.inspect_tokenization, t.tot_samples = False, False, 16
    t.output_dir = str(out_dir)
    return cfg


def _rows(path):
    with open(path) as f:
        return list(csv.DictReader(f))


def _losses_close(jdir, tdir, name, steps, keys):
    want, got = _rows(jdir / name), _rows(tdir / name)
    assert len(got) == len(want) == steps
    for w, g in zip(want, got):
        for key in keys:
            assert abs(float(g[key]) - float(w[key])) <= REL * abs(float(w[key])) + 1e-9, key


@pytest.mark.parametrize("name", list(PIPES))
def test_flat_pretrain_pipeline_matches_jax(tmp_path, name):
    spec = PIPES[name]
    jpipe = jpipeline.PretrainPipeline(_pipe_cfg(JConfig, tmp_path / "jax", spec)).setup()
    try:
        want = [{k: np.asarray(v) for k, v in b.items() if not k.startswith("_")}
                for b, _ in zip(jpipe._device_batches(0), range(2))]
        params = jax.tree_util.tree_map(np.asarray, jpipe.state.params)
        jpipe.run()
    finally:
        jpipe.loader.close()
    tpipe = tpipeline.PretrainPipeline(_pipe_cfg(TConfig, tmp_path / "port", spec),
                                       device="cpu").setup()
    assert type(tpipe.tokenizer).__name__ == "GSTTokenizer"
    for key in ("vocab_size", "stacked_feat", "next_n_token", "causal_attention",
                "use_discriminative", "smtp_inside"):
        assert getattr(tpipe.cfg.model, key) == getattr(jpipe.cfg.model, key), key
    assert tpipe.cfg.model.stacked_feat == 1 and tpipe.cfg.model.causal_attention
    got = [b for b, _ in zip(tpipe._device_batches(0), range(2))]
    for g, w in zip(got, want):
        assert sorted(g[0]) == sorted(w) and g[0]["input_ids"].ndim == 2
        for key in w:
            np.testing.assert_array_equal(g[0][key], w[key], err_msg=key)
        assert g[1] == int((w["segment_ids"] > 0).sum())
    model = tpipe.state.model
    model.load_state_dict(params_from_jax(params, device="cpu"))
    tpipe.state = init_train_state(model, tpipe.tx)
    tpipe.run()
    _losses_close(tmp_path / "jax", tmp_path / "port", "log.csv", 4, ("loss", "gen_loss"))


def test_packed_flat_rows_keep_their_segments_ids():
    """Packing flat rows: each segment keeps its own cyclic position ids,
    shifted by its start in the row (RoPE sees the same differences inside a
    segment); the JAX `_merge_packed` numbers the row 0..P-1. Stacked rows
    (0..n-1 each) come out as the JAX rows."""
    from graphgpt_tpu.data.collator import pack_samples as jpack

    _, tcfg, vm = _tok_cfgs({})
    tok = tgst.GSTTokenizer(tcfg, vm)
    samples = [tok(g, np.random.default_rng(i))
               for i, (_, g) in enumerate(_graphs("first-cyclic", "pretrain", n=6))]
    rows = list(pack_samples(samples, 128))
    want = list(jpack(samples, 128))
    assert len(rows) == len(want)
    start = 0
    for row, jrow in zip(rows, want):
        np.testing.assert_array_equal(row.input_ids, jrow.input_ids)
        np.testing.assert_array_equal(jrow.position_ids, np.arange(len(jrow.input_ids)))
        start = 0
        for n, s in zip(row.segment_lengths, samples[: len(row.segment_lengths)]):
            np.testing.assert_array_equal(row.position_ids[start:start + n],
                                          s.position_ids[:n] + start)
            start += n
        samples = samples[len(row.segment_lengths):]
    assert start > 0


def _ft_cfg(cls, out_dir):
    cfg = cls()
    tok = cfg.tokenization
    tok.tokenizer_class = "GSTTokenizer"
    tok.semantics.node.discrete, tok.semantics.node.dim = "node_attr", 9
    tok.semantics.edge.discrete, tok.semantics.edge.dim = "edge_attr", 3
    m = cfg.model
    m.hidden_size, m.num_hidden_layers, m.head_dim, m.dtype = 64, 2, 16, "float32"
    m.problem_type, m.loss_type, m.num_labels = "regression", "l1", 1
    t = cfg.training
    t.task_type = "graph"
    t.batch_size, t.max_length, t.num_workers = 8, 192, 0
    t.schedule.epochs, t.schedule.logging_steps = 1, 1
    t.optimizer.use_ema, t.k_samplers = True, 8
    t.output_dir = str(out_dir)
    return cfg


def test_flat_graph_finetune_matches_jax(tmp_path):
    """FinetunePipeline on flat graph rows (eos, then <gsum> last): four
    steps' losses and the epoch's valid MAE against the JAX pipeline's."""

    def shrink(pipe):
        pipe.dataset.size = 64
        pipe.train_idx = pipe.train_idx[pipe.train_idx < 64][:32]
        pipe.valid_idx = pipe.valid_idx[pipe.valid_idx < 64][:8]
        pipe.test_idx = pipe.valid_idx

    jpipe = jft.FinetunePipeline(_ft_cfg(JConfig, tmp_path / "jax")).setup()
    shrink(jpipe)
    params = jax.tree_util.tree_map(np.asarray, jpipe.state.params)
    jpipe.run()
    tpipe = tft.FinetunePipeline(_ft_cfg(TConfig, tmp_path / "port"), device="cpu").setup()
    shrink(tpipe)
    assert type(tpipe.tokenizer).__name__ == "GSTTokenizer"
    assert tpipe.cfg.model.stacked_feat == 1
    model = tpipe.state.model
    model.load_state_dict(params_from_jax(params, device="cpu"))
    tpipe.state = init_train_state(model, tpipe.tx, use_ema=True)
    tpipe.run()
    _losses_close(tmp_path / "jax", tmp_path / "port", "loss.csv", 4, ("loss", "task_loss"))
    want, got = _rows(tmp_path / "jax" / "result.csv"), _rows(tmp_path / "port" / "result.csv")
    w, g = float(want[0]["valid_mae"]), float(got[0]["valid_mae"])
    assert abs(g - w) <= REL * abs(w), (g, w)


def test_flat_tokenizer_through_spawned_workers(tmp_path):
    """A GSTTokenizer with nx streams and the structure_er dataset go through
    the loader's payload file to two spawned workers: the same batches as
    tokenizing in the loader's own thread."""
    _, tcfg, vm = _tok_cfgs(PIPES["euler-structure-er"]["tok"])
    tok = tgst.GSTTokenizer(tcfg, vm, task_type="pretrain-euler")
    ds = treaders.read_dataset("structure_er", TConfig(), size=200)
    idx = np.arange(96)
    runs = []
    for workers in (0, 2):
        loader = GraphTokenLoader(ds, tok, batch_size=16, mpe=256, pack=True, seed=4,
                                  num_workers=workers)
        try:
            runs.append([dict(b.data) for b in loader.epoch_batches(idx, epoch=1)])
        finally:
            loader.close()
    assert len(runs[0]) == len(runs[1]) > 0
    for a, b in zip(*runs):
        assert sorted(a) == sorted(b)
        for key in a:
            np.testing.assert_array_equal(a[key], b[key], err_msg=key)


def test_flat_rows_take_the_masking_after_packing_and_the_sweep(tmp_path):
    """Flat rows through the pretrain-mlm paths the JAX functions take only
    as [P, F] rows (a repair): `mask_after_pack` masks each packed flat row
    with one draw (labels only at masked cells, none on padding) and the
    save point's generation sweep runs over flat rows."""
    cfg = _pipe_cfg(TConfig, tmp_path, dict(task="pretrain-mlm", dataset="synthetic_mol",
                                            causal=False))
    t = cfg.training
    t.pack_tokens, t.mask_after_pack, t.schedule.total_num_steps = 1, True, 2
    t.do_valid, t.valid_percent, t.gen_eval_bands, t.gen_eval_samples = True, 0.0004, 2, 4
    cfg.generation.steps = 2
    pipe = tpipeline.PretrainPipeline(cfg, device="cpu").setup()
    data, _ = next(pipe._device_batches(0))
    ids, labels = data["input_ids"], data["labels"]
    assert ids.ndim == 2 and pipe.loader.post_pack_fn is not None
    masked = labels != -100
    assert masked.any() and (ids[masked] == pipe.tokenizer.mask_id).all()
    assert not masked[data["segment_ids"] == 0].any()
    pipe.run()
    row = _rows(tmp_path / "result.csv")[-1]
    assert np.isfinite(float(row["valid_loss"]))
    assert {"gen_acc@umr_0.0-0.5", "gen_acc@umr_0.5-1.0"} <= set(row)
