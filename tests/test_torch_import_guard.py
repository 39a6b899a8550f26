"""The port stands alone: no import of JAX or of the JAX package.

An AST scan of every module of `graphgpt_torch/` and of `chip_smoke.py`
finds no import of jax, jaxlib, optax, flax, orbax or graphgpt_tpu, at any
depth (inside functions too). A subprocess that blocks `jax` in
`sys.modules` imports every module of the port and runs a tiny CPU forward,
a few sampler steps, one training step, a one-epoch fine-tune run and the
two 3D-molecule models' training forwards, reads a graph-level store
through the readers and walks one of its graphs in C++, reads a big
graph through the ogbl-ppa reader, samples an ego subgraph in C++ and
tokenizes it in the long stacking, and tokenizes a structure_er graph flat
with the nx streams.
"""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
BANNED = {"jax", "jaxlib", "optax", "flax", "orbax", "graphgpt_tpu"}
SOURCES = sorted((ROOT / "graphgpt_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _imported_roots(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0], node.lineno
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0], node.lineno
        elif isinstance(node, ast.Call) and getattr(node.func, "id", None) == "__import__":
            if node.args and isinstance(node.args[0], ast.Constant):
                yield str(node.args[0].value).split(".")[0], node.lineno


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_import(path):
    bad = [(name, line) for name, line in _imported_roots(path) if name in BANNED]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_the_scan_sees_every_module():
    names = {str(p.relative_to(ROOT)) for p in SOURCES}
    for must in ("graphgpt_torch/ops/flash_attention.py", "graphgpt_torch/ops/mlp.py",
                 "graphgpt_torch/models/heads.py", "graphgpt_torch/generation/dllm.py",
                 "graphgpt_torch/training/optimizer.py", "graphgpt_torch/training/steps.py",
                 "graphgpt_torch/training/finetune.py", "graphgpt_torch/data/tokenizer.py",
                 "graphgpt_torch/utils/metrics.py", "graphgpt_torch/models/denoise.py",
                 "graphgpt_torch/models/pos_pretrain.py", "graphgpt_torch/data/mol3d.py",
                 "graphgpt_torch/training/pipeline.py", "graphgpt_torch/data/loader.py",
                 "graphgpt_torch/utils/inspection.py", "graphgpt_torch/readers.py",
                 "graphgpt_torch/native/euler_native.py", "graphgpt_torch/native/__init__.py",
                 "graphgpt_torch/data/partition.py", "graphgpt_torch/data/sampling.py",
                 "graphgpt_torch/utils/convert.py", "graphgpt_torch/data/gst_tokenizer.py",
                 "graphgpt_torch/data/structure_tasks.py", "chip_smoke.py"):
        assert must in names
    assert sorted(p.name for p in (ROOT / "graphgpt_torch" / "native").iterdir()
                  if p.suffix in (".py", ".cpp")) == ["__init__.py", "euler.cpp", "euler_native.py"]
    assert sorted(p.name for p in (ROOT / "graphgpt_torch" / "csrc").glob("*.cu")) == [
        "flash_bwd.cu", "flash_bwd_f32.cu", "flash_bwd_split.cu", "flash_bwd_split_f32.cu",
        "flash_fwd.cu", "flash_fwd_f32.cu", "mlp.cu", "mlp_qkv_f32.cu", "norm_mlp.cu",
        "norm_qkv.cu", "rmsnorm_bwd.cu",
    ]


_BLOCKED_RUN = r"""
import importlib, pkgutil, sys
for name in ("jax", "jaxlib", "optax", "flax", "orbax", "graphgpt_tpu"):
    sys.modules[name] = None  # any import of these raises ImportError
import numpy as np, torch
import graphgpt_torch
for info in pkgutil.walk_packages(graphgpt_torch.__path__, "graphgpt_torch."):
    importlib.import_module(info.name)
from graphgpt_torch.config import GenerationConfig, ModelConfig
from graphgpt_torch.generation import dllm
from graphgpt_torch.models.heads import GraphGPTPretrain
from graphgpt_torch.synthetic import fake_batch, to_torch
cfg = ModelConfig(vocab_size=40, hidden_size=128, num_hidden_layers=1, stacked_feat=2,
                  next_n_token=2, mask_token_id=1).finalize()
model = GraphGPTPretrain(cfg, device="cpu", seed=0)
nb = fake_batch(1, 64, 2, 40, np.random.default_rng(0))
batch = to_torch(nb, "cpu")
loss = model.loss(batch)
assert torch.isfinite(loss), loss
x = torch.from_numpy(np.where(nb["input_ids"] > 20, 1, nb["input_ids"]).reshape(1, -1))
fn = lambda x, pos, seg: model.logits(
    {"input_ids": x.view(1, 64, 2), "position_ids": pos, "segment_ids": seg}).view(1, 128, -1)
out = dllm.make_unmask_sampler(fn, GenerationConfig(steps=4), 1, device="cpu")(
    x, None, batch["position_ids"], batch["segment_ids"])
assert out.shape == x.shape
from graphgpt_torch.config import OptimizerConfig
from graphgpt_torch.training.optimizer import make_optimizer
from graphgpt_torch.training.steps import init_train_state, make_train_step
tx = make_optimizer(OptimizerConfig(), 10, 1)
state, metrics = make_train_step(tx)(init_train_state(model, tx), batch)
assert state.step == 1 and torch.isfinite(metrics["grad_norm"]), metrics
import tempfile
from graphgpt_torch.config import Config
from graphgpt_torch.training.finetune import FinetunePipeline
cfg = Config()
cfg.tokenization.semantics.node.discrete, cfg.tokenization.semantics.node.dim = "node_attr", 9
cfg.tokenization.semantics.edge.discrete, cfg.tokenization.semantics.edge.dim = "edge_attr", 3
cfg.model.hidden_size, cfg.model.num_hidden_layers, cfg.model.dtype = 64, 1, "float32"
cfg.model.problem_type, cfg.model.loss_type, cfg.model.layer_scale_init_value = "regression", "l1", 1.0
cfg.training.task_type, cfg.training.batch_size, cfg.training.max_length = "graph", 8, 64
cfg.training.schedule.epochs, cfg.training.k_samplers = 1, 0
cfg.training.output_dir = tempfile.mkdtemp()
import contextlib, io
with contextlib.redirect_stdout(io.StringIO()):  # the pipeline's log lines
    pipe = FinetunePipeline(cfg, device="cpu").setup()
    pipe.train_idx, pipe.valid_idx = pipe.train_idx[:16], pipe.valid_idx[:8]
    pipe.test_idx = pipe.valid_idx
    best = pipe.run()
assert np.isfinite(best["valid_mae"]), best
from graphgpt_torch.training.pipeline import PretrainPipeline
cfg = Config()
cfg.tokenization.semantics.node.discrete, cfg.tokenization.semantics.node.dim = "node_attr", 9
cfg.tokenization.semantics.edge.discrete, cfg.tokenization.semantics.edge.dim = "edge_attr", 3
cfg.model.hidden_size, cfg.model.num_hidden_layers, cfg.model.dtype = 64, 1, "float32"
t = cfg.training
t.batch_size, t.max_length, t.pack_tokens, t.num_workers = 2, 64, 1, 2
t.schedule.total_num_steps, t.schedule.logging_steps = 2, 1
t.valid_percent, t.do_valid, t.gen_eval_bands, t.gen_eval_samples = 0.0002, True, 1, 2
cfg.generation.steps = 2
t.output_dir = tempfile.mkdtemp()
with contextlib.redirect_stdout(io.StringIO()):
    PretrainPipeline(cfg, device="cpu").setup().run()
import csv, os
row = list(csv.DictReader(open(os.path.join(t.output_dir, "result.csv"))))[-1]
assert np.isfinite(float(row["valid_loss"])), row
from graphgpt_torch.models.denoise import GraphGPTDenoise
from graphgpt_torch.models.pos_pretrain import GraphGPTPosPred
from graphgpt_torch.synthetic import mol3d_batch
mb = to_torch(mol3d_batch(2, 40, bi_split=16), "cpu")
cfg3 = ModelConfig(vocab_size=755, hidden_size=64, num_hidden_layers=1, stacked_feat=13,
                   next_n_token=13, mask_token_id=1, dtype="float32", pos_num_bins=8,
                   problem_type="regression", loss_type="l1", bi_causal_split=16).finalize()
out = GraphGPTDenoise(cfg3, device="cpu")(mb, torch.Generator().manual_seed(0), train=True)
assert torch.isfinite(out["loss"]) and out["task_logits"].shape == (2, 1), out
out = GraphGPTPosPred(cfg3, device="cpu")(mb, torch.Generator().manual_seed(0), train=True)
assert torch.isfinite(out["loss"]), out
from graphgpt_torch import readers
from graphgpt_torch.data import euler
from graphgpt_torch.data.datasets import random_molecule_graph
d = tempfile.mkdtemp()
os.makedirs(os.path.join(d, "pcqm4m-v2"))
gs = [random_molecule_graph(np.random.default_rng(i)) for i in range(12)]
ptr = lambda xs: np.concatenate([[0], np.cumsum(xs)]).astype(np.int64)
np.savez(os.path.join(d, "pcqm4m-v2", "graphs.npz"),
         node_attr=np.concatenate([g.node_attr for g in gs]),
         edge_attr=np.concatenate([g.edge_attr for g in gs]),
         edge_index=np.concatenate([g.edge_index + o for g, o in
                                    zip(gs, ptr([g.num_nodes for g in gs]))], axis=1),
         node_ptr=ptr([g.num_nodes for g in gs]), edge_ptr=ptr([g.num_edges for g in gs]),
         y=np.ones((12, 1), np.float32), train_idx=np.arange(8), valid_idx=np.arange(8, 12))
cfg = Config()
cfg.tokenization.dataset, cfg.tokenization.data_dir = "pcqm4m-v2", d
ds = readers.read_dataset("pcqm4m-v2", cfg)
assert [len(s) for s in ds.splits()] == [8, 4, 0] and ds[3].num_nodes == gs[3].num_nodes
assert euler._native() is not None  # the C++ walk
assert len(euler.graph_to_walk(ds[0], np.random.default_rng(0))) >= ds[0].num_nodes
from graphgpt_torch.data import sampling, vocab
from graphgpt_torch.data.tokenizer import StackedGSTTokenizerLong
os.makedirs(os.path.join(d, "ogbl-ppa"))
rng = np.random.default_rng(0)
edges = np.unique(rng.integers(0, 50, (2, 300)), axis=1)
edges = edges[:, edges[0] < edges[1]]
np.savez(os.path.join(d, "ogbl-ppa", "big_graph.npz"),
         edge_index=np.concatenate([edges, edges[::-1]], axis=1).astype(np.int32),
         num_nodes=np.int64(50), train_edge=edges.T.astype(np.int64),
         node_attr=np.stack([np.arange(50), np.arange(50) % 4], 1).astype(np.int32))
cfg.tokenization.dataset, cfg.tokenization.stack_method = "ogbl-ppa", "long"
cfg.tokenization.semantics.node.dim, cfg.tokenization.semantics.edge.dim = 2, 0
cfg.tokenization.semantics.node.discrete = "node_attr"
cfg.tokenization.semantics.edge.discrete = None
big = readers.read_dataset("ogbl-ppa", cfg)
assert isinstance(big, sampling.EgoEdgeDataset) and big[0].root_n_id.shape == (2,)
vm = vocab.vocab_map_from_list(vocab.build_vocab(
    cfg.tokenization, [np.unique(big.big.node_attr[:, c]) for c in range(2)], []))
tok = StackedGSTTokenizerLong(cfg.tokenization, vm, task_type="edge")
assert tok(big[0], np.random.default_rng(0)).input_ids.shape[1] == 4
from graphgpt_torch.data.gst_tokenizer import GSTTokenizer
cfg = Config()
cfg.tokenization.structure.nx_funcs = ("degree", "triangles", "shortest_path",
                                       "shortest_path_length")
er = readers.read_dataset("structure_er", cfg, size=4)
vm = vocab.vocab_map_from_list(vocab.build_vocab(cfg.tokenization))
s = GSTTokenizer(cfg.tokenization, vm, task_type="pretrain-euler")(er[0], np.random.default_rng(0))
assert s.input_ids.ndim == 1 and vm["structure_0"] in s.input_ids.tolist()
bad = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "graphgpt_tpu")
             and sys.modules[m] is not None)
assert not bad, bad
print("OK", float(loss))
"""


def test_port_runs_with_jax_blocked():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(ROOT)
    proc = subprocess.run(
        [sys.executable, "-c", _BLOCKED_RUN], cwd=ROOT, env=env,
        capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert proc.stdout.startswith("OK")
