"""A spawned loader worker of the port imports no torch.

`GraphTokenLoader` starts its pool with the spawn context: each worker is a
fresh interpreter that unpickles `_init_worker`'s arguments (the dataset,
the tokenizer, the seed), which imports `graphgpt_torch.data.loader` and
the modules of the pickled classes. Those need only numpy, so torch must
stay out of the worker: importing it cost each worker seconds before its
first chunk. The first test builds the pretraining pipeline's
`synthetic_mol` dataset and tokenizer, pickles them as the pool does, and
has a fresh subprocess unpickle them, tokenize a chunk and report its
modules. A spawned worker also runs the parent's main module again before
its first task, and the port's entry points import torch: the second test
starts a loader from a main script that imports torch and asks its worker
for its modules.
"""

import os
import pickle
import subprocess
import sys
from pathlib import Path

from graphgpt_torch.config import Config
from graphgpt_torch.training.pipeline import build_dataset, build_tokenizer

ROOT = Path(__file__).resolve().parent.parent

_WORKER = r"""
import pickle, sys
import graphgpt_torch.data.loader as loader
loader._init_worker(*pickle.loads(sys.stdin.buffer.read()))
rows = loader._tokenize_chunk((0, 0, [0, 1, 2]))
assert len(rows) == 3 and all(len(r.input_ids) > 0 for r in rows), rows
print(sorted(m for m in sys.modules if m.split(".")[0] == "torch"))
"""


def test_a_spawned_worker_imports_no_torch(tmp_path):
    cfg = Config()
    cfg.training.output_dir = str(tmp_path)
    dataset = build_dataset(cfg)
    blob = pickle.dumps((dataset, build_tokenizer(cfg, dataset), cfg.training.seed))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(ROOT)
    proc = subprocess.run([sys.executable, "-c", _WORKER], input=blob, cwd=ROOT, env=env,
                          capture_output=True, timeout=120)
    assert proc.returncode == 0, proc.stderr.decode()
    assert proc.stdout.decode().strip() == "[]", proc.stdout.decode()


_MAIN = r"""
import sys
import torch  # the main module imports torch, as the port's entry points do
from graphgpt_torch.config import Config
from graphgpt_torch.data.loader import GraphTokenLoader
from graphgpt_torch.training.pipeline import build_dataset, build_tokenizer

if __name__ == "__main__":
    cfg = Config()
    cfg.training.output_dir = sys.argv[1]
    dataset = build_dataset(cfg)
    loader = GraphTokenLoader(dataset, build_tokenizer(cfg, dataset), batch_size=2, mpe=256,
                              pack=True, num_workers=1).start()
    expr = "sorted(m for m in __import__('sys').modules if m.split('.')[0] == 'torch')"
    print(loader._pool.apply(eval, (expr,)))
    batch = next(loader.epoch_batches(list(range(64))))
    assert batch.data["input_ids"].shape[:2] == (2, 256)
    assert "__file__" in vars(sys.modules["__main__"])  # put back after the start
    loader.close()
"""


def test_a_loader_started_from_a_torch_main_spawns_workers_without_torch(tmp_path):
    """The pool's workers skip the parent's main module, which would import
    torch again in each of them (multiprocessing runs it as __mp_main__)."""
    script = tmp_path / "main.py"
    script.write_text(_MAIN)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(ROOT)
    proc = subprocess.run([sys.executable, str(script), str(tmp_path)], cwd=tmp_path, env=env,
                          capture_output=True, timeout=120)
    assert proc.returncode == 0, proc.stderr.decode()
    assert proc.stdout.decode().strip() == "[]", proc.stdout.decode()
