"""The dataset and the tokenizer a config names.

Counterpart of `graphgpt_tpu/training/pipeline.py:41-107` (`build_dataset`,
`build_tokenizer`) for the `synthetic_mol` source; the OGB readers wait
until their data files are in the repository.
"""

from __future__ import annotations

import os

import numpy as np

from ..config import Config
from ..data import vocab as vocab_mod
from ..data.datasets import MOL_EDGE_CARD, MOL_NODE_CARD, SyntheticMolDataset
from ..data.tokenizer import StackedGSTTokenizer


def build_dataset(cfg: Config):
    name = cfg.tokenization.dataset
    if name != "synthetic_mol":
        raise NotImplementedError(
            f"dataset {name!r}: the port reads synthetic_mol; the OGB readers wait for their "
            "data files"
        )
    return SyntheticMolDataset(50_000, seed=cfg.training.seed)


def build_tokenizer(cfg: Config, dataset) -> StackedGSTTokenizer:
    """The vocab from `output_dir/vocab_file` where it exists, else built
    from the molecule attribute cardinalities and saved there."""
    tok_cfg = cfg.tokenization
    if tok_cfg.tokenizer_class != "StackedGSTTokenizer":
        raise NotImplementedError(f"tokenizer {tok_cfg.tokenizer_class!r} waits for a later slice")
    vocab_path = os.path.join(cfg.training.output_dir, tok_cfg.vocab_file)
    if os.path.exists(vocab_path):
        vm = vocab_mod.load_vocab(vocab_path)
    else:
        node_vals = [np.arange(c) for c in MOL_NODE_CARD]
        edge_vals = [np.arange(c) for c in MOL_EDGE_CARD]
        vocab = vocab_mod.build_vocab(tok_cfg, node_vals, edge_vals)
        vocab_mod.save_vocab(vocab, vocab_path)
        vm = vocab_mod.vocab_map_from_list(vocab)
    return StackedGSTTokenizer(tok_cfg, vm, task_type=cfg.training.task_type)
