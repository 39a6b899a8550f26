"""Synthetic molecules with the PCQM4M-v2 schema (9 node attributes, 3
edge attributes, one regression target per graph) and the fixed-seed
validation split: copies from `graphgpt_tpu/data/datasets.py`.
"""

from __future__ import annotations

import numpy as np

from .graph import Graph

# OGB molecule-like attribute cardinalities (ogb.utils.features full maps)
MOL_NODE_CARD = (119, 4, 12, 12, 10, 6, 6, 2, 2)
MOL_EDGE_CARD = (5, 6, 2)


def random_molecule_graph(
    rng: np.random.Generator,
    min_nodes: int = 4,
    max_nodes: int = 32,
    extra_edge_ratio: float = 0.3,
    with_pos: bool = False,
) -> Graph:
    """Random connected molecule-like graph: spanning tree + extra edges,
    attrs drawn from the OGB molecule cardinalities."""
    n = int(rng.integers(min_nodes, max_nodes + 1))
    # random spanning tree: connect node i to a random earlier node
    targets = np.asarray([rng.integers(0, i) for i in range(1, n)], np.int32) if n > 1 else np.zeros(0, np.int32)
    src = np.arange(1, n, dtype=np.int32)
    extra = int(n * extra_edge_ratio)
    if extra > 0 and n > 2:
        a = rng.integers(0, n, size=extra).astype(np.int32)
        b = rng.integers(0, n, size=extra).astype(np.int32)
        keep = a != b
        src = np.concatenate([src, a[keep]])
        targets = np.concatenate([targets, b[keep]])
    # dedup undirected, then emit both directions (OGB convention)
    lo, hi = np.minimum(src, targets), np.maximum(src, targets)
    key = np.unique(lo.astype(np.int64) * n + hi)
    lo, hi = (key // n).astype(np.int32), (key % n).astype(np.int32)
    edge_index = np.stack(
        [np.concatenate([lo, hi]), np.concatenate([hi, lo])]
    ).astype(np.int32)
    e = edge_index.shape[1]
    node_attr = np.stack(
        [rng.integers(0, c, size=n) for c in MOL_NODE_CARD], axis=1
    ).astype(np.int32)
    eattr_und = np.stack(
        [rng.integers(0, c, size=len(lo)) for c in MOL_EDGE_CARD], axis=1
    ).astype(np.int32)
    edge_attr = np.concatenate([eattr_und, eattr_und], axis=0)
    y = np.asarray([rng.normal(5.0, 1.0)], np.float32)
    pos = rng.normal(size=(n, 3)).astype(np.float32) if with_pos else None
    return Graph(
        num_nodes=n,
        edge_index=edge_index,
        node_attr=node_attr,
        edge_attr=edge_attr,
        y=y,
        pos=pos,
    )


class SyntheticMolDataset:
    """Deterministic synthetic molecule dataset: graph i is a pure function
    of (seed, i), so workers and epochs agree without materialisation."""

    def __init__(self, size: int, seed: int = 0, min_nodes: int = 4, max_nodes: int = 32, with_pos: bool = False):
        self.size = size
        self.seed = seed
        self.min_nodes = min_nodes
        self.max_nodes = max_nodes
        self.with_pos = with_pos

    def __len__(self):
        return self.size

    def __getitem__(self, idx: int) -> Graph:
        rng = np.random.default_rng((self.seed, int(idx)))
        g = random_molecule_graph(
            rng, self.min_nodes, self.max_nodes, with_pos=self.with_pos
        )
        g.idx = int(idx)
        return g


def train_valid_split(
    n: int, valid_percent: float, seed: int = 0
) -> tuple:
    """Fixed-seed validation holdout (reference
    get_pt_train_valid_test_sampler, loader_utils.py:318-409)."""
    rng = np.random.default_rng(seed)
    idx = rng.permutation(n)
    n_valid = int(n * valid_percent)
    return idx[n_valid:], idx[:n_valid]
