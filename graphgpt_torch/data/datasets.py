"""Synthetic molecules with the PCQM4M-v2 schema (9 node attributes, 3
edge attributes, one regression target per graph), the map dataset over a
columnar store with its epoch-seeded node permutation, the index samplers
and the fixed-seed validation split: copies from
`graphgpt_tpu/data/datasets.py` (`GraphsMapDataset` :109-144, the index
helpers :147-196). No pipeline calls the index helpers yet, as in the JAX
package.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from .graph import Graph, GraphBatchStore

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


class GraphsMapDataset:
    """Many-small-graphs dataset over columnar storage with optional node
    permutation augmentation (reference GraphsMapDataset,
    dataset_map.py:1172-1342)."""

    def __init__(
        self,
        store: GraphBatchStore,
        sample_idx: Optional[np.ndarray] = None,
        permute: bool = True,
        seed: int = 0,
    ):
        self.store = store
        self.sample_idx = (
            np.asarray(sample_idx, np.int64)
            if sample_idx is not None
            else np.arange(len(store), dtype=np.int64)
        )
        self.permute = permute
        self.seed = seed
        self.epoch = 0

    def __len__(self):
        return len(self.sample_idx)

    def reset_samples(self, epoch: int, seed: int = 0) -> None:
        self.epoch = epoch

    def __getitem__(self, i: int) -> Graph:
        idx = int(self.sample_idx[i])
        g = self.store.get(idx)
        if self.permute:
            rng = np.random.default_rng((self.seed, self.epoch, idx))
            g = g.permute_nodes(rng)
        g.idx = idx
        return g


def size_weighted_indices(
    store: GraphBatchStore,
    sample_idx: np.ndarray,
    n: int,
    rng: np.random.Generator,
) -> np.ndarray:
    """Sample graph indices with probability proportional to node count
    (reference with-prob sampler, dataset_map.py:1363-1400)."""
    sizes = np.diff(store._node_ptr)[sample_idx].astype(np.float64)
    p = sizes / sizes.sum()
    return rng.choice(sample_idx, size=n, replace=True, p=p)


def shift_distribution_indices(
    store: GraphBatchStore,
    train_idx: np.ndarray,
    target_idx: np.ndarray,
    n: int,
    rng: np.random.Generator,
    bins: int = 32,
) -> np.ndarray:
    """Re-weight training samples so their num_nodes histogram matches the
    valid+test distribution (reference shift-distribution sampler,
    dataset_map.py:1400-1445)."""
    sizes = np.diff(store._node_ptr)
    t_sizes = sizes[train_idx]
    g_sizes = sizes[target_idx]
    lo, hi = sizes.min(), sizes.max() + 1
    edges = np.linspace(lo, hi, bins + 1)
    t_hist, _ = np.histogram(t_sizes, bins=edges)
    g_hist, _ = np.histogram(g_sizes, bins=edges)
    t_bin = np.clip(np.digitize(t_sizes, edges) - 1, 0, bins - 1)
    w = (g_hist[t_bin] + 1e-9) / (t_hist[t_bin] + 1e-9)
    p = w / w.sum()
    return rng.choice(train_idx, size=n, replace=True, p=p)


def strided_shard(indices: np.ndarray, rank: int, world: int) -> np.ndarray:
    """Rank-strided sampler shard (reference distribute_sampler,
    loader_utils.py:70-75)."""
    return indices[rank::world]


def epoch_shuffled_indices(
    n: int, epoch: int, seed: int, rank: int = 0, world: int = 1
) -> np.ndarray:
    rng = np.random.default_rng((seed, epoch))
    idx = rng.permutation(n)
    return strided_shard(idx, rank, world)


def train_valid_split(
    n: int, valid_percent: float, seed: int = 0
) -> tuple:
    """Fixed-seed validation holdout (reference
    get_pt_train_valid_test_sampler, loader_utils.py:318-409)."""
    rng = np.random.default_rng(seed)
    idx = rng.permutation(n)
    n_valid = int(n * valid_percent)
    return idx[n_valid:], idx[:n_valid]
