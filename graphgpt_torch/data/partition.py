"""Random big-graph subgraph datasets and datasets over several
sub-datasets.

Counterpart of `graphgpt_tpu/data/partition.py` (`_slice_subgraph` :77,
`RandomNodesDataset` :124, `RandomEdgesDataset` :149, `EnsembleDataset`
:174-195); their subgraphs are the JAX package's, read from the big
graph's CSR (`sampling.induced_subgraph`). `bfs_partition` and
`PartitionDataset` wait for the multi-GPU slice (their one user is the
partitioned corpus). One addition: `epoch` and `reset_seed`, the last
epoch and seed given to `reset_samples`, which the loader sends with each
chunk so that its spawned workers follow them (`data/loader.py`).
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

from .graph import Graph
from .sampling import _Reopened, build_csr_directed, induced_subgraph


def _slice_subgraph(big: Graph, csr, nodes: np.ndarray, idx: int) -> Graph:
    sub_ei, eids = induced_subgraph(csr, nodes)
    return Graph(
        num_nodes=len(nodes),
        edge_index=sub_ei,
        node_attr=None if big.node_attr is None else big.node_attr[nodes],
        edge_attr=None if big.edge_attr is None else big.edge_attr[eids],
        y=None if big.y is None else np.asarray(big.y).reshape(big.num_nodes, -1)[nodes],
        idx=idx,
        extra={"orig_nodes": nodes},
    )


class _RandomSubgraphs:
    def __init__(self, big: Graph, num_samples: int, seed: int = 0, csr=None):
        self.big = big
        self.num_samples = num_samples
        self.seed = seed
        self.epoch, self.reset_seed = 0, None
        self.csr = csr if csr is not None else build_csr_directed(big.num_nodes, big.edge_index)

    def reset_samples(self, epoch: int, seed: Optional[int] = None):
        self.epoch, self.reset_seed = epoch, seed

    def __len__(self):
        return self.num_samples


class RandomNodesDataset(_RandomSubgraphs):
    """Random node subsets -> induced subgraphs (RandomNodesMapDataset,
    dataset_map.py:990-1089)."""

    def __init__(self, big: Graph, nodes_per_sample: int, num_samples: int, seed: int = 0,
                 csr=None):
        super().__init__(big, num_samples, seed, csr)
        self.nodes_per_sample = nodes_per_sample

    def __getitem__(self, i: int) -> Graph:
        rng = np.random.default_rng((self.seed, self.epoch, i))
        n = self.big.num_nodes
        nodes = np.sort(rng.choice(n, size=min(self.nodes_per_sample, n), replace=False))
        return _slice_subgraph(self.big, self.csr, nodes, i)


class RandomEdgesDataset(_RandomSubgraphs):
    """Random edge subsets -> node-induced subgraphs (RandomEdgesMapDataset,
    dataset_map.py:803-987)."""

    def __init__(self, big: Graph, edges_per_sample: int, num_samples: int, seed: int = 0,
                 csr=None):
        super().__init__(big, num_samples, seed, csr)
        self.edges_per_sample = edges_per_sample

    def __getitem__(self, i: int) -> Graph:
        rng = np.random.default_rng((self.seed, self.epoch, i))
        e = self.big.num_edges
        eids = rng.choice(e, size=min(self.edges_per_sample, e), replace=False)
        nodes = np.unique(self.big.edge_index[:, eids])
        return _slice_subgraph(self.big, self.csr, nodes.astype(np.int64), i)


class EnsembleDataset(_Reopened):
    """Concatenated dispatch over sub-datasets (EnsembleNodesEdgesMapDataset
    dataset_map.py:1092-1169 / EnsembleGraphsMapDataset:1448-1479)."""

    def __init__(self, datasets: Sequence):
        self.datasets = list(datasets)
        self._ptr = np.cumsum([0] + [len(d) for d in self.datasets])
        self.epoch, self.reset_seed = 0, None

    def reset_samples(self, epoch: int, seed: Optional[int] = None):
        self.epoch, self.reset_seed = epoch, seed
        for d in self.datasets:
            if hasattr(d, "reset_samples"):
                d.reset_samples(epoch, seed)
        self._ptr = np.cumsum([0] + [len(d) for d in self.datasets])

    def __len__(self):
        return int(self._ptr[-1])

    def __getitem__(self, i: int) -> Graph:
        k = int(np.searchsorted(self._ptr, i, side="right") - 1)
        g = self.datasets[k][i - int(self._ptr[k])]
        g.extra["idx_of_ds"] = np.asarray(k)
        return g
