"""Array-native graph containers: a copy of the parts of
`graphgpt_tpu/data/graph.py` that the tokenizer reads (`Graph`, `CSR`,
`connected_components`, the directed-edge lookups).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Optional

import numpy as np


@dataclass
class Graph:
    """One small graph / sampled subgraph.

    edge_index is directed, shape [2, E] (both directions present for
    undirected graphs, as in OGB molecule data).
    """

    num_nodes: int
    edge_index: np.ndarray  # int32 [2, E]
    node_attr: Optional[np.ndarray] = None  # int32 [N, Dn] discrete attrs
    edge_attr: Optional[np.ndarray] = None  # int32 [E, De] discrete attrs
    y: Optional[np.ndarray] = None  # labels (graph / node level)
    pos: Optional[np.ndarray] = None  # float32 [N, 3] 3D coords
    node_embed: Optional[np.ndarray] = None  # float32 [N, D] raw embeds
    root_n_id: Optional[np.ndarray] = None  # target node(s) for node/edge tasks
    tgt_edge_attr: Optional[np.ndarray] = None  # [De] for edge tasks
    wgt: Optional[float] = None  # sample weight
    idx: int = -1  # index within parent dataset
    extra: Dict[str, np.ndarray] = field(default_factory=dict)

    @property
    def num_edges(self) -> int:
        return int(self.edge_index.shape[1])


class CSR:
    """Compressed sparse row adjacency over the *undirected simple* graph.

    Mirrors the reference's `to_networkx(to_undirected="upper")` view
    (nx_utils.py:389): parallel/directed duplicates collapse to one
    undirected edge; self-loops are dropped (networkx keeps self-loops, but
    OGB molecule graphs have none, and Euler walks over them are no-ops).
    """

    __slots__ = ("num_nodes", "indptr", "indices", "edge_id", "u", "v")

    def __init__(self, num_nodes: int, edge_index: np.ndarray):
        self.num_nodes = num_nodes
        if edge_index.size == 0:
            self.u = np.empty(0, np.int32)
            self.v = np.empty(0, np.int32)
        else:
            lo = np.minimum(edge_index[0], edge_index[1])
            hi = np.maximum(edge_index[0], edge_index[1])
            keep = lo != hi  # drop self-loops
            key = lo[keep].astype(np.int64) * num_nodes + hi[keep]
            uniq = np.unique(key)
            self.u = (uniq // num_nodes).astype(np.int32)
            self.v = (uniq % num_nodes).astype(np.int32)
        m = self.u.shape[0]
        # symmetrised endpoints: edge e appears in rows u[e] and v[e]
        rows = np.concatenate([self.u, self.v])
        cols = np.concatenate([self.v, self.u])
        eids = np.concatenate([np.arange(m, dtype=np.int32)] * 2)
        order = np.argsort(rows, kind="stable")
        self.indices = cols[order]
        self.edge_id = eids[order]
        counts = np.bincount(rows, minlength=num_nodes)
        self.indptr = np.zeros(num_nodes + 1, dtype=np.int64)
        np.cumsum(counts, out=self.indptr[1:])

    @property
    def num_undirected_edges(self) -> int:
        return int(self.u.shape[0])

    def degrees(self) -> np.ndarray:
        return np.diff(self.indptr).astype(np.int64)

    def neighbors(self, node: int) -> np.ndarray:
        return self.indices[self.indptr[node] : self.indptr[node + 1]]


def connected_components(csr: CSR) -> np.ndarray:
    """Component label per node via scipy's C implementation."""
    from scipy.sparse import csr_matrix
    from scipy.sparse.csgraph import connected_components as _cc

    n = csr.num_nodes
    if csr.num_undirected_edges == 0:
        return np.arange(n, dtype=np.int64)
    mat = csr_matrix(
        (np.ones(len(csr.indices), np.int8), csr.indices, csr.indptr), shape=(n, n)
    )
    _, labels = _cc(mat, directed=False)
    return labels


def build_directed_edge_lookup(num_nodes: int, edge_index: np.ndarray):
    """Sorted key array for O(log E) (src,tgt) -> first edge position lookups.

    Replaces the reference's per-edge boolean scans (nx_utils.py:271-274)
    with a vectorised searchsorted.
    Returns (sorted_keys, order) where order maps sorted position -> original
    edge column.
    """
    keys = edge_index[0].astype(np.int64) * num_nodes + edge_index[1]
    order = np.argsort(keys, kind="stable")
    return keys[order], order.astype(np.int64)


def lookup_directed_edges(sorted_keys, order, num_nodes, src, tgt):
    """Vectorised lookup: original edge column for each (src,tgt), -1 if absent."""
    q = np.asarray(src, np.int64) * num_nodes + np.asarray(tgt, np.int64)
    pos = np.searchsorted(sorted_keys, q)
    pos_c = np.minimum(pos, len(sorted_keys) - 1) if len(sorted_keys) else pos * 0
    if len(sorted_keys) == 0:
        return np.full(q.shape, -1, np.int64)
    found = sorted_keys[pos_c] == q
    return np.where(found, order[pos_c], -1)
