"""Array-native graph containers: a copy of the parts of
`graphgpt_tpu/data/graph.py` that the tokenizer and the graph-level
readers read (`Graph` with `permute_nodes` :43-78, `CSR`,
`connected_components`, the directed-edge lookups, `GraphBatchStore`
:167-251).
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

    def permute_nodes(self, rng: np.random.Generator) -> "Graph":
        """Random node relabelling augmentation (reference:
        src/utils/nx_utils.py:594-612).

        Node i becomes permu[i]; node-aligned arrays are re-ordered so the
        new node k carries old node argsort(permu)[k]'s attributes.
        """
        permu = rng.permutation(self.num_nodes).astype(np.int32)
        inv = np.argsort(permu)

        def _perm_nodes(arr):
            if arr is None:
                return None
            if arr.shape[0] == self.num_nodes:
                return arr[inv]
            return arr

        extra = self.extra
        if "a2d" in extra:
            # a2d holds node IDS (values, not node-aligned rows): remap
            extra = dict(extra)
            extra["a2d"] = permu[extra["a2d"]]
        return Graph(
            num_nodes=self.num_nodes,
            edge_index=permu[self.edge_index],
            node_attr=_perm_nodes(self.node_attr),
            edge_attr=self.edge_attr,
            y=self.y if (self.y is None or self.y.shape[0] != self.num_nodes) else self.y[inv],
            pos=_perm_nodes(self.pos),
            node_embed=_perm_nodes(self.node_embed),
            root_n_id=None if self.root_n_id is None else permu[self.root_n_id],
            tgt_edge_attr=self.tgt_edge_attr,
            wgt=self.wgt,
            idx=self.idx,
            extra=extra,
        )


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


class GraphBatchStore:
    """Columnar storage for a dataset of many small graphs.

    All graphs' arrays are concatenated; per-graph slices are recovered from
    offset arrays. This is the array-native analogue of the collated storage
    the reference slices with `separate()` (dataset_map.py:1323-1329).
    """

    def __init__(self, graphs=None):
        self._fields: Dict[str, np.ndarray] = {}
        self._node_ptr = None
        self._edge_ptr = None
        self._ys = None
        self._pos = None
        if graphs is not None:
            self._collate(list(graphs))

    def _collate(self, graphs):
        self._node_ptr = np.zeros(len(graphs) + 1, np.int64)
        self._edge_ptr = np.zeros(len(graphs) + 1, np.int64)
        for i, g in enumerate(graphs):
            self._node_ptr[i + 1] = self._node_ptr[i] + g.num_nodes
            self._edge_ptr[i + 1] = self._edge_ptr[i] + g.num_edges
        # contract: edge_index holds GLOBAL node ids (graph i's edges are
        # offset by node_ptr[i]); get() subtracts the offset back. The
        # round-4 molhiv golden-fixture test caught this collate writing
        # graph-LOCAL ids, which silently corrupted every graph after the
        # first on the get() path.
        self.edge_index = (
            np.concatenate(
                [
                    g.edge_index + np.int64(self._node_ptr[i])
                    for i, g in enumerate(graphs)
                ],
                axis=1,
            ).astype(np.int32)
            if graphs
            else np.zeros((2, 0), np.int32)
        )
        self.node_attr = (
            np.concatenate([g.node_attr for g in graphs], axis=0)
            if graphs and graphs[0].node_attr is not None
            else None
        )
        self.edge_attr = (
            np.concatenate([g.edge_attr for g in graphs], axis=0)
            if graphs and graphs[0].edge_attr is not None
            else None
        )
        self._ys = (
            np.stack([np.asarray(g.y).reshape(-1) for g in graphs])
            if graphs and graphs[0].y is not None
            else None
        )
        self._pos = (
            np.concatenate([g.pos for g in graphs], axis=0)
            if graphs and graphs[0].pos is not None
            else None
        )

    def __len__(self) -> int:
        return len(self._node_ptr) - 1 if self._node_ptr is not None else 0

    def get(self, idx: int) -> Graph:
        n0, n1 = self._node_ptr[idx], self._node_ptr[idx + 1]
        e0, e1 = self._edge_ptr[idx], self._edge_ptr[idx + 1]
        g = Graph(
            num_nodes=int(n1 - n0),
            edge_index=self.edge_index[:, e0:e1] - np.int32(n0),
            node_attr=None if self.node_attr is None else self.node_attr[n0:n1],
            edge_attr=None if self.edge_attr is None else self.edge_attr[e0:e1],
            y=None if self._ys is None else self._ys[idx],
            pos=None if self._pos is None else self._pos[n0:n1],
            idx=int(idx),
        )
        # OneID instruction columns (graph-local node-id pairs + key type;
        # reference graph.a2d / graph.key_type, instruct_tuning_utils.py:102-156)
        a2d = getattr(self, "_a2d", None)
        a2d_ptr = getattr(self, "_a2d_ptr", None)
        if a2d is not None and a2d_ptr is not None:
            g.extra["a2d"] = a2d[a2d_ptr[idx] : a2d_ptr[idx + 1]]
        key_type = getattr(self, "_key_type", None)
        if key_type is not None:
            g.extra["key_type"] = key_type[idx]
        return g
