"""Randomized (semi-)Eulerian walks over CSR adjacency.

Counterpart of `graphgpt_tpu/data/euler.py`: the C++ walk of
`native/euler_native.py` by default (`_native` :30-45, `graph_to_walk`
:245-257), the numpy walk (components, eulerisation, randomized
Hierholzer, shortening, jump edges), and the node re-indexing, the edge
types (`walk_edge_types` :307, for the long stacking) and the
edge-attribute lookup the stacked tokenizers read. The two walks draw
their random numbers differently (the C++ one draws one seed), so a graph
gives other rows under each. A test takes the numpy walk by setting
`_NATIVE_CHECKED, _NATIVE = True, None`; nothing else does. The C++
library is built at the first walk; a failed build raises.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np

from .graph import (
    CSR,
    Graph,
    build_directed_edge_lookup,
    connected_components,
    lookup_directed_edges,
)

# the C++ walk (native/euler_native.py), loaded at the first walk
_NATIVE = None
_NATIVE_CHECKED = False


def _native():
    """The C++ binding, its library built and loaded at the first call (a
    failed build raises, each call again); None only where a test set
    `_NATIVE_CHECKED, _NATIVE = True, None`."""
    global _NATIVE, _NATIVE_CHECKED
    if not _NATIVE_CHECKED:
        from ..native import euler_native

        euler_native.load()
        _NATIVE, _NATIVE_CHECKED = euler_native, True
    return _NATIVE


def _bfs_shortest_path(csr: CSR, src: int, targets: set) -> Tuple[Optional[int], List[int]]:
    """BFS from src until any target is hit; returns (target, path nodes)."""
    n = csr.num_nodes
    parent = np.full(n, -2, np.int64)
    parent[src] = -1
    frontier = [src]
    while frontier:
        nxt = []
        for node in frontier:
            for nb in csr.neighbors(node):
                nb = int(nb)
                if parent[nb] == -2:
                    parent[nb] = node
                    if nb in targets:
                        path = [nb]
                        while path[-1] != src:
                            path.append(int(parent[path[-1]]))
                        return nb, path[::-1]
                    nxt.append(nb)
        frontier = nxt
    return None, []


def _bfs_tree(csr: CSR, src: int, comp_size: int) -> np.ndarray:
    """Full BFS parent tree from src (parent[src] = -1, unreached = -2)."""
    parent = np.full(csr.num_nodes, -2, np.int64)
    parent[src] = -1
    frontier = [src]
    reached = 1
    while frontier and reached < comp_size:
        nxt = []
        for node in frontier:
            for nb in csr.neighbors(node):
                nb = int(nb)
                if parent[nb] == -2:
                    parent[nb] = node
                    reached += 1
                    nxt.append(nb)
        frontier = nxt
    return parent


def _min_weight_pairing(dist: np.ndarray) -> List[Tuple[int, int]]:
    """Exact minimum-weight perfect matching over a small even set via
    bitmask DP (O(2^k * k)). dist is the [k, k] pairwise distance matrix."""
    k = dist.shape[0]
    full = (1 << k) - 1
    INF = float("inf")
    best = [INF] * (1 << k)
    choice = [None] * (1 << k)
    best[0] = 0.0
    for mask in range(1 << k):
        if best[mask] == INF:
            continue
        # lowest unmatched index
        i = 0
        while i < k and (mask >> i) & 1:
            i += 1
        if i >= k:
            continue
        for j in range(i + 1, k):
            if (mask >> j) & 1:
                continue
            nmask = mask | (1 << i) | (1 << j)
            cand = best[mask] + dist[i, j]
            if cand < best[nmask]:
                best[nmask] = cand
                choice[nmask] = (mask, i, j)
    pairs = []
    mask = full
    while mask:
        prev, i, j = choice[mask]
        pairs.append((i, j))
        mask = prev
    return pairs


def eulerize_component(
    csr: CSR, comp_nodes: np.ndarray, rng: np.random.Generator
) -> List[Tuple[int, int]]:
    """Extra duplicate edges making the component Eulerian.

    nx.eulerize pairs odd-degree nodes via a min-weight matching on
    shortest-path distances and duplicates the path edges (reference calls
    nx.eulerize at nx_utils.py:417). Here: exact bitmask-DP matching for
    <=14 odd nodes (the typical molecule/subgraph case), greedy
    nearest-neighbour pairing beyond that.
    """
    deg = csr.degrees()
    odd = [int(x) for x in comp_nodes if deg[x] % 2 == 1]
    if not odd:
        return []
    rng.shuffle(odd)
    extra: List[Tuple[int, int]] = []
    if len(odd) <= 14:
        trees = {s: _bfs_tree(csr, s, len(comp_nodes)) for s in odd}
        k = len(odd)
        dist = np.zeros((k, k))
        for a in range(k):
            parent = trees[odd[a]]
            for b in range(a + 1, k):
                d, node = 0, odd[b]
                while node != odd[a]:
                    node = int(parent[node])
                    d += 1
                dist[a, b] = dist[b, a] = d
        for a, b in _min_weight_pairing(dist):
            parent = trees[odd[a]]
            node = odd[b]
            while node != odd[a]:
                extra.append((node, int(parent[node])))
                node = int(parent[node])
    else:
        remaining = set(odd)
        while remaining:
            src = remaining.pop()
            tgt, path = _bfs_shortest_path(csr, src, remaining)
            assert tgt is not None, "odd-degree nodes come in pairs per component"
            remaining.discard(tgt)
            extra.extend(zip(path[:-1], path[1:]))
    return extra


def _hierholzer(
    num_nodes: int,
    edges: np.ndarray,  # [M, 2] undirected multigraph edge list
    start: int,
    rng: np.random.Generator,
) -> List[int]:
    """Randomized Euler tour over an Eulerian multigraph; returns node walk."""
    m = edges.shape[0]
    # adjacency: per node, list of (neighbor, edge_slot)
    adj: List[List[Tuple[int, int]]] = [[] for _ in range(num_nodes)]
    for eid in range(m):
        a, b = int(edges[eid, 0]), int(edges[eid, 1])
        adj[a].append((b, eid))
        adj[b].append((a, eid))
    for lst in adj:
        rng.shuffle(lst)
    used = np.zeros(m, dtype=bool)
    ptr = [0] * num_nodes
    stack = [start]
    tour: List[int] = []
    while stack:
        v = stack[-1]
        lst = adj[v]
        advanced = False
        while ptr[v] < len(lst):
            nb, eid = lst[ptr[v]]
            if used[eid]:
                ptr[v] += 1
                continue
            used[eid] = True
            stack.append(nb)
            advanced = True
            break
        if not advanced:
            tour.append(stack.pop())
    return tour[::-1]


def shorten_walk(walk: List[int], num_unique_edges: int) -> List[int]:
    """Truncate the tour once all unique undirected edges are covered
    (reference shorten_path, nx_utils.py:331-348)."""
    if num_unique_edges == 0:
        return walk[:1]
    seen = set()
    for i in range(len(walk) - 1):
        a, b = walk[i], walk[i + 1]
        seen.add((a, b) if a < b else (b, a))
        if len(seen) == num_unique_edges:
            return walk[: i + 2]
    return walk


def component_walk(
    csr: CSR, comp_nodes: np.ndarray, rng: np.random.Generator
) -> List[int]:
    """Euler walk over one connected component (connected_graph2path,
    nx_utils.py:413-422)."""
    if len(comp_nodes) == 1:
        return [int(comp_nodes[0])]
    comp_set = set(int(x) for x in comp_nodes)
    in_comp = np.isin(csr.u, comp_nodes) & np.isin(csr.v, comp_nodes)
    base_edges = np.stack([csr.u[in_comp], csr.v[in_comp]], axis=1).astype(np.int64)
    extra = eulerize_component(csr, comp_nodes, rng)
    all_edges = (
        np.concatenate([base_edges, np.asarray(extra, np.int64)], axis=0)
        if extra
        else base_edges
    )
    start = int(rng.choice(comp_nodes))
    assert start in comp_set
    walk = _hierholzer(csr.num_nodes, all_edges, start, rng)
    return shorten_walk(walk, base_edges.shape[0])


def graph_to_walk(graph: Graph, rng: np.random.Generator) -> np.ndarray:
    """Full graph -> Euler walk with jump edges between shuffled components.

    Returns int64 array of nodes; consecutive pairs are the path edges.
    Mirrors graph2path_v2 (nx_utils.py:388-410): components are shuffled,
    each toured independently, and walks joined by a (prev_end, next_start)
    jump edge.
    """
    native = _native()
    if native is not None:
        return native.graph_to_walk(graph.num_nodes, graph.edge_index, rng)
    csr = CSR(graph.num_nodes, graph.edge_index)
    labels = connected_components(csr)
    comp_ids = np.unique(labels)
    order = rng.permutation(len(comp_ids))
    walk: List[int] = []
    for k in order:
        comp_nodes = np.flatnonzero(labels == comp_ids[k])
        sub = component_walk(csr, comp_nodes, rng)
        walk.extend(sub)  # consecutive-pair join acts as the jump edge
    return np.asarray(walk, dtype=np.int64)


def walk_node_ranks(
    walk: np.ndarray, scope: int, mapping_type: int, rng: np.random.Generator
) -> np.ndarray:
    """Re-index raw node ids by first appearance along the walk.

    mapping_type 0/1/2 = normal/cyclic/random
    (get_structure_raw_node2idx_mapping, nx_utils.py:234-260).
    Returns per-walk-position structural index in [0, scope).
    """
    # first-appearance rank of each walk position's node
    _, first_pos, inverse = np.unique(walk, return_index=True, return_inverse=True)
    rank_of_unique = np.argsort(np.argsort(first_pos))  # unique id -> appearance rank
    ranks = rank_of_unique[inverse]
    n_unique = len(first_pos)
    if mapping_type == 2:
        perm = rng.choice(scope, size=n_unique, replace=False)
        return perm[ranks].astype(np.int64)
    start = int(rng.integers(0, scope)) if mapping_type == 1 else 0
    return (ranks + start) % scope


EDGE_JUMP, EDGE_IN, EDGE_OUT, EDGE_BI = 0, 1, 2, 3


def walk_edge_types(graph: Graph, walk: np.ndarray) -> np.ndarray:
    """Per-step edge type from directed edge membership (get_edge_type,
    nx_utils.py:277-290): forward only -> OUT, backward only -> IN, both ->
    BI, neither -> JUMP."""
    if len(walk) < 2:
        return np.zeros(0, np.int64)
    src, tgt = walk[:-1], walk[1:]
    sorted_keys, order = build_directed_edge_lookup(graph.num_nodes, graph.edge_index)
    fwd = lookup_directed_edges(sorted_keys, order, graph.num_nodes, src, tgt) >= 0
    bwd = lookup_directed_edges(sorted_keys, order, graph.num_nodes, tgt, src) >= 0
    out = np.full(len(src), EDGE_JUMP, np.int64)
    out[fwd & ~bwd] = EDGE_OUT
    out[~fwd & bwd] = EDGE_IN
    out[fwd & bwd] = EDGE_BI
    return out


def walk_edge_attr_rows(graph: Graph, walk: np.ndarray) -> np.ndarray:
    """Original edge column carrying each walk step's attributes, -1 for jumps.

    Forward direction wins, then backward (reference _get_edge2attr_mapping,
    src/data/tokenizer.py:780-797).
    """
    if len(walk) < 2:
        return np.zeros(0, np.int64)
    src, tgt = walk[:-1], walk[1:]
    sorted_keys, order = build_directed_edge_lookup(graph.num_nodes, graph.edge_index)
    fwd = lookup_directed_edges(sorted_keys, order, graph.num_nodes, src, tgt)
    bwd = lookup_directed_edges(sorted_keys, order, graph.num_nodes, tgt, src)
    return np.where(fwd >= 0, fwd, bwd)
