"""Subgraph sampling for the big-graph (node- and edge-level) datasets.

Counterpart of `graphgpt_tpu/data/sampling.py`: `build_csr_directed`
(:28), `ego_k_hop` (:38), `induced_subgraph` (:80), `EgoNodeDataset`
(:95), `sample_pos_edges` (:171), `sample_neg_edges_global` (:195),
`sample_neg_edges_local` (:228) and `EgoEdgeDataset` (:268-467). The
samples are the JAX package's, bit for bit; four things differ in how they
are computed:

  - `ego_k_hop` runs the C++ sampler of `native/euler_native.py` and raises
    where its library cannot be built (the JAX function falls back to
    numpy on any exception, which would change every sample with the
    presence of a compiler). `ego_k_hop_numpy` is the JAX numpy route,
    kept for the tests.
  - `induced_subgraph` reads the sampled nodes' out-edges from the CSR
    instead of scanning the big graph's whole edge list for every sample.
  - `sample_neg_edges_global` takes the existing edges as one sorted key
    array (`existing_edge_keys`, computed once a dataset) instead of a
    Python set built on every call, and keeps only their count from 1M on,
    where the JAX function ignores the set.
  - the wikikg2 weights come from sorted keys and `searchsorted`, not a
    Python dict.

A dataset that a reader built (`source` set) pickles as the reader's
arguments and its epoch, seed and negative-key cache: a spawned loader
worker opens the memory-mapped store again and redraws the epoch's samples
itself, instead of unpickling the big graph, its CSR and the epoch's edge
list.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np

from .graph import Graph

# from this many distinct existing edges on, global negatives are not
# checked against them (graphgpt_tpu/data/sampling.py:211-216)
NEG_CHECK_LIMIT = 1_000_000


def build_csr_directed(num_nodes: int, edge_index: np.ndarray):
    """CSR over *directed* edges with original edge ids as values:
    (indptr, destination of each CSR slot, its edge column)."""
    order = np.argsort(edge_index[0], kind="stable")
    indptr = np.zeros(num_nodes + 1, np.int64)
    counts = np.bincount(edge_index[0], minlength=num_nodes)
    np.cumsum(counts, out=indptr[1:])
    return indptr, edge_index[1][order].astype(np.int64), order.astype(np.int64)


def ego_k_hop(indptr, indices, seeds: Sequence[int], depth: int, fanout: int,
              rng: np.random.Generator, replace: bool = False) -> np.ndarray:
    """Sampled k-hop neighbourhood node set (sorted, seeds included), by the
    C++ sampler; it draws one 63-bit seed from `rng`."""
    from ..native import euler_native

    return euler_native.ego_k_hop(indptr, indices, np.asarray(seeds, np.int64), depth, fanout,
                                  rng, replace)


def ego_k_hop_numpy(indptr, indices, seeds: Sequence[int], depth: int, fanout: int,
                    rng: np.random.Generator, replace: bool = False) -> np.ndarray:
    """The JAX package's numpy route of `ego_k_hop` (its fallback)."""
    visited = set(int(s) for s in seeds)
    frontier = list(visited)
    for _ in range(depth):
        nxt = []
        for node in frontier:
            nbrs = indices[indptr[node] : indptr[node + 1]]
            if len(nbrs) == 0:
                continue
            if fanout >= 0 and len(nbrs) > fanout:
                if replace:
                    nbrs = nbrs[rng.integers(0, len(nbrs), size=fanout)]
                else:
                    nbrs = rng.choice(nbrs, size=fanout, replace=False)
            for nb in nbrs:
                nb = int(nb)
                if nb not in visited:
                    visited.add(nb)
                    nxt.append(nb)
        frontier = nxt
    return np.asarray(sorted(visited), np.int64)


def induced_subgraph(csr, nodes: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """(sub_edge_index relabelled, original edge columns ascending) of the
    node-induced directed subgraph, from the CSR `(indptr, indices, eids)`
    of `build_csr_directed`. `nodes` is sorted (a repeated node, as two
    equal seeds give, takes its last position, as the JAX lookup table
    does)."""
    indptr, indices, eid_of = csr
    nodes = np.asarray(nodes, np.int64)
    uniq = np.unique(nodes)
    starts = indptr[uniq]
    counts = indptr[uniq + 1] - starts
    total = int(counts.sum())
    # the CSR slots of every out-edge of the nodes
    slot = np.repeat(starts - np.cumsum(counts) + counts, counts) + np.arange(total)
    dst = indices[slot]
    # membership and relabelling by binary search in the sorted nodes
    loc = np.searchsorted(nodes, dst, side="right") - 1
    keep = (loc >= 0) & (nodes[np.maximum(loc, 0)] == dst)
    eids = eid_of[slot[keep]]
    order = np.argsort(eids, kind="stable")
    src_loc = np.searchsorted(nodes, np.repeat(uniq, counts)[keep], side="right") - 1
    sub = np.stack([src_loc[order], loc[keep][order]])
    return sub.astype(np.int32), eids[order]


class _Reopened:
    """Pickling of a dataset that a reader built: `source` names the reader
    call (see `readers._reopen`), and the state that pickles with it is the
    last `reset_samples` epoch and seed plus `_REOPEN_KEEP`."""

    source = None
    _REOPEN_KEEP: Tuple[str, ...] = ()

    def __reduce_ex__(self, protocol):
        if self.source is None:
            return object.__reduce_ex__(self, protocol)
        from .. import readers

        state = {k: getattr(self, k) for k in ("epoch", "reset_seed") + self._REOPEN_KEEP}
        return readers._reopen, (self.source, state)

    def restore(self, state):
        """Bring a freshly read dataset to a pickled state."""
        epoch, seed = state.pop("epoch"), state.pop("reset_seed")
        self.__dict__.update(state)
        if (epoch, seed) != (self.epoch, self.reset_seed):
            self.reset_samples(epoch, seed)
        return self


class EgoNodeDataset(_Reopened):
    """Per-seed-node ego subgraphs for node-level tasks (reference
    ShaDowKHopSeqMapDataset, dataset_map.py:132-268). `csr` is the big
    graph's `build_csr_directed` where the caller has it (a reader's
    memory-mapped one)."""

    def __init__(
        self,
        big: Graph,
        depth_neighbors: Sequence[Tuple[int, int]],
        sample_idx: Optional[np.ndarray] = None,
        replace: bool = False,
        seed: int = 0,
        pretrain_mode: bool = False,
        task_mask_func=None,
        root_attr_mask: Optional[np.ndarray] = None,
        csr=None,
    ):
        self.big = big
        self.depth_neighbors = list(depth_neighbors)
        self.sample_idx = (
            np.asarray(sample_idx, np.int64)
            if sample_idx is not None
            else np.arange(big.num_nodes, dtype=np.int64)
        )
        self.replace = replace
        self.seed = seed
        self.epoch = 0
        self.reset_seed = None
        self.pretrain_mode = pretrain_mode
        # task_mask_func(graph) -> graph: dataset-specific feature masking
        # (reference dataset_map.py:169, e.g. the ogbn-proteins species mask)
        self.task_mask_func = task_mask_func
        # x_mask semantics (dataset_map.py:253-258): during fine-tuning the
        # root node's attrs are multiplied by this mask to hide its label
        self.root_attr_mask = root_attr_mask
        self.csr = csr if csr is not None else build_csr_directed(big.num_nodes, big.edge_index)

    def __len__(self):
        return len(self.sample_idx)

    def reset_samples(self, epoch: int, seed: int = 0):
        self.epoch, self.reset_seed = epoch, seed

    def __getitem__(self, i: int) -> Graph:
        seed_node = int(self.sample_idx[i])
        rng = np.random.default_rng((self.seed, self.epoch, seed_node))
        depth, fanout = self.depth_neighbors[rng.integers(len(self.depth_neighbors))]
        nodes = ego_k_hop(self.csr[0], self.csr[1], [seed_node], depth, fanout, rng,
                          self.replace)
        sub_ei, eids = induced_subgraph(self.csr, nodes)
        root = int(np.searchsorted(nodes, seed_node))
        big = self.big
        g = Graph(
            num_nodes=len(nodes),
            edge_index=sub_ei,
            node_attr=None if big.node_attr is None else np.array(big.node_attr[nodes]),
            edge_attr=None if big.edge_attr is None else big.edge_attr[eids],
            y=None if big.y is None else np.asarray(big.y).reshape(big.num_nodes, -1)[nodes],
            root_n_id=np.asarray([root]),
            idx=int(i),
        )
        # node-aligned side arrays (ogbn-proteins' node_species) ride along
        # into the subgraph (dataset_map.py:252-258)
        for key, arr in big.extra.items():
            if hasattr(arr, "shape") and arr.shape[:1] == (big.num_nodes,):
                g.extra[key] = arr[nodes]
        if (not self.pretrain_mode) and self.root_attr_mask is not None and g.node_attr is not None:
            g.node_attr[root] = g.node_attr[root] * self.root_attr_mask
        if self.task_mask_func is not None:
            g = self.task_mask_func(g)
        return g


# ---------------------------------------------------------------------------
# Positive and negative edges (edge level)
# ---------------------------------------------------------------------------
def sample_pos_edges(pos_edges: np.ndarray, percent: int, epoch: int, seed: int,
                     pos_edge_attr: Optional[np.ndarray] = None):
    """Cyclic non-repeating positive subsets: with percent=p, epochs
    [0, 100/p) partition one permutation; the seed advances every cycle
    (reference sample_pos_edges, dataset_map.py:567-597). Target edge attrs
    (the wikikg2 relations) are subset alongside."""
    if percent >= 100:
        return pos_edges, pos_edge_attr
    tot = pos_edges.shape[0]
    period = int(round(100 / percent))
    cyc_seed = seed + percent * epoch // 100
    perm = np.random.default_rng(cyc_seed).permutation(tot)
    cnt = int(round(tot * percent / 100.0))
    cyc_epoch = epoch % period
    sel = perm[cyc_epoch * cnt : (cyc_epoch + 1) * cnt]
    attr = None if pos_edge_attr is None else pos_edge_attr[sel]
    return pos_edges[sel], attr


def existing_edge_keys(num_nodes: int, existing: np.ndarray):
    """(number of distinct directed edges, their sorted keys src * N + dst,
    or None from NEG_CHECK_LIMIT on, where no draw is checked against
    them)."""
    keys = np.sort(existing[0].astype(np.int64) * num_nodes + existing[1])
    n = int(np.count_nonzero(np.diff(keys))) + 1 if len(keys) else 0
    if n >= NEG_CHECK_LIMIT:
        return n, None
    return n, np.unique(keys)


def sample_neg_edges_global(num_nodes: int, existing: np.ndarray, count: int,
                            rng: np.random.Generator, keys=None) -> np.ndarray:
    """Uniform (src, dst) pairs avoiding existing edges and self loops
    (PyG negative_sampling semantics used at dataset_map.py:632-640).
    `keys` is `existing_edge_keys(num_nodes, existing)` where the caller
    has it."""
    n_keys, sorted_keys = keys if keys is not None else existing_edge_keys(num_nodes, existing)
    out = np.empty((count, 2), np.int64)
    filled = 0
    while filled < count:
        n_draw = int((count - filled) * 1.5) + 8
        src = rng.integers(0, num_nodes, n_draw)
        dst = rng.integers(0, num_nodes, n_draw)
        ok = src != dst
        if sorted_keys is not None and len(sorted_keys):
            # below NEG_CHECK_LIMIT distinct edges: no draw may be one of them
            k = src * num_nodes + dst
            pos = np.minimum(np.searchsorted(sorted_keys, k), len(sorted_keys) - 1)
            ok &= sorted_keys[pos] != k
        take = min(int(ok.sum()), count - filled)
        sel = np.flatnonzero(ok)[:take]
        out[filled : filled + take, 0] = src[sel]
        out[filled : filled + take, 1] = dst[sel]
        filled += take
    return out


def sample_neg_edges_local(
    pos_edges: np.ndarray,
    num_nodes: int,
    neg_ratio: int,
    rng: np.random.Generator,
    sample_heads: bool = True,
    sample_tails: bool = True,
    sample_edges: bool = False,
    pos_edge_attr: Optional[np.ndarray] = None,
    neg_edge_attr_candidates: Optional[np.ndarray] = None,
):
    """Head / tail / edge-type replacement negatives with edge-attr
    threading (reference sample_neg_edges_locally, dataset_map.py:626-683):
    head/tail corruption keeps the positive's edge attrs (the wikikg2
    relation); edge corruption keeps the endpoints and swaps the attrs for
    a random candidate row."""
    cands = []
    attrs = []
    has_attr = pos_edge_attr is not None
    if sample_tails:
        tails = rng.integers(0, num_nodes, pos_edges.shape[0])
        cands.append(np.stack([pos_edges[:, 0], tails], axis=1))
        if has_attr:
            attrs.append(pos_edge_attr)
    if sample_heads:
        heads = rng.integers(0, num_nodes, pos_edges.shape[0])
        cands.append(np.stack([heads, pos_edges[:, 1]], axis=1))
        if has_attr:
            attrs.append(pos_edge_attr)
    if sample_edges and has_attr and neg_edge_attr_candidates is not None:
        cands.append(pos_edges.copy())
        idx = rng.integers(0, len(neg_edge_attr_candidates), pos_edges.shape[0])
        attrs.append(np.asarray(neg_edge_attr_candidates)[idx])
    all_c = np.concatenate(cands, axis=0)
    want = neg_ratio * pos_edges.shape[0]
    sel = rng.permutation(all_c.shape[0])[:want]
    neg_attr = np.concatenate(attrs, axis=0)[sel] if attrs else None
    return all_c[sel], neg_attr


def _pair_codes(a: np.ndarray, b: np.ndarray, lo: int, width: int) -> np.ndarray:
    """An int64 code of each pair (a, b) with lo <= b < lo + width."""
    return a.astype(np.int64) * width + (b.astype(np.int64) - lo)


class EgoEdgeDataset(_Reopened):
    """Link-prediction ego subgraphs around edge endpoints (reference
    ShaDowKHopSeqFromEdgesMapDataset, dataset_map.py:271-553). `csr` as for
    `EgoNodeDataset`; `neg_keys` the big graph's `existing_edge_keys` where
    the caller has them."""

    _REOPEN_KEEP = ("_neg_keys",)

    def __init__(
        self,
        big: Graph,
        depth_neighbors: Sequence[Tuple[int, int]],
        pos_edges: Optional[np.ndarray] = None,  # [N_p, 2]; None -> from edge_index
        neg_edges: Optional[np.ndarray] = None,  # fixed eval negatives
        neg_ratio: int = 1,
        percent: int = 100,
        method: str = "global",  # global|local
        replace: bool = False,
        seed: int = 0,
        pretrain_mode: bool = False,
        pos_edge_attr: Optional[np.ndarray] = None,  # [N_p, De] target edge attrs
        neg_edge_attr: Optional[np.ndarray] = None,  # attrs of fixed eval negatives
        neg_edge_attr_candidates: Optional[np.ndarray] = None,  # [C, De]
        sample_edges: bool = False,  # local method: also corrupt the relation
        sample_wgt: bool = False,  # wikikg2 inverse-freq weights
        relation_col: int = 1,  # edge-attr column holding the relation id
        csr=None,
        neg_keys=None,  # existing_edge_keys of the big graph, where known
    ):
        self.big = big
        self.depth_neighbors = list(depth_neighbors)
        self.neg_ratio = neg_ratio
        self.percent = percent
        self.method = method
        self.replace = replace
        self.seed = seed
        self.pretrain_mode = pretrain_mode
        self.sample_edges = sample_edges
        self.relation_col = relation_col
        if pos_edges is None:
            ei = big.edge_index
            mask = ei[0] < ei[1]
            pos_edges = ei[:, mask].T.astype(np.int64)
        self.pos_edges_all = np.asarray(pos_edges, np.int64)
        self.pos_edge_attr_all = (
            None if pos_edge_attr is None else np.asarray(pos_edge_attr, np.int64)
        )
        self.fixed_neg = None if neg_edges is None else np.asarray(neg_edges, np.int64)
        # fixed eval negatives pair 1:1 with the FULL positive set; combining
        # them with a percent-subsampled positive stream would mispair the
        # MRR grouping (reference uses percent only on the train split)
        assert self.fixed_neg is None or percent >= 100, (
            "fixed eval negatives require percent=100 (got "
            f"percent={percent}): subsampled positives cannot be paired "
            "with full-set structured negatives"
        )
        self.fixed_neg_attr = None if neg_edge_attr is None else np.asarray(neg_edge_attr, np.int64)
        self.neg_edge_attr_candidates = (
            None if neg_edge_attr_candidates is None
            else np.asarray(neg_edge_attr_candidates, np.int64)
        )
        # wikikg2 inverse-frequency sample weights (reference dataset_map.py:
        # 369-388): count(head, rel) and count(tail, -rel-1) over the FULL
        # train triple set, base count 4; per-sample weight at each reset
        # sqrt(1 / (cnt_head + cnt_tail)) (dataset_map.py:451-469). Held as
        # sorted pair codes and counts.
        self.train_count = None
        if sample_wgt and not pretrain_mode and self.pos_edge_attr_all is not None:
            rel = self.pos_edge_attr_all[:, relation_col]
            h, t = self.pos_edges_all[:, 0], self.pos_edges_all[:, 1]
            a = np.concatenate([h, t])
            b = np.concatenate([rel, -rel - 1])
            lo, width = int(b.min()), int(b.max() - b.min()) + 1
            codes, counts = np.unique(_pair_codes(a, b, lo, width), return_counts=True)
            self.train_count = (codes, 4 + counts, lo, width)
        self.wgt: Optional[np.ndarray] = None
        self.csr = csr if csr is not None else build_csr_directed(big.num_nodes, big.edge_index)
        self._neg_keys = neg_keys  # computed at first use where None
        self.epoch = 0
        self.reset_samples(0, seed)

    def _count_of(self, a: np.ndarray, b: np.ndarray) -> np.ndarray:
        """The train count of each pair (a, b), 4 where it has none."""
        codes, counts, lo, width = self.train_count
        inside = (b >= lo) & (b < lo + width)
        q = _pair_codes(a, np.where(inside, b, lo), lo, width)
        pos = np.minimum(np.searchsorted(codes, q), len(codes) - 1)
        found = inside & (codes[pos] == q)
        return np.where(found, counts[pos], 4)

    def reset_samples(self, epoch: int, seed: int = 42):
        self.epoch, self.reset_seed = epoch, seed
        pos, pos_attr = sample_pos_edges(
            self.pos_edges_all, self.percent, epoch, seed, self.pos_edge_attr_all
        )
        rng = np.random.default_rng((seed, epoch, 7))
        neg_group = None  # per-negative: index of its positive (MRR grouping)
        neg_attr = None
        if self.fixed_neg is not None:
            neg = self.fixed_neg
            neg_attr = self.fixed_neg_attr
            if neg.ndim == 3:
                # structured negatives [N_pos, K, 2]: each row belongs to a
                # positive (ogbl-citation2/wikikg2 eval; ogb_utils.py:155-170)
                n_pos, k, _ = neg.shape
                neg_group = np.repeat(np.arange(n_pos), k)
                neg = neg.reshape(-1, 2)
                if neg_attr is None and self.pos_edge_attr_all is not None:
                    # eval negatives inherit their positive's relation
                    # (reference _get_reformatted_data_of_wikikg2,
                    # edge_formatting.py:54-83), from the FULL positive set
                    assert n_pos == len(self.pos_edge_attr_all), (
                        f"structured negatives ({n_pos} rows) must align with "
                        f"the full positive set ({len(self.pos_edge_attr_all)})"
                    )
                    neg_attr = np.repeat(self.pos_edge_attr_all, k, axis=0)
        elif self.method == "global":
            if self._neg_keys is None:
                self._neg_keys = existing_edge_keys(self.big.num_nodes, self.big.edge_index)
            neg = sample_neg_edges_global(self.big.num_nodes, self.big.edge_index,
                                          self.neg_ratio * pos.shape[0], rng, self._neg_keys)
            if self.neg_edge_attr_candidates is not None:
                idx = rng.integers(0, len(self.neg_edge_attr_candidates), neg.shape[0])
                neg_attr = self.neg_edge_attr_candidates[idx]
        else:
            neg, neg_attr = sample_neg_edges_local(
                pos,
                self.big.num_nodes,
                self.neg_ratio,
                rng,
                sample_edges=self.sample_edges,
                pos_edge_attr=pos_attr,
                neg_edge_attr_candidates=self.neg_edge_attr_candidates,
            )
        y = np.concatenate([np.ones(pos.shape[0], np.int64), np.zeros(neg.shape[0], np.int64)])
        self.edges_with_y = np.concatenate(
            [np.concatenate([pos, neg], axis=0), y[:, None]], axis=1
        )
        # [N_p + N_e, De] target edge attrs (reference all_edge_attr)
        if pos_attr is not None and neg_attr is not None:
            self.all_edge_attr = np.concatenate([pos_attr, neg_attr], axis=0)
            assert self.all_edge_attr.shape[0] == self.edges_with_y.shape[0]
        else:
            self.all_edge_attr = None
        # inverse-freq weights per sample (reference dataset_map.py:451-469)
        if self.train_count is not None and self.all_edge_attr is not None:
            rel = self.all_edge_attr[:, self.relation_col]
            h, t = self.edges_with_y[:, 0], self.edges_with_y[:, 1]
            sums = (self._count_of(h, rel) + self._count_of(t, -rel - 1)).astype(np.float64)
            self.wgt = np.sqrt(1.0 / sums).astype(np.float32)
        # grouping key per sample: positives map to themselves
        if neg_group is not None:
            self.group_idx = np.concatenate([np.arange(pos.shape[0]), neg_group])
        else:
            self.group_idx = None

    def __len__(self):
        return self.edges_with_y.shape[0]

    def __getitem__(self, i: int) -> Graph:
        src, dst, y = (int(x) for x in self.edges_with_y[i])
        rng = np.random.default_rng((self.seed, self.epoch, int(i)))
        depth, fanout = self.depth_neighbors[rng.integers(len(self.depth_neighbors))]
        nodes = ego_k_hop(self.csr[0], self.csr[1], [src, dst], depth, fanout, rng, self.replace)
        sub_ei, eids = induced_subgraph(self.csr, nodes)
        r_src = int(np.searchsorted(nodes, src))
        r_dst = int(np.searchsorted(nodes, dst))
        if not self.pretrain_mode:
            # remove the target edge in both directions (dataset_map.py:556-564)
            keep = ~(
                ((sub_ei[0] == r_src) & (sub_ei[1] == r_dst))
                | ((sub_ei[0] == r_dst) & (sub_ei[1] == r_src))
            )
            sub_ei = sub_ei[:, keep]
            eids = eids[keep]
        big = self.big
        g = Graph(
            num_nodes=len(nodes),
            edge_index=sub_ei,
            node_attr=None if big.node_attr is None else big.node_attr[nodes],
            edge_attr=None if big.edge_attr is None else big.edge_attr[eids],
            y=np.asarray([y], np.int64),
            root_n_id=np.asarray([r_src, r_dst]),
            idx=int(i),
        )
        if self.group_idx is not None:
            g.extra["eval_group"] = np.asarray([self.group_idx[i]], np.int64)
        if self.all_edge_attr is not None:
            # target edge attrs (the wikikg2 relation) for the tokenizer to
            # inject into the appended dst row (dataset_map.py:548-550)
            g.tgt_edge_attr = self.all_edge_attr[i]
        if self.wgt is not None:
            g.wgt = float(self.wgt[i])
        return g
