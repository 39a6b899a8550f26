"""Structure-understanding and instruction token streams of the flat tokenizer.

A copy of `graphgpt_tpu/data/structure_tasks.py`: the nx structure streams
(degree, triangles, shortest_path, shortest_path_length; reference
src/utils/nx_utils.py:53-172) over the port's `CSR`, with the shortest
path by BFS, and the instruction streams (homo_lumo and cepdb_prop_all
property digits, the OneID a2d stream; reference
src/utils/instruct_tuning_utils.py:51-118). Each stream is (token ids,
label ids): the next-token shift with the prompt positions label-padded
(get_labels_from_input_tokens with `skipped`, nx_utils.py:615-630). The rng
draws come in the JAX package's order.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np

from ..utils.registry import Register
from .graph import CSR, Graph
from .vocab import LABEL_PAD_ID

_nx = Register()
get_nx_struct = _nx.build

_instruct = Register()
get_instruct = _instruct.build


def _digit_ids(num, vocab_map: Dict[str, int]) -> List[int]:
    return [vocab_map[f"<{ch}>"] for ch in str(num)]


def _ntp_labels(tokens: List[int], skipped: int, eos_id: int) -> List[int]:
    labels = tokens[1:] + [eos_id]
    for i in range(min(skipped, len(labels))):
        labels[i] = LABEL_PAD_ID
    return labels


def _reserved_id(cfg, which: str, k: int, vocab_map) -> int:
    toks = cfg.structure.reserved_tokens if which == "structure" else cfg.semantics.reserved_tokens
    return vocab_map[toks[k]]


@_nx("degree")
def _degree(graph: Graph, *, csr: CSR, node_token_ids, cfg, vocab_map, eos_id, rng):
    """<structure_0> <node> <digits(degree)> (nx_utils.py:53-64)."""
    node = int(rng.integers(graph.num_nodes))
    tokens = [_reserved_id(cfg, "structure", 0, vocab_map), node_token_ids[node]]
    tokens += _digit_ids(int(csr.degrees()[node]), vocab_map)
    return tokens, _ntp_labels(tokens, 2, eos_id)


@_nx("triangles")
def _triangles(graph: Graph, *, csr: CSR, node_token_ids, cfg, vocab_map, eos_id, rng):
    """<structure_1> <node> <digits(triangles at node)> (nx_utils.py:67-78)."""
    node = int(rng.integers(graph.num_nodes))
    nbrs = csr.neighbors(node)
    nbr_set = set(int(x) for x in nbrs)
    count = sum(1 for a in nbrs for b in csr.neighbors(int(a))
                if int(b) in nbr_set and int(b) > int(a))
    tokens = [_reserved_id(cfg, "structure", 1, vocab_map), node_token_ids[node]]
    tokens += _digit_ids(count, vocab_map)
    return tokens, _ntp_labels(tokens, 2, eos_id)


def _bfs_path(csr: CSR, src: int, dst: int) -> List[int]:
    """A shortest path src .. dst by breadth-first search over the CSR
    (neighbours in CSR order), [] where dst is not reachable."""
    parent = {src: -1}
    frontier = [src]
    while frontier and dst not in parent:
        nxt = []
        for node in frontier:
            for nb in csr.neighbors(node):
                nb = int(nb)
                if nb not in parent:
                    parent[nb] = node
                    nxt.append(nb)
        frontier = nxt
    if dst not in parent:
        return []
    path = [dst]
    while path[-1] != src:
        path.append(parent[path[-1]])
    return path[::-1]


@_nx("shortest_path")
def _shortest_path(graph: Graph, *, csr: CSR, node_token_ids, cfg, vocab_map, eos_id, rng):
    """<structure_2> <src> <dst> <path nodes...> (nx_utils.py:81-100)."""
    if graph.num_nodes <= 2:
        return [], []
    src, dst = (int(x) for x in rng.choice(graph.num_nodes, size=2, replace=False))
    path = _bfs_path(csr, src, dst)
    tokens = [_reserved_id(cfg, "structure", 2, vocab_map), node_token_ids[src],
              node_token_ids[dst]] + [node_token_ids[n] for n in path]
    return tokens, _ntp_labels(tokens, 3, eos_id)


@_nx("shortest_path_length")
def _shortest_path_length(graph: Graph, *, csr: CSR, node_token_ids, cfg, vocab_map, eos_id,
                          rng):
    """<structure_3> <src> <dst> <digits(length)>, -1 where unreachable
    (nx_utils.py:103-122)."""
    if graph.num_nodes <= 2:
        return [], []
    src, dst = (int(x) for x in rng.choice(graph.num_nodes, size=2, replace=False))
    path = _bfs_path(csr, src, dst)
    tokens = [_reserved_id(cfg, "structure", 3, vocab_map), node_token_ids[src],
              node_token_ids[dst]] + _digit_ids(len(path) - 1 if path else -1, vocab_map)
    return tokens, _ntp_labels(tokens, 3, eos_id)


def structure_task_tokens(
    graph: Graph,
    func_names: List[str],
    node_token_ids: np.ndarray,  # per raw node: its structure token id
    cfg,
    vocab_map: Dict[str, int],
    eos_id: int,
    rng: np.random.Generator,
) -> Tuple[List[int], List[int]]:
    """The structure streams of `func_names`, in a random order where there
    are several (understand_structure, nx_utils.py:17-50)."""
    csr = CSR(graph.num_nodes, graph.edge_index)
    outs = []
    for name in func_names:
        toks, labs = get_nx_struct(name, graph, csr=csr, node_token_ids=node_token_ids, cfg=cfg,
                                   vocab_map=vocab_map, eos_id=eos_id, rng=rng)
        if toks:
            outs.append((toks, labs))
    if len(outs) > 1:
        outs = [outs[i] for i in rng.permutation(len(outs))]
    tokens: List[int] = []
    labels: List[int] = []
    for t, lab in outs:
        tokens += t
        labels += lab
    return tokens, labels


# ---------------------------------------------------------------------------
# Instruction streams
# ---------------------------------------------------------------------------
@_instruct("homo_lumo")
def _homo_lumo(graph: Graph, *, cfg, vocab_map, eos_id, rng, mask_ratio: float = 0.0, **kw):
    """<semantics_0> <digits of y> (instruct_tuning_utils.py:51-77)."""
    y = np.asarray(graph.y).reshape(-1)
    if len(y) == 0 or np.isnan(y[0]) or rng.random() >= 1 - mask_ratio:
        return [], []
    tokens = [_reserved_id(cfg, "semantics", 0, vocab_map)]
    tokens += [vocab_map[f"<{ch}>"] for ch in str(y[0])]
    return tokens, _ntp_labels(tokens, 1, eos_id)


@_instruct("cepdb_prop_all")
def _cepdb_props(graph: Graph, *, cfg, vocab_map, eos_id, rng, **kw):
    """Seven property blocks in a random order (instruct_tuning_utils.py:80-99)."""
    y = np.asarray(graph.y).reshape(-1)
    if len(y) != 7:
        return [], []
    blocks = []
    for k, val in enumerate(y):
        toks = [_reserved_id(cfg, "semantics", k, vocab_map)]
        toks += [vocab_map[f"<{ch}>"] for ch in str(val)]
        blocks.append((toks, _ntp_labels(toks, 1, eos_id)))
    tokens, labels = [], []
    for i in rng.permutation(len(blocks)):
        tokens += blocks[i][0]
        labels += blocks[i][1]
    return tokens, labels


@_instruct("a2d")
def _acc2device(graph: Graph, *, cfg, vocab_map, eos_id, rng, node_token_ids=None, **kw):
    """OneID account->device stream (reference _obtain_acc2device,
    instruct_tuning_utils.py:102-118): the reserved token the graph's
    key_type selects, then the structure token of each (account, device)
    node; next-token labels with the prompt skipped, as the JAX package
    gives them (the reference emits no labels)."""
    a2d = graph.extra.get("a2d")
    if a2d is None or len(a2d) == 0 or node_token_ids is None:
        return [], []
    key_type = int(np.asarray(graph.extra.get("key_type", 0)))
    tokens = [_reserved_id(cfg, "semantics", key_type, vocab_map)]
    tokens += [int(node_token_ids[n]) for n in np.asarray(a2d, np.int64).reshape(-1)]
    return tokens, _ntp_labels(tokens, 1, eos_id)


def instruction_tokens(
    graph: Graph, func_names: List[str], cfg, vocab_map, eos_id, rng, **kwargs
) -> Tuple[List[int], List[int]]:
    """The instruction streams of `func_names`, in that order."""
    tokens: List[int] = []
    labels: List[int] = []
    for name in func_names:
        t, lab = get_instruct(name, graph, cfg=cfg, vocab_map=vocab_map, eos_id=eos_id, rng=rng,
                              **kwargs)
        tokens += t
        labels += lab
    return tokens, labels
