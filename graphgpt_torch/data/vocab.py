"""Vocabulary building and loading: a copy of `graphgpt_tpu/data/vocab.py`
(one `"{token} {id}"` line per token, ids from 1, `<label_pad>` -> -100;
structure vocab, then semantics vocab, in the reference's order).
"""

from __future__ import annotations

import math
import os
from typing import Dict, Iterable, List, Optional, Sequence

import numpy as np

from ..config import TokenizationConfig

LABEL_PAD_TOKEN = "<label_pad>"
LABEL_PAD_ID = -100
NUMBER_TOKENS = ("<e>", "<.>", "<->") + tuple(f"<{d}>" for d in range(10))


def structure_vocab(cfg: TokenizationConfig) -> List[str]:
    s = cfg.structure
    common = [s.mask_token, s.icl_token, s.sep_token, *s.reserved_tokens]
    graph = [s.summary_token]
    edge = [s.edge.in_token, s.edge.out_token, s.edge.bi_token, s.edge.jump_token]
    node_cfg = s.node
    idx_tokens = [str(i) for i in range(node_cfg.scope_base)]
    high = int(math.ceil(node_cfg.node_scope / node_cfg.scope_base))
    idx_high = [f"{k}*{node_cfg.scope_base}" for k in range(1, high)]
    node = [node_cfg.eos_token, node_cfg.bos_token, node_cfg.new_node_token] + idx_tokens + idx_high
    return common + graph + edge + node


def _attr_value_tokens(
    values_per_col: Sequence[np.ndarray],
    world: str,
    neg: str,
    share_vocab: bool,
    ignored_val,
) -> List[str]:
    """Default column tokens + sorted value tokens for one attr family."""
    defaults = []
    entries = []
    seen_default = set()
    for col, vals in enumerate(values_per_col):
        col_id = -1 if share_vocab else col
        d = f"{world}#{neg}#{col_id}"
        if d not in seen_default:
            seen_default.add(d)
            defaults.append(d)
        for v in np.unique(vals):
            if ignored_val is not None and str(v) == str(ignored_val):
                continue
            entries.append((d, int(v)))
    entries = sorted(set(entries))
    return sorted(defaults) + [f"{p}#{v}" for p, v in entries]


def semantics_vocab(
    cfg: TokenizationConfig,
    node_attr_values: Optional[Sequence[np.ndarray]] = None,
    edge_attr_values: Optional[Sequence[np.ndarray]] = None,
    graph_attr_values: Optional[Sequence[np.ndarray]] = None,
) -> List[str]:
    sem = cfg.semantics
    out: List[str] = list(sem.reserved_tokens) + list(NUMBER_TOKENS)
    world = cfg.attr_world_identifier
    for neg, attr_cfg, vals in (
        ("node", sem.node, node_attr_values),
        ("edge", sem.edge, edge_attr_values),
        ("graph", sem.graph, graph_attr_values),
    ):
        if attr_cfg.discrete is not None and vals is not None:
            out += _attr_value_tokens(
                vals, world, neg, attr_cfg.share_vocab, attr_cfg.ignored_val
            )
        elif attr_cfg.continuous is not None:
            # continuous attrs use one identifier token per column with val "1"
            ncol = attr_cfg.dim
            cols = [np.asarray([1])] * ncol
            out += _attr_value_tokens(cols, world, neg, False, None)
    return out


def scan_attr_values(graphs: Iterable, field: str, dim: int) -> List[np.ndarray]:
    """Collect the set of observed values per attribute column."""
    per_col = [set() for _ in range(dim)]
    for g in graphs:
        arr = getattr(g, field, None)
        if arr is None or arr.size == 0:
            continue
        for col in range(dim):
            per_col[col].update(np.unique(arr[:, col]).tolist())
    return [np.asarray(sorted(s)) for s in per_col]


def build_vocab(
    cfg: TokenizationConfig,
    node_attr_values=None,
    edge_attr_values=None,
    graph_attr_values=None,
) -> List[str]:
    return structure_vocab(cfg) + semantics_vocab(
        cfg, node_attr_values, edge_attr_values, graph_attr_values
    )


def save_vocab(vocab: List[str], fn: str) -> None:
    os.makedirs(os.path.dirname(fn) or ".", exist_ok=True)
    with open(fn, "w") as fp:
        fp.writelines(f"{tok} {i}\n" for i, tok in enumerate(vocab, start=1))


def load_vocab(fn: str) -> Dict[str, int]:
    with open(fn) as fp:
        pairs = [line.strip().split() for line in fp if line.strip()]
    vocab_map = {tok: int(tid) for tok, tid in pairs}
    vocab_map[LABEL_PAD_TOKEN] = LABEL_PAD_ID
    return vocab_map


def vocab_map_from_list(vocab: List[str]) -> Dict[str, int]:
    m = {tok: i for i, tok in enumerate(vocab, start=1)}
    m[LABEL_PAD_TOKEN] = LABEL_PAD_ID
    return m
