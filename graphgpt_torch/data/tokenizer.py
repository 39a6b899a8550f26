"""Graph -> stacked token rows for the fine-tune tasks and the pretrain tasks.

A copy of `graphgpt_tpu/data/tokenizer.py`'s `StackedGSTTokenizer`
("short" stacking) with its task branches (graph, edge, node, nodev2), the
pretrain rows (:291-338: `pretrain-mlm` and `pretrain-cl` with host-side
SMTP masking, the latter with its trailing `<gsum>` row;
`pretrain-mlm-coord` with the coordinate extras; `pretrain`,
`pretrain-smtp`, `pretrain-coord` and `pretrain-smtp-3d` with next-row
labels, the last three with the extras `node_idx`, `pos_type` and `pos`,
`_coord_extras` :267-282), the a2d instruction rows (`_instruct_rows`
:207-239), `StackedGSTTokenizerLong` (:457-550, "long" stacking), and the
masking helpers `_polynomial_mask_ratio`, `mask_packed_row`,
`smtp_mask_stacked`; the rng draws come in the JAX package's order, so the
rows are the same. A task the JAX tokenizer has no rows for
(`pretrain-coord-cl`, and the flat tokenizer's `pretrain-ltp` and
`pretrain-euler`) raises NotImplementedError when called, as there. Short
row layout:

    [ node_idx_token | node_attr_0..node_attr_{Dn-1} | edge_attr_0..edge_attr_{De-1} ]

where position 0 and jump edges carry the default (column-identifier-only)
edge-attr tokens.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..config import TokenizationConfig
from . import euler
from .graph import Graph
from .vocab import LABEL_PAD_ID

PAD_ID = 0
MLM_TASKS = ("pretrain-mlm", "pretrain-cl", "pretrain-mlm-coord")
NEXT_ROW_TASKS = ("pretrain", "pretrain-smtp", "pretrain-coord", "pretrain-smtp-3d")


class AttrColumnLookup:
    """Vectorised attr value -> token id per column via searchsorted."""

    def __init__(self, vocab_map: Dict[str, int], world: str, neg: str, dim: int, share_vocab: bool = False):
        self.dim = dim
        self.default_ids = np.zeros(dim, np.int32)
        self._vals: List[np.ndarray] = []
        self._ids: List[np.ndarray] = []
        for col in range(dim):
            col_id = -1 if share_vocab else col
            prefix = f"{world}#{neg}#{col_id}#"
            self.default_ids[col] = vocab_map.get(f"{world}#{neg}#{col_id}", 0)
            pairs = sorted(
                (int(tok[len(prefix):]), tid)
                for tok, tid in vocab_map.items()
                if tok.startswith(prefix) and tok[len(prefix):].lstrip("-").isdigit()
            )
            self._vals.append(np.asarray([p[0] for p in pairs], np.int64))
            self._ids.append(np.asarray([p[1] for p in pairs], np.int32))

    def __call__(self, attr: np.ndarray) -> np.ndarray:
        """attr [*, dim] int -> token ids [*, dim]."""
        out = np.empty(attr.shape, np.int32)
        for col in range(self.dim):
            vals, ids = self._vals[col], self._ids[col]
            pos = np.searchsorted(vals, attr[..., col])
            pos_c = np.clip(pos, 0, max(len(vals) - 1, 0))
            if len(vals) == 0 or not np.all(vals[pos_c] == attr[..., col]):
                bad = attr[..., col][(len(vals) == 0) | (vals[pos_c] != attr[..., col])] if len(vals) else attr[..., col]
                raise KeyError(f"attr value(s) {np.unique(bad)[:5]} not in vocab column {col}")
            out[..., col] = ids[pos_c]
        return out


@dataclass
class TokenizedSample:
    """Per-sample tokenizer output (pre-padding), all numpy."""

    input_ids: np.ndarray  # [P, F] int32 (stacked) or [P] (flat)
    labels: np.ndarray  # same shape, LABEL_PAD_ID where unsupervised
    position_ids: np.ndarray  # [P] int32
    attention_mask: np.ndarray  # [P] int8, all ones pre-padding
    wgt: Optional[float] = None  # dLM loss weight
    graph_labels: Optional[np.ndarray] = None
    node_labels: Optional[np.ndarray] = None
    edge_labels: Optional[np.ndarray] = None
    segment_lengths: Optional[List[int]] = None  # for packing
    extras: Dict[str, np.ndarray] = field(default_factory=dict)

    @property
    def seq_len(self) -> int:
        return int(self.input_ids.shape[0])


class StackedGSTTokenizer:
    """Stacked graph-sequence tokenizer ("short" stacking).

    Reference: src/data/tokenizer.py:897-1186. Output per graph is an
    [P, stacked_feat] id matrix where P = Euler walk length (+1 eos row).
    """

    STACK_METHOD = "short"

    def __init__(
        self,
        cfg: TokenizationConfig,
        vocab_map: Dict[str, int],
        task_type: str = "graph",
        mlm_cfg=None,
        num_intra_cls: int = 0,
    ):
        assert cfg.stack_method == self.STACK_METHOD, (
            f"stack_method {cfg.stack_method!r}: see "
            f"{'StackedGSTTokenizerLong' if cfg.stack_method == 'long' else 'StackedGSTTokenizer'}")
        assert self.STACK_METHOD == "long" or cfg.structure.edge.remove_edge_type_token, (
            "stacked short rows assume the <edge_bi> token is elided "
            "(reference tokenizer.py:1062-1065)"
        )
        self.cfg = cfg
        self.vocab_map = vocab_map
        self.task_type = task_type
        if mlm_cfg is None and task_type in MLM_TASKS:
            from ..config import MlmScheduleConfig

            mlm_cfg = MlmScheduleConfig()
        self.mlm_cfg = mlm_cfg
        self.vocab_size = max(vocab_map.values()) + 1
        s = cfg.structure
        node_cfg = s.node
        assert node_cfg.scope_base == node_cfg.node_scope, (
            "stacked tokenizer uses single-token node ids; two-level ids are "
            "a GSTTokenizer (non-stacked) feature"
        )
        self.scope = node_cfg.node_scope
        self.cyclic = int(node_cfg.cyclic)
        self.eos_id = vocab_map[node_cfg.eos_token]
        self.bos_id = vocab_map[node_cfg.bos_token]
        self.mask_id = vocab_map[s.mask_token]
        self.gsum_id = vocab_map.get(s.summary_token, 0)
        # structural node-idx token ids: str(i) for i in [0, scope)
        self.node_idx_ids = np.asarray(
            [vocab_map[str(i)] for i in range(node_cfg.scope_base)], np.int32
        )
        sem = cfg.semantics
        world = cfg.attr_world_identifier
        self.node_dim = sem.node.dim if sem.node.discrete else 0
        self.edge_dim = sem.edge.dim if sem.edge.discrete else 0
        self.node_lookup = (
            AttrColumnLookup(vocab_map, world, "node", self.node_dim, sem.node.share_vocab)
            if self.node_dim
            else None
        )
        self.edge_lookup = (
            AttrColumnLookup(vocab_map, world, "edge", self.edge_dim, sem.edge.share_vocab)
            if self.edge_dim
            else None
        )
        self.stacked_feat = 1 + self.node_dim + self.edge_dim
        # eos row policy (reference tokenizer.py:525-526): pretrain rows always
        # carry the trailing eos row; task rows append it under cfg.add_eos
        self.append_eos = ("pretrain" in task_type) or cfg.add_eos
        # intra-instance class tokens for nodev2 token_ce_intra
        # (reference reserved semantics tokens, tokenizer_utils.py:729-747)
        self.num_intra_cls = num_intra_cls
        self.intra_cls_token_ids = [
            vocab_map[t] for t in sem.reserved_tokens[:num_intra_cls]
        ]

    # ------------------------------------------------------------------
    def tokenize(
        self, graph: Graph, rng: np.random.Generator
    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """graph -> (input_ids [P,F] incl. the trailing eos row [eos]*F,
        walk, ranks)."""
        walk = euler.graph_to_walk(graph, rng)  # [P0]
        ranks = euler.walk_node_ranks(walk, self.scope, self.cyclic, rng)
        p0 = len(walk)
        f = self.stacked_feat
        ids = np.empty((p0 + 1, f), np.int32)
        ids[:p0, 0] = self.node_idx_ids[ranks]
        col = 1
        if self.node_dim:
            ids[:p0, col : col + self.node_dim] = self.node_lookup(
                getattr(graph, "node_attr")[walk]
            )
            col += self.node_dim
        if self.edge_dim:
            erows = euler.walk_edge_attr_rows(graph, walk)  # [P0-1]
            eattr = np.empty((p0, self.edge_dim), np.int32)
            eattr[0] = self.edge_lookup.default_ids
            real = erows >= 0
            if p0 > 1 and not real.any():
                # an edge-free graph of several nodes walks by jumps only
                # (repair: the JAX tokenizer indexes its empty edge_attr here
                # and raises)
                eattr[1:] = self.edge_lookup.default_ids[None, :]
            elif p0 > 1:
                vals = np.where(real[:, None], graph.edge_attr[np.maximum(erows, 0)], 0)
                looked = self.edge_lookup(vals)
                eattr[1:] = np.where(
                    real[:, None], looked, self.edge_lookup.default_ids[None, :]
                )
            ids[:p0, col : col + self.edge_dim] = eattr
        ids[p0] = self.eos_id  # eos row
        if not self.append_eos:
            ids = ids[:p0]
        inst = self._instruct_rows(graph, walk, ranks)
        if inst is not None:
            ids = np.concatenate([ids, inst], axis=0)
        return ids, walk, ranks

    def _instruct_rows(self, graph: Graph, walk, ranks):
        """Stacked a2d instruction rows appended after the eos row
        (reference _obtain_stacked_acc2device, instruct_tuning_utils.py:121-151):
        a header row of the reserved token the graph's key_type selects, then
        a full stacked row (idx token, node attrs, default edge attrs) for
        each (account, device) node."""
        if "a2d" not in self.cfg.semantics.instruct_funcs:
            return None
        a2d = graph.extra.get("a2d")
        if a2d is None or len(a2d) == 0:
            return None
        key_type = int(np.asarray(graph.extra.get("key_type", 0)))
        reserved = self.cfg.semantics.reserved_tokens[key_type]
        rid = self.vocab_map.get(reserved)
        if rid is None:
            raise ValueError(f"reserved token {reserved!r} missing from vocab")
        flat = np.asarray(a2d, np.int64).reshape(-1)
        node_rank = np.zeros(graph.num_nodes, np.int64)  # raw node -> rank in this walk
        node_rank[walk] = np.asarray(ranks)
        rows = np.empty((1 + len(flat), self.stacked_feat), np.int32)
        rows[0] = rid
        rows[1:, 0] = self.node_idx_ids[node_rank[flat]]
        col = 1
        if self.node_dim:
            rows[1:, col : col + self.node_dim] = self.node_lookup(graph.node_attr[flat])
            col += self.node_dim
        if self.edge_dim:
            rows[1:, col : col + self.edge_dim] = self.edge_lookup.default_ids
        return rows

    def target_token_ids(self, graph: Graph, walk: np.ndarray, ranks: np.ndarray):
        """Structural idx token ids for root_n_id (node / edge tasks)."""
        if graph.root_n_id is None:
            return None
        root = np.atleast_1d(np.asarray(graph.root_n_id))
        out = []
        for r in root:
            pos = np.flatnonzero(walk == r)
            assert len(pos) > 0, "target node must appear on the Euler walk"
            out.append(int(self.node_idx_ids[ranks[pos[0]]]))
        return out

    def _row_for_node_token(
        self, ids: np.ndarray, tok_id: int, edge_attr_ids=None
    ) -> np.ndarray:
        """Full stacked row whose structural slot equals tok_id, with default
        (or target, e.g. the wikikg2 relation) edge-attr tokens substituted
        (reference tokenizer_utils.py:591-611)."""
        pos = np.flatnonzero(ids[:, 0] == tok_id)
        row = ids[pos[0]].copy()
        if self.edge_dim:
            row[-self.edge_dim :] = (
                self.edge_lookup.default_ids if edge_attr_ids is None else edge_attr_ids
            )
        return row

    def _coord_extras(self, graph: Graph, walk: np.ndarray, p: int, rng) -> dict:
        """Node decoration for in-model SMTP and 3D-position pretraining
        (reference _attach_node_mask_to_inputs, tokenizer_utils.py:453-468):
        node_idx = raw id + 1 (0 at eos), pos_type 0-4, and where the graph
        has coordinates the rotated ones (zeros on the eos row)."""
        from .mol3d import ROTATIONS, pos_type_from_node_index

        raw_idx = np.concatenate([walk, [-1]])
        extras = {"node_idx": (raw_idx + 1).astype(np.int32),
                  "pos_type": pos_type_from_node_index(raw_idx).astype(np.int32)}
        if graph.pos is not None:
            pos = ROTATIONS[self.cfg.rotation](np.asarray(graph.pos, np.float32), rng)
            row_pos = np.zeros((p, 3), np.float32)
            row_pos[:-1] = pos[walk]
            extras["pos"] = row_pos
        return extras

    # ------------------------------------------------------------------
    def __call__(self, graph: Graph, rng: np.random.Generator) -> TokenizedSample:
        ids, walk, ranks = self.tokenize(graph, rng)
        p = ids.shape[0]
        position_ids = np.arange(p, dtype=np.int32)
        attention_mask = np.ones(p, np.int8)
        task = self.task_type
        if task in MLM_TASKS:
            alpha_t, wgt = _polynomial_mask_ratio(self.mlm_cfg, rng)
            masked, labels = smtp_mask_stacked(
                ids, self.mask_id, alpha_t, rng, mtp=tuple(self.mlm_cfg.mtp),
                vocab_size=self.vocab_size,
            )
            if task == "pretrain-cl":
                # a trailing <gsum> row pools the contrastive embedding, its
                # label padded (reference _add_gsum_tokens_for_cl,
                # tokenizer_utils.py:366-387)
                f = masked.shape[1]
                masked = np.concatenate([masked, np.full((1, f), self.gsum_id, np.int32)])
                labels = np.concatenate([labels, np.full((1, f), LABEL_PAD_ID, np.int32)])
                p += 1
                position_ids = np.arange(p, dtype=np.int32)
                attention_mask = np.ones(p, np.int8)
            extras = (self._coord_extras(graph, walk, p, rng) if task == "pretrain-mlm-coord"
                      else {})
            return TokenizedSample(
                input_ids=masked,
                labels=labels,
                position_ids=position_ids,
                attention_mask=attention_mask,
                wgt=float(wgt) if self.mlm_cfg.dlm_wgt else None,
                segment_lengths=[p],
                extras=extras,
            )
        if task in NEXT_ROW_TASKS:
            # clean rows, labels the next row; in-model SMTP masks on the device
            labels = np.concatenate([ids[1:], np.full((1, ids.shape[1]), self.eos_id, np.int32)])
            extras = {} if task == "pretrain" else self._coord_extras(graph, walk, p, rng)
            return TokenizedSample(
                input_ids=ids,
                labels=labels,
                position_ids=position_ids,
                attention_mask=attention_mask,
                segment_lengths=[p],
                extras=extras,
            )
        if task == "graph":
            labels = np.full_like(ids, LABEL_PAD_ID)
            y = np.asarray(graph.y, np.float32).reshape(-1)
            return TokenizedSample(
                input_ids=ids,
                labels=labels,
                position_ids=position_ids,
                attention_mask=attention_mask,
                graph_labels=y,
                segment_lengths=[p],
            )
        if task == "edge":
            # append src/dst stacked rows after eos; shuffled ONLY when the
            # edge is undirected (no target attrs) — a relation edge (wikikg2)
            # keeps src,dst order and carries its relation tokens on the dst
            # row (reference prepare_inputs_for_edge_lvl_task,
            # tokenizer_utils.py:570-633)
            tgt = self.target_token_ids(graph, walk, ranks)
            assert tgt is not None and len(tgt) == 2
            tgt_edge_attr = graph.tgt_edge_attr
            dst_attr_ids = None
            if tgt_edge_attr is not None and self.edge_dim:
                dst_attr_ids = self.edge_lookup(
                    np.asarray(tgt_edge_attr).reshape(1, -1)
                )[0]
            elif rng.random() < 0.5:
                tgt = tgt[::-1]
            rows = np.stack(
                [
                    self._row_for_node_token(ids, tgt[0]),
                    self._row_for_node_token(ids, tgt[1], dst_attr_ids),
                ]
            )
            ids2 = np.concatenate([ids, rows], axis=0)
            p2 = ids2.shape[0]
            labels = np.full_like(ids2, LABEL_PAD_ID)
            extras = {}
            if "eval_group" in graph.extra:
                extras["eval_group"] = np.asarray(graph.extra["eval_group"], np.int64)
            return TokenizedSample(
                input_ids=ids2,
                labels=labels,
                position_ids=np.arange(p2, dtype=np.int32),
                attention_mask=np.ones(p2, np.int8),
                edge_labels=np.asarray(graph.y, np.float32).reshape(-1),
                wgt=graph.wgt,
                segment_lengths=[p2],
                extras=extras,
            )
        if task == "node":
            tgt = self.target_token_ids(graph, walk, ranks)
            assert tgt is not None and len(tgt) == 1
            rows = np.stack([self._row_for_node_token(ids, t) for t in tgt])
            ids2 = np.concatenate([ids, rows], axis=0)
            p2 = ids2.shape[0]
            labels = np.full_like(ids2, LABEL_PAD_ID)
            y = np.asarray(graph.y).reshape(graph.num_nodes, -1)[np.asarray(graph.root_n_id).reshape(-1)[0]]
            return TokenizedSample(
                input_ids=ids2,
                labels=labels,
                position_ids=np.arange(p2, dtype=np.int32),
                attention_mask=np.ones(p2, np.int8),
                node_labels=np.asarray(y, np.float32).reshape(-1),
                wgt=graph.wgt,
                segment_lengths=[p2],
            )
        if task == "nodev2":
            # token-level node classification: each node's label sits on its
            # FIRST structural-token occurrence only; optionally append
            # intra-instance class rows with cls_idx (reference
            # prepare_inputs_for_node_v2_token_lvl_task,
            # tokenizer_utils.py:688-748)
            y = (
                np.asarray(graph.y).reshape(graph.num_nodes, -1)[:, 0]
                if graph.y is not None
                else np.full(graph.num_nodes, LABEL_PAD_ID)
            )
            p0 = ids.shape[0]
            nodev2 = np.full(p0, LABEL_PAD_ID, np.int64)
            raw_node_idx = np.full(p0, LABEL_PAD_ID, np.int64)
            seen = set()
            for i, node in enumerate(walk):
                node = int(node)
                if node not in seen:
                    seen.add(node)
                    nodev2[i] = int(y[node])
                    raw_node_idx[i] = node
            extras = {"nodev2_labels": nodev2, "raw_node_idx": raw_node_idx}
            labels = np.full_like(ids, LABEL_PAD_ID)
            cls_rows = 0
            if self.num_intra_cls > 0:
                order = rng.permutation(self.num_intra_cls)
                cls_ids = np.asarray(
                    [self.intra_cls_token_ids[k] for k in order], np.int32
                )
                rows = np.repeat(cls_ids[:, None], ids.shape[1], axis=1)
                extras["cls_perm"] = np.argsort(order).astype(np.int64)
                extras["cls_idx"] = np.asarray([p0], np.int64)
                ids = np.concatenate([ids, rows])
                labels = np.concatenate(
                    [labels, np.full_like(rows, LABEL_PAD_ID)]
                )
                pad = np.full(len(cls_ids), LABEL_PAD_ID, np.int64)
                extras["nodev2_labels"] = np.concatenate([nodev2, pad])
                extras["raw_node_idx"] = np.concatenate([raw_node_idx, pad])
                cls_rows = len(cls_ids)
            p2 = p0 + cls_rows
            return TokenizedSample(
                input_ids=ids,
                labels=labels,
                position_ids=np.arange(p2, dtype=np.int32),
                attention_mask=np.ones(p2, np.int8),
                segment_lengths=[p2],
                extras=extras,
            )
        raise NotImplementedError(f"task_type {task!r}")


class StackedGSTTokenizerLong(StackedGSTTokenizer):
    """"Long" stacking: alternating node and edge rows
    (reference stack_attr_to_node_and_edge, tokenizer.py:1269-1359).

    Row layout (stacked_feat = 2 + node_dim + edge_dim):
      node row: [node_idx | node_attrs | <edge_bi> | default edge attrs]
      edge row: [<new>    | default node attrs | edge_type | edge attrs]

    The JAX class switches the config to the short stacking while its base
    initialises and leaves `remove_edge_type_token` False after; this one
    leaves the config as it was given. The rows are built by array
    operations, not a row at a time; they are the same.
    """

    STACK_METHOD = "long"

    def __init__(self, cfg, vocab_map, **kw):
        super().__init__(cfg, vocab_map, **kw)
        self.stacked_feat = 2 + self.node_dim + self.edge_dim
        s = cfg.structure
        self.edge_type_ids = np.asarray(
            [vocab_map[s.edge.jump_token], vocab_map[s.edge.in_token],
             vocab_map[s.edge.out_token], vocab_map[s.edge.bi_token]], np.int32)
        self.bi_id = vocab_map[s.edge.bi_token]
        self.new_id = vocab_map[s.node.new_node_token]
        self.default_node_attr_ids = (
            self.node_lookup.default_ids if self.node_lookup else np.zeros(0, np.int32)
        )

    def tokenize(self, graph: Graph, rng: np.random.Generator):
        walk = euler.graph_to_walk(graph, rng)
        ranks = euler.walk_node_ranks(walk, self.scope, self.cyclic, rng)
        etypes = euler.walk_edge_types(graph, walk)
        erows = euler.walk_edge_attr_rows(graph, walk)
        p0 = len(walk)
        dn, de = self.node_dim, self.edge_dim
        n_rows = 2 * p0 - 1 if p0 > 0 else 1
        ids = np.empty((n_rows + 1, self.stacked_feat), np.int32)
        node_rows, edge_rows = ids[0 : 2 * p0 : 2], ids[1 : 2 * p0 - 1 : 2]
        node_rows[:, 0] = self.node_idx_ids[ranks]
        if dn:
            node_rows[:, 1 : 1 + dn] = self.node_lookup(graph.node_attr)[walk]
            edge_rows[:, 1 : 1 + dn] = self.default_node_attr_ids
        node_rows[:, 1 + dn] = self.bi_id
        edge_rows[:, 0] = self.new_id
        edge_rows[:, 1 + dn] = self.edge_type_ids[etypes]
        if de:
            node_rows[:, 2 + dn :] = self.edge_lookup.default_ids
            eattr = np.repeat(self.edge_lookup.default_ids[None, :], p0 - 1, axis=0)
            real = erows >= 0
            if real.any():
                eattr[real] = self.edge_lookup(graph.edge_attr[erows[real]])
            edge_rows[:, 2 + dn :] = eattr
        ids[n_rows] = self.eos_id
        if not self.append_eos:
            ids = ids[:n_rows]
        return ids, walk, ranks

    def pad_stacked_labels(self, labels: np.ndarray) -> np.ndarray:
        """Label padding per row parity: node rows supervise the node part
        (cols <= node_dim), edge rows the edge part (cols > node_dim or eos)
        (reference _pad_stacked_targets, tokenizer_utils.py:206-219)."""
        out = labels.copy()
        dn = self.node_dim
        out[0::2, dn + 1 :] = LABEL_PAD_ID
        odd = labels[1::2]
        keep = (np.arange(labels.shape[1]) > dn)[None, :] | (odd == self.eos_id)
        out[1::2] = np.where(keep, odd, LABEL_PAD_ID)
        return out

    def __call__(self, graph: Graph, rng: np.random.Generator) -> TokenizedSample:
        sample = super().__call__(graph, rng)
        if self.task_type in ("pretrain-mlm", "pretrain-cl") and sample.labels.ndim == 2:
            sample.labels = self.pad_stacked_labels(sample.labels)
        return sample


def _polynomial_mask_ratio(mlm_cfg, rng: np.random.Generator) -> Tuple[float, float]:
    """Draw (alpha_t, dlm_wgt) from the SMTP schedule
    (reference tokenizer_utils.py:254-277)."""
    import math

    name = mlm_cfg.name
    if name == "fixed":
        return float(mlm_cfg.fixed_ratio), 1.0
    if name == "polynomial":
        power = float(mlm_cfg.power)
        umr_min, umr_max = mlm_cfg.umr_clip
        t = umr_min + (umr_max - umr_min) * float(rng.random())
        return 1.0 - t**power, power / t
    # cosine
    return math.cos(float(rng.random()) * math.pi) * 0.5 + 0.5, 1.0


def mask_packed_row(
    sample: TokenizedSample,
    mask_token_id: int,
    mlm_cfg,
    rng: np.random.Generator,
    vocab_size: int,
) -> TokenizedSample:
    """SMTP masking of an already packed row of clean ids with ONE mask-ratio
    draw shared by all its segments (the reference's packed-sequence
    semantics, tokenizer_utils.py:282-325); padding rows get no label."""
    alpha_t, wgt = _polynomial_mask_ratio(mlm_cfg, rng)
    ids = sample.input_ids
    masked, labels = smtp_mask_stacked(
        ids if ids.ndim == 2 else ids[:, None], mask_token_id, alpha_t, rng,
        mtp=tuple(mlm_cfg.mtp), vocab_size=vocab_size,
    )
    if ids.ndim == 1:  # a flat row, masked as one column (the JAX function takes [P, F] only)
        masked, labels = masked[:, 0], labels[:, 0]
    pad = ids[..., 0] == PAD_ID if ids.ndim == 2 else ids == PAD_ID
    labels = np.where(pad[..., None] if labels.ndim == 2 else pad, LABEL_PAD_ID, labels)
    return TokenizedSample(
        input_ids=masked,
        labels=labels,
        position_ids=sample.position_ids,
        attention_mask=sample.attention_mask,
        wgt=float(wgt) if mlm_cfg.dlm_wgt else None,
        segment_lengths=sample.segment_lengths,
        extras=sample.extras,
    )


def smtp_mask_stacked(
    input_ids: np.ndarray,
    mask_token_id: int,
    alpha_t: float,
    rng: np.random.Generator,
    mtp: Tuple[float, float, float] = (1.0, 0.0, 0.0),
    vocab_size: int = 0,
    pad_token_id: int = PAD_ID,
) -> Tuple[np.ndarray, np.ndarray]:
    """Global element-wise SMTP masking over the [P, F] grid (reference
    `_mask_stacked_input_ids_v2`, tokenizer_utils.py:112-148): exactly
    ceil(P*F*alpha) cells are chosen without replacement; the chosen cells
    become labels, and the non-pad ones are replaced by [mask], a random
    token or kept, per the mtp split."""
    p, f = input_ids.shape
    total = p * f
    k = int(np.ceil(total * alpha_t))
    flat = input_ids.reshape(-1)
    chosen = rng.choice(total, size=min(k, total), replace=False)
    labels = np.full(total, LABEL_PAD_ID, np.int32)
    labels[chosen] = flat[chosen]
    new_flat = flat.copy()
    maskable = chosen[flat[chosen] != pad_token_id]
    r_mask, r_rand, _ = mtp
    if r_rand > 0:
        u = rng.random(len(maskable))
        to_mask = maskable[u < r_mask]
        to_rand = maskable[(u >= r_mask) & (u < r_mask + r_rand)]
        new_flat[to_mask] = mask_token_id
        new_flat[to_rand] = rng.integers(1, vocab_size, size=len(to_rand))
    else:
        new_flat[maskable] = mask_token_id
    return new_flat.reshape(p, f), labels.reshape(p, f)
