"""The flat (non-stacked) GST tokenizer: one token per structural or
attribute item.

A copy of `graphgpt_tpu/data/gst_tokenizer.py` (reference GSTTokenizer,
src/data/tokenizer.py:428-535): the Euler walk, two-level cyclic node
re-indexing (a `k*base` high token before the low one past `scope_base`),
edge-type tokens (`<edge_bi>` left out under `remove_edge_type_token`),
attribute tokens inline where the `attr_assignment` occurrence mask says
(`occurrence_mask`, first/last/random/all/mix), continuous attributes as an
identifier and digit tokens, next-token labels with `<new>` for a node id
not seen before under random re-indexing (cyclic 2), the labels of
`label_tokens_to_pad` padded, cyclic position ids (a cumsum over node-idx,
eos, jump and gsum tokens; they repeat inside a row), and the structure and
instruction streams of `data/structure_tasks.py` (`_aux_streams`). Every
task branch of `__call__` (:313-502): pretrain, pretrain-ltp (the last
label only), pretrain-euler (the supervision gate, :226), pretrain-mlm,
pretrain-cl (masking, a trailing `<gsum>`), graph, node, edge and nodev2.
`tokenize_ids` is a Python loop over the tokens, as in the JAX package.
Numpy only: the loader's spawned workers import this module.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import numpy as np

from ..config import TokenizationConfig
from . import euler
from .graph import Graph
from .tokenizer import AttrColumnLookup, TokenizedSample, _polynomial_mask_ratio
from .vocab import LABEL_PAD_ID

PAD_ID = 0


def occurrence_mask(keys: List, mode: str, rng: np.random.Generator) -> np.ndarray:
    """1 where this occurrence of a key gets its attributes."""
    if mode == "mix":
        mode = ("first", "last", "random")[rng.integers(3)]
    positions: Dict = {}
    for i, k in enumerate(keys):
        positions.setdefault(k, []).append(i)
    mask = np.zeros(len(keys), np.int8)
    for occ in positions.values():
        if mode == "first":
            mask[occ[0]] = 1
        elif mode == "last":
            mask[occ[-1]] = 1
        elif mode == "random":
            mask[occ[rng.integers(len(occ))]] = 1
        else:  # all
            mask[occ] = 1
    return mask


class GSTTokenizer:
    """Flat graph-sequence tokenizer: each sample is a [P] id stream."""

    def __init__(
        self,
        cfg: TokenizationConfig,
        vocab_map: Dict[str, int],
        task_type: str = "pretrain",
        mlm_cfg=None,
        num_intra_cls: int = 0,
    ):
        self.cfg = cfg
        self.vocab_map = vocab_map
        self.task_type = task_type
        self.mlm_cfg = mlm_cfg
        self.vocab_size = max(vocab_map.values()) + 1
        s = cfg.structure
        self.scope = s.node.node_scope
        self.base = s.node.scope_base
        self.cyclic = int(s.node.cyclic)
        self.eos_id = vocab_map[s.node.eos_token]
        self.bos_id = vocab_map[s.node.bos_token]
        self.mask_id = vocab_map[s.mask_token]
        self.gsum_id = vocab_map.get(s.summary_token, 0)
        self.new_node_id = vocab_map.get(s.node.new_node_token, LABEL_PAD_ID)
        self.jump_id = vocab_map[s.edge.jump_token]
        self.edge_type_ids = np.asarray(  # indexed by euler.EDGE_* codes
            [vocab_map[s.edge.jump_token], vocab_map[s.edge.in_token],
             vocab_map[s.edge.out_token], vocab_map[s.edge.bi_token]], np.int32)
        self.bi_id = vocab_map[s.edge.bi_token]
        self.remove_bi = s.edge.remove_edge_type_token
        # low structural idx tokens, and the high k*base tokens
        self.low_ids = np.asarray([vocab_map[str(i)] for i in range(self.base)], np.int32)
        high = int(math.ceil(self.scope / self.base))
        self.high_ids = np.asarray(
            [0] + [vocab_map[f"{k}*{self.base}"] for k in range(1, high)], np.int32)
        self.node_idx_token_ids = set(self.low_ids.tolist())
        sem = cfg.semantics
        world = cfg.attr_world_identifier
        self.node_dim = sem.node.dim if sem.node.discrete else 0
        self.edge_dim = sem.edge.dim if sem.edge.discrete else 0
        self.node_lookup = (
            AttrColumnLookup(vocab_map, world, "node", self.node_dim, sem.node.share_vocab)
            if self.node_dim else None)
        self.edge_lookup = (
            AttrColumnLookup(vocab_map, world, "edge", self.edge_dim, sem.edge.share_vocab)
            if self.edge_dim else None)
        self.node_ignored = sem.node.ignored_val
        self.edge_ignored = sem.edge.ignored_val
        self.label_pad_ids = {vocab_map[t] for t in cfg.label_tokens_to_pad if t in vocab_map}
        # continuous attributes: a column identifier token, then digit tokens
        # (reference _tokenize_continuous_attr, tokenizer.py:729-756)
        self.node_cont_field = sem.node.continuous
        self.edge_cont_field = sem.edge.continuous
        self.digit_ids = {
            ch: vocab_map[f"<{ch}>"] for ch in "0123456789.-e" if f"<{ch}>" in vocab_map}
        self.node_cont_ident = [vocab_map.get(f"{world}#node#{c}#1", 0)
                                for c in range(sem.node.dim)]
        self.edge_cont_ident = [vocab_map.get(f"{world}#edge#{c}#1", 0)
                                for c in range(sem.edge.dim)]
        # intra-instance class tokens for nodev2 token_ce_intra (reference
        # reserved semantics tokens, tokenizer_utils.py:729-748)
        self.num_intra_cls = num_intra_cls
        self.intra_cls_token_ids = [
            vocab_map[t] for t in sem.reserved_tokens[:num_intra_cls] if t in vocab_map]
        if num_intra_cls > 0 and len(self.intra_cls_token_ids) != num_intra_cls:
            raise ValueError(
                f"num_intra_cls={num_intra_cls} but only {len(self.intra_cls_token_ids)} "
                "reserved semantics tokens are in the vocab; add the missing reserved tokens "
                "(semantics.reserved_tokens) to the vocab file")

    def _continuous_tokens(self, vals, ident_ids, ignored) -> List[int]:
        """value 380 -> [identifier, <3>, <8>, <0>]; a leading '0.' becomes
        '.' (reference _remove_lead_zero, tokenizer.py:720-726)."""
        out: List[int] = []
        for c, v in enumerate(vals):
            s = str(v)
            if ignored is not None and s == str(ignored):
                continue
            if len(s) > 2 and s[0] == "0" and s[1] == ".":
                s = s[1:]
            out.append(ident_ids[c])
            out.extend(self.digit_ids[ch] for ch in s if ch in self.digit_ids)
        return out

    # ------------------------------------------------------------------
    def _idx_tokens(self, rank: int) -> List[int]:
        hi, lo = divmod(int(rank), self.base)
        if hi > 0:
            return [int(self.high_ids[hi]), int(self.low_ids[lo])]
        return [int(self.low_ids[lo])]

    def tokenize_ids(
        self, graph: Graph, rng: np.random.Generator
    ) -> Tuple[List[int], np.ndarray, np.ndarray, np.ndarray]:
        """(tokens, walk, is_node_idx per token, ranks) of the main stream."""
        walk = euler.graph_to_walk(graph, rng)
        ranks = euler.walk_node_ranks(walk, self.scope, self.cyclic, rng)
        etypes = euler.walk_edge_types(graph, walk)
        erows = euler.walk_edge_attr_rows(graph, walk)
        # the occurrence mask over the interleaved node and edge sequence
        raw_keys: List = []
        for i in range(len(walk)):
            raw_keys.append(("n", int(walk[i])))
            if i < len(walk) - 1:
                a, b = int(walk[i]), int(walk[i + 1])
                raw_keys.append(("e", (min(a, b), max(a, b))))
        mask = occurrence_mask(raw_keys, self.cfg.semantics.attr_assignment, rng)

        node_attr_ids = self.node_lookup(graph.node_attr) if self.node_dim else None
        tokens: List[int] = []
        is_node_idx: List[bool] = []

        def emit(tok: int, node_like: bool = False):
            tokens.append(int(tok))
            is_node_idx.append(node_like)

        mi = 0
        for i in range(len(walk)):
            for t in self._idx_tokens(ranks[i]):
                emit(t, node_like=True)
            if mask[mi] and self.node_dim:
                cols = list(range(self.node_dim))
                if self.cfg.semantics.attr_shuffle:
                    rng.shuffle(cols)
                for c in cols:
                    val = graph.node_attr[walk[i], c]
                    if self.node_ignored is not None and int(val) == int(self.node_ignored):
                        continue
                    emit(node_attr_ids[walk[i], c])
            if mask[mi] and self.node_cont_field is not None:
                arr = getattr(graph, self.node_cont_field, None)
                if arr is None:
                    arr = graph.extra.get(self.node_cont_field)
                for t in self._continuous_tokens(arr[walk[i]], self.node_cont_ident,
                                                 self.node_ignored):
                    emit(t)
            mi += 1
            if i < len(walk) - 1:
                et = etypes[i]
                if not (self.remove_bi and et == euler.EDGE_BI):
                    emit(self.edge_type_ids[et])
                if mask[mi] and self.edge_dim and erows[i] >= 0:
                    eattr = self.edge_lookup(graph.edge_attr[erows[i]][None, :])[0]
                    for c in range(self.edge_dim):
                        val = graph.edge_attr[erows[i], c]
                        if self.edge_ignored is not None and int(val) == int(self.edge_ignored):
                            continue
                        emit(eattr[c])
                mi += 1
        return tokens, walk, np.asarray(is_node_idx), ranks

    def euler_gate_labels(self, labels: List[int]) -> List[int]:
        """The pretrain-euler supervision gate (reference
        prepare_inputs_for_last_token_pred_in_pretrain,
        tokenizer_utils.py:478-500): position i is supervised once two
        consecutive padded labels have been seen; an eos label closes the
        window."""
        out = [LABEL_PAD_ID] * len(labels)
        flag = 0
        for i in range(2, len(labels)):
            if labels[i - 1] == LABEL_PAD_ID and labels[i - 2] == LABEL_PAD_ID:
                flag = 1
            if labels[i - 1] == self.eos_id:
                flag = 0
            if flag:
                out[i] = labels[i]
        return out

    def labels_for(self, tokens: List[int]) -> List[int]:
        """Next-token labels ending in eos; under random re-indexing a node
        token not seen before becomes <new> (nx_utils.py:615-630)."""
        labels = tokens[1:] + [self.eos_id]
        if self.cyclic == 2:
            seen: set = set()
            for i, lab in enumerate(labels):
                if lab in self.node_idx_token_ids and lab not in seen:
                    labels[i] = self.new_node_id
                seen.add(tokens[i])
        if self.label_pad_ids:
            labels = [LABEL_PAD_ID if t in self.label_pad_ids else t for t in labels]
        return labels

    def position_ids_for(self, tokens: List[int], is_node_idx: np.ndarray, rng) -> np.ndarray:
        """Cyclic rows: a cumsum over the node-idx, eos, jump and gsum tokens
        (tokenizer.py:674-677), so ids repeat inside a row; else 0..n-1."""
        if self.cyclic:
            special = {self.eos_id, self.jump_id, self.gsum_id}
            tf = np.asarray([1 if (flag or t in special) else 0
                             for t, flag in zip(tokens, is_node_idx)], np.int64)
            return (np.cumsum(tf) - 1).clip(0).astype(np.int32)
        return np.arange(len(tokens), dtype=np.int32)

    def _aux_streams(self, graph, walk, ranks, rng):
        """The structure and instruction streams appended after the main
        stream (tokenizer.py:498-523)."""
        tokens: list = []
        labels: list = []
        nx_funcs = list(self.cfg.structure.nx_funcs)
        inst_funcs = list(self.cfg.semantics.instruct_funcs)
        node_token_ids = None
        if nx_funcs or inst_funcs:
            # raw node -> its low structure token under this walk's re-indexing
            node_token_ids = np.zeros(graph.num_nodes, np.int32)
            node_token_ids[walk] = self.low_ids[np.asarray(ranks) % self.base]
        if nx_funcs:
            from .structure_tasks import structure_task_tokens

            t, lab = structure_task_tokens(graph, nx_funcs, node_token_ids, self.cfg,
                                           self.vocab_map, self.eos_id, rng)
            tokens += t
            labels += lab
        if inst_funcs:
            from .structure_tasks import instruction_tokens

            t, lab = instruction_tokens(graph, inst_funcs, self.cfg, self.vocab_map, self.eos_id,
                                        rng, node_token_ids=node_token_ids)
            tokens += t
            labels += lab
        return tokens, labels

    def _sample(self, tokens, labels, flags, rng, **kw) -> TokenizedSample:
        n = len(tokens)
        return TokenizedSample(
            input_ids=np.asarray(tokens, np.int32),
            labels=(np.asarray(labels, np.int32) if labels is not None
                    else np.full(n, LABEL_PAD_ID, np.int32)),
            position_ids=self.position_ids_for(tokens, flags, rng),
            attention_mask=np.ones(n, np.int8), segment_lengths=[n], **kw)

    # ------------------------------------------------------------------
    def __call__(self, graph: Graph, rng: np.random.Generator) -> TokenizedSample:
        tokens, walk, is_node_idx, ranks = self.tokenize_ids(graph, rng)
        task = self.task_type
        if task in ("pretrain", "pretrain-ltp", "pretrain-euler"):
            labels = self.labels_for(tokens)
            if task == "pretrain-ltp":
                labels = [LABEL_PAD_ID] * (len(labels) - 1) + labels[-1:]
            extra_t, extra_l = self._aux_streams(graph, walk, ranks, rng)
            if extra_t:
                tokens = tokens + extra_t
                labels = labels + extra_l
                is_node_idx = np.concatenate([is_node_idx, np.zeros(len(extra_t), bool)])
            if self.label_pad_ids:
                # over the whole stream, the appended streams included
                # (reference tokenizer.py:536-556)
                labels = [LABEL_PAD_ID if t in self.label_pad_ids else t for t in labels]
            if task == "pretrain-euler":
                # over the whole stream: the double-<label_pad> marker lies at
                # the boundary of the main and the instruction streams
                labels = self.euler_gate_labels(labels)
            return self._sample(tokens, labels, is_node_idx, rng)
        if task in ("pretrain-mlm", "pretrain-cl"):
            # flat BERT-style masking (tokenizer_utils._mask_input_ids:175-203)
            tokens = tokens + [self.eos_id]
            ids = np.asarray(tokens, np.int32)
            alpha_t, wgt = _polynomial_mask_ratio(self.mlm_cfg, rng)
            n = len(tokens)
            k = int(np.ceil(n * alpha_t))
            chosen = rng.choice(n, size=min(k, n), replace=False)
            labels = np.full(n, LABEL_PAD_ID, np.int32)
            labels[chosen] = ids[chosen]
            masked = ids.copy()
            masked[chosen] = self.mask_id
            flags = np.append(is_node_idx, True)
            if task == "pretrain-cl":
                # a trailing <gsum> pools the contrastive embedding, its label
                # padded (reference _add_gsum_tokens_for_cl, tokenizer_utils.py:366-387)
                masked = np.append(masked, np.int32(self.gsum_id))
                labels = np.append(labels, np.int32(LABEL_PAD_ID))
                tokens = tokens + [self.gsum_id]
                flags = np.append(flags, True)
                n += 1
            return TokenizedSample(
                input_ids=masked,
                labels=labels,
                position_ids=self.position_ids_for(tokens, flags, rng),
                attention_mask=np.ones(n, np.int8),
                wgt=float(wgt) if (self.mlm_cfg and self.mlm_cfg.dlm_wgt) else None,
                segment_lengths=[n],
            )
        if task == "graph":
            tokens = tokens + [self.eos_id, self.gsum_id]
            return self._sample(tokens, None, np.concatenate([is_node_idx, [True, True]]), rng,
                                graph_labels=np.asarray(graph.y, np.float32).reshape(-1))
        if task == "node":
            root = int(np.asarray(graph.root_n_id).reshape(-1)[0])
            tgt_tokens = self._idx_tokens(ranks[int(np.flatnonzero(walk == root)[0])])
            tokens = tokens + [self.eos_id] + tgt_tokens
            y = np.asarray(graph.y).reshape(graph.num_nodes, -1)[root]
            return self._sample(tokens, None,
                                np.concatenate([is_node_idx, [True] * (1 + len(tgt_tokens))]),
                                rng, node_labels=np.asarray(y, np.float32).reshape(-1))
        if task == "edge":
            # the two seed nodes' idx tokens after eos, in a random order
            # (reference prepare_inputs_for_edge_lvl_task, tokenizer_utils.py:570-633)
            root = np.atleast_1d(np.asarray(graph.root_n_id)).reshape(-1)
            assert len(root) == 2, "edge task needs two seed nodes"
            pair = [self._idx_tokens(ranks[int(np.flatnonzero(walk == r)[0])]) for r in root]
            if rng.random() < 0.5:
                pair = pair[::-1]
            tgt_tokens = [t for seg in pair for t in seg]
            tokens = tokens + [self.eos_id] + tgt_tokens
            extras = {}
            if "eval_group" in graph.extra:
                extras["eval_group"] = np.asarray(graph.extra["eval_group"], np.int64)
            return self._sample(tokens, None,
                                np.concatenate([is_node_idx, [True] * (1 + len(tgt_tokens))]),
                                rng, edge_labels=np.asarray(graph.y, np.float32).reshape(-1),
                                wgt=graph.wgt, extras=extras)
        if task == "nodev2":
            # token-level node classification: each node's label on the last
            # (low) token of its first idx encoding; optional intra-instance
            # class tokens and cls_idx (reference
            # prepare_inputs_for_node_v2_token_lvl_task, tokenizer_utils.py:688-748)
            y = (np.asarray(graph.y).reshape(graph.num_nodes, -1)[:, 0]
                 if graph.y is not None else np.full(graph.num_nodes, LABEL_PAD_ID))
            n0 = len(tokens)
            nodev2 = np.full(n0, LABEL_PAD_ID, np.int64)
            raw_node_idx = np.full(n0, LABEL_PAD_ID, np.int64)
            # each walk step emits one or two idx tokens (hi, lo)
            tok_pos = np.flatnonzero(is_node_idx)
            step_last: List[int] = []
            cursor = 0
            for r in ranks:
                ntok = 2 if int(r) >= self.base else 1
                step_last.append(int(tok_pos[cursor + ntok - 1]))
                cursor += ntok
            seen: set = set()
            for i, node in enumerate(walk):
                node = int(node)
                if node not in seen:
                    seen.add(node)
                    nodev2[step_last[i]] = int(y[node])
                    raw_node_idx[step_last[i]] = node
            extras = {"nodev2_labels": nodev2, "raw_node_idx": raw_node_idx}
            if self.num_intra_cls > 0:
                order = rng.permutation(self.num_intra_cls)
                cls_ids = [self.intra_cls_token_ids[k] for k in order]
                extras["cls_perm"] = np.argsort(order).astype(np.int64)
                extras["cls_idx"] = np.asarray([n0], np.int64)
                tokens = tokens + cls_ids
                pad = np.full(len(cls_ids), LABEL_PAD_ID, np.int64)
                extras["nodev2_labels"] = np.concatenate([nodev2, pad])
                extras["raw_node_idx"] = np.concatenate([raw_node_idx, pad])
                is_node_idx = np.concatenate([is_node_idx, np.ones(len(cls_ids), bool)])
            return self._sample(tokens, None, is_node_idx, rng, extras=extras)
        raise NotImplementedError(f"GSTTokenizer task {task!r}")
