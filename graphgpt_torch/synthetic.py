"""Synthetic batches (numpy), for the tests and `chip_smoke.py`.

A copy of the JAX package entry module's `_packed_segments` and `_fake_batch`
(`__graft_entry__.py:66, :96`) that returns numpy arrays: PCQM4M-v2 SMTP
rows pack ~31 molecule sequences (mean ~32 tokens, p10/p90 = 11/55) into
each mpe-1024 row. And `mol3d_batch`: one synthetic molecule a row with
the 3D fields that the denoise and position-pretraining models read.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch


def packed_segments(b: int, p: int, rng, mean_len: int = 32, block: int = 0) -> np.ndarray:
    """[B, P] int32 segment ids: consecutive segments of uniform length in
    [mean_len/2, 2*mean_len); block > 0 keeps segments inside block-aligned
    windows, padding the unfillable remainder of each block."""
    seg = np.zeros((b, p), np.int32)
    for r in range(b):
        pos, sid = 0, 1
        while pos < p:
            ln = int(rng.integers(mean_len // 2, mean_len * 2))
            if block:
                space = block - (pos % block) if pos % block else block
                if ln > space:
                    if space >= mean_len // 2:
                        ln = int(rng.integers(mean_len // 2, space + 1))
                    else:
                        pos += space
                        continue
            ln = min(ln, p - pos)
            seg[r, pos : pos + ln] = sid
            pos += ln
            sid += 1
    return seg


def fake_batch(b, p, f, vocab, rng) -> Dict[str, np.ndarray]:
    """input_ids [B, P, F], labels (half the real cells, else -100),
    position_ids, packed segment_ids and per-row weights, as numpy arrays."""
    ids = rng.integers(2, vocab, size=(b, p, f)).astype(np.int32)
    labels = np.where(rng.random((b, p, f)) < 0.5, ids, -100).astype(np.int32)
    seg = packed_segments(b, p, rng)
    labels = np.where((seg > 0)[..., None], labels, -100)
    return {
        "input_ids": np.where((seg > 0)[..., None], ids, 0).astype(np.int32),
        "labels": labels.astype(np.int32),
        "position_ids": np.tile(np.arange(p, dtype=np.int32), (b, 1)),
        "segment_ids": seg,
        "wgt": np.ones((b,), np.float32),
    }


def to_torch(batch: Dict[str, np.ndarray], device) -> Dict[str, torch.Tensor]:
    return {k: torch.as_tensor(v, device=device) for k, v in batch.items()}


def mol3d_tokenizer():
    """The stacked tokenizer of the synthetic molecules (PCQM4M-v2's schema:
    9 node and 3 edge attributes; 13 stacked features, vocab 755)."""
    from .config import TokenizationConfig
    from .data import vocab as vocab_mod
    from .data.datasets import MOL_EDGE_CARD, MOL_NODE_CARD
    from .data.tokenizer import StackedGSTTokenizer

    cfg = TokenizationConfig()
    cfg.semantics.node.discrete, cfg.semantics.node.dim = "node_attr", 9
    cfg.semantics.edge.discrete, cfg.semantics.edge.dim = "edge_attr", 3
    vocab = vocab_mod.build_vocab(cfg, [np.arange(c) for c in MOL_NODE_CARD],
                                  [np.arange(c) for c in MOL_EDGE_CARD])
    return StackedGSTTokenizer(cfg, vocab_mod.vocab_map_from_list(vocab), task_type="graph")


def mol3d_batch(b: int, p: int, seed: int = 0, bi_split: int = 0,
                tokenizer=None) -> Dict[str, np.ndarray]:
    """[B, P] rows of `synthetic_mol` molecules with 3D fields, the fields
    of the JAX package's 3D batches: input_ids [B, P, F], position_ids,
    segment_ids, pos_type (0 pad, 1-4 by the anchor rotation's rule),
    node_idx (raw node index + 1, 0 off the nodes), pos [B, P, 3] and
    graph_labels [B, 1]. One molecule a row, at the front, in segment 1
    (cut to fit), with its Euler walk's eos row; coordinates from the seed,
    anchor-rotated and clipped into DICT_RANGE["p1p"]; padding (segment 0)
    after it. With bi_split > 0 the last bi_split positions of the row are
    the energy-bit slots: segment 1, the [mask] token in every feature,
    pos_type 0, position ids continuing the molecule's."""
    from .data import mol3d
    from .data.datasets import SyntheticMolDataset

    tok = tokenizer if tokenizer is not None else mol3d_tokenizer()
    ds = SyntheticMolDataset(b, seed=seed, with_pos=True)
    rng = np.random.default_rng(seed)
    lo, hi = mol3d.DICT_RANGE["p1p"]
    f, room = tok.stacked_feat, p - bi_split
    out = {
        "input_ids": np.zeros((b, p, f), np.int32),
        "position_ids": np.zeros((b, p), np.int32),
        "segment_ids": np.zeros((b, p), np.int32),
        "pos_type": np.zeros((b, p), np.int32),
        "node_idx": np.zeros((b, p), np.int32),
        "pos": np.zeros((b, p, 3), np.float32),
        "graph_labels": np.zeros((b, 1), np.float32),
    }
    for r in range(b):
        g = ds[r]
        ids, walk, _ = tok.tokenize(g, rng)
        n = min(ids.shape[0], room)
        raw = np.concatenate([walk, [-1]])[:n]  # -1: the eos row
        coords = np.clip(mol3d.anchor_rotate(g.pos), lo, hi)
        out["input_ids"][r, :n] = ids[:n]
        out["position_ids"][r, :n] = np.arange(n)
        out["segment_ids"][r, :n] = 1
        out["pos_type"][r, :n] = mol3d.pos_type_from_node_index(raw)
        out["node_idx"][r, :n] = raw + 1
        out["pos"][r, :n] = np.where((raw >= 0)[:, None], coords[np.maximum(raw, 0)], 0.0)
        out["graph_labels"][r] = g.y[0]
        if bi_split:
            out["input_ids"][r, room:] = tok.mask_id
            out["position_ids"][r, room:] = np.arange(n, n + bi_split)
            out["segment_ids"][r, room:] = 1
    return out
