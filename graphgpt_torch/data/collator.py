"""Batching: bucketed static-shape padding and segment ids.

A copy of `graphgpt_tpu/data/collator.py`'s `collate` and `bucket_length`:
sequences are padded to a multiple of `bucket` (capped at mpe) or to a
fixed length, and each row carries `segment_ids` (1.. per segment, 0 on
padding) for the attention kernels. Packing waits for the pretrain slice.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence

import numpy as np

from .tokenizer import PAD_ID, TokenizedSample
from .vocab import LABEL_PAD_ID


def _pad_rows(arr: np.ndarray, length: int, value) -> np.ndarray:
    if arr.shape[0] >= length:
        return arr[:length]
    pad_shape = (length - arr.shape[0],) + arr.shape[1:]
    return np.concatenate([arr, np.full(pad_shape, value, arr.dtype)], axis=0)


def bucket_length(lengths: Sequence[int], bucket: int, mpe: int) -> int:
    """Round max length up to a multiple of `bucket`, capped at mpe
    (reference _get_batch_seq_len, tokenizer.py:627-636)."""
    longest = max(lengths)
    return min(bucket * int(math.ceil(longest / bucket)), mpe)


@dataclass
class Batch:
    """Dict-like container of padded numpy arrays ready for device put."""

    data: Dict[str, np.ndarray]

    def __getitem__(self, key):
        return self.data[key]

    def __contains__(self, key):
        return key in self.data

    def keys(self):
        return self.data.keys()


def collate(
    samples: List[TokenizedSample],
    mpe: int = 1024,
    bucket: int = 8,
    fixed_length: Optional[int] = None,
) -> Batch:
    """Pad a list of tokenized samples into one batch.

    Samples longer than the target keep their head and their trailing tail
    row (the eos/task rows live at the end; reference keeps task tails via
    negative eos_idx, tokenizer.py:341-356). For pretrain the tail is just
    eos, so head-truncation matches the reference's slicing.
    """
    pad_to = fixed_length or bucket_length([s.seq_len for s in samples], bucket, mpe)
    stacked = samples[0].input_ids.ndim == 2

    def trunc(arr, value):
        if arr.shape[0] > pad_to:
            # keep head and the final (task/eos) row
            return np.concatenate([arr[: pad_to - 1], arr[-1:]], axis=0)
        return _pad_rows(arr, pad_to, value)

    out: Dict[str, np.ndarray] = {}
    out["input_ids"] = np.stack([trunc(s.input_ids, PAD_ID) for s in samples])
    out["labels"] = np.stack([trunc(s.labels, LABEL_PAD_ID) for s in samples])
    out["position_ids"] = np.stack(
        [trunc(s.position_ids, 0) for s in samples]
    ).astype(np.int32)
    out["attention_mask"] = np.stack(
        [trunc(s.attention_mask, 0) for s in samples]
    ).astype(np.int8)
    # segment ids: 1.. per packed segment, 0 on padding; negative entries in
    # segment_lengths encode in-row padding gaps (block-aligned packing)
    seg_rows = []
    for s in samples:
        if s.segment_lengths is not None and len(s.segment_lengths) > 1:
            parts = []
            sid = 1
            for n in s.segment_lengths:
                if n < 0:
                    parts.append(np.zeros(-n, np.int32))
                else:
                    parts.append(np.full(n, sid, np.int32))
                    sid += 1
            seg = np.concatenate(parts)[: s.seq_len]
        else:
            seg = np.ones(s.seq_len, np.int32)
        seg_rows.append(trunc(seg, 0))
    out["segment_ids"] = np.stack(seg_rows)

    if samples[0].wgt is not None:
        out["wgt"] = np.asarray([s.wgt for s in samples], np.float32)
    for key in ("graph_labels", "node_labels", "edge_labels"):
        vals = [getattr(s, key) for s in samples]
        if vals[0] is not None:
            out[key] = np.stack(vals).astype(np.float32)
    for k in samples[0].extras:
        vals = [s.extras[k] for s in samples]
        if vals[0].ndim >= 1 and vals[0].shape[0] == samples[0].seq_len:
            # label-like extras pad with -100; gather indices must pad with 0
            pad_val = LABEL_PAD_ID if ("label" in k or k == "raw_node_idx") else 0
            out[k] = np.stack([trunc(s.extras[k], pad_val) for s in samples])
        else:  # per-sample scalar-ish extras (e.g. cls_idx, cls_perm)
            out[k] = np.stack(vals)
    return Batch(out)
