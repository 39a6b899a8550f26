"""Batching: packing, bucketed static-shape padding and segment ids.

A copy of `graphgpt_tpu/data/collator.py`'s `collate`, `bucket_length` and
`pack_samples` (greedy, or block-aligned best-fit with `block=`):
sequences are packed into rows of mpe tokens or padded to a multiple of
`bucket` (capped at mpe) or to a fixed length, and each row carries
`segment_ids` (1.. per segment, 0 on padding) for the attention kernels.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
import warnings
from typing import Dict, Iterator, List, Optional, Sequence

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


def pack_samples(
    sample_iter: Iterator[TokenizedSample],
    mpe: int,
    max_segments: int = 0,
    block: int = 0,
    lookahead: int = 64,
) -> Iterator[TokenizedSample]:
    """Greedily pack consecutive samples into rows of exactly `mpe` tokens.

    Each tokenized sample ends with its eos row, so packing is plain
    concatenation (reference tokenizer.py:359-415). A sample that would
    overflow the row starts the next row; overlong samples are truncated to
    mpe.

    block > 0: block-aligned packing. No sample crosses a `block`-token
    boundary inside the row, so attention factorises into [block]-wide
    windows (ops/attention.py attn_block). When the next sample does not fit
    the current block's remainder, the largest pending sample that fits is
    taken from a `lookahead` buffer; if none fits, the remainder is padded
    (segment id 0). A sample longer than `block` is head-truncated to one
    block, with a warning the first time.
    """
    if block <= 0:
        buf: List[TokenizedSample] = []
        used = 0
        for s in sample_iter:
            n = min(s.seq_len, mpe)
            if used + n > mpe and buf:
                yield _merge_packed(buf, mpe)
                buf, used = [], 0
            buf.append(s)
            used += n
            if used >= mpe or (max_segments and len(buf) >= max_segments):
                yield _merge_packed(buf, mpe)
                buf, used = [], 0
        if buf:
            yield _merge_packed(buf, mpe)
        return
    assert mpe % block == 0, (mpe, block)
    pending: List[TokenizedSample] = []
    pieces: List[object] = []  # TokenizedSample or int (pad gap length)
    used = 0
    it = iter(sample_iter)
    exhausted = False
    truncated = 0

    def _fill():
        nonlocal exhausted
        while not exhausted and len(pending) < lookahead:
            try:
                pending.append(next(it))
            except StopIteration:
                exhausted = True

    def _take_best(space: int):
        """Largest pending sample fitting `space` (best-fit decreasing)."""
        best, best_n = -1, 0
        for j, s in enumerate(pending):
            n = min(s.seq_len, block)
            if best_n < n <= space:
                best, best_n = j, n
        return pending.pop(best) if best >= 0 else None

    while True:
        _fill()
        if not pending:
            break
        space = block - (used % block) if used % block else block
        s = _take_best(space)
        if s is None:
            pieces.append(space)  # nothing fits the remainder: pad the block
            used += space
        else:
            if s.seq_len > block:
                truncated += 1
                if truncated == 1:
                    warnings.warn(
                        f"pack_samples(block={block}): sample of {s.seq_len} tokens "
                        "head-truncated to one block; raise pack_block above the longest "
                        "sample to avoid truncation", stacklevel=2)
            pieces.append(s)
            used += min(s.seq_len, block)
        if used >= mpe:
            yield _merge_packed_pieces(pieces, mpe, block)
            pieces, used = [], 0
    if pieces:
        yield _merge_packed_pieces(pieces, mpe, block)


def _merge_packed_pieces(pieces: List[object], mpe: int, block: int) -> TokenizedSample:
    """One row from a block-aligned piece list (samples and int pad gaps);
    gaps become PAD_ID rows with segment id 0 (negative entries in
    segment_lengths, see collate)."""
    ids_parts, label_parts, seg_lengths, wgts = [], [], [], []
    used = 0
    proto = next(p for p in pieces if not isinstance(p, int))
    for p in pieces:
        if isinstance(p, int):
            n = min(p, mpe - used)
            if n <= 0:
                break
            pad_shape = (n,) + proto.input_ids.shape[1:]
            ids_parts.append(np.full(pad_shape, PAD_ID, proto.input_ids.dtype))
            label_parts.append(np.full(pad_shape, LABEL_PAD_ID, proto.labels.dtype))
            seg_lengths.append(-n)
            used += n
        else:
            n = min(p.seq_len, block, mpe - used)
            if n <= 0:
                break
            ids_parts.append(p.input_ids[:n])
            label_parts.append(p.labels[:n])
            seg_lengths.append(n)
            used += n
            if p.wgt is not None:
                wgts.append(p.wgt)
    ids = np.concatenate(ids_parts, axis=0)[:mpe]
    labels = np.concatenate(label_parts, axis=0)[:mpe]
    n_row = ids.shape[0]
    return TokenizedSample(
        input_ids=ids,
        labels=labels,
        position_ids=np.arange(n_row, dtype=np.int32),
        attention_mask=np.ones(n_row, np.int8),
        wgt=float(np.mean(wgts)) if wgts else None,
        segment_lengths=seg_lengths,
    )


def _merge_packed(samples: List[TokenizedSample], mpe: int) -> TokenizedSample:
    ids = np.concatenate([s.input_ids for s in samples], axis=0)[:mpe]
    labels = np.concatenate([s.labels for s in samples], axis=0)[:mpe]
    seg_lengths = []
    remaining = mpe
    for s in samples:
        n = min(s.seq_len, remaining)
        if n <= 0:
            break
        seg_lengths.append(n)
        remaining -= n
    p = ids.shape[0]
    wgts = [s.wgt for s in samples if s.wgt is not None]
    return TokenizedSample(
        input_ids=ids,
        labels=labels,
        position_ids=np.arange(p, dtype=np.int32),
        attention_mask=np.ones(p, np.int8),
        wgt=float(np.mean(wgts)) if wgts else None,
        segment_lengths=seg_lengths,
    )
