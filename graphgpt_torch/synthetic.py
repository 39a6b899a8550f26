"""Synthetic packed SMTP batches (numpy), for the tests and `chip_smoke.py`.

A copy of the JAX package entry module's `_packed_segments` and `_fake_batch`
(`__graft_entry__.py:66, :96`) that returns numpy arrays: PCQM4M-v2 SMTP
rows pack ~31 molecule sequences (mean ~32 tokens, p10/p90 = 11/55) into
each mpe-1024 row.
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
