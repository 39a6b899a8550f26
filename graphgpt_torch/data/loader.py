"""Host-side input pipeline in one process: tokenization, padding and a
background prefetch thread.

A copy of `graphgpt_tpu/data/loader.py`'s `GraphTokenLoader` without the
worker pool and the packing (both wait for the pretrain slice). Each
sample's tokenization RNG is seeded by (seed, epoch, idx, position), as
there, so the two loaders give the same batches for the same indices.
"""

from __future__ import annotations

import queue
import threading
from typing import Iterator, List, Optional

import numpy as np

from .collator import Batch, collate
from .tokenizer import TokenizedSample


PREFETCH = 4  # batches the producer thread runs ahead


class GraphTokenLoader:
    """Iterates batches of one graph per row for one epoch, each padded to
    a multiple of `bucket` (capped at mpe)."""

    def __init__(self, dataset, tokenizer, batch_size: int, mpe: int = 1024, bucket: int = 64,
                 seed: int = 0):
        self.dataset = dataset
        self.tokenizer = tokenizer
        self.batch_size = batch_size
        self.mpe = mpe
        self.bucket = bucket
        self.seed = seed

    def _sample_stream(self, indices: np.ndarray, epoch: int) -> Iterator[TokenizedSample]:
        for pos, idx in enumerate(indices):
            rng = np.random.default_rng((self.seed, epoch, int(idx), pos))
            yield self.tokenizer(self.dataset[int(idx)], rng)

    def epoch_batches(
        self,
        indices: np.ndarray,
        epoch: int = 0,
        drop_last: bool = True,
        batch_size: Optional[int] = None,
    ) -> Iterator[Batch]:
        """Batches for one pass over `indices`; `drop_last=False` keeps the
        final partial batch (eval passes cover every index)."""
        bs = batch_size or self.batch_size
        buf: List[TokenizedSample] = []
        for s in self._sample_stream(indices, epoch):
            buf.append(s)
            if len(buf) == bs:
                yield collate(buf, mpe=self.mpe, bucket=self.bucket)
                buf = []
        if buf and not drop_last:
            yield collate(buf, mpe=self.mpe, bucket=self.bucket)

    def prefetched(self, indices: np.ndarray, epoch: int = 0) -> Iterator[Batch]:
        """`epoch_batches` produced by a background thread, PREFETCH ahead."""
        q: queue.Queue = queue.Queue(maxsize=PREFETCH)
        sentinel = object()
        failure = []

        def producer():
            try:
                for b in self.epoch_batches(indices, epoch):
                    q.put(b)
            except Exception as e:  # raised in the consumer below
                failure.append(e)
            finally:
                q.put(sentinel)

        threading.Thread(target=producer, daemon=True).start()
        while True:
            item = q.get()
            if item is sentinel:
                break
            yield item
        if failure:
            raise failure[0]
