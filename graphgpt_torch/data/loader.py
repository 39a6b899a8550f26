"""Host-side input pipeline: tokenization workers, packing, padding and a
background prefetch thread.

A copy of `graphgpt_tpu/data/loader.py` (`GraphTokenLoader`, its worker
pool, `estimate_tokens_per_sample`) on one process. A pool of
`num_workers` processes tokenizes the index list in chunks of 32, in
order; 0 tokenizes in the calling thread. Each sample's tokenization RNG
is seeded by (seed, epoch, idx, position), so the batches are the same
for any number of workers, and the same as the JAX loader's for the same
indices. Three differences from the JAX loader: the workers are spawned
(fresh interpreters, the dataset and the tokenizer pickled to them, and
the parent's main module left out, so that they import no torch), not
forked (`start_method`); at most four chunks a worker are in flight, where `Pool.imap`
queues a whole epoch's, so that a pass left early (a run's last steps)
does not hold the pool for the next one (its save-point eval); and
`prefetched` raises what its producer raised instead of ending the epoch
early.
"""

from __future__ import annotations

import collections
import contextlib
import itertools
import queue
import sys
import threading
from typing import Iterator, List, Optional

import numpy as np

from .collator import Batch, collate, pack_samples
from .tokenizer import TokenizedSample

CHUNK = 32  # indices a worker tokenizes per task
_WORKER_STATE = {}


def _init_worker(dataset, tokenizer, seed):
    _WORKER_STATE["dataset"] = dataset
    _WORKER_STATE["tokenizer"] = tokenizer
    _WORKER_STATE["seed"] = seed


def _tokenize_chunk(args):
    epoch, start_pos, idx_chunk = args
    ds = _WORKER_STATE["dataset"]
    tok = _WORKER_STATE["tokenizer"]
    seed = _WORKER_STATE["seed"]
    # the position in the epoch enters the seed, so that a repeated index
    # gets an independent view
    return [tok(ds[int(idx)], np.random.default_rng((seed, epoch, int(idx), start_pos + j)))
            for j, idx in enumerate(idx_chunk)]


@contextlib.contextmanager
def _main_left_out(*objs):
    """While a pool starts: hide the parent's `__main__` module from the
    workers, unless one of `objs` (what the workers unpickle) is of a class
    defined there. A spawned worker otherwise runs the parent's main module
    again before its first task (multiprocessing's `__mp_main__`), and the
    port's entry points import torch, seconds of each worker's start; the
    workers need only this package's data modules, which import numpy."""
    main = sys.modules.get("__main__")
    if main is None or any(type(o).__module__ == "__main__" for o in objs):
        yield
        return
    keys = ("__spec__", "__file__")
    saved = {k: main.__dict__[k] for k in keys if k in main.__dict__}
    main.__spec__ = None
    main.__dict__.pop("__file__", None)
    try:
        yield
    finally:
        for k in keys:
            main.__dict__.pop(k, None)
        main.__dict__.update(saved)


class GraphTokenLoader:
    """Iterates batches for one epoch: packed rows of exactly mpe tokens when
    `pack` (block-aligned with `pack_block`), else one graph a row, padded to
    a multiple of `bucket` (capped at mpe) or to `fixed_length`.
    `post_pack_fn(sample, rng)` is applied to each packed row (the SMTP
    masking drawn once per row)."""

    def __init__(
        self,
        dataset,
        tokenizer,
        batch_size: int,
        mpe: int = 1024,
        pack: bool = False,
        bucket: int = 64,
        num_workers: int = 0,
        seed: int = 0,
        drop_last: bool = True,
        prefetch: int = 4,
        post_pack_fn=None,
        fixed_length: Optional[int] = None,
        pack_block: int = 0,
        start_method: str = "spawn",
    ):
        self.dataset = dataset
        self.tokenizer = tokenizer
        self.batch_size = batch_size
        self.mpe = mpe
        self.pack = pack
        self.bucket = bucket
        self.fixed_length = fixed_length
        self.pack_block = pack_block
        self.num_workers = num_workers
        self.seed = seed
        self.drop_last = drop_last
        self.prefetch = prefetch
        self.post_pack_fn = post_pack_fn
        self.start_method = start_method
        self._pool = None

    def start(self):
        """Start the worker pool now (it is otherwise started at first use)."""
        if self.num_workers > 0 and self._pool is None:
            import multiprocessing as mp

            # spawn by default, not the JAX loader's fork: the pipeline's
            # process holds threads (prefetch, CUDA), whose locks a forked
            # child inherits; a spawned worker imports the data modules only
            with _main_left_out(self.dataset, self.tokenizer):
                self._pool = mp.get_context(self.start_method).Pool(
                    self.num_workers, initializer=_init_worker,
                    initargs=(self.dataset, self.tokenizer, self.seed),
                )
        return self

    def _sample_stream(self, indices: np.ndarray, epoch: int) -> Iterator[TokenizedSample]:
        chunks = [(epoch, i, indices[i : i + CHUNK]) for i in range(0, len(indices), CHUNK)]
        pool = self.start()._pool
        if pool is None:
            _init_worker(self.dataset, self.tokenizer, self.seed)
            for c in chunks:
                yield from _tokenize_chunk(c)
            return
        # in order, at most 4 chunks a worker in flight (Pool.imap would queue
        # the whole epoch, and a later pass, an eval, would wait behind it)
        window = collections.deque()
        todo = iter(chunks)
        for c in itertools.islice(todo, 4 * self.num_workers):
            window.append(pool.apply_async(_tokenize_chunk, (c,)))
        while window:
            res = window.popleft().get()
            nxt = next(todo, None)
            if nxt is not None:
                window.append(pool.apply_async(_tokenize_chunk, (nxt,)))
            yield from res

    def epoch_batches(
        self,
        indices: np.ndarray,
        epoch: int = 0,
        pack: Optional[bool] = None,
        fixed_length: Optional[int] = None,
        drop_last: Optional[bool] = None,
        batch_size: Optional[int] = None,
    ) -> Iterator[Batch]:
        """Batches for one pass over `indices`; `pack`, `fixed_length`,
        `drop_last` and `batch_size` override the loader's own
        (`drop_last=False` keeps the final partial batch, so that an eval
        pass covers every index)."""
        use_pack = self.pack if pack is None else pack
        use_drop_last = self.drop_last if drop_last is None else drop_last
        bs = batch_size or self.batch_size
        stream = self._sample_stream(indices, epoch)
        if use_pack:
            stream = pack_samples(stream, self.mpe, block=self.pack_block)
            if self.post_pack_fn is not None:
                rng = np.random.default_rng((self.seed, epoch, 777))
                stream = (self.post_pack_fn(s, rng) for s in stream)
        flen = fixed_length if fixed_length is not None else (
            self.mpe if use_pack else self.fixed_length)
        buf: List[TokenizedSample] = []
        for s in stream:
            buf.append(s)
            if len(buf) == bs:
                yield collate(buf, mpe=self.mpe, bucket=self.bucket, fixed_length=flen)
                buf = []
        if buf and not use_drop_last:
            yield collate(buf, mpe=self.mpe, bucket=self.bucket, fixed_length=flen)

    def prefetched(self, indices: np.ndarray, epoch: int = 0) -> Iterator[Batch]:
        """`epoch_batches` produced by a background thread, `prefetch` ahead;
        raises what the producer raised. Closing it early stops the thread."""
        q: queue.Queue = queue.Queue(maxsize=self.prefetch)
        sentinel, stop, failure = object(), threading.Event(), []

        def producer():
            try:
                for b in self.epoch_batches(indices, epoch):
                    if stop.is_set():
                        break
                    q.put(b)
            except Exception as e:  # raised in the consumer below
                failure.append(e)
            finally:
                q.put(sentinel)

        threading.Thread(target=producer, daemon=True).start()
        item = None
        try:
            while True:
                item = q.get()
                if item is sentinel:
                    break
                yield item
        finally:
            stop.set()
            while item is not sentinel:  # let a producer blocked on put finish
                item = q.get()
        if failure:
            raise failure[0]

    def close(self):
        if self._pool is not None:
            self._pool.terminate()
            self._pool = None


def estimate_tokens_per_sample(dataset, tokenizer, n: int = 256, seed: int = 0) -> float:
    """Mean tokens of n sampled graphs (reference estimate_tokens_per_sample,
    misc_utils.py:349-378); the JAX package's cross-host form reduces to it
    on one process."""
    rng = np.random.default_rng(seed)
    n = min(n, len(dataset))
    idx = rng.choice(len(dataset), size=n, replace=False)
    return sum(tokenizer(dataset[int(i)], rng).seq_len for i in idx) / max(n, 1)
