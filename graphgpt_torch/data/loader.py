"""Host-side input pipeline: tokenization workers, packing, padding and a
background prefetch thread.

A copy of `graphgpt_tpu/data/loader.py` (`GraphTokenLoader`, its worker
pool, `estimate_tokens_per_sample`) on one process. A pool of
`num_workers` processes tokenizes the index list in chunks of 32, in
order; 0 tokenizes in the calling thread. Each sample's tokenization RNG
is seeded by (seed, epoch, idx, position), so the batches are the same
for any number of workers, and the same as the JAX loader's for the same
indices. Three differences from the JAX loader: the workers are spawned
(fresh interpreters, and the parent's main module left out, so that they
import no torch; the dataset and the tokenizer pickled once to a
temporary file that each worker reads as it starts: through the pool's
pipe, a pickle larger than its buffer makes the parent start the workers
one at a time, each reading and unpickling before the next, as a
577k-token vocab's tokenizer does), not forked (`start_method`); at most four chunks a worker are in flight, where `Pool.imap`
queues a whole epoch's, so that a pass left early (a run's last steps)
does not hold the pool for the next one (its save-point eval); and
`prefetched` raises what its producer raised instead of ending the epoch
early. Two more, for the spawned workers: each chunk carries the dataset's
epoch and the seed it was last reset with (`reset_seed`, where it keeps
one: the edge-level datasets draw each epoch's edges from it), which a
worker's copy follows (`reset_samples`), where the JAX loader's forked
workers keep the epoch the pool started at; a worker
walks as the parent does, in C++ unless a test pinned the numpy walk; and
`close` lets the workers finish their chunks instead of killing them.
"""

from __future__ import annotations

import collections
import contextlib
import itertools
import os
import pickle
import queue
import sys
import tempfile
import threading
import weakref
from typing import Iterator, List, Optional

import numpy as np

from . import euler
from .collator import Batch, collate, pack_samples
from .tokenizer import TokenizedSample

CHUNK = 32  # indices a worker tokenizes per task
_WORKER_STATE = {}


def _init_worker(dataset, tokenizer, seed, numpy_walk=False):
    _WORKER_STATE["dataset"] = dataset
    _WORKER_STATE["tokenizer"] = tokenizer
    _WORKER_STATE["seed"] = seed
    if numpy_walk:  # the parent walks in numpy (a test set it so)
        euler._NATIVE_CHECKED, euler._NATIVE = True, None


def _init_worker_from(path, seed, numpy_walk=False):
    """The pool's initializer: the dataset and the tokenizer from the file
    the parent wrote (`GraphTokenLoader.start`)."""
    with open(path, "rb") as f:
        dataset, tokenizer = pickle.load(f)
    _init_worker(dataset, tokenizer, seed, numpy_walk)


def _tokenize_chunk(args):
    epoch, start_pos, idx_chunk, ds_state = args
    ds = _WORKER_STATE["dataset"]
    tok = _WORKER_STATE["tokenizer"]
    seed = _WORKER_STATE["seed"]
    if ds_state is not None and _dataset_state(ds) != ds_state:
        # the parent's dataset moved to another epoch or seed (its node
        # permutations, its edges) after this worker unpickled it
        ds_epoch, ds_seed = ds_state
        if ds_seed is None:
            ds.reset_samples(ds_epoch)
        else:
            ds.reset_samples(ds_epoch, ds_seed)
    # the position in the epoch enters the seed, so that a repeated index
    # gets an independent view
    return [tok(ds[int(idx)], np.random.default_rng((seed, epoch, int(idx), start_pos + j)))
            for j, idx in enumerate(idx_chunk)]


def _dataset_state(ds):
    """(epoch, seed of the last reset) of a dataset that has an epoch, else
    None; the seed is None where the dataset keeps none."""
    if getattr(ds, "epoch", None) is None:
        return None
    return ds.epoch, getattr(ds, "reset_seed", None)


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

            # the C++ walk's library is built here, once, not by each worker;
            # a worker walks as this process does
            numpy_walk = euler._native() is None
            # spawn by default, not the JAX loader's fork: the pipeline's
            # process holds threads (prefetch, CUDA), whose locks a forked
            # child inherits; a spawned worker imports the data modules only
            fd, payload = tempfile.mkstemp(prefix="ggt_loader_", suffix=".pkl")
            # deleted by `close`, else when the loader is collected or the
            # interpreter exits (a pipeline that raised)
            self._drop_payload = weakref.finalize(self, os.unlink, payload)
            with os.fdopen(fd, "wb") as f:
                pickle.dump((self.dataset, self.tokenizer), f, protocol=pickle.HIGHEST_PROTOCOL)
            with _main_left_out(self.dataset, self.tokenizer):
                self._pool = mp.get_context(self.start_method).Pool(
                    self.num_workers, initializer=_init_worker_from,
                    initargs=(payload, self.seed, numpy_walk),
                )
        return self

    def _sample_stream(self, indices: np.ndarray, epoch: int) -> Iterator[TokenizedSample]:
        # each chunk carries the dataset's epoch and seed as they are now (a
        # reader's node permutations and edges follow them; the workers'
        # copies were pickled once)
        ds_state = _dataset_state(self.dataset)
        chunks = [(epoch, i, indices[i : i + CHUNK], ds_state)
                  for i in range(0, len(indices), CHUNK)]
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
        """Stop the pool: its workers finish the chunks in flight (at most
        four a worker) and exit. `Pool.terminate` could hang here: a worker
        killed while writing a result leaves a partial message that the
        pool's result thread then waits on."""
        if self._pool is not None:
            self._pool.close()
            self._pool.join()
            self._pool = None
            self._drop_payload()


def estimate_tokens_per_sample(dataset, tokenizer, n: int = 256, seed: int = 0) -> float:
    """Mean tokens of n sampled graphs (reference estimate_tokens_per_sample,
    misc_utils.py:349-378); the JAX package's cross-host form reduces to it
    on one process."""
    rng = np.random.default_rng(seed)
    n = min(n, len(dataset))
    idx = rng.choice(len(dataset), size=n, replace=False)
    return sum(tokenizer(dataset[int(i)], rng).seq_len for i in idx) / max(n, 1)
