"""The dataset and the tokenizer a config names, and the pretraining loop.

Counterpart of `graphgpt_tpu/training/pipeline.py` (`build_dataset`,
`build_tokenizer` :41-107, `PretrainPipeline` :110-811) on one process and
one card: vocab -> tokenizer -> model fields from the tokenizer -> token-
budget step counts -> model, optimizer, train and eval steps -> loader
(packing, block-aligned packing, SMTP masking after packing, a worker
pool) -> auto-resume from the latest checkpoint -> steps with log.csv
(loss, lr, tokens/s, TFLOP/s, mfu) -> save points with the valid and
EMA-valid losses and the dLLM generation sweep over unmask-ratio bands
(result.csv). The eval and the sweep run whole rows: `attn_block`, which
block-aligned packing sets for training, is off there, as the JAX package's
eval config has it. The mesh, several processes, the partitioned corpus and
the TensorBoard writer wait for later slices. The dataset is a config's
npz store through `readers.read_dataset` (PCQM4M-v2, ogbg-molpcba,
reddit_threads, spice-circuit, the ogbl/ogbn big graphs, ...) or
`synthetic_mol`; a big graph's dataset is its reader's train split, as in
the JAX package. Four differences from the JAX package, all repairs: a
save point's eval keeps the last partial batch (the JAX loader drops it,
so a valid set smaller than one packed batch gives no valid loss at all),
the tokenizer takes the config's `pretrain_mlm` schedule,
`stack_method: long` selects `StackedGSTTokenizerLong` (the JAX
`build_tokenizer` builds the short tokenizer, which asserts on it), and
the generation sweep's batch keeps its logits under the loss's
`LOGITS_BUDGET` (a large vocab).

    python -m graphgpt_torch.training.pipeline --smoke [--device cpu]
    python -m graphgpt_torch.training.pipeline --config cfg.yaml [key.sub=value ...]
"""

from __future__ import annotations

import contextlib
import os
import queue
import tempfile
import threading
from typing import Dict, Iterator, Optional

import numpy as np
import torch

from .. import resolve_device
from ..config import Config, config_to_dict
from ..data import vocab as vocab_mod
from ..data.collator import collate
from ..data.datasets import MOL_EDGE_CARD, MOL_NODE_CARD, SyntheticMolDataset, train_valid_split
from ..data.loader import GraphTokenLoader, estimate_tokens_per_sample
from ..data.tokenizer import StackedGSTTokenizer, StackedGSTTokenizerLong, mask_packed_row
from ..ops.losses import LOGITS_BUDGET
from ..synthetic import to_torch
from ..utils.logging import (CsvLogger, Throughput, log_line, peak_flops_per_chip,
                             train_flops_per_token)
from . import optimizer as opt_lib
from .checkpoint import Checkpointer, save_run_config
from .steps import init_train_state, make_eval_step, make_train_step

COORD_TASKS = ("pretrain-coord", "pretrain-coord-cl", "pretrain-mlm-coord")


def build_dataset(cfg: Config):
    name = cfg.tokenization.dataset
    if name == "synthetic_mol":
        # coord tasks need 3D positions on every molecule
        return SyntheticMolDataset(50_000, seed=cfg.training.seed,
                                   with_pos="coord" in cfg.training.task_type)
    from .. import readers  # registry of the dataset readers

    return readers.read_dataset(name, cfg)


def tokenizer_class(tok_cfg):
    """The stacked tokenizer of the config's `stack_method`."""
    if tok_cfg.tokenizer_class != "StackedGSTTokenizer":
        raise NotImplementedError(f"tokenizer {tok_cfg.tokenizer_class!r} waits for a later slice")
    return StackedGSTTokenizerLong if tok_cfg.stack_method == "long" else StackedGSTTokenizer


def attr_table_values(arr, dim: int):
    """The sorted distinct values of each of the first `dim` columns of an
    attribute table (none where it has no table)."""
    if arr is None or dim == 0:
        return [np.zeros(0, np.int64) for _ in range(dim)]
    a = np.asarray(arr).reshape(len(arr), -1)
    return [np.unique(a[:, c]) for c in range(dim)]


def build_tokenizer(cfg: Config, dataset) -> StackedGSTTokenizer:
    """The vocab from `output_dir/vocab_file` where it exists, else built
    and saved there: from the molecule attribute cardinalities for
    `synthetic_mol`; for a big-graph dataset from its FULL node and edge
    tables, a column at a time (sampling could miss nodes that appear later
    as random negative endpoints; JAX `training/pipeline.py:64-100`); else
    from the attribute values of the dataset's first 10,000 graphs. The
    tokenizer of the config's stacking and task, with its SMTP schedule."""
    tok_cfg = cfg.tokenization
    cls = tokenizer_class(tok_cfg)
    vocab_path = os.path.join(cfg.training.output_dir, tok_cfg.vocab_file)
    if os.path.exists(vocab_path):
        vm = vocab_mod.load_vocab(vocab_path)
    else:
        big = getattr(dataset, "big", None)
        if tok_cfg.dataset == "synthetic_mol":
            node_vals = [np.arange(c) for c in MOL_NODE_CARD]
            edge_vals = [np.arange(c) for c in MOL_EDGE_CARD]
        elif big is not None:
            node_vals = attr_table_values(big.node_attr, tok_cfg.semantics.node.dim)
            edge_vals = attr_table_values(big.edge_attr, tok_cfg.semantics.edge.dim)
        else:
            node_vals = vocab_mod.scan_attr_values(
                (dataset[i] for i in range(min(len(dataset), 10000))),
                tok_cfg.semantics.node.discrete or "node_attr",
                tok_cfg.semantics.node.dim,
            )
            edge_vals = vocab_mod.scan_attr_values(
                (dataset[i] for i in range(min(len(dataset), 10000))),
                tok_cfg.semantics.edge.discrete or "edge_attr",
                tok_cfg.semantics.edge.dim,
            )
        vocab = vocab_mod.build_vocab(tok_cfg, node_vals, edge_vals)
        vocab_mod.save_vocab(vocab, vocab_path)
        vm = vocab_mod.vocab_map_from_list(vocab)
    return cls(tok_cfg, vm, task_type=cfg.training.task_type, mlm_cfg=cfg.training.pretrain_mlm)


def _band_edge(v: float) -> str:
    """A generation band's edge in its CSV key: one decimal when exact, else
    two (so that n_bands = 4 gives 0.25, not 0.2)."""
    s = f"{v:.1f}"
    return s if abs(float(s) - v) < 1e-9 else f"{v:.2f}"


class PretrainPipeline:
    """Step-indexed pretraining (reference PretrainMode,
    src/training/pretrain_mode.py:97-500) on one card (`device`, cuda
    unless named)."""

    def __init__(self, cfg: Config, device=None):
        self.cfg = cfg.sync()
        self.device = resolve_device(device)

    def setup(self):
        cfg = self.cfg
        tcfg = cfg.training
        if tcfg.use_tb_writer:
            raise NotImplementedError("use_tb_writer: the TensorBoard writer waits for a later slice")
        os.makedirs(tcfg.output_dir, exist_ok=True)
        self.dataset = build_dataset(cfg)
        self.tokenizer = build_tokenizer(cfg, self.dataset)
        if tcfg.inspect_tokenization:
            from ..utils.inspection import inspect_tokenization

            inspect_tokenization(self.dataset, self.tokenizer, n_stats=32)
        m = cfg.model
        m.vocab_size = self.tokenizer.vocab_size
        m.mask_token_id = self.tokenizer.mask_id
        m.eos_token_id = self.tokenizer.eos_id
        m.bos_token_id = self.tokenizer.bos_id
        if tcfg.pack_block and tcfg.pack_tokens > 0:
            # no segment crosses a pack_block boundary: training attention
            # may run at P = pack_block (ops/attention.py attn_block)
            m.attn_block = tcfg.pack_block
        m.finalize()
        self.train_idx, self.valid_idx = train_valid_split(
            len(self.dataset), tcfg.valid_percent, tcfg.seed)
        # the step counts from the token budget
        pack = tcfg.pack_tokens > 0 and tcfg.task_type not in (
            "pretrain-cl", "pretrain-smtp", "pretrain-coord")
        if pack:
            tokens_per_sample = float(tcfg.max_length)  # packed rows are full
        else:
            tokens_per_sample = estimate_tokens_per_sample(
                self.dataset, self.tokenizer, n=min(256, tcfg.tot_samples))
        self.total_steps, self.warmup_steps = opt_lib.compute_total_steps(
            tcfg.schedule.total_tokens, tcfg.schedule.warmup_tokens, tokens_per_sample,
            tcfg.batch_size)
        if tcfg.schedule.total_num_steps:
            self.total_steps = tcfg.schedule.total_num_steps
        if tcfg.schedule.warmup_num_steps:
            self.warmup_steps = tcfg.schedule.warmup_num_steps
        log_line(f"schedule: {self.total_steps} steps ({self.warmup_steps} warmup), "
                 f"~{tokens_per_sample:.1f} tokens/sample")
        post_pack_fn = None
        loader_tokenizer = self.tokenizer
        if pack and tcfg.mask_after_pack and tcfg.task_type == "pretrain-mlm":
            loader_tokenizer = tokenizer_class(cfg.tokenization)(
                cfg.tokenization, self.tokenizer.vocab_map, task_type="pretrain")
            mask_id, vocab_size, mlm_cfg = (self.tokenizer.mask_id, self.tokenizer.vocab_size,
                                            tcfg.pretrain_mlm)

            def post_pack_fn(s, rng):
                return mask_packed_row(s, mask_id, mlm_cfg, rng, vocab_size)

        self.loader = GraphTokenLoader(
            self.dataset, loader_tokenizer, batch_size=tcfg.batch_size, mpe=tcfg.max_length,
            pack=pack, num_workers=tcfg.num_workers, seed=tcfg.seed, post_pack_fn=post_pack_fn,
            pack_block=tcfg.pack_block, bucket=tcfg.pad_to_multiple_of,
        ).start()
        # the model family (reference PretrainMode registry,
        # pretrain_mode.py:71-75): coord tasks train the 3D-position model
        if tcfg.task_type in COORD_TASKS:
            from ..models.pos_pretrain import GraphGPTPosPred as model_cls
        else:
            from ..models.heads import GraphGPTPretrain as model_cls
        model = model_cls(m, device=self.device, seed=tcfg.seed)
        self.schedule = opt_lib.make_schedule(tcfg.optimizer, self.total_steps, self.warmup_steps)
        self.tx = opt_lib.make_optimizer(tcfg.optimizer, self.total_steps, self.warmup_steps,
                                         self.schedule, num_layers=m.num_hidden_layers)
        self.state = init_train_state(model, self.tx, tcfg.optimizer.use_ema)
        self.train_step = make_train_step(self.tx, tcfg.optimizer, self.schedule)
        self.eval_step = make_eval_step()
        self.eval_step_ema = make_eval_step(use_ema=True) if tcfg.optimizer.use_ema else None
        # checkpoints and auto-resume
        self.ckpt = Checkpointer(os.path.join(tcfg.output_dir, "ckpt"))
        self.start_step = self.start_epoch = 0
        latest = self.ckpt.latest_step()
        if latest is not None:
            self.state, meta = self.ckpt.restore(self.state, latest)
            self.start_step = int(meta.get("step", latest))
            self.start_epoch = int(meta.get("epoch", 0))
            log_line(f"auto-resumed from step {self.start_step}")
        save_run_config(tcfg.output_dir, config_to_dict(cfg))
        self.logger = CsvLogger(os.path.join(tcfg.output_dir, "log.csv"))
        # one row per save point: the valid and EMA-valid losses and the
        # generation bands' accuracies
        self.results = CsvLogger(os.path.join(tcfg.output_dir, "result.csv"))
        self._copy_stream = (torch.cuda.Stream(self.device) if self.device.type == "cuda"
                             else None)
        return self

    # ------------------------------------------------------------------
    @contextlib.contextmanager
    def _whole_rows(self):
        """Eval rows may be unpacked (the generation sweep's), where one
        segment spans block boundaries: no attn_block factorisation."""
        m = self.state.model.cfg
        saved, m.attn_block = m.attn_block, 0
        try:
            yield
        finally:
            m.attn_block = saved

    def _device_batches(self, epoch: int) -> Iterator[tuple]:
        """(host batch, its token count) for one epoch, the count taken on
        the host so that no step waits on a read-back."""
        idx = np.random.default_rng((self.cfg.training.seed, epoch)).permutation(self.train_idx)
        if self.cfg.training.task_type == "pretrain-cl":
            # two adjacent independent views per sample (reference
            # get_cl_sampler, loader_utils.py:308-315)
            idx = np.repeat(idx, 2)
        for batch in self.loader.prefetched(idx, epoch):
            data = dict(batch.data)
            yield data, int(np.sum(data["segment_ids"] > 0))

    def _to_device(self, data: Dict[str, np.ndarray]):
        """(batch on the device, the event its copies end at): on a card,
        collated into pinned memory and copied with non_blocking on a side
        stream, so that the copy of batch k+1 overlaps step k."""
        if self._copy_stream is None:
            return to_torch(data, self.device), None
        with torch.cuda.stream(self._copy_stream):
            out = {k: torch.from_numpy(np.ascontiguousarray(v)).pin_memory().to(
                self.device, non_blocking=True) for k, v in data.items()}
            done = torch.cuda.Event()
            done.record(self._copy_stream)
        return out, done

    def _device_prefetch(self, it: Iterator[tuple], depth: int = 2) -> Iterator[tuple]:
        """(device batch, token count) from `it`, `depth` ahead, by a
        background thread that also makes the copies; raises what the
        thread raised. Closing it early stops the thread."""
        q: queue.Queue = queue.Queue(maxsize=depth)
        done, stop, failure = object(), threading.Event(), []

        def producer():
            try:
                for data, n_tokens in it:
                    if stop.is_set():
                        break
                    q.put((self._to_device(data), n_tokens))
            except BaseException as e:  # raised in the consumer below
                failure.append(e)
            finally:
                q.put(done)

        threading.Thread(target=producer, daemon=True).start()
        item = None
        try:
            while True:
                item = q.get()
                if item is done:
                    break
                (batch, ready), n_tokens = item
                if ready is not None:
                    cur = torch.cuda.current_stream(self.device)
                    cur.wait_event(ready)
                    for t in batch.values():
                        t.record_stream(cur)
                yield batch, n_tokens
        finally:
            stop.set()
            while item is not done:  # let a producer blocked on put finish
                item = q.get()
        if failure:
            raise failure[0]

    def run(self, max_steps: Optional[int] = None):
        tcfg = self.cfg.training
        step_limit = min(self.total_steps, max_steps or self.total_steps)
        thr = Throughput()
        # analytic FLOPs a token for the TFLOP/s and mfu columns
        mc = self.cfg.model
        n_params = sum(p.numel() for p in self.state.model.parameters())
        fpt = train_flops_per_token(n_params, mc.max_position_embeddings, mc.num_hidden_layers,
                                    mc.num_attention_heads, mc.head_dim,
                                    causal=mc.causal_attention)
        peak = peak_flops_per_chip() if self.device.type == "cuda" else 0.0
        global_step, epoch = self.start_step, self.start_epoch
        while global_step < step_limit:
            epoch_start_step = global_step
            for batch, n_tokens in self._device_prefetch(self._device_batches(epoch)):
                self.state, metrics = self.train_step(self.state, batch, seed=tcfg.seed)
                global_step += 1
                thr.update(n_tokens, batch["segment_ids"].shape[0])
                if global_step % tcfg.schedule.logging_steps == 0:
                    m = {k: float(v) for k, v in metrics.items()}
                    m.update(thr.rates())
                    m["tflops_per_s"] = m["tokens_per_s"] * fpt / 1e12
                    if peak > 0:
                        m["mfu"] = m["tflops_per_s"] * 1e12 / peak
                    m.update(step=global_step, epoch=epoch)
                    thr.reset()
                    log_line(f"step {global_step}/{step_limit} loss {m['loss']:.4f} "
                             f"lr {m.get('lr', 0):.2e} tok/s {m['tokens_per_s']:.0f}")
                    self.logger.log(m)
                if tcfg.schedule.steps_per_saving and (
                        global_step % tcfg.schedule.steps_per_saving == 0):
                    self._save_and_eval(global_step, epoch)
                if global_step >= step_limit:
                    break
            else:
                if global_step == epoch_start_step:
                    raise RuntimeError(
                        "epoch produced no training batches: the dataset is smaller than one "
                        "(packed) batch; shrink batch_size or max_length")
            epoch += 1
        self._save_and_eval(global_step, epoch)
        self.loader.close()
        return self.state

    # ------------------------------------------------------------------
    def _eval_batches(self, vidx: np.ndarray):
        """Valid batches covering every index once (the last one partial)."""
        tcfg = self.cfg.training
        yield from self.loader.epoch_batches(vidx, epoch=0, drop_last=False,
                                             batch_size=tcfg.batch_size_eval or tcfg.batch_size)

    def _eval_losses(self, vidx: np.ndarray, ema: bool = False):
        """(losses, EMA losses) of the valid batches of `vidx`."""
        losses, ema_losses = [], []
        with self._whole_rows():
            for batch in self._eval_batches(vidx):
                b = to_torch(batch.data, self.device)
                losses.append(float(self.eval_step(self.state, b)["loss"]))
                if ema and self.eval_step_ema is not None:
                    ema_losses.append(float(self.eval_step_ema(self.state, b)["loss"]))
        return losses, ema_losses

    def _save_and_eval(self, step: int, epoch: int):
        self.ckpt.save(step, self.state, {"step": step, "epoch": epoch})
        tcfg = self.cfg.training
        if not (tcfg.do_valid and len(self.valid_idx) > 0):
            return
        # the reference's eval surface at each save point: valid loss, EMA
        # valid loss, generation bands (log_eval_dump_utils.py:565-645)
        row = {"step": step, "epoch": epoch}
        losses, ema_losses = self._eval_losses(self.valid_idx[:512], ema=True)
        loss = float(np.mean(losses)) if losses else float("nan")
        if np.isfinite(loss):
            log_line(f"valid loss @ step {step}: {loss:.4f}")
            row["valid_loss"] = loss
        if ema_losses:
            ema_loss = float(np.mean(ema_losses))
            if np.isfinite(ema_loss):
                log_line(f"ema valid loss @ step {step}: {ema_loss:.4f}")
                row["ema_valid_loss"] = ema_loss
        if (tcfg.gen_eval_bands > 0 and "pretrain-mlm" in tcfg.task_type
                and "coord" not in tcfg.task_type):
            row.update(self.evaluate_generation(n_samples=tcfg.gen_eval_samples,
                                                n_bands=tcfg.gen_eval_bands))
        self.results.log(row)

    def evaluate_only(self) -> Dict[str, float]:
        """Eval of the latest checkpoint (setup restores it): the valid loss
        and the generation accuracies of all 10 unmask-ratio bands."""
        idx = self.valid_idx if len(self.valid_idx) else self.train_idx[:512]
        losses, _ = self._eval_losses(idx[:512])
        res = {"valid_loss": float(np.mean(losses)) if losses else float("nan")}
        res.update(self.evaluate_generation(n_bands=10))
        log_line(f"eval-only results: {res}")
        return res

    def infer_hidden_states(self, indices, path: str):
        """The last-token hidden state of each graph of `indices`, saved as
        npz (reference pt_infer_hidden_states, log_eval_dump_utils.py:166-239)."""
        from ..models.heads import last_token_pool

        chunks = []
        with self._whole_rows():
            for batch in self.loader.epoch_batches(np.asarray(indices), epoch=0,
                                                   drop_last=False):
                b = to_torch(batch.data, self.device)
                hidden = self.eval_step(self.state, b).get("hidden_states")
                if hidden is not None:
                    pooled = last_token_pool(hidden, b["segment_ids"])
                    chunks.append(pooled.float().cpu().numpy())
        arr = np.concatenate(chunks) if chunks else np.zeros((0,))
        np.savez(path, hidden_states=arr)
        log_line(f"pt hidden states {arr.shape} -> {path}")
        return arr

    def evaluate_generation(self, n_samples: Optional[int] = None, n_bands: int = 10,
                            batch_size: int = 0) -> Dict[str, float]:
        """dLLM generation accuracy over unmask-ratio bands (reference
        evaluate_generation, log_eval_dump_utils.py:307-384): each batch of
        clean valid rows, padded to max_length, is masked at a ratio drawn
        from each band, unmasked by the sampler, and the masked cells'
        accuracy summed per band."""
        from ..generation import dllm

        tcfg, gen_cfg, tok = self.cfg.training, self.cfg.generation, self.tokenizer
        clean_tok = tokenizer_class(self.cfg.tokenization)(self.cfg.tokenization, tok.vocab_map,
                                                           task_type="pretrain")
        rng_np = np.random.default_rng(0)
        idx = self.valid_idx if len(self.valid_idx) else self.train_idx
        if n_samples is None:
            n_samples = tcfg.pretrain_mlm.num_gen_samples  # <= 0: the whole subset
        if n_samples and n_samples > 0:
            idx = idx[:n_samples]
        bs = batch_size or min(tcfg.batch_size_eval or tcfg.batch_size, max(len(idx), 1))
        p = tcfg.max_length
        # at most LOGITS_BUDGET logits [b, P * F, V] a batch (the sampler's
        # softmax over a 33k vocab asked for 49 GiB at 32 rows of 1024 x 12)
        b = max(1, min(bs, len(idx), LOGITS_BUDGET // (p * clean_tok.stacked_feat
                                                         * tok.vocab_size)))
        model = self.state.model
        correct = np.zeros(n_bands, np.int64)
        masked_n = np.zeros(n_bands, np.int64)
        sampler = None
        with self._whole_rows():
            for start in range(0, len(idx) - b + 1, b):
                samples = [clean_tok(self.dataset[int(i)], rng_np) for i in idx[start : start + b]]
                batch = collate(samples, mpe=p, bucket=8, fixed_length=p)
                ids = np.asarray(batch["input_ids"])  # [B, P, F]
                f = ids.shape[-1]
                pos = torch.as_tensor(batch["position_ids"], device=self.device)
                seg = torch.as_tensor(batch["segment_ids"], device=self.device)
                pad_mask = np.asarray(batch["segment_ids"]) > 0

                def logits_fn(x_flat, position_ids, segment_ids):
                    rows = x_flat.shape[0]
                    return model.logits({"input_ids": x_flat.view(rows, p, f),
                                         "position_ids": position_ids,
                                         "segment_ids": segment_ids}).view(rows, p * f, -1)

                if sampler is None:
                    sampler = dllm.make_unmask_sampler(logits_fn, gen_cfg, tok.mask_id,
                                                       device=self.device)
                for band in range(n_bands):
                    lo, hi = band / n_bands, (band + 1) / n_bands
                    _, mask = dllm.mask_at_ratio(ids, tok.mask_id, (lo, hi), rng_np)
                    mask = mask & pad_mask[..., None]
                    x0 = torch.as_tensor(np.where(mask, tok.mask_id, ids).reshape(b, p * f),
                                         device=self.device)
                    seed = band * 100003 + start
                    if gen_cfg.batched:
                        gen = torch.Generator(device=self.device).manual_seed(seed)
                        out = sampler(x0, gen, pos, seg)
                    else:
                        # one example at a time, steps = min(#masked, steps)
                        # (reference eval_gen_per_sample)
                        out = torch.cat([dllm.sample_per_example(
                            logits_fn, gen_cfg, tok.mask_id, x0[r],
                            torch.Generator(device=self.device).manual_seed(seed + 7 * r),
                            pos[r : r + 1], seg[r : r + 1], device=self.device)[0]
                            for r in range(b)])
                    hit = (out.view(b, p, f).cpu().numpy() == ids) & mask
                    correct[band] += int(hit.sum())
                    masked_n[band] += int(mask.sum())
        results = {
            f"gen_acc@umr_{_band_edge(band / n_bands)}-{_band_edge((band + 1) / n_bands)}":
                float(correct[band] / max(masked_n[band], 1)) for band in range(n_bands)}
        log_line(f"generation eval ({len(idx)} samples): {results}")
        return results


def smoke_config(output_dir: Optional[str] = None) -> Config:
    """The JAX package's smoke run (hidden 128, 2 layers, batch 8 packed rows
    of 128, 30 steps, a save-point eval of 1% of synthetic_mol), with a
    generation sweep of 8 graphs in 8 steps in place of 32 in 64."""
    cfg = Config()
    sem = cfg.tokenization.semantics
    sem.node.discrete, sem.node.dim = "node_attr", 9
    sem.edge.discrete, sem.edge.dim = "edge_attr", 3
    cfg.model.hidden_size, cfg.model.num_hidden_layers = 128, 2
    t = cfg.training
    t.batch_size, t.max_length, t.pack_tokens, t.num_workers = 8, 128, 1, 0
    t.schedule.total_num_steps, t.schedule.warmup_num_steps = 30, 5
    t.schedule.logging_steps = 10
    t.valid_percent, t.do_valid, t.gen_eval_samples = 0.01, True, 8
    cfg.generation.steps = 8
    t.output_dir = output_dir or os.environ.get(
        "SMOKE_DIR", os.path.join(tempfile.gettempdir(), "graphgpt_torch_smoke"))
    return cfg


def smoke_test(device=None, output_dir: Optional[str] = None):
    pipe = PretrainPipeline(smoke_config(output_dir), device=device).setup()
    pipe.run()
    log_line("smoke test done")
    return pipe


if __name__ == "__main__":
    import argparse

    ap = argparse.ArgumentParser()
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--eval-only", action="store_true")
    ap.add_argument("--config", default=None)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("overrides", nargs="*")
    args = ap.parse_args()
    if args.smoke:
        smoke_test(args.device)
    else:
        from ..config import load_config

        pipe = PretrainPipeline(load_config(args.config, args.overrides),
                                device=args.device).setup()
        if args.eval_only:
            pipe.evaluate_only()
        else:
            pipe.run()
