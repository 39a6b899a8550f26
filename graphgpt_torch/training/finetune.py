"""Fine-tuning: epoch-level training with per-epoch eval and EMA-best.

Counterpart of `graphgpt_tpu/training/finetune.py` (`make_freeze_transform`
:31, `FinetunePipeline` :65) on one process and one card: warm start from a
pretrain checkpoint with the heads skipped, optional freezing, the eval
surface of each epoch (train subset, valid, EMA valid with the EMA-best
checkpoint, test with EMA), prediction and hidden-state dumps, and the
`eval_only` sweep over saved epochs. The mesh, several processes and the
partitioned corpus wait for the multi-GPU slice. The splits are the
dataset's own where it has them (a graph-level reader's), and each epoch
resets the dataset's node permutations (`reset_samples`); the loader runs
`num_workers` tokenizer processes. Eval covers each index once: no row is
repeated to fill a batch.

Here the port differs (a repair): where the reader's valid and test splits
are grouped (`readers.grouped_eval_datasets`: ogbl-citation2 and
ogbl-wikikg2, whose OGB metric is the MRR) valid and test are those
splits, each positive with its fixed negatives, and a train-subset eval
gives no MRR. The JAX pipeline takes valid and test from
`train_valid_split` over the train split, whose samples carry no groups, so
that its `reformat_mrr_inputs` raises at the first eval of either config.

    python -m graphgpt_torch.training.finetune --config cfg.yaml key.sub=value ...
"""

from __future__ import annotations

import csv
import os
from typing import Dict, Optional

import numpy as np
import torch

from .. import readers, resolve_device
from ..config import Config, config_to_dict
from ..data.datasets import train_valid_split
from ..data.loader import GraphTokenLoader
from ..models.heads import GraphGPTTask
from ..synthetic import to_torch
from ..utils import metrics as metrics_mod
from ..utils import ogb_eval
from ..utils.logging import CsvLogger, log_line
from . import optimizer as opt_lib
from .checkpoint import Checkpointer, restore_params_warmstart, save_run_config
from .pipeline import build_dataset, build_tokenizer
from .steps import init_train_state, make_eval_step, make_train_step

HEAD_PREFIXES = ("score", "lm_head", "n_token_proj")


def make_freeze_transform(freeze: int, num_layers: int):
    """A transform of the optimizer's updates that zeroes them (weight decay
    included) for the embedding table and, for freeze = k > 0, for the first
    k decoder layers: the parameters stay exactly as they were."""

    def transform(updates):
        out = {}
        for name, u in updates.items():
            idx = opt_lib.layer_index(name)
            frozen = "embed_tokens" in name or (freeze > 0 and idx is not None and idx < freeze)
            out[name] = torch.zeros_like(u) if frozen else u
        return out

    return transform


class FinetunePipeline:
    def __init__(self, cfg: Config, device=None):
        self.cfg = cfg.sync()
        self.device = resolve_device(device)

    def setup(self):
        cfg = self.cfg
        tcfg = cfg.training
        # JAX writes event files when use_tb_writer is set and eval_only is
        # not (graphgpt_tpu/training/finetune.py:226-232): raise rather than
        # run without them
        if tcfg.use_tb_writer and not tcfg.eval_only:
            raise NotImplementedError("use_tb_writer: the TensorBoard writer waits for a later slice")
        os.makedirs(tcfg.output_dir, exist_ok=True)
        self.dataset = build_dataset(cfg)
        self.tokenizer = build_tokenizer(cfg, self.dataset)
        m = cfg.model
        m.vocab_size = self.tokenizer.vocab_size
        m.mask_token_id = self.tokenizer.mask_id
        m.eos_token_id = self.tokenizer.eos_id
        m.next_n_token = m.stacked_feat if m.use_aux else 1
        m.finalize()

        # splits: the dataset's own where it has them (a reader's store)
        if hasattr(self.dataset, "splits"):
            self.train_idx, self.valid_idx, self.test_idx = self.dataset.splits()
        else:
            tr, va = train_valid_split(len(self.dataset), max(tcfg.valid_percent, 0.05),
                                       tcfg.seed)
            self.train_idx, self.valid_idx, self.test_idx = tr, va, va
        steps_per_epoch = max(len(self.train_idx) // tcfg.batch_size, 1)
        self.epochs = tcfg.schedule.epochs or 10
        self.total_steps = steps_per_epoch * self.epochs
        if tcfg.schedule.warmup_num_steps:
            warmup = tcfg.schedule.warmup_num_steps
        elif tcfg.schedule.warmup_epochs > 0:
            warmup = int(tcfg.schedule.warmup_epochs * steps_per_epoch)
        else:
            warmup = int(self.total_steps * 0.05)
        self.warmup_steps = max(warmup, 1)

        model = GraphGPTTask(m, device=self.device, seed=tcfg.seed)
        if tcfg.pretrain_cpt:
            model.load_state_dict(restore_params_warmstart(
                os.path.join(tcfg.pretrain_cpt, "ckpt"), model.state_dict(),
                skip_prefixes=HEAD_PREFIXES,
            ))
            log_line(f"warm-started from {tcfg.pretrain_cpt}")
        self.schedule = opt_lib.make_schedule(tcfg.optimizer, self.total_steps, self.warmup_steps)
        freeze = (make_freeze_transform(tcfg.freeze, m.num_hidden_layers)
                  if tcfg.freeze >= 0 else None)
        self.tx = opt_lib.make_optimizer(
            tcfg.optimizer, self.total_steps, self.warmup_steps, self.schedule,
            num_layers=m.num_hidden_layers, post_update=freeze,
        )
        self.state = init_train_state(model, self.tx, tcfg.optimizer.use_ema)
        self.train_step = make_train_step(self.tx, tcfg.optimizer, self.schedule)
        self.eval_step = make_eval_step()
        self.eval_step_ema = make_eval_step(use_ema=True)
        self.loader = GraphTokenLoader(
            self.dataset, self.tokenizer, batch_size=tcfg.batch_size, mpe=tcfg.max_length,
            bucket=tcfg.pad_to_multiple_of, num_workers=tcfg.num_workers, seed=tcfg.seed,
        )
        # grouped eval splits (the MRR datasets): valid and test from the
        # reader's own splits
        self.eval_loaders = {
            split: GraphTokenLoader(
                ds, self.tokenizer, batch_size=tcfg.batch_size, mpe=tcfg.max_length,
                bucket=tcfg.pad_to_multiple_of, num_workers=tcfg.num_workers, seed=tcfg.seed)
            for split, ds in readers.grouped_eval_datasets(cfg).items()}
        if self.eval_loaders:
            self.valid_idx = np.arange(len(self.eval_loaders["valid"].dataset))
            self.test_idx = np.arange(len(self.eval_loaders["test"].dataset))
        self.ckpt = Checkpointer(os.path.join(tcfg.output_dir, "ckpt"))
        self.ckpt_ema_best = Checkpointer(os.path.join(tcfg.output_dir, "ckpt_ema_best"), keep=1)
        self.logger = CsvLogger(os.path.join(tcfg.output_dir, "loss.csv"))
        self.results = CsvLogger(os.path.join(tcfg.output_dir, "result.csv"))
        self.best: Dict[str, float] = {}
        self.ema_best: Dict[str, float] = {}
        save_run_config(tcfg.output_dir, config_to_dict(cfg))
        return self

    # ------------------------------------------------------------------
    def _label_key(self) -> str:
        return {
            "graph": "graph_labels", "edge": "edge_labels", "node": "node_labels",
            "nodev2": "nodev2_labels",
        }.get(self.cfg.training.task_type, "task_labels")

    def _eval_collect(self, indices, use_ema: bool = False, want_hidden: bool = False,
                      split: Optional[str] = None):
        """(scores, labels, eval_group, hidden) over `indices` of the split's
        dataset (the training dataset unless `split` has an eval loader of
        its own), each index once, in order; None where nothing was
        collected."""
        tcfg = self.cfg.training
        ev = self.eval_step_ema if use_ema else self.eval_step
        bs = tcfg.batch_size_eval or tcfg.batch_size
        loader = self.eval_loaders.get(split, self.loader)
        scores, labels, groups, hidden = [], [], [], []
        for batch in loader.epoch_batches(np.asarray(indices), epoch=0, drop_last=False,
                                          batch_size=bs):
            out = ev(self.state, to_torch(batch.data, self.device))
            scores.append(out["task_logits"].float().cpu().numpy().astype(np.float64))
            labels.append(np.asarray(batch[self._label_key()]))
            if "eval_group" in batch:
                groups.append(np.asarray(batch["eval_group"]).reshape(-1))
            if want_hidden:
                hidden.append(out["task_hidden_states"].float().cpu().numpy())

        def cat(parts):
            return np.concatenate(parts) if parts else None

        return cat(scores), cat(labels), cat(groups), cat(hidden)

    def evaluate(self, indices, use_ema: bool = False, ogb_name: Optional[str] = None,
                 split: Optional[str] = None) -> Dict[str, float]:
        cfg = self.cfg
        scores, labels, groups, _ = self._eval_collect(indices, use_ema, split=split)
        if scores is None:
            return {}
        if cfg.training.task_type == "nodev2":
            # token-level labels: flatten and drop the -100 positions
            flat = labels.reshape(-1)
            keep = flat != -100
            scores = scores.reshape(-1, scores.shape[-1])[keep]
            labels = flat[keep]
        preds = scores.reshape(labels.shape) if cfg.model.problem_type == "regression" else scores
        res = metrics_mod.compute_metrics(cfg.model.problem_type, preds, labels)
        if ogb_name and ogb_name in ogb_eval._ogb:
            if ogb_name.startswith("ogbl"):
                pos = (scores[:, 1] - scores[:, 0] if scores.ndim > 1 and scores.shape[-1] == 2
                       else scores.reshape(-1))
                if ogb_name in ("ogbl-citation2", "ogbl-wikikg2"):
                    # only samples grouped by their positive have an MRR
                    if groups is not None:
                        n_pos = int((labels > 0.5).sum())
                        d = ogb_eval.reformat_mrr_inputs(pos, labels, groups,
                                                         num_neg=(len(labels) - n_pos) // n_pos)
                        res.update(ogb_eval.evaluate_ogb(ogb_name, d))
                else:
                    res.update(ogb_eval.evaluate_ogb(ogb_name,
                                                     ogb_eval.reformat_hits_inputs(pos, labels)))
            else:
                # graph-level evaluators take one score column per task: a
                # binary single-label head's positive-class probability
                y_pred = preds
                if (cfg.model.problem_type == "single_label_classification"
                        and np.ndim(preds) == 2 and preds.shape[-1] == 2):
                    e = np.exp(preds - preds.max(-1, keepdims=True))
                    y_pred = (e / e.sum(-1, keepdims=True))[:, 1:]
                res.update(ogb_eval.evaluate_ogb(ogb_name, {
                    "y_pred": y_pred, "y_true": np.asarray(labels).reshape(len(y_pred), -1),
                }))
        return res

    def dump_predictions(self, indices, path: str, use_ema: bool = False,
                         split: Optional[str] = None):
        """logit_..., label_... rows, one per index."""
        logits, labels, _, _ = self._eval_collect(indices, use_ema, split=split)
        if logits is None:
            return
        with open(path, "w", newline="") as f:
            writer = csv.writer(f)
            n_logit = len(np.atleast_1d(logits[0]))
            n_label = len(np.atleast_1d(labels[0]))
            writer.writerow([f"logit_{i}" for i in range(n_logit)]
                            + [f"label_{i}" for i in range(n_label)])
            for row_logits, row_label in zip(logits, labels):
                writer.writerow(list(np.atleast_1d(row_logits)) + list(np.atleast_1d(row_label)))
        log_line(f"predictions dumped to {path}")

    def infer_hidden_states(self, indices, path: str, split: Optional[str] = None):
        """The pooled hidden states of `indices`, saved as npz."""
        _, _, _, arr = self._eval_collect(indices, want_hidden=True, split=split)
        arr = np.zeros((0,)) if arr is None else arr
        np.savez(path, hidden_states=arr)
        log_line(f"hidden states {arr.shape} dumped to {path}")
        return arr

    def _epoch_eval(self, epoch: int, global_step: int, ogb_name: Optional[str] = None):
        """Train subset -> valid -> EMA valid (with the EMA-best checkpoint)
        -> test (with EMA when on); one result.csv row; optional dumps."""
        tcfg = self.cfg.training
        use_ema = tcfg.optimizer.use_ema
        ogb_name = ogb_name or self.cfg.tokenization.dataset
        res: Dict[str, float] = {}
        if tcfg.k_samplers > 0 and len(self.train_idx) > 0:
            tr = self.evaluate(self.train_idx[: tcfg.k_samplers], ogb_name=ogb_name)
            res.update({f"train_{k}": v for k, v in tr.items()})
        val = self.evaluate(self.valid_idx, ogb_name=ogb_name, split="valid")
        res.update({f"valid_{k}": v for k, v in val.items()})
        if use_ema:
            val_ema = self.evaluate(self.valid_idx, use_ema=True, ogb_name=ogb_name,
                                    split="valid")
            res.update({f"valid_ema_{k}": v for k, v in val_ema.items()})
            flag, self.ema_best = metrics_mod.compare_metrics_res(
                {f"ema_{k}": v for k, v in val_ema.items()}, self.ema_best
            )
            if flag and not tcfg.eval_only:
                self.ckpt_ema_best.save(
                    epoch, self.state, {"epoch": epoch, "ema_best": dict(self.ema_best)}
                )
        if tcfg.do_test and len(self.test_idx) > 0:
            te = self.evaluate(self.test_idx, use_ema=use_ema, ogb_name=ogb_name, split="test")
            res.update({f"test_{k}": v for k, v in te.items()})
        res.update(epoch=epoch, step=global_step)
        log_line(f"eval epoch {epoch}: {res}")
        self.results.log(res)
        if tcfg.save_pred:
            out = tcfg.output_dir
            self.dump_predictions(self.train_idx[: tcfg.k_samplers],
                                  os.path.join(out, "train_results.csv"))
            self.dump_predictions(self.valid_idx, os.path.join(out, "valid_results.csv"),
                                  split="valid")
            if len(self.test_idx) > 0:
                self.dump_predictions(self.test_idx, os.path.join(out, "test_results.csv"),
                                      use_ema=use_ema, split="test")
        if tcfg.dump_infer and len(self.test_idx) > 0:
            self.infer_hidden_states(
                self.test_idx, os.path.join(tcfg.output_dir, f"hidden_states_epoch{epoch}.npz"),
                split="test")
        key = next((k for k in res if str(k).startswith("valid_")), None)
        if key and metrics_mod.is_better(res, self.best, key):
            self.best = dict(res)
        return res

    def run_eval_only(self):
        """Restore every saved epoch of `pretrain_cpt` (or `output_dir`) and
        run the eval surface on it."""
        tcfg = self.cfg.training
        ckpt = Checkpointer(os.path.join(tcfg.pretrain_cpt or tcfg.output_dir, "ckpt"))
        for ep in ckpt.all_steps():
            self.state, _ = ckpt.restore(self.state, step=ep)
            self._epoch_eval(ep, global_step=0)
        return self.best

    def run(self):
        tcfg = self.cfg.training
        try:
            return self.run_eval_only() if tcfg.eval_only else self._run()
        finally:
            for loader in (self.loader, *self.eval_loaders.values()):
                loader.close()

    def _run(self):
        tcfg = self.cfg.training
        global_step = 0
        for epoch in range(self.epochs):
            # the dataset's epoch (its node permutations), as the JAX
            # pipeline resets it; the loader sends it to its workers
            if hasattr(self.dataset, "reset_samples"):
                self.dataset.reset_samples(epoch, tcfg.seed)
            idx = np.random.default_rng((tcfg.seed, epoch)).permutation(self.train_idx)
            for batch in self.loader.prefetched(idx, epoch):
                self.state, metrics = self.train_step(
                    self.state, to_torch(batch.data, self.device), seed=tcfg.seed
                )
                global_step += 1
                if global_step % tcfg.schedule.logging_steps == 0:
                    m = {k: float(v) for k, v in metrics.items()}
                    m.update(step=global_step, epoch=epoch)
                    log_line(f"epoch {epoch} step {global_step} loss {m['loss']:.4f}")
                    self.logger.log(m)
            self.ckpt.save(epoch, self.state, {"epoch": epoch})
            if (epoch + 1) % tcfg.epoch_per_eval == 0:
                self._epoch_eval(epoch, global_step)
        return self.best


if __name__ == "__main__":
    import argparse

    from ..config import load_config

    ap = argparse.ArgumentParser()
    ap.add_argument("--config", default=None)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("overrides", nargs="*")
    args = ap.parse_args()
    FinetunePipeline(load_config(args.config, args.overrides), device=args.device).setup().run()
