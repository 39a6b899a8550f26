"""CSV and stdout logs and the throughput columns of the training log:
`CsvLogger`, `log_line`, `Throughput`, `train_flops_per_token` of
`graphgpt_tpu/utils/logging.py`, and `peak_flops_per_chip` for the card
the port runs on."""

from __future__ import annotations

import csv
import os
import time
from typing import Dict, Optional


class CsvLogger:
    def __init__(self, path: str):
        self.path = path
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        self._fieldnames = None

    def log(self, row: Dict):
        write_header = self._fieldnames is None and not os.path.exists(self.path)
        if self._fieldnames is None:
            if os.path.exists(self.path):
                with open(self.path) as f:
                    reader = csv.reader(f)
                    self._fieldnames = next(reader, None)
            if self._fieldnames is None:
                self._fieldnames = list(row.keys())
        with open(self.path, "a", newline="") as f:
            writer = csv.DictWriter(f, fieldnames=self._fieldnames, extrasaction="ignore")
            if write_header:
                writer.writeheader()
            writer.writerow(row)


def log_line(msg: str):
    print(f"[{time.strftime('%Y-%m-%d %H:%M:%S')}] {msg}", flush=True)


class Throughput:
    """Tokens/s and samples/s between logging intervals (reference
    TrainingStats.cal_speed, src/conf/stats_configs.py:69-76), by the host
    clock."""

    def __init__(self):
        self.reset()

    def reset(self):
        self.t0 = time.perf_counter()
        self.tokens = 0
        self.samples = 0

    def update(self, tokens: int, samples: int):
        self.tokens += tokens
        self.samples += samples

    def rates(self) -> Dict[str, float]:
        dt = max(time.perf_counter() - self.t0, 1e-9)
        return {"tokens_per_s": self.tokens / dt, "samples_per_s": self.samples / dt}


def train_flops_per_token(n_params: int, seq_len: int, num_layers: int, num_heads: int,
                          head_dim: int, causal: bool = False) -> float:
    """Analytic training FLOPs a token: 6 N for the forward and backward of
    the weights, plus the dense attention's 12 L P H Dh (halved under the
    causal mask), as the JAX package counts them."""
    attn = 12.0 * num_layers * seq_len * num_heads * head_dim
    if causal:
        attn *= 0.5
    return 6.0 * float(n_params) + attn


# dense bf16 peaks by device name, first match (NVIDIA's H100 data sheet:
# the PCIe card, then the SXM card, "NVIDIA H100 80GB HBM3")
_PEAKS = (("h100 pcie", 756e12), ("h100", 989e12))


def peak_flops_per_chip(device_name: Optional[str] = None) -> float:
    """The dense bf16 peak of the CUDA card the port runs on (989e12 for an
    H100 SXM), 0 for a card it does not know or without a card, so that the log
    then has no `mfu` column, as the JAX package's has none off a TPU."""
    if device_name is None:
        import torch

        if not torch.cuda.is_available():
            return 0.0
        device_name = torch.cuda.get_device_name(0)
    name = device_name.lower()
    return next((peak for key, peak in _PEAKS if key in name), 0.0)
