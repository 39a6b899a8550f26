"""Datasets over several sub-datasets.

Counterpart of `graphgpt_tpu/data/partition.py` (`EnsembleDataset`
:174-195). The partitioned big-graph datasets of that module wait for the
big-graph slice. One addition: `epoch`, the last epoch given to
`reset_samples`, which the loader sends with each chunk so that its spawned
workers follow the epoch (`data/loader.py`).
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

from .graph import Graph


class EnsembleDataset:
    """Concatenated dispatch over sub-datasets (EnsembleNodesEdgesMapDataset
    dataset_map.py:1092-1169 / EnsembleGraphsMapDataset:1448-1479)."""

    def __init__(self, datasets: Sequence):
        self.datasets = list(datasets)
        self._ptr = np.cumsum([0] + [len(d) for d in self.datasets])
        self.epoch = 0

    def reset_samples(self, epoch: int, seed: Optional[int] = None):
        self.epoch = epoch
        for d in self.datasets:
            if hasattr(d, "reset_samples"):
                d.reset_samples(epoch, seed)
        self._ptr = np.cumsum([0] + [len(d) for d in self.datasets])

    def __len__(self):
        return int(self._ptr[-1])

    def __getitem__(self, i: int) -> Graph:
        k = int(np.searchsorted(self._ptr, i, side="right") - 1)
        g = self.datasets[k][i - int(self._ptr[k])]
        g.extra["idx_of_ds"] = np.asarray(k)
        return g
