"""CSV and stdout logs: `CsvLogger` and `log_line` of
`graphgpt_tpu/utils/logging.py`."""

from __future__ import annotations

import csv
import os
import time
from typing import Dict


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
