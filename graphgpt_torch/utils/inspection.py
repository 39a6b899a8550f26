"""Pipeline introspection (reference inspect_tokenization_results,
src/utils/inspection_utils.py:73-143): one sample's tokenize -> ids chain
and the token-length percentiles. A copy of
`graphgpt_tpu/utils/inspection.py`'s `inspect_tokenization`."""

from __future__ import annotations

from typing import Dict

import numpy as np

from .logging import log_line


def inspect_tokenization(dataset, tokenizer, n_stats: int = 256, seed: int = 0) -> Dict:
    rng = np.random.default_rng(seed)
    g = dataset[0]
    sample = tokenizer(g, rng)
    log_line("=== tokenization inspection ===")
    log_line(f"graph: num_nodes={g.num_nodes} num_edges={g.num_edges}")
    log_line(f"input_ids shape: {sample.input_ids.shape} dtype {sample.input_ids.dtype}")
    log_line(f"first rows:\n{sample.input_ids[:6]}")
    log_line(f"labels head:\n{sample.labels[:6]}")
    log_line(f"position_ids head: {sample.position_ids[:12].tolist()}")
    if sample.wgt is not None:
        log_line(f"dLM wgt: {sample.wgt:.3f}")
    lens = np.asarray([
        tokenizer(dataset[int(i)], rng).seq_len
        for i in rng.choice(len(dataset), size=min(n_stats, len(dataset)), replace=False)
    ])
    pct = np.percentile(lens, [50, 90, 99, 100]).astype(int)
    log_line(
        f"token length over {len(lens)} samples: mean {lens.mean():.1f}, "
        f"p50/p90/p99/max = {pct.tolist()}"
    )
    return {"mean_len": float(lens.mean()), "p99_len": int(pct[2]), "max_len": int(pct[3])}
