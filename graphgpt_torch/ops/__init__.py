"""Kernels and their plain PyTorch versions.

Each kernel wrapper launches its CUDA kernel for a CUDA tensor (or raises)
and runs the kernel's plain version for a CPU tensor. `reference_mode()` is
the one way to run the plain versions on the card; only the tests and
`chip_smoke.py` use it, to hold a kernel run against a plain one. The
backward wrappers read the mode when the backward runs, so a comparison
keeps forward and backward inside one block.
"""

from __future__ import annotations

import contextlib

import torch

_reference = False


@contextlib.contextmanager
def reference_mode():
    """Run every kernel wrapper's plain version inside this block."""
    global _reference
    prev, _reference = _reference, True
    try:
        yield
    finally:
        _reference = prev


def use_kernel(x: torch.Tensor, *others: torch.Tensor) -> bool:
    """True when a wrapper must launch its kernel: a CUDA tensor outside
    reference_mode. Raises on mixed devices."""
    if not x.is_cuda:
        return False
    if any(not t.is_cuda for t in others):
        raise ValueError("kernel inputs must all lie on the CUDA device")
    return not _reference


def mm_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b summed and returned in fp32 whatever the operands' dtype (the
    JAX package's `preferred_element_type=float32`): a bf16 product on the
    card keeps its fp32 sum instead of rounding it to bf16."""
    if a.dtype == torch.float32:
        return a @ b
    if a.is_cuda:
        return torch.mm(a, b, out_dtype=torch.float32)
    return a.float() @ b.float()
