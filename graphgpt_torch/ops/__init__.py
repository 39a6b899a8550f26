"""Kernels and their plain PyTorch versions.

Each kernel wrapper launches its CUDA kernel for a CUDA tensor (or raises)
and runs the kernel's plain version for a CPU tensor. `reference_mode()` is
the one way to run the plain versions on the card; only the tests and
`chip_smoke.py` use it, to hold a kernel run against a plain one.
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
    reference_mode. Raises where this inference-only slice cannot serve:
    mixed devices, or grad mode on with an input that requires grad."""
    if not x.is_cuda:
        return False
    if any(not t.is_cuda for t in others):
        raise ValueError("kernel inputs must all lie on the CUDA device")
    if _reference:
        return False
    if torch.is_grad_enabled() and any(t.requires_grad for t in (x, *others)):
        raise NotImplementedError(
            "the CUDA kernels are forward-only (inference); the backward "
            "kernels come with the training slice"
        )
    return True
