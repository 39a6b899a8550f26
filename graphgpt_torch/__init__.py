"""GraphGPT in PyTorch for NVIDIA Hopper.

A port of the JAX package `graphgpt_tpu` that imports nothing from it (nor
from JAX): module paths mirror the JAX package's, so each counterpart is easy
to find. The kernels that the JAX package writes in Pallas are hand-written
CUDA C++ here (`csrc/`), built with nvcc at first use (`ops/_build.py`).

Entry points that create state (the model's constructor, the weight
converter, the sampler) put it on `cuda` unless the caller passes
`device="cpu"`; without a card and without that argument they raise.
"""

from __future__ import annotations

__version__ = "0.1.0"


def resolve_device(device=None):
    """`cuda` unless the caller names another device, as a torch.device;
    raises without a card. torch is imported here, not with the package:
    the loader's spawned workers import the package's data modules, which
    need only numpy."""
    import torch

    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "graphgpt_torch: CUDA is not available; pass device='cpu' to run "
            "the plain PyTorch versions on the CPU"
        )
    return dev
