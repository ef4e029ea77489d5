"""imitation_tpu_torch: the PyTorch + CUDA port of ``imitation_tpu`` for Hopper.

The package mirrors ``imitation_tpu``'s module paths and public names so each
piece has an obvious counterpart, but it is written in PyTorch idiom:
``nn.Module``s that own their parameters, plain functions on tensors, an
explicit ``device`` and an explicit ``torch.Generator``. The two functions the
JAX package wrote as Pallas kernels (GAE and the discriminator-batch gather)
are hand-written CUDA C++ here (``csrc/``), built with ``nvcc`` at first use
and bound with ``ctypes`` (``ops/kernels.py``).

Entry points run on the GPU unless the caller passes ``device="cpu"``; there
is no silent fallback to the CPU.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

__version__ = "0.1.0"

Device = Union[str, torch.device]


def default_device(device: Optional[Device] = None) -> torch.device:
    """Resolves ``device``, defaulting to CUDA.

    Raises when CUDA is asked for (explicitly or by default) and none is
    available: the CPU is used only when the caller passes ``"cpu"``.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "imitation_tpu_torch runs on a CUDA device by default and none is "
            "available; pass device='cpu' to run on the CPU."
        )
    return dev


def make_generator(seed: int, device: Device) -> torch.Generator:
    """A ``torch.Generator`` on ``device`` seeded with ``seed``."""
    return torch.Generator(device=torch.device(device)).manual_seed(int(seed))
