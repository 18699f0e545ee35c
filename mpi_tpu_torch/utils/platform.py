"""Device selection for the port's entry points.

Counterpart of ``mpi_tpu/utils/platform.py``. The port's entry points run on
the CUDA device; the CPU is used only when the caller asks for it by name
(``device="cpu"``), as the tests do. A missing GPU is an error, never a
silent move to the CPU.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

__all__ = ["resolve_device"]


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """The device an entry point runs on.

    ``None`` means the CUDA device, and raises ``RuntimeError`` when CUDA
    is absent. Any other value is taken as the caller's explicit choice.

    Also pins float32 matrix products and convolutions to full float32
    (``allow_tf32 = False`` for both), so float32 results on the card are
    comparable with the CPU and the JAX reference; TF32 keeps only about
    three decimal digits.
    """
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "mpi_tpu_torch: no CUDA device is available; pass "
                "device='cpu' to run the plain PyTorch path on the CPU")
        return torch.device("cuda")
    return torch.device(device)
