"""Device resolution shared by the port's entry points.

Entry points run on the card unless the caller asks for the CPU. Asking for
CUDA on a machine without a CUDA device is an error: nothing carries on on
the CPU behind the caller's back.
"""

from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    """``device`` as a ``torch.device``; raises if it names CUDA and no
    CUDA device is present."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device!r} requested but no CUDA device is available; "
            "pass device='cpu' to run the plain PyTorch path")
    return dev
