"""Device resolution for the port's entry points."""

from __future__ import annotations

import torch

__all__ = ["resolve_device"]


def resolve_device(device="cuda") -> torch.device:
    """``device=`` (a string or ``torch.device``; default ``"cuda"``) →
    ``torch.device``. Asking for CUDA on a machine without a usable card
    raises: the port never drops to the CPU unasked."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device={str(device)!r} but torch.cuda.is_available() is False; "
            "pass device='cpu' to run on the host")
    return dev
