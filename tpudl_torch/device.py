"""Device resolution and f32 precision for the port's entry points."""

from __future__ import annotations

import contextlib

import torch

__all__ = ["resolve_device", "full_f32"]


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


@contextlib.contextmanager
def full_f32():
    """Switch TF32 off for cuDNN convolutions and cuBLAS products while the
    block runs, and restore the process's settings after. PyTorch lets
    cuDNN run f32 convolutions in TF32 (10-bit mantissa) by default, and a
    caller may allow it for matmuls (``allow_tf32``,
    ``set_float32_matmul_precision``), so an f32 model or step would
    otherwise not compute in f32, as tpudl does. The flags are process
    state: two threads inside at once can restore each other's."""
    cudnn, matmul = torch.backends.cudnn, torch.backends.cuda.matmul
    saved = cudnn.allow_tf32, matmul.allow_tf32
    cudnn.allow_tf32 = matmul.allow_tf32 = False
    try:
        yield
    finally:
        cudnn.allow_tf32, matmul.allow_tf32 = saved
