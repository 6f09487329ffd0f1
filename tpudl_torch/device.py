"""Device resolution and f32 precision for the port's entry points."""

from __future__ import annotations

import contextlib

import torch

from tpudl_torch.testing import tsan as _tsan

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


# process-wide state of full_f32: how many blocks are open, on any thread,
# and the flags the first of them found
_F32_LOCK = _tsan.named_lock("device.full_f32")
_f32_depth = 0
_f32_saved = None


@contextlib.contextmanager
def full_f32():
    """Switch TF32 off for cuDNN convolutions and cuBLAS products while the
    block runs, and restore the process's settings after. PyTorch lets
    cuDNN run f32 convolutions in TF32 (10-bit mantissa) by default, and a
    caller may allow it for matmuls (``allow_tf32``,
    ``set_float32_matmul_precision``), so an f32 model or step would
    otherwise not compute in f32, as tpudl does.

    The flags are process state, so the blocks of all threads share one
    count under a lock: the first block to enter saves and clears the
    flags, and the last to exit restores them. While any thread is inside
    a block, both flags stay off."""
    global _f32_depth, _f32_saved
    cudnn, matmul = torch.backends.cudnn, torch.backends.cuda.matmul
    with _F32_LOCK:
        if _f32_depth == 0:
            _f32_saved = cudnn.allow_tf32, matmul.allow_tf32
            cudnn.allow_tf32 = matmul.allow_tf32 = False
        _f32_depth += 1
    try:
        yield
    finally:
        with _F32_LOCK:
            _f32_depth -= 1
            if _f32_depth == 0:
                cudnn.allow_tf32, matmul.allow_tf32 = _f32_saved
                _f32_saved = None
