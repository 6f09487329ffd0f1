"""Device-side image prologue: cast, channel flip and resize.

Port of ``tpudl/image/ops.py`` (``sp_image_converter``, ``flattener``,
``resize_bilinear``, ``to_model_input``). Batches are NHWC, as the host
packs them. The resize is ``jax.image.resize(..., "bilinear")``'s: a
triangle filter widened by the scale when it shrinks (antialiased), with
the weights of each output pixel renormalized at the edges — torch's
``F.interpolate(mode="bilinear", antialias=True, align_corners=False)``
computes the same weights.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

__all__ = [
    "sp_image_converter",
    "flattener",
    "resize_bilinear",
    "to_model_input",
]


def sp_image_converter(batch: torch.Tensor, channel_order_in: str = "BGR",
                       channel_order_out: str = "RGB") -> torch.Tensor:
    """Packed image batch (B, H, W, C) → float32 in the model's channel
    order; BGRA ⇄ RGBA keeps alpha in place."""
    x = batch.to(torch.float32)
    if channel_order_in != channel_order_out:
        if {channel_order_in, channel_order_out} == {"BGR", "RGB"}:
            if x.shape[-1] == 4:
                x = x[..., [2, 1, 0, 3]]
            else:
                x = x.flip(-1)
        elif channel_order_out == "L" or channel_order_in == "L":
            raise ValueError("grayscale conversion must happen at decode time")
        else:
            raise ValueError(
                f"unsupported channel order {channel_order_in}->{channel_order_out}"
            )
    return x


def flattener(batch: torch.Tensor) -> torch.Tensor:
    """(B, ...) → (B, prod) float32 (TFImageTransformer's 'vector' mode)."""
    return batch.reshape(batch.shape[0], -1).to(torch.float32)


def resize_bilinear(batch: torch.Tensor, height: int,
                    width: int) -> torch.Tensor:
    """Antialiased bilinear resize (B, H, W, C) → (B, height, width, C),
    float32."""
    x = batch.to(torch.float32).permute(0, 3, 1, 2)
    y = F.interpolate(x, size=(height, width), mode="bilinear",
                      align_corners=False, antialias=True)
    return y.permute(0, 2, 3, 1)


def to_model_input(batch: torch.Tensor, height: int, width: int,
                   channel_order_in: str = "BGR",
                   channel_order_out: str = "RGB") -> torch.Tensor:
    """Convert + resize: the standard prologue of every image model."""
    x = sp_image_converter(batch, channel_order_in, channel_order_out)
    if batch.shape[1] != height or batch.shape[2] != width:
        x = resize_bilinear(x, height, width)
    return x
