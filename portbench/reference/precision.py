"""The arithmetic of the plain reference, in two precisions.

``"f32"`` is the reference: every convolution and matrix product in float32,
with TF32 off. ``"control"`` is the same computation one step below what the
configurations state (a bf16 torso and float32 heads): the torso's
convolutions and products take fp8 (e4m3) operands, each tensor scaled by
its own absolute maximum, and the heads' products take TF32 operands (10
bits of mantissa). Both accumulate in float32. The control must fail the
comparison that decides ``correct``; the gradient passes straight through
the rounding of an operand.
"""

from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F

PRECISIONS = ("f32", "control")
FP8_MAX = 448.0  # the largest finite float8_e4m3fn


@contextlib.contextmanager
def no_tf32():
    """Float32 products and convolutions in float32, restored on exit."""
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def _straight_through(x: torch.Tensor, rounded: torch.Tensor) -> torch.Tensor:
    return x + (rounded - x).detach()


def fp8(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to e4m3 under a per-tensor scale (amax / 448)."""
    scale = torch.clamp(x.detach().abs().amax(), min=1e-30) / FP8_MAX
    rounded = (x.detach() / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale
    return _straight_through(x, rounded)


def tf32(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to nearest even at 10 bits of mantissa."""
    bits = x.detach().contiguous().view(torch.int32)
    lsb = (bits >> 13) & 1
    rounded = ((bits + 0x0FFF + lsb) & -0x2000).view(torch.float32)
    return _straight_through(x, rounded)


def torso_operand(x: torch.Tensor, precision: str) -> torch.Tensor:
    return fp8(x) if precision == "control" else x


def head_operand(x: torch.Tensor, precision: str) -> torch.Tensor:
    return tf32(x) if precision == "control" else x


def conv(x, weight, bias, stride, padding, precision):
    """A torso convolution; ``padding`` is (left, right, top, bottom) zeros."""
    x = F.pad(x, padding)
    return F.conv2d(torso_operand(x, precision), torso_operand(weight, precision), bias,
                    stride=stride)


def torso_dense(x, weight, bias, precision):
    return F.linear(torso_operand(x, precision), torso_operand(weight, precision), bias)


def head_dense(x, weight, bias, precision):
    return F.linear(head_operand(x, precision), head_operand(weight, precision), bias)


def same_pads(size: int, window: int, stride: int) -> tuple[int, int]:
    """(low, high) padding of ``padding="SAME"`` along one dim."""
    out = -(-size // stride)
    total = max((out - 1) * stride + window - size, 0)
    return total // 2, total - total // 2
