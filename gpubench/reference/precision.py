"""The reference's products, in float32 or in TF32.

``"float32"`` is plain ``torch.matmul`` and ``F.conv2d`` with TF32 off
(``use_float32`` switches it off for cuBLAS and cuDNN). ``"tf32"`` is
the control of the correctness check, the nearest precision below: each
operand of every product, forward and backward, rounded to TF32's 10
mantissa bits (round to nearest, ties to even) and the sum kept in
float32, as the tensor cores compute it. It runs the same on the CPU and
on the card.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

PRECISIONS = ("float32", "tf32")


def use_float32() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 ``x`` with its mantissa rounded to 10 bits."""
    b = x.contiguous().view(torch.int32)
    b = (b + (0xFFF + ((b >> 13) & 1))) & ~0x1FFF
    return b.view(torch.float32)


class _MatmulTF32(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, b):
        a, b = round_tf32(a), round_tf32(b)
        ctx.save_for_backward(a, b)
        return a @ b

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        g = round_tf32(g)
        return g @ b.transpose(-1, -2), a.transpose(-1, -2) @ g


class _Conv2dTF32(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, padding):
        x, w = round_tf32(x), round_tf32(w)
        ctx.save_for_backward(x, w)
        ctx.padding = padding
        return F.conv2d(x, w, padding=padding)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        g = round_tf32(g)
        p = ctx.padding
        gx = torch.nn.grad.conv2d_input(x.shape, w, g, padding=p)
        gw = torch.nn.grad.conv2d_weight(x, w.shape, g, padding=p)
        return gx, gw, None


def matmul(a: torch.Tensor, b: torch.Tensor, precision: str) -> torch.Tensor:
    """``a @ b`` of two operands of equal batch shape (or 2-D ``b``
    against a 2-D ``a``)."""
    if precision == "float32":
        return a @ b
    return _MatmulTF32.apply(a, b)


def dense(x: torch.Tensor, kernel: torch.Tensor, bias: torch.Tensor,
          precision: str) -> torch.Tensor:
    """flax ``Dense``: ``x @ kernel + bias`` over the last axis, the
    kernel [in, out]."""
    lead = x.shape[:-1]
    y = matmul(x.reshape(-1, x.shape[-1]), kernel, precision)
    return (y + bias).reshape(lead + (kernel.shape[-1],))


def conv2d(x: torch.Tensor, w_oihw: torch.Tensor, padding: int,
           precision: str) -> torch.Tensor:
    if precision == "float32":
        return F.conv2d(x, w_oihw, padding=padding)
    return _Conv2dTF32.apply(x, w_oihw, padding)
