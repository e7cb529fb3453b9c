"""Products, norms and rotations of the references, and the float8
rounding of the control."""
from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F

PRECS = ("fp32", "fp8")
E4M3_MAX = 448.0


@contextlib.contextmanager
def float32_exact():
    """float32 products in float32: TF32 off for matmuls and cuDNN."""
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old


class _Fp8(torch.autograd.Function):
    """Rounding to float8 in the forward; the gradient passes through."""

    @staticmethod
    def forward(ctx, t):
        s = t.abs().amax().clamp(min=1e-30) / E4M3_MAX
        return (t / s).to(torch.float8_e4m3fn).float() * s

    @staticmethod
    def backward(ctx, g):
        return g


def fp8(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded to float8 e4m3 with one scale (its largest magnitude
    to 448), back in float32."""
    return _Fp8.apply(t.float())


def q(t: torch.Tensor, prec: str) -> torch.Tensor:
    """A product's operand in ``prec``: float32, or rounded to float8."""
    if prec == "fp32":
        return t.float()
    if prec == "fp8":
        return fp8(t)
    raise ValueError(prec)


def mm(a: torch.Tensor, b: torch.Tensor, prec: str) -> torch.Tensor:
    """a [..., k] @ b [k, n] in float32 from operands in ``prec``."""
    return q(a, prec) @ q(b, prec)


def rms(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    x = x.float()
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) \
        * scale.float()


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float
         ) -> torch.Tensor:
    """x [B, S, H, hd] rotated by position, each head split into halves
    (not interleaved); positions [S] or [B, S]."""
    hd = x.shape[-1]
    half = hd // 2
    inv = 1.0 / (theta ** (torch.arange(0, hd, 2, dtype=torch.float32,
                                        device=x.device) / hd))[:half]
    ang = positions.float()[..., None] * inv          # [(B,) S, half]
    if ang.dim() == 2:
        ang = ang[None]
    cos, sin = torch.cos(ang)[:, :, None], torch.sin(ang)[:, :, None]
    x1, x2 = x[..., :half].float(), x[..., half:2 * half].float()
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x, approximate="tanh")
