"""The dense feed-forward: RMSNorm, then GELU (tanh) or SwiGLU."""
from __future__ import annotations

import torch.nn.functional as F

from portbench.reference.ops import gelu_tanh, mm, rms


def ff(p: dict, x, spec: dict, prec: str):
    h = rms(x, p["ff.ln"], spec["norm_eps"])
    up = mm(h, p["ff.w_up"], prec)
    if spec["mlp"] == "swiglu":
        act = F.silu(mm(h, p["ff.w_gate"], prec)) * up
    elif spec["mlp"] == "gelu_tanh":
        act = gelu_tanh(up)
    else:
        raise ValueError(spec["mlp"])
    return mm(act, p["ff.w_down"], prec)
