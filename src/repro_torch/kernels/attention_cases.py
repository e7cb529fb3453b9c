"""The shapes at which the two attention kernels are held to their plain
versions on the card, the inputs for them, and the bar.

Used by `tests/test_torch_cuda.py` and `chip_smoke.py`. The cases are
`tests/test_kernels.py`'s, plus head_dim 120 (h2o-danube-3-4b), head_dim
20 (the SIMT route's, in both dtypes), ragged lengths, a sliding window
narrower than a KV tile (rows whose first visited tile is fully masked),
the qwen3-8b serving shapes, the
starcoder2-3b training shape and the decode shapes of the serve example
(`repro_torch.examples.serve_batched`, head_dim 16).

Tolerance, and why: float32 2e-5 absolute and relative (the kernels and
the plain versions sum in different orders); bfloat16 2e-2 (the output
is rounded to bf16's 8 bits, and the probabilities are rounded at other
places: the plain version rounds the normalised ones to bf16 before the
P V product, the tensor-core flash kernel the unnormalised ones, e^(s -
m) against the running max, dividing after; the decode kernel keeps 16
bits of them, a bf16 part and a bf16 remainder; the TPU kernels keep
them in float32).

At the serving shape 2e-2 is loose next to the outputs (about 0.05 over
a thousand keys), so the flash kernel is held there twice more: at the
same shape in float32 (2e-5), and in bf16 against the plain version
computed in float32 from the same bf16 inputs, row by row
(`row_rel_err` against `ROW_REL_BAR`). `drop_kv_tile` models a kernel
that loses one KV tile for some rows; `chip_smoke.py` prints its reading
beside the bar.

The backward (`kernel.flash_attention_bwd_cuda`) is held at the same
shapes to the plain route's gradients (autograd through `attention_ref`)
computed in float32 on the same inputs. float32: every grad within
`BWD_F32_BAR` of its largest element (the kernels sum in tiles and head
groups, the plain version over whole matrices). bfloat16: the relative L2
error within `BWD_FLOOR_X` times the floor, the plain route run in bf16
and read the same way (`bwd_readings`); the kernels round P and dS to
bf16 for their products, the plain route only P. `drop_key_tile` models a
backward that loses one key tile's dK and dV.
"""
from __future__ import annotations

from typing import Tuple

import torch

# (B, S, H, K, hd, causal, window, dtype)
FLASH_CASES = [
    (2, 128, 4, 2, 64, True, None, "float32"),
    (1, 256, 8, 8, 32, True, None, "float32"),
    (2, 128, 4, 1, 64, False, None, "float32"),
    (1, 256, 4, 2, 64, True, 64, "float32"),
    (1, 192, 6, 2, 48, True, None, "float32"),
    (2, 128, 4, 2, 64, True, None, "bfloat16"),
    (1, 128, 4, 4, 128, True, 32, "bfloat16"),
    (1, 300, 4, 2, 120, True, 100, "float32"),   # ragged, hd 120
    (1, 256, 4, 2, 64, True, 8, "float32"),      # window < a KV tile
    (1, 200, 4, 2, 128, False, 50, "bfloat16"),  # two-sided window
    (2, 512, 32, 8, 120, True, 4096, "bfloat16"),  # danube widths
    (1, 256, 4, 2, 64, True, 8, "bfloat16"),     # window < a tile, bf16
    (1, 300, 4, 2, 120, True, 100, "bfloat16"),  # ragged, hd 120, bf16
    # hd 20, not a multiple of 8: the SIMT kernels (`kernel.route`)
    (1, 128, 4, 2, 20, True, None, "float32"),
    (1, 128, 4, 2, 20, True, None, "bfloat16"),
]
# qwen3-8b prefill, batch 8 x 1,024 tokens, per layer
FLASH_SERVE = (8, 1024, 32, 8, 128, True, None, "bfloat16")
FLASH_SERVE_F32 = FLASH_SERVE[:7] + ("float32",)
# starcoder2-3b training, batch 4 x 2,048 tokens, per layer (24 heads over
# 2 KV heads)
FLASH_TRAIN = (4, 2048, 24, 2, 128, True, None, "bfloat16")
FLASH_TRAIN_F32 = FLASH_TRAIN[:7] + ("float32",)

# (B, T, H, K, hd, pos, ring, chunk, dtype); chunk None: the default split
DECODE_CASES = [
    (2, 256, 4, 2, 64, 255, False, 64, "float32"),
    (1, 512, 8, 8, 32, 300, False, 128, "float32"),  # partially filled
    (2, 128, 4, 1, 64, 90, True, 32, "float32"),     # ring buffer
    (2, 256, 24, 8, 64, 255, False, 64, "float32"),  # G = 3
    (2, 100, 8, 2, 120, 170, True, None, "bfloat16"),  # ring wrapped, hd 120
    (3, 1000, 16, 1, 128, 700, False, 96, "float32"),  # G = 16, ragged
    (1, 512, 8, 2, 64, 400, False, 32, "bfloat16"),  # bf16, 16 splits
    # the serve example (starcoder2-3b --reduced, batch 4, 64 + 96
    # tokens): its first decode step (two splits empty) and its last
    (4, 160, 4, 2, 16, 64, False, 32, "float32"),
    (4, 160, 4, 2, 16, 159, False, 32, "float32"),
]
# qwen3-8b decode, batch 8, the last step of a 1,024 + 32 serve
DECODE_SERVE = (8, 1056, 32, 8, 128, 1055, False, None, "bfloat16")


def tolerance(dtype: str) -> dict:
    return dict(atol=2e-2, rtol=2e-2) if dtype == "bfloat16" \
        else dict(atol=2e-5, rtol=2e-5)


# Rounding to bf16 (8 significant bits) moves each element by at most
# 2^-8 of itself, so one output row (a query token of one head) of a
# kernel that computes in float32 is within 2^-8 = 3.91e-3 relative L2
# of the float32 result on the same inputs; the rest of the bar is room
# for float32 summation order (about 1e-6). The tensor-core flash kernel
# rounds P to bf16 too and still reads under the bar (3.25e-3 on an H100,
# PERF.md), where the plain version in bf16, rounding P after normalising
# it, reads 4.37e-3.
ROW_REL_BAR = 4e-3


def row_rel_err(got: torch.Tensor, want: torch.Tensor) -> float:
    """The largest relative L2 error of one row of ``got`` [..., hd]
    against ``want``, in float32."""
    got, want = got.float(), want.float()
    err = (got - want).norm(dim=-1) / want.norm(dim=-1).clamp_min(1e-30)
    return float(err.max())


def drop_kv_tile(q, k, v, rows: slice, keys: slice, *, causal: bool = True,
                 window=None) -> torch.Tensor:
    """A faulty flash kernel's output: the attention of the plain version,
    in float32, with the keys ``keys`` hidden from the query rows
    ``rows``, rounded to q's type. q [B,S,H,hd]; k, v [B,T,K,hd]."""
    S, T, G = q.shape[1], k.shape[1], q.shape[2] // k.shape[2]
    qpos = torch.arange(S, device=q.device)[:, None]
    kpos = torch.arange(T, device=q.device)[None, :]
    mask = torch.ones((S, T), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kpos <= qpos
    if window is not None:
        mask &= (qpos - kpos) < window
    mask[rows, keys] = False
    kf = k.float().repeat_interleave(G, dim=2)
    vf = v.float().repeat_interleave(G, dim=2)
    s = torch.einsum("bqhd,bthd->bhqt", q.float(), kf) * q.shape[-1] ** -0.5
    p = torch.softmax(torch.where(mask, s, -1e30), dim=-1)
    return torch.einsum("bhqt,bthd->bqhd", p, vf).to(q.dtype)


BWD_F32_BAR = 1e-4
BWD_FLOOR_X = 2.0


def rel_l2(got: torch.Tensor, want: torch.Tensor) -> float:
    """Relative L2 error of ``got`` against ``want``, in float32."""
    got, want = got.float(), want.float()
    return float((got - want).norm() / want.norm().clamp_min(1e-30))


def plain_route_grads(q, k, v, g, *, causal=True, window=None):
    """(dq, dk, dv): autograd through `attention_ref` on detached copies
    of q, k, v (the port's plain route), cotangent g."""
    from repro_torch.kernels.flash_attention.ref import attention_ref
    qkv = [x.detach().requires_grad_() for x in (q, k, v)]
    with torch.enable_grad():
        o = attention_ref(*qkv, causal=causal, window=window)
        return torch.autograd.grad(o, qkv, g)


def bwd_readings(q, k, v, g, got, *, causal=True, window=None):
    """For a backward's ``got`` = (dq, dk, dv) on (q, k, v, g): (errors,
    floors, bars). float32: errors are max |got - want| / max |want|
    against the plain route, floors None, bars `BWD_F32_BAR`. bfloat16:
    errors are relative L2 against the plain route in float32 on the same
    bf16 inputs, floors the plain route in bf16 read the same way, bars
    `BWD_FLOOR_X` times the floors."""
    want = plain_route_grads(*(x.float() for x in (q, k, v)), g.float(),
                             causal=causal, window=window)
    if q.dtype == torch.float32:
        errs = [float((a - b).abs().max() / b.abs().max())
                for a, b in zip(got, want)]
        return errs, None, [BWD_F32_BAR] * 3
    floor = plain_route_grads(q, k, v, g, causal=causal, window=window)
    floors = [rel_l2(a, b) for a, b in zip(floor, want)]
    return ([rel_l2(a, b) for a, b in zip(got, want)], floors,
            [BWD_FLOOR_X * f for f in floors])


def drop_key_tile(grads, keys: slice):
    """A faulty backward's (dq, dk, dv): dk and dv of the keys ``keys``
    zeroed (one KV tile's accumulators lost)."""
    dq, dk, dv = (x.clone() for x in grads)
    dk[:, keys] = 0
    dv[:, keys] = 0
    return dq, dk, dv


def grad_output(q: torch.Tensor, seed: int = 3) -> torch.Tensor:
    """The cotangent g for a backward at q's shape, dtype and device."""
    g = torch.Generator().manual_seed(seed)
    return torch.randn(q.shape, generator=g).to(q.device, q.dtype)


def _randn(shape, gen, dtype, device):
    return torch.randn(shape, generator=gen).to(device, getattr(torch,
                                                                dtype))


def flash_inputs(case, device, seed: int = 0
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """q [B,S,H,hd], k and v [B,S,K,hd] for a FLASH_CASES entry."""
    B, S, H, K, hd, _, _, dtype = case
    g = torch.Generator().manual_seed(seed)
    return (_randn((B, S, H, hd), g, dtype, device),
            _randn((B, S, K, hd), g, dtype, device),
            _randn((B, S, K, hd), g, dtype, device))


def k_positions(T: int, pos: int, ring: bool, device) -> torch.Tensor:
    """Absolute position per cache slot, -1 where never written: a ring
    of T slots, or a linear cache filled up to ``pos``."""
    slots = torch.arange(T)
    if ring:
        kp = pos - torch.remainder(pos - slots, T)
        kp = torch.where(kp >= 0, kp, -1)
    else:
        kp = torch.where(slots <= pos, slots, -1)
    return kp.to(device, torch.int32)


def decode_inputs(case, device, seed: int = 0):
    """(q [B,H,hd], k, v [B,T,K,hd], k_pos [T], pos, chunk) for a
    DECODE_CASES entry."""
    B, T, H, K, hd, pos, ring, chunk, dtype = case
    g = torch.Generator().manual_seed(seed)
    q = _randn((B, H, hd), g, dtype, device)
    k = _randn((B, T, K, hd), g, dtype, device)
    v = _randn((B, T, K, hd), g, dtype, device)
    return q, k, v, k_positions(T, pos, ring, device), pos, chunk
