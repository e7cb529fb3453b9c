"""Public closed-loop op: per-run noise streams and the kernel dispatch;
port of `repro.kernels.closed_loop.ops`.

`closed_loop_sim` takes packed per-run profile / gain rows and either
per-run seeds or a ready noise tensor, and returns (traces, final-carry
dict) — the contract of `ref.closed_loop_ref`. CUDA tensors go to the
CUDA kernel: seeds to its seeds route (`kernel.closed_loop_seeds_cuda`,
which generates the streams of `draw_noise` inside the kernel), a noise
tensor to its tensor route (`kernel.closed_loop_cuda`). CPU tensors go to
the plain PyTorch version on `draw_noise`; there is no other path.

`draw_noise` does not reproduce `jax.random`: it is a counter-based
generator in plain integer arithmetic (a murmur3-style mix of seed,
channel word and step), so each run's stream depends only on its seed,
its integer bits are the same on every device, and any slice of a grid
reproduces the one-shot rows exactly.
"""
from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple, Union

import torch

from repro_torch import resolve_device
from repro_torch.counter_rng import M32, mix32, unit24
from repro_torch.kernels.closed_loop import ref as R
from repro_torch.kernels.closed_loop.kernel import (
    closed_loop_cuda, closed_loop_seeds_cuda, unpack_final)

# Time is rounded up to this many steps, as the reference kernel's time
# chunk rounds it; runs are frozen (done) before the padded tail.
CHUNK_T = 64

# int64 elements per temporary while drawing: keeps a 100k-run grid's
# integer scratch to a few hundred MB
_CHUNK_ELEMS = 1 << 25
# Per channel: the 32-bit words it consumes (normals take two, by
# Box-Muller; uniforms one), in `ref.NZ_*` order.
_WORDS = {R.NZ_PROG: (0, 1), R.NZ_POW: (2, 3), R.NU_ENTER: (4,),
          R.NU_EXIT: (5,), R.NZ_HB: (6, 7)}


def _noise_words(seeds: torch.Tensor, word: int, t0: int, t1: int
                ) -> torch.Tensor:
    """The 32-bit words (as int64) of stream ``word`` at steps [t0, t1)
    for runs with int64 ``seeds`` -> (t1 - t0, B)."""
    s = seeds.to(torch.int64)
    k = mix32((s & M32) ^ 0x3C6EF372)
    k = mix32(k ^ ((s >> 32) & M32))
    k = mix32((k + (word + 1) * 0x9E3779B9) & M32)         # (B,)
    t = torch.arange(t0, t1, dtype=torch.int64, device=seeds.device)
    h = mix32((t * 0x27D4EB2F + 0x165667B1) & M32)         # (Tc,)
    return mix32((h[:, None] + k[None, :]) & M32)


def draw_noise(seeds: Union[Sequence[int], torch.Tensor], T: int,
               device: Union[str, torch.device, None] = None
               ) -> torch.Tensor:
    """Per-run noise streams: seeds (B,) -> (T, 5, B) float32 on
    ``device`` (default: the seeds' device if they are a tensor, else
    CUDA, raising without one, as the entry points do).

    Channels (`ref.NZ_*`): progress-noise z, power-noise z, drop-enter
    u, drop-exit u, heartbeat z. Uniforms lie in [0, 1); normals come
    from two uniforms by Box-Muller. Generated channel by channel in time
    chunks, so the int64 scratch stays small beside the output."""
    if device is None:
        device = (seeds.device if isinstance(seeds, torch.Tensor)
                  else resolve_device(None))
    seeds = torch.as_tensor(seeds, dtype=torch.int64, device=device)
    if seeds.dim() != 1:
        raise ValueError(f"seeds must be (B,), got {tuple(seeds.shape)}")
    B = seeds.shape[0]
    out = torch.empty((T, R.N_NOISE, B), dtype=torch.float32,
                      device=seeds.device)
    step = max(1, _CHUNK_ELEMS // max(B, 1))
    for t0 in range(0, T, step):
        t1 = min(T, t0 + step)
        for ch, words in _WORDS.items():
            u = unit24(_noise_words(seeds, words[0], t0, t1))
            if len(words) == 2:
                u2 = unit24(_noise_words(seeds, words[1], t0, t1))
                # Box-Muller; 1 - u lies in (0, 1], so the log is finite
                u = (torch.sqrt(-2.0 * torch.log(1.0 - u))
                     * torch.cos((2.0 * math.pi) * u2))
            out[t0:t1, ch] = u
    return out


def _round_up(n: int, m: int) -> int:
    return ((n + m - 1) // m) * m


def horizon(max_time: float, dt: float) -> int:
    """Steps simulated for a horizon: ceil(max_time / dt), rounded up to
    `CHUNK_T` (the reference kernel's time-chunk rule)."""
    return _round_up(int(-(-max_time // dt)), CHUNK_T)


def closed_loop_sim(prof: torch.Tensor, gains: torch.Tensor,
                    seeds_or_noise, *, total_work: float, max_time: float,
                    dt: float = 1.0, summary_from: float = 0.0,
                    collect: bool = True
                    ) -> Tuple[Optional[dict], dict]:
    """Fused closed-loop runs for a flat batch.

    prof (B, 14) / gains (B, 9) packed rows (float32 or bfloat16) on one
    device; ``seeds_or_noise`` is either (B,) integer seeds (each run's
    noise is `draw_noise` of its seed) or a ready (T, 5, B) float32 noise
    tensor with T = `horizon(max_time, dt)`. Returns (traces | None,
    final): traces are (T, B) float32 per `ref.TRACE_KEYS`, final the
    `ref` carry dict of (B,) leaves + (B, BINS) histograms.

    On CUDA tensors seeds take the kernel's seeds route, which generates
    the noise inside the kernel, and a noise tensor its tensor route; a
    refused build or launch raises. On CPU tensors the plain version runs
    on `draw_noise` of the seeds or on the given noise.
    """
    B = prof.shape[0]
    T = horizon(max_time, dt)
    scalars = (total_work, max_time, dt, summary_from)
    given = (isinstance(seeds_or_noise, torch.Tensor)
             and seeds_or_noise.is_floating_point())
    if given and tuple(seeds_or_noise.shape) != (T, R.N_NOISE, B):
        raise ValueError(f"noise must be {(T, R.N_NOISE, B)} for "
                         f"max_time={max_time}, dt={dt}; got "
                         f"{tuple(seeds_or_noise.shape)}")
    if prof.device.type == "cuda":
        prof, gains = prof.contiguous(), gains.contiguous()
        if given:
            traces, blocks = closed_loop_cuda(
                prof, gains, seeds_or_noise.contiguous(), scalars, collect)
        else:
            seeds = torch.as_tensor(seeds_or_noise, dtype=torch.int64,
                                    device=prof.device).contiguous()
            traces, blocks = closed_loop_seeds_cuda(prof, gains, seeds, T,
                                                    scalars, collect)
        return traces, unpack_final(*blocks)
    noise = (seeds_or_noise if given
             else draw_noise(seeds_or_noise, T, prof.device))
    return R.closed_loop_ref(prof, gains, noise, *scalars, collect)
