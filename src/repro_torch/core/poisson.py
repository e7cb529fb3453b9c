"""Exact Poisson heartbeat counts from per-run counter streams: the
scan engine's stand-in for ``jax.random.poisson(khb, lam)``
(`repro.core.sim.engine_step`).

The algorithm is the one ``jax.random.poisson`` runs: Knuth's product
method below lam = 10 (the count is the number of uniform products that
stay above exp(-lam)), Hörmann's transformed rejection (PTRS) at 10 and
above. Both run a fixed number of candidate rounds, all at once as a
(rounds, B) slab, so a step never waits on the host: `KNUTH_ROUNDS`
products leave a draw unresolved only if the count reaches
`KNUTH_ROUNDS` (P < 5e-18 at lam < 10), and `PTRS_ROUNDS` rounds
leave it unresolved only if every candidate is rejected (P < 4e-15 at
lam >= 10, whose acceptance rate is at least 0.75). An unresolved draw is
counted on the device, and `PoissonStream.check` raises after the run if
there was one: a draw is never approximated.

The uniforms come from the port's counter generator (`kernels.
closed_loop.ops`: a murmur3-style mix of seed, stream word and step),
on stream words beside the closed-loop noise channels' (`ops._WORDS`,
words 0-7). Each run's count at a step depends only on its seed, the
step index and its rate, so a sub-grid or a chunk reproduces the
one-shot rows exactly.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.counter_rng import unit24
from repro_torch.kernels.closed_loop import ops

KNUTH_ROUNDS = 48
PTRS_ROUNDS = 24
# below this rate Knuth's method runs, at and above it PTRS
KNUTH_MAX_LAM = 10.0
# stream words: KNUTH_ROUNDS for Knuth's uniforms, then PTRS_ROUNDS
# (u, v) pairs, after the closed-loop noise channels' words 0-7
FIRST_WORD = 8
N_WORDS = KNUTH_ROUNDS + 2 * PTRS_ROUNDS


def poisson_from_uniforms(lam: torch.Tensor, uk: torch.Tensor,
                          u: torch.Tensor, v: torch.Tensor
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Poisson counts at rates ``lam`` (B,) float32 from given uniforms in
    [0, 1): ``uk`` (KNUTH_ROUNDS, B) for Knuth's products, ``u`` and ``v``
    (PTRS_ROUNDS, B) for the PTRS candidates. Returns (counts (B,) int32,
    unresolved (B,) bool)."""
    use_knuth = torch.isnan(lam) | (lam < KNUTH_MAX_LAM)
    # Knuth: the count is the number of prefix products of uniforms that
    # stay above exp(-lam), in logs
    lam_k = torch.where(use_knuth, lam, torch.zeros_like(lam))
    above = torch.cumsum(torch.log(uk), 0) > -lam_k
    count_k = above.sum(0)
    knuth_open = above[-1]

    # PTRS (Hörmann 1993), in the float32 arithmetic jax.random uses
    lam_r = torch.where(use_knuth, torch.full_like(lam, 1e5), lam)
    log_lam = torch.log(lam_r)
    b = 0.931 + 2.53 * torch.sqrt(lam_r)
    a = -0.059 + 0.02483 * b
    inv_alpha = 1.1239 + 1.1328 / (b - 3.4)
    v_r = 0.9277 - 3.6224 / (b - 2)
    u = u - 0.5
    us = 0.5 - torch.abs(u)
    k = torch.floor((2 * a / us + b) * u + lam_r + 0.43)
    s = torch.log(v * inv_alpha / (a / (us * us) + b))
    t = -lam_r + k * log_lam - torch.lgamma(k + 1)
    accept1 = (us >= 0.07) & (v <= v_r)
    reject = (k < 0) | ((us < 0.013) & (v > us))
    accept = accept1 | (~reject & (s <= t))
    # the first accepted candidate (argmax returns the first maximum)
    first = torch.argmax(accept.to(torch.uint8), 0, keepdim=True)
    count_p = torch.gather(k, 0, first)[0]
    ptrs_open = ~accept.any(0)

    counts = torch.where(use_knuth, count_k.to(torch.float32), count_p)
    counts = torch.where(lam == 0, torch.zeros_like(counts), counts)
    unresolved = torch.where(use_knuth, knuth_open, ptrs_open) & (lam != 0)
    return counts.to(torch.int32), unresolved


class PoissonStream:
    """Poisson counts for a batch of runs, one draw per run and step.

    ``stream(lam, step)`` draws each run's count at rate ``lam`` (B,) for
    step index ``step`` (a Python int) from its seed's words; unresolved
    draws add to `unresolved`, a device counter, and `check` raises if
    any was left (one host sync, after the run)."""

    def __init__(self, seeds: torch.Tensor):
        seeds = torch.as_tensor(seeds, dtype=torch.int64)
        self.keys = ops.seed_keys(seeds, FIRST_WORD, N_WORDS)
        self.unresolved = torch.zeros((), dtype=torch.int64,
                                      device=seeds.device)

    def uniforms(self, step: int) -> torch.Tensor:
        """The (N_WORDS, B) uniforms of every run at ``step``."""
        return unit24(ops.stream_words(self.keys, ops.step_hash(int(step))))

    def __call__(self, lam: torch.Tensor, step: int) -> torch.Tensor:
        w = self.uniforms(step)
        ku = KNUTH_ROUNDS
        counts, open_ = poisson_from_uniforms(
            lam, w[:ku], w[ku::2], w[ku + 1::2])
        self.unresolved += open_.sum()
        return counts

    def check(self) -> None:
        n = int(self.unresolved)
        if n:
            raise RuntimeError(
                f"{n} Poisson heartbeat draw(s) left unresolved after "
                f"{KNUTH_ROUNDS} Knuth / {PTRS_ROUNDS} PTRS rounds")
