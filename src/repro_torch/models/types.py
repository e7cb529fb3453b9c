"""Runtime apply options (implementation knobs, not architecture config);
port of `repro.models.types`."""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class ApplyOptions:
    # attention implementation:
    #   "reference"  full-score PyTorch oracle (small shapes)
    #   "blocked"    q-block loop, flash-style memory (default)
    #   "cuda"       the hand-written CUDA kernels on a CUDA tensor; their
    #                plain PyTorch versions on a CPU tensor (the TPU
    #                kernels' "pallas" / "pallas_interpret" in one value)
    attn_impl: str = "blocked"
    block_q: int = 512
    # Mamba selective-scan implementation (the reference has no such
    # switch: its Mamba blocks always take the chunked scan):
    #   "chunked"    the reference's `_mamba_seq`: a log-depth scan inside
    #                each chunk, a carry across chunks (default)
    #   "cuda"       the hand-written CUDA selective-scan kernel on a CUDA
    #                tensor; its plain PyTorch version on a CPU tensor
    scan_impl: str = "chunked"
    # kept for field parity with the reference; PyTorch runs eagerly, so
    # there is no scan to unroll
    unroll: bool = False
    # kept for field parity: the port always loops over layer repeats
    scan_layers: bool = True
