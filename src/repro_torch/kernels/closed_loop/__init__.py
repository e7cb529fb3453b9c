"""Fused closed-loop simulation kernel: `ref.py` (plain PyTorch version,
the CPU path), `kernel.py` (wrapper of the CUDA kernel in `csrc/`),
`ops.py` (the public `closed_loop_sim` op and `draw_noise`), `parity.py`
(the bar the kernel is held to)."""
from repro_torch.kernels.closed_loop.ops import closed_loop_sim, draw_noise
from repro_torch.kernels.closed_loop.ref import closed_loop_ref

__all__ = ["closed_loop_sim", "closed_loop_ref", "draw_noise"]
