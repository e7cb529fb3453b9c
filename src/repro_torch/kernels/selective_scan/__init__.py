"""Mamba (S6) selective scan: `ref.py` (plain PyTorch version, the CPU path
and the oracle), `kernel.py` (wrapper of the CUDA kernel in `csrc/`),
`ops.py` (the public `selective_scan` op), `cases.py` (the shapes and
tolerances the kernel is held to)."""
from repro_torch.kernels.selective_scan.ops import selective_scan
from repro_torch.kernels.selective_scan.ref import selective_scan_ref

__all__ = ["selective_scan", "selective_scan_ref"]
