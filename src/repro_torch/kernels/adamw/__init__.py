"""AdamW as multi-tensor CUDA kernels: `kernel.py` (wrapper of the norm,
finalize and update kernels in `csrc/`). It replaces no TPU kernel; the
plain version, the CPU path and the oracle is `repro_torch.optim.adamw`
(`global_norm`, `_update`), which dispatches to it."""
