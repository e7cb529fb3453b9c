"""Hand-written CUDA kernels of the port, one package per TPU kernel of
`repro.kernels`. Each ships ``ref.py`` (the plain PyTorch version, also
the CPU path), ``kernel.py`` (the ctypes wrapper with its launch count),
``ops.py`` (the public op) and ``csrc/`` (the CUDA source, built at
first use by `repro_torch.kernels._build`)."""
