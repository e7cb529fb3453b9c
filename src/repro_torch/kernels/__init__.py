"""Hand-written CUDA kernels of the port, one package per TPU kernel of
`repro.kernels`. Each ships ``ref.py`` (the plain PyTorch version, also
the CPU path), ``kernel.py`` (the ctypes wrapper with its launch count),
``ops.py`` (the public op) and ``csrc/`` (the CUDA source, built at
first use by `repro_torch.kernels._build`)."""


def check_tensor(name, x, shape, dtypes, dev) -> None:
    """Raise unless ``x`` is a contiguous tensor of ``shape`` on ``dev``
    with a dtype in ``dtypes``: what every kernel wrapper checks before a
    launch."""
    import torch
    if not isinstance(x, torch.Tensor):
        raise TypeError(f"{name} must be a tensor")
    if x.device != dev:
        raise ValueError(f"{name} is on {x.device}, expected {dev}")
    if x.dtype not in dtypes:
        raise TypeError(f"{name} has dtype {x.dtype}; the kernel takes "
                        f"{', '.join(map(str, dtypes))}")
    if tuple(x.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(x.shape)}, expected "
                         f"{tuple(shape)}")
    if not x.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
