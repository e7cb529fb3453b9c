"""Hand-written CUDA kernels of the port, one package per TPU kernel of
`repro.kernels`. Each ships ``ref.py`` (the plain PyTorch version, also
the CPU path), ``kernel.py`` (the ctypes wrapper with its launch count),
``ops.py`` (the public op) and ``csrc/`` (the CUDA source, built at
first use by `repro_torch.kernels._build`). ``adamw`` replaces no TPU
kernel: it has ``kernel.py`` and ``csrc/``, and its plain version and
public op are `repro_torch.optim.adamw`."""


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


def host_op(name: str):
    """A profiler op named ``name`` (function scope) around a launch made
    through ctypes, while a `torch.profiler` session records: the trace
    links a kernel to the innermost such op on the launching thread, and
    a launch outside any (a ctypes call runs under none of PyTorch's)
    links to no host op. A shared null context while none records."""
    import contextlib

    from torch.autograd import profiler
    if not profiler._is_profiler_enabled:
        return contextlib.nullcontext()
    import torch
    return torch._C._profiler._RecordFunctionFast(name)

