"""Build the port's CUDA sources at first use and load them with ctypes.

Each source under a kernel package's ``csrc/`` is compiled by ``nvcc``
into a shared library with a plain C interface (no PyTorch headers, so a
build takes seconds, not minutes). Libraries go to ``build/kernels/`` at
the repository root, named by a hash of the source and the flags, so an
edited source is rebuilt and an unchanged one is loaded as it is.
Nothing is built or imported while a module is imported: `load` runs
inside the first launch.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Dict, List, Sequence

BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"

# No --use_fast_math: expf/logf/sqrtf and division stay IEEE-accurate.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")
# -fmad=false: no contraction of a*x + b into an FMA, which the plain
# PyTorch version (one op per kernel) never does. The closed-loop kernel
# needs it to follow its plain version bit for bit; the SIMT flash kernel
# and the selective scan keep it and fuse only where they say so, by
# explicit fmaf (the flash dot products; the scan's state update and its
# sum over the states), which the flag leaves alone. The sources named in
# `CONTRACTING` are built without it: the tensor-core flash kernels (bf16
# and split TF32), the flash backward (every source: it sums in its own
# order, tiles and head groups, and is held to its plain version at a
# tolerance, float32 at 1e-4 of the largest grad) and the decode kernel sum
# in their own order and are held to their plain versions at a tolerance.
EXACT_FLAGS = ("-fmad=false",)
CONTRACTING = frozenset({"flash_attention_wgmma.cu", "flash_attention_bwd.cu",
                         "flash_attention_bwd_wgmma.cu",
                         "flash_attention_tf32.cu",
                         "flash_attention_bwd_tf32.cu",
                         "decode_attention.cu"})


def flags(source: Path) -> tuple:
    """nvcc flags for ``source``: `NVCC_FLAGS`, plus `EXACT_FLAGS` unless
    its file name is in `CONTRACTING`."""
    return NVCC_FLAGS + (() if source.name in CONTRACTING else EXACT_FLAGS)


_LOADED: Dict[Path, ctypes.CDLL] = {}
_LOCK = threading.Lock()


def nvcc_path() -> str:
    """The CUDA compiler: on PATH, else under $CUDA_HOME or /usr/local/cuda."""
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found (looked on PATH, $CUDA_HOME and "
                       "/usr/local/cuda); the CUDA kernels need the CUDA "
                       "toolkit")


def library_path(source: Path) -> Path:
    digest = hashlib.sha256(source.read_bytes()
                            + " ".join(flags(source)).encode()).hexdigest()
    return BUILD_DIR / f"{source.stem}-{digest[:16]}.so"


def build(source: Path) -> Path:
    """Compile ``source`` unless its library exists; return the library."""
    lib = library_path(source)
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # compile to a private name, then rename: a concurrent process never
    # sees a half-written library
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [nvcc_path(), *flags(source), "-o", tmp, str(source)]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}) on "
                               f"{source.name}:\n{proc.stderr}")
        os.replace(tmp, lib)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return lib


def build_all(sources: Sequence[Path]) -> List[Path]:
    """Build several sources at once, one nvcc process each, all started
    together; return their libraries in order."""
    with ThreadPoolExecutor(max_workers=max(1, len(sources))) as pool:
        return list(pool.map(build, sources))


def load(source: Path) -> ctypes.CDLL:
    """Build (if needed) and load ``source``'s library, once per process."""
    with _LOCK:
        lib = _LOADED.get(source)
        if lib is None:
            lib = ctypes.CDLL(str(build(source)))
            _LOADED[source] = lib
        return lib
