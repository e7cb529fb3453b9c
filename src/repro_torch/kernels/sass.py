"""Instruction counts from a built CUDA library's machine code (SASS), for
the least time a kernel's time loop could take, and the opcodes a kernel
holds (`opcodes`), to show which hardware paths it was built to take.

`loop_instructions` finds a kernel's main loop in ``cuobjdump -sass``
output (the backward branch that spans the most code, or the innermost
loop that holds a given opcode) and counts the
instructions on the shortest path through one pass of it, from the loop
head to that backward branch, where every forward branch may be taken
or not. Slow paths that a pass can skip (the fix-ups of IEEE division
and square root, called out of line) are therefore not counted, nor is
anything a call executes.

A Hopper SM issues one warp instruction per scheduler per clock, 4 x 32
thread-instructions per clock: the same as its float32 lanes, so the
card's issue rate is its float32 rate with an FMA counted as one. The
count per live step over that rate is a floor on a loop's time that
counts what the compiled code does, not what the source appears to do.
"""
from __future__ import annotations

import functools
import math
import re
import subprocess
from collections import Counter
from pathlib import Path
from typing import Dict, List, Optional, Tuple

from repro_torch.kernels import _build

_FUNCTION = re.compile(r"Function\s*:\s*(\S+)")
_INSTR = re.compile(r"/\*([0-9a-f]{4,})\*/\s+([^;]*);")
_BRANCH = re.compile(r"^(@!?U?P[T0-9]+\s+)?BRA(?:\.\w+)*\s+"
                     r"(!?U?P[T0-9]+\s*,\s*)?0x([0-9a-f]+)")

Instrs = List[Tuple[int, str]]


def functions(sass: str) -> Dict[str, Instrs]:
    """``cuobjdump -sass`` text -> {mangled kernel name: [(address,
    instruction text)]}."""
    out: Dict[str, Instrs] = {}
    current = None
    for line in sass.splitlines():
        head = _FUNCTION.search(line)
        if head:
            current = out.setdefault(head.group(1), [])
            continue
        m = _INSTR.search(line)
        if m and current is not None:
            current.append((int(m.group(1), 16), m.group(2).strip()))
    return out


def opcodes(instrs: Instrs) -> Counter:
    """How many times each opcode, with its modifiers and without a guard
    predicate (``HGMMA.64x128x16.F32.BF16``, ``LDGSTS.E.BYPASS.128``),
    occurs in ``instrs``."""
    ops = Counter()
    for _, text in instrs:
        words = text.split()
        if words and words[0].startswith("@"):
            words = words[1:]
        if words:
            ops[words[0]] += 1
    return ops


def local_memory(ops: Counter) -> Dict[str, int]:
    """The local-memory loads and stores (LDL, STL: spilled registers or
    arrays the compiler could not keep in registers) among `opcodes`."""
    return {op: n for op, n in ops.items()
            if op.split(".")[0] in ("LDL", "STL")}


def _branch(text: str):
    """(target, conditional) of a BRA instruction, else None."""
    m = _BRANCH.match(text)
    if m is None:
        return None
    return int(m.group(3), 16), bool(m.group(1) or m.group(2))


def loop_body(instrs: Instrs, containing: Optional[str] = None) -> Instrs:
    """The instructions of the widest loop in ``instrs``, from its head to
    the backward branch that closes it. With ``containing``, the loop is
    the narrowest one whose body holds an instruction that starts with
    that text (an opcode such as ``"MUFU.EX2"``): the innermost loop that
    does a given kind of work."""
    loops = [(addr, b[0]) for addr, text in instrs
             if (b := _branch(text)) and b[0] < addr]
    if containing is not None:
        loops = [(t, h) for t, h in loops
                 if any(h <= a <= t and x.startswith(containing)
                        for a, x in instrs)]
    if not loops:
        raise ValueError("no loop (backward branch) in this function"
                         + (f" holds {containing!r}" if containing else ""))
    width = (lambda lt: lt[1] - lt[0]) if containing else \
        (lambda lt: lt[0] - lt[1])
    tail, head = max(loops, key=width)
    return [(a, t) for a, t in instrs if head <= a <= tail]


def loop_instructions(instrs: Instrs, containing: Optional[str] = None
                      ) -> int:
    """Fewest instructions one pass of the `loop_body` in ``instrs`` can
    issue per thread (the backward branch that closes it included)."""
    body = loop_body(instrs, containing)
    tail = body[-1][0]
    index = {a: i for i, (a, _) in enumerate(body)}
    cost = [math.inf] * len(body)
    cost[-1] = 1
    for i in range(len(body) - 2, -1, -1):
        addr, text = body[i]
        b = _branch(text)
        nexts = [i + 1] if b is None or b[1] else []
        if b is not None and addr < b[0] <= tail:
            nexts.append(index[b[0]])
        cost[i] = 1 + min((cost[j] for j in nexts), default=math.inf)
    if math.isinf(cost[0]):
        raise ValueError("no pass of the loop reaches its backward branch")
    return int(cost[0])


def library_sass(lib: Path) -> str:
    """``cuobjdump -sass`` of a built library (cuobjdump beside nvcc)."""
    tool = Path(_build.nvcc_path()).with_name("cuobjdump")
    proc = subprocess.run([str(tool), "-sass", str(lib)],
                          capture_output=True, text=True, timeout=120)
    if proc.returncode != 0:
        raise RuntimeError(f"cuobjdump failed ({proc.returncode}) on "
                           f"{lib.name}:\n{proc.stderr}")
    return proc.stdout


@functools.lru_cache(maxsize=None)
def _library_functions(lib: str, mtime_ns: int) -> Dict[str, Instrs]:
    """`functions` of ``lib``'s SASS, read once per build of the file:
    one ``cuobjdump`` and one parse of a whole library take seconds, and
    a library's kernels are read one by one."""
    return functions(library_sass(Path(lib)))


def kernel_instructions(lib: Path, name_part: str) -> Instrs:
    """The instructions of the one kernel in ``lib`` whose mangled name
    contains ``name_part``."""
    lib = Path(lib)
    funcs = {k: v for k, v in _library_functions(
        str(lib.resolve()), lib.stat().st_mtime_ns).items()
        if name_part in k}
    if len(funcs) != 1:
        raise ValueError(f"{len(funcs)} kernels in {lib.name} match "
                         f"{name_part!r}")
    return list(next(iter(funcs.values())))


def kernel_loop_instructions(lib: Path, name_part: str,
                             containing: Optional[str] = None) -> int:
    """`loop_instructions` of the one kernel in ``lib`` whose mangled name
    contains ``name_part``."""
    return loop_instructions(kernel_instructions(lib, name_part), containing)
