"""The SASS loop counter behind chip_smoke.py's operation bound, on
hand-written listings in ``cuobjdump -sass`` form: the shortest pass
through the widest loop, forward branches taken or not, slow-path calls
skipped."""
import pytest

pytest.importorskip("torch")

from repro_torch.kernels import sass  # noqa: E402


def listing(*rows, name="_Z6kernelPf"):
    lines = [f"\t\tFunction : {name}"]
    for i, text in enumerate(rows):
        lines.append(f"        /*{16 * i:04x}*/  {text} ;"
                     f"   /* 0x{0:016x} */")
    return "\n".join(lines)


# 0: set-up; 1..9: the loop (head at 0x0010, backward branch at 0x0090).
# The division fix-up at 3..5 can be skipped by the branch at 2, and the
# if/else at 6..8 costs 2 one way (6, 7 -> 9) or 2 the other (6 -> 8).
LOOP = listing(
    "MOV R0, RZ",                        # 0x00
    "LDG.E R1, desc[UR4][R2.64]",        # 0x10 loop head
    "@!P0 BRA 0x60",                     # 0x20 skip the slow path
    "MOV R4, R1",                        # 0x30
    "CALL.REL.NOINC 0x200",              # 0x40
    "MOV R1, R4",                        # 0x50
    "@P1 BRA 0x80",                      # 0x60
    "BRA 0x90",                          # 0x70
    "FADD R1, R1, 1",                    # 0x80
    "@!P2 BRA P3, 0x10",                 # 0x90 backward branch
    "EXIT",                              # 0xa0
)


def test_functions_split_a_listing_by_kernel():
    text = LOOP + "\n" + listing("EXIT", name="_Z5otherv")
    funcs = sass.functions(text)
    assert sorted(funcs) == ["_Z5otherv", "_Z6kernelPf"]
    assert funcs["_Z6kernelPf"][2] == (0x20, "@!P0 BRA 0x60")
    assert len(funcs["_Z6kernelPf"]) == 11


@pytest.mark.parametrize("text,expected", [
    # head, skip branch, if, BRA, backward branch: 5 (the slow path and
    # the FADD arm are longer)
    (LOOP, 5),
    # with no way round the slow path, every row of the body counts
    (LOOP.replace("@!P0 BRA 0x60", "NOP").replace("@P1 BRA 0x80", "NOP"),
     8),
    # a branch out of the loop (a break) is not a pass: fall through it
    (LOOP.replace("@!P0 BRA 0x60", "@P4 BRA 0xa0"), 8),
])
def test_loop_instructions_count_the_shortest_pass(text, expected):
    (instrs,) = sass.functions(text).values()
    assert sass.loop_instructions(instrs) == expected


def test_the_widest_loop_is_the_main_one():
    inner = listing(
        "MOV R0, RZ",              # 0x00
        "FADD R0, R0, 1",          # 0x10 outer head
        "IADD3 R1, R1, 1, RZ",     # 0x20 inner head
        "@P0 BRA 0x20",            # 0x30 inner backward branch
        "FMUL R0, R0, 2",          # 0x40
        "@P1 BRA 0x10",            # 0x50 outer backward branch
    )
    (instrs,) = sass.functions(inner).values()
    assert sass.loop_instructions(instrs) == 5


def test_the_innermost_loop_holding_an_opcode():
    """A tile loop around a step loop: with ``containing`` the step loop,
    the narrowest one whose body holds the opcode, is counted."""
    nest = listing(
        "MOV R0, RZ",              # 0x00
        "LDG.E R1, desc[UR4][R2.64]",  # 0x10 tile head
        "STS [R3], R1",            # 0x20
        "MUFU.EX2 R4, R4",         # 0x30 step head
        "FMUL R5, R4, R5",         # 0x40
        "@P0 BRA 0x30",            # 0x50 step backward branch
        "BAR.SYNC.DEFER_BLOCKING 0x0",  # 0x60
        "@P1 BRA 0x10",            # 0x70 tile backward branch
    )
    (instrs,) = sass.functions(nest).values()
    assert sass.loop_instructions(instrs) == 7
    assert sass.loop_instructions(instrs, containing="MUFU.EX2") == 3
    with pytest.raises(ValueError, match="HMMA"):
        sass.loop_instructions(instrs, containing="HMMA")


def test_a_function_without_a_loop_is_refused():
    (instrs,) = sass.functions(listing("MOV R0, RZ", "EXIT")).values()
    with pytest.raises(ValueError, match="no loop"):
        sass.loop_instructions(instrs)


# a Hopper attention kernel's listing, cut down: TMA loads, mbarrier waits,
# tensor-core products, a guarded 16-byte asynchronous copy
HOPPER = listing(
    "UTMALDG.4D [UR8], [UR4]",
    "SYNCS.PHASECHK.TRANS64.TRYWAIT P0, [UR6], R3",
    "HGMMA.64x128x16.F32.BF16 R24, gdesc[UR12], RZ, !UPT",
    "HGMMA.64x128x16.F32.BF16 R24, gdesc[UR16], R24",
    "@P1 LDGSTS.E.BYPASS.128 [R5], desc[UR4][R6.64]",
    "@!P2 BRA 0x10",
    "EXIT",
)


def test_opcodes_count_mnemonics_without_guards():
    (instrs,) = sass.functions(HOPPER).values()
    ops = sass.opcodes(instrs)
    assert ops["HGMMA.64x128x16.F32.BF16"] == 2
    assert ops["UTMALDG.4D"] == 1
    assert ops["LDGSTS.E.BYPASS.128"] == 1
    assert ops["BRA"] == 1
    assert sum(ops.values()) == 7
    assert not any(op.startswith("@") for op in ops)


def test_local_memory_names_spills_only():
    """LDL / STL (spilled registers, local arrays) are told apart from the
    other loads and stores: shared, global, asynchronous copies."""
    spilling = listing(
        "STL [R1+0x4], R8",
        "LDS.128 R12, [R3]",
        "@P0 LDL.LU R8, [R1+0x4]",
        "LDL R9, [R1+0x8]",
        "LDG.E.128.CONSTANT R4, desc[UR4][R6.64]",
        "@P1 LDGSTS.E.BYPASS.128 [R5], desc[UR4][R6.64]",
        "STG.E desc[UR4][R2.64], R0",
        "EXIT",
    )
    (instrs,) = sass.functions(spilling).values()
    assert sass.local_memory(sass.opcodes(instrs)) == {
        "STL": 1, "LDL.LU": 1, "LDL": 1}
    (instrs,) = sass.functions(HOPPER).values()
    assert sass.local_memory(sass.opcodes(instrs)) == {}


def test_kernel_instructions_reads_a_library_once(tmp_path, monkeypatch):
    """One ``cuobjdump`` a built library, however many of its kernels are
    read; a library built anew (another mtime) is read again."""
    import os

    lib = tmp_path / "lib.so"
    lib.write_bytes(b"")
    reads = []

    def fake_sass(path):
        reads.append(path)
        return LOOP + "\n" + listing("EXIT", name="_Z5otherv")

    monkeypatch.setattr(sass, "library_sass", fake_sass)
    loop = sass.kernel_instructions(lib, "6kernel")
    assert sass.loop_instructions(loop) == 5
    loop.clear()  # the caller's copy: the cached listing stays whole
    assert sass.loop_instructions(sass.kernel_instructions(lib,
                                                           "6kernel")) == 5
    assert len(sass.kernel_instructions(lib, "5other")) == 1
    assert len(reads) == 1
    st = lib.stat()
    os.utime(lib, ns=(st.st_atime_ns, st.st_mtime_ns + 10**9))
    sass.kernel_instructions(lib, "5other")
    assert len(reads) == 2
    with pytest.raises(ValueError):
        sass.kernel_instructions(lib, "kernel_not_there")
