"""100 x the parameter elements the AdamW kernels updated over all the
elements updated, over the `optim.adamw.apply_adamw` calls made while the
program's spans recorded (the traced steps): the summary's own
``adamw_fused`` where it holds one (a made-up trace), else the program's
tally (`optim.adamw.fused_tally`); None where the program keeps none or
tallied nothing."""
import sys


def tally(summary: dict):
    """(elements the kernels updated, elements updated), or None."""
    if "adamw_fused" in summary:
        return tuple(summary["adamw_fused"])
    mod = sys.modules.get("repro_torch.optim.adamw")
    fused = getattr(mod, "fused_tally", None)
    return None if fused is None else fused()


def read(ctx):
    got = tally(ctx["trace"])
    if got is None or not got[1]:
        return None
    return 100.0 * got[0] / got[1]
