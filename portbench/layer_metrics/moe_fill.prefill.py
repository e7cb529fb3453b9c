"""100 x the expert slots filled by routed tokens over the slots computed
(G x E_pad x C a call), over the MoE calls of the traced batches."""
from portbench.spans import moe_slots


def read(ctx):
    got = moe_slots(ctx["trace"])
    if got is None or not got[1]:
        return None
    return 100.0 * got[0] / got[1]
