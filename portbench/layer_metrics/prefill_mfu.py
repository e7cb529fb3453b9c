"""The prefill step's share of the chip's roofline: each untraced batch's
bound (model operations `roofline.model.prefill_flops` over the bf16
peak, or its weights' bytes over HBM's, the larger) summed, over their
host seconds (dispatch to first tokens on the host)."""
from portbench.layer_metrics import share


def read(ctx):
    h, t, r, m = ctx["host"], ctx["traffic"], ctx["roofline"], ctx["model"]
    runs = [(L, s) for L, s, tr in zip(h["lengths"], h["batch_s"],
                                       h["traced"]) if not tr]
    if not runs:
        return None
    bound = sum(r.bound_s(m.prefill_flops(ctx["spec"], t["batch"], L),
                          m.weight_bytes(ctx["spec"])) for L, _ in runs)
    return share(bound, sum(s for _, s in runs))
