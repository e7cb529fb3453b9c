"""The flash backward's share of its five-product bound (D, dK / dV and
dQ kernels), over the traced calls: calls x bound over their device
time."""
from portbench.layer_metrics import device_s, share


def read(ctx):
    t, s, r = ctx["traffic"], ctx["spec"], ctx["roofline"]
    calls = ctx["trace"]["counters"]["flash_bwd"]
    took = device_s(ctx, "flash_bwd")
    if not calls or not took:
        return None
    f, b = r.flash_bwd(t["batch"], t["seq_len"], s["num_heads"],
                       s["num_kv_heads"], s["head_dim"])
    return share(calls * r.bound_s(f, b), took)
