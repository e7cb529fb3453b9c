"""The selective scan's sequence instance: its byte bound (or operation
bound at the float32 rate, the larger) at each traced batch's shape, over
its device time."""
from portbench.layer_metrics import device_s, layers_of, share


def read(ctx):
    s, t, r = ctx["spec"], ctx["traffic"], ctx["roofline"]
    lengths = ctx["trace"]["notes"].get("lengths", [])
    took = device_s(ctx, "selective_scan_seq")
    calls = ctx["trace"]["counters"]["scan_seq"]
    n = layers_of(s, "mamba")
    if not took or calls != n * len(lengths):
        return None
    d_in, N = s["mamba"]["expand"] * s["d_model"], s["mamba"]["d_state"]
    bound = sum(n * r.bound_s(*r.scan(t["batch"], L, d_in, N),
                              rate=r.FP32_PER_S) for L in lengths)
    return share(bound, took)
