"""The flash forward kernel: its operation bound (bf16) at each traced
batch's shape, over its device time."""
from portbench.layer_metrics import device_s, layers_of, share


def read(ctx):
    s, t, r = ctx["spec"], ctx["traffic"], ctx["roofline"]
    lengths = ctx["trace"]["notes"].get("lengths", [])
    took = device_s(ctx, "flash_fwd")
    calls = ctx["trace"]["counters"]["flash_fwd"]
    n = layers_of(s, "attn")
    if not took or calls != n * len(lengths):
        return None
    bound = sum(n * r.bound_s(*r.flash_fwd(
        t["batch"], L, s["num_heads"], s["num_kv_heads"], s["head_dim"]))
        for L in lengths)
    return share(bound, took)
