"""Device ms a batch of the kernels launched inside `models.moe.moe_apply`
(the range ``pb.moe``), over the traced batches (a whole cycle of the
lengths)."""
from portbench.layer_metrics import range_s


def read(ctx):
    n = len(ctx["trace"]["host_notes"].get("lengths", []))
    s = range_s(ctx, "pb.moe")
    return 1e3 * s / n if n and s > 0 else None
