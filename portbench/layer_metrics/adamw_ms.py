"""Device ms a step of the kernels launched inside
`optim.adamw.apply_adamw` (the range ``pb.adamw``), over the traced
steps."""
from portbench.layer_metrics import range_s


def read(ctx):
    steps = len(ctx["trace"]["host_notes"].get("steps", []))
    s = range_s(ctx, "pb.adamw")
    return 1e3 * s / steps if steps and s > 0 else None
