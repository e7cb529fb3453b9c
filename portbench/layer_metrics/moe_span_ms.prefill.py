"""Device ms a batch of the kernels launched inside the MoE's span
(``moe.apply``, `models.moe.moe_apply`), over the traced batches."""
from portbench.spans import span_ms


def read(ctx):
    return span_ms(ctx, "moe.apply", "lengths")
