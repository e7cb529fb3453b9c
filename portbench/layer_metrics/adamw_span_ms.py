"""Device ms a step of the kernels launched inside the optimizer's span
(``adamw.apply``, `optim.adamw.apply_adamw`), over the traced steps."""
from portbench.spans import span_ms


def read(ctx):
    return span_ms(ctx, "adamw.apply", "steps")
