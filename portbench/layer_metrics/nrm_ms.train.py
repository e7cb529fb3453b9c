"""Host ms a step in the NRM (heartbeat, control step, the plant's
advance), over the untraced steps of the window."""
from portbench.layer_metrics import mean, untraced


def read(ctx):
    return mean(untraced(ctx, "nrm_ms"))
