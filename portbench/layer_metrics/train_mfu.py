"""The training step's share of the chip's roofline: the larger of its
model operations (`roofline.model.train_step_flops`) over the bf16 peak
and its weights' bytes over HBM's, over the mean untraced step (host
clock: the step, its loss on the host, the NRM)."""
from portbench.layer_metrics import loop_s, mean, share


def read(ctx):
    t, r, m = ctx["traffic"], ctx["roofline"], ctx["model"]
    step = mean(loop_s(ctx))
    if step is None:
        return None
    bound = r.bound_s(m.train_step_flops(ctx["spec"], t["batch"],
                                         t["seq_len"]),
                      m.weight_bytes(ctx["spec"]))
    return share(bound, step)
