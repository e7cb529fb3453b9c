"""% of the card's stretch idle under `launch.steps`' step span
(``steps.train_step``) outside its children: the step's prologue and
what lies between the forward, the backward and the optimizer."""
from portbench.spans import idle_under


def read(ctx):
    return idle_under(ctx, lambda n: n == "steps.train_step")
