"""% of the card's stretch idle under the backward's span
(``steps.backward``, the calling thread's wait on autograd)."""
from portbench.spans import idle_under


def read(ctx):
    return idle_under(ctx, lambda n: n == "steps.backward")
