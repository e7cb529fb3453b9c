"""% of the card's stretch idle under the forward's span
(``steps.forward``)."""
from portbench.spans import idle_under


def read(ctx):
    return idle_under(ctx, lambda n: n == "steps.forward")
