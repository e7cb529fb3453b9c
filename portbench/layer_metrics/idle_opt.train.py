"""% of the card's stretch idle under the optimizer's span
(``adamw.apply``)."""
from portbench.spans import idle_under


def read(ctx):
    return idle_under(ctx, lambda n: n == "adamw.apply")
