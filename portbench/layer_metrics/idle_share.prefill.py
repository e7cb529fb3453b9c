"""The share of the traced stretch in which no kernel ran on the card."""


def read(ctx):
    tr = ctx["trace"]
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])
