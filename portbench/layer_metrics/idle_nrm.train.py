"""% of the card's stretch idle under the NRM's spans (``nrm.heartbeat``,
``nrm.advance``, ``nrm.control_step``)."""
from portbench.spans import idle_under


def read(ctx):
    return idle_under(ctx, lambda n: n.startswith("nrm."))
