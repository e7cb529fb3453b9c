"""Device events launched inside the NRM's spans (``nrm.*``) of the
host's stretch, per control period (``nrm.control_step``)."""
from portbench.spans import host_spans, launched_in


def read(ctx):
    tr = ctx["trace"]
    spans = [s for s in host_spans(tr) if s[0].startswith("nrm.")]
    periods = sum(s[0] == "nrm.control_step" for s in spans)
    if not periods or all(ev[3] is None for ev in tr["host_events"]):
        return None
    return len(launched_in(tr, spans)) / periods
