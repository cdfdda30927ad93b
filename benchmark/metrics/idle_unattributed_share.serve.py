"""Share of the traced stretch's device-idle time that no serving-loop
iteration explains: the idle gaps (`Trace.idle_gaps`) whose midpoint falls
in no `serving.step` span, the spans placed on the trace's clock by their
decode launches (`benchmark.steps.offset`), over all the gaps."""

from benchmark.steps import idle_by_phase


def read(run):
    by_phase = idle_by_phase(run)
    total = sum(by_phase.values()) if by_phase else 0.0
    if total <= 0:
        return None
    return 100.0 * by_phase["outside"] / total
