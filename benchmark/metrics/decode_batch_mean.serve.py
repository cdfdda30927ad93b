"""Slots a decode step served on average over the window: the change in
the engine's `tokens_generated` less the first tokens (those come from
prefill), over the change in its `step_count`."""


def read(run):
    s = run.serve
    if s is None:
        return None
    c0, c1 = s.counters["t0"], s.counters["t1"]
    steps = c1["step_count"] - c0["step_count"]
    if steps <= 0:
        return None
    firsts = sum(1 for r in s.records if r.arrivals and s.t0 <= r.arrivals[0] < s.t1)
    return (c1["tokens_generated"] - c0["tokens_generated"] - firsts) / steps
