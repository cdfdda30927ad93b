"""Device time of a prefill chunk: the traced stretch's prefill device
operations over the chunks that the `serving.step` spans start there
(`benchmark.steps.device_parts`)."""

from benchmark.steps import device_parts


def read(run):
    parts = device_parts(run)
    if parts is None or not parts[2]:
        return None
    return parts[1] * 1e3 / parts[2]
