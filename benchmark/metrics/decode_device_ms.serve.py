"""Device time of a decode step: the mean, over the traced stretch's
decode steps, of the device operations from the copies of the step's
inputs through its read-back (`benchmark.steps.device_parts`)."""

from benchmark.steps import device_parts, mean


def read(run):
    parts = device_parts(run)
    return None if parts is None else mean([s * 1e3 for s in parts[0]])
