"""Share of the traced stretch in which no operation ran on the device
(the union of the traced device operations' intervals, against the
stretch's length)."""

from benchmark.readers import idle_share as read  # noqa: F401
