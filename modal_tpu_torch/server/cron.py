"""Cron expressions: the parser `Cron` validates with at construction (port
of `parse_cron` / `_parse_field`, modal_tpu/server/cron.py:24-58).

A 5-field expression (minute hour day-of-month month day-of-week); each
field is "*", "*/n", "a", "a-b", "a-b/n", or a comma list of them. Day of
week 0 and 7 are Sunday. The firing loop (`cron_next`, `next_fire` and the
control plane's cron task) comes with ROADMAP Queue A 4c-ii; until then the
plane refuses a scheduled function.
"""

from __future__ import annotations

_FIELD_RANGES = [(0, 59), (0, 23), (1, 31), (1, 12), (0, 7)]


def _parse_field(spec: str, lo: int, hi: int) -> set[int]:
    out: set[int] = set()
    for part in spec.split(","):
        part = part.strip()
        step = 1
        if "/" in part:
            part, step_s = part.split("/", 1)
            step = int(step_s)
            if step <= 0:
                raise ValueError(f"cron step must be positive: {spec!r}")
        if part in ("*", ""):
            start, end = lo, hi
        elif "-" in part:
            a, b = part.split("-", 1)
            start, end = int(a), int(b)
        else:
            start = end = int(part)
        if not (lo <= start <= hi and lo <= end <= hi and start <= end):
            raise ValueError(f"cron field out of range [{lo},{hi}]: {spec!r}")
        out.update(range(start, end + 1, step))
    return out


def parse_cron(expr: str) -> tuple[set[int], set[int], set[int], set[int], set[int], bool, bool]:
    """(minutes, hours, days of month, months, days of week, dom is "*",
    dow is "*"); raises ValueError on a malformed expression."""
    fields = expr.split()
    if len(fields) != 5:
        raise ValueError(f"cron expression needs 5 fields: {expr!r}")
    parsed = [_parse_field(f, lo, hi) for f, (lo, hi) in zip(fields, _FIELD_RANGES)]
    minutes, hours, dom, month, dow = parsed
    dow = {d % 7 for d in dow}  # 7 == 0 == Sunday
    dom_star = fields[2].strip() == "*"
    dow_star = fields[4].strip() == "*"
    return minutes, hours, dom, month, dow, dom_star, dow_star
