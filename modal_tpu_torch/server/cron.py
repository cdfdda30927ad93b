"""Cron and Period schedules: the parser `Cron` validates with at
construction, and the next fire time the scheduler's firing loop
(`Scheduler._evaluate_schedule`) waits for (port of
modal_tpu/server/cron.py).

A 5-field expression (minute hour day-of-month month day-of-week); each
field is "*", "*/n", "a", "a-b", "a-b/n", or a comma list of them. Day of
week 0 and 7 are Sunday. When both day fields are restricted, either one
matching fires (vixie cron).
"""

from __future__ import annotations

from datetime import datetime, timedelta, timezone

from ..proto import api_pb2

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


def cron_next(expr: str, after_ts: float, tz_name: str = "") -> float:
    """Next fire time strictly after `after_ts` (unix seconds). The cron
    fields are evaluated in `tz_name` (IANA zone; default UTC) — DST shifts
    follow the zone's wall clock, like vixie cron."""
    if tz_name and tz_name != "UTC":
        from zoneinfo import ZoneInfo

        tz = ZoneInfo(tz_name)
    else:
        tz = timezone.utc
    minutes, hours, dom, month, dow, dom_star, dow_star = parse_cron(expr)
    t = datetime.fromtimestamp(int(after_ts) // 60 * 60, tz=tz) + timedelta(minutes=1)
    for _ in range(366 * 5):  # bounded scan: day-granular skip
        py_dow = (t.weekday() + 1) % 7  # Monday=0 → Sunday=0 convention
        if dom_star and dow_star:
            day_ok = True
        elif dom_star:
            day_ok = py_dow in dow
        elif dow_star:
            day_ok = t.day in dom
        else:  # both restricted: vixie OR
            day_ok = t.day in dom or py_dow in dow
        if t.month in month and day_ok:
            # scan remaining (hour, minute) slots of this day
            for hour in sorted(hours):
                if hour < t.hour:
                    continue
                for minute in sorted(minutes):
                    if hour == t.hour and minute < t.minute:
                        continue
                    return datetime(
                        t.year, t.month, t.day, hour, minute, tzinfo=tz
                    ).timestamp()
        t = (t + timedelta(days=1)).replace(hour=0, minute=0)
    raise ValueError(f"cron expression never fires: {expr!r}")


def next_fire(schedule: api_pb2.Schedule, after_ts: float) -> float:
    which = schedule.WhichOneof("schedule_oneof")
    if which == "cron":
        return cron_next(schedule.cron.cron_string, after_ts, schedule.cron.timezone)
    if which == "period":
        p = schedule.period
        seconds = (
            p.seconds
            + p.minutes * 60
            + p.hours * 3600
            + p.days * 86400
            + p.weeks * 604800
            + p.months * 2629800  # mean month, like the reference Period
            + p.years * 31557600
        )
        return after_ts + max(1.0, seconds)
    raise ValueError("schedule has no cron or period")
