"""Cron/Period schedules and placement constraints (port of
modal_tpu/schedule.py; reference py/modal/schedule.py:12).

A `Cron` is validated when it is built; the control plane's cron loop
fires a scheduled function (`server/scheduler.py`, `server/cron.py`).
"""

from __future__ import annotations

from .exception import InvalidError
from .proto import api_pb2


class Schedule:
    def to_proto(self) -> api_pb2.Schedule:
        raise NotImplementedError


class Cron(Schedule):
    """Cron-string schedule, e.g. ``Cron("5 4 * * *")``."""

    def __init__(self, cron_string: str, timezone: str = "UTC"):
        # full validation at construction: a bad expression must fail HERE,
        # not poison the server's scheduler loop at fire time
        from .server.cron import parse_cron

        try:
            parse_cron(cron_string)
        except ValueError as exc:
            raise InvalidError(f"invalid cron string {cron_string!r}: {exc}") from None
        if timezone not in ("", "UTC"):
            from zoneinfo import ZoneInfo, ZoneInfoNotFoundError

            try:
                ZoneInfo(timezone)
            except (ZoneInfoNotFoundError, ValueError) as exc:
                raise InvalidError(f"unknown timezone {timezone!r}: {exc}") from None
        self.cron_string = cron_string
        self.timezone = timezone

    def to_proto(self) -> api_pb2.Schedule:
        return api_pb2.Schedule(cron=api_pb2.Schedule.Cron(cron_string=self.cron_string, timezone=self.timezone))


class Period(Schedule):
    """Fixed-period schedule, e.g. ``Period(hours=12)``."""

    def __init__(
        self,
        years: int = 0,
        months: int = 0,
        weeks: int = 0,
        days: int = 0,
        hours: int = 0,
        minutes: int = 0,
        seconds: float = 0,
    ):
        self.years = years
        self.months = months
        self.weeks = weeks
        self.days = days
        self.hours = hours
        self.minutes = minutes
        self.seconds = seconds

    def to_proto(self) -> api_pb2.Schedule:
        return api_pb2.Schedule(
            period=api_pb2.Schedule.Period(
                years=self.years,
                months=self.months,
                weeks=self.weeks,
                days=self.days,
                hours=self.hours,
                minutes=self.minutes,
                seconds=self.seconds,
            )
        )


class SchedulerPlacement:
    """Region/zone/spot placement constraints (reference:
    scheduler_placement.py:7)."""

    def __init__(
        self,
        region: "str | list[str] | None" = None,
        zone: "str | list[str] | None" = None,
        spot: "bool | None" = None,
        instance_type: "str | list[str] | None" = None,
    ):
        def _as_list(x):
            if x is None:
                return []
            return [x] if isinstance(x, str) else list(x)

        self.regions = _as_list(region)
        self.zones = _as_list(zone)
        self.spot = spot
        self.instance_types = _as_list(instance_type)

    def to_proto(self) -> api_pb2.SchedulerPlacement:
        p = api_pb2.SchedulerPlacement(
            regions=self.regions,
            zones=self.zones,
            instance_types=self.instance_types,
        )
        if self.spot is not None:
            p.spot = self.spot
        return p
