"""Crash-forensics flight recorder (port of
modal_tpu/observability/flight_recorder.py).

The control plane keeps a bounded in-memory ring of the last ~60 s of raw
observability state: cumulative metric snapshots at ~1 Hz, a span tail fed
by a tracing tap, a journal tail fed by the journal's record tap, and
recent chaos events. Nothing is written in steady state.

On an event worth a look (``crash_restart``, a shard's ``takeover`` or
``fence``, a storm of ``fence_rejections``, or a burn-rate alert firing)
the recorder freezes the rings, writes
``postmortem-<event>-<ts>.json`` under ``<state_dir>/observability/`` and
resumes. ``python -m modal_tpu_torch.cli debug bundle`` collects the bundles
and renders the merged timeline (cli/entry_point.py).

MODAL_TPU_FLIGHT_RECORDER turns it off (default on); the ring's capacity in
~1 Hz samples is MODAL_TPU_FLIGHT_RECORDER_RING (default 60, one minute).
"""

from __future__ import annotations

import asyncio
import json
import os
import time
from collections import deque
from typing import Any, Callable, Optional

from .catalog import FLIGHT_RECORDER_DUMPS
from .metrics import Counter, Gauge, Histogram, MetricsRegistry, REGISTRY
from . import timeseries, tracing

ENABLE_ENV = "MODAL_TPU_FLIGHT_RECORDER"
RING_ENV = "MODAL_TPU_FLIGHT_RECORDER_RING"
DEFAULT_RING = 60  # ~1 Hz samples => ~60 s of history
SPAN_TAIL = 256
JOURNAL_TAIL = 256
CHAOS_TAIL = 64
# one postmortem per event kind per this many seconds: a crash-restart storm
# must not turn the recorder into a disk-filling amplifier
DUMP_MIN_INTERVAL_S = 5.0


def enabled() -> bool:
    return os.environ.get(ENABLE_ENV, "1").strip().lower() not in ("0", "off", "false", "no")


def ring_size() -> int:
    try:
        n = int(os.environ.get(RING_ENV, str(DEFAULT_RING)))
        return n if n > 0 else DEFAULT_RING
    except ValueError:
        return DEFAULT_RING


class FlightRecorder:
    """Bounded black-box ring + freeze/dump. All appenders are thread-safe
    (deque appends) and drop silently while a dump is serializing."""

    def __init__(
        self,
        state_dir: str,
        *,
        registry: MetricsRegistry = REGISTRY,
        journal: Optional[Any] = None,
        chaos: Optional[Any] = None,
        shard_index: Optional[int] = None,
        scope: str = "shard",
        interval_s: float = 1.0,
        ring: Optional[int] = None,
        clock: Callable[[], float] = time.time,
    ):
        self.state_dir = state_dir
        self.registry = registry
        self.journal = journal
        self.chaos = chaos
        self.shard_index = shard_index
        self.scope = scope
        self.interval_s = interval_s
        self.clock = clock
        self.samples: deque[dict] = deque(maxlen=ring if ring is not None else ring_size())
        self.spans: deque[dict] = deque(maxlen=SPAN_TAIL)
        self.journal_tail: deque[dict] = deque(maxlen=JOURNAL_TAIL)
        self.chaos_tail: deque[dict] = deque(maxlen=CHAOS_TAIL)
        self.dumps_written = 0
        self._frozen = False
        self._task: Optional[asyncio.Task] = None
        self._prev_journal_tap: Optional[Callable] = None
        self._last_dump: dict[str, float] = {}

    # -- lifecycle -----------------------------------------------------------

    def start(self) -> None:
        tracing.add_span_tap(self._on_span)
        if self.journal is not None:
            self._prev_journal_tap = getattr(self.journal, "tap", None)
            self.journal.tap = self._on_journal
        self.record_sample()
        try:
            self._task = asyncio.get_running_loop().create_task(self._loop())
        except RuntimeError:
            self._task = None  # no loop (unit tests drive record_sample directly)

    def stop(self) -> None:
        tracing.remove_span_tap(self._on_span)
        # `==`, not `is`: each access of a bound method makes a new object,
        # so the JAX package's `is` never matches and leaves its tap behind
        if self.journal is not None and getattr(self.journal, "tap", None) == self._on_journal:
            self.journal.tap = self._prev_journal_tap
        if self._task is not None:
            self._task.cancel()
            self._task = None

    async def _loop(self) -> None:
        while True:
            await asyncio.sleep(self.interval_s)
            try:
                self.record_sample()
            except Exception:
                pass

    # -- appenders -----------------------------------------------------------

    def record_sample(self, now: Optional[float] = None) -> None:
        """One raw cumulative snapshot of every tracked family. Cumulative
        (not delta) on purpose: forensics wants exact counter positions, and
        deltas reconstruct trivially between adjacent ring entries."""
        if self._frozen:
            return
        now = now if now is not None else self.clock()
        families: dict[str, Any] = {}
        for family in timeseries.tracked_families():
            m = self.registry.get(family)
            if m is None:
                continue
            if isinstance(m, Histogram):
                with m._lock:
                    families[family] = {
                        ",".join(k): [s.count, round(s.sum, 6)] for k, s in m._series.items()
                    }
            elif isinstance(m, (Counter, Gauge)):
                with m._lock:
                    families[family] = {",".join(k): float(v) for k, v in m._series.items()}
        sample = {"t": round(now, 3), "families": families}
        if self.journal is not None:
            sample["journal_seq"] = getattr(self.journal, "seq", None)
        self.samples.append(sample)

    def _on_span(self, span: "tracing.Span") -> None:
        if self._frozen:
            return
        try:
            self.spans.append(span.to_dict())
        except Exception:
            pass

    def _on_journal(self, payload: dict) -> None:
        if not self._frozen:
            self.journal_tail.append(dict(payload))
        prev = self._prev_journal_tap
        if prev is not None:
            prev(payload)

    def record_chaos(self, event: dict) -> None:
        if not self._frozen:
            self.chaos_tail.append(dict(event))

    # -- freeze + dump -------------------------------------------------------

    def dump(self, event: str, extra: Optional[dict] = None) -> Optional[str]:
        """Freeze the rings, write postmortem-<event>-<ts>.json, resume.
        Rate-limited per event kind; returns the path or None if suppressed."""
        now = self.clock()
        if now - self._last_dump.get(event, -1e9) < DUMP_MIN_INTERVAL_S:
            return None
        self._last_dump[event] = now
        try:
            self.record_sample(now)  # final sample right at the event edge
        except Exception:
            pass
        self._frozen = True
        try:
            chaos_events = list(self.chaos_tail)
            policy = self.chaos
            if policy is not None:
                for entry in list(getattr(policy, "fault_log", ()) or ())[-CHAOS_TAIL:]:
                    rec = entry if isinstance(entry, dict) else {"fault": str(entry)}
                    if rec not in chaos_events:
                        chaos_events.append(rec)
            bundle = {
                "version": 1,
                "event": event,
                "t": round(now, 3),
                "scope": self.scope,
                "shard_index": self.shard_index,
                "state_dir": self.state_dir,
                "pid": os.getpid(),
                "ring_capacity": self.samples.maxlen,
                "samples": list(self.samples),
                "spans": list(self.spans),
                "journal_tail": list(self.journal_tail),
                "chaos_events": chaos_events,
                "extra": extra or {},
            }
            obs_dir = os.path.join(self.state_dir, "observability")
            os.makedirs(obs_dir, exist_ok=True)
            path = os.path.join(obs_dir, f"postmortem-{event}-{now:.3f}.json")
            tmp = path + ".tmp"
            with open(tmp, "w") as f:
                json.dump(bundle, f, separators=(",", ":"))
            os.replace(tmp, path)
        except Exception:
            return None
        finally:
            self._frozen = False
        self.dumps_written += 1
        FLIGHT_RECORDER_DUMPS.inc(event=event)
        return path


def find_postmortems(root: str) -> list[str]:
    """Every postmortem bundle under a fleet root: the director's own
    observability dir plus each shard-*/observability dir."""
    out: list[str] = []
    dirs = [os.path.join(root, "observability")]
    try:
        for name in sorted(os.listdir(root)):
            if name.startswith("shard-"):
                dirs.append(os.path.join(root, name, "observability"))
    except OSError:
        pass
    for d in dirs:
        try:
            for name in sorted(os.listdir(d)):
                if name.startswith("postmortem-") and name.endswith(".json"):
                    out.append(os.path.join(d, name))
        except OSError:
            continue
    return out
