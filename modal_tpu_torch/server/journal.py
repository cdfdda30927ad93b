"""Durable control plane: write-ahead journal and crash recovery (port of
modal_tpu/server/journal.py).

The control plane's logical state (apps, functions, calls, inputs, delivered
outputs, worker registrations and the idempotency seen-set) is replayable:

- **Records**: every mutating RPC in ``server/services.py`` (and the
  scheduler's worker deregistration) appends one typed, monotonically
  sequenced JSON record to ``<state_dir>/journal/`` (``segment-<n>.jsonl``).
  Records describe effects, not RPC requests, so replay does not depend on
  handler internals. The format is the JAX package's, record for record:
  JSON lines with ``t``, ``seq`` and protos as base64.
- **Snapshots**: ``compact()`` synthesizes the records that rebuild the
  current state and writes them as ``snapshot-<seq>.jsonl``; segments the
  snapshot covers are pruned. Snapshot load and tail replay share one applier
  table (``_APPLIERS``).
- **Recovery** (``recover_state``): apply snapshot and tail into a fresh
  ``ServerState``. Claims are not journaled: an input claimed at crash time
  recovers as pending (requeued for free, its journaled ``resume_token``
  kept), tasks recover as gone (the scheduler relaunches from the backlog),
  and journaled workers recover ``adoption_pending`` until their next
  heartbeat re-adopts them.
- **Exactly once**: outputs carry dedupe keys (``input_id:retry_count``)
  applied at append time, and mutating RPCs are deduped by the client's
  ``x-idempotency-key`` through a journal-backed seen-set
  (``IdempotencyCache``), so a retry storm after a restart replays cached
  responses instead of re-executing.

The port's plane has the function path's tables, the App layer's images
and secrets, volumes, SLO alerts, and the SDK's objects: dicts and queues
(their registry; their contents are not journaled, as in the JAX package),
proxies, environments, workspace settings, granted tokens and the input
plane's attempt tokens: every record type of the JAX package's journal.
Recovery counts a record it cannot apply by type in its report and logs a
warning per type; it never drops one silently.

Replication (server/replication.py) hooks in here: `observer` sees every
appended record and `on_snapshot` ships a compaction's snapshot to the
follower shards before the segments it covers are pruned. A journal with
neither writes the same bytes.

Durability: appends are flushed to the OS (no fsync by default): a
``kill -9`` of the plane loses nothing, since the page cache outlives the
process. ``MODAL_TPU_JOURNAL_FSYNC=1`` also survives host power loss, at an
fsync per append.
"""

from __future__ import annotations

import asyncio
import base64
import contextlib
import json
import os
import time
from collections import OrderedDict
from typing import Any, Callable, Iterable, Optional

from ..config import logger
from ..observability.catalog import JOURNAL_APPEND_SECONDS, JOURNAL_APPENDS, JOURNAL_BYTES
from ..proto import api_pb2

JOURNAL_DIRNAME = "journal"
# segment roll size: small enough that compaction reclaims space promptly,
# large enough that a soak does not churn file handles
SEGMENT_MAX_RECORDS = 4096
# auto-compaction threshold (the scheduler's reap tick calls maybe_compact)
COMPACT_EVERY_RECORDS = 20000
# idempotency seen-set bound (journal-backed; oldest evicted first)
IDEMPOTENCY_MAX_ENTRIES = 8192

# Mutating RPCs whose effects are journaled (directly, or through the
# journaled helpers they call), as in the JAX package: the quorum layer
# (proto/rpc.py _maybe_quorum) holds their responses for the followers.
JOURNALED_RPCS = frozenset(
    {
        "AppCreate",
        "AppGetOrCreate",
        "AppPublish",
        "AppClientDisconnect",
        "AppStop",
        "AppDeploy",
        "FunctionCreate",
        "FunctionBindParams",
        "FunctionUpdateSchedulingParams",
        "FunctionMap",
        "FunctionMapBatch",  # coalesced FunctionMaps; group-committed
        "FunctionPutInputs",
        "FunctionRetryInputs",
        "FunctionGetOutputs",  # journals consumption (clear_on_success takes)
        "FunctionStreamOutputs",  # journals consumption, same as the poll twin
        "FunctionPutOutputs",
        "FunctionExchange",  # put side journals via _append_output; claims transient like FunctionGetInputs
        "FunctionCallCancel",
        "ContainerCheckpoint",  # resume tokens survive the restart
        "TaskResult",  # input retry/fail outcomes via _append_output/input_retry
        "ImageGetOrCreate",
        "ImageDelete",
        "VolumeGetOrCreate",
        "VolumePutFiles2",
        "VolumeRemoveFile",
        "VolumeCopyFiles",
        "VolumeCommit",
        "VolumeRename",
        "VolumeDelete",
        "SecretGetOrCreate",
        "SecretDelete",
        "ProxyCreate",
        "ProxyDelete",
        "DictGetOrCreate",
        "DictDelete",
        "QueueGetOrCreate",
        "QueueDelete",
        "EnvironmentCreate",
        "EnvironmentDelete",
        "EnvironmentUpdate",
        "WorkspaceSettingsSet",
        "TokenFlowWait",  # granted tokens survive the restart
        "WorkerRegister",
    }
)

# Mutating RPCs of the port's plane whose responses are deduped by the
# client's idempotency key: a retry after a lost response or a restart
# replays the cached response instead of re-executing.
IDEMPOTENT_RPCS = frozenset(
    {
        "FunctionMap",
        "FunctionMapBatch",
        "FunctionPutInputs",
        "FunctionRetryInputs",
        "FunctionPutOutputs",
        "AppCreate",
        "AppGetOrCreate",
        "FunctionCreate",
        "FunctionBindParams",
    }
)


# Mutating RPCs of the port's plane deliberately not journaled, with the
# reason (the JAX package's table, for the RPCs the port serves): a sandbox's
# processes and tunnel listeners live on the plane's host and cannot outlive
# it, so their registry is not replayed; a dict's or a queue's contents are
# an ephemeral data-plane payload (their registry is journaled).
EXEMPT_RPCS: dict[str, str] = {
    "SandboxCreate": "sandbox processes are supervisor-host-bound",
    "SandboxTerminate": "sandbox processes are supervisor-host-bound",
    "SandboxStdinWrite": "sandbox processes are supervisor-host-bound",
    "SandboxSnapshotFs": "snapshot blob lands on disk; record is re-creatable",
    "SandboxSnapshot": "snapshot blob lands on disk; record is re-creatable",
    "SandboxRestore": "sandbox processes are supervisor-host-bound",
    "SandboxSidecarCreate": "sandbox processes are supervisor-host-bound",
    "SandboxSidecarStop": "sandbox processes are supervisor-host-bound",
    "SandboxSidecarExit": "sandbox processes are supervisor-host-bound",
    "TaskTunnelsUpdate": "tunnel listeners die with the supervisor process",
    "TaskReady": "sandbox readiness is process-bound",
    "TunnelStart": "tunnel listeners die with the supervisor process",
    "TunnelStop": "tunnel listeners die with the supervisor process",
    "EphemeralObjectHeartbeat": "liveness timestamp for ephemeral objects",
    "TaskClusterHello": "gang rendezvous state; gangs relaunch from the backlog",
    "VolumeBlockPut": "content-addressed block store on disk is already durable",
    "ProfileControl": "profiling toggle is runtime-transient; an operator re-issues it after a restart",
    "MetricsHistory": "read-only history query; rollups are runtime-transient, rebuilt by sampling "
    "(alert transitions are journaled by the SLO evaluator, record type 'alert')",
    "DictUpdate": "ephemeral data-plane payload (registry IS journaled)",
    "DictPop": "ephemeral data-plane payload (registry IS journaled)",
    "DictClear": "ephemeral data-plane payload (registry IS journaled)",
    "QueuePut": "ephemeral data-plane payload (registry IS journaled)",
    "QueueGet": "ephemeral data-plane payload (registry IS journaled)",
    "QueueClear": "ephemeral data-plane payload (registry IS journaled)",
    "TokenFlowCreate": "pending browser flows are transient until granted",
    "ShardControl": "director↔shard topology administration; shard maps and epochs are runtime "
    "state rebuilt by the director's health loop (the takeover IT TRIGGERS replays+compacts "
    "journals, which is the durable part)",
    "JournalReplicate": "replication plumbing (server/replication.py): the shipped records ARE "
    "journal records — journaling the RPC that carries them would double-write every append",
}


def _b64(data: bytes) -> str:
    return base64.b64encode(bytes(data)).decode("ascii")


def _unb64(s: str) -> bytes:
    return base64.b64decode(s.encode("ascii"))


# ---------------------------------------------------------------------------
# The journal itself
# ---------------------------------------------------------------------------


class Journal:
    """Append-only JSONL segments and compacted snapshots under
    ``<state_dir>/journal/``. One writer (the plane's event loop); appends
    are synchronous and cheap (a dict to a JSON line, a buffered write and a
    flush)."""

    # metric sampling stride: per-append counter and histogram updates would
    # cost more than the append itself, so they are accumulated and flushed
    # every Nth append (the catalog's help text says "sampled")
    _METRIC_SAMPLE_EVERY = 32

    def __init__(self, state_dir: str, fsync: Optional[bool] = None):
        self.dir = os.path.join(state_dir, JOURNAL_DIRNAME)
        os.makedirs(self.dir, exist_ok=True)
        try:
            # records can carry secrets: the journal dir is owner-only
            os.chmod(self.dir, 0o700)
        except OSError:
            pass
        self.fsync = (
            fsync if fsync is not None else os.environ.get("MODAL_TPU_JOURNAL_FSYNC", "0") in ("1", "true", "yes")
        )
        self.seq = 0
        # a record observer (the flight recorder's journal tail): called with
        # each appended payload dict; what it raises never reaches append
        self.tap = None
        # the replication hooks (server/replication.py): `observer(payload,
        # line)` sees every appended record, `on_snapshot(covered_seq, path)`
        # is awaited by compact_async before pruning. None on a journal that
        # is not replicated.
        self.observer = None
        self.on_snapshot = None
        self._segment_index = 0
        self._segment_records = 0
        self._records_since_snapshot = 0
        self._fh = None
        self._pending_appends: dict[str, int] = {}
        self._pending_bytes = 0
        # group commit: inside a group() block the opening task's appends
        # skip their per-record flush and commit once at exit, before the
        # handler returns; appends of other tasks keep their own flush
        self._group_depth = 0
        self._group_dirty = False
        self._group_owner = None
        # segment name -> max seq it holds (kept as segments roll, so
        # compaction never re-reads segment files on the event loop)
        self._segment_max_seq: dict[str, int] = {}
        self._scan()

    # -- layout -------------------------------------------------------------

    def _segment_path(self, index: int) -> str:
        return os.path.join(self.dir, f"segment-{index:08d}.jsonl")

    def _snapshot_path(self, seq: int) -> str:
        return os.path.join(self.dir, f"snapshot-{seq:012d}.jsonl")

    def _list(self, prefix: str) -> list[str]:
        try:
            names = os.listdir(self.dir)
        except OSError:
            return []
        return sorted(n for n in names if n.startswith(prefix) and n.endswith(".jsonl"))

    def _scan(self) -> None:
        """The seq and segment cursor of an existing journal dir, from each
        segment's last valid line (appends are in seq order)."""
        segments = self._list("segment-")
        snapshots = self._list("snapshot-")
        max_seq = 0
        if snapshots:
            max_seq = int(snapshots[-1][len("snapshot-") : -len(".jsonl")])
        if segments:
            self._segment_index = int(segments[-1][len("segment-") : -len(".jsonl")])
        for name in segments:
            seg_max = _last_seq(os.path.join(self.dir, name))
            self._segment_max_seq[name] = seg_max
            max_seq = max(max_seq, seg_max)
        self.seq = max_seq

    def has_records(self) -> bool:
        return bool(self._list("segment-")) or bool(self._list("snapshot-"))

    # -- append -------------------------------------------------------------

    def _open_segment(self) -> None:
        if self._fh is not None:
            self._fh.close()
        self._segment_index += 1
        self._segment_records = 0
        path = self._segment_path(self._segment_index)
        self._fh = open(path, "a", buffering=1024 * 64)
        try:
            os.chmod(path, 0o600)  # records can carry secrets
        except OSError:
            pass

    def append(self, t: str, **payload: Any) -> int:
        """Append one typed record; returns its sequence number."""
        sample = (self.seq % self._METRIC_SAMPLE_EVERY) == 0
        t0 = time.perf_counter() if sample else 0.0
        if self._fh is None or self._segment_records >= SEGMENT_MAX_RECORDS:
            self._open_segment()
        self.seq += 1
        payload["seq"] = self.seq
        payload["t"] = t
        line = json.dumps(payload, separators=(",", ":")) + "\n"
        tap = self.tap
        if tap is not None:
            try:
                tap(payload)
            except Exception:
                pass
        observer = self.observer
        if observer is not None:
            try:
                # the serialized line rides along: the replicator never
                # re-encodes the record it ships
                observer(payload, line)
            except Exception:
                pass
        self._fh.write(line)
        if self._group_depth > 0 and self._current_task() is self._group_owner:
            self._group_dirty = True  # the group's exit commits the batch
        else:
            self._fh.flush()
            if self.fsync:
                os.fsync(self._fh.fileno())
        self._segment_records += 1
        self._records_since_snapshot += 1
        self._segment_max_seq[os.path.basename(self._fh.name)] = self.seq
        self._pending_appends[t] = self._pending_appends.get(t, 0) + 1
        self._pending_bytes += len(line)
        if sample:
            JOURNAL_APPEND_SECONDS.observe(time.perf_counter() - t0)
            for rec_t, n in self._pending_appends.items():
                JOURNAL_APPENDS.inc(n, type=rec_t)
            self._pending_appends.clear()
            JOURNAL_BYTES.inc(self._pending_bytes)
            self._pending_bytes = 0
        return self.seq

    def records_since_snapshot(self) -> int:
        return self._records_since_snapshot

    @staticmethod
    def _current_task():
        try:
            return asyncio.current_task()
        except RuntimeError:
            return None

    @contextlib.contextmanager
    def group(self):
        """Group-commit scope: the opening task's appends defer their flush
        and exit commits once. Re-entrant within that task; appends of tasks
        that interleave keep their per-record flush. An exception still
        commits what was appended."""
        opener = self._current_task()
        if self._group_depth > 0 and opener is not self._group_owner:
            yield self
            return
        self._group_owner = opener
        self._group_depth += 1
        try:
            yield self
        finally:
            self._group_depth -= 1
            if self._group_depth == 0:
                self._group_owner = None
                if self._group_dirty:
                    self._group_dirty = False
                    if self._fh is not None:
                        self._fh.flush()
                        if self.fsync:
                            os.fsync(self._fh.fileno())

    # -- read / replay ------------------------------------------------------

    def replay(self) -> tuple[list[dict], list[dict]]:
        """(snapshot_records, tail_records): the latest snapshot's records
        and every segment record past its seq, in order. Torn trailing lines
        (a crash mid-write) are skipped."""
        snapshots = self._list("snapshot-")
        snap_records: list[dict] = []
        snap_seq = 0
        if snapshots:
            snap_seq = int(snapshots[-1][len("snapshot-") : -len(".jsonl")])
            snap_records = list(_read_records(os.path.join(self.dir, snapshots[-1])))
        tail: list[dict] = []
        for name in self._list("segment-"):
            for rec in _read_records(os.path.join(self.dir, name)):
                if int(rec.get("seq", 0)) > snap_seq:
                    tail.append(rec)
        tail.sort(key=lambda r: int(r.get("seq", 0)))
        return snap_records, tail

    def latest_snapshot(self) -> Optional[tuple[int, str]]:
        """(covered_seq, path) of the newest snapshot, or None: the
        replicator installs it on a follower whose gap predates the kept
        segments."""
        snapshots = self._list("snapshot-")
        if not snapshots:
            return None
        name = snapshots[-1]
        return int(name[len("snapshot-") : -len(".jsonl")]), os.path.join(self.dir, name)

    def tail_lines(self, since_seq: int) -> list[tuple[int, str]]:
        """(seq, line) of the on-disk records past `since_seq`, in seq order:
        a follower's catch-up feed. A record still in the file buffer is not
        here, but it is still in the replicator's in-memory buffer."""
        out: list[tuple[int, str]] = []
        for name in self._list("segment-"):
            seg_max = self._segment_max_seq.get(name)
            if seg_max is not None and seg_max <= since_seq:
                continue
            for rec in _read_records(os.path.join(self.dir, name)):
                seq = int(rec.get("seq", 0))
                if seq > since_seq:
                    out.append((seq, json.dumps(rec, separators=(",", ":"))))
        out.sort(key=lambda pair: pair[0])
        return out

    # -- snapshot / compaction ----------------------------------------------

    @staticmethod
    def _write_snapshot_file(records: Iterable[dict], path: str) -> None:
        """tmp file, fsync, rename; touches no Journal state, so the async
        compaction runs it in a thread."""
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            for rec in records:
                f.write(json.dumps(rec, separators=(",", ":")) + "\n")
            f.flush()
            os.fsync(f.fileno())
        try:
            os.chmod(tmp, 0o600)
        except OSError:
            pass
        os.replace(tmp, path)

    def _finish_snapshot(self, path: str, covered_seq: int) -> None:
        """Prune what the snapshot at `covered_seq` covers, from the
        in-memory max-seq map. The live segment is rolled (and pruned) only
        when it holds nothing past `covered_seq`: appends that landed while
        the snapshot was written stay in the tail."""
        from ..observability.catalog import JOURNAL_COMPACTIONS

        live = os.path.basename(self._fh.name) if self._fh is not None else None
        if live is not None and self._segment_max_seq.get(live, 0) <= covered_seq:
            self._fh.close()
            self._fh = None
            self._segment_records = 0
            live = None
        for name in self._list("segment-"):
            if name == live:
                continue
            seg_max = self._segment_max_seq.get(name)
            if seg_max is not None and seg_max <= covered_seq:
                os.unlink(os.path.join(self.dir, name))
                self._segment_max_seq.pop(name, None)
        for name in self._list("snapshot-"):
            if os.path.join(self.dir, name) != path:
                os.unlink(os.path.join(self.dir, name))
        self._records_since_snapshot = max(0, self.seq - covered_seq)
        JOURNAL_COMPACTIONS.inc()

    def write_snapshot(self, records: Iterable[dict]) -> str:
        """Synchronous snapshot covering seq <= self.seq (tests, small
        states); the plane's periodic path is `compact_async`."""
        path = self._snapshot_path(self.seq)
        self._write_snapshot_file(records, path)
        self._finish_snapshot(path, self.seq)
        return path

    async def compact_async(self, records: list[dict]) -> str:
        """Compaction off the loop: the caller synthesizes `records` on the
        loop (a consistent view), the write and fsync run in a thread, and
        pruning finishes on the loop. Appends racing the thread carry
        seq > covered_seq and stay in the tail."""
        covered_seq = self.seq
        path = self._snapshot_path(covered_seq)
        await asyncio.to_thread(self._write_snapshot_file, records, path)
        on_snapshot = self.on_snapshot
        if on_snapshot is not None:
            # the followers get the snapshot before its segments are pruned:
            # none ever needs pruned history to seal (the hook logs its own
            # failures)
            try:
                await on_snapshot(covered_seq, path)
            except Exception:
                logger.exception("snapshot replication hook failed")
        self._finish_snapshot(path, covered_seq)
        return path

    def status(self) -> dict:
        segments = self._list("segment-")
        snapshots = self._list("snapshot-")
        by_type: dict[str, int] = {}
        tail_records = 0
        for name in segments:
            for rec in _read_records(os.path.join(self.dir, name)):
                tail_records += 1
                by_type[rec.get("t", "?")] = by_type.get(rec.get("t", "?"), 0) + 1
        size = 0
        for name in segments + snapshots:
            try:
                size += os.path.getsize(os.path.join(self.dir, name))
            except OSError:
                pass
        return {
            "dir": self.dir,
            "seq": self.seq,
            "segments": len(segments),
            "snapshot_seq": int(snapshots[-1][len("snapshot-") : -len(".jsonl")]) if snapshots else 0,
            "tail_records": tail_records,
            "records_by_type": dict(sorted(by_type.items())),
            "bytes": size,
            "fsync": self.fsync,
        }

    def close(self) -> None:
        if self._fh is not None:
            self._fh.close()
            self._fh = None


def _last_seq(path: str) -> int:
    """Max seq of a segment: its last parseable line's (a torn trailing line
    is skipped, as replay skips it)."""
    try:
        with open(path, "rb") as f:
            lines = f.read().splitlines()
    except OSError:
        return 0
    for raw in reversed(lines):
        raw = raw.strip()
        if not raw:
            continue
        try:
            return int(json.loads(raw).get("seq", 0))
        except (json.JSONDecodeError, ValueError, AttributeError):
            continue
    return 0


def archive_existing(state_dir: str) -> Optional[str]:
    """Move an existing journal's segments and snapshots into
    ``discarded-<ts>/``, for a plane that declines recovery (recover=False):
    the next boot's auto-recovery must not merge the abandoned state back.
    Returns the archive dir, or None when there was nothing to archive."""
    jdir = os.path.join(state_dir, JOURNAL_DIRNAME)
    try:
        names = [
            n
            for n in os.listdir(jdir)
            if (n.startswith("segment-") or n.startswith("snapshot-")) and n.endswith(".jsonl")
        ]
    except OSError:
        return None
    if not names:
        return None
    dest = os.path.join(jdir, f"discarded-{time.time_ns()}")
    os.makedirs(dest, exist_ok=True)
    for name in names:
        os.replace(os.path.join(jdir, name), os.path.join(dest, name))
    logger.warning(f"recovery declined: archived {len(names)} journal file(s) to {dest}")
    return dest


def _read_records(path: str):
    try:
        with open(path) as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                try:
                    yield json.loads(line)
                except json.JSONDecodeError:
                    # torn trailing line of a crash mid-write: never
                    # acknowledged anywhere
                    continue
    except OSError:
        return


# ---------------------------------------------------------------------------
# Idempotency seen-set (journal-backed)
# ---------------------------------------------------------------------------


class IdempotencyCache:
    """Bounded key → serialized-response map for mutating RPCs. Entries are
    journaled (``rpc_dedupe`` records), so a restarted plane replays the
    same responses to a client's retry storm."""

    def __init__(self, journal: Optional[Journal] = None, max_entries: int = IDEMPOTENCY_MAX_ENTRIES):
        self.journal = journal
        self.max_entries = max_entries
        self._entries: "OrderedDict[str, tuple[str, bytes]]" = OrderedDict()

    def get(self, key: str, method: str) -> Optional[bytes]:
        hit = self._entries.get(key)
        if hit is None or hit[0] != method:
            return None
        self._entries.move_to_end(key)
        return hit[1]

    def put(self, key: str, method: str, response: bytes, *, journal: bool = True) -> None:
        if key in self._entries:
            self._entries.move_to_end(key)
        self._entries[key] = (method, response)
        while len(self._entries) > self.max_entries:
            self._entries.popitem(last=False)
        if journal and self.journal is not None:
            self.journal.append("rpc_dedupe", key=key, method=method, resp=_b64(response))

    def __len__(self) -> int:
        return len(self._entries)


# ---------------------------------------------------------------------------
# Appliers: one table shared by snapshot load and tail replay
# ---------------------------------------------------------------------------


def _proto(cls, b64_str: str):
    msg = cls()
    if b64_str:
        msg.ParseFromString(_unb64(b64_str))
    return msg


def _apply_app(s, r):
    from .state import AppState

    app = s.apps.get(r["app_id"]) or AppState(app_id=r["app_id"])
    app.name = r.get("name", "")
    app.description = r.get("description", "")
    app.state = r.get("state", api_pb2.APP_STATE_INITIALIZING)
    app.environment_name = r.get("environment_name", "")
    s.apps[r["app_id"]] = app
    if r.get("deploy_name"):
        s.deployed_apps[(app.environment_name, r["deploy_name"])] = app.app_id


def _apply_app_state(s, r):
    app = s.apps.get(r["app_id"])
    if app is None:
        return
    app.state = r.get("state", app.state)
    for tag, fn_id in (r.get("function_ids") or {}).items():
        app.function_ids[tag] = fn_id
    for tag, cls_id in (r.get("class_ids") or {}).items():
        app.class_ids[tag] = cls_id
    if r.get("name"):
        app.name = r["name"]
        s.deployed_apps[(app.environment_name, r["name"])] = app.app_id
        if r.get("publish"):
            # only AppPublish re-keys the deployed-function map; an AppDeploy
            # record (a name, no publish flag) keeps its entries
            for env, app_name, tag in list(s.deployed_functions.keys()):
                if env == app.environment_name and app_name == r["name"]:
                    del s.deployed_functions[(env, app_name, tag)]
            for tag, fn_id in (r.get("function_ids") or {}).items():
                s.deployed_functions[(app.environment_name, r["name"], tag)] = fn_id
    if r.get("done"):
        app.done = True
        app.stopped_at = r.get("stopped_at", time.time())


def _apply_function(s, r):
    from .state import FunctionState

    s.functions[r["function_id"]] = FunctionState(
        function_id=r["function_id"],
        app_id=r.get("app_id", ""),
        tag=r.get("tag", ""),
        definition=_proto(api_pb2.Function, r.get("definition", "")),
        bound_parent=r.get("bound_parent") or None,
        serialized_params=_unb64(r.get("serialized_params", "")),
    )


def _apply_fn_sched(s, r):
    fn = s.functions.get(r["function_id"])
    if fn is not None:
        fn.autoscaler_override = _proto(api_pb2.AutoscalerSettings, r.get("settings", ""))


def _apply_call(s, r):
    from .state import FunctionCallState

    s.function_calls[r["function_call_id"]] = FunctionCallState(
        function_call_id=r["function_call_id"],
        function_id=r.get("function_id", ""),
        call_type=r.get("call_type", api_pb2.FUNCTION_CALL_TYPE_UNARY),
        invocation_type=r.get("invocation_type", api_pb2.FUNCTION_CALL_INVOCATION_TYPE_SYNC),
        return_exceptions=bool(r.get("return_exceptions")),
        server_originated=bool(r.get("server_originated")),
    )


def _apply_input(s, r):
    from .state import InputState

    prior = s.inputs.get(r["input_id"])
    inp = InputState(
        input_id=r["input_id"],
        function_call_id=r.get("function_call_id", ""),
        idx=r.get("idx", 0),
        input=_proto(api_pb2.FunctionInput, r.get("input", "")),
        retry_count=r.get("retry_count", 0),
        # a payload-resend record replacing an earlier input keeps a
        # checkpoint token journaled in between
        resume_token=r.get("resume_token", "") or (prior.resume_token if prior else ""),
    )
    s.inputs[inp.input_id] = inp
    call = s.function_calls.get(inp.function_call_id)
    if call is not None and inp.input_id not in call.input_ids:
        call.input_ids.append(inp.input_id)
        call.num_inputs += 1
    fn = s.functions.get(r.get("function_id", ""))
    if fn is not None and inp.input_id not in fn.pending:
        fn.pending.append(inp.input_id)


def _apply_input_retry(s, r):
    """A requeue or retry. `undo_done` re-opens a delivered input's slot in
    num_done and `prune_output` drops its stale output (the JAX input plane
    emits both; the port's sites emit neither: their dedupe keys shift by
    retry_count instead)."""
    inp = s.inputs.get(r["input_id"])
    if inp is None:
        return
    call = s.function_calls.get(inp.function_call_id)
    if call is not None and r.get("undo_done") and inp.status == "done":
        call.num_done = max(0, call.num_done - 1)
        if r.get("prune_output"):
            call.outputs[:] = [o for o in call.outputs if o.input_id != inp.input_id]
    inp.retry_count = r.get("retry_count", inp.retry_count)
    if r.get("input"):
        inp.input.ParseFromString(_unb64(r["input"]))
    inp.status = "pending"
    inp.claimed_by = ""
    inp.claimed_at = 0.0
    inp.delivered_to.clear()
    fn = s.functions.get(call.function_id) if call is not None else None
    if fn is not None and inp.input_id not in fn.pending:
        fn.pending.append(inp.input_id)


def _apply_input_token(s, r):
    inp = s.inputs.get(r["input_id"])
    if inp is not None:
        inp.resume_token = r.get("resume_token", "")


def _apply_output(s, r):
    call = s.function_calls.get(r["function_call_id"])
    if call is None:
        return
    item = _proto(api_pb2.FunctionGetOutputsItem, r.get("item", ""))
    key = f"{item.input_id}:{item.retry_count}"
    if item.input_id and key in call.output_keys:
        return  # replay of a deduped record
    call.output_keys.add(key)
    call.outputs.append(item)
    call.num_done += 1
    inp = s.inputs.get(item.input_id)
    # a stale output (a snapshot emits the input with its current
    # retry_count before the historical outputs) must not mark a retried,
    # pending input done again
    if inp is not None and item.retry_count >= inp.retry_count:
        inp.status = "done"
        fn = s.functions.get(call.function_id)
        if fn is not None and item.input_id in fn.pending:
            fn.pending.remove(item.input_id)


def _apply_consumed(s, r):
    call = s.function_calls.get(r["function_call_id"])
    if call is not None:
        call.outputs_consumed = max(call.outputs_consumed, int(r.get("n", 0)))


def _apply_call_cancel(s, r):
    call = s.function_calls.get(r["function_call_id"])
    if call is None:
        return
    call.cancelled = True
    fn = s.functions.get(call.function_id)
    for input_id in call.input_ids:
        inp = s.inputs.get(input_id)
        if inp is not None and inp.status in ("pending", "claimed"):
            inp.status = "cancelled"
            if fn is not None and input_id in fn.pending:
                fn.pending.remove(input_id)


def _apply_worker(s, r):
    """A worker registration. The port's workers hold cards (`gpu_type`,
    `num_gpus`); a JAX record's TPU inventory (`tpu_type`, `num_chips`)
    recovers as a worker with no cards."""
    from .state import WorkerState

    s.workers[r["worker_id"]] = WorkerState(
        worker_id=r["worker_id"],
        hostname=r.get("hostname", ""),
        gpu_type=r.get("gpu_type", ""),
        num_gpus=r.get("num_gpus", 0),
        milli_cpu=r.get("milli_cpu", 0),
        memory_mb=r.get("memory_mb", 0),
        container_address=r.get("container_address", ""),
        router_address=r.get("router_address", ""),
        region=r.get("region", ""),
        zone=r.get("zone", ""),
        spot=bool(r.get("spot")),
        instance_type=r.get("instance_type", ""),
    )


def _apply_worker_gone(s, r):
    s.workers.pop(r["worker_id"], None)


def _apply_secret(s, r):
    from .state import SecretState

    sec = s.secrets.get(r["secret_id"]) or SecretState(secret_id=r["secret_id"])
    sec.name = r.get("name", "")
    sec.env_dict = dict(r.get("env", {}))
    s.secrets[r["secret_id"]] = sec
    if r.get("deploy_key"):
        s.deployed_secrets[tuple(r["deploy_key"])] = sec.secret_id


def _apply_secret_del(s, r):
    s.secrets.pop(r["secret_id"], None)
    for key, sid in list(s.deployed_secrets.items()):
        if sid == r["secret_id"]:
            del s.deployed_secrets[key]


def _apply_image(s, r):
    from .state import ImageState

    s.images[r["image_id"]] = ImageState(
        image_id=r["image_id"],
        definition=_proto(api_pb2.Image, r.get("definition", "")),
        metadata=_proto(api_pb2.ImageMetadata, r.get("metadata", "")),
        built=bool(r.get("built", True)),
    )
    if r.get("hash_key"):
        s.images_by_hash[r["hash_key"]] = r["image_id"]


def _apply_image_del(s, r):
    s.images.pop(r["image_id"], None)
    for key, image_id in list(s.images_by_hash.items()):
        if image_id == r["image_id"]:
            del s.images_by_hash[key]


_DICTQ_POOLS = {
    "dicts": ("deployed_dicts", "DictState", "dict_id"),
    "queues": ("deployed_queues", "QueueState", "queue_id"),
}


def _apply_dictq(s, r):
    from . import state as state_mod

    deployed_name, cls_name, id_field = _DICTQ_POOLS[r["pool"]]
    pool = getattr(s, r["pool"])
    obj = pool.get(r["id"]) or getattr(state_mod, cls_name)(**{id_field: r["id"]})
    obj.name = r.get("name", "")
    obj.ephemeral = bool(r.get("ephemeral"))
    obj.last_heartbeat = time.time() if obj.ephemeral else 0.0
    pool[r["id"]] = obj
    if r.get("deploy_key"):
        getattr(s, deployed_name)[tuple(r["deploy_key"])] = r["id"]


def _apply_dictq_del(s, r):
    getattr(s, r["pool"]).pop(r["id"], None)
    deployed = getattr(s, _DICTQ_POOLS[r["pool"]][0])
    for key, oid in list(deployed.items()):
        if oid == r["id"]:
            del deployed[key]


def _apply_proxy(s, r):
    from .state import ProxyState

    s.proxies[r["proxy_id"]] = ProxyState(
        proxy_id=r["proxy_id"], name=r.get("name", ""), proxy_ip=r.get("proxy_ip", ""),
        environment_name=r.get("environment_name", ""),
    )
    s.deployed_proxies[(r.get("environment_name", ""), r.get("name", ""))] = r["proxy_id"]


def _apply_proxy_del(s, r):
    proxy = s.proxies.pop(r["proxy_id"], None)
    if proxy is not None:
        s.deployed_proxies.pop((proxy.environment_name, proxy.name), None)


def _apply_environment(s, r):
    s.environments[r["name"]] = r.get("web_suffix", "")


def _apply_environment_del(s, r):
    s.environments.pop(r["name"], None)


def _apply_environment_update(s, r):
    current = r["current"]
    if current not in s.environments:
        return
    if "web_suffix" in r:
        s.environments[current] = r["web_suffix"]
    if r.get("name") and r["name"] != current:
        s.environments[r["name"]] = s.environments.pop(current)
        for (env, app_name), app_id in list(s.deployed_apps.items()):
            if env == current:
                del s.deployed_apps[(env, app_name)]
                s.deployed_apps[(r["name"], app_name)] = app_id


def _apply_ws_setting(s, r):
    if r.get("value"):
        s.workspace_settings[r["name"]] = r["value"]
    else:
        s.workspace_settings.pop(r["name"], None)


def _apply_token(s, r):
    s.tokens[r["token_id"]] = r.get("token_secret", "")
    s.token_granted_at.setdefault(r["token_id"], r.get("granted_at", time.time()))


def _apply_attempt(s, r):
    s.attempts[r["token"]] = (r.get("call_id", ""), r.get("input_id", ""), time.monotonic())
    if r.get("supersedes"):
        s.attempts.pop(r["supersedes"], None)


def _apply_rpc_dedupe(s, r):
    if s.idempotency is not None:
        s.idempotency.put(r["key"], r.get("method", ""), _unb64(r.get("resp", "")), journal=False)


def _apply_alert(s, r):
    """SLO alert transition (observability/slo.py): replay keeps the last
    state per rule, so a firing alert survives crash_restart; the rebuilt
    evaluator adopts state.alerts and resolves it only from post-restart
    samples."""
    s.alerts[r["rule"]] = {
        k: r[k]
        for k in (
            "rule", "state", "since", "value", "burn_rate", "threshold",
            "description", "fast_window_s", "slow_window_s",
        )
        if k in r
    }


def _apply_volume(s, r):
    from .state import VolumeState

    vol = s.volumes.get(r["volume_id"]) or VolumeState(volume_id=r["volume_id"])
    vol.name = r.get("name", "")
    vol.version = r.get("version", vol.version)
    vol.ephemeral = bool(r.get("ephemeral"))
    vol.last_heartbeat = time.time() if vol.ephemeral else 0.0
    s.volumes[r["volume_id"]] = vol
    if r.get("deploy_key"):
        s.deployed_volumes[tuple(r["deploy_key"])] = vol.volume_id


def _apply_volume_files(s, r):
    vol = s.volumes.get(r["volume_id"])
    if vol is None:
        return
    for fb64 in r.get("files", []):
        f = _proto(api_pb2.VolumeFile, fb64)
        vol.files[f.path] = f


def _apply_volume_rm(s, r):
    vol = s.volumes.get(r["volume_id"])
    if vol is None:
        return
    path = r.get("path", "")
    if r.get("recursive"):
        for p in [p for p in vol.files if p == path or p.startswith(path + "/")]:
            del vol.files[p]
    else:
        vol.files.pop(path, None)


def _apply_volume_meta(s, r):
    vol = s.volumes.get(r["volume_id"])
    if vol is None:
        return
    if "name" in r:
        for key, vid in list(s.deployed_volumes.items()):
            if vid == vol.volume_id:
                del s.deployed_volumes[key]
                s.deployed_volumes[(key[0], r["name"])] = vid
        vol.name = r["name"]
    if "committed_version" in r:
        vol.committed_version = r["committed_version"]


def _apply_volume_del(s, r):
    s.volumes.pop(r["volume_id"], None)
    for key, vid in list(s.deployed_volumes.items()):
        if vid == r["volume_id"]:
            del s.deployed_volumes[key]


_APPLIERS: dict[str, Callable] = {
    "app": _apply_app,
    "app_state": _apply_app_state,
    "function": _apply_function,
    "fn_sched": _apply_fn_sched,
    "call": _apply_call,
    "input": _apply_input,
    "input_retry": _apply_input_retry,
    "input_token": _apply_input_token,
    "output": _apply_output,
    "consumed": _apply_consumed,
    "call_cancel": _apply_call_cancel,
    "worker": _apply_worker,
    "worker_gone": _apply_worker_gone,
    "secret": _apply_secret,
    "secret_del": _apply_secret_del,
    "image": _apply_image,
    "image_del": _apply_image_del,
    "volume": _apply_volume,
    "volume_files": _apply_volume_files,
    "volume_rm": _apply_volume_rm,
    "volume_meta": _apply_volume_meta,
    "volume_del": _apply_volume_del,
    "dictq": _apply_dictq,
    "dictq_del": _apply_dictq_del,
    "proxy": _apply_proxy,
    "proxy_del": _apply_proxy_del,
    "environment": _apply_environment,
    "environment_del": _apply_environment_del,
    "environment_update": _apply_environment_update,
    "ws_setting": _apply_ws_setting,
    "token": _apply_token,
    "attempt": _apply_attempt,
    "rpc_dedupe": _apply_rpc_dedupe,
    "alert": _apply_alert,
}


# ---------------------------------------------------------------------------
# Snapshot synthesis: the records that rebuild the current state
# ---------------------------------------------------------------------------


def synthesize_records(s) -> list[dict]:
    """Records that, applied in order to a fresh ServerState, reproduce the
    journaled projection of ``s``. Claims and tasks are absent by design."""
    out: list[dict] = []
    for name, suffix in s.environments.items():
        out.append({"t": "environment", "name": name, "web_suffix": suffix})
    for name, value in s.workspace_settings.items():
        out.append({"t": "ws_setting", "name": name, "value": value})
    for token_id, secret in s.tokens.items():
        out.append({"t": "token", "token_id": token_id, "token_secret": secret,
                    "granted_at": s.token_granted_at.get(token_id, 0.0)})
    for alert in s.alerts.values():
        out.append({"t": "alert", **alert})
    hash_by_image = {v: k for k, v in s.images_by_hash.items()}
    for img in s.images.values():
        out.append(
            {
                "t": "image",
                "image_id": img.image_id,
                "definition": _b64(img.definition.SerializeToString()),
                "metadata": _b64(img.metadata.SerializeToString()),
                "built": img.built,
                "hash_key": hash_by_image.get(img.image_id, ""),
            }
        )
    deployed_by_volume = {v: k for k, v in s.deployed_volumes.items()}
    for vol in s.volumes.values():
        deploy_key = deployed_by_volume.get(vol.volume_id)
        out.append(
            {
                "t": "volume",
                "volume_id": vol.volume_id,
                "name": vol.name,
                "version": vol.version,
                "ephemeral": vol.ephemeral,
                "deploy_key": list(deploy_key) if deploy_key else None,
            }
        )
        if vol.files:
            out.append({"t": "volume_files", "volume_id": vol.volume_id,
                        "files": [_b64(f.SerializeToString()) for f in vol.files.values()]})
        if vol.committed_version:
            out.append({"t": "volume_meta", "volume_id": vol.volume_id, "committed_version": vol.committed_version})
    deployed_by_secret = {v: k for k, v in s.deployed_secrets.items()}
    for sec in s.secrets.values():
        deploy_key = deployed_by_secret.get(sec.secret_id)
        out.append(
            {
                "t": "secret",
                "secret_id": sec.secret_id,
                "name": sec.name,
                "env": dict(sec.env_dict),
                "deploy_key": list(deploy_key) if deploy_key else None,
            }
        )
    for pool_name in ("dicts", "queues"):
        deployed_by_obj = {v: k for k, v in getattr(s, _DICTQ_POOLS[pool_name][0]).items()}
        for obj_id, obj in getattr(s, pool_name).items():
            deploy_key = deployed_by_obj.get(obj_id)
            out.append({"t": "dictq", "pool": pool_name, "id": obj_id, "name": obj.name, "ephemeral": obj.ephemeral,
                        "deploy_key": list(deploy_key) if deploy_key else None})
    for proxy in s.proxies.values():
        out.append({"t": "proxy", "proxy_id": proxy.proxy_id, "name": proxy.name, "proxy_ip": proxy.proxy_ip,
                    "environment_name": proxy.environment_name})
    deployed_by_app = {v: k[1] for k, v in s.deployed_apps.items()}
    for app in s.apps.values():
        out.append(
            {
                "t": "app",
                "app_id": app.app_id,
                "name": app.name,
                "description": app.description,
                "state": app.state,
                "environment_name": app.environment_name,
                "deploy_name": deployed_by_app.get(app.app_id, ""),
            }
        )
        rec = {
            "t": "app_state",
            "app_id": app.app_id,
            "state": app.state,
            "function_ids": dict(app.function_ids),
            "class_ids": dict(app.class_ids),
            "name": deployed_by_app.get(app.app_id, ""),
            "publish": True,  # authoritative function_ids: re-key the deployed map
        }
        if app.done:
            rec["done"] = True
            rec["stopped_at"] = app.stopped_at
        out.append(rec)
    for fn in s.functions.values():
        out.append(
            {
                "t": "function",
                "function_id": fn.function_id,
                "app_id": fn.app_id,
                "tag": fn.tag,
                "definition": _b64(fn.definition.SerializeToString()),
                "bound_parent": fn.bound_parent or "",
                "serialized_params": _b64(fn.serialized_params),
            }
        )
        if fn.autoscaler_override is not None:
            out.append(
                {
                    "t": "fn_sched",
                    "function_id": fn.function_id,
                    "settings": _b64(fn.autoscaler_override.SerializeToString()),
                }
            )
    for worker in s.workers.values():
        out.append(
            {
                "t": "worker",
                "worker_id": worker.worker_id,
                "hostname": worker.hostname,
                "gpu_type": worker.gpu_type,
                "num_gpus": worker.num_gpus,
                "milli_cpu": worker.milli_cpu,
                "memory_mb": worker.memory_mb,
                "container_address": worker.container_address,
                "router_address": worker.router_address,
                "region": worker.region,
                "zone": worker.zone,
                "spot": worker.spot,
                "instance_type": worker.instance_type,
            }
        )
    for call in s.function_calls.values():
        out.append(
            {
                "t": "call",
                "function_call_id": call.function_call_id,
                "function_id": call.function_id,
                "call_type": call.call_type,
                "invocation_type": call.invocation_type,
                "return_exceptions": call.return_exceptions,
                "server_originated": call.server_originated,
            }
        )
    for inp in s.inputs.values():
        call = s.function_calls.get(inp.function_call_id)
        out.append(
            {
                "t": "input",
                "input_id": inp.input_id,
                "function_call_id": inp.function_call_id,
                "function_id": call.function_id if call is not None else "",
                "idx": inp.idx,
                "input": _b64(inp.input.SerializeToString()),
                "retry_count": inp.retry_count,
                "resume_token": inp.resume_token,
            }
        )
    for call in s.function_calls.values():
        for item in call.outputs:
            out.append(
                {"t": "output", "function_call_id": call.function_call_id, "item": _b64(item.SerializeToString())}
            )
        if call.outputs_consumed:
            out.append({"t": "consumed", "function_call_id": call.function_call_id, "n": call.outputs_consumed})
        if call.cancelled:
            out.append({"t": "call_cancel", "function_call_id": call.function_call_id})
    for token, (call_id, input_id, _ts) in s.attempts.items():
        out.append({"t": "attempt", "token": token, "call_id": call_id, "input_id": input_id})
    if s.idempotency is not None:
        for key, (method, resp) in s.idempotency._entries.items():
            out.append({"t": "rpc_dedupe", "key": key, "method": method, "resp": _b64(resp)})
    return out


# ---------------------------------------------------------------------------
# Recovery
# ---------------------------------------------------------------------------


def recover_state(state, journal: Journal, preserve_live_workers: bool = False) -> dict:
    """Replay snapshot and tail into ``state``, then the post-passes: id
    counters past every recovered id, every unfinished input pending in its
    function's queue exactly once (claims are not journaled), and journaled
    workers ``adoption_pending``. Returns the recovery report; a record no
    applier takes is counted in it by type.

    ``preserve_live_workers=True`` is a shard takeover (server/shards.py):
    the journal is a dead sibling's and ``state`` a live shard's, whose own
    heartbeating workers keep their placements; only the workers the replay
    brought in await re-adoption."""
    from ..observability import tracing
    from ..observability.catalog import (
        RECOVERIES,
        RECOVERY_REPLAYED,
        RECOVERY_REQUEUED_INPUTS,
        RECOVERY_SECONDS,
    )
    from .state import bump_id_counter

    t0 = time.time()
    live_worker_ids = frozenset(state.workers) if preserve_live_workers else frozenset()
    snap_records, tail = journal.replay()
    applied = 0
    skipped = 0
    skipped_by_type: dict[str, int] = {}
    for rec in list(snap_records) + list(tail):
        t = rec.get("t", "")
        applier = _APPLIERS.get(t)
        if applier is None:
            skipped += 1
            skipped_by_type[t] = skipped_by_type.get(t, 0) + 1
            continue
        try:
            applier(state, rec)
            applied += 1
            RECOVERY_REPLAYED.inc(type=t)
        except Exception:  # noqa: BLE001 — one bad record must not kill recovery
            logger.exception(f"journal replay failed for record seq={rec.get('seq')} t={t}")
            skipped += 1
            skipped_by_type[t] = skipped_by_type.get(t, 0) + 1
    for t, n in sorted(skipped_by_type.items()):
        logger.warning(f"journal recovery skipped {n} {t!r} record(s): no table of the port holds it")
    # post-pass 1: id counters past every recovered id
    for pool in (state.apps, state.functions, state.function_calls, state.inputs, state.workers, state.secrets,
                 state.images, state.volumes, state.dicts, state.queues, state.proxies):
        for obj_id in pool:
            bump_id_counter(obj_id)
    # attempt tokens are make_id("at") too: a re-minted token would overwrite
    # a recovered one and answer a surviving client's AttemptAwait with
    # another input's result
    for token in state.attempts:
        bump_id_counter(token)
    # post-pass 2: every unfinished input is pending, once in its queue
    requeued = 0
    for inp in state.inputs.values():
        if inp.status != "pending":
            continue
        call = state.function_calls.get(inp.function_call_id)
        fn = state.functions.get(call.function_id) if call is not None else None
        if fn is None:
            continue
        if inp.input_id not in fn.pending:
            fn.pending.append(inp.input_id)
        requeued += 1
    RECOVERY_REQUEUED_INPUTS.inc(requeued)
    # post-pass 3: recovered workers take no placement until their next
    # heartbeat proves they outlived the crash
    now = time.time()
    pending_adoption = 0
    for worker_id, worker in state.workers.items():
        if worker_id in live_worker_ids:
            continue  # a takeover: the survivor's own workers stay placed
        worker.adoption_pending = True
        worker.recovered_at = now
        worker.last_heartbeat = 0.0
        pending_adoption += 1
    open_calls = sum(1 for c in state.function_calls.values() if c.num_done < c.num_inputs)
    took = time.time() - t0
    RECOVERY_SECONDS.set(took)
    RECOVERIES.inc(outcome="ok")
    report = {
        "records_applied": applied,
        "records_skipped": skipped,
        "skipped_by_type": dict(sorted(skipped_by_type.items())),
        "inputs_requeued": requeued,
        "open_calls": open_calls,
        "workers_pending_adoption": pending_adoption,
        "seconds": round(took, 4),
    }
    tracing.record_span("recovery.replay", start=t0, end=time.time(),
                        attrs={k: v for k, v in report.items() if k != "skipped_by_type"})
    logger.warning(f"control plane recovered from journal: {report}")
    return report
