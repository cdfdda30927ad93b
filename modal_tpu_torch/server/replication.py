"""Quorum replication of the write-ahead journal across shard peers (port of
modal_tpu/server/replication.py).

A takeover that replays a dead shard's own journal directory survives a
kill -9, but a lost disk loses every acknowledged record of that partition,
and fencing at the next epoch cannot stop a cut-off writer that keeps
committing. Replication makes journal durability a property of the fleet:

- **Writer side** (:class:`JournalReplicator`): every ``Journal.append`` of
  a shard streams, in order, to ``MODAL_TPU_JOURNAL_REPLICAS`` follower
  shards (ring order after the writer; default 2) through the
  ``JournalReplicate`` RPC, in process when the follower is. A mutating RPC
  is acknowledged only after :meth:`JournalReplicator.commit_barrier` sees
  a quorum of follower acks at or past the journal's seq: proto/rpc.py's
  ``_maybe_quorum`` sits where the idempotency dedupe does, so a group
  commit amortizes the follower round trip as it amortizes the flush.
- **Follower side** (:class:`ReplicaStore`): a stream per writer under
  ``<state_dir>/replica/shard-<writer>/``, the record lines verbatim and a
  ``meta.json`` with the stream's epoch and seal. Every append carries the
  writer's fleet epoch and a stale one is refused (a fencing token), so a
  cut-off old writer loses its quorum once a successor seals at a higher
  epoch.
- **Takeover** (server/shards.py): the director asks the survivors for
  their seq of the dead writer, seals every copy at the new epoch, and the
  successor materializes its sealed stream into a journal-shaped directory
  that ``adopt_partition`` replays. Killing a shard and deleting its
  journal directory loses nothing that was acknowledged.

``MODAL_TPU_JOURNAL_REPLICAS=0`` writes what the single-writer plane
writes: no journal observer, no quorum wrapper, no ``replica/`` directory.
When the live followers fall below a quorum the writer commits locally and
says so in ``shard_status()``.
"""

from __future__ import annotations

import asyncio
import json
import os
import shutil
import time
from collections import deque
from typing import Any, Callable, Optional

from ..config import logger
from ..observability import tracing
from ..observability.catalog import (
    JOURNAL_FENCE_REJECTIONS,
    JOURNAL_QUORUM_COMMIT_SECONDS,
    JOURNAL_REPLICA_APPENDS,
    JOURNAL_REPLICATION_LAG,
)
from .journal import JOURNAL_DIRNAME, Journal, _read_records

REPLICA_DIRNAME = "replica"
# durable writer identity (incarnation counter + last adopted fleet epoch),
# next to — not inside — the journal dir: it must survive the chaos soak's
# journal-dir deletion so a respawned writer keeps a monotonic incarnation
WRITER_META_FILENAME = "journal-writer.json"

# one replication append batch is bounded so a catch-up after a long
# partition cannot ship an unbounded payload in one RPC
APPEND_BATCH_MAX_RECORDS = 512

# writer-side in-memory replication buffer cap: one unreachable-but-not-yet-
# dead follower must not pin the buffer floor and grow it without bound —
# a follower evicted past the cap catches up from the journal's on-disk
# snapshot + segments instead (the sender's _catch_up path). Far larger than
# any group-commit batch, so evicted entries are always flushed to disk and
# therefore visible to tail_lines().
BUFFER_MAX_RECORDS = 4096


def replicas_configured() -> int:
    """MODAL_TPU_JOURNAL_REPLICAS: follower shards per journal writer
    (default 2 → three durable copies with the writer; 0 disables
    replication entirely and must be byte-identical to the single-writer
    path)."""
    raw = os.environ.get("MODAL_TPU_JOURNAL_REPLICAS", "2")
    try:
        return max(0, int(raw or "2"))
    except ValueError:
        logger.warning(f"ignoring malformed MODAL_TPU_JOURNAL_REPLICAS={raw!r}")
        return 2


def quorum_timeout_s() -> float:
    """MODAL_TPU_JOURNAL_QUORUM_TIMEOUT: seconds a mutating RPC waits for
    its quorum commit before failing UNAVAILABLE (the client's transient
    retry ladder rides it; the records are already locally durable, so the
    retry dedupes instead of double-applying)."""
    raw = os.environ.get("MODAL_TPU_JOURNAL_QUORUM_TIMEOUT", "5.0")
    try:
        return max(0.05, float(raw or "5.0"))
    except ValueError:
        logger.warning(f"ignoring malformed MODAL_TPU_JOURNAL_QUORUM_TIMEOUT={raw!r}")
        return 5.0


def quorum_acks_needed(replicas: int) -> int:
    """Follower acks required before an append is quorum-committed: a
    majority of the (writer + replicas) copies, minus the writer's own.
    replicas=2 → 1 of 2 followers (2-of-3 majority); replicas=1 → 1 of 1."""
    return (replicas + 1) // 2


def _line_seq(line: str) -> int:
    """Seq of one journal record line WITHOUT a full JSON parse — this runs
    per record on the follower's append hot path, and json.loads was the
    dominant cost of quorum commit. Exact, not heuristic: the journal
    appends its "seq"/"t" keys after every payload key, and a raw '"seq":'
    can never occur inside a JSON string value (quotes are escaped there),
    so the LAST occurrence is always the journal's own."""
    i = line.rfind('"seq":')
    if i < 0:
        raise ValueError("journal line has no seq")
    j = i + 6
    k = line.find(",", j)
    if k < 0:
        k = line.find("}", j)
    return int(line[j:k])


def replica_root(state_dir: str) -> str:
    return os.path.join(state_dir, REPLICA_DIRNAME)


def stream_dir(state_dir: str, writer: int) -> str:
    return os.path.join(replica_root(state_dir), f"shard-{writer}")


# ---------------------------------------------------------------------------
# Follower side: ReplicaStore
# ---------------------------------------------------------------------------


class _Stream:
    """One writer's replicated log on this follower: verbatim record lines
    in ``records.jsonl`` (torn-tail tolerant, like the journal itself), the
    writer's latest compacted snapshot in ``snapshot.jsonl``, and
    ``meta.json`` (epoch / seal / snapshot coverage)."""

    def __init__(self, dirpath: str, fsync: bool):
        self.dir = dirpath
        self.fsync = fsync
        self.records_path = os.path.join(dirpath, "records.jsonl")
        self.snapshot_path = os.path.join(dirpath, "snapshot.jsonl")
        self.meta_path = os.path.join(dirpath, "meta.json")
        self.epoch = 0
        self.sealed_epoch = 0
        self.sealed_seq = 0
        self.snapshot_seq = 0
        self.writer_inc = 0  # highest writer incarnation seen on this stream
        self.last_seq = 0
        self.valid_offset = 0  # byte offset of the last COMPLETE record line
        self._fh = None
        self._load()

    def _load(self) -> None:
        os.makedirs(self.dir, exist_ok=True)
        try:
            os.chmod(self.dir, 0o700)  # records can carry secrets
        except OSError:
            pass
        try:
            with open(self.meta_path) as f:
                meta = json.load(f)
            self.epoch = int(meta.get("epoch", 0))
            self.sealed_epoch = int(meta.get("sealed_epoch", 0))
            self.sealed_seq = int(meta.get("sealed_seq", 0))
            self.snapshot_seq = int(meta.get("snapshot_seq", 0))
            self.writer_inc = int(meta.get("writer_inc", 0))
        except (OSError, ValueError):
            pass
        self.last_seq = self.snapshot_seq
        # scan for the last complete line: a torn tail (follower crash or
        # chaos repl_torn_tail) is truncated by the next append — the
        # writer resends from our reported last_seq, so nothing is lost
        try:
            with open(self.records_path, "rb") as f:
                data = f.read()
        except OSError:
            data = b""
        offset = 0
        for raw in data.splitlines(keepends=True):
            if not raw.endswith(b"\n"):
                break  # torn tail
            line = raw.strip()
            if line:
                try:
                    seq = int(json.loads(line).get("seq", 0))
                except (json.JSONDecodeError, ValueError, AttributeError):
                    break  # corrupt mid-file line: treat the rest as torn
                self.last_seq = max(self.last_seq, seq)
            offset += len(raw)
        self.valid_offset = offset

    def persist_meta(self) -> None:
        tmp = self.meta_path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(
                {
                    "epoch": self.epoch,
                    "sealed_epoch": self.sealed_epoch,
                    "sealed_seq": self.sealed_seq,
                    "snapshot_seq": self.snapshot_seq,
                    "writer_inc": self.writer_inc,
                    "last_seq": self.last_seq,
                },
                f,
            )
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, self.meta_path)

    def _writer_fh(self):
        if self._fh is None:
            # r+b keeps explicit control of the write offset (append mode
            # would ignore the torn-tail truncation seek below)
            try:
                self._fh = open(self.records_path, "r+b")
            except FileNotFoundError:
                self._fh = open(self.records_path, "w+b")
        # torn-tail repair: drop any bytes past the last complete line
        # before appending, or the new line would concatenate with garbage
        self._fh.seek(self.valid_offset)
        self._fh.truncate(self.valid_offset)
        return self._fh

    def truncate_to(self, limit: int) -> None:
        """Drop every record with seq > `limit` — the phantom tail a
        crash-restarted writer streamed to us but lost locally before its
        own flush. Keeping it would desync the streams permanently: the
        writer re-mints those seqs with DIFFERENT records, and seq-dedupe
        would silently swallow them."""
        self.close()
        kept: list[str] = []
        max_kept = self.snapshot_seq
        for rec in _read_records(self.records_path):
            seq = int(rec.get("seq", 0))
            if seq > limit:
                continue
            kept.append(json.dumps(rec, separators=(",", ":")) + "\n")
            max_kept = max(max_kept, seq)
        with open(self.records_path, "w") as f:
            f.writelines(kept)
            f.flush()
            os.fsync(f.fileno())
        self.valid_offset = sum(len(line.encode()) for line in kept)
        self.last_seq = max_kept
        self.persist_meta()

    def close(self) -> None:
        if self._fh is not None:
            self._fh.close()
            self._fh = None


class ReplicaStore:
    """This shard's follower role: the durable home of every peer writer's
    replicated journal stream. All methods are synchronous (buffered file
    writes, like the journal's own append path) — callers on the event loop
    pay microseconds, not I/O waits."""

    def __init__(
        self,
        state_dir: str,
        fsync: bool = False,
        chaos: Any = None,
        on_fence_rejection: Optional[Callable[[int], None]] = None,
    ):
        self.state_dir = state_dir
        self.fsync = fsync
        self.chaos = chaos
        self.on_fence_rejection = on_fence_rejection
        self._streams: dict[int, _Stream] = {}

    def _stream(self, writer: int) -> _Stream:
        st = self._streams.get(writer)
        if st is None:
            st = self._streams[writer] = _Stream(stream_dir(self.state_dir, writer), self.fsync)
        return st

    def _reject(self, writer: int, st: _Stream, reason: str) -> dict:
        if reason == "stale_epoch":
            JOURNAL_FENCE_REJECTIONS.inc(writer=str(writer))
            cb = self.on_fence_rejection
            if cb is not None:
                try:
                    cb(writer)
                except Exception:
                    pass
        JOURNAL_REPLICA_APPENDS.inc(writer=str(writer), result=reason)
        return {"ok": False, "error": reason, "last_seq": st.last_seq, "epoch": st.epoch}

    def _check_epoch(self, writer: int, st: _Stream, epoch: int) -> Optional[dict]:
        """Fencing-token check shared by append/snapshot: a stale epoch is
        structurally rejected; a higher epoch on a SEALED stream means a new
        writer incarnation owns this shard index again — reset the stream."""
        if epoch < st.epoch or (st.sealed_epoch and epoch <= st.sealed_epoch):
            return self._reject(writer, st, "stale_epoch")
        if st.sealed_epoch and epoch > st.sealed_epoch:
            self._reset(writer, st)
            st = self._stream(writer)
        if epoch > st.epoch:
            st.epoch = epoch
            st.persist_meta()
        return None

    def _reset(self, writer: int, st: _Stream) -> None:
        st.close()
        for path in (st.records_path, st.snapshot_path, st.meta_path):
            try:
                os.unlink(path)
            except OSError:
                pass
        self._streams.pop(writer, None)

    def _check_incarnation(
        self, writer: int, st: _Stream, incarnation: int, boot_seq: int
    ) -> Optional[dict]:
        """Writer-restart divergence guard (runs AFTER the epoch fence, so a
        stale-epoch undead writer can never trigger a truncation). A new
        incarnation means the writer process restarted and replayed its
        journal to `boot_seq`: any tail we hold past that is a phantom the
        writer lost before its own flush — truncate it, or the writer's
        re-minted seqs would be seq-deduped away and the streams diverge
        silently. incarnation=0 (pre-incarnation peer / direct store use)
        skips tracking entirely."""
        if not incarnation:
            return None
        if incarnation < st.writer_inc:
            return self._reject(writer, st, "stale_incarnation")
        if incarnation > st.writer_inc:
            limit = max(boot_seq, st.snapshot_seq)
            if st.last_seq > limit:
                logger.warning(
                    f"replica stream of writer {writer}: truncating phantom tail "
                    f"{limit + 1}..{st.last_seq} (writer incarnation {incarnation} "
                    f"replayed only to {boot_seq})"
                )
                st.truncate_to(limit)
            st.writer_inc = incarnation
            st.persist_meta()
        return None

    def append(
        self,
        writer: int,
        epoch: int,
        lines: list[str],
        incarnation: int = 0,
        boot_seq: int = 0,
    ) -> dict:
        """Durably append a batch of record lines from `writer` at `epoch`.
        Duplicates (seq <= last_seq: resends after a dropped ack) are
        skipped; a gap (first new seq > last_seq+1: this follower missed
        pruned history) is refused so the writer falls back to a snapshot
        install + tail catch-up."""
        st = self._stream(writer)
        rejected = self._check_epoch(writer, st, epoch)
        if rejected is not None:
            return rejected
        st = self._stream(writer)  # _check_epoch may have reset the stream
        rejected = self._check_incarnation(writer, st, incarnation, boot_seq)
        if rejected is not None:
            return rejected
        chaos = self.chaos
        if chaos is not None and chaos.consume_knob("repl_disk_full"):
            return self._reject(writer, st, "disk_full")
        fresh: list[tuple[int, str]] = []
        for line in lines:
            try:
                seq = _line_seq(line)
            except ValueError:
                return self._reject(writer, st, "corrupt")
            if seq <= st.last_seq:
                continue  # dup: resend after a dropped ack
            fresh.append((seq, line))
        if fresh and fresh[0][0] > st.last_seq + 1:
            return self._reject(writer, st, "gap")
        torn = chaos is not None and fresh and chaos.consume_knob("repl_torn_tail")
        fh = st._writer_fh()
        for i, (seq, line) in enumerate(fresh):
            raw = line if line.endswith("\n") else line + "\n"
            if torn and i == len(fresh) - 1:
                # chaos: simulate a follower crash mid-write — half the last
                # line lands with no newline. last_seq stays at the previous
                # record; the writer resends it and _writer_fh repairs first.
                fh.write(raw[: max(1, len(raw) // 2)].encode())
                fh.flush()
                break
            fh.write(raw.encode())
            st.valid_offset += len(raw.encode())
            st.last_seq = seq
        fh.flush()
        if self.fsync:
            os.fsync(fh.fileno())
        if fresh:
            JOURNAL_REPLICA_APPENDS.inc(
                len(fresh) - (1 if torn else 0), writer=str(writer), result="ok"
            )
        if chaos is not None and chaos.consume_knob("repl_ack_drop"):
            # chaos: partition-during-commit — the append IS durable here but
            # the ack never reaches the writer, which must resend (and we
            # dedupe the resent records by seq)
            return {"ok": False, "error": "ack_dropped", "last_seq": st.last_seq, "epoch": st.epoch}
        return {"ok": True, "last_seq": st.last_seq, "epoch": st.epoch}

    def install_snapshot(
        self,
        writer: int,
        epoch: int,
        covered_seq: int,
        lines: list[str],
        incarnation: int = 0,
        boot_seq: int = 0,
    ) -> dict:
        """Adopt the writer's compacted snapshot (shipped before the writer
        prunes segments, and during catch-up when a follower's gap predates
        the writer's retained history): replaces any records it covers."""
        st = self._stream(writer)
        rejected = self._check_epoch(writer, st, epoch)
        if rejected is not None:
            return rejected
        st = self._stream(writer)
        rejected = self._check_incarnation(writer, st, incarnation, boot_seq)
        if rejected is not None:
            return rejected
        if covered_seq <= st.snapshot_seq:
            return {"ok": True, "last_seq": st.last_seq, "epoch": st.epoch}
        tmp = st.snapshot_path + ".tmp"
        with open(tmp, "w") as f:
            for line in lines:
                f.write(line if line.endswith("\n") else line + "\n")
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, st.snapshot_path)
        # drop covered records (rewrite keeps the torn-tail invariant simple)
        st.close()
        kept: list[str] = []
        for rec in _read_records(st.records_path):
            if int(rec.get("seq", 0)) > covered_seq:
                kept.append(json.dumps(rec, separators=(",", ":")) + "\n")
        with open(st.records_path, "w") as f:
            f.writelines(kept)
            f.flush()
            os.fsync(f.fileno())
        st.snapshot_seq = covered_seq
        st.last_seq = max(st.last_seq, covered_seq)
        st.valid_offset = sum(len(line.encode()) for line in kept)
        st.persist_meta()
        JOURNAL_REPLICA_APPENDS.inc(writer=str(writer), result="snapshot")
        return {"ok": True, "last_seq": st.last_seq, "epoch": st.epoch}

    def seal(self, writer: int, epoch: int) -> dict:
        """Seal the writer's stream at its replicated max-seq under the
        takeover epoch: every later append from the old writer (any epoch
        <= the seal's) is rejected, so a partitioned undead writer cannot
        extend a log its successor already adopted. Idempotent."""
        st = self._stream(writer)
        if epoch < st.epoch or (st.sealed_epoch and epoch < st.sealed_epoch):
            return self._reject(writer, st, "stale_epoch")
        if st.sealed_epoch == epoch:
            return {"ok": True, "last_seq": st.last_seq, "sealed_seq": st.sealed_seq, "epoch": st.epoch}
        st.epoch = epoch
        st.sealed_epoch = epoch
        st.sealed_seq = st.last_seq
        st.persist_meta()
        return {"ok": True, "last_seq": st.last_seq, "sealed_seq": st.sealed_seq, "epoch": st.epoch}

    def status(self, writer: int) -> dict:
        if writer not in self._streams and not os.path.isdir(stream_dir(self.state_dir, writer)):
            return {"ok": False, "error": "no_stream", "last_seq": 0, "epoch": 0}
        st = self._stream(writer)
        return {
            "ok": True,
            "writer": writer,
            "last_seq": st.last_seq,
            "epoch": st.epoch,
            "sealed_epoch": st.sealed_epoch,
            "sealed_seq": st.sealed_seq,
            "snapshot_seq": st.snapshot_seq,
            "incarnation": st.writer_inc,
        }

    def status_all(self) -> list[dict]:
        root = replica_root(self.state_dir)
        writers = set(self._streams)
        try:
            for name in os.listdir(root):
                if name.startswith("shard-"):
                    try:
                        writers.add(int(name[len("shard-") :]))
                    except ValueError:
                        pass
        except OSError:
            pass
        return [self.status(w) for w in sorted(writers)]

    def materialize(self, writer: int) -> str:
        """Turn the (sealed) replica stream into a journal-shaped directory
        the existing ``adopt_partition`` replay consumes: snapshot file +
        one segment of tail records, truncated at the seal. Returns the
        state-dir-like root (``Journal(root)`` finds ``root/journal/``)."""
        st = self._stream(writer)
        limit = st.sealed_seq if st.sealed_epoch else st.last_seq
        root = os.path.join(st.dir, f"materialized-{limit}")
        jdir = os.path.join(root, JOURNAL_DIRNAME)
        shutil.rmtree(root, ignore_errors=True)
        os.makedirs(jdir, exist_ok=True)
        if st.snapshot_seq > 0 and os.path.exists(st.snapshot_path):
            shutil.copyfile(
                st.snapshot_path, os.path.join(jdir, f"snapshot-{st.snapshot_seq}.jsonl")
            )
        with open(os.path.join(jdir, "segment-000001.jsonl"), "w") as f:
            for rec in _read_records(st.records_path):
                if st.snapshot_seq < int(rec.get("seq", 0)) <= limit:
                    f.write(json.dumps(rec, separators=(",", ":")) + "\n")
            f.flush()
            os.fsync(f.fileno())
        return root

    def close(self) -> None:
        for st in self._streams.values():
            st.close()
        self._streams.clear()


# ---------------------------------------------------------------------------
# Writer side: JournalReplicator
# ---------------------------------------------------------------------------


class JournalReplicator:
    """Streams this shard's journal appends to its follower shards and
    answers the RPC layer's quorum-commit barrier.

    One sender task per follower slot pipelines batches (records buffered in
    memory until the slowest follower acks; followers that fall behind the
    buffer — or behind pruned history — catch up from the journal's
    snapshot + segments on disk).  ``observe`` is the Journal's append
    observer: synchronous, allocation-light, never blocks the append path.
    """

    def __init__(
        self,
        journal: Journal,
        shard_index: int,
        state_dir: str,
        peers: Callable[[], list[tuple[int, str]]],
        replicas: Optional[int] = None,
        chaos: Any = None,
    ):
        self.journal = journal
        self.shard_index = shard_index
        self.state_dir = state_dir
        self.peers = peers  # () -> [(shard_index, url)] of live peers, self excluded
        self.replicas = replicas_configured() if replicas is None else replicas
        self.timeout_s = quorum_timeout_s()
        self.chaos = chaos
        self.epoch = 1
        # writer identity across restarts: `incarnation` bumps durably on
        # every journal open and `boot_seq` is the seq this incarnation
        # replayed to — followers truncate any phantom tail past boot_seq on
        # first contact with a new incarnation, so a kill -9 that loses the
        # writer's buffered tail cannot silently desync the streams. The
        # last adopted fleet epoch persists alongside it: restarting at
        # epoch=1 after any prior takeover would otherwise get every append
        # stale_epoch-rejected (and the shard permanently fenced) until the
        # next director probe delivers the fleet epoch.
        self.incarnation = 1
        self.boot_seq = journal.seq
        if self.replicas > 0:
            meta = self._load_writer_meta()
            self.incarnation = int(meta.get("incarnation", 0)) + 1
            self.epoch = max(1, int(meta.get("epoch", 1)))
            self._persist_writer_meta()  # durable BEFORE any append ships
        self.fenced = False  # a follower rejected our epoch: stop committing
        self.acked: dict[int, int] = {}  # follower shard -> replicated seq
        self.buffer_max = BUFFER_MAX_RECORDS
        self._buffer: deque[tuple[int, str, float]] = deque()  # (seq, line, appended_at)
        self._wake: list[asyncio.Event] = []
        self._ack_event: Optional[asyncio.Event] = None
        self._flush_lock = asyncio.Lock()
        self._senders: list[asyncio.Task] = []
        self._stopped = False
        self._degraded_logged = False
        self._stub_cache: dict[str, Any] = {}
        self._channel_cache: dict[str, Any] = {}

    # -- config ------------------------------------------------------------

    def _writer_meta_path(self) -> str:
        return os.path.join(self.state_dir, WRITER_META_FILENAME)

    def _load_writer_meta(self) -> dict:
        try:
            with open(self._writer_meta_path()) as f:
                return json.load(f)
        except (OSError, ValueError):
            return {}

    def _persist_writer_meta(self) -> None:
        path = self._writer_meta_path()
        tmp = path + ".tmp"
        try:
            with open(tmp, "w") as f:
                json.dump({"incarnation": self.incarnation, "epoch": self.epoch}, f)
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, path)
        except OSError as exc:
            logger.warning(f"journal writer meta persistence failed: {exc}")

    def note_epoch(self, epoch: int) -> None:
        """Adopt the fleet epoch (director health probes / takeover adopt):
        appends are stamped with it, so followers can fence our stale
        incarnations after WE are the ones taken over. Adopting a strictly
        higher epoch UN-fences: the director only probes shards that still
        own partitions, so a delivered fleet epoch is its statement that we
        are (again) the legitimate writer — staying fenced would turn one
        transient stale-epoch rejection into a permanent outage. Persisted,
        so a crash-restart resumes at the adopted epoch instead of 1."""
        if epoch > self.epoch:
            self.epoch = epoch
            if self.fenced:
                logger.warning(
                    f"journal writer shard {self.shard_index} un-fenced: "
                    f"director delivered fleet epoch {epoch}"
                )
                self.fenced = False
            if self.replicas > 0:
                self._persist_writer_meta()

    def current_followers(self) -> list[tuple[int, str]]:
        """The first `replicas` live peers in ring order after this shard —
        deterministic, so the director can find every copy at takeover."""
        peers = {idx: url for idx, url in self.peers() if idx != self.shard_index and url}
        if not peers:
            return []
        modulus = max(list(peers) + [self.shard_index]) + 1
        ring = sorted(peers.items(), key=lambda p: (p[0] - self.shard_index) % modulus)
        return ring[: self.replicas]

    # -- journal hooks -----------------------------------------------------

    def observe(self, payload: dict, line: str = "") -> None:
        """Journal append observer: enqueue the record for every sender.
        Runs on the append hot path — the journal hands over the line it
        already serialized, so this is list-append only: no re-encode, no
        awaits, no I/O."""
        if self._stopped:
            return
        if not line:
            line = json.dumps(payload, separators=(",", ":"))
        self._buffer.append(
            (int(payload.get("seq", 0)), line.rstrip("\n"), time.monotonic())
        )
        # hard cap even with zero acks (every follower unreachable): evicted
        # followers fall back to the sender's disk catch-up path
        while len(self._buffer) > self.buffer_max:
            self._buffer.popleft()
        for ev in self._wake:
            ev.set()

    async def ship_snapshot(self, covered_seq: int, path: str) -> None:
        """Compaction hook (Journal.compact_async, BEFORE pruning): push the
        fresh snapshot to every follower so none of them ever needs pruned
        history to seal. Best-effort — a follower that misses it catches up
        from the retained snapshot file later."""
        try:
            with open(path) as f:
                lines = f.read().splitlines()
        except OSError:
            return
        for idx, url in self.current_followers():
            try:
                await asyncio.wait_for(
                    self._send(
                        url,
                        kind="snapshot",
                        epoch=self.epoch,
                        base_seq=covered_seq,
                        payload_json="\n".join(lines),
                    ),
                    timeout=self.timeout_s,
                )
            except Exception as exc:  # noqa: BLE001 — snapshot shipping is best-effort
                logger.warning(f"snapshot replication to shard {idx} failed: {exc}")

    # -- lifecycle ---------------------------------------------------------

    def start(self) -> None:
        if self._senders or self.replicas <= 0:
            return
        self._ack_event = asyncio.Event()
        for slot in range(self.replicas):
            ev = asyncio.Event()
            self._wake.append(ev)
            self._senders.append(
                asyncio.create_task(self._sender(slot, ev), name=f"journal-repl-{slot}")
            )

    async def stop(self) -> None:
        self._stopped = True
        for t in self._senders:
            t.cancel()
        for t in self._senders:
            try:
                await t
            except (asyncio.CancelledError, Exception):  # noqa: BLE001
                pass
        self._senders.clear()
        self._wake.clear()
        for channel in self._channel_cache.values():
            try:
                await channel.close()
            except Exception:  # noqa: BLE001
                pass
        self._channel_cache.clear()
        self._stub_cache.clear()

    # -- quorum barrier ----------------------------------------------------

    @property
    def active(self) -> bool:
        return self.replicas > 0 and not self._stopped

    async def commit_barrier(self) -> bool:
        """Block until a quorum of followers has durably appended everything
        up to the journal's current seq (the records this handler just
        wrote, plus anything batched with them). False = no quorum within
        MODAL_TPU_JOURNAL_QUORUM_TIMEOUT, or this writer has been fenced —
        the RPC must NOT ack."""
        if not self.active:
            return True
        target = self.journal.seq
        t0 = time.perf_counter()
        deadline = t0 + self.timeout_s
        while True:
            if self.fenced:
                return False
            followers = self.current_followers()
            if not followers:
                # degraded single-writer mode: the fleet has no live peer to
                # replicate to — blocking every mutation would turn a
                # follower outage into a total outage (degradation matrix)
                if not self._degraded_logged:
                    self._degraded_logged = True
                    logger.warning(
                        "journal replication degraded: no live followers; committing locally"
                    )
                return True
            self._degraded_logged = False
            needed = min(quorum_acks_needed(self.replicas), len(followers))
            got = sum(1 for idx, _ in followers if self.acked.get(idx, 0) >= target)
            if got >= needed:
                JOURNAL_QUORUM_COMMIT_SECONDS.observe(time.perf_counter() - t0)
                return True
            remaining = deadline - time.perf_counter()
            if remaining <= 0:
                return False
            if not self._flush_lock.locked():
                # Inline group-commit fast path: the first waiter drives one
                # shared batch straight through the transport instead of
                # waiting for a sender task to be scheduled.  Co-located
                # followers (in-proc fleet) resolve without yielding to the
                # event loop, so the common case commits in-task; everyone
                # batched behind the lock rides the same acks.
                async with self._flush_lock:  # lint: disable=lock-across-await — group-commit leader; held only for one bounded batch
                    progressed = await self._inline_flush(target, needed)
                if progressed:
                    continue  # re-check the quorum with the fresh acks
            assert self._ack_event is not None
            self._ack_event.clear()
            try:
                await asyncio.wait_for(self._ack_event.wait(), timeout=min(remaining, 0.25))
            except asyncio.TimeoutError:
                pass

    async def _inline_flush(self, target: int, needed: int) -> bool:
        """Ship the buffered tail to followers until `needed` of them have
        acked `target`, directly from the barrier's own task.  Followers that
        need disk catch-up (behind the buffer floor) are left to their sender
        task — this path only handles the hot case where the gap is still
        buffered.  Duplicate delivery against a racing sender is safe: the
        follower store dedupes by seq.  Returns True when any follower's ack
        advanced (the barrier re-checks instead of sleeping)."""
        progressed = False
        for idx, url in self.current_followers():
            followers = self.current_followers()
            got = sum(1 for i, _ in followers if self.acked.get(i, 0) >= target)
            if got >= min(needed, len(followers)) or self.fenced:
                return True
            acked = self.acked.get(idx, 0)
            if acked >= target:
                continue
            buffered_floor = self._buffer[0][0] if self._buffer else self.journal.seq + 1
            if acked + 1 < buffered_floor:
                continue  # needs snapshot/segment catch-up — the sender's job
            pending = self._pending_for(acked)
            if not pending:
                continue
            try:
                await self._append_batch(idx, url, acked, pending[:APPEND_BATCH_MAX_RECORDS])
            except Exception as exc:  # noqa: BLE001 — follower outage: fall back to sender retry
                logger.debug(f"inline quorum flush to shard {idx} failed: {exc}")
                continue
            progressed = self.acked.get(idx, 0) > acked or progressed
        return progressed

    # -- sender tasks ------------------------------------------------------

    def _trim_buffer(self) -> None:
        followers = [idx for idx, _ in self.current_followers()]
        if followers:
            floor = min(self.acked.get(idx, 0) for idx in followers)
            while self._buffer and self._buffer[0][0] <= floor:
                self._buffer.popleft()
        # a slow-but-alive follower must not pin the floor and grow the
        # buffer without bound: past the cap it is evicted to disk catch-up
        while len(self._buffer) > self.buffer_max:
            self._buffer.popleft()

    def _pending_for(self, acked_seq: int) -> list[tuple[int, str, float]]:
        return [entry for entry in self._buffer if entry[0] > acked_seq]

    async def _sender(self, slot: int, wake: asyncio.Event) -> None:
        backoff = 0.05
        while not self._stopped:
            try:
                followers = self.current_followers()
                if slot >= len(followers):
                    await asyncio.sleep(0.25)  # fleet smaller than the replica target
                    continue
                idx, url = followers[slot]
                acked = self.acked.get(idx, 0)
                pending = self._pending_for(acked)
                buffered_floor = self._buffer[0][0] if self._buffer else self.journal.seq + 1
                if acked + 1 < buffered_floor and acked < self.journal.seq:
                    # follower is behind the in-memory buffer: catch up from
                    # disk (snapshot first when its gap predates retained
                    # segments, then the tail)
                    await self._catch_up(idx, url, acked)
                    continue
                if not pending:
                    lag = 0.0
                else:
                    lag = max(0.0, time.monotonic() - pending[0][2])
                JOURNAL_REPLICATION_LAG.set(lag, follower=str(idx))
                if not pending:
                    wake.clear()
                    try:
                        await asyncio.wait_for(wake.wait(), timeout=1.0)
                    except asyncio.TimeoutError:
                        pass
                    continue
                batch = pending[:APPEND_BATCH_MAX_RECORDS]
                await self._append_batch(idx, url, acked, batch)
                backoff = 0.05
            except asyncio.CancelledError:
                raise
            except Exception as exc:  # noqa: BLE001 — a follower outage must not kill the writer
                logger.debug(f"journal replication sender {slot} error: {exc}")
                await asyncio.sleep(backoff)
                backoff = min(backoff * 2, 0.5)

    async def _append_batch(
        self, idx: int, url: str, acked: int, batch: list[tuple[int, str, float]]
    ) -> None:
        chaos = self.chaos
        if chaos is not None and getattr(chaos, "repl_lag_ms", 0.0) > 0:
            await asyncio.sleep(chaos.repl_lag_ms / 1000.0)
        t0 = time.time()
        # No wait_for wrapper: the gRPC leg of _send carries its own deadline,
        # and the co-located leg awaits the follower handler directly — so a
        # quorum commit in an in-proc fleet never round-trips the event loop.
        result = await self._send(
            url,
            kind="append",
            epoch=self.epoch,
            base_seq=acked,
            payload_json="\n".join(line for _, line, _ in batch),
        )
        tracing.record_span(
            "journal.replicate",
            start=t0,
            end=time.time(),
            attrs={"follower": idx, "base_seq": acked, "records": len(batch)},
        )
        self._handle_result(idx, result)

    async def _catch_up(self, idx: int, url: str, acked: int) -> None:
        snap = self.journal.latest_snapshot()
        if snap is not None and snap[0] > acked:
            covered_seq, path = snap
            with open(path) as f:
                lines = f.read().splitlines()
            result = await asyncio.wait_for(
                self._send(
                    url,
                    kind="snapshot",
                    epoch=self.epoch,
                    base_seq=covered_seq,
                    payload_json="\n".join(lines),
                ),
                timeout=self.timeout_s,
            )
            self._handle_result(idx, result)
            if not result.get("ok"):
                return
            acked = max(acked, int(result.get("last_seq", covered_seq)))
        tail = self.journal.tail_lines(acked)
        t0 = time.time()
        for start in range(0, len(tail), APPEND_BATCH_MAX_RECORDS):
            chunk = tail[start : start + APPEND_BATCH_MAX_RECORDS]
            result = await asyncio.wait_for(
                self._send(
                    url,
                    kind="append",
                    epoch=self.epoch,
                    base_seq=acked,
                    payload_json="\n".join(line for _, line in chunk),
                ),
                timeout=self.timeout_s,
            )
            self._handle_result(idx, result)
            if not result.get("ok"):
                return
            acked = int(result.get("last_seq", acked))
        if tail:
            tracing.record_span(
                "journal.replicate",
                start=t0,
                end=time.time(),
                attrs={"follower": idx, "catch_up": True, "records": len(tail)},
            )

    def _handle_result(self, idx: int, result: dict) -> None:
        if result.get("error") == "stale_incarnation":
            # a follower tracked a NEWER incarnation of us than we are — our
            # durable writer meta was lost (full state-dir loss). Never ack
            # against such a follower; the next takeover/seal resolves it.
            logger.warning(
                f"journal writer shard {self.shard_index} incarnation "
                f"{self.incarnation} refused by follower {idx}: writer meta lost?"
            )
        if result.get("error") == "stale_epoch":
            # a follower sealed our stream at a higher epoch: a successor
            # already owns this partition — structurally stop committing
            if not self.fenced:
                logger.warning(
                    f"journal writer shard {self.shard_index} fenced by follower {idx} "
                    f"(epoch {result.get('epoch')} > ours {self.epoch})"
                )
            self.fenced = True
        if result.get("ok"):
            self.acked[idx] = max(self.acked.get(idx, 0), int(result.get("last_seq", 0)))
            self._trim_buffer()
        if self._ack_event is not None:
            self._ack_event.set()

    # -- transport ---------------------------------------------------------

    async def _send(self, url: str, **fields: Any) -> dict:
        """One JournalReplicate exchange: in-process fast path when the
        follower is co-located (in-proc sharding), else the follower's gRPC
        port. Raises on transport failure; returns the decoded payload."""
        from .._utils import local_transport
        from ..proto import api_pb2

        request = api_pb2.JournalReplicateRequest(
            writer_shard=self.shard_index,
            kind=fields["kind"],
            epoch=int(fields["epoch"]),
            base_seq=int(fields.get("base_seq", 0)),
            payload_json=fields.get("payload_json", ""),
            incarnation=self.incarnation,
            boot_seq=self.boot_seq,
        )
        server = local_transport.resolve_local_server(url)
        if server is not None:
            entry = server.handlers.get("JournalReplicate")
            if entry is not None:
                _method, impl = entry
                try:
                    resp = await impl(request, local_transport._LocalContext([]))
                except local_transport._AbortError as exc:
                    raise RuntimeError(f"replica rejected: {exc.details}") from exc
                return json.loads(resp.payload_json)
        stub = self._stub_cache.get(url)
        if stub is None:
            from .._utils.grpc_utils import create_channel
            from ..proto.rpc import ModalTPUStub

            channel = create_channel(url)
            self._channel_cache[url] = channel
            stub = self._stub_cache[url] = ModalTPUStub(channel)
        resp = await stub.JournalReplicate(request, timeout=self.timeout_s)
        return json.loads(resp.payload_json)

    # -- observability -----------------------------------------------------

    def status(self) -> dict:
        followers = self.current_followers()
        return {
            "replicas": self.replicas,
            "epoch": self.epoch,
            "incarnation": self.incarnation,
            "fenced": self.fenced,
            "quorum_acks_needed": min(quorum_acks_needed(self.replicas), len(followers))
            if followers
            else 0,
            "degraded_local_only": not followers,
            "followers": [
                {
                    "shard": idx,
                    "url": url,
                    "acked_seq": self.acked.get(idx, 0),
                    "lag_records": max(0, self.journal.seq - self.acked.get(idx, 0)),
                }
                for idx, url in followers
            ],
        }


# ---------------------------------------------------------------------------
# Offline helpers (CLI)
# ---------------------------------------------------------------------------


def offline_stream_status(state_dir: str) -> list[dict]:
    """`journal status`: the replica streams a (possibly stopped)
    shard holds for its peer writers, read straight off disk."""
    store = ReplicaStore(state_dir)
    try:
        return store.status_all()
    finally:
        store.close()


def offline_replicate_snapshot(
    fleet_root: str, writer_index: int, snapshot_path: str, covered_seq: int
) -> list[int]:
    """`journal compact` for a sharded fleet: copy the freshly
    written snapshot into every sibling shard's replica stream for this
    writer BEFORE the writer's segments are pruned — a follower must never
    need pruned history to seal. Returns the sibling indices updated."""
    try:
        with open(snapshot_path) as f:
            lines = f.read().splitlines()
    except OSError:
        return []
    updated: list[int] = []
    try:
        names = sorted(os.listdir(fleet_root))
    except OSError:
        return []
    indices: dict[int, str] = {}
    for name in names:
        if name.startswith("shard-"):
            try:
                indices[int(name[len("shard-") :])] = os.path.join(fleet_root, name)
            except ValueError:
                continue
    modulus = max(list(indices) + [writer_index]) + 1
    ring = sorted(
        (i for i in indices if i != writer_index),
        key=lambda i: (i - writer_index) % modulus,
    )
    followers = set(ring[: replicas_configured()])
    for idx in ring:
        sdir = indices[idx]
        # only touch siblings that already follow this writer, plus its
        # ring-order followers (the live replicator's deterministic set)
        if not os.path.isdir(stream_dir(sdir, writer_index)) and idx not in followers:
            continue
        store = ReplicaStore(sdir)
        try:
            st = store._stream(writer_index)
            result = store.install_snapshot(writer_index, st.epoch, covered_seq, lines)
            if result.get("ok"):
                updated.append(idx)
        finally:
            store.close()
    return updated
