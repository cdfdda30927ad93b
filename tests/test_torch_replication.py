"""Quorum journal replication (server/replication.py) in both packages.

The JAX package's tests/test_replication.py, each case run against the JAX
module and the port's (`pk`): the ReplicaStore's epoch-fencing matrix,
torn-tail repair, duplicates and gaps, the chaos faults, the seal at the
replicated max seq and materialize; the JournalReplicator's commit barrier,
ring order, capped buffer, incarnations and fencing; and the
MODAL_TPU_JOURNAL_REPLICAS=0 degradation. Then the same appends through both
packages' stores give the same record lines, meta.json and fence decisions.
Then the port's fleet: three in-process shards lose a shard and its journal
directory and take its partition over from the survivors' replica streams
(mode "replica"), and shard_status reports the replication.
"""

from __future__ import annotations

import asyncio
import importlib
import json
import os
import shutil
import time
import types

import pytest

PACKAGES = ("modal_tpu", "modal_tpu_torch")


def _ns(pkg: str) -> types.SimpleNamespace:
    rep = importlib.import_module(f"{pkg}.server.replication")
    return types.SimpleNamespace(
        JournalReplicator=rep.JournalReplicator,
        ReplicaStore=rep.ReplicaStore,
        offline_stream_status=rep.offline_stream_status,
        quorum_acks_needed=rep.quorum_acks_needed,
        replicas_configured=rep.replicas_configured,
        stream_dir=rep.stream_dir,
        WRITER_META_FILENAME=rep.WRITER_META_FILENAME,
        JOURNAL_DIRNAME=importlib.import_module(f"{pkg}.server.journal").JOURNAL_DIRNAME,
        ChaosPolicy=importlib.import_module(f"{pkg}.chaos").ChaosPolicy,
        _maybe_quorum=importlib.import_module(f"{pkg}.proto.rpc")._maybe_quorum,
        LocalSupervisor=importlib.import_module(f"{pkg}.server.supervisor").LocalSupervisor,
    )


@pytest.fixture(params=PACKAGES, ids=["jax", "port"])
def pk(request):
    return _ns(request.param)


def _rec(seq: int, **extra) -> str:
    payload = {"seq": seq, "rpc": "TestOp", "req": {"n": seq}}
    payload.update(extra)
    return json.dumps(payload, separators=(",", ":"))


def _records_on_disk(pk, state_dir: str, writer: int) -> list[dict]:
    path = os.path.join(pk.stream_dir(state_dir, writer), "records.jsonl")
    out = []
    with open(path) as f:
        for line in f:
            try:
                out.append(json.loads(line))
            except json.JSONDecodeError:
                pass  # torn tail — excluded on purpose
    return out


# -- config ---------------------------------------------------------------------


def test_quorum_math(pk):
    # majority of the write set (writer + followers), writer's own append free
    assert pk.quorum_acks_needed(0) == 0
    assert pk.quorum_acks_needed(1) == 1
    assert pk.quorum_acks_needed(2) == 1
    assert pk.quorum_acks_needed(3) == 2
    assert pk.quorum_acks_needed(4) == 2


def test_replicas_env_knob(pk, monkeypatch):
    monkeypatch.delenv("MODAL_TPU_JOURNAL_REPLICAS", raising=False)
    assert pk.replicas_configured() == 2, "default replica count changed"
    # gate off-toggle: MODAL_TPU_JOURNAL_REPLICAS=0 disables replication entirely
    monkeypatch.setenv("MODAL_TPU_JOURNAL_REPLICAS", "0")
    assert pk.replicas_configured() == 0
    monkeypatch.setenv("MODAL_TPU_JOURNAL_REPLICAS", "not-a-number")
    assert pk.replicas_configured() == 2, "garbage knob must fall back, not crash boot"


# -- ReplicaStore: append/dup/gap ----------------------------------------------


def test_store_append_dedupes_resent_records(pk, tmp_path):
    store = pk.ReplicaStore(str(tmp_path))
    try:
        r = store.append(0, 1, [_rec(1), _rec(2), _rec(3)])
        assert r == {"ok": True, "last_seq": 3, "epoch": 1}
        # resend after a dropped ack: seqs <= last_seq are skipped, not duplicated
        r = store.append(0, 1, [_rec(2), _rec(3), _rec(4)])
        assert r["ok"] and r["last_seq"] == 4
    finally:
        store.close()
    recs = _records_on_disk(pk, str(tmp_path), 0)
    assert [x["seq"] for x in recs] == [1, 2, 3, 4], "dup records leaked into the stream"


def test_store_refuses_gap(pk, tmp_path):
    store = pk.ReplicaStore(str(tmp_path))
    try:
        assert store.append(1, 1, [_rec(1)])["ok"]
        r = store.append(1, 1, [_rec(5)])
        assert r == {"ok": False, "error": "gap", "last_seq": 1, "epoch": 1}
        # the writer falls back to snapshot install, then the tail applies
        assert store.install_snapshot(1, 1, 4, [_rec(4, snapshot=True)])["ok"]
        assert store.append(1, 1, [_rec(5)])["last_seq"] == 5
    finally:
        store.close()


# -- ReplicaStore: epoch fencing matrix ----------------------------------------


def test_epoch_fencing_matrix(pk, tmp_path):
    store = pk.ReplicaStore(str(tmp_path))
    try:
        # writer at epoch 2 establishes the stream
        assert store.append(0, 2, [_rec(1), _rec(2)])["ok"]
        # stale epoch: structurally rejected (fencing token)
        r = store.append(0, 1, [_rec(3)])
        assert r == {"ok": False, "error": "stale_epoch", "last_seq": 2, "epoch": 2}
        # takeover seals at epoch 3: sealed_seq pins the replicated max-seq
        sealed = store.seal(0, 3)
        assert sealed["ok"] and sealed["sealed_seq"] == 2
        # the old writer cannot extend a sealed stream at ANY epoch <= the seal's
        for stale in (1, 2, 3):
            assert store.append(0, stale, [_rec(3)])["error"] == "stale_epoch"
        assert store.install_snapshot(0, 3, 9, [_rec(9)])["error"] == "stale_epoch"
        # a NEW incarnation of shard 0 (epoch 4 > seal) resets the stream
        r = store.append(0, 4, [_rec(1)])
        assert r == {"ok": True, "last_seq": 1, "epoch": 4}
        st = store.status(0)
        assert st["sealed_epoch"] == 0 and st["snapshot_seq"] == 0
    finally:
        store.close()


def test_seal_is_idempotent_and_fences_stale_sealers(pk, tmp_path):
    store = pk.ReplicaStore(str(tmp_path))
    try:
        assert store.append(2, 5, [_rec(1), _rec(2), _rec(3)])["ok"]
        first = store.seal(2, 6)
        again = store.seal(2, 6)
        assert first == again == {"ok": True, "last_seq": 3, "sealed_seq": 3, "epoch": 6}
        # a director retrying at an OLDER takeover epoch must not move the seal
        assert store.seal(2, 5)["error"] == "stale_epoch"
        # a later takeover may re-seal at a higher epoch
        assert store.seal(2, 7)["ok"]
    finally:
        store.close()


def test_fencing_survives_store_restart(pk, tmp_path):
    store = pk.ReplicaStore(str(tmp_path))
    store.append(0, 3, [_rec(1)])
    store.seal(0, 4)
    store.close()
    # meta.json is the durable fencing state — a restarted follower still rejects
    reopened = pk.ReplicaStore(str(tmp_path))
    try:
        assert reopened.append(0, 4, [_rec(2)])["error"] == "stale_epoch"
        st = reopened.status(0)
        assert st["sealed_epoch"] == 4 and st["sealed_seq"] == 1
    finally:
        reopened.close()


def test_fence_rejection_callback_fires(pk, tmp_path):
    seen: list[int] = []
    store = pk.ReplicaStore(str(tmp_path), on_fence_rejection=seen.append)
    try:
        store.append(1, 5, [_rec(1)])
        store.append(1, 2, [_rec(2)])  # stale → rejected → callback
        store.append(1, 1, [_rec(2)])
    finally:
        store.close()
    assert seen == [1, 1]


# -- ReplicaStore: writer incarnation (crash-restart divergence guard) ---------


def test_new_incarnation_truncates_phantom_tail(pk, tmp_path):
    """A kill -9 can lose the writer's buffered tail while followers keep it:
    the restarted writer replays to boot_seq and re-mints later seqs with
    DIFFERENT records. Deduping purely by seq would swallow them silently —
    the follower must truncate the phantom tail when it first sees the new
    incarnation."""
    store = pk.ReplicaStore(str(tmp_path))
    try:
        assert store.append(0, 1, [_rec(i) for i in range(1, 6)], incarnation=1)["ok"]
        # writer crash-restarted having durably replayed only to seq 3:
        # seqs 4..5 on this follower are phantoms the writer lost
        r = store.append(0, 1, [_rec(4, reminted=True)], incarnation=2, boot_seq=3)
        assert r["ok"] and r["last_seq"] == 4
        assert store.status(0)["incarnation"] == 2
    finally:
        store.close()
    recs = _records_on_disk(pk, str(tmp_path), 0)
    assert [x["seq"] for x in recs] == [1, 2, 3, 4]
    assert recs[3].get("reminted"), "re-minted seq 4 was seq-deduped against a phantom"


def test_incarnation_truncation_survives_follower_restart(pk, tmp_path):
    store = pk.ReplicaStore(str(tmp_path))
    store.append(1, 1, [_rec(i) for i in range(1, 4)], incarnation=1)
    store.append(1, 1, [_rec(2, reminted=True)], incarnation=2, boot_seq=1)
    store.close()
    reopened = pk.ReplicaStore(str(tmp_path))
    try:
        st = reopened.status(1)
        assert st["incarnation"] == 2 and st["last_seq"] == 2
        # the repeat of the SAME incarnation must not truncate again
        assert reopened.append(1, 1, [_rec(3)], incarnation=2, boot_seq=1)["last_seq"] == 3
    finally:
        reopened.close()
    assert [x["seq"] for x in _records_on_disk(pk, str(tmp_path), 1)] == [1, 2, 3]


def test_stale_incarnation_is_rejected(pk, tmp_path):
    store = pk.ReplicaStore(str(tmp_path))
    try:
        assert store.append(0, 1, [_rec(1)], incarnation=3, boot_seq=0)["ok"]
        r = store.append(0, 1, [_rec(2)], incarnation=2, boot_seq=0)
        assert r == {"ok": False, "error": "stale_incarnation", "last_seq": 1, "epoch": 1}
        # incarnation=0 (pre-incarnation peer / direct store use): no tracking
        assert store.append(0, 1, [_rec(2)])["ok"]
    finally:
        store.close()


def test_stale_epoch_never_triggers_truncation(pk, tmp_path):
    """Fencing order matters: a partitioned undead writer that crash-restarts
    (bumping its incarnation) but still carries its pre-takeover epoch must be
    refused BEFORE the incarnation logic can touch the stream."""
    store = pk.ReplicaStore(str(tmp_path))
    try:
        assert store.append(0, 5, [_rec(1), _rec(2)], incarnation=1)["ok"]
        r = store.append(0, 4, [_rec(1, undead=True)], incarnation=2, boot_seq=0)
        assert r["error"] == "stale_epoch"
        assert store.status(0)["last_seq"] == 2, "stale-epoch append truncated the stream"
        assert store.status(0)["incarnation"] == 1
    finally:
        store.close()
    assert [x["seq"] for x in _records_on_disk(pk, str(tmp_path), 0)] == [1, 2]


# -- ReplicaStore: torn tail + chaos faults ------------------------------------


def test_torn_tail_written_then_repaired_on_resend(pk, tmp_path):
    chaos = pk.ChaosPolicy(seed=0)
    chaos.set_knob("repl_torn_tail", 1)
    store = pk.ReplicaStore(str(tmp_path), chaos=chaos)
    try:
        r = store.append(0, 1, [_rec(1), _rec(2), _rec(3)])
        # the follower "crashed" mid-write: half of record 3 landed, no ack for it
        assert r["ok"] and r["last_seq"] == 2
    finally:
        store.close()
    raw = open(os.path.join(pk.stream_dir(str(tmp_path), 0), "records.jsonl")).read()
    assert not raw.endswith("\n"), "chaos torn tail did not tear"
    # a fresh store (follower restart) detects the torn tail and the writer's
    # resend repairs it in place — no duplicate, no corruption
    store = pk.ReplicaStore(str(tmp_path))
    try:
        assert store.status(0)["last_seq"] == 2
        assert store.append(0, 1, [_rec(3)]) == {"ok": True, "last_seq": 3, "epoch": 1}
    finally:
        store.close()
    assert [x["seq"] for x in _records_on_disk(pk, str(tmp_path), 0)] == [1, 2, 3]


def test_chaos_disk_full_rejects_then_recovers(pk, tmp_path):
    chaos = pk.ChaosPolicy(seed=0)
    chaos.set_knob("repl_disk_full", 1)
    store = pk.ReplicaStore(str(tmp_path), chaos=chaos)
    try:
        r = store.append(0, 1, [_rec(1)])
        assert r == {"ok": False, "error": "disk_full", "last_seq": 0, "epoch": 1}
        # budget consumed: the next append (operator freed space) succeeds
        assert store.append(0, 1, [_rec(1)])["ok"]
    finally:
        store.close()


def test_chaos_ack_drop_is_durable_but_nacked(pk, tmp_path):
    chaos = pk.ChaosPolicy(seed=0)
    chaos.set_knob("repl_ack_drop", 1)
    store = pk.ReplicaStore(str(tmp_path), chaos=chaos)
    try:
        r = store.append(0, 1, [_rec(1), _rec(2)])
        # partition-during-commit: durable on the follower, ack lost in flight
        assert not r["ok"] and r["error"] == "ack_dropped" and r["last_seq"] == 2
        # the writer resends; seq-dedupe makes the retry harmless
        assert store.append(0, 1, [_rec(1), _rec(2)])["ok"]
    finally:
        store.close()
    assert [x["seq"] for x in _records_on_disk(pk, str(tmp_path), 0)] == [1, 2]


def test_chaos_repl_knobs_parse_and_default_off(pk, monkeypatch):
    for var in (
        "MODAL_TPU_CHAOS_REPL_TORN_TAIL",
        "MODAL_TPU_CHAOS_REPL_DISK_FULL",
        "MODAL_TPU_CHAOS_REPL_ACK_DROP",
        "MODAL_TPU_CHAOS_REPL_LAG_MS",
    ):
        monkeypatch.delenv(var, raising=False)
    monkeypatch.setenv("MODAL_TPU_CHAOS", "1")
    policy = pk.ChaosPolicy.from_env()
    for knob in ("repl_torn_tail", "repl_disk_full", "repl_ack_drop"):
        assert policy.get_knob(knob) == 0, f"{knob} not off by default"
    assert policy.repl_lag_ms == 0.0
    monkeypatch.setenv("MODAL_TPU_CHAOS_REPL_TORN_TAIL", "2")
    monkeypatch.setenv("MODAL_TPU_CHAOS_REPL_DISK_FULL", "1")
    monkeypatch.setenv("MODAL_TPU_CHAOS_REPL_ACK_DROP", "3")
    monkeypatch.setenv("MODAL_TPU_CHAOS_REPL_LAG_MS", "12.5")
    policy = pk.ChaosPolicy.from_env()
    assert policy.get_knob("repl_torn_tail") == 2
    assert policy.get_knob("repl_disk_full") == 1
    assert policy.get_knob("repl_ack_drop") == 3
    assert policy.repl_lag_ms == 12.5
    monkeypatch.setenv("MODAL_TPU_CHAOS_REPL_LAG_MS", "banana")
    assert pk.ChaosPolicy.from_env().repl_lag_ms == 0.0, "typo'd knob must not kill boot"


# -- ReplicaStore: snapshot + materialize --------------------------------------


def test_snapshot_install_prunes_covered_records(pk, tmp_path):
    store = pk.ReplicaStore(str(tmp_path))
    try:
        store.append(0, 1, [_rec(i) for i in range(1, 6)])
        assert store.install_snapshot(0, 1, 4, [_rec(4, compacted=True)])["ok"]
        st = store.status(0)
        assert st["snapshot_seq"] == 4 and st["last_seq"] == 5
        # only the uncovered tail remains as raw records
        assert [x["seq"] for x in _records_on_disk(pk, str(tmp_path), 0)] == [5]
        # an older snapshot arriving late is a no-op, never a regression
        assert store.install_snapshot(0, 1, 2, [_rec(2)])["ok"]
        assert store.status(0)["snapshot_seq"] == 4
    finally:
        store.close()


def test_materialize_seals_at_replicated_max_seq(pk, tmp_path):
    store = pk.ReplicaStore(str(tmp_path))
    try:
        store.append(0, 1, [_rec(i) for i in range(1, 4)])
        store.install_snapshot(0, 1, 1, [_rec(1, compacted=True)])
        sealed = store.seal(0, 2)
        assert sealed["sealed_seq"] == 3
        root = store.materialize(0)
    finally:
        store.close()
    jdir = os.path.join(root, pk.JOURNAL_DIRNAME)
    assert os.path.exists(os.path.join(jdir, "snapshot-1.jsonl"))
    seg = open(os.path.join(jdir, "segment-000001.jsonl")).read().splitlines()
    assert [json.loads(s)["seq"] for s in seg] == [2, 3], "materialized tail != seal range"


def test_offline_stream_status_reads_cold_disk(pk, tmp_path):
    store = pk.ReplicaStore(str(tmp_path))
    store.append(1, 2, [_rec(1), _rec(2)])
    store.append(2, 1, [_rec(1)])
    store.close()
    statuses = {s["writer"]: s for s in pk.offline_stream_status(str(tmp_path))}
    assert statuses[1]["last_seq"] == 2 and statuses[1]["epoch"] == 2
    assert statuses[2]["last_seq"] == 1


# -- JournalReplicator: commit barrier + fencing -------------------------------


class _FakeJournal:
    def __init__(self, seq: int = 0):
        self.seq = seq

    def latest_snapshot(self):
        return None

    def tail_lines(self, since_seq: int):
        return []


def _replicator(pk, tmp_path, peers, seq=5, replicas=2):
    journal = _FakeJournal(seq=seq)
    repl = pk.JournalReplicator(
        journal, shard_index=0, state_dir=str(tmp_path), peers=lambda: peers, replicas=replicas
    )
    repl.timeout_s = 0.3  # unit tests never wait the production 5s
    return repl


async def test_commit_barrier_acks_quorum_in_any_order(pk, tmp_path):
    repl = _replicator(pk, tmp_path, [(1, "u1"), (2, "u2")], seq=5)
    repl._ack_event = asyncio.Event()
    # no acks yet → the barrier must NOT pass
    assert await repl.commit_barrier() is False
    # one stale ack (seq 3 < 5) is not enough
    repl.acked[1] = 3
    assert await repl.commit_barrier() is False
    # quorum for replicas=2 is ONE durable follower at >= journal.seq —
    # and it may be either follower (ack ordering is immaterial)
    repl.acked[2] = 5
    assert await repl.commit_barrier() is True
    repl.acked = {1: 7}
    assert await repl.commit_barrier() is True, "over-acked follower must also satisfy"


async def test_commit_barrier_fenced_writer_never_commits(pk, tmp_path):
    repl = _replicator(pk, tmp_path, [(1, "u1"), (2, "u2")], seq=1)
    repl._ack_event = asyncio.Event()
    repl.acked = {1: 99, 2: 99}
    repl.fenced = True
    assert await repl.commit_barrier() is False, "a fenced writer acked a mutation"


async def test_commit_barrier_degrades_without_followers(pk, tmp_path):
    # zero live peers: local-only commit keeps the fleet serving (degradation
    # matrix row), rather than turning follower outages into a total outage
    repl = _replicator(pk, tmp_path, [], seq=9)
    repl._ack_event = asyncio.Event()
    assert await repl.commit_barrier() is True
    # replicas=0 (MODAL_TPU_JOURNAL_REPLICAS=0): barrier is a no-op pass-through
    off = _replicator(pk, tmp_path, [(1, "u1")], seq=9, replicas=0)
    assert off.active is False
    assert await off.commit_barrier() is True


async def test_stale_epoch_result_fences_writer(pk, tmp_path):
    repl = _replicator(pk, tmp_path, [(1, "u1")], seq=2)
    repl._ack_event = asyncio.Event()
    repl._handle_result(1, {"ok": False, "error": "stale_epoch", "epoch": 7})
    assert repl.fenced is True
    assert await repl.commit_barrier() is False


def test_ring_order_follower_selection(pk, tmp_path):
    peers = [(1, "u1"), (2, "u2"), (3, "u3"), (4, "u4")]
    journal = _FakeJournal()
    repl = pk.JournalReplicator(journal, shard_index=3, state_dir=str(tmp_path), peers=lambda: peers, replicas=2)
    # ring order after shard 3 in a 5-wide fleet: 4, then 0 (absent), then 1
    assert [idx for idx, _ in repl.current_followers()] == [4, 1]


async def test_observe_trims_buffer_to_slowest_follower(pk, tmp_path):
    repl = _replicator(pk, tmp_path, [(1, "u1"), (2, "u2")], seq=0)
    repl._ack_event = asyncio.Event()
    for seq in range(1, 6):
        repl.journal.seq = seq
        repl.observe({"seq": seq, "rpc": "TestOp"})
    assert len(repl._buffer) == 5
    repl._handle_result(1, {"ok": True, "last_seq": 5})
    assert len(repl._buffer) == 5, "trimmed past the slowest follower's ack"
    repl._handle_result(2, {"ok": True, "last_seq": 3})
    assert [seq for seq, _, _ in repl._buffer] == [4, 5]


async def test_buffer_is_capped_despite_unreachable_follower(pk, tmp_path):
    """One unreachable-but-not-yet-dead follower pins the min-acked floor at
    0; the buffer must still be bounded — the slow follower is evicted to the
    disk catch-up path instead of growing writer memory without limit."""
    repl = _replicator(pk, tmp_path, [(1, "u1"), (2, "u2")], seq=0)
    repl._ack_event = asyncio.Event()
    repl.buffer_max = 3
    for seq in range(1, 8):
        repl.journal.seq = seq
        repl.observe({"seq": seq, "rpc": "TestOp"})
    assert [seq for seq, _, _ in repl._buffer] == [5, 6, 7], "buffer grew past the cap"
    # follower 2 acks within the retained window; follower 1 never acks —
    # the ack-path trim must keep the cap too
    repl._handle_result(2, {"ok": True, "last_seq": 6})
    assert len(repl._buffer) <= 3
    # the evicted follower reads as behind the buffer floor → disk catch-up
    assert repl._buffer[0][0] > repl.acked.get(1, 0) + 1


# -- writer meta: incarnation + epoch survive a crash-restart -------------------


def test_writer_meta_bumps_incarnation_and_restores_epoch(pk, tmp_path):
    repl = _replicator(pk, tmp_path, [(1, "u1")], seq=5)
    assert repl.incarnation == 1 and repl.boot_seq == 5
    repl.note_epoch(7)
    # crash-restart: a new replicator on the same state dir is a NEW
    # incarnation and resumes at the adopted fleet epoch, not epoch 1 —
    # restarting at 1 would get every append stale_epoch-rejected (and the
    # shard permanently fenced) until the next director probe
    reborn = _replicator(pk, tmp_path, [(1, "u1")], seq=3)
    assert reborn.incarnation == 2
    assert reborn.epoch == 7
    assert reborn.boot_seq == 3


def test_note_epoch_clears_fence_on_strictly_higher_epoch(pk, tmp_path):
    repl = _replicator(pk, tmp_path, [(1, "u1")], seq=1)
    repl._handle_result(1, {"ok": False, "error": "stale_epoch", "epoch": 9})
    assert repl.fenced is True
    repl.note_epoch(repl.epoch)  # same epoch: not an un-fence authority
    assert repl.fenced is True
    repl.note_epoch(repl.epoch + 1)  # the director re-adopted us
    assert repl.fenced is False


def test_writer_meta_skipped_when_replication_off(pk, tmp_path):
    _replicator(pk, tmp_path, [(1, "u1")], replicas=0)
    assert not os.path.exists(os.path.join(str(tmp_path), pk.WRITER_META_FILENAME)), (
        "replicas=0 must stay byte-identical: no writer meta file"
    )


# -- replicas=0 byte-identical degradation -------------------------------------


def test_replicas_zero_is_byte_identical_no_quorum_wrapper(pk, tmp_path, monkeypatch):
    """MODAL_TPU_JOURNAL_REPLICAS=0 must degrade to the unreplicated plane: no replica/ directory, no journal observer, and `_maybe_quorum`
    returning the raw impl object (identity, not an equivalent wrapper)."""
    monkeypatch.setenv("MODAL_TPU_JOURNAL_REPLICAS", "0")

    class _Method:
        name = "FunctionCreate"  # a JOURNALED_RPCS member

    class _Servicer:
        replicator = object()  # even with a replicator attached, 0 gates it off

    async def impl(request, context):
        return "resp"

    assert pk._maybe_quorum(_Servicer(), _Method(), impl) is impl


async def test_replica_store_inherits_journal_fsync(pk, tmp_path, monkeypatch):
    """MODAL_TPU_JOURNAL_FSYNC must govern BOTH sides of a quorum: a
    follower's "durably appended" ack is a lie if the writer fsyncs and the
    replica store only reaches the page cache."""
    monkeypatch.delenv("MODAL_TPU_JOURNAL_REPLICAS", raising=False)
    monkeypatch.setenv("MODAL_TPU_JOURNAL_FSYNC", "1")
    sup = pk.LocalSupervisor(
        num_workers=0,
        state_dir=str(tmp_path / "state"),
        replication_peers=lambda: [(1, "grpc://127.0.0.1:1")],
    )
    sup._attach_journal()
    journal = sup.state.journal
    try:
        assert journal.fsync is True
        assert sup.replica_store is not None and sup.replica_store.fsync is True
    finally:
        await sup._stop_replication()
        journal.close()


async def test_replicas_zero_supervisor_has_no_replication(pk, tmp_path, monkeypatch):
    monkeypatch.setenv("MODAL_TPU_JOURNAL_REPLICAS", "0")
    sup = pk.LocalSupervisor(
        num_workers=0,
        state_dir=str(tmp_path / "state"),
        replication_peers=lambda: [(1, "grpc://127.0.0.1:1")],
    )
    sup._attach_journal()
    journal = sup.state.journal
    try:
        assert sup.replica_store is None
        assert sup.state.replicator is None
        assert journal is not None and journal.observer is None
        assert not os.path.isdir(os.path.join(str(tmp_path / "state"), "replica"))
    finally:
        journal.close()




# -- the same appends through both packages' stores ---------------------------


def _drive_store(pkg: str, root: str) -> tuple[list, dict]:
    """A seeded sequence of appends, snapshots, seals and stale writers; the
    decisions the store took and the files it left."""
    import numpy as np

    ns = _ns(pkg)
    chaos = ns.ChaosPolicy(seed=0)
    chaos.set_knob("repl_ack_drop", 1)
    rng = np.random.default_rng(19)
    store = ns.ReplicaStore(root, chaos=chaos)
    decisions = []
    last = {0: 0, 2: 0}
    try:
        for step in range(60):
            writer = int(rng.choice([0, 2]))
            op = int(rng.integers(0, 10))
            if op < 6:
                n = int(rng.integers(1, 4))
                start = last[writer] + 1 - int(rng.integers(0, 2))  # a resend now and then
                lines = [_rec(s, step=step, w=writer) for s in range(max(1, start), last[writer] + 1 + n)]
                epoch = int(rng.integers(1, 4))
                r = store.append(writer, epoch, lines, incarnation=1 + step // 30, boot_seq=last[writer])
                last[writer] = max(last[writer], r.get("last_seq", 0))
            elif op < 8:
                r = store.install_snapshot(writer, 3, max(0, last[writer] - 1), [_rec(last[writer], snap=step)])
            elif op < 9:
                r = store.seal(writer, int(rng.integers(2, 6)))
            else:
                r = store.status(writer)
            decisions.append((step, writer, op, r))
    finally:
        store.close()
    files = {}
    for writer in (0, 2):
        d = ns.stream_dir(root, writer)
        for name in sorted(os.listdir(d)) if os.path.isdir(d) else ():
            path = os.path.join(d, name)
            if os.path.isfile(path):
                with open(path, "rb") as f:
                    files[f"{writer}/{name}"] = f.read()
    return decisions, files


def test_the_same_appends_give_the_same_stream_files_and_fence_decisions(tmp_path):
    jax = _drive_store("modal_tpu", str(tmp_path / "jax"))
    port = _drive_store("modal_tpu_torch", str(tmp_path / "port"))
    assert port[0] == jax[0]
    assert port[1] == jax[1]
    # the run exercised the fence, the seal and the snapshot paths
    errors = {d[3].get("error") for d in jax[0]}
    assert {"stale_epoch", "ack_dropped"} <= errors
    assert any(name.endswith("snapshot.jsonl") for name in jax[1]) and any(
        json.loads(jax[1][n]).get("sealed_epoch") for n in jax[1] if n.endswith("meta.json")
    )


def test_materialize_gives_the_same_journal_dir(tmp_path):
    out = {}
    for pkg in PACKAGES:
        ns = _ns(pkg)
        store = ns.ReplicaStore(str(tmp_path / pkg))
        try:
            store.append(1, 2, [_rec(i) for i in range(1, 7)])
            store.install_snapshot(1, 2, 2, [_rec(2, compacted=True)])
            store.seal(1, 3)
            root = store.materialize(1)
        finally:
            store.close()
        jdir = os.path.join(root, ns.JOURNAL_DIRNAME)
        out[pkg] = {n: open(os.path.join(jdir, n), "rb").read() for n in sorted(os.listdir(jdir))}
    assert out["modal_tpu_torch"] == out["modal_tpu"]
    assert sorted(out["modal_tpu"]) == ["segment-000001.jsonl", "snapshot-2.jsonl"]


def test_the_ported_journal_feeds_the_replicator_its_lines(tmp_path):
    """The journal's observer gets each appended record with its line, and
    tail_lines/latest_snapshot read the catch-up feed the JAX journal does."""
    from modal_tpu.server.journal import Journal as JJournal
    from modal_tpu_torch.server.journal import Journal as TJournal

    got = {}
    for name, cls in (("jax", JJournal), ("port", TJournal)):
        j = cls(str(tmp_path / name))
        seen = []
        j.observer = lambda payload, line, _seen=seen: _seen.append((payload["seq"], line))
        for i in range(5):
            j.append("worker_gone", worker_id=f"wk-{i}")
        j.write_snapshot([{"t": "worker_gone", "worker_id": "wk-s"}])
        j.append("worker_gone", worker_id="wk-5")
        snap = j.latest_snapshot()
        got[name] = ([(s, line.rstrip("\n")) for s, line in seen], j.tail_lines(0), (snap[0], os.path.basename(snap[1])))
        j.close()
    # the records carry the time of the append: compare without it
    def strip(pairs):
        return [(s, {k: v for k, v in json.loads(line).items() if k != "time"}) for s, line in pairs]

    assert strip(got["port"][0]) == strip(got["jax"][0])
    assert strip(got["port"][1]) == strip(got["jax"][1]) and [s for s, _ in got["port"][1]] == [6]
    assert got["port"][2] == got["jax"][2] == (5, "snapshot-000000000005.jsonl")


def test_the_quorum_layer_holds_a_journaled_rpc_until_the_barrier(monkeypatch):
    """With a replicator the port's quorum layer wraps the journaled RPCs
    only, answers after the barrier, and aborts UNAVAILABLE when it fails."""
    import grpc

    from modal_tpu_torch._utils.local_transport import _AbortError, _LocalContext
    from modal_tpu_torch.proto.rpc import _maybe_quorum

    monkeypatch.delenv("MODAL_TPU_JOURNAL_REPLICAS", raising=False)

    class _Repl:
        active, fenced, ok, calls = True, False, True, 0

        async def commit_barrier(self):
            self.calls += 1
            return self.ok

    class _Servicer:
        replicator = _Repl()

    class _Method:
        def __init__(self, name):
            self.name = name

    async def impl(request, context):
        return "resp"

    servicer = _Servicer()
    assert _maybe_quorum(servicer, _Method("ClientHello"), impl) is impl
    wrapped = _maybe_quorum(servicer, _Method("FunctionMap"), impl)
    assert wrapped is not impl
    assert asyncio.run(wrapped(None, _LocalContext([]))) == "resp" and servicer.replicator.calls == 1
    servicer.replicator.ok = False
    with pytest.raises(_AbortError) as exc:
        asyncio.run(wrapped(None, _LocalContext([])))
    assert exc.value.code == grpc.StatusCode.UNAVAILABLE and "quorum timeout" in exc.value.details


# -- the port's fleet: lose the shard and its journal directory ---------------


@pytest.fixture
def sharded(tmp_path, monkeypatch):
    """Three in-process shards of the port with replication on (the default
    replicas=2), one worker each, a fast health loop."""
    from modal_tpu_torch._utils.async_utils import synchronizer
    from modal_tpu_torch.client import _Client
    from modal_tpu_torch.server.shards import ShardedSupervisor

    monkeypatch.delenv("MODAL_TPU_JOURNAL_REPLICAS", raising=False)
    state = os.path.join(_short_tmp(), "state")
    sup = ShardedSupervisor(num_shards=3, num_workers=3, state_dir=state, worker_gpus=8,
                            worker_gpu_type="local-sim", health_interval_s=0.2)
    synchronizer.run(sup.start())
    client = _Client(sup.server_url)
    client._open()
    client.hello()
    _Client.set_env_client(client)
    sup.test_client = client
    try:
        yield sup
    finally:
        _Client.set_env_client(None)
        client._close()
        synchronizer.run(sup.stop())


def _short_tmp() -> str:
    import tempfile

    return tempfile.mkdtemp(prefix="repl-", dir="/tmp")


def _wait_for(predicate, timeout_s: float = 30.0, what: str = "condition"):
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        if predicate():
            return
        time.sleep(0.1)
    raise AssertionError(f"timed out waiting for {what}")


def test_kill_and_delete_journal_dir_replica_takeover(sharded):
    """The home shard dies and its journal directory is deleted (the disk,
    not only the process). The director seals the survivors' replica streams
    and adopts from them, mode "replica", and a map after the takeover
    computes every index once."""
    import modal_tpu_torch
    from modal_tpu_torch._utils.async_utils import synchronizer
    from modal_tpu_torch._utils.shard_routing import partition_for_name

    client = sharded.test_client
    assert type(client._stub).__name__ == "ShardRouterStub" and len(client._stub.shard_urls) == 3
    app = modal_tpu_torch.App("repl-e2e")

    def double(x):
        return x * 2

    f = app.function(serialized=True)(double)
    with app.run(client=client):
        assert sorted(f.map(range(24))) == [x * 2 for x in range(24)]

    home = partition_for_name("repl-e2e", 3)
    _wait_for(
        lambda: any(
            sharded.shards[i].replica_store is not None
            and sharded.shards[i].replica_store.status(home).get("last_seq", 0) > 0
            for i in range(3) if i != home
        ),
        what=f"a replica stream of shard {home} on a survivor",
    )
    synchronizer.run(sharded.kill_shard(home))
    shutil.rmtree(os.path.join(sharded.state_dir, f"shard-{home}", "journal"))
    # the log entry is written after the remap and the rehome
    _wait_for(lambda: any(e["dead_shard"] == home for e in sharded.takeover_log),
              what=f"replica takeover of partition {home}")
    assert sharded.assignments[home] != home
    (entry,) = [e for e in sharded.takeover_log if e["dead_shard"] == home]
    assert entry["mode"] == "replica" and entry["report"]["records_applied"] > 0
    assert "seal" in entry["phases"] and entry["epoch"] == sharded.epoch == 2
    for i in range(3):
        if i != home:
            st = sharded.shards[i].replica_store.status(home)
            assert st["ok"] and st["sealed_epoch"] == sharded.epoch, i
    with app.run(client=client):
        assert sorted(f.map(range(10))) == [x * 2 for x in range(10)]


def test_sharded_status_reports_replication(sharded):
    """shard_status carries the writer's replicator view (ring-order
    followers, acks) and the replica streams the shard holds."""
    import modal_tpu_torch

    app = modal_tpu_torch.App("repl-status")

    def inc(x):
        return x + 1

    f = app.function(serialized=True)(inc)
    with app.run(client=sharded.test_client):
        assert sorted(f.map(range(6))) == list(range(1, 7))
    saw_follower_ack = False
    for i in range(3):
        st = sharded.shards[i].shard_status()
        repl = st["replication"]
        assert repl is not None and repl["replicas"] == 2
        assert [f_["shard"] for f_ in repl["followers"]] == [(i + 1) % 3, (i + 2) % 3]
        saw_follower_ack = saw_follower_ack or any(f_["acked_seq"] > 0 for f_ in repl["followers"])
        assert isinstance(st["replica_streams"], list)
    assert saw_follower_ack
