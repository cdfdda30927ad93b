"""Control-plane state: the in-memory data model (port of
modal_tpu/server/state.py).

The JAX package's model: apps, functions, their input queues and calls,
tasks and workers, the App layer's images and secrets, the SDK's dicts,
queues (partitions, each with its own condition), proxies, environments,
workspace settings and tokens, plus the on-disk blob store, the
content-addressed block store of mounts and the fleet compile cache. A worker holds GPUs: a type (the card's full name),
a count, and which cards are pinned to which task.

The state is volatile dataclasses made durable by the write-ahead journal
(server/journal.py): the supervisor attaches `journal` and `idempotency`,
and a restarted plane replays them into a fresh ServerState. A shard of a
sharded plane (server/shards.py) also gets a `replicator`, which streams its
journal to its sibling shards (server/replication.py), and mints its ids in
its own partition (`make_id(prefix, namespace)`). Volumes (their files' block lists; the blocks live in `block_dir`) are
journaled; sandboxes and their snapshots and tunnels are not, as in the JAX
package: their processes live on the plane's host, and neither are gangs
(`ClusterState`), whose tasks recover as gone. A dict's or a queue's
registry (id, name, ephemeral) is journaled and its contents are not, as in
the JAX package.
"""

from __future__ import annotations

import asyncio
import itertools
import os
import time
from dataclasses import dataclass, field
from typing import Optional

from ..proto import api_pb2
from .compile_cache import CompileCacheStore

# The sharded control plane (server/shards.py): every object id embeds its
# home partition, so an RPC that carries an id routes with no lookup table.
# The number is `partition * PARTITION_STRIDE + local_counter`; partition 0
# stays inside the stride, so a monolith mints the 8-digit ids it always did.
PARTITION_STRIDE = 10**8

_id_counters: dict[tuple[int, str], itertools.count] = {}


def make_id(prefix: str, namespace: int = 0) -> str:
    """`<prefix>-NNNNNNNN` in partition `namespace`, as the JAX control
    plane mints them."""
    counter = _id_counters.setdefault((namespace, prefix), itertools.count(1))
    return f"{prefix}-{namespace * PARTITION_STRIDE + next(counter):08d}"


def partition_of_id(object_id: str) -> Optional[int]:
    """The home partition embedded in an object id, or None for an id
    outside the `prefix-NNNNNNNN` scheme (content-hashed blob ids, names):
    the placement director routes those."""
    _, _, num = object_id.rpartition("-")
    if not num.isdigit():
        return None
    return int(num) // PARTITION_STRIDE


def bump_id_counter(existing_id: str) -> None:
    """Advance the counter of the id's prefix and partition past an id
    recovered from the journal, so a fresh make_id never re-issues it.
    Counters only move forward: safe with several planes in one process. A
    takeover that replays a dead shard's journal bumps the dead partition's
    counters, so a respawned shard cannot re-mint a migrated id either."""
    prefix, _, num = existing_id.rpartition("-")
    if not prefix or not num.isdigit():
        return
    namespace, floor = int(num) // PARTITION_STRIDE, int(num) % PARTITION_STRIDE + 1
    counter = _id_counters.setdefault((namespace, prefix), itertools.count(1))
    # itertools.count has no peek: draw once, then keep the further one
    _id_counters[(namespace, prefix)] = itertools.count(max(next(counter), floor))


@dataclass
class AppState:
    app_id: str
    description: str = ""
    name: str = ""
    state: int = api_pb2.APP_STATE_INITIALIZING
    environment_name: str = ""
    created_at: float = field(default_factory=time.time)
    stopped_at: float = 0.0
    last_heartbeat: float = field(default_factory=time.time)
    function_ids: dict[str, str] = field(default_factory=dict)
    class_ids: dict[str, str] = field(default_factory=dict)
    deployment_history: list[api_pb2.AppDeploymentHistory] = field(default_factory=list)
    version: int = 0
    log_entries: list[api_pb2.TaskLogs] = field(default_factory=list)
    log_condition: asyncio.Condition = field(default_factory=asyncio.Condition)
    done: bool = False


@dataclass
class InputState:
    input_id: str
    function_call_id: str
    idx: int
    input: api_pb2.FunctionInput
    status: str = "pending"  # pending | claimed | done | cancelled
    retry_count: int = 0
    claimed_by: str = ""  # task_id
    claimed_at: float = 0.0
    created_at: float = field(default_factory=time.time)
    # checkpoint recorded by a preempted attempt (ContainerCheckpoint):
    # redelivered with the input so the retry resumes instead of restarting
    resume_token: str = ""
    # "trace_id:span_id" of the submitting RPC, redelivered with the input
    trace_context: str = ""
    # gang broadcast: the ranks that have received this input
    delivered_to: set = field(default_factory=set)


@dataclass
class FunctionCallState:
    function_call_id: str
    function_id: str
    call_type: int = api_pb2.FUNCTION_CALL_TYPE_UNARY
    invocation_type: int = api_pb2.FUNCTION_CALL_INVOCATION_TYPE_SYNC
    created_at: float = field(default_factory=time.time)
    input_ids: list[str] = field(default_factory=list)
    outputs: list[api_pb2.FunctionGetOutputsItem] = field(default_factory=list)
    outputs_consumed: int = 0
    output_condition: asyncio.Condition = field(default_factory=asyncio.Condition)
    data_chunks: list[api_pb2.DataChunk] = field(default_factory=list)
    data_condition: asyncio.Condition = field(default_factory=asyncio.Condition)
    num_inputs: int = 0
    num_done: int = 0
    cancelled: bool = False
    return_exceptions: bool = False
    first_output_at: float = 0.0
    # ("input_id:retry_count") of every delivered output: a requeued input
    # whose dead attempt already reported cannot deliver twice
    output_keys: set = field(default_factory=set)
    server_originated: bool = False  # a schedule's fire: GC'd after completion


@dataclass
class FunctionState:
    function_id: str
    app_id: str
    tag: str
    definition: api_pb2.Function
    created_at: float = field(default_factory=time.time)
    # queue of pending input_ids awaiting a container
    pending: list[str] = field(default_factory=list)
    input_condition: asyncio.Condition = field(default_factory=asyncio.Condition)
    task_ids: set[str] = field(default_factory=set)
    init_failures: int = 0  # consecutive container INIT_FAILUREs
    placement_unsat_since: float = 0.0  # when placement first looked unsatisfiable
    bound_parent: Optional[str] = None  # parametrized variant parent id
    serialized_params: bytes = b""
    autoscaler_override: Optional[api_pb2.AutoscalerSettings] = None
    # EWMA of per-call wall time reported by containers on FunctionGetInputs:
    # shapes the autoscaler's drain-time estimate
    reported_call_time: float = 0.0
    # the web endpoint's URL, set by its container (FunctionSetWebUrl)
    web_url: str = ""
    # the next schedule fire (server/cron.py): 0 = not evaluated yet, -1 =
    # disabled after an evaluation error
    next_fire_at: float = 0.0
    # SLO autoscaling cooldown stamp (scheduler._slo_desired): a serving
    # replica count moves at most one step per window
    slo_last_scale_at: float = 0.0

    @property
    def autoscaler(self) -> api_pb2.AutoscalerSettings:
        return self.autoscaler_override or self.definition.autoscaler_settings


@dataclass
class TaskState_:
    task_id: str
    function_id: str
    app_id: str
    state: int = api_pb2.TASK_STATE_QUEUED
    worker_id: str = ""
    created_at: float = field(default_factory=time.time)
    started_at: float = 0.0
    first_input_at: float = 0.0
    first_output_at: float = 0.0
    finished_at: float = 0.0
    last_heartbeat: float = 0.0
    cancelled_input_ids: list[str] = field(default_factory=list)
    terminate: bool = False
    preempted: bool = False
    result: Optional[api_pb2.GenericResult] = None
    gpu_ids: list[int] = field(default_factory=list)
    # trace context of the input whose backlog caused this launch: the
    # container's boot spans parent there
    trace_context: str = ""
    # the container's previous telemetry push (raw JSON): merges are
    # delta'd against it (observability/device_telemetry.py)
    telemetry_prev_json: str = ""
    # the bearer token of the task's router RPCs (x-task-token)
    router_token: str = ""
    # served by a pre-forked warm-pool interpreter (its ContainerHello said so)
    warm_pool_hit: bool = False
    # a gang member: its rank and gang, and the address it reported at the
    # rendezvous (TaskClusterHello)
    rank: int = 0
    cluster_id: str = ""
    container_address: str = ""


@dataclass
class ClusterState:
    """A gang: `size` tasks of one function placed together, each rank on
    its own cards (JAX: the hosts of one pod slice)."""

    cluster_id: str
    function_id: str
    size: int
    task_ids: list[str] = field(default_factory=list)  # rank order
    reported: dict[str, str] = field(default_factory=dict)  # task_id -> container address
    coordinator_port: int = 0
    condition: asyncio.Condition = field(default_factory=asyncio.Condition)


@dataclass
class VolumeState:
    volume_id: str
    name: str = ""
    version: int = api_pb2.VOLUME_FS_VERSION_V2
    created_at: float = field(default_factory=time.time)
    files: dict[str, api_pb2.VolumeFile] = field(default_factory=dict)
    committed_version: int = 0
    # an ephemeral volume lives while its client heartbeats (0.0: not
    # ephemeral)
    ephemeral: bool = False
    last_heartbeat: float = 0.0


@dataclass
class SecretState:
    secret_id: str
    name: str = ""
    env_dict: dict[str, str] = field(default_factory=dict)
    created_at: float = field(default_factory=time.time)
    last_used_at: float = 0.0


@dataclass
class ProxyState:
    """A static-egress proxy (reference proxy.py:1): a named, stable
    outbound IP a function binds with `proxy=`."""

    proxy_id: str
    name: str = ""
    proxy_ip: str = ""
    environment_name: str = ""
    created_at: float = field(default_factory=time.time)


@dataclass
class DictState:
    dict_id: str
    name: str = ""
    data: dict[bytes, bytes] = field(default_factory=dict)
    created_at: float = field(default_factory=time.time)
    ephemeral: bool = False
    last_heartbeat: float = 0.0


@dataclass
class QueuePartition:
    items: list[tuple[str, bytes]] = field(default_factory=list)  # (entry_id, value)
    condition: asyncio.Condition = field(default_factory=asyncio.Condition)
    next_entry: int = 0


@dataclass
class QueueState:
    queue_id: str
    name: str = ""
    partitions: dict[str, QueuePartition] = field(default_factory=dict)
    created_at: float = field(default_factory=time.time)
    ephemeral: bool = False
    last_heartbeat: float = 0.0

    def partition(self, key: str) -> QueuePartition:
        return self.partitions.setdefault(key, QueuePartition())


@dataclass
class ImageState:
    """An image definition. `built` is the plane's view; the worker builds
    the chain on first use (server/image_builder.py)."""

    image_id: str
    definition: api_pb2.Image
    metadata: api_pb2.ImageMetadata = field(default_factory=api_pb2.ImageMetadata)
    built: bool = False
    created_at: float = field(default_factory=time.time)


@dataclass
class WorkerState:
    worker_id: str
    hostname: str = ""
    gpu_type: str = ""  # the card's full name, e.g. "NVIDIA H100 80GB HBM3"
    num_gpus: int = 0
    milli_cpu: int = 0
    memory_mb: int = 0
    container_address: str = ""
    region: str = ""  # placement labels (SchedulerPlacement matching)
    zone: str = ""
    spot: bool = False
    instance_type: str = ""
    last_heartbeat: float = field(default_factory=time.time)
    # assignment channel consumed by the worker's WorkerPoll stream
    events: asyncio.Queue = field(default_factory=asyncio.Queue)
    active_tasks: set[str] = field(default_factory=set)
    gpus_in_use: dict[int, str] = field(default_factory=dict)  # card index -> task_id
    # preemption drain: no new placements land here; tasks still running
    # past drain_deadline are force-reaped (their inputs requeue for free)
    draining: bool = False
    drain_deadline: float = 0.0
    # journal-recovered and not yet heard from: no placements until its next
    # heartbeat re-adopts it (scheduler.WORKER_READOPT_GRACE_S)
    adoption_pending: bool = False
    recovered_at: float = 0.0
    # the worker's task command router (server/task_router.py)
    router_address: str = ""
    # parked warm-pool interpreters, from the last heartbeat (placement
    # tie-break), and the pool directives last sent (image_id -> target;
    # the scheduler sends a change only)
    warm_pool_ready: int = 0
    pool_directives: dict[str, int] = field(default_factory=dict)

    def free_gpus(self) -> list[int]:
        return [g for g in range(self.num_gpus) if g not in self.gpus_in_use]


@dataclass
class SandboxState_:
    sandbox_id: str
    app_id: str
    definition: api_pb2.Sandbox
    state: int = api_pb2.SANDBOX_STATE_PENDING
    task_id: str = ""
    created_at: float = field(default_factory=time.time)
    result: Optional[api_pb2.GenericResult] = None
    condition: asyncio.Condition = field(default_factory=asyncio.Condition)
    stdin_chunks: list[bytes] = field(default_factory=list)
    stdin_eof: bool = False
    stdin_last_index: int = 0  # dedupes retried SandboxStdinWrite calls
    name: str = ""
    tunnels: list = field(default_factory=list)  # TunnelData, reported by the worker
    tunnels_reported: bool = False
    ready: bool = False  # the readiness probe passed (or none was configured)
    workdir: str = ""  # the cwd the worker reported (a fs snapshot tars this)
    # name -> SandboxSidecar; running and returncode set by SandboxSidecarExit
    sidecars: dict[str, api_pb2.SandboxSidecar] = field(default_factory=dict)


@dataclass
class SandboxSnapshotState:
    """A full sandbox snapshot: its definition and its workdir's tarball."""

    snapshot_id: str
    definition: api_pb2.Sandbox
    fs_blob_id: str
    created_at: float = field(default_factory=time.time)


class ServerState:
    """All control-plane state + the on-disk stores."""

    def __init__(self, state_dir: str, shard_index: int = 0, blob_dir: Optional[str] = None):
        self.state_dir = state_dir
        # the partition this state mints its ids in (server/shards.py); 0 on
        # a monolith, whose ids and journal are those of an unsharded plane
        self.shard_index = shard_index
        # the shards of a fleet share one blob store (blob ids are content
        # hashes or presigned, so any shard serves any blob): the sharded
        # supervisor passes the fleet's dir; a monolith keeps its own
        self.blob_dir = blob_dir or os.path.join(state_dir, "blobs")
        os.makedirs(self.blob_dir, exist_ok=True)
        data_dir = os.path.dirname(self.blob_dir)
        # mount file contents and volume blocks by sha256 (MountPutFile,
        # VolumeBlockPut), in the JAX plane's block dir beside the blobs
        self.block_dir = os.path.join(data_dir, "volume_blocks")
        os.makedirs(self.block_dir, exist_ok=True)
        # the fleet compile cache beside the blob store (server/compile_cache.py)
        self.compile_cache = CompileCacheStore(os.path.join(data_dir, "compile_cache"))

        self.apps: dict[str, AppState] = {}
        self.deployed_apps: dict[tuple[str, str], str] = {}  # (env, name) -> app_id
        self.functions: dict[str, FunctionState] = {}
        self.deployed_functions: dict[tuple[str, str, str], str] = {}  # (env, app_name, tag) -> fn_id
        self.inputs: dict[str, InputState] = {}
        self.function_calls: dict[str, FunctionCallState] = {}
        self.tasks: dict[str, TaskState_] = {}
        self.clusters: dict[str, ClusterState] = {}
        self.workers: dict[str, WorkerState] = {}
        self.volumes: dict[str, VolumeState] = {}
        self.deployed_volumes: dict[tuple[str, str], str] = {}  # (env, name) -> volume_id
        self.secrets: dict[str, SecretState] = {}
        self.deployed_secrets: dict[tuple[str, str], str] = {}  # (env, name) -> secret_id
        self.dicts: dict[str, DictState] = {}
        self.deployed_dicts: dict[tuple[str, str], str] = {}  # (env, name) -> dict_id
        self.queues: dict[str, QueueState] = {}
        self.deployed_queues: dict[tuple[str, str], str] = {}  # (env, name) -> queue_id
        self.proxies: dict[str, ProxyState] = {}
        self.deployed_proxies: dict[tuple[str, str], str] = {}  # (env, name) -> proxy_id
        self.images: dict[str, ImageState] = {}
        self.images_by_hash: dict[str, str] = {}  # definition hash -> image_id
        self.environments: dict[str, str] = {"main": ""}  # name -> web suffix
        self.tokens: dict[str, str] = {}  # token_id -> token_secret
        # token_id -> grant time: the local workspace's members are its
        # issued tokens, the oldest its owner (WorkspaceMemberList)
        self.token_granted_at: dict[str, float] = {}
        # workspace-wide settings, validated in WorkspaceSettingsSet
        self.workspace_settings: dict[str, str] = {}
        # flow_id -> {token_id, token_secret, code, approved: asyncio.Event,
        # localhost_port}: browser-completed token issuance (TokenFlowCreate
        # and the blob server's /auth/token-flow page)
        self.pending_token_flows: dict[str, dict] = {}
        self.sandboxes: dict[str, SandboxState_] = {}
        self.sandbox_snapshots: dict[str, SandboxSnapshotState] = {}
        # (task_id, port) -> (asyncio server, port) of a TunnelStart, or a
        # Future while its start is in flight
        self.tunnels: dict[tuple[str, int], object] = {}
        self.blob_url_base: str = ""  # set by the blob server once it is up
        # the active profiling command ("start:<hz>" | "stop" | ""), repeated
        # on every container heartbeat while set (ProfileControl,
        # observability/profiler.py); "stop" expires after
        # services.PROFILE_STOP_TTL_S so it never reaches a later container
        self.profile_command: str = ""
        self.profile_command_set_at: float = 0.0
        # the input plane (server/input_plane.py): its URL, advertised at
        # ClientHello; the HS256 secret of its JWTs (AuthTokenGet mints,
        # the input plane verifies); attempt token -> (function_call_id,
        # input_id, minted at)
        self.input_plane_url: str = ""
        self.auth_secret: bytes = os.urandom(32)
        self.attempts: dict[str, tuple[str, str, float]] = {}
        # local fast-path coordinates advertised at ClientHello (set when
        # the supervisor binds): the plane's Unix socket, the input plane's,
        # and the blob store directory co-located clients read and write in
        # place
        self.uds_path: str = ""
        self.input_plane_uds: str = ""
        self.blob_local_dir: str = ""

        # scheduling wakeup
        self.schedule_event = asyncio.Event()

        # the durable control plane's hooks, read by proto/rpc.py's
        # _maybe_dedupe and _maybe_quorum: the journal and its idempotency
        # cache (server/journal.py, attached by the supervisor; None with
        # MODAL_TPU_JOURNAL=0), and the quorum replicator
        # (server/replication.py), None on a standalone plane and with
        # MODAL_TPU_JOURNAL_REPLICAS=0
        self.journal = None
        self.idempotency = None
        self.replicator = None

        # the metrics plane: the time-series store and the SLO evaluator
        # (set by the supervisor's sampler; None on a bare state and with
        # MODAL_TPU_TS_INTERVAL=0), and `alerts`, the journaled projection of
        # SLO alert state (rule name -> last transition), rebuilt by replay
        self.timeseries = None
        self.slo = None
        self.alerts: dict[str, dict] = {}

    def make_id(self, prefix: str) -> str:
        """An id in this shard's home partition: a migrated partition keeps
        routing to its journaled home while new objects land on this shard."""
        return make_id(prefix, self.shard_index)

    def blob_path(self, blob_id: str) -> str:
        return os.path.join(self.blob_dir, blob_id)

    def block_path(self, sha256_hex: str) -> str:
        return os.path.join(self.block_dir, sha256_hex)

    def put_block(self, sha256_hex: str, data: bytes) -> None:
        path = self.block_path(sha256_hex)
        if not os.path.exists(path):
            tmp = path + ".tmp"
            with open(tmp, "wb") as f:
                f.write(data)
            os.replace(tmp, path)

    def has_block(self, sha256_hex: str) -> bool:
        return os.path.exists(self.block_path(sha256_hex))

    def get_block(self, sha256_hex: str, offset: int = 0, length: int = 0) -> bytes:
        with open(self.block_path(sha256_hex), "rb") as f:
            f.seek(offset)
            return f.read(length) if length else f.read()

    async def notify_logs(self, app_id: str) -> None:
        app = self.apps.get(app_id)
        if app is not None:
            async with app.log_condition:
                app.log_condition.notify_all()
