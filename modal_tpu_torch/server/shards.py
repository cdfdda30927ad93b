"""The horizontally sharded control plane: N supervisor shards behind a thin
placement director (port of modal_tpu/server/shards.py).

Topology
--------
``ShardedSupervisor`` runs N ``LocalSupervisor`` shards, each with its own
state dir, journal, scheduler and workers, and one ``PlacementDirector`` on
the client-facing port. State is partitioned by app: every id a shard mints
embeds its partition (``state.make_id``), so an RPC that carries an id
routes with no lookup table, and an RPC that carries only a name (an app's
creation, a deployment's lookup) routes by a stable hash of the name.
``num_shards == 1`` is the monolith: ``serve_forever`` never builds this.

Partition ``p`` starts on shard ``p``; a takeover moves it, and
``assignments[p]`` is its live owner. The director's shard map
(``{"epoch": E, "urls": [owner url per partition]}``) rides on
ClientHelloResponse, so a client that knows it dials the owning shard; any
other client talks to the director, which forwards.

Failover
--------
The director probes every owning shard. ``death_threshold`` failed probes
in a row trigger a takeover: fence the presumed-dead shard (a false death
must stop serving before its partition lives elsewhere), seal the
survivors' replica streams of its journal at the next epoch and adopt the
partition from the best of them on a survivor (server/replication.py; the
dead shard's own journal directory only when no replica exists), rewrite
the partition map at the bumped epoch, and re-home the dead shard's
in-process worker agents to the successor, so in-flight maps finish exactly
once (the journal-fed idempotency cache travels with the replay).

Chaos
-----
``shard_kill``, ``shard_partition`` and ``director_blackhole`` belong to
this layer's event loop (the shards get event-less clones of the policy,
so no shard fires them twice); the shared output clock is the sum of every
shard's ``outputs_seen``.

The director also runs the fleet's federation (observability/federation.py):
``MetricsHistory`` answers from every live shard's merged series, and the
fleet's SLO rules run over them.
"""

from __future__ import annotations

import asyncio
import json
import os
import signal
import subprocess
import sys
import time
from typing import Any, Optional

import grpc

from .._utils import local_transport
from .._utils.grpc_utils import create_channel, find_free_port
from .._utils.shard_routing import partition_for_request
from ..chaos import ChaosPolicy
from ..config import config, logger
from ..observability import tracing
from ..observability.catalog import (
    CONTROL_SHARDS_ACTIVE,
    DIRECTOR_REROUTES,
    SHARD_PLACEMENT_LATENCY,
)
from ..observability.metrics import REGISTRY
from ..proto import api_pb2
from ..proto.rpc import RPCS, Arity, ModalTPUStub, build_generic_handler
from .supervisor import LocalSupervisor


def shard_dir(root: str, index: int) -> str:
    return os.path.join(root, f"shard-{index}")


class PlacementDirector:
    """The thin routing tier: answers ClientHello with the shard map and
    forwards every app-scoped RPC to the partition owner.  Implemented as a
    servicer whose ``__getattr__`` synthesizes one forwarder per registered
    RPC — ``build_generic_handler`` / ``build_local_handlers`` getattr each
    name at build time, so the director serves the full surface without
    hand-writing 60 pass-throughs.  Forwarding goes through the shard's OWN
    wrapped handler table (in-process) or a real stub (subprocess shards), so
    shard-side idempotency dedupe, instrumentation, and chaos all still
    apply."""

    # real attributes only — everything else is synthesized by __getattr__
    def __init__(self, parent: "ShardedSupervisor"):
        self.__dict__["parent"] = parent

    # -- explicit handlers ----------------------------------------------------

    async def ClientHello(self, request, context):
        parent = self.parent
        await self._check_blackhole(context)
        resp = await self._forward_unary(
            "ClientHello", request, context, parent.assignments[0]
        )
        # sharded-mode degradations: the input plane
        # and the control UDS are per-shard surfaces that would pin every call
        # to one shard, defeating routing — clients fall back to the
        # control-plane map path (routed per-app) and TCP/in-proc transport.
        resp.input_plane_url = ""
        resp.uds_path = ""
        resp.input_plane_uds_path = ""
        resp.shard_map_json = json.dumps(parent.shard_map())
        resp.shard_epoch = parent.epoch
        return resp

    async def ShardControl(self, request, context):
        parent = self.parent
        if request.action != "status":
            await context.abort(
                grpc.StatusCode.INVALID_ARGUMENT,
                f"director ShardControl supports action='status', got {request.action!r}",
            )
        return api_pb2.ShardControlResponse(payload_json=json.dumps(parent.topology()))

    async def MetricsHistory(self, request, context):
        """Fleet-merged history: when federation is on, the
        director answers the same query contract as a shard's handler but
        over every live shard's merged series; otherwise it forwards to the
        routed shard like any other RPC (one slice, as before)."""
        parent = self.parent
        await self._check_blackhole(context)
        if parent.federation is not None:
            payload = await parent.federation.payload(
                request.query,
                family=request.family,
                window_s=request.window_s,
                q=request.q,
            )
            return api_pb2.MetricsHistoryResponse(payload_json=json.dumps(payload))
        home, owner = self._route(request)
        return await self._forward_unary("MetricsHistory", request, context, owner)

    # -- synthesized forwarders ----------------------------------------------

    def __getattr__(self, name: str):
        method = RPCS.get(name)
        if method is None:
            raise AttributeError(name)
        if method.arity == Arity.UNARY_UNARY:

            async def forward(request, context, _name=name):
                t0 = time.perf_counter()
                await self._check_blackhole(context)
                home, owner = self._route(request)
                # trace stitching: for traced callers, open the
                # director.route span BEFORE forwarding and re-parent the
                # forwarded leg under it, so the shard's rpc.server span
                # hangs off the route hop — one waterfall, not two siblings.
                span = None
                if tracing.current_context() is not None:
                    span = tracing.open_span(
                        "director.route",
                        attrs={"rpc": _name, "partition": home, "shard": owner},
                    )
                try:
                    resp = await self._forward_unary(
                        _name,
                        request,
                        context,
                        owner,
                        trace_ctx=span.context if span is not None else None,
                    )
                except BaseException:
                    if span is not None:
                        tracing.close_span(span, status="error")
                    raise
                if span is not None:
                    tracing.close_span(span)
                SHARD_PLACEMENT_LATENCY.observe(time.perf_counter() - t0)
                if owner != home:
                    DIRECTOR_REROUTES.inc(reason="takeover")
                return resp

        elif method.arity == Arity.UNARY_STREAM:

            async def forward(request, context, _name=name):
                await self._check_blackhole(context)
                home, owner = self._route(request)
                if owner != home:
                    DIRECTOR_REROUTES.inc(reason="takeover")
                async for item in self._forward_stream(_name, request, context, owner):
                    yield item

        else:  # stream-request arities aren't part of the control surface
            raise AttributeError(name)

        forward.__name__ = name
        # cache: handler tables are rebuilt on director restart; same closure
        self.__dict__[name] = forward
        return forward

    # -- routing --------------------------------------------------------------

    async def _check_blackhole(self, context) -> None:
        if self.parent.blackhole_until > time.monotonic():
            # chaos director_blackhole: clients see UNAVAILABLE and retry
            await context.abort(grpc.StatusCode.UNAVAILABLE, "chaos: director blackhole")

    def _route(self, request) -> tuple[int, int]:
        """(home partition, owning shard index) for this request."""
        parent = self.parent
        part = partition_for_request(request, parent.num_partitions)
        home = 0 if part is None else part
        return home, parent.assignments[home]

    async def _forward_unary(self, name: str, request, context, shard: int, trace_ctx=None):
        parent = self.parent
        url = parent.shard_urls[shard]
        metadata = list(context.invocation_metadata() or ())
        if trace_ctx is not None:
            # re-parent the forwarded leg under the director.route span
            # (strip the caller's span id first — duplicate keys would race)
            metadata = [
                (k, v)
                for (k, v) in metadata
                if k not in (tracing.TRACE_ID_METADATA_KEY, tracing.SPAN_ID_METADATA_KEY)
            ] + tracing.context_metadata(trace_ctx)
        server = local_transport.resolve_local_server(url)
        if server is not None:
            entry = server.handlers.get(name)
            if entry is not None:
                _method, impl = entry
                # proto copy: handler mutations must not alias the director's
                # request object (mirrors the wire's serialize/deserialize)
                req = type(request).FromString(request.SerializeToString())
                try:
                    return await impl(req, local_transport._LocalContext(metadata))
                except local_transport._AbortError as exc:
                    await context.abort(exc.code, exc.details)
        stub = parent.shard_stub(shard)
        if stub is None:
            await context.abort(
                grpc.StatusCode.UNAVAILABLE, f"shard {shard} unavailable (takeover pending)"
            )
        try:
            return await getattr(stub, name)(request, metadata=metadata, timeout=60.0)
        except grpc.aio.AioRpcError as exc:
            await context.abort(exc.code(), exc.details() or f"shard {shard} forward failed")

    async def _forward_stream(self, name: str, request, context, shard: int):
        parent = self.parent
        url = parent.shard_urls[shard]
        metadata = list(context.invocation_metadata() or ())
        server = local_transport.resolve_local_server(url)
        if server is not None:
            entry = server.handlers.get(name)
            if entry is not None:
                _method, impl = entry
                req = type(request).FromString(request.SerializeToString())
                gen = impl(req, local_transport._LocalContext(metadata))
                try:
                    while True:
                        nxt = asyncio.ensure_future(gen.__anext__())
                        # a killed or fenced shard's stream would drain its
                        # abandoned state forever: once the shard's
                        # registration is gone, sever the stream
                        # (UNAVAILABLE), and the client's retry lands on the
                        # successor (ROADMAP Queue C 45)
                        while not nxt.done():
                            await asyncio.wait({nxt}, timeout=1.0)
                            if not nxt.done() and local_transport.resolve_local_server(url) is not server:
                                nxt.cancel()
                                await asyncio.gather(nxt, return_exceptions=True)
                                await context.abort(
                                    grpc.StatusCode.UNAVAILABLE, f"shard {shard} gone (stream severed)"
                                )
                        try:
                            item = nxt.result()
                        except StopAsyncIteration:
                            return
                        yield item
                except local_transport._AbortError as exc:
                    await context.abort(exc.code, exc.details)
                finally:
                    await gen.aclose()
        stub = parent.shard_stub(shard)
        if stub is None:
            await context.abort(
                grpc.StatusCode.UNAVAILABLE, f"shard {shard} unavailable (takeover pending)"
            )
        try:
            async for item in getattr(stub, name)(request, metadata=metadata):
                yield item
        except grpc.aio.AioRpcError as exc:
            await context.abort(exc.code(), exc.details() or f"shard {shard} forward failed")


class FederationServer:
    """The director's HTTP observability surface: ``GET /metrics/history``
    answered by FederatedHistory and ``GET /metrics`` rendering the
    director-process registry. Owns the fleet-root ``metrics_url``
    breadcrumb (shards keep theirs under ``observability/shards/``)."""

    def __init__(
        self,
        federation: Any,
        state_dir: str,
        host: str = "127.0.0.1",
        port: int = 0,
    ):
        self.federation = federation
        self.state_dir = state_dir
        self.host = host
        self.port = port
        self.url: Optional[str] = None
        self._runner: Optional[Any] = None

    async def start(self) -> str:
        from aiohttp import web

        app = web.Application()
        app.router.add_get("/metrics", self._metrics)
        app.router.add_get("/metrics/history", self._history)
        self._runner = web.AppRunner(app, access_log=None)
        await self._runner.setup()
        site = web.TCPSite(self._runner, self.host, self.port)
        await site.start()
        self.port = site._server.sockets[0].getsockname()[1]
        self.url = f"http://{self.host}:{self.port}"
        try:
            obs_dir = os.path.join(self.state_dir, "observability")
            os.makedirs(obs_dir, exist_ok=True)
            with open(os.path.join(obs_dir, "metrics_url"), "w") as f:  # lint: disable=blocking-in-async
                f.write(f"{self.url}/metrics\n")
        except OSError:
            pass
        return self.url

    async def stop(self) -> None:
        if self._runner is not None:
            await self._runner.cleanup()
            self._runner = None
        crumb = os.path.join(self.state_dir, "observability", "metrics_url")
        try:
            with open(crumb) as f:  # lint: disable=blocking-in-async
                current = f.read().strip()
            if self.url and current == f"{self.url}/metrics":
                os.remove(crumb)
        except OSError:
            pass

    async def _metrics(self, request: Any):
        from aiohttp import web

        accept = request.headers.get("Accept", "")
        if "application/openmetrics-text" in accept:
            return web.Response(
                text=REGISTRY.render_openmetrics(),
                content_type="application/openmetrics-text",
            )
        return web.Response(text=REGISTRY.render_prometheus(), content_type="text/plain")

    async def _history(self, request: Any):
        from aiohttp import web

        try:
            window_s = float(request.query.get("window_s", "0") or 0.0)
        except ValueError:
            window_s = 0.0
        try:
            q = float(request.query.get("q", "0") or 0.0)
        except ValueError:
            q = 0.0
        payload = await self.federation.payload(
            request.query.get("query", ""),
            family=request.query.get("family", ""),
            window_s=window_s,
            q=q,
        )
        return web.json_response(payload)


class ShardedSupervisor:
    """N supervisor shards + placement director, one object with the
    LocalSupervisor surface the client/boot/test plumbing expects
    (``start``/``stop``/``server_url``/``port``/``state_dir``)."""

    def __init__(
        self,
        num_shards: int = 2,
        num_workers: int = 1,
        port: int = 0,
        state_dir: Optional[str] = None,
        worker_gpus: Optional[int] = None,
        worker_gpu_type: Optional[str] = None,
        chaos: Optional[ChaosPolicy] = None,
        subprocess_shards: bool = False,
        health_interval_s: float = 0.25,
        death_threshold: int = 2,
    ):
        if num_shards < 2:
            raise ValueError("ShardedSupervisor needs >= 2 shards; use LocalSupervisor")
        self.num_shards = num_shards
        self.num_partitions = num_shards
        self.num_workers = num_workers
        self.port = port
        self.state_dir = state_dir or config["state_dir"]
        self.blob_dir = os.path.join(self.state_dir, "blobs")
        self.worker_gpus = worker_gpus
        self.worker_gpu_type = worker_gpu_type
        self.chaos = chaos if chaos is not None else ChaosPolicy.from_env()
        self.subprocess_shards = subprocess_shards
        self.health_interval_s = health_interval_s
        self.death_threshold = death_threshold

        self.shards: list[Optional[LocalSupervisor]] = [None] * num_shards
        self.procs: list[Optional[subprocess.Popen]] = [None] * num_shards
        self.shard_urls: list[str] = [""] * num_shards
        self.assignments: list[int] = list(range(num_shards))  # partition -> shard
        self.epoch = 1
        self.dead: list[bool] = [False] * num_shards
        self.partitioned_until: list[float] = [0.0] * num_shards  # chaos probe blackhole
        self.blackhole_until = 0.0  # chaos director blackhole
        self.takeover_log: list[dict] = []

        self.director = PlacementDirector(self)
        self._grpc_server: Optional[grpc.aio.Server] = None
        self._stubs: dict[str, ModalTPUStub] = {}
        self._channels: dict[str, grpc.aio.Channel] = {}
        self._probe_failures: list[int] = [0] * num_shards
        self._probe_outputs: list[int] = [0] * num_shards  # subprocess chaos clock
        self._health_task: Optional[asyncio.Task] = None
        self._chaos_task: Optional[asyncio.Task] = None
        self._takeover_lock = asyncio.Lock()

        # fleet observability: director-resident federation +
        # fleet-scope SLO loop + crash-forensics flight recorder
        self.federation = None
        self.federation_server = None
        self.flight_recorder = None
        self._federation_task: Optional[asyncio.Task] = None

    # -- identity -------------------------------------------------------------

    @property
    def server_url(self) -> str:
        return f"grpc://127.0.0.1:{self.port}"

    def shard_map(self) -> dict:
        return {
            "epoch": self.epoch,
            "urls": [self.shard_urls[self.assignments[p]] for p in range(self.num_partitions)],
            "director": self.server_url,
        }

    def topology(self) -> dict:
        return {
            "epoch": self.epoch,
            "num_shards": self.num_shards,
            "assignments": list(self.assignments),
            "urls": list(self.shard_urls),
            "dead": list(self.dead),
            "director": self.server_url,
            "subprocess": self.subprocess_shards,
            "takeovers": list(self.takeover_log),
        }

    def shard_stub(self, index: int) -> Optional[ModalTPUStub]:
        url = self.shard_urls[index]
        if not url:
            return None
        stub = self._stubs.get(url)
        if stub is None:
            channel = create_channel(url)
            self._channels[url] = channel
            stub = self._stubs[url] = ModalTPUStub(channel)
        return stub

    def _shard_policy(self) -> Optional[ChaosPolicy]:
        """Event-less clone for one shard: same seeded fault streams, but the
        shard/director events stay HERE — two event loops popping one shared
        list would race, and a shard cannot kill itself cleanly anyway."""
        if self.chaos is None:
            return None
        clone = ChaosPolicy(
            seed=self.chaos.seed,
            error_rates=self.chaos.error_rates,
            default_error_rate=self.chaos.default_error_rate,
            latency_ms=self.chaos.latency_ms,
            latency_jitter_ms=self.chaos.latency_jitter_ms,
            latency_rate=self.chaos.latency_rate,
            events=None,
            max_faults=self.chaos.max_faults,
        )
        clone.fail_counts = dict(self.chaos.fail_counts)
        clone.repl_lag_ms = self.chaos.repl_lag_ms
        return clone

    def _workers_for_shard(self, index: int) -> int:
        base, extra = divmod(self.num_workers, self.num_shards)
        return max(1, base + (1 if index < extra else 0))

    # -- lifecycle ------------------------------------------------------------

    async def start(self) -> None:
        os.makedirs(self.state_dir, exist_ok=True)
        os.makedirs(self.blob_dir, exist_ok=True)
        for i in range(self.num_shards):
            await self._start_shard(i)
        await self._start_director()
        self._persist_topology()
        CONTROL_SHARDS_ACTIVE.set(float(self.num_shards))
        # the director's span sink is at the fleet root: in-process shards
        # pointed the process's sink at their own dirs while they booted, so
        # point it here, and director.route and all after it lands under
        # <root>/traces (subprocess shards keep <root>/shard-<i>/traces;
        # readers merge them with tracing.span_dirs)
        trace_root = os.path.join(self.state_dir, "traces")
        tracing.gc_trace_dir(trace_root)
        tracing.configure(trace_root)
        from ..observability import federation as obs_federation
        from ..observability import flight_recorder as obs_flight_recorder

        if obs_flight_recorder.enabled():
            self.flight_recorder = obs_flight_recorder.FlightRecorder(
                self.state_dir, chaos=self.chaos, scope="director"
            )
            self.flight_recorder.start()
        if obs_federation.enabled():
            self.federation = obs_federation.FederatedHistory(
                self.state_dir,
                # in-process shards share one process-wide registry: every
                # shard's store holds the same series, so fan-out would
                # N-count — merge SERIES from one live shard, the rest of
                # the payload (replicas, alerts) from all
                shared_registry=not self.subprocess_shards,
            )
            self.federation_server = FederationServer(
                self.federation, self.state_dir
            )
            await self.federation_server.start()
            self._federation_task = asyncio.create_task(
                self._federation_loop(), name="fleet-slo"
            )
        self._health_task = asyncio.create_task(self._health_loop(), name="shard-health")
        if self.chaos is not None and self.chaos.events:
            self._chaos_task = asyncio.create_task(
                self._chaos_event_loop(), name="shard-chaos-events"
            )
        logger.debug(
            f"sharded control plane up at {self.server_url} "
            f"({self.num_shards} shards, subprocess={self.subprocess_shards})"
        )

    async def _start_shard(self, index: int) -> None:
        sdir = shard_dir(self.state_dir, index)
        if self.subprocess_shards:
            port = find_free_port()
            env = dict(os.environ)
            # shard events are owned by the DIRECTOR's loop; a shard process
            # re-parsing these knobs would fire them a second time
            for knob in ("MODAL_TPU_CHAOS_SHARD_KILL_AFTER", "MODAL_TPU_CHAOS_SHARD_PARTITION"):
                env.pop(knob, None)
            env["MODAL_TPU_SHARDS"] = "1"  # a shard is a monolith internally
            proc = subprocess.Popen(
                [
                    sys.executable,
                    "-m",
                    "modal_tpu_torch.server",
                    "--port",
                    str(port),
                    "--workers",
                    str(self._workers_for_shard(index)),
                    "--state-dir",
                    sdir,
                    "--shard-index",
                    str(index),
                    "--blob-dir",
                    self.blob_dir,
                    # journal-replication peer discovery: the
                    # shard reads <fleet_root>/shards.json for live siblings
                    "--fleet-root",
                    self.state_dir,
                ],
                env=env,
                start_new_session=True,  # a shard's SIGKILL must not orphan-kill us
            )
            self.procs[index] = proc
            self.shard_urls[index] = f"grpc://127.0.0.1:{port}"
            await self._await_shard_ready(index)
        else:
            sup = LocalSupervisor(
                num_workers=self._workers_for_shard(index),
                port=0,
                state_dir=sdir,
                worker_gpus=self.worker_gpus,
                worker_gpu_type=self.worker_gpu_type,
                chaos=self._shard_policy(),
                shard_index=index,
                blob_dir=self.blob_dir,
                # journal-replication peers: live siblings by
                # CURRENT topology — dead shards drop out so the writer's
                # follower set heals itself after a takeover
                replication_peers=lambda _i=index: [
                    (j, self.shard_urls[j])
                    for j in range(self.num_shards)
                    if j != _i and not self.dead[j] and self.shard_urls[j]
                ],
                fleet_root=self.state_dir,
            )
            await sup.start()
            self.shards[index] = sup
            self.shard_urls[index] = sup.server_url

    async def _await_shard_ready(self, index: int, timeout_s: float = 30.0) -> None:
        deadline = time.monotonic() + timeout_s
        request = api_pb2.ShardControlRequest(action="status")
        while time.monotonic() < deadline:
            proc = self.procs[index]
            if proc is not None and proc.poll() is not None:
                raise RuntimeError(
                    f"shard {index} subprocess exited rc={proc.returncode} before ready"
                )
            try:
                await self.shard_stub(index).ShardControl(request, timeout=1.0)
                return
            except grpc.aio.AioRpcError:
                await asyncio.sleep(0.1)
        raise RuntimeError(f"shard {index} not ready after {timeout_s}s")

    async def _start_director(self) -> None:
        self._grpc_server = grpc.aio.server(
            options=[
                ("grpc.max_receive_message_length", 128 * 1024 * 1024),
                ("grpc.max_send_message_length", 128 * 1024 * 1024),
            ]
        )
        self._grpc_server.add_generic_rpc_handlers((build_generic_handler(self.director),))
        self.port = self._grpc_server.add_insecure_port(f"127.0.0.1:{self.port}")
        await self._grpc_server.start()
        # in-process rung: same-process clients route through the director
        # exactly like remote ones — one routing brain, two transports
        local_transport.register_local_server(self.server_url, self.director)

    async def _federation_loop(self) -> None:
        """Fleet-scope SLO evaluation: run the burn-rate rules at
        the director over the MERGED series on the store's cadence, so a
        fleet-wide violation fires even when no single shard crosses its own
        threshold. Firing transitions freeze + dump the director's flight
        recorder."""
        from ..observability import timeseries as obs_timeseries

        interval = max(2.0, obs_timeseries.base_interval_s())
        while True:
            await asyncio.sleep(interval)
            try:
                transitions = await self.federation.evaluate_fleet()
            except asyncio.CancelledError:
                raise
            except Exception:
                logger.exception("fleet SLO evaluation failed")
                continue
            for tr in transitions:
                if tr.get("state") == "firing" and self.flight_recorder is not None:
                    self.flight_recorder.dump("alert", extra={"alert": tr, "fleet": True})

    async def restart_director(self) -> None:
        """Kill + rebind the routing tier on the same port (chaos / tests):
        clients mid-map see UNAVAILABLE, retry, and land on the rebuilt
        director with the topology intact — shards never notice."""
        local_transport.unregister_local_server(self.server_url)
        if self._grpc_server is not None:
            await self._grpc_server.stop(grace=None)
            self._grpc_server = None
        await self._start_director()
        logger.warning(f"placement director restarted at {self.server_url}")

    async def stop(self) -> None:
        for task in (self._health_task, self._chaos_task, self._federation_task):
            if task is not None:
                task.cancel()
                try:
                    await task
                except asyncio.CancelledError:
                    pass
        self._health_task = self._chaos_task = self._federation_task = None
        if self.federation_server is not None:
            await self.federation_server.stop()
            self.federation_server = None
        self.federation = None
        if self.flight_recorder is not None:
            self.flight_recorder.stop()
            self.flight_recorder = None
        local_transport.unregister_local_server(self.server_url)
        if self._grpc_server is not None:
            await self._grpc_server.stop(grace=0.5)
            self._grpc_server = None
        for sup in self.shards:
            if sup is not None:
                await sup.stop()
        for proc in self.procs:
            if proc is None or proc.poll() is not None:
                continue
            try:
                os.killpg(proc.pid, signal.SIGTERM)
            except (ProcessLookupError, PermissionError):
                proc.terminate()
            try:
                await asyncio.to_thread(proc.wait, 10)
            except subprocess.TimeoutExpired:
                try:
                    os.killpg(proc.pid, signal.SIGKILL)
                except (ProcessLookupError, PermissionError):
                    proc.kill()
                await asyncio.to_thread(proc.wait, 5)
        for channel in self._channels.values():
            await channel.close()
        self._channels.clear()
        self._stubs.clear()

    def _persist_topology(self) -> None:
        """director.json (epoch + partition map) and shards.json (pids/ports
        — the chaos soak reads these to aim its kill -9)."""
        try:
            with open(os.path.join(self.state_dir, "director.json"), "w") as f:
                json.dump(self.topology(), f, indent=2)
            with open(os.path.join(self.state_dir, "shards.json"), "w") as f:
                json.dump(
                    {
                        "shards": [
                            {
                                "index": i,
                                "url": self.shard_urls[i],
                                "state_dir": shard_dir(self.state_dir, i),
                                "pid": self.procs[i].pid if self.procs[i] is not None else 0,
                                "dead": self.dead[i],
                            }
                            for i in range(self.num_shards)
                        ]
                    },
                    f,
                    indent=2,
                )
        except OSError as exc:
            logger.warning(f"topology persistence failed: {exc}")

    # -- health + failover ----------------------------------------------------

    def _owning_shards(self) -> set[int]:
        return set(self.assignments)

    async def _probe(self, index: int) -> bool:
        if time.monotonic() < self.partitioned_until[index]:
            return False  # chaos shard_partition: alive but unreachable
        if self.subprocess_shards:
            proc = self.procs[index]
            if proc is None or proc.poll() is not None:
                return False
            try:
                # the probe carries the fleet epoch: shards stamp
                # their replicated journal appends with it, so followers can
                # fence a writer that missed a takeover
                resp = await self.shard_stub(index).ShardControl(
                    api_pb2.ShardControlRequest(action="status", epoch=self.epoch), timeout=1.0
                )
                status = json.loads(resp.payload_json)
                self._probe_outputs[index] = int(status.get("chaos_outputs_seen", 0))
                return not status.get("fenced", False)
            except (grpc.aio.AioRpcError, ValueError, asyncio.TimeoutError):
                return False
        sup = self.shards[index]
        if sup is None or sup._grpc_server is None or sup.fenced:
            return False
        sup.note_fleet_epoch(self.epoch)
        return True

    async def _health_loop(self) -> None:
        while True:
            try:
                for i in sorted(self._owning_shards()):
                    if self.dead[i]:
                        # death already known (chaos kill_shard) — don't wait
                        # out the probe threshold
                        await self._takeover(i)
                        continue
                    if await self._probe(i):
                        self._probe_failures[i] = 0
                        continue
                    self._probe_failures[i] += 1
                    if self._probe_failures[i] >= self.death_threshold:
                        self.dead[i] = True
                        await self._takeover(i)
                CONTROL_SHARDS_ACTIVE.set(float(len(self._owning_shards())))
            except asyncio.CancelledError:
                raise
            except Exception:
                logger.exception("shard health loop iteration failed")
            await asyncio.sleep(self.health_interval_s)

    def _pick_successor(self, dead_index: int) -> Optional[int]:
        for off in range(1, self.num_shards):
            cand = (dead_index + off) % self.num_shards
            if not self.dead[cand] and self.shard_urls[cand]:
                return cand
        return None

    async def _takeover(self, dead_index: int) -> None:
        async with self._takeover_lock:  # lint: disable=lock-across-await
            if dead_index not in self._owning_shards():
                return  # raced: another pass already moved its partitions
            successor = self._pick_successor(dead_index)
            if successor is None:
                logger.error(f"shard {dead_index} dead and no live successor — cannot fail over")
                return
            t0 = time.time()
            # per-phase wall timestamps: the debug-bundle timeline annotates
            # fence → seal → adopt → remap → rehome against the metrics window
            phases = {"start": round(t0, 3)}
            epoch = self.epoch + 1
            # fence FIRST: a false death (live shard behind a partition) must
            # stop serving before its journal is replayed elsewhere, or two
            # shards own one partition (split-brain)
            await self._fence_shard(dead_index, epoch)
            phases["fence"] = round(time.time(), 3)
            dead_dir = shard_dir(self.state_dir, dead_index)
            # quorum takeover: prefer the survivors' replica
            # streams over the corpse's own journal directory — the replica
            # path survives a lost DISK, and sealing every surviving copy at
            # the bumped epoch structurally kills the old writer's quorum.
            # No replicated copy (replication off / nothing ever appended)
            # falls back to replaying the dead shard's own journal directory.
            mode = "journal"
            try:
                replica_successor = await self._pick_replica_successor(dead_index)
                if replica_successor is not None:
                    successor = replica_successor
                    # seal the dead writer's stream on EVERY live shard, not
                    # just the holders found above: a survivor with no stream
                    # yet (unreachable during discovery, or a fresh peer the
                    # undead writer would later adopt via install_snapshot at
                    # its old epoch) must also refuse post-seal appends —
                    # seal() mints an empty sealed stream where none exists,
                    # so the partitioned old writer can't rebuild a quorum
                    # from non-holders.
                    for peer in range(self.num_shards):
                        if peer == dead_index or self.dead[peer] or not self.shard_urls[peer]:
                            continue
                        await self._replica_call(peer, "seal", dead_index, epoch)
                    phases["seal"] = round(time.time(), 3)
                    report = await self._adopt_replica(successor, dead_index, epoch)
                    mode = "replica"
                    # the corpse's journal (when its disk survived) must not
                    # be replayable by a stale respawn: archive best-effort
                    try:
                        from .journal import archive_existing

                        archive_existing(dead_dir)
                    except OSError:
                        pass
                else:
                    report = await self._adopt(successor, dead_dir, dead_index)
            except Exception:
                logger.exception(
                    f"takeover of shard {dead_index} by {successor} failed; will retry"
                )
                return
            phases["adopt"] = round(time.time(), 3)
            moved = [p for p in range(self.num_partitions) if self.assignments[p] == dead_index]
            for p in moved:
                self.assignments[p] = successor
            self.epoch = epoch
            self._persist_topology()
            phases["remap"] = round(time.time(), 3)
            await self._rehome_workers(dead_index, successor)
            phases["rehome"] = round(time.time(), 3)
            took = time.time() - t0
            entry = {
                "dead_shard": dead_index,
                "successor": successor,
                "partitions": moved,
                "epoch": epoch,
                "mode": mode,
                "seconds": round(took, 4),
                "phases": phases,
                "report": report,
            }
            self.takeover_log.append(entry)
            if self.flight_recorder is not None:
                self.flight_recorder.dump("takeover", extra={"takeover": entry})
            # re-persist: the first write published the new assignments ASAP;
            # this one adds the takeover record external watchers read
            self._persist_topology()
            CONTROL_SHARDS_ACTIVE.set(float(len(self._owning_shards())))
            logger.warning(
                f"shard {dead_index} partitions {moved} taken over by shard {successor} "
                f"at epoch {epoch} in {took:.2f}s"
            )

    async def _fence_shard(self, index: int, epoch: int) -> None:
        if self.subprocess_shards:
            proc = self.procs[index]
            if proc is None or proc.poll() is not None:
                return  # actually dead
            try:
                await self.shard_stub(index).ShardControl(
                    api_pb2.ShardControlRequest(action="fence", epoch=epoch), timeout=2.0
                )
            except grpc.aio.AioRpcError:
                pass  # unreachable — the SIGKILL case
            return
        sup = self.shards[index]
        if sup is not None and not sup.fenced:
            await sup.fence(epoch)

    async def _adopt(self, successor: int, dead_dir: str, partition: int) -> dict:
        if self.subprocess_shards:
            resp = await self.shard_stub(successor).ShardControl(
                api_pb2.ShardControlRequest(
                    action="adopt", journal_dir=dead_dir, partition=partition
                ),
                timeout=120.0,
            )
            return json.loads(resp.payload_json)
        return await self.shards[successor].adopt_partition(dead_dir, partition=partition)

    # -- quorum takeover (server/replication.py) ---------------------

    async def _replica_call(self, shard: int, kind: str, writer: int, epoch: int = 0) -> dict:
        """One JournalReplicate exchange with a surviving shard about its
        replica stream of `writer`: direct store access for in-process
        shards, the RPC for subprocess ones. Unreachable shards report as an
        error dict, never an exception — the takeover must keep moving."""
        if not self.subprocess_shards:
            sup = self.shards[shard]
            store = sup.replica_store if sup is not None else None
            if store is None:
                return {"ok": False, "error": "no_store"}
            if kind == "status":
                return store.status(writer)
            if kind == "seal":
                return store.seal(writer, epoch)
            raise ValueError(f"unknown replica call kind {kind!r}")
        stub = self.shard_stub(shard)
        if stub is None:
            return {"ok": False, "error": "unreachable"}
        try:
            resp = await stub.JournalReplicate(
                api_pb2.JournalReplicateRequest(kind=kind, writer_shard=writer, epoch=epoch),
                timeout=5.0,
            )
            return json.loads(resp.payload_json)
        except (grpc.aio.AioRpcError, ValueError, asyncio.TimeoutError):
            return {"ok": False, "error": "unreachable"}

    async def _pick_replica_successor(self, dead_index: int) -> Optional[int]:
        """The survivor adopting the dead writer's partition in a quorum
        takeover: highest writer INCARNATION first (a follower that heard a
        restarted writer truncated the prior incarnation's phantom tail, so
        its log is strictly newer than a higher-seq phantom on a stale
        follower), then highest replicated seq (everything any quorum ever
        acked), ring order breaking ties so the choice matches
        _pick_successor when replicas are in lockstep. None when no survivor
        holds a stream — the caller falls back to the corpse's own journal
        directory."""
        candidates: list[tuple[int, int, int, int]] = []  # (inc, last_seq, -ring_off, shard)
        for off in range(1, self.num_shards):
            cand = (dead_index + off) % self.num_shards
            if self.dead[cand] or not self.shard_urls[cand]:
                continue
            status = await self._replica_call(cand, "status", dead_index)
            if not status.get("ok"):
                continue
            candidates.append(
                (int(status.get("incarnation", 0)), int(status.get("last_seq", 0)), -off, cand)
            )
        if not candidates:
            return None
        candidates.sort(reverse=True)
        return candidates[0][3]

    async def _adopt_replica(self, successor: int, dead_index: int, epoch: int) -> dict:
        if self.subprocess_shards:
            resp = await self.shard_stub(successor).ShardControl(
                api_pb2.ShardControlRequest(
                    action="adopt_replica",
                    partition=dead_index,
                    shard_index=dead_index,
                    epoch=epoch,
                ),
                timeout=120.0,
            )
            return json.loads(resp.payload_json)
        return await self.shards[successor].adopt_from_replica(
            dead_index, dead_index, epoch
        )

    async def _rehome_workers(self, dead_index: int, successor: int) -> None:
        """In-process mode: the dead shard's worker AGENTS survive the
        simulated crash (only their containers died) — re-point them at the
        successor, whose journal replay just re-created their WorkerStates as
        adoption_pending.  The re-register is the heartbeat-reannounce that
        completes adoption, so the successor inherits capacity, not just
        state.  Subprocess mode has no agents to save: the adopted inputs
        were requeued by replay and the successor's own workers drain them."""
        dead_sup = self.shards[dead_index]
        if dead_sup is None:
            return
        succ = self.shards[successor]
        succ_url = succ.server_url if succ is not None else self.shard_urls[successor]
        succ_uds = succ.uds_path if succ is not None else ""
        for worker in dead_sup.workers:
            try:
                await worker.rehome(succ_url, succ_uds)
            except Exception:
                logger.exception(f"worker rehome to shard {successor} failed")

    # -- chaos ----------------------------------------------------------------

    def _sum_outputs(self) -> int:
        total = 0
        for i in range(self.num_shards):
            if self.subprocess_shards:
                total += self._probe_outputs[i]
            else:
                sup = self.shards[i]
                if sup is not None and sup.chaos is not None:
                    total += sup.chaos.outputs_seen
        return total

    async def kill_shard(self, index: int) -> None:
        """Simulated kill -9 of one shard (chaos shard_kill / tests): abrupt
        teardown, journal segments left on disk for the takeover to replay.
        The health loop notices on its next tick and fails over."""
        if self.subprocess_shards:
            proc = self.procs[index]
            if proc is not None and proc.poll() is None:
                try:
                    os.killpg(proc.pid, signal.SIGKILL)
                except (ProcessLookupError, PermissionError):
                    proc.kill()
        else:
            sup = self.shards[index]
            if sup is not None and not sup.fenced:
                await sup.crash_abandon()
                # crash_abandon tore the serving surfaces down; flag it so
                # sup.stop() doesn't tear down twice (and fence() no-ops)
                sup.fenced = True
        self.dead[index] = True
        logger.warning(f"chaos: killed shard {index}")

    async def _chaos_event_loop(self) -> None:
        while True:
            try:
                self.chaos.outputs_seen = self._sum_outputs()
                for ev in self.chaos.pop_due_events():
                    idx = ev.shard_index % self.num_shards
                    if ev.kind == "shard_kill":
                        await self.kill_shard(idx)
                    elif ev.kind == "shard_partition":
                        self.partitioned_until[idx] = time.monotonic() + ev.duration_s
                        logger.warning(
                            f"chaos: partitioning shard {idx} from health probes "
                            f"for {ev.duration_s}s"
                        )
                    elif ev.kind == "director_blackhole":
                        self.blackhole_until = time.monotonic() + ev.duration_s
                        logger.warning(f"chaos: director blackhole for {ev.duration_s}s")
                    elif ev.kind == "supervisor_crash" and self.shards[idx] is not None:
                        # monolith knob in sharded mode: crash-restart one shard
                        t = asyncio.create_task(self.shards[idx].crash_restart())
                        t.add_done_callback(lambda _t: None)
                    else:
                        logger.warning(
                            f"chaos event {ev.kind!r} is not shard-aware; ignored in "
                            f"sharded mode (set worker-level knobs on a monolith)"
                        )
            except asyncio.CancelledError:
                return
            except Exception:
                logger.exception("shard chaos event loop iteration failed")
            await asyncio.sleep(0.1)
