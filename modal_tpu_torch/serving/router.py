"""Prefix-aware serving-fleet router (port of modal_tpu/serving/router.py).

One replica reuses shared-prefix KV within its engine
(models/paged_kv.PrefixCache); once a second replica exists, blind routing
scatters same-prefix traffic and every replica pays its own cold prefill per
prefix. This director makes routing cache-aware:

- **prefix map**: prompts are hashed as full-page prefix chunks
  (`page_digests`, longest first: the page granularity the engine's
  PrefixCache indexes on). A fleet map digest → replica records who holds
  which prefix, fed two ways: observation (every routed request warms its
  target's entry) and `refresh_from_stats` (replicas expose their cache's
  keys as digests in /v1/stats, so restarts and evictions reconcile).
- **consistent-hash fallback**: a cold prefix ring-hashes on its first
  full-page digest, so same-prefix requests converge on one replica before
  the map learns it.
- **session affinity**: multi-turn sessions pin to their replica. Affinity
  survives replica death by re-pinning: the dead replica's map entries are
  purged, and the request re-routes with the SAME request id (the dead
  replica never answered, so the resend is the request).
- **disaggregation**: with dedicated prefill replicas, the router drives
  the two-leg flow: /v1/prefill on a prefill replica ships KV pages over
  the blob plane, /v1/prefilled lands them on a decode replica. Any failure
  on either leg degrades to a direct /v1/generate (a full local prefill):
  slower, never wrong.

Transport-agnostic: a replica is any callable ``transport(path, body) ->
dict`` that raises ``ConnectionError`` when the replica is unreachable:
tests inject fakes, an HTTP client wraps a replica's web URL.
MODAL_TPU_SERVING_ROUTER=0 collapses the tier to seeded-random choice.
"""

from __future__ import annotations

import bisect
import hashlib
import os
import random
import threading
import time
from collections import OrderedDict
from typing import Any, Callable, Optional

from ..config import logger
from ..observability import tracing
from ..observability.catalog import SERVING_ROUTER_ROUTED

ROUTER_ENV = "MODAL_TPU_SERVING_ROUTER"  # 0 → seeded-random routing

VNODES = 50  # ring points per replica (smooths the cold-prefix split)


def router_enabled() -> bool:
    return os.environ.get(ROUTER_ENV, "1").strip().lower() not in ("0", "false", "no", "off")


def prefix_digest(tokens) -> str:
    """Stable content digest of one token prefix. Token-value-based, so any
    engine and router compute identical digests for identical content: the
    map key IS the prefix."""
    h = hashlib.blake2b(digest_size=8)
    h.update(" ".join(str(int(t)) for t in tokens).encode())
    return h.hexdigest()


def page_digests(tokens, page_size: int) -> list[str]:
    """Digests of every full-page prefix of `tokens`, longest first — the
    probe order mirrors PrefixCache.lookup, so the first map hit is the
    replica holding the LONGEST cached prefix."""
    return [
        prefix_digest(tokens[: j * page_size])
        for j in range(len(tokens) // page_size, 0, -1)
    ]


class NoReplicasError(RuntimeError):
    """Every replica was marked dead (or none were registered)."""


class ServingRouter:
    """Serving-tier director over a fleet of engine replicas.

    `replicas` maps name → transport. `prefill_replicas` names the subset
    running role=prefill (empty: no disaggregation; `route` always takes
    the direct leg). Thread-safe: a client pool may drive it."""

    def __init__(
        self,
        replicas: dict[str, Callable[[str, dict], Any]],
        *,
        page_size: int = 16,
        prefill_replicas: tuple = (),
        seed: int = 0,
        map_capacity: int = 8192,
        affinity_capacity: int = 8192,
    ):
        self.page_size = page_size
        self.replicas = dict(replicas)
        self.prefill_replicas = [n for n in prefill_replicas if n in self.replicas]
        self.enabled = router_enabled()
        self._rng = random.Random(seed)
        self._lock = threading.Lock()
        # digest → replica name, LRU-bounded (move_to_end on touch): the map
        # is advisory, a wrong entry costs one cold prefill, never an error
        self._prefix_map: OrderedDict[str, str] = OrderedDict()
        self._map_capacity = map_capacity
        self._affinity: OrderedDict[str, str] = OrderedDict()  # session → replica
        self._affinity_capacity = affinity_capacity
        self._ring: list[tuple[int, str]] = []
        self._build_ring()
        self.routed = {"prefix": 0, "affinity": 0, "cold": 0, "random": 0}
        self.reroutes = 0
        self.prefill_fallbacks = 0

    # -- membership ---------------------------------------------------------

    def _build_ring(self) -> None:
        ring = []
        for name in self.replicas:
            for v in range(VNODES):
                h = hashlib.blake2b(f"{name}:{v}".encode(), digest_size=8).digest()
                ring.append((int.from_bytes(h, "big"), name))
        ring.sort()
        self._ring = ring

    def _ring_pick(self, key: str, exclude: frozenset = frozenset()) -> str:
        point = int.from_bytes(hashlib.blake2b(key.encode(), digest_size=8).digest(), "big")
        i = bisect.bisect_right(self._ring, (point, ""))
        # walk clockwise past excluded vnodes (standard consistent hashing:
        # an ineligible owner's keys spill to the next eligible successor)
        for step in range(len(self._ring)):
            name = self._ring[(i + step) % len(self._ring)][1]
            if name not in exclude:
                return name
        raise NoReplicasError("no eligible replica on the ring")

    def mark_dead(self, name: str) -> None:
        """Map repair on UNAVAILABLE: drop the replica from the live set and
        the ring, purge its prefix-map entries, and unpin its sessions (they
        re-pin wherever their next request routes)."""
        with self._lock:
            if name not in self.replicas:
                return
            del self.replicas[name]
            self.prefill_replicas = [n for n in self.prefill_replicas if n != name]
            self._build_ring()
            for d in [d for d, r in self._prefix_map.items() if r == name]:
                del self._prefix_map[d]
            for s in [s for s, r in self._affinity.items() if r == name]:
                del self._affinity[s]
        logger.debug(f"serving router: replica {name} marked dead (map repaired)")

    # -- prefix-map feeding -------------------------------------------------

    def _map_put(self, digest: str, name: str) -> None:
        self._prefix_map[digest] = name
        self._prefix_map.move_to_end(digest)
        while len(self._prefix_map) > self._map_capacity:
            self._prefix_map.popitem(last=False)

    def observe(self, name: str, tokens: list) -> None:
        """Learn from a routed request: its full-page prefixes will be in
        `name`'s cache once its prefill lands (engine inserts at prefill
        completion), so the map can point followers there immediately."""
        if name not in self.replicas:
            return
        with self._lock:
            for d in page_digests(tokens, self.page_size):
                self._map_put(d, name)

    def refresh_from_stats(self, name: str, stats: dict) -> None:
        """Reconcile from a replica's /v1/stats payload: `prefix_digests`
        lists what its PrefixCache ACTUALLY serves (pfx-hit% rides the same
        report over heartbeats) — evicted or restarted-away entries stop
        attracting traffic at the next refresh."""
        if name not in self.replicas:
            return
        digests = stats.get("prefix_digests") or []
        with self._lock:
            for d in digests:
                self._map_put(str(d), name)

    # -- picking ------------------------------------------------------------

    def pick(
        self,
        tokens: list,
        session: Optional[str] = None,
        exclude: frozenset = frozenset(),
    ) -> tuple[str, str]:
        """(replica, reason) for a prompt. reason ∈ prefix|affinity|cold, or
        `random` when the router is disabled. `exclude` removes replicas from consideration
        (the split path excludes the dedicated prefill tier from the decode
        pick)."""
        with self._lock:
            names = [n for n in self.replicas if n not in exclude]
            if not names:
                raise NoReplicasError("no live serving replicas")
            if not self.enabled:
                return self._rng.choice(names), "random"
            if session:
                pinned = self._affinity.get(session)
                if pinned in names:
                    self._affinity.move_to_end(session)
                    return pinned, "affinity"
            for d in page_digests(tokens, self.page_size):
                hit = self._prefix_map.get(d)
                if hit in names:
                    self._prefix_map.move_to_end(d)
                    return hit, "prefix"
            # cold: consistent-hash on the first full page (whole prompt when
            # shorter) — same-content prompts converge before the map learns
            key_len = self.page_size if len(tokens) >= self.page_size else len(tokens)
            return self._ring_pick(prefix_digest(tokens[:key_len]), frozenset(exclude)), "cold"

    def _pin(self, session: Optional[str], name: str) -> None:
        if not session:
            return
        with self._lock:
            self._affinity[session] = name
            self._affinity.move_to_end(session)
            while len(self._affinity) > self._affinity_capacity:
                self._affinity.popitem(last=False)

    # -- routing ------------------------------------------------------------

    def route(
        self,
        body: dict,
        *,
        session: Optional[str] = None,
        split_prefill: bool = False,
        max_attempts: int = 3,
    ) -> Any:
        """Dispatch one generate request. The body is the /v1/generate JSON
        shape (prompt as a token list). With `split_prefill` and a prefill
        tier registered, the request takes the disaggregated two-leg path;
        any leg failure falls back to the direct path.

        Replica death: a transport's ConnectionError re-routes to the next
        pick WITH THE SAME REQUEST ID: the dead replica never answered, so
        the resend is exactly-once from the consumer's point of view."""
        tokens = list(body.get("prompt") or [])
        if not tokens:
            raise ValueError("route needs a token prompt in the body")
        body = dict(body)
        body.setdefault("request_id", f"rt-{self._rng.getrandbits(48):012x}")
        last_exc: Optional[Exception] = None
        for _attempt in range(max_attempts):
            # split mode keeps the decode pick off the dedicated prefill tier
            # (unless the tier IS the whole fleet, where exclusion = nobody)
            with self._lock:
                tier = frozenset(self.prefill_replicas)
                split = bool(split_prefill and tier and len(tier) < len(self.replicas))
            try:
                name, reason = self.pick(tokens, session=session, exclude=tier if split else frozenset())
            except NoReplicasError:
                break
            t0 = time.time()
            if split:
                result = self._route_split(name, body, tokens)
            else:
                try:
                    result = self.replicas[name]("/v1/generate", body)
                except ConnectionError as exc:
                    last_exc = exc
                    self.reroutes += 1
                    self.mark_dead(name)
                    continue  # same request_id rides the re-route
            self.routed[reason] += 1
            SERVING_ROUTER_ROUTED.inc(reason=reason)
            tracing.record_span(
                "serving.route",
                start=t0,
                end=time.time(),
                attrs={
                    "replica": name,
                    "reason": reason,
                    "request_id": body["request_id"],
                    "split": split,
                },
            )
            self.observe(name, tokens)
            self._pin(session, name)
            return result
        raise last_exc or NoReplicasError("no live serving replicas")

    def _route_split(self, decode_name: str, body: dict, tokens: list) -> Any:
        """Disaggregated two-leg dispatch: prefill leg on a prefill-role
        replica (ring-hashed over the prefill tier so repeated prefixes warm
        the same one), then the shipment reference lands on the decode
        replica via /v1/prefilled. EVERY failure here (a dead prefill replica,
        a bad shipment, a dropped frame) degrades to the direct /v1/generate
        leg on the decode replica (a full local prefill, the same tokens)."""
        key_len = self.page_size if len(tokens) >= self.page_size else len(tokens)
        with self._lock:
            tier = list(self.prefill_replicas)
        pre_name = None
        if tier:
            h = int.from_bytes(
                hashlib.blake2b(prefix_digest(tokens[:key_len]).encode(), digest_size=8).digest(),
                "big",
            )
            pre_name = tier[h % len(tier)]
        if pre_name is not None:
            try:
                pre_body = {
                    k: body[k]
                    for k in ("prompt", "temperature", "top_k", "top_p", "seed")
                    if k in body
                }
                ship = self.replicas[pre_name]("/v1/prefill", pre_body)
                dec_body = dict(body)
                dec_body["kv_ref"] = ship["kv_ref"]
                return self.replicas[decode_name]("/v1/prefilled", dec_body)
            except ConnectionError:
                # prefill replica died mid-shipment: repair and degrade
                self.prefill_fallbacks += 1
                self.mark_dead(pre_name)
            except Exception as exc:  # noqa: BLE001 — degrade, never fail the request
                self.prefill_fallbacks += 1
                logger.debug(f"serving router: prefill leg degraded ({exc})")
        return self.replicas[decode_name]("/v1/generate", body)

    # -- introspection ------------------------------------------------------

    def stats(self) -> dict:
        with self._lock:
            return {
                "enabled": self.enabled,
                "replicas": sorted(self.replicas),
                "prefill_replicas": list(self.prefill_replicas),
                "prefix_map_entries": len(self._prefix_map),
                "affinity_entries": len(self._affinity),
                "routed": dict(self.routed),
                "reroutes": self.reroutes,
                "prefill_fallbacks": self.prefill_fallbacks,
            }
