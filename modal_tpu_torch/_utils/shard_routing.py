"""Pure request→partition routing shared by the placement director and the
client (port of modal_tpu/_utils/shard_routing.py).

The sharded control plane partitions app-scoped state by the partition number
embedded in every object id (see ``server.state.make_id``): id numbers are
``partition * PARTITION_STRIDE + local_counter``, so any RPC that carries an
object id can be routed without a lookup table.  RPCs that only carry a *name*
(app creation, deployment lookups) are routed by a stable hash of that name so
creates and subsequent lookups land on the same partition.  RPCs carrying
neither are unroutable and go to the director's default partition (0).

The module is light on dependencies: the director and the client's router
stub both import it.
"""

from __future__ import annotations

import zlib
from typing import Optional

from ..server.state import partition_of_id

# Id-bearing fields in priority order.  app_id first: everything scoped under
# an app must land on the app's partition even when the message also carries
# ids minted elsewhere.
ID_FIELDS: tuple[str, ...] = (
    "app_id",
    "function_id",
    "function_call_id",
    "input_id",
    "task_id",
    "sandbox_id",
    "image_id",
    "volume_id",
    "secret_id",
    "dict_id",
    "queue_id",
    "proxy_id",
    "worker_id",
    "mount_id",
    "cluster_id",
    "snapshot_id",
    "object_id",
)

# Name-bearing fields, used only when no id field is set.  ``description`` is
# the app name on AppCreate (AppGetOrCreate mirrors app_name into it), so a
# create and the later get-or-create hash identically.
NAME_FIELDS: tuple[str, ...] = (
    "app_name",
    "deployment_name",
    "description",
    "name",
)


def partition_for_name(name: str, num_partitions: int) -> int:
    return zlib.crc32(name.encode("utf-8")) % num_partitions


def partition_for_request(request, num_partitions: int) -> Optional[int]:
    """Return the owning partition for ``request``, or None if unroutable.

    Ids always win over names; an id minted by any shard encodes its partition
    directly.  Out-of-range partitions (id minted under a wider topology) are
    clamped modulo ``num_partitions`` so stale ids still resolve somewhere
    deterministic.
    """
    if num_partitions <= 1:
        return 0
    for field in ID_FIELDS:
        value = getattr(request, field, "")
        if value:
            part = partition_of_id(value)
            if part is not None:
                return part % num_partitions
    for field in NAME_FIELDS:
        value = getattr(request, field, "")
        if value:
            return partition_for_name(value, num_partitions)
    return None
