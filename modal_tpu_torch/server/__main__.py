"""Standalone control plane of the port:
``python -m modal_tpu_torch.server --port 9900 --workers 1``.

Serves the port's control plane, input plane, blob server and scheduler
with N local workers whose containers run
`modal_tpu_torch.runtime.container_entrypoint`.

``--shards N`` (or MODAL_TPU_SHARDS=N) boots the sharded control plane
instead (server/shards.py): N shards behind a placement director on
``--port``, in this process, or each its own OS process with
``--subprocess-shards``. ``--shard-index``, ``--blob-dir`` and
``--fleet-root`` are how the director starts one subprocess shard: a
monolith that mints partition-``i`` ids, shares the fleet's blob store and
finds its replication peers in ``<fleet-root>/shards.json``.
"""

import argparse
import asyncio
import os

from .supervisor import serve_forever


def main() -> None:
    parser = argparse.ArgumentParser(description="modal_tpu_torch control plane + local workers")
    parser.add_argument("--port", type=int, default=9900)
    parser.add_argument("--workers", type=int, default=1)
    parser.add_argument("--state-dir", type=str, default=None)
    parser.add_argument(
        "--shards",
        type=int,
        default=int(os.environ.get("MODAL_TPU_SHARDS", "1") or 1),
        help="number of control-plane shards (>1 boots the sharded plane)",
    )
    parser.add_argument(
        "--subprocess-shards",
        action="store_true",
        help="run each shard as its own OS process (kill -9-able)",
    )
    parser.add_argument("--shard-index", type=int, default=0, help="partition of minted ids (set by the director)")
    parser.add_argument("--blob-dir", type=str, default=None, help="the fleet's shared blob store (set by the director)")
    parser.add_argument(
        "--fleet-root",
        type=str,
        default=None,
        help="the sharded fleet's root dir, whose shards.json lists the replication peers (set by the director)",
    )
    args = parser.parse_args()
    try:
        asyncio.run(
            serve_forever(
                port=args.port,
                num_workers=args.workers,
                state_dir=args.state_dir,
                shards=args.shards,
                subprocess_shards=args.subprocess_shards,
                shard_index=args.shard_index,
                blob_dir=args.blob_dir,
                fleet_root=args.fleet_root,
            )
        )
    except KeyboardInterrupt:
        pass


if __name__ == "__main__":
    main()
