"""Standalone control plane of the port:
``python -m modal_tpu_torch.server --port 9900 --workers 1``.

Serves the port's control plane, blob server and scheduler with N local
workers whose containers run `modal_tpu_torch.runtime.container_entrypoint`.
"""

import argparse
import asyncio

from .supervisor import serve_forever


def main() -> None:
    parser = argparse.ArgumentParser(description="modal_tpu_torch control plane + local workers")
    parser.add_argument("--port", type=int, default=9900)
    parser.add_argument("--workers", type=int, default=1)
    parser.add_argument("--state-dir", type=str, default=None)
    args = parser.parse_args()
    try:
        asyncio.run(serve_forever(port=args.port, num_workers=args.workers, state_dir=args.state_dir))
    except KeyboardInterrupt:
        pass


if __name__ == "__main__":
    main()
