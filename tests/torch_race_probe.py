"""Probes of two timing races the CPU tests meet under load (not collected:
no `test_` prefix). Run from the repo root:

    python -m tests.torch_race_probe cli-order [N]
        `cli run ::double 21` of tests/test_torch_cli.py's app N times
        through each package's CLI, on the input plane and on the control
        plane, against one pair of planes: how often the container's log
        line printed before the function's result.

    python -m tests.torch_race_probe attribution-gap ROOT [REPS]
        tests/test_torch_attribution.py's no-op scenario (6 `.remote()`
        calls through the port's plane) REPS times with the port of the
        checkout at ROOT: the warm calls' unattributed `gap` against their
        wall time. Run it for two checkouts in turns, beside the same load,
        to compare them.
"""

from __future__ import annotations

import os
import statistics
import sys
import tempfile


def cli_order(n: int) -> None:
    from tests.test_torch_app import CONTAINER_ENV, Planes
    from tests.test_torch_cli import APP_SCRIPT, PACKAGES, Cli

    os.environ.update(CONTAINER_ENV)
    planes = Planes(tempfile.mkdtemp(prefix="race-probe-", dir="/tmp"))
    planes.jclient.hello()  # both clients learn the input plane
    try:
        for disable, route in (("0", "input plane"), ("1", "control plane")):
            os.environ["MODAL_TPU_DISABLE_INPUT_PLANE"] = disable
            for name, m, _cli in PACKAGES:
                client, sup = planes.of(m)
                cli = Cli(name, m, tempfile.mkdtemp(dir=planes.root), client, sup)
                path = cli.script(APP_SCRIPT)
                log_first = 0
                for _ in range(n):
                    lines = [ln.strip() for ln in cli.run("run", f"{path}::double", "21").splitlines() if ln.strip()]
                    log_first += lines[0] != "42"
                print(f"{name:<4} {route:<13} log line first in {log_first} of {n} runs", flush=True)
    finally:
        os.environ.pop("MODAL_TPU_DISABLE_INPUT_PLANE", None)
        planes.close()


def attribution_gap(root: str, reps: int) -> None:
    sys.path.insert(0, os.path.abspath(root))
    import modal_tpu_torch
    from modal_tpu_torch._utils.async_utils import synchronizer
    from modal_tpu_torch.client import _Client
    from modal_tpu_torch.observability import critical_path
    from modal_tpu_torch.server.supervisor import LocalSupervisor

    assert modal_tpu_torch.__file__.startswith(os.path.abspath(root)), modal_tpu_torch.__file__
    warm: list[tuple[float, float]] = []
    for _ in range(reps):
        state = tempfile.mkdtemp(prefix="race-probe-attr-", dir="/tmp")
        sup = LocalSupervisor(num_workers=1, state_dir=state, worker_gpus=1, worker_gpu_type="local-sim")
        synchronizer.run(sup.start())
        client = _Client(sup.server_url)
        client._open()
        try:
            app = modal_tpu_torch.App("noop")

            def noop(x):
                return x

            f = app.function(serialized=True)(noop)
            with app.run(client=client):
                assert [f.remote(i) for i in range(6)] == list(range(6))
        finally:
            client._close()
            synchronizer.run(sup.stop())
        _agg, per_trace = critical_path.attribute_store(os.path.join(state, "traces"), f.object_id)
        warm += [(a["gap"], a["total"]) for a in per_trace if a][1:]
    shares = [g / t for g, t in warm]
    print(f"{root}: {len(warm)} warm calls, gap p50 {statistics.median(g for g, _ in warm) * 1e3:.3f} ms, "
          f"wall p50 {statistics.median(t for _, t in warm) * 1e3:.2f} ms, gap/wall max {max(shares):.3f}, "
          f"over 10%: {sum(x > 0.10 for x in shares)}", flush=True)


def main(argv: list[str]) -> None:
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    if argv[:1] == ["cli-order"]:
        cli_order(int(argv[1]) if len(argv) > 1 else 40)
    elif argv[:1] == ["attribution-gap"] and len(argv) >= 2:
        attribution_gap(argv[1], int(argv[2]) if len(argv) > 2 else 5)
    else:
        sys.exit(__doc__)


if __name__ == "__main__":
    main(sys.argv[1:])
