"""Sandboxes: on-demand containers with exec, a typed FS API, and sidecar
processes sharing the sandbox's filesystem and lifecycle.

    python modal_tpu_torch/examples/05_sandbox_and_sidecars.py
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))  # repo checkout

import modal_tpu_torch

if __name__ == "__main__":
    sb = modal_tpu_torch.Sandbox.create("sleep", "60")
    try:
        p = sb.exec("sh", "-c", "echo hello-from-sandbox")
        p.wait()
        print(p.stdout.read().strip())

        sidecar = sb._experimental_sidecars.create(
            "sh", "-c", "echo sidecar-wrote-this > shared.txt", name="writer"
        )
        sidecar.wait(timeout=30)
        cat = sb.exec("cat", "shared.txt")
        cat.wait()
        print("via shared fs:", cat.stdout.read().strip())
    finally:
        sb.terminate()
