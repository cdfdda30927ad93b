"""Hello world: a function running on the platform.

    python modal_tpu_torch/examples/01_hello_world.py   # uses the zero-config
                                                        # local plane (or
                                                        # MODAL_TPU_SERVER_URL)
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))  # repo checkout

import modal_tpu_torch

app = modal_tpu_torch.App("example-hello")


@app.function()
def square(x: int) -> int:
    return x * x


@app.local_entrypoint()
def main(n: int = 12):
    print(f"square({n}) =", square.remote(int(n)))
    print("map:", list(square.map(range(5))))


if __name__ == "__main__":
    with modal_tpu_torch.enable_output(), app.run():
        main()
