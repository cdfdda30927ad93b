"""Gang-scheduled distributed training: @clustered(size=N) places N
containers atomically, the control plane hands out ranks, and each
container joins the gang's torch.distributed process group before your
code runs (NCCL when its ranks hold cards, gloo when they hold none).

    python modal_tpu_torch/examples/03_clustered_training.py

The two ranks ask for no card (one host with one card cannot place two),
so the group is gloo and the sum's tensors live on the CPU.
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))  # repo checkout

import modal_tpu_torch

app = modal_tpu_torch.App("example-gang")


@app.function(serialized=True, timeout=300)
@modal_tpu_torch.clustered(size=2)
def train_step(step: int):
    import torch
    import torch.distributed as dist

    from modal_tpu_torch import get_cluster_info

    info = get_cluster_info()
    world = dist.get_world_size()
    # each rank holds its slice of arange(world); the all-reduce sums them
    x = torch.arange(float(world))[info.rank:info.rank + 1].sum()
    dist.all_reduce(x)
    return {"rank": info.rank, "world": info.world_size, "sum": float(x), "step": step,
            "backend": dist.get_backend()}


if __name__ == "__main__":
    with modal_tpu_torch.enable_output(), app.run():
        print(train_step.remote(1))
