"""Volumes + streaming checkpoints: content-addressed block storage, HF
safetensors export, and the Volume->card streaming load.

    python modal_tpu_torch/examples/04_volumes_and_checkpoints.py             # on the card
    python modal_tpu_torch/examples/04_volumes_and_checkpoints.py --device cpu
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))  # repo checkout

import modal_tpu_torch
from modal_tpu_torch.models.llama import get_config, init_params
from modal_tpu_torch.models.weights import export_checkpoint, load_params

if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default="cuda", help="where the params live (default: the card)")
    args = parser.parse_args()

    vol = modal_tpu_torch.Volume.from_name("example-ckpt", create_if_missing=True)
    vol.hydrate()

    cfg = get_config("tiny")
    params = init_params(cfg, seed=0, device=args.device)  # a torch.Generator seeded 0
    index = export_checkpoint(params, cfg, (vol, "ckpt"))
    print("exported", index["metadata"]["total_size"], "bytes to the volume")

    restored = load_params((vol, "ckpt"), cfg, device=args.device)
    leaves = [*restored["layers"].values(), *(v for k, v in restored.items() if k != "layers")]
    print("restored param leaves:", len(leaves), "on", leaves[0].device.type)
