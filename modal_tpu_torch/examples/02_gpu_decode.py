"""LLM decode on a card: pin an H100, load weights once per container with
@enter(snap=True) (warm-state snapshots skip it on later cold boots), serve
decodes.

    python modal_tpu_torch/examples/02_gpu_decode.py        # on the card
    python modal_tpu_torch/examples/02_gpu_decode.py cpu    # on the CPU

The argument is the local entrypoint's `device`, which the class takes as
its `device` parameter (`python -m modal_tpu_torch.cli run
modal_tpu_torch/examples/02_gpu_decode.py --device cpu` does the same).
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))  # repo checkout

import modal_tpu_torch

app = modal_tpu_torch.App("example-decode")


@app.cls(gpu="H100", enable_memory_snapshot=True, serialized=True)
class Decoder:
    device: str = modal_tpu_torch.parameter(default="cuda")

    @modal_tpu_torch.enter(snap=True)
    def load(self):
        from modal_tpu_torch.models.llama import get_config, init_params

        # real deployments stream HF safetensors from a Volume:
        #   from modal_tpu_torch.models.weights import load_params
        #   self.params = load_params((modal_tpu_torch.Volume.from_name("weights"), "ckpt"), cfg)
        # and name model="llama3-8b"
        self.cfg = get_config("tiny")
        self.params = init_params(self.cfg, seed=0, device=self.device)  # a torch.Generator seeded 0

    @modal_tpu_torch.method()
    def decode(self, prompt_len: int = 16, gen_len: int = 8) -> dict:
        import time

        import torch

        from modal_tpu_torch.models.llama import KVCache
        from modal_tpu_torch.models.sampling import decode_tokens, host_sync, prefill

        t0 = time.perf_counter()
        prompt = torch.ones((1, prompt_len), dtype=torch.int32, device=self.device)
        cache = KVCache.create(self.cfg, 1, prompt_len + gen_len + 8, device=self.device)
        logits, cache = prefill(self.params, self.cfg, prompt, cache)
        next_tok = logits.argmax(-1, keepdim=True).to(torch.int32)
        toks, _, _ = decode_tokens(self.params, self.cfg, next_tok, cache, gen_len)
        host_sync(toks)
        return {"tokens": [int(t) for t in toks[0]], "seconds": time.perf_counter() - t0}


@app.local_entrypoint()
def main(device: str = "cuda"):
    out = Decoder(device=device).decode.remote()
    print("decoded tokens:", out["tokens"])
    print(f"decode wall time: {out['seconds']:.4f} s in the container")


if __name__ == "__main__":
    with modal_tpu_torch.enable_output(), app.run():
        main(*sys.argv[1:])
