"""Production inference serving: continuous batching + paged KV + SSE.

`llm_service` registers an `@app.cls` whose container runs ONE shared
decode loop on its card: requests from many clients join and leave the
running batch per step (continuous batching over a paged KV pool, each
decode step's attention in the paged-decode CUDA kernel), and tokens
stream back over SSE as they are generated.

    python modal_tpu_torch/examples/06_serving.py       # on the card only
"""

import json
import os
import sys
import time
import urllib.request

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))  # repo checkout

import modal_tpu_torch

app = modal_tpu_torch.App("example-serving")

# real deployments: model="llama3-8b", checkpoint=<a local path of its
# weights>, and SLO targets the scheduler scales replicas on
Service = modal_tpu_torch.serving.llm_service(
    app,
    model="tiny",
    max_slots=8,
    name="TinyLLM",
    target_ttft_ms=500,
    target_tokens_per_replica=2000,
    gpu="H100",
)


if __name__ == "__main__":
    with modal_tpu_torch.enable_output(), app.run():
        url = Service.get_web_url(timeout=300)
        print("serving at", url)
        # buffered completion
        body = json.dumps({"text": "hello", "max_new_tokens": 16}).encode()
        req = urllib.request.Request(
            url + "/v1/generate", data=body, headers={"content-type": "application/json"}
        )
        t0 = time.perf_counter()
        out = json.loads(urllib.request.urlopen(req, timeout=300).read())
        wall = time.perf_counter() - t0
        print("tokens:", out["tokens"], f"(TTFT {out['ttft_s']:.3f}s, {len(out['tokens'])} tokens in {wall:.3f}s)")
        # streaming: same route with {"stream": true} answers text/event-stream
        # (one `token` event per generated token)
