"""`llm_service`: a deployable continuous-batching LLM endpoint in one call
(port of modal_tpu/serving/service.py).

Glues the pieces the serving tier is built from: an `@app.cls` whose
`@enter(snap=True)` hook builds the params and the `ServingEngine` (so a
warm-state snapshot covers the loaded weights), an `@asgi_app` method
returning the SSE/JSON surface (serving/api.py), and an `@exit` hook that
stops the engine.

    app = modal_tpu_torch.App("llm")
    Service = modal_tpu_torch.serving.llm_service(app, model="llama3-8b", gpu="H100", max_slots=8)
    with app.run():
        url = Service.get_web_url()
        # POST {url}/v1/generate with {"prompt": [...], "stream": true}

`gpu=` and the other `@app.cls` options go through `**cls_kwargs`. The
params come from `checkpoint` (`weights.load_params`) or from the port's
`init_params` with `seed`; `device` is where the replica runs (CUDA unless
the caller names the CPU) and `dtype` overrides the config's. The SLO
targets (`target_ttft_ms`, `target_tokens_per_replica`) reach the control
plane, which refuses them until the port's SLO autoscaler (ROADMAP Queue A
4d-ii).
"""

from __future__ import annotations

from typing import Any, Optional


def llm_service(
    app: Any,
    *,
    model: str = "tiny",
    checkpoint: Optional[str] = None,  # a local path for weights.load_params
    quantize_int8: bool = False,
    seed: int = 0,
    max_slots: int = 8,
    num_pages: Optional[int] = None,
    page_size: int = 16,
    pages_per_slot: Optional[int] = None,
    prefill_chunk: int = 128,
    name: str = "LLMService",
    min_containers: int = 1,
    max_containers: int = 4,
    target_ttft_ms: float = 0.0,
    target_tokens_per_replica: float = 0.0,
    # service-level sampling defaults (request bodies override them)
    temperature: float = 0.0,
    top_k: int = 0,
    top_p: float = 1.0,
    sampling_seed: int = 0,
    draft_model: Optional[str] = None,  # alias of draft_config
    # a smaller draft: `draft_config` names its model config, `draft_weights`
    # its checkpoint (omitted: random init from `seed`)
    draft_config: Optional[str] = None,
    draft_weights: Optional[str] = None,
    spec_k: int = 3,
    prefix_cache: Optional[bool] = None,  # None = env default (on)
    role: Optional[str] = None,  # prefill | decode | both (None = env, else both)
    device: str = "cuda",
    dtype: Optional[str] = None,  # e.g. "float32"; None keeps the config's
    **cls_kwargs: Any,
) -> Any:
    """Register a serving class on `app` and return it (an `@app.cls`
    result: `.get_web_url()` under a run, or deploy it)."""
    import modal_tpu_torch

    opts = dict(
        serialized=True,
        min_containers=min_containers,
        max_containers=max_containers,
        target_ttft_ms=target_ttft_ms,
        target_tokens_per_replica=target_tokens_per_replica,
    )
    opts.update(cls_kwargs)

    class _LLMService:
        @modal_tpu_torch.enter(snap=True)
        def load(self):
            # before the snapshot: the weights and the engine's warm-up land
            # in the warm-state snapshot
            import torch

            from modal_tpu_torch.models.llama import get_config, init_params
            from modal_tpu_torch.serving.engine import ServingEngine

            overrides = {"dtype": getattr(torch, dtype)} if dtype else {}

            def params_of(cfg_name: str, weights: Optional[str]):
                cfg = get_config(cfg_name, **overrides)
                if weights:
                    from modal_tpu_torch.models.weights import load_params

                    return load_params(weights, cfg, device=device), cfg
                return init_params(cfg, seed=seed, device=device), cfg

            params, cfg = params_of(model, checkpoint)
            if quantize_int8:
                from modal_tpu_torch.models.quant import quantize_params

                params = quantize_params(params)
            draft_name = draft_config or draft_model
            draft = params_of(draft_name, draft_weights) if draft_name else None
            self.engine = ServingEngine(
                params,
                cfg,
                max_slots=max_slots,
                num_pages=num_pages,
                page_size=page_size,
                pages_per_slot=pages_per_slot,
                prefill_chunk=prefill_chunk,
                draft=draft,
                spec_k=spec_k,
                prefix_cache=prefix_cache,
                role=role,
                device=device,
            ).start()

        @modal_tpu_torch.exit()
        def shutdown(self):
            self.engine.stop()

        @modal_tpu_torch.asgi_app()
        def serve(self):
            from modal_tpu_torch.serving.api import serving_asgi_app

            return serving_asgi_app(
                self.engine,
                sampling_defaults={"temperature": temperature, "top_k": top_k, "top_p": top_p, "seed": sampling_seed},
            )

    # rename BEFORE decoration: @app.cls registers under __name__, and the
    # deployed class's tag must match the caller's `name`
    _LLMService.__name__ = name
    _LLMService.__qualname__ = name
    return app.cls(**opts)(_LLMService)
