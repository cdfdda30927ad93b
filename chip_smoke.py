#!/usr/bin/env python3
"""Drive the PyTorch port (`modal_tpu_torch`) on one NVIDIA GPU, in phases.

    python3 chip_smoke.py                 # every phase, as a release check
    python3 chip_smoke.py --phases device,build,kernels --out chiprun_out/smoke.json
    python3 chip_smoke.py --phases device,build,kernels,train
    python3 chip_smoke.py --phases device,build,serve,spec,disagg
    python3 chip_smoke.py --phases device,build,serve,graphs,weights,int8
    python3 chip_smoke.py --phases device,build,serve,weights,volume
    python3 chip_smoke.py --phases device,build,moe,mesh
    python3 chip_smoke.py --phases device,build,sdk
    python3 chip_smoke.py --phases device,build,serve,sdk,worker
    python3 chip_smoke.py --phases device,build,worker,app
    python3 chip_smoke.py --phases device,build,serve,web,disagg,disagg_http
    python3 chip_smoke.py --phases device,build,observe
    python3 chip_smoke.py --phases device,build,pool,sandbox
    python3 chip_smoke.py --phases device,build,serve,sdk,image

Phases (each failure raises; the script then exits non-zero and prints no
result line):

1. device   — the card's name and power limit (nvidia-smi), TF32 off; the
              host's CPU model, logical CPU count and 1-minute load
              average; one log line saying whether grpc, google.protobuf,
              cloudpickle and aiohttp are importable here (a probe, never a
              failure).
2. build    — compile every CUDA kernel of the port from `modal_tpu_torch/csrc`
              (one nvcc per source, all started together), then the AOT
              warm-up of every entry point (`MODAL_TPU_AOT_LOWER=all`), which
              must report no error.
3. kernels  — each kernel against its plain PyTorch version at its path's
              shapes (bf16), then timed beside the plain version, the
              card's bound for the same work, and one PyTorch library call
              computing the same function (a yardstick only: the port never
              calls it). K4 is also checked at q_pos on and around its
              chunk boundaries, and timed cold (L2 flushed before each call)
              beside its warm time, at llama3-8b's head shape and at the
              speculative draft's (hd 64).
4. serve    — llama3-8b at full width with seeded random weights: the
              ServingEngine answers 8 requests (one through the ASGI app's
              /v1/generate, driven in process) with its decode step captured
              as a CUDA graph (the engine's default on a card); every request
              must finish with 64 tokens and the paged decode kernel must have
              launched exactly n_layers times per decode step, replays counted.
5. sdk      — the SDK core at llama3-8b's full width: `gpu="H100"` through
              GPUConfig's bytes and back must name this card; a serving
              function defined here, closing over the serve phase's traffic,
              goes through the port's cloudpickle `serialize` to a fresh
              interpreter with one card visible, which deserializes and calls
              it: a graphed engine serves the 8 requests and the function
              returns the streams, the last decode step's logits as a CUDA
              tensor and K4's launches through `serialize_payload` (K4
              exactly n_layers per decode step; the logits come back a CPU
              tensor whose bytes hash as the child's did; the streams equal
              the serve phase's, a greedy one may differ only at a near-tie);
              then the 1.05 GB bf16 embedding table on the card goes through
              `serialize_payload` → frame bytes → `deserialize`: bit-equal,
              its pickle stream under 4 KiB, GB/s each way and peak host RSS.
6. worker   — the function path on one host, the port's end to end: its
              LocalSupervisor in this process (control plane, blob server,
              scheduler, one worker whose nvidia-smi probe must find this
              card); the sdk phase's serving function asked for with
              gpu="H100", placed by the scheduler on card 0 and run by the
              worker in a container process of
              `modal_tpu_torch.runtime.container_entrypoint` pinned to it
              (CUDA_VISIBLE_DEVICES); two inputs, served by the same task:
              each result through the blob server, its logits rebuilt on
              this card and hashing as the container's and the sdk child's,
              K4 exactly n_layers per decode step, streams equal to serve's;
              each call's boot split from the control plane's span sink;
              then gpu="H100:2" refused as unsatisfiable after the grace
              window, no task launched. The control plane journals (its
              default): a FunctionMap of two inputs, sent under one
              idempotency key, runs in the warm container until the first
              output is in and the second input is claimed; then
              `crash_restart` kills the plane and its containers and
              rebuilds it from the journal on the same ports and socket
              (the recovery report printed); the same FunctionMap re-sent
              across the restart must answer the same call and create none;
              the second input must run again in a new container and each
              idx deliver exactly one output, with the logits' sha256 of
              the earlier inputs. Its 4.1 MB result is fetched by path and
              over HTTP, 5 rounds each in turns, bytes equal; the
              containers' own uploads of their results and the rung of
              each of a container's RPCs come from their spans; the journal's
              appends, bytes and append time are read over the phase.
              Then the llama3-8b replica booted
              twice as containers of a second control plane (its own fleet
              store and snapshot dir): a serialized class whose
              `@enter(snap=True)` builds the state (init_params, seed 0,
              16.06 GB, a lambda and a closure), run by the entrypoint's
              boot order (compile hooks, fleet cache, restore or enter and
              save, ContainerCheckpoint, the AOT warm-up of K4), then its
              `serve` method: 8 greedy requests through the graphed
              engine. The fresh boot must restore nothing, build K4 with
              nvcc and publish it; the warm boot must restore every leaf
              bit-equal (device checksums), run nvcc zero times with a fleet
              hit for each kernel it loaded, emit the fresh boot's tokens,
              and call the restored lambda and closure. Each boot's time
              from the spawn to the first token is printed by part.
7. app      — the App layer, as a user's script drives it: `app.run()` with no
              server configured boots the port's LocalSupervisor in this
              process (a fresh state dir; the worker's nvidia-smi probe must
              find this card). A serialized `@app.cls(gpu="H100")` holds
              llama3-8b at full width: `@enter` builds the params (seed 0)
              and the graphed engine; `serve_all.remote()`, cold then warm,
              runs the sdk phase's 8 requests (logits sha256 equal to the
              sdk and worker phases' when they ran, K4 exactly n_layers per
              decode step, streams equal to serve's); `forward_last.map` over
              8 prompts of 128-512 tokens returns its results in order (K1
              exactly n_layers each), `.remote(prompt 0)` and
              `.spawn(prompt 1).get()` bit-equal to map results 0 and 1;
              every input in one container pinned to card 0 (TaskList), with
              `@enter` run once. Printed: the plane's boot and AppCreate →
              objects published, the cold call by part (spawn → hello,
              import torch, @enter, the method), the warm call, the map's
              time per input, and a warm `ping` through the App against raw
              FunctionMap + FunctionGetOutputs to the same container (the
              App layer's own cost). Then the module-level, non-serialized
              `app_file_function` (gpu="H100") runs in a container that
              imported this script by path, pinned to the card.
7b. pool    — the warm pool of the port's worker: the worker phase's
              llama3-8b function (gpu="H100") through a LocalSupervisor with
              MODAL_TPU_WARM_POOL=1 and =0 in turns (on, off, off, on), each
              run a control plane of its own. A pooled call must be a warm
              hit (`warm_pool_hit` on its task) served by the parked pid,
              its `import torch` span shorter than every unpooled one's,
              its logits bit-equal to the unpooled calls', K4 exactly
              n_layers per decode step in the container and the same count
              in its heartbeat; every parked interpreter holds no CUDA
              context (its park span; not among nvidia-smi's compute apps)
              and, after a placement that made one, exits while a fresh one
              parks (ROADMAP Queue C 28). Then a min_containers=1 function
              with the baseline off: the PoolDirective pre-forks an
              interpreter beside the cold first container, that container
              is stopped, and its replacement's call is a warm hit pinned
              to card 0. Printed: each boot by part (spawn or adoption →
              hello, import torch, AOT, ready, first output), the pids.
7b'. image  — images on the card, on a fresh control plane with an empty
              fleet store: `Image.debian_slim(python_version="3.12")` with
              an env layer (MODAL_TPU_AOT_LOWER=train,decode), a pip layer
              (a local package, --no-index) and `.prewarm` (K1-K4 built by
              nvcc into the image, counted as source=prewarm) is built by
              the port's worker; llama3-8b at full width (seed 0) runs as a
              gpu="H100" function on it: the serve phase's 8 requests (K4
              in the graphed step, n_layers per decode step), one
              cache-less forward of [1, 512] (K1 n_layers), each decode
              step's tokens put into an ephemeral Queue that this process
              drains while the call runs (equal to the return value), each
              request's text and the last logits (back here on the card)
              in a named Dict; K1 and K4 counted from the container's
              heartbeat. The container must run the image's python, import
              the pip layer (not importable here), see every epoch pin at
              its installed version, record no cache_miss and no nvcc run
              and load its libraries from under the image's rootfs; the
              streams and logits are held to serve's and sdk's. An image
              whose RUN exits 3 fails its call with INIT_FAILURE and the
              build log's tail, nothing run; ImageList counts the
              references and ImageDelete refuses a referenced image. A
              min_containers=1 pool keyed on the image parks the image's
              python with the park-time warm-up (no nvcc, no CUDA
              context), and its adoption serves one request. Then the twin
              image without `.prewarm` on a second fresh plane: its
              container runs nvcc four times, its logits equal the
              prewarmed one's. Printed: the build by part, both cold calls
              by part, Queue put → get ms per step, Dict get ms, the failed
              build's time, the pooled adoption → first output.
7c. sandbox — `Sandbox.create("sleep", "infinity", gpu="H100", app=...)`
              through `app.run()`, pinned to card 0; an exec'd
              `python -m modal_tpu_torch.tools.sandbox_forward` builds
              llama3-8b from the seed and runs the cache-less forward on 4
              prompts of 128-512 tokens, twice each (K1 exactly n_layers a call, the
              kernel path at least as close to fp32 attention as the plain
              path), its JSON line read through TaskExecStdioRead; a 1 MiB
              file through TaskFsOp; 1 MiB through an exec'd `cat`'s stdin;
              an HTTP server inside the sandbox reached through its tunnel;
              snapshot_filesystem restored into a CPU sandbox; terminate.
              Printed: create → running, exec → first byte, the forward's
              ms a call (device, and host until the call returned), the round trips, the snapshot's bytes and seconds,
              the exec'd process's peak device memory.
8. graphs   — the same traffic through an engine with cuda_graphs=False: the
              8 streams must equal the serve phase's (a differing token must be
              a near-tie, SELF_DRAFT_TIE, of the two modes' logits), K4 exact
              in both; then the decode step of each mode, wall and device ms
              and busy share at 8 slots, each graph's pool and capture time.
9. weights  — the serving params exported as a safetensors checkpoint to a
              temporary local directory (free space checked first) and
              loaded back (`models/weights.py`): export and load GB/s, peak
              host RSS, every tensor bit-equal; the cache-less forward on the
              reloaded params launches the flash kernel once per layer and
              equals the original's; a serve run on them gives the serve
              phase's streams. The reloaded params replace the originals.
9b. volume  — llama3-8b's weights in a Volume of the port's plane (booted by
              `app.run()` in a fresh state dir, free space checked first):
              `export_checkpoint(params, cfg, (vol, "llama3-8b"))`, upload
              GB/s; then an `@app.function(gpu="H100", volumes={"/weights":
              vol})` container pinned to card 0 loads them with
              `load_params((vol, "llama3-8b"), cfg, device="cuda")` (its
              reads land in the tensors' host buffers; load GB/s beside the
              weights phase's), runs the weights phase's cache-less forward
              (flash_fwd exactly n_layers, logits checksum equal to the
              weights phase's) and serves the 8 requests (streams equal to
              serve's, paged_decode exactly n_layers per decode step).
              Then, with the weights' blocks dropped from the store, a
              train state at llama3-8b's full width and 4 layers (bf16
              params and AdamW's two moments, ~11.5 GB) takes two steps,
              is saved with `VolumeCheckpointer` (`parallel.train.state_tree`),
              restored into fresh tensors on the card (every tensor
              bit-equal) and steps once more from the restored and from the
              live state: equal loss and grad norm (their gaps printed);
              K1-K3 exact per step; save and restore GB/s.
10. int8    — `init_params_quantized(llama3-8b, fast_host_init=True)` on the
              card (bytes, peak memory), the serving traffic through a
              graphed engine on it (64 tokens each, K4 exact), and its decode
              step's device ms beside the bf16 step's.
11. spec     — the same traffic through speculative decoding with the
              target at llama3-8b's width and SPEC_TARGET_LAYERS (16) of its
              32 layers (spec_k 3, the
              two slot groups of a round queued before either is read back;
              a host sync inside a dispatch raises): (a) a llama3-1b-proxy
              draft at full width, whose decode steps run the paged decode
              kernel at hd 64 exactly draft layers × (spec_k + 1) times per
              dispatch (replays of the draft's decode graph counted); (b) the
              target as its own draft, where every rejected proposal must sit
              at a near-tie of the target's logits (SELF_DRAFT_TIE); and the
              draft step's time, eager and graphed.
12. disagg   — a prefill-role and a decode-role engine on the card, sharing the
              weights, driven through /v1/prefill and /v1/prefilled with a
              shared shipment dir: 8 remote prefills and no degrade, pages that
              land bit-equal to the shipment, the decode engine's kernel
              launches exactly n_layers per step, and token streams equal to the
              serve phase's (an all-in-one engine's when serve did not run).
13. web      — llama3-8b served over HTTP by an `llm_service` replica:
              `app.run()` boots the port's plane (a fresh state dir); the
              service (gpu="H100", 8 slots, 2048 pages) builds the params
              (seed 0) and the graphed engine in `@enter(snap=True)` in a
              container pinned to card 0, and its `@asgi_app` serves the
              serve phase's 8 requests concurrently over HTTP (4 as SSE
              streams): 64 tokens each, streams equal to serve's (a greedy
              one may differ at a near-tie), /v1/stats requests_completed
              ≥ 8 and cuda_graphs true, K4 exactly n_layers per decode step
              inside the container (its heartbeat's launch counts); the
              cold `get_web_url` by part, TTFT and tokens/s beside serve's,
              the container's and the card's peak memory; a Period(2 s) CPU
              function must fire twice within 10 s.
13b. observe — the metrics plane on an SLO-targeted llm_service replica of
              llama3-8b (gpu="H100", max_containers 2, target_ttft_ms a
              quarter of the web phase's TTFT p50, at most 250 ms; its
              prefix cache off): the plane's sampler every
              OBSERVE_TS_INTERVAL_S and the TTFT burn-rate rule at the same
              objective. 8 concurrent HTTP requests (the same 8 in every
              round); then `/metrics` in both formats (OpenMetrics ends in
              `# EOF`; K4's launches +n_layers per decode step and the TTFT
              histogram's count +8 between two scrapes), MetricsHistory's
              p95 over the fast window equal to the bucket p95 of this
              round's own 8 TTFTs, `serving_ttft_p95` firing and its
              transition in the journal, the SLO autoscaler asking for 2
              replicas while the second waits for the card (one replica
              task; nvidia-smi's compute apps: this process and the
              replica), TaskGetTimeline of the replica; 6 more rounds with
              the sampler off and on, then ProfileControl on and off, in
              turns (tokens/s and TTFT p50 each), the folded stacks' top
              frames of the replica and of the plane's process; then a
              `runtime_debug=True` class (gpu="H100") runs the cache-less
              forward of llama3-8b on [1, 512] twice: AppListProfiles lists
              2 traces, each naming flash_fwd_kernel n_layers times, and the
              same class without runtime_debug gives the unprofiled call.
              The host line is logged again at its start.
14. disagg_http — the prefill and decode roles as two processes on card 0,
              each llama3-8b at full width behind AsgiHttpServer, shipping
              PUT → GET through a LocalSupervisor's blob server
              (MODAL_TPU_KV_SHIP_URL, no shared file); a ServingRouter with
              HTTP transports routes the 8 requests through /v1/prefill →
              /v1/prefilled with no prefill fallback; streams as in web, K4
              exact in the decode process; tokens/s, TTFT, the prefill leg,
              MB per shipment and export ms beside the in-process disagg
              phase's, each process's peak memory, and the same pages'
              export through a plain .cpu(), the chunked pinned Staging and
              export_pages.
15. parity  — one greedy request's first decode step through the kernel,
              through attn_impl="gather" and through fp32 attention, on the
              same engine state, at depths 1 to 32.
16. forward — cache-less `llama.forward` on [1, 2048] tokens: the flash
              kernel launches once per layer; its logits are compared with a
              forward through the plain einsum attention and one through fp32
              attention. Then the sandbox phase's calls (128-512 tokens, the
              same weights and tokens) in this process, timed the same way.
17. train   — the serving state is released first. Gradient parity: the
              grads of `loss_fn` on llama3-8b at full width and 2 layers
              ([1, 2048] tokens) through the kernels, through the einsum
              attention and through fp32 attention; the kernel path must be
              at least as close to the fp32 grads as the einsum path (global
              relative L2). Then `train_demo("llama3-8b", steps=4)`, the
              full model on one card: finite loss and grad norm, params that
              move once the lr is above 0, and per step exactly 2 x 32
              forward launches (remat runs each layer's forward again in the
              backward) and 32 launches of each backward kernel; the second
              step's optimizer update (clip + AdamW) runs under
              torch.cuda.set_sync_debug_mode("error"): no host sync.
18. moe     — llama3-8x7b-proxy at full width (8 experts, seeded random
              weights): the cache-less forward on [1, 2048] at full depth
              (32 layers, 64.9 GB of bf16 params), K1 exactly once per
              layer, the kernel path at least as close to fp32 attention
              as the einsum path, aux and the dropped fraction printed; one
              layer's dispatch / combine / expert einsums timed; then
              train_demo with n_layers cut to 6, 4 steps of [1, 2048] with
              the train phase's checks (launches per step 2 x 6 K1, 6 K2, 6
              K3; the second update under sync debug mode "error"), step
              time, tokens/s, peak memory and MFU over the active params.
19. mesh    — a one-rank NCCL group, build_mesh({}), and
              create_sharded_state's DTensor step on llama3-8b at full
              width with 2 layers, 2 steps, against the one-device step on
              the same params and tokens: first-step loss within 1e-3
              relative, params within a global relative L2 of 1e-2, K1-K3
              launches exact, AdamW's moments placed like their params.

Parity at depth: with random weights a single bf16 rounding inside
attention moves llama3-8b's logits by a few 1e-2 (max over the 128256-entry
vocabulary), and the gap grows with depth. So the parity and forward phases
print the kernel-vs-plain gap and require that the kernel land at least as close to
fp32 attention as the plain version does, and pick fp32 attention's greedy
token at least as often.

Output: progress lines, then the nvidia-smi line, then one JSON line
{"kernels": [...]}, and last {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import argparse
import asyncio
import json
import math
import os
import statistics
import subprocess
import sys
import time

from modal_tpu_torch import App  # the App layer loads no torch (a container imports this script)

REPO = os.path.dirname(os.path.abspath(__file__))
PHASES = ("device", "build", "kernels", "serve", "sdk", "worker", "app", "pool", "image", "sandbox", "graphs", "weights",
          "volume",
          "int8",
          "spec", "disagg", "web", "observe", "disagg_http", "parity", "forward", "train", "moe", "mesh")

# the card's published peaks (H100 SXM data sheet): HBM bytes/s and dense
# bf16 tensor-core FLOP/s
HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS = 989e12
# rounds of `time_ms` behind each kernel-phase median
TIMING_ROUNDS = 5
# clock cycles of the spin kernel `time_ms` queues ahead of the timed calls
SPIN_CYCLES = 100_000_000
# (B, S, H, D, causal) at which K1, K2 and K3 are held to their plain
# versions: the training path's shape, then one non-causal, one of three
# 128-row tiles, S 64, half of K1's 128-row q tile and of K3's 128-row K/V
# tile, and the app phase's cache-less forward lengths at 32 heads
# (`_forward_prompts`: 128 to 512)
FLASH_SHAPES = ((1, 2048, 32, 128, True), (2, 256, 4, 64, False), (1, 384, 2, 128, True),
                (1, 64, 2, 128, True), (1, 128, 32, 128, True), (1, 256, 32, 128, True),
                (1, 384, 32, 128, True), (1, 512, 32, 128, True))


def log(msg: str) -> None:
    print(msg, flush=True)


def time_ms(torch, fn, iters: int, warmup: int = 3) -> float:
    """Mean device time of `fn` over `iters` back-to-back calls (CUDA events).
    A spin kernel (~50 ms) holds the card while the host queues the calls,
    so a call whose host side outlasts its device side (SDPA's backward
    through autograd) is timed on the device, not by the host's pace."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    torch.cuda._sleep(SPIN_CYCLES)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def time_turns(torch, fns: dict, iters: int, rounds: int = TIMING_ROUNDS) -> dict:
    """{name: (median, min, max)} of `rounds` rounds of `time_ms` per
    function, taken in turns inside one call (a, b, ..., then ..., b, a),
    so a kernel and its library yardstick see the same card state."""
    times: dict = {name: [] for name in fns}
    for r in range(rounds):
        for name in (list(fns) if r % 2 == 0 else list(fns)[::-1]):
            times[name].append(time_ms(torch, fns[name], iters))
    return {name: (statistics.median(ts), min(ts), max(ts)) for name, ts in times.items()}


def _spread(t) -> str:
    return f"{t[0]:.4f} [{t[1]:.4f}, {t[2]:.4f}]"


def _sdpa_cudnn(torch):
    """SDPA pinned to its cuDNN backend, the fastest at the flash kernels'
    shape: left to choose, SDPA took cuDNN (backward ~0.28 ms on an H100
    80GB HBM3 at 700 W) in some calls and FlashAttention-2 (~0.50 ms) in
    others, so the yardstick moved 1.8x between calls."""
    from torch.nn.attention import SDPBackend, sdpa_kernel

    return sdpa_kernel(SDPBackend.CUDNN_ATTENTION)


def _timed(kernel, library, **rest) -> dict:
    """A kernel's measurements from `time_turns`: medians as `ms` and
    `library_ms`, each round's min and max beside them."""
    return {"ms": kernel[0], "ms_min": kernel[1], "ms_max": kernel[2], "library_ms": library[0],
            "library_ms_min": library[1], "library_ms_max": library[2], **rest}


def _nvidia_smi() -> str:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    if smi.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {smi.stderr.strip()}")
    return smi.stdout.strip().splitlines()[0]


# the packages the SDK core of the JAX package imports (client, gRPC utils,
# protobuf messages, serialization, the blob server)
SDK_PACKAGES = ("grpc", "google.protobuf", "cloudpickle", "aiohttp")


def _importable(name: str) -> bool:
    import importlib.util

    try:
        return importlib.util.find_spec(name) is not None
    except ModuleNotFoundError:  # the parent package (google) is missing
        return False


def phase_device(torch, ctx: dict) -> None:
    ctx["nvidia_smi"] = _nvidia_smi()
    ctx["kind"] = torch.cuda.get_device_name(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"[device] {ctx['kind']} | nvidia-smi: {ctx['nvidia_smi']} | torch {torch.__version__} "
        f"cuda {torch.version.cuda} | count {torch.cuda.device_count()}")
    ctx["host"] = _host_line()
    log(f"[device] {ctx['host']}")
    ctx["sdk_packages"] = {name: _importable(name) for name in SDK_PACKAGES}
    log("[device] SDK packages importable here: "
        + ", ".join(f"{name} {'yes' if ok else 'no'}" for name, ok in ctx["sdk_packages"].items()))


def phase_build(torch, ctx: dict) -> None:
    from modal_tpu_torch.ops import _build

    t0 = time.perf_counter()
    report = _build.build(verbose=True)
    ctx["build_s"] = time.perf_counter() - t0
    for name, rep in report.items():
        regs = [ln.strip() for ln in rep["log"].splitlines()
                if any(w in ln for w in ("entry function", "registers", "spill", "C7512"))]
        log(f"[build] {name}: {rep['seconds']:.1f}s from {rep['source']}")
        for ln in regs:
            log(f"[build]   {ln}")
    ctx["build_log"] = {name: rep["log"] for name, rep in report.items()}
    if "paged_decode" in report and report["paged_decode"]["source"] == "nvcc":
        # the instance the speculative draft (llama3-1b-proxy) runs: hd 64, n_rep 4
        lines = _ptxas_instance(report["paged_decode"]["log"], "paged_decode_kernelILi64ELi4E")
        if not lines:
            raise AssertionError("ptxas reported no paged_decode_kernel<64, 4> instance")
        for ln in lines:
            log(f"[build] paged_decode hd 64 n_rep 4 (the draft's instance): {ln}")
    log(f"[build] all kernels in {ctx['build_s']:.1f}s")
    from modal_tpu_torch.runtime import aot

    saved = os.environ.get(aot.AOT_ENV)
    os.environ[aot.AOT_ENV] = "all,cfg=llama3-8b"
    try:
        warm = aot.maybe_aot_lower()
    finally:
        if saved is None:
            del os.environ[aot.AOT_ENV]
        else:
            os.environ[aot.AOT_ENV] = saved
    if warm is None or "errors" in warm or set(warm) != set(aot.ENTRY_POINTS):
        raise AssertionError(f"AOT warm-up failed: {warm}")
    ctx["aot"] = warm
    log(f"[build] AOT warm-up ({aot.AOT_ENV}=all,cfg=llama3-8b): "
        + ", ".join(f"{k} {v['kernels'] or 'no kernel'} {v['seconds']}s" for k, v in warm.items())
        + f"; llama3-8b params {warm['decode']['param_bytes'] / 1e9:.2f} GB (meta tree)")


def _ptxas_instance(ptxas_log: str, mangled: str) -> list[str]:
    """ptxas' `-v` lines for the kernel instance whose mangled name holds
    `mangled`: its entry line, properties (stack, spills) and registers."""
    out, inside = [], False
    for ln in ptxas_log.splitlines():
        if "Compiling entry function" in ln:
            inside = mangled in ln
        if inside and ln.strip():
            out.append(ln.strip())
    return out


# K4's serving shapes (S, n_kv, n_rep, hd, page, pages per slot): 8 slots,
# an 8192-token span per slot, at llama3-8b's heads and at those of the
# speculative draft, llama3-1b-proxy (hd 64)
K4_SHAPE = (8, 8, 4, 128, 16, 512)
K4_DRAFT_SHAPE = (8, 8, 4, 64, 16, 512)


def _k4_pages(torch, gen, shape):
    """q and the K/V page pool at `shape`, 1 + S x pps pages (page 0 scratch)."""
    s, n_kv, n_rep, hd, page, pps = shape
    n_pages = 1 + s * pps
    q = torch.randn((s, n_kv, n_rep, hd), generator=gen, device="cuda").to(torch.bfloat16)
    k_pages = torch.randn((n_pages, page, n_kv, hd), generator=gen, device="cuda").to(torch.bfloat16)
    v_pages = torch.randn((n_pages, page, n_kv, hd), generator=gen, device="cuda").to(torch.bfloat16)
    return q, k_pages, v_pages


def _k4_tables(torch, gen, shape, lens, inactive=()):
    """A random page table over pages 1.. and the slots' q_pos; an inactive
    slot's table points at the scratch page."""
    s, _n_kv, _n_rep, _hd, _page, pps = shape
    perm = torch.randperm(s * pps, generator=gen, device="cuda").to(torch.int32) + 1
    page_table = perm.reshape(s, pps).contiguous()
    for i in inactive:
        page_table[i] = 0
    return page_table, torch.tensor(lens, dtype=torch.int32, device="cuda")


def _k4_check(torch, label: str, q, kp, vp, pt, sl, live) -> float:
    """K4 against its plain version on the live slots: max|kernel − plain|
    <= 2e-2 and relative L2 <= DECODE_REL_L2 on every (slot, kv head)."""
    from modal_tpu_torch.ops.paged_attention import (
        DECODE_REL_L2,
        paged_decode_attention,
        paged_decode_attention_ref,
        worst_head_rel_l2,
    )

    out = paged_decode_attention(q, kp, vp, pt, sl)
    torch.cuda.synchronize()
    ref = paged_decode_attention_ref(q, kp, vp, pt, sl)
    torch.cuda.synchronize()
    err = (out[live].float() - ref[live].float()).abs().max().item()
    rel = worst_head_rel_l2(out, ref, live)
    log(f"[kernels] paged_decode {label} q_pos {sl.tolist()}: max|kernel-plain| = {err:.3e} (atol 2e-2), "
        f"worst (slot, kv head) rel L2 {rel:.3e} (bar {DECODE_REL_L2})")
    if not (err <= 2e-2 and rel <= DECODE_REL_L2):
        raise AssertionError(f"paged_decode disagrees with its plain version ({label}): {err}, {rel}")
    return err


def time_cold_ms(torch, fn, calls: int = 20) -> float:
    """Median device time of `fn` with the L2 flushed before each call: a
    256 MB buffer (5x the 50 MB L2) is written between calls, and each call
    is timed by its own pair of CUDA events behind a spin kernel."""
    flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    events = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)) for _ in range(calls)]
    torch.cuda._sleep(SPIN_CYCLES)
    for start, end in events:
        flush.fill_(1)
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    return statistics.median(start.elapsed_time(end) for start, end in events)


def phase_kernels(torch, ctx: dict) -> None:
    from modal_tpu_torch.ops import _build
    from modal_tpu_torch.ops.attention import (
        FWD_TILE_REL_L2,
        flash_attention_fwd,
        flash_attention_fwd_ref,
        worst_tile_rel_l2,
    )

    F = torch.nn.functional
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    results = ctx.setdefault("kernels", {})

    # -- K4: paged decode attention, at the target's heads and the draft's --
    results["paged_decode"] = _k4_measure(torch, gen, K4_SHAPE, "hd 128")
    ctx["paged_decode_draft_shape"] = _k4_measure(torch, gen, K4_DRAFT_SHAPE, "hd 64")

    # -- K1: flash-attention forward ---------------------------------------
    def qkv(b, sq, h, d):
        return [torch.randn((b, sq, h, d), generator=gen, device="cuda").to(torch.bfloat16) for _ in range(3)]

    worst = 0.0
    for (b, sq, h, d, causal) in FLASH_SHAPES:
        fq, fk, fv = qkv(b, sq, h, d)
        o, lse = flash_attention_fwd(fq, fk, fv, causal)
        torch.cuda.synchronize()
        ro, rlse = flash_attention_fwd_ref(fq, fk, fv, causal)
        torch.cuda.synchronize()
        diff = o.float() - ro.float()
        e_out = diff.abs().max().item()
        e_lse = (lse - rlse).abs().max().item()
        e_tile = worst_tile_rel_l2(diff, ro)
        ok = (torch.allclose(o.float(), ro.float(), atol=5e-2, rtol=5e-2) and e_lse <= 5e-2
              and e_tile <= FWD_TILE_REL_L2)
        log(f"[kernels] flash_fwd B{b} S{sq} H{h} D{d} causal={causal}: "
            f"max|out| err {e_out:.3e}, max|lse| err {e_lse:.3e}, worst tile rel L2 {e_tile:.3e} "
            f"(bars atol=rtol=5e-2, tile rel L2 <= {FWD_TILE_REL_L2})")
        if not ok:
            raise AssertionError(f"flash_fwd disagrees with its plain version at {(b, sq, h, d, causal)}")
        worst = max(worst, e_out)
    fq, fk, fv = qkv(1, 2048, 32, 128)
    b, sq, h, d = fq.shape
    flops = 4 * b * h * d * (sq * (sq + 1) // 2)  # QKᵀ and PV over the causal triangle
    io_bytes = 4 * fq.numel() * 2 + b * h * sq * 4
    qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (fq, fk, fv))
    with _sdpa_cudnn(torch):
        t = time_turns(torch, {
            "kernel": lambda: flash_attention_fwd(fq, fk, fv, True),
            "library": lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=True),
        }, 20)
    k1 = _timed(
        t["kernel"], t["library"],
        plain_ms=time_ms(torch, lambda: flash_attention_fwd_ref(fq, fk, fv, True), 5),
        bound_ms=max(flops / BF16_FLOPS, io_bytes / HBM_BYTES_PER_S) * 1e3,
        bound_by="operations" if flops / BF16_FLOPS >= io_bytes / HBM_BYTES_PER_S else "bytes",
        max_abs_err=worst,
    )
    results["flash_fwd"] = k1
    log(f"[kernels] flash_fwd kernel_ms={_spread(t['kernel'])} plain_ms={k1['plain_ms']:.4f} "
        f"bound_ms={k1['bound_ms']:.4f} library_ms={_spread(t['library'])} "
        f"(median [min, max] of {TIMING_ROUNDS} rounds; B1 S2048 H32 D128 causal, {flops / 1e9:.1f} GFLOP)")
    del qt, kt, vt
    _flash_bwd_kernels(torch, gen, qkv, results)
    _build.reset_launches()  # comparison launches do not count toward any path


def _k4_measure(torch, gen, shape, label: str) -> dict:
    """K4 at `shape`: checked against its plain version at the serving
    lengths (spread over 1..4096, slot 3 inactive) and at q_pos on and
    around its chunk boundaries and at the span's end; then timed warm (in
    turns with SDPA over the pre-gathered span), cold, and as the plain
    version, beside the bound of the live KV bytes."""
    from modal_tpu_torch.ops.paged_attention import (
        DECODE_CHUNK,
        paged_decode_attention,
        paged_decode_attention_ref,
    )

    F = torch.nn.functional
    q, kp, vp = _k4_pages(torch, gen, shape)
    s, n_kv, n_rep, hd = q.shape
    span = shape[4] * shape[5]
    pt, sl = _k4_tables(torch, gen, shape, [0, 4095, 1, 0, 2047, 517, 3000, 100], inactive=[3])
    live = [i for i in range(s) if i != 3]
    err = _k4_check(torch, f"{label} serving lengths", q, kp, vp, pt, sl, live)
    bpt, bsl = _k4_tables(torch, gen, shape, [0, DECODE_CHUNK - 1, DECODE_CHUNK, DECODE_CHUNK + 1, span - 1,
                                               2 * DECODE_CHUNK - 1, 2 * DECODE_CHUNK, 16 * DECODE_CHUNK + 1])
    err = max(err, _k4_check(torch, f"{label} chunk boundaries", q, kp, vp, bpt, bsl, list(range(s))))
    del bpt, bsl
    live_tokens = sum(int(sl[i]) + 1 for i in live)
    kv_bytes = live_tokens * n_kv * hd * 2 * 2  # K and V rows each read once, bf16
    io_bytes = 2 * q.numel() * 2 + pt.numel() * 4 + sl.numel() * 4
    flops = 4 * live_tokens * n_kv * n_rep * hd
    bound = max((kv_bytes + io_bytes) / HBM_BYTES_PER_S, flops / BF16_FLOPS) * 1e3
    # library yardstick: SDPA over the pre-gathered, head-repeated span
    idx = pt.long()
    k_att = kp[idx].reshape(s, span, n_kv, hd).repeat_interleave(n_rep, dim=2).transpose(1, 2).contiguous()
    v_att = vp[idx].reshape(s, span, n_kv, hd).repeat_interleave(n_rep, dim=2).transpose(1, 2).contiguous()
    q_sd = q.reshape(s, n_kv * n_rep, 1, hd)
    vis = (torch.arange(span, device="cuda")[None, :] <= sl.long()[:, None])[:, None, None, :]
    t = time_turns(torch, {
        "kernel": lambda: paged_decode_attention(q, kp, vp, pt, sl),
        "library": lambda: F.scaled_dot_product_attention(q_sd, k_att, v_att, attn_mask=vis),
    }, 50)
    cold = time_cold_ms(torch, lambda: paged_decode_attention(q, kp, vp, pt, sl))
    k4 = _timed(t["kernel"], t["library"], cold_ms=cold,
                plain_ms=time_ms(torch, lambda: paged_decode_attention_ref(q, kp, vp, pt, sl), 10))
    del k_att, v_att
    k4.update(bound_ms=bound, bound_by="bytes" if (kv_bytes + io_bytes) / HBM_BYTES_PER_S >= flops / BF16_FLOPS else "operations",
              max_abs_err=err, shape=list(shape))
    log(f"[kernels] paged_decode {label} (S {s}, n_kv {n_kv}, n_rep {n_rep}, hd {hd}) kernel_ms "
        f"warm={_spread(t['kernel'])} cold={cold:.4f} plain_ms={k4['plain_ms']:.4f} "
        f"bound_ms={k4['bound_ms']:.4f} ({k4['ms'] / k4['bound_ms']:.2f}x) library_ms={_spread(t['library'])} "
        f"(warm: median [min, max] of {TIMING_ROUNDS} rounds of 50 back-to-back calls; cold: median of 20 "
        f"calls after a 256 MB write; live KV {kv_bytes / 1e6:.1f} MB over {live_tokens} tokens)")
    return k4


def _flash_bwd_kernels(torch, gen, qkv, results: dict) -> None:
    """K2 and K3 against the plain backward at the training path's shape
    (B1 S2048 H32 D128 causal) and the others of FLASH_SHAPES, then timed at the training
    shape. Bars on dQ, dK and dV: max|kernel − plain| < 0.35 (the JAX
    package's bf16 backward bar, bench.py:193-195) and relative L2 ≤ 1e-2
    on every 64-row tile of every (batch, head). Typical gradient entries
    are ~0.05, so the max bar alone would pass a tile skipped for late rows;
    the tile bar does not."""
    from modal_tpu_torch.ops.attention import (
        BWD_TILE_REL_L2,
        flash_attention_bwd_ref,
        flash_attention_delta,
        flash_attention_fwd,
        flash_bwd_dkv,
        flash_bwd_dq,
        worst_tile_rel_l2,
    )

    F = torch.nn.functional
    worst = {"flash_bwd_dq": 0.0, "flash_bwd_dkv": 0.0}
    for (b, sq, h, d, causal) in FLASH_SHAPES:
        q, k, v = qkv(b, sq, h, d)
        do = torch.randn((b, sq, h, d), generator=gen, device="cuda").to(torch.bfloat16)
        out, lse = flash_attention_fwd(q, k, v, causal)
        delta = flash_attention_delta(out, do)
        dq = flash_bwd_dq(q, k, v, do, lse, delta, causal)
        dk, dv = flash_bwd_dkv(q, k, v, do, lse, delta, causal)
        torch.cuda.synchronize()
        ref = flash_attention_bwd_ref(q, k, v, out, lse, do, causal)
        errs = {}
        for name, g, r in (("dq", dq, ref[0]), ("dk", dk, ref[1]), ("dv", dv, ref[2])):
            diff = g.float() - r
            errs[name] = (diff.abs().max().item(), (diff.norm() / r.norm()).item(), worst_tile_rel_l2(diff, r))
        log(f"[kernels] flash_bwd B{b} S{sq} H{h} D{d} causal={causal}: "
            + ", ".join(f"{n} max|err| {e[0]:.3e} rel L2 {e[1]:.3e} (worst tile {e[2]:.3e})" for n, e in errs.items())
            + f" (bars max|err| < 0.35, tile rel L2 <= {BWD_TILE_REL_L2})")
        if not all(e[0] < 0.35 and e[2] <= BWD_TILE_REL_L2 for e in errs.values()):
            raise AssertionError(f"flash backward disagrees with its plain version at {(b, sq, h, d, causal)}")
        worst["flash_bwd_dq"] = max(worst["flash_bwd_dq"], errs["dq"][0])
        worst["flash_bwd_dkv"] = max(worst["flash_bwd_dkv"], errs["dk"][0], errs["dv"][0])
        del ref
    q, k, v = qkv(1, 2048, 32, 128)
    do = torch.randn(q.shape, generator=gen, device="cuda").to(torch.bfloat16)
    out, lse = flash_attention_fwd(q, k, v, True)
    delta = flash_attention_delta(out, do)
    b, sq, h, d = q.shape
    matmul_flops = 2 * b * h * d * (sq * (sq + 1) // 2)  # one product over the causal triangle
    tile = q.numel() * 2
    stats = 2 * b * h * sq * 4  # lse and delta
    plain_ms = time_ms(torch, lambda: flash_attention_bwd_ref(q, k, v, out, lse, do, True), 3)
    # library yardstick: SDPA's backward (cuDNN) through autograd, one call
    # for dQ, dK and dV together, so both rows carry the same time
    qt, kt, vt = (t.transpose(1, 2).contiguous().requires_grad_() for t in (q, k, v))
    do_sd = do.transpose(1, 2).contiguous()
    with _sdpa_cudnn(torch):
        o_sd = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True)
        t = time_turns(torch, {
            "flash_bwd_dq": lambda: flash_bwd_dq(q, k, v, do, lse, delta, True),
            "flash_bwd_dkv": lambda: flash_bwd_dkv(q, k, v, do, lse, delta, True),
            "library": lambda: torch.autograd.grad(o_sd, (qt, kt, vt), do_sd, retain_graph=True),
        }, 20)
    for name, n_mm, io_bytes in (("flash_bwd_dq", 3, 5 * tile + stats), ("flash_bwd_dkv", 4, 6 * tile + stats)):
        flops = n_mm * matmul_flops
        results[name] = _timed(
            t[name], t["library"], plain_ms=plain_ms,
            bound_ms=max(flops / BF16_FLOPS, io_bytes / HBM_BYTES_PER_S) * 1e3,
            bound_by="operations" if flops / BF16_FLOPS >= io_bytes / HBM_BYTES_PER_S else "bytes",
            max_abs_err=worst[name],
        )
        m = results[name]
        log(f"[kernels] {name} kernel_ms={_spread(t[name])} "
            f"plain_ms={m['plain_ms']:.4f} (whole plain backward) bound_ms={m['bound_ms']:.4f} "
            f"library_ms={_spread(t['library'])} (SDPA backward, dQ+dK+dV; median [min, max] of "
            f"{TIMING_ROUNDS} rounds) (B1 S2048 H32 D128 causal, {flops / 1e9:.1f} GFLOP)")


def _load_8b(torch, ctx: dict):
    if "params" not in ctx:
        from modal_tpu_torch.models.llama import get_config, init_params

        cfg = get_config("llama3-8b")
        t0 = time.perf_counter()
        ctx["params"] = init_params(cfg, seed=0, device="cuda")
        torch.cuda.synchronize()
        ctx["cfg"] = cfg
        log(f"[serve] llama3-8b random params (seed 0) in {time.perf_counter() - t0:.1f}s, "
            f"{torch.cuda.memory_allocated() / 1e9:.2f} GB on the card")
    return ctx["params"], ctx["cfg"]


def _prompts(cfg, n: int, seed: int):
    import numpy as np

    rng = np.random.default_rng(seed)
    lens = rng.integers(100, 601, size=n)
    return [rng.integers(0, cfg.vocab_size, size=int(ln)).tolist() for ln in lens]


# the serving traffic of the serve, spec and disagg phases: 8 requests of 64
# new tokens, requests 5 and 7 sampled (T 0.8, top-p 0.9), seeds 1000 + i
NEW_TOKENS = 64
SAMPLED = (5, 7)
# the self-draft's near-tie bar: a greedy proposal may be rejected only this
# far below the target's best logit, a sampled one only where the draft's and
# the target's logits of the two contested tokens differ by this much in all.
# It is the kernel-vs-gather gap of llama3-8b's logits at 32 layers, 2.71e-1
# (PERF.md, parity phase), rounded up; a draft cache off by a position
# proposes tokens several logit std (~1) below the target's best
SELF_DRAFT_TIE = 0.3


def _traffic(i: int) -> dict:
    sampled = i in SAMPLED
    return {"temperature": 0.8 if sampled else 0.0, "top_p": 0.9 if sampled else 1.0, "seed": 1000 + i}


def _engine_8b(params, cfg, **kw):
    """The serving engine of the serve, spec and disagg phases: 8 slots,
    page 16, prefill chunk 128, the default pool (2048 pages)."""
    from modal_tpu_torch.serving import ServingEngine

    engine = ServingEngine(params, cfg, max_slots=8, page_size=16, prefill_chunk=128, device="cuda", **kw)
    if engine.attn_impl != "kernel":
        raise AssertionError(f"engine on CUDA chose attn_impl={engine.attn_impl!r}")
    return engine


def _check_streams(label: str, outs, vocab_size: int) -> None:
    for i, out in enumerate(outs):
        if len(out) != NEW_TOKENS or not all(0 <= t < vocab_size for t in out):
            raise AssertionError(f"{label}: request {i} returned {len(out)} tokens (or one out of the vocabulary)")


def _run_traffic(engine, prompts, vocab_size: int, label: str):
    """Start `engine`, submit the serving traffic over `prompts`, wait for
    every stream, stop it. Returns (streams, requests, wall s, stats)."""
    t0 = time.perf_counter()
    engine.start()
    try:
        reqs = [engine.submit(p, NEW_TOKENS, **_traffic(i)) for i, p in enumerate(prompts)]
        outs = [r.result(timeout=600) for r in reqs]
        wall = time.perf_counter() - t0
    finally:
        engine.stop()  # joins the loop: the last iteration's counters are in
    _check_streams(label, outs, vocab_size)
    return outs, reqs, wall, engine.stats()


def _pcts(values) -> tuple[float, float]:
    ordered = sorted(values)
    pct = lambda p: ordered[min(len(ordered) - 1, int(p * len(ordered)))]  # noqa: E731
    return pct(0.5), pct(0.95)


def _add_launches(ctx: dict, name: str, n: int) -> None:
    launches = ctx.setdefault("launches", {})
    launches[name] = launches.get(name, 0) + n


def _graph_line(engine) -> str:
    g = engine.decode_graph
    return (f"decode graph: pool {g.pool_bytes / 1e6:.1f} MB, warm-up + capture {g.capture_s:.2f}s, "
            f"launches per replay {g.graph.launches}")


def _keep_decode_logits(engine, engine_mod) -> tuple:
    """Keep each decoding slot's logits row of every decode step of
    `engine`, keyed by (request id, index of the token the row decides).
    Returns (the dict, a function that undoes the wrapping)."""
    kept: dict = {}

    def keep(logits):
        for i, s in engine._decoding():
            kept[(s.request.id, len(s.request.tokens))] = logits[i].clone()

    if engine.decode_graph is not None:
        graph = engine.decode_graph

        def graphed(tokens, active):
            out = graph(tokens, active)
            keep(out[0])
            return out

        engine.decode_graph = graphed
        return kept, lambda: setattr(engine, "decode_graph", graph)
    step = engine_mod.paged_decode_step

    def eager(*args):
        out = step(*args)
        keep(out[0])
        return out

    engine_mod.paged_decode_step = eager
    return kept, lambda: setattr(engine_mod, "paged_decode_step", step)


def phase_serve(torch, ctx: dict) -> None:
    from modal_tpu_torch.ops import _build
    from modal_tpu_torch.serving import asgi_request, serving_asgi_app
    from modal_tpu_torch.serving import engine as engine_mod

    params, cfg = _load_8b(torch, ctx)
    engine = _engine_8b(params, cfg)
    if engine.decode_graph is None:
        raise AssertionError("the engine on CUDA did not capture its decode step")
    log(f"[serve] engine: attn_impl={engine.attn_impl} pages={engine.allocator.num_pages - 1} "
        f"pool {engine.cache.pool_bytes() / 1e9:.2f} GB; {_graph_line(engine)}")
    prompts = _prompts(cfg, 8, seed=1)
    kept, unwrap = _keep_decode_logits(engine, engine_mod)
    _build.reset_launches()
    t0 = time.perf_counter()
    engine.start()
    try:
        app = serving_asgi_app(engine)
        reqs = [engine.submit(p, NEW_TOKENS, **_traffic(i)) for i, p in enumerate(prompts[1:], start=1)]
        status, body = asyncio.run(asgi_request(
            app, "POST", "/v1/generate", {"prompt": prompts[0], "max_new_tokens": NEW_TOKENS, **_traffic(0)}
        ))
        outs = [r.result(timeout=600) for r in reqs]
        wall = time.perf_counter() - t0
    finally:
        engine.stop()  # joins the loop: the last iteration's counters are in
        unwrap()
    launches = dict(_build.LAUNCHES)
    stats = engine.stats()
    if status != 200:
        raise AssertionError(f"/v1/generate answered {status}: {body[:300]!r}")
    api = json.loads(body)
    streams = [api["tokens"]] + outs
    ids = [api["request_id"]] + [r.id for r in reqs]
    ctx["serve_logits"] = {(i, n): row for (rid, n), row in kept.items() for i in [ids.index(rid)]}
    ctx["serve_graph"] = {"pool_bytes": engine.decode_graph.pool_bytes, "capture_s": engine.decode_graph.capture_s}
    _check_streams("serve", streams, cfg.vocab_size)
    steps = stats["steps"]
    if launches["paged_decode"] != cfg.n_layers * steps or steps == 0:
        raise AssertionError(
            f"paged_decode launched {launches['paged_decode']} times over {steps} decode steps "
            f"({cfg.n_layers} layers)"
        )
    p50, p95 = _pcts([api["ttft_s"]] + [r.ttft_s for r in reqs])
    _add_launches(ctx, "paged_decode", launches["paged_decode"])
    ctx["serve_streams"] = streams
    ctx["serve"] = {
        "requests": 8, "new_tokens": NEW_TOKENS, "decode_steps": steps,
        "tokens_generated": stats["tokens_generated"], "wall_s": wall,
        "tokens_per_s": 8 * NEW_TOKENS / wall,
        "ttft_p50_s": p50, "ttft_p95_s": p95, "preemptions": stats["preemptions"],
        "prompt_tokens": sum(len(p) for p in prompts), "launches": launches,
    }
    log(f"[serve] 8 requests x {NEW_TOKENS} tokens in {wall:.2f}s: "
        f"{ctx['serve']['tokens_per_s']:.1f} tokens/s, steps={steps}, "
        f"TTFT p50 {p50:.3f}s p95 {p95:.3f}s, launches={launches} (= {cfg.n_layers} x {steps} graph replays)")


def _sdk_serving_fn(cfg_name: str, seed: int, prompts: list):
    """The serving function the sdk phase ships to a fresh interpreter. It
    is defined in this script's __main__, so the port's cloudpickle takes it
    by value, as it takes a user's script function, together with the
    helpers it calls (`_engine_8b`, `_run_traffic` and the traffic they
    hold); it closes over the config name, the seed and the prompts."""

    def serve() -> dict:
        import hashlib

        import torch

        from modal_tpu_torch.models.llama import get_config, init_params
        from modal_tpu_torch.ops import _build

        cfg = get_config(cfg_name)
        engine = _engine_8b(init_params(cfg, seed=seed, device="cuda"), cfg)
        if engine.decode_graph is None:
            raise AssertionError("the engine on CUDA did not capture its decode step")
        graph, last = engine.decode_graph, {}

        def keep_last(tokens, active):
            out = graph(tokens, active)
            last["logits"] = out[0].clone()
            return out

        engine.decode_graph = keep_last
        _build.reset_launches()
        streams, _reqs, wall, stats = _run_traffic(engine, prompts, cfg.vocab_size, "sdk child")
        logits = last["logits"]
        print(f"logits sha256 {hashlib.sha256(logits.cpu().numpy().tobytes()).hexdigest()}", flush=True)
        return {"streams": streams, "logits": logits, "paged_decode_launches": _build.LAUNCHES["paged_decode"],
                "decode_steps": stats["steps"], "n_layers": cfg.n_layers, "wall_s": wall,
                "device": torch.cuda.get_device_name(0)}

    return serve


# the fresh interpreter of the sdk phase: argv = function file, result file, repo
SDK_CHILD = """
import json, sys, time
sys.path.insert(0, sys.argv[3])
from modal_tpu_torch.serialization import deserialize, serialize_payload
with open(sys.argv[1], "rb") as f:
    blob = f.read()
t0 = time.perf_counter()
fn = deserialize(blob)
load_ms = (time.perf_counter() - t0) * 1e3
result = fn()
t0 = time.perf_counter()
payload = serialize_payload(result)
serialize_ms = (time.perf_counter() - t0) * 1e3
with open(sys.argv[2], "wb") as f:
    for seg in payload.segments:
        f.write(seg)
print(json.dumps({"fn_deserialize_ms": load_ms, "result_serialize_ms": serialize_ms,
                  "result_bytes": payload.nbytes}), flush=True)
"""
# the largest pickle stream a tensor payload may carry: its bytes ride out of band
SDK_STREAM_BOUND = 4096


def _stream_len(frame) -> int:
    from modal_tpu_torch.serialization import _OOB_HEAD, OOB_MAGIC

    return _OOB_HEAD.unpack_from(frame, 0)[2] if bytes(frame[:4]) == OOB_MAGIC else len(frame)


def phase_sdk(torch, ctx: dict) -> None:
    import hashlib
    import tempfile
    import threading

    from modal_tpu_torch.gpu_config import from_proto, parse_gpu_config
    from modal_tpu_torch.models.llama import get_config
    from modal_tpu_torch.proto import api_pb2
    from modal_tpu_torch.serialization import deserialize, serialize, serialize_payload

    smi = ctx.get("nvidia_smi") or _nvidia_smi()
    kind, count = torch.cuda.get_device_name(0), torch.cuda.device_count()
    spec = parse_gpu_config("H100")
    wire = spec.to_proto().SerializeToString()
    back = from_proto(api_pb2.GPUConfig.FromString(wire))
    if back != spec or not spec.matches_device(kind) or spec.count > count:
        raise AssertionError(f"sdk: gpu='H100' gave {spec} -> {wire!r} -> {back}; the card is {kind!r} x {count}")
    log(f"[sdk] gpu='H100' -> {spec!r} -> GPUConfig {wire!r} -> {back}: matches {kind!r} (count {count})")

    cfg = get_config("llama3-8b")
    prompts = _prompts(cfg, 8, seed=1)
    fn = _sdk_serving_fn("llama3-8b", 0, prompts)
    t0 = time.perf_counter()
    blob = serialize(fn)
    fn_serialize_ms = (time.perf_counter() - t0) * 1e3
    torch.cuda.empty_cache()  # the child builds its own 16 GB of params beside ours
    visible = os.environ.get("CUDA_VISIBLE_DEVICES", str(torch.cuda.current_device())).split(",")[0]
    with tempfile.TemporaryDirectory(prefix="sdk-") as tmp:
        fn_path, out_path = os.path.join(tmp, "fn.pkl"), os.path.join(tmp, "result.bin")
        with open(fn_path, "wb") as f:
            f.write(blob)
        t_spawn = time.perf_counter()
        proc = subprocess.run([sys.executable, "-c", SDK_CHILD, fn_path, out_path, REPO],
                              env={**os.environ, "CUDA_VISIBLE_DEVICES": visible}, capture_output=True, text=True,
                              timeout=900)
        child_s = time.perf_counter() - t_spawn
        lines = proc.stdout.strip().splitlines()
        for ln in lines[:-1]:
            log(f"[sdk:child] {ln}")
        if proc.returncode != 0 or not lines:
            raise AssertionError(f"sdk: the child exited {proc.returncode}:\n{proc.stderr[-4000:]}")
        child = json.loads(lines[-1])
        digests = [ln.split()[-1] for ln in lines if ln.startswith("logits sha256 ")]
        with open(out_path, "rb") as f:
            data = f.read()
    t0 = time.perf_counter()
    result = deserialize(data)
    result_deserialize_ms = (time.perf_counter() - t0) * 1e3
    logits, streams = result["logits"], result["streams"]
    steps, k4 = result["decode_steps"], result["paged_decode_launches"]
    if len(digests) != 1:
        raise AssertionError(f"sdk: the child printed {len(digests)} logits digests")
    _check_streams("sdk", streams, cfg.vocab_size)
    if len(streams) != 8:
        raise AssertionError(f"sdk: {len(streams)} of 8 requests completed")
    if (type(logits) is not torch.Tensor or logits.device.type != "cpu" or logits.dtype != torch.float32
            or tuple(logits.shape) != (8, cfg.vocab_size)):
        raise AssertionError(f"sdk: logits came back as {type(logits)} {getattr(logits, 'device', '')} "
                             f"{getattr(logits, 'dtype', '')} {tuple(getattr(logits, 'shape', ()))}")
    got_digest = hashlib.sha256(logits.numpy().tobytes()).hexdigest()
    if got_digest != digests[0] or not torch.isfinite(logits).all():
        raise AssertionError(f"sdk: logits sha256 {got_digest} here, {digests[0]} in the child (or not finite)")
    if result["n_layers"] != cfg.n_layers or steps == 0 or k4 != cfg.n_layers * steps:
        raise AssertionError(f"sdk: paged_decode launched {k4} times over {steps} decode steps "
                             f"({result['n_layers']} layers)")
    stream_bytes = _stream_len(data)
    if stream_bytes >= SDK_STREAM_BOUND:
        raise AssertionError(f"sdk: the result's pickle stream is {stream_bytes} bytes (the logits went in band)")
    equal = None
    if "serve_streams" in ctx:
        # the child keeps no logits of its own: a greedy stream may differ
        # only at a near-tie of the serve phase's row, a sampled one not at all
        diverged = _first_divergence(ctx["serve_streams"], streams, ctx.get("serve_logits", {}), {})
        for d in diverged:
            log(f"[sdk] request {d['request']} ({'sampled' if d['sampled'] else 'greedy'}) differs from the serve "
                f"phase first at token {d['token']}: serve's logit of its token over the child's {d['gap']:.4f}, "
                f"serve's top-2 gap {d['top2_gap']:.4f} (a greedy stream may differ only at a gap <= "
                f"{SELF_DRAFT_TIE})")
        bad = [d for d in diverged if d["sampled"] or d["gap"] > SELF_DRAFT_TIE]
        if bad:
            raise AssertionError(f"sdk: streams differ from the serve phase's beyond a greedy near-tie: {bad}")
        equal = 8 - len(diverged)
    _add_launches(ctx, "paged_decode", k4)
    log(f"[sdk] serialized llama3-8b serving function: {len(blob)} bytes (serialize {fn_serialize_ms:.2f} ms here, "
        f"deserialize {child['fn_deserialize_ms']:.2f} ms in the child); the child (one card visible, "
        f"{result['device']}) served 8 requests x {NEW_TOKENS} tokens in {result['wall_s']:.2f}s, {steps} decode "
        f"steps, paged_decode launches {k4} (= {cfg.n_layers} x {steps}); its result: {child['result_bytes']} "
        f"payload bytes, pickle stream {stream_bytes} bytes, serialize {child['result_serialize_ms']:.2f} ms "
        f"there, deserialize {result_deserialize_ms:.2f} ms here; logits [8, {cfg.vocab_size}] fp32 back on the "
        f"CPU, sha256 equal; streams equal to serve's: {'serve not run' if equal is None else f'{equal}/8'}; "
        f"child process {child_s:.1f}s | {smi}")

    params, _cfg = _load_8b(torch, ctx)
    embed = params["embed"]
    nbytes = embed.numel() * embed.element_size()
    torch.cuda.synchronize()
    base_rss = _rss_bytes()
    peak, stop = [base_rss], threading.Event()
    sampler = threading.Thread(target=_sample_peak_rss, args=(peak, stop), daemon=True)
    sampler.start()
    try:
        t0 = time.perf_counter()
        payload = serialize_payload(embed)
        t1 = time.perf_counter()
        frame = payload.join()
        t2 = time.perf_counter()
        restored = deserialize(frame)
        t3 = time.perf_counter()
    finally:
        stop.set()
        sampler.join()
    peak_rss = max(peak[0], _rss_bytes())
    stream_bytes = _stream_len(frame)
    on_card = restored.to("cuda")
    same = (restored.dtype == embed.dtype and restored.shape == embed.shape and restored.device.type == "cpu"
            and torch.equal(on_card.view(torch.int16), embed.view(torch.int16)))
    del payload, frame, restored, on_card
    if not same or stream_bytes >= SDK_STREAM_BOUND:
        raise AssertionError(f"sdk: the embedding payload came back equal={same}, pickle stream {stream_bytes} bytes")
    # the reducer's copy to the host (pinned staging, in serialize_payload)
    # against one pageable `.cpu()`, alternated, two of each
    host_copy_s: dict = {"cpu": [], "serialize_payload": []}
    for _ in range(2):
        for name, copy in (("cpu", embed.cpu), ("serialize_payload", lambda: serialize_payload(embed))):
            torch.cuda.synchronize()
            t_copy = time.perf_counter()
            out = copy()
            torch.cuda.synchronize()
            host_copy_s[name].append(time.perf_counter() - t_copy)
            del out
    ser_s, de_s = t2 - t0, t3 - t2
    large = {"bytes": nbytes, "stream_bytes": stream_bytes, "serialize_payload_s": t1 - t0, "join_s": t2 - t1,
             "serialize_gbps": nbytes / ser_s / 1e9, "deserialize_s": de_s, "deserialize_gbps": nbytes / de_s / 1e9,
             "rss_before_bytes": base_rss, "peak_rss_bytes": peak_rss, "host_copy_s": host_copy_s}
    log(f"[sdk] llama3-8b embedding [{embed.shape[0]}, {embed.shape[1]}] bf16 on the card, {nbytes / 1e9:.3f} GB: "
        f"serialize_payload {t1 - t0:.3f}s (pinned staging) + join {t2 - t1:.3f}s = {large['serialize_gbps']:.2f} "
        f"GB/s; deserialize {de_s:.3f}s = {large['deserialize_gbps']:.2f} GB/s; bit-equal; pickle stream "
        f"{stream_bytes} bytes; host RSS {base_rss / 1e9:.2f} GB before, peak {peak_rss / 1e9:.2f} GB (sampled every "
        f"10 ms) | {smi}")
    log(f"[sdk] the embedding to the host, alternated: .cpu() {host_copy_s['cpu']} s, serialize_payload "
        f"(pinned staging) {host_copy_s['serialize_payload']} s | {smi}")
    ctx["sdk"] = {
        "gpu": {"spec": str(spec), "wire": wire.hex(), "device": kind, "count": count},
        "function": {"bytes": len(blob), "serialize_ms": fn_serialize_ms, **child, "child_s": child_s,
                     "result_deserialize_ms": result_deserialize_ms, "wall_s": result["wall_s"],
                     "result_stream_bytes": stream_bytes, "decode_steps": steps, "paged_decode_launches": k4,
                     "streams_equal": equal,
                     "logits_sha256": got_digest},
        "large_payload": large, "nvidia_smi": smi,
    }


def _first_divergence(want, got, want_logits: dict, got_logits: dict) -> list:
    """For each stream of `got` that differs from `want`: the first differing
    token and the two modes' logits there. A greedy row may differ only at a
    near-tie of the reference's logits (gap logit(a) − logit(b) of its token
    a over the other's b, beside the reference's top-2 gap); a sampled row
    only where the two rows' logits of the two tokens differ by at most the
    bar in all (the deviation). A row that was not kept gives inf."""
    out = []
    for i, (a_stream, b_stream) in enumerate(zip(want, got)):
        if a_stream == b_stream:
            continue
        j = next(j for j, (x, y) in enumerate(zip(a_stream, b_stream)) if x != y)
        a, b = a_stream[j], b_stream[j]
        # the prefill's token has no kept row: both modes prefill eagerly
        ref, row = want_logits.get((i, j)), got_logits.get((i, j))
        d = {"request": i, "token": j, "sampled": i in SAMPLED, "gap": math.inf, "top2_gap": math.inf,
             "deviation": math.inf}
        if ref is not None:
            best = ref.topk(2).values
            d["gap"], d["top2_gap"] = (ref[a] - ref[b]).item(), (best[0] - best[1]).item()
        if ref is not None and row is not None:
            d["deviation"] = ((ref[a] - row[a]).abs() + (ref[b] - row[b]).abs()).item()
        out.append(d)
    return out


def _decode_step_times(torch, params, cfg, graphs: bool, steps: int = 16) -> dict:
    """One engine decode step (`_decode_step`: the step, the sampling of the
    two sampled rows, the read-back and the host bookkeeping) at 8 slots
    after the serving prompts' prefill, graphed or eager: wall ms per step
    (host clock, each step ends in its read-back), device ms per step (the
    kernels' self time under torch.profiler over `steps` more steps), busy
    share = device / wall, and decode tokens/s at 8 slots."""
    import gc

    engine = _engine_8b(params, cfg, cuda_graphs=graphs)
    for i, p in enumerate(_prompts(cfg, 8, seed=1)):
        engine.submit(p, 3 * steps + 8, **_traffic(i))
    engine._admit()
    while any(s is not None and s.state == "prefill" for s in engine.slots):
        engine._prefill_one()
    for _ in range(4):
        engine._decode_step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        engine._decode_step()
    wall = (time.perf_counter() - t0) / steps * 1e3
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        t1 = time.perf_counter()
        for _ in range(steps):
            engine._decode_step()
        torch.cuda.synchronize()
        window = (time.perf_counter() - t1) / steps * 1e3
    busy_us = sum(float(getattr(e, "self_device_time_total", getattr(e, "self_cuda_time_total", 0.0)))
                  for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA)
    device = busy_us / 1e3 / steps
    out = {"wall_ms": wall, "device_ms": device, "profiled_wall_ms": window, "busy_share": device / window,
           "tokens_per_s": 8 * 1e3 / wall, "q_pos": [s.pos for s in engine.slots if s is not None]}
    if graphs:
        out.update(pool_bytes=engine.decode_graph.pool_bytes, capture_s=engine.decode_graph.capture_s)
    engine.stop()
    del engine
    gc.collect()
    torch.cuda.empty_cache()
    return out


def phase_graphs(torch, ctx: dict) -> None:
    from modal_tpu_torch.ops import _build
    from modal_tpu_torch.serving import engine as engine_mod

    params, cfg = _load_8b(torch, ctx)
    prompts = _prompts(cfg, 8, seed=1)
    runs = {}
    modes = ((True, "graphed"), (False, "eager")) if "serve_streams" not in ctx else ((False, "eager"),)
    for graphs, name in modes:
        engine = _engine_8b(params, cfg, cuda_graphs=graphs)
        kept, unwrap = _keep_decode_logits(engine, engine_mod)
        _build.reset_launches()
        try:
            outs, reqs, wall, st = _run_traffic(engine, prompts, cfg.vocab_size, f"graphs {name}")
        finally:
            unwrap()
        launches = _build.LAUNCHES["paged_decode"]
        if launches != cfg.n_layers * st["steps"] or st["steps"] == 0:
            raise AssertionError(f"graphs {name}: paged_decode launched {launches} times over {st['steps']} steps")
        ids = [r.id for r in reqs]
        runs[name] = {"streams": outs, "logits": {(ids.index(rid), n): row for (rid, n), row in kept.items()},
                      "wall_s": wall, "tokens_per_s": 8 * NEW_TOKENS / wall, "steps": st["steps"],
                      "paged_decode_launches": launches}
        log(f"[graphs] {name} engine: {8 * NEW_TOKENS} tokens in {wall:.2f}s ({8 * NEW_TOKENS / wall:.1f} tokens/s), "
            f"steps {st['steps']}, paged_decode launches {launches} (= {cfg.n_layers} x steps)")
        del engine
    graphed = runs.get("graphed") or {"streams": ctx["serve_streams"], "logits": ctx.pop("serve_logits")}
    diverged = _first_divergence(graphed["streams"], runs["eager"]["streams"], graphed["logits"], runs["eager"]["logits"])
    for d in diverged:
        log(f"[graphs] request {d['request']} ({'sampled' if d['sampled'] else 'greedy'}) differs first at token "
            f"{d['token']}: graphed-logit gap {d['gap']:.4f}, graphed-vs-eager deviation {d['deviation']:.4f} "
            f"(bar {SELF_DRAFT_TIE} on the greedy gap and the sampled deviation)")
    bad = [d for d in diverged if (d["deviation"] if d["sampled"] else d["gap"]) > SELF_DRAFT_TIE]
    if bad:
        raise AssertionError(f"graphs: streams differ beyond a near-tie between graphed and eager decode: {bad}")
    for run in runs.values():
        run.pop("logits")
    steps = {name: _decode_step_times(torch, params, cfg, graphs) for graphs, name in ((True, "graphed"), (False, "eager"))}
    for name, m in steps.items():
        log(f"[graphs] {name} decode step (8 slots, q_pos {min(m['q_pos'])}-{max(m['q_pos'])}): wall "
            f"{m['wall_ms']:.2f} ms, device {m['device_ms']:.2f} ms, busy share {m['busy_share']:.3f}, "
            f"{m['tokens_per_s']:.1f} decode tokens/s"
            + (f"; graph pool {m['pool_bytes'] / 1e6:.1f} MB, warm-up + capture {m['capture_s']:.2f}s"
               if name == "graphed" else ""))
    ctx["graphs"] = {"runs": {k: {kk: vv for kk, vv in v.items() if kk != "streams"} for k, v in runs.items()},
                     "streams_equal": 8 - len(diverged), "diverged": diverged, "decode_step": steps}
    ctx["bf16_decode_step"] = steps["graphed"]
    _add_launches(ctx, "paged_decode", sum(r["paged_decode_launches"] for r in runs.values()))
    log(f"[graphs] streams equal between graphed and eager decode: {8 - len(diverged)}/8; decode step "
        f"{steps['eager']['wall_ms']:.2f} -> {steps['graphed']['wall_ms']:.2f} ms wall "
        f"({steps['eager']['wall_ms'] / steps['graphed']['wall_ms']:.2f}x)")


def _host_room() -> str:
    """The host's available memory and the temp dir's free space (what a
    phase left behind shows here in the next phase's line)."""
    import tempfile

    avail = "not read"
    try:
        with open("/proc/meminfo") as f:
            for line in f:
                if line.startswith("MemAvailable:"):
                    avail = f"{int(line.split()[1]) / 1e6:.1f} GB"
    except OSError:
        pass
    return f"host memory available {avail}, {tempfile.gettempdir()} free {_free_bytes(tempfile.gettempdir()) / 1e9:.1f} GB"


def _free_bytes(path: str) -> int:
    import shutil

    return shutil.disk_usage(path).free


def phase_weights(torch, ctx: dict) -> None:
    import gc
    import shutil
    import tempfile

    from modal_tpu_torch.models.llama import forward
    from modal_tpu_torch.models.quant import quantized_bytes
    from modal_tpu_torch.models.weights import export_checkpoint, load_params
    from modal_tpu_torch.observability.catalog import observe_peak_rss
    from modal_tpu_torch.ops import _build

    params, cfg = _load_8b(torch, ctx)
    prompts = _prompts(cfg, 8, seed=1)
    want = ctx.get("serve_streams")
    if want is None:
        want, *_ = _run_traffic(_engine_8b(params, cfg), prompts, cfg.vocab_size, "weights reference")
        log("[weights] the serve phase did not run: reference streams from the original params")
    nbytes = quantized_bytes(params)
    parent = tempfile.gettempdir()
    free = _free_bytes(parent)
    log(f"[weights] {nbytes / 1e9:.2f} GB of params; {free / 1e9:.1f} GB free under {parent}")
    if free < nbytes * 1.1 + (2 << 30):
        raise AssertionError(f"weights: {free / 1e9:.1f} GB free under {parent}, the checkpoint needs {nbytes / 1e9:.1f}")
    ckpt = tempfile.mkdtemp(prefix="ckpt-", dir=parent)
    try:
        rss0 = observe_peak_rss()
        t0 = time.perf_counter()
        index = export_checkpoint(params, cfg, ckpt)
        export_s = time.perf_counter() - t0
        rss_export = observe_peak_rss()
        total = index["metadata"]["total_size"]
        shards = sorted(set(index["weight_map"].values()))
        t0 = time.perf_counter()
        loaded = load_params(ckpt, cfg, device="cuda")
        load_s = time.perf_counter() - t0
        rss_load = observe_peak_rss()
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)
    log(f"[weights] exported {total / 1e9:.2f} GB in {len(shards)} shards in {export_s:.2f}s "
        f"({total / export_s / 1e9:.2f} GB/s), loaded in {load_s:.2f}s ({total / load_s / 1e9:.2f} GB/s; "
        f"reads from the page cache the export filled); process peak RSS {rss0 / 1e9:.2f} GB before, "
        f"{rss_export / 1e9:.2f} after the export, {rss_load / 1e9:.2f} after the load")
    same = [torch.equal(loaded[k], params[k]) for k in ("embed", "final_norm", "lm_head")]
    same += [torch.equal(loaded["layers"][k], v) for k, v in params["layers"].items()]
    if not all(same):
        raise AssertionError(f"weights: {same.count(False)} reloaded tensors differ from their source")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(3)
    tokens = torch.randint(0, cfg.vocab_size, (1, 2048), generator=gen, device="cuda")
    _build.reset_launches()
    logits = forward(loaded, cfg, tokens)[0]
    torch.cuda.synchronize()
    k1 = _build.LAUNCHES["flash_fwd"]
    if k1 != cfg.n_layers or not bool(torch.isfinite(logits).all()):
        raise AssertionError(f"weights: the forward on the reloaded params launched flash_fwd {k1} times "
                             f"(want {cfg.n_layers}) or gave non-finite logits")
    same_fwd = torch.equal(logits, forward(params, cfg, tokens)[0])
    _build.reset_launches()  # the comparison forward does not count toward the path
    ctx["weights_logits_checksum"] = _checksum(torch, logits)  # the volume phase's reference
    del logits
    if not same_fwd:
        raise AssertionError("weights: the forward on the reloaded params differs from the original's")
    ctx["params"] = params = loaded  # the originals are dropped: the bits are the same
    gc.collect()
    torch.cuda.empty_cache()
    engine = _engine_8b(params, cfg)  # its warm-up launches come before the count
    _build.reset_launches()
    outs, _reqs, wall, st = _run_traffic(engine, prompts, cfg.vocab_size, "weights serve")
    del engine
    k4 = _build.LAUNCHES["paged_decode"]
    if k4 != cfg.n_layers * st["steps"]:
        raise AssertionError(f"weights: paged_decode launched {k4} times over {st['steps']} steps")
    differ = [i for i, (a, b) in enumerate(zip(outs, want)) if a != b]
    if differ:
        raise AssertionError(f"weights: streams {differ} on the reloaded params differ from the serve phase's")
    _add_launches(ctx, "flash_fwd", k1)
    _add_launches(ctx, "paged_decode", k4)
    ctx["weights"] = {
        "bytes": total, "shards": len(shards), "export_s": export_s, "export_gb_per_s": total / export_s / 1e9,
        "load_s": load_s, "load_gb_per_s": total / load_s / 1e9, "peak_rss_before_bytes": rss0,
        "peak_rss_after_export_bytes": rss_export, "peak_rss_after_load_bytes": rss_load,
        "serve_tokens_per_s": 8 * NEW_TOKENS / wall, "flash_fwd_launches": k1, "paged_decode_launches": k4,
    }
    log(f"[weights] every reloaded tensor bit-equal; forward on them: flash_fwd launches {k1}, logits equal "
        f"the original's; serve on them: 8/8 streams equal the serve phase's, {8 * NEW_TOKENS / wall:.1f} "
        f"tokens/s, paged_decode launches {k4} (= {cfg.n_layers} x {st['steps']})")


# the train state's depth: 32 layers would be ~48 GB of bf16 params and
# moments; 4 (8 until the observe phase came) keeps the whole run under
# ~1000 s of its 1200 s limit
VOLUME_TRAIN_LAYERS = 4
VOLUME_NAME = "llama3-8b-weights"


def _volume_serving_fn(cfg_name: str, volume_name: str, prefix: str, prompts: list):
    """The volume phase's function, run in a container of the port's worker
    with the Volume mounted: the params from the Volume, the weights phase's
    cache-less forward, the serving traffic. Cloudpickle takes it by value,
    with the helpers it calls."""

    def serve_from_volume() -> dict:
        import torch

        from modal_tpu_torch import Volume
        from modal_tpu_torch.models.llama import forward, get_config
        from modal_tpu_torch.models.weights import load_params
        from modal_tpu_torch.ops import _build

        cfg = get_config(cfg_name)
        vol = Volume.from_name(volume_name)
        vol.hydrate()
        t0 = time.perf_counter()
        params = load_params((vol, prefix), cfg, device="cuda")
        load_s = time.perf_counter() - t0
        nbytes = sum(t.numel() * t.element_size() for _p, t in _tree_leaves(params))
        gen = torch.Generator(device="cuda")
        gen.manual_seed(3)
        tokens = torch.randint(0, cfg.vocab_size, (1, 2048), generator=gen, device="cuda")
        _build.reset_launches()
        logits = forward(params, cfg, tokens)[0]
        torch.cuda.synchronize()
        k1 = _build.LAUNCHES["flash_fwd"]
        checksum, finite = _checksum(torch, logits), bool(torch.isfinite(logits).all())
        del logits
        engine = _engine_8b(params, cfg)  # its warm-up launches come before the count
        _build.reset_launches()
        streams, _reqs, wall, stats = _run_traffic(engine, prompts, cfg.vocab_size, "volume container")
        return {"load_s": load_s, "bytes": nbytes, "flash_fwd_launches": k1, "logits_checksum": checksum,
                "logits_finite": finite, "streams": streams, "paged_decode_launches": _build.LAUNCHES["paged_decode"],
                "decode_steps": stats["steps"], "n_layers": cfg.n_layers, "serve_wall_s": wall,
                "cuda_visible_devices": os.environ.get("CUDA_VISIBLE_DEVICES"),
                "device": torch.cuda.get_device_name(0)}

    return serve_from_volume


def _volume_train_state(torch, ckpt, ctx: dict) -> dict:
    """Two steps of a full-width llama3-8b train state of VOLUME_TRAIN_LAYERS
    layers, saved to the Volume, restored into fresh tensors, and a third
    step from each. Returns the measurements; raises on a difference."""
    from modal_tpu_torch.models.llama import get_config
    from modal_tpu_torch.ops import _build
    from modal_tpu_torch.parallel.train import TrainConfig, create_state, state_from_tree, state_tree

    cfg = get_config("llama3-8b", n_layers=VOLUME_TRAIN_LAYERS)
    tc = TrainConfig(warmup_steps=10, total_steps=100)  # train_demo's
    state, step_fn = create_state(cfg, tc, seed=0, device="cuda")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(1)
    tokens = torch.randint(0, cfg.vocab_size, (1, 2048), generator=gen, device="cuda")
    _build.reset_launches()
    for _ in range(2):
        state, _m = step_fn(state, tokens)
    torch.cuda.synchronize()
    live = state_tree(state)
    leaves = _tree_leaves(live)
    nbytes = sum(t.numel() * t.element_size() for _p, t in leaves)
    t0 = time.perf_counter()
    ckpt.save("train/step2", live)
    save_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    back = ckpt.restore("train/step2", device="cuda")
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t0
    got = dict(_tree_leaves(back))
    differ = [p for p, t in leaves if not (p in got and got[p].dtype == t.dtype and torch.equal(got[p].to(t.device), t))]
    if differ or len(got) != len(leaves):
        raise AssertionError(f"volume: {len(differ)} of {len(leaves)} restored tensors differ ({differ[:4]})")
    restored = state_from_tree(back, tc)
    _live_next, m_live = step_fn(state, tokens)
    _back_next, m_back = step_fn(restored, tokens)
    torch.cuda.synchronize()
    launches = {n: _build.LAUNCHES[n] for n in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")}
    want = {"flash_fwd": 4 * 2 * cfg.n_layers, "flash_bwd_dq": 4 * cfg.n_layers, "flash_bwd_dkv": 4 * cfg.n_layers}
    if launches != want:
        raise AssertionError(f"volume: the four train steps launched {launches}, want {want}")
    loss = (float(m_live["loss"]), float(m_back["loss"]))
    norm = (float(m_live["grad_norm"]), float(m_back["grad_norm"]))
    if not all(math.isfinite(x) for x in (*loss, *norm)):
        raise AssertionError(f"volume: step 3 loss {loss}, grad norm {norm}")
    return {"layers": cfg.n_layers, "state_bytes": nbytes, "leaves": len(leaves), "save_s": save_s,
            "save_gb_per_s": nbytes / save_s / 1e9, "restore_s": restore_s,
            "restore_gb_per_s": nbytes / restore_s / 1e9, "step3_loss": loss, "step3_grad_norm": norm,
            "loss_bit_equal": bool(torch.equal(m_live["loss"], m_back["loss"])),
            "grad_norm_bit_equal": bool(torch.equal(m_live["grad_norm"], m_back["grad_norm"])),
            "loss_abs_diff": abs(loss[0] - loss[1]), "grad_norm_abs_diff": abs(norm[0] - norm[1]),
            "launches": launches}


def phase_volume(torch, ctx: dict) -> None:
    """Weights in a Volume served by a gpu="H100" function, and a train
    state checkpointed to a Volume and resumed (the docstring's 9b)."""
    import gc
    import shutil
    import tempfile

    from modal_tpu_torch import Volume
    from modal_tpu_torch._utils.async_utils import synchronizer
    from modal_tpu_torch.checkpoint import VolumeCheckpointer
    from modal_tpu_torch.client import _Client
    from modal_tpu_torch.models.llama import forward
    from modal_tpu_torch.models.quant import quantized_bytes
    from modal_tpu_torch.models.weights import DEFAULT_SHARD_BYTES, export_checkpoint
    from modal_tpu_torch.ops import _build

    smi = ctx.get("nvidia_smi") or _nvidia_smi()
    kind = torch.cuda.get_device_name(0)
    params, cfg = _load_8b(torch, ctx)
    prompts = _prompts(cfg, 8, seed=1)
    want = ctx.get("serve_streams")
    if want is None:
        want, *_ = _run_traffic(_engine_8b(params, cfg), prompts, cfg.vocab_size, "volume reference")
        log("[volume] the serve phase did not run: reference streams from the params in this process")
    want_checksum = ctx.get("weights_logits_checksum")
    if want_checksum is None:
        gen = torch.Generator(device="cuda")
        gen.manual_seed(3)
        tokens = torch.randint(0, cfg.vocab_size, (1, 2048), generator=gen, device="cuda")
        want_checksum = _checksum(torch, forward(params, cfg, tokens)[0])
        _build.reset_launches()  # a reference forward, not the path
        log("[volume] the weights phase did not run: reference logits from the params in this process")
    nbytes = quantized_bytes(params)
    saved = {k: os.environ.pop(k, None) for k in ("MODAL_TPU_SERVER_URL", "MODAL_TPU_STATE_DIR",
                                                 "MODAL_TPU_AUTO_LOCAL_SERVER")}
    state_dir = os.environ["MODAL_TPU_STATE_DIR"] = tempfile.mkdtemp(prefix="volume-")
    free = _free_bytes(state_dir)
    train_bytes = 3 * nbytes * VOLUME_TRAIN_LAYERS // cfg.n_layers  # an upper bound: params and two moments
    need = max(nbytes + DEFAULT_SHARD_BYTES, train_bytes) * 1.1 + (2 << 30)
    log(f"[volume] {nbytes / 1e9:.2f} GB of params; {free / 1e9:.1f} GB free under {state_dir}, "
        f"{need / 1e9:.1f} GB needed | {smi}")
    if free < need:
        shutil.rmtree(state_dir, ignore_errors=True)
        raise AssertionError(f"volume: {free / 1e9:.1f} GB free under {state_dir}, the phase needs {need / 1e9:.1f}")
    out: dict = {"nvidia_smi": smi}
    app = App("chip_smoke volume")
    vol = Volume.from_name(VOLUME_NAME, create_if_missing=True)
    fn = app.function(serialized=True, gpu="H100", volumes={"/weights": vol}, scaledown_window=2, timeout=1800)(
        _volume_serving_fn("llama3-8b", VOLUME_NAME, "llama3-8b", prompts))
    try:
        with app.run():
            sup = _Client._local_supervisor
            if sup is None or sup.workers[0].gpu_type != kind:
                raise AssertionError("volume: app.run() did not boot the port's plane on this card")
            t0 = time.perf_counter()
            index = export_checkpoint(params, cfg, (vol, "llama3-8b"))
            upload_s = time.perf_counter() - t0
            total = index["metadata"]["total_size"]
            out["upload"] = {"bytes": total, "shards": len(set(index["weight_map"].values())), "s": upload_s,
                             "gb_per_s": total / upload_s / 1e9}
            log(f"[volume] export_checkpoint to the Volume: {total / 1e9:.2f} GB in {out['upload']['shards']} "
                f"shards in {upload_s:.2f}s ({total / upload_s / 1e9:.2f} GB/s; the weights phase's local "
                f"export: {ctx.get('weights', {}).get('export_gb_per_s', float('nan')):.2f} GB/s) | {smi}")
            t0 = time.perf_counter()
            r = fn.remote()
            call_s = time.perf_counter() - t0
            task = next(t for t in sup.state.tasks.values() if t.function_id == fn.object_id)
            _wait_app_tasks(sup, app.app_id)
            k1, k4 = r["flash_fwd_launches"], r["paged_decode_launches"]
            if r["device"] != kind or r["cuda_visible_devices"] != "0" or list(task.gpu_ids) != [0]:
                raise AssertionError(f"volume: the function ran on {r['device']!r} "
                                     f"(CUDA_VISIBLE_DEVICES={r['cuda_visible_devices']!r}, task cards {task.gpu_ids})")
            if k1 != cfg.n_layers or not r["logits_finite"] or r["logits_checksum"] != want_checksum:
                raise AssertionError(f"volume: the forward in the container launched flash_fwd {k1} times (want "
                                     f"{cfg.n_layers}), logits checksum {r['logits_checksum']} vs the weights "
                                     f"phase's {want_checksum}, finite {r['logits_finite']}")
            if k4 != cfg.n_layers * r["decode_steps"]:
                raise AssertionError(f"volume: paged_decode launched {k4} times over {r['decode_steps']} steps")
            differ = [i for i, (a, b) in enumerate(zip(r["streams"], want)) if a != b]
            if differ:
                raise AssertionError(f"volume: streams {differ} served from the Volume differ from the serve phase's")
            _add_launches(ctx, "flash_fwd", k1)
            _add_launches(ctx, "paged_decode", k4)
            load_gbps = r["bytes"] / r["load_s"] / 1e9
            out["serve"] = {k: v for k, v in r.items() if k != "streams"}
            out["serve"].update(call_s=call_s, load_gb_per_s=load_gbps)
            log(f"[volume] gpu=\"H100\" function with the Volume at /weights (task {task.task_id}, card {task.gpu_ids}): "
                f"load_params from the Volume {r['bytes'] / 1e9:.2f} GB in {r['load_s']:.2f}s ({load_gbps:.2f} GB/s; "
                f"the weights phase's local-directory load: "
                f"{ctx.get('weights', {}).get('load_gb_per_s', float('nan')):.2f} GB/s); forward flash_fwd {k1}, "
                f"logits checksum equal to the weights phase's; 8/8 streams equal serve's, paged_decode {k4} "
                f"(= {cfg.n_layers} x {r['decode_steps']}); cold call {call_s:.2f}s | {smi}")
            # the weights' blocks leave the store: the train state needs the disk
            for f in vol.listdir("llama3-8b"):
                for sha in sup.state.volumes[vol.object_id].files[f.path].block_sha256_hex:
                    try:
                        os.unlink(sup.state.block_path(sha))
                    except FileNotFoundError:
                        pass
            Volume.delete(VOLUME_NAME)
            gc.collect()
            torch.cuda.empty_cache()
            tvol = Volume.from_name("llama3-8b-train", create_if_missing=True)
            tvol.hydrate()
            tr = _volume_train_state(torch, VolumeCheckpointer(tvol), ctx)
            for n, c in tr["launches"].items():
                _add_launches(ctx, n, c)
            out["train_state"] = tr
            log(f"[volume] train state, llama3-8b full width at {tr['layers']} layers: {tr['leaves']} tensors, "
                f"{tr['state_bytes'] / 1e9:.2f} GB; saved to a Volume in {tr['save_s']:.2f}s "
                f"({tr['save_gb_per_s']:.2f} GB/s), restored into fresh tensors on the card in {tr['restore_s']:.2f}s "
                f"({tr['restore_gb_per_s']:.2f} GB/s), every tensor bit-equal; step 3 live vs restored: loss "
                f"{tr['step3_loss']} (bit-equal {tr['loss_bit_equal']}, |diff| {tr['loss_abs_diff']:.3e}), grad norm "
                f"{tr['step3_grad_norm']} (bit-equal {tr['grad_norm_bit_equal']}, |diff| "
                f"{tr['grad_norm_abs_diff']:.3e}); launches over the 4 steps {tr['launches']} | {smi}")
            if not tr["loss_bit_equal"]:
                raise AssertionError(f"volume: step 3's loss from the restored state {tr['step3_loss'][1]} differs "
                                     f"from the live state's {tr['step3_loss'][0]}")
    finally:
        if _Client._local_supervisor is not None:
            if _Client._client_from_env is not None:
                _Client._client_from_env._close()
            synchronizer.run(_Client._local_supervisor.stop())
            _Client._local_supervisor = None
            _Client.set_env_client(None)
        shutil.rmtree(state_dir, ignore_errors=True)
        for key, value in saved.items():
            os.environ.pop(key, None)
            if value is not None:
                os.environ[key] = value
        gc.collect()
        torch.cuda.empty_cache()
    ctx["volume"] = out


def phase_int8(torch, ctx: dict) -> None:
    import gc

    from modal_tpu_torch.models.llama import get_config
    from modal_tpu_torch.models.quant import init_params_quantized, quantized_bytes
    from modal_tpu_torch.ops import _build

    cfg = get_config("llama3-8b")
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    qparams = init_params_quantized(cfg, fast_host_init=True, device="cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    qbytes = quantized_bytes(qparams)
    init_peak = torch.cuda.max_memory_allocated() - base
    log(f"[int8] llama3-8b int8 params (fast_host_init) in {init_s:.1f}s: quantized_bytes {qbytes / 1e9:.3f} GB, "
        f"peak device memory of the init {init_peak / 1e9:.3f} GB above the {base / 1e9:.2f} GB already held")
    engine = _engine_8b(qparams, cfg)
    prompts = _prompts(cfg, 8, seed=1)
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launches()
    outs, _reqs, wall, st = _run_traffic(engine, prompts, cfg.vocab_size, "int8")
    k4 = _build.LAUNCHES["paged_decode"]
    serve_peak = torch.cuda.max_memory_allocated() - base
    if k4 != cfg.n_layers * st["steps"] or st["steps"] == 0:
        raise AssertionError(f"int8: paged_decode launched {k4} times over {st['steps']} steps")
    log(f"[int8] graphed engine on int8 params: {8 * NEW_TOKENS} tokens in {wall:.2f}s "
        f"({8 * NEW_TOKENS / wall:.1f} tokens/s), steps {st['steps']}, paged_decode launches {k4} "
        f"(= {cfg.n_layers} x steps), peak device memory {serve_peak / 1e9:.2f} GB above the bf16 params; "
        f"{_graph_line(engine)}")
    del engine
    gc.collect()
    step = _decode_step_times(torch, qparams, cfg, True)
    bf16 = ctx.get("bf16_decode_step")
    if bf16 is None:
        params, _cfg = _load_8b(torch, ctx)
        bf16 = ctx["bf16_decode_step"] = _decode_step_times(torch, params, cfg, True)
    _add_launches(ctx, "paged_decode", k4)
    ctx["int8"] = {"quantized_bytes": qbytes, "init_s": init_s, "init_peak_bytes": init_peak,
                   "serve_peak_bytes": serve_peak, "tokens_per_s": 8 * NEW_TOKENS / wall, "steps": st["steps"],
                   "paged_decode_launches": k4, "decode_step": step, "bf16_decode_step": bf16}
    log(f"[int8] graphed decode step at 8 slots: int8 device {step['device_ms']:.2f} ms (wall {step['wall_ms']:.2f}) "
        f"against bf16 device {bf16['device_ms']:.2f} ms (wall {bf16['wall_ms']:.2f}): "
        f"{step['device_ms'] / bf16['device_ms']:.2f}x (qmm converts each int8 weight to bf16 per call)")
    del qparams
    gc.collect()
    torch.cuda.empty_cache()


def _checked_dispatches(torch, engine, records: list) -> None:
    """Run each `_spec_dispatch` of `engine` under torch.cuda's sync debug
    mode "error": a host sync inside it (an `.item()`, a `.cpu()`, a copy
    from pageable memory) raises, fails the round and so the run. Each
    dispatch's group (slot, seed, next token index, temperature, max new
    tokens) and its target chain go to `records`."""
    dispatch = engine._spec_dispatch

    def checked(group):
        info = [(i, s.request.seed, len(s.request.tokens), s.request.temperature, s.request.max_new_tokens)
                for i, s in group]
        torch.cuda.set_sync_debug_mode("error")
        try:
            proposals, targets = dispatch(group)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        records.append({"group": info, "targets": targets})
        return proposals, targets

    engine._spec_dispatch = checked


def _dispatch_samples(samples: list, n_dispatches: int, k: int) -> list:
    """The draft logits of each dispatch: its sample_step calls are k [slots,
    V] draft calls then one [slots·(k+1), V] verify call; other calls (a
    prefill's sampled first token, [1, V]) come between dispatches."""
    drafts, run = [], []
    for logits in samples:
        if logits.shape[0] == 1:
            continue
        run.append(logits)
        if len(run) == k + 1:
            drafts.append(run[:k])
            run = []
    if len(drafts) != n_dispatches or run:
        raise AssertionError(f"spec: {len(drafts)} dispatches' draft logits for {n_dispatches} dispatches")
    return drafts


def _walk_rounds(torch, records: list, verifies: list, drafts: list, k: int) -> dict:
    """Replay acceptance over each dispatch's verify (fed tokens and logits),
    its draft logits and its target chain, as `_spec_accept` walks it. For
    every rejected proposal p against the target's token t at that
    position: the gap logit(t) − logit(p) in the target's logits, and the
    deviation |draft(t) − target(t)| + |draft(p) − target(p)| between the
    draft's logits and the target's at the two tokens. A greedy row's gap is
    at most its deviation. A sampled row's decision also turns on the top-p
    cut (a token at the nucleus edge is in for one and out for the other),
    so there only the deviation bounds what bf16 noise can flip."""
    rejections = []
    accepted = 0
    for rec, (fed, logits), dlogits in zip(records, verifies, drafts):
        fed_h = fed.cpu()
        targets = rec["targets"].cpu().reshape(fed.shape[0], k + 1)
        for i, _seed, index, temp, max_new in rec["group"]:
            for j in range(k):
                if index + j + 1 >= max_new:
                    break
                prop, tgt = int(fed_h[i, j + 1]), int(targets[i, j])
                if prop == tgt:
                    accepted += 1
                    continue
                row, drow = logits[i, j].float(), dlogits[j][i].float()
                rejections.append({
                    "sampled": temp > 0,
                    "gap": (row[tgt] - row[prop]).item(),
                    "deviation": ((drow[tgt] - row[tgt]).abs() + (drow[prop] - row[prop]).abs()).item(),
                })
                break
    return {"accepted": accepted, "rejections": rejections}


# the spec phase's target depth: llama3-8b's width at the first 16 of the
# serve params' 32 layers (views), cut (with the volume phase's train state)
# to keep the whole run under ~1000 s of its 1200 s limit; the breakdown
# still times the full-depth target
SPEC_TARGET_LAYERS = 16


def phase_spec(torch, ctx: dict) -> None:
    import gc

    from modal_tpu_torch.models.llama import get_config, init_params
    from modal_tpu_torch.ops import _build
    from modal_tpu_torch.serving import engine as engine_mod

    full_params, full_cfg = _load_8b(torch, ctx)
    cfg = get_config("llama3-8b", n_layers=SPEC_TARGET_LAYERS)
    params = {**full_params, "layers": {n: w[:SPEC_TARGET_LAYERS] for n, w in full_params["layers"].items()}}
    prompts = _prompts(cfg, 8, seed=1)
    k = 3
    serve_tps = ctx.get("serve", {}).get("tokens_per_s")
    out = {}
    dcfg = get_config("llama3-1b-proxy")
    runs = (("draft", (init_params(dcfg, seed=1, device="cuda"), dcfg)), ("self_draft", (params, cfg)))
    verify, sample = engine_mod.paged_verify_step, engine_mod.sample_step
    for name, draft in runs:
        engine = _engine_8b(params, cfg, draft=draft, spec_k=k)
        if not engine.spec_overlap:
            raise AssertionError("the spec phase runs with MODAL_TPU_SPEC_OVERLAP on")
        if engine.decode_graph is None:
            raise AssertionError("the speculative engine did not capture its draft's decode step")
        log(f"[spec] {name}: draft {_graph_line(engine)}")
        records: list = []
        verifies: list = []
        samples: list = []

        def kept_verify(*args):
            logits, cache = verify(*args)
            verifies.append((args[2], logits))  # the fed tokens and every position's logits
            return logits, cache

        def kept_sample(logits, *rest):
            # k draft steps' logits, then the verify's, per dispatch; a copy:
            # the draft graph's next replay overwrites its logits buffer
            samples.append(logits.clone())
            return sample(logits, *rest)

        _checked_dispatches(torch, engine, records)
        if name == "self_draft":  # the replay keeps each dispatch's logits: ~28 MB
            engine_mod.paged_verify_step, engine_mod.sample_step = kept_verify, kept_sample
        _build.reset_launches()
        torch.cuda.reset_peak_memory_stats()
        try:
            outs, reqs, wall, st = _run_traffic(engine, prompts, cfg.vocab_size, f"spec {name}")
        finally:
            engine_mod.paged_verify_step, engine_mod.sample_step = verify, sample
        peak = torch.cuda.max_memory_allocated()
        launches = _build.LAUNCHES["paged_decode"]
        d_layers = draft[1].n_layers
        want = d_layers * (k + 1) * st["spec_dispatches"]
        if launches != want or st["spec_dispatches"] == 0 or len(records) != st["spec_dispatches"]:
            raise AssertionError(
                f"spec {name}: paged_decode launched {launches} times, want {d_layers} draft layers x "
                f"{k + 1} x {st['spec_dispatches']} dispatches = {want} ({len(records)} dispatches seen)"
            )
        p50, p95 = _pcts([r.ttft_s for r in reqs])
        same = sum(a == b for a, b in zip(outs, ctx.get("serve_streams", [])))
        out[name] = {
            "draft": draft[1].name, "spec_k": k, "wall_s": wall,
            "tokens_per_s": 8 * NEW_TOKENS / wall, "ttft_p50_s": p50, "ttft_p95_s": p95,
            "spec_rounds": st["spec_rounds"], "spec_dispatches": st["spec_dispatches"],
            "spec_accept_ratio": st["spec_accept_ratio"], "paged_decode_launches": launches,
            "streams_equal_to_serve": same, "draft_pool_bytes": engine.draft_cache.pool_bytes(),
            "peak_memory_bytes": peak,
        }
        _add_launches(ctx, "paged_decode", launches)
        log(f"[spec] {name} ({draft[1].name} at {draft[1].n_layers} layers, target at {cfg.n_layers}, spec_k {k}, "
            f"overlap on): {8 * NEW_TOKENS} tokens in "
            f"{wall:.2f}s, {out[name]['tokens_per_s']:.1f} tokens/s (serve phase: "
            f"{f'{serve_tps:.1f}' if serve_tps else 'not run'}), TTFT p50 {p50:.3f}s p95 {p95:.3f}s, "
            f"rounds {st['spec_rounds']}, dispatches {st['spec_dispatches']} (no host sync inside one), "
            f"accept ratio {st['spec_accept_ratio']}, paged_decode launches {launches} (= {d_layers} x "
            f"{k + 1} x {st['spec_dispatches']}, draft graph replays counted), streams equal to the serve "
            f"phase's {same}/8, draft pool "
            f"{out[name]['draft_pool_bytes'] / 1e9:.2f} GB, peak memory {peak / 1e9:.2f} GB")
        if name == "self_draft":
            # the prefill emissions call sample_step too (sampled requests,
            # outside any dispatch): keep each dispatch's k + 1 calls only
            drafts = _dispatch_samples(samples, len(records), k)
            walk = _walk_rounds(torch, records, verifies, drafts, k)
            engine_acc = sum(a for a, _p in engine._spec_window)
            if walk["accepted"] != engine_acc or len(verifies) != len(records):
                raise AssertionError(f"spec self_draft: the replay accepted {walk['accepted']} proposals "
                                     f"over {len(verifies)} verifies, the engine {engine_acc}")
            rej = walk["rejections"]
            greedy = [r for r in rej if not r["sampled"]]
            sampled = [r for r in rej if r["sampled"]]
            worst = {"greedy_gap": max((r["gap"] for r in greedy), default=0.0),
                     "greedy_deviation": max((r["deviation"] for r in greedy), default=0.0),
                     "sampled_gap": max((r["gap"] for r in sampled), default=0.0),
                     "sampled_deviation": max((r["deviation"] for r in sampled), default=0.0)}
            out[name].update(rejections={"greedy": len(greedy), "sampled": len(sampled)}, worst=worst)
            log(f"[spec] self_draft rejections: greedy {len(greedy)} (worst target-logit gap "
                f"{worst['greedy_gap']:.4f}, worst draft-vs-target deviation {worst['greedy_deviation']:.4f}), "
                f"sampled {len(sampled)} (worst gap {worst['sampled_gap']:.4f}, worst deviation "
                f"{worst['sampled_deviation']:.4f}); bar {SELF_DRAFT_TIE} on the greedy gap and the sampled deviation")
            if max(worst["greedy_gap"], worst["sampled_deviation"]) > SELF_DRAFT_TIE:
                raise AssertionError(f"spec self_draft: a rejection is no near-tie ({worst}; bar {SELF_DRAFT_TIE}): "
                                     "the draft's cache is off")
        del engine, records, verifies, samples, draft
        gc.collect()
        torch.cuda.empty_cache()
    out["breakdown"] = _spec_breakdown(torch, full_params, full_cfg, *runs[0][1], k)
    del runs
    gc.collect()
    torch.cuda.empty_cache()
    ctx["spec"] = out


def _call_ms(torch, fn, iters: int = 5) -> tuple[float, float]:
    """(wall, device) ms per call of `fn`, after a warm-up: the host clock
    over `iters` calls ended by a synchronize, and the card's busy time over
    another `iters` (the kernels' self time under torch.profiler, as
    `tools/profile_serving.py` reads it). Wall above device means the host
    paces the calls."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) / iters * 1e3
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    busy_us = sum(float(getattr(e, "self_device_time_total", getattr(e, "self_cuda_time_total", 0.0)))
                  for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA)
    return wall, busy_us / 1e3 / iters


def _spec_breakdown(torch, params, cfg, dparams, dcfg, k: int) -> dict:
    """Where a speculative dispatch's time goes, at the spec phase's shapes
    (8 slots decoding at q_pos ~600, the engine's 2048-page pools): one draft
    decode step (the dispatch runs k + 1), the target's decode step for
    comparison, and the target's (k + 1)-token verify through the gather
    path, each as wall and device ms per call."""
    from modal_tpu_torch.models.llama import params_device
    from modal_tpu_torch.models.paged_kv import (
        DecodeGraph,
        PagedKVCache,
        assign_pages,
        paged_decode_step,
        paged_verify_step,
    )

    dev = params_device(params)

    def state(c):
        cache = PagedKVCache.create(c, 8, 2049, 16, 512, device=dev)
        for slot in range(8):
            assign_pages(cache, slot, 0, list(range(1 + 40 * slot, 1 + 40 * (slot + 1))))
        return cache

    gen = torch.Generator(device=dev)
    gen.manual_seed(5)
    tokens = torch.randint(0, cfg.vocab_size, (8, k + 1), generator=gen, device=dev)
    active = torch.ones((8,), dtype=torch.bool, device=dev)
    out = {}
    for name, (p, c) in (("draft_decode_step", (dparams, dcfg)), ("draft_decode_step_graphed", (dparams, dcfg)),
                         ("target_decode_step", (params, cfg)), ("target_decode_step_graphed", (params, cfg)),
                         ("target_verify", (params, cfg))):
        cache = state(c)
        graph = DecodeGraph(p, c, cache) if name.endswith("_graphed") else None

        def call():
            cache.seq_lens.fill_(600)
            if name == "target_verify":
                paged_verify_step(p, c, tokens, cache, active)
            elif graph is not None:
                graph(tokens[:, 0], active)
            else:
                paged_decode_step(p, c, tokens[:, 0], cache, active, "kernel")

        out[name] = _call_ms(torch, call)
        del cache, graph
    dispatch = (k + 1) * out["draft_decode_step_graphed"][0] + out["target_verify"][0]

    def ms(key):
        return "/".join(f"{x:.2f}" for x in out[key])

    log(f"[spec] breakdown (8 slots at q_pos 600; wall / device-busy ms per call): draft {dcfg.name} "
        f"decode step eager {ms('draft_decode_step')}, graphed {ms('draft_decode_step_graphed')} (x{k + 1} per "
        f"dispatch), target decode step eager {ms('target_decode_step')}, graphed "
        f"{ms('target_decode_step_graphed')}, target verify of {k + 1} tokens (gather, eager) "
        f"{ms('target_verify')}; a dispatch ~{dispatch:.1f} ms of wall before sampling")
    return out


def phase_disagg(torch, ctx: dict) -> None:
    import shutil
    import tempfile

    from modal_tpu_torch.models.paged_kv import export_pages
    from modal_tpu_torch.observability.catalog import KV_SHIP_SECONDS
    from modal_tpu_torch.ops import _build
    from modal_tpu_torch.serving import asgi_request, serving_asgi_app

    params, cfg = _load_8b(torch, ctx)
    prompts = _prompts(cfg, 8, seed=1)
    want = ctx.get("serve_streams")
    if want is None:
        want, *_ = _run_traffic(_engine_8b(params, cfg), prompts, cfg.vocab_size, "disagg reference")
        log("[disagg] the serve phase did not run: reference streams from an all-in-one engine")
    ship_dir = tempfile.mkdtemp(prefix="kvship-")
    saved_dir = os.environ.get("MODAL_TPU_BLOB_LOCAL_DIR")
    os.environ["MODAL_TPU_BLOB_LOCAL_DIR"] = ship_dir
    pre = _engine_8b(params, cfg, role="prefill")
    dec = _engine_8b(params, cfg, role="decode")
    page = pre.page_size
    try:
        _build.reset_launches()
        export_s0, export_n0 = KV_SHIP_SECONDS.totals()
        t0 = time.perf_counter()
        # request 0 by hand: export, submit, admit, and read the landed pages
        r0 = pre.prefill_export(prompts[0], **_traffic(0))
        while not r0.done:
            pre.run_once()
        ship = r0.shipment
        d0 = dec.submit_prefilled(prompts[0], ship, NEW_TOKENS, **_traffic(0))
        dec._admit()
        slot = next(s for s in dec.slots if s is not None and s.request is d0)
        landed = export_pages(dec.cache, slot.pages[: -(-len(prompts[0]) // page)])
        if not (torch.equal(landed["k"], ship["k"]) and torch.equal(landed["v"], ship["v"])):
            raise AssertionError("disagg: the imported pages differ from the exported bundle")
        ship_mb = (ship["k"].numel() + ship["v"].numel()) * ship["k"].element_size() / 1e6
        mb_per_page = ship_mb / ship["k"].shape[1]
        del landed, ship
        pre.start()
        dec.start()
        pre_app, dec_app = serving_asgi_app(pre), serving_asgi_app(dec)

        async def legs(i: int):
            status, body = await asgi_request(pre_app, "POST", "/v1/prefill", {"prompt": prompts[i], **_traffic(i)})
            if status != 200:
                raise AssertionError(f"/v1/prefill answered {status}: {body[:300]!r}")
            ref = json.loads(body)
            status, body = await asgi_request(dec_app, "POST", "/v1/prefilled", {
                "prompt": prompts[i], "kv_ref": ref["kv_ref"], "max_new_tokens": NEW_TOKENS, **_traffic(i)})
            if status != 200:
                raise AssertionError(f"/v1/prefilled answered {status}: {body[:300]!r}")
            return pre.get(ref["request_id"]).ttft_s, json.loads(body)

        async def all_legs():
            return await asyncio.gather(*(legs(i) for i in range(1, 8)))

        answers = asyncio.run(all_legs())
        outs = [d0.result(timeout=600)] + [a["tokens"] for _t, a in answers]
        wall = time.perf_counter() - t0
        pre_st, dec_st = pre.stats(), dec.stats()
        launches = _build.LAUNCHES["paged_decode"]
        export_s, export_n = (a - b for a, b in zip(KV_SHIP_SECONDS.totals(), (export_s0, export_n0)))
    finally:
        pre.stop()
        dec.stop()
        if saved_dir is None:
            os.environ.pop("MODAL_TPU_BLOB_LOCAL_DIR", None)
        else:
            os.environ["MODAL_TPU_BLOB_LOCAL_DIR"] = saved_dir
        shutil.rmtree(ship_dir, ignore_errors=True)
    _check_streams("disagg", outs, cfg.vocab_size)
    pages = sum(-(-len(p) // page) for p in prompts)
    if (dec_st["remote_prefills"], dec_st["kv_ship_drops"], pre_st["kv_pages_shipped"], export_n) != (8, 0, pages, 8):
        raise AssertionError(
            f"disagg: remote prefills {dec_st['remote_prefills']} (want 8), drops {dec_st['kv_ship_drops']} "
            f"(want 0), pages shipped {pre_st['kv_pages_shipped']} (want {pages}), exports {export_n} (want 8)"
        )
    if pre_st["steps"] != 0 or launches != cfg.n_layers * dec_st["steps"] or dec_st["steps"] == 0:
        raise AssertionError(f"disagg: paged_decode launched {launches} times over the decode engine's "
                             f"{dec_st['steps']} steps ({cfg.n_layers} layers; prefill engine steps {pre_st['steps']})")
    differ = [i for i, (a, b) in enumerate(zip(outs, want)) if a != b]
    if differ:
        first = {i: next(j for j, (x, y) in enumerate(zip(outs[i], want[i])) if x != y) for i in differ}
        raise AssertionError(f"disagg: streams {differ} differ from the all-in-one engine's "
                             f"(first differing token index {first})")
    dec_ttft = _pcts([d0.ttft_s] + [a["ttft_s"] for _t, a in answers])
    pre_ttft = _pcts([r0.ttft_s] + [t for t, _a in answers])
    _add_launches(ctx, "paged_decode", launches)
    ctx["disagg"] = {
        "wall_s": wall, "tokens_per_s": 8 * NEW_TOKENS / wall,
        "decode_steps": dec_st["steps"], "paged_decode_launches": launches,
        "remote_prefills": dec_st["remote_prefills"], "kv_ship_drops": dec_st["kv_ship_drops"],
        "kv_pages_shipped": pre_st["kv_pages_shipped"],
        "shipment_mb_total": pages * mb_per_page, "shipment_mb_request0": ship_mb,
        "export_ms_mean": export_s / export_n * 1e3,
        "decode_leg_ttft_p50_s": dec_ttft[0], "decode_leg_ttft_p95_s": dec_ttft[1],
        "prefill_leg_ttft_p50_s": pre_ttft[0], "prefill_leg_ttft_p95_s": pre_ttft[1],
    }
    d = ctx["disagg"]
    log(f"[disagg] 8 requests x {NEW_TOKENS} tokens in {wall:.2f}s: {d['tokens_per_s']:.1f} tokens/s, "
        f"decode steps {dec_st['steps']}, paged_decode launches {launches} (= {cfg.n_layers} x steps), "
        f"remote prefills 8, drops 0, pages shipped {pages} ({d['shipment_mb_total']:.1f} MB; request 0 "
        f"{ship_mb:.1f} MB, imported bit-equal), export {d['export_ms_mean']:.2f} ms mean over 8 "
        f"(KV_SHIP_SECONDS), TTFT decode leg p50 {dec_ttft[0]:.4f}s p95 {dec_ttft[1]:.4f}s, prefill leg "
        f"p50 {pre_ttft[0]:.3f}s p95 {pre_ttft[1]:.3f}s; all 8 streams equal the all-in-one engine's")


# -- web and disagg_http: serving over HTTP from other processes --------------


def _free_parent(torch, ctx: dict, label: str) -> None:
    """Drop the parent's copy of the 8B weights (a later phase loads them
    again from the seed) and its cached blocks, before other processes on
    the card build their own."""
    import gc

    ctx.pop("params", None)
    gc.collect()
    torch.cuda.empty_cache()
    log(f"[{label}] this process now holds {torch.cuda.memory_allocated() / 1e9:.2f} GB allocated, "
        f"{torch.cuda.memory_reserved() / 1e9:.2f} GB reserved on the card")


class _CardMemory:
    """The card's used memory (every process on it, `nvidia-smi`), sampled
    every 0.5 s in a thread until `stop()`; `peak` in bytes."""

    def __init__(self):
        import threading

        self.peak = 0
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self) -> None:
        while not self._stop.is_set():
            out = subprocess.run(["nvidia-smi", "--query-gpu=memory.used", "--format=csv,noheader,nounits", "-i", "0"],
                                 capture_output=True, text=True, timeout=30)
            if out.returncode == 0 and out.stdout.strip():
                self.peak = max(self.peak, int(out.stdout.split()[0]) * (1 << 20))
            self._stop.wait(0.5)

    def stop(self) -> int:
        self._stop.set()
        self._thread.join(timeout=30)
        return self.peak


def _http_json(url: str, body=None, timeout: float = 600.0) -> dict:
    import urllib.request

    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(url, data=data, method="GET" if body is None else "POST",
                                 headers={"content-type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        return json.loads(resp.read())


def _http_stream(url: str, body: dict, t0: float, timeout: float = 600.0) -> dict:
    """POST a `"stream": true` generate; the `done` event's payload, with
    the client's clock of the first token event (s after `t0`)."""
    import urllib.request

    req = urllib.request.Request(url, data=json.dumps({**body, "stream": True}).encode(), method="POST",
                                 headers={"content-type": "application/json"})
    first, tokens, done, event = None, [], None, ""
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        if not resp.headers.get("content-type", "").startswith("text/event-stream"):
            raise AssertionError(f"web: a streamed generate answered {resp.headers.get('content-type')!r}")
        for raw in resp:
            line = raw.decode().rstrip("\r\n")
            if line.startswith("event: "):
                event = line[7:]
            elif line.startswith("data: ") and event == "token":
                if first is None:
                    first = time.perf_counter() - t0
                tokens.append(json.loads(line[6:])["token"])
            elif line.startswith("data: ") and event == "done":
                done = json.loads(line[6:])
    if done is None or done["tokens"] != tokens:
        raise AssertionError(f"web: a stream ended without a done event equal to its token events ({done})")
    return {**done, "client_first_token_s": first}


def _report_of(task) -> dict:
    """The container's last heartbeat report (export_families JSON)."""
    return json.loads(task.telemetry_prev_json) if task.telemetry_prev_json else {}


def _k4_and_steps(report: dict) -> tuple:
    """(paged_decode launches, decode steps) in one heartbeat report: the
    kernel's launch count and the count of the engine's batch-occupancy
    histogram, observed once per decode step."""
    launches = (report.get("modal_tpu_kernel_launches") or {}).get("series", {}).get("paged_decode")
    occupancy = (report.get("modal_tpu_serving_batch_occupancy") or {}).get("series", {})
    steps = sum(s["count"] for s in occupancy.values())
    return (None if launches is None else int(launches)), int(steps)


def _wait_report(task, want, timeout: float = 20.0) -> dict:
    """The first heartbeat report of `task` for which `want(report)` holds."""
    deadline = time.time() + timeout
    while time.time() < deadline:
        report = _report_of(task)
        if report and want(report):
            return report
        time.sleep(0.2)
    raise AssertionError(f"web: no heartbeat report of {task.task_id} met the condition within {timeout}s "
                         f"(last: {_k4_and_steps(_report_of(task))})")


# the cron function of the web phase: a CPU function that fires every 2 s
WEB_PERIOD_S = 2
WEB_CRON_WINDOW_S = 10.0
# the web phase's streamed requests: two greedy, the two sampled
WEB_STREAMED = (1, 3, 5, 7)


def phase_web(torch, ctx: dict) -> None:
    """llama3-8b served over HTTP by an `llm_service` replica: `app.run()`
    boots the port's plane in this process (a fresh state dir), the
    service's container (gpu="H100") builds the params and the graphed
    engine in `@enter(snap=True)` and serves `/v1/generate` from its
    `@asgi_app` method; the 8 requests go concurrently over HTTP (4 as SSE
    streams), K4's launches per decode step are read from the container's
    heartbeat telemetry, and a `Period` function fires from the cron loop."""
    import concurrent.futures
    import shutil
    import tempfile

    from modal_tpu_torch import Period
    from modal_tpu_torch._utils.async_utils import synchronizer
    from modal_tpu_torch.client import _Client
    from modal_tpu_torch.models.llama import get_config
    from modal_tpu_torch.observability import tracing
    from modal_tpu_torch.serving import llm_service

    smi = ctx.get("nvidia_smi") or _nvidia_smi()
    cfg = get_config("llama3-8b")
    prompts = _prompts(cfg, 8, seed=1)
    _free_parent(torch, ctx, "web")
    saved = {k: os.environ.pop(k, None) for k in ("MODAL_TPU_SERVER_URL", "MODAL_TPU_STATE_DIR",
                                                 "MODAL_TPU_AUTO_LOCAL_SERVER", "MODAL_TPU_HEARTBEAT_INTERVAL")}
    state_dir = os.environ["MODAL_TPU_STATE_DIR"] = tempfile.mkdtemp(prefix="web-")
    os.environ["MODAL_TPU_HEARTBEAT_INTERVAL"] = "1"  # the containers' telemetry push
    web_app = App("chip_smoke web")
    Service = llm_service(web_app, model="llama3-8b", gpu="H100", max_slots=8, num_pages=2048, page_size=16,
                          prefill_chunk=128, name="Llama8B", scaledown_window=600, timeout=900)

    def tick() -> float:
        return time.time()

    ticker = web_app.function(serialized=True, schedule=Period(seconds=WEB_PERIOD_S))(tick)
    card = _CardMemory()
    out: dict = {"nvidia_smi": smi}
    try:
        t_run = time.time()
        with web_app.run():
            t_published = time.time()
            sup = _Client._local_supervisor
            if sup is None:
                raise AssertionError("web: app.run() did not boot the port's LocalSupervisor")
            t0 = time.time()
            url = Service.get_web_url(timeout=60)
            t_url = time.time()
            tasks = [t for t in sup.state.tasks.values() if t.function_id == Service._service_function.object_id]
            if len(tasks) != 1 or tasks[0].gpu_ids != [0]:
                raise AssertionError(f"web: the service's tasks {[(t.task_id, t.gpu_ids) for t in tasks]}")
            task = tasks[0]
            boot = next(s for s in tracing.read_spans(tracing.trace_dir())
                        if s["name"] == "container.boot" and s["attrs"].get("task_id") == task.task_id)
            spans = _spans_of(sup, boot["trace_id"])
            part = {n: spans[n]["end"] - spans[n]["start"] for n in ("container.import_torch", "container.imports",
                                                                   "container.snapshot_state")}
            cold = {"app_run_to_published_s": t_published - t_run, "get_web_url_s": t_url - t0,
                    "run_to_url_s": t_url - t_run, "spawn_to_hello_s": task.started_at - boot["start"],
                    "import_torch_s": part["container.import_torch"], "user_import_s": part["container.imports"],
                    "enter_s": part["container.snapshot_state"], "ready_to_url_s": t_url - boot["end"],
                    "spawn_to_url_s": t_url - boot["start"]}
            out["cold"] = cold
            log(f"[web] llm_service replica: app.run() published in {cold['app_run_to_published_s']:.2f}s; cold "
                f"get_web_url {cold['get_web_url_s']:.2f}s ({url}): spawn → ContainerHello "
                f"{cold['spawn_to_hello_s']:.2f}s, import torch {cold['import_torch_s']:.2f}s, user import "
                f"{cold['user_import_s']:.3f}s, @enter(snap=True) {cold['enter_s']:.2f}s (params + engine + graph "
                f"capture), ready → URL {cold['ready_to_url_s']:.2f}s; spawn → URL {cold['spawn_to_url_s']:.2f}s "
                f"| {smi}")
            # the baseline: a report sent after the URL, so after @enter's
            # graph warm-up (its eager steps launch K4 too)
            t_base = time.time()
            while task.last_heartbeat < t_base + 0.5:
                if time.time() > t_base + 20:
                    raise AssertionError("web: the replica's container stopped heartbeating")
                time.sleep(0.1)
            time.sleep(0.1)  # the heartbeat's report is merged right after its time is set
            k4_0, steps_0 = _k4_and_steps(_report_of(task))
            if k4_0 is None:
                raise AssertionError("web: the replica's heartbeat carries no kernel launch counts")
            stats_0 = _http_json(url + "/v1/stats")

            def one(i: int) -> dict:
                body = {"prompt": prompts[i], "max_new_tokens": NEW_TOKENS, **_traffic(i)}
                if i in WEB_STREAMED:
                    return _http_stream(url + "/v1/generate", body, t_send)
                r = _http_json(url + "/v1/generate", body)
                r["client_done_s"] = time.perf_counter() - t_send
                return r

            t_send = time.perf_counter()
            with concurrent.futures.ThreadPoolExecutor(8) as pool:
                answers = list(pool.map(one, range(8)))
            wall = time.perf_counter() - t_send
            stats = _http_json(url + "/v1/stats")
            d_steps = stats["steps"] - stats_0["steps"]
            report = _wait_report(task, lambda r: _k4_and_steps(r)[1] - steps_0 == d_steps)
            k4, steps = _k4_and_steps(report)
            k4, steps = k4 - k4_0, steps - steps_0
            peak_series = (report.get("modal_tpu_device_memory_bytes") or {}).get("series", {})
            container_peak = max((v for k, v in peak_series.items() if "peak" in k), default=0.0)
            streams = [a["tokens"] for a in answers]
            _check_streams("web", streams, cfg.vocab_size)
            if steps == 0 or k4 != cfg.n_layers * steps:
                raise AssertionError(f"web: paged_decode launched {k4} times in the replica's container over "
                                     f"{steps} decode steps ({cfg.n_layers} layers)")
            if stats["requests_completed"] - stats_0["requests_completed"] < 8 or stats["cuda_graphs"] is not True:
                raise AssertionError(f"web: /v1/stats {stats}")
            if "serve_streams" in ctx:
                diverged = _first_divergence(ctx["serve_streams"], streams, ctx.get("serve_logits", {}), {})
                bad = [d for d in diverged if d["sampled"] or d["gap"] > SELF_DRAFT_TIE]
                if bad:
                    raise AssertionError(f"web: streams differ from serve's beyond a near-tie: {bad}")
                out["diverged"] = diverged
            deadline = t_published + WEB_CRON_WINDOW_S
            while time.time() < deadline:
                time.sleep(0.2)
            fires = [c for c in sup.state.function_calls.values()
                     if c.function_id == ticker.object_id and c.server_originated]
            in_window = [c for c in fires if c.created_at <= t_published + WEB_CRON_WINDOW_S]
            done_deadline = time.time() + 30
            while sum(1 for c in in_window if c.num_done >= 1) < 2 and time.time() < done_deadline:
                time.sleep(0.2)
            if len(in_window) < 2 or sum(1 for c in in_window if c.num_done >= 1) < 2:
                raise AssertionError(f"web: the Period({WEB_PERIOD_S} s) function fired {len(in_window)} times in "
                                     f"{WEB_CRON_WINDOW_S:.0f}s ({sum(1 for c in in_window if c.num_done)} done)")
            run_id = web_app.app_id
        _wait_app_tasks(sup, run_id)
    finally:
        card_peak = card.stop()
        if _Client._local_supervisor is not None:
            if _Client._client_from_env is not None:
                _Client._client_from_env._close()
            synchronizer.run(_Client._local_supervisor.stop())
            _Client._local_supervisor = None
            _Client.set_env_client(None)
        shutil.rmtree(state_dir, ignore_errors=True)
        for key, value in saved.items():
            os.environ.pop(key, None)
            if value is not None:
                os.environ[key] = value
    ttft = _pcts([a["ttft_s"] for a in answers])
    client_first = _pcts([a["client_first_token_s"] for a in answers if "client_first_token_s" in a])
    # per streamed request: its first token event on the client's clock less
    # the engine's TTFT (HTTP, the ASGI hop to submit, the SSE write)
    over = statistics.median((a["client_first_token_s"] - a["ttft_s"]) * 1e3 for a in answers
                             if "client_first_token_s" in a)
    serve = ctx.get("serve", {})
    _add_launches(ctx, "paged_decode", k4)
    out.update({
        "wall_s": wall, "tokens_per_s": 8 * NEW_TOKENS / wall, "decode_steps": steps, "paged_decode_launches": k4,
        "ttft_p50_s": ttft[0], "ttft_p95_s": ttft[1], "stream_first_token_p50_s": client_first[0],
        "stream_first_token_p95_s": client_first[1], "stream_over_engine_ttft_ms": over,
        "streamed": list(WEB_STREAMED),
        "container_peak_device_bytes": container_peak, "card_peak_used_bytes": card_peak,
        "cron_fires_in_window": len(in_window), "stats": {k: stats[k] for k in ("steps", "requests_completed",
                                                                                "cuda_graphs", "preemptions")},
    })
    ctx["web"] = out
    log(f"[web] 8 requests x {NEW_TOKENS} tokens over HTTP, concurrently ({len(WEB_STREAMED)} as SSE streams) in "
        f"{wall:.2f}s: {out['tokens_per_s']:.1f} tokens/s (serve in process "
        f"{serve.get('tokens_per_s', float('nan')):.1f}); engine TTFT p50 {ttft[0]:.3f}s p95 {ttft[1]:.3f}s (serve "
        f"{serve.get('ttft_p50_s', float('nan')):.3f}s / {serve.get('ttft_p95_s', float('nan')):.3f}s); the streams' "
        f"first token on the client's clock p50 {client_first[0]:.3f}s p95 {client_first[1]:.3f}s, {over:.1f} ms after "
        f"its engine TTFT (median of the streamed); paged_decode "
        f"{k4} launches in the replica's container over {steps} decode steps (= {cfg.n_layers} x steps, from its "
        f"heartbeat telemetry); /v1/stats requests_completed {stats['requests_completed']}, cuda_graphs "
        f"{stats['cuda_graphs']}; streams "
        + ("equal serve's" + (f" but {len(out['diverged'])} greedy near-ties" if out.get("diverged") else "")
           if "serve_streams" in ctx else "not compared (serve did not run)")
        + f"; peak device memory: the container {container_peak / 1e9:.2f} GB, the card (nvidia-smi, every "
        f"process) {card_peak / 1e9:.2f} GB; Period({WEB_PERIOD_S} s) fired {len(in_window)} times in "
        f"{WEB_CRON_WINDOW_S:.0f}s | {smi}")


def _cpu_busy(seconds: float = 0.5) -> float:
    """The share of the CPUs' time spent busy over `seconds` (/proc/stat)."""

    def times() -> list:
        with open("/proc/stat") as f:
            return [int(x) for x in f.readline().split()[1:]]

    a = times()
    time.sleep(seconds)
    b = times()
    d = [y - x for x, y in zip(a, b)]
    idle = d[3] + (d[4] if len(d) > 4 else 0)  # idle + iowait
    return 1.0 - idle / max(1, sum(d))


def _host_line() -> str:
    """The host this run shares: CPU model, logical CPUs, the 1-minute load
    average and the CPUs' busy share right now (a slow host and a slow port
    read alike otherwise)."""
    import platform

    fields: dict = {}
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                key, _, value = line.partition(":")
                fields.setdefault(key.strip(), value.strip())
    except OSError:
        pass
    model = next((fields[k] for k in ("model name", "Model", "cpu model", "Hardware") if fields.get(k)),
                 fields.get("vendor_id") or "CPU model not in /proc/cpuinfo")
    try:
        busy = f"{100 * _cpu_busy():.1f}%"
    except (OSError, ValueError, IndexError):
        busy = "not readable"
    return (f"host: {model} ({platform.machine()}), {os.cpu_count()} logical CPUs, load average (1 min) "
            f"{os.getloadavg()[0]:.2f}, CPUs busy over 0.5 s {busy}")


# the observe phase: the sampler's cadence and the burn-rate windows, short
# enough for one phase; the cache-less forward's length in the debug call
OBSERVE_TS_INTERVAL_S = 1.0
OBSERVE_FAST_WINDOW_S = 20.0
OBSERVE_SLOW_WINDOW_S = 60.0
OBSERVE_DEBUG_LENGTH = 512
# the load rounds, each the same 8 concurrent requests over HTTP to a
# replica with its prefix cache off (so rounds differ by the condition, not
# by their prompts' lengths or cache hits), as (sampler on, profiler on):
# round 0 is the observed round; rounds 1-8 take the sampler on and off in
# turns (on, off, off, on, twice), rounds 9-16 the profiler
_TURNS = (True, False, False, True) * 2
OBSERVE_ROUNDS = ((True, False), *((on, False) for on in _TURNS), *((True, on) for on in _TURNS))
# calls of the debug class and of its unprofiled twin: the first boots the
# container, the others are warm
OBSERVE_DEBUG_CALLS = 3


def _debug_forward_class(app, cfg_name: str, profiled: bool, name: str):
    """A `gpu="H100"` class whose `@enter` builds `cfg_name`'s weights from
    seed 0 on the card and runs one untimed cache-less forward (K1 loaded,
    the libraries warm), and whose `forward(length)` runs `llama.forward`
    cache-less on `length` seeded tokens: the call `runtime_debug=True`
    profiles (`profiled`), or the same call unprofiled."""
    import modal_tpu_torch

    class _DebugForward:
        @modal_tpu_torch.enter()
        def load(self):
            import torch

            from modal_tpu_torch.models.llama import forward, get_config, init_params

            self.cfg = get_config(cfg_name)
            self.params = init_params(self.cfg, seed=0, device="cuda")
            forward(self.params, self.cfg, torch.zeros(1, 128, dtype=torch.long, device="cuda"))
            torch.cuda.synchronize()

        @modal_tpu_torch.method()
        def forward(self, length: int) -> dict:
            import torch

            from modal_tpu_torch.models.llama import forward
            from modal_tpu_torch.ops import _build

            gen = torch.Generator(device="cuda")
            gen.manual_seed(length)
            tokens = torch.randint(0, self.cfg.vocab_size, (1, length), generator=gen, device="cuda")
            before = _build.LAUNCHES.get("flash_fwd", 0)
            t0 = time.perf_counter()
            logits, _ = forward(self.params, self.cfg, tokens)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            return {"launches": _build.LAUNCHES.get("flash_fwd", 0) - before, "forward_s": wall,
                    "shape": list(logits.shape), "finite": bool(torch.isfinite(logits).all()),
                    "checksum": float(logits.float().sum())}

    _DebugForward.__name__ = _DebugForward.__qualname__ = name
    return app.cls(serialized=True, gpu="H100", runtime_debug=profiled, scaledown_window=2, timeout=600)(
        _DebugForward)


def _scrape(url: str, openmetrics: bool = False) -> tuple:
    """(text, ms) of one GET of the plane's `/metrics`."""
    import urllib.request

    req = urllib.request.Request(url, headers={"Accept": "application/openmetrics-text"} if openmetrics else {})
    t0 = time.perf_counter()
    with urllib.request.urlopen(req, timeout=60) as resp:
        text = resp.read().decode()
    return text, (time.perf_counter() - t0) * 1e3


def _sample_value(text: str, name: str, labels: str = "") -> float:
    """One sample's value in an exposition (`name{labels} value`), 0 when absent."""
    key = f"{name}{{{labels}}}" if labels else name
    for line in text.splitlines():
        if line.startswith(key + " "):
            return float(line.split(" ")[1])
    return 0.0


def _history(client, query: str, **kw) -> dict:
    from modal_tpu_torch._utils.async_utils import synchronizer
    from modal_tpu_torch.proto import api_pb2

    resp = synchronizer.run(client.stub.MetricsHistory(api_pb2.MetricsHistoryRequest(query=query, **kw)))
    return json.loads(resp.payload_json)


def _profile_control(client, action: str):
    from modal_tpu_torch._utils.async_utils import synchronizer
    from modal_tpu_torch.proto import api_pb2

    return synchronizer.run(client.stub.ProfileControl(api_pb2.ProfileControlRequest(action=action)))


def _journal_alerts(sup) -> list:
    """The `alert` records in the plane's journal, as a replay reads them."""
    snap, tail = sup.state.journal.replay()
    return [r for r in snap + tail if r.get("t") == "alert"]


def phase_observe(torch, ctx: dict) -> None:
    """The metrics plane on an SLO-targeted llama3-8b `llm_service` replica:
    `app.run()` boots the port's plane (a fresh state dir) with its sampler
    every OBSERVE_TS_INTERVAL_S and the TTFT objective below the TTFT the
    web phase measured; 8 concurrent requests over HTTP violate it. Checked:
    `/metrics` in both formats (K4's launches and the TTFT histogram's count
    rising by the round's), MetricsHistory's windowed p95 equal to this
    replica's own, `serving_ttft_p95` firing and journaled, the SLO
    autoscaler asking for 2 replicas while the second waits for the card
    (one task, one replica context), TaskGetTimeline, ProfileControl around
    a round (folded stacks of the plane and the container), then a
    `runtime_debug=True` class whose cache-less forward's torch.profiler
    trace AppListProfiles lists and names K1 once per layer. Measured: the
    sampler's and the profiler's cost on tokens/s and TTFT (rounds in
    turns), `/metrics` scrape ms, and the debug call against the same call
    unprofiled."""
    import concurrent.futures
    import shutil
    import tempfile

    from modal_tpu_torch._utils.async_utils import synchronizer
    from modal_tpu_torch.client import _Client
    from modal_tpu_torch.models.llama import get_config
    from modal_tpu_torch.observability import profiler
    from modal_tpu_torch.observability.catalog import SERVING_TTFT
    from modal_tpu_torch.observability.quantile import bucket_quantile
    from modal_tpu_torch.proto import api_pb2
    from modal_tpu_torch.serving import llm_service

    smi = ctx.get("nvidia_smi") or _nvidia_smi()
    log(f"[observe] {_host_line()}")
    cfg = get_config("llama3-8b")
    web = ctx.get("web", {})
    # the objective: a quarter of the TTFT p50 the web phase measured (250
    # ms without it), so the round violates it; the throughput target twice
    # one replica's rate, so the fleet never reads as idle
    if "ttft_p50_s" in web:
        target_ttft_ms = min(250.0, web["ttft_p50_s"] * 1e3 / 4)
        target_tps = 2.0 * web["tokens_per_s"]
        why = (f"a quarter of the web phase's TTFT p50 {web['ttft_p50_s']:.3f}s, at most 250 ms; twice its "
               f"{web['tokens_per_s']:.1f} tokens/s")
    else:
        target_ttft_ms, target_tps = 250.0, 1000.0
        why = "the web phase did not run: 250 ms, 1000 tokens/s"
    log(f"[observe] targets: target_ttft_ms {target_ttft_ms:.1f}, target_tokens_per_replica {target_tps:.1f} ({why});"
        f" max_containers 2 on one card, so the objective is violated and a second replica cannot fit")
    _free_parent(torch, ctx, "observe")
    env = {"MODAL_TPU_HEARTBEAT_INTERVAL": "1", "MODAL_TPU_TS_INTERVAL": str(OBSERVE_TS_INTERVAL_S),
           "MODAL_TPU_SLO_TTFT_P95_S": str(target_ttft_ms / 1e3),
           "MODAL_TPU_SLO_FAST_WINDOW_S": str(OBSERVE_FAST_WINDOW_S),
           "MODAL_TPU_SLO_SLOW_WINDOW_S": str(OBSERVE_SLOW_WINDOW_S)}
    saved = {k: os.environ.pop(k, None) for k in ("MODAL_TPU_SERVER_URL", "MODAL_TPU_STATE_DIR",
                                                 "MODAL_TPU_AUTO_LOCAL_SERVER", "MODAL_TPU_PROFILE", *env)}
    state_dir = os.environ["MODAL_TPU_STATE_DIR"] = tempfile.mkdtemp(prefix="observe-")
    os.environ.update(env)
    app = App("chip_smoke observe")
    Service = llm_service(app, model="llama3-8b", gpu="H100", max_slots=8, num_pages=2048, page_size=16,
                          prefill_chunk=128, name="Llama8BSLO", scaledown_window=600, timeout=900,
                          prefix_cache=False,
                          min_containers=1, max_containers=2, target_ttft_ms=target_ttft_ms,
                          target_tokens_per_replica=target_tps)
    out: dict = {"nvidia_smi": smi, "host": _host_line(), "target_ttft_ms": target_ttft_ms,
                 "target_tokens_per_replica": target_tps}
    decisions: list = []
    k4_total = 0
    try:
        with app.run():
            sup = _Client._local_supervisor
            client = _Client._client_from_env
            if sup is None or client is None:
                raise AssertionError("observe: app.run() did not boot the port's LocalSupervisor")
            fn_id = Service._service_function.object_id
            real_desired = sup.scheduler._slo_desired

            def recording(fn, live):
                desired = real_desired(fn, live)
                if fn.function_id == fn_id:
                    decisions.append((time.time(), len(live), desired))
                return desired

            sup.scheduler._slo_desired = recording
            t0 = time.time()
            url = Service.get_web_url(timeout=120)
            log(f"[observe] replica up: get_web_url {time.time() - t0:.2f}s ({url})")
            (task,) = [t for t in sup.state.tasks.values() if t.function_id == fn_id]
            metrics_url = sup.state.blob_url_base + "/metrics"
            with open(os.path.join(state_dir, "observability", "metrics_url")) as f:
                if f.read().strip() != metrics_url:
                    raise AssertionError("observe: the metrics_url discovery file names another URL")

            def settled() -> dict:
                """The replica's report once a heartbeat after now merged."""
                t_base = time.time()
                while task.last_heartbeat < t_base + 0.5:
                    if time.time() > t_base + 20:
                        raise AssertionError("observe: the replica's container stopped heartbeating")
                    time.sleep(0.1)
                time.sleep(0.1)
                return _report_of(task)

            prompts = _prompts(cfg, 8, seed=100)

            def load_round() -> dict:
                stats_0 = _http_json(url + "/v1/stats")

                def one(i: int) -> dict:
                    return _http_json(url + "/v1/generate",
                                      {"prompt": prompts[i], "max_new_tokens": NEW_TOKENS, **_traffic(i)})

                t_send = time.perf_counter()
                with concurrent.futures.ThreadPoolExecutor(8) as pool:
                    answers = list(pool.map(one, range(8)))
                wall = time.perf_counter() - t_send
                stats = _http_json(url + "/v1/stats")
                _check_streams("observe", [a["tokens"] for a in answers], cfg.vocab_size)
                return {"wall_s": wall, "tokens_per_s": 8 * NEW_TOKENS / wall,
                        "ttft": [a["ttft_s"] for a in answers], "steps": stats["steps"] - stats_0["steps"]}

            # -- the observed round: /metrics, history, the alert, the decision
            k4_0, steps_0 = _k4_and_steps(settled())
            card_0 = (_compute_apps(), _card_used_bytes())
            before = {fmt: _scrape(metrics_url, fmt)[0] for fmt in (False, True)}
            rounds = [load_round()]
            d_steps = rounds[0]["steps"]
            report = _wait_report(task, lambda r: _k4_and_steps(r)[1] - steps_0 == d_steps)
            k4 = _k4_and_steps(report)[0] - k4_0
            if d_steps == 0 or k4 != cfg.n_layers * d_steps:
                raise AssertionError(f"observe: paged_decode launched {k4} times over {d_steps} decode steps")
            k4_total += k4
            prom, prom_ms = _scrape(metrics_url)
            om, om_ms = _scrape(metrics_url, openmetrics=True)
            if not om.endswith("# EOF\n") or prom.endswith("# EOF\n"):
                raise AssertionError("observe: /metrics formats (OpenMetrics must end in '# EOF')")
            for text, was in ((prom, before[False]), (om, before[True])):
                d_k4 = (_sample_value(text, "modal_tpu_kernel_launches", 'kernel="paged_decode"')
                        - _sample_value(was, "modal_tpu_kernel_launches", 'kernel="paged_decode"'))
                d_ttft = (_sample_value(text, "modal_tpu_serving_ttft_seconds_count")
                          - _sample_value(was, "modal_tpu_serving_ttft_seconds_count"))
                if d_k4 != cfg.n_layers * d_steps or d_ttft != 8:
                    raise AssertionError(f"observe: /metrics moved paged_decode by {d_k4} (want "
                                         f"{cfg.n_layers * d_steps}) and the TTFT count by {d_ttft} (want 8)")
            scrape_ms = sorted(_scrape(metrics_url, fmt)[1] for fmt in (False, True) * 5)
            log(f"[observe] /metrics: {len(prom)} bytes Prometheus ({prom_ms:.1f} ms), {len(om)} bytes OpenMetrics "
                f"({om_ms:.1f} ms, ends '# EOF'); paged_decode +{cfg.n_layers * d_steps} launches "
                f"({cfg.n_layers} x {d_steps} decode steps), modal_tpu_serving_ttft_seconds_count +8; scrape p50 "
                f"{scrape_ms[len(scrape_ms) // 2]:.1f} ms over 10 | {smi}")
            # the windowed p95 is this replica's own: the store's first sample
            # was the baseline of every earlier phase's observations
            counts = [0] * len(SERVING_TTFT.buckets)
            for v in rounds[0]["ttft"]:
                idx = next((i for i, b in enumerate(SERVING_TTFT.buckets) if v <= b), None)
                if idx is not None:
                    counts[idx] += 1
            want_p95 = bucket_quantile(SERVING_TTFT.buckets, counts, 0.95, total=8)
            deadline = time.time() + 30
            while True:
                series = _history(client, "series", family="modal_tpu_serving_ttft_seconds",
                                  window_s=OBSERVE_FAST_WINDOW_S)
                n_window = sum(p[3] for pts in series.get("series", {}).values() for p in pts)
                if n_window == 8:
                    break
                if time.time() > deadline:
                    raise AssertionError(f"observe: the store's fast window holds {n_window} TTFT observations")
                time.sleep(0.2)
            q = _history(client, "quantile", family="modal_tpu_serving_ttft_seconds",
                         window_s=OBSERVE_FAST_WINDOW_S, q=0.95)
            if q["value"] != want_p95:
                raise AssertionError(f"observe: MetricsHistory p95 {q['value']} is not this replica's {want_p95}")
            deadline = time.time() + 30
            while sup.state.alerts.get("serving_ttft_p95", {}).get("state") != "firing":
                if time.time() > deadline:
                    raise AssertionError(f"observe: serving_ttft_p95 did not fire: {_history(client, 'alerts')}")
                time.sleep(0.2)
            alerts = _history(client, "alerts")
            rule = next(r for r in alerts["rules"] if r["rule"] == "serving_ttft_p95")
            journaled = [a for a in _journal_alerts(sup) if a["rule"] == "serving_ttft_p95"]
            if not journaled or journaled[-1]["state"] != "firing":
                raise AssertionError(f"observe: the alert's transition is not in the journal: {journaled}")
            deadline = time.time() + 30
            while not any(live == 1 and d == 2 for _t, live, d in decisions):
                if time.time() > deadline:
                    raise AssertionError(f"observe: the SLO autoscaler never asked for 2 replicas: {decisions[-5:]}")
                time.sleep(0.2)
            burn = alerts["alerts"]["serving_ttft_p95"]["burn_rate"]
            log(f"[observe] MetricsHistory quantile p95 over {OBSERVE_FAST_WINDOW_S:.0f}s: {q['value']}s (this "
                f"replica's 8 TTFTs: {want_p95}s); serving_ttft_p95 firing, burn {burn}x fast "
                f"{rule['fast_burn']} slow {rule['slow_burn']} (threshold {rule['threshold']}s), journaled "
                f"({len(journaled)} record); SLO autoscaler: desired 2 with 1 live (moves "
                f"{[(live, d) for _t, live, d in decisions if d != live][:3]}) | {smi}")
            tl = synchronizer.run(client.stub.TaskGetTimeline(api_pb2.TaskGetTimelineRequest(task_id=task.task_id)))
            (line,) = tl.tasks
            if not 0 < line.created_at <= line.started_at:
                raise AssertionError(f"observe: the replica's timeline {line}")
            log(f"[observe] TaskGetTimeline of the replica: created → started "
                f"{line.started_at - line.created_at:.2f}s (a web replica serves HTTP, not inputs: first input "
                f"{line.first_input_at}, first output {line.first_output_at})")
            out.update({"scrape_prom_ms": prom_ms, "scrape_openmetrics_ms": om_ms,
                        "scrape_p50_ms": scrape_ms[len(scrape_ms) // 2], "history_p95_s": q["value"],
                        "alert_burn": burn})

            # -- the cost rounds: the sampler off and on, the profiler on and off
            async def start_sampler():
                sup._start_sampler()  # on the plane's loop

            for sampler_on, profiler_on in OBSERVE_ROUNDS[1:]:
                if (sup._sampler_task is not None) != sampler_on:
                    synchronizer.run(start_sampler() if sampler_on else sup._stop_sampler())
                if profiler_on:
                    if not _profile_control(client, "start").running:
                        raise AssertionError("observe: ProfileControl(start) left the profiler stopped")
                    settled()  # the container applied the command on a beat
                    settled()
                steps_r = _k4_and_steps(settled())
                k4_r0 = steps_r[0]
                rounds.append(load_round())
                report = _wait_report(task, lambda rep: _k4_and_steps(rep)[1] - steps_r[1] == rounds[-1]["steps"])
                k4_total += _k4_and_steps(report)[0] - k4_r0
                if profiler_on:
                    stopped = _profile_control(client, "stop")
                    if stopped.running or not stopped.n_samples:
                        raise AssertionError(f"observe: ProfileControl(stop): {stopped}")
                    settled()  # the container stopped on a beat and wrote its file
                    settled()
            synchronizer.run(start_sampler())
            profiled_paths = list(_profile_control(client, "status").profile_paths)
            # the second replica waited for the card through every decision
            # of 2 since the first: one task, and no CUDA context more on the
            # card than when the replica came up (its memory is printed: the
            # replica's own grows under load)
            moves = [(t, live, d) for t, live, d in decisions if live == 1 and d == 2]
            svc_tasks = [t for t in sup.state.tasks.values() if t.function_id == fn_id]
            card_1 = (_compute_apps(), _card_used_bytes())
            if len(svc_tasks) != 1 or card_1[0] != card_0[0]:
                raise AssertionError(f"observe: {len(svc_tasks)} replica tasks; nvidia-smi compute apps "
                                     f"{card_0[0]} → {card_1[0]}, memory used {card_0[1] / 1e9:.2f} → "
                                     f"{card_1[1] / 1e9:.2f} GB")
            log(f"[observe] the second replica waited for the card through {len(moves)} SLO decisions of 2 over "
                f"{moves[-1][0] - moves[0][0]:.1f}s: {len(svc_tasks)} replica task; nvidia-smi's compute apps "
                f"{card_0[0]} and the card's memory used {card_0[1] / 1e9:.2f} GB when the replica came up, "
                f"{card_1[0]} and {card_1[1] / 1e9:.2f} GB now | {smi}")
            out.update({"slo_moves_to_2": len(moves), "compute_apps": card_1[0], "card_used_bytes": card_1[1]})
            mine = [p for p in profiled_paths if p.endswith("-supervisor.folded")]
            theirs = [p for p in profiled_paths if p.endswith(f"-{task.task_id}.folded")]
            if not mine or not theirs:
                raise AssertionError(f"observe: folded files {profiled_paths}")
            top = profiler.top_table(profiler.merge_folded(theirs), 5)
            top_plane = profiler.top_table(profiler.merge_folded(mine), 5)
            log(f"[observe] ProfileControl: folded files {[os.path.basename(p) for p in profiled_paths]}; "
                f"the replica's top 5 frames (self %): "
                + "; ".join(f"{row['frame']} {row['self_pct']:.1f}%" for row in top)
                + " | the plane's process: "
                + "; ".join(f"{row['frame']} {row['self_pct']:.1f}%" for row in top_plane))

            def summary(picked: list) -> dict:
                tps = [rounds[i]["tokens_per_s"] for i in picked]
                ttft = sorted(v for i in picked for v in rounds[i]["ttft"])
                return {"rounds": picked, "tokens_per_s": tps, "tokens_per_s_mean": statistics.mean(tps),
                        "ttft_p50_s": ttft[len(ttft) // 2]}

            cost = {"sampler_off": summary([r for r in range(1, 9) if not OBSERVE_ROUNDS[r][0]]),
                    "sampler_on": summary([r for r in range(1, 9) if OBSERVE_ROUNDS[r][0]]),
                    "profiler_off": summary([r for r in range(9, 17) if not OBSERVE_ROUNDS[r][1]]),
                    "profiler_on": summary([r for r in range(9, 17) if OBSERVE_ROUNDS[r][1]])}
            out.update({"rounds": rounds, "cost": cost, "folded": [os.path.basename(p) for p in profiled_paths],
                        "top_frames": top, "top_frames_plane": top_plane})
            for label, c in cost.items():
                log(f"[observe] {label}: rounds {c['rounds']}, tokens/s {[round(x, 1) for x in c['tokens_per_s']]} "
                    f"(mean {c['tokens_per_s_mean']:.1f}), TTFT p50 {c['ttft_p50_s']:.3f}s "
                    f"({8 * len(c['rounds'])} requests) "
                    f"| {smi}")
            run_id = app.app_id
        _wait_app_tasks(sup, run_id)

        # -- the debug profile: the cache-less forward, profiled and not
        debug_app = App("chip_smoke observe debug")
        profiled_cls = _debug_forward_class(debug_app, "llama3-8b", True, "DebugForward")
        plain_cls = _debug_forward_class(debug_app, "llama3-8b", False, "PlainForward")
        calls = {}
        with debug_app.run():
            for label, cls in (("profiled", profiled_cls), ("unprofiled", plain_cls)):
                obj = cls()
                rows = []
                for _ in range(OBSERVE_DEBUG_CALLS):
                    t_call = time.perf_counter()
                    res = obj.forward.remote(OBSERVE_DEBUG_LENGTH)
                    res["call_s"] = time.perf_counter() - t_call
                    if (res["launches"] != cfg.n_layers or not res["finite"]
                            or res["shape"] != [1, OBSERVE_DEBUG_LENGTH, cfg.vocab_size]):
                        raise AssertionError(f"observe: the {label} debug forward {res}")
                    rows.append(res)
                calls[label] = rows
                _add_launches(ctx, "flash_fwd", sum(r["launches"] for r in rows))
                if label == "profiled":
                    listed = synchronizer.run(_Client._client_from_env.stub.AppListProfiles(
                        api_pb2.AppListProfilesRequest(app_id=debug_app.app_id))).profiles
                    fn_debug = profiled_cls._service_function.object_id
                    (entry,) = [p for p in listed if sup.state.tasks[p.task_id].function_id == fn_debug]
                    traces = sorted(n for n in os.listdir(entry.path) if n.endswith(".pt.trace.json"))
                    if entry.num_traces != OBSERVE_DEBUG_CALLS or len(traces) != OBSERVE_DEBUG_CALLS:
                        raise AssertionError(f"observe: AppListProfiles lists {entry}")
                    k1_named = []
                    for name in traces:
                        with open(os.path.join(entry.path, name)) as fh:
                            events = json.load(fh)["traceEvents"]
                        k1_named.append(sum(1 for e in events if e.get("cat") == "kernel"
                                            and "flash_fwd_kernel" in str(e.get("name", ""))))
                        kernels = sum(1 for e in events if e.get("cat") == "kernel")
                    if k1_named != [cfg.n_layers] * OBSERVE_DEBUG_CALLS:
                        raise AssertionError(f"observe: the traces name K1 {k1_named} times, want {cfg.n_layers}")
                    dtask = sup.state.tasks[entry.task_id]
                    tl = synchronizer.run(_Client._client_from_env.stub.TaskGetTimeline(
                        api_pb2.TaskGetTimelineRequest(task_id=dtask.task_id))).tasks[0]
                    if not 0 < tl.created_at <= tl.started_at <= tl.first_input_at <= tl.first_output_at:
                        raise AssertionError(f"observe: the debug task's timeline {tl}")
                    out["debug_trace"] = {"path": entry.path, "num_traces": entry.num_traces,
                                          "size_bytes": entry.size_bytes, "k1_named": k1_named,
                                          "kernel_events_last": kernels}
                    log(f"[observe] AppListProfiles: {entry.num_traces} traces, {entry.size_bytes / 1e6:.1f} MB in "
                        f"{entry.path}; each names flash_fwd_kernel {k1_named} times ({kernels} kernel events in "
                        f"the last); TaskGetTimeline of the debug task: created → started "
                        f"{tl.started_at - tl.created_at:.2f}s → first input {tl.first_input_at - tl.started_at:.2f}s"
                        f" → first output {tl.first_output_at - tl.first_input_at:.2f}s")
            debug_run = debug_app.app_id
        _wait_app_tasks(sup, debug_run)
        out["debug_calls"] = calls
        for label, rows in calls.items():
            call_s = ", ".join("%.3f" % r["call_s"] for r in rows)
            forward_ms = ", ".join("%.1f" % (r["forward_s"] * 1e3) for r in rows)
            log(f"[observe] debug forward [1, {OBSERVE_DEBUG_LENGTH}] {label}: call {call_s} s, the forward in "
                f"the container {forward_ms} ms, flash_fwd {[r['launches'] for r in rows]} a call | {smi}")
        warm = {label: {"call_s": statistics.mean(r["call_s"] for r in rows[1:]),
                        "forward_ms": statistics.mean(r["forward_s"] * 1e3 for r in rows[1:])}
                for label, rows in calls.items()}
        out["debug_warm"] = warm
        log(f"[observe] the warm debug call (the first boots its container): "
            f"{warm['profiled']['call_s']:.3f} s profiled against {warm['unprofiled']['call_s']:.3f} s unprofiled, "
            f"the forward in the container {warm['profiled']['forward_ms']:.1f} ms against "
            f"{warm['unprofiled']['forward_ms']:.1f} ms | {smi}")
        same = calls["profiled"][0]["checksum"] == calls["unprofiled"][0]["checksum"]
        log(f"[observe] the profiled and the unprofiled forward's logits sum "
            f"{calls['profiled'][0]['checksum']!r} and {calls['unprofiled'][0]['checksum']!r}"
            + (" (equal)" if same else " (they differ)"))
    finally:
        profiler.stop()
        if _Client._local_supervisor is not None:
            if _Client._client_from_env is not None:
                _Client._client_from_env._close()
            synchronizer.run(_Client._local_supervisor.stop())
            _Client._local_supervisor = None
            _Client.set_env_client(None)
        shutil.rmtree(state_dir, ignore_errors=True)
        for key, value in saved.items():
            os.environ.pop(key, None)
            if value is not None:
                os.environ[key] = value
    _add_launches(ctx, "paged_decode", k4_total)
    ctx["observe"] = out


def _wait_app_tasks(sup, app_id: str, timeout: float = 60.0) -> None:
    """Wait until every task of `app_id` has finished (its containers
    stopped after the run)."""
    deadline = time.time() + timeout
    while any(not t.finished_at for t in list(sup.state.tasks.values()) if t.app_id == app_id):
        if time.time() > deadline:
            raise AssertionError(f"the tasks of {app_id} did not stop within {timeout}s")
        time.sleep(0.2)


DISAGG_CHILD = """
import json, os, signal, sys, threading, time
sys.path.insert(0, sys.argv[2])
role = sys.argv[1]
import torch
from modal_tpu_torch.models.llama import get_config, init_params
from modal_tpu_torch.ops import _build
from modal_tpu_torch.runtime.asgi import AsgiHttpServer
from modal_tpu_torch.serving import ServingEngine, serving_asgi_app
import asyncio
cfg = get_config("llama3-8b")
t0 = time.perf_counter()
params = init_params(cfg, seed=0, device="cuda")
engine = ServingEngine(params, cfg, max_slots=8, page_size=16, prefill_chunk=128, role=role, device="cuda").start()
torch.cuda.synchronize()
boot_s = time.perf_counter() - t0
_build.reset_launches()
loop = asyncio.new_event_loop()
server = AsgiHttpServer(serving_asgi_app(engine))
loop.run_until_complete(server.start())
print(json.dumps({"url": server.url, "boot_s": boot_s, "pid": os.getpid()}), flush=True)
stop = threading.Event()
signal.signal(signal.SIGTERM, lambda *_: stop.set())
threading.Thread(target=lambda: (sys.stdin.read(), stop.set()), daemon=True).start()
while not stop.is_set():
    loop.run_until_complete(asyncio.sleep(0.1))
loop.run_until_complete(server.stop())
engine.stop()
out = {"launches": dict(_build.LAUNCHES), "stats": engine.stats(), "peak_bytes": torch.cuda.max_memory_allocated()}
if role == "prefill":
    from modal_tpu_torch.models import paged_kv
    from modal_tpu_torch.observability.catalog import KV_SHIP_SECONDS
    s, n = KV_SHIP_SECONDS.totals()
    out["export_ms_mean"] = s / n * 1e3 if n else None
    out["exports"] = n
    # the same pages (one 600-token request's worth) three ways, in turns: a
    # plain .cpu() (before this slice), the snapshot's chunked pinned
    # Staging into fresh pageable memory, and export_pages (pinned memory
    # from the caching host allocator)
    from modal_tpu_torch.runtime.snapshot import Staging
    idx = torch.arange(1, 1 + -(-600 // 16), device="cuda")
    staging = Staging(chunk=8 << 20)
    def plain():
        return {n: p.index_select(1, idx).cpu() for n, p in (("k", engine.cache.k_pages), ("v", engine.cache.v_pages))}
    def chunked():
        res = {}
        for n, p in (("k", engine.cache.k_pages), ("v", engine.cache.v_pages)):
            src = p.index_select(1, idx)
            res[n] = torch.empty(src.shape, dtype=src.dtype)
            dst = res[n].view(-1).view(torch.uint8).numpy()
            staging.to_host(src.view(-1).view(torch.uint8), lambda off, c: dst.__setitem__(slice(off, off + c.size), c))
        return res
    def pinned():
        return paged_kv.export_pages(engine.cache, idx.tolist())
    times = {"plain": [], "chunked": [], "pinned": []}
    for _ in range(5):
        for name, fn in (("plain", plain), ("chunked", chunked), ("pinned", pinned), ("pinned", pinned),
                         ("chunked", chunked), ("plain", plain)):
            torch.cuda.synchronize()
            t = time.perf_counter()
            got = fn()
            times[name].append((time.perf_counter() - t) * 1e3)
            del got
    a, b, c = plain(), chunked(), pinned()
    for name, ms in times.items():
        out[f"export_{name}_ms"] = sorted(ms)[len(ms) // 2]
    out["export_equal"] = all(torch.equal(a[n], x[n]) for x in (b, c) for n in ("k", "v"))
    out["export_mb"] = (a["k"].numel() + a["v"].numel()) * a["k"].element_size() / 1e6
print(json.dumps(out, default=str), flush=True)
"""


def _child_hello(proc, role: str, timeout: float = 300.0) -> dict:
    """The process's first JSON line: its URL, once it serves."""
    import select

    deadline = time.time() + timeout
    while time.time() < deadline:
        if proc.poll() is not None:
            raise AssertionError(f"disagg_http: the {role} process exited rc={proc.returncode} before serving")
        ready, _, _ = select.select([proc.stdout], [], [], 1.0)
        if ready:
            line = proc.stdout.readline()
            if line.startswith("{"):
                return json.loads(line)
    raise AssertionError(f"disagg_http: the {role} process did not come up within {timeout}s")


def _child_result(proc, role: str, timeout: float = 120.0) -> dict:
    """Close the process's stdin (it stops serving) and read its last line:
    launches, engine stats, peak device memory (and the prefill's exports)."""
    proc.stdin.close()
    out = proc.stdout.read()
    proc.wait(timeout=timeout)
    if proc.returncode != 0:
        raise AssertionError(f"disagg_http: the {role} process exited rc={proc.returncode}")
    return json.loads(out.strip().splitlines()[-1])


def phase_disagg_http(torch, ctx: dict) -> None:
    """The prefill and decode roles as two processes on card 0, each a
    ServingEngine at llama3-8b's full width behind the port's
    AsgiHttpServer; shipments go PUT → GET through one LocalSupervisor's
    blob server (MODAL_TPU_KV_SHIP_URL, no shared file); a ServingRouter
    with HTTP transports routes the 8 requests through /v1/prefill →
    /v1/prefilled."""
    import concurrent.futures
    import tempfile
    import urllib.error

    from modal_tpu_torch._utils.async_utils import synchronizer
    from modal_tpu_torch.models.llama import get_config
    from modal_tpu_torch.server.supervisor import LocalSupervisor
    from modal_tpu_torch.serving.router import ServingRouter

    smi = ctx.get("nvidia_smi") or _nvidia_smi()
    cfg = get_config("llama3-8b")
    prompts = _prompts(cfg, 8, seed=1)
    _free_parent(torch, ctx, "disagg_http")
    sup = LocalSupervisor(num_workers=0, state_dir=tempfile.mkdtemp(prefix="blob-"))
    synchronizer.run(sup.start())
    card = _CardMemory()
    procs: dict = {}
    try:
        ship_url = sup.state.blob_url_base
        env = {k: v for k, v in os.environ.items() if k not in ("MODAL_TPU_BLOB_LOCAL_DIR", "CUDA_VISIBLE_DEVICES")}
        env.update({"MODAL_TPU_KV_SHIP_URL": ship_url, "CUDA_VISIBLE_DEVICES": "0"})
        t_boot = time.perf_counter()
        procs = {role: subprocess.Popen([sys.executable, "-c", DISAGG_CHILD, role, REPO], stdin=subprocess.PIPE,
                                        stdout=subprocess.PIPE, text=True, env=env)
                 for role in ("prefill", "decode")}
        hellos = {role: _child_hello(p, role) for role, p in procs.items()}
        boot_wall = time.perf_counter() - t_boot
        urls = {role: h["url"] for role, h in hellos.items()}
        kv_refs, legs = [], {}

        def transport(role: str):
            def call(path: str, body: dict) -> dict:
                t = time.perf_counter()
                try:
                    answer = _http_json(urls[role] + path, body)
                except urllib.error.URLError as exc:
                    raise ConnectionError(str(exc)) from exc
                if path == "/v1/prefill":
                    kv_refs.append(answer["kv_ref"])
                    legs[tuple(body["prompt"][:16])] = (t - t_send, time.perf_counter() - t)
                return answer
            return call

        router = ServingRouter({role: transport(role) for role in urls}, page_size=16, prefill_replicas=("prefill",))

        def one(i: int) -> dict:
            return router.route({"prompt": prompts[i], "max_new_tokens": NEW_TOKENS, **_traffic(i)},
                                split_prefill=True)

        t_send = time.perf_counter()
        with concurrent.futures.ThreadPoolExecutor(8) as pool:
            answers = list(pool.map(one, range(8)))
        wall = time.perf_counter() - t_send
        rstats = router.stats()
        results = {role: _child_result(p, role) for role, p in procs.items()}
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait(timeout=30)
        card_peak = card.stop()
        synchronizer.run(sup.stop())
    pre, dec = results["prefill"], results["decode"]
    streams = [a["tokens"] for a in answers]
    _check_streams("disagg_http", streams, cfg.vocab_size)
    if rstats["prefill_fallbacks"] != 0 or rstats["reroutes"] != 0:
        raise AssertionError(f"disagg_http: router stats {rstats}")
    if len(kv_refs) != 8 or not all(r.startswith(f"{ship_url}/blob/") for r in kv_refs):
        raise AssertionError(f"disagg_http: kv_refs {kv_refs} (want 8 under {ship_url}/blob/)")
    dst, pst = dec["stats"], pre["stats"]
    if (dst["remote_prefills"], dst["kv_ship_drops"], pre["exports"]) != (8, 0, 8):
        raise AssertionError(f"disagg_http: remote prefills {dst['remote_prefills']}, drops {dst['kv_ship_drops']}, "
                             f"exports {pre['exports']} (want 8, 0, 8)")
    k4 = dec["launches"]["paged_decode"]
    if dst["steps"] == 0 or k4 != cfg.n_layers * dst["steps"] or pst["steps"] != 0 or pre["launches"]["paged_decode"]:
        raise AssertionError(f"disagg_http: paged_decode {k4} launches over the decode process's {dst['steps']} steps; "
                             f"the prefill process {pre['launches']['paged_decode']} over {pst['steps']}")
    if not pre["export_equal"]:
        raise AssertionError("disagg_http: a staged export differs from the plain .cpu() of the same pages")
    if "serve_streams" in ctx:
        diverged = _first_divergence(ctx["serve_streams"], streams, ctx.get("serve_logits", {}), {})
        bad = [d for d in diverged if d["sampled"] or d["gap"] > SELF_DRAFT_TIE]
        if bad:
            raise AssertionError(f"disagg_http: streams differ from serve's beyond a near-tie: {bad}")
    ttft = _pcts([legs[tuple(p[:16])][0] + legs[tuple(p[:16])][1] for p in prompts])
    pre_leg = _pcts([legs[tuple(p[:16])][1] for p in prompts])
    dec_ttft = _pcts([a["ttft_s"] for a in answers])
    pages = sum(-(-len(p) // 16) for p in prompts)
    mb_per_page = pre["export_mb"] / -(-600 // 16)
    _add_launches(ctx, "paged_decode", k4)
    ctx["disagg_http"] = {
        "wall_s": wall, "tokens_per_s": 8 * NEW_TOKENS / wall, "boot_wall_s": boot_wall,
        "decode_steps": dst["steps"], "paged_decode_launches": k4, "router": rstats,
        "ttft_p50_s": ttft[0], "ttft_p95_s": ttft[1], "prefill_leg_p50_s": pre_leg[0], "prefill_leg_p95_s": pre_leg[1],
        "decode_leg_ttft_p50_s": dec_ttft[0], "shipment_mb_total": pages * mb_per_page,
        "shipment_mb_mean": pages * mb_per_page / 8, "export_ms_mean": pre["export_ms_mean"],
        "export_plain_ms": pre["export_plain_ms"], "export_chunked_ms": pre["export_chunked_ms"],
        "export_pinned_ms": pre["export_pinned_ms"],
        "export_bench_mb": pre["export_mb"], "peak_bytes": {"prefill": pre["peak_bytes"], "decode": dec["peak_bytes"]},
        "card_peak_used_bytes": card_peak,
    }
    d, ind = ctx["disagg_http"], ctx.get("disagg", {})
    log(f"[disagg_http] two processes on card 0 (booted in {boot_wall:.1f}s, in parallel), 8 requests x {NEW_TOKENS} "
        f"tokens routed /v1/prefill → /v1/prefilled over HTTP in {wall:.2f}s: {d['tokens_per_s']:.1f} tokens/s "
        f"(in process {ind.get('tokens_per_s', float('nan')):.1f}); TTFT (route → the prefill leg's answer carrying "
        f"the first token) p50 {ttft[0]:.3f}s p95 {ttft[1]:.3f}s; prefill leg (POST → answer) p50 {pre_leg[0]:.3f}s "
        f"(in process {ind.get('prefill_leg_ttft_p50_s', float('nan')):.3f}s); decode leg TTFT p50 {dec_ttft[0]:.4f}s; "
        f"router {rstats['routed']}, prefill_fallbacks 0; 8 shipments PUT → GET through {ship_url} "
        f"({d['shipment_mb_total']:.1f} MB, {d['shipment_mb_mean']:.1f} MB mean); export {pre['export_ms_mean']:.2f} ms "
        f"mean over 8 (export_pages, KV_SHIP_SECONDS; the in-process phase's {ind.get('export_ms_mean', float('nan')):.2f}); "
        f"the same {pre['export_mb']:.1f} MB of pages: plain .cpu() {pre['export_plain_ms']:.2f} ms, chunked pinned "
        f"Staging {pre['export_chunked_ms']:.2f} ms, export_pages (pinned) {pre['export_pinned_ms']:.2f} ms (median "
        f"of 10 each, in turns, bit-equal); paged_decode {k4} launches in "
        f"the decode process over {dst['steps']} steps (= {cfg.n_layers} x steps); peak device memory: prefill "
        f"{pre['peak_bytes'] / 1e9:.2f} GB, decode {dec['peak_bytes'] / 1e9:.2f} GB, the card (nvidia-smi) "
        f"{card_peak / 1e9:.2f} GB | {smi}")


def _fp32_decode_attention(q, k_pages, v_pages, page_table, mask, positions=None, attn_impl="gather"):
    """Stand-in for paged_kv._paged_attention on the decode step: the plain
    version computed entirely in fp32 (probabilities never rounded), the
    output rounded once to the model dtype. The yardstick both paths are
    held against."""
    from modal_tpu_torch.ops.paged_attention import paged_decode_attention_ref

    s, sq, h, hd = q.shape
    n_kv = k_pages.shape[2]
    out = paged_decode_attention_ref(
        q.float().reshape(s, n_kv, h // n_kv, hd), k_pages.float(), v_pages.float(),
        page_table, positions,
    )
    return out.to(q.dtype).reshape(s, sq, h, hd)


def _first_step_logits(torch, params, cfg, prompt):
    """A greedy request's first decode step, run three times on the same
    engine state (lengths rolled back between runs; each run writes the same
    K/V row, only attention differs): through the kernel, through
    attn_impl="gather", and through fp32 attention."""
    from modal_tpu_torch.models import paged_kv
    from modal_tpu_torch.serving import ServingEngine

    engine = ServingEngine(params, cfg, max_slots=8, page_size=16, prefill_chunk=128,
                           num_pages=257, device="cuda")
    engine.submit(prompt, 8)
    engine._admit()
    while engine.slots[0].state == "prefill":
        engine._prefill_one()
    tokens = torch.zeros((8,), dtype=torch.int64, device="cuda")
    tokens[0] = engine.slots[0].cur_token
    active = torch.zeros((8,), dtype=torch.bool, device="cuda")
    active[0] = True
    lens = engine.cache.seq_lens.clone()
    out = {}
    for name in ("kernel", "gather", "fp32"):
        engine.cache.seq_lens.copy_(lens)
        if name == "fp32":
            paged_kv._paged_attention, saved = _fp32_decode_attention, paged_kv._paged_attention
        try:
            logits, _t, _c = paged_kv.paged_decode_step(
                params, cfg, tokens, engine.cache, active, "gather" if name == "fp32" else name
            )
        finally:
            if name == "fp32":
                paged_kv._paged_attention = saved
        out[name] = logits[0]
    torch.cuda.synchronize()
    engine.stop()
    return out


def _gaps(torch, out: dict) -> dict:
    """Max and mean |difference| of the logits, kernel vs plain and each vs
    fp32, and how often each picks fp32 attention's greedy token."""
    def agree(a):
        return (out[a].argmax(-1) == out["fp32"].argmax(-1)).float().mean().item()

    def gap(a, b):
        d = (out[a] - out[b]).abs()
        return {"max": d.max().item(), "mean": d.mean().item()}

    return {
        "kernel_vs_plain": gap("kernel", "plain"),
        "kernel_vs_fp32": gap("kernel", "fp32"),
        "plain_vs_fp32": gap("plain", "fp32"),
        # share of positions whose greedy token matches fp32 attention's
        "kernel_token_agreement": agree("kernel"),
        "plain_token_agreement": agree("plain"),
        "logit_std": out["fp32"].std().item(),
    }


def _gap_sums(out: dict) -> dict:
    """`_gaps`' terms as sums over one forward's logits ([S, V] each of
    kernel, plain, fp32), so that several forwards pool (`_pooled_gaps`)."""
    ref = out["fp32"].argmax(-1)
    sums = {"rows": ref.numel(), "n": out["fp32"].numel(), "sum": out["fp32"].sum().item(),
            "sumsq": out["fp32"].square().sum().item()}
    for a, b in (("kernel", "plain"), ("kernel", "fp32"), ("plain", "fp32")):
        d = (out[a] - out[b]).abs()
        sums[f"{a}_vs_{b}"] = {"max": d.max().item(), "sum": d.sum().item()}
    for a in ("kernel", "plain"):
        sums[f"{a}_agree"] = (out[a].argmax(-1) == ref).sum().item()
    return sums


def _pooled_gaps(parts: list) -> dict:
    """`_gaps`' dict over every forward summed by `_gap_sums`."""
    n, rows = sum(p["n"] for p in parts), sum(p["rows"] for p in parts)
    mean = sum(p["sum"] for p in parts) / n
    g = {k: {"max": max(p[k]["max"] for p in parts), "mean": sum(p[k]["sum"] for p in parts) / n}
         for k in ("kernel_vs_plain", "kernel_vs_fp32", "plain_vs_fp32")}
    g.update({f"{a}_token_agreement": sum(p[f"{a}_agree"] for p in parts) / rows for a in ("kernel", "plain")})
    g["logit_std"] = ((sum(p["sumsq"] for p in parts) - n * mean * mean) / (n - 1)) ** 0.5
    return g


def _check_faithful(name: str, g: dict, bar: float, tokens: bool = True) -> None:
    """The kernel must sit at least as close to fp32 attention as the plain
    version does (max and mean over the logits) and, with `tokens`, pick
    fp32 attention's greedy token at least as often (a bar that needs
    thousands of rows: one flipped near-tie decides it over a few hundred).
    `bar` is the tolerance the kernel-vs-plain gap is reported against."""
    log(f"[{name}] max|kernel - plain| {g['kernel_vs_plain']['max']:.3e} (bar {bar:g}); "
        f"vs fp32 attention: kernel max {g['kernel_vs_fp32']['max']:.3e} mean "
        f"{g['kernel_vs_fp32']['mean']:.3e}, plain max {g['plain_vs_fp32']['max']:.3e} mean "
        f"{g['plain_vs_fp32']['mean']:.3e}; logits std {g['logit_std']:.3f}; greedy tokens "
        f"matching fp32: kernel {g['kernel_token_agreement']:.4f} plain {g['plain_token_agreement']:.4f}")
    ok = (
        g["kernel_vs_fp32"]["max"] <= g["plain_vs_fp32"]["max"]
        and g["kernel_vs_fp32"]["mean"] <= g["plain_vs_fp32"]["mean"]
        and (not tokens or g["kernel_token_agreement"] >= g["plain_token_agreement"])
    )
    if not ok:
        raise AssertionError(f"{name}: the kernel is farther from fp32 attention than the plain version")


def phase_parity(torch, ctx: dict) -> None:
    """Kernel vs gather on the first decode step of a llama3-8b request, at
    depths 1..32 (a prefix of the same stacked layers): the 1-layer gap is
    the kernel's own numerics, its growth with depth is how far a random-init
    model carries a bf16 difference."""
    import dataclasses

    params, cfg = _load_8b(torch, ctx)
    prompt = _prompts(cfg, 1, seed=2)[0]
    sweep = {}
    for depth in (1, 4, 16, cfg.n_layers):
        cfg_d = dataclasses.replace(cfg, n_layers=depth)
        params_d = {**params, "layers": {k: v[:depth] for k, v in params["layers"].items()}}
        out = _first_step_logits(torch, params_d, cfg_d, prompt)
        out["plain"] = out.pop("gather")
        sweep[depth] = _gaps(torch, out)
        _check_faithful(f"parity depth {depth}", sweep[depth], 3e-2)
    ctx["parity"] = {"prompt_tokens": len(prompt), "by_depth": sweep}


def phase_forward(torch, ctx: dict) -> None:
    from modal_tpu_torch.models.llama import attention, forward
    from modal_tpu_torch.ops import _build

    def fp32_attention(q, k, v, mask):
        return attention(q.float(), k.float(), v.float(), mask).to(q.dtype)

    params, cfg = _load_8b(torch, ctx)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(3)
    tokens = torch.randint(0, cfg.vocab_size, (1, 2048), generator=gen, device="cuda")
    _build.reset_launches()
    t0 = time.perf_counter()
    logits, _ = forward(params, cfg, tokens)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = _build.LAUNCHES["flash_fwd"]
    if launches != cfg.n_layers:
        raise AssertionError(f"flash_fwd launched {launches} times, want {cfg.n_layers}")
    finite = bool(torch.isfinite(logits).all())
    if not finite or list(logits.shape) != [1, 2048, cfg.vocab_size]:
        raise AssertionError("cache-less forward produced a wrong shape or non-finite logits")
    out = {"kernel": logits[0]}
    del logits
    out["plain"] = forward(params, cfg, tokens, attn_impl=attention)[0][0]
    out["fp32"] = forward(params, cfg, tokens, attn_impl=fp32_attention)[0][0]
    torch.cuda.synchronize()
    g = _gaps(torch, out)
    del out
    # the sandbox phase's exec'd calls, made here in this process on the same
    # weights and tokens: the same forward without the sandbox around it
    from modal_tpu_torch.tools.sandbox_forward import measure

    lengths = [int(x) for x in SANDBOX_LENGTHS.split(",")]
    short = measure(params, cfg, lengths, seed=0, device="cuda", gaps=False)
    short_launches = short["launches_per_call"] + short["launches_per_call_again"]
    if short_launches != [cfg.n_layers] * 2 * len(lengths):
        raise AssertionError(f"forward: K1 launches {short_launches} at {lengths} tokens, want {cfg.n_layers} a call")
    _add_launches(ctx, "flash_fwd", launches + sum(short_launches))
    ctx["forward"] = {**g, "wall_s": wall, "launches": launches, "in_process_short": short}
    log(f"[forward] llama3-8b [1, 2048] cache-less: {wall:.2f}s, flash_fwd launches {launches}")
    log(f"[forward] in process at {lengths} tokens (the sandbox phase's calls), twice each: {_ms_pairs(short)} ms "
        f"a call, device (host until the call returned) | {ctx.get('nvidia_smi') or _nvidia_smi()}")
    _check_faithful("forward", g, 5e-2)


def _release_serving_state(torch, ctx: dict) -> None:
    """Drop the 8B serving weights (and everything else the earlier phases
    left on the card) before the trainer builds its ~64 GB of state."""
    import gc

    ctx.pop("params", None)
    ctx.pop("cfg", None)
    gc.collect()
    torch.cuda.empty_cache()
    left = torch.cuda.memory_allocated()
    log(f"[train] released earlier phases: {left / 1e6:.1f} MB still allocated")
    if left > 256e6:
        live = sorted((t for t in gc.get_objects() if isinstance(t, torch.Tensor) and t.is_cuda),
                      key=lambda t: -t.untyped_storage().nbytes())
        for t in live[:12]:
            holders = sorted({type(r).__name__ for r in gc.get_referrers(t)} - {"list"})
            log(f"[train]   live: {tuple(t.shape)} {t.dtype} {t.untyped_storage().nbytes() / 1e6:.1f} MB "
                f"held by {holders}")
        raise AssertionError(f"{left / 1e9:.2f} GB still allocated before training")


def _grad_parity(torch) -> dict:
    """Grads of loss_fn on llama3-8b at full width, 2 layers, [1, 2048]
    tokens: through the kernels, through the einsum attention and through
    fp32 attention. Returns the global relative L2 error of each path's
    grads against the fp32 grads, and the tensor where it is largest.
    The kernel pass must launch K1, K2 and K3 once per layer (no remat), the
    other passes none, and the kernel grads must differ from the einsum's:
    a dispatch that sent the kernel pass to the einsum would fail here."""
    import gc

    from modal_tpu_torch.models.convert import unstack_layers
    from modal_tpu_torch.models.llama import attention, get_config, init_params
    from modal_tpu_torch.ops import _build
    from modal_tpu_torch.parallel.train import loss_fn

    cfg = get_config("llama3-8b", n_layers=2)
    params = unstack_layers(init_params(cfg, seed=0, device="cuda"))
    named = [(k, params[k]) for k in ("embed", "final_norm", "lm_head")] + [
        (f"layers[{i}].{k}", t) for i, layer in enumerate(params["layers"]) for k, t in layer.items()
    ]
    names = [n for n, _ in named]
    leaves = [t for _, t in named]
    for p in leaves:
        p.requires_grad_(True)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(4)
    tokens = torch.randint(0, cfg.vocab_size, (1, 2048), generator=gen, device="cuda")

    def fp32_attention(q, k, v, mask):
        return attention(q.float(), k.float(), v.float(), mask).to(q.dtype)

    paths = {
        "kernel": None,  # the default attn_impl: flash_attention → FlashAttentionCausal
        "einsum": attention,
        "fp32": fp32_attention,
    }
    kernels = ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")
    grads, losses = {}, {}
    for name, impl in paths.items():
        for p in leaves:
            p.grad = None
        _build.reset_launches()
        loss = loss_fn(params, cfg, tokens, False, impl)
        loss.backward()
        losses[name] = loss.item()
        grads[name] = [p.grad for p in leaves]
        got = {n: _build.LAUNCHES[n] for n in kernels}
        want = {n: cfg.n_layers if name == "kernel" else 0 for n in kernels}
        if got != want:
            raise AssertionError(f"train: the {name} pass of the grad check launched {got}, want {want}")
    _build.reset_launches()  # comparison launches do not count toward the path
    for p in leaves:
        p.grad = None

    def rel_l2(gs, ref):
        """Global and per-tensor relative L2 of `gs` against `ref`."""
        diff_sq = [torch.linalg.vector_norm(g.float() - r.float()).square() for g, r in zip(gs, ref)]
        ref_sq = [torch.linalg.vector_norm(r, dtype=torch.float32).square() for r in ref]
        per = [(d / r).sqrt().item() for d, r in zip(diff_sq, ref_sq)]
        return (torch.stack(diff_sq).sum() / torch.stack(ref_sq).sum()).sqrt().item(), per

    ref = grads.pop("fp32")
    out = {"loss": losses, "kernel_vs_einsum_rel_l2": rel_l2(grads["kernel"], grads["einsum"])[0]}
    for name, gs in grads.items():
        total, per = rel_l2(gs, ref)
        worst = max(range(len(per)), key=per.__getitem__)
        out[name] = {"global_rel_l2": total, "worst_tensor": names[worst], "worst_rel_l2": per[worst]}
    del grads, ref, params, leaves
    gc.collect()
    torch.cuda.empty_cache()
    return out


def _train_steps(torch, label: str, cfg_name: str, overrides: dict, steps: int, seq_len: int) -> dict:
    """`train_demo(cfg_name, steps, B 1, seq_len, overrides)` on one card:
    finite loss and grad norm every step, params that move once the lr is
    above 0 (the first update runs at schedule(0) = 0), per step exactly
    2 x n_layers forward launches (remat runs each layer's forward again in
    the backward) and n_layers of each backward kernel, and the second
    step's optimizer update (clip + AdamW) under
    torch.cuda.set_sync_debug_mode("error"). Returns the per-step record,
    the step times and the peak memory."""
    from modal_tpu_torch.models.llama import get_config
    from modal_tpu_torch.observability.catalog import STEP_SECONDS
    from modal_tpu_torch.ops import _build
    from modal_tpu_torch.parallel.train import Optimizer, train_demo

    cfg = get_config(cfg_name, **overrides)
    per_step: list[dict] = []

    def on_step(state, metrics):
        per_step.append({
            "step": metrics["step"], "loss": float(metrics["loss"]), "grad_norm": float(metrics["grad_norm"]),
            "launches": dict(_build.LAUNCHES), "step_s_total": STEP_SECONDS.totals(kind="train")[0],
            "wq0": state.params["layers"][0]["wq"].detach().clone(),
        })

    updates = []
    update = Optimizer.update

    def checked_update(self, opt_state, step, *rest):
        """The second update (the AdamW state exists by then) under sync
        debug mode "error": a host sync in the clip or AdamW raises."""
        if len(updates) != 1:
            updates.append(False)
            return update(self, opt_state, step, *rest)
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            norm = update(self, opt_state, step, *rest)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        updates.append(True)
        return norm

    torch.cuda.reset_peak_memory_stats()
    base_s = STEP_SECONDS.totals(kind="train")[0]
    _build.reset_launches()
    t0 = time.perf_counter()
    Optimizer.update = checked_update
    try:
        final = train_demo(cfg_name, steps=steps, per_device_batch=1, seq_len=seq_len, on_step=on_step,
                           overrides=overrides)
    finally:
        Optimizer.update = update
    wall = time.perf_counter() - t0
    if updates.count(True) != 1:
        raise AssertionError(f"{label}: the sync-checked update did not run ({updates})")
    peak = torch.cuda.max_memory_allocated()
    launches = dict(_build.LAUNCHES)
    want = {"flash_fwd": 2 * cfg.n_layers, "flash_bwd_dq": cfg.n_layers, "flash_bwd_dkv": cfg.n_layers}
    prev_launches, prev_s = {n: 0 for n in want}, base_s
    step_s = []
    for i, rec in enumerate(per_step):
        got = {n: rec["launches"][n] - prev_launches[n] for n in want}
        if got != want:
            raise AssertionError(f"{label} step {i + 1} launched {got}, want {want}")
        if not (math.isfinite(rec["loss"]) and rec["loss"] > 0 and math.isfinite(rec["grad_norm"]) and rec["grad_norm"] > 0):
            raise AssertionError(f"{label} step {i + 1}: loss {rec['loss']}, grad norm {rec['grad_norm']}")
        prev_launches = rec["launches"]
        step_s.append(rec["step_s_total"] - prev_s)
        prev_s = rec["step_s_total"]
    moved = [not torch.equal(a["wq0"], b["wq0"]) for a, b in zip(per_step, per_step[1:])]
    if not all(moved):
        raise AssertionError(f"{label}: layer 0 wq unchanged by an update with lr > 0 ({moved})")
    # the median of the steps after the first sets the steady time; the mean
    # is printed beside it, so a slow step shows
    return {"cfg": cfg, "final": final, "wall_s": wall, "step_s": step_s, "steady": statistics.median(step_s[1:]),
            "mean_s": statistics.fmean(step_s[1:]), "peak": peak, "launches": launches,
            "losses": [r["loss"] for r in per_step], "grad_norms": [r["grad_norm"] for r in per_step],
            "want": want}


def _attn_flops(cfg, seq_len: int) -> int:
    """Causal attention FLOPs of one forward: Q·K and P·V over the
    S(S+1)/2 visible pairs, every head and layer."""
    return 2 * 2 * cfg.n_heads * cfg.head_dim * (seq_len * (seq_len + 1) // 2) * cfg.n_layers


def phase_train(torch, ctx: dict) -> None:
    _release_serving_state(torch, ctx)
    t0 = time.perf_counter()
    parity = _grad_parity(torch)
    k, e = parity["kernel"], parity["einsum"]
    log(f"[train] grad parity, llama3-8b 2 layers [1, 2048], vs fp32 attention (global rel L2): "
        f"kernel {k['global_rel_l2']:.4e} (worst {k['worst_tensor']} "
        f"{k['worst_rel_l2']:.4e}); einsum {e['global_rel_l2']:.4e} "
        f"(worst {e['worst_tensor']} {e['worst_rel_l2']:.4e}); kernel vs einsum "
        f"{parity['kernel_vs_einsum_rel_l2']:.4e}; losses {parity['loss']} "
        f"({time.perf_counter() - t0:.1f}s)")
    if not k["global_rel_l2"] <= e["global_rel_l2"]:
        raise AssertionError("train: the kernel path's grads are farther from fp32 attention than the einsum path's")
    if not parity["kernel_vs_einsum_rel_l2"] > 0:
        raise AssertionError("train: the kernel path's grads equal the einsum path's")

    steps, seq_len = 4, 2048
    run = _train_steps(torch, "train", "llama3-8b", {}, steps, seq_len)
    cfg, steady, mean_s, peak, launches = run["cfg"], run["steady"], run["mean_s"], run["peak"], run["launches"]
    tokens = seq_len  # B 1
    step_flops = 6 * (cfg.param_count() - cfg.vocab_size * cfg.dim) * tokens + 3 * _attn_flops(cfg, seq_len)
    for n in run["want"]:  # flash_fwd also ran on the forward phase's path
        _add_launches(ctx, n, launches[n])
    ctx["train"] = {
        "grad_parity": parity, "steps": steps, "seq_len": seq_len, "final": run["final"], "wall_s": run["wall_s"],
        "step_s": run["step_s"], "steady_step_ms": steady * 1e3, "mean_step_ms": mean_s * 1e3,
        "tokens_per_s": tokens / steady,
        "step_flops": step_flops, "flops_bound_ms": step_flops / BF16_FLOPS * 1e3,
        "mfu": step_flops / steady / BF16_FLOPS, "peak_memory_bytes": peak,
        "losses": run["losses"], "grad_norms": run["grad_norms"], "launches": launches,
    }
    log(f"[train] train_demo llama3-8b 4 steps [1, 2048] in {run['wall_s']:.1f}s: step s "
        f"{[round(x, 4) for x in run['step_s']]}, "
        f"steady (median of steps 2-{steps}) {steady * 1e3:.1f} ms (mean {mean_s * 1e3:.1f} ms), "
        f"{tokens / steady:.1f} tokens/s, MFU {ctx['train']['mfu']:.4f} "
        f"({step_flops / 1e12:.1f} TFLOP/step, bound {step_flops / BF16_FLOPS * 1e3:.1f} ms), "
        f"peak {peak / 1e9:.2f} GB, losses {run['losses']}, grad norms "
        f"{run['grad_norms']}, launches {launches}; step 2's optimizer update (clip + AdamW) ran "
        f"under set_sync_debug_mode('error') without a host sync")


def _release(torch, label: str) -> None:
    import gc

    gc.collect()
    torch.cuda.empty_cache()
    log(f"[{label}] {torch.cuda.memory_allocated() / 1e6:.1f} MB allocated before the phase")


def _moe_dispatch_ms(torch, cfg, t: int) -> dict:
    """Device ms of one layer's MoE pieces at the path's shapes (bf16, T
    tokens): the dispatch and combine einsums over the one-hot [T, E, C]
    tensor, and the expert FFN einsums they feed."""
    e, d, f = cfg.n_experts, cfg.dim, cfg.ffn_dim
    c = int(cfg.capacity_factor * t / e)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(8)
    x = torch.randn(t, d, device="cuda", dtype=cfg.dtype, generator=gen)
    dispatch = torch.zeros(t, e, c, device="cuda", dtype=cfg.dtype)
    dispatch[torch.arange(t, device="cuda"), torch.arange(t, device="cuda") % e,
             (torch.arange(t, device="cuda") // e) % c] = 1
    w_in = torch.randn(e, d, f, device="cuda", dtype=cfg.dtype, generator=gen) * 0.02
    w_out = torch.randn(e, f, d, device="cuda", dtype=cfg.dtype, generator=gen) * 0.02
    expert_in = torch.einsum("tec,td->ecd", dispatch, x)
    h = torch.einsum("ecd,edf->ecf", expert_in, w_in)
    expert_out = torch.einsum("ecf,efd->ecd", h, w_out)
    out = {
        "dispatch_ms": time_ms(torch, lambda: torch.einsum("tec,td->ecd", dispatch, x), 10),
        "combine_ms": time_ms(torch, lambda: torch.einsum("tec,ecd->td", dispatch, expert_out), 10),
        "experts_ms": time_ms(torch, lambda: torch.einsum("ecf,efd->ecd", torch.einsum("ecd,edf->ecf", expert_in, w_in),
                                                            w_out), 10),
        "capacity": c,
    }
    del x, dispatch, w_in, w_out, expert_in, h, expert_out
    return out


def phase_moe(torch, ctx: dict) -> None:
    """llama3-8x7b-proxy at full width (dim 4096, 32 heads, 8 KV heads, FFN
    14336, 8 experts, vocab 128256, bf16, seeded random weights). (a) The
    cache-less forward on [1, 2048] tokens at full depth (32 layers): K1
    launches exactly 32 times, the kernel path sits at least as close to
    fp32 attention as the einsum path, and aux (> 0, finite) and the
    dropped fraction are printed. (b) `train_demo` with n_layers cut to 6
    (32 layers of params, grads and moments exceed one card): 4 steps of B
    1, S 2048, remat, through `_train_steps`' checks; step time, tokens/s,
    peak memory and MFU counting one expert per token."""
    from modal_tpu_torch.models.llama import attention, forward_with_aux, get_config, init_params
    from modal_tpu_torch.ops import _build
    from modal_tpu_torch.parallel import moe as moe_mod

    ctx.pop("params", None)
    ctx.pop("cfg", None)
    _release(torch, "moe")
    cfg = get_config("llama3-8x7b-proxy")
    t0 = time.perf_counter()
    params = init_params(cfg, seed=0, device="cuda")
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in [params["embed"], params["final_norm"], params["lm_head"],
                                       *params["layers"].values()])
    log(f"[moe] llama3-8x7b-proxy params: {n_params / 1e9:.2f} B, "
        f"{torch.cuda.memory_allocated() / 1e9:.2f} GB on the card, init {time.perf_counter() - t0:.1f}s")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(3)
    tokens = torch.randint(0, cfg.vocab_size, (1, 2048), generator=gen, device="cuda")

    dropped: list = []
    layer_fn = moe_mod.moe_layer

    def recording_layer(*a, **k):
        y, aux, drop = layer_fn(*a, **k)
        dropped.append(drop)
        return y, aux, drop

    def fp32_attention(q, k, v, mask):
        return attention(q.float(), k.float(), v.float(), mask).to(q.dtype)

    out = {}
    with torch.no_grad():
        _build.reset_launches()
        moe_mod.moe_layer = recording_layer
        try:
            t0 = time.perf_counter()
            logits, _, aux = forward_with_aux(params, cfg, tokens)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        finally:
            moe_mod.moe_layer = layer_fn
        launches = _build.LAUNCHES["flash_fwd"]
        if launches != cfg.n_layers:
            raise AssertionError(f"moe: flash_fwd launched {launches} times, want {cfg.n_layers}")
        if not bool(torch.isfinite(logits).all()) or list(logits.shape) != [1, 2048, cfg.vocab_size]:
            raise AssertionError("moe: the forward produced a wrong shape or non-finite logits")
        aux_v = aux.item()
        drops = [d.item() for d in dropped]
        if not (math.isfinite(aux_v) and aux_v > 0) or len(drops) != cfg.n_layers:
            raise AssertionError(f"moe: aux {aux_v}, {len(drops)} dropped fractions")
        out["kernel"] = logits[0]
        del logits
        t0 = time.perf_counter()  # the same forward again, warm (its launches are not the path's)
        forward_with_aux(params, cfg, tokens)
        torch.cuda.synchronize()
        warm = time.perf_counter() - t0
        out["plain"] = forward_with_aux(params, cfg, tokens, attn_impl=attention)[0][0]
        out["fp32"] = forward_with_aux(params, cfg, tokens, attn_impl=fp32_attention)[0][0]
        torch.cuda.synchronize()
    _build.reset_launches()
    g = _gaps(torch, out)
    del out, params
    _add_launches(ctx, "flash_fwd", launches)
    log(f"[moe] forward llama3-8x7b-proxy 32 layers [1, 2048]: {wall:.2f}s cold, {warm:.3f}s warm, "
        f"flash_fwd launches {launches}, "
        f"aux {aux_v:.5f}, dropped fraction per layer mean {statistics.fmean(drops):.4f} "
        f"(min {min(drops):.4f}, max {max(drops):.4f})")
    _check_faithful("moe", g, 5e-2)
    _release(torch, "moe")
    parts = _moe_dispatch_ms(torch, cfg, 2048)
    log(f"[moe] one layer's MoE at T 2048, C {parts['capacity']}, bf16: dispatch einsum "
        f"{parts['dispatch_ms']:.4f} ms, combine einsum {parts['combine_ms']:.4f} ms, expert FFN einsums "
        f"{parts['experts_ms']:.4f} ms (device ms, forward)")

    steps, seq_len, depth = 4, 2048, 6
    run = _train_steps(torch, "moe train", "llama3-8x7b-proxy", {"n_layers": depth}, steps, seq_len)
    tcfg, steady = run["cfg"], run["steady"]
    # active params: attention, the router and ONE expert's w_in / w_out per layer
    active = tcfg.param_count() - 2 * (tcfg.n_experts - 1) * tcfg.dim * tcfg.ffn_dim * tcfg.n_layers
    step_flops = 6 * (active - tcfg.vocab_size * tcfg.dim) * seq_len + 3 * _attn_flops(tcfg, seq_len)
    for n in run["want"]:
        _add_launches(ctx, n, run["launches"][n])
    ctx["moe"] = {
        "forward": {**g, "wall_s": wall, "warm_s": warm, "launches": launches, "aux": aux_v, "dropped": drops},
        "dispatch": parts,
        "train": {"n_layers": depth, "params": tcfg.param_count(), "active_params": active, "steps": steps,
                  "seq_len": seq_len, "step_s": run["step_s"], "steady_step_ms": steady * 1e3,
                  "mean_step_ms": run["mean_s"] * 1e3, "tokens_per_s": seq_len / steady,
                  "step_flops": step_flops, "mfu": step_flops / steady / BF16_FLOPS,
                  "peak_memory_bytes": run["peak"], "losses": run["losses"], "grad_norms": run["grad_norms"],
                  "launches": run["launches"]},
    }
    log(f"[moe] train_demo llama3-8x7b-proxy {depth} layers ({tcfg.param_count() / 1e9:.2f} B params, "
        f"{active / 1e9:.2f} B active) {steps} steps [1, {seq_len}] in {run['wall_s']:.1f}s: step s "
        f"{[round(x, 4) for x in run['step_s']]}, steady {steady * 1e3:.1f} ms (mean {run['mean_s'] * 1e3:.1f}), "
        f"{seq_len / steady:.1f} tokens/s, MFU {step_flops / steady / BF16_FLOPS:.4f} = (6 x (active params - "
        f"embedding) x tokens + 3 x causal attention FLOPs) / step time / 989 TFLOP/s "
        f"({step_flops / 1e12:.1f} TFLOP/step; dispatch/combine einsums not counted: "
        f"{(parts['dispatch_ms'] + parts['combine_ms']) * depth * 4:.2f} ms a step at 4x the forward's), "
        f"peak {run['peak'] / 1e9:.2f} GB, losses {run['losses']}, grad norms {run['grad_norms']}, "
        f"launches {run['launches']}; step 2's optimizer update ran under set_sync_debug_mode('error')")


def phase_mesh(torch, ctx: dict) -> None:
    """The mesh path on a one-rank NCCL group: build_mesh({}) (every axis
    1) through `create_sharded_state` (DTensor params, AdamW on their local
    pieces, the SPMD step), not train_demo's one-device path. llama3-8b at
    full width, 2 layers, [1, 2048], 2 steps (lr 0, then 3e-4), against the
    one-device step on the same seeded params and tokens: first-step loss
    within 1e-3 relative, params after 2 steps within a global relative L2
    of 1e-2, K1-K3 launches exact per step (2 x 2 forward with remat, 2
    each backward), AdamW's moments placed like their params."""
    import torch.distributed as dist

    from modal_tpu_torch.models.convert import unstack_layers
    from modal_tpu_torch.models.llama import get_config, init_params
    from modal_tpu_torch.ops import _build
    from modal_tpu_torch.parallel import mesh as mesh_mod
    from modal_tpu_torch.parallel.sharding import gather_train_params
    from modal_tpu_torch.parallel.train import (
        TrainConfig, TrainState, create_sharded_state, make_optimizer, make_train_step, mirror_opt_shardings,
        sharded_moments, train_state_shardings, tree_leaves,
    )

    _release(torch, "mesh")
    cfg = get_config("llama3-8b", n_layers=2)
    tc = TrainConfig(warmup_steps=1, total_steps=10)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(5)
    tokens = torch.randint(0, cfg.vocab_size, (1, 2048), generator=gen, device="cuda")
    want = {"flash_fwd": 2 * cfg.n_layers, "flash_bwd_dq": cfg.n_layers, "flash_bwd_dkv": cfg.n_layers}

    def run(state, step_fn, label):
        metrics, launches = [], []
        for _ in range(2):
            _build.reset_launches()
            state, m = step_fn(state, tokens)
            torch.cuda.synchronize()
            launches.append({n: _build.LAUNCHES[n] for n in want})
            metrics.append({k: float(v) for k, v in m.items()})
        for i, got in enumerate(launches):
            if got != want:
                raise AssertionError(f"mesh: {label} step {i + 1} launched {got}, want {want}")
        return state, metrics

    # the one-device step (train_demo's path) on the same params
    params = unstack_layers(init_params(cfg, seed=0, device="cuda"))
    for p in tree_leaves(params):
        p.requires_grad_(True)
    opt = make_optimizer(tc)
    state = TrainState(params, opt.init(params), 0)
    t0 = time.perf_counter()
    state, ref_metrics = run(state, make_train_step(cfg, tc, opt), "one-device")
    ref_s = time.perf_counter() - t0
    ref = {"embed": state.params["embed"].detach(), "final_norm": state.params["final_norm"].detach(),
           "lm_head": state.params["lm_head"].detach(),
           "layers": {k: torch.stack([layer[k].detach() for layer in state.params["layers"]])
                      for k in state.params["layers"][0]}}
    del state, params, opt
    _release(torch, "mesh")

    mesh_mod.init_process_group("cuda", world_size=1, rank=0)
    try:
        if dist.get_backend() != "nccl":
            raise AssertionError(f"mesh: the process group runs {dist.get_backend()}, not NCCL")
        mesh = mesh_mod.build_mesh({})
        t0 = time.perf_counter()
        state, step_fn, _ = create_sharded_state(mesh, cfg, tc, params=init_params(cfg, seed=0, device="cuda"))
        state, metrics = run(state, step_fn, "mesh")
        mesh_s = time.perf_counter() - t0
        shardings = train_state_shardings(state)
        mirrored = shardings["opt"] == mirror_opt_shardings(state.params) and shardings["opt"]["exp_avg"] == shardings["params"]
        moments = sharded_moments(state)
        n_dtensor = sum(type(m).__name__ == "DTensor" for m in tree_leaves(moments["exp_avg"]))
        full = gather_train_params(mesh, state.params)
        torch.cuda.synchronize()
    finally:
        dist.destroy_process_group()
    if not mirrored or n_dtensor != len(tree_leaves(state.params)):
        raise AssertionError(f"mesh: AdamW's moments are not placed like their params ({n_dtensor} DTensor moments)")
    loss_rel = abs(metrics[0]["loss"] - ref_metrics[0]["loss"]) / abs(ref_metrics[0]["loss"])
    diff_sq = ref_sq = 0.0
    for k in ("embed", "final_norm", "lm_head"):
        diff_sq += (full[k].float() - ref[k].float()).square().sum().item()
        ref_sq += ref[k].float().square().sum().item()
    for k, v in ref["layers"].items():
        diff_sq += (full["layers"][k].float() - v.float()).square().sum().item()
        ref_sq += v.float().square().sum().item()
    param_rel = (diff_sq / ref_sq) ** 0.5
    moved = not torch.equal(full["layers"]["wq"], init_params(cfg, seed=0, device="cuda")["layers"]["wq"])
    ctx["mesh"] = {"one_device": ref_metrics, "mesh": metrics, "loss_rel": loss_rel, "params_rel_l2": param_rel,
                   "one_device_s": ref_s, "mesh_s": mesh_s, "launches_per_step": want}
    for n, per in want.items():
        _add_launches(ctx, n, 2 * per)
    log(f"[mesh] llama3-8b 2 layers [1, 2048] on a one-rank NCCL mesh {mesh_mod.axis_sizes(mesh)}: losses "
        f"{[m['loss'] for m in metrics]} vs one-device {[m['loss'] for m in ref_metrics]} (first step rel "
        f"{loss_rel:.3e}, bar 1e-3); grad norms {[m['grad_norm'] for m in metrics]} vs "
        f"{[m['grad_norm'] for m in ref_metrics]}; params after 2 steps rel L2 {param_rel:.3e} (bar 1e-2); "
        f"launches per step {want} in both; {n_dtensor} AdamW moments placed like their params; "
        f"2 steps {mesh_s:.1f}s (with setup) vs one-device {ref_s:.1f}s")
    if not loss_rel <= 1e-3:
        raise AssertionError(f"mesh: first-step loss differs by {loss_rel:.3e} relative")
    if not param_rel <= 1e-2 or not moved:
        raise AssertionError(f"mesh: params after 2 steps differ by {param_rel:.3e} (moved {moved})")


# -- worker: the port's control plane, scheduler, worker and containers ---------

# what the coldstart boots build and warm: K4 at llama3-8b's decode shapes
COLDSTART_AOT = "decode,cfg=llama3-8b"
# a card count the one-card host cannot hold
WORKER_UNSAT_GPU = "H100:2"


def _tree_leaves(tree, prefix: str = "") -> list:
    """(path, tensor) for every tensor of a nested dict (sorted key order)
    and list tree."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in _tree_leaves(tree[k], f"{prefix}/{k}")]
    if isinstance(tree, (list, tuple)):
        return [leaf for i, v in enumerate(tree) for leaf in _tree_leaves(v, f"{prefix}/{i}")]
    return [(prefix, tree)]


def _checksum(torch, t) -> list:
    """A device-side checksum of a tensor's bytes: the sum of its 32-bit
    (or 8-bit) words and their sum weighted by position mod 65521, in
    int64, chunk by chunk; any flipped or moved word changes it."""
    flat = t.reshape(-1).view(torch.uint8)
    if flat.numel() % 4 == 0:
        flat = flat.view(torch.int32)
    plain = torch.zeros((), dtype=torch.int64, device=t.device)
    weighted = torch.zeros((), dtype=torch.int64, device=t.device)
    step = 1 << 26
    for off in range(0, flat.numel(), step):
        c = flat[off:off + step].to(torch.int64)
        pos = torch.arange(off, off + c.numel(), dtype=torch.int64, device=t.device) % 65521 + 1
        plain += c.sum()
        weighted += (c * pos).sum()
    return [int(plain), int(weighted)]


def _rss_bytes() -> int:
    """This process's resident set now, from /proc/self/statm; 0 if unreadable."""
    try:
        with open("/proc/self/statm") as f:
            return int(f.read().split()[1]) * os.sysconf("SC_PAGESIZE")
    except (OSError, ValueError, IndexError):
        return 0


def _sample_peak_rss(peak: list, stop) -> None:
    """Keep the largest RSS seen in peak[0], sampled every 10 ms until stop
    is set. Not ru_maxrss: Linux keeps that across execve, so a process this
    script (or its worker) spawned would report the parent's peak."""
    while not stop.wait(0.01):
        peak[0] = max(peak[0], _rss_bytes())


def _worker_serving_fn(cfg_name: str, seed: int, prompts: list):
    """The sdk phase's serving function, run as a container of the port's
    worker: it also returns what the container saw of its card."""
    serve = _sdk_serving_fn(cfg_name, seed, prompts)

    def serve_in_container() -> dict:
        import hashlib

        import torch

        from modal_tpu_torch.runtime import telemetry

        torch.cuda.reset_peak_memory_stats()
        out = serve()
        out.update(pid=os.getpid(), cuda_visible_devices=os.environ.get("CUDA_VISIBLE_DEVICES"),
                   peak_device_bytes=torch.cuda.max_memory_allocated(),
                   logits_sha256=hashlib.sha256(out["logits"].cpu().numpy().tobytes()).hexdigest(),
                   imports_top=[{"module": e["module"], "s": e["duration_s"]}
                                for e in telemetry.summarize(os.environ["MODAL_TPU_TELEMETRY_PATH"], top=5)])
        return out

    return serve_in_container


def _coldstart_class(cfg_name: str, prompts: list):
    """The coldstart boots' serialized class: `@enter(snap=True)` builds the
    replica's state (init_params, seed 0, on the card, and a lambda and a
    closure that the standard library's pickle refuses and cloudpickle
    keeps); `serve` runs the graphed engine over 8 greedy requests and
    returns the boot's measurements. The container entrypoint runs the boot
    order around them: compile hooks and fleet cache, restore or enter and
    save, ContainerCheckpoint, the AOT warm-up of K4 (MODAL_TPU_AOT_LOWER)."""
    from modal_tpu_torch.partial_function import _PartialFunctionFlags, enter, find_partial_methods_for_user_cls, method

    # what lives in this process only, not on the instance (a snapshot takes
    # the instance's attributes): the snap-enter's time, which a restored
    # boot never sets, and the peak RSS sampled from instantiation on
    init: dict = {}

    class Replica:
        def __init__(self):
            import threading

            init["peak_rss"] = [_rss_bytes()]  # sampled until the container exits
            threading.Thread(target=_sample_peak_rss, args=(init["peak_rss"], threading.Event()), daemon=True).start()

        @enter(snap=True)
        def load(self):
            import torch

            from modal_tpu_torch.models.llama import get_config, init_params

            t0 = time.time()
            cfg = get_config(cfg_name)
            self.params = init_params(cfg, seed=0, device="cuda")
            self.cfg = cfg
            self.count_tokens = lambda streams: sum(len(s) for s in streams)
            vocab = cfg.vocab_size

            def in_vocab(streams):
                return all(0 <= t < vocab for s in streams for t in s)

            self.in_vocab = in_vocab
            torch.cuda.synchronize()
            init["s"] = time.time() - t0

        @method()
        def serve(self) -> dict:
            import torch

            from modal_tpu_torch.observability import catalog, device_telemetry
            from modal_tpu_torch.ops import _build
            from modal_tpu_torch.runtime import telemetry

            out: dict = {"restored": "s" not in init, "init_s": init.get("s", 0.0)}
            t0 = time.time()  # this script's check, not a step of a boot: reported apart
            leaves = _tree_leaves(self.params)
            out["state_bytes"] = sum(t.numel() * t.element_size() for _, t in leaves)
            out["leaf_devices"] = sorted({str(t.device) for _, t in leaves})
            out["checksums"] = {path: _checksum(torch, t) for path, t in leaves}
            out["checks_s"] = time.time() - t0
            t0 = time.time()
            engine = _engine_8b(self.params, self.cfg, cuda_graphs=None)
            if engine.decode_graph is None:
                raise AssertionError("the engine on CUDA did not capture its decode step")
            out["capture_s"] = time.time() - t0
            _build.reset_launches()
            t_submit = time.time()
            reqs = [engine.submit(p, NEW_TOKENS) for p in prompts]  # queued before the loop starts
            engine.start()
            try:
                streams = [r.result(timeout=600) for r in reqs]
            finally:
                engine.stop()
            _check_streams("coldstart", streams, self.cfg.vocab_size)
            out["snap_functions"] = {"count_tokens": self.count_tokens(streams), "in_vocab": self.in_vocab(streams),
                                     "closure_cells": len(self.in_vocab.__closure__ or ())}
            out.update({
                "first_token_at": t_submit + min(r.ttft_s for r in reqs),
                "submit_to_first_token_s": min(r.ttft_s for r in reqs),
                "ttft_first_request_s": reqs[0].ttft_s,
                "serve_s": time.time() - t_submit,
                "streams": streams,
                "decode_steps": engine.stats()["steps"],
                "launches": dict(_build.LAUNCHES),
                "loaded_kernels": sorted(_build._libs),
                "nvcc_runs": int(catalog.COMPILE_EVENTS.value(event="compile", source="runtime")),
                "fleet_hits": int(catalog.COMPILE_CACHE_HITS.total()),
                "fleet_puts": int(catalog.COMPILE_CACHE_PUTS.total()),
                "peak_rss_bytes": max(init["peak_rss"][0], _rss_bytes()) or None,  # None: statm unreadable
                "peak_device_bytes": torch.cuda.max_memory_allocated(),
                "imports_top": [
                    {"module": e["module"], "s": e["duration_s"]}
                    for e in telemetry.summarize(os.environ["MODAL_TPU_TELEMETRY_PATH"], top=5)
                ],
                "telemetry_summary": device_telemetry.telemetry_summary(),
                "cuda_visible_devices": os.environ.get("CUDA_VISIBLE_DEVICES"),
            })
            return out

    find_partial_methods_for_user_cls(Replica, _PartialFunctionFlags.all())  # what a class decorator registers
    return Replica


class _Plane:
    """Raw RPCs from the port's client to the port's control plane, on the
    port's synchronizer thread: one app at a time, functions on it, calls
    whose context the control plane carries to the containers' spans."""

    def __init__(self, sup):
        from modal_tpu_torch.client import _Client

        self.sup = sup
        self.client = _Client(sup.server_url)
        self.client._open()  # blocking: synchronize_api wrapped the client's coroutines
        self.app_id = ""

    def run(self, coro):
        from modal_tpu_torch._utils.async_utils import synchronizer

        return synchronizer.run(coro)

    def call(self, name: str, req):
        from modal_tpu_torch._utils.grpc_utils import retry_transient_errors

        return self.run(retry_transient_errors(getattr(self.client.stub, name), req))

    def new_app(self, description: str) -> str:
        from modal_tpu_torch.proto import api_pb2

        self.app_id = self.call("AppCreate", api_pb2.AppCreateRequest(description=description)).app_id
        return self.app_id

    def stop_app(self, timeout: float = 120.0) -> None:
        """Stop the app and wait until each of its tasks has finished."""
        from modal_tpu_torch.proto import api_pb2

        self.call("AppStop", api_pb2.AppStopRequest(app_id=self.app_id))
        self.wait_finished(self.app_id, timeout)

    def wait_finished(self, app_id: str, timeout: float = 120.0) -> None:
        """Wait until each task of the stopped app `app_id` has finished and
        its container process has exited (the card is free for the next)."""
        deadline = time.monotonic() + timeout
        while True:
            ids = {t.task_id for t in list(self.sup.state.tasks.values()) if t.app_id == app_id}
            if all(self.sup.state.tasks[i].finished_at for i in ids) and not any(
                    ids & set(w._procs) for w in self.sup.workers):
                return
            if time.monotonic() > deadline:
                raise AssertionError(f"the tasks of {app_id} did not finish in {timeout}s")
            time.sleep(0.2)

    def create(self, tag: str, gpu: str, **fields) -> str:
        from modal_tpu_torch.gpu_config import parse_gpu_config
        from modal_tpu_torch.proto import api_pb2

        fdef = api_pb2.Function(function_name=tag, definition_type="serialized", **fields)
        fdef.resources.gpu_config.CopyFrom(parse_gpu_config(gpu).to_proto())
        fdef.autoscaler_settings.scaledown_window = 600  # kept warm for a second input
        req = api_pb2.FunctionCreateRequest(app_id=self.app_id, function=fdef, tag=tag)
        return self.call("FunctionCreate", req).function_id

    def task_logs(self) -> str:
        """The tail of every container's stderr under the supervisor's state dir."""
        tails = []
        for task_id in sorted(self.sup.state.tasks):
            path = os.path.join(self.sup.state_dir, "tasks", task_id, "stderr.log")
            if os.path.exists(path):
                with open(path, errors="replace") as f:
                    tails.append(f"--- {task_id} stderr ---\n{f.read()[-3000:]}")
        return "\n".join(tails)

    def remote(self, fn_id: str, method_name: str = "", timeout: float = 300.0) -> dict:
        """One input through FunctionMap (under a span, so the launch and the
        container's boot spans join its trace) and FunctionGetOutputs; the
        result fetched from the blob server when it went there."""
        from modal_tpu_torch._utils.blob_utils import resolve_blob_data
        from modal_tpu_torch._utils.grpc_utils import retry_transient_errors
        from modal_tpu_torch.observability import tracing
        from modal_tpu_torch.proto import api_pb2
        from modal_tpu_torch.serialization import serialize

        inp = api_pb2.FunctionInput(args=serialize(((), {})), data_format=api_pb2.DATA_FORMAT_PICKLE,
                                    method_name=method_name)
        req = api_pb2.FunctionMapRequest(function_id=fn_id, pipelined_inputs=[api_pb2.FunctionPutInputsItem(idx=0, input=inp)])

        async def submit():
            with tracing.span("chip_smoke.remote") as sp:
                resp = await retry_transient_errors(self.client.stub.FunctionMap, req)
            return resp.function_call_id, sp.trace_id

        t_map = time.time()
        call_id, trace_id = self.run(submit())
        deadline = time.monotonic() + timeout
        while True:
            if time.monotonic() > deadline:
                raise AssertionError(f"worker: no output of {fn_id} in {timeout}s\n{self.task_logs()}")
            resp = self.call("FunctionGetOutputs", api_pb2.FunctionGetOutputsRequest(
                function_call_id=call_id, timeout=30, clear_on_success=True))
            if resp.outputs:
                break
        t_out = time.time()
        result = resp.outputs[0].result
        out = {"t_map": t_map, "t_output": t_out, "trace_id": trace_id, "status": result.status,
               "exception": result.exception, "traceback": result.traceback, "blob_id": result.data_blob_id}
        if result.status == api_pb2.GENERIC_STATUS_SUCCESS:
            t0 = time.perf_counter()
            out["data"] = self.run(resolve_blob_data(result, self.client.stub))
            out["download_s"] = time.perf_counter() - t0
        return out

    def close(self) -> None:
        self.client._close()


def _spans_of(sup, trace_id: str) -> dict:
    """{span name: span record (start, end, attrs, ...)} of one call's
    trace, across the processes that wrote to the supervisor's span sink."""
    from modal_tpu_torch.observability import tracing

    return {s["name"]: s for s in tracing.read_spans(tracing.trace_dir()) if s["trace_id"] == trace_id}


BOOT_PARTS = ("container.import_torch", "container.imports", "container.snapshot_state", "container.enter_hooks",
              "container.aot_lower")


def _boot_split(sup, task, call: dict) -> dict:
    """A container's boot from the worker's spawn decision, by part: the
    interpreter up to ContainerHello (python, the runtime, the client), then
    `import torch` on the main thread (a function that asks for a card), the
    user's code, the snapshot state (restore, or enter and
    save), the other enter hooks, the AOT warm-up, then to the first output
    (the first input's execution). FunctionMap → first output on the
    client's clock beside it. Every part must have its span, and the AOT
    warm-up must have built every entry: the entrypoint writes no
    `container.aot_lower` span when the warm-up did not run, and a failed
    entry only into that span's `errors`."""
    spans = _spans_of(sup, call["trace_id"])
    missing = [name for name in ("container.boot",) + BOOT_PARTS if name not in spans]
    if missing:
        raise AssertionError(f"worker: the call's trace has no {missing} span (it has {sorted(spans)})")
    errors = spans["container.aot_lower"]["attrs"].get("errors")
    if errors:
        raise AssertionError(f"worker: the container's AOT warm-up failed: {errors}")
    if spans["container.import_torch"]["attrs"]["thread"] != "MainThread":
        raise AssertionError(f"worker: torch loaded on {spans['container.import_torch']['attrs']['thread']}")
    t0, ready = spans["container.boot"]["start"], spans["container.boot"]["end"]
    part = {name: spans[name]["end"] - spans[name]["start"] for name in BOOT_PARTS}
    return {
        "spawn_to_hello_s": task.started_at - t0,
        "import_torch_s": part["container.import_torch"],
        "user_import_s": part["container.imports"],
        "snapshot_state_s": part["container.snapshot_state"],
        "enter_s": part["container.enter_hooks"],
        "aot_s": part["container.aot_lower"],
        "spawn_to_ready_s": ready - t0,
        "spawn_to_first_output_s": task.first_output_at - t0,
        "hello_to_first_output_s": task.first_output_at - task.started_at,
        "map_to_output_s": call["t_output"] - call["t_map"],
        "spawn_at": t0,
    }


def _split_line(b: dict) -> str:
    return (f"FunctionMap → output {b['map_to_output_s']:.2f}s; from the spawn: ContainerHello "
            f"{b['spawn_to_hello_s']:.2f}s, import torch {b['import_torch_s']:.2f}s, user import "
            f"{b['user_import_s']:.3f}s, snapshot state "
            f"{b['snapshot_state_s']:.2f}s, enter {b['enter_s']:.3f}s, AOT {b['aot_s']:.2f}s, ready "
            f"{b['spawn_to_ready_s']:.2f}s, first output {b['spawn_to_first_output_s']:.2f}s")


def _boot_line(b: dict) -> str:
    """A coldstart boot from the spawn to its first token (this script's
    checksums left out), part by part; "other" is what no part covers."""
    gb = b["state_bytes"] / 1e9
    sp = b["split"]
    snap = sp["snapshot_state_s"]
    if b["restored"]:
        state = f"restore {snap:.2f}s ({gb / snap:.2f} GB/s)"
    else:
        save = snap - b["init_s"]
        state = f"init {b['init_s']:.2f}s + save {save:.2f}s ({gb / save:.2f} GB/s)"
    parts = (sp["spawn_to_hello_s"] + sp["import_torch_s"] + sp["user_import_s"] + snap + sp["enter_s"] + sp["aot_s"]
             + b["capture_s"] + b["submit_to_first_token_s"])
    top = ", ".join(f"{e['module']} {e['s']:.2f}s" for e in b["imports_top"])
    return (f"spawn → first token {b['first_token_s']:.2f}s = spawn → ContainerHello {sp['spawn_to_hello_s']:.2f}s "
            f"+ import torch {sp['import_torch_s']:.2f}s + user import {sp['user_import_s']:.3f}s + {state} (CUDA "
            f"init inside) + kernels "
            f"{sp['aot_s']:.2f}s ({b['nvcc_runs']} nvcc runs, {b['fleet_hits']} fleet hits, {b['fleet_puts']} "
            f"puts) + graph capture {b['capture_s']:.2f}s + submit → first token {b['submit_to_first_token_s']:.2f}s "
            f"+ other {b['first_token_s'] - parts:.2f}s (checksums, {b['checks_s']:.2f}s, left out); first-request "
            f"TTFT {b['ttft_first_request_s']:.3f}s; peak RSS "
            + (f"{b['peak_rss_bytes'] / 1e9:.2f} GB (sampled every 10 ms from the class's instantiation on)"
               if b["peak_rss_bytes"] else "not measured")
            + f", peak device {b['peak_device_bytes'] / 1e9:.2f} GB; the boot's slowest imports: {top}")


def _worker_env(root: str) -> dict:
    """What the containers of the phase read from this process's
    environment (the worker hands its own to each container): the coldstart
    boots' fleet-cache gate, snapshot dir, AOT warm-up and import trace,
    and no build dir of this process (each task builds in its own)."""
    return {"MODAL_TPU_COMPILE_CACHE": "1", "MODAL_TPU_SNAPSHOT_DIR": os.path.join(root, "snapshots"),
            "MODAL_TPU_AOT_LOWER": COLDSTART_AOT, "MODAL_TPU_IMPORT_TRACE": "1", "TORCH_EXTENSIONS_DIR": None,
            "MODAL_TPU_COMPILE_CACHE_DIR": None, "MODAL_TPU_COMPILE_CACHE_URL": None}


def _serve_through_worker(torch, ctx: dict, sup, smi: str) -> None:
    """Steps 1-5: the llama3-8b serving function asked for with gpu="H100",
    placed, run in a container pinned to the card, twice; then an ask the
    host cannot hold."""
    import hashlib

    from modal_tpu_torch.models.llama import get_config
    from modal_tpu_torch.proto import api_pb2
    from modal_tpu_torch.serialization import deserialize, serialize
    from modal_tpu_torch.server.scheduler import PLACEMENT_UNSAT_GRACE_S

    cfg = get_config("llama3-8b")
    prompts = _prompts(cfg, 8, seed=1)
    plane = _Plane(sup)
    try:
        plane.new_app("chip_smoke worker")
        blob = serialize(_worker_serving_fn("llama3-8b", 0, prompts))
        fn_id = plane.create("serve", "H100", function_serialized=blob)
        log(f"[worker] FunctionCreate serve ({len(blob)} bytes, gpu='H100'); {torch.cuda.memory_allocated() / 1e6:.1f} MB "
            f"allocated here before the container spawns")
        calls, results = [], []
        for i in range(2):
            call = plane.remote(fn_id)
            if call["status"] != api_pb2.GENERIC_STATUS_SUCCESS:
                raise AssertionError(f"worker: input {i} failed: {call['exception']}\n{call['traceback'][-4000:]}\n"
                                     f"{plane.task_logs()}")
            t0 = time.perf_counter()
            result = deserialize(call["data"])
            call["deserialize_s"] = time.perf_counter() - t0
            calls.append(call)
            results.append(result)
        tasks = plane.call("TaskList", api_pb2.TaskListRequest()).tasks
        mine = [t for t in tasks if t.app_id == plane.app_id]
        first, second = results
        if len(mine) != 1 or list(mine[0].gpu_ids) != [0]:
            raise AssertionError(f"worker: TaskList shows {[(t.task_id, list(t.gpu_ids)) for t in mine]}")
        if first["pid"] != second["pid"]:
            raise AssertionError(f"worker: the second input ran in pid {second['pid']}, the first in {first['pid']}")
        task = sup.state.tasks[mine[0].task_id]
        kind = torch.cuda.get_device_name(0)
        for i, r in enumerate(results):
            logits = r["logits"]
            on_card = logits.to("cuda")  # rebuilt on this process's card
            digest = hashlib.sha256(logits.numpy().tobytes()).hexdigest()
            if (type(logits) is not torch.Tensor or logits.dtype != torch.float32
                    or tuple(logits.shape) != (8, cfg.vocab_size) or not torch.isfinite(on_card).all()):
                raise AssertionError(f"worker: input {i}'s logits came back as {type(logits)} "
                                     f"{getattr(logits, 'dtype', '')} {tuple(getattr(logits, 'shape', ()))}")
            if digest != r["logits_sha256"]:
                raise AssertionError(f"worker: input {i}'s logits sha256 {digest} here, {r['logits_sha256']} in the container")
            if "sdk" in ctx and digest != ctx["sdk"]["function"]["logits_sha256"]:
                raise AssertionError(f"worker: input {i}'s logits sha256 {digest}, the sdk child's "
                                     f"{ctx['sdk']['function']['logits_sha256']}")
            steps, k4 = r["decode_steps"], r["paged_decode_launches"]
            if steps == 0 or k4 != cfg.n_layers * steps:
                raise AssertionError(f"worker: input {i}: paged_decode launched {k4} times over {steps} decode steps")
            if r["cuda_visible_devices"] != str(mine[0].gpu_ids[0]) or r["device"] != kind:
                raise AssertionError(f"worker: input {i}: the container saw CUDA_VISIBLE_DEVICES="
                                     f"{r['cuda_visible_devices']!r} and {r['device']!r}; pinned {list(mine[0].gpu_ids)}, "
                                     f"the card is {kind!r}")
            _check_streams("worker", r["streams"], cfg.vocab_size)
            if "serve_streams" in ctx:
                diverged = _first_divergence(ctx["serve_streams"], r["streams"], ctx.get("serve_logits", {}), {})
                bad = [d for d in diverged if d["sampled"] or d["gap"] > SELF_DRAFT_TIE]
                if bad:
                    raise AssertionError(f"worker: input {i}'s streams differ from the serve phase's beyond a greedy "
                                         f"near-tie: {bad}")
                r["streams_equal"] = 8 - len(diverged)
            _add_launches(ctx, "paged_decode", k4)
            del on_card
        split = _boot_split(sup, task, calls[0])
        nbytes = len(calls[0]["data"])
        t0 = time.perf_counter()
        up_id = plane.run(_blob_upload(calls[0]["data"], plane.client.stub))
        up_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        back = plane.run(_blob_download(up_id, plane.client.stub))
        down_s = time.perf_counter() - t0
        if bytes(back) != bytes(calls[0]["data"]):
            raise AssertionError("worker: the result payload came back from the blob server changed")
        log(f"[worker] served through the port's supervisor, scheduler and worker: task {task.task_id} pinned to "
            f"card {list(mine[0].gpu_ids)}, the container saw CUDA_VISIBLE_DEVICES={first['cuda_visible_devices']!r} "
            f"and {first['device']!r}; input 1 (cold): {_split_line(split)}; input 2 (warm, same task, pid "
            f"{second['pid']}): FunctionMap → output {calls[1]['t_output'] - calls[1]['t_map']:.2f}s | {smi}")
        for i, (r, c) in enumerate(zip(results, calls)):
            log(f"[worker] input {i + 1}: 8 requests x {NEW_TOKENS} tokens in {r['wall_s']:.2f}s, {r['decode_steps']} "
                f"decode steps, paged_decode launches {r['paged_decode_launches']} (= {cfg.n_layers} x "
                f"{r['decode_steps']}); logits [8, {cfg.vocab_size}] fp32 sha256 {r['logits_sha256'][:16]}… equal to "
                f"the container's{' and the sdk child' + chr(39) + 's' if 'sdk' in ctx else ''}; streams equal to "
                f"serve's: {r.get('streams_equal', 'serve not run')}/8; result {len(c['data'])} bytes through blob "
                f"{c['blob_id']}, fetched in {c['download_s'] * 1e3:.2f} ms, deserialized in "
                f"{c['deserialize_s'] * 1e3:.2f} ms; the container's peak device memory "
                f"{r['peak_device_bytes'] / 1e9:.2f} GB")
        log(f"[worker] blob server, the result payload ({nbytes} bytes) from this process: upload {up_s * 1e3:.2f} ms "
            f"({nbytes / up_s / 1e9:.3f} GB/s), download {down_s * 1e3:.2f} ms ({nbytes / down_s / 1e9:.3f} GB/s)")

        unsat_id = plane.create("unsat", WORKER_UNSAT_GPU, function_serialized=serialize(lambda: "never"))
        refused = plane.remote(unsat_id, timeout=120)
        waited = refused["t_output"] - refused["t_map"]
        want = f"unsatisfiable placement for unsat: gpu={WORKER_UNSAT_GPU} matches no registered worker"
        if refused["status"] != api_pb2.GENERIC_STATUS_FAILURE or refused["exception"] != want:
            raise AssertionError(f"worker: gpu={WORKER_UNSAT_GPU!r} gave {refused['status']} {refused['exception']!r}")
        if waited < PLACEMENT_UNSAT_GRACE_S - 0.1:
            raise AssertionError(f"worker: the refusal came after {waited:.2f}s, before the grace window")
        if any(t.function_id == unsat_id for t in sup.state.tasks.values()):
            raise AssertionError("worker: a task was launched for the unsatisfiable ask")
        log(f"[worker] gpu={WORKER_UNSAT_GPU!r} on this one-card host: refused after {waited:.2f}s "
            f"(grace {PLACEMENT_UNSAT_GRACE_S}s): {refused['exception']!r}")
        crash = _crash_restart_through_worker(torch, ctx, sup, plane, fn_id, cfg, first["logits_sha256"], smi)
        plane.stop_app()
        _fastpath_lines(sup, crash, smi)
    finally:
        plane.close()
    ctx["worker"] = {
        "function_bytes": len(blob), "task_id": task.task_id, "gpu_ids": list(mine[0].gpu_ids),
        "cuda_visible_devices": first["cuda_visible_devices"], "split_cold": split,
        "map_to_output_s": [c["t_output"] - c["t_map"] for c in calls],
        "results": [{k: v for k, v in r.items() if k not in ("logits", "streams")} for r in results],
        "result_bytes": nbytes, "blob_upload_s": up_s, "blob_download_s": down_s,
        "unsat": {"waited_s": waited, "exception": refused["exception"]}, "nvidia_smi": smi,
        "crash": crash,
    }


def _map_outputs(plane, call_id: str, n: int, timeout: float) -> list:
    """n outputs of one call, taken with clear_on_success."""
    from modal_tpu_torch.proto import api_pb2

    outs, deadline = [], time.monotonic() + timeout
    while len(outs) < n:
        if time.monotonic() > deadline:
            raise AssertionError(f"worker: {len(outs)}/{n} outputs of {call_id} in {timeout}s\n{plane.task_logs()}")
        outs += plane.call("FunctionGetOutputs", api_pb2.FunctionGetOutputsRequest(
            function_call_id=call_id, timeout=30, clear_on_success=True)).outputs
    return list(outs)


def _spans_named(name: str) -> list:
    from modal_tpu_torch.observability import tracing

    return [s for s in tracing.read_spans(tracing.trace_dir()) if s["name"] == name]


def _crash_restart_through_worker(torch, ctx: dict, sup, plane, fn_id: str, cfg, want_sha: str, smi: str) -> dict:
    """Steps 7-9: a FunctionMap of two inputs under one idempotency key into
    the warm container; once the first output is in and the second input is
    claimed, the control plane crash-restarts from its journal. The map
    re-sent across the restart answers the same call; the second input runs
    again in a new container; each idx delivers one output. Then the second
    result's blob fetched by path and over HTTP in turns."""
    from modal_tpu_torch._utils.blob_utils import blob_download
    from modal_tpu_torch.proto import api_pb2
    from modal_tpu_torch.serialization import deserialize, serialize

    inp = api_pb2.FunctionInput(args=serialize(((), {})), data_format=api_pb2.DATA_FORMAT_PICKLE)
    req = api_pb2.FunctionMapRequest(function_id=fn_id, function_call_type=api_pb2.FUNCTION_CALL_TYPE_MAP,
                                     pipelined_inputs=[api_pb2.FunctionPutInputsItem(idx=i, input=inp) for i in range(2)])
    key = [("x-idempotency-key", "chip_smoke-crash-map")]
    t_map = time.time()
    call_id = plane.run(plane.client.stub.FunctionMap(req, metadata=key, timeout=60)).function_call_id
    (before,) = _map_outputs(plane, call_id, 1, timeout=300)
    t_first = time.time()
    other = [i for i in sup.state.inputs.values() if i.function_call_id == call_id and i.idx != before.idx]
    deadline = time.monotonic() + 60
    while other[0].status != "claimed":
        if time.monotonic() > deadline:
            raise AssertionError(f"worker: the second input stayed {other[0].status!r} for 60 s")
        time.sleep(0.005)
    killed_task = other[0].claimed_by
    proc = sup.workers[0]._procs.get(killed_task)
    killed_pid = proc.pid if proc is not None else None
    claimed_s = time.time() - other[0].claimed_at
    n_calls = len(sup.state.function_calls)
    t0 = time.perf_counter()
    report = plane.run(sup.crash_restart())
    restart_s = time.perf_counter() - t0
    if report is None or report["inputs_requeued"] != 1 or report["records_skipped"] != 0:
        raise AssertionError(f"worker: the recovery report {report}")
    if len(sup.state.function_calls) != n_calls:
        raise AssertionError(f"worker: {n_calls} calls before the crash, {len(sup.state.function_calls)} recovered")
    again = plane.run(plane.client.stub.FunctionMap(req, metadata=key, timeout=60))
    if again.function_call_id != call_id or len(sup.state.function_calls) != n_calls:
        raise AssertionError(f"worker: the retried FunctionMap answered {again.function_call_id} (first {call_id}), "
                             f"{len(sup.state.function_calls)} calls (before {n_calls})")
    if sup.state.function_calls[call_id].num_inputs != 2:
        raise AssertionError(f"worker: the call holds {sup.state.function_calls[call_id].num_inputs} inputs after the retry")
    (after,) = _map_outputs(plane, call_id, 1, timeout=600)
    t_second = time.time()
    extra = plane.call("FunctionGetOutputs", api_pb2.FunctionGetOutputsRequest(
        function_call_id=call_id, timeout=2, clear_on_success=True)).outputs
    outs = [before, after, *extra]
    if sorted(o.idx for o in outs) != [0, 1]:
        raise AssertionError(f"worker: outputs by idx {sorted(o.idx for o in outs)} across the restart, want [0, 1]")
    got = {}
    for o in outs:
        if o.result.status != api_pb2.GENERIC_STATUS_SUCCESS:
            raise AssertionError(f"worker: idx {o.idx} failed across the restart: {o.result.exception}\n"
                                 f"{o.result.traceback[-3000:]}\n{plane.task_logs()}")
        got[o.idx] = deserialize(plane.run(_blob_download(o.result.data_blob_id, plane.client.stub)))
    for idx, r in got.items():
        if r["logits_sha256"] != want_sha:
            raise AssertionError(f"worker: idx {idx}'s logits sha256 {r['logits_sha256']} across the restart, {want_sha} before")
        if r["paged_decode_launches"] != cfg.n_layers * r["decode_steps"]:
            raise AssertionError(f"worker: idx {idx}: paged_decode {r['paged_decode_launches']} over {r['decode_steps']} steps")
        _check_streams("worker crash", r["streams"], cfg.vocab_size)
        _add_launches(ctx, "paged_decode", r["paged_decode_launches"])
    late = got[after.idx]
    (new_task,) = [t for t in sup.state.tasks.values() if t.function_id == fn_id]
    if late["pid"] == killed_pid or late["pid"] == got[before.idx]["pid"]:
        raise AssertionError(f"worker: idx {after.idx} came from pid {late['pid']}, the killed attempt's was {killed_pid}")
    log(f"[worker:crash] FunctionMap of 2 inputs (one idempotency key); idx {before.idx} out after "
        f"{t_first - t_map:.2f}s; idx {after.idx} claimed by {killed_task} (pid {killed_pid}) {claimed_s:.3f}s before "
        f"crash_restart ({restart_s * 1e3:.1f} ms): records replayed {report['records_applied']}, inputs requeued "
        f"{report['inputs_requeued']}, skipped by type {report['skipped_by_type'] or 'none'}, replay "
        f"{report['seconds'] * 1e3:.2f} ms, open calls {report['open_calls']}, workers awaiting re-adoption "
        f"{report['workers_pending_adoption']} | {smi}")
    log(f"[worker:crash] idx {after.idx} ran again: delivered by {new_task.task_id} (pid {late['pid']}, a new container, "
        f"attempt retry_count {after.retry_count}) {t_second - t_first:.2f}s after the first output; one output per idx; "
        f"logits sha256 {want_sha[:16]}… on both; the retried FunctionMap answered the same call {call_id} and the "
        f"plane holds {n_calls} calls, as before")
    # the blob handoff on and off, in turns
    plane.client.hello()  # learns the plane's blob dir (and socket) from ClientHello
    stub, blob_id = plane.client.stub, after.result.data_blob_id
    ref = bytes(plane.run(_blob_download(blob_id, stub)))
    saved = os.environ.get("MODAL_TPU_FASTPATH_BLOB")
    times: dict = {"path": [], "http": []}
    rungs0 = stub.rungs["BlobDownload:blob_local"]
    try:
        for r in range(TIMING_ROUNDS):
            for mode in (("path", "http") if r % 2 == 0 else ("http", "path")):
                os.environ["MODAL_TPU_FASTPATH_BLOB"] = "1" if mode == "path" else "0"
                t0 = time.perf_counter()
                data = plane.run(blob_download(blob_id, stub))
                times[mode].append(time.perf_counter() - t0)
                if bytes(data) != ref:
                    raise AssertionError(f"worker: the result fetched by {mode} differs")
    finally:
        os.environ.pop("MODAL_TPU_FASTPATH_BLOB", None)
        if saved is not None:
            os.environ["MODAL_TPU_FASTPATH_BLOB"] = saved
    if stub.rungs["BlobDownload:blob_local"] - rungs0 != TIMING_ROUNDS:
        raise AssertionError(f"worker: {stub.rungs['BlobDownload:blob_local'] - rungs0} fetches took the path")
    med = {m: statistics.median(v) for m, v in times.items()}
    log(f"[worker:blob] the {len(ref)}-byte result of idx {after.idx}, median of {TIMING_ROUNDS} in turns [min, max]: "
        f"by path {med['path'] * 1e3:.3f} ms [{min(times['path']) * 1e3:.3f}, {max(times['path']) * 1e3:.3f}] "
        f"({len(ref) / med['path'] / 1e9:.2f} GB/s), over HTTP {med['http'] * 1e3:.3f} ms "
        f"[{min(times['http']) * 1e3:.3f}, {max(times['http']) * 1e3:.3f}] ({len(ref) / med['http'] / 1e9:.2f} GB/s); "
        f"bytes equal | {smi}")
    return {"call_id": call_id, "report": report, "restart_s": restart_s, "killed_task": killed_task,
            "killed_pid": killed_pid, "claimed_before_crash_s": claimed_s, "new_task": new_task.task_id,
            "new_pid": late["pid"], "retry_count": after.retry_count, "first_output_s": t_first - t_map,
            "second_output_after_first_s": t_second - t_first, "result_bytes": len(ref),
            "fetch_path_s": times["path"], "fetch_http_s": times["http"],
            "new_split": _task_split(new_task),
            "new_imports_top": late["imports_top"]}


def _task_split(task) -> dict:
    """A task's spawn → ContainerHello, its `import torch` and ContainerHello
    → first output, from its container's spans (found by task id: a task
    launched for a recovered input carries no trace context)."""
    (boot,) = [s for s in _spans_named("container.boot") if s["attrs"].get("task_id") == task.task_id]
    (imp,) = [s for s in _spans_named("container.import_torch") if s["attrs"].get("task_id") == task.task_id]
    if imp["attrs"]["thread"] != "MainThread":
        raise AssertionError(f"worker: {task.task_id} loaded torch on {imp['attrs']['thread']}")
    return {"spawn_to_hello_s": task.started_at - boot["start"], "import_torch_s": imp["end"] - imp["start"],
            "hello_to_first_output_s": task.first_output_at - task.started_at}


def _fastpath_lines(sup, crash: dict, smi: str) -> None:
    """The containers' own result uploads and the rung each container RPC
    took, from their spans (a container writes its rung tally at exit: the
    one killed by the crash has none)."""
    uploads = _spans_named("container.blob_upload")
    if not uploads:
        raise AssertionError("worker: no container.blob_upload span in the plane's trace dir")
    for s in uploads:
        a = s["attrs"]
        log(f"[worker:blob] container {a['task_id']} uploaded its {a['bytes']}-byte result by {a['rung']} in "
            f"{(s['end'] - s['start']) * 1e3:.2f} ms ({a['bytes'] / max(s['end'] - s['start'], 1e-9) / 1e9:.2f} GB/s)")
    crash["uploads"] = [{"task_id": s["attrs"]["task_id"], "bytes": s["attrs"]["bytes"], "rung": s["attrs"]["rung"],
                         "s": s["end"] - s["start"]} for s in uploads]
    tallies = {s["attrs"]["task_id"]: s["attrs"] for s in _spans_named("container.fastpath")}
    if crash["new_task"] not in tallies:
        raise AssertionError(f"worker: the container {crash['new_task']} wrote no container.fastpath span")
    for task_id, a in sorted(tallies.items()):
        rungs = a["rungs"]
        off = {k: n for k, n in rungs.items() if not k.endswith((":uds", ":blob_local"))}
        if off:
            raise AssertionError(f"worker: container {task_id} left the local rungs: {off}")
        log(f"[worker:rungs] container {task_id} (socket {a['uds']}): " + ", ".join(
            f"{k} {n}" for k, n in sorted(rungs.items())))
    crash["rungs"] = {task_id: a["rungs"] for task_id, a in tallies.items()}

async def _blob_upload(data, stub) -> str:
    from modal_tpu_torch._utils.blob_utils import blob_upload

    return await blob_upload(data, stub)


async def _blob_download(blob_id: str, stub):
    from modal_tpu_torch._utils.blob_utils import blob_download

    return await blob_download(blob_id, stub)


def _coldstart_through_worker(torch, ctx: dict, sup, root: str, smi: str) -> None:
    """Step 6: the replica booted fresh, then warm, each a container of the
    port's worker running the real entrypoint's boot order."""
    from modal_tpu_torch.models.llama import get_config, init_params_abstract
    from modal_tpu_torch.models.quant import quantized_bytes
    from modal_tpu_torch.proto import api_pb2
    from modal_tpu_torch.serialization import deserialize, serialize

    cfg = get_config("llama3-8b")
    nbytes = quantized_bytes(init_params_abstract(cfg))
    plane = _Plane(sup)
    class_bytes = serialize(_coldstart_class("llama3-8b", _prompts(cfg, 8, seed=1)))
    boots: dict = {}
    try:
        for role in ("fresh", "warm"):
            plane.new_app(f"chip_smoke coldstart {role}")
            fn_id = plane.create("Replica", "H100", is_class=True, class_serialized=class_bytes,
                                 enable_memory_snapshot=True, experimental_options={"methods": "serve"})
            call = plane.remote(fn_id, method_name="serve")
            if call["status"] != api_pb2.GENERIC_STATUS_SUCCESS:
                raise AssertionError(f"coldstart: the {role} boot failed: {call['exception']}\n"
                                     f"{call['traceback'][-4000:]}\n{plane.task_logs()}")
            b = deserialize(call["data"])
            (task,) = [t for t in sup.state.tasks.values() if t.app_id == plane.app_id]
            b["role"] = role
            b["split"] = _boot_split(sup, task, call)
            b["first_token_s"] = b["first_token_at"] - b["split"]["spawn_at"] - b["checks_s"]
            plane.stop_app()
            if role == "fresh":
                snap = os.path.join(root, "snapshots")
                files = [os.path.join(d, f) for d, _, fs in os.walk(snap) for f in fs if f.endswith(".bin")]
                b["snapshot_bytes"] = sum(os.path.getsize(f) for f in files)
            boots[role] = b
    finally:
        plane.close()
    fresh, warm = boots["fresh"], boots["warm"]
    if fresh["restored"] or not warm["restored"]:
        raise AssertionError(f"coldstart: restored fresh={fresh['restored']} warm={warm['restored']}")
    if fresh["snapshot_bytes"] != nbytes or fresh["state_bytes"] != nbytes:
        raise AssertionError(f"coldstart: snapshot holds {fresh['snapshot_bytes']} bytes of array files, "
                             f"the state {fresh['state_bytes']}; llama3-8b has {nbytes}")
    if warm["state_bytes"] != fresh["state_bytes"] or warm["checksums"] != fresh["checksums"]:
        bad = [p for p in fresh["checksums"] if warm["checksums"].get(p) != fresh["checksums"][p]]
        raise AssertionError(f"coldstart: restored leaves differ from the saved ones: {bad[:8]}")
    if warm["leaf_devices"] != fresh["leaf_devices"] or not all(d.startswith("cuda") for d in warm["leaf_devices"]):
        raise AssertionError(f"coldstart: leaves on {fresh['leaf_devices']} then {warm['leaf_devices']}")
    if warm["streams"] != fresh["streams"]:
        raise AssertionError("coldstart: the warm boot's tokens differ from the fresh boot's")
    want_fns = {"count_tokens": 8 * NEW_TOKENS, "in_vocab": True, "closure_cells": 1}
    if fresh["snap_functions"] != want_fns or warm["snap_functions"] != want_fns:
        raise AssertionError(f"coldstart: the snapshotted lambda and closure gave {fresh['snap_functions']} fresh, "
                             f"{warm['snap_functions']} restored (want {want_fns})")
    if fresh["nvcc_runs"] < 1 or fresh["fleet_puts"] != fresh["nvcc_runs"]:
        raise AssertionError(f"coldstart: fresh boot ran nvcc {fresh['nvcc_runs']} times, published {fresh['fleet_puts']}")
    if warm["nvcc_runs"] != 0 or warm["fleet_hits"] != len(warm["loaded_kernels"]) or not warm["loaded_kernels"]:
        raise AssertionError(f"coldstart: warm boot ran nvcc {warm['nvcc_runs']} times with {warm['fleet_hits']} fleet "
                             f"hits for kernels {warm['loaded_kernels']}")
    for b in (fresh, warm):
        k4 = b["launches"]["paged_decode"]
        if k4 == 0 or k4 != cfg.n_layers * b["decode_steps"]:
            raise AssertionError(f"coldstart {b['role']}: paged_decode launched {k4} times over "
                                 f"{b['decode_steps']} decode steps ({cfg.n_layers} layers)")
        if b["cuda_visible_devices"] != "0":
            raise AssertionError(f"coldstart {b['role']}: the container saw CUDA_VISIBLE_DEVICES="
                                 f"{b['cuda_visible_devices']!r}")
        _add_launches(ctx, "paged_decode", k4)
        log(f"[worker:coldstart] {b['role']}: {_boot_line(b)} | {smi}")
        b.pop("checksums")
    ratio = warm["first_token_s"] / fresh["first_token_s"]
    log(f"[worker:coldstart] the warm boot restored the snap-enter lambda and closure and called them: "
        f"{warm['snap_functions']}")
    log(f"[worker:coldstart] {len(fresh['streams'])} streams equal; {nbytes / 1e9:.2f} GB restored bit-equal; warm / "
        f"fresh spawn → first token {warm['first_token_s']:.2f}s / {fresh['first_token_s']:.2f}s = {ratio:.3f} | {smi}")
    ctx["coldstart"] = {"fresh": fresh, "warm": warm, "warm_over_fresh": ratio, "nvidia_smi": smi}


def phase_worker(torch, ctx: dict) -> None:
    """The function path on one host: the port's LocalSupervisor (control
    plane, blob server, scheduler, one worker that probed this host's card)
    in this process; llama3-8b asked for with gpu="H100", served by the
    port's container entrypoint in a process pinned to the card; then the
    coldstart replica booted fresh and warm as containers of its worker."""
    import gc
    import shutil
    import tempfile

    from modal_tpu_torch._utils.async_utils import synchronizer
    from modal_tpu_torch.models.llama import get_config, init_params_abstract
    from modal_tpu_torch.models.quant import quantized_bytes
    from modal_tpu_torch.observability.catalog import JOURNAL_APPEND_SECONDS, JOURNAL_APPENDS, JOURNAL_BYTES
    from modal_tpu_torch.server.journal import Journal
    from modal_tpu_torch.server.supervisor import LocalSupervisor

    for key in ("params", "cfg"):  # the containers build their own 16 GB beside this process's context
        ctx.pop(key, None)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    smi = ctx.get("nvidia_smi") or _nvidia_smi()
    nbytes = quantized_bytes(init_params_abstract(get_config("llama3-8b")))
    parent = tempfile.gettempdir()
    free = _free_bytes(parent)
    if free < nbytes * 1.1 + (2 << 30):
        raise AssertionError(f"worker: {free / 1e9:.1f} GB free under {parent}, the snapshot needs {nbytes / 1e9:.1f}")
    roots = [tempfile.mkdtemp(prefix="worker-", dir=parent), tempfile.mkdtemp(prefix="coldstart-", dir=parent)]
    saved = {}
    for key, value in _worker_env(roots[1]).items():
        saved[key] = os.environ.pop(key, None)
        if value is not None:
            os.environ[key] = value
    # the journal's cost over the phase: every append timed (the plane
    # samples 1 in 32 otherwise)
    appends0, bytes0, every = JOURNAL_APPENDS.total(), JOURNAL_BYTES.value(), Journal._METRIC_SAMPLE_EVERY
    JOURNAL_APPEND_SECONDS.clear()
    Journal._METRIC_SAMPLE_EVERY = 1
    try:
        for root, step in zip(roots, ("serve", "coldstart")):
            # each step has its own control plane: the coldstart's fresh boot
            # must find an empty fleet store
            sup = LocalSupervisor(num_workers=1, state_dir=root)
            synchronizer.run(sup.start())
            try:
                worker = sup.workers[0]
                kind, count = torch.cuda.get_device_name(0), torch.cuda.device_count()
                if worker.gpu_type != kind or len(worker.card_indices) != count:
                    raise AssertionError(f"worker: the probe found {len(worker.card_indices)} x {worker.gpu_type!r}; "
                                         f"this process sees {count} x {kind!r}")
                log(f"[worker] LocalSupervisor at {sup.server_url} ({step}); the worker's probe (nvidia-smi): "
                    f"{len(worker.card_indices)} x {worker.gpu_type!r}, cards {worker.card_indices}")
                if step == "serve":
                    _serve_through_worker(torch, ctx, sup, smi)
                else:
                    _coldstart_through_worker(torch, ctx, sup, root, smi)
            finally:
                synchronizer.run(sup.stop())
    finally:
        Journal._METRIC_SAMPLE_EVERY = every
        for key, value in saved.items():
            os.environ.pop(key, None)
            if value is not None:
                os.environ[key] = value
        for root in roots:
            shutil.rmtree(root, ignore_errors=True)
    w = ctx["worker"]
    appended, nbytes_j = JOURNAL_APPENDS.total() - appends0, JOURNAL_BYTES.value() - bytes0
    p50, p99 = JOURNAL_APPEND_SECONDS.quantile(0.5), JOURNAL_APPEND_SECONDS.quantile(0.99)
    if not appended or p50 is None:
        raise AssertionError("worker: the control planes journaled nothing")
    w["journal"] = {"records": appended, "bytes": nbytes_j, "append_p50_s": p50, "append_p99_s": p99,
                    "append_mean_s": JOURNAL_APPEND_SECONDS.totals()[0] / JOURNAL_APPEND_SECONDS.count_total()}
    log(f"[worker:journal] the phase's two planes appended {appended:.0f} records, {nbytes_j:.0f} bytes; append time "
        f"p50 ≤ {p50 * 1e6:.0f} µs, p99 ≤ {p99 * 1e6:.0f} µs (histogram bucket bounds), mean "
        f"{w['journal']['append_mean_s'] * 1e6:.1f} µs over {JOURNAL_APPEND_SECONDS.count_total()} appends | {smi}")
    boots = [("serve, cold", w["split_cold"], w["results"][0]["imports_top"]),
             ("serve, after the restart", w["crash"]["new_split"], w["crash"]["new_imports_top"])]
    boots += [(f"coldstart, {b['role']}", b["split"], b["imports_top"])
              for b in (ctx["coldstart"]["fresh"], ctx["coldstart"]["warm"])]
    for label, split, top in boots:
        log(f"[worker:hello] {label}: spawn → ContainerHello {split['spawn_to_hello_s']:.2f}s, then import torch "
            f"{split['import_torch_s']:.2f}s on the main thread; ContainerHello → first output "
            f"{split['hello_to_first_output_s']:.2f}s (hello with torch loaded before it: 5.95–8.86 s); imports_top: "
            + ", ".join(f"{e['module']} {e['s']:.2f}s" for e in top) + f" | {smi}")
    ctx["worker"]["parent_peak_device_bytes"] = torch.cuda.max_memory_allocated()
    log(f"[worker] this process's peak device memory during the phase "
        f"{ctx['worker']['parent_peak_device_bytes'] / 1e9:.2f} GB | {smi}")


# -- app: the App layer, `app.run()` booting the port's plane itself ---------

# the file path: a module-level, non-serialized function the container finds
# by importing this script (as `modal run app.py` would); building the App and
# decorating contact nothing, so importing this script stays free of side
# effects (and of torch)
APP = App("chip_smoke")


@APP.function(gpu="H100")
def app_file_function() -> dict:
    import torch

    return {"device": torch.cuda.get_device_name(0), "cuda_visible_devices": os.environ.get("CUDA_VISIBLE_DEVICES"),
            "pid": os.getpid(), "module": __name__}


# rounds of the warm App-vs-raw-RPC comparison, in turns
APP_WARM_ROUNDS = 5


def _forward_prompts(cfg, n: int, seed: int) -> list:
    """Prompts for the cache-less forward: lengths that are multiples of K1's
    128-row q tile (128 to 512), so every layer takes the kernel."""
    import numpy as np

    rng = np.random.default_rng(seed)
    return [rng.integers(0, cfg.vocab_size, size=128 * (1 + i % 4)).tolist() for i in range(n)]


def _app_serving_class(app, cfg_name: str, prompts: list):
    """The serialized serving class of the app phase, registered on `app`:
    `@enter` builds llama3-8b's params (seed 0) and the graphed engine of the
    sdk and worker phases; `serve_all` runs their 8-request traffic (a fresh
    engine on the same params after the first call: a stopped engine does
    not restart); `forward_last` runs the cache-less forward on one prompt;
    `ping` answers at once (the App layer's own cost)."""
    from modal_tpu_torch import enter, method

    @app.cls(gpu="H100", scaledown_window=600, serialized=True)
    class Llama:
        def __init__(self):
            self.enter_calls = 0

        @enter()
        def load(self):
            import torch

            from modal_tpu_torch.models.llama import get_config, init_params

            t0 = time.time()
            self.enter_calls += 1
            self.cfg = get_config(cfg_name)
            self.params = init_params(self.cfg, seed=0, device="cuda")
            self.engine = _engine_8b(self.params, self.cfg)
            if self.engine.decode_graph is None:
                raise AssertionError("the engine on CUDA did not capture its decode step")
            torch.cuda.synchronize()
            self.enter_s = time.time() - t0

        @method()
        def serve_all(self) -> dict:
            import hashlib

            import torch

            from modal_tpu_torch.ops import _build

            t0 = time.time()
            engine = self.engine or _engine_8b(self.params, self.cfg)
            self.engine = None
            engine_s = time.time() - t0
            graph, last = engine.decode_graph, {}

            def keep_last(tokens, active):
                out = graph(tokens, active)
                last["logits"] = out[0].clone()
                return out

            engine.decode_graph = keep_last
            _build.reset_launches()
            streams, _reqs, wall, stats = _run_traffic(engine, prompts, self.cfg.vocab_size, "app serve_all")
            launches = _build.LAUNCHES["paged_decode"]
            logits = last["logits"].cpu()
            del engine, graph, last
            torch.cuda.empty_cache()
            return {"streams": streams, "logits": logits, "paged_decode_launches": launches,
                    "decode_steps": stats["steps"], "n_layers": self.cfg.n_layers, "wall_s": wall,
                    "engine_s": engine_s, "logits_sha256": hashlib.sha256(logits.numpy().tobytes()).hexdigest(),
                    "device": torch.cuda.get_device_name(0), "pid": os.getpid(), "enter_calls": self.enter_calls,
                    "enter_s": self.enter_s, "cuda_visible_devices": os.environ.get("CUDA_VISIBLE_DEVICES")}

        @method()
        def forward_last(self, tokens: list, check: bool = False) -> dict:
            import torch

            from modal_tpu_torch.models.llama import attention, forward
            from modal_tpu_torch.ops import _build

            def fp32_attention(q, k, v, mask):
                return attention(q.float(), k.float(), v.float(), mask).to(q.dtype)

            with torch.inference_mode():
                x = torch.tensor([tokens], dtype=torch.long, device="cuda")
                _build.reset_launches()
                logits, _ = forward(self.params, self.cfg, x)
                last = logits[0, -1].float()
                launches = _build.LAUNCHES["flash_fwd"]
                out = {"logits": last.cpu(), "argmax": int(last.argmax()), "flash_fwd_launches": launches,
                       "pid": os.getpid(), "enter_calls": self.enter_calls}
                if check:  # the same tokens through the einsum attention and fp32 attention
                    paths = {"kernel": logits[0],
                             "plain": forward(self.params, self.cfg, x, attn_impl=attention)[0][0],
                             "fp32": forward(self.params, self.cfg, x, attn_impl=fp32_attention)[0][0]}
                    out["gap_sums"] = _gap_sums(paths)
                    out["plain_launches"] = _build.LAUNCHES["flash_fwd"] - launches
            return out

        @method()
        def ping(self) -> int:
            return os.getpid()

    return Llama


def _app_split(sup, task, trace_id: str, t_call: float, t_result: float) -> dict:
    """The cold `.remote()` by part, from the spans of its trace: the
    worker's spawn decision to ContainerHello, `import torch` on the main
    thread, the user's code, `@enter`, then the first method call (ready →
    first output); the client's wall beside it."""
    spans = _spans_of(sup, trace_id)
    missing = [n for n in ("container.boot", "container.import_torch", "container.imports", "container.enter_hooks")
               if n not in spans]
    if missing:
        raise AssertionError(f"app: the cold call's trace has no {missing} span (it has {sorted(spans)})")
    t0, ready = spans["container.boot"]["start"], spans["container.boot"]["end"]
    part = {n: spans[n]["end"] - spans[n]["start"] for n in ("container.import_torch", "container.imports",
                                                            "container.enter_hooks")}
    return {"remote_s": t_result - t_call, "call_to_spawn_s": t0 - t_call, "spawn_to_hello_s": task.started_at - t0,
            "import_torch_s": part["container.import_torch"], "user_import_s": part["container.imports"],
            "enter_s": part["container.enter_hooks"], "ready_to_first_output_s": task.first_output_at - ready,
            "spawn_to_first_output_s": task.first_output_at - t0}


def phase_app(torch, ctx: dict) -> None:
    """The App layer on the card: `app.run()` with no server configured boots
    the port's LocalSupervisor in this process (its worker probes the card
    with nvidia-smi, its state in a fresh dir); a serialized
    `@app.cls(gpu="H100")` serves llama3-8b at full width through
    `.remote()`, `.map()` and `.spawn()`, in one container pinned to card 0;
    then the module-level file function runs in a container that imported
    this script by path."""
    import hashlib
    import shutil
    import tempfile

    from modal_tpu_torch._utils.async_utils import synchronizer
    from modal_tpu_torch._utils.grpc_utils import retry_transient_errors
    from modal_tpu_torch.client import _Client
    from modal_tpu_torch.models.llama import get_config
    from modal_tpu_torch.observability import tracing
    from modal_tpu_torch.proto import api_pb2

    smi = ctx.get("nvidia_smi") or _nvidia_smi()
    kind = torch.cuda.get_device_name(0)
    cfg = get_config("llama3-8b")
    prompts = _prompts(cfg, 8, seed=1)
    fwd_prompts = _forward_prompts(cfg, 8, seed=2)
    saved = {k: os.environ.pop(k, None) for k in ("MODAL_TPU_SERVER_URL", "MODAL_TPU_STATE_DIR",
                                                 "MODAL_TPU_AUTO_LOCAL_SERVER")}
    state_dir = os.environ["MODAL_TPU_STATE_DIR"] = tempfile.mkdtemp(prefix="app-")
    serve_app = App("chip_smoke app")
    Llama = _app_serving_class(serve_app, "llama3-8b", prompts)
    out: dict = {"nvidia_smi": smi}
    plane = None
    try:
        t_enter = time.time()
        with serve_app.run():
            t_ready = time.time()
            sup = _Client._local_supervisor
            if sup is None:
                raise AssertionError("app: app.run() did not boot the port's LocalSupervisor")
            client = _Client._client_from_env
            plane = _Plane(sup)  # raw RPCs to the same plane, beside the App's
            worker = sup.workers[0]
            if worker.gpu_type != kind:
                raise AssertionError(f"app: the auto-booted worker's probe found {worker.gpu_type!r}, the card is {kind!r}")
            created = sup.state.apps[serve_app.app_id].created_at
            out["setup"] = {"boot_s": created - t_enter, "app_create_to_published_s": t_ready - created,
                            "objects": sorted({**sup.state.apps[serve_app.app_id].function_ids,
                                               **sup.state.apps[serve_app.app_id].class_ids})}
            log(f"[app] app.run(): plane booted in {out['setup']['boot_s']:.2f}s (LocalSupervisor at "
                f"{sup.server_url}, worker {worker.gpu_type!r} cards {worker.card_indices}); AppCreate → objects "
                f"created and published {out['setup']['app_create_to_published_s'] * 1e3:.1f} ms "
                f"({out['setup']['objects']}) | {smi}")
            llama = Llama()
            serves = []
            for label in ("cold", "warm"):
                with tracing.span(f"chip_smoke.app.{label}") as sp:
                    t0 = time.time()
                    r = llama.serve_all.remote()
                    t1 = time.time()
                r["wall_s_client"], r["trace_id"], r["t_call"], r["t_result"] = t1 - t0, sp.trace_id, t0, t1
                serves.append(r)
            tasks = [t for t in synchronizer.run(retry_transient_errors(
                client.stub.TaskList, api_pb2.TaskListRequest())).tasks if t.app_id == serve_app.app_id]
            if len(tasks) != 1 or list(tasks[0].gpu_ids) != [0]:
                raise AssertionError(f"app: TaskList shows {[(t.task_id, list(t.gpu_ids)) for t in tasks]}")
            task = sup.state.tasks[tasks[0].task_id]
            for label, r in zip(("cold", "warm"), serves):
                digest = hashlib.sha256(r["logits"].numpy().tobytes()).hexdigest()
                if digest != r["logits_sha256"] or tuple(r["logits"].shape) != (8, cfg.vocab_size):
                    raise AssertionError(f"app: serve_all ({label}) logits {tuple(r['logits'].shape)} sha256 {digest}, "
                                         f"the container's {r['logits_sha256']}")
                for phase, want in (("sdk", ctx.get("sdk", {}).get("function", {}).get("logits_sha256")),
                                    ("worker", (ctx.get("worker", {}).get("results") or [{}])[0].get("logits_sha256"))):
                    if want is not None and digest != want:
                        raise AssertionError(f"app: serve_all ({label}) logits sha256 {digest}, the {phase} phase's {want}")
                steps, k4 = r["decode_steps"], r["paged_decode_launches"]
                if steps == 0 or k4 != cfg.n_layers * steps:
                    raise AssertionError(f"app: serve_all ({label}): paged_decode launched {k4} times over {steps} steps")
                if r["cuda_visible_devices"] != "0" or r["device"] != kind:
                    raise AssertionError(f"app: the container saw CUDA_VISIBLE_DEVICES={r['cuda_visible_devices']!r} "
                                         f"and {r['device']!r}")
                _check_streams("app", r["streams"], cfg.vocab_size)
                if "serve_streams" in ctx:
                    diverged = _first_divergence(ctx["serve_streams"], r["streams"], ctx.get("serve_logits", {}), {})
                    bad = [d for d in diverged if d["sampled"] or d["gap"] > SELF_DRAFT_TIE]
                    if bad:
                        raise AssertionError(f"app: serve_all ({label}) streams differ from serve's beyond a near-tie: {bad}")
                _add_launches(ctx, "paged_decode", k4)
            split = _app_split(sup, task, serves[0]["trace_id"], serves[0]["t_call"], serves[0]["t_result"])
            out["serve_all"] = [{k: v for k, v in r.items() if k not in ("logits", "streams")} for r in serves]
            out["cold_split"] = split
            log(f"[app] serve_all.remote() cold {split['remote_s']:.2f}s: call → spawn {split['call_to_spawn_s']:.2f}s, "
                f"spawn → ContainerHello {split['spawn_to_hello_s']:.2f}s, import torch {split['import_torch_s']:.2f}s, "
                f"user import {split['user_import_s']:.3f}s, @enter {split['enter_s']:.2f}s (params + engine), first "
                f"method call {split['ready_to_first_output_s']:.2f}s; warm {serves[1]['wall_s_client']:.2f}s (engine "
                f"{serves[1]['engine_s']:.2f}s + 8 requests {serves[1]['wall_s']:.2f}s); logits sha256 "
                f"{serves[0]['logits_sha256'][:16]}… both calls"
                + (", equal to the sdk and worker phases'" if "worker" in ctx and "sdk" in ctx else "")
                + f"; paged_decode {serves[0]['paged_decode_launches']} and {serves[1]['paged_decode_launches']} launches "
                f"(= {cfg.n_layers} x decode steps); task {task.task_id} on card {list(tasks[0].gpu_ids)} | {smi}")

            t0 = time.perf_counter()
            mapped = list(llama.forward_last.map(fwd_prompts))
            map_s = time.perf_counter() - t0
            single = llama.forward_last.remote(fwd_prompts[0])
            spawned = llama.forward_last.spawn(fwd_prompts[1]).get()
            if len(mapped) != len(fwd_prompts):
                raise AssertionError(f"app: forward_last.map returned {len(mapped)} results for {len(fwd_prompts)}")
            for i, r in enumerate(mapped + [single, spawned]):
                if (tuple(r["logits"].shape) != (cfg.vocab_size,) or not torch.isfinite(r["logits"]).all()
                        or r["flash_fwd_launches"] != cfg.n_layers or r["argmax"] != int(r["logits"].argmax())):
                    raise AssertionError(f"app: forward_last result {i}: shape {tuple(r['logits'].shape)}, flash_fwd "
                                         f"{r['flash_fwd_launches']} launches, argmax {r['argmax']}")
                _add_launches(ctx, "flash_fwd", r["flash_fwd_launches"])
            # in order: each map result is the one its own prompt gives
            for i in (0, 1):
                want = single if i == 0 else spawned
                if not torch.equal(mapped[i]["logits"], want["logits"]):
                    raise AssertionError(f"app: forward_last map result {i} differs from the same prompt's "
                                         f"{'remote' if i == 0 else 'spawn'} result")
            if len({r["argmax"] for r in mapped}) == 1 and len({tuple(r["logits"][:8].tolist()) for r in mapped}) == 1:
                raise AssertionError("app: every prompt gave the same logits")
            # K1 at the app path's shapes, held to the plain forward on the same
            # tokens: one prompt of each length (128 to 512), every row's logits,
            # pooled; these comparison launches are not counted
            checked = list(llama.forward_last.map(fwd_prompts[:4], kwargs={"check": True}))
            for i, r in enumerate(checked):
                if not torch.equal(r["logits"], mapped[i]["logits"]) or r["plain_launches"] != 0:
                    raise AssertionError(f"app: the checked forward of prompt {i} differs from its map result, or "
                                         f"its plain paths launched flash_fwd {r['plain_launches']} times")
            gaps = _pooled_gaps([r["gap_sums"] for r in checked])
            _check_faithful(f"app forward_last S{[len(p) for p in fwd_prompts[:4]]}", gaps, 5e-2, tokens=False)
            pids = {r["pid"] for r in serves + mapped + checked + [single, spawned]}
            enters = {r["enter_calls"] for r in serves + mapped + checked + [single, spawned]}
            if len(pids) != 1 or enters != {1}:
                raise AssertionError(f"app: inputs ran in pids {pids} with @enter counts {enters}")

            fn = llama._get_bound_function()
            app_ms, raw_ms = [], []
            for _ in range(APP_WARM_ROUNDS):
                t0 = time.perf_counter()
                llama.ping.remote()
                app_ms.append((time.perf_counter() - t0) * 1e3)
                t0 = time.perf_counter()
                raw = plane.remote(fn.object_id, "ping", timeout=60.0)
                raw_ms.append((time.perf_counter() - t0) * 1e3)
                if raw["status"] != api_pb2.GENERIC_STATUS_SUCCESS:
                    raise AssertionError(f"app: the raw ping failed: {raw['exception']}\n{raw['traceback']}")
            out["forward_last"] = {"map_s": map_s, "map_per_input_s": map_s / len(fwd_prompts),
                                   "prompt_lens": [len(p) for p in fwd_prompts],
                                   "argmax": [r["argmax"] for r in mapped], "gaps": gaps}
            out["warm"] = {"app_ms": app_ms, "raw_ms": raw_ms, "app_layer_ms": statistics.median(app_ms)
                           - statistics.median(raw_ms)}
            log(f"[app] forward_last.map over {len(fwd_prompts)} prompts ({[len(p) for p in fwd_prompts]} tokens) in "
                f"{map_s:.2f}s ({map_s / len(fwd_prompts) * 1e3:.1f} ms per input), in order, flash_fwd "
                f"{cfg.n_layers} launches each; .remote(prompt 0) and .spawn(prompt 1).get() bit-equal to map results 0 "
                f"and 1; the prompts of 128 to 512 tokens held to the plain forward (above); every input in pid "
                f"{pids.pop()}, @enter once | {smi}")
            log(f"[app] warm ping, {APP_WARM_ROUNDS} rounds in turns, median [min, max]: .remote() through the App "
                f"{statistics.median(app_ms):.2f} [{min(app_ms):.2f}, {max(app_ms):.2f}] ms, raw FunctionMap + "
                f"FunctionGetOutputs to the same bound function {statistics.median(raw_ms):.2f} [{min(raw_ms):.2f}, "
                f"{max(raw_ms):.2f}] ms; the App layer's own cost {out['warm']['app_layer_ms']:.2f} ms | {smi}")
            run_id = serve_app.app_id
        plane.wait_finished(run_id)

        t_enter = time.time()
        with APP.run():
            t0 = time.time()
            r = app_file_function.remote()
            file_s = time.time() - t0
            run_id = APP.app_id
            fdef = next(f.definition for f in sup.state.functions.values() if f.app_id == run_id)
        plane.wait_finished(run_id)
        if (fdef.definition_type != "file" or not fdef.experimental_options.get("main_file_path", "").endswith(
                "chip_smoke.py") or r["device"] != kind or r["cuda_visible_devices"] != "0"
                or r["module"] != "__modal_tpu_main__"):
            raise AssertionError(f"app: the file function ran as {fdef.definition_type!r} "
                                 f"{dict(fdef.experimental_options)} and returned {r}")
        out["file_function"] = {**r, "remote_s": file_s, "run_s": time.time() - t_enter}
        log(f"[app] file function (not serialized): the container imported {fdef.experimental_options['main_file_path']} "
            f"as {r['module']!r}, saw {r['device']!r} with CUDA_VISIBLE_DEVICES={r['cuda_visible_devices']!r}; cold "
            f".remote() {file_s:.2f}s | {smi}")
    finally:
        if plane is not None:
            plane.close()
        # stop the plane app.run() booted (the stop its exit hook repeats
        # does nothing more), and drop its state
        if _Client._local_supervisor is not None:
            if _Client._client_from_env is not None:
                _Client._client_from_env._close()
            synchronizer.run(_Client._local_supervisor.stop())
            _Client._local_supervisor = None
            _Client.set_env_client(None)
        shutil.rmtree(state_dir, ignore_errors=True)
        for key, value in saved.items():
            os.environ.pop(key, None)
            if value is not None:
                os.environ[key] = value
    ctx["app"] = out


# -- pool: the warm pool of the port's worker on the card ----------------------

POOL_ROUNDS = 2  # pool on and off, in turns: on, off, off, on


def _compute_apps() -> int:
    """How many CUDA contexts nvidia-smi lists on the card (its lines: a
    sandbox may show every process under one pid)."""
    out = subprocess.run(["nvidia-smi", "--query-compute-apps=pid,used_memory", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    if out.returncode != 0:
        raise AssertionError(f"nvidia-smi --query-compute-apps failed: {out.stderr.strip()}")
    return len([line for line in out.stdout.splitlines() if line.strip()])


def _card_used_bytes() -> int:
    out = subprocess.run(["nvidia-smi", "--query-gpu=memory.used", "--format=csv,noheader,nounits", "-i", "0"],
                         capture_output=True, text=True, timeout=60)
    if out.returncode != 0:
        raise AssertionError(f"nvidia-smi --query-gpu=memory.used failed: {out.stderr.strip()}")
    return int(out.stdout.split()[0]) * (1 << 20)


def _compute_pids() -> set:
    """The pids holding a CUDA context on the card, from nvidia-smi."""
    out = subprocess.run(["nvidia-smi", "--query-compute-apps=pid", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    if out.returncode != 0:
        raise AssertionError(f"nvidia-smi --query-compute-apps failed: {out.stderr.strip()}")
    return {int(x) for x in out.stdout.split() if x.strip().isdigit()}


def _pool_spans(sup, name: str) -> list:
    from modal_tpu_torch.observability import tracing

    return [s["attrs"] for s in tracing.read_spans(os.path.join(sup.state_dir, "traces")) if s["name"] == name]


def _parked_entry(sup, timeout: float = 180.0):
    """The worker's parked interpreter, once it parked; checked for a CUDA
    context: its park span (torch imported, no context, no pinning
    variables; whether the driver library is mapped is printed) and
    nvidia-smi's compute apps (not listed)."""
    from modal_tpu_torch._utils.async_utils import synchronizer

    pool = sup.workers[0].pool
    t0 = time.perf_counter()
    if not synchronizer.run(pool.wait_parked(1, timeout)):
        raise AssertionError(f"pool: no interpreter parked within {timeout}s")
    park_s = time.perf_counter() - t0
    entry = next(e for e in pool.entries.values() if e.state == "parked")
    span = next((a for a in reversed(_pool_spans(sup, "coldstart.park")) if a["pid"] == entry.proc.pid), None)
    if span is None or not span["torch_imported"] or span["cuda_initialized"] or span["pinning_env"]:
        raise AssertionError(f"pool: the parked interpreter {entry.proc.pid} is not clean: {span}")
    if entry.proc.pid in _compute_pids():
        raise AssertionError(f"pool: nvidia-smi lists the parked interpreter {entry.proc.pid} as a compute app")
    log(f"[pool] parked pid {entry.proc.pid}: torch imported, CUDA context {span['cuda_initialized']}, CUDA driver "
        f"library mapped {span['libcuda_mapped']}, pinning variables {span['pinning_env']}, not among nvidia-smi's "
        f"compute apps")
    return entry, park_s


def _pool_run(torch, ctx: dict, root: str, label: str, pooled: bool, smi: str) -> dict:
    """One control plane with the pool on or off: the worker phase's
    llama3-8b serving function (gpu="H100") called once, its boot split, K4
    counted in the container and in its heartbeat; then the app stopped and
    the re-park rule checked (an interpreter whose placement made a CUDA
    context exits, a fresh one parks)."""
    from modal_tpu_torch._utils.async_utils import synchronizer
    from modal_tpu_torch.models.llama import get_config
    from modal_tpu_torch.proto import api_pb2
    from modal_tpu_torch.serialization import deserialize, serialize
    from modal_tpu_torch.server.supervisor import LocalSupervisor

    cfg = get_config("llama3-8b")
    os.environ["MODAL_TPU_WARM_POOL"] = "1" if pooled else "0"
    sup = LocalSupervisor(num_workers=1, state_dir=os.path.join(root, label))
    synchronizer.run(sup.start())
    plane = None
    try:
        parked, park_s = _parked_entry(sup) if pooled else (None, 0.0)
        plane = _Plane(sup)
        plane.new_app(f"chip_smoke pool {label}")
        fn_id = plane.create("serve", "H100",
                             function_serialized=serialize(_worker_serving_fn("llama3-8b", 0, _prompts(cfg, 8, seed=1))))
        call = plane.remote(fn_id)
        if call["status"] != api_pb2.GENERIC_STATUS_SUCCESS:
            raise AssertionError(f"pool {label}: the call failed: {call['exception']}\n{call['traceback'][-4000:]}"
                                 f"\n{plane.task_logs()}")
        r = deserialize(call["data"])
        (task,) = [t for t in sup.state.tasks.values() if t.app_id == plane.app_id]
        if task.warm_pool_hit != pooled or (pooled and r["pid"] != parked.proc.pid):
            raise AssertionError(f"pool {label}: warm_pool_hit {task.warm_pool_hit}, served by pid {r['pid']}, "
                                 f"parked pid {parked.proc.pid if parked else None}")
        steps, k4 = r["decode_steps"], r["paged_decode_launches"]
        if steps == 0 or k4 != cfg.n_layers * steps or r["cuda_visible_devices"] != "0":
            raise AssertionError(f"pool {label}: K4 {k4} over {steps} steps, CUDA_VISIBLE_DEVICES "
                                 f"{r['cuda_visible_devices']!r}")
        report = _wait_report(task, lambda rep: _k4_and_steps(rep)[0] == k4)
        _check_streams(f"pool {label}", r["streams"], cfg.vocab_size)
        split = _boot_split(sup, task, call)
        plane.stop_app()
        out = {"label": label, "pooled": pooled, "warm_pool_hit": task.warm_pool_hit, "served_pid": r["pid"],
               "logits_sha256": r["logits_sha256"], "decode_steps": steps, "paged_decode_launches": k4,
               "heartbeat_k4": _k4_and_steps(report)[0], "split": split, "wall_s": r["wall_s"],
               "peak_device_bytes": r["peak_device_bytes"], "imports_top": r["imports_top"]}
        if pooled:
            pool = sup.workers[0].pool
            # the re-park rule: the placement made a CUDA context, so its
            # interpreter exits, and the pool parks a fresh one
            deadline = time.monotonic() + 60
            while parked.proc.returncode is None or any(e.proc.pid == parked.proc.pid for e in pool.entries.values()):
                if time.monotonic() > deadline:
                    raise AssertionError(f"pool {label}: the interpreter {parked.proc.pid} did not exit after a "
                                         f"placement that made a CUDA context")
                time.sleep(0.2)
            exits = [a for a in _pool_spans(sup, "coldstart.exit_after_cuda") if a["pid"] == parked.proc.pid]
            if not exits:
                raise AssertionError(f"pool {label}: the interpreter {parked.proc.pid} exited without its exit span")
            fresh, _ = _parked_entry(sup)
            out.update(parked_pid=parked.proc.pid, park_s=park_s, exit_rc=parked.proc.returncode,
                       fresh_pid=fresh.proc.pid)
        _add_launches(ctx, "paged_decode", k4)
        log(f"[pool] {label}: pool {'on' if pooled else 'off'}, warm_pool_hit {task.warm_pool_hit}, served by pid "
            f"{r['pid']}" + (f" (parked pid {parked.proc.pid}, parked {park_s:.2f}s after the plane's start; after "
                             f"the placement it exited rc {out['exit_rc']} and pid {out['fresh_pid']} parked)"
                             if pooled else "") + f"; {_split_line(split)}; K4 {k4} = {cfg.n_layers} x {steps} in the "
            f"container, {out['heartbeat_k4']} in its heartbeat; logits sha256 {r['logits_sha256'][:16]}…; serve "
            f"{r['wall_s']:.2f}s; peak device {r['peak_device_bytes'] / 1e9:.2f} GB | {smi}")
        return out
    finally:
        if plane is not None:
            plane.close()
        synchronizer.run(sup.stop())


def _pool_min_containers(torch, root: str, smi: str) -> dict:
    """A min_containers=1 function with the baseline pool off: the
    scheduler's PoolDirective pre-forks an interpreter while the first
    container (a cold spawn: nothing was parked yet) holds the card; that
    container is stopped, and its replacement, which keeps min_containers,
    adopts the pre-forked interpreter: the call is a warm hit."""
    from modal_tpu_torch._utils.async_utils import synchronizer
    from modal_tpu_torch.proto import api_pb2
    from modal_tpu_torch.serialization import deserialize, serialize
    from modal_tpu_torch.server.supervisor import LocalSupervisor

    def where() -> dict:
        import os as _os

        import torch as _torch

        before = _torch.cuda.is_initialized()
        x = _torch.ones(1024, 1024, device="cuda")
        return {"pid": _os.getpid(), "cuda_visible_devices": _os.environ.get("CUDA_VISIBLE_DEVICES"),
                "device": _torch.cuda.get_device_name(0), "cuda_initialized_before": before,
                "sum": float((x @ x).sum())}

    os.environ["MODAL_TPU_WARM_POOL"] = "0"
    sup = LocalSupervisor(num_workers=1, state_dir=os.path.join(root, "min"))
    synchronizer.run(sup.start())
    plane = None
    try:
        plane = _Plane(sup)
        plane.new_app("chip_smoke pool min_containers")
        fn_id = plane.create("where", "H100", function_serialized=serialize(where),
                             autoscaler_settings=api_pb2.AutoscalerSettings(min_containers=1, max_containers=1))
        entry, park_s = _parked_entry(sup)
        first = [t for t in sup.state.tasks.values() if t.function_id == fn_id]
        if len(first) != 1 or first[0].warm_pool_hit:
            raise AssertionError(f"pool min_containers: the first container {[(t.task_id, t.warm_pool_hit) for t in first]}")
        plane.call("ContainerStop", api_pb2.ContainerStopRequest(task_id=first[0].task_id))
        call = plane.remote(fn_id)
        if call["status"] != api_pb2.GENERIC_STATUS_SUCCESS:
            raise AssertionError(f"pool min_containers: {call['exception']}\n{plane.task_logs()}")
        r = deserialize(call["data"])
        task = next(t for t in sup.state.tasks.values() if t.function_id == fn_id and t.task_id != first[0].task_id
                    and t.started_at)
        if not task.warm_pool_hit or r["pid"] != entry.proc.pid or r["cuda_initialized_before"] \
                or r["cuda_visible_devices"] != "0" or r["device"] != torch.cuda.get_device_name(0):
            raise AssertionError(f"pool min_containers: the call ran in {r} (warm_pool_hit {task.warm_pool_hit}, "
                                 f"parked pid {entry.proc.pid})")
        directives = dict(sup.workers[0].pool.directives)
        plane.stop_app()
        out = {"parked_pid": entry.proc.pid, "park_s": park_s, "served": r, "directives": directives,
               "map_to_output_s": call["t_output"] - call["t_map"], "warm_pool_hit": task.warm_pool_hit}
        log(f"[pool] min_containers=1 (baseline pool off): directive {directives}, pid {entry.proc.pid} parked "
            f"{park_s:.2f}s after the function's creation beside the cold first container; that container stopped, "
            f"its replacement adopted pid {r['pid']} (warm_pool_hit {task.warm_pool_hit}, CUDA_VISIBLE_DEVICES="
            f"{r['cuda_visible_devices']!r}, {r['device']!r}, no CUDA context before the call); FunctionMap → output "
            f"{out['map_to_output_s']:.2f}s | {smi}")
        return out
    finally:
        if plane is not None:
            plane.close()
        synchronizer.run(sup.stop())


def phase_pool(torch, ctx: dict) -> None:
    """The warm pool on the card: the worker phase's llama3-8b function
    served through the port's LocalSupervisor with the pool on and off, in
    turns (on, off, off, on): a pooled call is a warm hit served by the
    parked pid, its `import torch` term ~0, its logits equal to the unpooled
    calls', K4 launched in the adopted container (its heartbeat's count), no
    CUDA context in any parked interpreter, and after each pooled placement
    the interpreter exits (it made a CUDA context) and a fresh one parks.
    Then a min_containers=1 function's interpreter pre-forked by a
    PoolDirective serves its call as a warm hit."""
    import gc
    import shutil
    import tempfile

    for key in ("params", "cfg"):  # the containers build their own 16 GB
        ctx.pop(key, None)
    gc.collect()
    torch.cuda.empty_cache()
    smi = ctx.get("nvidia_smi") or _nvidia_smi()
    root = tempfile.mkdtemp(prefix="pool-")
    env = {**_worker_env(root), "MODAL_TPU_WARM_POOL_PREIMPORT": "torch", "MODAL_TPU_HEARTBEAT_INTERVAL": "3",
           "MODAL_TPU_WARM_POOL": None}
    saved = {}
    for key, value in env.items():
        saved[key] = os.environ.pop(key, None)
        if value is not None:
            os.environ[key] = value
    runs = []
    try:
        order = [True, False, False, True] * (POOL_ROUNDS // 2)
        for i, pooled in enumerate(order):
            runs.append(_pool_run(torch, ctx, root, f"{'on' if pooled else 'off'}-{i}", pooled, smi))
        shas = {r["logits_sha256"] for r in runs}
        if len(shas) != 1:
            raise AssertionError(f"pool: the pooled and unpooled calls' logits differ: {[(r['label'], r['logits_sha256'][:16]) for r in runs]}")
        min_run = _pool_min_containers(torch, root, smi)
    finally:
        for key, value in saved.items():
            os.environ.pop(key, None)
            if value is not None:
                os.environ[key] = value
        shutil.rmtree(root, ignore_errors=True)
    on = [r["split"] for r in runs if r["pooled"]]
    off = [r["split"] for r in runs if not r["pooled"]]

    def mean(xs, k):
        return sum(x[k] for x in xs) / len(xs)

    for k in ("spawn_to_hello_s", "import_torch_s", "spawn_to_ready_s", "spawn_to_first_output_s"):
        log(f"[pool] {k}: pool on {', '.join(f'{x[k]:.2f}' for x in on)} s (mean {mean(on, k):.2f}); pool off "
            f"{', '.join(f'{x[k]:.2f}' for x in off)} s (mean {mean(off, k):.2f}) | {smi}")
    if max(x["import_torch_s"] for x in on) >= min(x["import_torch_s"] for x in off):
        raise AssertionError("pool: a pooled placement's import torch was not shorter than every unpooled one's")
    ctx["pool"] = {"runs": runs, "min_containers": min_run, "nvidia_smi": smi}


# -- image: a built, prewarmed image on the card, with a Queue and a Dict -------

IMAGE_PKG = "chip_smoke_img_probe"
# the image's env layer: the AOT spec every container of the image (and a
# parked interpreter of its pool) warms at boot, and a marker
IMAGE_ENV = {"MODAL_TPU_AOT_LOWER": "train,decode,cfg=llama3-8b", "CHIP_SMOKE_IMAGE": "1"}
# the cache-less forward's length in the image function (K1, n_layers launches)
IMAGE_FORWARD_TOKENS = 512


def _image_package(root: str) -> str:
    """A local package for the image's pip layer (installed with --no-index
    --no-build-isolation: no network)."""
    src = os.path.join(root, f"{IMAGE_PKG}-src")
    os.makedirs(os.path.join(src, IMAGE_PKG))
    with open(os.path.join(src, IMAGE_PKG, "__init__.py"), "w") as f:
        f.write("VALUE = 'from the pip layer'\n")
    with open(os.path.join(src, "setup.py"), "w") as f:
        f.write(f"from setuptools import setup\nsetup(name={IMAGE_PKG!r}, version='0.1', packages=[{IMAGE_PKG!r}])\n")
    return src


def _image_prewarm():
    """The image's build function: K1-K4 built into the image (the prewarm's
    build dir), their build report left under the image root."""

    def prewarm() -> None:
        import json as _json
        import os as _os

        from modal_tpu_torch.ops import _build
        from modal_tpu_torch.runtime.aot import maybe_aot_lower

        _os.environ["MODAL_TPU_AOT_LOWER"] = "train,decode,cfg=llama3-8b"
        report = maybe_aot_lower()
        if report is None or report.get("errors"):
            raise RuntimeError(f"prewarm: the AOT warm-up failed: {report}")
        with open(_os.path.join(_os.environ["MODAL_TPU_IMAGE_ROOT"], "prewarm_report.json"), "w") as f:
            _json.dump({"aot": report, "build_dir": _build.build_dir()}, f)

    return prewarm


def _image_serving_fn(cfg_name: str, seed: int, prompts: list, fwd_tokens: list):
    """The image phase's serving function: the serve phase's engine and
    traffic over llama3-8b, each decode step's tokens put into `queue` (a
    thread does the puts, so the engine's loop never waits on an RPC), each
    request's text and the last decode step's logits (a CUDA tensor) written
    into `texts`, then one cache-less forward. It also returns what the
    container saw: its python, the pip layer, the epoch's pins against the
    installed versions, its compile events and where its kernel libraries
    came from."""

    def serve_image(queue, texts, n_requests: int = 8, forward: bool = True) -> dict:
        import hashlib
        import importlib.metadata as md
        import queue as _queue
        import sys as _sys
        import threading as _threading

        import torch

        from modal_tpu_torch import builder
        from modal_tpu_torch.models.llama import forward as llama_forward
        from modal_tpu_torch.models.llama import get_config, init_params
        from modal_tpu_torch.observability.catalog import COMPILE_EVENTS
        from modal_tpu_torch.ops import _build

        import chip_smoke_img_probe

        pins = builder.load_requirements(builder.known_versions()[-1])
        installed = {}
        for name in pins:
            try:
                installed[name] = md.version(name)
            except md.PackageNotFoundError:
                installed[name] = None
        t0 = time.time()
        cfg = get_config(cfg_name)
        params = init_params(cfg, seed=seed, device="cuda")
        torch.cuda.synchronize()
        params_s = time.time() - t0
        t0 = time.time()
        engine = _engine_8b(params, cfg)
        if engine.decode_graph is None:
            raise AssertionError("the engine on CUDA did not capture its decode step")
        engine_s = time.time() - t0
        graph, last = engine.decode_graph, {}

        def keep_last(tokens, active):
            out = graph(tokens, active)
            last["logits"] = out[0].clone()
            return out

        engine.decode_graph = keep_last
        # each decode step's new tokens (the prefill's first token rides the
        # next step's) go to a local queue; a thread puts them into `queue`
        pending: list = []
        local: _queue.Queue = _queue.Queue()
        decode_step = engine._decode_step

        def step_and_flush():
            decode_step()
            if pending:
                local.put(list(pending))
                pending.clear()

        engine._decode_step = step_and_flush

        def pump():
            step = 0
            while True:
                item = local.get()
                if item is None:
                    queue.put({"end": True, "steps": step, "t_put": time.time()})
                    return
                queue.put({"step": step, "tokens": item, "t_put": time.time()})
                step += 1

        pumper = _threading.Thread(target=pump, name="queue-pump")
        pumper.start()
        _build.reset_launches()
        t0 = time.time()
        engine.start()
        try:
            reqs = []
            for i, p in enumerate(prompts[:n_requests]):
                r = engine.submit(p, NEW_TOKENS, **_traffic(i))
                append = r._append

                def tee(token, i=i, append=append):
                    append(token)
                    pending.append((i, token))

                r._append = tee
                reqs.append(r)
            streams = [r.result(timeout=600) for r in reqs]
        finally:
            engine.stop()
            if pending:
                local.put(list(pending))
            local.put(None)
        serve_s = time.time() - t0
        pumper.join(timeout=120)
        stats = engine.stats()
        k4 = _build.LAUNCHES["paged_decode"]
        logits = last["logits"]
        for i, stream in enumerate(streams):
            texts[f"request-{i}"] = " ".join(str(t) for t in stream)
        texts["last_logits"] = logits
        out = {"streams": streams, "logits": logits.cpu(), "decode_steps": stats["steps"],
               "paged_decode_launches": k4, "params_s": params_s, "engine_s": engine_s, "serve_s": serve_s}
        del engine, graph, last
        if forward:
            with torch.inference_mode():
                x = torch.tensor([fwd_tokens], dtype=torch.long, device="cuda")
                t0 = time.time()
                f_logits, _ = llama_forward(params, cfg, x)
                torch.cuda.synchronize()
                out.update(forward_s=time.time() - t0, forward_argmax=int(f_logits[0, -1].float().argmax()),
                           flash_fwd_launches=_build.LAUNCHES["flash_fwd"])
        del params
        torch.cuda.empty_cache()
        out.update(
            python=_sys.executable, prefix=_sys.prefix, pip_layer=chip_smoke_img_probe.VALUE,
            image_root=os.environ.get("MODAL_TPU_IMAGE_ROOT", ""), build_dir=_build.build_dir(),
            pins=pins, installed=installed, compile_events=COMPILE_EVENTS.snapshot(),
            libs={name: lib._name for name, lib in _build._libs.items()}, pid=os.getpid(),
            logits_sha256=hashlib.sha256(out["logits"].numpy().tobytes()).hexdigest(),
            cuda_visible_devices=os.environ.get("CUDA_VISIBLE_DEVICES"), device=torch.cuda.get_device_name(0),
            torch_cuda=torch.version.cuda, env_mark=os.environ.get("CHIP_SMOKE_IMAGE"),
        )
        return out

    return serve_image


def _image_split(sup, task, trace_id: str, t_call: float) -> dict:
    """A container of the image by part, from its trace: the worker's image
    step, the spawn to ContainerHello, `import torch`, the boot's AOT
    warm-up (the kernels' libraries), then to the first output (the whole
    function: params, engine, 8 requests, the forward)."""
    from modal_tpu_torch.observability import tracing

    spans = _spans_of(sup, trace_id)
    missing = [n for n in ("image.build", "container.boot", "container.import_torch", "container.aot_lower")
               if n not in spans]
    if missing:
        raise AssertionError(f"image: the call's trace has no {missing} span (it has {sorted(spans)})")
    build_parts: dict = {}
    for s in tracing.read_spans(tracing.trace_dir()):
        if s["trace_id"] == trace_id and s["name"] == "image.build_part":
            build_parts[s["attrs"]["part"]] = build_parts.get(s["attrs"]["part"], 0.0) + s["end"] - s["start"]
    # the worker's launch decision, its image step (a build on first use),
    # then the spawn
    t0, spawn = spans["container.boot"]["start"], spans["image.build"]["end"]
    part = {n: spans[n]["end"] - spans[n]["start"] for n in ("image.build", "container.import_torch",
                                                            "container.aot_lower")}
    return {"call_to_worker_s": t0 - t_call, "image_step_s": part["image.build"], "build_parts_s": build_parts,
            "spawn_to_hello_s": task.started_at - spawn, "import_torch_s": part["container.import_torch"],
            "aot_s": part["container.aot_lower"], "aot_sources": spans["container.aot_lower"]["attrs"].get("sources"),
            "spawn_to_first_output_s": task.first_output_at - spawn, "call_to_first_output_s": task.first_output_at - t_call}


def _image_heartbeat(task, k4: int, k1: int) -> dict:
    """The container's heartbeat launch counts, once they reach the counts the
    function saw (K4 over the decode steps, K1 over the forward's layers)."""

    def launches(report: dict) -> dict:
        return {k: int(v) for k, v in (report.get("modal_tpu_kernel_launches") or {}).get("series", {}).items()}

    report = _wait_report(task, lambda rep: launches(rep).get("paged_decode") == k4
                          and launches(rep).get("flash_fwd", 0) == k1)
    return launches(report)


def _image_call(torch, ctx: dict, sup, client, app, fn, label: str, cfg, queue, texts) -> dict:
    """One call of the image function: spawned, its Queue drained while it
    runs (each step's put → get ms), its result and the Dict checked."""
    from modal_tpu_torch.observability import tracing

    with tracing.span(f"chip_smoke.image.{label}") as sp:
        t_call = time.time()
        call = fn.spawn(queue, texts)
    drained, lat_ms = [], []
    deadline = time.time() + 900
    while True:
        try:
            item = queue.get(timeout=2.0)
        except TimeoutError:
            if time.time() > deadline:
                raise AssertionError(f"image {label}: no end of the Queue's stream within 900 s") from None
            try:
                call.get(timeout=0)  # a failed call raises its error here instead of a silent wait
            except TimeoutError:
                pass
            continue
        lat_ms.append((time.time() - item["t_put"]) * 1e3)
        if item.get("end"):
            break
        drained.append(item)
    r = call.get()
    (task,) = [t for t in sup.state.tasks.values() if t.function_id == fn.object_id and t.first_output_at]
    split = _image_split(sup, task, sp.trace_id, t_call)
    beats = _image_heartbeat(task, r["paged_decode_launches"], r["flash_fwd_launches"])
    streams = [[] for _ in r["streams"]]
    for item in drained:
        for i, tok in item["tokens"]:
            streams[i].append(tok)
    if streams != r["streams"]:
        raise AssertionError(f"image {label}: the tokens drained from the Queue differ from the return value")
    texts_ok = all(texts[f"request-{i}"] == " ".join(map(str, s)) for i, s in enumerate(r["streams"]))
    t0 = time.perf_counter()
    dict_logits = texts.get("last_logits")
    dict_get_ms = (time.perf_counter() - t0) * 1e3
    dict_bytes = dict_logits.numel() * dict_logits.element_size()
    if not texts_ok or dict_logits.device.type != "cuda" or not torch.equal(dict_logits.cpu(), r["logits"]):
        raise AssertionError(f"image {label}: the Dict's texts {texts_ok}, its logits on {dict_logits.device}")
    steps, k4, k1 = r["decode_steps"], r["paged_decode_launches"], r["flash_fwd_launches"]
    if steps == 0 or k4 != cfg.n_layers * steps or k1 != cfg.n_layers or beats != {**beats, "paged_decode": k4,
                                                                                      "flash_fwd": k1}:
        raise AssertionError(f"image {label}: K4 {k4} over {steps} steps, K1 {k1}, heartbeat {beats}")
    if r["cuda_visible_devices"] != "0" or r["device"] != torch.cuda.get_device_name(0) or not r["torch_cuda"]:
        raise AssertionError(f"image {label}: the container saw {r['cuda_visible_devices']!r}, {r['device']!r}, "
                             f"torch.version.cuda {r['torch_cuda']!r}")
    _check_streams(f"image {label}", r["streams"], cfg.vocab_size)
    if "serve_streams" in ctx:
        bad = [d for d in _first_divergence(ctx["serve_streams"], r["streams"], ctx.get("serve_logits", {}), {})
               if d["sampled"] or d["gap"] > SELF_DRAFT_TIE]
        if bad:
            raise AssertionError(f"image {label}: streams differ from serve's beyond a near-tie: {bad}")
    want = ctx.get("sdk", {}).get("function", {}).get("logits_sha256")
    if want is not None and r["logits_sha256"] != want:
        raise AssertionError(f"image {label}: logits sha256 {r['logits_sha256']}, the sdk phase's {want}")
    _add_launches(ctx, "paged_decode", beats["paged_decode"])
    _add_launches(ctx, "flash_fwd", beats["flash_fwd"])
    p50, p95 = _pcts(lat_ms[:-1])
    return {"label": label, "result": {k: v for k, v in r.items() if k not in ("streams", "logits")},
            "split": split, "heartbeat_launches": beats, "queue_items": len(drained),
            "queue_put_to_get_ms": {"p50": p50, "p95": p95, "n": len(lat_ms) - 1}, "dict_get_logits_ms": dict_get_ms,
            "dict_logits_bytes": dict_bytes,
            "task_id": task.task_id}


def _sources(by_entry: dict) -> set:
    """Where an AOT warm-up's libraries came from ("local", "fleet",
    "nvcc"), over its entries."""
    return {src for kernels in (by_entry or {}).values() for src in kernels.values()}


def _image_checks(label: str, r: dict, prewarmed: bool) -> None:
    """What the container saw of its image: its own python, the pip layer
    (not importable here), the epoch's pins equal to the installed versions,
    and its kernels: loaded from under the image's rootfs with no cache_miss
    and no nvcc run (prewarmed), or built by four nvcc runs (the twin)."""
    import importlib.util

    res = r["result"]
    if not res["python"].endswith("venv/bin/python") or res["pip_layer"] != "from the pip layer" \
            or res["env_mark"] != "1" or importlib.util.find_spec(IMAGE_PKG) is not None:
        raise AssertionError(f"image {label}: python {res['python']}, pip layer {res['pip_layer']!r}, env "
                             f"{res['env_mark']!r}, importable here {importlib.util.find_spec(IMAGE_PKG) is not None}")
    drift = {n: (pin, res["installed"][n]) for n, pin in res["pins"].items()
             if pin != f"{n}=={res['installed'][n]}"}
    if drift:
        raise AssertionError(f"image {label}: epoch pins differ from the installed versions: {drift}")
    events = res["compile_events"]
    nvcc, misses = events.get("compile,runtime", 0), events.get("cache_miss,runtime", 0)
    kernels = os.path.join(res["image_root"], "cache", "kernels")
    if prewarmed:
        if nvcc or misses or res["build_dir"] != kernels or _sources(r["split"]["aot_sources"]) != {"local"} \
                or not res["libs"] or not all(p.startswith(kernels + os.sep) for p in res["libs"].values()):
            raise AssertionError(f"image {label}: compile events {events}, build dir {res['build_dir']}, libs "
                                 f"{res['libs']}, boot sources {r['split']['aot_sources']}")
    elif nvcc != 4:
        raise AssertionError(f"image {label}: the twin's container ran nvcc {nvcc} times, not 4 ({events})")


def _image_pooled(torch, ctx: dict, sup, client, image, cfg, prompts, fwd) -> dict:
    """A min_containers=1 function of the prewarmed image: the scheduler's
    PoolDirective parks an interpreter keyed on the image, running its
    python, whose park-time warm-up finds the image's libraries (no nvcc)
    and makes no CUDA context; the cold first container is stopped, and its
    replacement adopts the parked interpreter and serves one request."""
    from modal_tpu_torch.proto import api_pb2

    app = App("chip_smoke image pooled")
    fn = app.function(image=image, gpu="H100", serialized=True, min_containers=1, max_containers=1,
                      scaledown_window=600, name="serve_one")(_image_serving_fn("llama3-8b", 0, prompts, fwd))
    from modal_tpu_torch import Dict, Queue
    from modal_tpu_torch._utils.async_utils import synchronizer
    from modal_tpu_torch._utils.grpc_utils import retry_transient_errors

    queue, texts = Queue.ephemeral(client=client), Dict.ephemeral(client=client)
    with app.run(client=client):
        image_id = sup.state.functions[fn.object_id].definition.image_id
        entry, park_s = _parked_entry(sup)
        span = next(a for a in reversed(_pool_spans(sup, "coldstart.park")) if a["pid"] == entry.proc.pid)
        warm = [a for a in _pool_spans(sup, "coldstart.aot_lower") if a["pid"] == entry.proc.pid]
        if entry.key != image_id or span["python"] != entry.python_bin or not entry.python_bin.endswith(
                "venv/bin/python") or not warm or warm[-1]["errors"] or warm[-1]["cuda_initialized"] \
                or _sources(warm[-1]["sources"]) != {"local"} or warm[-1]["load_errors"] \
                or sorted(warm[-1]["loaded"]) != sorted(KERNELS):
            raise AssertionError(f"image pooled: entry key {entry.key!r} (image {image_id}), python "
                                 f"{entry.python_bin} / {span['python']}, park-time warm-up {warm}")
        first = [t for t in sup.state.tasks.values() if t.function_id == fn.object_id]
        if len(first) != 1 or first[0].warm_pool_hit:
            raise AssertionError(f"image pooled: the first container {[(t.task_id, t.warm_pool_hit) for t in first]}")
        synchronizer.run(retry_transient_errors(client.stub.ContainerStop,
                                                api_pb2.ContainerStopRequest(task_id=first[0].task_id)))
        t_call = time.time()
        call = fn.spawn(queue, texts, n_requests=1, forward=False)
        r = call.get()
        t_result = time.time()
        task = next(t for t in sup.state.tasks.values() if t.function_id == fn.object_id and t.first_output_at)
        kernels = os.path.join(r["image_root"], "cache", "kernels")
        if not task.warm_pool_hit or r["pid"] != entry.proc.pid or r["python"] != entry.python_bin \
                or r["compile_events"].get("compile,runtime") or r["cuda_visible_devices"] != "0" \
                or sorted(r["libs"]) != sorted(KERNELS) or not all(
                    p.startswith(kernels + os.sep) for p in r["libs"].values()):
            raise AssertionError(f"image pooled: served by pid {r['pid']} (parked {entry.proc.pid}), warm_pool_hit "
                                 f"{task.warm_pool_hit}, python {r['python']}, events {r['compile_events']}")
        k4 = r["paged_decode_launches"]
        beats = _image_heartbeat(task, k4, 0)
        _add_launches(ctx, "paged_decode", beats["paged_decode"])
    return {"parked_pid": entry.proc.pid, "park_s": park_s, "python": entry.python_bin,
            "park_warmup": warm[-1], "adoption_to_first_output_s": task.first_output_at - task.started_at,
            "call_to_result_s": t_result - t_call, "call_to_first_output_s": task.first_output_at - t_call,
            "served": {k: v for k, v in r.items() if k not in ("streams", "logits", "pins", "installed")},
            "heartbeat_launches": beats}


def phase_image(torch, ctx: dict) -> None:
    """Images on the card: a debian_slim image with an env layer, a pip
    layer (a local package) and `.prewarm` (K1-K4 built into the image) is
    built by the port's worker on a fresh plane with an empty fleet store;
    llama3-8b at full width runs as a gpu="H100" function on it, serving the
    serve phase's 8 requests (K4 in the graphed step) and one cache-less
    forward of [1, 512] (K1), each decode step's tokens through a Queue
    drained while the call runs, each request's text and the last logits
    into a named Dict; an image whose RUN fails fails its call with
    INIT_FAILURE and the build log's tail, nothing run; ImageList counts the
    references and ImageDelete refuses a referenced image; a
    min_containers=1 pool keyed on the prewarmed image serves one request by
    adoption. Then the twin image without `.prewarm`, on a second fresh
    plane: its container runs nvcc four times."""
    import gc
    import shutil
    import tempfile

    import grpc

    from modal_tpu_torch import Dict, Image, Queue
    from modal_tpu_torch._utils.async_utils import synchronizer
    from modal_tpu_torch._utils.grpc_utils import retry_transient_errors
    from modal_tpu_torch.client import _Client
    from modal_tpu_torch.models.llama import get_config
    from modal_tpu_torch.observability.catalog import COMPILE_EVENTS
    from modal_tpu_torch.proto import api_pb2
    from modal_tpu_torch.server.supervisor import LocalSupervisor

    for key in ("params", "cfg"):  # the containers build their own 16 GB
        ctx.pop(key, None)
    gc.collect()
    torch.cuda.empty_cache()
    smi = ctx.get("nvidia_smi") or _nvidia_smi()
    cfg = get_config("llama3-8b")
    prompts = _prompts(cfg, 8, seed=1)
    fwd = _forward_prompts(cfg, 4, seed=2)[3]
    if len(fwd) != IMAGE_FORWARD_TOKENS:
        raise AssertionError(f"image: the forward prompt has {len(fwd)} tokens")
    root = tempfile.mkdtemp(prefix="image-")
    pkg = _image_package(root)
    env = {"MODAL_TPU_COMPILE_CACHE": "1", "TORCH_EXTENSIONS_DIR": None, "MODAL_TPU_COMPILE_CACHE_DIR": None,
           "MODAL_TPU_COMPILE_CACHE_URL": None, "MODAL_TPU_AOT_LOWER": None, "MODAL_TPU_WARM_POOL": "0",
           "MODAL_TPU_WARM_POOL_PREIMPORT": "torch", "MODAL_TPU_HEARTBEAT_INTERVAL": "3",
           "MODAL_TPU_IMAGE_BUILDER_VERSION": None}
    saved = {}
    for key, value in env.items():
        saved[key] = os.environ.pop(key, None)
        if value is not None:
            os.environ[key] = value

    def images(*prewarm):
        base = Image.debian_slim(python_version="3.12").env(IMAGE_ENV).pip_install(
            pkg, extra_options="--no-index --no-build-isolation")
        return base.prewarm(_image_prewarm()) if prewarm else base

    def plane(label: str):
        sup = LocalSupervisor(num_workers=1, state_dir=os.path.join(root, label))
        synchronizer.run(sup.start())
        client = _Client(sup.server_url)
        client._open()
        client.hello()
        if sup.workers[0].gpu_type != torch.cuda.get_device_name(0):
            raise AssertionError(f"image: the worker's probe found {sup.workers[0].gpu_type!r}")
        return sup, client

    def rpc(client, name, req):
        return synchronizer.run(retry_transient_errors(getattr(client.stub, name), req))

    out: dict = {"nvidia_smi": smi}
    sups = []
    try:
        # -- the prewarmed image, on a fresh plane with an empty fleet store
        sup, client = plane("prewarmed")
        sups.append((sup, client))
        image = images(True)
        app = App("chip_smoke image")
        fn = app.function(image=image, gpu="H100", serialized=True, scaledown_window=600,
                          name="serve_image")(_image_serving_fn("llama3-8b", 0, prompts, fwd))
        marker = os.path.join(root, "failed-image-ran")

        def never(path=marker):
            open(path, "w").close()

        bad = app.function(image=Image.debian_slim(python_version="3.12").run_commands(
            "echo a layer that fails && exit 3"), serialized=True, name="never")(never)
        queue, texts = Queue.ephemeral(client=client), Dict.lookup("chip-smoke-image-texts", client=client,
                                                                   create_if_missing=True)
        with app.run(client=client):
            run = _image_call(torch, ctx, sup, client, app, fn, "prewarmed", cfg, queue, texts)
            _image_checks("prewarmed", run, prewarmed=True)
            with open(os.path.join(run["result"]["image_root"], "prewarm_report.json")) as f:
                baked = json.load(f)
            parts = run["split"]["build_parts_s"]
            if set(parts) != {"venv", "run", "prewarm"}:
                raise AssertionError(f"image: the build's parts {parts}")
            nvcc_s = max(v["seconds"] for v in (baked["aot"].get("train", {}), baked["aot"].get("decode", {})))
            out["build"] = {"parts_s": parts, "prewarm_aot": baked["aot"], "prewarm_build_dir": baked["build_dir"],
                            "image_step_s": run["split"]["image_step_s"]}
            prewarm_events = {k: v for k, v in COMPILE_EVENTS.snapshot().items() if k.endswith(",prewarm")}
            if prewarm_events.get("compile,prewarm", 0) < 4:
                raise AssertionError(f"image: the prewarm's nvcc runs were not merged as source=prewarm: {prewarm_events}")
            # the failing image: INIT_FAILURE with the log's tail, nothing ran
            t0 = time.time()
            try:
                bad.remote()
                raise AssertionError("image: the call of a failed image succeeded")
            except Exception as exc:  # noqa: BLE001 — the call's failure is the point
                failed_s = time.time() - t0
                message = str(exc)
            failed = [t for t in sup.state.tasks.values() if t.function_id == bad.object_id]
            if "image build failed" not in message or "a layer that fails" not in message or "rc=3" not in message \
                    or os.path.exists(marker) or not failed or any(
                        t.result is None or t.result.status != api_pb2.GENERIC_STATUS_INIT_FAILURE for t in failed):
                raise AssertionError(f"image: the failed build's call said {message[:2000]!r}; tasks "
                                     f"{[(t.task_id, t.result) for t in failed]}; ran {os.path.exists(marker)}")
            # ImageList's reference counts, ImageDelete's refusal
            listed = {i.image_id: i.ref_count for i in rpc(client, "ImageList", api_pb2.ImageListRequest()).images}
            fn_image = sup.state.functions[fn.object_id].definition.image_id
            try:
                rpc(client, "ImageDelete", api_pb2.ImageDeleteRequest(image_id=fn_image))
                raise AssertionError("image: ImageDelete removed a referenced image")
            except grpc.RpcError as exc:
                if exc.code() != grpc.StatusCode.FAILED_PRECONDITION:
                    raise
            if listed.get(fn_image, 0) < 1:
                raise AssertionError(f"image: ImageList {listed} does not count the function's image")
        _wait_app_tasks(sup, app.app_id, timeout=120.0)
        after = {i.image_id: i.ref_count for i in rpc(client, "ImageList", api_pb2.ImageListRequest()).images}
        rpc(client, "ImageDelete", api_pb2.ImageDeleteRequest(image_id=fn_image))
        gone = fn_image not in {i.image_id for i in rpc(client, "ImageList", api_pb2.ImageListRequest()).images}
        out.update(prewarmed=run, failed_build_s=failed_s, failed_message_tail=message[-600:], images_listed=listed,
                   images_after_stop=after, deleted_after_stop=gone)
        log(f"[image] build of the prewarmed image: {', '.join(f'{k} {v:.2f}s' for k, v in sorted(parts.items()))}"
            f" (the prewarm's 4 nvcc runs {nvcc_s:.2f}s in parallel, {prewarm_events} merged); the worker's image "
            f"step in the first call {run['split']['image_step_s']:.2f}s | {smi}")
        # -- the pool keyed on the prewarmed image (same plane, built image)
        pooled = _image_pooled(torch, ctx, sup, client, images(True), cfg, prompts, fwd)
        out["pooled"] = pooled
        # -- the twin without .prewarm, on a second fresh plane and store
        sup2, client2 = plane("twin")
        sups.append((sup2, client2))
        app2 = App("chip_smoke image twin")
        fn2 = app2.function(image=images(), gpu="H100", serialized=True, scaledown_window=600,
                            name="serve_image")(_image_serving_fn("llama3-8b", 0, prompts, fwd))
        queue2, texts2 = Queue.ephemeral(client=client2), Dict.lookup("chip-smoke-image-texts", client=client2,
                                                                      create_if_missing=True)
        with app2.run(client=client2):
            twin = _image_call(torch, ctx, sup2, client2, app2, fn2, "twin", cfg, queue2, texts2)
            _image_checks("twin", twin, prewarmed=False)
        if twin["result"]["logits_sha256"] != run["result"]["logits_sha256"]:
            raise AssertionError("image: the twin's logits differ from the prewarmed image's")
        out["twin"] = twin
    finally:
        for sup_, client_ in sups:
            try:
                client_._close()
            finally:
                synchronizer.run(sup_.stop())
        for key, value in saved.items():
            os.environ.pop(key, None)
            if value is not None:
                os.environ[key] = value
        shutil.rmtree(root, ignore_errors=True)
    for r in (run, twin):
        s, res = r["split"], r["result"]
        log(f"[image] {r['label']} cold call: call → worker {s['call_to_worker_s']:.2f}s, the worker's image step "
            f"{s['image_step_s']:.2f}s ({', '.join(f'{k} {v:.2f}s' for k, v in sorted(s['build_parts_s'].items()))}), "
            f"spawn → ContainerHello {s['spawn_to_hello_s']:.2f}s, import torch "
            f"{s['import_torch_s']:.2f}s, AOT {s['aot_s']:.2f}s ({s['aot_sources']}), spawn → first output "
            f"{s['spawn_to_first_output_s']:.2f}s (params {res['params_s']:.2f}s, engine + graph {res['engine_s']:.2f}s,"
            f" 8 requests {res['serve_s']:.2f}s, forward [1, {IMAGE_FORWARD_TOKENS}] {res['forward_s'] * 1e3:.1f} ms); "
            f"compile events {res['compile_events']}; K4 {res['paged_decode_launches']} = {cfg.n_layers} x "
            f"{res['decode_steps']}, K1 {res['flash_fwd_launches']} (heartbeat {r['heartbeat_launches']}); logits "
            f"sha256 {res['logits_sha256'][:16]}… | {smi}")
        q = r["queue_put_to_get_ms"]
        log(f"[image] {r['label']}: Queue put → get per decode step p50 {q['p50']:.2f} ms p95 {q['p95']:.2f} ms "
            f"({q['n']} items, the streams equal the return value); Dict get of the last logits (back on the card, "
            f"{r['dict_logits_bytes'] / 1e6:.2f} MB) {r['dict_get_logits_ms']:.2f} ms | {smi}")
    res = run["result"]
    log(f"[image] the container ran {res['python']} (torch.version.cuda {res['torch_cuda']}), the pip layer "
        f"importable there and not here, {len(res['pins'])} epoch pins equal to the installed versions; a failed "
        f"build reached INIT_FAILURE in {out['failed_build_s']:.2f}s; ImageList refs {sorted(out['images_listed'].values())}"
        f", ImageDelete refused the referenced image and removed it after the app stopped | {smi}")
    p = out["pooled"]
    log(f"[image] pooled (min_containers=1): pid {p['parked_pid']} parked {p['park_s']:.2f}s after the function's "
        f"creation, running {p['python']}, park-time warm-up {p['park_warmup']['sources']}, "
        f"{p['park_warmup']['loaded']} loaded, without a CUDA context; "
        f"adoption → first output {p['adoption_to_first_output_s']:.2f}s (call → result {p['call_to_result_s']:.2f}s, "
        f"1 request, K4 {p['heartbeat_launches'].get('paged_decode')}) | {smi}")
    ctx["image"] = out


# -- sandbox: a gpu="H100" sandbox on the card ---------------------------------


def _ms_pairs(m: dict) -> str:
    """Each length's two calls as device ms (host ms until the call returned)."""
    return "; ".join(f"{a:.2f} ({ha:.2f}), {b:.2f} ({hb:.2f})" for a, ha, b, hb in zip(
        m["ms_per_call"], m["host_ms_per_call"], m["ms_per_call_again"], m["host_ms_per_call_again"]))


SANDBOX_LENGTHS = "128,256,384,512"
SANDBOX_TUNNEL_ROUNDS = 20


def phase_sandbox(torch, ctx: dict) -> None:
    """A `gpu="H100"` sandbox through `app.run()` (the port's plane booted in
    this process): `sleep infinity` pinned to card 0, then an exec'd
    `python -m modal_tpu_torch.tools.sandbox_forward` builds llama3-8b from
    the seed and runs the cache-less forward through K1 on 4 prompts of
    128-512 tokens (K1 exactly n_layers per call, the kernel path at least
    as close to fp32 attention as the plain path), its JSON line read
    through TaskExecStdioRead; a file written and read back through
    TaskFsOp; stdin streamed to an exec'd `cat`; a tunnel to a loopback
    HTTP server inside the sandbox; snapshot_filesystem restored into a
    second (CPU) sandbox; terminate."""
    import gc
    import shutil
    import tempfile
    import urllib.request

    from modal_tpu_torch import Sandbox
    from modal_tpu_torch._utils.async_utils import synchronizer
    from modal_tpu_torch.client import _Client
    from modal_tpu_torch.models.llama import get_config

    for key in ("params", "cfg"):
        ctx.pop(key, None)
    gc.collect()
    torch.cuda.empty_cache()
    smi = ctx.get("nvidia_smi") or _nvidia_smi()
    kind = torch.cuda.get_device_name(0)
    cfg = get_config("llama3-8b")
    saved = {k: os.environ.pop(k, None) for k in ("MODAL_TPU_SERVER_URL", "MODAL_TPU_STATE_DIR",
                                                 "MODAL_TPU_AUTO_LOCAL_SERVER", "TORCH_EXTENSIONS_DIR",
                                                 "MODAL_TPU_COMPILE_CACHE_DIR", "MODAL_TPU_COMPILE_CACHE_URL")}
    state_dir = os.environ["MODAL_TPU_STATE_DIR"] = tempfile.mkdtemp(prefix="sandbox-")
    app = App("chip_smoke sandbox")
    port = 8000 + os.getpid() % 1000
    out: dict = {"nvidia_smi": smi}
    try:
        with app.run():
            sup = _Client._local_supervisor
            t0 = time.perf_counter()
            sb = Sandbox.create("sleep", "infinity", gpu="H100", app=app, unencrypted_ports=[port], timeout=900)
            sb.wait_until_ready()
            out["create_to_running_s"] = time.perf_counter() - t0
            task = sup.state.tasks[sup.state.sandboxes[sb.object_id].task_id]
            if list(task.gpu_ids) != [0]:
                raise AssertionError(f"sandbox: pinned to {list(task.gpu_ids)}")
            # the forward through K1, exec'd into the sandbox
            t0 = time.perf_counter()
            p = sb.exec(sys.executable, "-m", "modal_tpu_torch.tools.sandbox_forward", "--config", "llama3-8b",
                        "--seed", "0", "--lengths", SANDBOX_LENGTHS)
            first_byte, text = None, ""
            for chunk in p.stdout:
                first_byte = first_byte or time.perf_counter() - t0
                text += chunk
            rc = p.wait()
            exec_s = time.perf_counter() - t0
            if rc != 0:
                raise AssertionError(f"sandbox: the forward exited {rc}: {text[-2000:]}\n{p.stderr.read()[-4000:]}")
            fwd = json.loads([line for line in text.splitlines() if line.startswith("{")][-1])
            n_calls = len(fwd["lengths"])
            launches = fwd["launches_per_call"] + fwd["launches_per_call_again"]
            if launches != [cfg.n_layers] * 2 * n_calls or fwd["device"] != kind \
                    or fwd["cuda_visible_devices"] != "0":
                raise AssertionError(f"sandbox: K1 launches {launches} (want {cfg.n_layers} a call), "
                                     f"device {fwd['device']!r}, CUDA_VISIBLE_DEVICES {fwd['cuda_visible_devices']!r}")
            _check_faithful("sandbox", fwd["gaps"], 5e-2, tokens=False)
            _add_launches(ctx, "flash_fwd", sum(launches))
            out.update(exec_to_first_byte_s=first_byte, exec_s=exec_s, forward=fwd)
            # a file through TaskFsOp
            payload = os.urandom(1 << 20)
            t0 = time.perf_counter()
            sb.fs.write_file("probe.bin", payload)
            back = sb.fs.read_file("probe.bin")
            out["fs_round_trip_s"] = time.perf_counter() - t0
            if back != payload:
                raise AssertionError("sandbox: the file read back through TaskFsOp differs")
            sb.fs.write_file("note.txt", "from the card's sandbox\n")
            # stdin streamed to an exec'd cat
            data = os.urandom(1 << 20)
            t0 = time.perf_counter()
            cat = sb.exec("cat", text=False)
            cat.stdin.write(data)
            cat.stdin.write_eof()
            cat.stdin.drain()
            echoed = cat.stdout.read()
            if cat.wait() != 0 or echoed != data:
                raise AssertionError(f"sandbox: cat echoed {len(echoed)} of {len(data)} bytes")
            out["stdin_round_trip_s"] = time.perf_counter() - t0
            # a tunnel to a loopback HTTP server inside the sandbox
            sb.exec(sys.executable, "-m", "http.server", str(port), "--bind", "127.0.0.1")
            tun = sb.tunnels()[port]
            deadline = time.monotonic() + 60
            while True:
                try:
                    with urllib.request.urlopen(f"{tun.url}/note.txt", timeout=5) as resp:
                        body = resp.read()
                    break
                except OSError:
                    if time.monotonic() > deadline:
                        raise
                    time.sleep(0.2)
            if body != b"from the card's sandbox\n":
                raise AssertionError(f"sandbox: the tunnel answered {body!r}")
            trips = []
            for _ in range(SANDBOX_TUNNEL_ROUNDS):
                t0 = time.perf_counter()
                with urllib.request.urlopen(f"{tun.url}/note.txt", timeout=5) as resp:
                    resp.read()
                trips.append(time.perf_counter() - t0)
            out["tunnel_round_trip_ms"] = {"median": statistics.median(trips) * 1e3, "min": min(trips) * 1e3,
                                           "max": max(trips) * 1e3}
            # snapshot_filesystem, restored into a second (CPU) sandbox
            t0 = time.perf_counter()
            image = sb.snapshot_filesystem()
            out["snapshot_s"] = time.perf_counter() - t0
            blob_id = sup.state.images[image.object_id].definition.fs_snapshot_blob_id
            out["snapshot_bytes"] = os.path.getsize(sup.state.blob_path(blob_id))
            sb2 = Sandbox.create("cat", "note.txt", image=image, app=app)
            if sb2.wait() != 0 or sb2.stdout.read() != "from the card's sandbox\n":
                raise AssertionError("sandbox: the restored sandbox did not see the snapshot's file")
            task2 = sup.state.tasks[sup.state.sandboxes[sb2.object_id].task_id]
            if list(task2.gpu_ids):
                raise AssertionError(f"sandbox: the CPU sandbox was pinned to {list(task2.gpu_ids)}")
            sb.terminate()
            if sb.wait(raise_on_termination=False) == 0:
                raise AssertionError("sandbox: terminate did not end the sandbox")
    finally:
        if _Client._local_supervisor is not None:
            if _Client._client_from_env is not None:
                _Client._client_from_env._close()
            synchronizer.run(_Client._local_supervisor.stop())
            _Client._local_supervisor = None
            _Client.set_env_client(None)
        shutil.rmtree(state_dir, ignore_errors=True)
        for key, value in saved.items():
            os.environ.pop(key, None)
            if value is not None:
                os.environ[key] = value
    g = fwd["gaps"]
    log(f"[sandbox] create → running {out['create_to_running_s']:.2f}s; exec → first byte "
        f"{out['exec_to_first_byte_s']:.2f}s, exec → exit {out['exec_s']:.2f}s; llama3-8b cache-less forward at "
        f"{fwd['lengths']} tokens, twice each: {_ms_pairs(fwd)} ms a call, K1 "
        f"{fwd['launches_per_call']} launches; vs fp32 attention kernel max {g['kernel_vs_fp32']['max']:.3e} mean "
        f"{g['kernel_vs_fp32']['mean']:.3e}, plain max {g['plain_vs_fp32']['max']:.3e} mean "
        f"{g['plain_vs_fp32']['mean']:.3e}; peak device {fwd['peak_device_bytes'] / 1e9:.2f} GB | {smi}")
    log(f"[sandbox] TaskFsOp 1 MiB write + read {out['fs_round_trip_s'] * 1e3:.1f} ms; 1 MiB through an exec'd "
        f"cat {out['stdin_round_trip_s'] * 1e3:.1f} ms; tunnel HTTP round trip median "
        f"{out['tunnel_round_trip_ms']['median']:.2f} ms (min {out['tunnel_round_trip_ms']['min']:.2f}, max "
        f"{out['tunnel_round_trip_ms']['max']:.2f}, {SANDBOX_TUNNEL_ROUNDS} requests); snapshot_filesystem "
        f"{out['snapshot_bytes']} bytes in {out['snapshot_s']:.2f}s, restored into a CPU sandbox | {smi}")
    ctx["sandbox"] = out


KERNELS = {
    "paged_decode": ("modal_tpu_torch/csrc/paged_decode.cu", "modal_tpu/ops/paged_attention.py:42"),
    "flash_fwd": ("modal_tpu_torch/csrc/flash_fwd.cu", "modal_tpu/ops/attention.py:50"),
    "flash_bwd_dq": ("modal_tpu_torch/csrc/flash_bwd_dq.cu", "modal_tpu/ops/attention.py:106"),
    "flash_bwd_dkv": ("modal_tpu_torch/csrc/flash_bwd_dkv.cu", "modal_tpu/ops/attention.py:152"),
}
# the phases whose run each kernel's launch count is read from
PATHS = {"paged_decode": ("serve", "sdk", "worker", "app", "pool", "image", "graphs", "weights", "volume", "int8", "spec",
                          "disagg", "web", "observe", "disagg_http"),
         "flash_fwd": ("app", "image", "sandbox", "weights", "volume", "observe", "forward", "train", "moe", "mesh"),
         "flash_bwd_dq": ("volume", "train", "moe", "mesh"),
         "flash_bwd_dkv": ("volume", "train", "moe", "mesh")}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--phases", default=",".join(PHASES), help="comma list of " + ",".join(PHASES))
    ap.add_argument("--out", default="", help="also write every measurement as JSON here")
    args = ap.parse_args()
    phases = [p for p in args.phases.split(",") if p]
    unknown = set(phases) - set(PHASES)
    if unknown:
        ap.error(f"unknown phases {sorted(unknown)}")

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    import modal_tpu_torch  # noqa: F401 — fails outside a checkout of the repo

    ctx: dict = {}
    t_all = time.perf_counter()
    for name in PHASES:
        if name in phases:
            t0 = time.perf_counter()
            globals()[f"phase_{name}"](torch, ctx)
            log(f"[{name}] phase done in {time.perf_counter() - t0:.1f}s, "
                f"{torch.cuda.memory_allocated() / 1e6:.1f} MB allocated; {_host_room()}")
    for key in ("params", "cfg", "serve_logits"):  # tensors, and logits keyed by (request, token)
        ctx.pop(key, None)
    log(f"[total] {time.perf_counter() - t_all:.1f}s")
    rows = []
    for name, m in ctx.get("kernels", {}).items():
        source, replaces = KERNELS[name]
        rows.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": ctx.get("launches", {}).get(name, 0), "max_abs_err": m["max_abs_err"],
            "ms": m["ms"], "plain_ms": m["plain_ms"], "bound_ms": m["bound_ms"],
            "bound_by": m["bound_by"], "library_ms": m["library_ms"],
        })
    for row in rows:
        if set(PATHS[row["name"]]) & set(phases) and row["launches"] == 0:
            raise AssertionError(f"{row['name']} was never launched on its path")
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump({"phases": phases, **ctx}, f, indent=1, default=str)
    print(ctx["nvidia_smi"] if "nvidia_smi" in ctx else "nvidia-smi: not queried", flush=True)
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
