"""The runtime debug profile on the card (`runtime/container_entrypoint.py`
`_maybe_profile`): torch.profiler's CUDA activity is chosen from the
function's card ask, and CUPTI sees the kernels of a graphed decode step.
Every test here needs an NVIDIA GPU and skips without one:
`python -m pytest -m cuda tests/test_torch_profile_cuda.py` on the card."""

import json
import os

import pytest
import torch

from modal_tpu_torch.models import llama as tllama
from modal_tpu_torch.runtime import container_entrypoint as ce


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA activity of torch.profiler traces the card)")
    return torch.device("cuda")


def _profiled(tmp_path, on_card: bool, fn) -> list:
    """The trace events of `fn()` run under `_maybe_profile`, as a function
    that asked for a card (`on_card`) or for none would be profiled."""
    saved = (ce.PROFILE_DIR, ce.PROFILE_CUDA)
    ce.PROFILE_DIR, ce.PROFILE_CUDA = str(tmp_path), on_card
    try:
        with ce._maybe_profile():
            fn()
            torch.cuda.synchronize()
    finally:
        ce.PROFILE_DIR, ce.PROFILE_CUDA = saved
    (trace,) = [n for n in os.listdir(tmp_path) if n.endswith(".pt.trace.json")]
    with open(tmp_path / trace) as fh:
        return json.load(fh)["traceEvents"]


@pytest.mark.cuda
@pytest.mark.parametrize("on_card", [True, False])
def test_the_debug_profile_traces_the_card_only_for_a_card_function(cuda_device, tmp_path, on_card):
    """With the CUDA activity (a function that asked for a card) the trace
    holds the card's kernels; without it (a CPU function) none."""
    x = torch.randn(256, 256, device=cuda_device)
    events = _profiled(tmp_path, on_card, lambda: (x @ x).sum().item())
    kernels = [e for e in events if e.get("cat") == "kernel"]
    assert bool(kernels) is on_card, len(kernels)


@pytest.mark.cuda
def test_k4_launches_show_in_a_profiled_graph_replay(cuda_device, tmp_path):
    """A graphed decode step (`paged_kv.DecodeGraph`) replayed under the
    debug profile: CUPTI records each replayed K4 launch as a kernel event
    (n_layers per step), as the eager step's launches are."""
    from modal_tpu_torch.ops import _build
    from modal_tpu_torch.serving.engine import ServingEngine

    cfg = tllama.get_config("tiny")
    params = tllama.init_params(cfg, seed=0, device=cuda_device)
    engine = ServingEngine(params, cfg, max_slots=4, num_pages=33, page_size=16, pages_per_slot=8,
                           prefill_chunk=32, device=cuda_device, cuda_graphs=True)
    assert engine.decode_graph is not None
    engine.start()
    try:
        engine.submit(list(range(3, 30)), 4).result(timeout=120)  # builds and warms K4
        _build.reset_launches()

        def traffic():
            engine.submit(list(range(5, 40)), 12).result(timeout=120)

        events = _profiled(tmp_path, True, traffic)
    finally:
        engine.stop()
    k4 = [e for e in events if e.get("cat") == "kernel" and "paged_decode_kernel" in str(e.get("name", ""))]
    launches = _build.LAUNCHES["paged_decode"]
    assert launches > 0 and len(k4) == launches, (len(k4), launches)
