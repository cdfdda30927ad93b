"""A copy of the benchmark at the `tiny` size for the CPU tests: the same
harness, readers and reference, with configurations, mixes and limits
small enough for a test run."""

from __future__ import annotations

import copy
import json
import shutil
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]

TINY = {
    "name": "tiny", "source": "https://huggingface.co/mistralai/Mistral-7B-v0.3/blob/main/config.json",
    "vocab_size": 2048, "hidden_size": 128, "intermediate_size": 256, "num_hidden_layers": 2,
    "num_attention_heads": 4, "num_key_value_heads": 2, "hidden_act": "silu", "rms_norm_eps": 1e-5,
    "rope_theta": 1e6, "max_position_embeddings": 256, "tie_word_embeddings": False,
    "torch_dtype": "bfloat16", "initializer_range": 0.02,
}
TINY_MHA = {**TINY, "name": "tiny-mha", "num_key_value_heads": 4, "rope_theta": 1e4}

CHAT = {
    "kind": "serve", "clients": 8,
    "engine": {"max_slots": 8, "page_size": 16, "prefill_chunk": 16, "num_pages": 129},
    "requests": 16,
    "prompt_tokens": {"dist": "lognormal", "median": 20, "sigma": 0.8, "min": 8, "max": 60},
    "output_tokens": {"dist": "lognormal", "median": 24, "sigma": 0.6, "min": 8, "max": 48},
    "sampled_share": 0.5, "temperature": 0.8, "top_p": 0.95, "top_k": 0,
    "preroll_completions": 2, "check_requests": 4,
}
DOCQA = {
    **CHAT, "shared_prefix": {"count": 2, "tokens": 40}, "sampled_share": 0.0,
    "prompt_tokens": {"dist": "uniform", "min": 4, "max": 12},
}
TRAIN = {
    "kind": "train", "batch": 1, "seq_len": 64,
    "train_config": {"learning_rate": 3e-4, "weight_decay": 0.1, "b1": 0.9, "b2": 0.95, "grad_clip": 1.0,
                     "warmup_steps": 0, "total_steps": 100000, "remat": True},
    "check_steps": 2,
}
# limits set as the cells' are, from the tiny size's readings on the CPU
# (program, seeds 1-8: served_gap <= 0.0044, loss_gap <= 2.3e-5, grad_gap
# <= 0.0022, update_gap <= 0.0008; the float8 control: served_gap >=
# 0.0125, loss_gap >= 3.4e-4); the kernels do not run on the CPU, so their
# launches are not asked for
SERVE_LIMITS = {"served_gap": {"max": 0.008}, "k4_launches": {"min": 0}}
TRAIN_LIMITS = {"loss_gap": {"max": 1e-4}, "grad_gap": {"max": 0.005}, "update_gap": {"max": 0.0015},
                "step_count_gap": {"max": 0},
                "flash_fwd_launches": {"min": 0}, "flash_bwd_dq_launches": {"min": 0},
                "flash_bwd_dkv_launches": {"min": 0}}


def make_root(tmp: Path) -> Path:
    """A checkout-shaped directory: the benchmark's files, with the cells
    swapped for tiny ones (`tiny.chat`, `tiny.docqa`, `tiny.train`)."""
    root = Path(tmp) / "checkout"
    shutil.copytree(REPO / "benchmark", root / "benchmark",
                    ignore=shutil.ignore_patterns(".cache", "__pycache__", "tests"))
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    bench = copy.deepcopy(bench)
    for name, cfg in (("tiny", TINY), ("tiny-mha", TINY_MHA)):
        (root / "benchmark" / "configs" / f"{name}.json").write_text(json.dumps(cfg))
    for name, mix in (("tiny_chat", CHAT), ("tiny_docqa", DOCQA), ("tiny_train", TRAIN)):
        (root / "benchmark" / "traffic" / f"{name}.json").write_text(json.dumps(mix))
    cells = {"mistral7b.chat": ("tiny.chat", "tiny", "tiny_chat", SERVE_LIMITS),
             "deepseek7b.docqa": ("tiny.docqa", "tiny-mha", "tiny_docqa", SERVE_LIMITS),
             "mistral7b.train": ("tiny.train", "tiny", "tiny_train", TRAIN_LIMITS)}
    bench["configs"] = [
        {"name": "tiny", "source": TINY["source"], "file": "benchmark/configs/tiny.json", "reduced": [],
         "why": "tiny"},
        {"name": "tiny-mha", "source": TINY["source"], "file": "benchmark/configs/tiny-mha.json", "reduced": [],
         "why": "tiny"},
    ]
    for w in bench["workloads"]:
        new, config, traffic, limits = cells[w["name"]]
        w.update(name=new, config=config, traffic=traffic)
        (root / "benchmark" / "limits" / f"{new}.json").write_text(json.dumps(limits))
    rename = {old: new for old, (new, *_rest) in cells.items()}
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "workloads" in m:
            m["workloads"] = [rename[c] for c in m["workloads"]]
    (root / "BENCHMARK.json").write_text(json.dumps(bench, indent=1))
    return root
