"""The harness is driven by data: a new configuration, traffic mix, limits
file and cell entry are found and run with no existing file edited, and
`validate` holds names, units and keys to the benchmark's rules."""

from __future__ import annotations

import copy
import hashlib
import json
from pathlib import Path

import pytest

from benchmark import run, spec
from benchmark.tests.tiny import CHAT, REPO, SERVE_LIMITS, TINY, make_root


def digests(root: Path) -> dict:
    return {str(p.relative_to(root)): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(root.rglob("*")) if p.is_file() and "__pycache__" not in p.parts}


def test_the_repository_benchmark_is_valid():
    assert spec.validate(spec.load(REPO), REPO) == []


def test_a_new_cell_is_found_by_name_with_no_file_edited(tmp_path, capsys):
    root = make_root(tmp_path)
    before = digests(root)
    cfg = {**TINY, "name": "tiny-wide-rope", "rope_theta": 5e5}
    (root / "benchmark" / "configs" / "tiny-wide-rope.json").write_text(json.dumps(cfg))
    mix = {**CHAT, "clients": 2, "prompt_tokens": {"dist": "uniform", "min": 8, "max": 24}}
    (root / "benchmark" / "traffic" / "tiny_pairs.json").write_text(json.dumps(mix))
    (root / "benchmark" / "limits" / "tiny.pairs.json").write_text(json.dumps(SERVE_LIMITS))
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "tiny-wide-rope", "source": cfg["source"],
                             "file": "benchmark/configs/tiny-wide-rope.json", "reduced": [], "why": "a test"})
    bench["workloads"].append({"name": "tiny.pairs", "config": "tiny-wide-rope", "traffic": "tiny_pairs",
                               "chips": 1, "why": "two clients"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "tiny.chat" in m.get("workloads", []):
            m["workloads"].append("tiny.pairs")
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    assert spec.validate(bench, root) == []
    after = digests(root)
    assert {k: v for k, v in after.items() if k in before} == {k: v for k, v in before.items() if k != "BENCHMARK.json"} | {"BENCHMARK.json": after["BENCHMARK.json"]}
    assert run.main(["--workload", "tiny.pairs", "--seed", "4294967311", "--seconds", "3", "--trace", "0"],
                    device="cpu", root=root) == 0
    result = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert result["correct"] is True
    assert set(result["metrics"]) == {m["name"] for m in spec.cell_metrics(bench, "tiny.pairs", "end_to_end")}
    assert {"output_tok_s", "setup_s"} <= set(result["metrics"])
    assert list(result)[-1] == "check"


def _broken(mutate):
    bench = copy.deepcopy(spec.load(REPO))
    mutate(bench)
    return spec.validate(bench, REPO)


@pytest.mark.parametrize("mutate", [
    lambda b: b["per_layer"][0].update(name="decode batch"),
    lambda b: b["per_layer"][0].update(name="a/b"),
    lambda b: b["end_to_end"][0].update(unit="tokens per second"),
    lambda b: b["end_to_end"][0].update(unit="µs"),
    lambda b: b["workloads"][0].update(name="chat,short"),
    lambda b: b["end_to_end"][0].update(bound=0.3),
    lambda b: b["per_layer"][0].update(why="extra key"),
    lambda b: b["workloads"][0].update(chips=2),
    lambda b: b["workloads"][1].update(traffic="no_such_mix"),
    lambda b: b["per_layer"][0].update(moves="train_tok_s"),
    lambda b: b["configs"][0].update(file="BENCHMARK.json"),
], ids=["space", "slash", "unit-words", "unit-greek", "comma", "bound", "extra-key", "chips", "mix",
        "moves-elsewhere", "file-outside"])
def test_breaches_are_refused(mutate):
    assert _broken(mutate)


@pytest.mark.parametrize("change", [
    {"loop": "open"},
    {"engine": {**CHAT["engine"], "max_waiting": 8}},
    {"prompt_tokens": {"dist": "uniform", "min": 8, "max": 60, "median": 20}},
], ids=["unread-key", "engine-key", "length-key"])
def test_a_mix_knob_the_harness_does_not_honour_is_refused(tmp_path, change):
    root = make_root(tmp_path)
    (root / "benchmark" / "traffic" / "tiny_chat.json").write_text(json.dumps({**CHAT, **change}))
    assert any("tiny_chat" in e for e in spec.validate(spec.load(root), root))
    assert run.main(["--workload", "tiny.chat", "--seed", "3", "--seconds", "1", "--trace", "0"],
                    device="cpu", root=root) == 2

