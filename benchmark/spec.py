"""`BENCHMARK.json` and the files it names, found by name:

- a configuration `<config>` is the file its entry names, under
  `benchmark/configs/`;
- a traffic mix `<traffic>` is `benchmark/traffic/<traffic>.json`;
- a per-layer metric `<metric>` is read by `benchmark/metrics/<metric>.py`,
  whose `read(run)` returns the number, or None where it found nothing to
  read;
- a cell's limits are `benchmark/limits/<cell>.json`.

A later cell, mix, configuration or metric is a new file and a new entry;
no file here changes. `validate` holds the file to the benchmark's rules
on names, units and keys."""

from __future__ import annotations

import importlib.util
import json
import re
from pathlib import Path

from .workload import mix_errors

HERE = Path(__file__).resolve().parent
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
LINE = re.compile(r"^[^\n\t]{1,200}$")
PATH = re.compile(r"^[A-Za-z0-9_.\-/]{1,200}$")
TOP_KEYS = {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
CONFIG_KEYS = {"name", "source", "file", "reduced", "why"}
CELL_KEYS = {"name", "config", "traffic", "chips", "why"}
E2E_KEYS = {"name", "unit", "better", "bound", "source"}
LAYER_KEYS = {"name", "unit", "better", "source", "layer", "moves"}
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def load(root: Path) -> dict:
    return json.loads((Path(root) / "BENCHMARK.json").read_text())


def cell(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def config_entry(bench: dict, name: str) -> dict:
    for c in bench["configs"]:
        if c["name"] == name:
            return c
    raise KeyError(f"no configuration {name!r} in BENCHMARK.json")


def traffic_path(root: Path, traffic: str) -> Path:
    return Path(root) / "benchmark" / "traffic" / f"{traffic}.json"


def limits_path(root: Path, cell_name: str) -> Path:
    return Path(root) / "benchmark" / "limits" / f"{cell_name}.json"


def metric_path(root: Path, metric: str) -> Path:
    return Path(root) / "benchmark" / "metrics" / f"{metric}.py"


def reader(root: Path, metric: str):
    """The `read` function of a per-layer metric's reader."""
    path = metric_path(root, metric)
    mod_name = "benchmark_metric_" + re.sub(r"[^A-Za-z0-9_]", "_", metric)
    spec = importlib.util.spec_from_file_location(mod_name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def cell_metrics(bench: dict, cell_name: str, kind: str) -> list[dict]:
    """The metrics of `kind` ("end_to_end" or "per_layer") this cell reports:
    those whose `workloads` name it, and those without the key."""
    return [m for m in bench[kind] if cell_name in m.get("workloads", [cell_name])]


def validate(bench: dict, root: Path) -> list[str]:
    """Every breach of the benchmark's rules found in `bench` (empty when
    none)."""
    errs: list[str] = []

    def need(cond: bool, msg: str) -> None:
        if not cond:
            errs.append(msg)

    root = Path(root)
    need(set(bench) == TOP_KEYS, f"top-level keys {sorted(bench)}")
    paths = bench.get("paths", [])
    need(1 <= len(paths) <= 16 and all(PATH.match(p) and ".." not in p.split("/") and not p.startswith("/")
                                       for p in paths), f"paths {paths}")
    cmd = bench.get("command", [])
    need(1 <= len(cmd) <= 32 and all(LINE.match(w) for w in cmd), "command")
    need(isinstance(bench.get("run_seconds"), int) and 1 <= bench["run_seconds"] <= 51, "run_seconds")

    def under_paths(f: str) -> bool:
        return any(f == p or f.startswith(p.rstrip("/") + "/") for p in paths)

    names: set = set()
    for c in bench.get("configs", []):
        need(set(c) == CONFIG_KEYS, f"config keys {sorted(c)}")
        need(bool(NAME.match(c.get("name", ""))), f"config name {c.get('name')!r}")
        need(bool(LINE.match(c.get("source", ""))) and bool(LINE.match(c.get("why", ""))), f"config {c.get('name')} source/why")
        need(under_paths(c.get("file", "")) and (root / c.get("file", "")).is_file(), f"config file {c.get('file')}")
        need(len(c.get("reduced", [])) <= 16 and all(NAME.match(k) for k in c.get("reduced", [])), "reduced")
        names.add(c.get("name"))
    files = [c.get("file") for c in bench.get("configs", [])]
    need(len(files) == len(set(files)), "two configurations share a file")
    need(1 <= len(bench.get("configs", [])) <= 24, "number of configs")
    cells: set = set()
    used: set = set()
    pairs: set = set()
    for w in bench.get("workloads", []):
        need(set(w) == CELL_KEYS, f"cell keys {sorted(w)}")
        for key in ("name", "config", "traffic"):
            need(bool(NAME.match(str(w.get(key, "")))), f"cell {key} {w.get(key)!r}")
        need(w.get("config") in names, f"cell {w.get('name')} names an unknown config")
        need(w.get("chips") in (1, 4), f"cell {w.get('name')} chips")
        need(bool(LINE.match(w.get("why", ""))), f"cell {w.get('name')} why")
        mix_file = traffic_path(root, w.get("traffic", ""))
        need(mix_file.is_file(), f"no traffic file for {w.get('traffic')}")
        if mix_file.is_file():
            errs.extend(f"traffic {w.get('traffic')}: {e}" for e in mix_errors(json.loads(mix_file.read_text())))
        need(limits_path(root, w.get("name", "")).is_file(), f"no limits file for {w.get('name')}")
        need((w.get("config"), w.get("traffic")) not in pairs, f"cell {w.get('name')} repeats a pair")
        pairs.add((w.get("config"), w.get("traffic")))
        cells.add(w.get("name"))
        used.add(w.get("config"))
    need(1 <= len(cells) <= 24 and len(cells) == len(bench.get("workloads", [])), "cells")
    need(used == names, "a configuration no cell uses")
    four = sum(1 for w in bench.get("workloads", []) if w.get("chips") == 4)
    need(four <= max(1, len(cells) // 4), "too many four-chip cells")
    metric_names: list = []
    e2e = bench.get("end_to_end", [])
    need(1 <= len(e2e) <= 16 and any(m.get("name") == "setup_s" for m in e2e), "end_to_end")
    for m in e2e:
        need(set(m) - {"workloads"} == E2E_KEYS, f"metric keys {sorted(m)}")
        need(m.get("source") in ("host_clock", "device_trace"), f"{m.get('name')} source")
        need(isinstance(m.get("bound"), (int, float)) and 0 < m["bound"] <= 0.25, f"{m.get('name')} bound")
    for m in bench.get("per_layer", []):
        need(set(m) - {"workloads"} == LAYER_KEYS, f"metric keys {sorted(m)}")
        need(m.get("source") in SOURCES, f"{m.get('name')} source")
        need(bool(LINE.match(m.get("layer", ""))), f"{m.get('name')} layer")
        need(any(e.get("name") == m.get("moves") for e in e2e), f"{m.get('name')} moves an unknown metric")
        need(metric_path(root, m.get("name", "")).is_file(), f"no reader for {m.get('name')}")
    for m in e2e + bench.get("per_layer", []):
        need(bool(NAME.match(m.get("name", ""))), f"metric name {m.get('name')!r}")
        need(bool(UNIT.match(m.get("unit", ""))), f"unit {m.get('unit')!r}")
        need(m.get("better") in ("lower", "higher"), f"{m.get('name')} better")
        need(all(c in cells for c in m.get("workloads", [])), f"{m.get('name')} names an unknown cell")
        metric_names.append(m.get("name"))
    need(len(metric_names) == len(set(metric_names)), "two metrics share a name")
    for w in bench.get("workloads", []):
        reported = [m for m in e2e if w.get("name") in m.get("workloads", [w.get("name")])]
        need(any(m["name"] == "setup_s" for m in reported) and len(reported) >= 2, f"{w.get('name')} end-to-end metrics")
        need(bool(cell_metrics(bench, w.get("name"), "per_layer")), f"{w.get('name')} has no per-layer metric")
    for m in bench.get("per_layer", []):
        moved = next((e for e in e2e if e.get("name") == m.get("moves")), {})
        for c in m.get("workloads", list(cells)):
            need(c in moved.get("workloads", list(cells)), f"{m.get('name')} lists {c}, which does not report {m.get('moves')}")
    need(len(json.dumps(bench).encode()) <= 64 * 1024, "BENCHMARK.json over 64 KiB")
    return errs
