"""Nothing the benchmark runs loads JAX or the JAX package, and the
reference loads nothing of the program. Module names are compared by their
top-level name, the part before the first dot, whole: `modal_tpu_torch`
is not `modal_tpu`."""

from __future__ import annotations

import json
import subprocess
import sys
import textwrap
from pathlib import Path

from benchmark.tests.tiny import REPO, make_root

FORBIDDEN = ("jax", "jaxlib", "flax", "modal_tpu")


def fresh(code: str, cwd: Path = REPO) -> list[str]:
    """Top-level module names loaded after `code` ran in a new interpreter."""
    probe = textwrap.dedent(code) + textwrap.dedent("""
        import json, sys
        print(json.dumps(sorted({m.split(".", 1)[0] for m in sys.modules})))
    """)
    out = subprocess.run([sys.executable, "-c", probe], cwd=cwd, capture_output=True, text=True, timeout=300,
                         env={"PATH": "/usr/bin:/bin", "PYTHONPATH": str(REPO), "HOME": str(cwd)})
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_harness_modules_load_no_jax():
    loaded = fresh("""
        from pathlib import Path
        import benchmark.run, benchmark.serve, benchmark.train, benchmark.check, benchmark.control
        import benchmark.measure, benchmark.trace, benchmark.stats, benchmark.roofline, benchmark.readers
        import benchmark.workload, benchmark.weights, benchmark.models, benchmark.spec
        import benchmark.reference.llama
        from benchmark import models, spec
        root = Path(benchmark.run.ROOT)
        bench = spec.load(root)
        for c in bench["configs"]:
            m, _ = models.load(root / c["file"])
            models.llama_config(m)
        for w in bench["workloads"]:
            json.loads(spec.traffic_path(root, w["traffic"]).read_text())
        for m in bench["per_layer"]:
            spec.reader(root, m["name"])
        import modal_tpu_torch.serving.engine, modal_tpu_torch.parallel.train
    """.replace("from pathlib", "import json\n        from pathlib"))
    assert "modal_tpu_torch" in loaded
    assert not [m for m in loaded if m in FORBIDDEN]


def test_reference_loads_nothing_of_the_program():
    loaded = fresh("import benchmark.reference.llama")
    assert "torch" in loaded
    assert not [m for m in loaded if m in FORBIDDEN + ("modal_tpu_torch",)]


def test_a_whole_run_loads_no_jax(tmp_path):
    root = make_root(tmp_path)
    loaded = fresh(f"""
        from pathlib import Path
        from benchmark import run
        rc = run.main(["--workload", "tiny.chat", "--seed", "21", "--seconds", "3", "--trace", "0"],
                      device="cpu", root=Path({str(root)!r}))
        assert rc == 0
    """, cwd=tmp_path)
    assert not [m for m in loaded if m in FORBIDDEN]


def test_without_a_card_the_run_fails_and_prints_no_result(tmp_path):
    out = subprocess.run([sys.executable, "-m", "benchmark.run", "--workload", "mistral7b.chat", "--seed", "1",
                          "--seconds", "1", "--trace", "0"], cwd=REPO, capture_output=True, text=True,
                         timeout=300, env={"PATH": "/usr/bin:/bin", "HOME": str(tmp_path), "CUDA_VISIBLE_DEVICES": ""})
    assert out.returncode != 0 and out.stdout.strip() == ""


def test_with_only_the_benchmark_the_run_fails_and_prints_no_result(tmp_path):
    root = make_root(tmp_path)  # BENCHMARK.json and the files under its paths, nothing else
    out = subprocess.run([sys.executable, "-m", "benchmark.run", "--workload", "tiny.train", "--seed", "1",
                          "--seconds", "1", "--trace", "0"], cwd=root, capture_output=True, text=True,
                         timeout=300, env={"PATH": "/usr/bin:/bin", "HOME": str(tmp_path)})
    assert out.returncode != 0 and out.stdout.strip() == ""
    assert "modal_tpu_torch" in out.stderr


def test_a_forbidden_module_loaded_after_the_window_stops_the_result(tmp_path):
    """The look at `sys.modules` comes after the check and the readers: a
    module that either loads still stops the result line."""
    root = make_root(tmp_path)
    probe = textwrap.dedent(f"""
        import sys, types
        from pathlib import Path
        from benchmark import check, run
        judge = check.judge

        def loads_jax(*args, **kwargs):
            sys.modules["jax"] = types.ModuleType("jax")
            return judge(*args, **kwargs)

        check.judge = loads_jax
        rc = run.main(["--workload", "tiny.chat", "--seed", "22", "--seconds", "3", "--trace", "0"],
                      device="cpu", root=Path({str(root)!r}))
        print("RC", rc)
    """)
    out = subprocess.run([sys.executable, "-c", probe], cwd=tmp_path, capture_output=True, text=True, timeout=300,
                         env={"PATH": "/usr/bin:/bin", "PYTHONPATH": str(REPO), "HOME": str(tmp_path)})
    lines = out.stdout.strip().splitlines()
    assert lines and lines[-1] == "RC 4", out.stderr[-3000:]
    assert not [line for line in lines if line.startswith("{")]
    assert "jax" in out.stderr
