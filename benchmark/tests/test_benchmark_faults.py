"""The check catches a broken timed path: a sound run is correct, and each
fault a cell can have, planted under the harness, makes `correct` false.
The control (the reference in float8 in the program's place) fails the
tiny cells' limits too. Driven on the CPU at the tiny size: the harness's
look for a card is skipped."""

from __future__ import annotations

import contextlib

import pytest
import torch

from benchmark import check, control, run, weights
from benchmark.tests.tiny import make_root


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return make_root(tmp_path_factory.mktemp("faults"))


def outcome(root, cell, seed=5, step_hook=None, ctx=None):
    args = run.parse(["--workload", cell, "--seed", str(seed), "--seconds", "3"])
    with ctx or contextlib.nullcontext():
        out = run.execute(args, "cpu", root, step_hook=step_hook)
    return out, run.result_line(out, False, root)


def unchanged(step_fn):
    """A step whose state comes back as it went in."""

    def step(state, tokens):
        saved = [p.detach().clone() for p in _params(state)]
        state, metrics = step_fn(state, tokens)
        with torch.no_grad():
            for p, s in zip(_params(state), saved):
                p.copy_(s)
        return state, metrics

    return step


def _params(state):
    from modal_tpu_torch.parallel.train import tree_leaves

    return tree_leaves(state.params)


@pytest.mark.parametrize("cell", ["tiny.chat", "tiny.docqa", "tiny.train"])
def test_a_sound_run_is_correct(root, cell):
    _out, result = outcome(root, cell)
    assert result["correct"] is True, result["check"]


@pytest.mark.parametrize("cell", ["tiny.chat", "tiny.docqa"])
def test_a_token_altered_where_it_is_produced_fails(root, cell):
    _out, result = outcome(root, cell, ctx=control.altered_tokens())
    assert result["correct"] is False
    assert result["check"]["served_gap"]["value"] > 0.05


@pytest.mark.parametrize("fault,number", [(control.half_batch, "grad_gap"), (unchanged, "update_gap")],
                         ids=["half_batch", "state_unchanged"])
def test_a_broken_training_step_fails(root, fault, number):
    _out, result = outcome(root, "tiny.train", step_hook=fault)
    assert result["correct"] is False
    limit = float(result["check"][number]["limit"].split()[-1])
    assert result["check"][number]["value"] > limit


def skips_the_window(step_fn):
    """Sound through set-up's steps; in the window each step returns its
    state without an update."""
    calls = [0]

    def step(state, tokens):
        calls[0] += 1
        if calls[0] > 2:  # the tiny mix's check_steps
            return state, {"loss": torch.zeros(())}
        return step_fn(state, tokens)

    return step


def test_a_step_that_fails_only_in_the_window_fails(root):
    out, result = outcome(root, "tiny.train", step_hook=skips_the_window)
    assert out.run.train.steps > 0
    assert result["check"]["step_count_gap"]["value"] == out.run.train.steps
    assert result["correct"] is False


def test_the_float8_control_fails_the_training_limits(root):
    out, _result = outcome(root, "tiny.train", seed=7)
    nums = control.control_numbers(out, 7, "cpu")
    ok, _ = check.judge({k.split(".")[0]: v for k, v in nums.items()},
                        check.load_limits(root / "benchmark" / "limits" / "tiny.train.json"))
    assert ok is False


@pytest.mark.parametrize("seed", [3, 7])
def test_the_float8_control_fails_the_serving_limit(root, seed):
    out, result = outcome(root, "tiny.chat", seed=seed)
    assert result["correct"] is True
    w = weights.make(out.run.model, seed, "cpu")
    gaps = check.lower_precision_gaps(out.run.model, w, out.sample, ("fp8",))
    ok, _ = check.judge({"served_gap": gaps["fp8"]}, {"served_gap": check.load_limits(
        root / "benchmark" / "limits" / "tiny.chat.json")["served_gap"]})
    assert ok is False
