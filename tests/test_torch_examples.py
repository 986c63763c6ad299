"""The JAX package's examples on the port (``repro_torch.examples``), each
``main`` at a cut on the CPU (3 SFT steps, 2 RL steps; two serving
requests): the JAX example's printed lines, in its order, with finite
numbers. Each line's fixed text is read from the JAX example's source,
so the two cannot drift apart unseen. The modules run by
``python -m`` with the JAX example's flags plus ``--device``.
"""
import math
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from repro_torch.examples import hetero_train, quickstart, serve_batch

ROOT = Path(__file__).resolve().parents[1]
NUM = r"(-?[0-9.]+(?:e[+-]?\d+)?|nan|inf)"


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)
    yield


def _lines(capsys):
    return [ln for ln in capsys.readouterr().out.splitlines() if ln.strip()]


def _fixed_text_in_jax_example(name, texts):
    src = (ROOT / "examples" / f"{name}.py").read_text()
    for t in texts:
        assert t in src, t


def _numbers(line):
    vals = [float(x) for x in re.findall(NUM, line)
            if re.fullmatch(NUM, x)]
    return vals


def test_quickstart_prints_the_jax_examples_lines(capsys):
    out = quickstart.main(device="cpu", sft_steps=3, steps=2)
    lines = _lines(capsys)
    pats = [r"== SFT warm start \(the paper RL-tunes a pretrained model\) ==",
            rf"SFT loss: {NUM}",
            r"== GEPO online RL ==",
            rf"step +0: reward={NUM} iw_var={NUM} kl={NUM}",
            r"eval scores: \[.*\]",
            rf"final reward \(last 10 steps\): {NUM}"]
    assert len(lines) == len(pats), lines
    for ln, pat in zip(lines, pats):
        assert re.fullmatch(pat, ln), (pat, ln)
    _fixed_text_in_jax_example("quickstart", [
        "== SFT warm start (the paper RL-tunes a pretrained model) ==",
        "SFT loss: ", "== GEPO online RL ==", "step ", ": reward=",
        "iw_var=", "kl=", "eval scores: ", "final reward (last 10 steps): "])
    assert math.isfinite(out["sft_loss"]) and math.isfinite(
        out["final_reward"])
    assert all(math.isfinite(x) for k in ("reward_mean", "iw_var", "kl")
               for x in out[k])


@pytest.mark.parametrize("method", ["gepo", "gspo"])
def test_hetero_train_prints_the_jax_examples_lines(capsys, method):
    out = hetero_train.main(method=method, device="cpu", sft_steps=3,
                            steps=2)
    lines = _lines(capsys)
    pats = [rf"== {method} under lognormal delay \(median 900s, window 64 "
            r"steps\) ==",
            rf"learner steps: 2, sim time {NUM}s, discarded stale batches: "
            r"\d+",
            rf"staleness: mean={NUM} max={NUM}",
            rf"IW variance: mean={NUM} max={NUM}",
            rf"KL\(learner\|\|sampler\): mean={NUM}",
            rf"reward: first10={NUM} last10={NUM}",
            r"eval: \[.*\]",
            r"sampler syncs: \[\d+, \d+, \d+, \d+\]"]
    assert len(lines) == len(pats), lines
    for ln, pat in zip(lines, pats):
        assert re.fullmatch(pat, ln), (pat, ln)
        assert all(math.isfinite(v) for v in _numbers(ln)), ln
    _fixed_text_in_jax_example("hetero_train", [
        " under ", " delay ", "learner steps: ", ", sim time ",
        "discarded stale batches: ", "staleness: mean=", "IW variance: mean=",
        "KL(learner||sampler): mean=", "reward: first10=", "eval: ",
        "sampler syncs: "])
    assert out["learner_steps"] == 2


def test_serve_batch_serves_through_the_launcher(capsys):
    serve_batch.main(["--arch", "qwen2-7b", "--batch", "2", "--max-new",
                      "4", "--rounds", "1", "--device", "cpu"])
    lines = _lines(capsys)
    assert re.match(r"\[serve\] round 0: 8 tokens in ", lines[0]), lines
    assert lines[-1].startswith("[serve] arch=qwen2-7b-smoke device=cpu ")
    assert serve_batch.DEFAULTS == ("--arch", "qwen2-7b", "--batch", "8",
                                    "--max-new", "12", "--rounds", "2")
    _fixed_text_in_jax_example("serve_batch", [
        '["--arch", "qwen2-7b", "--batch", "8",',
        '"--max-new", "12", "--rounds", "2"]'])


@pytest.mark.parametrize("name,flags", [
    ("quickstart", ["--device"]),
    ("hetero_train", ["--method", "--steps", "--delay-median", "--dist",
                      "--device"])])
def test_the_modules_run_with_the_jax_examples_flags(name, flags):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-m", f"repro_torch.examples.{name}",
                          "--help"], cwd=ROOT, env=env, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    found = set(re.findall(r"--[a-z-]+", out.stdout)) - {"--help"}
    assert found == set(flags)
    assert "{cuda,cpu}" in out.stdout
