"""The train launcher on a 2-rank learner mesh: ``torchrun
--nproc-per-node 2 -m repro_torch.launch.train --device cpu --smoke
--mesh 2x1`` (gloo, one torch thread a rank, a free port from
``--standalone``, 300 s timeout) trains and writes its summary, and its
numbers equal the one-process 1x1 run's within 1e-4 relative: the SFT
warm start and the RL steps ran sharded, on the global batch."""
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
KEYS = ("reward_mean_last20", "iw_var_mean", "kl_mean", "steps")


def _run(cmd, out):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    proc = subprocess.run(cmd + ["--device", "cpu", "--smoke", "--mode",
                                 "hetero", "--out", str(out)],
                          capture_output=True, text=True, env=env,
                          timeout=300, cwd=ROOT)
    assert proc.returncode == 0, proc.stderr[-3000:] + proc.stdout[-2000:]
    return proc.stdout, json.loads(out.read_text())


def test_torchrun_two_rank_learner_matches_one_process(tmp_path):
    torchrun = [sys.executable, "-m", "torch.distributed.run", "--standalone",
                "--nproc-per-node", "2"]
    log, two = _run(torchrun + ["-m", "repro_torch.launch.train", "--mesh",
                                "2x1"], tmp_path / "two.json")
    assert "mode=train, mesh=2dx1m, devices=2" in log
    _, one = _run([sys.executable, "-m", "repro_torch.launch.train"],
                  tmp_path / "one.json")
    assert two["steps"] == one["steps"] == 2
    for k in KEYS:
        np.testing.assert_allclose(two[k], one[k], rtol=1e-4, err_msg=k)
