"""Import guard: the port and chip_smoke.py never reach jax or ``repro``.

Importing every module of ``repro_torch`` (and ``chip_smoke``) in a fresh
interpreter must leave ``jax`` and every ``repro.*`` module out of
``sys.modules``; a source scan backs that up and also finds no library
attention call (``scaled_dot_product_attention``) in the port: chip_smoke
may time one as a yardstick, the port never calls one.
"""
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
PKG = ROOT / "src" / "repro_torch"


def _modules():
    out = []
    for path in sorted(PKG.rglob("*.py")):
        rel = path.relative_to(ROOT / "src").with_suffix("")
        parts = list(rel.parts)
        if parts[-1] == "__init__":
            parts = parts[:-1]
        out.append(".".join(parts))
    return out


def test_modules_import_without_jax_or_repro():
    mods = _modules()
    assert "repro_torch.kernels.paged_attention" in mods
    assert {"repro_torch.parallel.step", "repro_torch.parallel.collectives",
            "repro_torch.models.moe_ep", "repro_torch.runtime_context",
            "repro_torch.launch.sharding", "repro_torch.examples.quickstart",
            "repro_torch.examples.hetero_train",
            "repro_torch.examples.serve_batch"} <= set(mods)
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}: importlib.import_module(m)\n"
        "import chip_smoke\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'repro' or m.startswith('repro.')]\n"
        "assert not bad, bad\n"
        "print('ok', len(sys.modules))\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src") + os.pathsep
               + str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("ok")


def test_source_scan():
    bad_import = re.compile(
        r"^\s*(import\s+jax\b|from\s+jax\b|import\s+repro(\.|\s|$)|"
        r"from\s+repro(\.|\s))", re.M)
    sources = sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    for path in sources:
        text = path.read_text()
        assert not bad_import.search(text), path
        if path.name != "chip_smoke.py":
            assert "scaled_dot_product_attention" not in text, path
    smoke = (ROOT / "chip_smoke.py").read_text()
    # the yardstick appears only inside the library-timing helper
    assert smoke.count("scaled_dot_product_attention") == 1


def test_no_fallback_from_cuda_to_twin():
    """The wrappers take the twin only for CPU tensors: no try/except
    around a launch anywhere in the kernels package."""
    for path in (PKG / "kernels").rglob("*.py"):
        assert not re.search(r"^\s*try\s*:", path.read_text(), re.M), path


def test_serve_cli_runs_the_moe_family_on_cpu():
    """The serve launcher takes the new ``--arch`` names; ``--smoke``
    serves the reduced Llama-4 Scout (top-1 over 4 experts and a shared
    expert) through the continuous engine on the CPU."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--device", "cpu",
         "--smoke", "--arch", "llama4-scout-17b-a16e", "--batch", "3",
         "--slots", "2", "--prompt-len", "12", "--max-new", "4",
         "--page-size", "4", "--prefill-chunk", "8", "--rounds", "1"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "arch=llama4-scout-17b-a16e-smoke device=cpu" in out.stdout
    assert "engine=continuous" in out.stdout
    assert "total 12 tokens" in out.stdout, out.stdout


@pytest.mark.parametrize("arch", ["whisper-small", "llama-3.2-vision-11b"])
def test_serve_cli_runs_the_memory_families_on_cpu(arch):
    """``--smoke`` serves the reduced VLM (a stub memory of 0.02 N(0, 1)
    patch embeddings) and Whisper (``encode`` over N(0, 1) frames) on the
    CPU: the continuous engine warns and the static engine serves, its
    cross-attention through K5's twin under ``--attn-impl pallas``;
    ``--listen`` refuses a memory model."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    base = [sys.executable, "-m", "repro_torch.launch.serve", "--device",
            "cpu", "--smoke", "--arch", arch, "--batch", "3",
            "--prompt-len", "10", "--max-new", "4"]
    out = subprocess.run(base + ["--rounds", "2", "--attn-impl", "pallas"],
                         cwd=ROOT, env=env, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr
    assert f"arch={arch}-smoke device=cpu" in out.stdout
    assert "engine=static attn=pallas" in out.stdout
    assert "total 24 tokens" in out.stdout, out.stdout
    assert "serving static" in out.stderr
    out = subprocess.run(base + ["--listen", "--port", "0"], cwd=ROOT,
                         env=env, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode != 0
    assert "--listen serves decoder-only" in out.stderr
