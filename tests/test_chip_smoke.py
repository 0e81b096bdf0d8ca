"""chip_smoke.py: each phase at a tiny size on the CPU with the same
reference checks, its refusal to run without a GPU, and the nvidia-smi
line parser.  The full-size run needs a card (``gpu`` marker)."""

import json
import os
import shutil
import subprocess
import sys

import jax
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402


def _env(**kw):
    env = dict(os.environ, **kw)
    env.pop("XLA_FLAGS", None)
    return env


@pytest.mark.parametrize("phase,kw", [
    ("gridcal", {"n_bus": 300, "n_spmv": 2000}),
    ("spgemm", {"n_rand": 400, "density": 1e-2, "n_bus": 200}),
    ("lu10k", {"n": 300, "rhs": 4}),
    ("solve100k", {"n": 1500, "rhs": 8}),
    ("newton10k", {"n": 200}),
])
def test_phase_tiny(phase, kw):
    results = getattr(chip_smoke, f"phase_{phase}")(**kw)
    assert results and all(r["err"] <= r["tol"] for r in results)


def test_phase_config5_tiny():
    """Config 5 on four of the virtual CPU devices: every factor shard on
    its own device, each residual within tolerance."""
    results = chip_smoke.phase_config5(jax.devices()[:4], n_lu=3000,
                                       n_ring=3000)
    assert [r["phase"] for r in results] == [
        "config5-lu", "config5-spmv", "config5-cg"]


def test_report_raises_above_tolerance():
    import time

    with pytest.raises(chip_smoke.PhaseError):
        chip_smoke._report("x", "tiny", time.perf_counter(), 2e-4, 1e-4)
    with pytest.raises(chip_smoke.PhaseError):
        chip_smoke._report("x", "tiny", time.perf_counter(), float("nan"),
                           1e-4)


@pytest.mark.parametrize("text,expect", [
    ("NVIDIA H100 80GB HBM3, 700.00 W\n",
     [("NVIDIA H100 80GB HBM3", 700.0)]),
    ("NVIDIA H100 80GB HBM3, 500.00 W\nNVIDIA H100 80GB HBM3, 700.00 W\n",
     [("NVIDIA H100 80GB HBM3", 500.0), ("NVIDIA H100 80GB HBM3", 700.0)]),
])
def test_parse_nvidia_smi(text, expect):
    assert chip_smoke.parse_nvidia_smi(text) == expect


def test_parse_nvidia_smi_empty_raises():
    with pytest.raises(ValueError):
        chip_smoke.parse_nvidia_smi("\n")


def test_no_gpu_exits_nonzero_without_ok_line():
    r = subprocess.run([sys.executable, os.path.join(ROOT, "chip_smoke.py")],
                       capture_output=True, text=True, timeout=300,
                       env=_env(JAX_PLATFORMS="cpu"), cwd=ROOT)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout
    assert "no GPU" in r.stderr


def test_alone_exits_nonzero(tmp_path):
    """Copied out of the repository, the script cannot run the library."""
    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), tmp_path)
    r = subprocess.run([sys.executable, "chip_smoke.py"],
                       capture_output=True, text=True, timeout=300,
                       env=_env(JAX_PLATFORMS="cpu", PYTHONPATH=""),
                       cwd=tmp_path)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout
    assert "No module named 'csparse3_jax'" in r.stderr


@pytest.mark.gpu
def test_chip_smoke_on_gpu(gpu):
    """The full one-card run; its last line is the ok record."""
    r = subprocess.run([sys.executable, "chip_smoke.py"],
                       capture_output=True, text=True, timeout=1200,
                       env=_env(), cwd=ROOT)
    assert r.returncode == 0, r.stderr[-2000:]
    last = json.loads(r.stdout.strip().splitlines()[-1])
    assert last["ok"] is True and last["device"]["platform"] == "gpu"
