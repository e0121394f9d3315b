"""chip_smoke.py: its phases 3-5 at a tiny size on the CPU, its refusal
to run without a GPU, and (marked ``gpu``) the whole script on a card."""

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

import chip_smoke as cs

ROOT = Path(__file__).resolve().parents[1]
TINY_COUNTS = {"n_col": 300, "n_band": 60, "n_adaptive": 100, "n_bd": 20}
TINY_CUTS = {"adam_epochs": 120, "lbfgs_epochs": 45, "density_every": 50,
             "tail_max": 20}
TINY = dict(TINY_COUNTS, grid=31, testing_size=(24, 24), lbfgs_grid=20)


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    out = tmp_path_factory.mktemp("chip_smoke")
    return out, cs.train_phase(out, cuts=TINY_CUTS, **TINY)


def test_reference_check_tiny():
    """Phase 3: the f32 loss/gradient against refmode's float64 loss."""
    out = cs.reference_check(counts=TINY_COUNTS, depth=2, width=8, grid=21)
    for tier, (loss_tol, grad_tol) in cs.TOLERANCES.items():
        assert out[tier]["loss_rel_err"] <= loss_tol
        assert out[tier]["grad_err"] <= grad_tol


def test_train_phase_tiny(trained):
    """Phase 4: the annulus recipe (epochs and sizes cut) trains, writes
    its artifacts and checkpoint, and times each phase."""
    out, res = trained
    assert np.isfinite(res.rel_l2)
    phases = {r["phase"] for r in res.phase_walls}
    assert {"adam", "lbfgs", "lsq_polish", "eval_f64",
            "deflation"} <= phases
    for r in res.phase_walls:
        assert 0.0 <= r["compile_s"] <= r["wall_s"]
    assert (out / "params_stage_1.npz").exists()


def test_serve_phase_tiny(trained):
    """Phase 5: the checkpoint served over HTTP matches the predictor and
    keeps the hard BCs."""
    out, res = trained
    checks = cs.serve_phase(out / "params_stage_1.npz", res.predict,
                            big=1024)
    assert checks["predict_big"]["n"] == 1024
    assert checks["predict_big"]["max_err"] <= cs.PREDICT_TOL
    assert checks["bc_err"] <= cs.HARD_BC_TOL


def test_main_exits_nonzero_on_cpu(capsys):
    with pytest.raises(SystemExit) as exc:
        cs.main([])
    assert exc.value.code not in (0, None)
    assert "not 'gpu'" in str(exc.value.code)
    assert '"ok": true' not in capsys.readouterr().out


def test_lone_script_fails(tmp_path):
    """Copied into a directory that holds nothing else of the repo, the
    script fails and prints no result."""
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["JAX_PLATFORMS"] = "cpu"
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                          env=env, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout


@pytest.mark.gpu
def test_chip_smoke_on_gpu():
    """The whole script on the card, in a child process (this test process
    is pinned to the CPU)."""
    env = {k: v for k, v in os.environ.items()
           if k not in ("JAX_PLATFORMS", "XLA_FLAGS")}
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=ROOT,
                          env=env, capture_output=True, text=True,
                          timeout=1500)
    assert proc.returncode == 0, proc.stderr[-3000:]
    last = json.loads(proc.stdout.strip().splitlines()[-1])
    assert last["ok"] is True and last["device"]["platform"] == "gpu"
