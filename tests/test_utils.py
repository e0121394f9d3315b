"""Utils: log buffers, Tee capture, atomic artifact writes, profiling, CLI."""

import io
import subprocess
import sys
import threading
from pathlib import Path

import numpy as np
import pytest

from tpinn.utils import artifacts
from tpinn.utils.logging import (
    BufferHandler, LogBuffer, SessionLogs, Tee, format_step_line,
)


def test_log_buffer_ring_and_threads():
    buf = LogBuffer(maxlen=5)
    threads = [
        threading.Thread(target=lambda i=i: [buf.append(f"{i}-{j}")
                                             for j in range(20)])
        for i in range(4)
    ]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert len(buf) == 5  # bounded
    assert buf.text().count("\n") == 4


def test_session_logs_isolated():
    logs = SessionLogs()
    logs.get("a").append("alpha")
    logs.get("b").append("beta")
    assert logs.get("a").lines() == ["alpha"]
    assert logs.get("b").lines() == ["beta"]
    logs.drop("a")
    assert logs.get("a").lines() == []


def test_format_step_line_matches_reference_shape():
    line = format_step_line(100, np.array([1.5e-3, 1e-3, 5e-4]))
    assert line.startswith("Step: 100 | Loss: 1.5000e-03 |")
    assert "Loss_d: 1.0000e-03" in line and "Loss_e: 5.0000e-04" in line


def test_tee_mirrors_lines():
    buf = LogBuffer()
    stream = io.StringIO()
    tee = Tee(stream, buf)
    tee.write("hello\nwor")
    tee.write("ld\n")
    assert stream.getvalue() == "hello\nworld\n"
    assert buf.lines() == ["hello", "world"]


def test_buffer_handler():
    import logging

    buf = LogBuffer()
    logger = logging.Logger("t")
    logger.addHandler(BufferHandler(buf))
    logger.info("message %d", 7)
    assert "message 7" in buf.text()


def test_atomic_savez_no_partial_file(tmp_path):
    target = tmp_path / "x.npz"
    artifacts.atomic_savez(target, a=np.arange(5))
    assert np.load(target)["a"].tolist() == [0, 1, 2, 3, 4]
    # no stray temp files
    assert [p.name for p in tmp_path.iterdir()] == ["x.npz"]


def test_step_timer():
    import jax.numpy as jnp

    from tpinn.utils.profiling import StepTimer, timed

    timer = StepTimer()
    for _ in range(3):
        with timer.step() as t:
            t.observe(jnp.ones(8) * 2)
    assert len(timer.times) == 3
    assert "steps=3" in timer.summary()

    out, secs = timed(lambda x: x + 1, jnp.zeros(4), iters=3)
    assert secs >= 0


def test_cli_problems_lists_presets():
    out = subprocess.run(
        [sys.executable, "-m", "tpinn", "problems"],
        capture_output=True, text=True, timeout=240,
        cwd=str(Path(__file__).resolve().parent.parent),
    )
    assert out.returncode == 0, out.stderr[-500:]
    for name in ["annulus_laplace", "poisson_1d", "burgers_1d",
                 "poisson_2d", "heat_2d", "helmholtz_2d"]:
        assert name in out.stdout


@pytest.mark.parametrize("env_dir", [None, "custom_cache"])
def test_compile_cache_dir(monkeypatch, tmp_path, env_dir):
    """The cache lives where JAX_COMPILATION_CACHE_DIR says, else at the
    fixed <checkout>/.jax_cache."""
    import jax

    from tpinn.utils import compile_cache

    if env_dir is None:
        monkeypatch.delenv(compile_cache.ENV_VAR, raising=False)
        want = Path(__file__).resolve().parents[1] / ".jax_cache"
    else:
        want = tmp_path / env_dir
        monkeypatch.setenv(compile_cache.ENV_VAR, str(want))
    before = jax.config.jax_compilation_cache_dir
    try:
        assert compile_cache.enable_compile_cache() == want
        assert jax.config.jax_compilation_cache_dir == str(want)
    finally:
        jax.config.update("jax_compilation_cache_dir", before)


def test_phase_timer_splits_compile_from_run():
    import jax
    import jax.numpy as jnp

    from tpinn.utils.profiling import PhaseTimer

    timer = PhaseTimer()
    f = jax.jit(lambda x: jnp.sin(x) * 3.0 + x.sum())
    for _ in range(2):
        with timer.phase(1, "step"):
            jax.block_until_ready(f(jnp.ones((64,))))
    (row,) = timer.rows()
    assert row["stage"] == 1 and row["phase"] == "step"
    assert 0.0 < row["compile_s"] <= row["wall_s"]
