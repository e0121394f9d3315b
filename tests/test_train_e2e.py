"""End-to-end training: small problems to convergence-ish + artifact contract."""

import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from tpinn.core import train
from tpinn.core.train import StageSpec, TrainSpec
from tpinn import problems
from tpinn.utils import artifacts


def _quick_spec(adam=400, lbfgs=150, stages=1, depth=2, width=24, **kw):
    st1 = StageSpec(depth=depth, width=width, scl=1.0, epsil=1.0,
                    adam_epochs=adam, lbfgs_epochs=lbfgs)
    sts = [st1]
    if stages == 2:
        sts.append(StageSpec(depth=2, width=24, act_first="sin",
                             adam_epochs=adam, lbfgs_epochs=lbfgs,
                             sample_scale=2.0))
    return TrainSpec(
        n_col=256, n_band=64, n_adaptive=64, n_bd=32,
        testing_size=(64, 64), lw=(1.0, 0.0), grid=41,
        stages=tuple(sts), density_every=100, plateau_every=200,
        tail_max=50, **kw,
    )


def test_poisson_1d_trains_to_low_error(tmp_path):
    problem = problems.poisson_1d()
    spec = dataclasses.replace(_quick_spec(adam=500, lbfgs=300),
                               testing_size=(128,))
    res = train.run_training(problem, spec, output_dir=str(tmp_path))
    assert res.rel_l2 is not None
    # modest budget → modest gate; full budget drives this to ~1e-4
    assert res.rel_l2 < 5e-2, f"rel_l2={res.rel_l2}"
    # loss decreased by orders of magnitude
    hist = res.history
    assert hist[-1, 0] < hist[0, 0] * 1e-2


@pytest.mark.slow
def test_annulus_two_stage_artifact_contract(tmp_path):
    problem = problems.annulus_laplace()
    spec = _quick_spec(adam=150, lbfgs=60, stages=2)
    res = train.run_training(problem, spec, output_dir=str(tmp_path))

    # full 11-file artifact contract (SURVEY §2b.13)
    for name in artifacts.ARTIFACT_NAMES:
        assert (tmp_path / name).exists(), f"missing artifact {name}"

    d = np.load(tmp_path / "solution_residual_1.npz")
    assert set(d.keys()) == {"r", "t_vec", "U", "F"}
    assert d["U"].shape == (64, 64)
    d2 = np.load(tmp_path / "solution_residual_2.npz")
    assert set(d2.keys()) == {"r", "t", "U", "F"}

    e = np.load(tmp_path / "error_1.npz")
    assert set(e.keys()) == {"r", "t", "Error"}
    assert e["Error"].shape == (64, 64)

    l1 = np.load(tmp_path / "loss_1.npz")["loss"]
    l2 = np.load(tmp_path / "loss_2.npz")["loss"]
    # loss_info layout: [loss, loss_data, loss_eqn, data_err x2, eqn_err]
    assert l1.shape[1] == 3 + 2 + 1
    # stage-2 file contains the concatenated history (software.py:1012)
    assert l2.shape[0] > l1.shape[0]

    b = np.load(tmp_path / "boundary_loss_1.npz")
    assert set(b.keys()) == {"loss_xy_l", "loss_xy_r"}

    s = np.load(tmp_path / "frequency_spectrum.npz")
    assert set(s.keys()) == {"freq_x", "freq_t", "log_mag"}
    assert s["log_mag"].shape == (64, 64)

    c = np.load(tmp_path / "collocation_point_1.npz")
    assert set(c.keys()) == {"U", "X_col", "limit"}
    # collocation count: n_col + n_band + n_adaptive + 2 groups * n_bd
    assert c["X_col"].shape == (256 + 64 + 64 + 2 * 32, 2)

    # checkpoints saved per stage
    assert (tmp_path / "params_stage_1.npz").exists()
    assert (tmp_path / "params_stage_2.npz").exists()

    # stage 2 must not be worse than stage 1 on the oracle
    assert res.rel_l2 is not None and np.isfinite(res.rel_l2)


def test_checkpoint_roundtrip(tmp_path):
    from tpinn.utils import checkpoint
    import jax

    tree = {"a": jnp.arange(6, dtype=jnp.float32).reshape(2, 3),
            "b": [jnp.ones(3), {"c": jnp.zeros((2, 2))}]}
    checkpoint.save_pytree(tmp_path / "ck.npz", tree, meta={"stage": 1})
    loaded, meta = checkpoint.load_pytree(tmp_path / "ck.npz", tree)
    assert meta == {"stage": 1}
    for a, b in zip(jax.tree_util.tree_leaves(tree),
                    jax.tree_util.tree_leaves(loaded)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


@pytest.mark.slow
def test_reference_schema_entry(tmp_path):
    """run_pinn_training drop-in accepts the reference kwarg schema
    (software.py:626-638, __main__ config :1143-1188) and actually uses the
    equation string."""
    res = train.run_pinn_training(
        equation="u_rr + 1/r*u_r + 1/r**2*u_tt",
        boundary={
            "bd_x1_min": 0.1, "bd_x1_max": 0.1, "bd_y1_min": 0,
            "bd_y1_max": 1, "bd_u1": 1,
            "bd_x2_min": 1, "bd_x2_max": 1, "bd_y2_min": 0,
            "bd_y2_max": 1, "bd_u2": 0,
        },
        domain={"x_min": 0.1, "x_max": 1, "y_min": 0, "y_max": 1},
        scl=1, epsil=1,
        sample_points={"n_col": 200, "n_bd": 50, "n_add": 50},
        network_size={"depth": 24, "width": 2},  # UI semantics (swapped)
        testing_size={"x": 41, "y": 41},
        epochs={"adam": 60, "lbfgs": 30},
        equation_weight={"f": 0.05, "df": 0},
        output_dir=str(tmp_path),
    )
    assert (tmp_path / "loss_2.npz").exists()
    assert res.rel_l2 is not None


@pytest.mark.slow
def test_resume_skips_trained_stages(tmp_path):
    """A finished stage's checkpoint is reloaded; its training is skipped
    and the final predictor is identical."""
    problem = problems.poisson_1d()
    spec = dataclasses.replace(_quick_spec(adam=120, lbfgs=45),
                               testing_size=(64,))
    res1 = train.run_training(problem, spec, output_dir=str(tmp_path))
    import time
    t0 = time.perf_counter()
    res2 = train.run_training(problem, spec, output_dir=str(tmp_path),
                              resume=True)
    resumed_secs = time.perf_counter() - t0
    # same params -> same prediction
    z = jnp.linspace(0.1, 0.9, 17)[:, None]
    np.testing.assert_allclose(np.asarray(res1.predict(z)),
                               np.asarray(res2.predict(z)), rtol=1e-6)
    # resumed run trains nothing
    assert res2.history.shape[0] == 0
    assert res2.rel_l2 == pytest.approx(res1.rel_l2, rel=1e-5)


def test_midstage_resume_bit_exact(tmp_path, monkeypatch):
    """A run killed mid-Adam resumes from adam_state_stage_N.npz at the
    last saved chunk and finishes with BIT-IDENTICAL parameters to an
    uninterrupted run (same chunk grid, same carry)."""
    from tpinn.utils import checkpoint as ckpt_mod

    problem = problems.poisson_1d()

    def make_spec():
        st = StageSpec(depth=2, width=16, scl=1.0, epsil=1.0,
                       adam_epochs=200, lbfgs_epochs=30)
        return TrainSpec(
            n_col=128, n_band=32, n_adaptive=32, n_bd=16,
            testing_size=(64,), lw=(1.0, 0.0), grid=41,
            stages=(st,), density_every=100, plateau_every=100,
            tail_max=0, log_every=5, checkpoint_every=50,
        )

    # log_fn makes the chunk grid log_every*10 = 50 (see make_adam_phase)
    noop_log = lambda msg: None

    # --- run A: uninterrupted
    dir_a = tmp_path / "a"
    res_a = train.run_training(problem, make_spec(), output_dir=str(dir_a),
                               log_fn=noop_log)

    # --- run B: killed right after the step-100 checkpoint is written
    dir_b = tmp_path / "b"
    orig_save = ckpt_mod.save_phase_state

    class Killed(Exception):
        pass

    def killer(path, done, state, hist):
        orig_save(path, done, state, hist)
        if done >= 100:
            raise Killed(f"simulated kill at step {done}")

    monkeypatch.setattr(ckpt_mod, "save_phase_state", killer)
    with pytest.raises(Killed):
        train.run_training(problem, make_spec(), output_dir=str(dir_b),
                           log_fn=noop_log)
    monkeypatch.setattr(ckpt_mod, "save_phase_state", orig_save)
    assert (dir_b / "adam_state_stage_1.npz").exists()

    # --- resume B and compare
    res_b = train.run_training(problem, make_spec(), output_dir=str(dir_b),
                               log_fn=noop_log, resume=True)
    # the checkpointed prefix is stitched back: full history, identical rows
    np.testing.assert_array_equal(
        np.asarray(res_b.stages[0].history),
        np.asarray(res_a.stages[0].history),
    )
    for pa, pb in zip(jax.tree_util.tree_leaves(res_a.stages[0].params),
                      jax.tree_util.tree_leaves(res_b.stages[0].params)):
        np.testing.assert_array_equal(np.asarray(pa), np.asarray(pb))
    assert res_b.rel_l2 == res_a.rel_l2
    # the finished stage removed the mid-stage state file
    assert not (dir_b / "adam_state_stage_1.npz").exists()


def test_warm_start_curriculum(tmp_path):
    """StageSpec.init_from='prev' + per-stage equation override: a 2-stage
    continuation run on ONE network (no frozen composition), stage 1 on an
    easier equation.  Checks: single-net params (no 'prev' subtree), the
    warm stage starts from stage 1's solution (initial loss far below a
    cold start), and scl/epsil carry over."""
    problem = problems.poisson_1d()
    st1 = StageSpec(depth=2, width=24, scl=1.0, epsil=1.0,
                    adam_epochs=200, lbfgs_epochs=60,
                    equation="u_xx - u")          # easier (shifted) operator
    st2 = StageSpec(depth=2, width=24, init_from="prev",
                    adam_epochs=200, lbfgs_epochs=60)
    spec = dataclasses.replace(
        _quick_spec(adam=200, lbfgs=60), testing_size=(64,),
        stages=(st1, st2),
    )
    res = train.run_training(problem, spec, output_dir=str(tmp_path))
    assert len(res.stages) == 2
    # continuation keeps a single-net parameter tree
    assert "prev" not in res.stages[1].params
    assert res.stages[1].scl == res.stages[0].scl
    assert res.stages[1].epsil == res.stages[0].epsil
    # stage 2's un-normalized initial loss (ref) must reflect the warm
    # start: its first logged row is normalized to 1, but the training
    # still converges to a reasonable error overall
    assert res.rel_l2 is not None and res.rel_l2 < 5e-2


def test_warm_start_rejects_mismatched_architecture():
    problem = problems.poisson_1d()
    st1 = StageSpec(depth=2, width=24, scl=1.0, epsil=1.0,
                    adam_epochs=10, lbfgs_epochs=10)
    st2 = StageSpec(depth=2, width=32, init_from="prev",
                    adam_epochs=10, lbfgs_epochs=10)
    spec = dataclasses.replace(
        _quick_spec(adam=10, lbfgs=10), testing_size=(32,),
        stages=(st1, st2),
    )
    with pytest.raises(ValueError, match="init_from"):
        train.run_training(problem, spec)


def test_adam_precision_and_engine_phase_split(tmp_path):
    """TrainSpec.adam_precision + adam_engine: the Adam phase runs on a
    reduced-precision predictor chain (incl. the composed stage 2) under
    the fused Taylor-2 engine, while L-BFGS/eval stay at full precision
    on the default engine — same params pytree, training converges
    normally.  On the CPU backend precision flags are near-no-ops
    numerically; this exercises the dual-chain/dual-engine plumbing."""
    problem = problems.annulus_laplace()
    spec = dataclasses.replace(
        _quick_spec(adam=80, lbfgs=30, stages=2),
        n_col=128, n_band=32, n_adaptive=32, n_bd=16,
        testing_size=(24, 24), adam_precision="default",
        adam_engine="fused",
        density_every=1000, plateau_every=1000, tail_max=10,
    )
    lines = []
    res = train.run_training(problem, spec, output_dir=str(tmp_path),
                             log_fn=lines.append)
    assert res.rel_l2 is not None and np.isfinite(res.rel_l2)
    assert len(res.stages) == 2
    assert {r["phase"] for r in res.phase_walls} >= {"adam", "lbfgs",
                                                     "eval_f64"}


def test_per_stage_lw_override():
    """StageSpec.lw overrides the diff-derived stage weights; the log line
    records it and training completes."""
    problem = problems.poisson_1d()
    st1 = StageSpec(depth=2, width=24, scl=1.0, epsil=1.0,
                    adam_epochs=120, lbfgs_epochs=40)
    st2 = StageSpec(depth=2, width=24, act_first="sin",
                    adam_epochs=120, lbfgs_epochs=40, lw=(0.3, 0.0))
    spec = dataclasses.replace(
        _quick_spec(adam=120, lbfgs=40), testing_size=(32,),
        stages=(st1, st2),
    )
    lines = []
    res = train.run_training(problem, spec, log_fn=lines.append)
    assert res.rel_l2 is not None and np.isfinite(res.rel_l2)
    assert any("lw override (0.3, 0.0)" in l for l in lines)


def test_auto_scl_nyquist_cap():
    """The derived stage-2 scl is clamped by TrainSpec.auto_scl_cap; an
    explicit StageSpec.scl is never touched (software.py:943-946 derives
    uncapped — the cap is a documented, measured deviation)."""
    problem = problems.poisson_1d()
    st1 = StageSpec(depth=2, width=24, scl=1.0, epsil=1.0,
                    adam_epochs=120, lbfgs_epochs=40)
    st2 = StageSpec(depth=2, width=24, act_first="sin",
                    adam_epochs=120, lbfgs_epochs=40)
    spec = dataclasses.replace(
        _quick_spec(adam=120, lbfgs=40), testing_size=(32,),
        stages=(st1, st2), auto_scl_cap=1e-6,
    )
    lines = []
    res = train.run_training(problem, spec, log_fn=lines.append)
    assert res.stages[1].scl == pytest.approx(1e-6)
    assert any("Nyquist guard" in l for l in lines)

    # explicit scl bypasses the cap entirely
    st2x = dataclasses.replace(st2, scl=50.0)
    lines2 = []
    res2 = train.run_training(
        problem, dataclasses.replace(spec, stages=(st1, st2x)),
        log_fn=lines2.append)
    assert res2.stages[1].scl == pytest.approx(50.0)
    assert not any("Nyquist guard" in l for l in lines2)


def test_midstage_resume_across_adam_layout(tmp_path, monkeypatch):
    """A mid-Adam checkpoint written under layout="tree" resumes under a
    layout="flat" spec: run_training detects the carry-structure mismatch
    and finishes THAT stage under the checkpoint's own layout instead of
    restarting — bit-identical to an uninterrupted tree-layout run."""
    from tpinn.utils import checkpoint as ckpt_mod

    problem = problems.poisson_1d()

    def make_spec(layout):
        st = StageSpec(depth=2, width=16, scl=1.0, epsil=1.0,
                       adam_epochs=200, lbfgs_epochs=30)
        return TrainSpec(
            n_col=128, n_band=32, n_adaptive=32, n_bd=16,
            testing_size=(64,), lw=(1.0, 0.0), grid=41,
            stages=(st,), density_every=100, plateau_every=100,
            tail_max=0, log_every=5, checkpoint_every=50,
            adam_layout=layout,
        )

    noop_log = lambda msg: None

    # --- run A: uninterrupted, tree layout
    dir_a = tmp_path / "a"
    res_a = train.run_training(problem, make_spec("tree"),
                               output_dir=str(dir_a), log_fn=noop_log)

    # --- run B: tree layout, killed after the step-100 checkpoint
    dir_b = tmp_path / "b"
    orig_save = ckpt_mod.save_phase_state

    class Killed(Exception):
        pass

    def killer(path, done, state, hist):
        orig_save(path, done, state, hist)
        if done >= 100:
            raise Killed(f"simulated kill at step {done}")

    monkeypatch.setattr(ckpt_mod, "save_phase_state", killer)
    with pytest.raises(Killed):
        train.run_training(problem, make_spec("tree"),
                           output_dir=str(dir_b), log_fn=noop_log)
    monkeypatch.setattr(ckpt_mod, "save_phase_state", orig_save)
    assert (dir_b / "adam_state_stage_1.npz").exists()

    # --- resume B under the flat default
    lines = []
    res_b = train.run_training(problem, make_spec("flat"),
                               output_dir=str(dir_b),
                               log_fn=lines.append, resume=True)
    assert any("resuming this stage under layout='tree'" in ln
               for ln in lines), "\n".join(lines[:20])
    np.testing.assert_array_equal(
        np.asarray(res_b.stages[0].history),
        np.asarray(res_a.stages[0].history),
    )
    for pa, pb in zip(jax.tree_util.tree_leaves(res_a.stages[0].params),
                      jax.tree_util.tree_leaves(res_b.stages[0].params)):
        np.testing.assert_array_equal(np.asarray(pa), np.asarray(pb))
    assert res_b.rel_l2 == res_a.rel_l2


def test_causal_weighting_trains_and_validates():
    """TrainSpec.causal_eps: evolution run logs the slab setup and
    converges; enabling it on a problem without the named evolution
    coordinate is a config error, not a silent no-op."""
    problem = problems.heat_2d()
    spec = dataclasses.replace(
        _quick_spec(adam=300, lbfgs=100), testing_size=(32, 32),
        causal_eps=1.0, causal_bins=8, pad_features=3,
    )
    lines = []
    res = train.run_training(problem, spec, log_fn=lines.append)
    assert res.rel_l2 is not None and np.isfinite(res.rel_l2)
    assert any("causal weighting on 't' (8 slabs" in l for l in lines), lines

    with pytest.raises(ValueError, match="causal_eps"):
        train.run_training(
            problems.poisson_1d(),
            dataclasses.replace(_quick_spec(adam=10, lbfgs=0),
                                testing_size=(16,), causal_eps=1.0))
