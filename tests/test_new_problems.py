"""Round-4 benchmark families: Allen–Cahn (stiff reaction–diffusion),
nonlinear Schrödinger (complex → 2-field system), wave (second order in
time + operator velocity IC), KdV (third-order dispersion) — and the
numerical oracles behind the two that have no closed form.

Reference anchor: the reference ships exactly one problem and one oracle
(software.py:283-297, 815); these presets are the standard benchmark set
of the PINN literature (Raissi et al. 2019 configs), each gate-checkable
because the oracle is validated here in-suite."""

import numpy as np
import pytest

import jax.numpy as jnp

from tpinn import problems
from tpinn.core import net, pde
from tpinn.core.march import axis_derivative, window_problem
from tpinn.problems import oracles
from tpinn.problems.systems import get_system


# ---------------------------------------------------------------------------
# Oracles
# ---------------------------------------------------------------------------


def test_allen_cahn_oracle_self_convergence():
    # dt-halving agreement at t=1 (ETDRK4 is 4th order; committed full-
    # resolution runs agree to 1.7e-11 — the coarse check here keeps the
    # suite fast)
    _, _, U1 = oracles.allen_cahn_solution(n=256, dt=2e-3, frame_every=500)
    _, _, U2 = oracles.allen_cahn_solution(n=256, dt=1e-3, frame_every=1000)
    assert np.abs(U1[-1] - U2[-1]).max() < 1e-8


def test_allen_cahn_oracle_fd_residual():
    # the interpolated field satisfies the PDE in finite differences
    p = problems.get_problem("allen_cahn")
    f = p.exact
    rng = np.random.default_rng(1)
    z = rng.uniform([-0.9, 0.05], [0.9, 0.95], size=(200, 2))
    h = 1e-3
    u = f(z)[:, 0]
    u_t = (f(z + [0, h])[:, 0] - f(z - [0, h])[:, 0]) / (2 * h)
    u_xx = (f(z + [h, 0])[:, 0] - 2 * u + f(z - [h, 0])[:, 0]) / h**2
    res = u_t - 1e-4 * u_xx + 5 * u**3 - 5 * u
    assert np.sqrt((res**2).mean()) < 2e-4          # measured: 2.2e-5

    # IC match.  Interior: tight.  The seam x=±1 at t=0 is special: the
    # benchmark IC x²cos(πx) is C⁰- but not C¹-periodic (slope −2 vs +2
    # across the seam), so the cubic interpolant carries a ~4e-4 kink
    # error exactly there (it decays instantly for t>0 as diffusion
    # smooths the corner) — inherent to the benchmark's own IC, not an
    # oracle defect.
    xi = np.linspace(-0.97, 0.97, 64)
    z0 = np.stack([xi, np.zeros(64)], axis=1)
    assert np.abs(f(z0)[:, 0] - xi**2 * np.cos(np.pi * xi)).max() < 1e-5
    zs = np.array([[-1.0, 0.0], [1.0, 0.0]])
    assert np.abs(f(zs)[:, 0] - (-1.0)).max() < 1e-3


def test_nls_oracle_breather_physics():
    # the Satsuma–Yajima N=2 breather: |h| focuses from 2 to 4 at t=π/4,
    # returns to ~2 at t=π/2; L² mass is conserved
    t, x, H = oracles.nls_solution(n=512, nsteps=2000, frame_every=10)
    amp = np.abs(H).max(axis=1)
    i_peak = np.argmax(amp)
    assert abs(amp[i_peak] - 4.0) < 0.05
    assert abs(t[i_peak] - np.pi / 4) < 0.02
    assert abs(amp[-1] - 2.0) < 0.05
    mass = (np.abs(H)**2).sum(axis=1)
    assert np.abs(mass - mass[0]).max() / mass[0] < 1e-9


def test_nls_equations_exact_on_soliton():
    # the 2-field real reduction is checked EXACTLY on the closed-form
    # 1-soliton h = sech(x)·e^{it/2} through the compiled system
    s = get_system("schrodinger")
    cs = pde.compile_system(s.equations, s.coords, s.fields)

    def exact(z):
        x, t = z[:, 0:1], z[:, 1:2]
        return jnp.concatenate(
            [jnp.cos(0.5 * t) / jnp.cosh(x),
             jnp.sin(0.5 * t) / jnp.cosh(x)], axis=1)

    rng = np.random.default_rng(3)
    z = jnp.asarray(rng.uniform([-4, 0], [4, 1.5],
                                size=(100, 2)).astype(np.float32))
    r = np.asarray(cs.residual(exact, z))
    assert np.abs(r).max() < 1e-5

    # oracle IC matches the preset IC (5e-5: interpolant node error at
    # the periodic-seam endpoints, see the Allen–Cahn IC note)
    z0 = np.stack([np.linspace(-5, 5, 64), np.zeros(64)], axis=1)
    uv = s.exact(z0)
    assert np.abs(uv[:, 0] - 2 / np.cosh(z0[:, 0])).max() < 5e-5
    assert np.abs(uv[:, 1]).max() < 1e-9


def test_grid_interpolant_periodic_seam():
    # wrap-around continuity: query just left of lb and just right of ub
    t = np.linspace(0, 1, 21)
    x = -1.0 + 2.0 * np.arange(32) / 32
    U = np.sin(np.pi * x)[None, :] * np.exp(-t)[:, None]
    f = oracles.grid_interpolant(t, x, U, 2.0)
    zl = np.array([[-1.0 - 1e-6, 0.5]])
    zr = np.array([[1.0 - 1e-6, 0.5]])
    assert abs(f(zl)[0, 0] - f(zr)[0, 0]) < 1e-4


# ---------------------------------------------------------------------------
# Closed-form presets through the compiler
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name,tol", [("wave_1d", 1e-4), ("kdv_1d", 1e-5)])
def test_closed_form_residual(name, tol):
    p = problems.get_problem(name)
    c = pde.compile_pde(p.equation, p.coords)
    rng = np.random.default_rng(0)
    z = jnp.asarray(rng.uniform(p.lb, p.ub, size=(64, 2)).astype(np.float32))
    r = np.asarray(c.residual(p.exact, z))
    assert np.abs(r).max() < tol


def test_kdv_third_order_index():
    p = problems.get_problem("kdv_1d")
    c = pde.compile_pde(p.equation, p.coords)
    assert c.max_order == 3 and (0, 0, 0) in c.indices


def test_wave_hard_bc_ansatz():
    # u = lift + t²·x(1−x)·N pins u(x,0), u_t(x,0)=0 and both edges for
    # ANY network — check with a nonzero surrogate in place of N
    p = problems.with_hard_bc(problems.get_problem("wave_1d"))
    lift, bubble = p.hard_bc
    lf = pde.compile_coord_expr(lift, p.coords)
    bf = pde.compile_coord_expr(bubble, p.coords)

    def u(z):
        return lf(z) + bf(z) * (1.0 + jnp.sin(3 * z[:, 0:1] + z[:, 1:2]))

    x = jnp.linspace(0, 1, 33)[:, None]
    z0 = jnp.concatenate([x, jnp.zeros_like(x)], axis=1)
    ic = np.sin(np.pi * x) + 0.5 * np.sin(4 * np.pi * x)
    assert np.abs(np.asarray(u(z0)) - ic).max() < 1e-6
    ut = axis_derivative(u, 1)
    assert np.abs(np.asarray(ut(z0))).max() < 1e-6
    t = jnp.linspace(0, 1, 17)[:, None]
    for xe in (0.0, 1.0):
        ze = jnp.concatenate([jnp.full_like(t, xe), t], axis=1)
        assert np.abs(np.asarray(u(ze))).max() < 1e-6


# ---------------------------------------------------------------------------
# Domain-fitted periodic features
# ---------------------------------------------------------------------------


def test_periodic_fit_feature_map():
    fm = net.feature_map_for(("periodic_fit", "minmax"))
    lb = jnp.asarray([-1.0, 0.0])
    ub = jnp.asarray([1.0, 1.0])
    z = jnp.asarray([[-0.7, 0.3]])
    z_shift = jnp.asarray([[-0.7 + 2.0, 0.3]])   # one full period
    np.testing.assert_allclose(np.asarray(fm(z, lb, ub)),
                               np.asarray(fm(z_shift, lb, ub)),
                               rtol=0, atol=1e-6)
    # the embedding spans the full circle over one domain width
    ends = fm(jnp.asarray([[-1.0, 0.0], [0.0, 0.0]]), lb, ub)
    np.testing.assert_allclose(np.asarray(ends[0, :2]), [1.0, 0.0],
                               atol=1e-6)          # cos, sin at lb
    np.testing.assert_allclose(np.asarray(ends[1, :2]), [-1.0, 0.0],
                               atol=1e-6)          # half period


# ---------------------------------------------------------------------------
# Second-order-in-time marching: the velocity handoff
# ---------------------------------------------------------------------------


def test_march_velocity_handoff_groups():
    p = problems.get_problem("wave_1d")

    def prev(z):
        return jnp.sin(z[:, 0:1]) * z[:, 1:2] ** 2

    w1 = window_problem(p, 1, 0.5, 1.0, 1, prev, handoff_velocity=True)
    ops = [g for g in w1.bc_groups if g.operator == "u_t"]
    # the slab keeps: 2 edges + u handoff + u_t handoff (the t=0 IC and
    # the t=0 velocity group are dropped)
    assert len(ops) == 1 and len(w1.bc_groups) == 4
    g = ops[0]
    pts = jnp.asarray([[0.3, 0.5], [0.9, 0.5]])
    want = np.sin([0.3, 0.9]) * 2 * 0.5            # d/dt sin(x)·t² at t=½
    np.testing.assert_allclose(np.asarray(g.target(pts))[:, 0], want,
                               rtol=1e-5)


def test_march_axis_order_guard():
    from tpinn.core.march import run_time_marching
    from tpinn.core.train import ProblemSpec, StageSpec, TrainSpec
    from tpinn.core import sample

    bad = ProblemSpec(
        name="third_order_t", equation="u_ttt + u_x",
        coords=("x", "t"), lb=(0.0, 0.0), ub=(1.0, 1.0),
        bc_groups=(sample.BCGroup(lo=(0.0, 0.0), hi=(1.0, 0.0),
                                  value=0.0),))
    spec = TrainSpec(n_col=50, n_band=0, n_adaptive=0, n_bd=10,
                     stages=(StageSpec(depth=2, width=8, adam_epochs=5,
                                       lbfgs_epochs=0),))
    with pytest.raises(ValueError, match="order"):
        run_time_marching(bad, spec, 2)


@pytest.mark.slow
def test_wave_march_e2e():
    # second-order-in-time marching end to end: 2 windows with the
    # (u, u_t) Cauchy handoff produce a composite whose rel-L2 beats a
    # broken u-only handoff's typical collapse (exactness needs real
    # budgets; this asserts the plumbing trains and composes)
    from tpinn.core.march import run_time_marching
    from tpinn.core.train import StageSpec, TrainSpec

    p = problems.get_problem("wave_1d")
    spec = TrainSpec(
        n_col=400, n_band=0, n_adaptive=100, n_bd=80,
        testing_size=(25, 25), grid=21, tail_max=0, pad_features=3,
        stages=(StageSpec(depth=3, width=24, scl=1.0, epsil=1.0,
                          adam_epochs=300, lbfgs_epochs=150),))
    m = run_time_marching(p, spec, 2)
    assert m.rel_l2 is not None and np.isfinite(m.rel_l2)
    assert len(m.windows) == 2
    # velocity handoff: window 2's problem carried an operator group —
    # verified structurally above; here assert the composite evaluates
    z = jnp.asarray([[0.5, 0.25], [0.5, 0.75]])
    assert np.asarray(m.predict(z)).shape == (2, 1)


@pytest.mark.slow
def test_kdv_tiny_training():
    from tpinn.core.train import StageSpec, TrainSpec, run_training

    p = problems.get_problem("kdv_1d")
    spec = TrainSpec(
        n_col=400, n_band=0, n_adaptive=100, n_bd=80,
        testing_size=(25, 25), grid=21, tail_max=0, pad_features=3,
        stages=(StageSpec(depth=3, width=24, scl=1.0, epsil=1.0,
                          adam_epochs=400, lbfgs_epochs=200),))
    r = run_training(p, spec)
    assert r.rel_l2 < 0.2                          # measured 0.049


@pytest.mark.slow
def test_schrodinger_tiny_training():
    from tpinn.core.system import run_system
    from tpinn.core.train import StageSpec, TrainSpec

    s = get_system("schrodinger")
    spec = TrainSpec(
        n_col=400, n_band=0, n_adaptive=100, n_bd=80,
        testing_size=(25, 25), grid=21, tail_max=0, pad_features=3,
        stages=(StageSpec(depth=3, width=24, scl=1.0, epsil=1.0,
                          adam_epochs=400, lbfgs_epochs=200),))
    r = run_system(s, spec)
    assert r.rel_l2 is not None and np.isfinite(r.rel_l2)
    assert len(r.rel_l2_fields) == 2
