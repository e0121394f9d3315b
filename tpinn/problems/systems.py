"""Coupled-system benchmark presets (tpinn.core.system).

The reference application has no system capability at all (one hardcoded
scalar residual, software.py:283-297); these presets exercise the
framework's compile_system path on named CFD benchmarks with analytic
solutions, so system runs are gate-checkable exactly like the scalar
presets (problems.PRESETS).

Kovasznay flow — the classic steady incompressible Navier–Stokes
benchmark (Kovasznay 1948; the standard PINN system test since Raissi et
al.): an exact laminar wake behind a periodic grid,

    λ = Re/2 − sqrt(Re²/4 + 4π²)
    u = 1 − e^{λx} cos(2πy)
    v = (λ/2π) e^{λx} sin(2πy)
    p = (1 − e^{2λx})/2

solving  (u·∇)u + ∇p − ν∆u = 0,  ∇·u = 0  with ν = 1/Re.  Three coupled
equations over three fields on one multi-output net; the convective terms
make it NONLINEAR — the same compiled-AST machinery covers it because the
derivative engine is field-vectorized (system.py design notes).
"""

from __future__ import annotations

import math

import jax.numpy as jnp

from tpinn.core import sample
from tpinn.core.system import SystemSpec


def kovasznay(re: float = 40.0) -> SystemSpec:
    """Steady Navier–Stokes Kovasznay flow at Reynolds number ``re``.

    Domain [−0.5, 1.0] × [−0.5, 1.5] (the standard window).  Dirichlet
    u and v on all four edges from the exact solution; p is pinned on the
    inflow edge x = −0.5 only (the pressure is determined up to a
    constant by the momentum equations — one edge anchors it).
    """
    nu = 1.0 / re
    lam = re / 2.0 - math.sqrt(re * re / 4.0 + 4.0 * math.pi**2)
    two_pi = 2.0 * math.pi

    def u_fn(z):
        return 1.0 - jnp.exp(lam * z[:, 0:1]) * jnp.cos(two_pi * z[:, 1:2])

    def v_fn(z):
        return (lam / two_pi) * jnp.exp(lam * z[:, 0:1]) * jnp.sin(
            two_pi * z[:, 1:2])

    def p_fn(z):
        return 0.5 * (1.0 - jnp.exp(2.0 * lam * z[:, 0:1]))

    def exact(z):
        return jnp.concatenate([u_fn(z), v_fn(z), p_fn(z)], axis=1)

    lb, ub = (-0.5, -0.5), (1.0, 1.5)
    edges = (
        ((lb[0], lb[1]), (lb[0], ub[1])),   # x = -0.5 (inflow)
        ((ub[0], lb[1]), (ub[0], ub[1])),   # x = 1.0
        ((lb[0], lb[1]), (ub[0], lb[1])),   # y = -0.5
        ((lb[0], ub[1]), (ub[0], ub[1])),   # y = 1.5
    )
    groups = []
    for fi, fn in ((0, u_fn), (1, v_fn)):
        for lo, hi in edges:
            groups.append(sample.BCGroup(lo=lo, hi=hi, value_fn=fn, field=fi))
    groups.append(sample.BCGroup(lo=edges[0][0], hi=edges[0][1],
                                 value_fn=p_fn, field=2))

    return SystemSpec(
        name=f"kovasznay_re{re:g}",
        equations=(
            f"u*u_x + v*u_y + p_x - {nu}*(u_xx + u_yy)",
            f"u*v_x + v*v_y + p_y - {nu}*(v_xx + v_yy)",
            "u_x + v_y",
        ),
        fields=("u", "v", "p"),
        coords=("x", "y"),
        lb=lb, ub=ub,
        bc_groups=tuple(groups),
        exact=exact,
    )


def taylor_green(nu: float = 0.1, t_final: float = 1.0) -> SystemSpec:
    """Unsteady incompressible Navier–Stokes: the 2-D decaying
    Taylor–Green vortex,

        u = −cos x · sin y · e^{−2νt}
        v =  sin x · cos y · e^{−2νt}
        p = −(cos 2x + cos 2y)/4 · e^{−4νt}

    an exact pointwise solution of u_t + (u·∇)u + ∇p − ν∆u = 0, ∇·u = 0.
    Posed on [0, π]² × [0, t_final] with Dirichlet u, v from the exact
    trace on the four spatial faces + the initial condition, and p
    anchored on the x = 0 face (time-varying Dirichlet).  Exercises the
    system path in THREE coordinates (x, y, t) — time is just another
    sampled axis; no marching scheme exists anywhere in the stack.
    """
    pi = math.pi

    def u_fn(z):
        return (-jnp.cos(z[:, 0:1]) * jnp.sin(z[:, 1:2])
                * jnp.exp(-2.0 * nu * z[:, 2:3]))

    def v_fn(z):
        return (jnp.sin(z[:, 0:1]) * jnp.cos(z[:, 1:2])
                * jnp.exp(-2.0 * nu * z[:, 2:3]))

    def p_fn(z):
        return (-0.25 * (jnp.cos(2.0 * z[:, 0:1]) + jnp.cos(2.0 * z[:, 1:2]))
                * jnp.exp(-4.0 * nu * z[:, 2:3]))

    def exact(z):
        return jnp.concatenate([u_fn(z), v_fn(z), p_fn(z)], axis=1)

    lb, ub = (0.0, 0.0, 0.0), (pi, pi, t_final)
    faces = (
        ((0.0, 0.0, 0.0), (0.0, pi, t_final)),     # x = 0
        ((pi, 0.0, 0.0), (pi, pi, t_final)),       # x = π
        ((0.0, 0.0, 0.0), (pi, 0.0, t_final)),     # y = 0
        ((0.0, pi, 0.0), (pi, pi, t_final)),       # y = π
        ((0.0, 0.0, 0.0), (pi, pi, 0.0)),          # t = 0 (IC)
    )
    groups = []
    for fi, fn in ((0, u_fn), (1, v_fn)):
        for lo, hi in faces:
            groups.append(sample.BCGroup(lo=lo, hi=hi, value_fn=fn, field=fi))
    groups.append(sample.BCGroup(lo=faces[0][0], hi=faces[0][1],
                                 value_fn=p_fn, field=2))

    return SystemSpec(
        name=f"taylor_green_nu{nu:g}",
        equations=(
            f"u_t + u*u_x + v*u_y + p_x - {nu}*(u_xx + u_yy)",
            f"v_t + u*v_x + v*v_y + p_y - {nu}*(v_xx + v_yy)",
            "u_x + v_y",
        ),
        fields=("u", "v", "p"),
        coords=("x", "y", "t"),
        lb=lb, ub=ub,
        bc_groups=tuple(groups),
        exact=exact,
    )


_NLS_EXACT = None


def _nls_oracle(z):
    """Lazy split-step Fourier reference (problems.oracles) → [N, 2]
    columns (Re h, Im h).  Host-side f64 numpy, built once per process
    (~5 s); never traced.  Measured: dt-halving final-frame agreement
    8e-7, mass drift 5e-12, interpolated-field error vs a 2× finer solve
    rms 2.0e-5."""
    global _NLS_EXACT
    if _NLS_EXACT is None:
        from tpinn.problems import oracles

        t, x, H = oracles.nls_solution()
        fr = oracles.grid_interpolant(t, x, H.real, 10.0)
        fi = oracles.grid_interpolant(t, x, H.imag, 10.0)
        _NLS_EXACT = (fr, fi)
    import numpy as np

    fr, fi = _NLS_EXACT
    return np.concatenate([fr(z), fi(z)], axis=1)


def schrodinger() -> SystemSpec:
    """The Raissi et al. (2019) nonlinear Schrödinger benchmark:

        i·h_t + ½·h_xx + |h|²·h = 0,   x∈[−5,5], t∈[0,π/2]
        h(x,0) = 2·sech(x),  periodic in x

    COMPLEX-valued — posed as the equivalent 2-field real system over
    h = u + iv (the standard reduction; the compiler has no complex
    dtype and does not need one):

        u_t + ½·v_xx + (u² + v²)·v = 0        (imaginary part)
        v_t − ½·u_xx − (u² + v²)·u = 0        (−1 × real part)

    The IC is the Satsuma–Yajima N=2 soliton bound state: |h| focuses
    from 2 to ≈4 at t = π/4 — a genuinely hard dispersive benchmark
    (Raissi reports 1.97e-3 rel-L2 on h).  Periodicity is hard-posed by
    the domain-fitted periodic embedding, so the two ICs are the only
    data terms.  Oracle: Strang split-step Fourier
    (problems.oracles.nls_solution)."""
    t_final = 0.5 * math.pi

    def ic_u(z):
        return 2.0 / jnp.cosh(z[:, 0:1])

    return SystemSpec(
        name="schrodinger",
        equations=(
            "u_t + 0.5*v_xx + (u**2 + v**2)*v",
            "v_t - 0.5*u_xx - (u**2 + v**2)*u",
        ),
        fields=("u", "v"),
        coords=("x", "t"),
        lb=(-5.0, 0.0),
        ub=(5.0, t_final),
        feature_kinds=("periodic_fit", "minmax"),
        bc_groups=(
            sample.BCGroup(lo=(-5.0, 0.0), hi=(5.0, 0.0), value_fn=ic_u,
                           value_expr="2/cosh(x)", field=0),    # Re IC
            sample.BCGroup(lo=(-5.0, 0.0), hi=(5.0, 0.0), value=0.0,
                           field=1),                            # Im IC
        ),
        exact=_nls_oracle,
    )


SYSTEM_PRESETS = {
    "kovasznay": kovasznay,
    "taylor_green": taylor_green,
    "schrodinger": schrodinger,
}


def get_system(name: str) -> SystemSpec:
    try:
        return SYSTEM_PRESETS[name]()
    except KeyError:
        raise KeyError(f"unknown system preset {name!r}; "
                       f"available: {sorted(SYSTEM_PRESETS)}")


# ---------------------------------------------------------------------------
# Best-known system recipes — the measured hardware configs, mirroring
# tpinn.problems.recipes.RECIPES for the single-field presets.  Each dict
# holds the CLI-level knobs of the committed evidence run (the system CLI
# builds one TrainSpec stage from them; `tpinn system --name X --recipe`).
# ---------------------------------------------------------------------------

SYSTEM_RECIPES = {
    # kv1 (earlier accelerator run; awaiting an H100 run): aggregate
    # 3.67e-4 — u 2.5e-4, v 1.8e-3, p 8.7e-4 (pressure pinned on one edge only)
    "kovasznay": {
        "adam": 12000, "lbfgs": 8000, "depth": 5, "width": 64,
        "n_col": 8000, "n_adaptive": 2000, "n_bd": 400,
        "expected_rel_l2": 3.7e-4, "run_tag": "kv1",
    },
    # tg1 pending; CPU evidence (round 4): u 7.2e-4,
    # v 8.1e-4, p 6.6e-3 at 6k+5k
    "taylor_green": {
        "adam": 10000, "lbfgs": 8000, "depth": 5, "width": 64,
        "n_col": 8000, "n_adaptive": 2000, "n_bd": 300,
        "expected_rel_l2": 8e-4, "run_tag": "tg1(queued); CPU r4",
    },
    # sch1 (earlier accelerator run; awaiting an H100 run): aggregate
    # 1.28e-2 — u 1.0e-2, v 1.6e-2 on the Satsuma-Yajima focusing bound state
    "schrodinger": {
        "adam": 20000, "lbfgs": 8000, "depth": 5, "width": 96,
        "n_col": 8192, "n_adaptive": 2048, "n_bd": 512,
        "expected_rel_l2": 1.3e-2, "run_tag": "sch1",
    },
}
