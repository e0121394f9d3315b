"""Benchmark problem presets, each with an analytic oracle.

The reference solves exactly one problem — polar Laplace on an annulus with
the hardcoded oracle u = log(r)/log(0.1) (software.py:283-297, 815).  The
rebuild generalizes: these presets cover BASELINE.json's five configs plus
the reference problem, every one with an exact solution so convergence is
measurable (rel-L2) in tests and benchmarks.

Each preset is a ``ProblemSpec`` whose equation string goes through the real
symbolic compiler — nothing is hardcoded.  Problems with a non-zero forcing
use manufactured solutions so the oracle is closed-form.
"""

from __future__ import annotations

from typing import Optional


import math

import jax.numpy as jnp

from tpinn.core import net, pde, sample
from tpinn.core.train import ProblemSpec

__all__ = ["PRESETS", "get_problem", "get_recipe", "RECIPES",
           "annulus_laplace", "poisson_1d",
           "burgers_1d", "poisson_2d", "heat_2d", "helmholtz_2d",
           "allen_cahn", "wave_1d", "kdv_1d"]


def annulus_laplace() -> ProblemSpec:
    """The reference's problem: Laplace in polar coordinates on the annulus
    r∈[0.1,1], θ∈[0,2π), Dirichlet u(0.1)=1, u(1)=0.  Exact:
    u = log(r)/log(0.1).

    **Deliberate deviation from the reference's θ-domain.**  The reference
    trains on t∈[0,1] (software.py:1170 T_bd=[0,1]) with raw cos(t)/sin(t)
    features (:172-175) — i.e. a 1-RADIAN WEDGE with Dirichlet data only on
    the two arcs and nothing on the θ-edges.  That problem is ill-posed:
    harmonic null modes sin(kπ·ln(r/0.1)/ln 10)·e^(±ν t) vanish on both
    arcs and are free on the wedge edges, so residual+BC minimization does
    not determine the solution (measured: longer optimization *increases*
    rel-L2 while the loss decreases — round-2 isolation runs aC0/aC1).
    Posing θ over the full circle [0, 2π] makes the cos/sin embedding a
    true hard periodicity constraint and the problem uniquely solvable;
    the exact solution and the equation string are unchanged."""
    two_pi = float(2.0 * jnp.pi)
    return ProblemSpec(
        name="annulus_laplace",
        equation="u_rr + 1/r*u_r + 1/r**2*u_tt",
        coords=("r", "t"),
        lb=(0.1, 0.0),
        ub=(1.0, two_pi),
        bc_groups=(
            sample.BCGroup(lo=(0.1, 0.0), hi=(0.1, two_pi), value=1.0),
            sample.BCGroup(lo=(1.0, 0.0), hi=(1.0, two_pi), value=0.0),
        ),
        feature_kinds=(net.MINMAX, net.PERIODIC),
        exact=lambda z: jnp.log(z[:, 0:1]) / jnp.log(0.1),
    )


def poisson_1d() -> ProblemSpec:
    """BASELINE config 1: −u″ = f on [0,1], u(0)=u(1)=0,
    manufactured u = sin(πx)."""
    return ProblemSpec(
        name="poisson_1d",
        equation="u_xx + pi**2*sin(pi*x)",
        coords=("x",),
        lb=(0.0,),
        ub=(1.0,),
        bc_groups=(
            sample.BCGroup(lo=(0.0,), hi=(0.0,), value=0.0),
            sample.BCGroup(lo=(1.0,), hi=(1.0,), value=0.0),
        ),
        exact=lambda z: jnp.sin(jnp.pi * z[:, 0:1]),
    )


def burgers_1d(nu: float = 0.01) -> ProblemSpec:
    """BASELINE config 2: viscous Burgers u_t + u·u_x = ν·u_xx on
    x∈[-1,1], t∈[0,1].  Manufactured solution u = e^{-t} sin(πx) with the
    matching forcing, so the oracle stays closed-form while the residual
    keeps the nonlinear convection and mixed space-time derivatives."""
    source = (
        f"-exp(-t)*sin(pi*x) + pi*exp(-2*t)*sin(pi*x)*cos(pi*x) "
        f"+ {nu}*pi**2*exp(-t)*sin(pi*x)"
    )
    ic = pde.compile_coord_expr("sin(pi*x)", coords=("x", "t"))
    return ProblemSpec(
        name="burgers_1d",
        equation=f"u_t + u*u_x - {nu}*u_xx",
        coords=("x", "t"),
        lb=(-1.0, 0.0),
        ub=(1.0, 1.0),
        bc_groups=(
            sample.BCGroup(lo=(-1.0, 0.0), hi=(1.0, 0.0), value_fn=ic,
                           value_expr="sin(pi*x)"),  # IC
            sample.BCGroup(lo=(-1.0, 0.0), hi=(-1.0, 1.0), value=0.0),
            sample.BCGroup(lo=(1.0, 0.0), hi=(1.0, 1.0), value=0.0),
        ),
        exact=lambda z: jnp.exp(-z[:, 1:2]) * jnp.sin(jnp.pi * z[:, 0:1]),
        source=source,
    )


_HERMGAUSS = None


def _burgers_shock_exact(z, nu: float):
    """Cole–Hopf closed form of viscous Burgers with IC −sin(πx),
    evaluated by 96-point Gauss–Hermite quadrature (the standard oracle
    for this benchmark; public method).  Host-side float64 numpy — the
    Cole–Hopf weight exp(−cos(πy)/(2πν)) reaches e^50 at ν = 0.01/π,
    which overflows f32; every call site wraps exact() eagerly, so no
    jit ever traces this."""
    import numpy as np

    global _HERMGAUSS
    if _HERMGAUSS is None:
        _HERMGAUSS = np.polynomial.hermite.hermgauss(96)
    xi, w = _HERMGAUSS
    z = np.asarray(z, np.float64)
    x, t = z[:, 0:1], z[:, 1:2]
    s = np.sqrt(np.maximum(4.0 * nu * t, 0.0))          # [N,1]
    y = x - s * xi[None, :]                             # [N,Q]
    expo = -np.cos(np.pi * y) / (2.0 * np.pi * nu)
    g = np.exp(expo - expo.max(axis=1, keepdims=True))  # stabilized
    num = np.sum(w * np.sin(np.pi * y) * g, axis=1, keepdims=True)
    den = np.sum(w * g, axis=1, keepdims=True)
    return -num / den


def burgers_shock(nu: Optional[float] = None) -> ProblemSpec:
    """The REAL Burgers benchmark (Raissi et al. 2019 config): ν = 0.01/π,
    u(x,0) = −sin(πx), u(±1,t) = 0 — a genuine steep front forms at x = 0
    by t ≈ 0.3 (|u_x(0,1)| ≈ 152), unlike burgers_1d's smooth manufactured
    solution.  No forcing; the oracle is the Cole–Hopf integral evaluated
    by Gauss–Hermite quadrature (exact BCs by antisymmetry).  The front is
    where time-marching (--march) and the causal weighting earn their keep."""
    if nu is None:
        nu = 0.01 / float(jnp.pi)
    ic = pde.compile_coord_expr("-sin(pi*x)", coords=("x", "t"))
    return ProblemSpec(
        name="burgers_shock",
        equation=f"u_t + u*u_x - {nu}*u_xx",
        coords=("x", "t"),
        lb=(-1.0, 0.0),
        ub=(1.0, 1.0),
        bc_groups=(
            sample.BCGroup(lo=(-1.0, 0.0), hi=(1.0, 0.0), value_fn=ic,
                           value_expr="-sin(pi*x)"),  # IC
            sample.BCGroup(lo=(-1.0, 0.0), hi=(-1.0, 1.0), value=0.0),
            sample.BCGroup(lo=(1.0, 0.0), hi=(1.0, 1.0), value=0.0),
        ),
        exact=lambda z, _nu=nu: _burgers_shock_exact(z, _nu),
    )


def poisson_2d() -> ProblemSpec:
    """BASELINE config 3: Poisson on the unit square with adaptive
    collocation resampling.  Manufactured u = sin(πx)sin(πy)."""
    return ProblemSpec(
        name="poisson_2d",
        equation="u_xx + u_yy + 2*pi**2*sin(pi*x)*sin(pi*y)",
        coords=("x", "y"),
        lb=(0.0, 0.0),
        ub=(1.0, 1.0),
        bc_groups=(
            sample.BCGroup(lo=(0.0, 0.0), hi=(0.0, 1.0), value=0.0),
            sample.BCGroup(lo=(1.0, 0.0), hi=(1.0, 1.0), value=0.0),
            sample.BCGroup(lo=(0.0, 0.0), hi=(1.0, 0.0), value=0.0),
            sample.BCGroup(lo=(0.0, 1.0), hi=(1.0, 1.0), value=0.0),
        ),
        exact=lambda z: jnp.sin(jnp.pi * z[:, 0:1]) * jnp.sin(jnp.pi * z[:, 1:2]),
    )


def heat_2d() -> ProblemSpec:
    """BASELINE config 4: heat equation u_t = u_xx on x∈[0,1], t∈[0,1],
    u(x,0)=sin(πx), u(0,t)=u(1,t)=0.  Exact u = e^{-π²t} sin(πx)."""
    ic = pde.compile_coord_expr("sin(pi*x)", coords=("x", "t"))
    return ProblemSpec(
        name="heat_2d",
        equation="u_t - u_xx",
        coords=("x", "t"),
        lb=(0.0, 0.0),
        ub=(1.0, 1.0),
        bc_groups=(
            sample.BCGroup(lo=(0.0, 0.0), hi=(1.0, 0.0), value_fn=ic,
                           value_expr="sin(pi*x)"),   # IC
            sample.BCGroup(lo=(0.0, 0.0), hi=(0.0, 1.0), value=0.0),
            sample.BCGroup(lo=(1.0, 0.0), hi=(1.0, 1.0), value=0.0),
        ),
        exact=lambda z: jnp.exp(-jnp.pi**2 * z[:, 1:2]) * jnp.sin(jnp.pi * z[:, 0:1]),
    )


def helmholtz_2d(k: float = 20.0) -> ProblemSpec:
    """BASELINE config 5: Helmholtz Δu + k²u = f, k=20 — the
    high-frequency spectral-bias stress test.  Manufactured
    u = sin(kx)sin(ky) ⇒ f = −k²·sin(kx)sin(ky); Dirichlet edges carry the
    exact trace (compiled boundary expressions)."""
    k2 = k * k
    edge = lambda expr: pde.compile_coord_expr(expr, coords=("x", "y"))
    return ProblemSpec(
        name="helmholtz_2d",
        equation=f"u_xx + u_yy + {k2}*u + {k2}*sin({k}*x)*sin({k}*y)",
        coords=("x", "y"),
        lb=(0.0, 0.0),
        ub=(1.0, 1.0),
        bc_groups=(
            sample.BCGroup(lo=(0.0, 0.0), hi=(0.0, 1.0), value=0.0),
            sample.BCGroup(lo=(1.0, 0.0), hi=(1.0, 1.0),
                           value_fn=edge(f"sin({k})*sin({k}*y)"),
                           value_expr=f"sin({k})*sin({k}*y)"),
            sample.BCGroup(lo=(0.0, 0.0), hi=(1.0, 0.0), value=0.0),
            sample.BCGroup(lo=(0.0, 1.0), hi=(1.0, 1.0),
                           value_fn=edge(f"sin({k}*x)*sin({k})"),
                           value_expr=f"sin({k}*x)*sin({k})"),
        ),
        exact=lambda z: jnp.sin(k * z[:, 0:1]) * jnp.sin(k * z[:, 1:2]),
    )


def poisson_3d() -> ProblemSpec:
    """Beyond the reference (strictly 2-D, SURVEY §2b.14): Poisson on the
    unit cube, manufactured u = sin(πx)sin(πy)sin(πz) — exercises the
    d ≥ 3 sampler/density path (sample.make_sampler_nd).  Soft-posed with
    six zero-Dirichlet face groups; the recipe trains the hard-BC ansatz
    (HARD_BC below), which is ~6× more accurate at equal wall in 3-D."""
    faces = (
        ((0.0, 0.0, 0.0), (0.0, 1.0, 1.0)),
        ((1.0, 0.0, 0.0), (1.0, 1.0, 1.0)),
        ((0.0, 0.0, 0.0), (1.0, 0.0, 1.0)),
        ((0.0, 1.0, 0.0), (1.0, 1.0, 1.0)),
        ((0.0, 0.0, 0.0), (1.0, 1.0, 0.0)),
        ((0.0, 0.0, 1.0), (1.0, 1.0, 1.0)),
    )
    return ProblemSpec(
        name="poisson_3d",
        equation=("u_xx + u_yy + u_zz "
                  "+ 3*pi**2*sin(pi*x)*sin(pi*y)*sin(pi*z)"),
        coords=("x", "y", "z"),
        lb=(0.0, 0.0, 0.0),
        ub=(1.0, 1.0, 1.0),
        bc_groups=tuple(
            sample.BCGroup(lo=lo, hi=hi, value=0.0) for lo, hi in faces
        ),
        exact=lambda z: (jnp.sin(jnp.pi * z[:, 0:1])
                         * jnp.sin(jnp.pi * z[:, 1:2])
                         * jnp.sin(jnp.pi * z[:, 2:3])),
    )


def convection_1d(c: float = 30.0) -> ProblemSpec:
    """Beyond the reference (no pure-advection config): convection
    u_t + c·u_x = 0 at c = 30 — the canonical PINN failure mode
    (Krishnapriyan et al. 2021; the motivating benchmark of the causal-
    weighting literature).  The residual is near-minimized by flattening
    u at later times, so plain MSE training stalls far from the
    travelling wave.  Mitigations shipped here, measured at equal
    ~30k-step CPU budget (out/acc_cpu/cv*, out/march_cv):
    time-marching WINS — 4 windows reach 2.04e-2 composite rel-L2
    (the recipe, Recipe.march=4) where plain training gets 0.196 and
    in-net causal weighting 0.265 (front mechanism verified — slabs
    converge strictly left→right — but at this budget the swept-late
    slabs are undertrained).  Per-stage c-curricula are the third arm
    (StageSpec.equation + init_from="prev"); the longer-budget A/Bs
    (cvT0/cvT20/cvTc/cvTM) await an H100 run.

    Posed 2π-periodic in x via the periodic feature map (the network is
    exactly periodic, so the IC u(x,0) = sin(x) is the only data term).
    Exact u = sin(x − c·t)."""
    two_pi = 2.0 * float(jnp.pi)
    ic = pde.compile_coord_expr("sin(x)", coords=("x", "t"))
    return ProblemSpec(
        name="convection_1d",
        equation=f"u_t + {c}*u_x",
        coords=("x", "t"),
        lb=(0.0, 0.0),
        ub=(two_pi, 1.0),
        feature_kinds=("periodic", "minmax"),
        bc_groups=(
            sample.BCGroup(lo=(0.0, 0.0), hi=(two_pi, 0.0),
                           value_fn=ic, value_expr="sin(x)"),   # IC
        ),
        exact=lambda z: jnp.sin(z[:, 0:1] - c * z[:, 1:2]),
    )


_AC_EXACT = None


def _allen_cahn_oracle(z):
    """Lazy ETDRK4 spectral reference (problems.oracles) — host-side f64
    numpy, built once per process (~1 s); never traced (burgers_shock's
    oracle discipline).  Measured oracle accuracy: dt-halving agreement
    1.7e-11 at t=1; interpolated-field error vs a 2× finer solve
    rms 7.9e-6 / max 3.0e-4 (interface-localized) — far below any PINN
    accuracy on this benchmark."""
    global _AC_EXACT
    if _AC_EXACT is None:
        from tpinn.problems import oracles

        t, x, U = oracles.allen_cahn_solution()
        _AC_EXACT = oracles.grid_interpolant(t, x, U, 2.0)
    return _AC_EXACT(z)


def allen_cahn() -> ProblemSpec:
    """The Raissi et al. (2019) Allen–Cahn benchmark — the canonical STIFF
    reaction–diffusion PINN stress test:

        u_t − 1e-4·u_xx + 5u³ − 5u = 0,   x∈[−1,1], t∈[0,1]
        u(x,0) = x²cos(πx),  periodic in x

    The bistable reaction term sharpens the IC into near-±1 plateaus
    separated by thin (√γ ≈ 0.01-wide) interface layers — plain space-time
    PINN training famously fails here (it was the motivating example of
    the seq2seq/marching literature), which makes it the flagship problem
    for ``--march``.  Periodicity is hard-posed via the domain-fitted
    periodic embedding (net.PERIODIC_FIT), so the IC is the only data
    term.  No closed form: the oracle is the ETDRK4 Fourier-spectral
    reference (problems.oracles.allen_cahn_solution)."""
    ic = pde.compile_coord_expr("x**2*cos(pi*x)", coords=("x", "t"))
    return ProblemSpec(
        name="allen_cahn",
        equation="u_t - 0.0001*u_xx + 5*u**3 - 5*u",
        coords=("x", "t"),
        lb=(-1.0, 0.0),
        ub=(1.0, 1.0),
        feature_kinds=(net.PERIODIC_FIT, net.MINMAX),
        bc_groups=(
            sample.BCGroup(lo=(-1.0, 0.0), hi=(1.0, 0.0), value_fn=ic,
                           value_expr="x**2*cos(pi*x)"),   # IC
        ),
        exact=_allen_cahn_oracle,
    )


def wave_1d() -> ProblemSpec:
    """Second-order-in-time: the 1-D wave equation u_tt = 4u_xx on
    x∈[0,1], t∈[0,1] with the two-mode standing wave

        u = sin(πx)cos(2πt) + ½sin(4πx)cos(8πt)

    (the benchmark of Wang et al.'s causal-training paper).  Exercises
    u_tt through the derivative engine and the OPERATOR boundary condition
    (BCGroup.operator="u_t"): a well-posed wave IC pins both u(x,0) and
    u_t(x,0), which no Dirichlet-only UI (the reference's, software.py
    :283-297) can express.  The hard-BC recipe instead uses the bubble t²
    — u = IC(x) + t²·x(1−x)·N satisfies all four constraints exactly."""
    ic = pde.compile_coord_expr("sin(pi*x) + 0.5*sin(4*pi*x)",
                                coords=("x", "t"))
    return ProblemSpec(
        name="wave_1d",
        equation="u_tt - 4*u_xx",
        coords=("x", "t"),
        lb=(0.0, 0.0),
        ub=(1.0, 1.0),
        bc_groups=(
            sample.BCGroup(lo=(0.0, 0.0), hi=(1.0, 0.0), value_fn=ic,
                           value_expr="sin(pi*x) + 0.5*sin(4*pi*x)"),  # IC
            sample.BCGroup(lo=(0.0, 0.0), hi=(1.0, 0.0), value=0.0,
                           operator="u_t"),           # velocity IC
            sample.BCGroup(lo=(0.0, 0.0), hi=(0.0, 1.0), value=0.0),
            sample.BCGroup(lo=(1.0, 0.0), hi=(1.0, 1.0), value=0.0),
        ),
        exact=lambda z: (
            jnp.sin(jnp.pi * z[:, 0:1]) * jnp.cos(2 * jnp.pi * z[:, 1:2])
            + 0.5 * jnp.sin(4 * jnp.pi * z[:, 0:1])
            * jnp.cos(8 * jnp.pi * z[:, 1:2])),
    )


def kdv_1d(c: float = 4.0, a: float = -5.0) -> ProblemSpec:
    """Korteweg–de Vries single soliton — THIRD-order dispersion:

        u_t + 6u·u_x + u_xxx = 0,   x∈[−10,10], t∈[0,1]
        u = (c/2)·sech²(√c/2·(x − ct − a))

    The order-3 term rides the nested-jvp derivative path
    (tpinn.core.deriv: order ≥ 3 multi-indices), which no other preset
    reaches.  Dirichlet data from the exact trace on both edges (soliton
    tails ≤ 7e-4 there) + the IC; the balance of nonlinear steepening
    against dispersion means the profile must translate undistorted —
    any residual shortcut shows up immediately as shape error."""
    # host math only: preset construction must never dispatch to the
    # device (the UI preset list builds every spec; a wedged backend
    # would hang the whole app on a jnp call here)
    rc = math.sqrt(c) / 2.0

    def exact(z):
        s = rc * (z[:, 0:1] - c * z[:, 1:2] - a)
        return (c / 2.0) / jnp.cosh(s) ** 2

    ic_expr = f"{c / 2.0}/cosh({rc}*(x - {a}))**2"
    ic = pde.compile_coord_expr(ic_expr, coords=("x", "t"))
    return ProblemSpec(
        name="kdv_1d",
        equation="u_t + 6*u*u_x + u_xxx",
        coords=("x", "t"),
        lb=(-10.0, 0.0),
        ub=(10.0, 1.0),
        bc_groups=(
            sample.BCGroup(lo=(-10.0, 0.0), hi=(10.0, 0.0), value_fn=ic,
                           value_expr=ic_expr),                 # IC
            sample.BCGroup(lo=(-10.0, 0.0), hi=(-10.0, 1.0), value_fn=exact),
            sample.BCGroup(lo=(10.0, 0.0), hi=(10.0, 1.0), value_fn=exact),
        ),
        exact=exact,
    )


def lshape_laplace() -> ProblemSpec:
    """Beyond the reference (box domains only): Laplace on the L-shaped
    domain [−1,1]² ∖ (0,1]×[−1,0) — the classic re-entrant-corner
    benchmark.  Exact singular solution u = r^{2/3} sin(2θ/3) with
    θ ∈ [0, 3π/2] measured counterclockwise from the inner edge y=0, x>0
    (u ∈ H^{1+2/3−ε} only: the gradient blows up at the corner — the
    standard stress test for adaptive refinement).

    Posed on the BOUNDING box with a 0/1 ``residual_weight`` indicator
    that removes the dead quadrant from the residual, BC groups tracing
    the true L boundary (the two inner edges carry u = 0), and
    ``eval_mask`` restricting the metric and the adaptive density to the
    real domain.  No sampler changes needed — the masked-box posing is
    the framework's general non-box recipe."""
    def _theta(z):
        th = jnp.arctan2(z[:, 1:2], z[:, 0:1])
        return jnp.where(th < 0, th + 2 * jnp.pi, th)

    def exact(z):
        r = jnp.sqrt(z[:, 0:1] ** 2 + z[:, 1:2] ** 2)
        return r ** (2.0 / 3.0) * jnp.sin(2.0 * _theta(z) / 3.0)

    def inside(z):
        # 1 on the L (x <= 0 or y >= 0), 0 on the dead quadrant
        x, y = z[:, 0:1], z[:, 1:2]
        return jnp.where(jnp.logical_or(x <= 0.0, y >= 0.0), 1.0, 0.0)

    edges = (
        ((-1.0, -1.0), (-1.0, 1.0)),    # x = −1
        ((-1.0, 1.0), (1.0, 1.0)),      # y = 1
        ((1.0, 0.0), (1.0, 1.0)),       # x = 1, upper half
        ((-1.0, -1.0), (0.0, -1.0)),    # y = −1, left half
        ((0.0, -1.0), (0.0, 0.0)),      # inner edge x = 0 (u = 0)
        ((0.0, 0.0), (1.0, 0.0)),       # inner edge y = 0 (u = 0)
    )
    return ProblemSpec(
        name="lshape_laplace",
        equation="u_xx + u_yy",
        coords=("x", "y"),
        lb=(-1.0, -1.0),
        ub=(1.0, 1.0),
        bc_groups=tuple(
            sample.BCGroup(lo=lo, hi=hi, value_fn=exact) for lo, hi in edges
        ),
        exact=exact,
        residual_weight=inside,
        eval_mask=inside,
    )


PRESETS = {
    "annulus_laplace": annulus_laplace,
    "poisson_1d": poisson_1d,
    "burgers_1d": burgers_1d,
    "burgers_shock": burgers_shock,
    "poisson_2d": poisson_2d,
    "heat_2d": heat_2d,
    "helmholtz_2d": helmholtz_2d,
    "poisson_3d": poisson_3d,
    "convection_1d": convection_1d,
    "lshape_laplace": lshape_laplace,
    "allen_cahn": allen_cahn,
    "wave_1d": wave_1d,
    "kdv_1d": kdv_1d,
}


def get_problem(name: str) -> ProblemSpec:
    try:
        return PRESETS[name]()
    except KeyError:
        raise KeyError(
            f"unknown problem {name!r}; available: {sorted(PRESETS)}"
        ) from None


# Hard Dirichlet ansatz (lift, bubble) per preset: u = lift + bubble·N
# meets the BC/IC data to machine precision for any network output
# (net.wrap_hard_bc).  The lift interpolates the boundary data (transfinite
# blending for non-constant traces); the bubble vanishes exactly on the
# constrained boundary.  Opt-in: ProblemSpec.hard_bc stays None by default
# so the presets keep the reference's soft-penalty semantics.
_K = 20.0  # helmholtz_2d default wavenumber


def _helmholtz_hard(k: float = _K):
    lift = (f"x*sin({k})*sin({k}*y) + y*sin({k}*x)*sin({k}) "
            f"- x*y*sin({k})*sin({k})")
    return (lift, "x*(1 - x)*y*(1 - y)")


HARD_BC = {
    "annulus_laplace": ("(1 - r)/0.9", "(r - 0.1)*(1 - r)"),
    "poisson_1d": ("0", "x*(1 - x)"),
    "burgers_1d": ("sin(pi*x)", "t*(1 - x**2)"),
    "burgers_shock": ("-sin(pi*x)", "t*(1 - x**2)"),
    "poisson_2d": ("0", "x*(1 - x)*y*(1 - y)"),
    "heat_2d": ("sin(pi*x)", "t*x*(1 - x)"),
    "helmholtz_2d": _helmholtz_hard(),
    "poisson_3d": ("0", "x*(1 - x)*y*(1 - y)*z*(1 - z)"),
    # hard IC only — x is handled by the periodic feature map
    "convection_1d": ("sin(x)", "t"),
    # hard IC only — x is handled by the domain-fitted periodic map
    "allen_cahn": ("x**2*cos(pi*x)", "t"),
    # the t² bubble pins u(x,0) AND u_t(x,0); x(1−x) the edges
    "wave_1d": ("sin(pi*x) + 0.5*sin(4*pi*x)", "t**2*x*(1 - x)"),
}


def with_hard_bc(problem: ProblemSpec) -> ProblemSpec:
    """The preset posed with its hard-BC ansatz (KeyError if no recipe)."""
    import dataclasses

    return dataclasses.replace(problem, hard_bc=HARD_BC[problem.name])


def get_recipe(name: str):
    """(ProblemSpec, TrainSpec) of the preset's best-known gate-meeting
    configuration (tpinn.problems.recipes)."""
    from tpinn.problems.recipes import get_recipe as _get

    return _get(name)


def __getattr__(name):  # lazy: recipes imports core.train
    if name == "RECIPES":
        from tpinn.problems.recipes import RECIPES

        return RECIPES
    if name in ("SYSTEM_PRESETS", "get_system"):
        from tpinn.problems import systems

        return getattr(systems, name)
    raise AttributeError(name)
