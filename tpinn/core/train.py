"""Training orchestrator: multi-stage PINN pipeline (run_pinn_training equivalent).

Mirrors the reference's two-stage Adam→L-BFGS pipeline
(software.py:626-1139) with each stage's compute fully on-device:

    stage 1: user-size tanh net → Adam phase (one XLA computation:
             resample / density-refresh / plateau-LR / tail automaton)
             → density refresh → pure-XLA L-BFGS → artifacts + diagnostics
    stage 2: multilevel correction net (default 6×50, sin first activation)
             with frequency scl₂ = 30 if e₁>50 else r₁/e₁, amplitude
             ε₂ = e₁, weights lw₂ = [f/diff, df/diff²], composed predictor
             u = u₁(z) + ε₂·NN₂(z) with stage 1 frozen, doubled sample
             counts, 3× epochs (software.py:938-997)

and generalizes it: any parsed PDE (1-D or 2-D), any number of stages, any
model family from the zoo, configurable dtype.

Deviations from the reference, on purpose (documented per SURVEY §2b.14):
- depth/width use correct semantics (depth = hidden layers, width = units);
  the reference swaps them when unpacking the UI dict (software.py:712).
- Problems without an analytic solution derive stage-2 scales from the
  residual RMS alone (the reference always has its hardcoded oracle).
- L-BFGS history cadence is selectable (TrainSpec.lbfgs_history): one row
  per accepted iterate (default, compact) or per function evaluation (the
  reference's cadence, software.py:485-488 — the app entry uses this).
"""

from __future__ import annotations

import sys
from dataclasses import dataclass, field, replace
from pathlib import Path
from typing import Callable, List, Optional, Sequence, Tuple, Union

import jax
import jax.numpy as jnp
import numpy as np

from tpinn.core import loss as loss_mod
from tpinn.core import net, optim, pde, sample
from tpinn.utils import artifacts
from tpinn.utils.profiling import PhaseTimer

Array = jax.Array


# ---------------------------------------------------------------------------
# Specs
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class ProblemSpec:
    """What to solve: PDE + domain + BCs + (optional) analytic oracle."""

    name: str
    equation: str                          # residual expression (or lhs = rhs)
    coords: Tuple[str, ...]                # e.g. ("r", "t"), ("x",), ("x", "t")
    lb: Tuple[float, ...]
    ub: Tuple[float, ...]
    bc_groups: Tuple[sample.BCGroup, ...]
    feature_kinds: Tuple[str, ...] = None  # defaults to all-minmax
    exact: Optional[Callable[[Array], Array]] = None  # analytic solution z->u
    source: Optional[str] = None           # forcing g(z): residual -= g
    # hard Dirichlet constraints: coordinate-expression strings
    # (lift, bubble) -> u = lift(z) + bubble(z)·N(z); see net.wrap_hard_bc
    hard_bc: Optional[Tuple[str, str]] = None
    # pointwise residual weight w(z) (coordinate-expression string, or a
    # callable z -> [N,1]): loss_eqn = MSE(w·residual).  E.g. "exp(4*t)"
    # on decaying problems, or a 0/1 indicator to pose a NON-BOX domain
    # inside its bounding box (collocation outside the true domain is
    # weighted out; BC groups trace the real boundary) — see
    # problems.lshape_laplace
    residual_weight: Optional[object] = None
    # evaluation mask m(z) -> [N,1] in {0,1} (callable): rel-L2 and the
    # adaptive density are restricted to m > 0.  Required for masked
    # non-box domains, where the predictor is unconstrained (and the
    # oracle meaningless) outside the true domain
    eval_mask: Optional[Callable[[Array], Array]] = None

    def __post_init__(self):
        if self.feature_kinds is None:
            object.__setattr__(
                self, "feature_kinds", tuple([net.MINMAX] * len(self.coords))
            )
        if len(self.feature_kinds) != len(self.coords):
            raise ValueError("feature_kinds must match coords")

    @property
    def dim(self) -> int:
        return len(self.coords)


@dataclass(frozen=True)
class StageSpec:
    """Architecture/schedule of one training stage.  ``None`` fields are
    derived from the previous stage's diagnostics (stage≥2 only)."""

    depth: int
    width: int
    act_first: str = "tanh"
    act_hidden: str = "tanh"               # "sin" → SIREN-style
    scl: Optional[float] = None            # None → derived (stage ≥ 2)
    epsil: Optional[float] = None          # None → derived (stage ≥ 2)
    adam_epochs: int = 1000
    lbfgs_epochs: int = 1000               # max L-BFGS iters = epochs/3 (ref)
    # L-BFGS restarts with fresh point draws + density refresh between them
    # (the reference's `for l in range(1)` loop, software.py:755-759, with
    # the knob actually usable).  Deep L-BFGS on ONE fixed draw overfits the
    # sampled collocation set — measured on the annulus: 3000 iterations on
    # one draw reach loss 5e-10 but WORSEN rel-L2 3x vs 1000 iterations;
    # restarting with fresh draws restores generalization.
    lbfgs_rounds: int = 1
    # extra count multiplier for the L-BFGS phase's point set only: the
    # polish is a few hundred full-batch iterations, so points are cheap,
    # and a larger set prevents the quasi-Newton steps from interpolating
    # the draw (f64-polish study of the earlier accuracy campaign)
    lbfgs_sample_scale: float = 1.0
    # if > 0: replace the L-BFGS phase's random draws with a DETERMINISTIC
    # tensor grid of this resolution (g^dim interior points + g points per
    # BC group along its box).  A dense regular grid finer than the net's
    # representable frequency kills the aliasing failure mode outright: the
    # polish cannot drive the sampled residual to zero while oscillating
    # between points, because there is no "between points" below the net's
    # bandwidth (same f64-polish study).
    lbfgs_grid: int = 0
    sample_scale: float = 1.0              # multiplies all sample counts
    fourier_features: int = 0
    fourier_scale: float = 1.0
    modified: bool = False
    # "prev": WARM-START this stage from the previous stage's final params
    # instead of composing a frozen correction chain (u = u_prev + ε·NN).
    # The architecture must match the previous stage exactly (same pytree);
    # scl/epsil default to the previous stage's values.  This is the
    # curriculum knob: e.g. Helmholtz k-continuation trains k=5 → k=10 →
    # k=20 on ONE network, each stage initialized at the previous k's
    # solution (combine with ``equation``below).
    init_from: Optional[str] = None
    # per-stage Adam learning rate (None → TrainSpec.lr).  Warm-started
    # continuation stages usually want a lower restart lr than the cold
    # stage-1 default — restarting a converged net at 1e-3 can undo it.
    lr: Optional[float] = None
    # Per-stage governing-equation override (same coords/BCs/domain).
    # Earlier curriculum stages solve an easier PDE (e.g. lower wavenumber);
    # the FINAL stage must state the problem's true equation (or leave this
    # None) — the reported metrics evaluate the stage's own equation.
    equation: Optional[str] = None
    # Per-stage (f, df) equation-weight override (None → TrainSpec.lw, or
    # the diff-derived rebalance for composed stages).  The loss-weight
    # schedule knob: e.g. near-resonant Helmholtz starts at lw0≈1/k⁴ so
    # the residual term doesn't swamp the boundary data, then a warm
    # continuation stage RAISES lw0 — at convergence the boundary rows are
    # what pin the near-resonant eigenmodes that the residual can't see
    # (loss 1e-6 at rel-L2 1.3e-3 measured on hP).
    lw: Optional[Tuple[float, float]] = None


@dataclass(frozen=True)
class TrainSpec:
    """Full training configuration (the UI dict schema, typed)."""

    n_col: int = 3000
    n_band: int = 1000
    n_adaptive: int = 1000
    n_bd: int = 100
    testing_size: Tuple[int, ...] = (111, 111)
    lw: Tuple[float, float] = (0.05, 0.0)  # (f, df) equation weights
    stages: Tuple[StageSpec, ...] = ()
    grid: int = 111
    seed: int = 1234
    dtype: str = "float32"
    lr: float = 1e-3
    log_every: int = 100
    resample_every: int = 100
    density_every: int = 2000
    plateau_every: int = 4000
    # plateau-halving lr floor (0.0 = reference's unbounded halving; see
    # optim.AdamConfig.lr_min — long budgets freeze without one)
    lr_min: float = 0.0
    tail_max: int = 4000
    # Optional dtype override for the L-BFGS phase only.  "float64" runs the
    # quasi-Newton polish in double precision (enables jax x64 globally):
    # Adam explores in fast f32 on the accelerator, then L-BFGS descends
    # below the f32 gradient-noise floor — the reference runs everything in
    # f64 (software.py:18) and owes its tight convergence to the L-BFGS
    # phase.
    # enable the residual-gradient loss term weighted by lw[1]
    # (make_loss(deriv_loss=True) — the reference's dormant df weight)
    deriv_loss: bool = False
    lbfgs_dtype: Optional[str] = None
    # L-BFGS loss-history cadence: "iters" = one row per accepted iterate
    # (compact), "evals" = one row per function evaluation — the
    # reference's cadence (software.py:485-488), so the UI loss curves
    # show the same number of points per L-BFGS phase as the reference.
    lbfgs_history: str = "iters"
    # Exact last-layer least-squares polish after each stage's L-BFGS
    # (tpinn.core.polish): "off", "auto" (apply when the compiled PDE is
    # linear — Burgers et al. skip it), or "on" (error if nonlinear).
    # Solved in float64 on the host CPU: the device does the nonconvex f32
    # feature learning, one exact convex solve lands the output layer on
    # the quadratic's optimum.
    lsq_polish: str = "off"
    # Spectral error correction after the FINAL stage (polish.defect_
    # correction): "off" | "auto" | "full".
    # "auto" — resonance-band deflation: for linear PDEs with a constant
    # zeroth-order coefficient c₀ (Helmholtz Δu+k²u), subtract the modal
    # leakage ⟨r,v⟩/ε·v on the near-null eigenmodes |ε| ≤ 0.35·c₀ that NO
    # loss term can see (measured: hQ's error FFT sits on the ring λ≈k²;
    # offline 3.7×).  Safe for soft BCs; inert when the operator has no
    # band (Poisson c₀=0) or isn't sine-diagonal (heat's ∂t).
    # "full" — exact defect correction e = L⁻¹r over the truncated
    # spectrum, valid when the error carries zero Dirichlet data (hard-BC
    # ansatz; the bubble is checked numerically face by face): elliptic
    # full-band inversion, the per-mode Duhamel march for parabolic
    # operators (heat), or the GALERKIN least-squares solve for operators
    # whose sine modes are not eigenmodes (annulus polar Laplace; Fourier
    # family on certified-periodic axes, (m−½)π march sines on
    # initial-value axes) — and, via jax.linearize, one Newton step for
    # NONLINEAR equations (Burgers).  Offline on committed runs:
    # poisson_2d 6.8×, heat tS 4.5×, annulus eM 9.9×.
    deflation: str = "off"
    # Resonance-band TRAINING penalty (polish.ring_penalty_setup; the
    # deflation="auto" spectral identity turned into a loss term): adds
    # ring_weight·‖Pᵀr‖² — the implied mean-square ring-mode solution
    # error of the live residual — so the optimizer can SEE the
    # near-null directions a plain residual MSE weights by ε²≈0
    # (Helmholtz's k²-ring).  0 disables; inert (with a log line) when
    # the operator selects no band modes (Poisson, heat, nonlinear).
    ring_weight: float = 0.0
    ring_band: float = 0.35
    ring_max_mode: int = 16
    # Causal residual weighting for EVOLUTION problems (loss.make_loss
    # ``causal=``; Wang/Sankaran/Perdikaris 2022): bin collocation points
    # into causal_bins slabs along the causal_axis coordinate and weight
    # slab i's residual by exp(-eps·Σ_{j<i}L_j/Σ_jL_j) — the exponent is
    # the slab's SHARE of the current total residual, so the optimizer
    # must converge early times before late ones count; plain residual
    # MSE lets stiff/advective problems "solve backwards in time" into a
    # wrong attractor.  eps is DIMENSIONLESS (share-normalized; 10-30
    # are sensible).  Adam phase only: L-BFGS/eval/polish see the plain
    # residual.  0.0 = off.  causal_axis is a coordinate NAME
    # looked up in ProblemSpec.coords (explicit because e.g. the annulus
    # preset's "t" is the polar angle, not time); enabling causal on a
    # problem without that coordinate is a config error.
    causal_eps: float = 0.0
    causal_bins: int = 32
    causal_axis: str = "t"
    # Derivative-engine selection for the loss residual (loss.make_loss,
    # one of loss.ENGINES): "auto" | "generic" | "fused".
    engine: str = "auto"
    # jax.lax matmul precision of the dense chain for the ADAM PHASE only
    # ("default", "high", or None = the network's own "highest").  What
    # each tier computes is the backend's choice: on an H100 "default" and
    # "high" run an f32 dot as TF32 on the tensor cores, "highest" as full
    # fp32 (chip_smoke.py phase 2).  The Adam phase explores above the f32
    # noise floor anyway; L-BFGS, the f64 eval and the LSQ polish always
    # run at the network's full precision, so converged accuracy is set by
    # the high-precision phases.
    adam_precision: Optional[str] = None
    # Derivative engine for the ADAM PHASE only (None = same as ``engine``)
    # — e.g. "fused" for the long Adam phase while L-BFGS keeps "auto".
    adam_engine: Optional[str] = None
    # Parameter layout of the scanned Adam automaton ("flat" = the whole
    # phase rides ONE raveled vector; same math to float32 ulps, fewer
    # per-step ops — see optim.AdamConfig.layout).  "tree" restores the
    # pre-round-4 per-leaf layout (and is required to resume a mid-Adam
    # checkpoint saved by it).
    adam_layout: str = "flat"
    # Minimum input-embedding width (net.FeatureMap.pad_to): pads the
    # feature columns with duplicates of column 0.  The model class is
    # unchanged; the first layer gets extra input rows, which changes its
    # initialisation and is recorded in the checkpoint meta.
    pad_features: int = 0
    # Mid-stage checkpoint cadence (steps, rounded up to the dispatch-chunk
    # grid; 0 = stage-level only).  With ``run_training(resume=True)`` a
    # killed run resumes the Adam phase at the last saved chunk with
    # identical numerics (L-BFGS is not mid-resumable — it restarts).
    checkpoint_every: int = 0
    # Nyquist guard on the DERIVED stage-≥2 frequency scale scl₂ = r/e
    # (software.py:943-946 derives it uncapped when e ≤ 50; an explicit
    # StageSpec.scl is never touched).  The sampler's density grid resolves
    # ~grid/2 cycles per axis, so a correction net whose first-layer sines
    # oscillate faster than ~grid/4 can zero the SAMPLED residual while
    # aliasing between collocation points — measured: heat_2d stage 2
    # auto-derived scl=106 and contributed nothing (e_rms 1.04e-5→1.09e-5,
    # error map low-frequency); annulus stage 3 auto-scl 118 pinned rel-L2
    # at ~1e-4 until capped at 30 (eE study).  "auto" → grid/4;
    # a float sets the cap directly; None reproduces the reference's
    # uncapped derivation.
    auto_scl_cap: Union[str, float, None] = "auto"

    def __post_init__(self):
        for name in ("engine", "adam_engine"):
            value = getattr(self, name)
            if value is not None and value not in loss_mod.ENGINES:
                raise ValueError(f"TrainSpec.{name}={value!r}; valid "
                                 f"engines: {', '.join(loss_mod.ENGINES)}")

    def with_default_stages(self, depth=6, width=50, adam=1000, lbfgs=1000):
        """Reference-like two stages: user net then 6×50 sin correction
        (software.py:941-956, 959, 983, 992)."""
        s1 = StageSpec(depth=depth, width=width, act_first="tanh",
                       scl=1.0, epsil=1.0, adam_epochs=adam, lbfgs_epochs=lbfgs)
        s2 = StageSpec(depth=6, width=50, act_first="sin", scl=None, epsil=None,
                       adam_epochs=3 * adam, lbfgs_epochs=3 * lbfgs,
                       sample_scale=2.0)
        return replace(self, stages=(s1, s2))


@dataclass
class StageResult:
    params: dict
    predictor_frozen: Callable[[Array], Array]   # z -> u with params baked in
    history: np.ndarray                          # [n, k] loss_info rows
    r_rms: float                                 # residual RMS on eval grid
    e_rms: Optional[float]                       # error RMS vs analytic
    U: np.ndarray                                # solution field on eval grid
    F: np.ndarray                                # residual field on eval grid
    scl: float
    epsil: float
    n_adam: int = 0                              # leading Adam rows of history


@dataclass
class TrainResult:
    problem: ProblemSpec
    spec: TrainSpec
    stages: List[StageResult]
    predict: Callable[[Array], Array]            # final composed u(z)
    rel_l2: Optional[float]                      # vs analytic, final stage
    history: np.ndarray                          # concatenated loss rows
    # PhaseTimer rows: wall and compile seconds per (stage, phase)
    phase_walls: List[dict] = field(default_factory=list)


def rms(x: Array) -> Array:
    """Global RMS — the reference's double-RMS reduction collapses to this
    (software.py:899-902: mean-of-column-means of squares)."""
    return jnp.sqrt(jnp.mean(jnp.square(x)))


# ---------------------------------------------------------------------------
# Evaluation grids + density refresh
# ---------------------------------------------------------------------------


def eval_grid(problem: ProblemSpec, testing_size: Sequence[int], dtype):
    """Test grid X_star and its meshes (software.py:698-702)."""
    axes = [
        jnp.linspace(problem.lb[i], problem.ub[i], int(testing_size[i]), dtype=dtype)
        for i in range(problem.dim)
    ]
    if problem.dim == 1:
        X = axes[0][:, None]
        return X, axes, (axes[0][:, None],)
    if problem.dim == 2:
        R, T = jnp.meshgrid(axes[0], axes[1])
        X_star = jnp.stack([R.reshape(-1), T.reshape(-1)], axis=1)
        return X_star, axes, (R, T)
    # d >= 3: 'ij' meshgrid stack (figures are 2-D-only; metrics/oracles
    # only need the flattened point set)
    grids = jnp.meshgrid(*axes, indexing="ij")
    X_star = jnp.stack([G.reshape(-1) for G in grids], axis=1)
    return X_star, axes, tuple(grids)


def resolve_testing_size(problem, testing_size, log=None, label=""):
    """``testing_size`` if its rank matches the problem, else a per-axis
    fallback grid (TrainSpec defaults to 2-D; shared by the system /
    inverse / patched runners)."""
    if len(testing_size) == problem.dim:
        return tuple(int(v) for v in testing_size)
    per_axis = {1: 256, 2: 64, 3: 24}.get(problem.dim, 12)
    tsize = (per_axis,) * problem.dim
    if log is not None:
        log(f"{label}testing_size {tuple(testing_size)} is not "
            f"{problem.dim}-D; evaluating on {tsize}")
    return tsize


def resolve_residual_weight(problem):
    """``w(z)`` from ProblemSpec.residual_weight: a callable passes
    through, a string compiles as a coordinate expression."""
    if problem.residual_weight is None:
        return None
    if callable(problem.residual_weight):
        return problem.residual_weight
    return pde.compile_coord_expr(problem.residual_weight, problem.coords)


def eval_stage_f64(predictor, params, X_star, compiled, source_fn, exact):
    """Evaluate u, residual (and the analytic oracle) in float64 on host CPU.

    The model trains and serves in f32 on the device, but the
    *measurement* must be more precise than the thing measured: composed
    stage-2+ predictors reach error levels (~1e-5 rel-L2) where f32
    evaluation noise — in u and especially through the nested-jvp second
    derivatives — inflates the reported metrics several-fold (measured on
    the annulus 2-stage run: rel-L2 1.29e-4 under f32 eval vs 3.17e-5
    under f64, same weights).  One-shot on the test grid.  Returns numpy
    arrays (u, f, exact_or_None)."""
    from tpinn.utils.x64 import force_x64

    cpu = jax.devices("cpu")[0]
    with force_x64():
        p64 = jax.tree.map(
            lambda a: jax.device_put(jnp.asarray(a, jnp.float64), cpu), params
        )
        z64 = jax.device_put(
            jnp.asarray(np.asarray(X_star), jnp.float64), cpu
        )
        with jax.default_device(cpu):
            u = np.asarray(jax.jit(predictor)(p64, z64))

            def _f(p, z):
                f = compiled.residual_fast(predictor, p, z)
                if source_fn is not None:
                    f = f - source_fn(z)
                return f

            f = np.asarray(jax.jit(_f)(p64, z64))
            e = np.asarray(exact(z64)) if exact is not None else None
    return u, f, e


def make_density_fn(predictor, compiled: pde.CompiledPDE, grids, source_fn=None,
                    mask_fn=None):
    """predictF equivalent (software.py:608-623): residual² density,
    normalized + 0.5 floor, Gaussian-smoothed — fully on-device.

    ``mask_fn`` (ProblemSpec.eval_mask) zeroes the density outside a
    masked non-box domain, so adaptive points never chase the
    meaningless residual there."""
    if len(grids) == 1:
        x_nodes = grids[0]

        def density1(params):
            f0 = compiled.residual_fast(predictor, params, x_nodes)
            if source_fn is not None:
                f0 = f0 - source_fn(x_nodes)
            f_sq = f0**2
            f_nm = f_sq / jnp.mean(f_sq) + 0.5
            if mask_fn is not None:
                f_nm = f_nm * mask_fn(x_nodes)
            return sample.gaussian_smooth_1d(f_nm, 1.0, 5)

        return density1

    if len(grids) == 2:
        R, T = grids
        z_star = jnp.stack([R.reshape(-1), T.reshape(-1)], axis=1)

        def density2(params):
            f0 = compiled.residual_fast(predictor, params, z_star)
            if source_fn is not None:
                f0 = f0 - source_fn(z_star)
            f_sq = f0**2
            f_nm = f_sq / jnp.mean(f_sq) + 0.5
            if mask_fn is not None:
                f_nm = f_nm * mask_fn(z_star)
            F = jnp.reshape(f_nm, R.shape)
            return sample.gaussian_smooth_2d(F, (1.0, 1.0), (5, 5))

        return density2

    # d >= 3 (make_sampler_nd grids): same pipeline on the flattened stack
    z_nd = jnp.stack([G.reshape(-1) for G in grids], axis=1)
    shape_nd = grids[0].shape

    def density_nd(params):
        f0 = compiled.residual_fast(predictor, params, z_nd)
        if source_fn is not None:
            f0 = f0 - source_fn(z_nd)
        f_sq = f0**2
        f_nm = f_sq / jnp.mean(f_sq) + 0.5
        if mask_fn is not None:
            f_nm = f_nm * mask_fn(z_nd)
        return sample.gaussian_smooth_nd(jnp.reshape(f_nm, shape_nd))

    return density_nd


# ---------------------------------------------------------------------------
# Orchestrator
# ---------------------------------------------------------------------------


def run_training(
    problem: ProblemSpec,
    spec: TrainSpec,
    output_dir: Optional[str] = None,
    log_fn: Optional[Callable] = None,
    print_log: bool = False,
    resume: bool = False,
    mesh=None,
) -> TrainResult:
    """Run the multi-stage pipeline.  Writes the reference's 11-artifact
    contract into ``output_dir`` when given.

    ``resume=True`` reloads any per-stage checkpoint already present in
    ``output_dir`` (params_stage_N.npz) and skips that stage's training —
    an interrupted multi-stage run continues from the last finished stage.
    With ``spec.checkpoint_every > 0`` it additionally resumes a stage
    mid-Adam from adam_state_stage_N.npz (saved every ``checkpoint_every``
    steps at dispatch-chunk granularity) with bit-identical numerics.
    (The reference has no checkpointing at all: params die with its
    training thread, SURVEY §5.)

    ``mesh``: a jax.sharding.Mesh from tpinn.parallel.make_mesh — point
    batches shard over the mesh's 'points' axis (pure data parallelism:
    one gradient psum per step), parameters replicated; sample
    counts are rounded up to multiples of the points-axis size."""
    if not spec.stages:
        spec = spec.with_default_stages()
    dtype = jnp.dtype(spec.dtype)
    if dtype == jnp.float64:
        jax.config.update("jax_enable_x64", True)

    out = Path(output_dir) if output_dir else None
    if out:
        out.mkdir(parents=True, exist_ok=True)

    def log(msg: str):
        if log_fn is not None:
            log_fn(msg)
        if print_log:
            print(msg, file=sys.stderr)

    compiled = pde.compile_pde(problem.equation, problem.coords)
    source_fn = (
        pde.compile_coord_expr(problem.source, problem.coords)
        if problem.source
        else None
    )
    # Neumann/Robin boundary operators (BCGroup.operator expressions):
    # group i's data term pins op_i(u) instead of u (loss.make_loss)
    bc_ops = tuple(
        pde.compile_pde(g.operator, problem.coords) if g.operator else None
        for g in problem.bc_groups
    )
    has_op_bc = any(o is not None for o in bc_ops)
    if not has_op_bc:
        bc_ops = None
    hard_fns = None
    if problem.hard_bc is not None:
        hard_fns = tuple(
            pde.compile_coord_expr(e, problem.coords) for e in problem.hard_bc
        )
    rw_fn = resolve_residual_weight(problem)
    if spec.lsq_polish == "on" and problem.eval_mask is not None:
        # fail BEFORE spending the training budget: the polish would be
        # rejected at its call site anyway (bounding-box quadrature over
        # the dead region)
        raise ValueError("lsq_polish='on' is not supported on masked "
                         "(eval_mask) domains")
    feature_map = net.feature_map_for(problem.feature_kinds,
                                      pad_to=spec.pad_features)
    lb = jnp.asarray(problem.lb, dtype)
    ub = jnp.asarray(problem.ub, dtype)

    key = jax.random.PRNGKey(spec.seed)
    keys = jax.random.split(key, 4 * len(spec.stages))

    X_star, axes, grids_eval = eval_grid(problem, spec.testing_size, dtype)
    exact_star = (
        jnp.asarray(problem.exact(X_star), dtype) if problem.exact else None
    )

    info_width = loss_mod.loss_info_width(len(problem.bc_groups))
    if spec.deriv_loss:
        info_width += 1  # extra eqn_err column for the gradient term
    lw = jnp.asarray(spec.lw, dtype)

    prev_predictor: Optional[Callable] = None
    prev_predictor_lo: Optional[Callable] = None
    prev_params = None
    prev_diag: Optional[Tuple[float, Optional[float]]] = None
    stage_results: List[StageResult] = []
    histories: List[np.ndarray] = []
    chain_specs: List[dict] = []  # per-stage MLPSpec dicts for checkpoint meta
    timer = PhaseTimer()

    for si, st in enumerate(spec.stages):
        stage_no = si + 1
        log(f"===== stage {stage_no}/{len(spec.stages)} =====")
        # --- per-stage equation override (curriculum stages solve an easier
        # PDE on the same domain/BCs; see StageSpec.equation)
        if st.equation:
            compiled_st = pde.compile_pde(st.equation, problem.coords)
            log(f"stage {stage_no}: equation override {st.equation!r}")
        else:
            compiled_st = compiled
        if st.init_from == "prev" and si == 0:
            raise ValueError(
                "StageSpec.init_from='prev' on stage 1 has nothing to warm "
                "from — remove it or reorder the stages")
        warm = st.init_from == "prev" and si > 0
        # --- derive scales from previous diagnostics (software.py:941-956)
        if si == 0:
            scl = st.scl if st.scl is not None else 1.0
            epsil = st.epsil if st.epsil is not None else 1.0
            stage_lw = lw
        elif warm:
            # warm start continues the SAME network: inherit its scales and
            # the user weights — the diff-derived rebalance targets frozen
            # correction chains, not continuation
            scl = st.scl if st.scl is not None else stage_results[-1].scl
            epsil = (st.epsil if st.epsil is not None
                     else stage_results[-1].epsil)
            stage_lw = lw
            log(f"stage {stage_no}: warm start from stage {si} "
                f"(scl={scl:.4g} epsil={epsil:.4g})")
        else:
            r_prev, e_prev = prev_diag
            e_prev = e_prev if e_prev is not None else r_prev
            diff = r_prev / max(e_prev, 1e-30)
            if st.scl is not None:
                scl = st.scl
            else:
                scl = 30.0 if e_prev > 50 else diff
                cap = (spec.grid / 4.0 if spec.auto_scl_cap == "auto"
                       else spec.auto_scl_cap)
                if cap is not None and scl > cap:
                    log(f"stage {stage_no}: derived scl {scl:.4g} exceeds the "
                        f"sampler Nyquist guard — capped to {cap:.4g} "
                        f"(grid {spec.grid}/axis)")
                    scl = float(cap)
            epsil = st.epsil if st.epsil is not None else e_prev
            stage_lw = jnp.asarray(
                [spec.lw[0] / diff, spec.lw[1] / diff**2], dtype
            )
            log(f"stage {stage_no}: scl={scl:.4g} epsil={epsil:.4g} "
                f"diff={diff:.4g}")
        if st.lw is not None:
            # explicit per-stage weight schedule overrides both the user
            # default and the diff-derived rebalance
            stage_lw = jnp.asarray(st.lw, dtype)
            log(f"stage {stage_no}: lw override {tuple(st.lw)}")

        mspec = net.MLPSpec(
            depth=st.depth, width=st.width, act_first=st.act_first,
            act_hidden=st.act_hidden,
            scl=float(scl), epsil=float(epsil),
            fourier_features=st.fourier_features,
            fourier_scale=st.fourier_scale, modified=st.modified,
        )
        params = net.init_params(keys[4 * si], mspec, feature_map, dtype)
        if warm:
            # continuation: same architecture, previous stage's weights.
            # Enforce an exact pytree match up front (a composed previous
            # stage carries a "prev" subtree and is not warm-startable).
            t_new = jax.tree_util.tree_structure(params)
            t_prev = jax.tree_util.tree_structure(prev_params)
            shapes = lambda t: [jnp.shape(x)
                                for x in jax.tree_util.tree_leaves(t)]
            if t_new != t_prev or shapes(params) != shapes(prev_params):
                raise ValueError(
                    f"stage {stage_no}: init_from='prev' requires the same "
                    f"architecture as stage {si} (got {t_new} vs {t_prev})"
                )
            params = jax.tree_util.tree_map(
                lambda x: jnp.asarray(x, dtype), prev_params
            )
            chain_specs[-1] = net.spec_to_dict(mspec)
        else:
            chain_specs.append(net.spec_to_dict(mspec))
        if prev_predictor is None or warm:
            raw_predictor = net.make_predictor(mspec, feature_map, lb, ub)
        else:
            # frozen previous-stage params are threaded as ARGUMENTS (the
            # "prev" subtree, gradients stopped) rather than closure
            # constants — see net.compose_stages
            raw_predictor = net.compose_stages(
                prev_predictor, mspec, feature_map, lb, ub
            )
            params = net.compose_params(params, prev_params)
        # hard-BC ansatz wraps the WHOLE raw chain (later stages correct
        # inside the bubble, keeping the boundary machine-exact)
        predictor = (net.wrap_hard_bc(raw_predictor, *hard_fns)
                     if hard_fns is not None else raw_predictor)
        # parallel REDUCED-PRECISION chain for the Adam phase (same params
        # pytree, different matmul precision — see TrainSpec.adam_precision)
        raw_predictor_lo = predictor_lo = None
        if spec.adam_precision:
            mspec_lo = replace(mspec, precision=spec.adam_precision)
            if prev_predictor_lo is None or warm:
                raw_predictor_lo = net.make_predictor(
                    mspec_lo, feature_map, lb, ub)
            else:
                raw_predictor_lo = net.compose_stages(
                    prev_predictor_lo, mspec_lo, feature_map, lb, ub)
            predictor_lo = (net.wrap_hard_bc(raw_predictor_lo, *hard_fns)
                            if hard_fns is not None else raw_predictor_lo)

        # --- sampler (counts scaled per stage, software.py:959)
        sc = st.sample_scale
        if mesh is None:
            _rc = lambda n: n
        else:
            from tpinn.parallel import round_count

            _rc = lambda n: round_count(max(1, n), mesh)
        cfg = sample.SamplerConfig(
            n_col=_rc(int(spec.n_col * sc)), n_band=_rc(int(spec.n_band * sc)),
            n_adaptive=_rc(int(spec.n_adaptive * sc)),
            n_bd=_rc(int(spec.n_bd * sc)),
            grid=spec.grid,
        )
        sample_fn, grids = sample.sampler_for(
            cfg, problem.bc_groups, problem.lb, problem.ub, dtype
        )
        F0 = jnp.ones_like(grids[0])

        density_fn = make_density_fn(predictor, compiled_st, grids, source_fn,
                                     mask_fn=problem.eval_mask)

        ring_arg = None
        if spec.ring_weight > 0 and problem.eval_mask is not None:
            log(f"stage {stage_no}: ring penalty inert (masked non-box "
                "domain: bounding-box quadrature would integrate the "
                "unconstrained dead region)")
        elif spec.ring_weight > 0:
            from tpinn.core import polish as polish_mod

            setup = polish_mod.ring_penalty_setup(
                compiled_st, problem.lb, problem.ub,
                band=spec.ring_band, max_mode=spec.ring_max_mode)
            if setup is not None:
                z_r, P_r = setup
                ring_arg = {"z": jnp.asarray(z_r, dtype),
                            "P": jnp.asarray(P_r, dtype),
                            "weight": spec.ring_weight}
                log(f"stage {stage_no}: ring penalty on {P_r.shape[1]} "
                    f"band modes (weight {spec.ring_weight:g})")
            else:
                log(f"stage {stage_no}: ring penalty inert "
                    "(no resonance-band modes for this operator)")

        causal_arg = None
        if spec.causal_eps > 0:
            if spec.causal_axis not in problem.coords:
                raise ValueError(
                    f"causal_eps>0 needs coordinate {spec.causal_axis!r} "
                    f"in the problem's coords {problem.coords} — set "
                    "TrainSpec.causal_axis to the evolution coordinate")
            cax = problem.coords.index(spec.causal_axis)
            causal_arg = {"axis": cax, "t0": float(problem.lb[cax]),
                          "t1": float(problem.ub[cax]),
                          "bins": int(spec.causal_bins),
                          "eps": float(spec.causal_eps)}
            log(f"stage {stage_no}: causal weighting on "
                f"{spec.causal_axis!r} ({spec.causal_bins} slabs, "
                f"eps {spec.causal_eps:g}, Adam phase)")

        def build_loss(pred, engine, causal=None):
            return loss_mod.make_loss(pred, compiled_st, source_fn,
                                      deriv_loss=spec.deriv_loss,
                                      engine=engine,
                                      residual_weight_fn=rw_fn,
                                      bc_operators=bc_ops,
                                      ring=ring_arg,
                                      causal=causal)

        loss_fn = build_loss(predictor, spec.engine)

        # Adam-phase loss: reduced-precision chain, different engine,
        # and/or causal weighting (causal is ADAM-ONLY: strong-Wolfe
        # line search needs a self-consistent objective, and by the
        # L-BFGS phase the causal front has swept the domain — the plain
        # residual is then the right target); L-BFGS/eval/polish stay on
        # loss_fn
        adam_engine = spec.adam_engine or spec.engine
        if (predictor_lo is not None or adam_engine != spec.engine
                or causal_arg is not None):
            loss_fn_adam = build_loss(predictor_lo or predictor,
                                      adam_engine, causal=causal_arg)
        else:
            loss_fn_adam = loss_fn
        if mesh is not None:
            from tpinn import parallel

            shared = loss_fn_adam is loss_fn
            loss_fn = parallel.make_parallel_loss(loss_fn, mesh)
            loss_fn_adam = (loss_fn if shared
                            else parallel.make_parallel_loss(loss_fn_adam,
                                                             mesh))
            sample_fn = parallel.sharded_sampler(sample_fn, mesh)
            params = jax.device_put(params, parallel.replicated(mesh))

        key_adam = keys[4 * si + 1]
        key_lbfgs = keys[4 * si + 2]
        data0 = sample_fn(key_adam, F0)
        if mesh is not None:
            from tpinn import parallel

            data0 = parallel.shard_data(data0, mesh)

        if out and problem.dim <= 2:
            limit = [problem.lb[0], problem.ub[0]] + (
                [problem.lb[1], problem.ub[1]] if problem.dim == 2
                else [0.0, 1.0]
            )
            artifacts.write_collocation(
                out / f"collocation_point_{stage_no}.npz",
                U=np.asarray(F0) if problem.dim == 2 else np.asarray(F0).T,
                X_col=np.asarray(
                    data0["x_col"] if problem.dim == 2
                    else jnp.concatenate(
                        [data0["x_col"], jnp.zeros_like(data0["x_col"])], axis=1
                    )
                ),
                limit=limit,
            )

        # --- resume: reload a finished stage's checkpoint and skip training
        resumed = False
        ckpt_path = out / f"params_stage_{stage_no}.npz" if out else None
        if resume and ckpt_path is not None and ckpt_path.exists():
            from tpinn.utils.checkpoint import load_pytree

            try:
                loaded, meta = load_pytree(ckpt_path, params)
                if meta.get("problem") == problem.name:
                    params = loaded
                    resumed = True
                    log(f"stage {stage_no}: resumed from {ckpt_path.name}")
            except Exception as e:
                log(f"stage {stage_no}: checkpoint unusable ({e}); retraining")

        if not resumed:
            # --- normalization reference = loss at init (software.py:738-739)
            with timer.phase(stage_no, "initial_loss"):
                ref = jax.jit(loss_fn)(
                    params, data0, stage_lw, jnp.asarray(1.0, dtype)
                )[1][0]
                log(f"stage {stage_no}: initial loss {float(ref):.4e}")

            # --- Adam phase (single XLA computation)
            adam_cfg = optim.AdamConfig(
                epochs=st.adam_epochs,
                lr=(st.lr if st.lr is not None else spec.lr),
                resample_every=spec.resample_every,
                density_every=spec.density_every,
                plateau_every=spec.plateau_every,
                lr_min=spec.lr_min,
                tail_max=spec.tail_max, log_every=spec.log_every,
                layout=spec.adam_layout,
            )
            adam_log = None
            if log_fn is not None or print_log:
                from tpinn.utils.logging import format_step_line

                def adam_log(step, loss_info):  # noqa: F811
                    log(format_step_line(int(step), np.asarray(loss_info)))

            phase = optim.make_adam_phase(
                loss_fn_adam, sample_fn, density_fn, adam_cfg, info_width,
                adam_log
            )

            # --- mid-stage checkpoint/resume (chunk granularity)
            adam_ckpt = (out / f"adam_state_stage_{stage_no}.npz"
                         if out else None)
            init_phase = None
            if resume and adam_ckpt is not None and adam_ckpt.exists():
                from tpinn.utils.checkpoint import load_phase_state

                try:
                    like = phase.make_state0(key_adam, params, data0, F0, ref)
                    init_phase = load_phase_state(adam_ckpt, like)
                    log(f"stage {stage_no}: resuming Adam mid-stage at step "
                        f"{init_phase[0]}/{st.adam_epochs}")
                except Exception as e:
                    # layout cross-compatibility: a checkpoint written under
                    # the other AdamConfig.layout has a different carry
                    # structure (one raveled leaf vs per-leaf arrays).
                    # Rather than discard hours of a long Adam phase, finish
                    # THIS stage under the checkpoint's own layout — the
                    # trajectories agree to float32 ulps (tests/test_optim).
                    other = ("tree" if spec.adam_layout == "flat"
                             else "flat")
                    try:
                        import dataclasses as _dc

                        cfg_other = _dc.replace(adam_cfg, layout=other)
                        phase_other = optim.make_adam_phase(
                            loss_fn_adam, sample_fn, density_fn, cfg_other,
                            info_width, adam_log
                        )
                        like = phase_other.make_state0(
                            key_adam, params, data0, F0, ref)
                        init_phase = load_phase_state(adam_ckpt, like)
                        phase, adam_cfg = phase_other, cfg_other
                        log(f"stage {stage_no}: checkpoint predates the "
                            f"'{spec.adam_layout}' Adam layout — resuming "
                            f"this stage under layout='{other}' at step "
                            f"{init_phase[0]}/{st.adam_epochs}")
                    except Exception:
                        log(f"stage {stage_no}: mid-stage checkpoint "
                            f"unusable ({e}); restarting the Adam phase")
                        init_phase = None
            ckpt_cb = None
            if adam_ckpt is not None and spec.checkpoint_every > 0:
                from tpinn.utils.checkpoint import save_phase_state

                _last_saved = [init_phase[0] if init_phase else 0]

                def ckpt_cb(done, state, hist):  # noqa: F811
                    if (done - _last_saved[0] >= spec.checkpoint_every
                            or done >= st.adam_epochs):
                        save_phase_state(adam_ckpt, done, state, hist)
                        _last_saved[0] = done

            with timer.phase(stage_no, "adam"):
                res = phase(key_adam, params, data0, F0, stage_lw, ref,
                            ckpt_cb=ckpt_cb, init=init_phase)
                params = res.params
                n_adam = int(res.n_valid)
                hist_adam = np.asarray(res.history)[:n_adam]
            if n_adam:
                log(f"stage {stage_no}: Adam done ({n_adam} steps, "
                    f"final loss {hist_adam[-1, 0]:.4e}, "
                    f"lr {float(res.lr):.2e})")

            # --- pure-XLA L-BFGS (max_iters = epochs/3, as TFP was driven,
            #     software.py:504-508), in `lbfgs_rounds` restarts with a
            #     density refresh + fresh point draw between rounds (the
            #     reference's loop at :755-759)
            rounds = max(1, st.lbfgs_rounds)
            lbfgs_cfg = optim.LBFGSConfig(
                max_iters=max(1, int(st.lbfgs_epochs / 3 / rounds)),
                tolerance=1e-10,
                history=spec.lbfgs_history,
            )

            lbfgs_dtype = dtype
            if spec.lbfgs_dtype is not None:
                lbfgs_dtype = jnp.dtype(spec.lbfgs_dtype)
                if lbfgs_dtype == jnp.float64:
                    jax.config.update("jax_enable_x64", True)
                    log(f"stage {stage_no}: L-BFGS polish in {lbfgs_dtype}")

            cast_to = lambda t, dt: jax.tree_util.tree_map(
                lambda x: x.astype(dt)
                if jnp.issubdtype(x.dtype, jnp.floating) else x, t
            )

            grid_fixed = None
            if st.lbfgs_grid:
                grid_fixed = _grid_data(problem, st.lbfgs_grid, dtype)
                if mesh is not None:
                    from tpinn import parallel

                    grid_fixed = parallel.shard_data(grid_fixed, mesh)
                log(f"stage {stage_no}: L-BFGS on deterministic "
                    f"{st.lbfgs_grid}^{problem.dim} grid "
                    f"({grid_fixed['x_col'].shape[0]} pts)")
                sample_fn_l = None
            elif st.lbfgs_sample_scale != 1.0:
                ls = st.lbfgs_sample_scale * sc
                lcfg = sample.SamplerConfig(
                    n_col=int(spec.n_col * ls), n_band=int(spec.n_band * ls),
                    n_adaptive=int(spec.n_adaptive * ls),
                    n_bd=int(spec.n_bd * ls), grid=spec.grid,
                )
                mk = (sample.make_sampler_1d if problem.dim == 1
                      else sample.make_sampler)
                sample_fn_l, _ = mk(lcfg, problem.bc_groups, problem.lb,
                                    problem.ub, dtype)
            else:
                sample_fn_l = sample_fn

            hist_parts = []
            key_round = key_lbfgs
            for ri in range(rounds):
                with timer.phase(stage_no, "lbfgs"):
                    if grid_fixed is not None:
                        data_lbfgs = grid_fixed
                    else:
                        Fs = jax.jit(density_fn)(params)
                        key_round, sub = jax.random.split(key_round)
                        data_lbfgs = sample_fn_l(sub, Fs)
                    if lbfgs_dtype != dtype:
                        params = cast_to(params, lbfgs_dtype)
                        data_lbfgs = cast_to(data_lbfgs, lbfgs_dtype)
                        stage_lw_l = jnp.asarray(stage_lw, lbfgs_dtype)
                        ref_l = jnp.asarray(ref, lbfgs_dtype)
                    else:
                        stage_lw_l, ref_l = stage_lw, ref

                    params, hist_lbfgs_full, n_rows = (
                        optim.lbfgs_over_pytree(loss_fn, params, data_lbfgs,
                                                stage_lw_l, ref_l, lbfgs_cfg))
                    if lbfgs_dtype != dtype:
                        # return to the training dtype so later stages
                        # (frozen composition, density refresh) keep
                        # uniform carry types; ~1e-7 relative rounding, far
                        # below the optimization floor the f64 polish just
                        # reached
                        params = cast_to(params, dtype)
                    part = np.asarray(hist_lbfgs_full)[: int(n_rows)]
                hist_parts.append(part)
                unit = ("fn evaluations" if spec.lbfgs_history == "evals"
                        else "accepted iterations")
                log(f"stage {stage_no}: L-BFGS round {ri + 1}/{rounds} done "
                    f"({int(n_rows) - 1} {unit}, "
                    f"final loss {part[-1, 0]:.4e})")

                # --- exact last-layer least-squares polish (linear PDEs).
                #     Applied after EVERY round: with lbfgs_rounds > 1 this
                #     is variable projection — L-BFGS moves the hidden
                #     features, the f64 host solve re-lands the output
                #     layer on the convex subproblem's optimum each time.
                if spec.lsq_polish not in ("off", "auto", "on"):
                    raise ValueError(f"lsq_polish={spec.lsq_polish!r}")
                if spec.lsq_polish != "off" and problem.eval_mask is not None:
                    # masked non-box domain: the polish's quadrature spans
                    # the BOUNDING box, and the dead region's residual is
                    # unconstrained — a solve over it would bake garbage
                    if spec.lsq_polish == "on":
                        raise ValueError(
                            "lsq_polish='on' is not supported on masked "
                            "(eval_mask) domains")
                    log(f"stage {stage_no}: lsq_polish skipped "
                        f"(masked non-box domain)")
                elif (spec.lsq_polish != "off" and has_op_bc
                        and problem.hard_bc is None):
                    # the polish's soft-BC rows pin VALUES at z_bd
                    # (polish.last_layer_lsq); operator groups (Neumann/
                    # Robin) would be silently treated as Dirichlet.
                    # Hard-BC runs are unaffected (boundary rows unused).
                    if spec.lsq_polish == "on":
                        raise ValueError(
                            "lsq_polish='on' with operator (Neumann/Robin) "
                            "BC groups needs hard_bc; use lsq_polish='off'")
                    log(f"stage {stage_no}: lsq_polish skipped (operator "
                        f"BC groups pin derivatives, not values)")
                elif spec.lsq_polish != "off":
                    if not compiled_st.is_linear and spec.lsq_polish == "auto":
                        log(f"stage {stage_no}: lsq_polish skipped "
                            f"(equation nonlinear in u)")
                    else:
                        from tpinn.core import polish as polish_mod

                        pdata = (grid_fixed if grid_fixed is not None
                                 else data_lbfgs)
                        cpu = jax.devices("cpu")[0]
                        with (timer.phase(stage_no, "lsq_polish"),
                              jax.default_device(cpu)):
                            new_params, pinfo = polish_mod.last_layer_lsq(
                                predictor, compiled_st,
                                jax.device_put(params, cpu),
                                jax.device_put(pdata, cpu),
                                float(stage_lw[0]), source_fn,
                                residual_weight_fn=rw_fn,
                            )
                            if pinfo["applied"]:
                                # back to the training dtype on the host,
                                # then onto the devices and shardings the
                                # params had before the solve (replicated
                                # over the mesh when there is one)
                                params = _put_like(cast_to(new_params, dtype),
                                                   params)
                        log(f"stage {stage_no}: lsq polish objective "
                            f"{pinfo['pre']:.4e} -> {pinfo['post']:.4e}"
                            f"{'' if pinfo['applied'] else ' (not applied)'}")
            hist_lbfgs = np.concatenate(hist_parts, axis=0)
        else:
            hist_adam = np.zeros((0, info_width), np.float64)
            hist_lbfgs = np.zeros((0, info_width), np.float64)

        # --- evaluation + diagnostics (float64 on host: the metric must be
        # more precise than the model it measures — see eval_stage_f64)
        frozen = _freeze(predictor, params)
        with timer.phase(stage_no, "eval_f64"):
            u_star, f_star, exact64 = eval_stage_f64(
                predictor, params, X_star, compiled_st, source_fn,
                problem.exact)

        # --- spectral error correction (final stage only; see TrainSpec)
        defl = None
        if (si == len(spec.stages) - 1 and spec.deflation != "off"
                and problem.eval_mask is not None):
            # box-spectral correctors integrate the bounding box; the dead
            # region's unconstrained residual would pollute every modal
            # coefficient (recipes for masked domains ship deflation off)
            log("deflation skipped: masked non-box domain")
        elif (si == len(spec.stages) - 1 and spec.deflation != "off"
                and has_op_bc and problem.hard_bc is None):
            # the soft-BC Chebyshev path treats the boundary trace as
            # known Dirichlet data; operator groups don't provide one
            log("deflation skipped: operator (Neumann/Robin) BC groups "
                "have no Dirichlet boundary trace")
        elif (si == len(spec.stages) - 1 and spec.deflation != "off"
                and (compiled_st.is_linear or spec.deflation == "full")):
            # nonlinear operators are admitted on "full" only: the
            # Galerkin path linearizes the residual (one Newton step in
            # the error); "auto" deflation stays linear-only
            from tpinn.core import polish as polish_mod

            with timer.phase(stage_no, "deflation"):
                defl = polish_mod.defect_correction(
                    predictor, params, compiled_st, problem.lb, problem.ub,
                    problem.hard_bc, mode=spec.deflation,
                    source_fn=source_fn, coords=problem.coords,
                    bc_groups=problem.bc_groups,
                )
                if defl is not None:
                    du, df = polish_mod.deflation_fields(
                        defl, compiled_st, np.asarray(X_star))
            if defl is not None:
                if exact64 is not None:
                    # pre-correction accuracy, kept in the correction meta
                    # so every run records its own before/after pair
                    defl["rel_l2_before"] = float(
                        rms(u_star - exact64) / (rms(exact64) + 1e-300))
                u_star = u_star - du
                term = polish_mod.deflation_term(defl)
                raw = frozen
                frozen = lambda z, _raw=raw, _t=term: _raw(z) - _t(z)
                if df is None:
                    # nonlinear: the residual is not affine in the
                    # correction — recompute it from the corrected
                    # predictor instead of adjusting the field
                    pred_corr = (lambda p, z, _p=predictor, _t=term:
                                 _p(p, z) - _t(z))
                    _, f_star, _ = eval_stage_f64(
                        pred_corr, params, X_star, compiled_st,
                        source_fn, None)
                else:
                    f_star = f_star - df
                log(f"stage {stage_no}: spectral correction "
                    f"({defl['kind']}) removed {len(defl['modes'])} modes, "
                    f"|du|_rms {float(np.sqrt((du**2).mean())):.3e}")

        if problem.dim == 1:
            U = u_star[:, 0][None, :]                 # [1, nx]
            F = f_star[:, 0][None, :]
        elif problem.dim == 2:
            ny, nx = int(spec.testing_size[1]), int(spec.testing_size[0])
            U = u_star.reshape(ny, nx)
            F = f_star.reshape(ny, nx)
        else:
            # d >= 3: metrics work on the flat point set; the 11-artifact
            # figure contract is 2-D-only (the reference app is 2-D)
            U = u_star
            F = f_star

        r_rms = float(rms(f_star))
        e_rms = None
        if exact64 is not None:
            e_rms = float(rms(u_star - exact64))
        log(f"stage {stage_no}: residual RMS {r_rms:.4e}"
            + (f", error RMS {e_rms:.4e}" if e_rms is not None else ""))

        hist_stage = np.concatenate([hist_adam, hist_lbfgs], axis=0)
        histories.append(hist_stage)
        hist_cum = np.concatenate(histories, axis=0)

        if out and not resumed:
            if problem.dim <= 2:
                _write_stage_artifacts(
                    out, stage_no, problem, spec, axes, U, F,
                    exact_star, hist_stage if stage_no == 1 else hist_cum,
                )
            else:
                artifacts.write_loss(out / f"loss_{stage_no}.npz",
                                     hist_stage if stage_no == 1
                                     else hist_cum)
            from tpinn.utils.checkpoint import save_pytree

            save_pytree(
                out / f"params_stage_{stage_no}.npz", params,
                meta={"stage": stage_no, "scl": float(scl),
                      "epsil": float(epsil), "problem": problem.name,
                      # full spec chain (stage 1..N) so a serving process
                      # can rebuild the composed predictor — including
                      # act_first/scl/epsil of every stage
                      "chain": chain_specs,
                      "feature_kinds": list(problem.feature_kinds),
                      "lb": list(problem.lb), "ub": list(problem.ub),
                      "hard_bc": (list(problem.hard_bc)
                                  if problem.hard_bc else None),
                      "coords": list(problem.coords),
                      "pad_features": spec.pad_features,
                      # JSON-safe modal correction; serving subtracts
                      # polish.deflation_term(meta["deflation"])
                      "deflation": defl},
            )
            # the stage-level checkpoint supersedes any mid-stage Adam state
            mid = out / f"adam_state_stage_{stage_no}.npz"
            if mid.exists():
                mid.unlink()

        stage_results.append(
            StageResult(
                params=params, predictor_frozen=frozen,
                history=hist_stage, r_rms=r_rms, e_rms=e_rms,
                U=U, F=F, scl=float(scl), epsil=float(epsil),
                n_adam=hist_adam.shape[0],
            )
        )
        prev_predictor = raw_predictor  # composition extends the raw chain
        prev_predictor_lo = raw_predictor_lo
        prev_params = params
        prev_diag = (r_rms, e_rms)

    final = stage_results[-1]
    rel_l2 = None
    if exact64 is not None:
        # u_star/exact64 are the final stage's float64 host evaluation;
        # numpy (not loss_mod.relative_l2/jnp) keeps them f64 — jnp would
        # silently downcast to f32 whenever x64 is off
        if problem.eval_mask is not None:
            # masked non-box domain: measure only where the PDE was posed
            m = np.asarray(problem.eval_mask(X_star), np.float64).reshape(-1)
            du = (u_star.reshape(-1) - exact64.reshape(-1)) * m
            rel_l2 = float(np.linalg.norm(du)
                           / np.linalg.norm(exact64.reshape(-1) * m))
            log(f"final rel-L2 vs analytic (masked, "
                f"{int(m.sum())}/{m.size} pts): {rel_l2:.4e}")
        else:
            rel_l2 = float(np.linalg.norm(u_star - exact64)
                           / np.linalg.norm(exact64))
            log(f"final rel-L2 vs analytic: {rel_l2:.4e}")

    return TrainResult(
        problem=problem, spec=spec, stages=stage_results,
        predict=final.predictor_frozen, rel_l2=rel_l2,
        history=np.concatenate(histories, axis=0),
        phase_walls=timer.rows(),
    )


def _put_like(tree, like):
    """Place each leaf of ``tree`` with the sharding of its ``like`` leaf."""
    return jax.tree.map(lambda a, b: jax.device_put(a, b.sharding), tree, like)


def _freeze(predictor, params):
    from tpinn.core import taylor

    frozen = lambda z: predictor(params, z)
    return taylor.attach_frozen_meta(frozen, predictor, params)


def _grid_data(problem: ProblemSpec, g: int, dtype) -> dict:
    """Deterministic L-BFGS point set: g^dim tensor grid of collocation
    points plus g evenly spaced points per BC group along its box (the
    StageSpec.lbfgs_grid option)."""
    axes = [
        jnp.linspace(problem.lb[i], problem.ub[i], g, dtype=dtype)
        for i in range(problem.dim)
    ]
    if problem.dim == 1:
        x_col = axes[0][:, None]
    elif problem.dim == 2:
        A, B = jnp.meshgrid(axes[0], axes[1])
        x_col = jnp.stack([A.reshape(-1), B.reshape(-1)], axis=1)
    else:
        meshes = jnp.meshgrid(*axes, indexing="ij")
        x_col = jnp.stack([A.reshape(-1) for A in meshes], axis=1)
    x_bd, u_bd = [], []
    for grp in problem.bc_groups:
        lo = jnp.asarray(grp.lo, dtype)
        hi = jnp.asarray(grp.hi, dtype)
        varying = [i for i in range(problem.dim)
                   if float(hi[i]) != float(lo[i])]
        if len(varying) <= 1:
            # point or edge group: g points along the segment
            ts = jnp.linspace(0.0, 1.0, g, dtype=dtype)[:, None]
            pts = lo[None, :] + ts * (hi - lo)[None, :]
        else:
            # face (or higher) group, d >= 3: tensor grid over the varying
            # axes at ~g total points (m per axis)
            m = int(np.ceil(g ** (1.0 / len(varying))))
            axes_v = [jnp.linspace(float(lo[i]), float(hi[i]), m,
                                   dtype=dtype) for i in varying]
            mesh_v = jnp.meshgrid(*axes_v, indexing="ij")
            n_pts = mesh_v[0].size
            cols = []
            for i in range(problem.dim):
                if i in varying:
                    cols.append(mesh_v[varying.index(i)].reshape(-1))
                else:
                    cols.append(jnp.full((n_pts,), float(lo[i]), dtype))
            pts = jnp.stack(cols, axis=1)
        x_bd.append(pts)
        u_bd.append(grp.target(pts))
    return {"x_col": x_col, "x_bd": x_bd, "u_bd": u_bd}


def _residual_with_source(compiled, source_fn, frozen, z):
    f = compiled.residual(frozen, z)
    if source_fn is not None:
        f = f - source_fn(z)
    return f


def _write_stage_artifacts(out, stage_no, problem, spec, axes, U, F,
                           exact_star, hist):
    """The per-stage artifact set (SURVEY §2b.13)."""
    if problem.dim == 1:
        r_vec = np.asarray(axes[0])
        t_vec = np.zeros(1)
        ny, nx = 1, r_vec.shape[0]
    else:
        r_vec = np.asarray(axes[0])
        t_vec = np.asarray(axes[1])
        ny, nx = t_vec.shape[0], r_vec.shape[0]

    artifacts.write_solution_residual(
        out / f"solution_residual_{stage_no}.npz", r_vec, t_vec, U, F, stage_no
    )

    if exact_star is not None:
        U_real = np.asarray(exact_star).reshape(ny, nx)
        artifacts.write_error(
            out / f"error_{stage_no}.npz", r_vec, t_vec, U - U_real
        )

    artifacts.write_loss(out / f"loss_{stage_no}.npz", hist)

    k = hist.shape[1]
    xy_l = hist[:, 3] if k > 3 else np.zeros(hist.shape[0])
    xy_r = hist[:, 4] if k > 4 else np.zeros(hist.shape[0])
    artifacts.write_boundary_loss(
        out / f"boundary_loss_{stage_no}.npz", xy_l, xy_r
    )

    # frequency spectrum of the STAGE-1 residual field (software.py:905-936)
    if stage_no == 1:
        mag = np.abs(np.fft.fftshift(np.fft.fft2(F)))
        dx = r_vec[1] - r_vec[0] if nx > 1 else 1.0
        dt = t_vec[1] - t_vec[0] if ny > 1 else 1.0
        freq_x = np.fft.fftshift(np.fft.fftfreq(nx, d=dx))
        freq_t = np.fft.fftshift(np.fft.fftfreq(ny, d=dt))
        artifacts.write_spectrum(
            out / "frequency_spectrum.npz", freq_x, freq_t, np.log1p(mag)
        )


# ---------------------------------------------------------------------------
# Reference-schema entry point (drop-in for software.py:626-638)
# ---------------------------------------------------------------------------


# Whitelisted "advanced options" the UI may pass to run_pinn_training —
# the single source of truth shared with the controller's validation
# (tpinn.app.controller.TrainingRequest).  Values are either a tuple of
# allowed choices or a coercion type (int = must be integral).
UI_OPTION_SPEC = {
    "deflation": ("off", "auto", "full"),
    "lsq_polish": ("off", "auto", "on"),
    "adam_precision": ("highest", "high", "default"),
    "adam_engine": loss_mod.ENGINES,
    "lr_min": float,
    "lbfgs_rounds": int,
    "lbfgs_grid": int,
    "ring_weight": float,
    # causal residual weighting (TrainSpec.causal_eps/_bins) — evolution
    # presets only; the axis stays the default "t"
    "causal_eps": float,
    "causal_bins": int,
    # time-marching (core.march.run_time_marching): N sequential windows
    # along the SECOND coordinate (the UI's y/t axis); 0 = off
    "march": int,
    # UI inverse mode (round 4, tpinn.core.inverse): declare unknown
    # equation coefficients "name=init[,name=init…]"; observations are
    # synthesized from the oracle preset's analytic solution
    "inverse_params": "coef_list",
    "n_obs": int,
    "obs_noise": float,
    "oracle": "preset_name",
}
_UI_STAGE_OPTIONS = frozenset({"lbfgs_rounds", "lbfgs_grid"})
_UI_INVERSE_OPTIONS = frozenset({"inverse_params", "n_obs", "obs_noise",
                                 "oracle"})


def parse_coef_list(s: str):
    """'lam=0.5,k=1' → (('lam', 'k'), (0.5, 1.0)); '' → ((), ())."""
    names, inits = [], []
    for part in str(s).split(","):
        part = part.strip()
        if not part:
            continue
        if "=" not in part:
            raise ValueError(
                f"inverse_params entries must be NAME=INIT, got {part!r}")
        n, v = part.split("=", 1)
        n = n.strip()
        if not n.isidentifier():
            raise ValueError(f"bad coefficient name {n!r}")
        names.append(n)
        inits.append(float(v))
    return tuple(names), tuple(inits)


def coerce_ui_option(key: str, value):
    """Validate + coerce one UI option against UI_OPTION_SPEC.

    Raises KeyError for unknown keys and ValueError for bad values (a
    non-integral number for an int option, a value outside the choices),
    so callers can validate BEFORE the training thread starts instead of
    crashing mid-run."""
    spec = UI_OPTION_SPEC[key]
    if isinstance(spec, tuple):
        if value not in spec:
            raise ValueError(f"option {key} must be one of {spec}, "
                             f"got {value!r}")
        return value
    if spec == "coef_list":
        parse_coef_list(value)  # raises ValueError on bad format
        return str(value)
    if spec == "preset_name":
        if not value:
            return ""
        from tpinn import problems as _problems

        if str(value) not in _problems.PRESETS:
            raise ValueError(f"option {key}: unknown preset {value!r}")
        return str(value)
    try:
        f = float(value)
    except (TypeError, ValueError):
        raise ValueError(f"option {key} must be numeric, "
                         f"got {value!r}") from None
    if spec is int:
        i = int(f)
        if f != i:
            raise ValueError(f"option {key} must be an integer, "
                             f"got {value!r}")
        return i
    return f


def run_pinn_training(
    equation: str,
    boundary: dict,
    domain: dict,
    scl: float,
    epsil: float,
    sample_points: dict,
    network_size: dict,
    testing_size: dict,
    epochs: dict,
    equation_weight: dict,
    output_dir: str,
    coords: Optional[Tuple[str, ...]] = None,
    feature_kinds: Optional[Tuple[str, ...]] = None,
    exact: Optional[Callable] = "auto",
    log_fn: Optional[Callable] = None,
    dtype: str = "float32",
    options: Optional[dict] = None,
) -> TrainResult:
    """Drop-in for the reference's public entry (software.py:626-638):
    same kwarg schema (the Dash callback maps 1:1, training.py:93-105) —
    except the equation string is actually *used* here.

    Coordinates default to inference from the equation (pde.infer_coords):
    polar r/t gets the reference's hard periodic-θ embedding, cartesian
    x/y (or x/t) plain min-max features.  ``exact="auto"`` installs the
    reference's analytic oracle u = log(r)/log(0.1) (software.py:815) only
    when the equation is its polar Laplacian — the reference writes that
    error field unconditionally because it ignores the equation entirely.
    """
    if coords is None:
        coords = pde.infer_coords(equation)
        if len(coords) == 1:
            coords = ("x", "t")  # UI always supplies a 2-D domain
    if feature_kinds is None:
        feature_kinds = tuple(
            net.PERIODIC if c == "t" and coords[0] == "r" else net.MINMAX
            for c in coords
        )
    if exact == "auto":
        canon = equation.replace(" ", "")
        if coords == ("r", "t") and canon in (
            "u_rr+1/r*u_r+1/r**2*u_tt", "u_rr+u_r/r+u_tt/r**2",
        ):
            exact = lambda z: jnp.log(z[:, 0:1]) / jnp.log(0.1)
        else:
            exact = None

    n_groups = len(boundary) // 5
    groups = []
    for i in range(1, n_groups + 1):
        raw_u = boundary[f"bd_u{i}"]
        try:
            value, value_fn, value_expr = float(raw_u), None, None
        except (TypeError, ValueError):
            # expression-valued BC (e.g. the heat IC "sin(pi*x)") — a
            # capability the reference's constant-only inputs lack
            value = 0.0
            value_expr = str(raw_u)
            value_fn = pde.compile_coord_expr(value_expr, coords)
        groups.append(
            sample.BCGroup(
                lo=(boundary[f"bd_x{i}_min"], boundary[f"bd_y{i}_min"]),
                hi=(boundary[f"bd_x{i}_max"], boundary[f"bd_y{i}_max"]),
                value=value, value_fn=value_fn, value_expr=value_expr,
            )
        )

    if exact == "annulus":  # legacy explicit oracle selector
        exact = lambda z: jnp.log(z[:, 0:1]) / jnp.log(0.1)

    problem = ProblemSpec(
        name="ui", equation=equation, coords=coords,
        lb=(domain["x_min"], domain["y_min"]),
        ub=(domain["x_max"], domain["y_max"]),
        bc_groups=tuple(groups), feature_kinds=feature_kinds, exact=exact,
    )

    # correct depth/width semantics (the reference swaps them, SURVEY §2b.14)
    depth = int(network_size["width"])   # UI "width" is hidden-layer count
    width = int(network_size["depth"])   # UI "depth" is units per layer
    spec = TrainSpec(
        n_col=int(sample_points["n_col"]), n_band=int(sample_points["n_bd"]),
        n_adaptive=int(sample_points["n_add"]), n_bd=100,
        testing_size=(int(testing_size["x"]), int(testing_size["y"])),
        lw=(float(equation_weight["f"]), float(equation_weight["df"])),
        dtype=dtype,
        # minimum embedding width 3, as most shipped recipes set it (model
        # class unchanged; see TrainSpec.pad_features)
        pad_features=3,
        # reference cadence: one loss row per L-BFGS function EVALUATION
        # (software.py:485-488), so the UI loss curves carry the same
        # number of points per quasi-Newton phase as the reference's
        lbfgs_history="evals",
    ).with_default_stages(
        depth=depth, width=width,
        adam=int(epochs["adam"]), lbfgs=int(epochs["lbfgs"]),
    )
    # stage-1 scl/epsil from the UI
    s1 = replace(spec.stages[0], scl=float(scl), epsil=float(epsil))
    spec = replace(spec, stages=(s1, spec.stages[1]))

    # advanced options (round-3 UI extension beyond the reference schema):
    # whitelisted TrainSpec / per-stage overrides, coerced through the
    # SHARED registry (UI_OPTION_SPEC) the controller validates against
    inv_opts = {}
    march_n = 0
    if options:
        coerced = {k: coerce_ui_option(k, v) for k, v in options.items()
                   if k in UI_OPTION_SPEC}
        inv_opts = {k: coerced.pop(k) for k in list(coerced)
                    if k in _UI_INVERSE_OPTIONS}
        march_n = int(coerced.pop("march", 0) or 0)
        spec_keys = {k: v for k, v in coerced.items()
                     if k not in _UI_STAGE_OPTIONS}
        if spec_keys:
            spec = replace(spec, **spec_keys)
        st_keys = {k: v for k, v in coerced.items()
                   if k in _UI_STAGE_OPTIONS}
        if st_keys:
            spec = replace(spec, stages=tuple(
                replace(s, **st_keys) for s in spec.stages))

    if march_n and inv_opts.get("inverse_params"):
        raise ValueError("march has no inverse-path implementation — "
                         "drop one of options.march / inverse_params")
    if march_n:
        # UI time-marching: windows along the second (y/t) coordinate;
        # the composite's artifact set lands at output_dir's top level
        from tpinn.core.march import run_time_marching

        mres = run_time_marching(problem, spec, march_n,
                                 axis=problem.coords[1],
                                 output_dir=output_dir, log_fn=log_fn,
                                 print_log=log_fn is None)
        return TrainResult(
            problem=problem, spec=spec, stages=[],
            predict=mres.predict, rel_l2=mres.rel_l2,
            history=np.concatenate([r.history for r in mres.windows],
                                   axis=0),
        )

    if inv_opts.get("inverse_params"):
        # UI inverse mode: identify the declared unknown coefficients from
        # observations synthesized from an analytic oracle — the problem's
        # own (polar-Laplace autodetect above) or a named preset's
        from tpinn.core.inverse import InverseSpec, run_inverse

        names, inits = parse_coef_list(inv_opts["inverse_params"])
        if problem.exact is None and inv_opts.get("oracle"):
            from tpinn import problems as _problems

            oracle = _problems.get_problem(inv_opts["oracle"])
            if oracle.dim != problem.dim:
                raise ValueError(
                    f"oracle preset {inv_opts['oracle']!r} is "
                    f"{oracle.dim}-D but the problem is {problem.dim}-D")
            problem = replace(problem, exact=oracle.exact)
        if problem.exact is None:
            raise ValueError(
                "inverse mode needs an analytic oracle to synthesize "
                "observations from — pick a preset (options.oracle) or use "
                "tpinn.core.inverse.run_inverse with observations=")
        inv = InverseSpec(
            params=names, init=inits,
            n_obs=int(inv_opts.get("n_obs") or 200),
            obs_noise=float(inv_opts.get("obs_noise") or 0.0),
        )
        dropped = [k for k in ("lsq_polish", "deflation")
                   if getattr(spec, k, "off") != "off"]
        if spec.ring_weight > 0:
            dropped.append("ring_weight")
        if spec.causal_eps > 0:
            dropped.append("causal_eps")
        if dropped:
            msg = ("inverse mode: option(s) "
                   f"{', '.join(dropped)} have no inverse-path "
                   "implementation and are ignored")
            (log_fn or (lambda m: print(m, file=sys.stderr)))(msg)
        # single stage: the coefficient must stay live through every phase
        # (no frozen-correction chain in inverse mode)
        single = replace(spec, stages=spec.stages[:1])
        res = run_inverse(problem, inv, single, log_fn=log_fn,
                          print_log=log_fn is None, output_dir=output_dir)
        return TrainResult(
            problem=problem, spec=single, stages=[],
            predict=res.predict, rel_l2=res.rel_l2, history=res.history,
        )

    return run_training(problem, spec, output_dir=output_dir, log_fn=log_fn,
                        print_log=log_fn is None)


if __name__ == "__main__":
    # Runnable smoke config mirroring the reference's __main__ demo
    # (software.py:1142-1201): annulus r∈[0.1,1], Dirichlet u(0.1)=1,
    # u(1)=0, tiny epoch counts — a manual integration smoke test.
    run_pinn_training(
        equation="u_rr + 1/r*u_r + 1/r**2*u_tt",
        boundary={
            "bd_x1_min": 0.1, "bd_x1_max": 0.1, "bd_y1_min": 0,
            "bd_y1_max": 1, "bd_u1": 1,
            "bd_x2_min": 1, "bd_x2_max": 1, "bd_y2_min": 0,
            "bd_y2_max": 1, "bd_u2": 0,
        },
        domain={"x_min": 0.1, "x_max": 1, "y_min": 0, "y_max": 1},
        scl=1, epsil=1,
        sample_points={"n_col": 3000, "n_bd": 1000, "n_add": 1000},
        network_size={"depth": 60, "width": 6},
        testing_size={"x": 111, "y": 111},
        epochs={"adam": 1000, "lbfgs": 1000},
        equation_weight={"f": 0.05, "df": 0},
        output_dir="data/test",
    )
