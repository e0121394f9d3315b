"""Time-marching (sequential-window) training for evolution problems.

The reference trains ONE network over the whole space-time box
(software.py:207-218, 626-1139) — which is exactly what fails on stiff /
advective evolution problems: the residual is near-minimized by solutions
that are wrong at late times (plain PINN training "solves the PDE
backwards in time"; Krishnapriyan et al. 2021 document the collapse and
show sequence-to-sequence time windowing is the reliable fix).  This
module adds that fix as a first-class driver: split the causal axis into
W windows, train window k on its own slab [t_k, t_{k+1}] with the
previous window's terminal state as its initial condition, and serve the
piecewise-in-time composite.

Relation to the in-loss mitigation: ``TrainSpec.causal_eps`` (soft
advancing-front weighting inside ONE net, tpinn/core/loss.py) reshapes
the gradient but keeps a single global optimization; marching makes the
causality STRUCTURAL — each window is a short-horizon problem that plain
training solves well, and the handoff is data, not a weight schedule.
The two compose: a causal front can run inside each window.

Design notes: each window is an ordinary ``run_training`` (scanned
Adam automaton + pure-XLA L-BFGS — everything rides the existing jit
graphs at the window's static shapes); the IC handoff enters the loss as
a ``BCGroup.value_fn`` whose body is the previous window's frozen
predictor, so it traces into the window's graph as one extra forward
pass (no host callbacks, no data staging).  The composite predictor
evaluates ALL windows at ALL points and selects with a one-hot matmul —
a static-shape [W, N] contraction instead of a gather, the same pattern
the causal loss and the patch blender use.

Window nets are intentionally COLD-started: each window's minmax feature
map renormalizes t to its own slab, so the previous window's weights
represent a *different* function of the network inputs — the state is
carried by the IC data, as in the seq2seq literature.
"""

from __future__ import annotations

import json
from dataclasses import dataclass, replace
from pathlib import Path
from typing import Callable, List, Optional

import jax
import jax.numpy as jnp
import numpy as np

from tpinn.core import sample
from tpinn.core.train import (ProblemSpec, TrainResult, TrainSpec,
                              eval_grid, resolve_testing_size, run_training)

Array = jax.Array


@dataclass
class MarchResult:
    problem: ProblemSpec
    edges: np.ndarray                       # [W+1] window boundaries
    axis_index: int
    windows: List[TrainResult]
    predict: Callable[[Array], Array]       # piecewise composite u(z)
    rel_l2: Optional[float]                 # vs analytic, FULL domain


def axis_derivative(f: Callable, axis_index: int) -> Callable:
    """∂f/∂z[axis] as a jittable callable (one jvp along the axis tangent)
    — the velocity handoff for second-order-in-time marching."""
    def df(z):
        tang = jnp.zeros_like(z).at[:, axis_index].set(1.0)
        return jax.jvp(f, (z,), (tang,))[1]

    return df


def window_problem(problem: ProblemSpec, axis_index: int,
                   t_lo: float, t_hi: float, k: int,
                   prev_predict: Optional[Callable],
                   handoff_velocity: bool = False) -> ProblemSpec:
    """The slab-k sub-problem: domain clipped to [t_lo, t_hi] along the
    causal axis, BC groups intersected with the slab, and (for k > 0) the
    previous window's terminal state appended as the slab's IC.

    ``handoff_velocity``: also pin ∂u/∂t at the handoff plane to the
    previous window's time derivative (an operator BC group) — required
    for equations that are SECOND order along the march axis (wave): the
    Cauchy data of a u_tt problem is (u, u_t), and handing off only u
    leaves each window free to pick any velocity."""
    lb = list(problem.lb)
    ub = list(problem.ub)
    lb[axis_index], ub[axis_index] = float(t_lo), float(t_hi)

    groups = []
    for g in problem.bc_groups:
        glo, ghi = g.lo[axis_index], g.hi[axis_index]
        # drop groups living outside the slab (e.g. the t=0 IC for k>0);
        # boundary-touching groups (IC at t_lo == slab start) belong to
        # the LOWER slab only when they are handoff planes — the original
        # t=0 IC stays with window 0 by the strict upper test
        if ghi < t_lo or glo > t_hi or (k > 0 and ghi <= t_lo):
            continue
        lo = list(g.lo)
        hi = list(g.hi)
        lo[axis_index] = max(glo, t_lo)
        hi[axis_index] = min(ghi, t_hi)
        groups.append(replace(g, lo=tuple(lo), hi=tuple(hi)))
    if k > 0:
        if prev_predict is None:
            raise ValueError("window k>0 needs the previous predictor")
        lo = list(problem.lb)
        hi = list(problem.ub)
        lo[axis_index] = hi[axis_index] = float(t_lo)
        groups.append(sample.BCGroup(
            lo=tuple(lo), hi=tuple(hi), value_fn=prev_predict,
            value_expr=f"<window {k} terminal state>"))
        if handoff_velocity:
            axis = problem.coords[axis_index]
            groups.append(sample.BCGroup(
                lo=tuple(lo), hi=tuple(hi),
                value_fn=axis_derivative(prev_predict, axis_index),
                value_expr=f"<window {k} terminal velocity>",
                operator=f"u_{axis}"))

    return replace(
        problem,
        name=f"{problem.name}_w{k + 1}",
        lb=tuple(lb), ub=tuple(ub), bc_groups=tuple(groups),
    )


def make_march_predictor(predicts, edges, axis_index: int):
    """Piecewise-in-t composite: every window evaluates at every point,
    a one-hot over ``searchsorted`` selects — static shapes, no gather.
    Gradients w.r.t. coordinates flow through the selected window's
    forward only (the one-hot is piecewise-constant), so residuals of
    the composite are exact away from the (measure-zero) edges."""
    inner = jnp.asarray(np.asarray(edges)[1:-1], dtype=jnp.float32)
    preds = tuple(predicts)

    def predict(z):
        t = z[:, axis_index]
        idx = jnp.searchsorted(inner, t, side="right")
        oh = jax.nn.one_hot(idx, len(preds), dtype=z.dtype)   # [N, W]
        vals = jnp.stack([f(z) for f in preds])               # [W, N, 1]
        return jnp.einsum("wnk,nw->nk", vals, oh)

    return predict


def run_time_marching(
    problem: ProblemSpec,
    spec: TrainSpec,
    n_windows: int,
    axis: str = "t",
    output_dir: Optional[str] = None,
    log_fn: Optional[Callable] = None,
    print_log: bool = False,
    resume: bool = False,
    mesh=None,
) -> MarchResult:
    """Train ``n_windows`` sequential slabs along coordinate ``axis`` and
    compose the piecewise predictor.  Each window is a full
    ``run_training`` of ``spec`` (total budget = n_windows x spec), so
    everything the single-net path has — multi-stage chains, causal
    weighting inside the window (slab ranges follow the clipped
    sub-domain automatically), checkpoint/resume, CPU fallback, and
    points-DP sharding over ``mesh`` — works per window unchanged.  ``resume=True`` short-circuits finished
    windows from their stage checkpoints (run_training's own resume).

    Writes ``march.json`` + per-window checkpoint dirs under
    ``output_dir``; tpinn.app.serve rebuilds the composite from it."""
    if n_windows < 2:
        raise ValueError("time marching needs n_windows >= 2 "
                         "(1 window IS plain training)")
    if axis not in problem.coords:
        raise ValueError(
            f"march axis {axis!r} is not a coordinate of "
            f"{problem.name} (coords={problem.coords})")
    if problem.hard_bc is not None:
        raise ValueError(
            "time marching poses the IC handoff softly; hard_bc "
            "expressions cannot represent a learned terminal state — "
            "drop hard_bc (window BCs are weighted data terms)")
    ai = problem.coords.index(axis)
    edges = np.linspace(problem.lb[ai], problem.ub[ai], n_windows + 1)

    # equations second-order along the march axis (wave) hand off the
    # full Cauchy data (u, u_t); first-order ones (heat/burgers/
    # convection/allen-cahn) hand off u only
    from tpinn.core import pde
    compiled = pde.compile_pde(problem.equation, problem.coords)
    axis_order = max((ix.count(ai) for ix in compiled.indices), default=0)
    if axis_order > 2:
        raise ValueError(
            f"time marching supports order <= 2 along the march axis; "
            f"{problem.name} is order {axis_order} in {axis!r}")
    handoff_velocity = axis_order == 2

    def log(msg):
        if log_fn is not None:
            log_fn(msg)
        if print_log:
            print(msg, flush=True)

    out = Path(output_dir) if output_dir else None
    if out:
        out.mkdir(parents=True, exist_ok=True)

    results: List[TrainResult] = []
    predicts = []
    prev_predict = None
    for k in range(n_windows):
        sub = window_problem(problem, ai, edges[k], edges[k + 1], k,
                             prev_predict,
                             handoff_velocity=handoff_velocity)
        log(f"march window {k + 1}/{n_windows}: {axis} in "
            f"[{edges[k]:g}, {edges[k + 1]:g}], "
            f"{len(sub.bc_groups)} BC groups")
        res = run_training(
            sub, spec,
            output_dir=str(out / f"window_{k + 1}") if out else None,
            log_fn=log_fn, print_log=print_log, resume=resume, mesh=mesh,
        )
        results.append(res)
        predicts.append(res.predict)
        prev_predict = res.predict

    predict = make_march_predictor(predicts, edges, ai)

    if out and problem.dim <= 2:
        # the COMPOSITE's 11-artifact figure set at the top level (the
        # per-window run_trainings wrote their own inside window_k/) so
        # the result tabs render a march run exactly like a plain one
        from tpinn.core.train import (_residual_with_source,
                                      _write_stage_artifacts)

        tsize = resolve_testing_size(problem, spec.testing_size, log,
                                     "march: ")
        X_star, axes, _ = eval_grid(problem, tsize, jnp.float32)
        ny, nx = ((1, tsize[0]) if problem.dim == 1
                  else (tsize[1], tsize[0]))
        U = np.asarray(predict(X_star)).reshape(ny, nx)
        src = (pde.compile_coord_expr(problem.source, problem.coords)
               if problem.source else None)
        F = np.asarray(
            _residual_with_source(compiled, src, predict, X_star)
        ).reshape(ny, nx)
        exact_star = (np.asarray(problem.exact(X_star))
                      if problem.exact is not None else None)
        hist = np.concatenate([r.history for r in results], axis=0)
        _write_stage_artifacts(out, 1, problem, spec, axes, U, F,
                               exact_star, hist)
        # composite collocation tab: every window's sampled points over
        # the composite |residual| density (each window's own artifact
        # lives in window_k/; the top level needs one so the result tabs
        # render a march run exactly like a plain one)
        from tpinn.utils import artifacts

        cols = []
        for k in range(n_windows):
            p = out / f"window_{k + 1}" / "collocation_point_1.npz"
            if p.exists():
                with np.load(p) as d:
                    cols.append(np.asarray(d["X_col"]))
        if cols:
            limit = [problem.lb[0], problem.ub[0]] + (
                [problem.lb[1], problem.ub[1]] if problem.dim == 2
                else [0.0, 1.0])
            artifacts.write_collocation(
                out / "collocation_point_1.npz",
                U=np.abs(F), X_col=np.concatenate(cols, axis=0),
                limit=limit)

    # full-domain rel-L2 vs the analytic oracle (each window's own
    # rel_l2 is slab-local; the composite is the number that matters)
    rel_l2 = None
    if problem.exact is not None:
        tsize = resolve_testing_size(problem, spec.testing_size, log,
                                     "march: ")
        X_star, _, _ = eval_grid(problem, tsize, jnp.float32)
        u = np.asarray(predict(X_star), np.float64).reshape(-1)
        ue = np.asarray(problem.exact(X_star), np.float64).reshape(-1)
        if problem.eval_mask is not None:
            m = np.asarray(problem.eval_mask(X_star), np.float64).reshape(-1)
            u, ue = u * m, ue * m
        rel_l2 = float(np.linalg.norm(u - ue) / np.linalg.norm(ue))
        log(f"march composite rel-L2 vs analytic: {rel_l2:.4e}")

    if out:
        record = {
            "problem": problem.name,
            "axis": axis,
            "axis_index": ai,
            "edges": [float(v) for v in edges],
            "windows": [
                f"window_{k + 1}/params_stage_{len(r.stages)}.npz"
                for k, r in enumerate(results)
            ],
            "rel_l2": rel_l2,
            "rel_l2_windows": [r.rel_l2 for r in results],
        }
        tmp = out / "march.json.tmp"
        tmp.write_text(json.dumps(record, indent=1))
        tmp.rename(out / "march.json")

    return MarchResult(
        problem=problem, edges=edges, axis_index=ai, windows=results,
        predict=predict, rel_l2=rel_l2,
    )
