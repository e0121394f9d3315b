"""Ensemble training: K seed-varied members, one combined solution.

Motivation (measured in the earlier accuracy campaign): after the
L-BFGS/polish phases and the spectral defect correction, the remaining
error of a converged PINN is broadband *net noise* — a high-frequency
field outside every correction basis tried (the helmholtz hS postmortem).  Training noise decorrelates
across initialization seeds, so the convex combination of K independently
trained solutions cancels ~sqrt(K) of it — a fundamentally different lever
from more steps (hP measured: 2.5x budget REGRESSES) or more basis columns
(the held-out guard rejects them).

Device shape: members are trained SEQUENTIALLY here — every member reuses the
previous member's compiled graphs (identical shapes, jit cache), so member
k costs only run time, no compile time.  On a multi-chip mesh the same
members ride the `ensemble` mesh axis instead
(tpinn.parallel.ensemble_init/make_ensemble_loss, tested on the virtual
8-device mesh) — this module is the single-chip/product path that shares
its combination + correction logic.

Combination weights:
- "uniform": 1/K.
- "lsq" (default): the convex combination minimizing the PDE residual norm
  on a quadrature grid — ORACLE-FREE (usable in production, where no
  analytic solution exists) and exact for linear operators, where the
  residual of the mean is the mean of residuals.  Nonlinear operators fall
  back to uniform.

After combining, the spectral defect correction (``spec.deflation``) runs
once on the MEAN predictor — the correction composes linearly, so
correcting the mean equals the mean of corrections for linear operators,
at 1/K the host cost.

The reference has no ensemble concept (single net, single seed,
software.py:1142-1201); this is a tpinn-native capability.
"""

from __future__ import annotations

import json
from dataclasses import dataclass, replace
from pathlib import Path
from typing import Callable, List, Optional, Sequence

import numpy as np

from tpinn.core import pde
from tpinn.core.train import (ProblemSpec, TrainResult, TrainSpec,
                              eval_grid, run_training)


@dataclass
class EnsembleResult:
    members: List[TrainResult]
    weights: np.ndarray                     # convex combination, sums to 1
    rel_l2_members: List[Optional[float]]
    err_correlation: Optional[List[List[float]]]  # only with an oracle
    rel_l2_mean_raw: Optional[float]        # before the defect correction
    rel_l2: Optional[float]                 # the ensemble's final accuracy
    deflation: Optional[dict]
    predict: Callable                        # z -> combined (corrected) u


def _lsq_weights(frozen, compiled, source_fn, problem, n_grid=121):
    """Convex weights minimizing ||sum_i w_i r_i|| on a quadrature grid —
    no oracle used.  min-norm solve of the constrained LSQ (sum w = 1,
    eliminated through the last weight)."""
    from tpinn.core.polish import _host_residual_f64

    dim = problem.dim
    axes = [np.linspace(problem.lb[j], problem.ub[j], n_grid)
            for j in range(dim)]
    mesh = np.meshgrid(*axes, indexing="ij")
    z = np.stack([g.ravel() for g in mesh], axis=1)
    R = np.concatenate(
        [_host_residual_f64(lambda _p, zz, _f=f: _f(zz), None, compiled,
                            source_fn, z)
         for f in frozen], axis=1)                       # [n, K]
    A = R[:, :-1] - R[:, -1:]
    w_head, *_ = np.linalg.lstsq(A, -R[:, -1], rcond=None)
    w = np.append(w_head, 1.0 - w_head.sum())
    if not np.all(np.isfinite(w)) or np.abs(w).max() > 3.0:
        # ill-conditioned (near-identical members): extrapolating weights
        # amplify noise instead of cancelling it — fall back to uniform
        return np.full(len(frozen), 1.0 / len(frozen)), "uniform-fallback"
    return w, "lsq"


def run_ensemble_training(
    problem: ProblemSpec,
    spec: TrainSpec,
    n_members: int = 4,
    seeds: Optional[Sequence[int]] = None,
    output_dir: Optional[str] = None,
    log_fn: Optional[Callable] = None,
    print_log: bool = False,
    resume: bool = False,
    mesh=None,
    weights: str = "lsq",
) -> EnsembleResult:
    """Train ``n_members`` seed-varied copies of ``spec``, combine them by
    convex weights, and defect-correct the combination.

    ``resume=True`` passes through to each member (a killed campaign
    continues from the last finished member/stage).  Member checkpoints
    land in ``output_dir/member_<i>/``; the combination record in
    ``output_dir/ensemble.json`` is loadable by ``tpinn.app.serve``."""
    if seeds is None:
        seeds = [spec.seed + 1000 * i for i in range(n_members)]
    if len(seeds) != n_members:
        raise ValueError(f"{len(seeds)} seeds for n_members={n_members}")

    def log(msg):
        if log_fn is not None:
            log_fn(msg)
        if print_log:
            import sys
            print(msg, file=sys.stderr)

    out = Path(output_dir) if output_dir else None

    # members train WITHOUT the final correction: it applies once, to the
    # combined predictor (linearity; see module docstring)
    member_spec = replace(spec, deflation="off")
    members: List[TrainResult] = []
    for i, seed in enumerate(seeds):
        log(f"=== ensemble member {i + 1}/{n_members} (seed {seed}) ===")
        mdir = str(out / f"member_{i}") if out else None
        members.append(run_training(
            problem, replace(member_spec, seed=int(seed)),
            output_dir=mdir, log_fn=log_fn, print_log=print_log,
            resume=resume, mesh=mesh))

    compiled = pde.compile_pde(problem.equation, problem.coords)
    source_fn = (pde.compile_coord_expr(problem.source, problem.coords)
                 if problem.source else None)
    frozen = [m.predict for m in members]

    how = weights
    if weights == "lsq" and compiled.is_linear and n_members > 1:
        w, how = _lsq_weights(frozen, compiled, source_fn, problem)
    else:
        w = np.full(n_members, 1.0 / n_members)
        how = "uniform"
    log(f"ensemble weights ({how}): {np.round(w, 4).tolist()}")

    # combined fields on the shared eval grid (StageResult.U is the f64
    # final-stage evaluation each member already computed)
    import jax.numpy as jnp

    X_star, _, _ = eval_grid(problem, spec.testing_size, jnp.float32)
    z_star = np.asarray(X_star, np.float64)
    fields = [m.stages[-1].U.reshape(-1, 1).astype(np.float64)
              for m in members]
    mean_f = sum(wi * f for wi, f in zip(w, fields))

    exact = corr = rel_mean = None
    rels = [m.rel_l2 for m in members]
    if problem.exact is not None:
        from tpinn.utils.x64 import force_x64

        with force_x64():
            exact = np.asarray(problem.exact(jnp.asarray(z_star,
                                                         jnp.float64)))
        errs = [f - exact for f in fields]
        K = n_members
        corr = np.ones((K, K))
        for i in range(K):
            for j in range(i + 1, K):
                c = float(np.sum(errs[i] * errs[j])
                          / (np.linalg.norm(errs[i])
                             * np.linalg.norm(errs[j]) + 1e-300))
                corr[i, j] = corr[j, i] = c
        nrm = float(np.linalg.norm(exact)) + 1e-300
        rel_mean = float(np.linalg.norm(mean_f - exact) / nrm)
        log(f"ensemble mean rel-L2 {rel_mean:.4e} "
            f"(best member {min(r for r in rels if r is not None):.4e}; "
            f"offdiag corr {corr[np.triu_indices(K, 1)].round(3).tolist()})")

    def predict_mean(z):
        acc = None
        for wi, f in zip(w, frozen):
            v = float(wi) * f(z)
            acc = v if acc is None else acc + v
        return acc

    predict = predict_mean
    defl = None
    rel_final = rel_mean
    if spec.deflation != "off" and (compiled.is_linear
                                    or spec.deflation == "full"):
        from tpinn.core import polish

        defl = polish.defect_correction(
            lambda _p, z: predict_mean(z), None, compiled,
            problem.lb, problem.ub, problem.hard_bc, mode=spec.deflation,
            source_fn=source_fn, coords=problem.coords,
            bc_groups=problem.bc_groups)
        if defl is not None:
            term = polish.deflation_term(defl)
            predict = lambda z: predict_mean(z) - term(z)
            du, _ = polish.deflation_fields(defl, compiled, z_star)
            if exact is not None:
                defl["rel_l2_before"] = rel_mean
                rel_final = float(np.linalg.norm(mean_f - du - exact)
                                  / (np.linalg.norm(exact) + 1e-300))
            log(f"ensemble correction ({defl['kind']}): "
                f"{len(defl['modes'])} modes"
                + (f", rel-L2 {rel_mean:.4e} -> {rel_final:.4e}"
                   if exact is not None else ""))

    if out:
        n_stages = len(spec.stages) if spec.stages else 2
        record = {
            "problem": problem.name,
            "members": [f"member_{i}/params_stage_{n_stages}.npz"
                        for i in range(n_members)],
            "seeds": [int(s) for s in seeds],
            "weights": [float(v) for v in w],
            "weights_how": how,
            "deflation": defl,
            "rel_l2_members": rels,
            "rel_l2_mean_raw": rel_mean,
            "rel_l2": rel_final,
            "err_correlation": (np.round(corr, 6).tolist()
                                if corr is not None else None),
        }
        (out / "ensemble.json").write_text(json.dumps(record, indent=1))

    return EnsembleResult(
        members=members, weights=w, rel_l2_members=rels,
        err_correlation=(np.round(corr, 6).tolist()
                         if corr is not None else None),
        rel_l2_mean_raw=rel_mean, rel_l2=rel_final, deflation=defl,
        predict=predict)
