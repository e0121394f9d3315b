"""Ensemble-average trained checkpoints and measure the accuracy gain.

The helmholtz postmortem (run hS): after the spectral defect
correction the remaining ~1.5e-4 error is broadband net noise outside
every basis tried.  If that noise decorrelates across training seeds, the
mean of K independently trained solutions cuts it ~sqrt(K) — this script
measures exactly that on committed checkpoints, entirely host-side f64:

- per-member rel-L2 against the analytic oracle,
- the pairwise error-field correlation matrix (the hypothesis test:
  ~1 means shared/systematic error — averaging is useless; ~0 means
  independent noise — averaging pays sqrt(K)),
- rel-L2 of the uniform ensemble mean,
- rel-L2 of the mean after polish.defect_correction of the AVERAGED
  predictor (the correction composes: the mean's residual is the mean of
  residuals for linear operators).

Usage:
    python scripts/ensemble_avg.py --problem helmholtz_2d \
        --checkpoints out/acc/hS_artifacts/params_stage_2.npz \
                      out/acc/hE1_artifacts/params_stage_2.npz \
                      out/acc/hE2_artifacts/params_stage_2.npz \
        [--mode full] [--grid 161] [--weights lsq]
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--checkpoints", nargs="+", required=True)
    p.add_argument("--problem", required=True)
    p.add_argument("--mode", default="full", choices=("auto", "full", "off"),
                   help="defect correction applied to the averaged "
                        "predictor (off = skip)")
    p.add_argument("--grid", type=int, default=161)
    p.add_argument("--n-grid", type=int, default=161)
    p.add_argument("--platform", default="cpu")
    p.add_argument("--weights", default="uniform",
                   choices=("uniform", "lsq"),
                   help="'lsq': min-residual-norm convex weights on the "
                        "quadrature grid (no oracle used) instead of 1/K")
    args = p.parse_args()

    import jax

    if args.platform:
        jax.config.update("jax_platforms", args.platform)
    import jax.numpy as jnp

    from tpinn import problems
    from tpinn.app.serve import PINNServer
    from tpinn.core import pde as pde_mod
    from tpinn.core import polish
    from tpinn.utils.x64 import force_x64

    servers = [PINNServer(c, args.problem) for c in args.checkpoints]
    problem = servers[0].problem
    dim = problem.dim
    axes = [np.linspace(problem.lb[j], problem.ub[j], args.grid)
            for j in range(dim)]
    mesh = np.meshgrid(*axes, indexing="ij")
    z = np.stack([g.ravel() for g in mesh], axis=1)

    with force_x64():
        z64 = jnp.asarray(z, jnp.float64)
        exact = np.asarray(problem.exact(z64))
        fields, p64s = [], []
        for srv in servers:
            p64 = jax.tree.map(
                lambda a: jnp.asarray(np.asarray(a), jnp.float64), srv.params)
            p64s.append(p64)
            fields.append(np.asarray(srv.predictor(p64, z64)))

    nrm = np.linalg.norm(exact)
    errs = [f - exact for f in fields]
    rels = [float(np.linalg.norm(e) / nrm) for e in errs]

    K = len(fields)
    corr = np.ones((K, K))
    for i in range(K):
        for j in range(i + 1, K):
            c = float(np.sum(errs[i] * errs[j])
                      / (np.linalg.norm(errs[i]) * np.linalg.norm(errs[j])))
            corr[i, j] = corr[j, i] = c

    if args.weights == "lsq" and K > 1:
        # weights minimizing the RESIDUAL norm of the convex combination on
        # the quadrature grid — oracle-free (usable in production), valid
        # for linear operators where residuals combine linearly
        from tpinn.core.polish import _host_residual_f64

        source_fn = (pde_mod.compile_coord_expr(problem.source,
                                                problem.coords)
                     if problem.source else None)
        R = np.concatenate(
            [_host_residual_f64(srv.predictor, p64, srv.compiled,
                                source_fn, z)
             for srv, p64 in zip(servers, p64s)], axis=1)  # [n, K]
        # min ||R w|| s.t. sum w = 1  (eliminate constraint via w_K)
        A = R[:, :-1] - R[:, -1:]
        w_head, *_ = np.linalg.lstsq(A, -R[:, -1], rcond=None)
        w = np.append(w_head, 1.0 - w_head.sum())
    else:
        w = np.full(K, 1.0 / K)

    mean_f = sum(wi * f for wi, f in zip(w, fields))
    rel_mean = float(np.linalg.norm(mean_f - exact) / nrm)

    out = {
        "problem": args.problem,
        "members": [str(c) for c in args.checkpoints],
        "rel_l2_members": rels,
        "err_correlation": np.round(corr, 4).tolist(),
        "weights": np.round(w, 4).tolist(),
        "rel_l2_mean": rel_mean,
        "gain_vs_best_member": min(rels) / rel_mean if rel_mean > 0 else None,
    }

    if args.mode != "off":
        # correction of the averaged predictor: one callable, K nets inside
        def avg_predictor(params_list, zz):
            contribs = [wi * srv.predictor(pp, zz)
                        for wi, srv, pp in zip(w, servers, params_list)]
            return sum(contribs)

        source_fn = (pde_mod.compile_coord_expr(problem.source,
                                                problem.coords)
                     if problem.source else None)
        raw0 = np.load(args.checkpoints[0])
        meta0 = (json.loads(bytes(raw0["__meta__"]).decode())
                 if "__meta__" in raw0.files else {})
        defl = polish.defect_correction(
            avg_predictor, p64s, servers[0].compiled,
            problem.lb, problem.ub,
            tuple(meta0["hard_bc"]) if meta0.get("hard_bc") else None,
            mode=args.mode, source_fn=source_fn,
            coords=tuple(meta0.get("coords", problem.coords)),
            bc_groups=problem.bc_groups, n_grid=args.n_grid)
        if defl is None:
            out["rel_l2_mean_corrected"] = None
            out["note"] = "defect_correction returned None"
        else:
            du, _ = polish.deflation_fields(defl, servers[0].compiled, z)
            out["rel_l2_mean_corrected"] = float(
                np.linalg.norm(mean_f - du - exact) / nrm)
            out["correction_kind"] = defl["kind"]

    print(json.dumps(out, indent=1))


if __name__ == "__main__":
    main()
