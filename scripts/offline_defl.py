"""Offline defect-correction evaluation on a trained checkpoint.

Rebuilds the predictor exactly as serving does (tpinn.app.serve), runs
polish.defect_correction on the trained fields, and reports rel-L2 against
the problem's analytic oracle before/after the correction — the cheap
host-side estimate of what a --deflation arm would gain, without spending
a training run on the device.

Usage:
    python scripts/offline_defl.py --checkpoint out/acc/eM_artifacts/params_stage_1.npz \
        --problem annulus_laplace [--mode full] [--grid 161] [--platform cpu]
"""
import argparse
import json
import sys
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--checkpoint", required=True)
    p.add_argument("--problem", required=True)
    p.add_argument("--mode", default="full", choices=("auto", "full"))
    p.add_argument("--grid", type=int, default=161,
                   help="oracle-comparison grid per axis")
    p.add_argument("--n-grid", type=int, default=161,
                   help="correction quadrature grid per axis")
    p.add_argument("--platform", default="cpu")
    p.add_argument("--degree", default=None,
                   help="soft-BC Chebyshev degree: an int or 'auto' "
                        "(held-out-selected ladder); default = "
                        "polish.soft_defect's default")
    p.add_argument("--no-ring", action="store_true",
                   help="soft path: disable the resonance-band sine "
                        "augmentation (ablation)")
    p.add_argument("--ring-band", type=float, default=None,
                   help="soft path: resonance band as a fraction of c0 "
                        "(default polish.soft_defect's 0.35)")
    p.add_argument("--write", action="store_true",
                   help="persist the computed correction into the "
                        "checkpoint meta (serving then applies it "
                        "automatically)")
    args = p.parse_args()

    import jax

    if args.platform:
        jax.config.update("jax_platforms", args.platform)

    from tpinn import problems
    from tpinn.app.serve import PINNServer
    from tpinn.core import polish

    srv = PINNServer(args.checkpoint, args.problem)
    problem = srv.problem
    raw = np.load(args.checkpoint)
    meta = json.loads(bytes(raw["__meta__"]).decode()) \
        if "__meta__" in raw else {}
    if meta.get("deflation"):
        raise SystemExit("checkpoint already carries a deflation term; "
                         "offline re-correction would double-count")

    # oracle grid
    dim = problem.dim
    axes = [np.linspace(problem.lb[j], problem.ub[j], args.grid)
            for j in range(dim)]
    mesh = np.meshgrid(*axes, indexing="ij")
    z = np.stack([g.ravel() for g in mesh], axis=1)

    from tpinn.utils.x64 import force_x64
    import jax.numpy as jnp

    with force_x64():
        p64 = jax.tree.map(lambda a: jnp.asarray(np.asarray(a), jnp.float64),
                           srv.params)
        u = np.asarray(srv.predictor(p64, jnp.asarray(z, jnp.float64)))
        exact = np.asarray(problem.exact(jnp.asarray(z, jnp.float64)))
    rel0 = float(np.linalg.norm(u - exact) / np.linalg.norm(exact))

    from tpinn.core import pde as pde_mod

    source_fn = (pde_mod.compile_coord_expr(problem.source, problem.coords)
                 if problem.source else None)
    defl = polish.defect_correction(
        srv.predictor, srv.params, srv.compiled, problem.lb, problem.ub,
        tuple(meta["hard_bc"]) if meta.get("hard_bc") else None,
        mode=args.mode, source_fn=source_fn,
        coords=tuple(meta.get("coords", problem.coords)),
        bc_groups=problem.bc_groups,
        n_grid=args.n_grid,
        **{**({} if args.degree is None else
              {"degree": args.degree if args.degree == "auto"
               else int(args.degree)}),
           **({"ring": False} if args.no_ring else {}),
           **({} if args.ring_band is None
              else {"ring_band": args.ring_band})})
    if defl is None:
        print(json.dumps({"problem": args.problem, "rel_l2": rel0,
                          "corrected": None,
                          "note": "defect_correction returned None"}))
        return
    du, _ = polish.deflation_fields(defl, srv.compiled, z)
    rel1 = float(np.linalg.norm(u - du - exact) / np.linalg.norm(exact))
    written = False
    if args.write:
        from tpinn.utils.artifacts import atomic_savez

        arrays = {k: raw[k] for k in raw.files if k != "__meta__"}
        meta2 = dict(meta)
        meta2["deflation"] = defl
        arrays["__meta__"] = np.frombuffer(
            json.dumps(meta2).encode(), dtype=np.uint8)
        atomic_savez(args.checkpoint, **arrays)
        written = True
    print(json.dumps({
        "problem": args.problem, "kind": defl["kind"],
        "degree": defl.get("degree"),
        "n_modes": len(defl["modes"]),
        "resid_drop": defl.get("resid_drop"),
        "rel_l2": rel0, "rel_l2_corrected": rel1,
        "gain": rel0 / rel1 if rel1 > 0 else float("inf"),
        "written": written,
    }))


if __name__ == "__main__":
    main()
