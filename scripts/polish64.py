"""Post-hoc float64 L-BFGS polish of a saved checkpoint chain (CPU).

Loads a ``params_stage_N.npz`` chain checkpoint, rebuilds the composed
predictor, and runs double-precision L-BFGS on a deterministic tensor
grid — then reports the float64-eval rel-L2 and writes the polished
checkpoint next to the original.  Note: the rebuilt chain keeps earlier
stages frozen exactly as in training (net.compose_stages stops gradients
into the ``prev`` subtree), so the polish moves the FINAL stage only.

Rationale: the training loop runs in f32 on the device; the final approach
to the ≤1e-5 rel-L2 gate is a small-step quasi-Newton descent where f32 gradient
noise dominates. Doing that last mile once, in f64 on the host, costs
minutes and needs no retraining (the poisson_1d study measured a 4x rel-L2
improvement from the same polish inside the training loop).

    python scripts/polish64.py out/acc/eB_artifacts/params_stage_3.npz \
        --grid 200 --iters 400 [--tag eB64]
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def main():
    p = argparse.ArgumentParser()
    p.add_argument("checkpoint")
    p.add_argument("--grid", type=int, default=200)
    p.add_argument("--iters", type=int, default=400)
    p.add_argument("--lw0", type=float, default=None,
                   help="eqn-term weight (default: 0.05)")
    p.add_argument("--lsq", action="store_true",
                   help="variable-projection last-layer solve after L-BFGS "
                        "(linear PDEs)")
    p.add_argument("--out", default=None,
                   help="polished checkpoint path (default: "
                        "<ckpt>_polished.npz)")
    p.add_argument("--tag", default=None, help="JSON result tag to stdout")
    args = p.parse_args()

    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp

    from tpinn import problems
    from tpinn.core import loss as loss_mod
    from tpinn.core import net, optim, pde
    from tpinn.core.train import _grid_data, eval_grid
    from tpinn.utils import checkpoint as ckpt

    dtype = jnp.float64
    raw = np.load(args.checkpoint)
    meta = json.loads(bytes(raw["__meta__"]).decode())
    problem = problems.get_problem(meta["problem"])
    compiled = pde.compile_pde(problem.equation, problem.coords)
    source_fn = (pde.compile_coord_expr(problem.source, problem.coords)
                 if problem.source else None)
    fm = net.feature_map_for(tuple(meta["feature_kinds"]),
                             pad_to=meta.get("pad_features", 0))
    lb = jnp.asarray(meta["lb"], dtype)
    ub = jnp.asarray(meta["ub"], dtype)
    specs = [net.spec_from_dict(d) for d in meta["chain"]]
    predictor = net.make_predictor(specs[0], fm, lb, ub)
    template = net.init_params(jax.random.PRNGKey(0), specs[0], fm, dtype)
    for s in specs[1:]:
        predictor = net.compose_stages(predictor, s, fm, lb, ub)
        template = net.compose_params(
            net.init_params(jax.random.PRNGKey(0), s, fm, dtype), template)
    if meta.get("hard_bc"):
        coords = tuple(meta.get("coords", problem.coords))
        lift_fn, bubble_fn = (pde.compile_coord_expr(e, coords)
                              for e in meta["hard_bc"])
        predictor = net.wrap_hard_bc(predictor, lift_fn, bubble_fn)
    params, _ = ckpt.load_pytree(args.checkpoint, template)
    params = jax.tree.map(lambda a: jnp.asarray(a, dtype), params)

    data = _grid_data(problem, args.grid, dtype)
    lw = jnp.asarray((args.lw0 if args.lw0 is not None else 0.05, 0.0), dtype)
    ref = jnp.asarray(1.0, dtype)
    # the composed residual in the loss: generic nested-jvp engine (exact)
    loss_fn = loss_mod.make_loss(predictor, compiled, source_fn,
                                 engine="generic")

    l0 = float(jax.jit(loss_fn)(params, data, lw, ref)[0])
    print(f"grid {args.grid}^{problem.dim}: initial loss {l0:.4e}",
          file=sys.stderr)

    cfg = optim.LBFGSConfig(max_iters=args.iters, chunk_iters=0)
    t0 = time.perf_counter()
    params, hist, n_rows = optim.lbfgs_over_pytree(
        loss_fn, params, data, lw, ref, cfg)
    l1 = float(jax.jit(loss_fn)(params, data, lw, ref)[0])
    print(f"L-BFGS {int(n_rows) - 1} accepted iters: loss {l0:.4e} -> "
          f"{l1:.4e} ({time.perf_counter() - t0:.0f}s)", file=sys.stderr)

    if args.lsq and compiled.is_linear:
        from tpinn.core import polish as polish_mod

        params, pinfo = polish_mod.last_layer_lsq(
            predictor, compiled, params, data, float(lw[0]), source_fn,
            dtype=jnp.float64)
        print(f"lsq polish: {pinfo['pre']:.4e} -> {pinfo['post']:.4e}"
              f"{'' if pinfo['applied'] else ' (not applied)'}",
              file=sys.stderr)

    # float64 evaluation on the standard test grid
    X_star, _, _ = eval_grid(problem, (111,) * problem.dim, dtype)
    u = jax.jit(predictor)(params, X_star)
    rec = {"tag": args.tag or "polish64", "checkpoint": args.checkpoint,
           "grid": args.grid, "iters_accepted": int(n_rows) - 1,
           "loss": l1}
    if problem.exact is not None:
        exact = jnp.asarray(problem.exact(X_star), dtype)
        rec["rel_l2"] = float(loss_mod.relative_l2(u, exact))
        print(f"rel-L2 (f64 eval): {rec['rel_l2']:.4e}", file=sys.stderr)

    out = args.out or args.checkpoint.replace(".npz", "_polished.npz")
    ckpt.save_pytree(Path(out), params, meta=meta)
    rec["out"] = out
    print(json.dumps(rec))


if __name__ == "__main__":
    main()
