"""Command-line interface: train presets, run benchmarks, launch the app.

    python -m tpinn train --problem poisson_2d --adam 8000 --lbfgs 3000 \
        --out out/poisson2d [--stages 2] [--f64-polish] [--resume]
    python -m tpinn problems            # list presets
    python -m tpinn app [--port 8050]   # the online PDE calculator
    python -m tpinn serve --checkpoint out/params_stage_1.npz \
        --problem poisson_2d
    python -m tpinn invert --problem heat_2d --equation "u_t - lam*u_xx" \
        --param lam=0.3        # coefficient identification from observations

(The reference's only entries are the Dash dev server and a __main__ demo;
a production framework needs a scriptable front door.)
"""

from __future__ import annotations

import argparse
import json
import sys


def cmd_problems(args):
    from tpinn import problems

    from tpinn.problems.recipes import RECIPES

    for name in sorted(problems.PRESETS):
        p = problems.PRESETS[name]()
        rec = RECIPES.get(name)
        gate = (f"   recipe: {rec.expected_rel_l2:.1e} rel-L2 "
                f"(run {rec.run_tag})" if rec else "")
        print(f"{name:18s} {p.equation}   coords={p.coords} "
              f"domain={list(zip(p.lb, p.ub))}{gate}")

    from tpinn.problems.systems import SYSTEM_PRESETS

    for name in sorted(SYSTEM_PRESETS):
        s = SYSTEM_PRESETS[name]()
        eqs = "; ".join(s.equations)
        print(f"{name:18s} [system {'/'.join(s.fields)}] {eqs}   "
              f"coords={s.coords} domain={list(zip(s.lb, s.ub))}")


def cmd_train(args):
    import jax

    if args.platform:
        jax.config.update("jax_platforms", args.platform)
    from tpinn import problems
    from tpinn.core import train
    from tpinn.core.train import StageSpec, TrainSpec

    if args.recipe and args.patches:
        raise SystemExit("--recipe and --patches are exclusive: recipes "
                         "are single-net configs (drop one)")
    if args.march and (args.patches or args.ensemble > 1 or args.recipe):
        raise SystemExit("--march composes windows sequentially; combine "
                         "it with --patches/--ensemble/--recipe per "
                         "window is not supported (drop one)")
    if args.recipe:
        # best-known gate-meeting config (tpinn/problems/recipes.py);
        # the explicit sizing flags are ignored in this mode
        problem, spec = problems.get_recipe(args.problem)
        if args.checkpoint_every > 0:
            import dataclasses

            spec = dataclasses.replace(
                spec, checkpoint_every=args.checkpoint_every)
        if args.ensemble > 1:
            from tpinn.core.ensemble import run_ensemble_training

            res = run_ensemble_training(
                problem, spec, n_members=args.ensemble,
                output_dir=args.out, print_log=True, resume=args.resume)
            print(json.dumps({
                "problem": args.problem, "recipe": True,
                "ensemble": args.ensemble,
                "rel_l2": res.rel_l2,
                "rel_l2_members": res.rel_l2_members,
                "weights": [float(v) for v in res.weights],
            }))
            return
        from tpinn.problems.recipes import RECIPES

        rec_march = RECIPES[args.problem].march
        if rec_march:
            from tpinn.core.march import run_time_marching

            mres = run_time_marching(problem, spec, rec_march,
                                     output_dir=args.out, print_log=True,
                                     resume=args.resume)
            print(json.dumps({
                "problem": args.problem, "recipe": True,
                "march": rec_march, "rel_l2": mres.rel_l2,
                "rel_l2_windows": [r.rel_l2 for r in mres.windows],
            }))
            return
        res = train.run_training(problem, spec, output_dir=args.out,
                                 print_log=True, resume=args.resume)
        print(json.dumps({
            "problem": args.problem, "recipe": True,
            "rel_l2": res.rel_l2,
            "steps": int(res.history.shape[0]),
        }))
        return

    problem = problems.get_problem(args.problem)
    stages = [StageSpec(depth=args.depth, width=args.width, scl=1.0,
                        epsil=1.0, adam_epochs=args.adam,
                        lbfgs_epochs=args.lbfgs)]
    if args.stages == 2:
        stages.append(StageSpec(depth=6, width=50, act_first="sin",
                                adam_epochs=3 * args.adam,
                                lbfgs_epochs=3 * args.lbfgs,
                                sample_scale=2.0))
    spec = TrainSpec(
        n_col=args.n_col, n_band=args.n_band, n_adaptive=args.n_adaptive,
        n_bd=args.n_bd, lw=(args.weight_f, args.weight_df),
        stages=tuple(stages), seed=args.seed,
        pad_features=args.pad_features,
        lbfgs_dtype="float64" if args.f64_polish else None,
        checkpoint_every=args.checkpoint_every,
    )
    if args.ensemble > 1:
        from tpinn.core.ensemble import run_ensemble_training

        res = run_ensemble_training(
            problem, spec, n_members=args.ensemble, output_dir=args.out,
            print_log=True, resume=args.resume)
        print(json.dumps({
            "problem": args.problem, "ensemble": args.ensemble,
            "rel_l2": res.rel_l2,
            "rel_l2_members": res.rel_l2_members,
            "weights": [float(v) for v in res.weights],
        }))
        return
    if args.march:
        from tpinn.core.march import run_time_marching

        res = run_time_marching(problem, spec, args.march,
                                axis=args.march_axis, output_dir=args.out,
                                print_log=True, resume=args.resume)
        print(json.dumps({
            "problem": args.problem, "march": args.march,
            "axis": args.march_axis,
            "rel_l2": res.rel_l2,
            "rel_l2_windows": [r.rel_l2 for r in res.windows],
        }))
        return
    if args.patches:
        from tpinn.core.patch import PatchSpec, run_patched

        n = tuple(int(v) for v in args.patches.lower().split("x"))
        res = run_patched(problem, spec, PatchSpec(n=n),
                          output_dir=args.out, print_log=True,
                          resume=args.resume)
        print(json.dumps({
            "problem": args.problem, "patches": list(n),
            "rel_l2": res.rel_l2,
        }))
        return
    res = train.run_training(problem, spec, output_dir=args.out,
                             print_log=True, resume=args.resume)
    print(json.dumps({
        "problem": args.problem,
        "rel_l2": res.rel_l2,
        "final_loss": float(res.history[-1, 0]) if len(res.history) else None,
        "steps": int(res.history.shape[0]),
    }))


def cmd_invert(args):
    import dataclasses

    import jax

    if args.platform:
        jax.config.update("jax_platforms", args.platform)
    from tpinn import problems
    from tpinn.core.inverse import InverseSpec, run_inverse
    from tpinn.core.train import StageSpec, TrainSpec

    names, inits = [], []
    for spec_str in args.param:
        if "=" not in spec_str:
            raise SystemExit(f"--param expects NAME=INIT, got {spec_str!r}")
        n, v = spec_str.split("=", 1)
        names.append(n.strip())
        inits.append(float(v))

    # the preset supplies domain/BCs/analytic oracle; the --equation
    # override states the same physics with the coefficients unknown
    problem = problems.get_problem(args.problem)
    problem = dataclasses.replace(problem, equation=args.equation)
    if args.normalize > 0:
        # eigen mode: the preset's analytic solution solves its ORIGINAL
        # equation, not the eigenproblem — drop it so no bogus rel-L2 is
        # reported (the preset supplies only domain + homogeneous BCs)
        problem = dataclasses.replace(problem, exact=None)

    inv = InverseSpec(params=tuple(names), init=tuple(inits),
                      n_obs=args.n_obs, obs_noise=args.obs_noise,
                      obs_weight=args.obs_weight, obs_seed=args.obs_seed,
                      normalize=args.normalize)
    spec = TrainSpec(
        n_col=args.n_col, n_band=args.n_band, n_adaptive=args.n_adaptive,
        n_bd=args.n_bd, lw=(args.weight_f, 0.0), seed=args.seed,
        pad_features=3,
        stages=(StageSpec(depth=args.depth, width=args.width, scl=1.0,
                          epsil=1.0, adam_epochs=args.adam,
                          lbfgs_epochs=args.lbfgs),),
    )
    res = run_inverse(problem, inv, spec, print_log=True,
                      output_dir=args.out)
    print(json.dumps({
        "problem": args.problem, "equation": args.equation,
        "coef": res.coef, "coef_adam": res.coef_adam,
        "rel_l2": res.rel_l2, "n_obs": args.n_obs,
        "obs_noise": args.obs_noise,
    }))


def cmd_system(args):
    import jax

    if args.platform:
        jax.config.update("jax_platforms", args.platform)
    from tpinn.core.system import run_system
    from tpinn.core.train import StageSpec, TrainSpec
    from tpinn.problems.systems import get_system

    problem = get_system(args.name)
    if args.recipe:
        from tpinn.problems.systems import SYSTEM_RECIPES

        rec = SYSTEM_RECIPES.get(args.name)
        if rec is None:
            raise SystemExit(f"no system recipe for {args.name!r}")
        for k in ("adam", "lbfgs", "depth", "width",
                  "n_col", "n_adaptive", "n_bd"):
            setattr(args, k, rec[k])
    spec = TrainSpec(
        n_col=args.n_col, n_band=args.n_band, n_adaptive=args.n_adaptive,
        n_bd=args.n_bd, lw=(args.weight_f, 0.0), seed=args.seed,
        pad_features=3,
        stages=(StageSpec(depth=args.depth, width=args.width, scl=1.0,
                          epsil=1.0, adam_epochs=args.adam,
                          lbfgs_epochs=args.lbfgs),),
    )
    res = run_system(problem, spec, print_log=True, output_dir=args.out)
    print(json.dumps({
        "system": args.name, "rel_l2": res.rel_l2,
        "rel_l2_fields": (list(res.rel_l2_fields)
                          if res.rel_l2_fields else None),
    }))


def cmd_app(args):
    from tpinn.app import lite

    lite.serve(port=args.port, data_root=args.data_root)


def cmd_serve(args):
    from tpinn.app import serve as serve_mod

    sys.argv = ["serve", "--checkpoint", args.checkpoint,
                "--problem", args.problem, "--port", str(args.port)]
    serve_mod.main()


def main(argv=None):
    p = argparse.ArgumentParser(prog="tpinn")
    sub = p.add_subparsers(dest="cmd", required=True)

    sub.add_parser("problems", help="list problem presets")

    t = sub.add_parser("train", help="train a preset")
    t.add_argument("--problem", required=True)
    t.add_argument("--adam", type=int, default=8000)
    t.add_argument("--lbfgs", type=int, default=3000)
    t.add_argument("--depth", type=int, default=6)
    t.add_argument("--width", type=int, default=50)
    t.add_argument("--stages", type=int, default=1, choices=(1, 2))
    t.add_argument("--n-col", type=int, default=3000)
    t.add_argument("--n-band", type=int, default=500)
    t.add_argument("--n-adaptive", type=int, default=1000)
    t.add_argument("--n-bd", type=int, default=100)
    t.add_argument("--weight-f", type=float, default=1.0)
    t.add_argument("--weight-df", type=float, default=0.0)
    t.add_argument("--seed", type=int, default=1234)
    t.add_argument("--out", default=None)
    t.add_argument("--resume", action="store_true")
    t.add_argument("--checkpoint-every", type=int, default=0,
                   help="save resumable mid-Adam state every N steps "
                        "(TrainSpec.checkpoint_every); 0 = final params "
                        "only. With --resume, a killed run restarts at "
                        "the last saved chunk")
    t.add_argument("--f64-polish", action="store_true")
    t.add_argument("--platform", default=None)
    t.add_argument("--recipe", action="store_true",
                   help="use the preset's best-known gate-meeting config "
                        "(tpinn.problems.get_recipe); sizing flags ignored")
    t.add_argument("--pad-features", type=int, default=3,
                   help="FeatureMap.pad_to minimum input width (model "
                        "class unchanged; 0 disables)")
    t.add_argument("--patches", default=None,
                   help="overlapping-patch decomposition (FBPINN-style): "
                        "patches per axis, e.g. '8' (1-D) or '4x4' (2-D); "
                        "the --depth/--width net is PER PATCH")
    t.add_argument("--ensemble", type=int, default=1,
                   help="train K seed-varied members and serve their "
                        "residual-min-norm convex combination "
                        "(core.ensemble.run_ensemble_training); the "
                        "combination record lands in OUT/ensemble.json")
    t.add_argument("--march", type=int, default=0,
                   help="time-marching (seq2seq): train N sequential "
                        "windows along --march-axis, each handed the "
                        "previous window's terminal state as its IC "
                        "(core.march.run_time_marching); the composite "
                        "record lands in OUT/march.json")
    t.add_argument("--march-axis", default="t",
                   help="evolution coordinate for --march")

    i = sub.add_parser(
        "invert",
        help="identify unknown PDE coefficients from observations "
             "(tpinn.core.inverse): the preset supplies domain/BCs/oracle, "
             "--equation restates the physics with named unknowns, --param "
             "NAME=INIT declares them")
    i.add_argument("--problem", required=True,
                   help="preset providing domain/BCs/analytic solution")
    i.add_argument("--equation", required=True,
                   help="equation with unknown coefficients, e.g. "
                        "'u_t - lam*u_xx'")
    i.add_argument("--param", action="append", required=True,
                   metavar="NAME=INIT",
                   help="unknown coefficient + initial guess (repeatable)")
    i.add_argument("--n-obs", type=int, default=200)
    i.add_argument("--normalize", type=float, default=0.0,
                   help="EIGEN mode: > 0 replaces observations with a "
                        "mean-square amplitude pin (e.g. 0.5 for sin "
                        "eigenfunctions); the unknown coefficient "
                        "converges to an eigenvalue near its init")
    i.add_argument("--obs-noise", type=float, default=0.0)
    i.add_argument("--obs-weight", type=float, default=1.0)
    i.add_argument("--obs-seed", type=int, default=0)
    i.add_argument("--adam", type=int, default=4000)
    i.add_argument("--lbfgs", type=int, default=3000)
    i.add_argument("--depth", type=int, default=4)
    i.add_argument("--width", type=int, default=32)
    i.add_argument("--n-col", type=int, default=2000)
    i.add_argument("--n-band", type=int, default=0)
    i.add_argument("--n-adaptive", type=int, default=500)
    i.add_argument("--n-bd", type=int, default=100)
    i.add_argument("--weight-f", type=float, default=1.0)
    i.add_argument("--seed", type=int, default=1234)
    i.add_argument("--platform", default=None)
    i.add_argument("--out", default=None,
                   help="write a servable checkpoint (params_stage_1.npz "
                        "with the identified equation/coefficients in the "
                        "meta) + inverse.json record")

    y = sub.add_parser(
        "system",
        help="train a coupled-system benchmark preset "
             "(tpinn.core.system; e.g. Navier-Stokes Kovasznay flow)")
    y.add_argument("--name", required=True,
                   help="system preset (see `tpinn problems`)")
    y.add_argument("--adam", type=int, default=6000)
    y.add_argument("--lbfgs", type=int, default=4000)
    y.add_argument("--depth", type=int, default=5)
    y.add_argument("--width", type=int, default=64)
    y.add_argument("--n-col", type=int, default=4000)
    y.add_argument("--n-band", type=int, default=0)
    y.add_argument("--n-adaptive", type=int, default=1000)
    y.add_argument("--n-bd", type=int, default=150)
    y.add_argument("--weight-f", type=float, default=1.0)
    y.add_argument("--seed", type=int, default=1234)
    y.add_argument("--recipe", action="store_true",
                   help="use the preset's best-known measured config "
                        "(problems.systems.SYSTEM_RECIPES)")
    y.add_argument("--platform", default=None)
    y.add_argument("--out", default=None,
                   help="write a servable multi-field checkpoint + "
                        "system.json record")

    a = sub.add_parser("app", help="launch the web calculator")
    a.add_argument("--port", type=int, default=8050)
    a.add_argument("--data-root", default="data")

    s = sub.add_parser("serve", help="serve a trained checkpoint")
    s.add_argument("--checkpoint", required=True)
    s.add_argument("--problem", required=True)
    s.add_argument("--port", type=int, default=8060)

    args = p.parse_args(argv)
    from tpinn.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    {"problems": cmd_problems, "train": cmd_train, "app": cmd_app,
     "serve": cmd_serve, "invert": cmd_invert,
     "system": cmd_system}[args.cmd](args)


if __name__ == "__main__":
    main()
