"""Accuracy experiment runner: one training config per invocation, JSON out.

The campaign tool for driving presets to their rel-L2 gates (annulus
≤1e-5, others ≤1e-4, helmholtz ≤1e-2).  Each run is one process, so one
process owns the device and configs run one after another.

    python scripts/accuracy.py --problem annulus_laplace \
        --stages "6x50:tanh,6x50:sin" --adam 20000 --lbfgs 3000 \
        --n-col 20000 --lbfgs-grid 334 --tag exp1
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def parse_stage(token: str, args, first: bool):
    """'6x50:tanh' or '4x128:tanh:ff64:fs10' -> StageSpec."""
    from tpinn.core.train import StageSpec

    parts = token.split(":")
    depth, width = (int(v) for v in parts[0].split("x"))
    act = parts[1] if len(parts) > 1 else "tanh"
    ff, fs, modified = 0, 1.0, False
    act_hidden = "tanh"
    scl_override = None
    init_from = None
    stage_lr = None
    stage_lw0 = None
    for p in parts[2:]:
        if p.startswith("ff"):
            ff = int(p[2:])
        elif p.startswith("fs"):
            fs = float(p[2:])
        elif p.startswith("scl"):
            scl_override = float(p[3:])  # cap stage-k input scaling
        elif p.startswith("lr"):
            stage_lr = float(p[2:])      # per-stage Adam restart lr
        elif p.startswith("lw"):
            stage_lw0 = float(p[2:])     # per-stage equation weight
        elif p == "warm":
            init_from = "prev"           # continuation, not composition
        elif p == "mod":
            modified = True
        elif p == "siren":
            act_hidden = "sin"
    return StageSpec(
        depth=depth, width=width, act_first=act, act_hidden=act_hidden,
        scl=(1.0 if first else scl_override),  # None = auto-derive
        epsil=1.0 if first else None,
        adam_epochs=args.adam if first else int(args.adam * args.stage2_mult),
        lbfgs_epochs=args.lbfgs if first else int(args.lbfgs * args.stage2_mult),
        sample_scale=1.0 if first else args.sample_scale2,
        lbfgs_grid=args.lbfgs_grid,
        lbfgs_rounds=args.lbfgs_rounds,
        fourier_features=ff, fourier_scale=fs, modified=modified,
        init_from=init_from, lr=stage_lr,
        lw=(None if stage_lw0 is None else (stage_lw0, args.lw1)),
    )


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--problem", required=True)
    p.add_argument("--stages", default="6x50:tanh,6x50:sin")
    p.add_argument("--adam", type=int, default=20000)
    p.add_argument("--lbfgs", type=int, default=3000,
                   help="lbfgs 'epochs' (max_iters = epochs/3, ref semantics)")
    p.add_argument("--stage2-mult", type=float, default=1.5)
    p.add_argument("--n-col", type=int, default=20000)
    p.add_argument("--n-band", type=int, default=4000)
    p.add_argument("--n-adaptive", type=int, default=8000)
    p.add_argument("--n-bd", type=int, default=500)
    p.add_argument("--lw0", type=float, default=0.05)
    p.add_argument("--lw1", type=float, default=0.0)
    p.add_argument("--deriv-loss", action="store_true")
    p.add_argument("--engine", default="auto",
                   choices=("auto", "generic", "fused"))
    p.add_argument("--lsq-polish", default="off",
                   choices=("off", "auto", "on"),
                   help="exact f64 last-layer LSQ solve after each stage "
                        "(linear PDEs; tpinn.core.polish)")
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--lr-min", type=float, default=0.0,
                   help="plateau-halving floor (TrainSpec.lr_min); keeps "
                        "long Adam budgets from decaying lr to nothing")
    p.add_argument("--sample-scale2", type=float, default=2.0)
    p.add_argument("--lbfgs-grid", type=int, default=0)
    p.add_argument("--lbfgs-rounds", type=int, default=1)
    p.add_argument("--lbfgs-dtype", default=None)
    p.add_argument("--lbfgs-history", default="iters",
                   choices=("iters", "evals"),
                   help="loss-history cadence: per accepted iterate or per "
                        "function evaluation (the reference's cadence)")
    p.add_argument("--scl1", type=float, default=1.0)
    p.add_argument("--seed", type=int, default=1234)
    p.add_argument("--ensemble", type=int, default=1,
                   help="train K seed-varied members (seeds = seed + "
                        "1000*i), combine by residual-min-norm convex "
                        "weights, correct the mean once "
                        "(core.ensemble.run_ensemble_training)")
    p.add_argument("--march", type=int, default=0,
                   help="time-marching: N sequential windows along "
                        "--march-axis (core.march.run_time_marching); "
                        "the recorded rel_l2 is the composite's")
    p.add_argument("--march-axis", default="t")
    p.add_argument("--grid", type=int, default=111)
    p.add_argument("--platform", default=None)
    p.add_argument("--pad-features", type=int, default=0,
                   help="minimum input-embedding width (TrainSpec."
                        "pad_features)")
    p.add_argument("--residual-weight", default=None,
                   help="pointwise residual weight w(z) expression "
                        "(ProblemSpec.residual_weight)")
    p.add_argument("--hard-bc", action="store_true",
                   help="pose with the preset's hard Dirichlet ansatz "
                        "(problems.HARD_BC)")
    p.add_argument("--adam-precision", default=None,
                   choices=("default", "high"),
                   help="reduced matmul precision for the Adam phase "
                        "(TrainSpec.adam_precision); L-BFGS/eval/polish "
                        "stay full-precision")
    p.add_argument("--adam-engine", default=None,
                   choices=("auto", "generic", "fused"),
                   help="derivative engine for the Adam phase only "
                        "(TrainSpec.adam_engine)")
    p.add_argument("--stage-eq", action="append", default=None,
                   metavar="N:EXPR",
                   help="per-stage governing-equation override (1-based "
                        "stage index; StageSpec.equation) — curriculum "
                        "stages, e.g. Helmholtz k-continuation")
    p.add_argument("--ring-weight", type=float, default=0.0,
                   help="resonance-band training penalty weight "
                        "(TrainSpec.ring_weight; inert when the operator "
                        "has no band modes)")
    p.add_argument("--causal-eps", type=float, default=0.0,
                   help="causal residual weighting strength for evolution "
                        "problems (TrainSpec.causal_eps; 0 = off)")
    p.add_argument("--causal-bins", type=int, default=32,
                   help="number of causal time slabs (TrainSpec.causal_bins)")
    p.add_argument("--causal-axis", default="t",
                   help="evolution coordinate name (TrainSpec.causal_axis)")
    p.add_argument("--deflation", default="off",
                   choices=("off", "auto", "full"),
                   help="spectral error correction after the final stage "
                        "(TrainSpec.deflation): auto = resonance-band "
                        "deflation, full = exact defect correction "
                        "(hard-BC only); inert where invalid")
    p.add_argument("--auto-scl-cap", default="auto",
                   help="Nyquist guard on derived stage-2+ scl "
                        "(TrainSpec.auto_scl_cap): 'auto' = grid/4, "
                        "'none' = uncapped (reference behavior), or a float")
    p.add_argument("--tag", required=True)
    p.add_argument("--out-dir", default="out/acc")
    p.add_argument("--save-artifacts", action="store_true",
                   help="write the 11-npz artifact set + per-stage param "
                        "checkpoints to out/acc/<tag>_artifacts/")
    p.add_argument("--resume", action="store_true",
                   help="run_training(resume=True): skip stages whose "
                        "params_stage_N.npz already exists in the artifact "
                        "dir (seed a warm run from a previous tag by "
                        "copying its stage checkpoint in)")
    p.add_argument("--quiet", action="store_true")
    args = p.parse_args()
    if args.march and args.ensemble > 1:
        raise SystemExit("--march and --ensemble are exclusive")
    if args.march and args.hard_bc:
        raise SystemExit("--march poses the IC handoff softly; --hard-bc "
                         "cannot represent a learned terminal state")

    import jax

    from tpinn.utils.compile_cache import enable_compile_cache
    from tpinn.utils.device_info import jax_device

    if args.platform:
        jax.config.update("jax_platforms", args.platform)
    enable_compile_cache()
    device = jax_device()

    from dataclasses import replace

    from tpinn import problems
    from tpinn.core import train
    from tpinn.core.train import TrainSpec

    problem = problems.get_problem(args.problem)
    if args.hard_bc:
        problem = problems.with_hard_bc(problem)
    if args.residual_weight:
        import dataclasses

        problem = dataclasses.replace(problem,
                                      residual_weight=args.residual_weight)
    tokens = args.stages.split(",")
    stages = tuple(
        parse_stage(tok, args, first=(i == 0)) for i, tok in enumerate(tokens)
    )
    stages = (replace(stages[0], scl=args.scl1),) + stages[1:]
    for item in args.stage_eq or ():
        idx, expr = item.split(":", 1)
        if not (1 <= int(idx) <= len(stages)):
            raise SystemExit(
                f"--stage-eq: stage index {idx} out of range "
                f"(1..{len(stages)} for stages={args.stages!r})")
        i = int(idx) - 1
        stages = stages[:i] + (replace(stages[i], equation=expr),) + stages[i + 1:]
    spec = TrainSpec(
        n_col=args.n_col, n_band=args.n_band, n_adaptive=args.n_adaptive,
        n_bd=args.n_bd, lw=(args.lw0, args.lw1), stages=stages,
        pad_features=args.pad_features,
        seed=args.seed, lr=args.lr, lr_min=args.lr_min, grid=args.grid,
        deriv_loss=args.deriv_loss,
        lsq_polish=args.lsq_polish, engine=args.engine,
        deflation=args.deflation, ring_weight=args.ring_weight,
        causal_eps=args.causal_eps, causal_bins=args.causal_bins,
        causal_axis=args.causal_axis,
        lbfgs_dtype=args.lbfgs_dtype,
        lbfgs_history=args.lbfgs_history,
        adam_precision=args.adam_precision,
        adam_engine=args.adam_engine,
        auto_scl_cap=(
            "auto" if args.auto_scl_cap == "auto"
            else None if args.auto_scl_cap == "none"
            else float(args.auto_scl_cap)),
        testing_size=((256,) if problem.dim == 1
                      else (111, 111) if problem.dim == 2
                      else (48,) * problem.dim),
    )

    # quiet mode still surfaces stage-level milestones (phase transitions,
    # polish results) so long campaign runs are monitorable from the log
    stage_log = (
        (lambda m: print(m, file=sys.stderr, flush=True)
         if m.startswith("stage") else None)
        if args.quiet else None
    )
    out_dir = (f"{args.out_dir}/{args.tag}_artifacts"
               if args.save_artifacts else None)
    t0 = time.perf_counter()
    if args.ensemble > 1:
        from tpinn.core.ensemble import run_ensemble_training

        eres = run_ensemble_training(
            problem, spec, n_members=args.ensemble,
            output_dir=out_dir, print_log=not args.quiet,
            log_fn=stage_log, resume=args.resume)
        wall = time.perf_counter() - t0
        res = eres.members[-1]  # stage diagnostics: last member's
        rec = {
            "tag": args.tag,
            "problem": args.problem,
            "rel_l2": eres.rel_l2,
            "ensemble": {
                "n_members": args.ensemble,
                "rel_l2_members": eres.rel_l2_members,
                "rel_l2_mean_raw": eres.rel_l2_mean_raw,
                "weights": [float(v) for v in eres.weights],
                "err_correlation": eres.err_correlation,
            },
            "wall_secs": round(wall, 2),
            "device": device,
            "config": {k: v for k, v in vars(args).items()
                       if k not in ("out_dir", "quiet")},
        }
        out = Path(args.out_dir)
        out.mkdir(parents=True, exist_ok=True)
        (out / f"{args.tag}.json").write_text(json.dumps(rec, indent=2))
        print(json.dumps({"tag": args.tag, "rel_l2": eres.rel_l2,
                          "wall_secs": round(wall, 2)}))
        return
    if args.march:
        from tpinn.core.march import run_time_marching

        mres = run_time_marching(
            problem, spec, args.march, axis=args.march_axis,
            output_dir=out_dir, print_log=not args.quiet,
            log_fn=stage_log, resume=args.resume)
        wall = time.perf_counter() - t0
        rec = {
            "tag": args.tag,
            "problem": args.problem,
            "rel_l2": mres.rel_l2,
            "march": {
                "n_windows": args.march, "axis": args.march_axis,
                "edges": [float(v) for v in mres.edges],
                "rel_l2_windows": [r.rel_l2 for r in mres.windows],
            },
            "wall_secs": round(wall, 2),
            "device": device,
            "config": {k: v for k, v in vars(args).items()
                       if k not in ("out_dir", "quiet")},
        }
        out = Path(args.out_dir)
        out.mkdir(parents=True, exist_ok=True)
        (out / f"{args.tag}.json").write_text(json.dumps(rec, indent=2))
        print(json.dumps({"tag": args.tag, "rel_l2": mres.rel_l2,
                          "wall_secs": round(wall, 2)}))
        return
    res = train.run_training(problem, spec, print_log=not args.quiet,
                             log_fn=stage_log, output_dir=out_dir,
                             resume=args.resume)
    wall = time.perf_counter() - t0

    rec = {
        "tag": args.tag,
        "problem": args.problem,
        "rel_l2": res.rel_l2,
        "stages": [
            {"r_rms": s.r_rms, "e_rms": s.e_rms, "scl": s.scl,
             "epsil": s.epsil, "steps": int(s.history.shape[0])}
            for s in res.stages
        ],
        "final_loss": float(res.history[-1, 0]),
        "wall_secs": round(wall, 2),
        "device": device,
        "config": {k: v for k, v in vars(args).items()
                   if k not in ("out_dir", "quiet")},
    }
    out = Path(args.out_dir)
    out.mkdir(parents=True, exist_ok=True)
    (out / f"{args.tag}.json").write_text(json.dumps(rec, indent=2))
    print(json.dumps({"tag": args.tag, "rel_l2": res.rel_l2,
                      "wall_secs": round(wall, 2)}))


if __name__ == "__main__":
    main()
