"""Convergence campaign: train every preset, record rel-L2 + wall time.

Produces out/convergence.json (one record per preset), every preset
trained in this one process on the default device:

    python scripts/convergence.py [--quick] [--only annulus_laplace,...]
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--quick", action="store_true", help="tiny budgets (smoke)")
    p.add_argument("--out", default="out/convergence.json")
    p.add_argument("--only", default=None, help="comma-separated preset names")
    p.add_argument("--platform", default=None)
    args = p.parse_args()

    import jax

    from tpinn.utils.compile_cache import enable_compile_cache
    from tpinn.utils.device_info import jax_device

    if args.platform:
        jax.config.update("jax_platforms", args.platform)
    enable_compile_cache()
    device = jax_device()

    from tpinn import problems
    from tpinn.core import train
    from tpinn.core.train import StageSpec, TrainSpec

    adam = 300 if args.quick else 8000
    lbfgs = 120 if args.quick else 3000

    def two_stage(depth=6, width=50):
        s1 = StageSpec(depth=depth, width=width, scl=1.0, epsil=1.0,
                       adam_epochs=adam, lbfgs_epochs=lbfgs)
        s2 = StageSpec(depth=6, width=50, act_first="sin",
                       adam_epochs=3 * adam, lbfgs_epochs=3 * lbfgs,
                       sample_scale=2.0)
        return (s1, s2)

    def one_stage(depth=6, width=50, ff=0, fscale=1.0):
        return (StageSpec(depth=depth, width=width, scl=1.0, epsil=1.0,
                          adam_epochs=adam, lbfgs_epochs=lbfgs,
                          fourier_features=ff, fourier_scale=fscale),)

    CAMPAIGN = {
        "annulus_laplace": TrainSpec(
            n_col=3000, n_band=1000, n_adaptive=1000, n_bd=100,
            lw=(0.05, 0.0), stages=two_stage(),
        ),
        "poisson_1d": TrainSpec(
            n_col=2000, n_band=0, n_adaptive=200, n_bd=100,
            testing_size=(256,), lw=(1.0, 0.0), stages=one_stage(4, 50),
        ),
        "burgers_1d": TrainSpec(
            n_col=3000, n_band=500, n_adaptive=500, n_bd=200,
            lw=(1.0, 0.0), stages=one_stage(6, 50),
        ),
        "poisson_2d": TrainSpec(
            n_col=3000, n_band=500, n_adaptive=1000, n_bd=100,
            lw=(1.0, 0.0), stages=one_stage(6, 50),
        ),
        "heat_2d": TrainSpec(
            n_col=3000, n_band=500, n_adaptive=500, n_bd=200,
            lw=(1.0, 0.0), stages=one_stage(6, 50),
        ),
        "helmholtz_2d": TrainSpec(
            n_col=4000, n_band=500, n_adaptive=1500, n_bd=200,
            lw=(1.0, 0.0),
            stages=one_stage(4, 128, ff=64, fscale=10.0),
        ),
    }

    from dataclasses import replace as _replace

    # the campaign's configs were tuned with 3-wide embeddings (no-op for
    # embeddings already >=3 wide; see net.FeatureMap.pad_to)
    CAMPAIGN = {k: _replace(v, pad_features=3)
                for k, v in CAMPAIGN.items()}

    only = set(args.only.split(",")) if args.only else None
    results = []
    for name, spec in CAMPAIGN.items():
        if only and name not in only:
            continue
        problem = problems.get_problem(name)
        print(f"=== {name} ===", file=sys.stderr, flush=True)
        t0 = time.perf_counter()
        res = train.run_training(problem, spec, print_log=True)
        dt = time.perf_counter() - t0
        steps = res.history.shape[0]
        rec = {
            "problem": name,
            "rel_l2": res.rel_l2,
            "stages": [
                {"r_rms": s.r_rms, "e_rms": s.e_rms, "scl": s.scl,
                 "epsil": s.epsil, "steps": int(s.history.shape[0])}
                for s in res.stages
            ],
            "total_steps": int(steps),
            "wall_secs": round(dt, 2),
            "final_loss": float(res.history[-1, 0]),
            "device": device,
        }
        print(json.dumps(rec), flush=True)
        results.append(rec)

    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(results, indent=2))
    print(f"wrote {out}", file=sys.stderr)


if __name__ == "__main__":
    main()
