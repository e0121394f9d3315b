"""Best-known training recipes per preset — the gate-meeting configs.

Each recipe is the configuration of the best run of the earlier accuracy
campaign (run tag in ``Recipe.run_tag``; its records are in the git
history), translated from the campaign runner's CLI flags
(scripts/accuracy.py) into the typed spec.  The reference keeps its only
"recipe" in the ``__main__`` demo block
(software.py:1142-1201); here every preset ships
with the configuration that met its BASELINE gate, so

    problem, spec = problems.get_recipe("annulus_laplace")
    result = train.run_training(problem, spec)

is the one-liner from PDE name to gate-class accuracy.  The CLI exposes
this as ``python -m tpinn train --problem <name> --recipe``.

Every ``expected_rel_l2`` was measured on the accelerator this code was
first built for and awaits a re-measurement on the H100.

Recipe notes:
- Linear PDEs (all but burgers' advection term) use the variable-
  projection loop: deterministic-grid L-BFGS rounds alternating with an
  exact f64 last-layer solve (``lsq_polish="auto"``).
- The annulus flagship runs the Adam phase at the reduced matmul tier
  (``adam_precision="default"``) — converged accuracy is set by the
  full-precision L-BFGS/polish phases (eN: 1.75e-7 with in-run deflation).
- Helmholtz k=20 trains soft-BC (hard-BC measured 0.43-1.1 at high k)
  with lw0 ≈ 1/k⁴ and a k-continuation curriculum: stage 1 solves k=10,
  stage 2 warm-starts the same net at the true k.
- Every recipe closes with the spectral defect correction
  (``deflation="full"``): validated in-run it gains annulus 10.6x (eN
  1.75e-7), poisson_2d 68x (pW 1.20e-8), burgers 7.8x (bN 1.11e-6, one
  Newton step), heat 4.8x (tW 7.64e-6) over the best pre-deflation runs;
  offline on saved checkpoints poisson_1d gains 13949x (2.5e-12),
  helmholtz 2.5x (soft-BC Chebyshev); the guards make it a no-op where it
  cannot help.  It runs on the host CPU after the final stage (the
  linearized system is assembled from per-index coefficient fields, not
  per-column dispatches).
- ``pad_features=3`` pads 2-wide embeddings to 3 columns (see
  TrainSpec.pad_features); the recipes were tuned with it.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

from tpinn.core.train import StageSpec, TrainSpec


@dataclass(frozen=True)
class Recipe:
    """A preset's best-known training configuration."""

    spec: TrainSpec
    hard_bc: bool                 # pose with problems.HARD_BC[name]
    expected_rel_l2: float        # earlier accelerator; awaits an H100 run
    run_tag: str                  # tag of the run that set it
    # True = expected_rel_l2 is the best MEASURED value so far, not yet a
    # gate-class result — the preset is a hard benchmark whose decisive
    # configuration is still being campaigned (see README's honest-status
    # notes).  ``--recipe`` still runs the pinned best-known config.
    provisional: bool = False
    # > 0: the recipe is a time-marching config — run
    # core.march.run_time_marching(problem, spec, march) instead of
    # run_training (the CLI --recipe path dispatches on this).  spec
    # describes ONE window; hard_bc must be False (soft IC handoff).
    march: int = 0


def _two_stage(depth, width, adam, lbfgs, *, n_col, n_band, n_adaptive,
               n_bd, lw0, lbfgs_grid, lbfgs_rounds=1, stage2_scl=None,
               mult=1.5, sample_scale2=2.0):
    """The workhorse shape: tanh stage 1 + sin correction stage 2 with
    auto-derived (Nyquist-capped) scales, VP polish on both."""
    s1 = StageSpec(depth=depth, width=width, act_first="tanh",
                   scl=1.0, epsil=1.0, adam_epochs=adam, lbfgs_epochs=lbfgs,
                   lbfgs_grid=lbfgs_grid, lbfgs_rounds=lbfgs_rounds)
    s2 = StageSpec(depth=depth, width=width, act_first="sin",
                   scl=stage2_scl, epsil=None,
                   adam_epochs=int(adam * mult),
                   lbfgs_epochs=int(lbfgs * mult),
                   sample_scale=sample_scale2,
                   lbfgs_grid=lbfgs_grid, lbfgs_rounds=lbfgs_rounds)
    return TrainSpec(
        n_col=n_col, n_band=n_band, n_adaptive=n_adaptive, n_bd=n_bd,
        lw=(lw0, 0.0), stages=(s1, s2), lsq_polish="auto", pad_features=3, deflation="full",
    )


RECIPES = {
    # eN: 1.75e-7 rel-L2 (the eM config with
    # the deflation="full" pass IN-RUN, 10.6x over eM's 1.85e-6)
    "annulus_laplace": Recipe(
        spec=TrainSpec(
            n_col=30000, n_band=5000, n_adaptive=10000, n_bd=500,
            lw=(0.05, 0.0),
            stages=(StageSpec(depth=6, width=80, act_first="tanh",
                              scl=1.0, epsil=1.0,
                              adam_epochs=8000, lbfgs_epochs=8000,
                              lbfgs_grid=450, lbfgs_rounds=3),),
            lsq_polish="auto", adam_precision="default", deflation="full",
        ),
        hard_bc=True, expected_rel_l2=1.7e-7, run_tag="eN"),
    # p1W: 2.55e-12 rel-L2 (p1K config with
    # the diagonal full-band deflation in-run; machine-precision class,
    # reproducing the offline 13949x prediction live)
    "poisson_1d": Recipe(
        spec=TrainSpec(
            n_col=8000, n_band=0, n_adaptive=1000, n_bd=200,
            lw=(1.0, 0.0),
            stages=(StageSpec(depth=5, width=50, act_first="tanh",
                              scl=1.0, epsil=1.0,
                              adam_epochs=6000, lbfgs_epochs=5000,
                              lbfgs_grid=2000, lbfgs_rounds=2),),
            lsq_polish="auto", pad_features=3, testing_size=(256,),
            deflation="full",
        ),
        hard_bc=True, expected_rel_l2=2.5e-12, run_tag="p1W"),
    # bN: 1.11e-6 rel-L2 (bJ config with the
    # deflation Newton step in-run, 7.8x over bJ's 8.70e-6)
    "burgers_1d": Recipe(
        spec=_two_stage(5, 64, 10000, 4000, n_col=20000, n_band=2000,
                        n_adaptive=6000, n_bd=500, lw0=1.0, lbfgs_grid=300),
        hard_bc=True, expected_rel_l2=1.1e-6, run_tag="bN"),
    # pW: 1.20e-8 rel-L2 (pJ config with the
    # deflation pass in-run, 68x over pJ's 8.13e-7)
    "poisson_2d": Recipe(
        spec=_two_stage(5, 64, 10000, 4000, n_col=20000, n_band=2000,
                        n_adaptive=6000, n_bd=500, lw0=1.0, lbfgs_grid=300),
        hard_bc=True, expected_rel_l2=1.2e-8, run_tag="pW"),
    # tW: 7.64e-6 rel-L2 (same config as tS,
    # which measured 3.69e-5; the in-run deflation="full" pass is the
    # difference) — the single-stage VP recipe (the annulus winner's
    # shape transplanted; beat every 2-stage arm at 1/3 the wall)
    "heat_2d": Recipe(
        spec=TrainSpec(
            n_col=20000, n_band=2000, n_adaptive=6000, n_bd=500,
            lw=(1.0, 0.0),
            stages=(StageSpec(depth=6, width=96, act_first="tanh",
                              scl=1.0, epsil=1.0,
                              adam_epochs=20000, lbfgs_epochs=12000,
                              lbfgs_grid=300, lbfgs_rounds=3),),
            lsq_polish="auto", pad_features=3, deflation="full",
        ),
        hard_bc=True, expected_rel_l2=7.6e-6, run_tag="tW"),
    # hS: 3.84e-4 rel-L2 — soft BC, Fourier features, k-continuation,
    # LSQ polish; the soft-BC Chebyshev defect correction applies on top
    "helmholtz_2d": Recipe(
        spec=TrainSpec(
            n_col=40000, n_band=4000, n_adaptive=16000, n_bd=4000,
            lw=(1e-4, 0.0),
            stages=(
                StageSpec(depth=4, width=128, act_first="tanh",
                          scl=1.0, epsil=1.0,
                          adam_epochs=40000, lbfgs_epochs=12000,
                          lbfgs_grid=283, fourier_features=64,
                          fourier_scale=10.0,
                          equation="u_xx + u_yy + 100*u "
                                   "+ 100*sin(10*x)*sin(10*y)"),
                StageSpec(depth=4, width=128, act_first="tanh",
                          adam_epochs=60000, lbfgs_epochs=18000,
                          sample_scale=2.0, lbfgs_grid=283,
                          fourier_features=64, fourier_scale=10.0,
                          init_from="prev"),
            ),
            pad_features=3, lsq_polish="auto", deflation="full",
        ),
        hard_bc=False, expected_rel_l2=3.8e-4, run_tag="hS"),
    # nd1: 8.87e-6 rel-L2 — 3-D cube Poisson
    # (beyond the 2-D reference), hard-BC ansatz + VP loop on a 24³
    # deterministic grid.  Deflation stays off: the spectral corrector is
    # 1-D/2-D (polish.defect_correction guards).
    "poisson_3d": Recipe(
        spec=TrainSpec(
            n_col=4000, n_band=1000, n_adaptive=1000, n_bd=200,
            lw=(1.0, 0.0), grid=31,
            stages=(StageSpec(depth=5, width=64, act_first="tanh",
                              scl=1.0, epsil=1.0,
                              adam_epochs=4000, lbfgs_epochs=4000,
                              lbfgs_grid=24, lbfgs_rounds=2),),
            lsq_polish="auto", testing_size=(48, 48, 48),
        ),
        hard_bc=True, expected_rel_l2=8.9e-6, run_tag="nd1"),
    # ls1: 5.34e-3 rel-L2 — L-shaped Laplace
    # (non-box domain via masked residual): the re-entrant-corner
    # singularity caps a plain MLP near 1e-2; adaptive density (masked to
    # the L) concentrates points at the corner.  Deflation off: the
    # box-spectral correctors don't apply to a masked domain.
    # bsA (CPU, out/acc_cpu): 2.06e-3 on the REAL nu=0.01/pi Burgers
    # front — plain hard-IC/BC single stage; Raissi-class accuracy on the
    # first config.
    "burgers_shock": Recipe(
        spec=TrainSpec(
            n_col=4096, n_band=0, n_adaptive=2048, n_bd=256,
            lw=(1.0, 0.0), grid=111,
            stages=(StageSpec(depth=4, width=64, act_first="tanh",
                              scl=1.0, epsil=1.0,
                              adam_epochs=10000, lbfgs_epochs=5000),),
            pad_features=3, testing_size=(111, 111),
        ),
        hard_bc=True, expected_rel_l2=2.06e-3, run_tag="bsA"),
    # cvTM: 1.21e-3 rel-L2 — 8-window
    # marching at 20k+6k per window; per-window errors 6.7e-4..1.5e-3,
    # mild growth through handoffs.  Controls: plain 24k-step CPU cvD0
    # 0.196, causal cvD10 0.265, CPU-budget march-8 cvM8 1.07e-2, and
    # plain at a 120k-step budget (cvT0) 6.83e-3 — marching beats
    # the 10x-budget single net 5.6x at 1/3 the wall.  The structural
    # fix for "solving the PDE backwards in time".
    "convection_1d": Recipe(
        spec=TrainSpec(
            n_col=4096, n_band=0, n_adaptive=1024, n_bd=512,
            lw=(1.0, 0.0), grid=101,
            stages=(StageSpec(depth=4, width=64, act_first="tanh",
                              scl=1.0, epsil=1.0,
                              adam_epochs=20000, lbfgs_epochs=6000),),
            pad_features=3, testing_size=(111, 111),
        ),
        hard_bc=False, expected_rel_l2=1.2e-3, run_tag="cvTM",
        march=8),
    # acM8: 8.14e-3 rel-L2 — the canonical
    # stiff PINN failure case: plain space-time training collapses to the
    # metastable branch (acP control, 24k steps: 0.505); marching
    # with the domain-fitted periodic embedding breaks the collapse
    # (acM4: 1.95e-2; 8 windows at 12k+4k each: 8.14e-3, 62x over
    # plain).  Provisional: the causal-training literature reaches
    # 1e-3-class with modified-MLP architectures — window-budget and
    # architecture arms remain.
    "allen_cahn": Recipe(
        spec=TrainSpec(
            n_col=4096, n_band=0, n_adaptive=1024, n_bd=512,
            lw=(1.0, 0.0), grid=111,
            stages=(StageSpec(depth=4, width=64, act_first="tanh",
                              scl=1.0, epsil=1.0,
                              adam_epochs=12000, lbfgs_epochs=4000),),
            pad_features=3, testing_size=(201, 101),
        ),
        hard_bc=False, expected_rel_l2=8.1e-3, run_tag="acM8",
        provisional=True, march=8),
    # wvMT4: 2.04e-2 rel-L2 — 4-window
    # Cauchy-handoff marching (u AND u_t hand off; core/march.py
    # second-order path), lw0=0.01 (the helmholtz lesson: near the
    # operator's eigenstructure small residual != small error, so the
    # residual term must not swamp the soft IC/edge data).  Controls:
    # plain single net wvA 0.509 (the 8pi time mode defeats it — CPU
    # ladder in out/acc_cpu agrees), march-8 wvMT8 2.30e-2 at 1.5x the
    # wall — wave prefers FEWER, longer windows than convection.
    # Provisional: 1e-2 class, window-budget scaling continues.
    "wave_1d": Recipe(
        spec=TrainSpec(
            n_col=4096, n_band=0, n_adaptive=1024, n_bd=512,
            lw=(0.01, 0.0), grid=111,
            stages=(StageSpec(depth=4, width=64, act_first="tanh",
                              scl=1.0, epsil=1.0,
                              adam_epochs=20000, lbfgs_epochs=6000),),
            pad_features=3, testing_size=(111, 111),
        ),
        hard_bc=False, expected_rel_l2=2.0e-2, run_tag="wvMT4",
        provisional=True, march=4),
    # kdA: 1.19e-3 rel-L2 — third-order
    # dispersion through the nested-jvp path; soft IC + exact edge
    # traces.  The soliton translates undistorted at 1e-3 class on the
    # first hardware config.
    "kdv_1d": Recipe(
        spec=TrainSpec(
            n_col=4096, n_band=0, n_adaptive=1024, n_bd=256,
            lw=(1.0, 0.0), grid=111,
            stages=(StageSpec(depth=4, width=64, act_first="tanh",
                              scl=1.0, epsil=1.0,
                              adam_epochs=8000, lbfgs_epochs=4000),),
            pad_features=3, testing_size=(111, 111),
        ),
        hard_bc=False, expected_rel_l2=1.2e-3, run_tag="kdA"),
    "lshape_laplace": Recipe(
        spec=TrainSpec(
            n_col=2048, n_band=512, n_adaptive=1024, n_bd=128,
            lw=(1.0, 0.0), grid=64,
            stages=(StageSpec(depth=4, width=48, act_first="tanh",
                              scl=1.0, epsil=1.0,
                              adam_epochs=6000, lbfgs_epochs=6000),),
            pad_features=3, testing_size=(81, 81),
        ),
        hard_bc=False, expected_rel_l2=5.3e-3, run_tag="ls1"),
}


def get_recipe(name: str):
    """(ProblemSpec, TrainSpec) of the preset's best-known configuration."""
    from tpinn import problems

    try:
        rec = RECIPES[name]
    except KeyError:
        raise KeyError(
            f"no recipe for {name!r}; available: {sorted(RECIPES)}"
        ) from None
    problem = problems.get_problem(name)
    if rec.hard_bc:
        problem = problems.with_hard_bc(problem)
    return problem, rec.spec
