"""Benchmark: collocation points/sec on the flagship training step.

Prints ONE JSON line as the last line of stdout:
    {"metric": "...", "value": N, "unit": "pts/s", "vs_baseline": N,
     "device": {...}, "card": "<name>, <power limit>", ...}

Setup (matches the reference's smoke-config scale, BASELINE.md):
- problem: annulus Laplace (the reference's problem), via the symbolic
  compiler — nothing hardcoded,
- batch: 3000 uniform + 1000 boundary-band + 1000 adaptive + 2×100 BC
  points = 5200 collocation points per step,
- net: 6 hidden × 60 units tanh (the reference __main__'s effective net,
  software.py:1172-1175 after the depth/width swap),
- step: full Adam training step (residual + BC losses, grad, optax update)
  with on-device resampling — executed as the scanned on-device phase.

Methodology:
- value = MEDIAN of --repeats (default 5) timed runs of the compiled
  400-step phase; the spread is reported on stderr and in the details file.
- every timed section ends in ``jax.block_until_ready``.
- a model-FLOP share accompanies the headline: FLOPs of the fused
  Taylor-2 formulation (S stacked streams through the dense chain, ×3 for
  the backward) against the device's data-sheet peak for the precision
  the step runs at (``PEAK_TFLOPS``; a device missing from it is an
  error, so the benchmark runs only where its peak is known).
- --full additionally measures the batch-scaling curve and the loss-engine
  comparison (auto/fused) and writes out/bench_details.json.
- the process fails (non-zero exit) when any measurement fails.

Baseline: the reference solver itself cannot run here (tensorflow-
probability and pyDOE are not installed), so the baseline is measured from
tpinn.core.refmode — a faithful reimplementation of its hot-path semantics
(float64, reverse-over-reverse vectgrad residual, one jitted Adam step per
Python-loop iteration) pinned to CPU in a child process
(``JAX_PLATFORMS=cpu``, so it never opens the card), per BASELINE.md's
"measure from the reference solver (CPU)" instruction.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

N_COL, N_BAND, N_ADAPT, N_BD = 3000, 1000, 1000, 100
DEPTH, WIDTH = 6, 60
BATCH = N_COL + N_BAND + N_ADAPT + 2 * N_BD   # 5200
# n_col, n_band, n_adaptive, n_bd of the annulus recipe (problems/recipes.py)
RECIPE_COUNTS = (30000, 5000, 10000, 500)
# Headline Adam-step precision.  Production campaigns run the Adam phase at
# this tier (TrainSpec.adam_precision) with L-BFGS/eval/polish at full
# "highest".
HEADLINE_PRECISION = "highest"

# Dense peak rates in TFLOP/s by jax device_kind.  Source: NVIDIA H100
# Tensor Core GPU data sheet, SXM part, dense (no sparsity); the rates
# assume the card's full 700 W power limit.  "fp32" runs outside the
# tensor cores.
PEAK_TFLOPS = {
    "NVIDIA H100 80GB HBM3": {"fp32": 67.0, "tf32": 495.0, "bf16": 989.0},
}
# The arithmetic an f32 matmul runs at on such a card at each
# jax.lax.Precision tier (measured by chip_smoke.py's precision phase).
PRECISION_ARITHMETIC = {"highest": "fp32", "high": "tf32", "default": "tf32"}


def peak_flops(device_kind: str, precision: str):
    """(name, FLOP/s) of the data-sheet peak an f32 step at ``precision``
    can reach on ``device_kind``.  An unknown device is an error."""
    try:
        peaks = PEAK_TFLOPS[device_kind]
    except KeyError:
        raise KeyError(f"no peak rates for device kind {device_kind!r}; "
                       f"known: {sorted(PEAK_TFLOPS)}") from None
    name = PRECISION_ARITHMETIC[precision]
    return name, peaks[name] * 1e12


def model_flops_per_point(depth=DEPTH, width=WIDTH, n_features=3,
                          n_streams=5, out_dim=1):
    """Model FLOPs of one training step per collocation point: the fused
    Taylor-2 stream pass (n_streams stacked rows per point through the
    dense chain), ×3 for reverse mode (grad wrt W needs H^T·dX and dH·W^T
    matmuls of the same shape)."""
    sizes = [n_features] + [width] * depth + [out_dim]
    mm = sum(2 * a * b for a, b in zip(sizes[:-1], sizes[1:]))
    return 3 * n_streams * mm


def build_phase(batch_scale=1.0, engine="auto", steps=400,
                depth=DEPTH, width=WIDTH, precision="highest",
                layout="flat", counts=None):
    import jax
    import jax.numpy as jnp

    from tpinn import problems
    from tpinn.core import loss as loss_mod
    from tpinn.core import net, optim, pde, sample, train

    problem = problems.annulus_laplace()
    compiled = pde.compile_pde(problem.equation, problem.coords)
    fm = net.feature_map_for(problem.feature_kinds)
    spec = net.MLPSpec(depth=depth, width=width, precision=precision)
    params = net.init_params(jax.random.PRNGKey(0), spec, fm, jnp.float32)
    predictor = net.make_predictor(
        spec, fm, jnp.asarray(problem.lb, jnp.float32),
        jnp.asarray(problem.ub, jnp.float32),
    )
    n_col, n_band, n_adapt, n_bd = (int(n * batch_scale) for n in (
        counts or (N_COL, N_BAND, N_ADAPT, N_BD)))
    cfg = sample.SamplerConfig(n_col=n_col, n_band=n_band,
                               n_adaptive=n_adapt, n_bd=n_bd)
    sample_fn, grids = sample.make_sampler(
        cfg, problem.bc_groups, problem.lb, problem.ub, jnp.float32
    )
    batch = n_col + n_band + n_adapt + len(problem.bc_groups) * n_bd
    loss_fn = loss_mod.make_loss(predictor, compiled, engine=engine)
    density_fn = train.make_density_fn(predictor, compiled, grids)
    acfg = optim.AdamConfig(epochs=steps, resample_every=100,
                            density_every=2000, plateau_every=4000,
                            tail_max=0, layout=layout)
    phase = optim.make_adam_phase(
        loss_fn, sample_fn, density_fn, acfg,
        info_width=loss_mod.loss_info_width(2),
    )
    F0 = jnp.ones_like(grids[0])
    data0 = sample_fn(jax.random.PRNGKey(1), F0)
    lw = jnp.array([0.05, 0.0], jnp.float32)
    ref = jnp.array(1.0, jnp.float32)

    def run(key):
        return jax.block_until_ready(phase(key, params, data0, F0, lw, ref))

    return run, batch


def timed_inference(n_points=262144, repeats=5, depth=DEPTH, width=WIDTH):
    """Serving-path throughput: batched forward (u) and residual (L u)
    evaluation pts/s at a serving batch — what tpinn.app.serve dispatches
    per /predict and /residual request.  The reference has no serving
    path at all; this records the framework's inference ceiling next to
    its training rate."""
    import time

    import jax
    import jax.numpy as jnp
    import numpy as np

    from tpinn import problems
    from tpinn.core import net, pde

    problem = problems.annulus_laplace()
    compiled = pde.compile_pde(problem.equation, problem.coords)
    fm = net.feature_map_for(problem.feature_kinds)
    spec = net.MLPSpec(depth=depth, width=width)
    params = net.init_params(jax.random.PRNGKey(0), spec, fm, jnp.float32)
    predictor = net.make_predictor(
        spec, fm, jnp.asarray(problem.lb, jnp.float32),
        jnp.asarray(problem.ub, jnp.float32),
    )
    rng = np.random.RandomState(0)
    z = jnp.asarray(
        problem.lb + rng.rand(n_points, 2).astype(np.float32)
        * (np.asarray(problem.ub, np.float32) - problem.lb), jnp.float32)

    predict = jax.jit(lambda p, zz: predictor(p, zz))
    resid = jax.jit(
        lambda p, zz: compiled.residual_fast(predictor, p, zz))

    out = {}
    for name, fn in (("predict", predict), ("residual", resid)):
        jax.block_until_ready(fn(params, z))    # warmup + compile
        times = []
        for _ in range(repeats):
            t0 = time.perf_counter()
            jax.block_until_ready(fn(params, z))
            times.append(time.perf_counter() - t0)
        med = sorted(times)[len(times) // 2]
        out[name] = {
            "n_points": n_points,
            "median_s": round(med, 5),
            "pts_per_sec": round(n_points / med, 1),
        }
    return out


def timed_phase(batch_scale=1.0, engine="auto", steps=400, repeats=5,
                depth=DEPTH, width=WIDTH, precision="highest",
                layout="flat", counts=None):
    import jax

    run, batch = build_phase(batch_scale, engine, steps, depth, width,
                             precision, layout, counts)
    run(jax.random.PRNGKey(2))  # compile + warm
    times = []
    for i in range(repeats):
        t0 = time.perf_counter()
        run(jax.random.PRNGKey(3 + i))
        times.append(time.perf_counter() - t0)
    med = statistics.median(times)
    return {
        "batch": batch,
        "steps": steps,
        "median_s": round(med, 4),
        "min_s": round(min(times), 4),
        "max_s": round(max(times), 4),
        "pts_per_sec": round(steps * batch / med, 1),
        "ms_per_step": round(med / steps * 1e3, 4),
    }


def engine_comparison(steps=200, repeats=3):
    """Adam-step time of the default ("auto") and the fused Taylor-2
    engine at the annulus recipe's shape (6×80, its point counts) and its
    two precision tiers."""
    rows = {}
    for prec in ("default", "highest"):
        for engine in ("auto", "fused"):
            row = timed_phase(engine=engine, steps=steps, repeats=repeats,
                              depth=6, width=80, precision=prec,
                              counts=RECIPE_COUNTS)
            rows[f"{engine}/{prec}"] = row
            print(f"[bench] engine={engine} precision={prec}: "
                  f"{row['ms_per_step']:.4f} ms/step at batch "
                  f"{row['batch']} ({row['pts_per_sec']:,.0f} pts/s)",
                  file=sys.stderr)
    return rows


_BASELINE_SNIPPET = r"""
import time, sys, json
import jax
jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)
import jax.numpy as jnp
sys.path.insert(0, {repo!r})
from tpinn import problems
from tpinn.core import net, refmode, sample

problem = problems.annulus_laplace()
fm = net.feature_map_for(problem.feature_kinds)
spec = net.MLPSpec(depth={depth}, width={width})
params = net.init_params(jax.random.PRNGKey(0), spec, fm, jnp.float64)
predictor = net.make_predictor(
    spec, fm, jnp.asarray(problem.lb, jnp.float64),
    jnp.asarray(problem.ub, jnp.float64))
cfg = sample.SamplerConfig(n_col={n_col}, n_band={n_band},
                           n_adaptive={n_adapt}, n_bd={n_bd})
sample_fn, grids = sample.make_sampler(
    cfg, problem.bc_groups, problem.lb, problem.ub, jnp.float64)
data = sample_fn(jax.random.PRNGKey(1), jnp.ones_like(grids[0]))
loss_fn = refmode.make_reference_loss(predictor)
opt, step = refmode.make_reference_adam_step(loss_fn)
opt_state = opt.init(params)
lw = jnp.array([0.05, 0.0]); ref = jnp.array(1.0)
params, opt_state, info = step(params, opt_state, data, lw, ref)
float(info[0])          # compile + sync
n = {steps}
t0 = time.perf_counter()
for _ in range(n):                   # per-step dispatch, as the reference runs
    params, opt_state, info = step(params, opt_state, data, lw, ref)
float(info[0])
dt = time.perf_counter() - t0
print(json.dumps({{"pts_per_sec": n * {batch} / dt, "secs": dt}}))
"""


def bench_cpu_reference(steps=30):
    """Reference-semantics baseline in a subprocess (isolated x64 config)."""
    code = _BASELINE_SNIPPET.format(
        repo=os.path.dirname(os.path.abspath(__file__)),
        depth=DEPTH, width=WIDTH, n_col=N_COL, n_band=N_BAND,
        n_adapt=N_ADAPT, n_bd=N_BD, steps=steps, batch=BATCH,
    )
    out = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True,
        timeout=1800, env={**os.environ, "JAX_PLATFORMS": "cpu"},
    )
    if out.returncode != 0:
        print(out.stderr[-2000:], file=sys.stderr)
        raise RuntimeError("baseline subprocess failed")
    line = out.stdout.strip().splitlines()[-1]
    result = json.loads(line)
    print(f"[bench] cpu-reference baseline: "
          f"{result['pts_per_sec']:,.0f} pts/s "
          f"({result['secs']:.2f}s for {steps} steps)", file=sys.stderr)
    return result["pts_per_sec"]


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--full", action="store_true",
                   help="add batch-scaling curve + engine comparison; "
                        "write out/bench_details.json")
    p.add_argument("--repeats", type=int, default=5)
    p.add_argument("--precision", default=HEADLINE_PRECISION,
                   choices=tuple(PRECISION_ARITHMETIC),
                   help="matmul precision of the benched Adam step "
                        "(TrainSpec.adam_precision in production runs)")
    args = p.parse_args()

    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from tpinn.utils.compile_cache import enable_compile_cache
    from tpinn.utils.device_info import card_name_and_power_limit, jax_device

    enable_compile_cache()
    device = jax_device()
    peak_name, peak = peak_flops(device["kind"], args.precision)
    card = card_name_and_power_limit()
    print(f"[bench] card: {card}", file=sys.stderr)

    baseline = bench_cpu_reference()

    head = timed_phase(repeats=args.repeats, precision=args.precision)
    fpp = model_flops_per_point()
    achieved = head["pts_per_sec"] * fpp
    share = achieved / peak
    print(f"[bench] device={device} steps={head['steps']} "
          f"batch={head['batch']} median {head['median_s']:.3f}s "
          f"(spread {head['min_s']:.3f}-{head['max_s']:.3f}) "
          f"-> {head['pts_per_sec']:,.0f} pts/s | "
          f"{fpp / 1e3:.1f} kFLOP/pt, {achieved / 1e12:.2f} TFLOP/s, "
          f"{share * 100:.2f}% of the {peak_name} peak "
          f"({peak / 1e12:.0f} TFLOP/s)", file=sys.stderr)

    details = {
        "device": device,
        "card": card,
        "precision": args.precision,
        "peak": {"name": peak_name, "tflops": peak / 1e12},
        "baseline_pts_per_sec": round(baseline, 1),
        "headline": head,
        "model_flops_per_point": fpp,
        "achieved_tflops": round(achieved / 1e12, 3),
        "share_of_peak": round(share, 5),
    }
    headline_line = json.dumps({
        "metric": "collocation_pts_per_sec",
        "value": head["pts_per_sec"],
        "unit": "pts/s",
        "vs_baseline": round(head["pts_per_sec"] / baseline, 2),
        "share_of_peak": round(share, 5),
        "peak": peak_name,
        "device": device,
        "card": card,
    })

    if args.full:
        _full_sweep(args, details, fpp)

    print(headline_line, flush=True)


def _write_details(details):
    """Persist the sweep so far."""
    os.makedirs("out", exist_ok=True)
    with open("out/bench_details.json", "w") as f:
        json.dump(details, f, indent=2)


def _full_sweep(args, details, fpp):
    """Batch scaling, width, precision, layout and engine sweeps plus the
    serving-path rate, written to out/bench_details.json."""
    kind = details["device"]["kind"]
    _, peak = peak_flops(kind, args.precision)
    scaling = []
    for scale in (1.0, 5.0, 20.0, 80.0):
        steps = max(50, int(400 / scale))
        row = timed_phase(batch_scale=scale, steps=steps,
                          repeats=max(3, args.repeats - 2),
                          precision=args.precision)
        row["achieved_tflops"] = round(row["pts_per_sec"] * fpp / 1e12, 3)
        row["share_of_peak"] = round(row["pts_per_sec"] * fpp / peak, 5)
        print(f"[bench] scale x{scale:g}: batch={row['batch']} "
              f"{row['pts_per_sec']:,.0f} pts/s "
              f"({row['ms_per_step']:.2f} ms/step)", file=sys.stderr)
        scaling.append(row)
    details["scaling"] = scaling
    _write_details(details)

    widths = []
    for w in (60, 64, 128, 256):
        row = timed_phase(batch_scale=20.0, steps=50, repeats=3, width=w,
                          precision=args.precision)
        f = model_flops_per_point(width=w)
        row["width"] = w
        row["achieved_tflops"] = round(row["pts_per_sec"] * f / 1e12, 3)
        row["share_of_peak"] = round(row["pts_per_sec"] * f / peak, 5)
        print(f"[bench] width={w}: {row['pts_per_sec']:,.0f} pts/s, "
              f"{row['achieved_tflops']} TFLOP/s", file=sys.stderr)
        widths.append(row)
    details["width_sweep"] = widths
    _write_details(details)

    # precision tiers at the flagship shape (PRECISION_ARITHMETIC says what
    # each runs at); production runs use TrainSpec.adam_precision for the
    # Adam phase only, so the Adam-step rate here is what that phase rides
    precisions = {}
    for prec in PRECISION_ARITHMETIC:
        row = timed_phase(steps=200, repeats=3, precision=prec)
        name, pk = peak_flops(kind, prec)
        row["peak"] = name
        row["share_of_peak"] = round(row["pts_per_sec"] * fpp / pk, 5)
        precisions[prec] = row
        print(f"[bench] precision={prec}: {row['pts_per_sec']:,.0f} "
              f"pts/s ({row['ms_per_step']:.3f} ms/step)", file=sys.stderr)
    details["precisions"] = precisions
    _write_details(details)

    # Adam param layout A/B at the flagship shape: "flat" rides ONE
    # raveled vector through the scanned automaton
    # (optim.AdamConfig.layout), "tree" the per-leaf layout
    layouts = {}
    for lay in ("flat", "tree"):
        row = timed_phase(steps=200, repeats=3, layout=lay,
                          precision=args.precision)
        layouts[lay] = row
        print(f"[bench] layout={lay}: {row['pts_per_sec']:,.0f} pts/s "
              f"({row['ms_per_step']:.3f} ms/step)", file=sys.stderr)
    details["layouts"] = layouts
    _write_details(details)

    details["engines"] = engine_comparison()
    _write_details(details)

    inference = timed_inference(repeats=max(3, args.repeats - 2))
    for name, row in inference.items():
        print(f"[bench] inference {name}: {row['pts_per_sec']:,.0f} "
              f"pts/s at batch {row['n_points']}", file=sys.stderr)
    details["inference"] = inference
    _write_details(details)
    print("[bench] details -> out/bench_details.json", file=sys.stderr)


if __name__ == "__main__":
    main()
