"""Smoke run of tpinn's training and serving path on an NVIDIA GPU.

    python chip_smoke.py                # one card (phases 1-6)
    python chip_smoke.py --four-cards   # the points-mesh path on 4 cards

One process owns the card(s) and calls what ``tpinn train --recipe`` and
``tpinn serve`` call.  Phases, in order:

1. device check: JAX version and devices, the card's name and power limit
   (nvidia-smi, a child process that never imports JAX).  Exits non-zero
   unless the default backend is ``gpu`` and the ``cpu`` platform is also
   present (the float64 host phases run there: ``JAX_PLATFORMS=cuda,cpu``
   or unset, never ``cuda`` alone);
2. what the matmul precision tiers compute on this card: one
   [45,500, 80] @ [80, 80] float32 product per tier against numpy float64;
3. the annulus loss and parameter gradient on the GPU (float32,
   ``make_loss(engine="auto")``) against the plain float64 reference
   (``core.refmode``) on the host CPU, at the net's "highest" chain and at
   the recipe's Adam tier "default";
4. ``run_training`` on the annulus recipe at its own widths and point
   counts, with only the epochs cut (``EPOCH_CUTS``); wall and compile
   seconds of each phase;
5. the phase-4 checkpoint loaded by ``tpinn.app.serve``'s own loader and
   served over HTTP on 127.0.0.1 from a thread of this process: /predict
   against the trained predictor, hard BCs, /residual, one request at
   the 262,144-point tier;
6. the last line of stdout: ``{"ok": true, "device": {...}}``.

Any failed phase raises, so the script exits non-zero and prints no ok
line.  ``--four-cards`` runs only the mesh path and what it is compared
with: the sharded loss gradient against the single-device one, the
phase-4 training on a 4-card points mesh, and a check that the params
are still replicated over the mesh after the LSQ polish.
"""

from __future__ import annotations

import argparse
import json
import sys
import threading
import time
import urllib.request
from dataclasses import replace
from http.server import ThreadingHTTPServer
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
RECIPE = "annulus_laplace"
# Point counts of the annulus recipe (problems/recipes.py), the sizes of
# phase 3's one draw
RECIPE_COUNTS = {"n_col": 30000, "n_band": 5000, "n_adaptive": 10000,
                 "n_bd": 500}
# The only cuts of the recipe: its epochs.  One density refresh runs in
# the Adam phase, and each of the 3 L-BFGS rounds takes 10 iterations.
EPOCH_CUTS = {"adam_epochs": 300, "lbfgs_epochs": 90,
              "density_every": 100, "tail_max": 300}
# Phase-3 tolerances of the float32 GPU loss against the float64 host
# reference: (relative loss error, max gradient error / max|g|).
TOLERANCES = {
    # float32 rounding and reduction order only
    "highest": (1e-5, 1e-4),
    # reduced tier: TF32 keeps about 3 decimal digits, so the bound only
    # catches a broken path, not rounding
    "default": (2e-2, 1e-1),
}
SERVE_TIER = 262_144
HARD_BC_TOL = 1e-5
# served /predict against the loaded predictor evaluated directly
PREDICT_TOL = 1e-6
# ... and against the trained predictor: the same function compiled with
# its params as constants, which moves float32 results by ~1e-6
TRAINED_TOL = 1e-5


def _import_tpinn():
    """Import tpinn from this checkout, and from nowhere else."""
    sys.path.insert(0, str(ROOT))
    import tpinn

    if Path(tpinn.__file__).resolve().parent.parent != ROOT:
        raise SystemExit(f"chip_smoke: tpinn imported from "
                         f"{tpinn.__file__}, not from {ROOT}")
    return tpinn


# ---------------------------------------------------------------------------
# Phase 1
# ---------------------------------------------------------------------------


def device_check(n_cards: int = 1) -> dict:
    import jax

    from tpinn.utils.device_info import card_name_and_power_limit, jax_device

    print(f"jax {jax.__version__}")
    print(f"devices: {jax.devices()}")
    device = jax_device()
    print(f"device_kind: {device['kind']}  count: {device['count']}")
    if jax.default_backend() != "gpu":
        raise SystemExit(f"chip_smoke: JAX's default backend is "
                         f"{jax.default_backend()!r}, not 'gpu'; this "
                         f"script needs an NVIDIA GPU")
    try:
        jax.devices("cpu")
    except RuntimeError:
        raise SystemExit("chip_smoke: no 'cpu' platform; the float64 host "
                         "phases need it (JAX_PLATFORMS=cuda,cpu or unset)")
    if device["count"] < n_cards:
        raise SystemExit(f"chip_smoke: {n_cards} cards needed, "
                         f"{device['count']} found")
    print(f"card: {card_name_and_power_limit()}")
    return device


# ---------------------------------------------------------------------------
# Phase 2
# ---------------------------------------------------------------------------


def precision_tiers(n: int = 45_500, k: int = 80, seed: int = 0) -> dict:
    """Max error of an f32 matmul at each precision tier, relative to
    max|C| of the float64 product."""
    import jax
    import jax.numpy as jnp

    rng = np.random.default_rng(seed)
    a = rng.standard_normal((n, k)).astype(np.float32)
    b = rng.standard_normal((k, k)).astype(np.float32)
    want = a.astype(np.float64) @ b.astype(np.float64)
    errs = {}
    for tier in ("default", "high", "highest"):
        mm = jax.jit(lambda x, y, t=tier: jnp.matmul(x, y, precision=t))
        got = np.asarray(mm(a, b), np.float64)
        errs[tier] = float(np.max(np.abs(got - want)) / np.max(np.abs(want)))
        print(f"precision {tier:8s}: max rel error {errs[tier]:.3e}")
    # float32 with k=80 terms: a few ulps; more means "highest" is not fp32
    if not errs["highest"] < 1e-5:
        raise AssertionError(f"'highest' matmul error {errs['highest']:.3e}")
    return errs


# ---------------------------------------------------------------------------
# Phase 3
# ---------------------------------------------------------------------------


def reference_check(counts=None, depth: int = 6, width: int = 80,
                    grid: int = 111, seed: int = 0) -> dict:
    """Loss and parameter gradient of the float32 loss on the default
    device against ``refmode``'s float64 loss on the host CPU."""
    import jax
    import jax.flatten_util
    import jax.numpy as jnp

    from tpinn import problems
    from tpinn.core import loss as loss_mod
    from tpinn.core import net, pde, refmode, sample
    from tpinn.utils.x64 import force_x64

    counts = dict(RECIPE_COUNTS if counts is None else counts)
    problem = problems.annulus_laplace()
    compiled = pde.compile_pde(problem.equation, problem.coords)
    fm = net.feature_map_for(problem.feature_kinds)
    f32 = jnp.float32
    params = net.init_params(jax.random.PRNGKey(seed),
                             net.MLPSpec(depth=depth, width=width), fm, f32)
    sample_fn, grids = sample.make_sampler(
        sample.SamplerConfig(grid=grid, **counts), problem.bc_groups,
        problem.lb, problem.ub, f32)
    data = sample_fn(jax.random.PRNGKey(seed + 1), jnp.ones_like(grids[0]))
    n_pts = data["x_col"].shape[0] + sum(x.shape[0] for x in data["x_bd"])
    print(f"reference check: {depth}x{width} tanh, {n_pts} points")

    cpu = jax.devices("cpu")[0]
    with force_x64(), jax.default_device(cpu):
        to64 = lambda t: jax.tree.map(
            lambda x: jax.device_put(np.asarray(x, np.float64), cpu), t)
        pred64 = net.make_predictor(
            net.MLPSpec(depth=depth, width=width), fm,
            jnp.asarray(problem.lb, jnp.float64),
            jnp.asarray(problem.ub, jnp.float64))
        ref_loss = refmode.make_reference_loss(pred64)
        (l64, _), g64 = jax.jit(jax.value_and_grad(ref_loss, has_aux=True))(
            to64(params), to64(data), to64(np.array([0.05, 0.0])),
            to64(np.array(1.0)))
        l64 = float(l64)
        g64 = np.asarray(jax.flatten_util.ravel_pytree(g64)[0])

    lw, ref = jnp.array([0.05, 0.0], f32), jnp.array(1.0, f32)
    out = {}
    for tier, (loss_tol, grad_tol) in TOLERANCES.items():
        pred = net.make_predictor(
            net.MLPSpec(depth=depth, width=width, precision=tier), fm,
            jnp.asarray(problem.lb, f32), jnp.asarray(problem.ub, f32))
        lf = loss_mod.make_loss(pred, compiled, engine="auto")
        (l32, _), g32 = jax.jit(jax.value_and_grad(lf, has_aux=True))(
            params, data, lw, ref)
        g32 = np.asarray(jax.flatten_util.ravel_pytree(g32)[0], np.float64)
        loss_err = abs(float(l32) - l64) / abs(l64)
        grad_err = float(np.max(np.abs(g32 - g64)) / np.max(np.abs(g64)))
        out[tier] = {"loss_rel_err": loss_err, "grad_err": grad_err}
        print(f"reference check {tier:8s}: loss {float(l32):.8e} vs "
              f"{l64:.8e} (rel err {loss_err:.3e}, tol {loss_tol:g}); "
              f"grad max err / max|g| {grad_err:.3e} (tol {grad_tol:g})")
        if not (loss_err <= loss_tol and grad_err <= grad_tol):
            raise AssertionError(f"{tier}: GPU loss/gradient off the "
                                 f"float64 reference: {out[tier]}")
    return out


# ---------------------------------------------------------------------------
# Phase 4
# ---------------------------------------------------------------------------


def recipe_spec(cuts=None, **overrides):
    """The annulus recipe with its epochs cut (``EPOCH_CUTS``) and any
    further ``TrainSpec`` overrides (the CPU tests shrink it)."""
    from tpinn import problems

    cuts = dict(EPOCH_CUTS if cuts is None else cuts)
    problem, spec = problems.get_recipe(RECIPE)
    stage_keys = {"adam_epochs", "lbfgs_epochs", "lbfgs_grid"}
    st = {k: v for k, v in {**cuts, **overrides}.items() if k in stage_keys}
    rest = {k: v for k, v in {**cuts, **overrides}.items()
            if k not in stage_keys}
    spec = replace(spec, stages=tuple(replace(s, **st) for s in spec.stages),
                   **rest)
    return problem, spec


def train_phase(out_dir: Path, mesh=None, cuts=None, **overrides):
    """``run_training`` on the cut recipe; asserts the run is sane and
    prints the wall and compile seconds of each phase."""
    from tpinn.core import train
    from tpinn.utils import artifacts

    problem, spec = recipe_spec(cuts, **overrides)
    st = spec.stages[0]
    print(f"training {RECIPE}: {len(spec.stages)} stage, "
          f"{st.depth}x{st.width}, adam_precision={spec.adam_precision}, "
          f"lbfgs_grid={st.lbfgs_grid}, lbfgs_rounds={st.lbfgs_rounds}, "
          f"lsq_polish={spec.lsq_polish}, deflation={spec.deflation}, "
          f"points {spec.n_col}/{spec.n_band}/{spec.n_adaptive}/{spec.n_bd}")
    print(f"cuts: {dict(EPOCH_CUTS if cuts is None else cuts)}"
          + (f", overrides: {overrides}" if overrides else ""))
    t0 = time.perf_counter()
    res = train.run_training(problem, spec, output_dir=str(out_dir),
                             mesh=mesh, print_log=True)
    wall = time.perf_counter() - t0
    for row in res.phase_walls:
        print(f"  stage {row['stage']} {row['phase']:12s} wall "
              f"{row['wall_s']:8.2f} s = compile {row['compile_s']:7.2f} s "
              f"+ run {row['wall_s'] - row['compile_s']:8.2f} s")
    print(f"training wall {wall:.2f} s, rel_l2 {res.rel_l2:.4e}")

    stage = res.stages[0]
    adam = stage.history[:stage.n_adam, 0]
    if not (stage.n_adam > 0 and np.all(np.isfinite(adam))):
        raise AssertionError("non-finite (or no) Adam loss")
    tail = adam[-max(1, len(adam) // 6):].mean()
    if not tail < adam[0]:
        raise AssertionError(f"Adam loss did not fall: {adam[0]:.4e} -> "
                             f"{tail:.4e}")
    if not (res.rel_l2 is not None and np.isfinite(res.rel_l2)):
        raise AssertionError(f"rel_l2 {res.rel_l2}")
    # the contract's files of the stages this recipe has (one stage: the
    # "_1" files and the stage-1 spectrum), plus each stage's checkpoint
    ends = tuple(f"_{i + 1}.npz" for i in range(len(spec.stages)))
    want = [n for n in artifacts.ARTIFACT_NAMES
            if n.endswith(ends) or n == "frequency_spectrum.npz"]
    want += [f"params_stage_{i + 1}.npz" for i in range(len(spec.stages))]
    missing = [n for n in want if not (out_dir / n).exists()]
    if missing:
        raise AssertionError(f"missing artifacts: {missing}")
    print(f"artifacts: {len(want)} files present in {out_dir}")
    return res


# ---------------------------------------------------------------------------
# Phase 5
# ---------------------------------------------------------------------------


def _post(port: int, path: str, points) -> dict:
    body = json.dumps({"points": np.asarray(points).tolist()}).encode()
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=body,
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=600) as r:
        out = json.loads(r.read())
    if "error" in out:
        raise AssertionError(f"{path}: {out['error']}")
    return out


def serve_phase(checkpoint: Path, trained_fn, big: int = SERVE_TIER,
                seed: int = 0) -> dict:
    """Serve ``checkpoint`` over HTTP; check /predict against the loaded
    predictor evaluated directly and against ``trained_fn`` (the trained
    predictor, z -> u)."""
    import jax
    import jax.numpy as jnp

    from tpinn import problems
    from tpinn.app.serve import PINNServer, make_handler

    problem = problems.get_problem(RECIPE)
    lb, ub = np.asarray(problem.lb), np.asarray(problem.ub)
    rng = np.random.default_rng(seed)
    server = PINNServer(str(checkpoint), RECIPE)
    direct_fn = jax.jit(server.predictor)
    trained_fn = jax.jit(trained_fn)
    httpd = ThreadingHTTPServer(("127.0.0.1", 0), make_handler(server))
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    try:
        port = httpd.server_address[1]
        out = {}
        for name, n in (("small", 5), ("mid", 1000), ("big", big)):
            z = (lb + rng.random((n, 2)) * (ub - lb)).astype(np.float32)
            t0 = time.perf_counter()
            u = np.asarray(_post(port, "/predict", z)["u"])
            dt = time.perf_counter() - t0
            # evaluated on the batch the server pads the request to
            zp = jnp.asarray(np.concatenate(
                [z, np.repeat(z[-1:], server._tier(n) - n, axis=0)]))
            direct = np.asarray(direct_fn(server.params, zp))[:n, 0]
            trained = np.asarray(trained_fn(zp))[:n, 0]
            err = float(np.max(np.abs(u - direct)))
            err_t = float(np.max(np.abs(u - trained)))
            out[f"predict_{name}"] = {"n": n, "s": dt, "max_err": err,
                                      "max_err_trained": err_t}
            print(f"/predict {n:7d} pts: {dt:.3f} s, max |served - direct| "
                  f"{err:.3e}, |served - trained| {err_t:.3e}")
            if not (u.shape == (n,) and err <= PREDICT_TOL
                    and err_t <= TRAINED_TOL):
                raise AssertionError(f"/predict off the predictor: "
                                     f"{out[f'predict_{name}']}")
        z = (lb + rng.random((1000, 2)) * (ub - lb)).astype(np.float32)
        t0 = time.perf_counter()
        f = np.asarray(_post(port, "/residual", z)["f"])
        dt = time.perf_counter() - t0
        rms = float(np.sqrt(np.mean(f ** 2)))
        print(f"/residual    1000 pts: {dt:.3f} s, rms {rms:.3e}")
        if not (f.shape == (1000,) and np.all(np.isfinite(f))):
            raise AssertionError("/residual not finite")
        t = rng.random(64) * (ub[1] - lb[1]) + lb[1]
        bc_err = 0.0
        for r, target in ((lb[0], 1.0), (ub[0], 0.0)):
            z = np.stack([np.full_like(t, r), t], axis=1).astype(np.float32)
            u = np.asarray(_post(port, "/predict", z)["u"])
            bc_err = max(bc_err, float(np.max(np.abs(u - target))))
        print(f"hard BC: max |u(0.1,.) - 1|, |u(1,.)| = {bc_err:.3e}")
        if not bc_err <= HARD_BC_TOL:
            raise AssertionError(f"hard BC violated by {bc_err:.3e}")
        out["bc_err"] = bc_err
        return out
    finally:
        httpd.shutdown()
        httpd.server_close()
        thread.join(timeout=30)


# ---------------------------------------------------------------------------
# --four-cards
# ---------------------------------------------------------------------------


def mesh_gradient_check(mesh, counts=None, depth: int = 6, width: int = 80,
                        grid: int = 111, seed: int = 0) -> float:
    """Max |sharded - single-device| loss gradient over max|g|."""
    import jax
    import jax.flatten_util
    import jax.numpy as jnp

    from tpinn import parallel, problems
    from tpinn.core import loss as loss_mod
    from tpinn.core import net, pde, sample

    counts = dict(RECIPE_COUNTS if counts is None else counts)
    problem = problems.annulus_laplace()
    compiled = pde.compile_pde(problem.equation, problem.coords)
    fm = net.feature_map_for(problem.feature_kinds)
    spec = net.MLPSpec(depth=depth, width=width)
    params = net.init_params(jax.random.PRNGKey(seed), spec, fm)
    pred = net.make_predictor(spec, fm, jnp.asarray(problem.lb),
                              jnp.asarray(problem.ub))
    sample_fn, grids = sample.make_sampler(
        sample.SamplerConfig(grid=grid, **{k: parallel.round_count(v, mesh)
                                           for k, v in counts.items()}),
        problem.bc_groups, problem.lb, problem.ub)
    data = sample_fn(jax.random.PRNGKey(seed + 1), jnp.ones_like(grids[0]))
    lf = loss_mod.make_loss(pred, compiled)
    lw, ref = jnp.array([0.05, 0.0]), jnp.array(1.0)
    dev0 = jax.devices()[0]
    g1 = jax.jit(jax.grad(lambda p, d: lf(p, d, lw, ref)[0]))(
        jax.device_put(params, dev0), jax.device_put(data, dev0))
    ploss = parallel.make_parallel_loss(lf, mesh)
    g2 = jax.jit(jax.grad(lambda p, d: ploss(p, d, lw, ref)[0]))(
        jax.device_put(params, parallel.replicated(mesh)),
        parallel.shard_data(data, mesh))
    f1 = np.asarray(jax.flatten_util.ravel_pytree(g1)[0])
    f2 = np.asarray(jax.flatten_util.ravel_pytree(g2)[0])
    err = float(np.max(np.abs(f2 - f1)) / np.max(np.abs(f1)))
    print(f"sharded gradient on mesh {dict(mesh.shape)}: max |mesh - "
          f"single| / max|g| {err:.3e} (tol 1e-4)")
    if not err <= 1e-4:
        raise AssertionError(f"sharded gradient off by {err:.3e}")
    return err


def assert_replicated(params, mesh) -> None:
    import jax

    devices = set(mesh.devices.flat)
    for leaf in jax.tree.leaves(params):
        sh = leaf.sharding
        if not (sh.is_fully_replicated and sh.device_set == devices):
            raise AssertionError(f"param not replicated over the mesh: {sh}")


def four_cards(out_dir: Path) -> None:
    import jax

    from tpinn import parallel

    mesh = parallel.make_mesh(jax.devices()[:4])
    mesh_gradient_check(mesh)
    res = train_phase(out_dir, mesh=mesh)
    assert_replicated(res.stages[-1].params, mesh)
    print(f"params replicated over {len(mesh.devices.flat)} devices after "
          f"the LSQ polish")


# ---------------------------------------------------------------------------


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--four-cards", action="store_true",
                   help="run only the 4-card points-mesh path")
    p.add_argument("--out", default=None,
                   help="training output directory (default "
                        "out/chip_smoke[_4cards] under the checkout)")
    args = p.parse_args(argv)

    _import_tpinn()
    from tpinn.utils.compile_cache import enable_compile_cache

    n_cards = 4 if args.four_cards else 1
    device = device_check(n_cards)
    print(f"compile cache: {enable_compile_cache()}")
    out_dir = Path(args.out) if args.out else (
        ROOT / "out" / ("chip_smoke_4cards" if args.four_cards
                        else "chip_smoke"))
    if args.four_cards:
        four_cards(out_dir)
    else:
        precision_tiers()
        reference_check()
        res = train_phase(out_dir)
        serve_phase(out_dir / "params_stage_1.npz", res.predict)
    print(json.dumps({"ok": True, "device": device}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
