"""Overlapping-patch decomposition: many small nets, one global solution.

The reference trains ONE network over the whole domain (software.py:207-218)
— which is exactly what fails on multiscale problems: a global MLP must
resolve the finest feature everywhere (spectral bias), and its conditioning
degrades with the frequency range.  This module adds the FBPINN-style
decomposition (Moseley, Markham & Nissen-Meyer, 2023 — finite-basis
physics-informed neural networks; public method): partition the box into P
overlapping patches, give each its own small net normalized to ITS box,
and blend with a smooth partition of unity

    u(z) = Σ_p  ŵ_p(z) · N_p((z − c_p)/h_p),      ŵ_p = w_p / Σ_q w_q

with w_p a cos² bump supported on the patch.  Every patch sees an O(1)
problem at its own scale; the loss trains all patches JOINTLY through the
summed predictor, so continuity needs no interface terms — the overlap
does it.

Device design: all P nets evaluate at ALL collocation points as one
``jax.vmap`` over stacked parameters — a batched matmul chain
(P small matmuls fused into one [P, N, W] contraction) with static
shapes; no gather/scatter, no per-patch point routing.  The stacked
pytree has exactly the ensemble layout (leading P axis), so on a mesh it
shards over the mesh's 'ensemble' axis unchanged (tpinn/parallel/mesh.py)
— patch-parallelism IS ensemble-parallelism with a spatial window.

Derivatives ride the standard forward-mode engine (the composite is a
plain callable; taylor.fast_partials dispatches nested-jvp through the
vmap), so residuals of any compiled PDE work unchanged.
"""

from __future__ import annotations

import sys
from dataclasses import dataclass, replace
from typing import Callable, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from tpinn.core import loss as loss_mod
from tpinn.core import net, optim, pde, sample
from tpinn.core.train import ProblemSpec, TrainSpec, eval_grid, make_density_fn

Array = jax.Array


@dataclass(frozen=True)
class PatchSpec:
    """Patch grid: ``n[i]`` patches along axis i, cos²-bump windows.

    ``overlap`` is the fractional widening of each patch beyond its
    uniform cell (0.5 → each patch is 1.5 cells wide).  Must be > 0 so
    neighbouring bumps overlap and the partition of unity stays positive
    everywhere.
    """

    n: Tuple[int, ...]
    overlap: float = 0.5

    def __post_init__(self):
        if not self.n or any(int(k) < 1 for k in self.n):
            raise ValueError(f"PatchSpec.n must be positive ints, got {self.n}")
        if not 0.0 < self.overlap <= 2.0:
            raise ValueError("PatchSpec.overlap must be in (0, 2]")

    @property
    def count(self) -> int:
        out = 1
        for k in self.n:
            out *= int(k)
        return out


def patch_geometry(patch: PatchSpec, lb, ub, dtype=jnp.float32):
    """(centers [P, d], half_widths [d]) of the overlapping patch boxes."""
    import itertools

    lb = np.asarray(lb, np.float64)
    ub = np.asarray(ub, np.float64)
    d = lb.shape[0]
    if len(patch.n) != d:
        raise ValueError(f"PatchSpec.n has {len(patch.n)} axes for a "
                         f"{d}-D domain")
    steps = (ub - lb) / np.asarray(patch.n, np.float64)
    half = steps * (1.0 + patch.overlap) / 2.0
    axes = [lb[i] + (np.arange(patch.n[i]) + 0.5) * steps[i]
            for i in range(d)]
    centers = np.asarray([c for c in itertools.product(*axes)], np.float64)
    return (jnp.asarray(centers, dtype), jnp.asarray(half, dtype))


def make_patch_predictor(
    mspec: net.MLPSpec,
    patch: PatchSpec,
    lb,
    ub,
    dtype=jnp.float32,
    pad_features: int = 0,
):
    """``u(stacked_params, z)`` over the partition of unity.

    ``stacked_params`` carries a leading P axis on every leaf
    (init via :func:`init_patch_params`).
    """
    centers, half = patch_geometry(patch, lb, ub, dtype)
    fm = net.feature_map_for((net.MINMAX,) * centers.shape[1],
                             pad_to=pad_features)

    def _window(z):
        # cos² bump per axis, product over axes: [P, N, 1]
        t = jnp.abs(z[None, :, :] - centers[:, None, :]) / half[None, None, :]
        w = jnp.where(t < 1.0, jnp.cos(0.5 * jnp.pi * jnp.minimum(t, 1.0))
                      ** 2, 0.0)
        return jnp.prod(w, axis=2, keepdims=True)

    def predictor(stacked, z):
        lo = centers - half[None, :]
        hi = centers + half[None, :]

        def one(p, l, h):
            return mspec.epsil * net.mlp_apply(p, fm(z, l, h), mspec)

        u_all = jax.vmap(one)(stacked, lo, hi)          # [P, N, 1]
        w = _window(z)
        return jnp.sum(u_all * w, axis=0) / (
            jnp.sum(w, axis=0) + jnp.asarray(1e-12, z.dtype))

    predictor.tpinn_patch = (centers, half)
    return predictor


def init_patch_params(key, mspec, patch: PatchSpec, dtype=jnp.float32,
                      pad_features: int = 0):
    fm = net.feature_map_for((net.MINMAX,) * len(patch.n),
                             pad_to=pad_features)
    keys = jax.random.split(key, patch.count)
    return jax.vmap(lambda k: net.init_params(k, mspec, fm, dtype))(keys)


@dataclass
class PatchResult:
    rel_l2: Optional[float]
    params: dict
    predict: Callable[[Array], Array]
    history: np.ndarray
    n_patches: int


def run_patched(
    problem: ProblemSpec,
    spec: TrainSpec,
    patch: PatchSpec,
    log_fn: Optional[Callable] = None,
    print_log: bool = False,
    mesh=None,
    output_dir: Optional[str] = None,
    resume: bool = False,
) -> PatchResult:
    """Train the patched predictor: single-stage Adam → L-BFGS on the
    joint stacked pytree (``spec.stages[0]`` sets the PER-PATCH net).

    ``mesh``: point batches shard over the mesh's 'points' axis; the
    stacked patch params stay replicated (sharding them over the
    'ensemble' axis is the pod layout — patch nets are independent until
    the window sum, one psum per step).

    ``resume=True`` with ``output_dir``: a finished run's
    params_stage_1.npz short-circuits training entirely; with
    ``spec.checkpoint_every > 0`` a killed run additionally resumes the
    Adam phase from adam_state_stage_1.npz at the last saved chunk
    (same contract as run_training).
    """
    if not spec.stages:
        spec = spec.with_default_stages()
    st = spec.stages[0]
    dtype = jnp.dtype(spec.dtype)

    def log(msg):
        if log_fn is not None:
            log_fn(msg)
        if print_log:
            print(msg, file=sys.stderr)

    if problem.hard_bc is not None:
        raise ValueError("run_patched poses BCs softly; hard_bc is the "
                         "single-net path (net.wrap_hard_bc)")
    dropped = [k for k in ("lsq_polish", "deflation")
               if getattr(spec, k, "off") != "off"]
    if spec.ring_weight > 0:
        dropped.append("ring_weight")
    if len(spec.stages) > 1:
        dropped.append(f"stages[1:{len(spec.stages)}]")
    if dropped:
        log("patched: option(s) " + ", ".join(dropped)
            + " have no patched-path implementation and are ignored")
    compiled = pde.compile_pde(problem.equation, problem.coords)
    source_fn = (pde.compile_coord_expr(problem.source, problem.coords)
                 if problem.source else None)
    from tpinn.core.train import resolve_residual_weight

    rw_fn = resolve_residual_weight(problem)

    mspec = net.MLPSpec(
        depth=st.depth, width=st.width,
        act_first=st.act_first, act_hidden=st.act_hidden,
        scl=float(st.scl if st.scl is not None else 1.0),
        epsil=float(st.epsil if st.epsil is not None else 1.0),
    )
    predictor = make_patch_predictor(mspec, patch, problem.lb, problem.ub,
                                     dtype, spec.pad_features)
    key = jax.random.PRNGKey(spec.seed)
    k_init, k_adam, k_lbfgs = jax.random.split(key, 3)
    params = init_patch_params(k_init, mspec, patch, dtype,
                               spec.pad_features)
    log(f"patched: {patch.count} patches ({'x'.join(map(str, patch.n))}), "
        f"{st.depth}x{st.width} net each, overlap {patch.overlap:g}")
    if mesh is not None and mesh.shape.get("ensemble", 1) > 1:
        # PATCH-PARALLELISM: the stacked pytree's leading P axis shards
        # over the mesh's 'ensemble' axis (each chip group holds its own
        # patches); the window-weighted sum over P becomes one psum —
        # XLA inserts it from the sharding constraint.  Composes with
        # points-DP on the other axis.
        from jax.sharding import NamedSharding
        from jax.sharding import PartitionSpec as P

        n_ens = mesh.shape["ensemble"]
        if patch.count % n_ens != 0:
            raise ValueError(
                f"{patch.count} patches not divisible by the mesh's "
                f"ensemble axis ({n_ens})")
        sh = NamedSharding(mesh, P("ensemble"))
        params = jax.tree.map(lambda a: jax.device_put(a, sh), params)
        log(f"patched: {patch.count} patches sharded over "
            f"{n_ens} ensemble-axis groups")

    if mesh is None:
        _rc = lambda n: n
    else:
        from tpinn.parallel import round_count

        _rc = lambda n: round_count(max(1, n), mesh) if n else 0
    cfg = sample.SamplerConfig(
        n_col=_rc(spec.n_col), n_band=_rc(spec.n_band),
        n_adaptive=_rc(spec.n_adaptive), n_bd=_rc(spec.n_bd),
        grid=spec.grid,
    )
    sample_fn, grids = sample.sampler_for(
        cfg, problem.bc_groups, problem.lb, problem.ub, dtype)
    F0 = jnp.ones_like(grids[0])
    density_fn = make_density_fn(predictor, compiled, grids, source_fn,
                                 mask_fn=problem.eval_mask)

    loss_fn = loss_mod.make_loss(predictor, compiled, source_fn,
                                 residual_weight_fn=rw_fn)
    info_width = loss_mod.loss_info_width(len(problem.bc_groups))

    if mesh is not None:
        from tpinn import parallel

        loss_fn = parallel.make_parallel_loss(loss_fn, mesh)
        sample_fn = parallel.sharded_sampler(sample_fn, mesh)

    lw = jnp.asarray(spec.lw, dtype)
    data0 = sample_fn(k_adam, F0)
    if mesh is not None:
        from tpinn import parallel

        data0 = parallel.shard_data(data0, mesh)
    ref = jax.jit(loss_fn)(params, data0, lw, jnp.asarray(1.0, dtype))[1][0]
    log(f"patched: initial loss {float(ref):.4e}")

    adam_cfg = optim.AdamConfig(
        epochs=st.adam_epochs,
        lr=(st.lr if st.lr is not None else spec.lr),
        resample_every=spec.resample_every,
        density_every=spec.density_every,
        plateau_every=spec.plateau_every,
        lr_min=spec.lr_min, tail_max=spec.tail_max,
        log_every=spec.log_every, layout=spec.adam_layout,
    )
    adam_log = None
    if log_fn is not None or print_log:
        from tpinn.utils.logging import format_step_line

        def adam_log(step, loss_info):  # noqa: F811
            log(format_step_line(int(step), np.asarray(loss_info)))

    phase = optim.make_adam_phase(
        loss_fn, sample_fn, density_fn, adam_cfg, info_width, adam_log
    )

    from pathlib import Path

    out = Path(output_dir) if output_dir is not None else None
    final_ckpt = out / "params_stage_1.npz" if out else None
    adam_ckpt = out / "adam_state_stage_1.npz" if out else None

    if resume and final_ckpt is not None and final_ckpt.exists():
        from tpinn.utils.checkpoint import load_pytree

        params, _ = load_pytree(final_ckpt, params)
        log("patched: resumed finished run from params_stage_1.npz "
            "(training skipped)")
        hist_adam = np.zeros((0, info_width), np.float64)
        hist_lbfgs = np.zeros((0, info_width), np.float64)
        st = replace(st, lbfgs_epochs=0)  # skip both phases below
        res = None
    else:
        init_phase = None
        if resume and adam_ckpt is not None and adam_ckpt.exists():
            from tpinn.utils.checkpoint import load_phase_state

            try:
                like = phase.make_state0(k_adam, params, data0, F0, ref)
                init_phase = load_phase_state(adam_ckpt, like)
                log(f"patched: resuming Adam mid-run at step "
                    f"{init_phase[0]}/{st.adam_epochs}")
            except Exception as e:
                log(f"patched: mid-run checkpoint unusable ({e}); "
                    "restarting the Adam phase")
        ckpt_cb = None
        if adam_ckpt is not None and spec.checkpoint_every > 0:
            from tpinn.utils.checkpoint import save_phase_state

            _last = [init_phase[0] if init_phase else 0]

            def ckpt_cb(done, state, hist):  # noqa: F811
                if (done - _last[0] >= spec.checkpoint_every
                        or done >= st.adam_epochs):
                    save_phase_state(adam_ckpt, done, state, hist)
                    _last[0] = done

        res = phase(k_adam, params, data0, F0, lw, ref,
                    ckpt_cb=ckpt_cb, init=init_phase)
        int(res.n_valid)  # host sync
        params = res.params
        hist_adam = np.asarray(res.history[: int(res.n_valid)])

    if res is not None:
        hist_lbfgs = np.zeros((0, info_width), np.float64)
    if res is not None and st.lbfgs_epochs > 0:
        lb_cfg = optim.LBFGSConfig(
            max_iters=max(1, st.lbfgs_epochs // 3),
            history=spec.lbfgs_history,
        )
        data_l = sample_fn(k_lbfgs, res.density)
        params, hist, n_rows = optim.lbfgs_over_pytree(
            loss_fn, params, data_l, lw, ref, lb_cfg
        )
        hist_lbfgs = np.asarray(hist[: int(n_rows)])

    predict = lambda z: predictor(params, z)
    rel_l2 = None
    if problem.exact is not None:
        from tpinn.core.train import resolve_testing_size

        tsize = resolve_testing_size(problem, spec.testing_size, log,
                                     label="patched: ")
        X_star, _, _ = eval_grid(problem, tsize, dtype)
        u = predict(X_star)
        e = jnp.asarray(problem.exact(X_star), dtype)
        if problem.eval_mask is not None:
            m = problem.eval_mask(X_star)
            u, e = u * m, e * m
        rel_l2 = float(loss_mod.relative_l2(u, e))
        log(f"patched: rel-L2 {rel_l2:.3e}")

    history = (np.concatenate([hist_adam, hist_lbfgs], axis=0)
               if hist_lbfgs.size else hist_adam)

    if out is not None:
        import json

        from tpinn.utils.checkpoint import save_pytree

        out.mkdir(parents=True, exist_ok=True)
        save_pytree(
            out / "params_stage_1.npz", params,
            meta={"stage": 1, "scl": mspec.scl, "epsil": mspec.epsil,
                  "problem": problem.name,
                  "chain": [net.spec_to_dict(mspec)],
                  "feature_kinds": list(problem.feature_kinds),
                  "lb": list(problem.lb), "ub": list(problem.ub),
                  "hard_bc": None, "coords": list(problem.coords),
                  "pad_features": spec.pad_features,
                  "equation": problem.equation,
                  "patch": {"n": list(patch.n),
                            "overlap": patch.overlap}},
        )
        (out / "patched.json").write_text(json.dumps({
            "problem": problem.name, "n_patches": patch.count,
            "n": list(patch.n), "overlap": patch.overlap,
            "rel_l2": rel_l2,
        }, indent=1))
        log(f"patched: checkpoint written to {out}")

    return PatchResult(rel_l2=rel_l2, params=params, predict=predict,
                       history=history, n_patches=patch.count)
