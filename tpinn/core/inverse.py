"""Inverse problems: recover unknown PDE coefficients from observations.

The reference application is forward-only — its solver hardcodes one fully
specified residual (software.py:283-297) and has no notion of data
assimilation.  This module extends the framework past that boundary with
the classic PINN inverse formulation (Raissi et al.): the equation string
declares named unknown coefficients (``"u_t - lam*u_xx"`` with
``params=("lam",)``, tpinn.core.pde.compile_pde), the coefficients become
scalar leaves of the TRAINING pytree, and a pointwise observation term

    loss = loss_bc + obs_weight·MSE(u(z_obs) − u_obs) + lw[0]·loss_eqn

identifies them jointly with the network weights.  Everything reuses the
forward machinery unchanged — the scanned Adam automaton and the pure-XLA
L-BFGS are pytree-generic, so the joint ``{"net": …, "coef": {…}}``
parameter tree rides the exact same compiled phases (optim.make_adam_phase,
optim.lbfgs_over_pytree); the coefficient adds one scalar per unknown to
the raveled flat layout and nothing else.

``loss_info`` layout (the UI contract, loss.py) gains one column:
``[loss, loss_data, loss_eqn, data_err_1..G, obs_err, eqn_err]`` — the
observation term is a data term, so it lands in the data block and the
loss/boundary figures render it like an extra BC group.
"""

from __future__ import annotations

import sys
from dataclasses import dataclass
from typing import Callable, Dict, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from tpinn.core import loss as loss_mod
from tpinn.core import net, optim, pde, sample
from tpinn.core.train import ProblemSpec, TrainSpec

Array = jax.Array


@dataclass(frozen=True)
class InverseSpec:
    """What to identify: coefficient names, initial guesses, observations.

    ``params``/``init`` must align; the names must appear in the problem's
    equation string.  When ``observations`` is not passed to
    :func:`run_inverse`, ``n_obs`` points are LHS-drawn over the domain and
    labelled by ``problem.exact`` (+ optional Gaussian noise of std
    ``obs_noise``) — the standard synthetic-benchmark protocol.
    """

    params: Tuple[str, ...]
    init: Tuple[float, ...]
    n_obs: int = 200
    obs_noise: float = 0.0
    obs_weight: float = 1.0
    obs_seed: int = 0
    # EIGENVALUE mode: > 0 replaces the observation MSE with the
    # normalization penalty (mean u² over n_obs domain points − normalize)²
    # — no oracle or observations needed.  The residual of
    # ``"u_xx + lam*u"`` with homogeneous BCs has the trivial minimum
    # u ≡ 0 at ANY lam; pinning the solution's mean-square excludes it, so
    # the joint optimization converges to an eigenpair near the initial
    # guess (λ rides the same coefficient machinery as any unknown).
    # For -u'' = λu on [0,1]: normalize=0.5 targets ‖sin πx‖²
    normalize: float = 0.0

    def __post_init__(self):
        if len(self.params) != len(self.init):
            raise ValueError("InverseSpec.init must align with .params")
        if not self.params:
            raise ValueError("InverseSpec needs at least one parameter")
        if self.normalize < 0:
            raise ValueError("InverseSpec.normalize must be >= 0")


@dataclass
class InverseResult:
    coef: Dict[str, float]                 # recovered coefficient values
    coef_adam: Dict[str, float]            # values at the Adam→L-BFGS handoff
    rel_l2: Optional[float]                # solution error vs analytic
    params: dict                           # joint {"net", "coef"} pytree
    predict: Callable[[Array], Array]      # z -> u with trained weights
    history: np.ndarray                    # loss_info rows, both phases
    z_obs: np.ndarray
    u_obs: np.ndarray


def make_inverse_loss(
    predictor: Callable[[dict, Array], Array],
    compiled: pde.CompiledPDE,
    z_obs: Array,
    u_obs: Array,
    source_fn: Optional[Callable[[Array], Array]] = None,
    residual_weight_fn: Optional[Callable[[Array], Array]] = None,
    obs_weight: float = 1.0,
    bc_operators=None,
    normalize: float = 0.0,
):
    """Joint loss over ``params = {"net": net_pytree, "coef": {name: scalar}}``.

    Same ``(params, data, lw, ref) -> (loss_n, loss_info)`` contract as
    loss.make_loss so the optimizer drivers are reused verbatim; the
    residual rides the structure-aware fused engine (pde.residual_fast) with
    the coefficient dict threaded through the expression evaluation, so the
    tangent passes stay fused into the MLP matmuls.
    """

    def loss_fn(params: dict, data: Dict, lw: Array, ref: Array):
        net_p, coef = params["net"], params["coef"]
        f_u = lambda z: predictor(net_p, z)

        data_errs = []
        for gi, (z_bd, u_bd) in enumerate(zip(data["x_bd"], data["u_bd"])):
            op = bc_operators[gi] if bc_operators else None
            # operator BCs may reference the unknown coefficients too
            # (e.g. a Robin condition with an unknown transfer coefficient)
            bd_val = (op.residual(f_u, z_bd, coef) if op is not None
                      else f_u(z_bd))
            data_errs.append(loss_mod.ms_error(bd_val - u_bd))
        if normalize > 0.0:
            # eigen mode: pin the mean-square amplitude instead of values
            u_n = f_u(z_obs)
            obs_err = (jnp.mean(u_n * u_n) - normalize)[None] ** 2
        else:
            obs_err = loss_mod.ms_error(f_u(z_obs) - u_obs)
        data_errs.append(obs_err)
        data_err = jnp.concatenate(data_errs)

        x_col = data["x_col"]
        f = compiled.residual_fast(predictor, net_p, x_col, coef)
        if source_fn is not None:
            f = f - source_fn(x_col)
        if residual_weight_fn is not None:
            f = residual_weight_fn(x_col) * f
        eqn_err = loss_mod.ms_error(f)

        loss_data = jnp.sum(data_err[:-1]) + obs_weight * obs_err[0]
        loss_eqn = jnp.sum(eqn_err)
        loss = loss_data + lw[0] * loss_eqn
        loss_n = loss / ref
        loss_info = jnp.concatenate(
            [jnp.stack([loss, loss_data, loss_eqn]), data_err, eqn_err]
        )
        return loss_n, loss_info

    return loss_fn


def synth_observations(
    problem: ProblemSpec, inv: InverseSpec, dtype
) -> Tuple[Array, Array]:
    """LHS observation points labelled by the analytic solution (+ noise)."""
    if problem.exact is None:
        raise ValueError(
            f"problem {problem.name!r} has no analytic solution to "
            f"synthesize observations from — pass observations=(z, u)"
        )
    key = jax.random.PRNGKey(inv.obs_seed)
    k_pts, k_noise = jax.random.split(key)
    lb = jnp.asarray(problem.lb, dtype)
    ub = jnp.asarray(problem.ub, dtype)
    z_obs = sample.lhs_box(k_pts, inv.n_obs, lb, ub, dtype)
    u_obs = jnp.asarray(problem.exact(z_obs), dtype)
    if inv.obs_noise > 0.0:
        u_obs = u_obs + inv.obs_noise * jax.random.normal(
            k_noise, u_obs.shape, dtype
        )
    return z_obs, u_obs


def run_inverse(
    problem: ProblemSpec,
    inv: InverseSpec,
    spec: TrainSpec,
    observations: Optional[Tuple[Array, Array]] = None,
    log_fn: Optional[Callable] = None,
    print_log: bool = False,
    mesh=None,
    output_dir: Optional[str] = None,
) -> InverseResult:
    """Identify the equation's unknown coefficients from observations.

    Single-stage Adam → L-BFGS over the joint pytree; ``spec.stages[0]``
    sets the architecture and epoch budgets (inverse identification has no
    analog of the reference's frozen-correction stage chain — the
    coefficient must stay live through every phase).

    ``mesh``: a jax.sharding.Mesh (tpinn.parallel.make_mesh) — collocation
    and BC batches shard over the 'points' axis exactly as in the forward
    path (one gradient psum per step); the joint pytree, including
    the coefficient scalars, stays replicated.  Observations are small and
    replicated (their MSE is computed redundantly per chip — free).
    """
    if not spec.stages:
        spec = spec.with_default_stages()
    st = spec.stages[0]
    dtype = jnp.dtype(spec.dtype)

    def log(msg: str):
        if log_fn is not None:
            log_fn(msg)
        if print_log:
            print(msg, file=sys.stderr)

    compiled = pde.compile_pde(problem.equation, problem.coords, inv.params)
    source_fn = (
        pde.compile_coord_expr(problem.source, problem.coords)
        if problem.source else None
    )
    from tpinn.core.train import resolve_residual_weight

    rw_fn = resolve_residual_weight(problem)
    feature_map = net.feature_map_for(problem.feature_kinds,
                                      pad_to=spec.pad_features)
    lb = jnp.asarray(problem.lb, dtype)
    ub = jnp.asarray(problem.ub, dtype)

    mspec = net.MLPSpec(
        depth=st.depth, width=st.width, act_first=st.act_first,
        act_hidden=st.act_hidden,
        scl=float(st.scl if st.scl is not None else 1.0),
        epsil=float(st.epsil if st.epsil is not None else 1.0),
        fourier_features=st.fourier_features,
        fourier_scale=st.fourier_scale, modified=st.modified,
    )
    key = jax.random.PRNGKey(spec.seed)
    k_init, k_adam, k_lbfgs = jax.random.split(key, 3)
    net_params = net.init_params(k_init, mspec, feature_map, dtype)
    raw_predictor = net.make_predictor(mspec, feature_map, lb, ub)
    if problem.hard_bc is not None:
        hard_fns = tuple(
            pde.compile_coord_expr(e, problem.coords) for e in problem.hard_bc
        )
        predictor = net.wrap_hard_bc(raw_predictor, *hard_fns)
    else:
        predictor = raw_predictor

    params = {
        "net": net_params,
        "coef": {n: jnp.asarray(v, dtype) for n, v in
                 zip(inv.params, inv.init)},
    }

    if inv.normalize > 0.0:
        # eigen mode: fixed LHS normalization points, no labels needed
        z_obs = sample.lhs_box(jax.random.PRNGKey(inv.obs_seed),
                               inv.n_obs, lb, ub, dtype)
        u_obs = jnp.zeros((inv.n_obs, 1), dtype)
        log(f"inverse: eigen mode — {len(inv.params)} coefficient(s) "
            f"{inv.params}, mean-square normalization {inv.normalize:g} "
            f"over {inv.n_obs} points")
    elif observations is not None:
        z_obs = jnp.asarray(observations[0], dtype)
        u_obs = jnp.asarray(observations[1], dtype)
        if u_obs.ndim == 1:
            u_obs = u_obs[:, None]
        log(f"inverse: {len(inv.params)} coefficient(s) {inv.params}, "
            f"{z_obs.shape[0]} observations (noise {inv.obs_noise:g})")
    else:
        z_obs, u_obs = synth_observations(problem, inv, dtype)
        log(f"inverse: {len(inv.params)} coefficient(s) {inv.params}, "
            f"{z_obs.shape[0]} observations (noise {inv.obs_noise:g})")

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

    # adaptive density over the JOINT pytree: the residual (and therefore
    # the refresh, software.py:608-623) depends on the current coefficient,
    # so train.make_density_fn (which has no coef channel) is re-derived
    # here with the live coefficient threaded through
    z_grid, reshape_g, smooth = sample.density_geometry(grids)

    def density_fn(joint):
        f0 = compiled.residual_fast(
            predictor, joint["net"], z_grid, joint["coef"])
        if source_fn is not None:
            f0 = f0 - source_fn(z_grid)
        f_sq = f0 ** 2
        f_nm = f_sq / jnp.mean(f_sq) + 0.5
        if problem.eval_mask is not None:
            # masked non-box domain: adaptive points must not chase the
            # unconstrained dead-region residual (train.make_density_fn)
            f_nm = f_nm * problem.eval_mask(z_grid)
        return smooth(reshape_g(f_nm))

    bc_ops = tuple(
        pde.compile_pde(g.operator, problem.coords, inv.params)
        if g.operator else None
        for g in problem.bc_groups
    )
    if not any(o is not None for o in bc_ops):
        bc_ops = None
    loss_fn = make_inverse_loss(
        predictor, compiled, z_obs, u_obs, source_fn, rw_fn, inv.obs_weight,
        bc_operators=bc_ops, normalize=inv.normalize,
    )
    info_width = loss_mod.loss_info_width(len(problem.bc_groups)) + 1

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
    log(f"inverse: initial loss {float(ref):.4e}, "
        + " ".join(f"{n}={float(v):.6g}"
                   for n, v in params["coef"].items()))

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
    res = phase(k_adam, params, data0, F0, lw, ref)
    int(res.n_valid)  # force host sync (async crash surfacing, train.py)
    params = res.params
    coef_adam = {n: float(v) for n, v in params["coef"].items()}
    hist_adam = np.asarray(res.history[: int(res.n_valid)])
    log("inverse: after Adam  "
        + " ".join(f"{n}={v:.6g}" for n, v in coef_adam.items()))

    hist_lbfgs = np.zeros((0, info_width), np.float64)
    if st.lbfgs_epochs > 0:
        lb_cfg = optim.LBFGSConfig(
            max_iters=max(1, st.lbfgs_epochs // 3),
            history=spec.lbfgs_history,
        )
        data_l = sample_fn(k_lbfgs, res.density)
        params, hist, n_rows = optim.lbfgs_over_pytree(
            loss_fn, params, data_l, lw, ref, lb_cfg
        )
        hist_lbfgs = np.asarray(hist[: int(n_rows)])
    coef = {n: float(v) for n, v in params["coef"].items()}
    log("inverse: after L-BFGS "
        + " ".join(f"{n}={v:.6g}" for n, v in coef.items()))

    net_final = params["net"]
    predict = lambda z: predictor(net_final, z)

    from tpinn.core.train import eval_grid, resolve_testing_size

    tsize = resolve_testing_size(problem, spec.testing_size, log,
                                 label="inverse: ")
    X_star, axes, _ = eval_grid(problem, tsize, dtype)
    u_star = predict(X_star)
    exact_star = (jnp.asarray(problem.exact(X_star), dtype)
                  if problem.exact is not None else None)
    if problem.eval_mask is not None:
        m_star = jnp.asarray(problem.eval_mask(X_star), dtype)
        u_star = u_star * m_star
        if exact_star is not None:
            exact_star = exact_star * m_star
    rel_l2 = None
    if exact_star is not None:
        if inv.normalize > 0.0:
            # eigen mode: the eigenfunction's sign is arbitrary — compare
            # against the closer of ±exact
            rel_l2 = min(
                float(loss_mod.relative_l2(u_star, exact_star)),
                float(loss_mod.relative_l2(u_star, -exact_star)),
            )
        else:
            rel_l2 = float(loss_mod.relative_l2(u_star, exact_star))
        log(f"inverse: solution rel-L2 {rel_l2:.3e}")

    history = (np.concatenate([hist_adam, hist_lbfgs], axis=0)
               if hist_lbfgs.size else hist_adam)

    if output_dir is not None:
        # standard single-stage checkpoint (net params + spec chain) with
        # the identified equation/coefficients in the meta — servable by
        # tpinn.app.serve exactly like a forward checkpoint, /residual
        # evaluated at the RECOVERED coefficient values
        import json
        from pathlib import Path

        from tpinn.utils.checkpoint import save_pytree

        out = Path(output_dir)
        out.mkdir(parents=True, exist_ok=True)
        save_pytree(
            out / "params_stage_1.npz", net_final,
            meta={"stage": 1, "scl": mspec.scl, "epsil": mspec.epsil,
                  "problem": problem.name,
                  "chain": [net.spec_to_dict(mspec)],
                  "feature_kinds": list(problem.feature_kinds),
                  "lb": list(problem.lb), "ub": list(problem.ub),
                  "hard_bc": (list(problem.hard_bc)
                              if problem.hard_bc else None),
                  "coords": list(problem.coords),
                  "pad_features": spec.pad_features,
                  "equation": problem.equation,
                  "coef": coef, "inverse": True},
        )
        (out / "inverse.json").write_text(json.dumps({
            "problem": problem.name, "equation": problem.equation,
            "coef": coef, "coef_adam": coef_adam, "rel_l2": rel_l2,
            "n_obs": int(z_obs.shape[0]), "obs_noise": inv.obs_noise,
        }, indent=1))
        if problem.dim <= 2:
            # the UI figure-artifact contract (SURVEY §2b.13), so the web
            # app's result tabs render inverse runs like forward ones:
            # solution/residual/error fields at the RECOVERED coefficients,
            # loss history with the obs column, observation points on the
            # collocation tab
            from tpinn.core.train import _write_stage_artifacts
            from tpinn.utils import artifacts as artifacts_mod

            coef_arr = {k: jnp.asarray(v, dtype) for k, v in coef.items()}
            f_star = compiled.residual_fast(
                predictor, net_final, X_star, coef_arr)
            if source_fn is not None:
                f_star = f_star - source_fn(X_star)
            u_np, f_np = np.asarray(u_star), np.asarray(f_star)
            if problem.dim == 1:
                U, F = u_np[:, 0][None, :], f_np[:, 0][None, :]
            else:
                ny, nx = int(tsize[1]), int(tsize[0])
                U, F = u_np.reshape(ny, nx), f_np.reshape(ny, nx)
            _write_stage_artifacts(
                out, 1, problem, spec, axes, U, F,
                (np.asarray(exact_star) if exact_star is not None
                 else None), history)
            z_np = np.asarray(z_obs)
            artifacts_mod.write_collocation(
                out / "collocation_point_1.npz",
                U=np.ones((8, 8), np.float32),
                X_col=(z_np if problem.dim == 2 else np.concatenate(
                    [z_np, np.zeros_like(z_np)], axis=1)),
                limit=[float(problem.lb[0]), float(problem.ub[0])] + (
                    [float(problem.lb[1]), float(problem.ub[1])]
                    if problem.dim == 2 else [0.0, 1.0]),
            )
        log(f"inverse: checkpoint + record written to {out}")

    return InverseResult(
        coef=coef, coef_adam=coef_adam, rel_l2=rel_l2, params=params,
        predict=predict, history=history,
        z_obs=np.asarray(z_obs), u_obs=np.asarray(u_obs),
    )
