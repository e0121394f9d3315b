"""Coupled PDE systems: several equations, several fields, one network.

The reference solves exactly one scalar equation with one hardcoded
residual (software.py:283-297).  This module generalizes the framework to
first-class systems — ``fields=("u", "v")`` makes ``v``, ``v_x``, ``u_xy``…
legal identifiers (tpinn.core.pde.compile_system), the network grows to
``out_dim = len(fields)`` output columns (net.MLPSpec.out_dim), and the
loss stacks one residual column per equation:

    loss = Σ_g MSE(u_pred[:, field_g] − u_bc_g)            per-BC-group data
         + lw[0] · Σ_e MSE(residual_e)                     per-equation

Design notes:
- All fields' derivatives come out of the SAME forward-mode passes — the
  derivative engine (deriv.partials) is already [N, m]-valued, so a coupled
  system costs the same tangent passes as a scalar problem of the same
  derivative order; only the final dense layer widens.
- The optimizer drivers are pytree-generic; the system rides the identical
  scanned Adam automaton and pure-XLA L-BFGS as the scalar path
  (optim.make_adam_phase / lbfgs_over_pytree).
- Unknown coefficients compose: ``compile_system(..., params=("lam",))``
  plus an observation term identifies coefficients of a SYSTEM the same way
  tpinn.core.inverse does for a scalar equation (run_system's
  ``inverse=``/``observations=`` hooks).

``loss_info`` layout: ``[loss, loss_data, loss_eqn, data_err_1..G,
(obs_err_1..m,) eqn_err_1..E]`` — same leading triple as the scalar
contract (loss.py), one data column per BC group, one residual column per
equation.
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
from tpinn.core.train import TrainSpec, eval_grid

Array = jax.Array


@dataclass(frozen=True)
class SystemSpec:
    """What to solve: coupled equations + domain + field-tagged BCs.

    The system analog of train.ProblemSpec.  ``bc_groups`` entries carry
    ``field`` (sample.BCGroup.field) naming the component each group pins;
    ``exact`` (optional oracle) maps ``z -> [N, len(fields)]``.
    """

    name: str
    equations: Tuple[str, ...]
    fields: Tuple[str, ...]
    coords: Tuple[str, ...]
    lb: Tuple[float, ...]
    ub: Tuple[float, ...]
    bc_groups: Tuple[sample.BCGroup, ...]
    feature_kinds: Optional[Tuple[str, ...]] = None
    exact: Optional[Callable[[Array], Array]] = None

    def __post_init__(self):
        if self.feature_kinds is None:
            object.__setattr__(
                self, "feature_kinds", tuple([net.MINMAX] * len(self.coords))
            )
        for g in self.bc_groups:
            if not (0 <= g.field < len(self.fields)):
                raise ValueError(
                    f"BC group pins field {g.field} but the system has "
                    f"{len(self.fields)} fields {self.fields}"
                )

    @property
    def dim(self) -> int:
        return len(self.coords)


@dataclass
class SystemResult:
    rel_l2: Optional[float]                # aggregate over all fields
    rel_l2_fields: Optional[Tuple[float, ...]]  # per field
    coef: Dict[str, float]                 # recovered coefficients (if any)
    params: dict
    predict: Callable[[Array], Array]      # z -> [N, m]
    history: np.ndarray


def make_system_loss(
    predictor: Callable[[dict, Array], Array],
    compiled: pde.CompiledSystem,
    bc_fields: Tuple[int, ...],
    observations: Optional[Tuple[Array, Array]] = None,
    obs_weight: float = 1.0,
    bc_operators=None,
):
    """Build the system loss.  ``params`` is the net pytree, or
    ``{"net", "coef"}`` when the system declares unknown coefficients.

    ``bc_operators``: per-group compiled boundary operators (one-equation
    CompiledSystems over the same fields) — Neumann/Robin/flux conditions
    like ``"v_x"`` or ``"u_x - v"``; None entries pin the tagged field's
    value (Dirichlet)."""
    has_coef = bool(compiled.param_names)

    def loss_fn(params: dict, data: Dict, lw: Array, ref: Array):
        if has_coef:
            net_p, coef = params["net"], params["coef"]
        else:
            net_p, coef = params, None
        f = lambda z: predictor(net_p, z)

        data_errs = []
        for gi, (z_bd, u_bd, fi) in enumerate(
                zip(data["x_bd"], data["u_bd"], bc_fields)):
            op = bc_operators[gi] if bc_operators else None
            bd_val = (op.residual(f, z_bd, coef) if op is not None
                      else f(z_bd)[:, fi : fi + 1])
            data_errs.append(loss_mod.ms_error(bd_val - u_bd))
        n_bc_cols = len(data_errs)
        if observations is not None:
            z_obs, u_obs = observations
            # one obs column per field: the full state is observed
            data_errs.append(loss_mod.ms_error(f(z_obs) - u_obs))
        data_err = (
            jnp.concatenate(data_errs) if data_errs
            else jnp.zeros((0,), data["x_col"].dtype)
        )

        res = compiled.residual(f, data["x_col"], coef)  # [N, n_eq]
        eqn_err = loss_mod.ms_error(res)                 # [n_eq]

        # loss_info columns stay unscaled; the weight applies in the sum
        loss_data = (jnp.sum(data_err[:n_bc_cols])
                     + obs_weight * jnp.sum(data_err[n_bc_cols:]))
        loss_eqn = jnp.sum(eqn_err)
        loss = loss_data + lw[0] * loss_eqn
        loss_info = jnp.concatenate(
            [jnp.stack([loss, loss_data, loss_eqn]), data_err, eqn_err]
        )
        return loss / ref, loss_info

    return loss_fn


def run_system(
    problem: SystemSpec,
    spec: TrainSpec,
    inverse: Optional["object"] = None,     # tpinn.core.inverse.InverseSpec
    observations: Optional[Tuple[Array, Array]] = None,
    log_fn: Optional[Callable] = None,
    print_log: bool = False,
    mesh=None,
    output_dir: Optional[str] = None,
) -> SystemResult:
    """Train a coupled system: single-stage Adam → L-BFGS.

    With ``inverse`` (an InverseSpec), the equations may declare unknown
    coefficients, identified jointly from ``observations`` (or synthesized
    from ``problem.exact`` — full-state observations, one column per
    field).

    ``mesh``: point batches shard over the mesh's 'points' axis; the
    multi-output params (and any coefficient scalars) stay replicated —
    the same pure-data-parallel layout as the scalar forward path.
    """
    if not spec.stages:
        spec = spec.with_default_stages()
    st = spec.stages[0]
    dtype = jnp.dtype(spec.dtype)
    m = len(problem.fields)

    def log(msg: str):
        if log_fn is not None:
            log_fn(msg)
        if print_log:
            print(msg, file=sys.stderr)

    param_names = tuple(inverse.params) if inverse is not None else ()
    compiled = pde.compile_system(
        problem.equations, problem.coords, problem.fields, param_names
    )
    feature_map = net.feature_map_for(problem.feature_kinds,
                                      pad_to=spec.pad_features)
    lb = jnp.asarray(problem.lb, dtype)
    ub = jnp.asarray(problem.ub, dtype)
    mspec = net.MLPSpec(
        depth=st.depth, width=st.width, out_dim=m,
        act_first=st.act_first, act_hidden=st.act_hidden,
        scl=float(st.scl if st.scl is not None else 1.0),
        epsil=float(st.epsil if st.epsil is not None else 1.0),
        fourier_features=st.fourier_features,
        fourier_scale=st.fourier_scale, modified=st.modified,
    )
    key = jax.random.PRNGKey(spec.seed)
    k_init, k_adam, k_lbfgs = jax.random.split(key, 3)
    net_params = net.init_params(k_init, mspec, feature_map, dtype)
    predictor = net.make_predictor(mspec, feature_map, lb, ub)

    if param_names:
        params = {
            "net": net_params,
            "coef": {n: jnp.asarray(v, dtype)
                     for n, v in zip(inverse.params, inverse.init)},
        }
    else:
        params = net_params

    obs = None
    if inverse is not None:
        if observations is not None:
            z_obs = jnp.asarray(observations[0], dtype)
            u_obs = jnp.asarray(observations[1], dtype)
        else:
            if problem.exact is None:
                raise ValueError(
                    "inverse system identification needs observations or an "
                    "analytic oracle to synthesize them from"
                )
            k_pts, k_noise = jax.random.split(
                jax.random.PRNGKey(inverse.obs_seed))
            z_obs = sample.lhs_box(k_pts, inverse.n_obs, lb, ub, dtype)
            u_obs = jnp.asarray(problem.exact(z_obs), dtype)
            if inverse.obs_noise > 0.0:
                u_obs = u_obs + inverse.obs_noise * jax.random.normal(
                    k_noise, u_obs.shape, dtype)
        obs = (z_obs, u_obs)
        log(f"system: inverse mode, {len(param_names)} coefficient(s) "
            f"{param_names}, {obs[0].shape[0]} observations")

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

    # adaptive density: total residual energy over all equations
    z_grid, reshape, smooth = sample.density_geometry(grids)

    def density_fn(p):
        net_p = p["net"] if param_names else p
        coef = p["coef"] if param_names else None
        res = compiled.residual(lambda z: predictor(net_p, z), z_grid, coef)
        f_sq = jnp.sum(res**2, axis=1, keepdims=True)
        return smooth(reshape(f_sq / jnp.mean(f_sq) + 0.5))

    bc_fields = tuple(g.field for g in problem.bc_groups)
    bc_ops = tuple(
        pde.compile_system([g.operator], problem.coords, problem.fields,
                           param_names) if g.operator else None
        for g in problem.bc_groups
    )
    if not any(o is not None for o in bc_ops):
        bc_ops = None
    loss_fn = make_system_loss(
        predictor, compiled, bc_fields, obs,
        obs_weight=(inverse.obs_weight if inverse is not None else 1.0),
        bc_operators=bc_ops,
    )
    info_width = (3 + len(problem.bc_groups) + (m if obs is not None else 0)
                  + compiled.n_eq)

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
    log(f"system: {compiled.n_eq} equations, {m} fields "
        f"{problem.fields}; initial loss {float(ref):.4e}")

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
    int(res.n_valid)  # host sync: surface async device crashes here
    params = res.params
    hist_adam = np.asarray(res.history[: int(res.n_valid)])

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

    net_final = params["net"] if param_names else params
    coef = ({n: float(v) for n, v in params["coef"].items()}
            if param_names else {})
    if coef:
        log("system: recovered " +
            " ".join(f"{n}={v:.6g}" for n, v in coef.items()))
    predict = lambda z: predictor(net_final, z)

    rel_l2 = rel_fields = None
    if problem.exact is not None:
        # SystemSpec reuses train.eval_grid via a duck-typed shim
        from tpinn.core.train import resolve_testing_size

        tsize = resolve_testing_size(problem, spec.testing_size, log,
                                     label="system: ")
        X_star, _, _ = eval_grid(problem, tsize, dtype)
        u = predict(X_star)
        u_true = jnp.asarray(problem.exact(X_star), dtype)
        rel_fields = tuple(
            float(loss_mod.relative_l2(u[:, i : i + 1], u_true[:, i : i + 1]))
            for i in range(m)
        )
        rel_l2 = float(loss_mod.relative_l2(u, u_true))
        log(f"system: rel-L2 {rel_l2:.3e} (" +
            ", ".join(f"{f}={e:.3e}"
                      for f, e in zip(problem.fields, rel_fields)) + ")")

    history = (np.concatenate([hist_adam, hist_lbfgs], axis=0)
               if hist_lbfgs.size else hist_adam)

    if output_dir is not None:
        # self-describing checkpoint: the meta carries the full system
        # (equations/fields/domain), so tpinn.app.serve can rebuild the
        # multi-output predictor WITHOUT a problem preset (--problem
        # optional); /predict returns one row per point with m columns
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
                  "hard_bc": None,
                  "coords": list(problem.coords),
                  "pad_features": spec.pad_features,
                  "system": {"equations": list(problem.equations),
                             "fields": list(problem.fields)},
                  "coef": coef},
        )
        (out / "system.json").write_text(json.dumps({
            "problem": problem.name,
            "equations": list(problem.equations),
            "fields": list(problem.fields),
            "coef": coef, "rel_l2": rel_l2,
            "rel_l2_fields": (list(rel_fields) if rel_fields else None),
        }, indent=1))
        log(f"system: checkpoint + record written to {out}")

    return SystemResult(
        rel_l2=rel_l2, rel_l2_fields=rel_fields, coef=coef, params=params,
        predict=predict, history=history,
    )
