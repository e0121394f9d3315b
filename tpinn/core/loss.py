"""Loss system: per-BC-group data terms + PDE residual term.

Preserves the reference's loss semantics and — critically for the UI — its
``loss_info`` column contract (software.py:310-383):

    loss_info = [loss, loss_data, loss_eqn, data_err_1..G, eqn_err]

- ``data_err_i``: MSE of (u_pred − u_bc) for BC group i.
- ``eqn_err``: MSE of the PDE residual over collocation points.
- ``loss = loss_data + lw[0] * loss_eqn`` with unit per-term weights
  (software.py:366-374).
- The returned scalar is ``loss / ref`` — normalized by the loss value at
  initialization (software.py:375); the gradient is taken of the normalized
  loss, matching the reference optimizer dynamics.

``ref`` and ``lw`` are dynamic arguments (not closure attributes mutated
after the fact like loss_fun.ref/lw in the reference) so one jitted loss
serves both stages.
"""

from __future__ import annotations

from typing import Callable, Dict

import jax
import jax.numpy as jnp

from tpinn.core.pde import CompiledPDE

Array = jax.Array

# derivative engines of make_loss (see its ``engine`` parameter)
ENGINES = ("auto", "generic", "fused")


def ms_error(diff: Array) -> Array:
    """Columnwise mean squared error (software.py:241-242).

    An EMPTY batch contributes zero, not NaN: with full hard-BC ansatzes
    n_bd=0 is a legal config (every constraint is exact by construction),
    and jnp.mean over a zero-length axis would otherwise poison the total
    loss.  Static shape check — resolved at trace time, jit-safe."""
    if diff.shape[0] == 0:
        return jnp.zeros(diff.shape[1:], diff.dtype)
    return jnp.mean(jnp.square(diff), axis=0)


def make_loss(
    predictor: Callable[[dict, Array], Array],
    pde: CompiledPDE,
    source_fn: Callable[[Array], Array] | None = None,
    deriv_loss: bool = False,
    engine: str = "auto",
    residual_weight_fn: Callable[[Array], Array] | None = None,
    bc_operators=None,
    ring=None,
    causal=None,
):
    """Build ``loss_fn(params, data, lw, ref) -> (loss_n, loss_info)``.

    :param predictor: ``u(params, z)``.
    :param pde: compiled residual (tpinn.core.pde).
    :param source_fn: optional forcing ``g(z)``; residual becomes
        ``pde(...) - g(z)`` (for problems whose RHS is not baked into the
        equation string).
    :param deriv_loss: add the residual-*gradient* MSE term weighted by
        ``lw[1]`` — the reference sketches this (gov_deri_eqn,
        software.py:300-307) but leaves it commented out of the loss
        (:354, :359-361), which is why its UI "df" weight is dead; here it
        is a real, optional term.  Adds one eqn_err column per coordinate.
    :param residual_weight_fn: optional pointwise weight ``w(z)`` applied
        to the residual before the MSE (weighted-residual PINN; the
        deriv_loss gradient term stays unweighted).
    :param bc_operators: optional per-BC-group compiled boundary operators
        (tpinn.core.pde.compile_pde of BCGroup.operator, or None for plain
        Dirichlet): group i's data term becomes
        ``MSE(op_i(u)(z_bd) - u_bd)`` — Neumann (``"u_x"``) and Robin
        (``"u_x + k*u"``) conditions; the reference supports Dirichlet only.
    :param ring: optional resonance-band penalty
        (polish.ring_penalty_setup): ``{"z": [N,d], "P": [N,M],
        "weight": w}``.  Adds ``w·‖Pᵀ r(z)‖²`` — the implied mean-square
        ring-mode error of the live residual — to the total loss.  The
        raw residual is used (no ``residual_weight_fn``): P already
        carries the quadrature weights and 1/ε amplification.  Folded
        into the total/``loss`` column only; the loss_info layout (the
        UI contract) is unchanged.
    :param causal: optional causal residual weighting for time-dependent
        problems (Wang, Sankaran & Perdikaris 2022, "Respecting causality
        …"): ``{"axis": i, "t0": a, "t1": b, "bins": B, "eps": e}``.
        Collocation points are binned into B time slabs along coordinate
        ``axis``; slab i's residual is down-weighted by
        ``w_i = exp(-eps · Σ_{j<i} L_j / Σ_j L_j)`` (stop-gradient) —
        the exponent is slab i's SHARE of the current total, so eps is
        dimensionless (eps ≈ log-suppression of the last slab while the
        loss is spread out; 10-30 are sensible) and the weights form an
        advancing front: slabs already converged contribute ~nothing to
        the total, so the first unconverged slab always trains at w ≈ 1
        while later ones wait.  The gradient can no longer satisfy the
        PDE "backwards in time", the classic failure mode of stiff /
        advective evolution problems.
        The optimized ``loss_eqn`` becomes the causally weighted term
        (``loss = loss_data + lw[0]*loss_eqn`` still holds in loss_info);
        the trailing ``eqn_err`` columns stay UNWEIGHTED so the residual
        metric the user watches remains the true MSE.  At eps=0 the
        weighted term equals the unweighted MSE exactly (per-point
        weights, not per-slab means).  All shapes static — B is a Python
        int, the binning is a clipped integer quantization, so the term
        jits into the scanned Adam automaton unchanged.
    :param engine: one of ``ENGINES``: "auto" (taylor.fast_partials
        dispatch), "generic" (nested-jvp), or "fused" (require the fused
        pure-JAX Taylor-2 path).
    :returns: loss function with the reference's loss_info layout
        ``[loss, loss_data, loss_eqn, data_err_1..G, eqn_err...]``.
    """
    from tpinn.core import deriv as deriv_mod

    if engine not in ENGINES:
        raise ValueError(f"engine={engine!r}; valid engines: "
                         f"{', '.join(ENGINES)}")

    def residual_at(params, z):
        if engine == "generic":
            f = pde.residual(lambda zz: predictor(params, zz), z)
        elif engine == "fused":
            parts = predictor.tpinn_partials(params, z, pde.indices)
            f = pde.evaluate(z, parts)
        else:  # "auto": dispatch via taylor.fast_partials policy
            f = pde.residual_fast(predictor, params, z)
        if source_fn is not None:
            f = f - source_fn(z)
        return f

    def loss_fn(params: dict, data: Dict, lw: Array, ref: Array):
        f_u = lambda z: predictor(params, z)

        data_errs = []
        for gi, (z_bd, u_bd) in enumerate(zip(data["x_bd"], data["u_bd"])):
            op = bc_operators[gi] if bc_operators else None
            bd_val = op.residual(f_u, z_bd) if op is not None else f_u(z_bd)
            data_errs.append(ms_error(bd_val - u_bd))
        data_err = (
            jnp.concatenate(data_errs) if data_errs
            else jnp.zeros((0,), data["x_col"].dtype)  # keep dtype uniform in x64
        )

        x_col = data["x_col"]
        f = residual_at(params, x_col)
        if residual_weight_fn is not None:
            # pointwise residual weighting w(z)·f — e.g. e^{+π²t} on the
            # heat preset so late-time residuals (where u itself decays to
            # ~5e-5) count at the solution's own scale
            f = residual_weight_fn(x_col) * f
        eqn_errs = [ms_error(f)]
        eqn_weights = [1.0]

        if deriv_loss:
            # d(residual)/dz via forward mode over the residual itself
            res_of_z = lambda z: residual_at(params, z)
            d = x_col.shape[1]
            dparts = deriv_mod.partials(res_of_z, x_col,
                                        [(i,) for i in range(d)])
            df = jnp.concatenate([dparts[(i,)] for i in range(d)], axis=1)
            eqn_errs.append(jnp.mean(ms_error(df), keepdims=True))
            eqn_weights.append(1.0)  # scaled by lw[1] below

        eqn_err = jnp.concatenate(eqn_errs)
        loss_data = jnp.sum(data_err)
        n_res_cols = eqn_errs[0].shape[0]
        if causal is not None:
            # per-slab mean residual → exclusive prefix → slab weights;
            # applied per POINT so eps→0 recovers the plain MSE exactly
            r2 = jnp.sum(jnp.square(f), axis=1)
            nb = causal["bins"]
            pos = ((x_col[:, causal["axis"]] - causal["t0"])
                   / (causal["t1"] - causal["t0"]))
            idx = jnp.clip((pos * nb).astype(jnp.int32), 0, nb - 1)
            # one-hot matmul instead of segment_sum: the (N, B) contraction
            # is a plain dense product, with no scatter-add
            oh = jax.nn.one_hot(idx, nb, dtype=r2.dtype)
            l_slab = (r2 @ oh) / jnp.maximum(jnp.sum(oh, axis=0), 1.0)
            # RELATIVE-SHARE exponent (measured design, out/acc_cpu
            # cvA5/cvB5): the prefix sum is normalized by the CURRENT
            # total over all slabs, so w_i = exp(-eps·share-of-loss
            # -before-slab-i).  Scale-free by construction — the paper's
            # raw exponent froze every slab past the first at c=30
            # convection's init MSE ~4e2 and the unconstrained late-time
            # net blew up (cvA5, rel-L2 19); normalizing by the INIT loss
            # instead opened the weights as soon as the loss fell below
            # init scale, which the COLLAPSED u≈0 state satisfies (cvB5,
            # no gain).  Share-normalization gives an advancing front:
            # converged slabs stop contributing to the total, so the
            # first unconverged slab always sees w ≈ 1 while everything
            # past it stays suppressed — and a collapse's transition band
            # dominates the total, freezing the (spuriously low-residual)
            # late slabs until the band is fixed.
            tot = jnp.sum(l_slab)
            w_slab = jax.lax.stop_gradient(
                jnp.exp(-causal["eps"] * (jnp.cumsum(l_slab) - l_slab)
                        / jnp.maximum(tot, 1e-30)))
            res_term = jnp.mean(w_slab[idx] * r2)
        else:
            res_term = jnp.sum(eqn_err[:n_res_cols])
        if deriv_loss:
            loss_eqn = res_term + lw[1] * eqn_err[n_res_cols]
        else:
            loss_eqn = res_term
        loss = loss_data + lw[0] * loss_eqn
        if ring is not None:
            f_ring = residual_at(params, ring["z"])
            loss = loss + ring["weight"] * jnp.sum(
                jnp.square(jnp.matmul(ring["P"].T, f_ring)))
        loss_n = loss / ref
        loss_info = jnp.concatenate(
            [jnp.stack([loss, loss_data, loss_eqn]), data_err, eqn_err]
        )
        return loss_n, loss_info

    return loss_fn


def loss_info_width(num_bc_groups: int) -> int:
    """Number of columns in loss_info: 3 + G data terms + 1 residual term."""
    return 3 + num_bc_groups + 1


def relative_l2(u_pred: Array, u_true: Array) -> Array:
    """rel-L2 error, the parity/convergence gate metric (BASELINE.json)."""
    return jnp.linalg.norm(u_pred - u_true) / jnp.linalg.norm(u_true)
