"""Structured Taylor-2 propagation: fused value+derivative forward passes.

The generic engine (tpinn.core.deriv) nests ``jvp`` — correct for any
callable, but each pass re-walks the network.  For the known predictor
structures (feature map → dense chain → amplitude, optionally summed with a
frozen previous stage) the derivative recurrences are closed-form, and all
derivative "streams" can ride ONE matmul per layer by stacking them along
the batch axis:

    H_all = stack([h, h_i, h_j, h_ii, h_jj, ...])   # [S*B, width]
    X_all = H_all @ W                                # one matmul
    a     = φ(x);  a_i = φ'(x)·x_i
    a_ij  = φ''(x)·x_i·x_j + φ'(x)·x_ij

This cuts matmul count ~2× vs nested jvp and turns five skinny [B, 60]
matmuls into one [5B, 60] matmul, while remaining plain JAX: ``jax.grad``
differentiates through it, so the same fast path serves the training
step (``engine="fused"``).

Activation derivative table:
    tanh:  φ' = 1 − a²          φ'' = −2·a·(1 − a²)
    sin:   φ' = cos x           φ'' = −sin x
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Sequence, Tuple

import jax
import jax.numpy as jnp

from tpinn.core import net as net_mod
from tpinn.core.net import FeatureMap, MLPSpec

Array = jax.Array
MultiIndex = Tuple[int, ...]


def plan_streams(indices: Iterable[MultiIndex]) -> List[MultiIndex]:
    """Ordered stream list: value first, then firsts, then pairs — with any
    pair's component firsts force-included (the recurrence needs them)."""
    need = {tuple(sorted(ix)) for ix in indices}
    pairs = sorted(ix for ix in need if len(ix) == 2)
    firsts = {ix[0] for ix in need if len(ix) == 1}
    for i, j in pairs:
        firsts.add(i)
        firsts.add(j)
    if any(len(ix) > 2 for ix in need):
        raise ValueError("taylor2 engine handles order <= 2 only")
    return [()] + [(i,) for i in sorted(firsts)] + pairs


# ---------------------------------------------------------------------------
# Feature-map stream construction
# ---------------------------------------------------------------------------


def feature_streams(
    fm: FeatureMap, z: Array, lb: Array, ub: Array, streams: Sequence[MultiIndex]
) -> Array:
    """[S, B, nf] stacked feature values/derivatives per stream."""
    cols_per_stream: List[List[Array]] = [[] for _ in streams]
    B = z.shape[0]
    zero = jnp.zeros((B, 1), z.dtype)
    for ci, kind in enumerate(fm.kinds):
        x = z[:, ci : ci + 1]
        if kind == net_mod.MINMAX:
            scale = 2.0 / (ub[ci] - lb[ci])
            vals = {(): scale * (x - lb[ci]) - 1.0}
            d1 = jnp.full((B, 1), scale, z.dtype)
            width = 1
        elif kind == net_mod.IDENTITY:
            vals = {(): x}
            d1 = jnp.ones((B, 1), z.dtype)
            width = 1
        elif kind == net_mod.PERIODIC:
            c, s = jnp.cos(x), jnp.sin(x)
            width = 2
        else:  # pragma: no cover
            raise ValueError(kind)

        for si, st in enumerate(streams):
            if kind == net_mod.PERIODIC:
                if st == ():
                    out = [c, s]
                elif st == (ci,):
                    out = [-s, c]
                elif st == (ci, ci):
                    out = [-c, -s]
                else:
                    out = [zero, zero]
            else:
                if st == ():
                    out = [vals[()]]
                elif st == (ci,):
                    out = [d1]
                else:
                    out = [zero]
            cols_per_stream[si].extend(out)
    # width padding duplicates column 0 (FeatureMap.pad_to) — same values
    # AND same derivative streams
    pad_to = getattr(fm, "pad_to", 0)
    for cols in cols_per_stream:
        while len(cols) < pad_to:
            cols.append(cols[0])
    return jnp.stack(
        [jnp.concatenate(cols, axis=1) for cols in cols_per_stream], axis=0
    )


# ---------------------------------------------------------------------------
# Dense-chain propagation
# ---------------------------------------------------------------------------


def _act_derivs(name: str, x: Array):
    if name == "tanh":
        a = jnp.tanh(x)
        d1 = 1.0 - a * a
        d2 = -2.0 * a * d1
    elif name == "sin":
        a = jnp.sin(x)
        d1 = jnp.cos(x)
        d2 = -a
    else:  # pragma: no cover
        raise ValueError(name)
    return a, d1, d2


def taylor2_mlp(
    params: dict,
    z: Array,
    spec: MLPSpec,
    fm: FeatureMap,
    lb: Array,
    ub: Array,
    indices: Iterable[MultiIndex],
) -> Dict[MultiIndex, Array]:
    """Fused value+derivative pass through a plain dense chain.

    Returns {multi-index: [B, out_dim]} for every planned stream (a superset
    of ``indices``).  Supports the plain MLP family (no fourier/modified —
    those fall back to the generic engine).
    """
    if spec.fourier_features or spec.modified:
        raise ValueError("taylor2_mlp supports the plain dense family")
    streams = plan_streams(indices)
    S = len(streams)
    B = z.shape[0]
    pos = {st: k for k, st in enumerate(streams)}

    H = feature_streams(fm, z, lb, ub, streams)          # [S, B, nf]
    dot = lambda a, b: jnp.dot(a, b, precision=spec.precision)
    layers = params["layers"]
    n_layers = len(layers)

    for li, layer in enumerate(layers):
        w, b = layer["w"], layer["b"]
        nf = H.shape[-1]
        X = dot(H.reshape(S * B, nf), w).reshape(S, B, -1)
        if li == 0:
            X = X * spec.scl
        last = li == n_layers - 1
        if last:
            out = X
            out = out.at[0].add(b)
            break
        x0 = X[0] + b
        name = spec.act_first if li == 0 else spec.act_hidden
        a, d1, d2 = _act_derivs(name, x0)
        new = [a]
        for st in streams[1:]:
            if len(st) == 1:
                new.append(d1 * X[pos[st]])
            else:
                i, j = st
                new.append(
                    d2 * X[pos[(i,)]] * X[pos[(j,)]] + d1 * X[pos[st]]
                )
        H = jnp.stack(new, axis=0)

    out = out * spec.epsil
    return {st: out[pos[st]] for st in streams}


# ---------------------------------------------------------------------------
# Predictor registration: structure-aware partials with generic fallback
# ---------------------------------------------------------------------------


def attach_mlp_meta(predictor, spec: MLPSpec, fm: FeatureMap, lb, ub):
    """Tag a predictor closure so residual evaluation can use the fused
    engine.  ``predictor.tpinn_partials(params, z, indices)`` computes the
    requested u-derivatives."""
    lb = jnp.asarray(lb)
    ub = jnp.asarray(ub)

    supported = not (spec.fourier_features or spec.modified)

    def tpinn_partials(params, z, indices):
        return taylor2_mlp(params, z, spec, fm, lb, ub, indices)

    if supported:
        predictor.tpinn_partials = tpinn_partials
    predictor.tpinn_kind = "mlp"
    predictor.tpinn_spec = spec
    predictor.tpinn_feature_map = fm
    predictor.tpinn_bounds = (lb, ub)
    return predictor


def attach_sum_meta(predictor, prev_predictor, stage_predictor):
    """Composed stage u = u_prev(params['prev'], z) + stage(params['stage'],
    z): partials of a sum are sums of partials, provided both parts expose
    fused partials.  The prev subtree rides through stop_gradient so the
    fused path keeps the frozen-stage semantics of net.compose_stages."""
    prev_parts = getattr(prev_predictor, "tpinn_partials", None)
    stage_parts = getattr(stage_predictor, "tpinn_partials", None)

    if prev_parts is not None and stage_parts is not None:
        def tpinn_partials(params, z, indices):
            a = stage_parts(params["stage"], z, indices)
            b = prev_parts(jax.lax.stop_gradient(params["prev"]), z, indices)
            return {k: a[k] + b[k] for k in a if k in b} | {
                k: v for k, v in a.items() if k not in b
            }

        predictor.tpinn_partials = tpinn_partials
    predictor.tpinn_kind = "sum"
    predictor.tpinn_prev = prev_predictor
    predictor.tpinn_stage = stage_predictor
    return predictor


def attach_frozen_meta(frozen, predictor, params):
    """Freeze params into a z-only callable, keeping fused-partials access."""
    parts = getattr(predictor, "tpinn_partials", None)
    if parts is not None:
        frozen.tpinn_frozen_partials = lambda z, indices: parts(
            params, z, indices
        )
    return frozen


# Engine dispatch default: the generic nested-jvp engine.  On the
# accelerator this was first tuned for, the stacked fused engine lost to
# it both forward and through jax.grad — XLA's jvp linearization fuses
# tangent arithmetic into the primal matmuls better than the hand-stacked
# [S·B, W] formulation, which pays for its stream (re)stacking.  Not yet
# measured on the H100; the fused engine stays opt-in
# (make_loss(engine="fused") or set_fused(True)).
PREFER_FUSED = False


def set_fused(enabled: bool) -> None:
    global PREFER_FUSED
    PREFER_FUSED = enabled


def fast_partials(predictor, params, z, indices, max_order: int):
    """Engine dispatch for the loss/residual path: generic nested-jvp by
    default (measured fastest under XLA), structure-aware fused engine when
    opted in via set_fused(True) and supported (order <= 2)."""
    from tpinn.core import deriv

    fn = getattr(predictor, "tpinn_partials", None)
    if PREFER_FUSED and fn is not None and max_order <= 2:
        return fn(params, z, indices)
    return deriv.partials(lambda zz: predictor(params, zz), z, indices)
