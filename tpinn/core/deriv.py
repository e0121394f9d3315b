"""Forward-mode derivative engine for PDE residuals.

The reference computes batched Jacobians with reverse-mode ``vjp`` driven by
one-hot cotangent tensors, nested twice for second derivatives
(/root/reference/pinn_app/software.py:246-307).  For PINNs the map is
R^d -> R^m with tiny d (1-3 coordinates) and m (usually 1), evaluated at many
points — exactly the regime where *forward* mode wins: one ``jvp`` per input
direction, no transposition, no stored primals, and XLA fuses the tangent
arithmetic straight into the forward matmuls.

Key trick: a directional second derivative costs ONE forward-over-forward
pass and yields the value and both first derivatives for free:

    g(z)   = (f(z), df(z)@v_j)                       # inner jvp
    jvp(g) = ((u, u_j), (u_i, u_ij))                 # outer jvp along v_i

``partials`` plans a minimal set of such passes covering every derivative a
compiled PDE residual needs (see tpinn.core.pde), then evaluates them.  All
tangents are whole-batch constants so every pass is a handful of large
matmuls, no per-point loops.
"""

from __future__ import annotations

from functools import partial
from typing import Callable, Dict, Iterable, Tuple

import jax
import jax.numpy as jnp

Array = jax.Array
MultiIndex = Tuple[int, ...]  # sorted tuple of coordinate indices; () == value


def _unit_tangent(z: Array, i: int) -> Array:
    """Whole-batch tangent e_i: [N, d] of zeros with column i set to 1."""
    t = jnp.zeros_like(z)
    return t.at[:, i].set(1.0)


def pair_pass(f: Callable[[Array], Array], z: Array, i: int, j: int):
    """One forward-over-forward pass.

    Returns ``(u, u_i, u_j, u_ij)`` for a batched ``f: [N, d] -> [N, m]``.
    When ``i == j`` this is the pure directional second derivative.
    """
    vi = _unit_tangent(z, i)
    vj = _unit_tangent(z, j)

    def g(zz):
        return jax.jvp(f, (zz,), (vj,))

    (u, u_j), (u_i, u_ij) = jax.jvp(g, (z,), (vi,))
    return u, u_i, u_j, u_ij


def first_pass(f: Callable[[Array], Array], z: Array, i: int):
    """Single jvp: returns ``(u, u_i)``."""
    return jax.jvp(f, (z,), (_unit_tangent(z, i),))


def directional(f: Callable[[Array], Array], z: Array, dirs: MultiIndex) -> Array:
    """Arbitrary-order partial D_{dirs} f via recursively nested jvp.

    Cost grows ~2^k with order k; used only for order >= 3 terms, which are
    rare in practice (the reference never goes past order 2).
    """
    if not dirs:
        return f(z)
    *rest, last = dirs

    def g(zz):
        return jax.jvp(f, (zz,), (_unit_tangent(zz, last),))[1]

    return directional(g, z, tuple(rest))


def plan_passes(indices: Iterable[MultiIndex]):
    """Choose a minimal set of passes covering the requested multi-indices.

    Returns ``(pairs, singles, highers, want_value)`` where ``pairs`` is a
    list of (i, j) forward-over-forward passes, ``singles`` a list of bare
    first-derivative directions not already covered, and ``highers`` the
    order>=3 multi-indices evaluated by nested jvp.
    """
    need = {tuple(sorted(ix)) for ix in indices}
    want_value = () in need
    pairs = sorted({ix for ix in need if len(ix) == 2})
    highers = sorted({ix for ix in need if len(ix) > 2})
    covered_firsts = {i for p in pairs for i in p}
    # order>=3 nested passes also produce nothing reusable here (we only keep
    # the top-order term), so they don't reduce `singles`.
    singles = sorted(
        {ix[0] for ix in need if len(ix) == 1} - covered_firsts
    )
    return pairs, singles, highers, want_value


def partials(
    f: Callable[[Array], Array],
    z: Array,
    indices: Iterable[MultiIndex],
) -> Dict[MultiIndex, Array]:
    """Evaluate the requested partial derivatives of ``f`` at batch ``z``.

    :param f: batched function ``[N, d] -> [N, m]``.
    :param z: evaluation points ``[N, d]``.
    :param indices: multi-indices as sorted tuples of coordinate positions,
        e.g. ``()`` = value, ``(0,)`` = d/dx0, ``(0, 0)`` = d2/dx0^2,
        ``(0, 1)`` = mixed second derivative.
    :return: dict mapping each requested multi-index (plus any byproducts)
        to an ``[N, m]`` array.
    """
    pairs, singles, highers, want_value = plan_passes(indices)
    out: Dict[MultiIndex, Array] = {}

    for (i, j) in pairs:
        u, u_i, u_j, u_ij = pair_pass(f, z, i, j)
        out.setdefault((), u)
        out[(i,)] = u_i
        out[(j,)] = u_j
        out[(i, j)] = u_ij

    for i in singles:
        u, u_i = first_pass(f, z, i)
        out.setdefault((), u)
        out[(i,)] = u_i

    for ix in highers:
        out[ix] = directional(f, z, ix)

    if want_value and () not in out:
        out[()] = f(z)

    return out


# ---------------------------------------------------------------------------
# Reference-semantics engine (reverse-over-reverse), used for parity tests and
# for measuring the CPU baseline the reference would produce.  Same algorithm
# as software.py:246-279 (one-hot cotangents vmapped over outputs), written
# independently.
# ---------------------------------------------------------------------------


def vect_grad_reverse(func: Callable[[Array], Array], z: Array):
    """Batch Jacobian via vjp with one-hot cotangents (reference-style).

    Returns ``(grad [N, m*d], sol [N, m])`` with the reference's column
    layout (output-major): column ``o*d + i`` is d(out_o)/d(z_i), matching
    software.py:268-279's ``transpose(1, 0, 2).reshape`` ordering.
    """
    sol, vjp_fn = jax.vjp(func, z)
    n, m = sol.shape
    eye = jnp.eye(m, dtype=sol.dtype)
    cotangents = jnp.broadcast_to(eye[:, None, :], (m, n, m))
    grad_rows = jax.vmap(vjp_fn)(cotangents)[0]  # [m, N, d]
    grad_all = grad_rows.transpose(1, 0, 2).reshape(n, z.shape[1] * m)
    return grad_all, sol
