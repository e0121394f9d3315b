"""On-device sampling: LHS, inverse-CDF adaptive sampling, density smoothing.

The reference's sampling pipeline round-trips to the host every resample:
``pyDOE.lhs`` is NumPy (software.py:553,562) and the Gaussian smoothing uses
``scipy.signal.convolve2d`` (software.py:82).  Every function here is pure
jax.numpy and jittable, so resampling can live *inside* a lax.scan training
loop — the entire Adam phase compiles to one XLA computation with no host
synchronization.

Components (reference counterparts cited):
- ``lhs``                — stratified Latin-hypercube sampling (pyDOE.lhs
                           replacement): one random permutation + jitter per
                           axis; identical marginal stratification.
- ``inverse_cdf_1d/2d``  — density-weighted point sampling by inverse-CDF of
                           the flattened cell masses with intra-cell jitter
                           (software.py:35-67, 87-136 — algorithm is the
                           same; it was already jittable).
- ``gaussian_smooth_*``  — separable Gaussian window smoothing with 'same'
                           padding (software.py:21-32, 71-83).
- ``boundary_band_density`` — the 5%-frame boundary-band mask F_bd
                           (software.py:527-532).
- ``make_sampler``       — the dataf() equivalent: draws BC-group points,
                           uniform + boundary-band + adaptive collocation
                           points, concatenating BC points into the
                           collocation set (software.py:535-573); fixed
                           output shapes so it composes with scan/jit.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp

Array = jax.Array


# ---------------------------------------------------------------------------
# Latin hypercube sampling (on-device pyDOE.lhs equivalent)
# ---------------------------------------------------------------------------


def lhs(key: Array, n: int, dim: int, dtype=jnp.float32) -> Array:
    """Stratified LHS in the unit cube: [n, dim], one point per 1/n slab
    per axis (random axis permutations + intra-slab jitter)."""
    kp, kj = jax.random.split(key)
    perm_keys = jax.random.split(kp, dim)
    perms = jnp.stack(
        [jax.random.permutation(k, n) for k in perm_keys], axis=1
    ).astype(dtype)
    jitter = jax.random.uniform(kj, (n, dim), dtype)
    return (perms + jitter) / n


def lhs_box(key: Array, n: int, lb: Array, ub: Array, dtype=jnp.float32) -> Array:
    """LHS scaled to the box [lb, ub]."""
    lb = jnp.asarray(lb, dtype)
    ub = jnp.asarray(ub, dtype)
    return lhs(key, n, lb.shape[0], dtype) * (ub - lb) + lb


# ---------------------------------------------------------------------------
# Inverse-CDF sampling from gridded densities
# ---------------------------------------------------------------------------


def inverse_cdf_1d(key: Array, x: Array, f: Array, n: int) -> Array:
    """Sample ``n`` points on the 1-D grid ``x`` with cell density ``f``.

    ``x``: [N, 1] equally spaced nodes; ``f``: [N, 1] density at nodes.
    Returns [n, 1].
    """
    xc = x[:-1, :]
    fc = f[:-1, 0]
    dx = xc[1, 0] - xc[0, 0]
    k1, k2 = jax.random.split(key)
    cdf = jnp.concatenate([jnp.zeros((1,), fc.dtype), jnp.cumsum(fc)])
    draws = jax.random.uniform(k1, (n,), fc.dtype) * cdf[-1]
    seq = jnp.arange(cdf.shape[0], dtype=fc.dtype)
    pos = jnp.floor(jnp.interp(draws, cdf, seq)).astype(jnp.int32)
    pos = jnp.clip(pos, 0, xc.shape[0] - 1)
    jitter = jax.random.uniform(k2, (n, 1), fc.dtype)
    return xc[pos] + jitter * dx


def inverse_cdf_2d(key: Array, X: Array, Y: Array, F: Array, n: int) -> Array:
    """Sample ``n`` points from the 2-D cell density ``F`` on meshgrid (X, Y).

    Same algorithm as the reference sampler (software.py:87-136): flatten
    cell masses, draw uniforms on the total mass, invert the cumulative sum
    for the flat cell index, then jitter uniformly within the cell.
    Returns [n, 2] (x, y) points.
    """
    Xc = X[:-1, :-1]
    Yc = Y[:-1, :-1]
    Fc = F[:-1, :-1]
    f = Fc.reshape(-1)
    dx = X[0, 1] - X[0, 0]
    dy = Y[1, 0] - Y[0, 0]
    k1, k2 = jax.random.split(key)
    cdf = jnp.concatenate([jnp.zeros((1,), f.dtype), jnp.cumsum(f)])
    draws = jax.random.uniform(k1, (n,), f.dtype) * cdf[-1]
    seq = jnp.arange(cdf.shape[0], dtype=f.dtype)
    flat = jnp.floor(jnp.interp(draws, cdf, seq))
    flat = jnp.clip(flat, 0, f.shape[0] - 1)
    ncols = Fc.shape[1]
    row = (flat // ncols).astype(jnp.int32)
    col = (flat % ncols).astype(jnp.int32)
    px = Xc[row, col]
    py = Yc[row, col]
    jitter = jax.random.uniform(k2, (2, n), f.dtype)
    return jnp.stack([px + jitter[0] * dx, py + jitter[1] * dy], axis=1)


def inverse_cdf_nd(key: Array, axes: Sequence[Array], F: Array, n: int) -> Array:
    """Sample ``n`` points from a d-dimensional cell density (d ≥ 1).

    ``axes``: per-axis equally spaced node vectors [g_i]; ``F``: density on
    their ``indexing='ij'`` meshgrid, shape (g_0, …, g_{d-1}).  Same
    algorithm as the 1-D/2-D samplers (cumsum → uniform draws → interp →
    per-axis jitter within the cell), generalized through
    ``jnp.unravel_index``.  Returns [n, d].
    """
    d = len(axes)
    Fc = F[tuple(slice(0, -1) for _ in range(d))]
    f = Fc.reshape(-1)
    steps = [a[1] - a[0] for a in axes]
    k1, k2 = jax.random.split(key)
    cdf = jnp.concatenate([jnp.zeros((1,), f.dtype), jnp.cumsum(f)])
    draws = jax.random.uniform(k1, (n,), f.dtype) * cdf[-1]
    seq = jnp.arange(cdf.shape[0], dtype=f.dtype)
    flat = jnp.floor(jnp.interp(draws, cdf, seq))
    flat = jnp.clip(flat, 0, f.shape[0] - 1).astype(jnp.int32)
    idx = jnp.unravel_index(flat, Fc.shape)
    jitter = jax.random.uniform(k2, (d, n), f.dtype)
    cols = [axes[i][idx[i]] + jitter[i] * steps[i] for i in range(d)]
    return jnp.stack(cols, axis=1)


# ---------------------------------------------------------------------------
# Gaussian density smoothing (separable, on-device)
# ---------------------------------------------------------------------------


def _gauss_window(sig: float, wid: int, dtype) -> Array:
    xg = jnp.linspace(-sig, sig, wid, dtype=dtype)
    w = jax.scipy.stats.norm.pdf(xg)
    return w


def gaussian_smooth_1d(f: Array, sig: float = 1.0, wid: int = 5) -> Array:
    """'same'-mode 1-D Gaussian smoothing of [N, 1] (software.py:21-32)."""
    w = _gauss_window(sig, wid, f.dtype)
    w = w / jnp.sum(w)
    out = jnp.convolve(f[:, 0], w, mode="same", precision="highest")
    return out[:, None]


def gaussian_smooth_2d(
    F: Array, sig: Sequence[float] = (1.0, 1.0), wid: Sequence[int] = (5, 5)
) -> Array:
    """'same'-mode 2-D Gaussian smoothing of an [H, W] density.

    Matches the reference window construction: outer product of two 1-D
    normal-pdf windows sampled on linspace(-sig, sig, wid), normalized to
    sum 1 (software.py:77-81).  The convolution itself is separable and is
    executed as two small 1-D convolutions on-device.
    """
    wx = _gauss_window(float(sig[0]), int(wid[0]), F.dtype)
    wy = _gauss_window(float(sig[1]), int(wid[1]), F.dtype)
    total = jnp.sum(wx) * jnp.sum(wy)
    wx = wx / jnp.sqrt(total)
    wy = wy / jnp.sqrt(total)
    # rows: convolve along axis 1 with wx; cols: along axis 0 with wy.
    # 'same' via explicit zero padding + valid conv.
    def conv_same_rows(a: Array, w: Array) -> Array:
        k = w.shape[0]
        lo = (k - 1) // 2
        hi = k - 1 - lo
        ap = jnp.pad(a, ((0, 0), (lo, hi)))
        # precision="highest": a reduced-precision conv (bf16 or TF32
        # inputs) would corrupt the density and differ from the scipy
        # parity oracle.
        return jax.vmap(
            lambda r: jnp.convolve(r, w, mode="valid", precision="highest")
        )(ap)

    F1 = conv_same_rows(F, wx[::-1])
    F2 = conv_same_rows(F1.T, wy[::-1]).T
    return F2


def boundary_band_density(R: Array, T: Array, lb: Array, ub: Array) -> Array:
    """Density = 1 on the outer 5% frame of the box, 0 inside
    (software.py:527-532)."""
    fx = (ub[0] - lb[0]) / 20.0
    fy = (ub[1] - lb[1]) / 20.0
    interior = (
        (R > lb[0] + fx) & (R < ub[0] - fx) & (T > lb[1] + fy) & (T < ub[1] - fy)
    )
    return jnp.where(interior, 0.0, 1.0).astype(R.dtype)


def gaussian_smooth_nd(F: Array, sig: float = 1.0, wid: int = 5) -> Array:
    """Separable 'same'-mode Gaussian smoothing along every axis of a
    d-dimensional density (the N-D analog of gaussian_smooth_2d; one small
    1-D convolution per axis, fully on-device)."""
    w = _gauss_window(sig, wid, F.dtype)
    w = w / jnp.sum(w)
    k = w.shape[0]
    lo = (k - 1) // 2
    hi = k - 1 - lo

    def conv_axis(a: Array, axis: int) -> Array:
        a = jnp.moveaxis(a, axis, -1)
        shp = a.shape
        flat = a.reshape(-1, shp[-1])
        ap = jnp.pad(flat, ((0, 0), (lo, hi)))
        out = jax.vmap(
            lambda r: jnp.convolve(r, w[::-1], mode="valid",
                                   precision="highest")
        )(ap)
        return jnp.moveaxis(out.reshape(shp), -1, axis)

    for ax in range(F.ndim):
        F = conv_axis(F, ax)
    return F


def boundary_band_density_nd(grids, lb: Array, ub: Array) -> Array:
    """N-D analog of ``boundary_band_density``: 1 on the outer 5% shell of
    the box, 0 inside.  ``grids``: per-axis ``indexing='ij'`` meshgrids."""
    interior = None
    for i, G in enumerate(grids):
        band = (ub[i] - lb[i]) / 20.0
        ax_in = (G > lb[i] + band) & (G < ub[i] - band)
        interior = ax_in if interior is None else (interior & ax_in)
    return jnp.where(interior, 0.0, 1.0).astype(grids[0].dtype)


# ---------------------------------------------------------------------------
# Full data pipeline (dataf equivalent)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class BCGroup:
    """One boundary-condition group: LHS-sample the box [lo, hi] and pin the
    solution to ``value`` there (constant, as in the reference UI) or to a
    coordinate expression compiled by tpinn.core.pde (``value_fn``;
    ``value_expr`` carries its source string for UIs/serialization)."""

    lo: Tuple[float, ...]
    hi: Tuple[float, ...]
    value: float = 0.0
    value_fn: Optional[Callable[[Array], Array]] = None
    value_expr: Optional[str] = None
    # which solution component this group pins (coupled systems,
    # tpinn.core.system; scalar problems leave the default 0)
    field: int = 0
    # Neumann/Robin generalization (the reference UI is Dirichlet-only):
    # an expression over u/derivatives/coords, e.g. "u_x" (flux) or
    # "u_x + 0.5*u" (Robin), compiled by tpinn.core.pde and pinned to
    # ``value``/``value_fn`` on this group's box.  None = plain Dirichlet.
    # For coupled systems the expression may reference any field ("v_x");
    # ``field`` is ignored when an operator is set.
    operator: Optional[str] = None

    def target(self, pts: Array) -> Array:
        if self.value_fn is not None:
            return self.value_fn(pts)
        return jnp.full((pts.shape[0], 1), self.value, dtype=pts.dtype)


@dataclass(frozen=True)
class SamplerConfig:
    """Counts per draw: ``n_col`` uniform, ``n_band`` boundary-band,
    ``n_adaptive`` residual-adaptive collocation points, ``n_bd`` points per
    BC group.  Grid is the density grid used for band/adaptive sampling
    (the reference fixes it at 111×111, software.py:522-523)."""

    n_col: int
    n_band: int
    n_adaptive: int
    n_bd: int
    grid: int = 111


def make_sampler(
    config: SamplerConfig,
    bc_groups: Sequence[BCGroup],
    lb: Sequence[float],
    ub: Sequence[float],
    dtype=jnp.float32,
):
    """Build the jittable resampling function for a 2-D problem.

    Returns ``(sample, grids)`` where ``sample(key, F) -> data`` draws a
    fresh point set given the current adaptive density ``F`` on the grid,
    and ``grids = (R, T)`` is the density meshgrid.  ``data`` is a dict:

        x_col : [n_col + n_band + n_adaptive + sum(n_bd), d]  collocation pts
        x_bd  : list of [n_bd, d]  per BC group
        u_bd  : list of [n_bd, 1]  per BC group

    BC points are concatenated into the collocation set, as the reference
    does (software.py:569).
    """
    lb_a = jnp.asarray(lb, dtype)
    ub_a = jnp.asarray(ub, dtype)
    d = lb_a.shape[0]
    if d != 2:
        raise ValueError("make_sampler is 2-D; use make_sampler_1d for 1-D")
    g = config.grid
    r = jnp.linspace(lb_a[0], ub_a[0], g, dtype=dtype)
    t = jnp.linspace(lb_a[1], ub_a[1], g, dtype=dtype)
    R, T = jnp.meshgrid(r, t)
    F_bd = boundary_band_density(R, T, lb_a, ub_a)
    groups = tuple(bc_groups)

    def sample(key: Array, F: Array) -> Dict:
        keys = jax.random.split(key, 3 + len(groups))
        x_bd: List[Array] = []
        u_bd: List[Array] = []
        for gi, grp in enumerate(groups):
            pts = lhs_box(
                keys[3 + gi], config.n_bd, jnp.asarray(grp.lo, dtype),
                jnp.asarray(grp.hi, dtype), dtype,
            )
            x_bd.append(pts)
            u_bd.append(grp.target(pts))
        x_uniform = lhs_box(keys[0], config.n_col, lb_a, ub_a, dtype)
        x_band = inverse_cdf_2d(keys[1], R, T, F_bd, config.n_band)
        x_adapt = inverse_cdf_2d(keys[2], R, T, F, config.n_adaptive)
        parts = [x_uniform, x_band] + x_bd + [x_adapt]
        x_col = jnp.concatenate(parts, axis=0)
        return {"x_col": x_col, "x_bd": x_bd, "u_bd": u_bd}

    return sample, (R, T)


def make_sampler_1d(
    config: SamplerConfig,
    bc_groups: Sequence[BCGroup],
    lb: Sequence[float],
    ub: Sequence[float],
    dtype=jnp.float32,
):
    """1-D counterpart of ``make_sampler`` (the reference's 1-D machinery,
    software.py:21-67, is unreachable from its app; here it is first-class).

    BC groups in 1-D are points (lo == hi): sampled as n_bd copies of the
    endpoint so shapes stay static.
    """
    lb_a = jnp.asarray(lb, dtype)
    ub_a = jnp.asarray(ub, dtype)
    g = config.grid
    x_nodes = jnp.linspace(lb_a[0], ub_a[0], g, dtype=dtype)[:, None]
    groups = tuple(bc_groups)

    def sample(key: Array, F: Array) -> Dict:
        keys = jax.random.split(key, 2 + len(groups))
        x_bd: List[Array] = []
        u_bd: List[Array] = []
        for gi, grp in enumerate(groups):
            span = grp.hi[0] - grp.lo[0]
            if span == 0.0:
                pts = jnp.full((config.n_bd, 1), grp.lo[0], dtype=dtype)
            else:
                pts = lhs_box(
                    keys[2 + gi], config.n_bd, jnp.asarray(grp.lo, dtype),
                    jnp.asarray(grp.hi, dtype), dtype,
                )
            x_bd.append(pts)
            u_bd.append(grp.target(pts))
        x_uniform = lhs_box(keys[0], config.n_col, lb_a, ub_a, dtype)
        n_extra = config.n_band + config.n_adaptive
        parts = [x_uniform]
        if n_extra:
            x_adapt = inverse_cdf_1d(keys[1], x_nodes, F, n_extra)
            parts.append(x_adapt)
        parts += x_bd
        x_col = jnp.concatenate(parts, axis=0)
        return {"x_col": x_col, "x_bd": x_bd, "u_bd": u_bd}

    return sample, (x_nodes,)


def make_sampler_nd(
    config: SamplerConfig,
    bc_groups: Sequence[BCGroup],
    lb: Sequence[float],
    ub: Sequence[float],
    dtype=jnp.float32,
):
    """d ≥ 3 sampler (the reference is strictly 2-D; this generalizes the
    same pipeline — uniform LHS + boundary-band + residual-adaptive draws —
    over an ``indexing='ij'`` d-dimensional density grid).

    Returns ``(sample, grids)`` with ``grids`` the tuple of d meshgrid
    arrays (each of shape grid**d); density refreshes evaluate the residual
    on their flattened stack, exactly like the 2-D path.  Note the grid has
    ``config.grid ** d`` cells — keep ``grid`` modest in high dimension
    (the reference's 111/axis default is a 2-D choice).
    """
    lb_a = jnp.asarray(lb, dtype)
    ub_a = jnp.asarray(ub, dtype)
    d = lb_a.shape[0]
    if d < 3:
        raise ValueError("make_sampler_nd is for d >= 3; use the 1-D/2-D "
                         "samplers (sampler_for dispatches)")
    g = config.grid
    axes = [jnp.linspace(lb_a[i], ub_a[i], g, dtype=dtype) for i in range(d)]
    grids = jnp.meshgrid(*axes, indexing="ij")
    F_bd = boundary_band_density_nd(grids, lb_a, ub_a)
    groups = tuple(bc_groups)

    def sample(key: Array, F: Array) -> Dict:
        keys = jax.random.split(key, 3 + len(groups))
        x_bd: List[Array] = []
        u_bd: List[Array] = []
        for gi, grp in enumerate(groups):
            pts = lhs_box(
                keys[3 + gi], config.n_bd, jnp.asarray(grp.lo, dtype),
                jnp.asarray(grp.hi, dtype), dtype,
            )
            x_bd.append(pts)
            u_bd.append(grp.target(pts))
        parts = [lhs_box(keys[0], config.n_col, lb_a, ub_a, dtype)]
        if config.n_band:
            parts.append(inverse_cdf_nd(keys[1], axes, F_bd, config.n_band))
        parts += x_bd
        if config.n_adaptive:
            parts.append(inverse_cdf_nd(keys[2], axes, F, config.n_adaptive))
        x_col = jnp.concatenate(parts, axis=0)
        return {"x_col": x_col, "x_bd": x_bd, "u_bd": u_bd}

    return sample, tuple(grids)


def sampler_for(
    config: SamplerConfig,
    bc_groups: Sequence[BCGroup],
    lb: Sequence[float],
    ub: Sequence[float],
    dtype=jnp.float32,
):
    """Dispatch the point sampler on the domain dimension (1/2/N-D)."""
    d = len(lb)
    if d == 1:
        return make_sampler_1d(config, bc_groups, lb, ub, dtype)
    if d == 2:
        return make_sampler(config, bc_groups, lb, ub, dtype)
    return make_sampler_nd(config, bc_groups, lb, ub, dtype)


def density_geometry(grids):
    """``(z_grid, reshape, smooth)`` for evaluating an adaptive density on a
    sampler's grid tuple in any dimension: flatten the grid to an [N, d]
    point stack, reshape a residual column back onto the grid, and apply
    the dimension-appropriate separable Gaussian smoothing."""
    if len(grids) == 1:
        x_nodes = grids[0]
        return (x_nodes, lambda f: f,
                lambda f: gaussian_smooth_1d(f, 1.0, 5))
    if len(grids) == 2:
        R, T = grids
        z = jnp.stack([R.reshape(-1), T.reshape(-1)], axis=1)
        return (z, lambda f: jnp.reshape(f, R.shape),
                lambda F: gaussian_smooth_2d(F, (1.0, 1.0), (5, 5)))
    z = jnp.stack([G.reshape(-1) for G in grids], axis=1)
    shp = grids[0].shape
    return z, lambda f: jnp.reshape(f, shp), gaussian_smooth_nd
