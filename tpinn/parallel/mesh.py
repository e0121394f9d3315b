"""Device-mesh parallelism for PINN training.

The reference is strictly single-device (SURVEY §2 parallelism census: no
DP/TP/PP/SP/EP, no collectives of any kind).  The right scale axes for this
workload — and the ones implemented here — are:

- **points** (data parallelism): the loss is a mean over collocation /
  boundary points, so sharding the point batch across devices makes every
  per-point residual evaluation local; only the scalar loss terms and the
  parameter gradients cross the interconnect (one psum per step, inserted
  by XLA from sharding annotations).  Parameters (a few-KB MLP) are
  replicated.
- **ensemble** (a form of model parallelism that actually pays off at this
  model size): independent networks (different seeds / frequency scales /
  stages) trained simultaneously via vmap, sharded one-or-more per device.
  Tensor/pipeline parallelism would be counterproductive for ~10-100KB
  parameter pytrees — a 50-wide layer already leaves each device's matrix
  units mostly idle; this is documented as a deliberate design position
  (SURVEY §5).

Everything uses `jax.sharding.Mesh` + NamedSharding annotations under
``jit`` — XLA chooses the collectives — with
``jax.lax.with_sharding_constraint`` pinning the point batches.  The same
code runs on 1 CPU device, a virtual 8-CPU mesh (tests), or the cards of
one or more GPU hosts.  The cards of one host are joined all to all, so
the mesh follows the algorithm, not the topology.

**Several hosts.**  Beyond one host, the only traffic this workload
generates is the per-step gradient psum of a 10-100KB parameter pytree,
so the right strategy is plain points-DP *across* hosts too:
``make_multihost_mesh`` extends the points axis over every host, laying
devices out so points-axis neighbours share a host and exactly one
gradient all-reduce per step crosses the network.  Under a
multi-controller launch each process calls ``jax.distributed.initialize()``
first and passes ``jax.devices()`` (global) here; all sharding annotations
downstream are unchanged because the axis names are the same.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Sequence

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

Array = jax.Array

POINTS_AXIS = "points"
ENSEMBLE_AXIS = "ensemble"


def make_mesh(
    devices: Optional[Sequence] = None,
    ensemble: int = 1,
) -> Mesh:
    """Build a (ensemble, points) mesh over the available devices.

    ``ensemble`` divides the device count; the remainder becomes the points
    (data-parallel) axis.  ``ensemble=1`` gives pure point-parallelism.
    """
    devices = list(devices if devices is not None else jax.devices())
    n = len(devices)
    if n % ensemble != 0:
        raise ValueError(f"{n} devices not divisible by ensemble={ensemble}")
    arr = np.asarray(devices).reshape(ensemble, n // ensemble)
    return Mesh(arr, (ENSEMBLE_AXIS, POINTS_AXIS))


def make_multihost_mesh(
    devices: Optional[Sequence] = None,
    ensemble: int = 1,
    n_hosts: Optional[int] = None,
) -> Mesh:
    """(ensemble, points) mesh spanning the devices of several hosts.

    Devices are grouped by ``process_index``, one group per host process.
    When every device reports the same process (one process driving every
    card, or virtual CPU devices in tests), ``n_hosts`` contiguous blocks
    of ``len/n_hosts`` devices stand for the hosts.  Within each ensemble
    row the points axis enumerates host 0's devices, then host 1's, …, so
    XLA's gradient all-reduce decomposes into in-host reductions plus one
    small cross-host exchange.  Run ``jax.distributed.initialize()`` per
    process first under a multi-controller launch.
    """
    devices = list(devices if devices is not None else jax.devices())
    procs = sorted({d.process_index for d in devices})
    if len(procs) > 1:
        if n_hosts is not None and n_hosts != len(procs):
            raise ValueError(f"n_hosts={n_hosts} but the devices span "
                             f"{len(procs)} processes")
        groups = [[d for d in devices if d.process_index == p]
                  for p in procs]
    else:
        n_hosts = n_hosts or 1
        if len(devices) % n_hosts:
            raise ValueError(f"{len(devices)} devices not divisible by "
                             f"n_hosts={n_hosts}")
        per = len(devices) // n_hosts
        groups = [devices[i * per:(i + 1) * per] for i in range(n_hosts)]
    per_host = len(groups[0])
    if any(len(g) != per_host for g in groups):
        raise ValueError("hosts have unequal device counts")
    if per_host % ensemble:
        raise ValueError(f"per-host device count {per_host} not divisible "
                         f"by ensemble={ensemble}")
    # [ensemble, points] with points = host-major blocks of in-host devices
    chunk = per_host // ensemble
    rows = [[d for g in groups for d in g[e * chunk:(e + 1) * chunk]]
            for e in range(ensemble)]
    return Mesh(np.asarray(rows, dtype=object), (ENSEMBLE_AXIS, POINTS_AXIS))


def points_sharding(mesh: Mesh) -> NamedSharding:
    """Shard the leading (point-batch) axis across the points axis."""
    return NamedSharding(mesh, P(POINTS_AXIS, None))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


def _batch_sharding(x: Array, mesh: Mesh) -> NamedSharding:
    """Points sharding when the batch divides the points axis, else
    replicated: samplers round their counts (``round_count``), but a
    deterministic grid (e.g. 450 points per BC group on 4 devices) need
    not divide, and its few points are cheap to evaluate on every
    device."""
    if x.shape[0] % mesh.shape[POINTS_AXIS] == 0:
        return points_sharding(mesh)
    return replicated(mesh)


def _constrain_points(x: Array, mesh: Mesh) -> Array:
    return jax.lax.with_sharding_constraint(x, _batch_sharding(x, mesh))


def shard_data(data: Dict, mesh: Mesh) -> Dict:
    """Place a sampler output dict with point batches sharded over the
    devices (a batch that does not divide the points axis is
    replicated)."""
    put = lambda x: jax.device_put(x, _batch_sharding(x, mesh))
    out = dict(data)
    out["x_col"] = put(data["x_col"])
    out["x_bd"] = [put(x) for x in data["x_bd"]]
    out["u_bd"] = [put(u) for u in data["u_bd"]]
    return out


def round_count(n: int, mesh: Mesh) -> int:
    """Round a sample count up to a multiple of the points-axis size."""
    size = mesh.shape[POINTS_AXIS]
    return int(-(-n // size) * size)


def sharded_sampler(sample_fn: Callable, mesh: Mesh) -> Callable:
    """Wrap a sampler so freshly drawn batches carry point shardings even
    when generated *inside* a jitted scan (resampling never leaves the
    device mesh)."""

    def fn(key, F):
        data = sample_fn(key, F)
        data = dict(data)
        data["x_col"] = _constrain_points(data["x_col"], mesh)
        data["x_bd"] = [_constrain_points(x, mesh) for x in data["x_bd"]]
        data["u_bd"] = [_constrain_points(u, mesh) for u in data["u_bd"]]
        return data

    return fn


def make_parallel_loss(loss_fn: Callable, mesh: Mesh) -> Callable:
    """Annotate a loss so point batches stay sharded and params replicated.

    XLA turns the final means into a reduce over the points axis (a psum)
    automatically; nothing else crosses devices.
    """

    def fn(params, data, lw, ref):
        data = dict(data)
        data["x_col"] = _constrain_points(data["x_col"], mesh)
        data["x_bd"] = [_constrain_points(x, mesh) for x in data["x_bd"]]
        data["u_bd"] = [_constrain_points(u, mesh) for u in data["u_bd"]]
        return loss_fn(params, data, lw, ref)

    return fn


# ---------------------------------------------------------------------------
# Ensemble parallelism: N independent nets, vmapped, sharded over chips
# ---------------------------------------------------------------------------


def ensemble_init(key: Array, init_fn: Callable, n: int, mesh: Optional[Mesh] = None):
    """Init ``n`` parameter pytrees stacked on a leading ensemble axis,
    sharded over the mesh's ensemble axis when given."""
    keys = jax.random.split(key, n)
    params = jax.vmap(init_fn)(keys)
    if mesh is not None:
        sh = NamedSharding(mesh, P(ENSEMBLE_AXIS))
        params = jax.tree_util.tree_map(lambda x: jax.device_put(x, sh), params)
    return params


def make_ensemble_loss(loss_fn: Callable, mesh: Optional[Mesh] = None) -> Callable:
    """vmap a loss over stacked ensemble params (shared data), returning the
    summed loss (so one backward pass trains all members) plus stacked
    per-member loss_info."""

    vloss = jax.vmap(loss_fn, in_axes=(0, None, None, None))

    def fn(params, data, lw, ref):
        loss_n, info = vloss(params, data, lw, ref)
        return jnp.sum(loss_n), info

    return fn
