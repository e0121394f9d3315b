"""Network zoo: dense PINN MLPs, feature maps, multi-stage composition.

Reproduces the reference's network semantics (software.py:139-234) in a
shape-generic, dtype-generic form:

- Xavier-scaled truncated-normal (±2σ) init for weights AND biases
  (software.py:148-152).
- Input feature map: per-coordinate min-max normalization to [-1, 1] and/or
  periodic cos/sin embedding (the reference hardcodes [minmax(r), cos θ,
  sin θ], software.py:172-175; here it is configurable per coordinate).
- First layer activation selectable tanh/sin with frequency scale ``scl``
  applied inside the activation; hidden layers tanh; linear output; output
  scaled by amplitude ``epsil`` (software.py:170-183, 215).
- Multi-stage composition u(z) = u_prev(z) + epsil * NN(z) with the previous
  stage frozen via closure capture (software.py:221-234).

The reference swaps depth/width when wiring the UI (SURVEY.md §2b.14); this
module uses the correct semantics: ``depth`` = number of hidden layers,
``width`` = units per hidden layer.

Beyond the reference, the zoo adds model families that directly target PINN
failure modes: random-Fourier-feature MLPs (spectral bias / Helmholtz) and
the modified MLP of Wang et al. with multiplicative gating.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, List, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp

Array = jax.Array
Params = List[dict]  # [{"w": [din, dout], "b": [dout]} per layer]


# ---------------------------------------------------------------------------
# Initialization
# ---------------------------------------------------------------------------


def init_mlp(key: Array, sizes: Sequence[int], dtype=jnp.float32) -> Params:
    """Xavier truncated-normal init for a dense chain ``sizes[0]→…→sizes[-1]``."""
    params: Params = []
    keys = jax.random.split(key, len(sizes) - 1)
    for din, dout, k in zip(sizes[:-1], sizes[1:], keys):
        std = jnp.sqrt(2.0 / (din + dout)).astype(dtype)
        kw, kb = jax.random.split(k)
        w = jax.random.truncated_normal(kw, -2.0, 2.0, (din, dout), dtype) * std
        b = jax.random.truncated_normal(kb, -2.0, 2.0, (dout,), dtype) * std
        params.append({"w": w, "b": b})
    return params


# ---------------------------------------------------------------------------
# Feature maps
# ---------------------------------------------------------------------------

MINMAX = "minmax"
PERIODIC = "periodic"
PERIODIC_FIT = "periodic_fit"
IDENTITY = "identity"

_FEATURE_WIDTH = {MINMAX: 1, PERIODIC: 2, PERIODIC_FIT: 2, IDENTITY: 1}


@dataclass(frozen=True)
class FeatureMap:
    """Per-coordinate input embedding.

    ``kinds[i]`` ∈ {"minmax", "periodic", "identity"} selects the embedding
    of coordinate i.  The reference's hard 2π-periodicity constraint in θ is
    ``kinds = ("minmax", "periodic")``.

    ``pad_to``: minimum output width — duplicates of the first column are
    appended until the embedding has at least this many columns.  The model
    class is unchanged (a duplicated input spans the same functions), but
    the first layer gets one weight row per column, so padding changes its
    initialisation; checkpoints record ``pad_features`` to rebuild it."""

    kinds: Tuple[str, ...]
    pad_to: int = 0

    @property
    def num_features(self) -> int:
        base = sum(_FEATURE_WIDTH[k] for k in self.kinds)
        return max(base, self.pad_to)

    def __call__(self, z: Array, lb: Array, ub: Array) -> Array:
        cols = []
        for i, kind in enumerate(self.kinds):
            x = z[:, i : i + 1]
            if kind == MINMAX:
                cols.append(2.0 * (x - lb[i]) / (ub[i] - lb[i]) - 1.0)
            elif kind == PERIODIC:
                cols.append(jnp.cos(x))
                cols.append(jnp.sin(x))
            elif kind == PERIODIC_FIT:
                # period = the coordinate's domain width (PERIODIC assumes
                # the raw coordinate spans one 2π period, which only suits
                # angle-like axes; this variant makes any box axis exactly
                # periodic — allen_cahn's x∈[−1,1], nls's x∈[−5,5])
                w = 2.0 * jnp.pi * (x - lb[i]) / (ub[i] - lb[i])
                cols.append(jnp.cos(w))
                cols.append(jnp.sin(w))
            elif kind == IDENTITY:
                cols.append(x)
            else:  # pragma: no cover - guarded by dataclass construction
                raise ValueError(f"unknown feature kind {kind!r}")
        while len(cols) < self.pad_to:
            cols.append(cols[0])
        return jnp.concatenate(cols, axis=1)


def feature_map_for(kinds: Sequence[str], pad_to: int = 0) -> FeatureMap:
    for k in kinds:
        if k not in _FEATURE_WIDTH:
            raise ValueError(f"unknown feature kind {k!r}")
    return FeatureMap(tuple(kinds), pad_to=int(pad_to))


# ---------------------------------------------------------------------------
# Activations
# ---------------------------------------------------------------------------

_ACTIVATIONS = {"tanh": jnp.tanh, "sin": jnp.sin}


def activation(name: str) -> Callable[[Array], Array]:
    try:
        return _ACTIVATIONS[name]
    except KeyError:
        raise ValueError(f"unknown activation {name!r}") from None


# ---------------------------------------------------------------------------
# Model specs / apply functions
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class MLPSpec:
    """Architecture + scaling of one PINN stage network.

    :param depth: number of hidden layers.
    :param width: units per hidden layer.
    :param out_dim: network outputs (1 for scalar PDEs).
    :param act_first: first-layer activation, "tanh" or "sin"
        (act_s 0/1 in the reference, software.py:170).
    :param scl: frequency scale applied inside the first activation.
    :param epsil: output amplitude multiplier.
    :param fourier_features: if > 0, replace the plain feature map input with
        ``fourier_features`` random Fourier features (Tancik et al.) drawn
        with std ``fourier_scale`` — spectral-bias mitigation for
        high-frequency problems (e.g. Helmholtz k=20).
    :param modified: use the modified-MLP gating of Wang et al. (2021):
        two auxiliary encoders U, V and per-layer interpolation
        ``H ← (1−H̃)·U + H̃·V``.
    """

    depth: int
    width: int
    out_dim: int = 1
    act_first: str = "tanh"
    act_hidden: str = "tanh"   # "sin" gives SIREN-style all-periodic nets
    scl: float = 1.0
    epsil: float = 1.0
    fourier_features: int = 0
    fourier_scale: float = 1.0
    modified: bool = False
    # jax.lax matmul precision for the dense chain.  "highest" = full fp32;
    # a reduced tier (TF32 or bf16 inputs, the backend's choice) is too
    # coarse for the second-derivative residuals PINNs converge on.
    precision: str = "highest"


def init_params(key: Array, spec: MLPSpec, feature_map: FeatureMap, dtype=jnp.float32):
    """Initialize the parameter pytree for ``spec``.

    Returns a dict pytree; plain MLPs have ``{"layers": [...]}`` so that
    extra families (fourier B matrix, modified-MLP gates) extend it without
    changing the layer chain structure.
    """
    n_in = feature_map.num_features
    p: dict = {}
    k_layers, k_extra = jax.random.split(key)
    if spec.fourier_features:
        # Fixed (non-trainable treated as trainable-with-init) projection B.
        b_key, k_layers = jax.random.split(k_layers)
        p["fourier_b"] = (
            jax.random.normal(b_key, (n_in, spec.fourier_features), dtype)
            * spec.fourier_scale
        )
        n_in = 2 * spec.fourier_features
    sizes = [n_in] + [spec.width] * spec.depth + [spec.out_dim]
    p["layers"] = init_mlp(k_layers, sizes, dtype)
    if spec.modified:
        ku, kv = jax.random.split(k_extra)
        p["gate_u"] = init_mlp(ku, [n_in, spec.width], dtype)[0]
        p["gate_v"] = init_mlp(kv, [n_in, spec.width], dtype)[0]
    return p


def mlp_hidden(params: dict, h: Array, spec: MLPSpec) -> Array:
    """Dense chain up to (and excluding) the output layer: the feature
    basis ``[N, width]`` the output layer combines linearly.  Split out of
    ``mlp_apply`` so the last-layer least-squares polish
    (tpinn.core.polish) can treat the network as a learned basis."""
    act0 = activation(spec.act_first)
    acth = activation(spec.act_hidden)
    layers = params["layers"]
    dot = lambda a, b: jnp.dot(a, b, precision=spec.precision)
    if spec.fourier_features:
        proj = dot(h, params["fourier_b"])
        h = jnp.concatenate([jnp.cos(proj), jnp.sin(proj)], axis=1)
    first, *hidden, _last = layers
    if spec.modified:
        u = jnp.tanh(dot(h, params["gate_u"]["w"]) + params["gate_u"]["b"])
        v = jnp.tanh(dot(h, params["gate_v"]["w"]) + params["gate_v"]["b"])
        h = act0(dot(h, first["w"]) * spec.scl + first["b"])
        h = (1.0 - h) * u + h * v
        for layer in hidden:
            t = acth(dot(h, layer["w"]) + layer["b"])
            h = (1.0 - t) * u + t * v
    else:
        h = act0(dot(h, first["w"]) * spec.scl + first["b"])
        for layer in hidden:
            h = acth(dot(h, layer["w"]) + layer["b"])
    return h


def mlp_apply(params: dict, h: Array, spec: MLPSpec) -> Array:
    """Dense chain on already-embedded features ``h``."""
    h = mlp_hidden(params, h, spec)
    last = params["layers"][-1]
    return jnp.dot(h, last["w"], precision=spec.precision) + last["b"]


# ---------------------------------------------------------------------------
# Predictors (feature map + network + amplitude), and stage composition
# ---------------------------------------------------------------------------


def make_predictor(
    spec: MLPSpec,
    feature_map: FeatureMap,
    lb: Array,
    ub: Array,
) -> Callable[[dict, Array], Array]:
    """Build ``u(params, z)`` = epsil * MLP(features(z)).

    Mirrors sol_pred_create (software.py:207-218) with the feature map made
    explicit instead of hardcoded.
    """

    lb = jnp.asarray(lb)
    ub = jnp.asarray(ub)

    def f_u(params: dict, z: Array) -> Array:
        h = feature_map(z, lb, ub)
        return spec.epsil * mlp_apply(params, h, spec)

    from tpinn.core import taylor  # late import (taylor imports net)

    return taylor.attach_mlp_meta(f_u, spec, feature_map, lb, ub)


def compose_stages(
    prev_predictor: Callable[[dict, Array], Array],
    spec: MLPSpec,
    feature_map: FeatureMap,
    lb: Array,
    ub: Array,
) -> Callable[[dict, Array], Array]:
    """Multilevel predictor ``u(z) = u_prev(prev_params, z) + NN(params, z)``.

    Mirrors mNN_pred_create (software.py:221-234) but — unlike the
    reference's closure capture, which bakes the previous stage's weights
    into the next stage's jitted graphs as compile-time constants (XLA
    constant-folding warnings, bloated executables) — the frozen parameters
    are threaded as *runtime arguments*: the composed predictor takes the
    nested pytree ``{"stage": <this stage>, "prev": <previous chain>}`` and
    stops gradients into the ``prev`` subtree, so optimizers see exact-zero
    gradients there and the weights stay frozen.
    """

    stage_fn = make_predictor(spec, feature_map, lb, ub)

    def f_comb(params: dict, z: Array) -> Array:
        prev_u = prev_predictor(jax.lax.stop_gradient(params["prev"]), z)
        return prev_u + stage_fn(params["stage"], z)

    from tpinn.core import taylor  # late import (taylor imports net)

    return taylor.attach_sum_meta(f_comb, prev_predictor, stage_fn)


def compose_params(stage_params, prev_params) -> dict:
    """Parameter pytree for a composed predictor (see compose_stages)."""
    return {"stage": stage_params, "prev": prev_params}


def hard_bc_partials(raw_partials, lift_fn, bubble_fn):
    """Partials of ``u = lift + bubble·v`` from the RAW net's partials
    source (the fused Taylor-2 engine) by the product rule:

        u_i  = l_i + b_i·v + b·v_i
        u_ij = l_ij + b_ij·v + b_i·v_j + b_j·v_i + b·v_ij

    lift/bubble derivatives come from the generic jvp engine (cheap scalar
    expressions); ``raw_partials(params, z, need)`` supplies v and its
    derivatives and may return a SUPERSET of ``need``."""

    def tpinn_partials(params, z, indices):
        from tpinn.core import deriv  # late import (deriv imports net)

        need = set()
        for ix in indices:
            need.add(ix)
            if len(ix) == 2:
                need.add((ix[0],))
                need.add((ix[1],))
        need.add(())
        need = sorted(need, key=lambda t: (len(t), t))
        v = raw_partials(params, z, need)
        l = deriv.partials(lift_fn, z, need)
        b = deriv.partials(bubble_fn, z, need)
        out = {}
        for ix in indices:
            if ix == ():
                out[ix] = l[()] + b[()] * v[()]
            elif len(ix) == 1:
                out[ix] = (l[ix] + b[ix] * v[()] + b[()] * v[ix])
            else:
                i, j = ix
                out[ix] = (l[ix] + b[ix] * v[()]
                           + b[(i,)] * v[(j,)] + b[(j,)] * v[(i,)]
                           + b[()] * v[ix])
        return out

    return tpinn_partials


def wrap_hard_bc(raw_predictor, lift_fn, bubble_fn):
    """Hard boundary-condition ansatz ``u(z) = lift(z) + bubble(z)·N(z)``.

    ``lift`` satisfies the Dirichlet data exactly, ``bubble`` vanishes on
    the constrained boundary, so u meets the BCs to machine precision for
    ANY network output and the optimizer spends its whole budget on the
    residual.  (The reference imposes BCs only through loss penalties;
    hard constraints are a deliberate capability extension — the measured
    soft-BC error floor on the annulus is the dominant rel-L2 term.)

    The wrapper keeps the raw chain accessible (``tpinn_raw``,
    ``tpinn_hard``) so stage composition can extend the chain INSIDE the
    bubble (otherwise later stages would reintroduce boundary error)."""

    def f_hard(params, z):
        return lift_fn(z) + bubble_fn(z) * raw_predictor(params, z)

    raw_partials = getattr(raw_predictor, "tpinn_partials", None)
    if raw_partials is not None:
        f_hard.tpinn_partials = hard_bc_partials(
            raw_partials, lift_fn, bubble_fn
        )

    f_hard.tpinn_raw = raw_predictor
    f_hard.tpinn_hard = (lift_fn, bubble_fn)
    return f_hard


def spec_to_dict(spec: MLPSpec) -> dict:
    from dataclasses import asdict

    return asdict(spec)


def spec_from_dict(d: dict) -> MLPSpec:
    return MLPSpec(**d)


def num_params(params) -> int:
    return sum(int(x.size) for x in jax.tree_util.tree_leaves(params))
