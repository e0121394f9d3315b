"""The fused Taylor-2 loss engine against the generic nested-jvp engine
and against the plain reference loss (core.refmode), and the engine
choices every entry point accepts."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from tpinn.core import loss as loss_mod
from tpinn.core import net, pde, refmode, train

EQ = "u_rr + 1/r*u_r + 1/r**2*u_tt"   # refmode's polar Laplacian
LW = jnp.array([0.05, 0.0])
REF = jnp.array(1.0)


def _lift(z):
    return 1.0 - (z[:, 0:1] - 0.1) / 0.9


def _bubble(z):
    return (z[:, 0:1] - 0.1) * (1.0 - z[:, 0:1])


def _case(name):
    act, kinds, n, hard = {
        "tanh_periodic": ("tanh", ("minmax", "periodic"), 300, False),
        "sin_minmax": ("sin", ("minmax", "minmax"), 300, False),
        "partial_batch": ("tanh", ("minmax", "periodic"), 77, False),
        "hard_bc": ("tanh", ("minmax", "periodic"), 300, True),
    }[name]
    fm = net.feature_map_for(kinds)
    spec = net.MLPSpec(depth=3, width=24, act_first=act, scl=1.5, epsil=0.8)
    params = net.init_params(jax.random.PRNGKey(0), spec, fm)
    predictor = net.make_predictor(spec, fm, jnp.array([0.1, 0.0]),
                                   jnp.array([1.0, 1.0]))
    if hard:
        predictor = net.wrap_hard_bc(predictor, _lift, _bubble)
    z = jax.random.uniform(jax.random.PRNGKey(1), (n, 2), minval=0.2,
                           maxval=0.9)
    data = {
        "x_col": z,
        "x_bd": [jnp.stack([jnp.full((40,), 0.1),
                            jnp.linspace(0.0, 1.0, 40)], axis=1)],
        "u_bd": [jnp.ones((40, 1))],
    }
    return predictor, params, data


def _loss_and_grad(loss_fn, params, data):
    (l, info), g = jax.value_and_grad(loss_fn, has_aux=True)(
        params, data, LW, REF)
    return float(l), np.asarray(info), jax.flatten_util.ravel_pytree(g)[0]


@pytest.mark.parametrize("case", ["tanh_periodic", "sin_minmax",
                                  "partial_batch", "hard_bc"])
@pytest.mark.parametrize("oracle", ["generic", "refmode"])
def test_fused_engine_matches_oracle(case, oracle):
    """Loss value, loss_info and parameter gradient of
    make_loss(engine="fused") agree with the generic engine and with the
    reference-semantics loss (reverse-over-reverse residual), including
    a batch that is no multiple of anything and the hard-BC product rule
    (net.hard_bc_partials)."""
    import jax.flatten_util  # noqa: F401

    predictor, params, data = _case(case)
    compiled = pde.compile_pde(EQ, coords=("r", "t"))
    fused = loss_mod.make_loss(predictor, compiled, engine="fused")
    want_fn = (loss_mod.make_loss(predictor, compiled, engine="generic")
               if oracle == "generic"
               else refmode.make_reference_loss(predictor))
    l_f, info_f, g_f = _loss_and_grad(fused, params, data)
    l_w, info_w, g_w = _loss_and_grad(want_fn, params, data)
    np.testing.assert_allclose(l_f, l_w, rtol=1e-4)
    np.testing.assert_allclose(info_f, info_w, rtol=1e-4, atol=1e-7)
    scale = float(np.max(np.abs(g_w)))
    assert float(np.max(np.abs(g_f - g_w))) <= 2e-3 * scale


def _make_loss_kernel():
    predictor, _, _ = _case("tanh_periodic")
    loss_mod.make_loss(predictor, pde.compile_pde(EQ, coords=("r", "t")),
                       engine="kernel")


@pytest.mark.parametrize("build", [
    _make_loss_kernel,
    lambda: train.TrainSpec(engine="kernel"),
    lambda: train.TrainSpec(adam_engine="kernel"),
    lambda: train.coerce_ui_option("adam_engine", "kernel"),
], ids=["make_loss", "TrainSpec.engine", "TrainSpec.adam_engine",
        "ui_option"])
def test_kernel_engine_rejected(build):
    """The removed kernel engine is no choice anywhere; the error names
    the valid engines."""
    with pytest.raises(ValueError, match="fused"):
        build()
    assert "kernel" not in loss_mod.ENGINES
    assert train.UI_OPTION_SPEC["adam_engine"] == loss_mod.ENGINES
