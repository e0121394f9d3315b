"""Sharding tests on the virtual 8-device CPU mesh."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from tpinn import parallel, problems
from tpinn.core import loss as loss_mod
from tpinn.core import net, optim, pde, sample, train


@pytest.fixture(scope="module")
def mesh8():
    assert len(jax.devices()) == 8, "conftest must provide 8 virtual devices"
    return parallel.make_mesh()


@pytest.fixture(scope="module")
def mesh_2x4():
    return parallel.make_mesh(ensemble=2)


def _problem_setup(dtype=jnp.float32, n_bd=16):
    problem = problems.poisson_2d()
    compiled = pde.compile_pde(problem.equation, problem.coords)
    fm = net.feature_map_for(problem.feature_kinds)
    spec = net.MLPSpec(depth=2, width=16)
    params = net.init_params(jax.random.PRNGKey(0), spec, fm, dtype)
    predictor = net.make_predictor(
        spec, fm, jnp.asarray(problem.lb), jnp.asarray(problem.ub)
    )
    cfg = sample.SamplerConfig(n_col=128, n_band=32, n_adaptive=32, n_bd=n_bd,
                               grid=21)
    sample_fn, grids = sample.make_sampler(
        cfg, problem.bc_groups, problem.lb, problem.ub, dtype
    )
    loss_fn = loss_mod.make_loss(predictor, compiled)
    return problem, params, predictor, sample_fn, grids, loss_fn, compiled


def test_sharded_loss_matches_single_device(mesh8):
    _, params, _, sample_fn, grids, loss_fn, _ = _problem_setup()
    data = sample_fn(jax.random.PRNGKey(1), jnp.ones_like(grids[0]))
    lw = jnp.array([1.0, 0.0])
    ref = jnp.array(1.0)

    single = jax.jit(loss_fn)(params, data, lw, ref)

    ploss = parallel.make_parallel_loss(loss_fn, mesh8)
    sharded_data = parallel.shard_data(data, mesh8)
    out = jax.jit(ploss)(params, sharded_data, lw, ref)

    np.testing.assert_allclose(float(single[0]), float(out[0]), rtol=1e-5)
    np.testing.assert_allclose(
        np.asarray(single[1]), np.asarray(out[1]), rtol=1e-5
    )


def test_sharded_grad_matches_single_device(mesh8):
    _, params, _, sample_fn, grids, loss_fn, _ = _problem_setup()
    data = sample_fn(jax.random.PRNGKey(2), jnp.ones_like(grids[0]))
    lw = jnp.array([1.0, 0.0])
    ref = jnp.array(1.0)

    g1 = jax.jit(jax.grad(lambda p: loss_fn(p, data, lw, ref)[0]))(params)

    ploss = parallel.make_parallel_loss(loss_fn, mesh8)
    sharded = parallel.shard_data(data, mesh8)
    g2 = jax.jit(jax.grad(lambda p: ploss(p, sharded, lw, ref)[0]))(params)

    for a, b in zip(jax.tree_util.tree_leaves(g1), jax.tree_util.tree_leaves(g2)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=1e-4,
                                   atol=1e-6)


def test_multislice_mesh_layout_and_grad():
    """Emulated 2-host layout on the 8 virtual CPUs: points axis enumerates
    host 0's devices then host 1's (contiguous blocks), and the loss
    gradient matches the single-device value (the one cross-host
    collective is the gradient psum — numerics must be unchanged)."""
    devices = jax.devices()
    mesh = parallel.make_multihost_mesh(devices, ensemble=2, n_hosts=2)
    assert dict(mesh.shape) == {"ensemble": 2, "points": 4}
    # row 0 of the points axis: first half of host 0 then first half of host 1
    row = list(mesh.devices[0])
    assert row == [devices[0], devices[1], devices[4], devices[5]]

    _, params, _, sample_fn, grids, loss_fn, _ = _problem_setup()
    data = sample_fn(jax.random.PRNGKey(3), jnp.ones_like(grids[0]))
    lw, ref = jnp.array([1.0, 0.0]), jnp.array(1.0)
    g1 = jax.jit(jax.grad(lambda p: loss_fn(p, data, lw, ref)[0]))(params)
    ploss = parallel.make_parallel_loss(loss_fn, mesh)
    sharded = parallel.shard_data(data, mesh)
    g2 = jax.jit(jax.grad(lambda p: ploss(p, sharded, lw, ref)[0]))(params)
    for a, b in zip(jax.tree_util.tree_leaves(g1),
                    jax.tree_util.tree_leaves(g2)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=1e-4,
                                   atol=1e-6)


@pytest.mark.slow
def test_full_adam_phase_sharded(mesh8):
    """The complete on-chip Adam automaton runs under the mesh with sharded
    resampling inside the scan."""
    _, params, predictor, sample_fn, grids, loss_fn, compiled = _problem_setup()
    ploss = parallel.make_parallel_loss(loss_fn, mesh8)
    psample = parallel.sharded_sampler(sample_fn, mesh8)
    density_fn = train.make_density_fn(predictor, compiled, grids)
    cfg = optim.AdamConfig(epochs=30, resample_every=10, density_every=15,
                           plateau_every=20, tail_max=10)
    phase = optim.make_adam_phase(ploss, psample, density_fn, cfg,
                                  info_width=loss_mod.loss_info_width(4))
    F0 = jnp.ones_like(grids[0])
    data0 = parallel.shard_data(psample(jax.random.PRNGKey(3), F0), mesh8)
    with jax.sharding.set_mesh(mesh8):
        res = phase(jax.random.PRNGKey(4), params, data0, F0,
                    jnp.array([1.0, 0.0]), jnp.array(1.0))
    hist = np.asarray(res.history)[: int(res.n_valid)]
    assert np.isfinite(hist[:, 0]).all()
    assert hist[-1, 0] < hist[0, 0]


def test_ensemble_parallel(mesh_2x4):
    """4 independent nets trained as one vmapped/sharded ensemble."""
    problem = problems.poisson_1d()
    compiled = pde.compile_pde(problem.equation, problem.coords)
    fm = net.feature_map_for(problem.feature_kinds)
    spec = net.MLPSpec(depth=2, width=16)
    init_fn = lambda k: net.init_params(k, spec, fm)
    eparams = parallel.ensemble_init(jax.random.PRNGKey(0), init_fn, 4,
                                     mesh_2x4)
    predictor = net.make_predictor(spec, fm, jnp.asarray(problem.lb),
                                   jnp.asarray(problem.ub))
    loss_fn = loss_mod.make_loss(predictor, compiled)
    eloss = parallel.make_ensemble_loss(loss_fn, mesh_2x4)

    cfg = sample.SamplerConfig(n_col=64, n_band=0, n_adaptive=0, n_bd=8,
                               grid=33)
    sample_fn, grids = sample.make_sampler_1d(cfg, problem.bc_groups,
                                              problem.lb, problem.ub)
    data = sample_fn(jax.random.PRNGKey(1), jnp.ones_like(grids[0]))
    lw = jnp.array([1.0, 0.0])
    ref = jnp.array(1.0)

    total, infos = jax.jit(eloss)(eparams, data, lw, ref)
    assert infos.shape[0] == 4
    # members differ (different seeds)
    assert len({float(x) for x in infos[:, 0]}) == 4

    # one grad step trains all members at once
    g = jax.jit(jax.grad(lambda p: eloss(p, data, lw, ref)[0]))(eparams)
    assert jax.tree_util.tree_structure(g) == jax.tree_util.tree_structure(eparams)


def test_round_count(mesh8):
    assert parallel.round_count(100, mesh8) == 104
    assert parallel.round_count(104, mesh8) == 104


@pytest.mark.slow
def test_run_training_with_mesh(mesh8, tmp_path):
    """One-argument multi-chip training: the full pipeline under a mesh."""
    from tpinn.core.train import StageSpec, TrainSpec

    problem = problems.poisson_2d()
    spec = TrainSpec(
        n_col=128, n_band=32, n_adaptive=32, n_bd=16,
        testing_size=(31, 31), grid=31, lw=(1.0, 0.0),
        stages=(StageSpec(depth=2, width=16, scl=1.0, epsil=1.0,
                          adam_epochs=40, lbfgs_epochs=15),),
        density_every=20, plateau_every=40, tail_max=10,
    )
    res = train.run_training(problem, spec, output_dir=str(tmp_path),
                             mesh=mesh8)
    assert res.rel_l2 is not None and np.isfinite(res.rel_l2)
    assert (tmp_path / "loss_1.npz").exists()
    # counts were rounded to the points-axis size (4 with ensemble=2... this
    # mesh is (1, 8)): 128/32/32/16 are already multiples of 8
    assert res.history.shape[0] > 40


# ---------------------------------------------------------------------------
# Round-4 capabilities under the mesh: inverse + coupled systems
# ---------------------------------------------------------------------------


def test_sharded_inverse_loss_grad_matches(mesh8):
    """The joint {"net","coef"} pytree rides the points-sharded loss with
    bitwise-meaningful parity: loss and gradients (including d/dcoef)
    match the single-device values."""
    from tpinn.core.inverse import make_inverse_loss

    problem = problems.poisson_2d()
    compiled = pde.compile_pde("lam*(u_xx + u_yy) + 2*pi**2*sin(pi*x)*sin(pi*y)",
                               problem.coords, params=("lam",))
    fm = net.feature_map_for(problem.feature_kinds)
    mspec = net.MLPSpec(depth=2, width=16)
    net_p = net.init_params(jax.random.PRNGKey(0), mspec, fm, jnp.float32)
    predictor = net.make_predictor(
        mspec, fm, jnp.asarray(problem.lb), jnp.asarray(problem.ub))
    params = {"net": net_p, "coef": {"lam": jnp.float32(0.7)}}

    z_obs = jax.random.uniform(jax.random.PRNGKey(7), (24, 2))
    u_obs = jnp.sin(jnp.pi * z_obs[:, :1]) * jnp.sin(jnp.pi * z_obs[:, 1:2])
    loss_fn = make_inverse_loss(predictor, compiled, z_obs, u_obs)

    cfg = sample.SamplerConfig(n_col=128, n_band=32, n_adaptive=32, n_bd=16,
                               grid=21)
    sample_fn, grids = sample.make_sampler(
        cfg, problem.bc_groups, problem.lb, problem.ub, jnp.float32)
    data = sample_fn(jax.random.PRNGKey(1), jnp.ones_like(grids[0]))
    lw = jnp.array([1.0, 0.0])
    ref = jnp.array(1.0)

    (l1, _), g1 = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        params, data, lw, ref)
    ploss = parallel.make_parallel_loss(loss_fn, mesh8)
    data_s = parallel.shard_data(data, mesh8)
    (l2, _), g2 = jax.jit(jax.value_and_grad(ploss, has_aux=True))(
        params, data_s, lw, ref)

    np.testing.assert_allclose(float(l1), float(l2), rtol=2e-6)
    np.testing.assert_allclose(float(g1["coef"]["lam"]),
                               float(g2["coef"]["lam"]), rtol=2e-5)
    for a, b in zip(jax.tree_util.tree_leaves(g1["net"]),
                    jax.tree_util.tree_leaves(g2["net"])):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                   rtol=2e-4, atol=2e-6)


@pytest.mark.slow
def test_run_system_with_mesh(mesh8):
    """Coupled-system inverse identification end-to-end under the mesh."""
    from tpinn.core.inverse import InverseSpec
    from tpinn.core.system import SystemSpec, run_system
    from tpinn.core.train import StageSpec, TrainSpec

    PI = np.pi
    prob = SystemSpec(
        name="osc_inverse_mesh",
        equations=("u_x - v", "v_x + w2*u"),
        fields=("u", "v"), coords=("x",), lb=(0.0,), ub=(1.0,),
        bc_groups=(
            sample.BCGroup(lo=(0.0,), hi=(0.0,), value=0.0, field=0),
        ),
        exact=lambda z: jnp.concatenate(
            [jnp.sin(PI * z[:, :1]), PI * jnp.cos(PI * z[:, :1])], axis=1),
    )
    inv = InverseSpec(params=("w2",), init=(5.0,), n_obs=80)
    spec = TrainSpec(
        n_col=256, n_band=0, n_adaptive=64, n_bd=16,
        stages=(StageSpec(depth=3, width=24,
                          adam_epochs=400, lbfgs_epochs=600),),
        grid=64, lw=(1.0, 0.0), testing_size=(201,), pad_features=3,
        log_every=200,
    )
    r = run_system(prob, spec, inverse=inv, mesh=mesh8)
    assert abs(r.coef["w2"] - PI**2) / PI**2 < 5e-2
    assert r.rel_l2 is not None and r.rel_l2 < 2e-2


def test_params_stay_replicated_after_lsq_polish(mesh8, tmp_path):
    """run_training under the mesh: after the host-side LSQ polish the
    params go back with the sharding they had (replicated over all 8
    devices), not onto one device.  The 12-point BC grid groups do not
    divide the points axis and ride replicated."""
    from tpinn.core.train import StageSpec, TrainSpec

    problem = problems.poisson_2d()
    spec = TrainSpec(
        n_col=128, n_band=32, n_adaptive=32, n_bd=16,
        testing_size=(21, 21), grid=21, lw=(1.0, 0.0), lsq_polish="auto",
        stages=(StageSpec(depth=2, width=16, scl=1.0, epsil=1.0,
                          adam_epochs=40, lbfgs_epochs=15,
                          lbfgs_grid=12),),
        density_every=20, plateau_every=40, tail_max=10,
    )
    lines = []
    res = train.run_training(problem, spec, mesh=mesh8, log_fn=lines.append)
    assert any("lsq polish objective" in l for l in lines)
    assert np.isfinite(res.rel_l2)
    devices = set(mesh8.devices.flat)
    for leaf in jax.tree_util.tree_leaves(res.stages[-1].params):
        assert leaf.sharding.is_fully_replicated
        assert leaf.sharding.device_set == devices


def test_shard_data_replicates_indivisible_batches(mesh8):
    data = {"x_col": jnp.ones((64, 2)), "x_bd": [jnp.ones((12, 2))],
            "u_bd": [jnp.ones((12, 1))]}
    out = parallel.shard_data(data, mesh8)
    assert out["x_col"].sharding == parallel.points_sharding(mesh8)
    assert out["x_bd"][0].sharding.is_fully_replicated
    assert out["u_bd"][0].sharding.is_fully_replicated
