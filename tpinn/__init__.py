"""tpinn — a physics-informed neural network (PINN) framework in JAX.

A ground-up JAX/XLA rebuild of the capabilities of the reference
"PINN-based online PDE calculator" (see /root/reference, SURVEY.md):

- ``tpinn.core``     — solver library: symbolic PDE compiler, forward-mode
  derivative engine, MLP model zoo, on-device sampling, loss system,
  Adam schedule automaton and pure-XLA L-BFGS, multi-stage training.
- ``tpinn.parallel`` — device-mesh sharding (collocation-point data
  parallelism + ensemble parallelism) via jax.sharding / shard_map.
- ``tpinn.problems`` — benchmark problem presets with analytic oracles.
- ``tpinn.app``      — web UI + artifact/logging layer preserving the
  reference's .npz / log contracts.

Design notes: everything on the training path is jit-compiled with static
shapes; sampling, adaptive-density refresh and optimizer schedules run
on-device inside lax.scan/while_loop so a whole training stage is a single
XLA computation with no host round-trips (the reference re-enters Python
every step and resamples on host, software.py:396-460).
"""

__version__ = "0.1.0"
