"""Two-process ``jax.distributed`` bring-up smoke (VERDICT r3 missing #3).

Everything else in the suite runs single-process (virtual 8-CPU devices);
this test closes the last multi-chip seam that CAN be tested in this image:
a real multi-controller launch — two OS processes, a coordinator, gloo CPU
collectives — building the SAME ``make_multihost_mesh`` a multi-host GPU
launch uses over the global device view, jitting a sharded-points
gradient, and asserting it equals the single-process value.

Reference analog: none — the reference is strictly single-device
(SURVEY §2 parallelism census); this validates tpinn's scale-out design
(tpinn/parallel/mesh.py "Several hosts" docstring contract).
"""

from __future__ import annotations

import json
import os
import socket
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]

WORKER = r"""
import json, sys
import numpy as np

pid, nproc, port = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
import jax

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_cpu_collectives_implementation", "gloo")
jax.distributed.initialize(coordinator_address=f"127.0.0.1:{port}",
                           num_processes=nproc, process_id=pid)
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P

sys.path.insert(0, __ROOT__)
from tpinn.parallel import mesh as pmesh

devs = jax.devices()                       # GLOBAL view: 2 procs x 4 local
assert len(devs) == 8, devs
assert len(jax.local_devices()) == 4
# each process's block of local devices stands for one host
mesh = pmesh.make_multihost_mesh(devs, n_hosts=nproc)
assert mesh.shape == {"ensemble": 1, "points": 8}

# identical host-side data/params on every process (seeded)
rng = np.random.default_rng(0)
x = rng.standard_normal((64, 3)).astype(np.float32)
params = {
    "W1": jnp.asarray(rng.standard_normal((3, 16)).astype(np.float32) / 4),
    "W2": jnp.asarray(rng.standard_normal((16, 1)).astype(np.float32) / 4),
}

def loss(p, xx):
    h = jnp.tanh(xx @ p["W1"])
    return jnp.mean((h @ p["W2"]) ** 2)

ps = NamedSharding(mesh, P("points", None))
rep = NamedSharding(mesh, P())

def put(a, sh):
    a = np.asarray(a)
    return jax.make_array_from_callback(a.shape, sh, lambda idx: a[idx])

xg = put(x, ps)
pg = jax.tree_util.tree_map(lambda a: put(a, rep), params)
grads = jax.jit(jax.grad(loss), in_shardings=(rep, ps),
                out_shardings=rep)(pg, xg)
got = jax.tree_util.tree_map(
    lambda a: np.asarray(a.addressable_data(0)), grads)

# single-process oracle on local device 0, full batch, no mesh
want = jax.tree_util.tree_map(
    np.asarray, jax.grad(loss)(params, jnp.asarray(x)))

err = max(float(np.abs(got[k] - want[k]).max()) for k in want)
print(json.dumps({"pid": pid, "max_abs_err": err,
                   "checksum": float(sum(float(np.sum(v))
                                         for v in got.values()))}))
assert err < 1e-6, err
jax.distributed.shutdown()
"""


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def test_two_process_distributed_gradients_match():
    port = _free_port()
    code = WORKER.replace("__ROOT__", repr(str(ROOT)))
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    env.pop("JAX_NUM_CPU_DEVICES", None)
    procs = [
        subprocess.Popen([sys.executable, "-c", code, str(pid), "2",
                          str(port)],
                         stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                         text=True, env=env, cwd=str(ROOT))
        for pid in (0, 1)
    ]
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=300)
            assert p.returncode == 0, f"rc={p.returncode}\n{err[-3000:]}"
            outs.append(json.loads(out.strip().splitlines()[-1]))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    assert all(o["max_abs_err"] < 1e-6 for o in outs), outs
    # both controllers computed the identical replicated gradient
    assert outs[0]["checksum"] == outs[1]["checksum"], outs
