"""Test configuration: run JAX on a virtual 8-device CPU mesh.

This is the TPU build's analog of the reference's np=1,2,4,8 single-node
testing (SURVEY.md section 4): the same partitioned solve paths run over
XLA's host-platform device simulation so distributed code is exercised in
CI without TPU hardware.  float64 is enabled to match the reference's
strictly-FP64 semantics for correctness tests.
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

os.environ.setdefault("JAX_ENABLE_X64", "1")

from acg_tpu._platform import provision_host_mesh  # noqa: E402

jax = provision_host_mesh(8)
jax.config.update("jax_enable_x64", True)

# -- two-process collective capability probe ----------------------------
#
# The two-process CLI tests need the CPU backend to RUN cross-process
# XLA computations, not just to initialise a coordinator: some jaxlib
# CPU builds raise "Multiprocess computations aren't implemented on the
# CPU backend" at dispatch.  Probing that with a real two-process psum
# once per session lets those tests SKIP with the true reason instead
# of failing in containers whose backend lacks the capability.
# ACG_TPU_MULTIPROC_TESTS=1/0 overrides the probe either way.

_PROBE_CODE = """
import sys
import numpy as np
from acg_tpu.parallel.multihost import initialize
initialize("localhost:%d", 2, int(sys.argv[1]))
import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from acg_tpu._platform import shard_map
assert jax.process_count() == 2
devs = np.asarray(jax.devices()[:2])
mesh = Mesh(devs, ("x",))
f = jax.jit(shard_map(lambda a: jax.lax.psum(a, "x"), mesh=mesh,
                      in_specs=P("x"), out_specs=P()))
a = jax.device_put(jnp.arange(2.0),
                   NamedSharding(mesh, P("x")))
out = np.asarray(f(a))
assert out == 1.0, out
print("MULTIPROC-OK")
"""

_mp_status = None


def _multiprocess_collectives_status():
    """Cached ``(available, reason)`` for cross-process XLA
    collectives on this backend."""
    global _mp_status
    if _mp_status is not None:
        return _mp_status
    forced = os.environ.get("ACG_TPU_MULTIPROC_TESTS")
    if forced is not None:
        _mp_status = (forced not in ("0", "false", ""),
                      "forced by ACG_TPU_MULTIPROC_TESTS")
        return _mp_status
    import socket
    import subprocess

    with socket.socket() as s:
        s.bind(("", 0))
        port = s.getsockname()[1]
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
    procs = [subprocess.Popen(
        [sys.executable, "-c", _PROBE_CODE % port, str(i)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        env=env, cwd=os.path.dirname(os.path.dirname(
            os.path.abspath(__file__)))) for i in range(2)]
    try:
        outs = [p.communicate(timeout=180) for p in procs]
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        _mp_status = (False, "two-process collective probe timed out")
        return _mp_status
    if all(p.returncode == 0 and "MULTIPROC-OK" in so
           for p, (so, _) in zip(procs, outs)):
        _mp_status = (True, "")
    else:
        reason = "two-process XLA computation failed"
        for _, (_, se) in zip(procs, outs):
            for line in se.splitlines():
                if "Multiprocess computations" in line:
                    reason = line.strip().split("INVALID_ARGUMENT: ")[-1]
                    break
        _mp_status = (False, reason)
    return _mp_status


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "two_process_collectives: needs cross-process XLA collectives "
        "(skipped when the CPU backend lacks them; probe in conftest)")
    config.addinivalue_line(
        "markers",
        "slow: excluded from the tier-1 run (-m 'not slow'); full "
        "campaigns and long soak scenarios")
    config.addinivalue_line(
        "markers",
        "cuda: needs a CUDA device (the port's kernels run only on the "
        "card); skips without one")


def pytest_collection_modifyitems(config, items):
    import pytest

    marked = [it for it in items
              if it.get_closest_marker("two_process_collectives")]
    if not marked:
        return
    ok, reason = _multiprocess_collectives_status()
    if ok:
        return
    skip = pytest.mark.skip(
        reason=f"CPU backend lacks multiprocess collectives in this "
               f"environment: {reason}")
    for it in marked:
        it.add_marker(skip)
