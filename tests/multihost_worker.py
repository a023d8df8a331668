"""Worker process for tests/test_multihost.py.

Launched twice (process_id 0/1) over a localhost coordinator; each
process exposes 2 virtual CPU devices, giving a 2x2 (scenario x
cluster) hybrid mesh.  Asserts:

1. the measurement exchange unions both hosts' local returns,
2. one scenario+cluster-sharded tracker step on the global mesh equals
   the unsharded single-process step run locally on the same inputs.

Usage: python multihost_worker.py <pid> <nproc> <port>
"""
import os
import sys

pid, nproc, port = int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3])
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"

import numpy as np
import jax

jax.config.update("jax_platforms", "cpu")

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from pymht_tpu.parallel import multihost  # noqa: E402

assert multihost.initialize(f"127.0.0.1:{port}", nproc, pid)
assert jax.process_count() == nproc
assert jax.device_count() == 2 * nproc

import jax.numpy as jnp  # noqa: E402
from jax.sharding import NamedSharding, PartitionSpec as P  # noqa: E402
from pymht_tpu.core.config import TrackerShapes, TrackerParams  # noqa: E402
from pymht_tpu.core.grow import Scan, empty_ais  # noqa: E402
from pymht_tpu.parallel import scenario as scen  # noqa: E402

# --- 1. measurement exchange -------------------------------------------
M = 8
z_local = np.zeros((3, 2), np.float32)
z_local[:2] = [[10.0 * pid, 1.0], [10.0 * pid, 2.0]]   # 2 valid per host
mask_local = np.array([True, True, False])
z, mask = multihost.gather_local_measurements(z_local, mask_local, M)
assert mask.sum() == 2 * nproc, mask
assert {tuple(r) for r in z[mask]} == {
    (10.0 * p, float(v)) for p in range(nproc) for v in (1, 2)}

# --- 2. sharded tracker step == local unsharded step --------------------
mesh = multihost.hybrid_mesh()
assert dict(zip(mesh.axis_names, mesh.devices.shape)) == {
    "scenario": nproc, "cluster": 2}

shapes = TrackerShapes(max_targets=8, max_leaves=8, max_meas=M,
                       max_ais=2, window=4, max_prelim=8, max_initiators=8)
params = TrackerParams(radar_period=1.0, N=2)
B = nproc
state_b, istate_b = scen.batch_states(shapes, params, B)
rng = np.random.default_rng(0)
zb = jnp.asarray(rng.normal(0, 50, (B, M, 2)).astype(np.float32))
scan_b = Scan(z=zb, mask=jnp.ones((B, M), bool),
              time=jnp.full((B,), 1.0, jnp.float32))
ais_b = jax.tree_util.tree_map(
    lambda x: jnp.broadcast_to(x, (B,) + x.shape), empty_ais(shapes))

# local reference: unsharded batched step on this process's device 0
ref_step = jax.jit(scen.make_batched_step(shapes, params))
ref_state, _, ref_out = ref_step(state_b, istate_b, scan_b, ais_b)
ref_scalar = float(jnp.sum(jnp.where(ref_state.leaf_mask,
                                     ref_state.leaf_cnllr, 0.0)))

# global sharded step on the hybrid mesh (same host-identical inputs)
step, in_sh = scen.make_sharded_step(mesh, shapes, params)
args = jax.tree_util.tree_map(
    jax.device_put, (state_b, istate_b, scan_b, ais_b),
    in_sh(state_b, istate_b, scan_b, ais_b))
g_state, _, g_out = step(*args)


@jax.jit
def scalar_of(st):
    s = jnp.sum(jnp.where(st.leaf_mask, st.leaf_cnllr, 0.0))
    return jax.lax.with_sharding_constraint(s, NamedSharding(mesh, P()))


g_scalar = float(scalar_of(g_state))
assert abs(g_scalar - ref_scalar) <= 1e-3 * (1 + abs(ref_scalar)), \
    (g_scalar, ref_scalar)

# --- 3. explicit-collective (shard_map psum/pmin) tracker step with the
# cluster axis SPANNING the two processes (the selection collectives
# crossing hosts) ------------------------------------------------------
from jax.sharding import Mesh  # noqa: E402
from pymht_tpu.models import pv  # noqa: E402
from pymht_tpu.core.state import empty_state, insert_targets  # noqa: E402
from pymht_tpu.core.tracker import scan_step  # noqa: E402
from pymht_tpu.core.grow import Scan as _Scan  # noqa: E402
from pymht_tpu.core import initiator as initiator_mod  # noqa: E402
from pymht_tpu.parallel.sharded_tracker import make_sharded_tracker_step  # noqa: E402

shapes_c = TrackerShapes(max_targets=8, max_leaves=8, max_meas=16,
                         max_ais=2, window=5, max_prelim=8,
                         max_initiators=8)
params_c = TrackerParams(radar_period=2.5, P_d=0.9, lambda_phi=1e-6,
                         lambda_nu=1e-6, N=3, radar_range=float('inf'),
                         cnllr_upper_limit=1e9,
                         score_upper_limit_scale=1e6)
rng_c = np.random.default_rng(5)
xs = np.zeros((4, 4), np.float32)
for i in range(4):
    xs[i, :2] = [30 * i, 3.0 * (i % 2)]
    xs[i, 2:] = [2.0, 0.0]


def _seed_state():
    st = empty_state(shapes_c, params_c)
    mask = np.zeros(8, bool)
    mask[:4] = True
    xs8 = np.zeros((8, 4), np.float32)
    xs8[:4] = xs
    return insert_targets(st, jnp.asarray(xs8),
                          jnp.broadcast_to(jnp.asarray(np.asarray(pv.P0)),
                                           (8, 4, 4)),
                          jnp.asarray(mask), jnp.zeros(8, jnp.int32),
                          jnp.asarray(0.0), params_c)


scans_c = []
for k in range(3):
    t = 2.5 * (k + 1)
    z = np.concatenate([
        xs[:, :2] + xs[:, 2:] * t + rng_c.normal(0, 1.0, (4, 2)),
        xs[:2, :2] + xs[:2, 2:] * t + np.array([0., 2.5])
        + rng_c.normal(0, 1.0, (2, 2)),
    ]).astype(np.float32)
    zp = np.zeros((16, 2), np.float32)
    zp[:len(z)] = z
    m = np.zeros(16, bool)
    m[:len(z)] = True
    scans_c.append((zp, m, np.float32(t)))

# single-process reference (local devices only)
st1 = _seed_state()
ist1 = initiator_mod.empty_initiator(shapes_c)
ref_labels, ref_objs = [], []
for zp, m, t in scans_c:
    sc = _Scan(z=jnp.asarray(zp), mask=jnp.asarray(m), time=jnp.asarray(t))
    st1, ist1, out1 = scan_step(st1, ist1, sc, empty_ais(shapes_c),
                                shapes_c, params_c, method='lagrangian',
                                use_ais=False)
    ref_labels.append(np.asarray(out1.sel_hist_meas)[:4, -1].tolist())
    ref_objs.append(float(out1.sel_obj))

# global 4-device cluster mesh: device order is process-major, so the
# axis spans BOTH processes — every psum/pmin in distributed_select
# crosses the process boundary.
mesh_c = Mesh(np.array(jax.devices()), ('cluster',))
proc_span = {d.process_index for d in jax.devices()}
assert len(proc_span) == nproc, proc_span
step_c = make_sharded_tracker_step(mesh_c, shapes_c, params_c)


def _put(tree, spec_fn):
    from jax.sharding import NamedSharding
    return jax.tree_util.tree_map(
        lambda x: jax.device_put(
            x, NamedSharding(mesh_c, spec_fn(x))), tree)


T_g = shapes_c.max_targets
state_spec = lambda x: (P("cluster") if (hasattr(x, 'ndim') and x.ndim >= 1
                                         and x.shape[0] == T_g) else P())
st2 = _put(_seed_state(), state_spec)
ist2 = _put(initiator_mod.empty_initiator(shapes_c), lambda x: P())
got_labels, got_objs = [], []
for zp, m, t in scans_c:
    sc = _Scan(z=jnp.asarray(zp), mask=jnp.asarray(m), time=jnp.asarray(t))
    sc = _put(sc, lambda x: P())
    ais0 = _put(empty_ais(shapes_c), lambda x: P())
    st2, ist2, out2 = step_c(st2, ist2, sc, ais0)
    # outputs are GLOBAL arrays spanning both processes: gather them
    from jax.experimental import multihost_utils
    labels_g = np.asarray(
        multihost_utils.process_allgather(out2['sel_hist_meas'],
                                          tiled=True))
    got_labels.append(labels_g[:4, -1].tolist())
    got_objs.append(float(np.asarray(
        multihost_utils.process_allgather(out2['sel_obj'],
                                          tiled=True))))

for k, (rl, gl, ro, go) in enumerate(
        zip(ref_labels, got_labels, ref_objs, got_objs)):
    assert abs(go - ro) <= 1e-3 * (1 + abs(ro)), \
        f"scan {k}: sharded obj {go} vs local {ro}"
    assert gl == rl, f"scan {k}: sharded labels {gl} vs local {rl}"

print(f"OK pid={pid} scalar={g_scalar:.4f} xproc_obj={got_objs[-1]:.4f}",
      flush=True)
