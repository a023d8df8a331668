"""Multi-chip parallelism: scenario batches × target (cluster) sharding.

The reference is single-threaded (SURVEY §2.3); the latent parallel
structure becomes explicit mesh axes here:

* ``scenario`` — independent Monte-Carlo scenarios (data-parallel-like):
  a vmapped tracker step with the batch axis sharded over the mesh; no
  collectives cross this axis.
* ``cluster``  — the target axis within one scenario (model-parallel-
  like): targets shard across chips; GSPMD inserts the collectives the
  selection needs (all-reduce of Lagrangian usage counts / duals,
  all-gather for the cluster-adjacency matmul).

Everything is expressed as sharding annotations on one jitted step —
the XLA-collective (scaling-book) recipe rather than hand-written
NCCL-style communication.
"""
from __future__ import annotations

import functools

import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..core.config import TrackerShapes, TrackerParams
from ..core.state import TrackerState, empty_state, \
    insert_targets as insert_targets_
from ..core import initiator as initiator_mod
from ..core.grow import Scan, AisBatch, empty_ais
from ..core.tracker import scan_step


def make_batched_step(shapes: TrackerShapes, params: TrackerParams,
                      method: str = 'lagrangian', use_ais: bool = False):
    """vmapped scan_step over a leading scenario axis."""
    def one(state, istate, scan, ais):
        return scan_step(state, istate, scan, ais, shapes, params,
                         method=method, use_ais=use_ais)
    return jax.vmap(one)


def batch_states(shapes: TrackerShapes, params: TrackerParams, n: int):
    state = empty_state(shapes, params)
    istate = initiator_mod.empty_initiator(shapes)
    tile = lambda x: jnp.broadcast_to(x, (n,) + x.shape)
    return (jax.tree_util.tree_map(tile, state),
            jax.tree_util.tree_map(tile, istate))


def make_sharded_step(mesh: Mesh, shapes: TrackerShapes,
                      params: TrackerParams, method: str = 'lagrangian',
                      use_ais: bool = False):
    """jit the batched step with scenario+cluster shardings on the mesh.

    TrackerState arrays are [B, T, ...]: B shards over 'scenario', the
    target axis T over 'cluster'.  Scan/AIS inputs shard over 'scenario'
    only (measurements are broadcast to every cluster shard — they gate
    against all targets).
    """
    step = make_batched_step(shapes, params, method=method, use_ais=use_ais)

    def state_spec(x):
        if x.ndim >= 2:
            return P('scenario', 'cluster')
        if x.ndim == 1:
            return P('scenario')
        return P()

    def scalar_or_scenario(x):
        return P('scenario') if x.ndim >= 1 else P()

    def shard(tree, spec_fn):
        return jax.tree_util.tree_map(
            lambda x: NamedSharding(mesh, spec_fn(x)), tree)

    def in_shardings(state_b, istate_b, scan_b, ais_b):
        return (shard(state_b, state_spec),
                shard(istate_b, scalar_or_scenario),
                shard(scan_b, scalar_or_scenario),
                shard(ais_b, scalar_or_scenario))

    @functools.partial(jax.jit)
    def sharded_step(state_b, istate_b, scan_b, ais_b):
        return step(state_b, istate_b, scan_b, ais_b)

    return sharded_step, in_shardings


def dryrun_swarm_cluster(n_devices: int):
    """Compile + execute ONE full tracker scan with the target axis
    sharded over ALL n devices at swarm-like shapes (T=1024 slots, 600
    live targets, AIS fusion on) — the configuration the swarm headline
    uses, so the driver's multi-chip check exercises the real program
    (round-3 verdict item 2b).  M/A are scaled to 512/32 to keep the
    CPU compile budget sane; the sharded axis and the psum'd dual
    vector are production-shaped."""
    from .sharded_tracker import make_sharded_tracker_step
    from ..models import pv

    devices = np.array(jax.devices()[:n_devices])
    mesh = Mesh(devices, ('cluster',))
    shapes = TrackerShapes(max_targets=1024, max_leaves=8, max_meas=512,
                           max_ais=32, window=5, max_prelim=32,
                           max_initiators=64, ais_per_leaf=2)
    params = TrackerParams(radar_period=2.5, P_d=0.9, lambda_phi=1.5e-6,
                           lambda_nu=1e-6, N=3, radar_range=12000.0)
    rng = np.random.default_rng(0)
    n_tgt = 600
    state = empty_state(shapes, params)
    xs = np.zeros((shapes.max_targets, 4), np.float32)
    xs[:n_tgt, :2] = rng.uniform(-6000, 6000, (n_tgt, 2))
    xs[:n_tgt, 2:] = rng.normal(0, 5, (n_tgt, 2))
    mask = np.arange(shapes.max_targets) < n_tgt
    mmsi = np.where(mask, 111000000 + np.arange(shapes.max_targets), 0)
    state = insert_targets_(state, jnp.asarray(xs),
                            jnp.broadcast_to(pv.P0,
                                             (shapes.max_targets, 4, 4)),
                            jnp.asarray(mask),
                            jnp.asarray(mmsi, jnp.int32),
                            jnp.asarray(0.0), params)
    istate = initiator_mod.empty_initiator(shapes)
    n_z = min(n_tgt, shapes.max_meas)
    z = np.zeros((shapes.max_meas, 2), np.float32)
    z[:n_z] = xs[:n_z, :2] + xs[:n_z, 2:] * 2.5 \
        + rng.normal(0, 2.5, (n_z, 2))
    scan = Scan(z=jnp.asarray(z),
                mask=jnp.asarray(np.arange(shapes.max_meas) < n_z),
                time=jnp.asarray(2.5, jnp.float32))
    a_state = np.zeros((shapes.max_ais, 4), np.float32)
    a_state[:16] = xs[:16] + 1.0
    ais = AisBatch(state=jnp.asarray(a_state),
                   time=jnp.full((shapes.max_ais,), 1.5, jnp.float32),
                   mmsi=jnp.asarray(mmsi[:shapes.max_ais], jnp.int32),
                   high_accuracy=jnp.zeros((shapes.max_ais,), bool),
                   mask=jnp.asarray(np.arange(shapes.max_ais) < 16))
    step = make_sharded_tracker_step(mesh, shapes, params, use_ais=True)
    out = step(state, istate, scan, ais)
    jax.block_until_ready(out)
    return out


def dryrun(n_devices: int, scenario: int = None, cluster: int = None):
    """Compile + execute ONE sharded step on an n-device mesh with tiny
    shapes.  Used by the driver's multi-chip validation."""
    devices = np.array(jax.devices()[:n_devices])
    if scenario is None:
        cluster = min(2, n_devices)
        scenario = n_devices // cluster
    mesh = Mesh(devices.reshape(scenario, cluster), ('scenario', 'cluster'))

    shapes = TrackerShapes(max_targets=8, max_leaves=8, max_meas=8,
                           max_ais=2, window=4, max_prelim=8,
                           max_initiators=8)
    params = TrackerParams(radar_period=1.0, N=2)
    B = scenario  # one scenario per scenario-shard at minimum

    state_b, istate_b = batch_states(shapes, params, B)
    rng = np.random.default_rng(0)
    z = jnp.asarray(rng.normal(0, 50, (B, shapes.max_meas, 2))
                    .astype(np.float32))
    scan_b = Scan(z=z, mask=jnp.ones((B, shapes.max_meas), bool),
                  time=jnp.full((B,), 1.0, jnp.float32))
    ais_b = jax.tree_util.tree_map(
        lambda x: jnp.broadcast_to(x, (B,) + x.shape), empty_ais(shapes))

    step, in_shardings_fn = make_sharded_step(mesh, shapes, params)
    shardings = in_shardings_fn(state_b, istate_b, scan_b, ais_b)
    args = jax.tree_util.tree_map(jax.device_put,
                                  (state_b, istate_b, scan_b, ais_b),
                                  shardings)
    out = step(*args)
    jax.block_until_ready(out)
    return out
