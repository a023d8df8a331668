"""Multi-host runtime: ``jax.distributed`` init + process-major meshes.

SURVEY §2.3: the reference is a single-process library, so its latent
scaling story stops at one machine.  Here the multi-host runtime is
explicit:

* ``initialize``   — process bootstrap (coordinator handshake).  Pass
  (or set in the environment) the coordinator address, process count
  and process id; under SLURM JAX detects them itself.
* ``hybrid_mesh``  — device mesh whose 'scenario' axis spans processes
  (independent Monte-Carlo scenarios need no cross-talk, so they ride
  the links between hosts) and whose 'cluster' axis spans each
  process's local devices (the selection collectives psum/pmin every
  iteration, so they stay on the links inside one host).
* ``gather_local_measurements`` — the measurement exchange: every host
  ingests its local radar feed, and all cluster shards must gate
  against the union.  A fixed-width all-gather of the per-host padded
  buffers (the static-shape equivalent of a ragged all-to-all).

Tested by ``tests/test_multihost.py``, which launches two real
processes over a localhost coordinator (Gloo CPU collectives) and
asserts a cross-process collective, the measurement exchange, and a
sharded tracker step all agree with the single-process result.
"""
from __future__ import annotations

import os
from typing import Optional, Tuple

import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import Mesh


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None,
               local_device_ids=None) -> bool:
    """Bootstrap ``jax.distributed`` for a multi-host run.

    Arguments fall back to ``PYMHT_COORDINATOR`` / ``PYMHT_NUM_PROCS`` /
    ``PYMHT_PROC_ID`` env vars, then to JAX's own cluster
    auto-detection under SLURM.  Returns True if a multi-process
    runtime was initialised, False for the single-process no-op (so
    callers can share one code path).
    """
    coordinator_address = coordinator_address or os.environ.get(
        "PYMHT_COORDINATOR")
    if num_processes is None and "PYMHT_NUM_PROCS" in os.environ:
        num_processes = int(os.environ["PYMHT_NUM_PROCS"])
    if process_id is None and "PYMHT_PROC_ID" in os.environ:
        process_id = int(os.environ["PYMHT_PROC_ID"])
    if num_processes is not None and num_processes <= 1:
        return False
    if coordinator_address is None and num_processes is None:
        # SLURM auto-detection: initialize() with no args only inside a
        # SLURM job.
        if "SLURM_JOB_ID" not in os.environ:
            return False
        jax.distributed.initialize()
        return jax.process_count() > 1
    jax.distributed.initialize(coordinator_address=coordinator_address,
                               num_processes=num_processes,
                               process_id=process_id,
                               local_device_ids=local_device_ids)
    return True


def hybrid_mesh(scenario: Optional[int] = None,
                cluster: Optional[int] = None) -> Mesh:
    """('scenario', 'cluster') mesh with scenario over processes and
    cluster over each process's local devices.

    Defaults: scenario = process count, cluster = local device count.
    Single-process: a flat mesh over the local devices (scenario=1
    unless given).
    """
    n_proc = jax.process_count()
    n_local = jax.local_device_count()
    scenario = n_proc if scenario is None else scenario
    cluster = (n_proc * n_local) // scenario if cluster is None else cluster
    # Process-major ordering: each process's local devices land
    # contiguously along the cluster axis, so with scenario=n_proc the
    # selection collectives never cross processes.  The cards of one
    # host are joined all to all, so no finer topology matters.
    ordered = sorted(jax.devices(), key=lambda d: (d.process_index, d.id))
    devs = np.array(ordered[:scenario * cluster]).reshape(scenario, cluster)
    return Mesh(devs, ("scenario", "cluster"))


def gather_local_measurements(z_local: np.ndarray,
                              mask_local: np.ndarray,
                              max_meas: int
                              ) -> Tuple[np.ndarray, np.ndarray]:
    """All-gather each host's padded radar returns into the global scan.

    ``z_local [M_l, 2]`` / ``mask_local [M_l]`` are this host's local
    (padded) measurements; the result is the same ``[max_meas, 2]`` /
    ``[max_meas]`` on every host, valid entries packed first.  With one
    process this is just pad/truncate.  Overflow beyond ``max_meas`` is
    dropped deterministically (lowest process rank first) — mirroring
    the single-host padding contract of Tracker._pad_scan.
    """
    z_local = np.asarray(z_local, np.float32).reshape(-1, 2)
    mask_local = np.asarray(mask_local, bool).reshape(-1)
    if jax.process_count() > 1:
        from jax.experimental import multihost_utils
        z_all = np.asarray(multihost_utils.process_allgather(
            jnp.asarray(z_local)))                       # [P, M_l, 2]
        m_all = np.asarray(multihost_utils.process_allgather(
            jnp.asarray(mask_local)))                    # [P, M_l]
        z_local = z_all.reshape(-1, 2)
        mask_local = m_all.reshape(-1)
    # pack valid entries first, then pad/truncate to the static width
    z_valid = z_local[mask_local]
    n = min(len(z_valid), max_meas)
    z = np.zeros((max_meas, 2), np.float32)
    z[:n] = z_valid[:n]
    mask = np.zeros((max_meas,), bool)
    mask[:n] = True
    return z, mask


def replicate_to_global(tree, mesh: Mesh):
    """Host-identical pytree -> globally-replicated jax.Arrays on the
    (possibly multi-host) mesh.  Every process must pass the same
    values (the usual pattern: same seed, same config)."""
    from jax.sharding import NamedSharding, PartitionSpec as P
    sh = NamedSharding(mesh, P())
    return jax.tree_util.tree_map(lambda x: jax.device_put(x, sh), tree)
