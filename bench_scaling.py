#!/usr/bin/env python
"""Scenario-parallel scaling-efficiency harness.

Measures scans/s of the vmapped+sharded tracker step for growing device
counts on the available mesh (virtual CPU devices by default, so the
rates are CPU rates; SCALING_CPU=0 runs on the real devices).

Prints one JSON line per mesh size plus a summary efficiency line.
"""
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

if os.environ.get("SCALING_CPU", "1") == "1":
    os.environ["JAX_PLATFORMS"] = "cpu"
    flags = os.environ.get("XLA_FLAGS", "")
    if "host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402

if os.environ.get("SCALING_CPU", "1") == "1":
    jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp  # noqa: E402
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P  # noqa: E402


def main():
    from pymht_tpu.utils.runtime import enable_compile_cache
    enable_compile_cache()
    from pymht_tpu.core.config import TrackerShapes, TrackerParams
    from pymht_tpu.parallel import montecarlo as mc
    from pymht_tpu.parallel.scenario import batch_states, make_batched_step
    from pymht_tpu.core.grow import Scan, empty_ais
    from pymht_tpu.core.state import insert_targets
    from pymht_tpu.models import pv

    shapes = TrackerShapes(max_targets=16, max_leaves=16, max_meas=32,
                           max_ais=2, window=6, max_prelim=16,
                           max_initiators=32)
    params = TrackerParams(radar_period=2.5, P_d=0.9, lambda_phi=2e-6,
                           lambda_nu=1e-5, N=4, radar_range=500.0)
    devices = jax.devices()
    n_dev = len(devices)
    per_dev = int(os.environ.get("SCALING_BATCH_PER_DEV", "4"))
    n_scans = 8
    n_targets = 8

    key = jax.random.PRNGKey(0)
    results = []
    base_rate = None
    for nd in [d for d in (1, 2, 4, 8) if d <= n_dev]:
        B = per_dev * nd
        sc = mc.generate(key, batch=B, n_targets=n_targets,
                         n_scans=n_scans, shapes=shapes, params=params,
                         radar_range=500.0)
        mesh = Mesh(np.array(devices[:nd]), ('scenario',))
        step = make_batched_step(shapes, params, method='lagrangian',
                                 use_ais=False)
        state_b, istate_b = batch_states(shapes, params, B)

        def pre(state, x0):
            T = shapes.max_targets
            xs = jnp.zeros((T, 4), jnp.float32).at[:n_targets].set(
                x0[:n_targets])
            return insert_targets(
                state, xs, jnp.broadcast_to(pv.P0, (T, 4, 4)),
                jnp.arange(T) < n_targets, jnp.zeros((T,), jnp.int32),
                jnp.asarray(0.0), params)
        state_b = jax.vmap(pre)(state_b, sc.truth[:, 0])
        ais_b = jax.tree_util.tree_map(
            lambda x: jnp.broadcast_to(x, (B,) + x.shape),
            empty_ais(shapes))

        sharding = NamedSharding(mesh, P('scenario'))
        put = lambda tree: jax.tree_util.tree_map(
            lambda x: jax.device_put(x, NamedSharding(
                mesh, P('scenario') if x.ndim >= 1 and x.shape[0] == B
                else P())), tree)
        state_b, istate_b, ais_b = put(state_b), put(istate_b), put(ais_b)

        @jax.jit
        def run(state_b, istate_b):
            def body(carry, s):
                st, ist = carry
                scan_b = Scan(z=sc.z[:, s], mask=sc.z_mask[:, s],
                              time=jnp.full((B,), sc.times[s]))
                st, ist, out = step(st, ist, scan_b, ais_b)
                return (st, ist), out.n_leaves
            (st, ist), _ = jax.lax.scan(body, (state_b, istate_b),
                                        jnp.arange(n_scans))
            return st

        out = run(state_b, istate_b)
        jax.block_until_ready(out)
        reps = []
        for _ in range(3):
            t0 = time.time()
            out = run(state_b, istate_b)
            jax.block_until_ready(out)
            reps.append(time.time() - t0)
        dt = float(np.median(reps))
        rate = B * n_scans / dt            # scenario-scans per second
        if base_rate is None:
            base_rate = rate
        eff = rate / (base_rate * nd)
        results.append((nd, rate, eff))
        print(json.dumps({"metric": "scenario_scans_per_s",
                          "devices": nd, "batch": B,
                          "value": round(rate, 1),
                          "efficiency": round(eff, 3)}))
    if len(results) > 1:
        print(json.dumps({"metric": "scaling_efficiency",
                          "value": round(results[-1][2], 3),
                          "devices": results[-1][0],
                          "unit": "fraction"}))


if __name__ == "__main__":
    main()
