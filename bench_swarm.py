#!/usr/bin/env python
"""Swarm-scale benchmark: 1000 targets with AIS priors on ONE chip.

BASELINE.json config 5 calls for a "1000-target swarm with AIS-style
priors".  This runs the full per-scan pipeline (grow + two-stage AIS
fusion + tiered selection + lifecycle + initiation) at swarm shapes,
device-resident streaming, and prints one JSON line:

  {"metric": "ms_per_scan_1000tgt_ais_swarm", ...}

The cross-device partition of the same step is exercised by
``chip_smoke.py --four`` and tests/test_sharded_swarm.py.  Fails without
a GPU.
"""
import dataclasses  # noqa: F401
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

N_TARGETS = int(os.environ.get("SWARM_TARGETS", "1000"))
N_SCANS = int(os.environ.get("SWARM_SCANS", "8"))
M_CAP = int(os.environ.get("SWARM_MEAS", "2048"))
A_CAP = int(os.environ.get("SWARM_AIS", "128"))
USE_AIS = os.environ.get("SWARM_USE_AIS", "1") == "1"
DYN_WIN = os.environ.get("SWARM_DYNWIN", "0") == "1"


def main():
    from pymht_tpu.utils.runtime import enable_compile_cache, require_gpu
    enable_compile_cache()
    devices = require_gpu()
    import jax
    import jax.numpy as jnp
    from pymht_tpu.core.config import TrackerShapes, TrackerParams
    from pymht_tpu.core.tracker import Tracker, scan_many
    from pymht_tpu.core.grow import Scan, AisBatch
    from pymht_tpu.utils import simulator as sim

    period = 2.5
    radar_range = 12000.0
    shapes = TrackerShapes(
        max_targets=1024, max_leaves=16, max_meas=M_CAP, max_ais=A_CAP,
        window=6, max_prelim=64, max_initiators=512, ais_per_leaf=2,
        ais_prefilter_width=int(os.environ.get("SWARM_PREFILTER", "0")),
        # per-target nearest-64 spatial pre-gate: decisions identical
        # to the full-M path at this scene (coverage, rms and oracle
        # gap are checked by chip_smoke.py)
        radar_cand_width=int(os.environ.get("SWARM_PREGATE", "64")))
    params = TrackerParams(radar_period=period, P_d=0.9,
                           lambda_phi=1.5e-6, lambda_nu=1e-6, N=4,
                           radar_range=radar_range)

    n_tgt = min(N_TARGETS, shapes.max_targets - 16)
    rng = np.random.default_rng(77)
    targets = sim.generate_initial_targets(
        rng, n_tgt, (0.0, 0.0), radar_range * 0.85, 0.9, 0.1,
        assign_mmsi=True, P_r=0.5)
    sim_list = sim.simulate_targets(rng, targets,
                                    sim_time=N_SCANS * period, dt=period)
    scans = sim.simulate_scans(rng, sim_list, period, sigma_R=2.5,
                               lambda_phi=1.5e-6, radar_range=radar_range,
                               p0=(0.0, 0.0), lambda_local=0.2)
    ais_groups = sim.simulate_ais(rng, sim_list, period,
                                  init_time=sim_list[0][0].time)

    M = shapes.max_meas
    F_inv = np.eye(4)
    F_inv[0, 2] = F_inv[1, 3] = -period
    tracker = Tracker(shapes, params, method='lagrangian',
                      use_ais=USE_AIS)
    tracker.pre_initialize(scans[0].time - period,
                           [F_inv @ t.state for t in targets],
                           mmsi=[t.mmsi for t in targets])
    # device times are relative to the tracker's internal origin
    t0_base = tracker.t0
    zb = np.zeros((N_SCANS, M, 2), np.float32)
    mb = np.zeros((N_SCANS, M), bool)
    tb = np.zeros((N_SCANS,), np.float32)
    ais_st = np.zeros((N_SCANS, A_CAP, 4), np.float32)
    ais_tm = np.zeros((N_SCANS, A_CAP), np.float32)
    ais_mm = np.zeros((N_SCANS, A_CAP), np.int32)
    ais_hi = np.zeros((N_SCANS, A_CAP), bool)
    ais_mk = np.zeros((N_SCANS, A_CAP), bool)
    n_meas, n_msgs = [], []
    for i, s in enumerate(scans[:N_SCANS]):
        n = min(len(s.measurements), M)
        n_meas.append(len(s.measurements))
        zb[i, :n] = s.measurements[:n]
        mb[i, :n] = True
        tb[i] = s.time - t0_base
        group = ais_groups[i] if i < len(ais_groups) else []
        n_msgs.append(len(group))
        for j, msg in enumerate(group[:A_CAP]):
            ais_st[i, j] = msg.state
            ais_tm[i, j] = msg.time - t0_base
            ais_mm[i, j] = msg.mmsi
            ais_hi[i, j] = msg.highAccuracy
            ais_mk[i, j] = True
    scans_dev = Scan(z=jnp.asarray(zb), mask=jnp.asarray(mb),
                     time=jnp.asarray(tb))
    ais_dev = AisBatch(state=jnp.asarray(ais_st), time=jnp.asarray(ais_tm),
                       mmsi=jnp.asarray(ais_mm),
                       high_accuracy=jnp.asarray(ais_hi),
                       mask=jnp.asarray(ais_mk))

    run = jax.jit(lambda st, ist, sc, a: scan_many(
        st, ist, sc, a, shapes, params, method='lagrangian',
        use_ais=USE_AIS, dynamic_window=DYN_WIN))
    out = run(tracker.state, tracker.init_state, scans_dev, ais_dev)
    jax.block_until_ready(out)
    reps = []
    for _ in range(3):
        t0 = time.time()
        out = run(tracker.state, tracker.init_state, scans_dev, ais_dev)
        jax.block_until_ready(out)
        reps.append(time.time() - t0)
    ms = float(np.median(reps) / N_SCANS * 1000.0)
    _, _, outs = out
    gaps = np.asarray(outs.sel_obj) - np.asarray(outs.sel_bound)
    rel = np.median(gaps / np.maximum(1.0, np.abs(np.asarray(outs.sel_bound))))
    n_alive = int(np.asarray(outs.track_mask)[-1].sum())
    final_state = out[0]
    tw = np.asarray(final_state.tgt_window)[np.asarray(final_state.tgt_mask)]
    win_stats = ({"mean": round(float(tw.mean()), 2),
                  "min": int(tw.min()), "max": int(tw.max()),
                  "shrunk_frac": round(float((tw < params.N).mean()), 3)}
                 if DYN_WIN and tw.size else None)

    # Streaming quality vs ground truth: per scan, ONE-TO-ONE match
    # truth targets to selected-track estimates (20 m gate) via the
    # Hungarian assignment — nearest-track matching lets a single track
    # "cover" several nearby truths in a dense swarm, inflating
    # coverage (advisor round-3 finding).
    from pymht_tpu.utils.metrics import scan_coverage, truth_positions
    coverage, rms = scan_coverage(outs.track_x, outs.track_mask,
                                  truth_positions(sim_list[:N_SCANS]))

    # Swarm-scale optimality cross-check (round-3 verdict item 4): the
    # dual gap above is the solver grading itself.  Capture ONE
    # swarm-shape forest state post-grow / pre-select (after streaming
    # the first N-1 scans, growing the last), solve it exactly with the
    # host HiGHS oracle, and report the device selection's true gap.
    oracle_gap = None
    oracle_optimal = None
    if os.environ.get("SWARM_ORACLE", "1") == "1":
        from pymht_tpu.core.grow import grow as grow_fn
        from pymht_tpu.core.select import select as select_fn
        from pymht_tpu.utils.oracle import milp_select_oracle
        part = lambda tree, lo, hi: jax.tree_util.tree_map(  # noqa: E731
            lambda x: x[lo:hi], tree)
        per = lambda tree, i: jax.tree_util.tree_map(        # noqa: E731
            lambda x: x[i], tree)
        stp, istp, _ = jax.jit(lambda st, ist, sc, a: scan_many(
            st, ist, sc, a, shapes, params, method='lagrangian',
            use_ais=USE_AIS))(tracker.state, tracker.init_state,
                              part(scans_dev, 0, N_SCANS - 1),
                              part(ais_dev, 0, N_SCANS - 1))
        g = jax.jit(lambda st, sc, a: grow_fn(
            st, sc, a if USE_AIS else None, shapes, params))(
            stp, per(scans_dev, N_SCANS - 1), per(ais_dev, N_SCANS - 1))
        res = jax.jit(lambda st: select_fn(
            st, shapes, params, method='lagrangian',
            compute_clusters=False))(g.state)
        obj_dev = float(res.obj)
        limit = float(os.environ.get("SWARM_ORACLE_LIMIT", "900"))
        _, obj_o, oracle_optimal = milp_select_oracle(
            g.state, shapes, params, time_limit=limit)
        if np.isfinite(obj_o):
            oracle_gap = (obj_dev - obj_o) / max(1.0, abs(obj_o))

    # Batched smoothing at swarm scale: all tracks RTS-smoothed in ONE
    # device dispatch.
    from pymht_tpu.ops.smoother import smooth_tracks
    from pymht_tpu.models import pv as pv_model
    Nsm = max(N_SCANS, 2)
    x0b = np.array([t.state for t in targets], np.float32)
    zsb = np.stack([[s[k].cartesian_state()[:2]
                     for s in sim_list[:Nsm]]
                    for k in range(n_tgt)]).astype(np.float32)
    mkb = rng.random((n_tgt, Nsm)) < 0.9
    P0b = jnp.broadcast_to(pv_model.P0, (n_tgt, 4, 4))
    sm_fn = jax.jit(lambda a, b, c, d: smooth_tracks(a, b, c, d, period))
    out_sm = jax.block_until_ready(sm_fn(jnp.asarray(x0b), P0b,
                                         jnp.asarray(zsb),
                                         jnp.asarray(mkb)))
    t0 = time.time()
    out_sm = jax.block_until_ready(sm_fn(jnp.asarray(x0b), P0b,
                                         jnp.asarray(zsb),
                                         jnp.asarray(mkb)))
    smooth_ms = round((time.time() - t0) * 1000.0, 2)

    print(json.dumps({
        "metric": "ms_per_scan_1000tgt_ais_swarm",
        "value": round(ms, 3),
        "unit": "ms",
        "vs_real_time": round(period * 1000.0 / ms, 1),
        "n_targets": n_tgt,
        "tracks_alive_last_scan": n_alive,
        "mean_meas_per_scan": round(float(np.mean(n_meas)), 1),
        "mean_ais_per_scan": round(float(np.mean(n_msgs)), 1),
        "median_dual_gap": round(float(rel), 6),
        "opt_gap_vs_exact_oracle": (round(oracle_gap, 6)
                                    if oracle_gap is not None else None),
        "oracle_proven_optimal": oracle_optimal,
        "truth_coverage": round(coverage, 4),
        "rms_matched_m": round(rms, 3),
        "dynamic_window": win_stats,
        "smooth_1000tracks_one_dispatch_ms": smooth_ms,
        "device_kind": devices[0].device_kind,
        "device_count": len(devices),
    }))


if __name__ == "__main__":
    main()
