#!/usr/bin/env python
"""Chip-saturation curve (round-3 verdict item 3): ms/scan vs target
count at FIXED per-target load on one chip.

Scales the scene area with T (radar_range ~ sqrt(T)) so measurement
density per target stays constant (~1.8 meas/target incl. clutter), and
sizes the static shapes proportionally (M = 2T).  For each T it times

  grow        — candidate planes + beam (the [T,L,M] tensors)
  grow+select — + tiered/Lagrangian global selection
  full        — the production scan_many pipeline

so the knee and the dominating op past it are attributable from the
deltas.  Prints one JSON line per point plus a summary line naming the
bottleneck phase at the largest T.

Run:  python bench_saturation.py          (fails without a GPU)
Knobs: SAT_POINTS="256,512,1024,2048" SAT_SCANS=4 SAT_REPS=3
       SAT_BEAM=16     hypothesis beam L (8 = the degraded half-beam
                       step — the compute-shedding variant the host
                       roof trigger switches to, round-5)
       SAT_PREGATE=0   radar_cand_width Km (per-target nearest-Km
                       measurement pre-gate; 0 = off)
Each row also reports one-to-one truth coverage + rms (Hungarian, 20 m
gate) so degraded-mode quality cost is quantified, not asserted.
"""
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

POINTS = [int(x) for x in os.environ.get(
    "SAT_POINTS", "256,512,1024,2048,4096").split(",")]
N_SCANS = int(os.environ.get("SAT_SCANS", "4"))
REPS = int(os.environ.get("SAT_REPS", "3"))
BEAM = int(os.environ.get("SAT_BEAM", "16"))
PREGATE = int(os.environ.get("SAT_PREGATE", "0"))


def run_point(T_cap):
    import jax
    import jax.numpy as jnp
    from pymht_tpu.core.config import TrackerShapes, TrackerParams
    from pymht_tpu.core.tracker import Tracker, scan_many
    from pymht_tpu.core.grow import grow
    from pymht_tpu.core.select import select
    from pymht_tpu.utils import simulator as sim

    period = 2.5
    # area ~ T keeps clutter + target density per unit area constant
    radar_range = 12000.0 * float(np.sqrt(T_cap / 1024.0))
    shapes = TrackerShapes(
        max_targets=T_cap, max_leaves=BEAM, max_meas=2 * T_cap,
        max_ais=16, window=6, max_prelim=64, max_initiators=512,
        ais_per_leaf=2,
        radar_cand_width=min(PREGATE, 2 * T_cap) if PREGATE else 0)
    params = TrackerParams(radar_period=period, P_d=0.9,
                           lambda_phi=1.5e-6, lambda_nu=1e-6, N=4,
                           radar_range=radar_range)
    n_tgt = T_cap - 16
    rng = np.random.default_rng(7)
    targets = sim.generate_initial_targets(
        rng, n_tgt, (0.0, 0.0), radar_range * 0.85, 0.9, 0.1)
    sim_list = sim.simulate_targets(rng, targets,
                                    sim_time=N_SCANS * period, dt=period)
    scans = sim.simulate_scans(rng, sim_list, period, sigma_R=2.5,
                               lambda_phi=1.5e-6, radar_range=radar_range,
                               p0=(0.0, 0.0), lambda_local=0.2)
    F_inv = np.eye(4)
    F_inv[0, 2] = F_inv[1, 3] = -period
    tracker = Tracker(shapes, params, method='lagrangian', use_ais=False)
    tracker.pre_initialize(scans[0].time - period,
                           [F_inv @ t.state for t in targets])
    scan_b, ais_b = tracker.make_stream_inputs(scans[:N_SCANS])
    n_meas = float(np.mean([len(s.measurements) for s in scans[:N_SCANS]]))

    def timeit(fn, *args):
        out = fn(*args)
        jax.block_until_ready(out)
        reps = []
        for _ in range(REPS):
            t0 = time.time()
            out = fn(*args)
            jax.block_until_ready(out)
            reps.append(time.time() - t0)
        return float(np.median(reps) / N_SCANS * 1000.0)

    def grow_only(s, sc, a):
        def body(st_, inp):
            scan_t, _ = inp
            g = grow(st_, scan_t, None, shapes, params)
            return g.state, g.used_meas.sum()
        return jax.lax.scan(body, s, (sc, a))

    def grow_sel(s, sc, a):
        def body(st_, inp):
            scan_t, _ = inp
            g = grow(st_, scan_t, None, shapes, params)
            st2 = g.state
            res = select(st2, shapes, params, method='lagrangian',
                         compute_clusters=False)
            st2 = st2.replace(sel_leaf=res.sel, lam=res.lam)
            return st2, res.obj
        return jax.lax.scan(body, s, (sc, a))

    st, ist = tracker.state, tracker.init_state
    ms_grow = timeit(jax.jit(grow_only), st, scan_b, ais_b)
    ms_gsel = timeit(jax.jit(grow_sel), st, scan_b, ais_b)
    run_full = jax.jit(lambda s, i, sc, a: scan_many(
        s, i, sc, a, shapes, params, method='lagrangian', use_ais=False))
    ms_full = timeit(run_full, st, ist, scan_b, ais_b)

    # quality: one-to-one Hungarian matching per scan (20 m gate), like
    # bench_swarm — quantifies what a degraded/pre-gated mode costs
    from scipy.optimize import linear_sum_assignment
    _, _, outs = jax.block_until_ready(run_full(st, ist, scan_b, ais_b))
    track_x = np.asarray(outs.track_x)
    track_ok = np.asarray(outs.track_mask)
    truth = np.array([[t.cartesian_state() for t in sample]
                      for sample in sim_list[:N_SCANS]])
    matched, sq, GATE = 0, [], 20.0
    for i in range(min(N_SCANS, truth.shape[0])):
        tp = track_x[i][track_ok[i]][:, :2]
        if not len(tp):
            continue
        d = np.linalg.norm(truth[i][:, None, :2] - tp[None, :, :], axis=2)
        ri, ci = linear_sum_assignment(np.minimum(d, GATE))
        dm = d[ri, ci]
        hit = dm < GATE
        matched += int(hit.sum())
        sq.extend((dm[hit] ** 2).tolist())
    coverage = matched / float(truth.shape[0] * truth.shape[1])
    rms = float(np.sqrt(np.mean(sq))) if sq else float('nan')

    return dict(targets=T_cap, meas_per_scan=round(n_meas, 1),
                beam=BEAM, pregate=PREGATE,
                grow_ms=round(ms_grow, 3),
                select_ms=round(ms_gsel - ms_grow, 3),
                rest_ms=round(ms_full - ms_gsel, 3),
                full_ms=round(ms_full, 3),
                us_per_target=round(1000.0 * ms_full / T_cap, 2),
                coverage=round(coverage, 4), rms_m=round(rms, 2))


def main():
    from pymht_tpu.utils.runtime import enable_compile_cache, require_gpu
    enable_compile_cache()
    require_gpu()
    rows = []
    for T_cap in POINTS:
        try:
            r = run_point(T_cap)
        except Exception as e:  # noqa: BLE001
            r = dict(targets=T_cap, error=str(e)[:200])
        rows.append(r)
        print(json.dumps({"metric": "saturation_point", **r}), flush=True)
    ok = [r for r in rows if "error" not in r]
    if len(ok) >= 2:
        # knee: largest T where us/target stays within 1.5x of the best
        best = min(r["us_per_target"] for r in ok)
        knee = max(r["targets"] for r in ok
                   if r["us_per_target"] <= 1.5 * best)
        last = ok[-1]
        phases = {"grow": last["grow_ms"], "select": last["select_ms"],
                  "lifecycle+init": last["rest_ms"]}
        print(json.dumps({
            "metric": "chip_saturation_curve",
            "points": rows, "knee_targets": knee,
            "bottleneck_at_max": max(phases, key=phases.get),
            "device_kind": jax.devices()[0].device_kind,
            "device_count": len(jax.devices()),
        }), flush=True)


if __name__ == "__main__":
    main()
