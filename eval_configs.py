#!/usr/bin/env python
"""Tracking-quality evaluation over the BASELINE.json scenario families.

Runs scaled versions of the five benchmark configs and prints one JSON
line per config with tracking metrics (rms, coverage, track loss, false
tracks) plus the selection-gap certificate.  Scale via EVAL_SCALE=full
for the full-size configs (GPU recommended).

  1. 2-target crossing, no clutter, P_d=1
  2. 10 targets, clutter, P_d=0.9
  3. 50 targets, dense clutter, N=3
  4. Monte-Carlo batch of scenarios (device-batched)
  5. swarm with AIS priors (scaled)
"""
import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

FULL = os.environ.get("EVAL_SCALE", "small") == "full"


def build_scene(n_targets, clutter, P_d, N, shapes_kw, n_scans=16,
                radar_range=1000.0, use_ais=False, seed=7):
    """Deterministic scenario + config for one eval family.  Shared by
    run_config and tests/test_eval_parity.py so the device tracker and
    the reference-decision oracle see the SAME scans/AIS messages."""
    from pymht_tpu import TrackerShapes, TrackerParams
    from pymht_tpu.utils import simulator as sim

    period = 2.5
    shapes = TrackerShapes(**shapes_kw)
    params = TrackerParams(radar_period=period, P_d=min(P_d, 0.99),
                           lambda_phi=clutter, lambda_nu=1e-5, N=N,
                           radar_range=radar_range)
    rng = np.random.default_rng(seed)
    targets = sim.generate_initial_targets(rng, n_targets, (0., 0.),
                                           radar_range * 0.6, P_d, 0.1,
                                           assign_mmsi=use_ais)
    sim_list = sim.simulate_targets(rng, targets, sim_time=n_scans * period,
                                    dt=period)
    scans = sim.simulate_scans(rng, sim_list, period, sigma_R=2.5,
                               lambda_phi=clutter, radar_range=radar_range,
                               p0=(0., 0.), P_d=P_d,
                               local_clutter=clutter > 0,
                               global_clutter=clutter > 0)
    ais_groups = (sim.simulate_ais(rng, sim_list, period,
                                   sim_list[0][0].time) if use_ais else [])
    return shapes, params, sim_list, scans, ais_groups


def run_config(name, n_targets, clutter, P_d, N, shapes_kw, n_scans=16,
               radar_range=1000.0, use_ais=False, seed=7,
               method='lagrangian'):
    from pymht_tpu import Tracker
    from pymht_tpu.utils.ais_io import AisMessageStream
    from pymht_tpu.utils.metrics import evaluate

    period = 2.5
    shapes, params, sim_list, scans, ais_groups = build_scene(
        n_targets, clutter, P_d, N, shapes_kw, n_scans=n_scans,
        radar_range=radar_range, use_ais=use_ais, seed=seed)
    stream = AisMessageStream(ais_groups)

    # Production selection path by default (round-2 verdict item 4:
    # eval timings must describe the production solver; 'ipm' remains
    # as a cross-check config below).
    tracker = Tracker(shapes, params, method=method, use_ais=use_ais)
    gaps = []
    for s in scans:
        msgs = [m for m in stream.get_measurements(s.time)
                if s.time - period < m.time < s.time] if use_ais else None
        out = tracker.add_measurement_list(s.time, s.measurements, msgs)
        obj, bound = float(out.sel_obj), float(out.sel_bound)
        if np.isfinite(obj) and np.isfinite(bound):
            gaps.append((obj - bound) / max(1.0, abs(bound)))
    m = evaluate(tracker, sim_list, period, p0=(0., 0.),
                 radar_range=radar_range)
    m['config'] = name
    m['median_gap'] = round(float(np.median(gaps)), 6) if gaps else 0.0
    m = {k: (round(v, 3) if isinstance(v, float) else v)
         for k, v in m.items()}
    print(json.dumps(m))
    return m


def run_montecarlo(name, batch, n_targets, n_scans=10):
    import jax
    from pymht_tpu import TrackerShapes, TrackerParams
    from pymht_tpu.parallel import montecarlo as mc

    shapes = TrackerShapes(max_targets=max(8, n_targets + 4),
                           max_leaves=16, max_meas=n_targets + 24,
                           max_ais=2, window=6, max_prelim=8,
                           max_initiators=n_targets + 24)
    params = TrackerParams(radar_period=2.5, P_d=0.9, lambda_phi=1e-6,
                           lambda_nu=1e-5, N=4, radar_range=800.0)
    sc = mc.generate(jax.random.PRNGKey(0), batch=batch,
                     n_targets=n_targets, n_scans=n_scans, shapes=shapes,
                     params=params, radar_range=800.0, sigma_Q=0.05)
    state_b, xs, ms = mc.run_batch(sc, shapes, params)
    xs, msk = np.asarray(xs), np.asarray(ms)
    truth = np.asarray(sc.truth)
    errs = []
    for b in range(batch):
        for k in range(n_targets):
            if msk[-1, b, k]:
                errs.append(np.linalg.norm(xs[-1, b, k, :2]
                                           - truth[b, -1, k, :2]))
    out = {'config': name, 'batch': batch,
           'tracks_alive': int(msk[-1, :, :n_targets].sum()),
           'expected': batch * n_targets,
           'median_err': round(float(np.median(errs)), 2) if errs else None}
    print(json.dumps(out))
    return out


def main():
    from pymht_tpu.utils.runtime import enable_compile_cache
    enable_compile_cache()
    small = dict(max_targets=16, max_leaves=32, max_meas=64, max_ais=4,
                 window=7, max_prelim=16, max_initiators=64)
    # max_prelim sized to the 50-target confirm-from-empty burst: 32
    # starved the m/n initiator and cost 0.14 of config-3 coverage vs
    # the reference-decision oracle (round-5 finding; same static-cap
    # failure class as the round-4 max_ais=4 AIS-drop finding)
    big = dict(max_targets=80, max_leaves=16, max_meas=192, max_ais=4,
               window=5, max_prelim=96, max_initiators=192)
    results = [
        run_config("1_crossing", 2, 0.0, 1.0, 5, small, radar_range=2000.0),
        run_config("2_10tgt_clutter", 10, 2e-6, 0.9, 5, small),
        run_config("3_50tgt_dense", 50 if FULL else 24, 4e-6, 0.9, 3, big,
                   radar_range=2000.0),
        run_montecarlo("4_mc_batch", 64 if FULL else 8, 4),
        # max_ais sized to the scenario's peak AIS rate (12 msgs/scan):
        # an undersized static cap silently drops messages (round-4
        # parity finding — A=4 cost ~0.25 of track_percent here)
        run_config("5_ais_swarm", 12, 1e-6, 0.9, 4,
                   dict(small, max_ais=16), use_ais=True,
                   radar_range=1500.0),
        # dense-IPM cross-check of the production path on config 2
        run_config("2_ipm_xcheck", 10, 2e-6, 0.9, 5, small, method='ipm'),
    ]
    out_path = os.environ.get("EVAL_OUT")
    if out_path:
        with open(out_path, "w") as fh:
            json.dump({"scale": "full" if FULL else "small",
                       "configs": results}, fh, indent=1)
        print(f"wrote {out_path}", file=sys.stderr)


if __name__ == "__main__":
    main()
