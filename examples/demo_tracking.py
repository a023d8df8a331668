#!/usr/bin/env python
"""Demo: simulate a multi-target maritime scenario with AIS and track it.

Produces demo_scene.png (truth, measurements, tracks, gates) and
demo_run.xml (reference-compatible result export).

Run:  python examples/demo_tracking.py [--targets 6] [--scans 20]
"""
import argparse
import os
import sys
import xml.etree.ElementTree as ET

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from pymht_tpu import Tracker, TrackerShapes, TrackerParams  # noqa: E402
from pymht_tpu.utils import simulator as sim                  # noqa: E402
from pymht_tpu.utils.runtime import enable_compile_cache       # noqa: E402
from pymht_tpu.utils import plotting, xml_io                  # noqa: E402


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument('--targets', type=int, default=6)
    ap.add_argument('--scans', type=int, default=20)
    ap.add_argument('--seed', type=int, default=42)
    ap.add_argument('--clutter', type=float, default=2e-6)
    ap.add_argument('--out', default='.')
    args = ap.parse_args()
    enable_compile_cache()

    period, radar_range = 2.5, 1000.0
    shapes = TrackerShapes(max_targets=32, max_leaves=32, max_meas=64,
                           max_ais=8, window=7, max_prelim=32,
                           max_initiators=64)
    params = TrackerParams(radar_period=period, P_d=0.9,
                           lambda_phi=args.clutter, lambda_nu=1e-5, N=5,
                           radar_range=radar_range)

    rng = np.random.default_rng(args.seed)
    targets = sim.generate_initial_targets(rng, args.targets, (0., 0.),
                                           radar_range * 0.7, 0.9, 0.1,
                                           assign_mmsi=True)
    sim_list = sim.simulate_targets(rng, targets,
                                    sim_time=args.scans * period, dt=period)
    scans = sim.simulate_scans(rng, sim_list, period, sigma_R=2.5,
                               lambda_phi=args.clutter,
                               radar_range=radar_range, p0=(0., 0.))
    ais_groups = sim.simulate_ais(rng, sim_list, period,
                                  sim_list[0][0].time)
    ais_by_scan = {}
    for g in ais_groups:
        tmax = max(m.time for m in g)
        for s in scans:
            if s.time > tmax:
                ais_by_scan.setdefault(s.time, []).extend(g)
                break

    tracker = Tracker(shapes, params, method='ipm', use_ais=True)
    for s in scans:
        msgs = [m for m in ais_by_scan.get(s.time, [])
                if s.time - period < m.time < s.time]
        tracker.add_measurement_list(s.time, s.measurements, msgs)

    ids, states = tracker.get_track_states()
    print(f"{len(ids)} active tracks after {len(scans)} scans")
    tracker.print_time_log()

    import matplotlib
    matplotlib.use('Agg')
    import matplotlib.pyplot as plt
    fig, ax = plt.subplots(figsize=(9, 9))
    plotting.plot_ground_truth(ax, sim_list)
    plotting.plot_measurements(ax, scans, alpha=0.3)
    plotting.plot_tracks(ax, tracker, smooth=True)
    plotting.plot_validation_regions(ax, tracker)
    ax.set_aspect('equal')
    scene = os.path.join(args.out, 'demo_scene.png')
    fig.savefig(scene, dpi=120)
    print('wrote', scene)

    scenario = ET.Element(xml_io.SCENARIO)
    xml_io.store_ground_truth(scenario, sim_list, (0., 0.), radar_range,
                              period, sim_list[0][0].time)
    xml_io.store_tracker_settings(scenario, shapes, params, seed=args.seed)
    xml_io.store_run(scenario, tracker, smooth=True, i=0)
    run_xml = os.path.join(args.out, 'demo_run.xml')
    xml_io.write_element_to_file(run_xml, scenario)
    print('wrote', run_xml)


if __name__ == '__main__':
    main()
