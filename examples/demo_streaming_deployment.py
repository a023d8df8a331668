#!/usr/bin/env python
"""Demo: the production streaming deployment pattern, end to end.

Shows how the pieces a deployed tracker needs compose:

  1. device-resident streaming — radar frames buffer on device and a
     CHUNK of scans is processed in ONE dispatch (``scan_many``);
  2. on-device graceful degradation — ``dynamic_window=True`` runs the
     reference's dynamic-window triggers inside the compiled step
     (tracker.py:918-950 in /root/reference/pymht), so overloaded
     targets shrink their N-scan window without host round-trips;
  3. checkpoint/resume between chunks — ``checkpoint.save_state``
     snapshots the bare (TrackerState, InitiatorState) pytrees; a
     restarted process resumes bit-identically;
  4. host-side consumption — selected states stream back once per
     chunk (one transfer), and quality is scored with one-to-one
     truth matching.

This is the LOW-LEVEL pattern (explicit scan_many + checkpoints).  The
high-level equivalent is ``Tracker.stream(scans, ais_groups, chunk=N)``
(round 5): same chunked dispatches, plus full per-track archive
absorption and host supervision between chunks (wall-clock roof ->
half-beam degrade when ``degrade_on_overload=True``).  At swarm/large
scale also set ``TrackerShapes(radar_cand_width=64)`` — the spatial
pre-gate the swarm benchmark uses.

Run:  python examples/demo_streaming_deployment.py [--targets 400]
"""
import argparse
import os
import sys
import tempfile
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402

from pymht_tpu import Tracker, TrackerShapes, TrackerParams  # noqa: E402
from pymht_tpu.core.tracker import scan_many                  # noqa: E402
from pymht_tpu.utils import simulator as sim                  # noqa: E402
from pymht_tpu.utils.runtime import enable_compile_cache       # noqa: E402
from pymht_tpu.utils import checkpoint                        # noqa: E402


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument('--targets', type=int, default=100)
    ap.add_argument('--scans', type=int, default=12)
    ap.add_argument('--chunk', type=int, default=4)
    ap.add_argument('--seed', type=int, default=11)
    args = ap.parse_args()
    enable_compile_cache()

    period = 2.5
    radar_range = 4000.0 * float(np.sqrt(args.targets / 100.0))
    shapes = TrackerShapes(
        max_targets=max(128, args.targets + 24), max_leaves=16,
        max_meas=2 * args.targets + 64, max_ais=64, window=6,
        max_prelim=64, max_initiators=256, ais_per_leaf=2)
    params = TrackerParams(radar_period=period, P_d=0.9,
                           lambda_phi=1.5e-6, lambda_nu=1e-6, N=4,
                           radar_range=radar_range)

    rng = np.random.default_rng(args.seed)
    targets = sim.generate_initial_targets(
        rng, args.targets, (0.0, 0.0), radar_range * 0.8, 0.9, 0.1,
        assign_mmsi=True, P_r=0.5)
    sim_list = sim.simulate_targets(rng, targets,
                                    sim_time=args.scans * period, dt=period)
    scans = sim.simulate_scans(rng, sim_list, period, sigma_R=2.5,
                               lambda_phi=1.5e-6, radar_range=radar_range,
                               p0=(0.0, 0.0), lambda_local=0.2)
    ais_groups = sim.simulate_ais(rng, sim_list, period,
                                  init_time=sim_list[0][0].time)

    F_inv = np.eye(4)
    F_inv[0, 2] = F_inv[1, 3] = -period
    tracker = Tracker(shapes, params, use_ais=True)
    tracker.pre_initialize(scans[0].time - period,
                           [F_inv @ t.state for t in targets],
                           mmsi=[t.mmsi for t in targets])
    scan_b, ais_b = tracker.make_stream_inputs(scans[:args.scans],
                                               ais_groups[:args.scans])
    part = lambda tree, lo, hi: jax.tree_util.tree_map(  # noqa: E731
        lambda x: x[lo:hi], tree)

    run = jax.jit(lambda st, ist, sc, a: scan_many(
        st, ist, sc, a, shapes, params, method='lagrangian',
        use_ais=True, dynamic_window=True))

    ckpt_dir = tempfile.mkdtemp(prefix='pymht_ckpt_')
    state, istate = tracker.state, tracker.init_state
    alive_per_chunk = []
    for lo in range(0, args.scans, args.chunk):
        hi = min(lo + args.chunk, args.scans)
        t0 = time.time()
        state, istate, outs = run(state, istate,
                                  part(scan_b, lo, hi), part(ais_b, lo, hi))
        jax.block_until_ready(outs.track_mask)
        dt = time.time() - t0
        # one host transfer per chunk: the selected-track summaries
        alive = int(np.asarray(outs.track_mask)[-1].sum())
        alive_per_chunk.append(alive)
        print(f"chunk {lo:3d}-{hi:3d}: {alive:4d} tracks alive, "
              f"{dt / (hi - lo) * 1000:7.2f} ms/scan "
              f"(first chunk includes compile)")
        # operational checkpoint: a restarted process resumes from here
        checkpoint.save_state(os.path.join(ckpt_dir, f"scan{hi:04d}"),
                              state, istate)

    # demonstrate resume: reload the last checkpoint and verify the
    # restored state matches bitwise
    last = os.path.join(ckpt_dir, f"scan{args.scans:04d}")
    st2, ist2 = checkpoint.load_state(last)
    same = all(bool(np.array_equal(np.asarray(a), np.asarray(b)))
               for a, b in zip(jax.tree_util.tree_leaves((state, istate)),
                               jax.tree_util.tree_leaves((st2, ist2))))
    print(f"checkpoint resume bitwise-identical: {same}")

    tw = np.asarray(state.tgt_window)[np.asarray(state.tgt_mask)]
    print(f"dynamic window: mean {tw.mean():.2f}, min {tw.min()}, "
          f"max {tw.max()} (N={params.N}); "
          f"{(tw < params.N).mean() * 100:.1f}% of targets degraded")

    # score the final chunk's estimates against truth (one-to-one)
    from scipy.optimize import linear_sum_assignment
    truth = np.array([[t.cartesian_state() for t in sample]
                      for sample in sim_list[:args.scans]])
    est = np.asarray(state.leaf_x)[
        np.arange(shapes.max_targets), np.asarray(state.sel_leaf)][:, :2]
    ok = np.asarray(state.tgt_mask)
    d = np.linalg.norm(truth[args.scans - 1][:, None, :2]
                       - est[None, ok, :], axis=2)
    ri, ci = linear_sum_assignment(np.minimum(d, 20.0))
    hit = d[ri, ci] < 20.0
    print(f"final-scan coverage: {hit.mean() * 100:.1f}% "
          f"({int(hit.sum())}/{truth.shape[1]}), "
          f"rms {np.sqrt((d[ri, ci][hit] ** 2).mean()):.2f} m")
    assert same


if __name__ == '__main__':
    main()
