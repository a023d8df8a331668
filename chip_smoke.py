#!/usr/bin/env python
"""Smoke run of the tracker's main path on one GPU.

    python chip_smoke.py           # phases a-e on one card
    python chip_smoke.py --four    # only the target-sharded swarm step
                                   # on four cards, against one card

Phases (one process; any failed check raises and the exit code is not 0):

a. device: JAX's device kind and count, and the card's name and power
   limit from nvidia-smi; every timing line carries that label.
b. Kalman and gating parity at the served and swarm widths: the device
   ops (ops/kalman.py, ops/ais_fused.py) against the float64 NumPy
   oracle (utils/kalman_ref.py), each with a stated tolerance, at the
   precision each op asks for (HIGHEST on the Kalman products: TF32 at
   the default misses these tolerances by orders of magnitude).
c. served path: the 100-target high-clutter scene with AIS through
   ``Tracker.add_measurement_list`` (lagrangian selection), then
   ``get_tracks``/``get_smooth_tracks``; truth coverage and rms, and
   the selection against the exact HiGHS oracle on three scans.  Then
   three scans through a default-constructed Tracker (IPM selection).
d. streaming path: the 1000-target AIS swarm through ``scan_many``,
   device-resident; coverage, rms, oracle gap, memory.
e. timings (information only, labelled with the card): compile seconds
   and warm wall ms/scan of c and d.

The last line of standard output is one JSON object
``{"ok": true, "device": {"platform", "kind", "count"}}``; it is printed
only when every phase passed.  With no GPU the script fails at once.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from pymht_tpu.utils.runtime import enable_compile_cache, require_gpu  # noqa: E402

PERIOD = 2.5

# Limits every scene must meet (BASELINE.md): selection within 0.1% of
# the exact optimum; pre-initialised targets at sigma_R = 2.5 m.
MAX_ORACLE_GAP = 1e-3
MIN_COVERAGE = 0.9
MAX_RMS_M = 10.0

# Scene sizes.  SERVED is bench.py's 100-target scene, SWARM is
# BASELINE config 5 (bench_swarm.py); tests run the same phases with
# tiny sizes.
FULL = dict(
    widths=(dict(T=128, L=32, M=512, A=32, radar_range=2000.0),
            dict(T=1024, L=16, M=2048, A=128, radar_range=12000.0)),
    served=dict(n_targets=100, radar_range=2000.0, n_scans=10,
                oracle_after=(4, 7, 10), ipm_scans=3,
                shapes=dict(max_targets=128, max_leaves=32, max_meas=512,
                            max_ais=32, ais_per_leaf=2, window=7,
                            max_prelim=64, max_initiators=512),
                params=dict(P_d=0.9, lambda_phi=2e-5, lambda_nu=1e-5,
                            N=5),
                spread=1.0, P_r=0.9, lambda_local=0.5, seed=4321,
                ipm_seed=1234),
    swarm=dict(n_targets=1000, radar_range=12000.0, n_scans=6,
               shapes=dict(max_targets=1024, max_leaves=16,
                           max_meas=2048, max_ais=128, ais_per_leaf=2,
                           window=6, max_prelim=64, max_initiators=512,
                           radar_cand_width=64),
               params=dict(P_d=0.9, lambda_phi=1.5e-6, lambda_nu=1e-6,
                           N=4),
               spread=0.85, P_r=0.5, lambda_local=0.2, seed=77,
               four_scans=3),
)


def log(*a):
    print(*a, flush=True)


def card_label() -> str:
    """``name, power.limit`` of the first card, as nvidia-smi reports."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


# ---------------------------------------------------------------------
# b. Kalman / gating parity against the float64 oracle
# ---------------------------------------------------------------------

def _check(name, dev, ref, rtol, atol, where=None):
    """|dev - ref| <= atol + rtol*|ref| elementwise (on ``where``)."""
    dev = np.asarray(dev, np.float64)
    ref = np.asarray(ref, np.float64)
    if where is not None:
        dev, ref = dev[where], ref[where]
    err = np.abs(dev - ref)
    ratio = float(np.max(err / (atol + rtol * np.abs(ref)))) if err.size \
        else 0.0
    log(f"  {name:24s} n={err.size:<10d} max|err|={float(err.max()) if err.size else 0.0:.3e}"
        f"  rtol={rtol:g} atol={atol:g}  worst err/tol={ratio:.3f}")
    if not np.all(np.isfinite(dev)) or ratio > 1.0:
        raise AssertionError(f"{name}: outside tolerance (err/tol {ratio})")
    return ratio


def _check_gate(name, dev_gate, ref_gate, ref_nis, eta2, band):
    """Gate decisions agree except where the oracle NIS is within
    ``band`` of the threshold (float32 rounding can flip those)."""
    flips = np.asarray(dev_gate) != np.asarray(ref_gate)
    bad = flips & (np.abs(np.asarray(ref_nis) - eta2) > band)
    log(f"  {name:24s} gated={int(np.sum(ref_gate))} "
        f"boundary flips={int(flips.sum())} other flips={int(bad.sum())}")
    if bad.any():
        raise AssertionError(f"{name}: {int(bad.sum())} gate decisions "
                             "differ away from the threshold")


def kernel_inputs(rng, T, L, M, A, radar_range):
    """A leaf table, scan and AIS batch of realistic magnitudes: leaves
    in the radar disc, covariances around the tracker's P0, half of the
    measurements at predicted leaf positions (so gates fire), the rest
    uniform clutter; AIS reports near random leaves."""
    N = T * L
    r = radar_range * np.sqrt(rng.uniform(size=N))
    th = rng.uniform(0, 2 * np.pi, N)
    x = np.stack([r * np.cos(th), r * np.sin(th),
                  rng.normal(0, 5, N), rng.normal(0, 5, N)], 1)
    B = rng.normal(size=(N, 4, 4)) * np.array([2.0, 2.0, 0.5, 0.5])[:, None]
    P = B @ np.swapaxes(B, 1, 2) + np.diag([6.25, 6.25, 1.9, 1.9])
    n_det = M // 2
    who = rng.choice(N, n_det, replace=False)
    zd = x[who, :2] + PERIOD * x[who, 2:] + rng.normal(0, 2.5, (n_det, 2))
    rc = radar_range * np.sqrt(rng.uniform(size=M - n_det))
    tc = rng.uniform(0, 2 * np.pi, M - n_det)
    z = np.concatenate([zd, np.stack([rc * np.cos(tc), rc * np.sin(tc)], 1)])
    zmask = np.ones(M, bool)
    zmask[-max(1, M // 16):] = False
    src = rng.choice(N, A)
    t_a = rng.uniform(0.1, PERIOD - 0.1, A)
    hi = rng.uniform(size=A) < 0.5
    sig = np.where(hi, 1.0, 3.0)[:, None]
    xa = x[src]
    a_state = np.stack([xa[:, 0] + t_a * xa[:, 2], xa[:, 1] + t_a * xa[:, 3],
                        xa[:, 2], xa[:, 3]], 1) + rng.normal(size=(A, 4)) * sig
    f32 = lambda a: np.asarray(a, np.float32)  # noqa: E731
    return dict(x=f32(x), P=f32(P), z=f32(z), zmask=zmask,
                cnllr=f32(rng.normal(0, 1, N)), pd=np.float32(0.9),
                lmask=rng.uniform(size=N) < 0.95,
                a_state=f32(a_state), a_time=f32(t_a), a_hi=hi,
                a_mmsi=np.arange(1, A + 1, dtype=np.int32))


def phase_kernels(widths, seed=0):
    """Device Kalman/gating ops against the float64 oracle (phase b)."""
    import jax
    import jax.numpy as jnp
    from pymht_tpu.core.config import TrackerShapes, TrackerParams
    from pymht_tpu.core.grow import Scan, AisBatch
    from pymht_tpu.core.state import empty_state
    from pymht_tpu.models import pv, ais as ais_model
    from pymht_tpu.ops import kalman as k
    from pymht_tpu.ops.ais_fused import (ais_candidates_planes,
                                         radar_candidates_planes)
    from pymht_tpu.utils import kalman_ref as kr

    params = TrackerParams(radar_period=PERIOD, P_d=0.9, lambda_phi=2e-5,
                           lambda_nu=1e-5)
    lam = params.lambda_ex
    rng = np.random.default_rng(seed)
    worst = 0.0
    for w in widths:
        T, L, M, A = w['T'], w['L'], w['M'], w['A']
        N = T * L
        # Tolerances for float32 device math against float64: relative
        # 1e-4 (a float32 4x4 product chain with margin for
        # conditioning; a TF32 product, ~1e-3, fails it) plus an
        # absolute floor in each quantity's units.  Positions: 4 ulps
        # of the largest operand, 2x the radar range (a residual to
        # clutter across the disc), since x_bar + K*z_tilde cancels.
        # NIS/NLLR: 1e-2 (0.2% of the 5.99 gate).
        x_atol = max(1e-3, 4 * float(np.finfo(np.float32).eps)
                     * 2 * w['radar_range'])
        TOL = dict(x=(1e-5, x_atol), P=(1e-4, 1e-4), S=(1e-4, 1e-4),
                   S_inv=(1e-4, 1e-7), K=(1e-4, 1e-6), P_hat=(1e-4, 1e-3),
                   nis=(1e-4, 1e-2), nllr=(1e-4, 1e-2), det=(1e-4, 0.0))
        log(f"phase b: {N} leaves x {M} measurements, {A} AIS "
            f"(T={T} L={L}); precision as the ops request it")
        d = kernel_inputs(rng, T, L, M, A, w['radar_range'])

        # -- ops/kalman.py: predict, precalc, nis, nllr, filter update
        @jax.jit
        def kal(x, P, z):
            xb, Pb = k.predict(pv.Phi(PERIOD), pv.Q(PERIOD), x, P)
            zh, S, Si, K, Ph = k.precalc(pv.C_RADAR, pv.R_RADAR(), xb, Pb)
            zt = k.residuals(z, zh)
            nis = k.nis(zt, Si)
            return (xb, Pb, S, Si, K, Ph, nis,
                    k.nllr(lam, 0.9, S, nis), k.filter_update(xb, K, zt))

        dev = [np.asarray(a) for a in kal(d['x'], d['P'], d['z'])]
        xb, Pb = kr.predict(kr.Phi(PERIOD), kr.Q(PERIOD), d['x'], d['P'])
        zh, S, Si, K, Ph = kr.precalc(kr.C_RADAR, kr.R_RADAR(), xb, Pb)
        zt = kr.z_tilde(d['z'], zh)
        nis = kr.normalizedInnovationSquared(zt, Si)
        ref = [xb, Pb, S, Si, K, Ph, nis, kr.nllr(lam, 0.9, S, nis)]
        names = (("predict x_bar", 'x'), ("predict P_bar", 'P'),
                 ("precalc S", 'S'), ("precalc S_inv", 'S_inv'),
                 ("precalc K", 'K'), ("precalc P_hat", 'P_hat'),
                 ("nis", 'nis'), ("nllr", 'nllr'))
        for (name, key), dv, rf in zip(names, dev, ref):
            worst = max(worst, _check(name, dv, rf, *TOL[key]))
        worst = max(worst, _check("filter_update", dev[8],
                                  kr.numpyFilter(xb, K, zt), *TOL['x']))
        del dev, zt

        # -- ops/ais_fused.py radar planes (production grow path)
        shapes = TrackerShapes(max_targets=T, max_leaves=L, max_meas=M,
                               max_ais=A, ais_per_leaf=2)
        st = empty_state(shapes, params).replace(
            leaf_x=jnp.asarray(d['x'].reshape(T, L, 4)),
            leaf_P=jnp.asarray(d['P'].reshape(T, L, 4, 4)),
            leaf_cnllr=jnp.asarray(d['cnllr'].reshape(T, L)),
            leaf_mask=jnp.asarray(d['lmask'].reshape(T, L)),
            tgt_mask=jnp.ones((T,), bool))
        scan = Scan(z=jnp.asarray(d['z']), mask=jnp.asarray(d['zmask']),
                    time=jnp.asarray(PERIOD, jnp.float32))
        ais = AisBatch(state=jnp.asarray(d['a_state']),
                       time=jnp.asarray(d['a_time']),
                       mmsi=jnp.asarray(d['a_mmsi']),
                       high_accuracy=jnp.asarray(d['a_hi']),
                       mask=jnp.ones((A,), bool))
        out = jax.jit(lambda s, sc: radar_candidates_planes(s, sc, params))(
            st, scan)
        p_xb, p_Pb, p_K, p_Ph, p_gate, p_nllr = (np.asarray(a).reshape(
            (N,) + a.shape[2:]) for a in out)
        gate = ((nis <= params.eta2) & d['zmask'][None, :]
                & d['lmask'][:, None])
        nllr_ref = ref[7]
        for name, dv, rf, key in (("planes x_bar", p_xb, xb, 'x'),
                                  ("planes P_bar", p_Pb, Pb, 'P'),
                                  ("planes K", p_K, K, 'K'),
                                  ("planes P_hat", p_Ph, Ph, 'P_hat')):
            worst = max(worst, _check(name, dv, rf, *TOL[key]))
        band = TOL['nis'][1] + TOL['nis'][0] * params.eta2
        _check_gate("planes gate", p_gate, gate, nis, params.eta2, band)
        worst = max(worst, _check("planes nllr (gated)", p_nllr, nllr_ref,
                                  *TOL['nllr'], where=gate & p_gate))
        del nis, nllr_ref, p_nllr, p_gate, gate

        # -- 4x4 AIS path: stage-1 oracle over every (leaf, message)
        R1 = np.where(d['a_hi'][:, None, None],
                      np.eye(4) * ais_model.sigmaR_AIS_true_highAccuracy ** 2,
                      np.eye(4) * ais_model.sigmaR_AIS_true_lowAccuracy ** 2)
        Phi1, Q1 = kr.Phi(d['a_time']), kr.Q(d['a_time'])          # [A,4,4]
        xb1 = np.einsum('aij,nj->nai', Phi1, d['x'].astype(np.float64))
        Pb1 = (Phi1[None] @ d['P'].astype(np.float64)[:, None]
               @ np.swapaxes(Phi1, 1, 2)[None] + Q1[None])      # [N,A,4,4]
        S1 = Pb1 + R1[None]
        S1i = np.linalg.inv(S1)
        zt1 = d['a_state'][None].astype(np.float64) - xb1
        nis1 = np.einsum('nai,naij,naj->na', zt1, S1i, zt1)
        gate1 = (nis1 <= params.eta2_ais) & d['lmask'][:, None]

        inv_d, det_d = jax.jit(lambda s: (k.inv_psd(s), k.det_psd(s)))(
            jnp.asarray(S1.astype(np.float32)))
        S1_32 = S1.astype(np.float32).astype(np.float64)
        worst = max(worst, _check("inv4x4 (AIS S1)", inv_d,
                                  np.linalg.inv(S1_32), 1e-4, 1e-7))
        worst = max(worst, _check("det4x4 (AIS S1)", det_d,
                                  np.linalg.det(S1_32), *TOL['det']))
        del inv_d, det_d, S1_32

        G = shapes.ais_fuse_width
        (g_ok, gate2, _, nllr1g, fused, x_bar2, _, K2, P_hat2,
         ais_idx) = (np.asarray(a) for a in jax.jit(
             lambda s, sc, a: ais_candidates_planes(s, sc, a, params, G))(
                 st, scan, ais))
        g_ok = g_ok.reshape(N, G)
        idx = ais_idx.reshape(N, G)
        rows = np.arange(N)[:, None]
        band1 = TOL['nis'][1] + TOL['nis'][0] * params.eta2_ais
        near1 = np.any(np.abs(nis1 - params.eta2_ais) <= band1, axis=1)
        n_ref = np.minimum(gate1.sum(1), G)
        bad = (g_ok.sum(1) != n_ref) & ~near1
        sel_ok = gate1[rows, idx] | ~g_ok | near1[:, None]
        log(f"  ais stage-1 selection   leaves with gated AIS="
            f"{int((n_ref > 0).sum())} count mismatches={int(bad.sum())} "
            f"ungated picks={int((~sel_ok).sum())}")
        if bad.any() or not sel_ok.all():
            raise AssertionError("AIS stage-1 compression differs from the "
                                 "oracle away from the gate threshold")
        n_tgt = T
        lam_ais = n_tgt * params.P_ais / (np.pi * 1e4 ** 2)
        nllr1 = kr.nllr(lam_ais, 1.0, S1, nis1[..., None])[..., 0]
        sel = g_ok & gate1[rows, idx]
        worst = max(worst, _check("ais nllr1 (selected)",
                                  nllr1g.reshape(N, G), nllr1[rows, idx],
                                  *TOL['nllr'], where=sel))

        # stage 2 for the selected messages: update at the message time,
        # re-predict to scan time, radar gate and fused score
        li, gi = np.nonzero(sel)
        ai = idx[li, gi]
        K1 = Pb1[li, ai] @ S1i[li, ai]
        xh1 = xb1[li, ai] + np.einsum('nij,nj->ni', K1, zt1[li, ai])
        Ph1 = Pb1[li, ai] - K1 @ Pb1[li, ai]
        dt2 = PERIOD - d['a_time'][ai].astype(np.float64)
        xb2, Pb2 = kr.predict(kr.Phi(dt2), kr.Q(dt2), xh1, Ph1)
        zh2, S2, S2i, K2r, Ph2 = kr.precalc(kr.C_RADAR, kr.R_RADAR(), xb2,
                                           Pb2)
        nis2 = kr.normalizedInnovationSquared(kr.z_tilde(d['z'], zh2), S2i)
        nllr2 = kr.nllr(lam, 0.9, S2, nis2)
        fused_ref = 0.5 * nllr1[li, ai][:, None] + 0.5 * nllr2
        gate2_ref = (nis2 <= params.eta2) & d['zmask'][None, :]
        pick = lambda a: a.reshape((N, G) + a.shape[3:])[li, gi]  # noqa: E731
        worst = max(worst, _check("ais x_bar2", pick(x_bar2), xb2,
                                  *TOL['x']))
        worst = max(worst, _check("ais K2", pick(K2), K2r, *TOL['K']))
        worst = max(worst, _check("ais P_hat2", pick(P_hat2), Ph2,
                                  *TOL['P_hat']))
        g2 = pick(gate2)
        _check_gate("ais gate2", g2, gate2_ref, nis2, params.eta2, band)
        worst = max(worst, _check("ais fused score (gated)", pick(fused),
                                  fused_ref, *TOL['nllr'],
                                  where=g2 & gate2_ref))
    return worst


# ---------------------------------------------------------------------
# scenes
# ---------------------------------------------------------------------

def _scene(cfg, seed, with_ais):
    """Targets, truth, scans and per-scan AIS groups of one scene."""
    from pymht_tpu.utils import simulator as sim
    from pymht_tpu.utils.ais_io import AisMessageStream
    rng = np.random.default_rng(seed)
    rr = cfg['radar_range']
    n_scans = cfg['n_scans']
    targets = sim.generate_initial_targets(
        rng, cfg['n_targets'], (0.0, 0.0), rr * cfg['spread'], 0.9, 0.1,
        assign_mmsi=with_ais, P_r=cfg['P_r'])
    sim_list = sim.simulate_targets(rng, targets, sim_time=n_scans * PERIOD,
                                    dt=PERIOD)
    scans = sim.simulate_scans(rng, sim_list, PERIOD, sigma_R=2.5,
                               lambda_phi=cfg['params']['lambda_phi'],
                               radar_range=rr, p0=(0.0, 0.0),
                               lambda_local=cfg['lambda_local'])[:n_scans]
    groups = [[] for _ in scans]
    if with_ais:
        stream = AisMessageStream(sim.simulate_ais(
            rng, sim_list, PERIOD, init_time=sim_list[0][0].time))
        groups = [[m for m in stream.get_measurements(s.time)
                   if s.time - PERIOD < m.time < s.time] for s in scans]
    # targets' states are valid at scans[0].time; the tracker seeds
    # one period earlier, so back-propagate them
    F_inv = np.eye(4)
    F_inv[0, 2] = F_inv[1, 3] = -PERIOD
    seeds = [F_inv @ t.state for t in targets]
    mmsi = [t.mmsi for t in targets] if with_ais else None
    return sim_list[:n_scans], scans, groups, seeds, mmsi


def _config(cfg):
    from pymht_tpu.core.config import TrackerShapes, TrackerParams
    return (TrackerShapes(**cfg['shapes']),
            TrackerParams(radar_period=PERIOD,
                          radar_range=cfg['radar_range'], **cfg['params']))


def _check_quality(name, coverage, rms):
    log(f"  {name}: truth coverage {coverage:.4f} (min {MIN_COVERAGE}), "
        f"rms {rms:.3f} m (max {MAX_RMS_M})")
    if not (coverage >= MIN_COVERAGE and rms <= MAX_RMS_M):
        raise AssertionError(f"{name}: coverage/rms outside limits")


def _check_gap(name, state, shapes, params):
    from pymht_tpu.utils.oracle import selection_gap
    t0 = time.perf_counter()
    gap = selection_gap(state, shapes, params)
    log(f"  {name}: selection gap vs exact HiGHS oracle {gap} "
        f"(max {MAX_ORACLE_GAP}; oracle {time.perf_counter() - t0:.1f} s)")
    if gap is None or not gap <= MAX_ORACLE_GAP:
        raise AssertionError(f"{name}: oracle gap {gap}")
    return gap


def _smooth_precision(tr, kw, tol_m=1e-2):
    """The smoother at the default matmul precision against the same
    call at HIGHEST: positions must agree to ``tol_m`` metres (far below
    the 2.5 m radar noise; TF32 rounding of the EM statistics would
    not)."""
    import jax
    base = tr.get_smooth_tracks(**kw)
    with jax.default_matmul_precision("highest"):
        ref = tr.get_smooth_tracks(**kw)
    diff = max((float(np.max(np.abs(base[k][0] - ref[k][0])))
                for k in base if base[k][2]), default=0.0)
    log(f"  get_smooth_tracks({kw}): default vs highest precision, max "
        f"position difference {diff:.3e} m (max {tol_m})")
    if not diff <= tol_m:
        raise AssertionError(f"smoother {kw}: precision-dependent result")


def _smooth_quality(tr, sim_list, gate=20.0):
    """Smoothed track positions against the nearest truth target at the
    same scan: (fraction within ``gate`` metres, rms of those, tracks)."""
    truth = np.array([[t.cartesian_state()[:2] for t in sample]
                      for sample in sim_list])                 # [S, K, 2]
    t_index = {round(sample[0].time, 6): i
               for i, sample in enumerate(sim_list)}
    smooth = tr.get_smooth_tracks()
    seqs = tr._track_measurement_sequences()
    d_all = []
    for tid, (pos, vel, ok) in smooth.items():
        if not ok:
            continue
        if not (np.all(np.isfinite(pos)) and np.all(np.isfinite(vel))):
            raise AssertionError(f"smoothed track {tid} is not finite")
        for t, p in zip(seqs[tid][0], pos):
            si = t_index.get(round(float(t) + tr.t0, 6))
            if si is not None:
                d_all.append(np.min(np.linalg.norm(truth[si] - p, axis=1)))
    d_all = np.asarray(d_all)
    hit = d_all < gate
    if not hit.any():
        raise AssertionError("no smoothed sample near the truth")
    n = sum(1 for v in smooth.values() if v[2])
    return float(hit.mean()), float(np.sqrt(np.mean(d_all[hit] ** 2))), n


# ---------------------------------------------------------------------
# c. served path
# ---------------------------------------------------------------------

def phase_served(cfg, card):
    from pymht_tpu.core.tracker import Tracker
    from pymht_tpu.utils.metrics import evaluate
    shapes, params = _config(cfg)
    sim_list, scans, groups, seeds, mmsi = _scene(cfg, cfg['seed'], True)
    log(f"phase c: served path, {cfg['n_targets']} targets, "
        f"{np.mean([len(s.measurements) for s in scans]):.1f} meas/scan, "
        f"{np.mean([len(g) for g in groups]):.1f} AIS/scan")
    tr = Tracker(shapes, params, method='lagrangian')
    tr.pre_initialize(scans[0].time - PERIOD, seeds, mmsi=mmsi)
    walls, gaps = [], []
    for i, (s, g) in enumerate(zip(scans, groups), 1):
        t0 = time.perf_counter()
        out = tr.add_measurement_list(s.time, s.measurements, g)
        walls.append(time.perf_counter() - t0)
        if not bool(out.sel_feasible):
            raise AssertionError(f"scan {i}: infeasible selection")
        if i in cfg['oracle_after']:
            gaps.append(_check_gap(f"scan {i}", tr.state, shapes, params))
    ev = evaluate(tr, sim_list, PERIOD, p0=(0.0, 0.0),
                  radar_range=cfg['radar_range'])
    _check_quality("lagrangian", ev['track_percent'], ev['rms'])
    tracks = tr.get_tracks()
    if not tracks:
        raise AssertionError("get_tracks: no tracks")
    cov, rms, n = _smooth_quality(tr, sim_list)
    _check_quality(f"get_smooth_tracks over {n} tracks", cov, rms)
    for kw in (dict(), dict(em_iters=5, em_mode='full')):
        _smooth_precision(tr, kw)
    P = np.asarray(tr.state.leaf_P)[np.asarray(tr.state.leaf_mask)]
    asym = float(np.max(np.abs(P - np.swapaxes(P, 1, 2)))) if len(P) else 0.0
    min_eig = float(np.min(np.linalg.eigvalsh(
        0.5 * (P + np.swapaxes(P, 1, 2))))) if len(P) else 0.0
    log(f"  {len(tracks)} tracks; live leaf P: max "
        f"asymmetry {asym:.3e}, min eigenvalue {min_eig:.3e}")
    warm = float(np.median(walls[1:])) * 1e3
    log(f"  [{card}] served lagrangian: first scan {walls[0]:.2f} s "
        f"(compile + one scan), warm wall {warm:.3f} ms/scan (median of "
        f"{len(walls) - 1}, host work included)")

    # the constructor's defaults: method='ipm', AIS on; radar-only scene
    sim2, scans2, _, seeds2, _ = _scene(
        dict(cfg, n_scans=cfg['ipm_scans']), cfg['ipm_seed'], False)
    tr2 = Tracker(shapes, params)
    if tr2.method != 'ipm':
        raise AssertionError(f"default method is {tr2.method!r}")
    tr2.pre_initialize(scans2[0].time - PERIOD, seeds2)
    walls2 = []
    for s in scans2:
        t0 = time.perf_counter()
        out = tr2.add_measurement_list(s.time, s.measurements)
        walls2.append(time.perf_counter() - t0)
        if not bool(out.sel_feasible):
            raise AssertionError("ipm: infeasible selection")
    gaps.append(_check_gap("ipm last scan", tr2.state, shapes, params))
    ev2 = evaluate(tr2, sim2, PERIOD, p0=(0.0, 0.0),
                   radar_range=cfg['radar_range'])
    _check_quality("ipm", ev2['track_percent'], ev2['rms'])
    log(f"  [{card}] served ipm: first scan {walls2[0]:.2f} s, then "
        f"{[round(w * 1e3, 3) for w in walls2[1:]]} ms")
    return dict(coverage=ev['track_percent'], rms=ev['rms'],
                oracle_gaps=gaps, warm_ms=warm)


# ---------------------------------------------------------------------
# d. streaming path
# ---------------------------------------------------------------------

def _stream_inputs(cfg):
    """Tracker seeded with the swarm scene, and its device-resident
    scan/AIS batches."""
    from pymht_tpu.core.tracker import Tracker
    shapes, params = _config(cfg)
    sim_list, scans, groups, seeds, mmsi = _scene(cfg, cfg['seed'], True)
    tr = Tracker(shapes, params, method='lagrangian')
    tr.pre_initialize(scans[0].time - PERIOD, seeds, mmsi=mmsi)
    scan_b, ais_b = tr.make_stream_inputs(scans, groups)
    return shapes, params, sim_list, scans, groups, tr, scan_b, ais_b


def phase_stream(cfg, card, device):
    import jax
    from pymht_tpu.core.tracker import scan_many
    from pymht_tpu.utils.metrics import scan_coverage, truth_positions
    (shapes, params, sim_list, scans, groups, tr, scan_b,
     ais_b) = _stream_inputs(cfg)
    log(f"phase d: streaming path, {cfg['n_targets']} targets, "
        f"{np.mean([len(s.measurements) for s in scans]):.1f} meas/scan, "
        f"{np.mean([len(g) for g in groups]):.1f} AIS/scan, "
        f"{len(scans)} scans per scan_many")
    fn = jax.jit(lambda st, ist, sc, a: scan_many(
        st, ist, sc, a, shapes, params, method='lagrangian'))
    t0 = time.perf_counter()
    compiled = fn.lower(tr.state, tr.init_state, scan_b, ais_b).compile()
    t_compile = time.perf_counter() - t0
    log(f"  memory_analysis: {compiled.memory_analysis()}")
    st, _, outs = jax.block_until_ready(
        compiled(tr.state, tr.init_state, scan_b, ais_b))
    walls = []
    for _ in range(3):
        t0 = time.perf_counter()
        jax.block_until_ready(compiled(tr.state, tr.init_state, scan_b,
                                       ais_b))
        walls.append(time.perf_counter() - t0)
    stats = device.memory_stats() or {}
    log(f"  peak_bytes_in_use: {stats.get('peak_bytes_in_use')}")
    if not np.all(np.asarray(outs.sel_feasible)):
        raise AssertionError("swarm: infeasible selection")
    if not np.all(np.isfinite(np.asarray(outs.track_x)[
            np.asarray(outs.track_mask)])):
        raise AssertionError("swarm: non-finite track states")
    coverage, rms = scan_coverage(outs.track_x, outs.track_mask,
                                  truth_positions(sim_list))
    _check_quality("swarm", coverage, rms)
    gap = _check_gap("swarm final state", st, shapes, params)
    ms = float(np.median(walls)) / len(scans) * 1e3
    log(f"  [{card}] swarm scan_many: compile {t_compile:.2f} s, warm "
        f"{ms:.3f} ms/scan (median of 3 runs of {len(scans)} scans)")
    return dict(coverage=coverage, rms=rms, oracle_gap=gap, warm_ms=ms,
                compile_s=t_compile)


# ---------------------------------------------------------------------
# f. target-sharded swarm step on four devices
# ---------------------------------------------------------------------

def phase_four(cfg, card, devices):
    """Sharded step on a ('cluster',) mesh of four devices against the
    single-device ``scan_step`` on the same inputs, under the contract
    of tests/test_sharded_swarm.py."""
    import jax
    from jax.sharding import Mesh
    from pymht_tpu.core.tracker import scan_step
    from pymht_tpu.parallel.sharded_tracker import make_sharded_tracker_step
    n_scans = cfg['four_scans']
    (shapes, params, _, _, _, tr, scan_b,
     ais_b) = _stream_inputs(dict(cfg, n_scans=n_scans))
    n_tgt = cfg['n_targets']
    log(f"phase f: target-sharded step on {len(devices)} devices vs one, "
        f"{n_tgt} targets, {n_scans} scans")
    per = lambda tree, i: jax.tree_util.tree_map(lambda x: x[i], tree)  # noqa: E731
    single = jax.jit(lambda st, ist, sc, a: scan_step(
        st, ist, sc, a, shapes, params, method='lagrangian'))
    sharded = make_sharded_tracker_step(Mesh(np.array(devices), ('cluster',)),
                                        shapes, params, use_ais=True)

    def run(step, unpack):
        st, ist = tr.state, tr.init_state
        res = []
        for i in range(n_scans):
            t0 = time.perf_counter()
            st, ist, out = jax.block_until_ready(
                step(st, ist, per(scan_b, i), per(ais_b, i)))
            wall = time.perf_counter() - t0
            o = unpack(out)
            res.append(dict(
                wall=wall, obj=float(o['sel_obj']),
                feas=bool(o['sel_feasible']),
                hist=np.asarray(o['sel_hist_meas'])[:n_tgt],
                x=np.asarray(o['track_x'])[:n_tgt],
                ais=np.asarray(st.hist_ais)[np.arange(shapes.max_targets),
                                            np.asarray(st.sel_leaf),
                                            -1][:n_tgt]))
        return res

    one = run(single, lambda o: o._asdict())
    four = run(sharded, lambda o: o)
    for k, (a, b) in enumerate(zip(one, four)):
        # psum order differs from the single-device reduction order, so
        # near-tied leaves may resolve differently (the contract of
        # tests/test_sharded_swarm.py).  A target whose decision differed
        # at an earlier scan carries another track even where this
        # scan's label coincides, so states and AIS labels are compared
        # where the whole selected label history agrees.
        same = a['hist'][:, -1] == b['hist'][:, -1]
        same_hist = np.all(a['hist'] == b['hist'], axis=1)
        log(f"  scan {k}: obj {a['obj']:.4f} vs {b['obj']:.4f}, "
            f"identical labels {same.mean():.4f}, identical histories "
            f"{same_hist.mean():.4f}, feasible {b['feas']}")
        if not b['feas']:
            raise AssertionError(f"scan {k}: sharded selection infeasible")
        if abs(a['obj'] - b['obj']) > 1e-3 * (1 + abs(a['obj'])):
            raise AssertionError(f"scan {k}: objective differs")
        if same.mean() < 0.995:
            raise AssertionError(f"scan {k}: labels agree {same.mean()}")
        np.testing.assert_array_equal(a['ais'][same_hist],
                                      b['ais'][same_hist])
        np.testing.assert_allclose(a['x'][same_hist], b['x'][same_hist],
                                   atol=1e-3)
    log(f"  [{card}] one device: {[round(r['wall'], 3) for r in one]} s "
        f"per scan; {len(devices)} devices: "
        f"{[round(r['wall'], 3) for r in four]} s per scan (first "
        f"includes compile)")
    return dict(objs=[r['obj'] for r in four])


# ---------------------------------------------------------------------

def run(scale, devices, card, four=False):
    """Every phase at ``scale`` on ``devices``; raises on any failure.
    Returns the result line."""
    dev0 = devices[0]
    log(f"phase a: device_kind={dev0.device_kind!r} platform="
        f"{dev0.platform} count={len(devices)}")
    log(f"card: {card}")
    if four:
        phase_four(scale['swarm'], card, devices[:4])
        count = 4
    else:
        t0 = time.perf_counter()
        worst = phase_kernels(scale['widths'])
        log(f"phase b passed: worst err/tol {worst:.3f} "
            f"({time.perf_counter() - t0:.1f} s)")
        phase_served(scale['served'], card)
        phase_stream(scale['swarm'], card, dev0)
        count = len(devices)
    return {"ok": True, "device": {"platform": dev0.platform,
                                   "kind": dev0.device_kind,
                                   "count": count}}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the target-sharded swarm step on four "
                         "GPUs, against one")
    args = ap.parse_args(argv)
    enable_compile_cache()
    devices = require_gpu(4 if args.four else 1)
    result = run(FULL, devices, card_label(), four=args.four)
    print(json.dumps(result), flush=True)


if __name__ == "__main__":
    main()
