"""Fusion-friendly scalar-plane formulation of the AIS two-stage fusion.

The einsum/dot formulation of the AIS candidate stages
(tracker.py:417-552 in the reference; grow._ais_candidates_einsum here)
lowers to dozens of small batched dot_generals and gathers, each a
separate kernel launch, dwarfing the actual FLOPs.  Here the whole chain
is expressed as scalar *planes* (one array per matrix entry, broadcast
over the batch axes): every 4x4 predict / Schur inverse / NIS / NLLR
becomes a pure elementwise expression DAG that XLA fuses into a handful
of kernels, with no matrix product (so no TF32 rounding either).

Structure (exact same math as ops.kalman inv4x4/det4x4/nllr and
models.pv.Phi/Q, reordered but formula-identical):

* stage-1 sweep over [T,L,A]: predict-to-message-time covariance,
  4x4 block-Schur NIS + gate ONLY (no update math for unselected
  messages);
* compression: lax.top_k by gated NIS -> the G best messages per leaf
  (nis rides back via the top_k values, so nothing else is gathered
  from the [T,L,A] pass — per-message scalars come from one packed
  [A,8] table gather);
* [T,L,G] recompute: stage-1 update (x_hat1, P_hat1, det S1, nllr1)
  for the selected messages only — 16x fewer elements than the old
  full-A update einsums;
* stage-2 sweep: closed-form CV re-predict to scan time, 2x2 innovation
  inverse, all-measurements NIS/score planes [T,L,G,M], and the
  selected-candidate ingredients (K2, P_hat2) as planes.

Reference parity: pymht/tracker.py:417-552 (two-stage fusion),
kalman.py:7-22 (nllr), pv.py:17-34 (Phi/Q conventions incl. the T^3/3
off-diagonal).
"""
from __future__ import annotations

import math

import jax
import jax.numpy as jnp

from ..models import pv, ais as ais_model

_LOG2PI = float(math.log(2.0 * math.pi))
BIG = jnp.float32(1e9)


def _pred_cov_planes(g, T, q):
    """Planes of Phi(T) P Phi(T)^T + Q(T, q) for CV pairs (0,2),(1,3).

    ``g(i,j)`` returns the P_{ij} plane; ``T`` is a per-element plane;
    ``q`` the process-noise scale.  Matches models.pv.Phi/Q exactly
    (incl. the reference's T^3/3 off-diagonal convention, pv.py:17-23).
    """
    T2 = T * T
    T3 = T2 * T / 3.0
    T4 = T2 * T2 / 4.0
    pb = {}
    for (a, b) in ((0, 2), (1, 3)):
        pb[(a, a)] = g(a, a) + T * (g(a, b) + g(b, a)) + T2 * g(b, b) + T4 * q
        pb[(a, b)] = g(a, b) + T * g(b, b) + T3 * q
        pb[(b, a)] = g(b, a) + T * g(b, b) + T3 * q
        pb[(b, b)] = g(b, b) + T2 * q
    pb[(0, 1)] = g(0, 1) + T * (g(0, 3) + g(2, 1)) + T2 * g(2, 3)
    pb[(1, 0)] = g(1, 0) + T * (g(1, 2) + g(3, 0)) + T2 * g(3, 2)
    pb[(0, 3)] = g(0, 3) + T * g(2, 3)
    pb[(3, 0)] = g(3, 0) + T * g(3, 2)
    pb[(1, 2)] = g(1, 2) + T * g(3, 2)
    pb[(2, 1)] = g(2, 1) + T * g(2, 3)
    pb[(2, 3)] = g(2, 3)
    pb[(3, 2)] = g(3, 2)
    return pb


def _schur4(s):
    """Block-Schur pieces of a 4x4 matrix given entry planes s[(i,j)].

    Returns (inv, det): inv[(i,j)] planes of the inverse, det plane.
    Same factorisation as ops.kalman.inv4x4/det4x4.
    """
    detA = s[(0, 0)] * s[(1, 1)] - s[(0, 1)] * s[(1, 0)]
    rA = 1.0 / detA
    ia = {(0, 0): s[(1, 1)] * rA, (0, 1): -s[(0, 1)] * rA,
          (1, 0): -s[(1, 0)] * rA, (1, 1): s[(0, 0)] * rA}
    # CA = C invA,  E = invA B
    ca = {}
    e = {}
    for i in range(2):
        for j in range(2):
            ca[(i, j)] = (s[(2 + i, 0)] * ia[(0, j)]
                          + s[(2 + i, 1)] * ia[(1, j)])
            e[(i, j)] = (ia[(i, 0)] * s[(0, 2 + j)]
                         + ia[(i, 1)] * s[(1, 2 + j)])
    # M = D - CA B
    m = {}
    for i in range(2):
        for j in range(2):
            m[(i, j)] = (s[(2 + i, 2 + j)]
                         - (ca[(i, 0)] * s[(0, 2 + j)]
                            + ca[(i, 1)] * s[(1, 2 + j)]))
    detM = m[(0, 0)] * m[(1, 1)] - m[(0, 1)] * m[(1, 0)]
    rM = 1.0 / detM
    im = {(0, 0): m[(1, 1)] * rM, (0, 1): -m[(0, 1)] * rM,
          (1, 0): -m[(1, 0)] * rM, (1, 1): m[(0, 0)] * rM}
    # F = E invM
    f = {}
    for i in range(2):
        for j in range(2):
            f[(i, j)] = e[(i, 0)] * im[(0, j)] + e[(i, 1)] * im[(1, j)]
    inv = {}
    for i in range(2):
        for j in range(2):
            inv[(i, j)] = (ia[(i, j)] + f[(i, 0)] * ca[(0, j)]
                           + f[(i, 1)] * ca[(1, j)])
            inv[(i, 2 + j)] = -f[(i, j)]
            inv[(2 + i, j)] = -(im[(i, 0)] * ca[(0, j)]
                                + im[(i, 1)] * ca[(1, j)])
            inv[(2 + i, 2 + j)] = im[(i, j)]
    return inv, detA * detM


def _quad4(inv, zt):
    """zt^T inv zt for zt planes (zt[0..3])."""
    acc = 0.0
    for i in range(4):
        yi = sum(inv[(i, j)] * zt[j] for j in range(4))
        acc = acc + zt[i] * yi
    return acc


def ais_candidates_planes(state, scan, ais, params, G, n_targets=None,
                          prefilter=0, z_sub=None, zmask_sub=None):
    """Drop-in replacement for grow._ais_candidates (same return tuple).

    state: TrackerState; scan: Scan; ais: AisBatch; G: compressed width.
    ``n_targets`` overrides the live-target count entering the AIS
    association density lambda_ais — REQUIRED under target sharding,
    where the local ``sum(tgt_mask)`` is only this shard's count and
    would bias every AIS association score by log(global/local)
    (sharded_tracker.py psums it).  Default: local count (single-chip).

    ``prefilter`` (shapes.ais_prefilter_width): when 0 < prefilter < A,
    the exact 4x4 Schur/NIS stage-1 sweep runs on only the ``Gp =
    max(prefilter, G)`` best messages per leaf under a PROVABLE lower
    bound on the stage-1 NIS — for PSD S, z'S^-1 z >= |z|^2/lambda_max
    >= |z|^2/trace(S), so any message whose bound exceeds eta2_ais is
    exactly ungated and its exclusion is lossless.  The only
    approximation is the top-Gp truncation when MORE than Gp messages
    pass the conservative bound for one leaf — same controlled
    score-beam class as ``ais_per_leaf`` itself (the reference fuses
    every stage-1-gated message, tracker.py:417-552).

    Off by default: on the earlier accelerator the mid-chain
    gather/top_k pair fragmented XLA's fusion of the AIS DAG and the
    prefilter lost despite cutting the [T,L,A] Schur DAG 16x in
    elements (not measured on the H100).  Decision parity is tested
    (tests/test_ais_fused.py::test_prefilter_matches_exact_sweep).

    Returns (g_ok, gate2, pure_gate, nllr1g, fused_score,
             x_bar2, z_hat2, K2, P_hat2, ais_idx).
    """
    T, L = state.leaf_mask.shape
    A = ais.mask.shape[0]
    M = scan.z.shape[0]
    from ..models.constants import sigmaQ_tracker
    q = float(sigmaQ_tracker)                 # sigmaQ scale (Q = kernel*q)
    r_hi = ais_model.sigmaR_AIS_true_highAccuracy ** 2
    r_lo = ais_model.sigmaR_AIS_true_lowAccuracy ** 2

    # ---- per-message scalar table (ONE gather after compression) -----
    dT1 = ais.time - state.time                                   # [A]
    r_a = jnp.where(ais.high_accuracy, r_hi, r_lo).astype(jnp.float32)
    table = jnp.stack([dT1, r_a, ais.state[:, 0], ais.state[:, 1],
                       ais.state[:, 2], ais.state[:, 3],
                       ais.time.astype(jnp.float32),
                       jnp.zeros((A,), jnp.float32)], axis=1)      # [A,8]

    P = state.leaf_P                                              # [T,L,4,4]
    x = state.leaf_x                                              # [T,L,4]

    # MMSI consistency (pyTarget.py:269-272)
    hist_mmsi_leaf = jnp.max(state.hist_mmsi, axis=2)
    hist_mmsi_leaf = jnp.maximum(hist_mmsi_leaf, state.tgt_mmsi[:, None])
    mmsi_ok = ((hist_mmsi_leaf[:, :, None] == 0)
               | (hist_mmsi_leaf[:, :, None] == ais.mmsi[None, None, :]))

    def _stage1_nis_planes(dtg, rg, sg):
        """Exact stage-1 NIS on a compressed [T,L,K] message axis with
        per-element dt/r/message-state planes.  Returns (nis, pb, inv,
        det, xb) so callers can reuse the pieces."""
        gP = lambda i, j: P[:, :, i, j][:, :, None]        # noqa: E731
        pb = _pred_cov_planes(gP, dtg, q)
        s = dict(pb)
        for i in range(4):
            s[(i, i)] = pb[(i, i)] + rg
        inv, det = _schur4(s)
        K = dtg.shape[2]
        xb = [x[:, :, 0][:, :, None] + dtg * x[:, :, 2][:, :, None],
              x[:, :, 1][:, :, None] + dtg * x[:, :, 3][:, :, None],
              jnp.broadcast_to(x[:, :, 2][:, :, None], (T, L, K)),
              jnp.broadcast_to(x[:, :, 3][:, :, None], (T, L, K))]
        zt = [sg[k] - xb[k] for k in range(4)]
        nis = _quad4(inv, zt)
        return nis, det

    if 0 < prefilter < A:
        Gp = min(max(prefilter, G), A)
        # cheap conservative sweep: bound = |zt|^2 / trace(S) <= NIS
        dt1 = dT1[None, None, :]                                  # [1,1,A]
        t2 = dt1 * dt1
        p = lambda i, j: P[:, :, i, j][:, :, None]          # noqa: E731
        tr = (p(0, 0) + dt1 * (p(0, 2) + p(2, 0)) + t2 * p(2, 2)
              + p(1, 1) + dt1 * (p(1, 3) + p(3, 1)) + t2 * p(3, 3)
              + p(2, 2) + p(3, 3)
              + (t2 * t2 / 2.0 + 2.0 * t2) * q
              + 4.0 * r_a[None, None, :])                         # trace(S)
        ztb = [ais.state[None, None, :, 0]
               - (x[:, :, 0][:, :, None] + dt1 * x[:, :, 2][:, :, None]),
               ais.state[None, None, :, 1]
               - (x[:, :, 1][:, :, None] + dt1 * x[:, :, 3][:, :, None]),
               ais.state[None, None, :, 2] - x[:, :, 2][:, :, None],
               ais.state[None, None, :, 3] - x[:, :, 3][:, :, None]]
        z2 = sum(zz * zz for zz in ztb)
        bound = z2 / tr                                           # [T,L,A]
        okb = ((bound <= params.eta2_ais)
               & ais.mask[None, None, :]
               & state.leaf_mask[:, :, None] & mmsi_ok)
        keyb = jnp.where(okb, bound, jnp.inf)
        _, idxp = jax.lax.top_k(-keyb, Gp)                        # [T,L,Gp]
        validp = jnp.take_along_axis(okb, idxp, axis=2)
        tabp = table[idxp]                                        # [T,L,Gp,8]
        nis_p, _ = _stage1_nis_planes(tabp[..., 0], tabp[..., 1],
                                      [tabp[..., 2 + k]
                                       for k in range(4)])
        gate_p = validp & (nis_p <= params.eta2_ais)
        key2 = jnp.where(gate_p, nis_p, jnp.inf)
        negk, sel2 = jax.lax.top_k(-key2, G)                      # [T,L,G]
        nis1g = -negk
        g_ok = jnp.isfinite(nis1g)
        ais_idx = jnp.take_along_axis(idxp, sel2, axis=2)         # [T,L,G]
    else:
        # ---- exact stage-1 sweep over the full [T,L,A] axis ----------
        nis1, _ = _stage1_nis_planes(
            dT1[None, None, :], r_a[None, None, :],
            [ais.state[None, None, :, k] for k in range(4)])
        gate1 = ((nis1 <= params.eta2_ais)
                 & ais.mask[None, None, :]
                 & state.leaf_mask[:, :, None] & mmsi_ok)
        # ---- compression: best G gated messages per leaf by NIS ------
        key = jnp.where(gate1, nis1, jnp.inf)                     # [T,L,A]
        if G <= 4:
            # G-pass iterated argmin instead of lax.top_k: identical
            # selection (both break ties by lowest index), but pure
            # masked reductions that fuse with the NIS producer (not
            # measured on the H100).
            idxs, vals = [], []
            for _ in range(G):
                i = jnp.argmin(key, axis=2)
                vals.append(jnp.min(key, axis=2))
                idxs.append(i)
                key = jnp.where(jax.nn.one_hot(i, A, dtype=bool),
                                jnp.inf, key)
            nis1g = jnp.stack(vals, axis=2)                       # [T,L,G]
            ais_idx = jnp.stack(idxs, axis=2)
        else:
            negk, ais_idx = jax.lax.top_k(-key, G)                # [T,L,G]
            nis1g = -negk
        g_ok = jnp.isfinite(nis1g)

    tab = table[ais_idx]                                          # [T,L,G,8]
    dtg = tab[..., 0]
    rg = tab[..., 1]
    sg = [tab[..., 2 + k] for k in range(4)]                      # msg state
    msg_time = tab[..., 6]

    # ---- [T,L,G] stage-1 update for the selected messages ------------
    def g2(i, j):
        return P[:, :, i, j][:, :, None]                          # [T,L,1]

    pbg = _pred_cov_planes(g2, dtg, q)
    s1g = dict(pbg)
    for i in range(4):
        s1g[(i, i)] = pbg[(i, i)] + rg
    invg, detg = _schur4(s1g)
    xbg = [x[:, :, 0][:, :, None] + dtg * x[:, :, 2][:, :, None],
           x[:, :, 1][:, :, None] + dtg * x[:, :, 3][:, :, None],
           jnp.broadcast_to(x[:, :, 2][:, :, None], (T, L, G)),
           jnp.broadcast_to(x[:, :, 3][:, :, None], (T, L, G))]
    ztg = [sg[k] - xbg[k] for k in range(4)]
    # y = S^-1 zt; x_hat1 = x_bar1 + P_bar1 y;
    # P_hat1 = P_bar1 - P_bar1 S^-1 P_bar1
    y = [sum(invg[(i, j)] * ztg[j] for j in range(4)) for i in range(4)]
    xh = [xbg[i] + sum(pbg[(i, j)] * y[j] for j in range(4))
          for i in range(4)]
    w = {}
    for i in range(4):
        for j in range(4):
            w[(i, j)] = sum(invg[(i, k)] * pbg[(k, j)] for k in range(4))
    ph = {}
    for i in range(4):
        for j in range(4):
            ph[(i, j)] = pbg[(i, j)] - sum(pbg[(i, k)] * w[(k, j)]
                                           for k in range(4))

    if n_targets is None:
        n_targets = jnp.sum(state.tgt_mask.astype(jnp.float32))
    radar_range = (params.radar_range
                   if math.isfinite(params.radar_range) else 1e4)
    lambda_ais = (n_targets * params.P_ais) / (jnp.pi * radar_range ** 2)
    log_lam_ais = jnp.log(jnp.maximum(lambda_ais, 1e-20))
    nllr1g = (0.5 * nis1g + log_lam_ais
              + 0.5 * (4.0 * _LOG2PI
                       + jnp.log(jnp.maximum(detg, 1e-30))))      # [T,L,G]

    # ---- stage-2: re-predict to scan time, 2x2 gate + score ----------
    dt2 = scan.time - msg_time                                    # [T,L,G]

    def gph(i, j):
        return ph[(i, j)]

    pb2 = _pred_cov_planes(gph, dt2, q)
    xb2 = [xh[0] + dt2 * xh[2], xh[1] + dt2 * xh[3], xh[2], xh[3]]
    r2 = float(pv.sigmaR_RADAR_tracker) ** 2
    s11 = pb2[(0, 0)] + r2
    s12 = pb2[(0, 1)]
    s21 = pb2[(1, 0)]
    s22 = pb2[(1, 1)] + r2
    det2 = s11 * s22 - s12 * s21
    rdet = 1.0 / det2
    i11 = s22 * rdet
    i12 = -s12 * rdet
    i21 = -s21 * rdet
    i22 = s11 * rdet
    ioff = i12 + i21

    if z_sub is None:
        zx = scan.z[:, 0][None, None, None, :]                    # [1,1,1,M]
        zy = scan.z[:, 1][None, None, None, :]
        m_mask = scan.mask[None, None, None, :]
    else:
        # per-target compressed measurement axis (see
        # radar_candidates_planes): [T,1,1,Km] broadcast over L, G
        zx = z_sub[:, None, None, :, 0]
        zy = z_sub[:, None, None, :, 1]
        m_mask = zmask_sub[:, None, None, :]
    dx = zx - xb2[0][..., None]                                   # [T,L,G,M]
    dy = zy - xb2[1][..., None]
    nis2 = (i11[..., None] * dx * dx + ioff[..., None] * dx * dy
            + i22[..., None] * dy * dy)
    gate2 = ((nis2 <= params.eta2)
             & m_mask
             & g_ok[..., None])
    lambda_ex = jnp.maximum(jnp.asarray(params.lambda_ex, jnp.float32),
                            1e-20)
    pd = state.tgt_pd[:, None, None]                              # [T,1,1]
    log_term2 = (jnp.log(lambda_ex)
                 + 0.5 * (2.0 * _LOG2PI
                          + jnp.log(jnp.maximum(det2, 1e-30)))
                 - jnp.log(pd))
    nllr2 = 0.5 * nis2 + log_term2[..., None]
    fused_score = 0.5 * nllr1g[..., None] + 0.5 * nllr2           # [T,L,G,M]
    no_radar = ~jnp.any(gate2, axis=-1)
    pure_gate = g_ok & no_radar

    # ---- selected-candidate ingredients as stacked planes ------------
    # K2 = P_bar2 C^T S2^-1 (C picks rows 0,1); P_hat2 = P_bar2 - K C P_bar2
    k2 = {}
    for i in range(4):
        k2[(i, 0)] = pb2[(i, 0)] * i11 + pb2[(i, 1)] * i21
        k2[(i, 1)] = pb2[(i, 0)] * i12 + pb2[(i, 1)] * i22
    ph2 = {}
    for i in range(4):
        for j in range(4):
            ph2[(i, j)] = pb2[(i, j)] - (k2[(i, 0)] * pb2[(0, j)]
                                         + k2[(i, 1)] * pb2[(1, j)])

    x_bar2 = jnp.stack(xb2, axis=-1)                              # [T,L,G,4]
    z_hat2 = jnp.stack([xb2[0], xb2[1]], axis=-1)                 # [T,L,G,2]
    K2 = jnp.stack(
        [jnp.stack([k2[(i, 0)], k2[(i, 1)]], axis=-1) for i in range(4)],
        axis=-2)                                                  # [T,L,G,4,2]
    P_hat2 = jnp.stack(
        [jnp.stack([ph2[(i, j)] for j in range(4)], axis=-1)
         for i in range(4)], axis=-2)                             # [T,L,G,4,4]

    return (g_ok, gate2, pure_gate, nllr1g, fused_score,
            x_bar2, z_hat2, K2, P_hat2, ais_idx)


def radar_candidates_planes(state, scan, params, z_sub=None,
                            zmask_sub=None):
    """Scalar-plane twin of grow._radar_candidates_einsum (same math:
    CV predict + 2x2 innovation precalc + all-pairs NIS/NLLR/gate),
    returning (x_bar, P_bar, K, P_hat, gate, nllr_m) — the subset grow
    actually consumes.  ~5 fewer dot-kernel launches per scan than the
    einsum form.

    ``z_sub [T, Km, 2]`` / ``zmask_sub [T, Km]``: optional PER-TARGET
    compressed measurement axis (shapes.radar_cand_width spatial
    pre-gate) — the planes then run over [T, L, Km] instead of
    [T, L, M].  The gather happens at the INPUT side (z only), so the
    plane DAG stays one fusable chain (the round-3/4 lesson: mid-chain
    gathers fragment fusion and lose)."""
    T, L = state.leaf_mask.shape
    from ..models.constants import sigmaQ_tracker
    q = float(sigmaQ_tracker)
    dt = scan.time - state.time                                   # scalar

    P = state.leaf_P
    x = state.leaf_x

    def g(i, j):
        return P[:, :, i, j]                                      # [T,L]

    pb = _pred_cov_planes(g, dt, q)
    xb = [x[:, :, 0] + dt * x[:, :, 2], x[:, :, 1] + dt * x[:, :, 3],
          x[:, :, 2], x[:, :, 3]]
    r2 = float(pv.sigmaR_RADAR_tracker) ** 2
    s11 = pb[(0, 0)] + r2
    s12 = pb[(0, 1)]
    s21 = pb[(1, 0)]
    s22 = pb[(1, 1)] + r2
    det = s11 * s22 - s12 * s21
    rdet = 1.0 / det
    i11 = s22 * rdet
    i12 = -s12 * rdet
    i21 = -s21 * rdet
    i22 = s11 * rdet
    ioff = i12 + i21

    if z_sub is None:
        zx = scan.z[:, 0][None, None, :]                          # [1,1,M]
        zy = scan.z[:, 1][None, None, :]
        m_mask = scan.mask[None, None, :]
    else:
        zx = z_sub[:, None, :, 0]                                 # [T,1,Km]
        zy = z_sub[:, None, :, 1]
        m_mask = zmask_sub[:, None, :]
    dx = zx - xb[0][..., None]                                    # [T,L,M]
    dy = zy - xb[1][..., None]
    nis = (i11[..., None] * dx * dx + ioff[..., None] * dx * dy
           + i22[..., None] * dy * dy)
    gate = ((nis <= params.eta2)
            & m_mask
            & state.leaf_mask[:, :, None])
    lambda_ex = jnp.maximum(jnp.asarray(params.lambda_ex, jnp.float32),
                            1e-20)
    pd = state.tgt_pd[:, None]                                    # [T,1]
    log_term = (jnp.log(lambda_ex)
                + 0.5 * (2.0 * _LOG2PI
                         + jnp.log(jnp.maximum(det, 1e-30)))
                - jnp.log(pd))
    nllr_m = 0.5 * nis + log_term[..., None]

    k = {}
    for i in range(4):
        k[(i, 0)] = pb[(i, 0)] * i11 + pb[(i, 1)] * i21
        k[(i, 1)] = pb[(i, 0)] * i12 + pb[(i, 1)] * i22
    ph = {}
    for i in range(4):
        for j in range(4):
            ph[(i, j)] = pb[(i, j)] - (k[(i, 0)] * pb[(0, j)]
                                       + k[(i, 1)] * pb[(1, j)])

    x_bar = jnp.stack(xb, axis=-1)                                # [T,L,4]
    P_bar = jnp.stack(
        [jnp.stack([pb[(i, j)] for j in range(4)], axis=-1)
         for i in range(4)], axis=-2)                             # [T,L,4,4]
    K = jnp.stack(
        [jnp.stack([k[(i, 0)], k[(i, 1)]], axis=-1) for i in range(4)],
        axis=-2)                                                  # [T,L,4,2]
    P_hat = jnp.stack(
        [jnp.stack([ph[(i, j)] for j in range(4)], axis=-1)
         for i in range(4)], axis=-2)                             # [T,L,4,4]
    return x_bar, P_bar, K, P_hat, gate, nllr_m
