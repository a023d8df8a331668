"""Hypothesis-forest growth: one scan's spawn/gate/score, fully batched.

This is the batched replacement for the reference's per-target Python loop
(_growTarget + _processLeafNodes + spawnNewNodes,
/root/reference/pymht/tracker.py:309-415, pyTarget.py:227-295): predict
all leaves of all targets, gate them against all measurements, score
every (leaf, association) candidate, and keep the best ``L`` new leaves
per target (a score-based beam — the principled version of the
reference's ad-hoc node caps at tracker.py:118,918-950; with generous
``L`` it is exhaustive and exactly matches the reference tree).

Candidate layout per leaf (C = 1 + M + G*(1 + M) slots, where G =
shapes.ais_fuse_width is the compressed per-leaf AIS axis — the best G
stage-1-gated messages per leaf; g maps back to a real message index via
the ais_idx table):

* slot 0                     : zero-hypothesis (missed detection)
* slot 1 + m                 : radar measurement m
* slot 1 + M + g*(1+M)       : pure-AIS association with compressed slot g
* slot 1 + M + g*(1+M) + 1+m : compressed AIS slot g fused with radar meas m

AIS fusion follows tracker.py:417-552: two-stage Kalman update (AIS at
its own timestamp, then radar at scan time), score 0.5*nllr_ais +
0.5*nllr_radar, MMSI-consistency enforced against the track's history.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp

from ..models import pv, ais as ais_model
from ..ops import kalman as k
from .config import TrackerShapes, TrackerParams
from .state import TrackerState

BIG = jnp.float32(1e9)


class Scan(NamedTuple):
    """One radar scan, padded to M measurements."""
    z: jnp.ndarray        # [M, 2] f32
    mask: jnp.ndarray     # [M] bool
    time: jnp.ndarray     # [] f32


class AisBatch(NamedTuple):
    """AIS messages received since the previous scan, padded to A."""
    state: jnp.ndarray    # [A, 4] f32
    time: jnp.ndarray     # [A] f32
    mmsi: jnp.ndarray     # [A] i32
    high_accuracy: jnp.ndarray  # [A] bool
    mask: jnp.ndarray     # [A] bool


def empty_ais(shapes: TrackerShapes) -> AisBatch:
    A = shapes.max_ais
    return AisBatch(
        state=jnp.zeros((A, 4), jnp.float32),
        time=jnp.zeros((A,), jnp.float32),
        mmsi=jnp.zeros((A,), jnp.int32),
        high_accuracy=jnp.zeros((A,), bool),
        mask=jnp.zeros((A,), bool),
    )


class GrowOutputs(NamedTuple):
    state: TrackerState
    used_meas: jnp.ndarray   # [M] bool — gated by any active target
    gated_counts: jnp.ndarray  # [T] i32 — gated (leaf, meas) pairs per
    #   target: the per-target growth-cost proxy feeding the dynamic
    #   window (reference per-target grow TIME, tracker.py:918-928)


def _radar_candidates_einsum(state, scan, params, A_mat, Q_mat, C, R):
    """Predict + gate + score all (leaf, radar measurement) pairs —
    einsum formulation, kept as the readable parity oracle for the
    production scalar-plane path (ops.ais_fused.radar_candidates_planes;
    tests/test_ais_fused.py asserts equivalence).

    Returns per-candidate scores and the update ingredients shared by the
    selection step.
    """
    x_bar, P_bar = k.predict(A_mat, Q_mat, state.leaf_x, state.leaf_P)   # [T,L,4]
    z_hat, S, S_inv, K, P_hat = k.precalc(C, R, x_bar, P_bar)
    zt = k.residuals(scan.z, z_hat)                 # [T,L,M,2]
    nis = k.nis(zt, S_inv)                          # [T,L,M]
    gate = ((nis <= params.eta2)
            & scan.mask[None, None, :]
            & state.leaf_mask[:, :, None])
    nllr_m = k.nllr(params.lambda_ex, state.tgt_pd[:, None], S, nis)  # [T,L,M]
    return x_bar, P_bar, z_hat, S, K, P_hat, zt, nis, gate, nllr_m


def _ais_candidates(state, scan, ais, params, G=None, n_targets=None,
                    prefilter=0, z_sub=None, zmask_sub=None):
    """Two-stage AIS+radar fusion candidates (tracker.py:417-552).

    Production path: the scalar-plane formulation in ops.ais_fused
    (one fusable elementwise DAG instead of the einsum chains below,
    which remain as the readable parity oracle —
    tests/test_ais_fused.py asserts equivalence)."""
    from ..ops.ais_fused import ais_candidates_planes
    T, L = state.leaf_mask.shape
    A = ais.mask.shape[0]
    G = A if G is None else min(max(G, 1), A)
    return ais_candidates_planes(state, scan, ais, params, G,
                                 n_targets=n_targets, prefilter=prefilter,
                                 z_sub=z_sub, zmask_sub=zmask_sub)


def _ais_candidates_einsum(state, scan, ais, params, G=None):
    """Einsum/dot formulation of the two-stage fusion (parity oracle).

    Stage 1 gates each (leaf, message) pair at the message timestamp
    (full-state AIS observation, C_ais = I) and applies MMSI
    consistency; the surviving messages are then COMPRESSED to the best
    ``G`` per leaf by stage-1 NIS (shapes.ais_per_leaf) before the
    expensive stage-2 radar fusion — the stage-1 gate typically admits
    <= 1-2 messages per leaf, so this shrinks every stage-2 tensor from
    [T,L,A,M,...] to [T,L,G,M,...].

    Returns per (target, leaf, g, radar-slot) candidate scores and
    gates, plus the stage-2 ingredients (x_bar2/z_hat2/K2/P_hat2 on the
    compressed axis) from which grow() recomputes the few SELECTED fused
    states after beam selection — the [T,L,A,M,4] fused-state tensor is
    never materialised.  ``ais_idx`` maps compressed slot g back to the
    message index.
    """
    T, L = state.leaf_mask.shape
    A = ais.mask.shape[0]
    M = scan.z.shape[0]
    G = A if G is None else min(max(G, 1), A)

    # Stage 1: predict each leaf to each AIS timestamp and update with the
    # full-state AIS observation (C_ais = I).  einsum letters: t=target,
    # q=leaf, a=ais message (g after compression), m=radar measurement,
    # ijkl=matrix dims.
    dT1 = ais.time - state.time                                  # [A]
    Phi1 = pv.Phi(dT1)                                           # [A,4,4]
    Q1 = pv.Q(dT1)                                               # [A,4,4]
    x_bar1 = jnp.einsum('aij,tqj->tqai', Phi1, state.leaf_x)     # [T,L,A,4]
    P_bar1 = jnp.einsum('aij,tqjk,alk->tqail', Phi1,
                        state.leaf_P, Phi1) + Q1                 # [T,L,A,4,4]
    R1 = jax.vmap(ais_model.R)(ais.high_accuracy)                # [A,4,4]
    S1 = P_bar1 + R1                                             # C=I
    S1_inv = k.inv_psd(S1)
    zt1 = ais.state - x_bar1                                     # [T,L,A,4]
    nis1 = jnp.einsum('tqai,tqaij,tqaj->tqa', zt1, S1_inv, zt1)
    gate1 = ((nis1 <= params.eta2_ais)
             & ais.mask[None, None, :]
             & state.leaf_mask[:, :, None])                      # [T,L,A]

    # MMSI consistency (pyTarget.py:269-272): a leaf may only take an AIS
    # message whose MMSI matches the track's historical MMSI (if any).
    hist_mmsi_leaf = jnp.max(state.hist_mmsi, axis=2)            # [T,L]
    hist_mmsi_leaf = jnp.maximum(hist_mmsi_leaf, state.tgt_mmsi[:, None])
    mmsi_ok = ((hist_mmsi_leaf[:, :, None] == 0)
               | (hist_mmsi_leaf[:, :, None] == ais.mmsi[None, None, :]))
    gate1 = gate1 & mmsi_ok

    K1 = jnp.einsum('tqaij,tqajk->tqaik', P_bar1, S1_inv)
    x_hat1 = x_bar1 + jnp.einsum('tqaij,tqaj->tqai', K1, zt1)
    P_hat1 = P_bar1 - jnp.einsum('tqaij,tqajk->tqaik', K1, P_bar1)

    n_targets = jnp.sum(state.tgt_mask.astype(jnp.float32))
    radar_range = params.radar_range if math.isfinite(params.radar_range) else 1e4
    lambda_ais = (n_targets * params.P_ais) / (jnp.pi * radar_range ** 2)
    nllr1 = k.nllr(lambda_ais, 1.0, S1, nis1[..., None])[..., 0]  # [T,L,A]

    # Compress the message axis: keep the G best stage-1-gated messages
    # per leaf (all of them when G == A; identity up to ordering).
    key = jnp.where(gate1, nis1, jnp.inf)                        # [T,L,A]
    _, ais_idx = jax.lax.top_k(-key, G)                          # [T,L,G]
    tb = jnp.arange(T)[:, None, None]
    lb = jnp.arange(L)[None, :, None]
    g_ok = jnp.take_along_axis(gate1, ais_idx, axis=2)           # [T,L,G]
    x_hat1g = x_hat1[tb, lb, ais_idx]                            # [T,L,G,4]
    P_hat1g = P_hat1[tb, lb, ais_idx]                            # [T,L,G,4,4]
    nllr1g = jnp.take_along_axis(nllr1, ais_idx, axis=2)         # [T,L,G]

    # Stage 2: predict the AIS-updated state to scan time, gate + score
    # against the radar measurements.
    dT2 = scan.time - ais.time                                   # [A]
    Phi2_a = pv.Phi(dT2)                                         # [A,4,4]
    Q2_a = pv.Q(dT2)
    Phi2 = Phi2_a[ais_idx]                                       # [T,L,G,4,4]
    Q2 = Q2_a[ais_idx]
    x_bar2 = jnp.einsum('tqgij,tqgj->tqgi', Phi2, x_hat1g)       # [T,L,G,4]
    P_bar2 = jnp.einsum('tqgij,tqgjk,tqglk->tqgil',
                        Phi2, P_hat1g, Phi2) + Q2
    C = pv.C_RADAR
    R2 = pv.R_RADAR()
    z_hat2 = jnp.einsum('ij,tqgj->tqgi', C, x_bar2)              # [T,L,G,2]
    PCt = jnp.einsum('tqgij,kj->tqgik', P_bar2, C)
    S2 = jnp.einsum('ij,tqgjk->tqgik', C, PCt) + R2              # [T,L,G,2,2]
    S2_inv = k.inv_psd(S2)
    K2 = PCt @ S2_inv                                            # [T,L,G,4,2]
    P_hat2 = P_bar2 - jnp.einsum('tqgij,jk,tqgkl->tqgil', K2, C, P_bar2)
    zt2 = scan.z[None, None, None, :, :] - z_hat2[..., None, :]  # [T,L,G,M,2]
    nis2 = jnp.einsum('tqgmi,tqgij,tqgmj->tqgm', zt2, S2_inv, zt2)
    gate2 = ((nis2 <= params.eta2)
             & scan.mask[None, None, None, :]
             & g_ok[..., None])                                  # [T,L,G,M]
    nllr2 = k.nllr(params.lambda_ex, state.tgt_pd[:, None, None], S2, nis2)

    # Fused candidates: score = cnllr + 0.5*nllr1 + 0.5*nllr2
    # (tracker.py:502).  Pure-AIS candidate (no gated radar,
    # tracker.py:513-525): score = cnllr + nllr1; its state is x_bar2
    # (prediction of the AIS-updated state to scan time) and its
    # covariance the radar-UPDATED P_hat2 — the reference takes
    # P_hat_list2[0] there, and P_hat2 is measurement-independent.
    fused_score = 0.5 * nllr1g[..., None] + 0.5 * nllr2          # [T,L,G,M]
    no_radar = ~jnp.any(gate2, axis=-1)                          # [T,L,G]
    pure_gate = g_ok & no_radar
    return (g_ok, gate2, pure_gate, nllr1g, fused_score,
            x_bar2, z_hat2, K2, P_hat2, ais_idx)


def grow(state: TrackerState,
         scan: Scan,
         ais: Optional[AisBatch],
         shapes: TrackerShapes,
         params: TrackerParams,
         n_targets_global: Optional[jnp.ndarray] = None) -> GrowOutputs:
    """Advance every target's hypothesis forest by one scan.

    ``n_targets_global``: global live-target count for the AIS
    association density when the target axis is sharded (the local
    mask sum under-counts); None = local count."""
    T, L, W = state.hist_meas.shape
    M = shapes.max_meas

    # --- spatial pre-gate (shapes.radar_cand_width, round-5) ---------
    # Each target's candidate planes run over only its Km nearest
    # measurements (by distance to the selected leaf's prediction).
    # ONE input-side top_k + z gather; every downstream plane and the
    # beam top_k shrink by M/Km.  See config.py for the approximation
    # contract.
    Km = shapes.radar_cand_width
    pregate = 0 < Km < M
    if pregate:
        tb0 = jnp.arange(T)
        sel0 = jnp.clip(state.sel_leaf, 0, L - 1)
        xr = state.leaf_x[tb0, sel0]                                 # [T,4]
        dt0 = scan.time - state.time
        px = xr[:, 0] + dt0 * xr[:, 2]
        py = xr[:, 1] + dt0 * xr[:, 3]
        d2 = ((scan.z[None, :, 0] - px[:, None]) ** 2
              + (scan.z[None, :, 1] - py[:, None]) ** 2)             # [T,M]
        d2 = jnp.where(scan.mask[None, :], d2, jnp.inf)
        negd, zidx = jax.lax.top_k(-d2, Km)                          # [T,Km]
        valid_k = jnp.isfinite(negd)
        z_sub = scan.z[zidx]                                         # [T,Km,2]
        zmask_sub = scan.mask[zidx] & valid_k
        M_eff = Km
    else:
        z_sub = zmask_sub = zidx = None
        M_eff = M

    from ..ops.ais_fused import radar_candidates_planes
    (x_bar, P_bar, K, P_hat, gate, nllr_m) = radar_candidates_planes(
        state, scan, params, z_sub=z_sub, zmask_sub=zmask_sub)

    # --- candidate scores -------------------------------------------
    # slot 0: zero hypothesis; slots 1..M: radar measurements.
    zero_score = jnp.where(
        state.leaf_mask,
        state.leaf_cnllr + k.nllr_missed(state.tgt_pd)[:, None],
        BIG)                                                         # [T,L]
    meas_score = jnp.where(gate,
                           state.leaf_cnllr[:, :, None] + nllr_m,
                           BIG)                                      # [T,L,M]
    cand_scores = jnp.concatenate(
        [zero_score[:, :, None], meas_score], axis=2)                # [T,L,1+M]

    use_ais = ais is not None
    Cn_r = cand_scores.shape[2]                                      # 1 + M_eff
    if use_ais:
        G = min(shapes.ais_fuse_width, shapes.max_ais)
        (g_ok, gate2, pure_gate, nllr1g, fused_score,
         x_bar2, z_hat2, K2g, P_ais_hat, ais_idx) = _ais_candidates(
            state, scan, ais, params, G=G, n_targets=n_targets_global,
            prefilter=shapes.ais_prefilter_width,
            z_sub=z_sub, zmask_sub=zmask_sub)
        pure_score = jnp.where(pure_gate,
                               state.leaf_cnllr[:, :, None] + nllr1g, BIG)  # [T,L,G]
        fused = jnp.where(gate2,
                          state.leaf_cnllr[:, :, None, None] + fused_score,
                          BIG)                                       # [T,L,G,M_eff]
        ais_block = jnp.concatenate(
            [pure_score[..., None], fused], axis=3)                  # [T,L,G,1+M_eff]
        Cn = Cn_r + G * (1 + M_eff)
    else:
        Cn = Cn_r

    # --- beam selection: keep the best L candidates per target -------
    # Block-wise exact merge: the global top-L over [radar | ais]
    # candidates equals the top-L of (top-L(radar) ++ top-L(ais)), so
    # the radar and AIS blocks are reduced SEPARATELY and merged over
    # [T, 2L] — this avoids both materialising the concatenated
    # [T, L*(1+M)(1+G)] score tensor (~50 MB at bench shapes) and the
    # 3x-wider top_k.  Indices are remapped to the
    # unified per-leaf slot layout documented in the module docstring.
    flat_radar = cand_scores.reshape(T, L * Cn_r)
    if use_ais:
        neg_r, idx_r = jax.lax.top_k(-flat_radar, L)
        glob_r = (idx_r // Cn_r) * Cn + (idx_r % Cn_r)
        flat_ais = ais_block.reshape(T, L * G * (1 + M_eff))
        neg_a, idx_a = jax.lax.top_k(-flat_ais, L)
        W_a = G * (1 + M_eff)
        glob_a = (idx_a // W_a) * Cn + Cn_r + (idx_a % W_a)
        neg_m = jnp.concatenate([neg_r, neg_a], axis=1)              # [T,2L]
        glob_m = jnp.concatenate([glob_r, glob_a], axis=1)
        neg_top, pos = jax.lax.top_k(neg_m, L)
        top_idx = jnp.take_along_axis(glob_m, pos, axis=1)
        top_scores = -neg_top                                        # [T,L]
    else:
        # One WIDE top_k over [T, L*(1+M)].  The exact two-stage
        # alternative (per-leaf top-L over 1+M, then a [T, L*L] merge)
        # lost on the earlier accelerator because its narrow-last-dim
        # batched top_k forced the candidate planes to materialise (not
        # measured on the H100).
        neg_r, top_idx = jax.lax.top_k(-flat_radar, L)
        top_scores = -neg_r                                          # [T,L] ascending
    # Fusion firewall: when the big top_k's outputs were consumed
    # directly by the beam tail, the earlier accelerator's scheduler
    # made a slow choice at swarm shapes (T=1024, M=2048).  Forcing
    # materialisation of the [T,L] beam here pins one schedule for both
    # branches.  Whether the H100 needs it is not measured yet.
    top_scores, top_idx = jax.lax.optimization_barrier(
        (top_scores, top_idx))

    # Guaranteed feasibility spine: the reference's tree always contains
    # a zero-hypothesis child of every node (pyTarget.py:319-328), which
    # is what makes its global selection ILP always feasible.  The array
    # equivalent: force the zero-hyp child of the PREVIOUSLY SELECTED
    # leaf into the beam.  The previous selection was conflict-free and
    # N-scan pruning always keeps selected leaves, so by induction the
    # set {previous selection + missed detection} is a global feasible
    # assignment at every scan — the conflict-repair fallback.
    zero_parent = jnp.clip(state.sel_leaf, 0, L - 1)                 # [T]
    has_zero = state.leaf_mask[jnp.arange(T), zero_parent]
    zcand = zero_parent * Cn                                         # slot 0
    beam_pos = jnp.argmax(top_idx == zcand[:, None], axis=1)         # [T]
    in_beam = jnp.any(top_idx == zcand[:, None], axis=1)
    force = has_zero & ~in_beam
    # Read the zero-hypothesis score from the SMALL [T,L] plane, never
    # by indexing the concatenated [T,L,1+M] score tensor: a gather on
    # the concat forces XLA to materialise it AND breaks the fusion of
    # the candidate chain into the top_k input (~28x slower grow on CPU
    # at bench shapes; not measured on the H100).
    zscore = zero_score[jnp.arange(T), zero_parent]
    top_idx = top_idx.at[:, L - 1].set(
        jnp.where(force, zcand, top_idx[:, L - 1]))
    top_scores = top_scores.at[:, L - 1].set(
        jnp.where(force, zscore, top_scores[:, L - 1]))
    spine_leaf = jnp.where(has_zero,
                           jnp.where(force, L - 1, beam_pos), 0)

    new_mask = top_scores < BIG * 0.5
    parent = top_idx // Cn                                           # [T,L]
    slot = top_idx % Cn                                              # [T,L]

    tb = jnp.arange(T)[:, None]
    is_zero = slot == 0
    radar_m = jnp.clip(slot - 1, 0, M_eff - 1)                       # [T,L]
    if use_ais:
        ais_slot = jnp.clip(slot - (1 + M_eff), 0, G * (1 + M_eff) - 1)
        is_ais = slot >= (1 + M_eff)
        ais_g = ais_slot // (1 + M_eff)                              # [T,L]
        ais_sub = ais_slot % (1 + M_eff)                             # 0=pure, 1+m fused
        is_pure_ais = is_ais & (ais_sub == 0)
        ais_m = jnp.clip(ais_sub - 1, 0, M_eff - 1)
    # Map compressed measurement indices back to real scan indices
    # (identity when the pre-gate is off).
    if pregate:
        radar_m = jnp.take_along_axis(zidx, radar_m, axis=1)
        if use_ais:
            ais_m = jnp.take_along_axis(zidx, ais_m, axis=1)

    # --- gather new leaf states -------------------------------------
    # Every parent-indexed payload is packed into ONE [T, L, D] tensor
    # so the beam re-indexing is a single gather instead of ~10 separate
    # ones (x_bar/P_bar/K/P_hat + 5 history chains), each a kernel with
    # a fixed launch cost.  Integer
    # channels ride along bitcast to f32 (pure data movement — no
    # arithmetic ever touches the bit patterns).
    i2f = lambda a: jax.lax.bitcast_convert_type(a, jnp.float32)     # noqa: E731
    f2i = lambda a: jax.lax.bitcast_convert_type(a, jnp.int32)      # noqa: E731
    payload = jnp.concatenate([
        x_bar,                                                       # 0:4
        P_bar.reshape(T, L, 16),                                     # 4:20
        K.reshape(T, L, 8),                                          # 20:28
        P_hat.reshape(T, L, 16),                                     # 28:44
        i2f(state.hist_meas),                                        # 44:44+W
        i2f(state.hist_ais),                                         # +W
        i2f(state.hist_mmsi),                                        # +W
        state.hist_cnllr,                                            # +W
        state.hist_x.reshape(T, L, 4 * W),                           # +4W
    ], axis=2)                                                       # [T,L,44+8W]
    pp = payload[tb, parent]                                         # ONE gather
    x_bar_p = pp[:, :, 0:4]
    P_bar_p = pp[:, :, 4:20].reshape(T, L, 4, 4)
    K_p = pp[:, :, 20:28].reshape(T, L, 4, 2)
    P_radar = pp[:, :, 28:44].reshape(T, L, 4, 4)
    h0 = 44
    hist_meas_p = f2i(pp[:, :, h0:h0 + W])
    hist_ais_p = f2i(pp[:, :, h0 + W:h0 + 2 * W])
    hist_mmsi_p = f2i(pp[:, :, h0 + 2 * W:h0 + 3 * W])
    hist_cnllr_p = pp[:, :, h0 + 3 * W:h0 + 4 * W]
    hist_x_p = pp[:, :, h0 + 4 * W:h0 + 8 * W].reshape(T, L, W, 4)

    # Residual of the selected candidate, recomputed directly (cheaper
    # than carrying/gathering the [T,L,M,2] residual tensor, which the
    # plane path never materialises).
    zt_p = scan.z[radar_m] - x_bar_p[..., :2]                        # [T,L,2]
    x_radar = x_bar_p + jnp.einsum('tlij,tlj->tli', K_p, zt_p,
                                   precision=k.HIGHEST)

    new_x = jnp.where(is_zero[..., None], x_bar_p, x_radar)
    new_P = jnp.where(is_zero[..., None, None], P_bar_p, P_radar)
    new_meas_label = jnp.where(is_zero, 0, radar_m + 1)
    new_ais_label = jnp.zeros((T, L), jnp.int32)
    new_mmsi_label = jnp.zeros((T, L), jnp.int32)

    if use_ais:
        # Recompute the selected fused states from the compressed
        # stage-2 ingredients — only [T,L] gathers, never the full
        # [T,L,G,M,4] fused-state tensor.  Same single-gather packing
        # over the [T,L,G] compressed axis.
        apayload = jnp.concatenate([
            x_bar2,                                                  # 0:4
            K2g.reshape(T, L, G, 8),                                 # 4:12
            z_hat2,                                                  # 12:14
            P_ais_hat.reshape(T, L, G, 16),                          # 14:30
            i2f(ais_idx)[..., None],                                 # 30
        ], axis=3)                                                   # [T,L,G,31]
        ap = apayload[tb, parent, ais_g]                             # ONE gather
        x_p = ap[:, :, 0:4]
        K_f = ap[:, :, 4:12].reshape(T, L, 4, 2)
        zt_f = scan.z[ais_m] - ap[:, :, 12:14]
        x_f = x_p + jnp.einsum('tlij,tlj->tli', K_f, zt_f,
                               precision=k.HIGHEST)
        P_f = ap[:, :, 14:30].reshape(T, L, 4, 4)
        # Map the compressed slot back to the real AIS message index.
        ais_a = f2i(ap[:, :, 30])                                    # [T,L]
        new_x = jnp.where(is_ais[..., None],
                          jnp.where(is_pure_ais[..., None], x_p, x_f), new_x)
        new_P = jnp.where(is_ais[..., None, None], P_f, new_P)
        new_meas_label = jnp.where(is_ais,
                                   jnp.where(is_pure_ais, 0, ais_m + 1),
                                   new_meas_label)
        new_ais_label = jnp.where(is_ais, ais_a + 1, new_ais_label)
        new_mmsi_label = jnp.where(is_ais, ais.mmsi[ais_a], new_mmsi_label)

    new_meas_label = jnp.where(new_mask, new_meas_label, -1)

    # --- roll history one column left, write the new column ---------
    # The gathered history is already parent-aligned; rolling is a
    # W-slice + concat of the new column (fusable data movement, no
    # second gather).
    def shift_append(hist_p, col, fill):
        rolled = jnp.concatenate([hist_p[:, :, 1:], col[:, :, None]],
                                 axis=2)
        return jnp.where(new_mask[:, :, None], rolled, fill)

    hist_meas = shift_append(hist_meas_p, new_meas_label, -1)
    hist_ais = shift_append(hist_ais_p, new_ais_label, 0)
    hist_mmsi = shift_append(hist_mmsi_p, new_mmsi_label, 0)
    hist_cnllr = shift_append(hist_cnllr_p, top_scores, 0.0)
    hx = jnp.concatenate([hist_x_p[:, :, 1:], new_x[:, :, None]], axis=2)
    hist_x = jnp.where(new_mask[:, :, None, None], hx, 0.0)

    # Roll the warm-started selection duals with the window: prices of
    # the oldest scan's slots retire, the new scan's slots start at 0.
    per_col = M + shapes.max_ais
    lam = jnp.roll(state.lam.reshape(W, per_col), -1, axis=0)
    lam = lam.at[-1].set(0.0).reshape(-1)

    new_state = state.replace(
        lam=lam,
        spine_leaf=spine_leaf,
        leaf_x=jnp.where(new_mask[..., None], new_x, 0.0),
        leaf_P=jnp.where(new_mask[..., None, None], new_P, 0.0),
        leaf_cnllr=jnp.where(new_mask, top_scores, 0.0),
        leaf_mask=new_mask & state.tgt_mask[:, None],
        hist_meas=hist_meas,
        hist_ais=hist_ais,
        hist_mmsi=hist_mmsi,
        hist_cnllr=hist_cnllr,
        hist_x=hist_x,
        tgt_depth=jnp.where(state.tgt_mask,
                            jnp.minimum(state.tgt_depth + 1, W),
                            state.tgt_depth),
        scan_idx=state.scan_idx + 1,
        time=scan.time,
    )

    if pregate:
        # scatter the compressed gate back to the [M] axis (one scatter
        # per scan — not in any loop body)
        any_l = jnp.any(gate, axis=1)                                # [T,Km]
        scat = jnp.where(any_l, zidx, M)
        used = jnp.zeros((M + 1,), bool).at[scat.reshape(-1)].set(
            True)[:M]
    else:
        used = jnp.any(gate, axis=(0, 1))                            # [M]
    gated_counts = jnp.sum(gate.astype(jnp.int32), axis=(1, 2))      # [T]
    return GrowOutputs(state=new_state, used_meas=used,
                       gated_counts=gated_counts)
