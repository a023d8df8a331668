"""m/n track initiation, fully batched on device.

Mirrors the reference Initiator pipeline
(/root/reference/pymht/initiators/m_of_n.py:215-478):

1. preliminary tracks are predicted, AIS-seeded prelims inserted (NIS
   dedup), measurements gated (chi2 df=2) and assigned by GNN
   (auction_assign replaces the external munkres), assigned tracks get a
   KF update and m += 1, every track n += 1, then m/n analysis confirms
   (m >= M) or kills (n >= N with m < M, or speed > 1.5*v_max);
2. measurements unclaimed by prelims pair with the previous scan's
   one-point initiators (distance GNN, gate v_max*dt) and spawn new
   prelims with two-point velocity initialisation + NIS dedup;
3. everything still unclaimed becomes the next scan's initiators.

State is a fixed-capacity SoA; confirmed tracks are emitted as padded
arrays for the tracker to insert (duplicate-neighbour merging happens
there, mirroring _merge_similar_targets + haveNoNeightbours).
"""
from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp

from ..models import pv, ais as ais_model
from ..ops import kalman as k
from ..ops.assignment import auction_assign
from ..utils.pytree import pytree_dataclass
from .config import TrackerShapes, TrackerParams
from .grow import AisBatch


@pytree_dataclass
class InitiatorState:
    # Preliminary tracks
    p_x: jnp.ndarray       # [P, 4]
    p_P: jnp.ndarray       # [P, 4, 4]
    p_m: jnp.ndarray       # [P] i32 — hits
    p_n: jnp.ndarray       # [P] i32 — checks
    p_mask: jnp.ndarray    # [P] bool
    p_mmsi: jnp.ndarray    # [P] i32
    p_meas_idx: jnp.ndarray  # [P] i32 — last assigned measurement
    # One-point initiators (previous scan's leftovers)
    i_pos: jnp.ndarray     # [I, 2]
    i_mask: jnp.ndarray    # [I] bool
    last_time: jnp.ndarray  # [] f32
    has_time: jnp.ndarray   # [] bool


class InitiatorOutputs(NamedTuple):
    state: InitiatorState
    new_x: jnp.ndarray     # [P, 4] confirmed target states
    new_P: jnp.ndarray     # [P, 4, 4]
    new_mask: jnp.ndarray  # [P] bool
    new_mmsi: jnp.ndarray  # [P] i32


def empty_initiator(shapes: TrackerShapes) -> InitiatorState:
    P, I = shapes.max_prelim, shapes.max_initiators
    return InitiatorState(
        p_x=jnp.zeros((P, 4), jnp.float32),
        p_P=jnp.zeros((P, 4, 4), jnp.float32),
        p_m=jnp.zeros((P,), jnp.int32),
        p_n=jnp.zeros((P,), jnp.int32),
        p_mask=jnp.zeros((P,), bool),
        p_mmsi=jnp.zeros((P,), jnp.int32),
        p_meas_idx=jnp.full((P,), -1, jnp.int32),
        i_pos=jnp.zeros((I, 2), jnp.float32),
        i_mask=jnp.zeros((I,), bool),
        last_time=jnp.asarray(0.0, jnp.float32),
        has_time=jnp.asarray(False),
    )


def _insert_rows(dst_mask, src_mask):
    """Map the k-th valid source row to the k-th free destination slot.
    Returns (take [D] bool, src_idx [D] i32)."""
    D = dst_mask.shape[0]
    free = ~dst_mask
    slot_rank = jnp.cumsum(free.astype(jnp.int32)) - 1
    src_rank = jnp.cumsum(src_mask.astype(jnp.int32)) - 1
    match = (free[:, None] & src_mask[None, :]
             & (slot_rank[:, None] == src_rank[None, :]))
    return match.any(axis=1), jnp.argmax(match, axis=1)


def _nis_dedup(cand_x, cand_mask, pool_x, pool_P, pool_mask,
               threshold: float = 1.0):
    """Reference compareSimilarity (m_of_n.py:196-201): NIS between a
    candidate state and each existing prelim with S = P + R_ais(low);
    candidates too close to any existing prelim are dropped."""
    S = pool_P + ais_model.R(False)                         # [P,4,4]
    S_inv = k.inv_psd(S)
    d = cand_x[:, None, :] - pool_x[None, :, :]             # [K,P,4]
    nis = jnp.einsum('kpi,pij,kpj->kp', d, S_inv, d, precision=k.HIGHEST)
    close = (nis <= threshold) & pool_mask[None, :]
    return cand_mask & ~close.any(axis=1)


def step(state: InitiatorState,
         z: jnp.ndarray, z_mask: jnp.ndarray, time,
         ais: AisBatch,
         shapes: TrackerShapes, params: TrackerParams) -> InitiatorOutputs:
    P = shapes.max_prelim
    I = shapes.max_initiators
    M = z.shape[0]
    C = pv.C_RADAR
    R = pv.R_RADAR()
    gamma = params.gamma_initiator

    # -- 1a. predict preliminary tracks ------------------------------
    dt = jnp.where(state.has_time, time - state.last_time,
                   jnp.asarray(params.radar_period, jnp.float32))
    F, Q = pv.Phi(dt), pv.Q(dt)
    p_x, p_P = k.predict(F, Q, state.p_x, state.p_P)
    p_x = jnp.where(state.p_mask[:, None], p_x, 0.0)
    p_P = jnp.where(state.p_mask[:, None, None], p_P, 0.0)
    st = state.replace(p_x=p_x, p_P=p_P)

    # -- 1b. AIS-seeded prelims (m_of_n.py:262-278) ------------------
    dTa = time - ais.time                                   # [A]
    PhiA = pv.Phi(dTa)
    QA = pv.Q(dTa)
    ax = jnp.einsum('aij,aj->ai', PhiA, ais.state, precision=k.HIGHEST)
    aP = jnp.einsum('aij,jk,alk->ail', PhiA, pv.P0, PhiA,
                    precision=k.HIGHEST) + QA               # AIS_message.predict
    a_new = ais.mask & ~jnp.isin(ais.mmsi, jnp.where(st.p_mask, st.p_mmsi, -1))
    a_new = _nis_dedup(ax, a_new, st.p_x, st.p_P, st.p_mask)
    take, src = _insert_rows(st.p_mask, a_new)
    st = st.replace(
        p_x=jnp.where(take[:, None], ax[src], st.p_x),
        p_P=jnp.where(take[:, None, None], aP[src], st.p_P),
        p_m=jnp.where(take, 0, st.p_m),
        p_n=jnp.where(take, 0, st.p_n),
        p_mmsi=jnp.where(take, ais.mmsi[src], st.p_mmsi),
        p_meas_idx=jnp.where(take, -1, st.p_meas_idx),
        p_mask=st.p_mask | take,
    )

    # -- 1c. gate + GNN assign measurements to prelims ---------------
    z_hat, S, S_inv, K, P_hat = k.precalc(C, R, st.p_x, st.p_P)
    zt = k.residuals(z, z_hat)                              # [P,M,2]
    nis = k.nis(zt, S_inv)                                  # [P,M]
    dist = jnp.linalg.norm(zt, axis=2)
    gate = (nis <= gamma) & z_mask[None, :] & st.p_mask[:, None]
    # max_iters is a LATENCY budget (the auction runs inside the per-scan
    # jit; per-iteration cost on the H100 not measured).  Cardinality
    # stays exact past the cap via augmentation; only contested-tie cost
    # refinement is truncated.
    assign = auction_assign(dist, gate, max_iters=48)       # [P] -> meas or -1
    assigned = assign >= 0
    am = jnp.clip(assign, 0, M - 1)
    x_upd = st.p_x + jnp.einsum('pij,pj->pi', K, zt[jnp.arange(P), am],
                                precision=k.HIGHEST)
    st = st.replace(
        p_x=jnp.where(assigned[:, None], x_upd, st.p_x),
        p_P=jnp.where(assigned[:, None, None], P_hat, st.p_P),
        p_m=st.p_m + assigned.astype(jnp.int32),
        p_n=st.p_n + st.p_mask.astype(jnp.int32),
        p_meas_idx=jnp.where(assigned, assign, -1),
    )
    meas_claimed = jnp.zeros((M,), bool).at[
        jnp.where(assigned, assign, M)].set(True, mode='drop')

    # -- 1d. m/n analysis --------------------------------------------
    speed = jnp.linalg.norm(st.p_x[:, 2:4], axis=1)
    too_fast = speed > params.max_speed * 1.5
    confirmed = st.p_mask & (st.p_m >= params.M_required) & ~too_fast
    dead = st.p_mask & (too_fast
                        | ((st.p_n >= params.N_checks)
                           & (st.p_m < params.M_required)))
    new_x = st.p_x
    new_P = st.p_P
    new_mask = confirmed
    new_mmsi = jnp.where(confirmed, st.p_mmsi, 0)
    st = st.replace(p_mask=st.p_mask & ~(confirmed | dead))

    # -- 2. pair unclaimed measurements with previous initiators -----
    un1 = z_mask & ~meas_claimed                            # [M]
    d_init = jnp.linalg.norm(z[None, :, :] - st.i_pos[:, None, :], axis=2)
    gate_d = params.max_speed * dt
    gate2 = (d_init <= gate_d) & un1[None, :] & st.i_mask[:, None] \
        & state.has_time
    # Optimal GNN pairing, matching the reference's exact Munkres solve
    # (m_of_n.py:380-413); the auction converges in a few rounds for the
    # spatially-separated common case but resolves contested pairings
    # optimally where greedy would not.
    assign2 = auction_assign(d_init, gate2, max_iters=48)   # [I] -> meas or -1
    paired = assign2 >= 0
    am2 = jnp.clip(assign2, 0, M - 1)
    # two-point velocity init (m_of_n.py:455-463)
    vel = (z[am2] - st.i_pos) / jnp.maximum(dt, 1e-6)
    cand_x = jnp.concatenate([z[am2], vel], axis=1)         # [I, 4]
    cand_ok = _nis_dedup(cand_x, paired, st.p_x, st.p_P, st.p_mask)
    take2, src2 = _insert_rows(st.p_mask, cand_ok)
    st = st.replace(
        p_x=jnp.where(take2[:, None], cand_x[src2], st.p_x),
        p_P=jnp.where(take2[:, None, None], pv.P0, st.p_P),
        p_m=jnp.where(take2, 0, st.p_m),
        p_n=jnp.where(take2, 0, st.p_n),
        p_mmsi=jnp.where(take2, 0, st.p_mmsi),
        p_meas_idx=jnp.where(take2, -1, st.p_meas_idx),
        p_mask=st.p_mask | take2,
    )
    meas_claimed = meas_claimed.at[
        jnp.where(paired, assign2, M)].set(True, mode='drop')

    # -- 3. leftovers become next scan's initiators ------------------
    un2 = z_mask & ~meas_claimed
    take3, src3 = _insert_rows(jnp.zeros((I,), bool), un2)
    st = st.replace(
        i_pos=jnp.where(take3[:, None], z[src3], 0.0),
        i_mask=take3,
        last_time=jnp.asarray(time, jnp.float32),
        has_time=jnp.asarray(True),
    )

    return InitiatorOutputs(state=st, new_x=new_x, new_P=new_P,
                            new_mask=new_mask, new_mmsi=new_mmsi)
