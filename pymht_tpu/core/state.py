"""Struct-of-arrays tracker state.

The reference keeps each target as a Python tree of ``Target`` nodes with
parent pointers (/root/reference/pymht/pyTarget.py:14-40).  Here the whole
forest lives in padded device arrays: a hypothesis *leaf* is one row of the
leaf table, and its ancestry is not a pointer chain but a label history —
``hist_meas``/``hist_ais``/``hist_mmsi`` columns aligned so that column
``W-1`` is the current scan for every target.  The tree is a trie of
association labels, so leaves-with-histories represent it losslessly for
every operation the tracker needs (scoring, A1/A2 assembly, N-scan
pruning, backtracking).

Encodings:

* ``hist_meas``: -1 = no scan (padding), 0 = zero-hypothesis / missed
  detection (reference measurementNumber == 0), m >= 1 = radar
  measurement index m-1 of that scan (reference measurementNumber == m).
  A pure-AIS node (reference measurementNumber is None) is 0 with a
  nonzero ``hist_ais`` slot.
* ``hist_ais``: 0 = none, a >= 1 = AIS message slot a-1 of that scan.
* ``hist_mmsi``: 0 = none, else the MMSI identity (fits int32).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

from .config import TrackerShapes, TrackerParams
from ..utils.pytree import pytree_dataclass


@pytree_dataclass
class TrackerState:
    # Leaf table ------------------------------------------------------
    leaf_x: jnp.ndarray       # [T, L, 4] f32 — leaf state estimate
    leaf_P: jnp.ndarray       # [T, L, 4, 4] f32 — leaf covariance
    leaf_cnllr: jnp.ndarray   # [T, L] f32 — cumulative NLLR since birth
    leaf_mask: jnp.ndarray    # [T, L] bool
    # Label history window (col W-1 == current scan) ------------------
    hist_meas: jnp.ndarray    # [T, L, W] i32
    hist_ais: jnp.ndarray     # [T, L, W] i32
    hist_mmsi: jnp.ndarray    # [T, L, W] i32
    hist_cnllr: jnp.ndarray   # [T, L, W] f32 — cnllr after each scan
    hist_x: jnp.ndarray       # [T, L, W, 4] f32 — state after each scan
    # Per-target ------------------------------------------------------
    tgt_mask: jnp.ndarray     # [T] bool — active target
    tgt_id: jnp.ndarray       # [T] i32 — external track id (-1 free slot)
    tgt_root_cnllr: jnp.ndarray  # [T] f32 — cnllr at window root
    tgt_depth: jnp.ndarray    # [T] i32 — valid history columns
    tgt_window: jnp.ndarray   # [T] i32 — per-target dynamic N
    tgt_pd: jnp.ndarray       # [T] f32
    tgt_mmsi: jnp.ndarray     # [T] i32 — MMSI confirmed before the window
    sel_leaf: jnp.ndarray     # [T] i32 — selected (global-best) leaf
    # Index of this scan's feasibility spine: the zero-hypothesis child
    # of the previously selected leaf, forced into the beam by grow.
    # The spine set across targets is always mutually conflict-free
    # (previous selection feasibility + no new association), so conflict
    # repair can always retreat to it.  Valid between grow and select.
    spine_leaf: jnp.ndarray   # [T] i32
    # Globals ---------------------------------------------------------
    scan_idx: jnp.ndarray     # [] i32 — number of scans processed
    time: jnp.ndarray         # [] f32 — time of last processed scan
    next_id: jnp.ndarray     # [] i32 — next track id to assign
    # Warm-started dual prices for the selection Lagrangian, one per
    # single-use slot [W*(M+A)]; rolled with the history window each
    # scan so scan-persistent conflicts keep their prices.
    lam: jnp.ndarray          # [W*(M+A)] f32


def empty_state(shapes: TrackerShapes, params: TrackerParams) -> TrackerState:
    T, L, W = shapes.max_targets, shapes.max_leaves, shapes.window
    f32, i32 = jnp.float32, jnp.int32
    return TrackerState(
        leaf_x=jnp.zeros((T, L, 4), f32),
        leaf_P=jnp.zeros((T, L, 4, 4), f32),
        leaf_cnllr=jnp.zeros((T, L), f32),
        leaf_mask=jnp.zeros((T, L), bool),
        hist_meas=jnp.full((T, L, W), -1, i32),
        hist_ais=jnp.zeros((T, L, W), i32),
        hist_mmsi=jnp.zeros((T, L, W), i32),
        hist_cnllr=jnp.zeros((T, L, W), f32),
        hist_x=jnp.zeros((T, L, W, 4), f32),
        tgt_mask=jnp.zeros((T,), bool),
        tgt_id=jnp.full((T,), -1, i32),
        tgt_root_cnllr=jnp.zeros((T,), f32),
        tgt_depth=jnp.zeros((T,), i32),
        tgt_window=jnp.full((T,), params.N, i32),
        tgt_pd=jnp.full((T,), params.P_d, f32),
        tgt_mmsi=jnp.zeros((T,), i32),
        sel_leaf=jnp.zeros((T,), i32),
        spine_leaf=jnp.zeros((T,), i32),
        scan_idx=jnp.asarray(0, i32),
        time=jnp.asarray(0.0, f32),
        next_id=jnp.asarray(0, i32),
        lam=jnp.zeros((W * (shapes.max_meas + shapes.max_ais),), f32),
    )


def shrink_beam(state: TrackerState, new_L: int) -> TrackerState:
    """Re-shape the forest to a narrower hypothesis beam (static L ->
    new_L), keeping each target's best ``new_L`` live leaves by
    cumulative NLLR with the currently selected leaf forced in.

    This is the state half of COMPUTE-SHEDDING degradation (reference
    __dynamicWindow, tracker.py:918-950: the point of shrinking the
    window is to keep a scan inside the radar period).  Shrinking
    ``tgt_window`` under static shapes narrows the surviving hypothesis
    set but cannot reduce FLOPs; switching the step to a compiled
    variant with half the beam actually sheds ~L/2 of grow's candidate
    work and L/2 of every selection tensor.  Between scans leaf indices
    are stable (grow rebuilds the beam; prune only masks), so the
    conversion is one gather; ``sel_leaf`` is remapped so the next
    grow's feasibility spine (zero-child of the previous selection)
    stays intact.
    """
    T, L, W = state.hist_meas.shape
    assert new_L <= L, (new_L, L)
    if new_L == L:
        return state
    tb = jnp.arange(T)
    sel = jnp.clip(state.sel_leaf, 0, L - 1)
    sel_live = state.leaf_mask[tb, sel]
    key = jnp.where(state.leaf_mask, state.leaf_cnllr, jnp.inf)
    is_sel = (jnp.arange(L)[None, :] == sel[:, None]) & sel_live[:, None]
    key = jnp.where(is_sel, -jnp.inf, key)                 # selected first
    _, keep = jax.lax.top_k(-key, new_L)                   # [T, new_L]
    take2 = lambda a: jnp.take_along_axis(a, keep, axis=1)
    new_sel = jnp.argmax(keep == sel[:, None], axis=1)
    new_sel = jnp.where(sel_live, new_sel, 0)
    return state.replace(
        leaf_x=jnp.take_along_axis(state.leaf_x, keep[..., None], axis=1),
        leaf_P=jnp.take_along_axis(state.leaf_P, keep[..., None, None],
                                   axis=1),
        leaf_cnllr=take2(state.leaf_cnllr),
        leaf_mask=take2(state.leaf_mask),
        hist_meas=jnp.take_along_axis(state.hist_meas, keep[..., None],
                                      axis=1),
        hist_ais=jnp.take_along_axis(state.hist_ais, keep[..., None],
                                     axis=1),
        hist_mmsi=jnp.take_along_axis(state.hist_mmsi, keep[..., None],
                                      axis=1),
        hist_cnllr=jnp.take_along_axis(state.hist_cnllr, keep[..., None],
                                       axis=1),
        hist_x=jnp.take_along_axis(state.hist_x,
                                   keep[..., None, None], axis=1),
        sel_leaf=new_sel,
        spine_leaf=new_sel,
    )


def expand_beam(state: TrackerState, new_L: int) -> TrackerState:
    """Inverse conversion: widen the beam back to ``new_L`` (padding
    with dead leaves).  Leaf order is preserved, so sel_leaf is
    unchanged."""
    T, L, W = state.hist_meas.shape
    assert new_L >= L, (new_L, L)
    if new_L == L:
        return state
    pad = new_L - L

    def padl(a, fill):
        shape = (T, pad) + a.shape[2:]
        return jnp.concatenate(
            [a, jnp.full(shape, fill, a.dtype)], axis=1)

    return state.replace(
        leaf_x=padl(state.leaf_x, 0.0),
        leaf_P=padl(state.leaf_P, 0.0),
        leaf_cnllr=padl(state.leaf_cnllr, 0.0),
        leaf_mask=padl(state.leaf_mask, False),
        hist_meas=padl(state.hist_meas, -1),
        hist_ais=padl(state.hist_ais, 0),
        hist_mmsi=padl(state.hist_mmsi, 0),
        hist_cnllr=padl(state.hist_cnllr, 0.0),
        hist_x=padl(state.hist_x, 0.0),
    )


def insert_targets(state: TrackerState,
                   new_x: jnp.ndarray,       # [K, 4]
                   new_P: jnp.ndarray,       # [K, 4, 4]
                   new_mask: jnp.ndarray,    # [K] bool
                   new_mmsi: jnp.ndarray,    # [K] i32 (0 = none)
                   time: jnp.ndarray,
                   params: TrackerParams,
                   new_ids: jnp.ndarray = None) -> TrackerState:
    """Initiate up to K new targets into free slots (masked, fixed-shape).

    Mirrors Tracker.initiateTarget (/root/reference/pymht/tracker.py:147-158):
    each new target becomes a single root-leaf with cnllr 0 and a fresh id
    (or an explicit id from ``new_ids`` — used by the target-sharded step,
    where ids must be globally unique across shards).
    Neighbourhood rejection is the caller's responsibility.
    """
    T, L = state.leaf_mask.shape
    K = new_x.shape[0]

    free = ~state.tgt_mask                               # [T]
    # Rank free slots and new targets; new target k -> k-th free slot.
    slot_rank = jnp.cumsum(free.astype(jnp.int32)) - 1   # [T] rank among free
    new_rank = jnp.cumsum(new_mask.astype(jnp.int32)) - 1  # [K]
    # For each target slot, which new target lands there (-1 = none).
    # slot t gets new target k iff free[t] and new_rank[k] == slot_rank[t].
    match = (free[:, None]
             & new_mask[None, :]
             & (slot_rank[:, None] == new_rank[None, :]))  # [T, K]
    take = match.any(axis=1)                              # [T]
    src = jnp.argmax(match, axis=1)                       # [T] index into K

    x_in = new_x[src]                                     # [T, 4]
    P_in = new_P[src]
    mmsi_in = new_mmsi[src]

    leaf_x = jnp.where(take[:, None, None],
                       jnp.zeros_like(state.leaf_x).at[:, 0].set(x_in),
                       state.leaf_x)
    leaf_P = jnp.where(take[:, None, None, None],
                       jnp.zeros_like(state.leaf_P).at[:, 0].set(P_in),
                       state.leaf_P)
    leaf_cnllr = jnp.where(take[:, None], 0.0, state.leaf_cnllr)
    first = jnp.zeros((T, L), bool).at[:, 0].set(True)
    leaf_mask = jnp.where(take[:, None], first, state.leaf_mask)

    hist_meas = jnp.where(take[:, None, None], -1, state.hist_meas)
    hist_ais = jnp.where(take[:, None, None], 0, state.hist_ais)
    hist_mmsi = jnp.where(take[:, None, None], 0, state.hist_mmsi)
    hist_cnllr = jnp.where(take[:, None, None], 0.0, state.hist_cnllr)
    hist_x = jnp.where(take[:, None, None, None], 0.0, state.hist_x)

    n_new = jnp.sum(new_mask.astype(jnp.int32))
    ids_in = (state.next_id + slot_rank) if new_ids is None \
        else new_ids[src]
    ids = jnp.where(take, ids_in, state.tgt_id)

    # The inserted states are valid at ``time``: advance the forest clock
    # so the next grow predicts them by the correct dt.  (During a scan,
    # insertion happens at the scan time the forest already carries; at
    # pre-initialization this seeds the clock.)
    new_time = jnp.maximum(state.time, jnp.asarray(time, jnp.float32))

    return state.replace(
        time=new_time,
        leaf_x=leaf_x, leaf_P=leaf_P, leaf_cnllr=leaf_cnllr,
        leaf_mask=leaf_mask, hist_meas=hist_meas, hist_ais=hist_ais,
        hist_mmsi=hist_mmsi, hist_cnllr=hist_cnllr, hist_x=hist_x,
        tgt_mask=state.tgt_mask | take,
        tgt_id=ids,
        tgt_root_cnllr=jnp.where(take, 0.0, state.tgt_root_cnllr),
        tgt_depth=jnp.where(take, 0, state.tgt_depth),
        tgt_window=jnp.where(take, params.N, state.tgt_window),
        tgt_pd=jnp.where(take, params.P_d, state.tgt_pd),
        tgt_mmsi=jnp.where(take, mmsi_in, state.tgt_mmsi),
        sel_leaf=jnp.where(take, 0, state.sel_leaf),
        spine_leaf=jnp.where(take, 0, state.spine_leaf),
        next_id=state.next_id + n_new,
    )
