"""Global hypothesis selection over the forest arrays.

Covers the reference's cluster + optimise phases
(/root/reference/pymht/tracker.py:961-1217): build the measurement-usage
structure (A1), the one-leaf-per-target structure (A2) and the score
vector (C) directly from the history arrays, then pick one leaf per
target minimising total score subject to single-use measurements.

The production solver (``method='lagrangian'``) is a tiered hybrid that
mirrors the reference's per-cluster decomposition
(/root/reference/pymht/tracker.py:961-1027) with fixed shapes:

* tier 0 — if the per-target independent optima are conflict-free they
  are the global optimum (reference singleton clusters,
  tracker.py:228-233); no solver runs.
* tier 1 — singleton clusters take their argmin leaf (exact).
* tier 2 — clusters of 2..4 targets are gathered into padded buckets
  and solved by batched exhaustive enumeration over each member's top-C
  leaves (exact on the candidate sets, one fixed-shape tensor op — no
  sequential loop).  This replaces the reference's per-cluster CBC ILP
  (tracker.py:1155-1217) for the common case.
* tier 3 — larger clusters fall back to a matrix-free Lagrangian
  subgradient loop restricted to their targets, warm-started from duals
  carried across scans.  Exact tiers 1-2 contribute zero gap, so the
  convergence test only has to close the big-cluster gap.

Two further solvers are kept for parity/debug:

* ``ipm``             — dense assembly + interior-point LP with
                        truncated branch-and-bound (ops/lp.py).
* ``lagrangian_pure`` — the tier-3 loop applied to the whole forest.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp

from ..ops import lp as lp_ops
from .config import TrackerShapes, TrackerParams
from .state import TrackerState

BIG = jnp.float32(1e4)

# Tier-2 enumeration limits (static): clusters up to K_ENUM targets are
# solved exactly over each member's best C_ENUM leaves.
K_ENUM = 4
C_ENUM = 16

# Debug-only: run data-dependent branches eagerly (Python if/while) so
# host tools can count loop iterations.  Never set inside jit.
EAGER_DEBUG = False


def _cond(pred, true_fn, false_fn, operand):
    if EAGER_DEBUG:
        return true_fn(operand) if bool(pred) else false_fn(operand)
    return jax.lax.cond(pred, true_fn, false_fn, operand)


class SelectionResult(NamedTuple):
    sel: jnp.ndarray        # [T] selected leaf per target
    feasible: jnp.ndarray   # [] bool
    obj: jnp.ndarray        # [] selected total score
    bound: jnp.ndarray      # [] lower bound (gap certificate)
    labels: jnp.ndarray     # [T] cluster label per target
    n_clusters: jnp.ndarray  # [] number of clusters
    lam: jnp.ndarray        # [S] final dual prices (warm start carrier)


# ----------------------------------------------------------------------
# Usage encoding helpers
# ----------------------------------------------------------------------

def _slot_index(state: TrackerState, shapes: TrackerShapes):
    """Map each (leaf, window column) to a global single-use slot id.

    Radar measurement m at column w -> w*(M+A) + m; AIS message a at
    column w -> w*(M+A) + M + a; no-usage -> slot S (a dump slot).
    Returns (slots [T,L,W,2], n_slots) where the last axis carries the
    radar slot and the AIS slot of that column (a fused node uses both,
    exactly like the reference's A1 which adds a radar row *and* an AIS
    row for a fused hypothesis, tracker.py:1047-1064).
    """
    T, L, W = state.hist_meas.shape
    M, A = shapes.max_meas, shapes.max_ais
    per_col = M + A
    n_slots = W * per_col
    w_ids = jnp.arange(W)[None, None, :]
    radar_slot = jnp.where(state.hist_meas >= 1,
                           w_ids * per_col + (state.hist_meas - 1),
                           n_slots)
    ais_slot = jnp.where(state.hist_ais >= 1,
                         w_ids * per_col + M + (state.hist_ais - 1),
                         n_slots)
    slots = jnp.stack([radar_slot, ais_slot], axis=-1)    # [T,L,W,2]
    return slots, n_slots


# Above this many virtual elements in the dense-compare formulation,
# _hist_usage switches to the scatter build: the dense DAG does
# T*L*W*(M+A) compare-ops (13e9 at T=8192/M=16k — measured ~130 ms of
# the round-5 select probe) while the scatter writes only T*L*W
# indices (~786k, one ~400us scatter op).  At bench/swarm scale the
# dense form stays faster (few-hundred-us fused chain vs the scatter's
# fixed op cost) — the round-2/3 cost-model rule, which this threshold
# encodes instead of hard-coding either choice.
_USAGE_DENSE_LIMIT = 1 << 29


def _hist_usage(state: TrackerState, shapes: TrackerShapes,
                tgt_filter=None):
    """Per-target slot-usage tensor [T, W, M+A] (bool): does any live
    leaf of target t associate radar measurement m (column block
    [0, M)) or AIS message a (block [M, M+A)) at window column w?

    Slot ordering matches ``_slot_index`` (slot id = w*(M+A) + block
    offset).  Formulation switches on problem size (see
    _USAGE_DENSE_LIMIT)."""
    T, L, W = state.hist_meas.shape
    M, A = shapes.max_meas, shapes.max_ais
    live = state.leaf_mask
    if tgt_filter is not None:
        live = live & tgt_filter[:, None]
    if T * L * W * (M + A) <= _USAGE_DENSE_LIMIT:
        um = ((state.hist_meas[..., None] == jnp.arange(1, M + 1))
              & live[:, :, None, None]).any(axis=1)        # [T, W, M]
        ua = ((state.hist_ais[..., None] == jnp.arange(1, A + 1))
              & live[:, :, None, None]).any(axis=1)        # [T, W, A]
        return jnp.concatenate([um, ua], axis=2)           # [T, W, M+A]
    P = M + A
    n = T * W * P
    base = ((jnp.arange(T)[:, None, None] * W
             + jnp.arange(W)[None, None, :]) * P)          # [T,1,W]
    live3 = live[:, :, None]
    mi = jnp.where((state.hist_meas >= 1) & live3,
                   base + state.hist_meas - 1, n)          # [T,L,W]
    ai = jnp.where((state.hist_ais >= 1) & live3,
                   base + M + state.hist_ais - 1, n)
    out = jnp.zeros((n + 1,), bool)
    out = out.at[mi.reshape(-1)].set(True)
    out = out.at[ai.reshape(-1)].set(True)
    return out[:n].reshape(T, W, P)


def target_usage(state: TrackerState, shapes: TrackerShapes):
    """[T, n_slots] bool: does any live leaf of target t use slot s?"""
    use = _hist_usage(state, shapes)
    T, W, P = use.shape
    return use.reshape(T, W * P), W * P


# ----------------------------------------------------------------------
# Clustering (reference tracker.py:961-974)
# ----------------------------------------------------------------------

# Sized with headroom over the contested counts seen so far: the
# T=8192 saturation scene has 1081 contested slots — at 1024 the cap
# overflowed and every scan silently paid the full [T, n_slots]
# fallback matmul (~13 TFLOP at T=8192).  2048 keeps the compact
# matmul at ~137 GMAC.
CLUSTER_COMPACT_CAP = 2048


def _slot_flat_labels(state: TrackerState, shapes: TrackerShapes):
    """Flat slot id per (leaf, window column) for radar and AIS labels:
    w*(M+A) + (m-1) / w*(M+A) + M + (a-1); invalid -> n (= W*(M+A)).
    Small [T, L, W] integer tensors — never [T, n_slots]."""
    T, L, W = state.hist_meas.shape
    M, A = shapes.max_meas, shapes.max_ais
    P = M + A
    n = W * P
    base = jnp.arange(W)[None, None, :] * P                # [1,1,W]
    live3 = state.leaf_mask[:, :, None]
    mi = jnp.where((state.hist_meas >= 1) & live3,
                   base + state.hist_meas - 1, n)          # [T,L,W]
    ai = jnp.where((state.hist_ais >= 1) & live3,
                   base + M + state.hist_ais - 1, n)
    return mi, ai, n


def _contested_minmax(state: TrackerState, shapes: TrackerShapes,
                      tgt_filter=None):
    """EXACT per-slot contestedness without materialising any
    [T, n_slots] tensor (the round-5 T=16384 enabler: that tensor hits
    3.2e9 elements there): scatter the min and the max target id using
    each slot over [n_slots] buffers; a slot is used by >= 2 DISTINCT
    targets iff min < max.  Returns (contested [n_slots] bool,
    used [n_slots] bool)."""
    T, L, W = state.hist_meas.shape
    mi, ai, n = _slot_flat_labels(state, shapes)
    if tgt_filter is not None:
        keep = tgt_filter[:, None, None]
        mi = jnp.where(keep, mi, n)
        ai = jnp.where(keep, ai, n)
    tid = jnp.broadcast_to(jnp.arange(T)[:, None, None], mi.shape)
    tid_flat = tid.reshape(-1)
    mn = jnp.full((n + 1,), T, jnp.int32)
    mx = jnp.full((n + 1,), -1, jnp.int32)
    for idx in (mi, ai):
        f = idx.reshape(-1)
        mn = mn.at[f].min(tid_flat)
        mx = mx.at[f].max(tid_flat)
    used = mx[:n] >= 0
    return (mn[:n] < mx[:n]), used


def _compact_rank(contested, cap):
    """[S+1] map: flat slot id -> compact column (< cap) or the dump
    column ``cap`` (uncontested / beyond-cap / invalid-slot id S)."""
    S = contested.shape[0]
    r = jnp.cumsum(contested.astype(jnp.int32)) - 1
    rank = jnp.where(contested & (r < cap), r, cap)
    return jnp.concatenate([rank, jnp.asarray([cap], jnp.int32)])


def _compact_usage(state: TrackerState, shapes: TrackerShapes,
                   rank_pad, cap, tgt_filter=None):
    """[T, cap] f32: does any live leaf of target t use compact
    contested column c?  Built by ONE 2D scatter per label family from
    the [T, L, W] flat-slot tensors — never a [T, n_slots] array."""
    T, L, W = state.hist_meas.shape
    mi, ai, n = _slot_flat_labels(state, shapes)
    if tgt_filter is not None:
        keep = tgt_filter[:, None, None]
        mi = jnp.where(keep, mi, n)
        ai = jnp.where(keep, ai, n)
    tids = jnp.broadcast_to(jnp.arange(T)[:, None, None],
                            mi.shape).reshape(-1)
    uc = jnp.zeros((T, cap + 1), jnp.float32)
    for idx in (mi, ai):
        cols = rank_pad[idx.reshape(-1)]
        uc = uc.at[tids, cols].set(1.0)
    return uc[:, :cap]


def cluster(state: TrackerState, shapes: TrackerShapes, usage=None):
    """Connected components of the target–measurement sharing graph via
    min-label propagation with pointer jumping (log-depth convergence
    even for chain-shaped clusters).

    The adjacency "targets t,u share >=1 slot" only ever involves
    CONTESTED slots (used by >=2 distinct targets — sharing IS being
    contested), so the usage matrix is compacted to the contested
    columns before the matmul: [T, C] x [C, T] with
    C = CLUSTER_COMPACT_CAP instead of [T, n_slots] (at T=8192 /
    n_slots=98k: 13 TFLOP -> 137 GMAC).  When more than C slots are
    contested the exact full matmul runs instead (lax.cond).

    Two formulations by size (the dense compares were chosen where the
    earlier accelerator made scatters ms-class; not measured on the
    H100): below the [T, n_slots]
    int32 addressing wall, contestedness/compaction come from the
    dense usage tensor; above it (T=16384+), from exact
    min/max-target-id scatters (_contested_minmax) with the compact
    adjacency truncated to the first C contested slots on overflow
    (documented degradation: cluster SPLITS can then occur, never
    merges)."""
    T, L, W = state.hist_meas.shape
    M, A = shapes.max_meas, shapes.max_ais
    S = W * (M + A)
    CAPc = min(CLUSTER_COMPACT_CAP, S)
    if T * S <= (1 << 31):
        use = _hist_usage(state, shapes) if usage is None else usage
        useb = use.reshape(T, -1)                          # [T, S] bool
        cnt = useb.sum(axis=0)                             # int32
        contested = cnt >= 2
        n_cont = contested.sum()
        slot_ids = jnp.where(contested, jnp.arange(S), S)
        idx = jnp.sort(slot_ids)[:CAPc]                    # [CAPc]
        # stay bool until after the gather: the f32 cast of [T, S] is
        # 4x the memory and only the overflow fallback needs it
        uc = (jnp.take(useb, jnp.clip(idx, 0, S - 1), axis=1)
              & (idx < S)[None, :]).astype(jnp.float32)    # [T, CAPc]

        def adj_compact(_):
            return (uc @ uc.T) > 0

        def adj_full(_):
            usef = useb.astype(jnp.float32)
            return (usef @ usef.T) > 0

        adj = _cond(n_cont <= CAPc, adj_compact, adj_full, None)
    else:
        contested, _ = _contested_minmax(state, shapes)
        rank_pad = _compact_rank(contested, CAPc)
        uc = _compact_usage(state, shapes, rank_pad, CAPc)  # [T, CAPc]
        adj = (uc @ uc.T) > 0
    adj = adj & state.tgt_mask[:, None] & state.tgt_mask[None, :]
    adj = adj | (jnp.eye(T, dtype=bool) & state.tgt_mask[:, None])

    labels0 = jnp.where(state.tgt_mask, jnp.arange(T), T)

    def body(carry):
        labels, _ = carry
        neigh = jnp.where(adj, labels[None, :], T)
        new = jnp.minimum(labels, jnp.min(neigh, axis=1))
        # pointer jump: adopt the label of your current label target
        lab_pad = jnp.concatenate([new, jnp.asarray([T])])
        new = jnp.minimum(new, lab_pad[jnp.clip(new, 0, T)])
        return new, jnp.any(new != labels)

    def cond(carry):
        return carry[1]

    labels, _ = jax.lax.while_loop(cond, body, (labels0, jnp.asarray(True)))
    is_root = state.tgt_mask & (labels == jnp.arange(T))
    return labels, jnp.sum(is_root.astype(jnp.int32))


def cluster_sizes(labels: jnp.ndarray, tgt_mask: jnp.ndarray):
    """[T] member count of each target's cluster (0 for inactive)."""
    same = (labels[:, None] == labels[None, :]) & tgt_mask[None, :]
    return jnp.where(tgt_mask, same.sum(axis=1).astype(jnp.int32), 0)


# ----------------------------------------------------------------------
# Scores (reference _createC, tracker.py:1124-1136)
# ----------------------------------------------------------------------

def leaf_scores(state: TrackerState, params: TrackerParams):
    f = (state.leaf_cnllr - state.tgt_root_cnllr[:, None]) / params.N
    return jnp.where(state.leaf_mask, f, BIG)


# ----------------------------------------------------------------------
# Dense IPM path
# ----------------------------------------------------------------------

def select_ipm(state: TrackerState, shapes: TrackerShapes,
               params: TrackerParams, budget: int = 8) -> SelectionResult:
    T, L, W = state.hist_meas.shape
    slots, n_slots = _slot_index(state, shapes)
    n = T * L

    # A_in [n_slots, n]: leaf uses slot — scatter, not one-hot (a dense
    # one-hot over slots is O(T*L*W*S) memory).
    s = jnp.where(state.leaf_mask[..., None, None], slots, n_slots)
    col = jnp.arange(n).reshape(T, L)[..., None, None]     # [T,L,1,1]
    flat_idx = (col * (n_slots + 1) + s).reshape(-1)
    A_in = jnp.zeros((n * (n_slots + 1),), jnp.float32).at[flat_idx].set(1.0)
    A_in = A_in.reshape(n, n_slots + 1)[:, :n_slots].T     # [S, n]
    # Keep every slot used by at least one leaf: within-target conflicts
    # across the window matter too (a measurement may be claimed by two
    # different targets' histories at different tree depths).
    in_mask = A_in.sum(axis=1) > 0.5

    A_eq = jax.nn.one_hot(jnp.arange(n) // L, T, dtype=jnp.float32).T
    f = leaf_scores(state, params).reshape(n)
    var_mask = state.leaf_mask.reshape(n)
    # Inactive targets: equality row must stay satisfiable -> allow their
    # leaf 0 as a dummy with zero cost.
    dummy = (~state.tgt_mask)[:, None] & (jnp.arange(L) == 0)[None, :]
    var_mask = var_mask | dummy.reshape(n)
    f = jnp.where(dummy.reshape(n), 0.0, f)

    sel, feas, obj, bound = lp_ops.solve_ilp(
        f, A_eq, jnp.ones((T,), jnp.float32),
        A_in, jnp.ones((n_slots,), jnp.float32),
        var_mask, jnp.ones((T,), bool), in_mask,
        T, L, state.tgt_mask | ~state.tgt_mask, budget=budget)
    # (tgt_mask passed as all-true so dummy leaves keep eq rows feasible;
    # scores of inactive targets are 0 so they do not affect the
    # objective.)
    labels, n_clusters = cluster(state, shapes)
    return SelectionResult(sel=sel, feasible=feas, obj=obj, bound=bound,
                           labels=labels, n_clusters=n_clusters,
                           lam=state.lam)


# ----------------------------------------------------------------------
# Tier 2: batched exact enumeration of small clusters
# ----------------------------------------------------------------------

def _candidate_sets(state: TrackerState, f: jnp.ndarray, C: int):
    """Top-C leaves per target by score, with the feasibility spine leaf
    forced into the set (so the all-spines combo is always available).

    Also returns ``excl_lb`` [T]: a lower bound on the score of every
    leaf OUTSIDE the candidate set (= the C-th best score; +inf when the
    target has <= C live leaves, i.e. no truncation).  Used to keep the
    tier-2 gap certificate sound under candidate truncation."""
    T, L = f.shape
    topv, topi = jax.lax.top_k(-f, C)                      # [T,C]
    spine = jnp.clip(state.spine_leaf, 0, L - 1)
    in_set = jnp.any(topi == spine[:, None], axis=1)
    topi = topi.at[:, C - 1].set(
        jnp.where(in_set, topi[:, C - 1], spine))
    n_live = state.leaf_mask.sum(axis=1)                   # [T]
    excl_lb = jnp.where(n_live > C, -topv[:, C - 1],
                        jnp.asarray(jnp.inf, jnp.float32))
    return topi, excl_lb                                   # [T,C], [T]


def _enum_small_clusters(state: TrackerState, f: jnp.ndarray,
                         slots_flat: jnp.ndarray, n_slots: int,
                         labels: jnp.ndarray, small: jnp.ndarray,
                         C: int = C_ENUM):
    """Exact batched solve of all clusters with 2..K_ENUM members.

    Gathers each small cluster into a padded bucket of K_ENUM members
    (dummy-padded), restricts each member to its top-C leaves (+spine),
    and enumerates all C^K combinations with pairwise slot-conflict
    masks — one argmin over a [B, C^K] tensor.  Equivalent to the
    reference's per-cluster CBC ILP (tracker.py:979-1217) for small
    clusters, with bounded candidate sets.

    Returns (sel_enum [T], obj_small [], bound_small []).  ``obj_small``
    is the enumerated optimum (exact on the candidate sets; an upper
    bound on the true optimum).  ``bound_small`` is a sound lower bound
    accounting for candidate truncation: any solution using a leaf
    outside some member's top-C set costs at least
    sum_t min_incl(t) + min_t (excl_lb(t) - min_incl(t)), since excluded
    leaves all score >= the C-th best and the other members cost at
    least their unconstrained minimum.
    """
    T, L, W2 = slots_flat.shape
    C = min(C, L)
    K = K_ENUM
    B = max(T // 2, 1)
    tidx = jnp.arange(T)

    # member rank within the cluster (among small members)
    same = small[None, :] & (labels[:, None] == labels[None, :])
    rank = jnp.sum((same & (tidx[None, :] < tidx[:, None])).astype(jnp.int32),
                   axis=1)                                  # [T]
    is_root = small & (labels == tidx)
    bid_of_root = jnp.cumsum(is_root.astype(jnp.int32)) - 1  # [T]
    bucket_of = jnp.where(small, bid_of_root[jnp.clip(labels, 0, T - 1)], B)

    # members [B, K]: target index or T (dummy) — dense compare-argmax
    # build instead of a scatter (scatter cost on the H100 not
    # measured)
    hit = (small[None, None, :]
           & (bucket_of[None, None, :] == jnp.arange(B)[:, None, None])
           & (rank[None, None, :] == jnp.arange(K)[None, :, None]))
    members = jnp.where(hit.any(axis=2),
                        jnp.argmax(hit, axis=2), T)        # [B, K]

    # candidate tables padded with a dummy target row (cost 0, no slots)
    cand_idx, excl_lb = _candidate_sets(state, f, C)        # [T,C], [T]
    cand_f = jnp.take_along_axis(f, cand_idx, axis=1)       # [T,C]
    cand_slots = jnp.take_along_axis(
        slots_flat, cand_idx[:, :, None], axis=1)           # [T,C,W2]
    cand_f = jnp.concatenate([cand_f, jnp.zeros((1, C), jnp.float32)], 0)
    cand_slots = jnp.concatenate(
        [cand_slots, jnp.full((1, C, W2), n_slots, jnp.int32)], 0)

    bf = cand_f[members]                                    # [B,K,C]
    bs = cand_slots[members]                                # [B,K,C,W2]

    def _enum_buckets(bf, bs):
        """Exhaustive C^K enumeration for a block of buckets.

        bf [b,K,C], bs [b,K,C,W2] -> (best combo index [b], value [b]).
        """
        # pairwise slot conflicts between bucket members
        conf = {}
        for i in range(K):
            for j in range(i + 1, K):
                a = bs[:, i]                                # [b,C,W2]
                b = bs[:, j]
                eq = (a[:, :, None, :, None] == b[:, None, :, None, :])
                valid = a[:, :, None, :, None] < n_slots
                conf[(i, j)] = jnp.any(eq & valid, axis=(3, 4))  # [b,C,C]

        # enumerate all C^K combos (K=4): score sum + pairwise feasibility
        score = (bf[:, 0][:, :, None, None, None]
                 + bf[:, 1][:, None, :, None, None]
                 + bf[:, 2][:, None, None, :, None]
                 + bf[:, 3][:, None, None, None, :])        # [b,C,C,C,C]
        ok = (~conf[(0, 1)][:, :, :, None, None]
              & ~conf[(0, 2)][:, :, None, :, None]
              & ~conf[(0, 3)][:, :, None, None, :]
              & ~conf[(1, 2)][:, None, :, :, None]
              & ~conf[(1, 3)][:, None, :, None, :]
              & ~conf[(2, 3)][:, None, None, :, :])
        total = jnp.where(ok, score, jnp.inf).reshape(-1, C ** K)
        return jnp.argmin(total, axis=1), jnp.min(total, axis=1)

    # The [b, C^K] score tensor is the memory hot spot: at T=4096,
    # C=16 the unchunked [T/2, C^4] tensor is 537 MB (round-4 verdict
    # weak #4).  Chunk buckets through lax.map so live memory stays
    # <= B_CHUNK * C^K * 4 = 67 MB; for T <= 512 (bench shapes and
    # below) the single-shot path is unchanged.
    B_CHUNK = 256
    if B <= B_CHUNK:
        best, best_val = _enum_buckets(bf, bs)
    else:
        nch = -(-B // B_CHUNK)
        pad = nch * B_CHUNK - B
        bf_p = jnp.pad(bf, ((0, pad), (0, 0), (0, 0)))
        bs_p = jnp.pad(bs, ((0, pad), (0, 0), (0, 0), (0, 0)),
                       constant_values=n_slots)
        best, best_val = jax.lax.map(
            lambda ab: _enum_buckets(*ab),
            (bf_p.reshape(nch, B_CHUNK, K, C),
             bs_p.reshape(nch, B_CHUNK, K, C, W2)))
        best = best.reshape(-1)[:B]
        best_val = best_val.reshape(-1)[:B]
    c_of = jnp.stack([best // C ** 3,
                      (best // C ** 2) % C,
                      (best // C) % C,
                      best % C], axis=1)                    # [B,K]

    # write back per-target selected leaf
    chosen = c_of[jnp.clip(bucket_of, 0, B - 1),
                  jnp.clip(rank, 0, K - 1)]                 # [T]
    sel_enum = cand_idx[tidx, chosen]
    # empty buckets enumerate all-dummy combos: score 0, feasible — they
    # contribute nothing to the objective.
    obj_small = jnp.where(jnp.isfinite(best_val), best_val, 0.0).sum()

    # Truncation-aware lower bound per bucket (see docstring).  Dummy
    # member rows contribute min_incl = 0 and excl_lb = +inf.
    min_incl = jnp.concatenate(
        [jnp.min(cand_f[:T], axis=1), jnp.zeros((1,), jnp.float32)], 0)
    excl_pad = jnp.concatenate(
        [excl_lb, jnp.full((1,), jnp.inf, jnp.float32)], 0)
    b_min = min_incl[members]                               # [B,K]
    b_excl = excl_pad[members]                              # [B,K]
    indep = b_min.sum(axis=1)                               # [B]
    swap_pen = jnp.min(b_excl - b_min, axis=1)              # [B]
    lb_outside = jnp.where(jnp.isfinite(swap_pen),
                           indep + swap_pen, jnp.inf)
    lb_bucket = jnp.minimum(
        jnp.where(jnp.isfinite(best_val), best_val, jnp.inf), lb_outside)
    bound_small = jnp.where(jnp.isfinite(lb_bucket), lb_bucket, 0.0).sum()
    return sel_enum, obj_small, bound_small


# ----------------------------------------------------------------------
# Tier 3: matrix-free Lagrangian (optionally restricted to one
# participation set — the big-cluster fallback)
# ----------------------------------------------------------------------

def select_lagrangian(state: TrackerState, shapes: TrackerShapes,
                      params: TrackerParams, iters: int = 60,
                      theta: float = 1.0,
                      participate: Optional[jnp.ndarray] = None,
                      obj_offset=0.0,
                      lam0: Optional[jnp.ndarray] = None,
                      patience: int = 6,
                      repair_rounds: int = 8,
                      repair_cadence: int = 4,
                      with_clusters: bool = True) -> SelectionResult:
    """Subgradient ascent with gather/scatter duals — no matrices.

    Dual price lam[s] per single-use slot; reduced cost of a leaf is its
    score plus the prices of every slot in its history (two gathers).
    The decode is an argmin per target; usage counts come from a
    scatter-add of the decoded selection.  Feasible incumbents are
    maintained with a conflict-repair sweep.

    ``participate`` restricts the solve to a subset of targets (their
    clusters must be disjoint from the rest — guaranteed when the subset
    is a union of connected components).  ``obj_offset`` is the exact
    objective of the already-solved remainder, used only to scale the
    relative convergence tolerance.
    """
    T, L, W = state.hist_meas.shape
    eff_tgt = state.tgt_mask if participate is None \
        else (state.tgt_mask & participate)
    eff_leaf = state.leaf_mask & eff_tgt[:, None]
    slots, n_slots = _slot_index(state, shapes)            # [T,L,W,2]
    f = leaf_scores(state, params)                         # [T,L]
    slots_flat = slots.reshape(T, L, W * 2)
    lam_init = state.lam if lam0 is None else lam0
    obj_offset = jnp.asarray(obj_offset, jnp.float32)

    def reduced_cost(lam):
        lam_pad = jnp.concatenate([lam, jnp.zeros((1,), jnp.float32)])
        picked = lam_pad[slots_flat]                       # [T,L,W*2]
        return f + picked.sum(axis=2)

    def decode(lam):
        rc = reduced_cost(lam)
        sel = jnp.argmin(rc, axis=1)
        lb = (jnp.where(eff_tgt, jnp.min(rc, axis=1), 0.0).sum()
              - lam.sum())
        return sel, lb

    def usage_of(sel):
        s = slots_flat[jnp.arange(T), sel]                 # [T, W*2]
        s = jnp.where(eff_tgt[:, None], s, n_slots)
        cnt = jnp.zeros((n_slots + 1,), jnp.float32)
        cnt = cnt.at[s.reshape(-1)].add(1.0)
        return cnt[:n_slots]

    # Per-(target, slot) unavoidability: slot s is unavoidable for t if
    # EVERY live leaf of t uses it (a shared within-window prefix).  An
    # unavoidable claimant must win the keep decision — by the spine
    # invariant (grow) at most one target can unavoidably claim a slot,
    # so ceding to it is always consistent.  Loop-invariant; computed
    # once per selection.
    #
    # Representation: a slot's window column is part of its identity
    # (slot = (column, measurement)), so "all live leaves use s" can
    # only happen at s's own column — unavoidability is a [T, W*2]
    # all-live-leaves-agree test per column, NOT a [T, n_slots] table
    # (the round-3 table was T x W(M+A): ~800 MB of scatter at the
    # T=4096 saturation point and the quadratic term in select's
    # scaling curve).  Any live leaf's own slot at an agreed column
    # equals the shared slot, so the repair can read this directly.
    def _unavoidable_cols():
        sf = jnp.where(eff_leaf[..., None], slots_flat, -1)  # [T,L,K]
        rep = jnp.max(sf, axis=1)                            # [T,K]
        same = jnp.all((sf == rep[:, None, :])
                       | ~eff_leaf[..., None], axis=1)       # [T,K]
        n_live = eff_leaf.sum(axis=1)
        return same & (rep >= 0) & (rep < n_slots) \
            & (n_live > 0)[:, None]                          # [T,K]

    unav_cols = _unavoidable_cols()

    def repair(sel, lam):
        """Parallel keep-best-per-slot conflict resolution.

        Per round: every over-used slot keeps its best claimant —
        unavoidable claimants first, then cheapest (deterministic index
        tiebreak); all other conflicted targets ban their current leaf
        and repick by reduced cost plus a penalty on still-contested
        slots.  Resolves most conflicts in 1-2 rounds.
        """
        rc = reduced_cost(lam)

        def body(carry):
            sel, banned, it, _ = carry
            cnt = usage_of(sel)
            over = cnt > 1.5
            over_pad = jnp.concatenate([over, jnp.zeros((1,), bool)])
            own = jnp.where(eff_tgt[:, None],
                            slots_flat[jnp.arange(T), sel], n_slots)
            fsel = f[jnp.arange(T), sel]
            # keep-priority key per (t, own slot): unavoidable claimants
            # dominate, then spine-holders (the spine set is mutually
            # feasible, so granting it a contested slot is always
            # consistent), then score.  A spine-holder therefore never
            # loses its slot, which guarantees the repair terminates at
            # the all-spines assignment in the worst case.
            unav_own = unav_cols                                  # [T,W*2]
            on_spine = (sel == state.spine_leaf).astype(jnp.float32)
            key = (fsel[:, None]
                   - 1e8 * unav_own.astype(jnp.float32)
                   - 5e7 * on_spine[:, None])
            claim = jnp.where(over_pad[own], key, jnp.inf)
            slot_min = jnp.full((n_slots + 1,), jnp.inf)
            slot_min = slot_min.at[own.reshape(-1)].min(claim.reshape(-1))
            in_conf = over_pad[own].any(axis=1) & eff_tgt
            # Exact tie-break: the keeper of a slot is the LOWEST-INDEX
            # claimant within tolerance of the slot's best key (a float
            # epsilon added to the key itself would vanish in fp32 next
            # to the priority offsets).
            tol = 1e-5 * (1.0 + jnp.abs(slot_min[own]))
            is_min = over_pad[own] & (key <= slot_min[own] + tol)
            cand_idx = jnp.where(is_min, jnp.arange(T)[:, None], T)
            slot_owner = jnp.full((n_slots + 1,), T, jnp.int32)
            slot_owner = slot_owner.at[own.reshape(-1)].min(
                cand_idx.reshape(-1).astype(jnp.int32))
            keeper = jnp.all(~over_pad[own]
                             | (slot_owner[own]
                                == jnp.arange(T)[:, None]), axis=1)
            loser = in_conf & ~keeper
            any_conf = jnp.any(in_conf)
            banned = banned | (loser[:, None]
                               & (jnp.arange(L)[None, :] == sel[:, None]))
            # Conflict-aware repick: penalise leaves that touch any slot
            # currently over-used so losers prefer clean leaves.  (An
            # occupancy-based penalty converges faster but measurably
            # degrades incumbent quality — it herds losers onto their
            # spines; termination is already guaranteed by the
            # spine-holder keep priority above.)
            pen = over_pad[slots_flat].sum(axis=2).astype(jnp.float32)
            rcb = jnp.where(banned, jnp.inf, rc + 1e3 * pen)
            sel = jnp.where(loser, jnp.argmin(rcb, axis=1), sel)
            return sel, banned, it + 1, any_conf

        def cond(carry):
            _, _, it, had_conf = carry
            return (it < repair_rounds) & had_conf

        sel, _, _, _ = jax.lax.while_loop(
            cond, body,
            (sel, jnp.zeros((T, L), bool), jnp.asarray(0),
             jnp.asarray(True)))
        cnt = usage_of(sel)
        return sel, ~jnp.any(cnt > 1.5)

    def obj_of(sel):
        return jnp.where(eff_tgt, f[jnp.arange(T), sel], 0.0).sum()

    def body(carry):
        (it, lam, best_sel, best_obj, best_feas, best_lb, last_sel,
         stale) = carry
        sel, lb = decode(lam)
        best_lb = jnp.maximum(best_lb, lb)
        cnt = usage_of(sel)
        # Subgradient of the dualised <=1 rows over rows in play: used
        # rows push prices up, slack rows that still carry a price decay
        # back toward 0 (g = -1, projected) — without the decay a price
        # that overshoots is stuck forever and the dual bound diverges.
        g = jnp.where((cnt > 0) | (lam > 0), cnt - 1.0, 0.0)
        feas = ~jnp.any(cnt > 1.5)
        # Lagrangian heuristic: turn an infeasible decode into a
        # feasible incumbent candidate via conflict repair.  Repair is
        # the expensive sequential part, so it only runs on a cadence
        # (every ``repair_cadence`` iterations) — the in-between
        # iterations are pure dual ascent (skipped by lax.cond).
        do_repair = ~feas & ((it % repair_cadence) == 0)
        sel_c, feas_c = _cond(
            do_repair, lambda a: repair(*a),
            lambda a: (a[0], feas), (sel, lam))
        obj = jnp.where(feas_c, obj_of(sel_c), jnp.inf)
        better = feas_c & ((obj < best_obj - 1e-6) | ~best_feas)
        # Patience resets only on a MATERIAL improvement (>=0.01% of the
        # pre-update incumbent) — marginal decodes must not keep the loop
        # alive for the full budget.
        material = feas_c & ((obj < best_obj
                              - 1e-4 * (1.0 + jnp.abs(best_obj)))
                             | ~best_feas)
        best_sel = jnp.where(better, sel_c, best_sel)
        best_obj = jnp.where(better, obj, best_obj)
        best_feas = best_feas | feas_c
        same = jnp.all(sel == last_sel)
        stale = jnp.where(material, 0, stale + 1)
        stale = jnp.where(feas & same, stale + 3, stale)
        gnorm2 = jnp.maximum(jnp.dot(g, g), 1e-6)
        gap_est = jnp.where(
            best_feas,
            jnp.clip(best_obj - lb, 1e-3, 1.0 + 0.25 * jnp.abs(best_obj)),
            1.0)
        step = theta * gap_est / gnorm2
        lam = jnp.maximum(0.0, lam + step * g)
        return (it + 1, lam, best_sel, best_obj, best_feas, best_lb, sel,
                stale)

    def cond(carry):
        (it, lam, best_sel, best_obj, best_feas, best_lb, last_sel,
         stale) = carry
        gap = best_obj - best_lb
        # Convergence is judged against the GLOBAL objective (exact part
        # + this subproblem): the caller only needs the total gap small.
        scale = 1.0 + jnp.abs(obj_offset + best_obj)
        converged = best_feas & (gap <= 2e-4 * scale)
        # The patience exit only fires once the certified gap is inside
        # the 0.1% contract — a stale incumbent with a loose bound keeps
        # iterating (the dual typically closes it within ~2x patience).
        patience_out = (best_feas & (stale >= patience)
                        & (gap <= 1e-3 * scale))
        return (it < iters) & ~converged & ~patience_out

    # Seed a feasible incumbent by repairing the warm-started decode:
    # the patience/convergence exits can then fire within a handful of
    # subgradient iterations instead of running the full budget.
    sel_seed, lb_seed = decode(lam_init)
    sel_seed, feas_seed = repair(sel_seed, lam_init)
    obj_seed = jnp.where(feas_seed, obj_of(sel_seed),
                         jnp.asarray(jnp.inf, jnp.float32))

    init = (jnp.asarray(0), lam_init,
            sel_seed, obj_seed, feas_seed,
            lb_seed,
            sel_seed, jnp.asarray(0))
    (_, lam, best_sel, best_obj, best_feas, best_lb,
     last_sel, _) = jax.lax.while_loop(cond, body, init)

    # (Every iteration already repairs its decode into an incumbent
    # candidate, so no post-loop repair pass is needed.)
    del last_sel
    if with_clusters:
        labels, n_clusters = cluster(state, shapes)
    else:
        labels = jnp.zeros((T,), jnp.int32)
        n_clusters = jnp.asarray(-1, jnp.int32)
    return SelectionResult(sel=best_sel, feasible=best_feas, obj=best_obj,
                           bound=best_lb, labels=labels,
                           n_clusters=n_clusters, lam=lam)


# ----------------------------------------------------------------------
# Tier 3 compact solver: Lagrangian over CONTESTED slots only
# ----------------------------------------------------------------------

def _compact_lagrangian(f, Uc, lam0, spine, eff_tgt, eff_leaf,
                        obj_offset, iters=60, theta=1.5, patience=4,
                        repair_rounds=8, repair_cadence=4,
                        axis_name=None, force_iters=False):
    """Subgradient ascent in the compact contested-slot space.

    ``Uc [T, L, C]`` is the 0/1 usage of contested slot c by leaf (t,l),
    already masked to live leaves of participating targets.  Every loop
    op is a small dense einsum/reduction over [CAP] columns instead of
    the full-slot gather/scatter formulation (per-iteration cost on the
    H100 not measured).  Semantics match select_lagrangian restricted to the
    participants: uncontested slots can never conflict (they are used by
    at most one participant through any leaf), so dualising only the
    contested set is exact.

    With ``axis_name`` set the SAME loop runs target-sharded inside
    shard_map: usage counts, objectives and bounds become psums of the
    local sums, the repair keep decision pmins its [CAP] keys/owners
    across shards, and the dual update stays replicated (all inputs are
    psum'd).  Per-iteration collective volume is 2 x [CAP] floats
    (~1-2 KB) instead of the full-slot formulation's [n_slots] vectors
    (~52 KB) — and no scatter ever touches the n_slots space.
    """
    T, L, CAP = Uc.shape
    tb = jnp.arange(T)
    obj_offset = jnp.asarray(obj_offset, jnp.float32)

    if axis_name is None:
        psum = pmin = lambda x: x
        gidx, T_g = tb, T
        mark_varying = lambda x: x
    else:
        psum = lambda x: jax.lax.psum(x, axis_name)
        pmin = lambda x: jax.lax.pmin(x, axis_name)
        my_shard = jax.lax.axis_index(axis_name)
        n_shards = jax.lax.axis_size(axis_name)
        gidx = my_shard * T + tb
        T_g = n_shards * T
        mark_varying = lambda x: jax.lax.pcast(x, (axis_name,),
                                               to='varying')

    n_live = eff_leaf.sum(axis=1).astype(jnp.float32)
    unavoid = ((Uc.sum(axis=1) >= n_live[:, None] - 0.5)
               & (n_live[:, None] > 0.5))                  # [T, CAP]

    def rc_of(lam):
        return f + jnp.einsum('tlc,c->tl', Uc, lam)

    def usel_of(sel):
        return jnp.take_along_axis(Uc, sel[:, None, None], axis=1)[:, 0]

    def decode(lam):
        rc = rc_of(lam)
        sel = jnp.argmin(rc, axis=1)
        lb = (psum(jnp.where(eff_tgt, jnp.min(rc, axis=1), 0.0).sum())
              - lam.sum())
        return sel, lb

    def obj_of(sel):
        return psum(jnp.where(eff_tgt, f[tb, sel], 0.0).sum())

    def repair(sel, lam):
        rc = rc_of(lam)

        def body(carry):
            sel, banned, it, _ = carry
            usel = usel_of(sel)                            # [T, CAP]
            cnt = psum(usel.sum(axis=0))
            over = cnt > 1.5                               # [CAP]
            fsel = f[tb, sel]
            on_spine = (sel == spine).astype(jnp.float32)
            keyc = (fsel[:, None] - 5e7 * on_spine[:, None]
                    - 1e8 * unavoid.astype(jnp.float32))   # [T, CAP]
            claiming = (usel > 0.5) & over[None, :]
            claim = jnp.where(claiming, keyc, jnp.inf)
            slot_min = pmin(jnp.min(claim, axis=0))        # [CAP]
            in_conf = claiming.any(axis=1) & eff_tgt
            tol = 1e-5 * (1.0 + jnp.abs(slot_min))
            is_min = claiming & (keyc <= (slot_min + tol)[None, :])
            cand = jnp.where(is_min, gidx[:, None], T_g)
            owner = pmin(jnp.min(cand, axis=0))            # [CAP] global
            keeper = jnp.all(~claiming | (owner[None, :] == gidx[:, None]),
                             axis=1)
            loser = in_conf & ~keeper
            banned = banned | (loser[:, None]
                               & (jnp.arange(L)[None, :] == sel[:, None]))
            pen = jnp.einsum('tlc,c->tl', Uc, over.astype(jnp.float32))
            rcb = jnp.where(banned, jnp.inf, rc + 1e3 * pen)
            sel = jnp.where(loser, jnp.argmin(rcb, axis=1), sel)
            any_conf = psum(jnp.any(in_conf).astype(jnp.int32)) > 0
            return sel, banned, it + 1, any_conf

        def cond(carry):
            _, _, it, had_conf = carry
            return (it < repair_rounds) & had_conf

        sel, _, _, _ = jax.lax.while_loop(
            cond, body,
            (sel, mark_varying(jnp.zeros((T, L), bool)), jnp.asarray(0),
             jnp.asarray(True)))
        cnt = psum(usel_of(sel).sum(axis=0))
        return sel, ~jnp.any(cnt > 1.5)

    def body(carry):
        (it, lam, best_sel, best_obj, best_feas, best_lb, stale,
         th, lb_stale) = carry
        sel, lb = decode(lam)
        lb_up = lb > best_lb + 1e-6 * (1.0 + jnp.abs(best_lb))
        best_lb = jnp.maximum(best_lb, lb)
        cnt = psum(usel_of(sel).sum(axis=0))
        g = jnp.where((cnt > 0) | (lam > 0), cnt - 1.0, 0.0)
        feas = ~jnp.any(cnt > 1.5)
        do_repair = ~feas & ((it % repair_cadence) == 0)
        sel_c, feas_c = _cond(do_repair, lambda a: repair(*a),
                              lambda a: (a[0], feas), (sel, lam))
        obj = jnp.where(feas_c, obj_of(sel_c), jnp.inf)
        better = feas_c & ((obj < best_obj - 1e-6) | ~best_feas)
        material = feas_c & ((obj < best_obj
                              - 1e-4 * (1.0 + jnp.abs(best_obj)))
                             | ~best_feas)
        best_sel = jnp.where(better, sel_c, best_sel)
        best_obj = jnp.where(better, obj, best_obj)
        best_feas = best_feas | feas_c
        stale = jnp.where(material, 0, stale + 1)
        # Held-Karp step schedule: a fixed theta oscillates around the
        # optimum on some instances — halve it whenever the dual bound
        # has not improved for 3 consecutive iterations.
        lb_stale = jnp.where(lb_up, 0, lb_stale + 1)
        halve = lb_stale >= 3
        th = jnp.where(halve, jnp.maximum(th * 0.5, 0.05), th)
        lb_stale = jnp.where(halve, 0, lb_stale)
        gnorm2 = jnp.maximum(jnp.dot(g, g), 1e-6)
        gap_est = jnp.where(
            best_feas,
            jnp.clip(best_obj - lb, 1e-3, 1.0 + 0.25 * jnp.abs(best_obj)),
            1.0)
        lam = jnp.maximum(0.0, lam + th * gap_est / gnorm2 * g)
        return (it + 1, lam, best_sel, best_obj, best_feas, best_lb, stale,
                th, lb_stale)

    def cond(carry):
        (it, lam, best_sel, best_obj, best_feas, best_lb, stale,
         th, lb_stale) = carry
        if force_iters:
            # A/B instrumentation: run exactly ``iters`` loop bodies so
            # per-iteration cost is measurable (tools/ab_distributed_
            # select.py).  Never set in production.
            return it < iters
        gap = best_obj - best_lb
        scale = 1.0 + jnp.abs(obj_offset + best_obj)
        converged = best_feas & (gap <= 2e-4 * scale)
        patience_out = (best_feas & (stale >= patience)
                        & (gap <= 1e-3 * scale))
        return (it < iters) & ~converged & ~patience_out

    sel_seed, lb_seed = decode(lam0)
    sel_seed, feas_seed = repair(sel_seed, lam0)
    obj_seed = jnp.where(feas_seed, obj_of(sel_seed),
                         jnp.asarray(jnp.inf, jnp.float32))
    init = (jnp.asarray(0), lam0, sel_seed, obj_seed, feas_seed,
            lb_seed, jnp.asarray(0), jnp.asarray(theta, jnp.float32),
            jnp.asarray(0))
    (_, lam, best_sel, best_obj, best_feas,
     best_lb, _, _, _) = jax.lax.while_loop(cond, body, init)
    return best_sel, best_feas, best_obj, best_lb, lam


# ----------------------------------------------------------------------
# The tiered hybrid (production path)
# ----------------------------------------------------------------------

def select_hybrid(state: TrackerState, shapes: TrackerShapes,
                  params: TrackerParams, iters: int = 60,
                  theta: float = 1.5,
                  enum_cands: int = C_ENUM,
                  patience: int = 4,
                  contested_cap: int = 256,
                  labels_in=None, **lag_kw) -> SelectionResult:
    """Cluster-decomposed selection: exact enumeration for small
    clusters, compact contested-slot Lagrangian for big ones (see module
    docstring).
    """
    T, L, W = state.hist_meas.shape
    M, A = shapes.max_meas, shapes.max_ais
    P = M + A
    slots, n_slots = _slot_index(state, shapes)
    slots_flat = slots.reshape(T, L, W * 2)
    f = leaf_scores(state, params)
    tb = jnp.arange(T)

    # Formulation switch: the dense/compare builds are used wherever
    # they are representable (they beat min/max-target-id scatters on
    # the earlier accelerator; not measured on the H100).  The scatter
    # path exists ONLY to cross the int32 addressing wall of
    # [T, n_slots] at T=16384+.
    dense_ok = T * W * P <= (1 << 31)
    usage = _hist_usage(state, shapes) if dense_ok else None
    if labels_in is None:
        labels, n_clusters = cluster(state, shapes, usage=usage)
    else:
        labels, n_clusters = labels_in
    csize = cluster_sizes(labels, state.tgt_mask)
    singleton = state.tgt_mask & (csize == 1)
    small = state.tgt_mask & (csize >= 2) & (csize <= K_ENUM)
    big = state.tgt_mask & (csize > K_ENUM)

    # tier 1: singletons — exact argmin
    sel0 = jnp.argmin(f, axis=1)
    obj_single = jnp.where(singleton, jnp.min(f, axis=1), 0.0).sum()

    # tier 2: small clusters — batched exact enumeration (exact on the
    # candidate sets; bound_small keeps the certificate sound when a
    # member's candidate set is truncated)
    sel_enum, obj_small, bound_small = _enum_small_clusters(
        state, f, slots_flat, n_slots, labels, small, C=enum_cands)
    exact_obj = obj_single + obj_small
    exact_bound = obj_single + bound_small

    # tier 3: big clusters — compact contested-slot Lagrangian.  Only
    # slots used by >=2 distinct big-cluster targets can conflict or
    # carry dual prices; compacting to those CAP slots makes every
    # loop op a small dense tensor op.  Contestedness: per-slot
    # big-target counts from the dense usage tensor when representable,
    # else exact min/max-target-id scatters (see dense_ok above).
    CAP = min(contested_cap, W * P)
    S = W * P
    if dense_ok:
        cnt_big = (usage & big[:, None, None]).sum(axis=0)  # [W, P]
        contested = (cnt_big >= 2).reshape(S)
    else:
        contested, _ = _contested_minmax(state, shapes, tgt_filter=big)
    n_cont = contested.sum()
    # compact column -> flat slot id tables (shared by both builds)
    s_ids = jnp.where(contested, jnp.arange(S), S)
    col_slot = jnp.sort(s_ids)[:CAP]                       # [CAP]
    col_ok = col_slot < S
    cs = jnp.where(col_ok, col_slot, 0)
    cw = jnp.where(col_ok, cs // P, 0)                     # column of slot
    off = cs % P
    cais = col_ok & (off >= M)
    # label value of each compact column; 0 for empty columns — the
    # cval > 0 guard below is load-bearing: hist_meas==0 is the
    # zero-hypothesis encoding, so unguarded empty columns would
    # become phantom "at most one target may miss at column cw"
    # constraints.
    cval = jnp.where(col_ok,
                     jnp.where(off >= M, off - M + 1, off + 1), 0)
    eff_leaf = state.leaf_mask & big[:, None]
    if dense_ok:
        wids = jnp.arange(W)[None, None, :, None]
        m_match = ((state.hist_meas[..., None] == cval)
                   & ~cais & (cval > 0))
        a_match = (state.hist_ais[..., None] == cval) & cais
        use_c = ((m_match | a_match) & (wids == cw)).any(axis=2)
        Uc = (use_c & eff_leaf[..., None]).astype(jnp.float32)  # [T,L,CAP]
    else:
        rank_pad = _compact_rank(contested, CAP)           # [S+1]
        mi, ai, n_inv = _slot_flat_labels(state, shapes)
        keepb = big[:, None, None]
        tlids = jnp.broadcast_to(
            (jnp.arange(T)[:, None] * L
             + jnp.arange(L)[None, :])[..., None], mi.shape).reshape(-1)
        Uc2 = jnp.zeros((T * L, CAP + 1), jnp.float32)
        for idx in (mi, ai):
            cols = rank_pad[jnp.where(keepb, idx, n_inv).reshape(-1)]
            Uc2 = Uc2.at[tlids, cols].set(1.0)
        Uc = Uc2[:, :CAP].reshape(T, L, CAP)
    lam_pad0 = jnp.concatenate([state.lam,
                                jnp.zeros((1,), jnp.float32)])
    lam_c0 = jnp.where(col_ok, lam_pad0[jnp.clip(col_slot, 0, S)],
                       0.0)                                # [CAP]

    def run_big(_):
        sel_b, feas_b, obj_b, lb_b, lam_out = _compact_lagrangian(
            f, Uc, lam_c0, state.spine_leaf, big, eff_leaf, exact_obj,
            iters=iters, theta=theta, patience=patience, **lag_kw)
        lam_full = jnp.zeros((S,), jnp.float32).at[
            jnp.where(col_ok, col_slot, S)].add(
            jnp.where(col_ok, lam_out, 0.0), mode='drop')
        return sel_b, feas_b, obj_b, lb_b, lam_full

    def no_big(_):
        return (sel0, jnp.asarray(True), jnp.asarray(0.0, jnp.float32),
                jnp.asarray(0.0, jnp.float32),
                jnp.zeros_like(state.lam))

    sel_big, feas_big, obj_big, bound_big, lam = _cond(
        jnp.any(big), run_big, no_big, None)

    sel = jnp.where(singleton, sel0,
                    jnp.where(small, sel_enum, sel_big))

    # Overflow guard: with more than CAP contested slots the compact
    # solver cannot see every conflict — verify the combined selection
    # in the full slot space and retreat big-cluster targets to their
    # (globally feasible) spines if needed.  The Lagrangian bound stays
    # valid (dualising a subset of constraints only loosens it).
    ok = _selection_feasible(state, shapes, sel)
    need_fb = (n_cont > CAP) & ~ok
    spine = jnp.clip(state.spine_leaf, 0, L - 1)
    sel = jnp.where(need_fb & big, spine, sel)
    obj_fb = jnp.where(big, f[tb, spine], 0.0).sum()
    obj_big = jnp.where(need_fb, obj_fb, obj_big)
    feas = jnp.where(need_fb, _selection_feasible(state, shapes, sel),
                     feas_big & ok)

    return SelectionResult(
        sel=sel, feasible=feas,
        obj=exact_obj + obj_big,
        bound=exact_bound + bound_big,
        labels=labels, n_clusters=n_clusters, lam=lam)


def _independent_best(state: TrackerState, shapes: TrackerShapes,
                      params: TrackerParams):
    """Per-target best leaf + feasibility of that joint choice.

    When every target's independent minimum is conflict-free it is the
    exact global optimum (the reference reaches the same conclusion by
    handling singleton clusters with _selectBestHypothesis,
    tracker.py:228-233).
    """
    T, L, W = state.hist_meas.shape
    f = leaf_scores(state, params)
    sel = jnp.argmin(f, axis=1)
    obj = jnp.where(state.tgt_mask, jnp.min(f, axis=1), 0.0).sum()
    feasible = _selection_feasible(state, shapes, sel)
    return sel, obj, feasible


def _selection_feasible(state: TrackerState, shapes: TrackerShapes, sel):
    """True iff the per-target selection ``sel`` uses every (window
    column, measurement/AIS) slot at most once.  Dense compares below
    _USAGE_DENSE_LIMIT virtual elements, scatter-add counts above (the
    same size switch as _hist_usage — T*W writes vs T*W*(M+A)
    compares)."""
    T, L, W = state.hist_meas.shape
    M, A = shapes.max_meas, shapes.max_ais
    tb = jnp.arange(T)
    act = state.tgt_mask
    sm = jnp.where(act[:, None], state.hist_meas[tb, sel], -1)    # [T, W]
    sa = jnp.where(act[:, None], state.hist_ais[tb, sel], 0)
    if T * W * (M + A) <= _USAGE_DENSE_LIMIT:
        cm = (sm[:, :, None] == jnp.arange(1, M + 1)).sum(axis=0)  # [W, M]
        ca = (sa[:, :, None] == jnp.arange(1, A + 1)).sum(axis=0)  # [W, A]
        return ~(jnp.any(cm > 1) | jnp.any(ca > 1))
    P = M + A
    n = W * P
    base_w = jnp.arange(W)[None, :] * P                            # [1, W]
    smi = jnp.where(sm >= 1, base_w + sm - 1, n)                   # [T, W]
    sai = jnp.where(sa >= 1, base_w + M + sa - 1, n)
    cnt = jnp.zeros((n + 1,), jnp.int32)
    cnt = cnt.at[smi.reshape(-1)].add(1)
    cnt = cnt.at[sai.reshape(-1)].add(1)
    return ~jnp.any(cnt[:n] > 1)


def select(state: TrackerState, shapes: TrackerShapes, params: TrackerParams,
           method: str = 'ipm', fast_path: bool = True,
           compute_clusters: bool = True, **kw) -> SelectionResult:
    solver = {'ipm': select_ipm,
              'lagrangian': select_hybrid,
              'lagrangian_pure': select_lagrangian}
    if method not in solver and method != 'greedy':
        raise ValueError(f"unknown selection method {method!r}")
    if not fast_path and method != 'greedy':
        return solver[method](state, shapes, params, **kw)

    # Fast path: if the per-target independent optima are conflict-free,
    # they are the global optimum — skip the solver entirely.  Both
    # branches of lax.cond compile, only the taken one executes.
    sel0, obj0, feas0 = _independent_best(state, shapes, params)
    if compute_clusters:
        labels, n_clusters = cluster(state, shapes)
        if method == 'lagrangian':
            kw = dict(kw, labels_in=(labels, n_clusters))
    else:
        # Cluster labels are observability, not needed for selection —
        # the hybrid's slow branch computes real labels internally; the
        # fast branch only needs placeholders of matching shape.
        T = state.tgt_mask.shape[0]
        labels = jnp.zeros((T,), jnp.int32)
        n_clusters = jnp.asarray(-1, jnp.int32)

    def fast(_):
        return SelectionResult(sel=sel0, feasible=jnp.asarray(True),
                               obj=obj0, bound=obj0, labels=labels,
                               n_clusters=n_clusters, lam=state.lam)

    if method == 'greedy':
        # Profiling / degraded mode: per-target independent best, no
        # conflict resolution (feasibility reported honestly).
        return fast(None)._replace(feasible=feas0)

    def slow(_):
        res = solver[method](state, shapes, params, **kw)
        if method != 'lagrangian':
            res = res._replace(labels=labels, n_clusters=n_clusters)
        return res

    return _cond(feas0, fast, slow, None)
