"""Target-sharded global hypothesis selection with explicit collectives.

BASELINE config 5's pattern: the target axis partitions across chips
("cluster" mesh axis); each shard decodes its own targets against shared
dual prices, and the cross-chip traffic is an all-reduce of the
slot-usage counts (the Lagrangian subgradient) plus per-slot min
reductions for the conflict-repair keep decision.  The
dual update is replicated deterministically on every shard, so prices
never need a broadcast.

Feasibility machinery mirrors core/select.py: every decode that is
infeasible is repaired by keep-best-per-slot rounds with spine priority
(the spine set is mutually conflict-free across ALL shards — grow
forces the zero-child of the previous global selection into each
target's beam), so the loop always produces a feasible incumbent.

Two implementations:

* ``distributed_select_compact`` (production) — the round-5 default.
  Shares core/select.py's compact contested-slot loop
  (``_compact_lagrangian(axis_name=...)``): the contested-slot set is
  found with ONE psum of the dense per-slot target counts, compacted to
  [CAP] columns, and every Lagrangian iteration then all-reduces only a
  [CAP] usage vector (+[CAP] pmin keys in repair rounds) — ~1 KB/iter
  instead of the full-slot formulation's [n_slots] ~52 KB vectors, and
  NO scatter into the n_slots space anywhere (the single-chip path
  avoids that op class too).  An up-front
  fast path (one psum'd dense usage count) skips the whole loop when
  the per-target independent optima are globally conflict-free — the
  dominant case on low-conflict scans, mirroring
  core/select.select's tier 0.
* ``distributed_lagrangian`` (kept for A/B + parity) — the round-3/4
  full-slot formulation with scatter-built usage counts and [n_slots]
  psum/pmin per iteration.

Built on shard_map + lax.psum/pmin rather than hand-written RDMA: the
collective pattern is explicit, the transport is XLA's.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

from ..core.config import TrackerShapes, TrackerParams
from ..core.select import (_slot_index, _compact_lagrangian, _compact_rank,
                           _slot_flat_labels, _hist_usage, leaf_scores)


def _local_tables(state, shapes):
    slots, n_slots = _slot_index(state, shapes)
    T, L, W, _ = slots.shape
    return slots.reshape(T, L, W * 2), n_slots


def distributed_lagrangian(state, shapes: TrackerShapes,
                           params: TrackerParams, axis_name: str,
                           iters: int = 60, theta: float = 1.5,
                           patience: int = 6, repair_rounds: int = 8,
                           repair_cadence: int = 2,
                           lam0=None, force_iters: bool = False):
    """Runs INSIDE shard_map: ``state`` holds this shard's targets.

    Returns (sel [T_local], obj_global, lb_global, feasible_global,
    lam [n_slots] — final duals, replicated, for cross-scan warm starts).
    """
    slots_flat, n_slots = _local_tables(state, shapes)
    T, L = state.leaf_mask.shape
    f = leaf_scores(state, params)
    my_shard = jax.lax.axis_index(axis_name)
    n_shards = jax.lax.axis_size(axis_name)
    gidx = my_shard * T + jnp.arange(T)              # global target index
    T_g = n_shards * T
    tgt = state.tgt_mask

    def reduced_cost(lam):
        lam_pad = jnp.concatenate([lam, jnp.zeros((1,), jnp.float32)])
        return f + lam_pad[slots_flat].sum(axis=2)

    def decode(lam):
        rc = reduced_cost(lam)
        sel = jnp.argmin(rc, axis=1)
        local_min = jnp.where(tgt, jnp.min(rc, axis=1), 0.0).sum()
        lb = jax.lax.psum(local_min, axis_name) - lam.sum()
        return sel, lb

    def usage_of(sel):
        s = slots_flat[jnp.arange(T), sel]
        s = jnp.where(tgt[:, None], s, n_slots)
        cnt = jnp.zeros((n_slots + 1,), jnp.float32)
        cnt = cnt.at[s.reshape(-1)].add(1.0)
        # THE collective: global usage = sum of shard usages.
        return jax.lax.psum(cnt[:n_slots], axis_name)

    def obj_of(sel):
        local = jnp.where(tgt, f[jnp.arange(T), sel], 0.0).sum()
        return jax.lax.psum(local, axis_name)

    # per-(target, column) unavoidability: all-live-leaves-agree test
    # per window column (see core/select.py — a slot's column is part
    # of its identity, so the [T, n_slots] table is never needed)
    def _unavoidable_cols():
        eff = state.leaf_mask & tgt[:, None]
        sf = jnp.where(eff[..., None], slots_flat, -1)
        rep = jnp.max(sf, axis=1)
        same = jnp.all((sf == rep[:, None, :]) | ~eff[..., None], axis=1)
        n_live = eff.sum(axis=1)
        return same & (rep >= 0) & (rep < n_slots) \
            & (n_live > 0)[:, None]

    unav_cols = _unavoidable_cols()

    def repair(sel, lam):
        """Distributed keep-best-per-slot conflict resolution: the keep
        decision reduces claim keys per slot across shards (pmin); losers
        repick locally.  Spine priority guarantees termination at the
        globally feasible all-spines assignment."""
        rc = reduced_cost(lam)

        def body(carry):
            sel, banned, it, _ = carry
            cnt = usage_of(sel)
            over = cnt > 1.5
            over_pad = jnp.concatenate([over, jnp.zeros((1,), bool)])
            own = jnp.where(tgt[:, None],
                            slots_flat[jnp.arange(T), sel], n_slots)
            fsel = f[jnp.arange(T), sel]
            unav_own = unav_cols
            on_spine = (sel == state.spine_leaf).astype(jnp.float32)
            key = (fsel[:, None]
                   - 1e8 * unav_own.astype(jnp.float32)
                   - 5e7 * on_spine[:, None])
            claim = jnp.where(over_pad[own], key, jnp.inf)
            slot_min = jnp.full((n_slots + 1,), jnp.inf)
            slot_min = slot_min.at[own.reshape(-1)].min(claim.reshape(-1))
            slot_min = jax.lax.pmin(slot_min, axis_name)   # global min key
            in_conf = over_pad[own].any(axis=1) & tgt
            tol = 1e-5 * (1.0 + jnp.abs(slot_min[own]))
            is_min = over_pad[own] & (key <= slot_min[own] + tol)
            cand_idx = jnp.where(is_min, gidx[:, None], T_g)
            slot_owner = jnp.full((n_slots + 1,), T_g, jnp.int32)
            slot_owner = slot_owner.at[own.reshape(-1)].min(
                cand_idx.reshape(-1).astype(jnp.int32))
            slot_owner = jax.lax.pmin(slot_owner, axis_name)  # global owner
            keeper = jnp.all(~over_pad[own]
                             | (slot_owner[own] == gidx[:, None]), axis=1)
            loser = in_conf & ~keeper
            any_conf = jax.lax.psum(
                jnp.any(in_conf).astype(jnp.int32), axis_name) > 0
            banned = banned | (loser[:, None]
                               & (jnp.arange(L)[None, :] == sel[:, None]))
            pen = over_pad[slots_flat].sum(axis=2).astype(jnp.float32)
            rcb = jnp.where(banned, jnp.inf, rc + 1e3 * pen)
            sel = jnp.where(loser, jnp.argmin(rcb, axis=1), sel)
            return sel, banned, it + 1, any_conf

        def cond(carry):
            _, _, it, had_conf = carry
            return (it < repair_rounds) & had_conf

        sel, _, _, _ = jax.lax.while_loop(
            cond, body,
            (sel,
             # banned is shard-varying (tracks local targets)
             jax.lax.pcast(jnp.zeros((T, L), bool), (axis_name,),
                           to='varying'),
             jnp.asarray(0), jnp.asarray(True)))
        cnt = usage_of(sel)
        return sel, ~jnp.any(cnt > 1.5)

    def body(carry):
        (it, lam, best_sel, best_obj, best_feas, best_lb, stale) = carry
        sel, lb = decode(lam)
        best_lb = jnp.maximum(best_lb, lb)
        cnt = usage_of(sel)
        # used rows raise prices; slack-but-priced rows decay (see
        # core/select.py — without decay the dual diverges).
        g = jnp.where((cnt > 0) | (lam > 0), cnt - 1.0, 0.0)
        feas = ~jnp.any(cnt > 1.5)
        do_repair = ~feas & ((it % repair_cadence) == 0)
        sel_c, feas_c = jax.lax.cond(
            do_repair, lambda a: repair(*a),
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
        gnorm2 = jnp.maximum(jnp.dot(g, g), 1e-6)
        gap_est = jnp.where(best_feas,
                            jnp.clip(best_obj - lb, 1e-3,
                                     1.0 + 0.25 * jnp.abs(best_obj)), 1.0)
        # identical on every shard (g and totals are psum'd) -> lam stays
        # replicated without a broadcast.
        lam = jnp.maximum(0.0, lam + theta * gap_est / gnorm2 * g)
        return (it + 1, lam, best_sel, best_obj, best_feas, best_lb, stale)

    def cond(carry):
        (it, lam, best_sel, best_obj, best_feas, best_lb, stale) = carry
        if force_iters:
            return it < iters           # A/B instrumentation only
        gap = best_obj - best_lb
        scale = 1.0 + jnp.abs(best_obj)
        converged = best_feas & (gap <= 2e-4 * scale)
        patience_out = (best_feas & (stale >= patience)
                        & (gap <= 1e-3 * scale))
        return (it < iters) & ~converged & ~patience_out

    lam_init = jnp.zeros((n_slots,), jnp.float32) if lam0 is None else lam0
    sel_seed, lb_seed = decode(lam_init)
    sel_seed, feas_seed = repair(sel_seed, lam_init)
    obj_seed = jnp.where(feas_seed, obj_of(sel_seed),
                         jnp.asarray(jnp.inf, jnp.float32))

    init = (jnp.asarray(0), lam_init,
            sel_seed, obj_seed, feas_seed, lb_seed, jnp.asarray(0))
    (_, lam, best_sel, best_obj, best_feas,
     best_lb, _) = jax.lax.while_loop(cond, body, init)
    return best_sel, best_obj, best_lb, best_feas, lam


def _dist_selection_feasible(state, shapes: TrackerShapes, sel, axis_name):
    """Global feasibility of a per-target selection under target
    sharding: dense local (window column, label) counts, ONE psum.
    Twin of core/select._selection_feasible."""
    T, L, W = state.hist_meas.shape
    M, A = shapes.max_meas, shapes.max_ais
    tb = jnp.arange(T)
    act = state.tgt_mask
    sm = jnp.where(act[:, None], state.hist_meas[tb, sel], -1)    # [T, W]
    sa = jnp.where(act[:, None], state.hist_ais[tb, sel], 0)
    cm = (sm[:, :, None] == jnp.arange(1, M + 1)).sum(axis=0)     # [W, M]
    ca = (sa[:, :, None] == jnp.arange(1, A + 1)).sum(axis=0)     # [W, A]
    cm = jax.lax.psum(cm, axis_name)
    ca = jax.lax.psum(ca, axis_name)
    return ~(jnp.any(cm > 1) | jnp.any(ca > 1))


def distributed_select_compact(state, shapes: TrackerShapes,
                               params: TrackerParams, axis_name: str,
                               iters: int = 60, theta: float = 1.5,
                               patience: int = 4, repair_rounds: int = 8,
                               repair_cadence: int = 4,
                               contested_cap: int = 256,
                               lam0=None, fast_path: bool = True,
                               force_iters: bool = False):
    """Runs INSIDE shard_map: ``state`` holds this shard's targets.

    Production distributed selection (see module docstring): fast-path
    short-circuit, then the shared compact contested-slot Lagrangian
    with [CAP]-sized collectives, then the same contested-cap overflow
    guard as core/select.select_hybrid (spine retreat keeps the
    selection feasible; the dual bound stays valid because dualising a
    subset of constraints only loosens it).

    Returns (sel [T_local], obj_global, lb_global, feasible_global,
    lam [n_slots] — final duals, replicated, for cross-scan warm
    starts).
    """
    T, L, W = state.hist_meas.shape
    M, A = shapes.max_meas, shapes.max_ais
    Pcols = M + A
    tb = jnp.arange(T)
    f = leaf_scores(state, params)
    lam_full0 = state.lam if lam0 is None else lam0

    # tier 0 fast path: independent optima, one psum'd feasibility check
    sel0 = jnp.argmin(f, axis=1)
    obj0 = jax.lax.psum(
        jnp.where(state.tgt_mask, jnp.min(f, axis=1), 0.0).sum(), axis_name)
    feas0 = _dist_selection_feasible(state, shapes, sel0, axis_name)

    def fast(_):
        return sel0, obj0, obj0, jnp.asarray(True), lam_full0

    def slow(_):
        # contested set: slots used by >= 2 targets GLOBALLY.  Dense
        # formulation (psum'd per-slot target counts) wherever the
        # local [T, n_slots] usage is representable (as in
        # core/select.py).  Beyond the int32 addressing wall: exact min/max
        # GLOBAL-target-id scatters + one pmin/pmax pair.
        S = W * Pcols
        eff_leaf = state.leaf_mask & state.tgt_mask[:, None]
        if T * S <= (1 << 31):
            usage = _hist_usage(state, shapes)             # [T, W, Pcols]
            cnt_t = jax.lax.psum(usage.sum(axis=0).astype(jnp.int32),
                                 axis_name)                # [W, Pcols]
            contested = (cnt_t >= 2).reshape(S)            # replicated
        else:
            my_shard = jax.lax.axis_index(axis_name)
            n_shards = jax.lax.axis_size(axis_name)
            T_g = n_shards * T
            mi, ai, n_inv = _slot_flat_labels(state, shapes)
            gtid = jnp.broadcast_to(
                (my_shard * T + jnp.arange(T))[:, None, None],
                mi.shape).reshape(-1)
            mn = jnp.full((S + 1,), T_g, jnp.int32)
            mx = jnp.full((S + 1,), -1, jnp.int32)
            for idx in (mi, ai):
                f_idx = idx.reshape(-1)
                mn = mn.at[f_idx].min(gtid)
                mx = mx.at[f_idx].max(gtid)
            mn = jax.lax.pmin(mn[:S], axis_name)
            mx = jax.lax.pmax(mx[:S], axis_name)
            contested = mn < mx                            # replicated
        n_cont = contested.sum()
        CAP = min(contested_cap, S)
        # compaction tables are pure functions of the reduced
        # ``contested`` — identical on every shard, no broadcast needed.
        s_ids = jnp.where(contested, jnp.arange(S), S)
        col_slot = jnp.sort(s_ids)[:CAP]                   # [CAP]
        col_ok = col_slot < S
        if T * S <= (1 << 31):
            cs = jnp.where(col_ok, col_slot, 0)
            cw = jnp.where(col_ok, cs // Pcols, 0)
            off = cs % Pcols
            cais = col_ok & (off >= M)
            # cval > 0 guard is load-bearing (zero-hypothesis encoding;
            # see core/select.select_hybrid)
            cval = jnp.where(col_ok,
                             jnp.where(off >= M, off - M + 1, off + 1), 0)
            wids = jnp.arange(W)[None, None, :, None]
            m_match = ((state.hist_meas[..., None] == cval)
                       & ~cais & (cval > 0))
            a_match = (state.hist_ais[..., None] == cval) & cais
            use_c = ((m_match | a_match) & (wids == cw)).any(axis=2)
            Uc = (use_c & eff_leaf[..., None]).astype(jnp.float32)
        else:
            rank_pad = _compact_rank(contested, CAP)       # [S+1]
            tlids = jnp.broadcast_to(
                (jnp.arange(T)[:, None] * L
                 + jnp.arange(L)[None, :])[..., None],
                mi.shape).reshape(-1)
            Uc2 = jnp.zeros((T * L, CAP + 1), jnp.float32)
            for idx in (mi, ai):
                cols = rank_pad[idx.reshape(-1)]
                Uc2 = Uc2.at[tlids, cols].set(1.0)
            Uc = Uc2[:, :CAP].reshape(T, L, CAP)
        lam_pad0 = jnp.concatenate([lam_full0,
                                    jnp.zeros((1,), jnp.float32)])
        lam_c0 = jnp.where(col_ok, lam_pad0[jnp.clip(col_slot, 0, S)],
                           0.0)

        sel_b, feas_b, obj_b, lb_b, lam_c = _compact_lagrangian(
            f, Uc, lam_c0, state.spine_leaf, state.tgt_mask, eff_leaf,
            0.0, iters=iters, theta=theta, patience=patience,
            repair_rounds=repair_rounds, repair_cadence=repair_cadence,
            axis_name=axis_name, force_iters=force_iters)
        lam_full = jnp.zeros((S,), jnp.float32).at[
            jnp.where(col_ok, col_slot, S)].add(
            jnp.where(col_ok, lam_c, 0.0), mode='drop')

        # contested-cap overflow guard (core/select.select_hybrid twin)
        ok = _dist_selection_feasible(state, shapes, sel_b, axis_name)
        need_fb = (n_cont > CAP) & ~ok
        spine = jnp.clip(state.spine_leaf, 0, L - 1)
        sel_fin = jnp.where(need_fb & state.tgt_mask, spine, sel_b)
        obj_fb = jax.lax.psum(
            jnp.where(state.tgt_mask, f[tb, spine], 0.0).sum(), axis_name)
        obj_fin = jnp.where(need_fb, obj_fb, obj_b)
        feas_fin = jnp.where(
            need_fb,
            _dist_selection_feasible(state, shapes, sel_fin, axis_name),
            feas_b & ok)
        return sel_fin, obj_fin, lb_b, feas_fin, lam_full

    if not fast_path:
        return slow(None)
    return jax.lax.cond(feas0, fast, slow, None)


def make_distributed_select(mesh: Mesh, shapes: TrackerShapes,
                            params: TrackerParams, axis_name: str = 'cluster',
                            iters: int = 60, impl: str = 'compact',
                            **impl_kw):
    """jitted shard_map wrapper: TrackerState sharded on the target axis.

    ``impl``: 'compact' (production, [CAP] collectives) or 'full' (the
    round-3/4 full-slot formulation, kept for A/B and parity)."""
    from jax import shard_map

    def spec_of(x):
        if x.ndim >= 1 and x.shape[0] == shapes.max_targets:
            return P(axis_name)
        return P()

    def fn(state):
        if impl == 'compact':
            return distributed_select_compact(state, shapes, params,
                                              axis_name, iters=iters,
                                              **impl_kw)
        return distributed_lagrangian(state, shapes, params, axis_name,
                                      iters=iters, **impl_kw)

    def run(state):
        specs = jax.tree_util.tree_map(spec_of, state)
        sm = shard_map(fn, mesh=mesh, in_specs=(specs,),
                       out_specs=(P(axis_name), P(), P(), P(), P()))
        return jax.jit(sm)(state)

    return run
