"""Target-sharded full tracker step: the whole per-scan pipeline under
shard_map with the selection collectives of distributed_select.

The forest's target axis partitions across the 'cluster' mesh axis
(BASELINE config 5).  Per scan:

* grow     — embarrassingly target-parallel (each shard grows its own
             targets against the replicated scan);
* select   — distributed Lagrangian with psum usage counts / pmin
             repair keys (distributed_select.py);
* terminate / N-scan prune — target-local;
* initiate — replicated compute on the globally-unused measurements
             (identical on every shard), with new targets dealt
             round-robin across shards so insertion stays local.

The reference has no distributed runtime (SURVEY §2.3); this is the
explicit-collective design the north star calls for.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

from ..core.config import TrackerShapes, TrackerParams
from ..core.state import insert_targets
from ..core.grow import Scan, AisBatch, empty_ais, grow
from ..core.lifecycle import n_scan_prune, terminate
from ..core import initiator as initiator_mod
from ..core.tracker import _merge_new_targets
from .distributed_select import (distributed_lagrangian,
                                 distributed_select_compact)


def sharded_scan_step(state, init_state, scan: Scan, ais,
                      shapes: TrackerShapes, params: TrackerParams,
                      axis_name: str = 'cluster',
                      use_ais: bool = False,
                      ais_initialization: bool = True,
                      prune_similar: bool = False,
                      dynamic_window: bool = False,
                      select_impl: str = 'compact',
                      select_kw=None):
    """One scan; runs INSIDE shard_map.  ``state`` holds this shard's
    target slots; ``init_state``/``scan``/``ais`` are replicated."""
    T, L, W = state.hist_meas.shape
    tb = jnp.arange(T)
    my_shard = jax.lax.axis_index(axis_name)
    n_shards = jax.lax.axis_size(axis_name)

    # 1. grow (target-parallel up to ONE pre-collective: the AIS
    # association density lambda_ais depends on the GLOBAL live-target
    # count — the local mask sum would bias every AIS score by
    # log(global/local), a divergence invisible at toy shapes but worth
    # ~3% of the selection objective at swarm scale)
    n_tgt_global = jax.lax.psum(
        jnp.sum(state.tgt_mask.astype(jnp.float32)), axis_name)
    g = grow(state, scan, ais if use_ais else None, shapes, params,
             n_targets_global=n_tgt_global if use_ais else None)
    state = g.state
    if prune_similar:
        from ..core.merge import prune_similar as _ps
        state = _ps(state, shapes, params)
    used_meas = jax.lax.psum(g.used_meas.astype(jnp.int32), axis_name) > 0

    # 2-3. distributed selection.  'compact' (production): fast-path
    # short-circuit + contested-slot compaction, [CAP]-sized psum/pmin
    # per iteration; 'full': the round-3/4 [n_slots] formulation, kept
    # for A/B (tools/ab_distributed_select.py).
    if select_impl == 'compact':
        sel, obj, lb, feas, lam = distributed_select_compact(
            state, shapes, params, axis_name, lam0=state.lam,
            **(select_kw or {}))
    else:
        sel, obj, lb, feas, lam = distributed_lagrangian(
            state, shapes, params, axis_name, lam0=state.lam,
            **(select_kw or {}))
    state = state.replace(sel_leaf=sel, lam=lam)

    track_x = state.leaf_x[tb, sel]
    track_mask = state.tgt_mask
    track_id = state.tgt_id
    sel_hist_meas = state.hist_meas[tb, sel]

    # 6-7. lifecycle (target-local)
    term = terminate(state, shapes, params)
    state = term.state
    pr = n_scan_prune(state, shapes, params)
    state = pr.state

    # 8. initiate: replicated compute, round-robin insertion.  AIS-aided
    # initiation mirrors core/tracker.py: messages whose MMSI was
    # associated by any surviving leaf — on ANY shard (psum-OR) — are
    # not available for seeding (reference tracker.py:267-270).
    unused_z = scan.mask & ~used_meas
    if use_ais and ais_initialization:
        cur_mmsi = jnp.where(state.leaf_mask, state.hist_mmsi[:, :, -1], 0)
        used_local = jnp.isin(ais.mmsi, cur_mmsi.reshape(-1))
        used_mmsi_ais = jax.lax.psum(used_local.astype(jnp.int32),
                                     axis_name) > 0
        ais_for_init = ais._replace(mask=ais.mask & ~used_mmsi_ais)
    else:
        ais_for_init = empty_ais(shapes)
    init_out = initiator_mod.step(init_state, scan.z, unused_z, scan.time,
                                  ais_for_init, shapes, params)
    init_state = init_out.state
    new_x, new_mask, new_mmsi = _merge_new_targets(
        init_out.new_x, init_out.new_mask, init_out.new_mmsi,
        params.merge_threshold)
    # global neighbour rejection: any shard's live leaf close by
    leaf_pos = state.leaf_x[..., :2].reshape(-1, 2)
    leaf_ok = state.leaf_mask.reshape(-1)
    d = jnp.linalg.norm(new_x[:, None, :2] - leaf_pos[None, :, :], axis=2)
    near_local = ((d < params.merge_threshold) & leaf_ok[None, :]).any(axis=1)
    near = jax.lax.psum(near_local.astype(jnp.int32), axis_name) > 0
    new_mask = new_mask & ~near
    # deal new target k to shard (k mod n_shards); ids come from the
    # replicated global rank so they are unique across shards and
    # next_id stays replicated.
    rank = jnp.cumsum(new_mask.astype(jnp.int32)) - 1
    mine = new_mask & ((rank % n_shards) == my_shard)
    new_ids = state.next_id + rank
    next_id_after = state.next_id + jnp.sum(new_mask.astype(jnp.int32))
    prev_mask = state.tgt_mask
    state = insert_targets(state, new_x, init_out.new_P, mine,
                           new_mmsi, scan.time, params, new_ids=new_ids)
    state = state.replace(next_id=next_id_after)

    # 9. on-device dynamic window, sharded twin of core/tracker.py's
    # (reference __dynamicWindow, tracker.py:918-950): saturation is
    # target-local; the load-share trigger compares each target's
    # gated-pair work against the GLOBAL scan total (one psum).
    if dynamic_window:
        T_l, L_l = state.leaf_mask.shape
        inserted = state.tgt_mask & ~prev_mask
        lc = jnp.sum(state.leaf_mask.astype(jnp.int32), axis=1)
        sat = state.tgt_mask & (lc >= L_l)
        proxy = lc.astype(jnp.float32) * (
            1.0 + g.gated_counts.astype(jnp.float32))
        total = jax.lax.psum(
            jnp.sum(jnp.where(state.tgt_mask, proxy, 0.0)), axis_name)
        share = params.max_target_time / params.radar_period
        over = (state.tgt_mask & (lc >= L_l // 2)
                & (proxy > share * jnp.maximum(total, 1.0)))
        shrink = (sat | over) & ~inserted
        state = state.replace(tgt_window=jnp.where(
            shrink, jnp.maximum(state.tgt_window - 1, 1),
            state.tgt_window))

    outs = dict(track_mask=track_mask, track_id=track_id, track_x=track_x,
                sel_hist_meas=sel_hist_meas, sel_obj=obj, sel_bound=lb,
                sel_feasible=feas, dead=term.dead,
                confirmed_mask=pr.confirmed_mask, confirmed_x=pr.confirmed_x,
                confirmed_meas=pr.confirmed_meas)
    return state, init_state, outs


def make_sharded_tracker_step(mesh: Mesh, shapes: TrackerShapes,
                              params: TrackerParams,
                              axis_name: str = 'cluster',
                              use_ais: bool = False,
                              ais_initialization: bool = True,
                              prune_similar: bool = False,
                              dynamic_window: bool = False,
                              select_impl: str = 'compact',
                              select_kw=None):
    """jitted shard_map wrapper over one full tracker scan.

    ``shapes`` describes the GLOBAL state (as built by ``empty_state``);
    its target axis shards over the mesh axis, so ``shapes.max_targets``
    must be divisible by the axis size.  Initiator state, scan and AIS
    inputs are replicated.  Track ids assigned by round-robin insertion
    come from the replicated global rank, so they are globally unique.
    """
    from jax import shard_map

    n_shards = mesh.shape[axis_name]
    assert shapes.max_targets % n_shards == 0
    T_g = shapes.max_targets

    def _state_spec(x):
        # arrays with a leading target axis shard; lam [S] and scalars
        # replicate.
        return P(axis_name) if (x.ndim >= 1 and x.shape[0] == T_g) else P()

    def fn(state, init_state, scan, ais):
        return sharded_scan_step(state, init_state, scan, ais,
                                 shapes, params, axis_name,
                                 use_ais=use_ais,
                                 ais_initialization=ais_initialization,
                                 prune_similar=prune_similar,
                                 dynamic_window=dynamic_window,
                                 select_impl=select_impl,
                                 select_kw=select_kw)

    def build(state, init_state, scan, ais):
        sspec = jax.tree_util.tree_map(_state_spec, state)
        rep_i = jax.tree_util.tree_map(lambda x: P(), init_state)
        rep_s = jax.tree_util.tree_map(lambda x: P(), scan)
        rep_a = jax.tree_util.tree_map(lambda x: P(), ais)
        out_specs = (sspec, rep_i,
                     dict(track_mask=P(axis_name), track_id=P(axis_name),
                          track_x=P(axis_name),
                          sel_hist_meas=P(axis_name),
                          sel_obj=P(), sel_bound=P(), sel_feasible=P(),
                          dead=P(axis_name),
                          confirmed_mask=P(axis_name),
                          confirmed_x=P(axis_name),
                          confirmed_meas=P(axis_name)))
        return jax.jit(shard_map(fn, mesh=mesh,
                                 in_specs=(sspec, rep_i, rep_s, rep_a),
                                 out_specs=out_specs))

    # one jitted program per input structure: a fresh jit per call would
    # trace and compile the whole step again every scan
    steps = {}

    def run(state, init_state, scan, ais):
        args = (state, init_state, scan, ais)
        key = jax.tree_util.tree_structure(args)
        if key not in steps:
            steps[key] = build(*args)
        return steps[key](*args)

    return run
