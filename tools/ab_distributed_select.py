#!/usr/bin/env python
"""A/B: full-slot vs compact contested-slot distributed selection.

Same 8-device CPU mesh, same conflicted swarm-shape instance, both
implementations of parallel/distributed_select:

* 'full'    — round-3/4 formulation: scatter-built [n_slots] usage
  counts psum'd per iteration, [n_slots] pmin keys per repair round.
* 'compact' — round-5 production: contested-slot compaction, [CAP]
  psum/pmin per iteration, no scatters into the slot space.

Reported:
1. wall time per call at two iteration budgets; the delta/(K2-K1) is
   the CPU per-iteration cost (CPU kernel times do NOT transfer to a
   GPU).
2. HLO collective inventory (count + bytes) whole-program and inside
   while bodies (per Lagrangian iteration) for both programs — the
   hardware-independent evidence that per-iteration all-reduce payload
   dropped ~n_slots/CAP x.
3. equality of the two selections' objectives on the instance.

Run CPU-only:
  env JAX_PLATFORMS=cpu XLA_FLAGS=--xla_force_host_platform_device_count=8 \
    python tools/ab_distributed_select.py
"""
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import jax.numpy as jnp
from jax.sharding import Mesh

from scaling_artifact import hlo_collectives, while_body_text  # noqa: E402


def build_state(shapes, params, n_tgt, seed=11):
    """Swarm-shape post-grow forest with dense conflicts (targets packed
    so gates overlap heavily)."""
    from pymht_tpu.core.state import empty_state, insert_targets
    from pymht_tpu.core.grow import Scan, grow
    from pymht_tpu.models import pv

    rng = np.random.default_rng(seed)
    T = shapes.max_targets
    M = shapes.max_meas
    st = empty_state(shapes, params)
    xs = np.zeros((T, 4), np.float32)
    # pairs/triples of targets near shared gates (realistic swarm
    # conflict density: the bench swarm has ~200 contested slots; an
    # all-dense instance overflows any CAP and only tests the spine
    # retreat)
    for i in range(n_tgt):
        c = i // 3
        xs[i, :2] = [150.0 * (c % 64), 150.0 * (c // 64)]
        xs[i, :2] += rng.normal(0, 8.0, 2)
        xs[i, 2:] = rng.normal(0, 3.0, 2)
    mask = np.zeros(T, bool)
    mask[:n_tgt] = True
    st = insert_targets(st, jnp.asarray(xs),
                        jnp.broadcast_to(pv.P0, (T, 4, 4)),
                        jnp.asarray(mask), jnp.zeros(T, jnp.int32),
                        jnp.asarray(0.0), params)
    # measurements: ~0.7 per target near the predictions + clutter
    z = np.zeros((M, 2), np.float32)
    zmask = np.zeros(M, bool)
    n_near = min(int(0.7 * n_tgt), int(0.9 * M))
    pick = rng.choice(n_tgt, n_near, replace=False)
    z[:n_near] = (xs[pick, :2] + xs[pick, 2:] * params.radar_period
                  + rng.normal(0, 2.0, (n_near, 2)))
    n_clut = min(M - n_near, n_tgt // 2)
    z[n_near:n_near + n_clut] = rng.uniform(0, 6400, (n_clut, 2))
    zmask[:n_near + n_clut] = True
    scan = Scan(z=jnp.asarray(z), mask=jnp.asarray(zmask),
                time=jnp.asarray(params.radar_period, jnp.float32))
    g = grow(st, scan, None, shapes, params)
    return g.state


def make_select(mesh, shapes, params, impl, iters, **kw):
    from pymht_tpu.parallel.distributed_select import make_distributed_select
    return make_distributed_select(mesh, shapes, params, iters=iters,
                                   impl=impl, **kw)


def lowered_text(mesh, shapes, params, impl, iters, state, **kw):
    from jax import shard_map
    from jax.sharding import PartitionSpec as P
    from pymht_tpu.parallel.distributed_select import (
        distributed_lagrangian, distributed_select_compact)

    def spec_of(x):
        return P('cluster') if (x.ndim >= 1
                                and x.shape[0] == shapes.max_targets) else P()

    def fn(st):
        if impl == 'compact':
            return distributed_select_compact(st, shapes, params, 'cluster',
                                              iters=iters, **kw)
        return distributed_lagrangian(st, shapes, params, 'cluster',
                                      iters=iters, **kw)

    specs = jax.tree_util.tree_map(spec_of, state)
    sm = shard_map(fn, mesh=mesh, in_specs=(specs,),
                   out_specs=(P('cluster'), P(), P(), P(), P()))
    return jax.jit(sm).lower(state).compile().as_text()


def main():
    from pymht_tpu.core.config import TrackerShapes, TrackerParams

    # swarm target axis at production scale; M sized to keep the CPU
    # A/B tractable (n_slots = W*(M+A) = 3264 — the full-slot loop's
    # vectors scale with this, the compact loop's with CAP=256)
    shapes = TrackerShapes(max_targets=1024, max_leaves=8, max_meas=512,
                           max_ais=32, window=6)
    params = TrackerParams(radar_period=2.5, P_d=0.85, lambda_phi=2e-6,
                           lambda_nu=1e-6, N=4)
    n_slots = shapes.window * (shapes.max_meas + shapes.max_ais)
    state = build_state(shapes, params, n_tgt=1000)
    CAP = 512

    # host-side contested-slot count for context (a CAP overflow means
    # the compact run only measured the spine-retreat guard)
    from pymht_tpu.core.select import _hist_usage
    usage = np.asarray(_hist_usage(state, shapes))        # [T, W, M+A]
    n_cont = int((usage.sum(axis=0) >= 2).sum())

    mesh = Mesh(np.array(jax.devices()[:8]), ('cluster',))

    res = {'metric': 'distributed_select_ab',
           'hardware': (f'8 virtual CPU devices on {os.cpu_count()} cores '
                        '(timing = CPU op-class comparison only)'),
           'shape': {'T': shapes.max_targets, 'L': shapes.max_leaves,
                     'M': shapes.max_meas, 'A': shapes.max_ais,
                     'n_slots': n_slots, 'contested_cap': CAP,
                     'n_contested_slots': n_cont}}

    K1, K2 = 10, 40
    for impl in ('full', 'compact'):
        kw = ({'fast_path': False, 'contested_cap': CAP}
              if impl == 'compact' else {})
        entry = {}
        objs = {}
        # force_iters pins the while loop to exactly K bodies (no
        # convergence/patience exits), so the K2-K1 wall-time delta IS
        # the cost of (K2-K1) loop iterations.
        for K in (K1, K2):
            run = make_select(mesh, shapes, params, impl, iters=K,
                              **dict(kw, force_iters=True))
            out = run(state)
            jax.block_until_ready(out)
            ts = []
            for _ in range(3):
                t0 = time.time()
                out = run(state)
                jax.block_until_ready(out)
                ts.append(time.time() - t0)
            sel, obj, lb, feas, lam = out
            entry[f'ms_iters_{K}'] = round(float(np.median(ts)) * 1000, 2)
            objs[K] = (float(obj), float(lb), bool(feas))
        entry['ms_per_iteration_cpu'] = round(
            (entry[f'ms_iters_{K2}'] - entry[f'ms_iters_{K1}']) / (K2 - K1),
            3)
        entry['obj'], entry['lb'], entry['feasible'] = objs[K2]
        text = lowered_text(mesh, shapes, params, impl, 60, state, **kw)
        entry['collectives_whole_program'] = hlo_collectives(text)
        entry['collectives_per_while_iteration'] = hlo_collectives(
            while_body_text(text))
        res[impl] = entry
        print(impl, json.dumps(entry, indent=1), flush=True)

    f_b = res['full']['collectives_per_while_iteration'].get(
        'all-reduce', {}).get('bytes', 0)
    c_b = res['compact']['collectives_per_while_iteration'].get(
        'all-reduce', {}).get('bytes', 0)
    res['per_iteration_allreduce_bytes_ratio'] = (
        round(f_b / c_b, 1) if c_b else None)

    # solution-quality equality under the production exits
    conv = {}
    for impl in ('full', 'compact'):
        kw = ({'fast_path': False, 'contested_cap': CAP}
              if impl == 'compact' else {})
        run = make_select(mesh, shapes, params, impl, iters=60, **kw)
        sel, obj, lb, feas, lam = run(state)
        conv[impl] = {'obj': float(obj), 'lb': float(lb),
                      'feasible': bool(feas)}
    res['converged'] = conv
    d_obj = abs(conv['full']['obj'] - conv['compact']['obj'])
    res['obj_rel_delta'] = round(
        d_obj / (1 + abs(conv['full']['obj'])), 6)

    # per-iteration collective inventory at the REAL swarm bench shapes
    # (n_slots = 6*(2048+128) = 13056) — compile-only, no timing
    sw_shapes = TrackerShapes(max_targets=1024, max_leaves=16,
                              max_meas=2048, max_ais=128, window=6,
                              ais_per_leaf=2)
    sw_state = build_state(sw_shapes, params, n_tgt=256, seed=5)
    sw = {}
    for impl in ('full', 'compact'):
        kw = ({'fast_path': False, 'contested_cap': 256}
              if impl == 'compact' else {})
        text = lowered_text(mesh, sw_shapes, params, impl, 60, sw_state,
                            **kw)
        sw[impl] = {
            'whole_program': hlo_collectives(text),
            'per_while_iteration': hlo_collectives(while_body_text(text))}
    sw_f = sw['full']['per_while_iteration'].get('all-reduce',
                                                 {}).get('bytes', 0)
    sw_c = sw['compact']['per_while_iteration'].get('all-reduce',
                                                    {}).get('bytes', 0)
    res['swarm_shape_collectives'] = {
        'n_slots': sw_shapes.window * (sw_shapes.max_meas
                                       + sw_shapes.max_ais),
        **sw,
        'per_iteration_allreduce_bytes_ratio':
            round(sw_f / sw_c, 1) if sw_c else None}

    out_path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), 'dist_select_ab_cpu.json')
    with open(out_path, 'w') as f:
        json.dump(res, f, indent=1)
    print('wrote', out_path, flush=True)


if __name__ == '__main__':
    main()
