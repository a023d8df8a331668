"""Target-sharded selection with psum/pmin collectives: equality with the
single-device solver, feasibility under conflict-dense (infeasible
decode) instances, and the full sharded scan step."""
import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import Mesh
import pytest

from pymht_tpu.core.config import TrackerShapes, TrackerParams
from pymht_tpu.core.state import empty_state, insert_targets
from pymht_tpu.core.grow import Scan, empty_ais, grow
from pymht_tpu.core.select import select_lagrangian
from pymht_tpu.parallel.distributed_select import make_distributed_select
from pymht_tpu.models import pv

SHAPES = TrackerShapes(max_targets=8, max_leaves=8, max_meas=16,
                       max_ais=2, window=5)
PARAMS = TrackerParams(radar_period=2.5, P_d=0.85, lambda_phi=1e-5,
                       lambda_nu=1e-5, N=3)


def _conflicted_state(seed=0):
    """Grow a state where neighbouring targets share measurements."""
    rng = np.random.default_rng(seed)
    state = empty_state(SHAPES, PARAMS)
    # four close target pairs -> shared gates
    xs = np.zeros((8, 4), np.float32)
    for i in range(8):
        xs[i, :2] = [20 * (i // 2), 6 * (i % 2)]
        xs[i, 2:] = [1.0, 0.0]
    state = insert_targets(state, jnp.asarray(xs),
                           jnp.broadcast_to(pv.P0, (8, 4, 4)),
                           jnp.ones(8, bool), jnp.zeros(8, jnp.int32),
                           jnp.asarray(0.0), PARAMS)
    z = np.concatenate([
        xs[:, :2] + xs[:, 2:] * 2.5 + rng.normal(0, 1.0, (8, 2)),
        xs[:4, :2] + xs[:4, 2:] * 2.5 + np.array([0., 3.])
        + rng.normal(0, 1.0, (4, 2)),
        rng.normal(0, 100, (4, 2))]).astype(np.float32)
    scan = Scan(z=jnp.asarray(z), mask=jnp.ones(16, bool),
                time=jnp.asarray(2.5, jnp.float32))
    g = grow(state, scan, None, SHAPES, PARAMS)
    return g.state


def _monster_state(seed=3):
    """All eight targets packed around the origin sharing nearly every
    measurement: the independent decode is guaranteed infeasible, so the
    distributed repair machinery must engage."""
    rng = np.random.default_rng(seed)
    state = empty_state(SHAPES, PARAMS)
    xs = np.zeros((8, 4), np.float32)
    for i in range(8):
        xs[i, :2] = rng.normal(0, 2.0, 2)
        xs[i, 2:] = [1.0, 0.0]
    state = insert_targets(state, jnp.asarray(xs),
                           jnp.broadcast_to(pv.P0, (8, 4, 4)),
                           jnp.ones(8, bool), jnp.zeros(8, jnp.int32),
                           jnp.asarray(0.0), PARAMS)
    # fewer attractive measurements than targets
    z = np.concatenate([
        xs[:4, :2] + xs[:4, 2:] * 2.5 + rng.normal(0, 0.5, (4, 2)),
        rng.normal(0, 150, (12, 2))]).astype(np.float32)
    scan = Scan(z=jnp.asarray(z), mask=jnp.ones(16, bool),
                time=jnp.asarray(2.5, jnp.float32))
    g = grow(state, scan, None, SHAPES, PARAMS)
    return g.state


def test_distributed_matches_single_device():
    state = _conflicted_state()
    ref = select_lagrangian(state, SHAPES, PARAMS)

    mesh = Mesh(np.array(jax.devices()[:4]), ('cluster',))
    run = make_distributed_select(mesh, SHAPES, PARAMS, iters=60)
    sel, obj, lb, feas, lam = run(state)

    assert bool(feas)
    # objective must match the single-device solver's (both converge to
    # the same near-optimal incumbent on this instance)
    assert abs(float(obj) - float(ref.obj)) < 1e-3 * (1 + abs(float(ref.obj)))
    # and the lower bound must bound the objective
    assert float(lb) <= float(obj) + 1e-4


@pytest.mark.parametrize("ndev", [4, 8])
def test_distributed_repair_on_infeasible_decode(ndev):
    """Conflict-dense instance: the raw decode is infeasible; the
    distributed spine-priority repair must still return a feasible
    selection within 0.5% of the exact MILP oracle."""
    state = _monster_state()
    from pymht_tpu.core.select import _independent_best
    _, _, feas0 = _independent_best(state, SHAPES, PARAMS)
    assert not bool(feas0), "instance must start infeasible"

    mesh = Mesh(np.array(jax.devices()[:ndev]), ('cluster',))
    run = make_distributed_select(mesh, SHAPES, PARAMS, iters=60)
    sel, obj, lb, feas, lam = run(state)
    assert bool(feas)

    # verify feasibility of the returned selection directly
    from pymht_tpu.core.select import _slot_index
    slots, n_slots = _slot_index(state, SHAPES)
    sf = np.asarray(slots).reshape(8, SHAPES.max_leaves, -1)
    sel_np = np.asarray(sel)
    used = set()
    for t in range(8):
        for s in sf[t, sel_np[t]]:
            if s < n_slots:
                assert s not in used, "slot used twice"
                used.add(s)

    from pymht_tpu.utils.oracle import milp_select_oracle
    _, obj_o, optimal = milp_select_oracle(state, SHAPES, PARAMS)
    assert optimal
    assert float(obj) <= obj_o + 5e-3 * (1 + abs(obj_o))


def test_sharded_scan_step_matches_single_device():
    """Multi-scan e2e: the target-sharded full step tracks the same
    objects as the single-device step (pre-initialized slots compared on
    selected labels + states)."""
    from pymht_tpu.core.tracker import scan_step
    from pymht_tpu.core import initiator as initiator_mod
    from pymht_tpu.parallel.sharded_tracker import make_sharded_tracker_step

    shapes = TrackerShapes(max_targets=8, max_leaves=8, max_meas=16,
                           max_ais=2, window=5)
    params = TrackerParams(radar_period=2.5, P_d=0.9, lambda_phi=1e-6,
                           lambda_nu=1e-6, N=3, radar_range=float('inf'),
                           cnllr_upper_limit=1e9,
                           score_upper_limit_scale=1e6)
    rng = np.random.default_rng(5)
    xs = np.zeros((4, 4), np.float32)
    for i in range(4):
        xs[i, :2] = [30 * i, 3.0 * (i % 2)]
        xs[i, 2:] = [2.0, 0.0]

    def seed_state():
        st = empty_state(shapes, params)
        mask = np.zeros(8, bool)
        mask[:4] = True
        xs8 = np.zeros((8, 4), np.float32)
        xs8[:4] = xs
        return insert_targets(st, jnp.asarray(xs8),
                              jnp.broadcast_to(pv.P0, (8, 4, 4)),
                              jnp.asarray(mask), jnp.zeros(8, jnp.int32),
                              jnp.asarray(0.0), params)

    scans = []
    for k in range(4):
        t = 2.5 * (k + 1)
        z = np.concatenate([
            xs[:, :2] + xs[:, 2:] * t + rng.normal(0, 1.0, (4, 2)),
            xs[:2, :2] + xs[:2, 2:] * t + np.array([0., 2.5])
            + rng.normal(0, 1.0, (2, 2)),
        ]).astype(np.float32)
        zp = np.zeros((16, 2), np.float32)
        zp[:len(z)] = z
        mask = np.zeros(16, bool)
        mask[:len(z)] = True
        scans.append(Scan(z=jnp.asarray(zp), mask=jnp.asarray(mask),
                          time=jnp.asarray(t, jnp.float32)))

    # single device
    st1 = seed_state()
    ist1 = initiator_mod.empty_initiator(shapes)
    labels1, states1 = [], []
    for sc in scans:
        st1, ist1, out = scan_step(st1, ist1, sc, empty_ais(shapes),
                                   shapes, params, method='lagrangian',
                                   use_ais=False)
        labels1.append(np.asarray(out.sel_hist_meas)[:4, -1])
        states1.append(np.asarray(out.track_x)[:4])

    # sharded (4 devices x 2 targets)
    mesh = Mesh(np.array(jax.devices()[:4]), ('cluster',))
    step = make_sharded_tracker_step(mesh, shapes, params)
    st2 = seed_state()
    ist2 = initiator_mod.empty_initiator(shapes)
    labels2, states2 = [], []
    for sc in scans:
        st2, ist2, out = step(st2, ist2, sc, empty_ais(shapes))
        labels2.append(np.asarray(out['sel_hist_meas'])[:4, -1])
        states2.append(np.asarray(out['track_x'])[:4])

    for k in range(len(scans)):
        np.testing.assert_array_equal(labels1[k], labels2[k],
                                      err_msg=f"scan {k}")
        np.testing.assert_allclose(states1[k], states2[k], atol=1e-4,
                                   err_msg=f"scan {k}")


def test_sharded_scan_step_matches_single_device_with_ais():
    """Same multi-scan sharded-vs-single equality, but with AIS fusion
    AND AIS-aided initiation active: two targets carry transponders
    (one high- one low-accuracy, matching MMSIs pre-assigned), one AIS
    message belongs to no track (available for initiation).  Selected
    labels, states, AND the psum'd used-MMSI exclusion must agree with
    the single-device step scan by scan."""
    from pymht_tpu.core.tracker import scan_step
    from pymht_tpu.core import initiator as initiator_mod
    from pymht_tpu.core.grow import AisBatch
    from pymht_tpu.parallel.sharded_tracker import make_sharded_tracker_step

    shapes = TrackerShapes(max_targets=8, max_leaves=8, max_meas=16,
                           max_ais=4, window=5, max_prelim=8,
                           max_initiators=16, ais_per_leaf=2)
    params = TrackerParams(radar_period=2.5, P_d=0.9, lambda_phi=1e-6,
                           lambda_nu=1e-6, N=3, radar_range=float('inf'),
                           cnllr_upper_limit=1e9,
                           score_upper_limit_scale=1e6)
    rng = np.random.default_rng(9)
    xs = np.zeros((4, 4), np.float32)
    for i in range(4):
        xs[i, :2] = [40 * i, 4.0 * (i % 2)]
        xs[i, 2:] = [2.0, 0.5]
    mmsi = np.array([111000001, 111000002, 0, 0], np.int32)

    def seed_state():
        st = empty_state(shapes, params)
        mask = np.zeros(8, bool)
        mask[:4] = True
        xs8 = np.zeros((8, 4), np.float32)
        xs8[:4] = xs
        mm8 = np.zeros(8, np.int32)
        mm8[:4] = mmsi
        return insert_targets(st, jnp.asarray(xs8),
                              jnp.broadcast_to(pv.P0, (8, 4, 4)),
                              jnp.asarray(mask), jnp.asarray(mm8),
                              jnp.asarray(0.0), params)

    scans, batches = [], []
    for k in range(4):
        t = 2.5 * (k + 1)
        z = (xs[:, :2] + xs[:, 2:] * t
             + rng.normal(0, 1.0, (4, 2))).astype(np.float32)
        zp = np.zeros((16, 2), np.float32)
        zp[:4] = z
        mask = np.zeros(16, bool)
        mask[:4] = True
        scans.append(Scan(z=jnp.asarray(zp), mask=jnp.asarray(mask),
                          time=jnp.asarray(t, jnp.float32)))
        ast = np.zeros((4, 4), np.float32)
        ast[0] = xs[0] + np.concatenate(
            [xs[0, 2:] * (t - 0.9), [0, 0]]).astype(np.float32)
        ast[1] = xs[1] + np.concatenate(
            [xs[1, 2:] * (t - 1.4), [0, 0]]).astype(np.float32)
        ast[2] = [500.0 + 2.0 * t, 300.0, 2.0, 0.0]   # no matching track
        batches.append(AisBatch(
            state=jnp.asarray(ast),
            time=jnp.asarray([t - 0.9, t - 1.4, t - 1.0, 0.0], jnp.float32),
            mmsi=jnp.asarray([111000001, 111000002, 222000009, 0],
                             jnp.int32),
            high_accuracy=jnp.asarray([True, False, True, False]),
            mask=jnp.asarray([True, True, True, False])))

    st1 = seed_state()
    ist1 = initiator_mod.empty_initiator(shapes)
    labels1, states1, ais_labels1 = [], [], []
    for sc, ab in zip(scans, batches):
        st1, ist1, out = scan_step(st1, ist1, sc, ab, shapes, params,
                                   method='lagrangian', use_ais=True)
        labels1.append(np.asarray(out.sel_hist_meas)[:4, -1])
        states1.append(np.asarray(out.track_x)[:4])
        ais_labels1.append(np.asarray(st1.hist_ais)[
            np.arange(8), np.asarray(st1.sel_leaf), -1][:4])

    mesh = Mesh(np.array(jax.devices()[:4]), ('cluster',))
    step = make_sharded_tracker_step(mesh, shapes, params, use_ais=True)
    st2 = seed_state()
    ist2 = initiator_mod.empty_initiator(shapes)
    labels2, states2, ais_labels2 = [], [], []
    for sc, ab in zip(scans, batches):
        st2, ist2, out = step(st2, ist2, sc, ab)
        labels2.append(np.asarray(out['sel_hist_meas'])[:4, -1])
        states2.append(np.asarray(out['track_x'])[:4])
        ais_labels2.append(np.asarray(st2.hist_ais)[
            np.arange(8), np.asarray(st2.sel_leaf), -1][:4])

    fused_any = False
    for k in range(len(scans)):
        np.testing.assert_array_equal(labels1[k], labels2[k],
                                      err_msg=f"scan {k} meas labels")
        np.testing.assert_array_equal(ais_labels1[k], ais_labels2[k],
                                      err_msg=f"scan {k} ais labels")
        np.testing.assert_allclose(states1[k], states2[k], atol=1e-4,
                                   err_msg=f"scan {k}")
        fused_any |= bool((ais_labels1[k] > 0).any())
    assert fused_any, "scenario never exercised AIS fusion"


def test_sharded_dynamic_window_matches_single_device():
    """The sharded step's on-device dynamic window must shrink the same
    targets' windows as the single-device step (saturation is local;
    the load-share trigger psums the global work total)."""
    from pymht_tpu.core.tracker import scan_step
    from pymht_tpu.core import initiator as initiator_mod
    from pymht_tpu.parallel.sharded_tracker import make_sharded_tracker_step

    shapes = TrackerShapes(max_targets=8, max_leaves=4, max_meas=16,
                           max_ais=2, window=6)
    params = TrackerParams(radar_period=2.5, P_d=0.9, lambda_phi=1e-6,
                           lambda_nu=1e-6, N=4, radar_range=float('inf'),
                           cnllr_upper_limit=1e9,
                           score_upper_limit_scale=1e6)
    rng = np.random.default_rng(2)
    xs = np.zeros((8, 4), np.float32)
    xs[0] = [0.0, 0.0, 1.0, 0.0]          # will be clutter-saturated
    xs[1] = [200.0, 200.0, -1.0, 0.0]     # coasts (no detections)

    def seed_state():
        st = empty_state(shapes, params)
        mask = np.zeros(8, bool)
        mask[:2] = True
        return insert_targets(st, jnp.asarray(xs),
                              jnp.broadcast_to(pv.P0, (8, 4, 4)),
                              jnp.asarray(mask), jnp.zeros(8, jnp.int32),
                              jnp.asarray(0.0), params)

    scans = []
    for k in range(5):
        t = 2.5 * (k + 1)
        z = (np.array([[t, 0.0]]) + rng.normal(0, 1.5, (8, 2))
             ).astype(np.float32)
        zp = np.zeros((16, 2), np.float32)
        zp[:8] = z
        mask = np.zeros(16, bool)
        mask[:8] = True
        scans.append(Scan(z=jnp.asarray(zp), mask=jnp.asarray(mask),
                          time=jnp.asarray(t, jnp.float32)))

    st1, ist1 = seed_state(), initiator_mod.empty_initiator(shapes)
    for sc in scans:
        st1, ist1, _ = scan_step(st1, ist1, sc, empty_ais(shapes),
                                 shapes, params, method='lagrangian',
                                 use_ais=False, dynamic_window=True)

    mesh = Mesh(np.array(jax.devices()[:4]), ('cluster',))
    step = make_sharded_tracker_step(mesh, shapes, params,
                                     dynamic_window=True)
    st2, ist2 = seed_state(), initiator_mod.empty_initiator(shapes)
    for sc in scans:
        st2, ist2, _ = step(st2, ist2, sc, empty_ais(shapes))

    tw1 = np.asarray(st1.tgt_window)[:2]
    tw2 = np.asarray(st2.tgt_window)[:2]
    np.testing.assert_array_equal(tw1, tw2)
    assert tw1[0] < params.N, f"saturated target kept N: {tw1}"
    assert tw1[1] == params.N, f"coasting target shrank: {tw1}"


def test_compact_fast_path_conflict_free():
    """When the independent per-target optima are globally conflict-free
    the compact distributed select must return exactly the argmin
    selection with obj == bound (tier-0 short-circuit, round-5)."""
    rng = np.random.default_rng(4)
    state = empty_state(SHAPES, PARAMS)
    # far-apart targets: no shared gates
    xs = np.zeros((8, 4), np.float32)
    for i in range(8):
        xs[i, :2] = [300.0 * i, 200.0 * (i % 2)]
        xs[i, 2:] = [1.0, 0.0]
    state = insert_targets(state, jnp.asarray(xs),
                           jnp.broadcast_to(pv.P0, (8, 4, 4)),
                           jnp.ones(8, bool), jnp.zeros(8, jnp.int32),
                           jnp.asarray(0.0), PARAMS)
    z = (xs[:, :2] + xs[:, 2:] * 2.5
         + rng.normal(0, 1.0, (8, 2))).astype(np.float32)
    zp = np.zeros((16, 2), np.float32); zp[:8] = z
    mask = np.zeros(16, bool); mask[:8] = True
    scan = Scan(z=jnp.asarray(zp), mask=jnp.asarray(mask),
                time=jnp.asarray(2.5, jnp.float32))
    g = grow(state, scan, None, SHAPES, PARAMS)
    st = g.state

    from pymht_tpu.core.select import leaf_scores, _independent_best
    sel0, obj0, feas0 = _independent_best(st, SHAPES, PARAMS)
    assert bool(feas0), "scene must be conflict-free"

    mesh = Mesh(np.array(jax.devices()[:4]), ('cluster',))
    run = make_distributed_select(mesh, SHAPES, PARAMS, impl='compact')
    sel, obj, lb, feas, lam = run(st)
    assert bool(feas)
    np.testing.assert_array_equal(np.asarray(sel), np.asarray(sel0))
    assert abs(float(obj) - float(obj0)) < 1e-5 * (1 + abs(float(obj0)))
    assert abs(float(obj) - float(lb)) < 1e-6 * (1 + abs(float(obj)))


def test_compact_matches_full_impl_on_conflicts():
    """Compact and full-slot distributed selections must agree on the
    conflicted instance (same incumbent quality, both feasible)."""
    state = _conflicted_state()
    mesh = Mesh(np.array(jax.devices()[:4]), ('cluster',))
    out_c = make_distributed_select(mesh, SHAPES, PARAMS,
                                    impl='compact')(state)
    out_f = make_distributed_select(mesh, SHAPES, PARAMS,
                                    impl='full')(state)
    assert bool(out_c[3]) and bool(out_f[3])
    oc, of = float(out_c[1]), float(out_f[1])
    assert abs(oc - of) < 1e-3 * (1 + abs(of)), (oc, of)
