"""grow()'s spatial pre-gate (shapes.radar_cand_width) against the
exact full-M path."""


def test_pregate_matches_exact_grow():
    """Spatial pre-gate (shapes.radar_cand_width): with Km covering all
    gated measurements the beam decisions must match the exact full-M
    path — labels, scores, states, used_meas (round-5, grow O(T*M)
    work)."""
    import dataclasses
    import numpy as np
    import jax.numpy as jnp
    from pymht_tpu.core.config import TrackerShapes, TrackerParams
    from pymht_tpu.core.state import empty_state, insert_targets
    from pymht_tpu.core.grow import Scan, AisBatch, grow
    from pymht_tpu.models import pv

    shapes = TrackerShapes(max_targets=8, max_leaves=8, max_meas=32,
                           max_ais=4, window=5, ais_per_leaf=2)
    params = TrackerParams(radar_period=2.5, P_d=0.9, lambda_phi=2e-6,
                           lambda_nu=1e-6, N=3)
    rng = np.random.default_rng(21)
    xs = np.zeros((8, 4), np.float32)
    for i in range(6):
        xs[i, :2] = [60.0 * i, 10.0 * (i % 3)]
        xs[i, 2:] = rng.normal(0, 2.0, 2)
    st0 = empty_state(shapes, params)
    mask = np.zeros(8, bool); mask[:6] = True
    mm = np.zeros(8, np.int32); mm[0] = 111000001
    st0 = insert_targets(st0, jnp.asarray(xs),
                         jnp.broadcast_to(pv.P0, (8, 4, 4)),
                         jnp.asarray(mask), jnp.asarray(mm),
                         jnp.asarray(0.0), params)
    z = np.concatenate([
        xs[:6, :2] + xs[:6, 2:] * 2.5 + rng.normal(0, 1.0, (6, 2)),
        xs[:3, :2] + xs[:3, 2:] * 2.5 + rng.normal(0, 2.0, (3, 2)),
        rng.uniform(-200, 500, (10, 2))]).astype(np.float32)
    zp = np.zeros((32, 2), np.float32); zp[:len(z)] = z
    zm = np.zeros(32, bool); zm[:len(z)] = True
    scan = Scan(z=jnp.asarray(zp), mask=jnp.asarray(zm),
                time=jnp.asarray(2.5, jnp.float32))
    ab = AisBatch(
        state=jnp.asarray(np.stack([xs[0] + [2.0, 0, 0, 0],
                                    np.zeros(4), np.zeros(4),
                                    np.zeros(4)]).astype(np.float32)),
        time=jnp.asarray([1.6, 0, 0, 0], jnp.float32),
        mmsi=jnp.asarray([111000001, 0, 0, 0], jnp.int32),
        high_accuracy=jnp.asarray([True, False, False, False]),
        mask=jnp.asarray([True, False, False, False]))

    g_exact = grow(st0, scan, ab, shapes, params)
    # Km = max_meas - 1 (< M so the pre-gate path compiles, but every
    # valid measurement is within each target's Km nearest: only one
    # padded slot is dropped)
    shapes_p = dataclasses.replace(shapes, radar_cand_width=31)
    g_pre = grow(st0, scan, ab, shapes_p, params)

    np.testing.assert_array_equal(
        np.asarray(g_exact.state.hist_meas[:, :, -1]),
        np.asarray(g_pre.state.hist_meas[:, :, -1]))
    np.testing.assert_array_equal(
        np.asarray(g_exact.state.hist_ais[:, :, -1]),
        np.asarray(g_pre.state.hist_ais[:, :, -1]))
    np.testing.assert_allclose(np.asarray(g_exact.state.leaf_cnllr),
                               np.asarray(g_pre.state.leaf_cnllr),
                               atol=1e-5)
    np.testing.assert_allclose(np.asarray(g_exact.state.leaf_x),
                               np.asarray(g_pre.state.leaf_x), atol=1e-4)
    np.testing.assert_array_equal(np.asarray(g_exact.used_meas),
                                  np.asarray(g_pre.used_meas))
    np.testing.assert_array_equal(np.asarray(g_exact.gated_counts),
                                  np.asarray(g_pre.gated_counts))
    # and with a TIGHT Km the labels must still match on this scene
    # (every gated measurement is among the 8 nearest here)
    shapes_t = dataclasses.replace(shapes, radar_cand_width=8)
    g_tight = grow(st0, scan, ab, shapes_t, params)
    np.testing.assert_array_equal(
        np.asarray(g_exact.state.hist_meas[:, :, -1]),
        np.asarray(g_tight.state.hist_meas[:, :, -1]))
