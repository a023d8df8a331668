"""Parity tests of the batched Kalman ops against the reference formulas,
restated as a float64 NumPy oracle in ``pymht_tpu.utils.kalman_ref``.
"""
import numpy as np
import jax.numpy as jnp
import pytest

from pymht_tpu.models import pv
from pymht_tpu.ops import kalman as k
from pymht_tpu.utils import kalman_ref


@pytest.fixture(scope="module")
def ref_kalman():
    # (kalman module, pv module) of the oracle: one module serves both
    return kalman_ref, kalman_ref


def _random_states(n, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, 4)).astype(np.float32) * 10
    L = rng.normal(size=(n, 4, 4)).astype(np.float32)
    P = L @ np.transpose(L, (0, 2, 1)) + np.eye(4, dtype=np.float32) * 2
    return x, P


def test_inv2x2_and_det():
    rng = np.random.default_rng(1)
    L = rng.normal(size=(7, 2, 2))
    S = L @ np.transpose(L, (0, 2, 1)) + np.eye(2) * 0.5
    np.testing.assert_allclose(np.asarray(k.inv2x2(S)), np.linalg.inv(S), rtol=1e-5)
    np.testing.assert_allclose(np.asarray(k.det2x2(S)), np.linalg.det(S), rtol=1e-5)


def test_inv4x4_and_det():
    rng = np.random.default_rng(2)
    L = rng.normal(size=(5, 4, 4))
    S = L @ np.transpose(L, (0, 2, 1)) + np.eye(4) * 0.5
    np.testing.assert_allclose(np.asarray(k.inv4x4(S)), np.linalg.inv(S), rtol=1e-4)
    np.testing.assert_allclose(np.asarray(k.det4x4(S)), np.linalg.det(S), rtol=1e-4)


def test_predict_parity(ref_kalman):
    ref_k, ref_pv = ref_kalman
    x, P = _random_states(10)
    A = np.asarray(ref_pv.Phi(2.5))
    Q = np.asarray(ref_pv.Q(2.5))
    ref_x, ref_P = ref_k.predict(A, Q, x, P)
    out_x, out_P = k.predict(jnp.asarray(A), jnp.asarray(Q), jnp.asarray(x), jnp.asarray(P))
    np.testing.assert_allclose(np.asarray(out_x), ref_x, rtol=1e-5)
    np.testing.assert_allclose(np.asarray(out_P), ref_P, rtol=1e-4, atol=1e-4)


def test_precalc_parity(ref_kalman):
    ref_k, ref_pv = ref_kalman
    x, P = _random_states(10, seed=3)
    C = np.asarray(ref_pv.C_RADAR)
    R = np.asarray(ref_pv.R_RADAR())
    ref_z, ref_S, ref_Sinv, ref_K, ref_Phat = ref_k.precalc(C, R, x, P)
    z, S, Sinv, K, Phat = k.precalc(jnp.asarray(C), jnp.asarray(R), jnp.asarray(x), jnp.asarray(P))
    np.testing.assert_allclose(np.asarray(z), ref_z, rtol=1e-5)
    np.testing.assert_allclose(np.asarray(S), ref_S, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(np.asarray(Sinv), ref_Sinv, rtol=1e-3, atol=1e-4)
    np.testing.assert_allclose(np.asarray(K), ref_K, rtol=1e-3, atol=1e-4)
    np.testing.assert_allclose(np.asarray(Phat), ref_Phat, rtol=1e-3, atol=1e-3)


def test_nis_and_residual_parity(ref_kalman):
    ref_k, ref_pv = ref_kalman
    x, P = _random_states(6, seed=4)
    C = np.asarray(ref_pv.C_RADAR)
    R = np.asarray(ref_pv.R_RADAR())
    rng = np.random.default_rng(5)
    z = rng.normal(size=(9, 2)).astype(np.float32) * 10

    ref_z_hat, ref_S, ref_Sinv, _, _ = ref_k.precalc(C, R, x, P)
    ref_zt = ref_k.z_tilde(z, ref_z_hat)
    ref_nis = ref_k.normalizedInnovationSquared(ref_zt, ref_Sinv)

    z_hat, S, Sinv, _, _ = k.precalc(jnp.asarray(C), jnp.asarray(R), jnp.asarray(x), jnp.asarray(P))
    zt = k.residuals(jnp.asarray(z), z_hat)
    out_nis = k.nis(zt, Sinv)
    np.testing.assert_allclose(np.asarray(zt), ref_zt, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(np.asarray(out_nis), ref_nis, rtol=1e-3, atol=1e-3)


def test_nllr_parity(ref_kalman):
    ref_k, ref_pv = ref_kalman
    x, P = _random_states(6, seed=6)
    C = np.asarray(ref_pv.C_RADAR)
    R = np.asarray(ref_pv.R_RADAR())
    _, S, Sinv, _, _ = [np.asarray(a) for a in
                        k.precalc(jnp.asarray(C), jnp.asarray(R), jnp.asarray(x), jnp.asarray(P))]
    nis_vals = np.abs(np.random.default_rng(7).normal(size=(6, 3))).astype(np.float32)
    lambda_ex, P_d = 2e-5, 0.8
    ref_rows = ref_k.nllr(lambda_ex, P_d, S, nis_vals)
    out = k.nllr(lambda_ex, P_d, jnp.asarray(S), jnp.asarray(nis_vals))
    np.testing.assert_allclose(np.asarray(out), ref_rows, rtol=1e-4, atol=1e-4)


def test_filter_update_parity(ref_kalman):
    ref_k, ref_pv = ref_kalman
    x, P = _random_states(1, seed=8)
    C = np.asarray(ref_pv.C_RADAR)
    R = np.asarray(ref_pv.R_RADAR())
    _, _, _, K, _ = [np.asarray(a) for a in
                     k.precalc(jnp.asarray(C), jnp.asarray(R), jnp.asarray(x), jnp.asarray(P))]
    zt = np.random.default_rng(9).normal(size=(5, 2)).astype(np.float32)
    ref_xhat = ref_k.numpyFilter(x[0], K[0], zt)
    out = k.filter_update(jnp.asarray(x[0]), jnp.asarray(K[0]), jnp.asarray(zt))
    np.testing.assert_allclose(np.asarray(out), ref_xhat, rtol=1e-4, atol=1e-4)


def test_nllr_missed():
    np.testing.assert_allclose(float(k.nllr_missed(0.8)), -np.log(0.2), rtol=1e-6)
