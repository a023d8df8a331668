"""Batched Kalman-filter primitives.

This is the op contract of the reference's kalman module
(/root/reference/pymht/utils/kalman.py:14-101): predict / precalc /
residuals / NIS / NLLR, deliberately batched over arbitrary leading axes
(nodes, targets, scenarios).  Two deltas from the reference:

* no ``np.linalg.inv``: innovation covariances are 2x2 (radar) or 4x4
  (AIS); both are inverted in closed form (4x4 via 2x2 block Schur
  complement), as elementwise math with no LAPACK-style ops;
* everything is shape-polymorphic over leading batch axes so the same
  functions serve single nodes, per-target leaf tables and whole
  scenario batches under vmap/jit.

The Kalman products (predict, precalc, NIS, filter update) ask for
``HIGHEST`` precision: at the default, a GPU with tensor cores may round
float32 operands to TF32 (10-bit mantissa), which put their results
45-14000x outside the float32 tolerances of chip_smoke.py phase b
against the float64 oracle on an H100.  The 2x2-block products of
``inv4x4``/``det4x4`` met their tolerance at the default.
"""
import jax
import jax.numpy as jnp

HIGHEST = jax.lax.Precision.HIGHEST

_LOG2PI = float(jnp.log(2.0 * jnp.pi))


def inv2x2(S):
    """Closed-form inverse of batched 2x2 matrices (..., 2, 2)."""
    a = S[..., 0, 0]
    b = S[..., 0, 1]
    c = S[..., 1, 0]
    d = S[..., 1, 1]
    det = a * d - b * c
    inv_det = 1.0 / det
    row0 = jnp.stack([d * inv_det, -b * inv_det], axis=-1)
    row1 = jnp.stack([-c * inv_det, a * inv_det], axis=-1)
    return jnp.stack([row0, row1], axis=-2)


def det2x2(S):
    return S[..., 0, 0] * S[..., 1, 1] - S[..., 0, 1] * S[..., 1, 0]


def inv4x4(S):
    """Closed-form inverse of batched 4x4 matrices via 2x2 block Schur.

    Assumes the leading 2x2 block is invertible (always true for the SPD
    innovation covariances this is used on).
    """
    A = S[..., :2, :2]
    B = S[..., :2, 2:]
    C = S[..., 2:, :2]
    D = S[..., 2:, 2:]
    Ainv = inv2x2(A)
    # Schur complement of A
    M = D - C @ Ainv @ B
    Minv = inv2x2(M)
    AinvB = Ainv @ B
    CAinv = C @ Ainv
    top_left = Ainv + AinvB @ Minv @ CAinv
    top_right = -AinvB @ Minv
    bot_left = -Minv @ CAinv
    bot_right = Minv
    top = jnp.concatenate([top_left, top_right], axis=-1)
    bot = jnp.concatenate([bot_left, bot_right], axis=-1)
    return jnp.concatenate([top, bot], axis=-2)


def det4x4(S):
    """det via the same 2x2 block Schur factorisation: det(A) det(D - C A^-1 B)."""
    A = S[..., :2, :2]
    B = S[..., :2, 2:]
    C = S[..., 2:, :2]
    D = S[..., 2:, 2:]
    M = D - C @ inv2x2(A) @ B
    return det2x2(A) * det2x2(M)


def inv_psd(S):
    dim = S.shape[-1]
    if dim == 2:
        return inv2x2(S)
    if dim == 4:
        return inv4x4(S)
    return jnp.linalg.inv(S)


def det_psd(S):
    dim = S.shape[-1]
    if dim == 2:
        return det2x2(S)
    if dim == 4:
        return det4x4(S)
    return jnp.linalg.det(S)


def predict(A, Q, x, P):
    """Batched time update (reference kalman.py:55-64).

    A: (4, 4), Q: (4, 4); x: (..., 4), P: (..., 4, 4).
    Returns x_bar (..., 4), P_bar (..., 4, 4).
    """
    x_bar = jnp.einsum('ij,...j->...i', A, x, precision=HIGHEST)
    P_bar = jnp.einsum('ij,...jk,lk->...il', A, P, A,
                       precision=HIGHEST) + Q
    return x_bar, P_bar


def precalc(C, R, x_bar, P_bar):
    """Batched measurement-update precalculation (reference kalman.py:82-101).

    C: (m, n), R: (m, m); x_bar: (..., n), P_bar: (..., n, n).
    Returns z_hat (..., m), S (..., m, m), S_inv, K (..., n, m),
    P_hat (..., n, n).
    """
    z_hat = jnp.einsum('ij,...j->...i', C, x_bar, precision=HIGHEST)
    PCt = jnp.einsum('...ij,kj->...ik', P_bar, C,
                     precision=HIGHEST)                     # (..., n, m)
    S = jnp.einsum('ij,...jk->...ik', C, PCt,
                   precision=HIGHEST) + R                   # (..., m, m)
    S_inv = inv_psd(S)
    K = jnp.matmul(PCt, S_inv, precision=HIGHEST)           # (..., n, m)
    # Joseph-free form, like the reference: P_hat = P_bar - K C P_bar
    P_hat = P_bar - jnp.einsum('...ij,jk,...kl->...il', K, C, P_bar,
                               precision=HIGHEST)
    return z_hat, S, S_inv, K, P_hat


def residuals(z, z_hat):
    """All-pairs innovation tensor (reference kalman.py:36-40 ``z_tilde``).

    z: (M, m) measurements; z_hat: (..., m) predicted measurements.
    Returns (..., M, m).
    """
    return z - z_hat[..., None, :]


def nis(z_tilde, S_inv):
    """Batched normalized innovation squared (reference kalman.py:25-28).

    z_tilde: (..., M, m), S_inv: (..., m, m) -> (..., M).
    """
    return jnp.einsum('...mi,...ij,...mj->...m', z_tilde, S_inv, z_tilde,
                      precision=HIGHEST)


def filter_update(x_bar, K, z_tilde):
    """Batched state update for many residuals of one prediction
    (reference kalman.py:43-52 ``numpyFilter``).

    x_bar: (..., n), K: (..., n, m), z_tilde: (..., M, m) -> (..., M, n).
    """
    return x_bar[..., None, :] + jnp.einsum('...nm,...Mm->...Mn', K, z_tilde,
                                            precision=HIGHEST)


def nllr(lambda_ex, P_d, S, nis_values):
    """Measurement-association negative log-likelihood-ratio increment
    (reference kalman.py:14-22): 0.5*NIS + ln(lambda_ex*sqrt(det(2*pi*S))/P_d).

    S: (..., m, m) broadcasts against nis_values (..., M).
    """
    m = S.shape[-1]
    lambda_ex = jnp.maximum(jnp.asarray(lambda_ex, dtype=jnp.float32), 1e-20)
    log_norm = 0.5 * (m * _LOG2PI + jnp.log(det_psd(S)))
    log_term = jnp.log(lambda_ex) + log_norm - jnp.log(P_d)
    return 0.5 * nis_values + log_term[..., None]


def nllr_ais(S, nis_values):
    """AIS-association NLLR increment (reference kalman.py:7-11)."""
    m = S.shape[-1]
    log_norm = 0.5 * (m * _LOG2PI + jnp.log(det_psd(S)))
    return 0.5 * nis_values + log_norm[..., None]


def nllr_missed(P_d):
    """Missed-detection (zero-hypothesis) NLLR increment
    (reference pyTarget.py:326): -ln(1 - P_d)."""
    return -jnp.log1p(-P_d)
