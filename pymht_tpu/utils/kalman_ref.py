"""Float64 NumPy oracle of the Kalman and PV-model formulas.

A plain, loop-free restatement of the reference's formulas, kept apart
from the device code it checks (``ops/kalman.py``, ``models/pv.py``,
``ops/ais_fused.py``).  Everything is computed in float64 with
``np.linalg`` inverses and determinants.  Function names follow the
reference so a reader can put the two side by side:

* ``Phi``/``Q``/``C_RADAR``/``R_RADAR`` -- reference models/pv.py:7-34;
* ``predict``/``precalc``/``z_tilde``/``normalizedInnovationSquared``/
  ``nllr``/``numpyFilter`` -- reference utils/kalman.py:14-101.
"""
from __future__ import annotations

import numpy as np

from ..models.constants import sigmaQ_tracker, sigmaR_RADAR_tracker

C_RADAR = np.array([[1.0, 0.0, 0.0, 0.0],
                    [0.0, 1.0, 0.0, 0.0]])


def Phi(T):
    """CV transition, (..., 4, 4) for T of shape (...)."""
    T = np.asarray(T, np.float64)
    out = np.broadcast_to(np.eye(4), T.shape + (4, 4)).copy()
    out[..., 0, 2] = T
    out[..., 1, 3] = T
    return out


def Q(T, sigmaQ=sigmaQ_tracker):
    """Process noise with the reference's T^4/4, T^3/3, T^2 kernel."""
    T = np.asarray(T, np.float64)
    out = np.zeros(T.shape + (4, 4))
    for a, b in ((0, 2), (1, 3)):
        out[..., a, a] = T ** 4 / 4.0
        out[..., a, b] = out[..., b, a] = T ** 3 / 3.0
        out[..., b, b] = T ** 2
    return out * sigmaQ


def R_RADAR(sigmaR=sigmaR_RADAR_tracker):
    return np.eye(2) * sigmaR ** 2


def predict(A, Q, x, P):
    """x_bar = A x, P_bar = A P A^T + Q over leading batch axes."""
    A = np.asarray(A, np.float64)
    x_bar = np.einsum('...ij,...j->...i', A, np.asarray(x, np.float64))
    P_bar = A @ np.asarray(P, np.float64) @ np.swapaxes(A, -1, -2) + Q
    return x_bar, P_bar


def precalc(C, R, x_bar, P_bar):
    """(z_hat, S, S_inv, K, P_hat) for observation matrix C, noise R."""
    C = np.asarray(C, np.float64)
    x_bar = np.asarray(x_bar, np.float64)
    P_bar = np.asarray(P_bar, np.float64)
    z_hat = np.einsum('ij,...j->...i', C, x_bar)
    PCt = P_bar @ C.T
    S = C @ PCt + R
    S_inv = np.linalg.inv(S)
    K = PCt @ S_inv
    P_hat = P_bar - K @ C @ P_bar
    return z_hat, S, S_inv, K, P_hat


def z_tilde(z, z_hat):
    """All-pairs residuals: z [M, m], z_hat [..., m] -> [..., M, m]."""
    return (np.asarray(z, np.float64)[None]
            - np.asarray(z_hat, np.float64)[..., None, :])


def normalizedInnovationSquared(zt, S_inv):
    """zt [..., M, m], S_inv [..., m, m] -> [..., M]."""
    return np.einsum('...mi,...ij,...mj->...m', zt, S_inv, zt)


def nllr(lambda_ex, P_d, S, nis):
    """0.5*NIS + ln(lambda_ex * sqrt(det(2 pi S)) / P_d); S [..., m, m]
    broadcasts over the last axis of nis."""
    det = np.linalg.det(2.0 * np.pi * np.asarray(S, np.float64))
    log_term = np.log(lambda_ex * np.sqrt(det) / np.asarray(P_d, np.float64))
    return 0.5 * np.asarray(nis, np.float64) + log_term[..., None]


def numpyFilter(x_bar, K, zt):
    """One prediction updated by many residuals: [M, n]."""
    return (np.asarray(x_bar, np.float64)[..., None, :]
            + np.einsum('...nm,...Mm->...Mn', np.asarray(K, np.float64),
                        np.asarray(zt, np.float64)))
