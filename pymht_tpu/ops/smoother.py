"""Batched fixed-interval RTS smoothing with EM refinement.

Replaces the reference's pykalman dependency
(/root/reference/pymht/pyTarget.py:580-609: KalmanFilter(
transition_matrices=Phi, observation_matrices=C_RADAR,
initial_state_mean=x0).em(measurements, n_iter=5).smooth(...)) with a
lax.scan forward filter + backward RTS pass, batched over tracks via
vmap.  Missing measurements (missed detections) are masked, exactly
like pykalman's masked arrays.

EM modes:

* ``em_mode='full'`` — the reference-parity mode.  pykalman's default
  ``em_vars`` with Phi/C fixed in the constructor are
  [transition_covariance, observation_covariance, initial_state_mean,
  initial_state_covariance]; each iteration refits the FULL Q [4,4] and
  R [2,2] matrices plus (x0, P0) from the smoothed moments, using the
  standard EM M-step (Ghahramani & Hinton 1996) with lag-one smoothed
  covariances.  Masked steps are excluded from the R update and divide
  by the observed count, matching pykalman's handling.
* ``em_mode='scalar'`` — lightweight mode: refit only scalar scale
  factors on the pv-model Q and R (cheaper, well-conditioned on short
  tracks).
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from ..models import pv
from . import kalman as k

# Every product below asks for HIGHEST precision: at the default, TF32
# rounding on an H100 moved EM-refit smoothed positions by up to 1.5 m
# (chip_smoke.py phase c, default vs highest).
_mm = functools.partial(jnp.matmul, precision=k.HIGHEST)
_es = functools.partial(jnp.einsum, precision=k.HIGHEST)


def _forward(xs0, P0, zs, mask, A, Q, C, R):
    """Masked Kalman filter over time. zs: [N, 2], mask: [N]."""
    def step(carry, inp):
        x, P = carry
        z, m = inp
        x_bar, P_bar = k.predict(A, Q, x, P)
        z_hat, S, S_inv, K, P_hat = k.precalc(C, R, x_bar, P_bar)
        x_upd = x_bar + _mm(K, z - z_hat)
        x_new = jnp.where(m, x_upd, x_bar)
        P_new = jnp.where(m, P_hat, P_bar)
        return (x_new, P_new), (x_new, P_new, x_bar, P_bar)

    (_, _), (xf, Pf, xp, Pp) = jax.lax.scan(step, (xs0, P0), (zs, mask))
    return xf, Pf, xp, Pp


def _smooth_pass(x0, P0, zs, mask, A, Q, C, R):
    """One filter + RTS pass.  Returns (xs, Ps, M) where M[t] is the
    lag-one smoothed covariance Cov(x_t, x_{t-1} | z_{1:N}) for
    t = 1..N-1 (M[0] is zeros padding)."""
    xf, Pf, xp, Pp = _forward(x0, P0, zs, mask, A, Q, C, R)

    def back(carry, inp):
        x_next, P_next = carry
        xf_t, Pf_t, xp_t1, Pp_t1 = inp
        # G = Pf A^T Pp^{-1}
        G = _mm(_mm(Pf_t, A.T), k.inv_psd(Pp_t1))
        x_s = xf_t + _mm(G, x_next - xp_t1)
        P_s = Pf_t + _mm(_mm(G, P_next - Pp_t1), G.T)
        return (x_s, P_s), (x_s, P_s, G)

    # inputs at t use prediction into t+1: shift xp/Pp left
    xp1 = jnp.concatenate([xp[1:], xp[-1:]], axis=0)
    Pp1 = jnp.concatenate([Pp[1:], Pp[-1:]], axis=0)
    (_, _), (xs, Ps, G) = jax.lax.scan(
        back, (xf[-1], Pf[-1]),
        (xf[:-1], Pf[:-1], xp1[:-1], Pp1[:-1]), reverse=True)
    xs = jnp.concatenate([xs, xf[-1:]], axis=0)
    Ps = jnp.concatenate([Ps, Pf[-1:]], axis=0)
    # lag-one: Cov(x_{t+1}, x_t) = Ps[t+1] @ G[t]^T, stored at index t+1
    M_tail = _es('nij,nkj->nik', Ps[1:], G)          # [N-1,4,4]
    M = jnp.concatenate([jnp.zeros_like(M_tail[:1]), M_tail], axis=0)
    return xs, Ps, M


def rts_smooth(x0, P0, zs, mask, radar_period, em_iters: int = 0,
               sigma_q: float = None, sigma_r: float = None,
               em_mode: str = 'scalar'):
    """Smooth one track. zs: [N, 2] measurements (garbage where ~mask).

    Returns (xs [N, 4], Ps [N, 4, 4]) smoothed states/covariances.
    With em_iters > 0, alternates smoothing with noise refits: full
    matrix EM (``em_mode='full'``, reference-parity — see module
    docstring) or scalar noise-scale refits (``'scalar'``).
    """
    A = pv.Phi(radar_period)
    C = pv.C_RADAR
    q = jnp.asarray(1.0 if sigma_q is None else sigma_q, jnp.float32)
    r = jnp.asarray(1.0 if sigma_r is None else sigma_r, jnp.float32)
    Q0 = pv.Q(radar_period)
    R0 = pv.R_RADAR()

    if em_mode == 'full':
        Qm, Rm = Q0, R0
        x0m, P0m = x0, P0
        xs, Ps, M = _smooth_pass(x0m, P0m, zs, mask, A, Qm, C, Rm)
        for _ in range(em_iters):
            N = zs.shape[0]
            # Q: mean over transitions of
            #   outer(err) + Ps[t+1] - M[t+1] A^T - A M[t+1]^T + A Ps[t] A^T
            err = xs[1:] - _es('ij,nj->ni', A, xs[:-1])  # [N-1,4]
            Mt = M[1:]                                          # [N-1,4,4]
            Qn = (_es('ni,nj->nij', err, err)
                  + Ps[1:]
                  - _es('nij,kj->nik', Mt, A)    # - M A^T
                  - _es('ij,nkj->nik', A, Mt)    # - A M^T
                  + _es('ij,njk,lk->nil', A, Ps[:-1], A))
            Qm = Qn.mean(axis=0)
            Qm = 0.5 * (Qm + Qm.T)
            # R: observed steps only, divide by observed count
            v = zs - _es('ij,nj->ni', C, xs)             # [N,2]
            Rn = (_es('ni,nj->nij', v, v)
                  + _es('ij,njk,lk->nil', C, Ps, C))
            w = mask.astype(jnp.float32)[:, None, None]
            n_obs = jnp.maximum(mask.sum(), 1).astype(jnp.float32)
            Rm = (Rn * w).sum(axis=0) / n_obs
            Rm = 0.5 * (Rm + Rm.T)
            # initial state / covariance
            x0m, P0m = xs[0], 0.5 * (Ps[0] + Ps[0].T)
            xs, Ps, M = _smooth_pass(x0m, P0m, zs, mask, A, Qm, C, Rm)
        return xs, Ps

    def smooth_once(q, r):
        xs, Ps, _ = _smooth_pass(x0, P0, zs, mask, A, Q0 * q, C, R0 * r)
        return xs, Ps

    xs, Ps = smooth_once(q, r)
    for _ in range(em_iters):
        # Scalar refit: match innovation magnitudes (lightweight EM).
        resid = jnp.where(mask[:, None], zs - xs[:, :2], 0.0)
        n_obs = jnp.maximum(mask.sum(), 1)
        r = jnp.maximum(jnp.sum(resid ** 2) / (2 * n_obs)
                        / (R0[0, 0]), 1e-3)
        step_res = xs[1:] - _es('ij,nj->ni', A, xs[:-1])
        q = jnp.maximum(jnp.mean(step_res[:, :2] ** 2)
                        / jnp.maximum(Q0[0, 0], 1e-6), 1e-3)
        xs, Ps = smooth_once(q, r)
    return xs, Ps


def smooth_tracks(x0s, P0s, zs, masks, radar_period, em_iters: int = 0,
                  em_mode: str = 'scalar'):
    """vmapped multi-track smoothing: x0s [B,4], zs [B,N,2], masks [B,N].

    ONE device dispatch for the whole batch — the production path for
    Tracker.get_smooth_tracks (a per-track host loop would pay one
    dispatch and transfer per track)."""
    fn = lambda x0, P0, z, m: rts_smooth(x0, P0, z, m, radar_period,
                                         em_iters=em_iters,
                                         em_mode=em_mode)
    return jax.vmap(fn)(x0s, P0s, zs, masks)
