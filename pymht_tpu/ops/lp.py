"""On-device LP solver for the global-hypothesis selection ILP.

The reference ships every cluster's 0/1 program to an external C++ MILP
solver (CBC via OR-Tools, /root/reference/pymht/tracker.py:1155-1217):

    min f^T tau   s.t.  A1 tau <= 1   (measurement used at most once)
                        A2 tau  = 1   (exactly one leaf per target)
                        tau in {0,1}

Here the LP relaxation of the *global* problem (all clusters at once — the
blocks are independent, so one padded solve covers every cluster) is
solved on-device with an infeasible-start primal-dual interior-point
method.  The per-iteration work is a Cholesky factorisation of the
constraint-space normal equations — dense and fixed-shape.
Assignment-type polytopes like this one have LP relaxations that are
integral in almost all instances; ``round_and_repair`` turns the
fractional solution into a feasible integral one, and tests validate the
optimality gap against an exact branch-and-bound oracle.
"""
from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp


class LpSolution(NamedTuple):
    x: jnp.ndarray          # [n] primal solution (the tau variables)
    obj: jnp.ndarray        # [] objective value
    iters: jnp.ndarray      # [] iterations used
    mu: jnp.ndarray         # [] final complementarity


def solve_lp(f, A_eq, b_eq, A_in, b_in, var_mask, eq_mask, in_mask,
             max_iters: int = 30, tol: float = 2e-6):
    """Solve  min f.x  s.t.  A_eq x = b_eq, A_in x <= b_in, 0 <= x.

    All shapes static; ``*_mask`` flags valid variables/rows (padding rows
    must have zero coefficients; they are neutralised here).

    Infeasible-start primal-dual path following with Mehrotra-style
    adaptive centering; the normal-equations matrix is regularised so
    padded (zero) rows stay benign.
    """
    dtype = jnp.float32
    f = f.astype(dtype)
    n = f.shape[0]
    p = b_eq.shape[0]
    r = b_in.shape[0]

    # Neutralise padding: invalid vars get cost 1 and a zero column,
    # invalid rows become 0 = 0 / 0 <= 1.
    A_eq = jnp.where(eq_mask[:, None] & var_mask[None, :], A_eq, 0.0).astype(dtype)
    A_in = jnp.where(in_mask[:, None] & var_mask[None, :], A_in, 0.0).astype(dtype)
    b_eq = jnp.where(eq_mask, b_eq, 0.0).astype(dtype)
    b_in = jnp.where(in_mask, b_in, 1.0).astype(dtype)
    f = jnp.where(var_mask, f, 1.0)

    # Standard form with slacks: xs = [x; s], A = [[A_eq, 0], [A_in, I]].
    m = p + r
    A = jnp.zeros((m, n + r), dtype)
    A = A.at[:p, :n].set(A_eq)
    A = A.at[p:, :n].set(A_in)
    A = A.at[p:, n:].set(jnp.eye(r, dtype=dtype))
    b = jnp.concatenate([b_eq, b_in])
    c = jnp.concatenate([f, jnp.zeros((r,), dtype)])
    nv = n + r

    x = jnp.ones((nv,), dtype)
    z = jnp.ones((nv,), dtype)
    y = jnp.zeros((m,), dtype)

    delta = dtype(1e-6)   # normal-equations regularisation

    def nt_solve(x, z, rhs_p, rhs_d, rhs_mu):
        """One Newton solve of the KKT system via normal equations.

        rhs_p = b - A xs (primal), rhs_d = c - A^T y - z (dual),
        rhs_mu = target complementarity vector (sigma*mu - x*z terms).
        """
        d = jnp.clip(x / jnp.maximum(z, 1e-12), 1e-8, 1e8)  # [nv]
        # M = A D A^T + delta I  (m x m SPD)
        AD = A * d[None, :]
        M = AD @ A.T + delta * jnp.eye(m, dtype=dtype)
        rhs = rhs_p + A @ (d * rhs_d - rhs_mu / jnp.maximum(z, 1e-12))
        Lc = jnp.linalg.cholesky(M)
        dy = jax.scipy.linalg.cho_solve((Lc, True), rhs)
        dx = d * (A.T @ dy - rhs_d) + rhs_mu / jnp.maximum(z, 1e-12)
        dz = (rhs_mu - z * dx) / jnp.maximum(x, 1e-12)
        return dx, dy, dz

    def alpha_max(v, dv):
        """Largest step in [0,1] keeping v + a*dv >= (1-0.9995) v."""
        ratio = jnp.where(dv < 0, -v / jnp.where(dv < 0, dv, -1.0), jnp.inf)
        return jnp.minimum(1.0, 0.9995 * jnp.min(ratio))

    def body(carry):
        x, y, z, it, _, _ = carry
        rp = b - A @ x
        rd = c - A.T @ y - z
        mu = jnp.dot(x, z) / nv

        # Affine (predictor) direction
        dx_a, dy_a, dz_a = nt_solve(x, z, rp, rd, -x * z)
        ap = alpha_max(x, dx_a)
        ad = alpha_max(z, dz_a)
        mu_aff = jnp.dot(x + ap * dx_a, z + ad * dz_a) / nv
        sigma = jnp.clip((mu_aff / jnp.maximum(mu, 1e-15)) ** 3, 1e-4, 0.9)

        # Corrector
        rhs_mu = sigma * mu - x * z - dx_a * dz_a
        dx, dy, dz = nt_solve(x, z, rp, rd, rhs_mu)
        ap = alpha_max(x, dx)
        ad = alpha_max(z, dz)
        x_new = x + ap * dx
        y_new = y + ad * dy
        z_new = z + ad * dz
        # fp32 guard: reject a step that produced non-finite values (past
        # convergence the normal equations degenerate) — keep the last
        # good iterate and let ``cond`` terminate.
        ok = (jnp.all(jnp.isfinite(x_new)) & jnp.all(jnp.isfinite(y_new))
              & jnp.all(jnp.isfinite(z_new)))
        x = jnp.where(ok, x_new, x)
        y = jnp.where(ok, y_new, y)
        z = jnp.where(ok, z_new, z)
        return x, y, z, it + 1, mu, ok

    def cond(carry):
        x, y, z, it, mu_prev, ok = carry
        mu = jnp.dot(x, z) / nv
        rp = jnp.max(jnp.abs(b - A @ x))
        return ok & (it < max_iters) & ((mu > tol) | (rp > 1e-4))

    x, y, z, iters, mu, _ = jax.lax.while_loop(
        cond, body,
        (x, y, z, jnp.asarray(0), jnp.asarray(jnp.inf, dtype),
         jnp.asarray(True)))

    tau = jnp.where(var_mask, x[:n], 0.0)
    return LpSolution(x=tau, obj=jnp.dot(f, tau), iters=iters,
                      mu=jnp.dot(x, z) / nv)


def solve_ilp(f, A_eq, b_eq, A_in, b_in, var_mask, eq_mask, in_mask,
              T, L, tgt_mask, budget: int = 12, lp_iters: int = 30):
    """Truncated best-first branch-and-bound with on-device LP bounding.

    Replaces the reference's external CBC MILP call
    (/root/reference/pymht/tracker.py:1155-1217).  The common case — the
    LP relaxation of the assignment polytope is integral — exits after a
    single interior-point solve.  Fractional cases branch on the most
    fractional variable (ban it vs. force it, both expressible as ban
    masks thanks to the one-leaf-per-target equality rows) with a fixed
    node budget, then a Lagrangian-subgradient + coordinate-descent
    polish tightens the incumbent.  Returns (sel [T], feasible, obj,
    lower_bound); the gap certificate is (obj - lower_bound).
    """
    BIG = jnp.float32(1e4)
    n = f.shape[0]
    POOL = budget + 2
    EPS = jnp.float32(1e-5)

    tgt_of = jnp.arange(n) // L                              # variable -> target

    def lp_round(bans):
        f_eff = jnp.where(bans, f + BIG, f)
        sol = solve_lp(f_eff, A_eq, b_eq, A_in, b_in,
                       var_mask, eq_mask, in_mask, max_iters=lp_iters)
        sel, feas = round_and_repair(sol.x, f_eff, A_in, in_mask,
                                     T, L, tgt_mask, banned0=bans.reshape(T, L))
        onehot = (jax.nn.one_hot(sel, L, dtype=jnp.float32)
                  * tgt_mask[:, None]).reshape(-1)
        obj = jnp.dot(jnp.where(var_mask, f, 0.0), onehot)
        frac = jnp.where(var_mask & ~bans,
                         -jnp.abs(sol.x - 0.5), -jnp.inf)      # peak at 0.5
        j_frac = jnp.argmax(frac)
        integral = jnp.max(jnp.where(var_mask, jnp.abs(sol.x - jnp.round(sol.x)),
                                     0.0)) < 0.01
        # Subtract the ban penalty actually picked up (selected banned
        # vars) so lp bound stays comparable; in practice banned vars
        # carry ~0 weight at optimum.
        return sel, feas, obj, sol.obj, j_frac, integral

    # Node pool: ban masks + parent-bound priority.
    pool_bans = jnp.zeros((POOL, n), bool)
    pool_prio = jnp.full((POOL,), jnp.inf, jnp.float32)
    pool_act = jnp.zeros((POOL,), bool)
    pool_prio = pool_prio.at[0].set(-jnp.inf)
    pool_act = pool_act.at[0].set(True)

    def insert(pool_bans, pool_prio, pool_act, bans, prio):
        # Place into the first inactive slot; if none, replace the worst
        # (highest-priority) active node if strictly better.
        has_free = jnp.any(~pool_act)
        free_slot = jnp.argmin(pool_act)                  # first False
        worst = jnp.argmax(jnp.where(pool_act, pool_prio, -jnp.inf))
        slot = jnp.where(has_free, free_slot, worst)
        do = has_free | (prio < pool_prio[worst])
        pool_bans = jnp.where(do, pool_bans.at[slot].set(bans), pool_bans)
        pool_prio = jnp.where(do, pool_prio.at[slot].set(prio), pool_prio)
        pool_act = jnp.where(do, pool_act.at[slot].set(True), pool_act)
        return pool_bans, pool_prio, pool_act

    def body(carry):
        (it, pool_bans, pool_prio, pool_act,
         best_sel, best_obj, best_feas, root_bound) = carry
        # Pop the best-bound node.
        i = jnp.argmin(jnp.where(pool_act, pool_prio, jnp.inf))
        bans = pool_bans[i]
        pool_act = pool_act.at[i].set(False)

        sel, feas, obj, lp_obj, j_frac, integral = lp_round(bans)
        better = feas & ((obj < best_obj) | ~best_feas)
        best_sel = jnp.where(better, sel, best_sel)
        best_obj = jnp.where(better, obj, best_obj)
        best_feas = best_feas | feas
        root_bound = jnp.where(it == 0, lp_obj, root_bound)

        # Branch if fractional and the node bound beats the incumbent.
        expand = (~integral) & (lp_obj < best_obj - EPS)
        # Child A: ban j_frac.
        bans_a = bans.at[j_frac].set(True)
        # Child B: force j_frac == ban every other leaf of its target.
        same_tgt = tgt_of == tgt_of[j_frac]
        bans_b = jnp.where(same_tgt & (jnp.arange(n) != j_frac), True, bans)
        pool_bans, pool_prio, pool_act = jax.tree_util.tree_map(
            lambda new, old: jnp.where(expand, new, old),
            insert(pool_bans, pool_prio, pool_act, bans_a, lp_obj),
            (pool_bans, pool_prio, pool_act))
        pool_bans, pool_prio, pool_act = jax.tree_util.tree_map(
            lambda new, old: jnp.where(expand, new, old),
            insert(pool_bans, pool_prio, pool_act, bans_b, lp_obj),
            (pool_bans, pool_prio, pool_act))
        return (it + 1, pool_bans, pool_prio, pool_act,
                best_sel, best_obj, best_feas, root_bound)

    def cond(carry):
        (it, pool_bans, pool_prio, pool_act,
         best_sel, best_obj, best_feas, root_bound) = carry
        open_bound = jnp.min(jnp.where(pool_act, pool_prio, jnp.inf))
        work_left = jnp.any(pool_act) & (open_bound < best_obj - EPS)
        return (it < budget) & (work_left | (it == 0))

    init = (jnp.asarray(0), pool_bans, pool_prio, pool_act,
            jnp.zeros((T,), jnp.int32), jnp.asarray(jnp.inf, jnp.float32),
            jnp.asarray(False), jnp.asarray(0.0, jnp.float32))
    (_, _, _, _, best_sel, best_obj, best_feas, bound) = \
        jax.lax.while_loop(cond, body, init)

    # Lagrangian subgradient polish (skipped work-wise if already provably
    # integral-optimal: it cannot improve on an integral LP optimum, but
    # running it is branch-free and cheap relative to the LP solves).
    f_pol = jnp.where(var_mask, f, BIG)
    best_sel, best_obj, best_feas, lag_lb = lagrangian_polish(
        f_pol, A_in, in_mask, T, L, tgt_mask,
        best_sel, best_obj, best_feas)
    bound = jnp.maximum(bound, lag_lb)

    # Final monotone polish: exact per-target re-optimisation.
    best_sel = coordinate_descent(f_pol, A_in, in_mask, T, L, tgt_mask,
                                  best_sel)
    onehot = (jax.nn.one_hot(best_sel, L, dtype=jnp.float32)
              * tgt_mask[:, None]).reshape(-1)
    best_obj = jnp.dot(jnp.where(var_mask, f, 0.0), onehot)
    return best_sel, best_feas, best_obj, bound


def lagrangian_polish(f, A_in, in_mask, T, L, tgt_mask,
                      best_sel, best_obj, best_feas,
                      iters: int = 80, theta: float = 1.5):
    """Subgradient ascent on the measurement-usage constraints.

    Dualising A_in tau <= 1 decomposes the problem per target (pick the
    leaf minimising reduced cost f + lambda^T a_l), so every iteration is
    a masked argmin + matvec — no factorisation.  Each decode is repaired
    to feasibility and the best incumbent kept; the dual value gives a
    lower bound.  Classic polish for assignment-type ILPs.
    """
    n = f.shape[0]
    r = in_mask.shape[0]
    fT = f.reshape(T, L)
    AT = A_in.T.reshape(T, L, r)                           # per-leaf usage rows
    lam = jnp.zeros((r,), jnp.float32)

    def decode(lam):
        red = fT + AT @ lam                                # [T, L]
        red = jnp.where(tgt_mask[:, None], red, jnp.inf)
        sel = jnp.argmin(red, axis=1)
        lb = (jnp.where(tgt_mask, jnp.min(red, axis=1), 0.0).sum()
              - lam.sum())
        return sel, lb

    def body(i, carry):
        lam, best_sel, best_obj, best_feas, best_lb = carry
        sel, lb = decode(lam)
        best_lb = jnp.maximum(best_lb, lb)
        onehot = (jax.nn.one_hot(sel, L, dtype=jnp.float32)
                  * tgt_mask[:, None]).reshape(-1)
        usage = A_in @ onehot
        g = jnp.where(in_mask, usage - 1.0, 0.0)           # subgradient
        # Repair conflicts on the raw decode to harvest an incumbent:
        # seed round_and_repair with the decode as the "LP weights".
        tau_like = onehot
        sel_use, feas_use = round_and_repair(
            tau_like, f, A_in, in_mask, T, L, tgt_mask)
        obj = jnp.dot(jnp.where(tgt_mask[:, None], fT, 0.0).reshape(-1),
                      (jax.nn.one_hot(sel_use, L, dtype=jnp.float32)
                       * tgt_mask[:, None]).reshape(-1))
        better = feas_use & ((obj < best_obj) | ~best_feas)
        best_sel = jnp.where(better, sel_use, best_sel)
        best_obj = jnp.where(better, obj, best_obj)
        best_feas = best_feas | feas_use
        # Polyak-style step towards the incumbent value.
        gnorm2 = jnp.maximum(jnp.dot(g, g), 1e-6)
        gap_est = jnp.where(best_feas, best_obj - lb, 1.0)
        step = theta * jnp.maximum(gap_est, 1e-3) / gnorm2
        lam = jnp.maximum(0.0, lam + step * g)
        return lam, best_sel, best_obj, best_feas, best_lb

    init = (lam, best_sel, best_obj, best_feas,
            jnp.asarray(-jnp.inf, jnp.float32))
    _, best_sel, best_obj, best_feas, best_lb = jax.lax.fori_loop(
        0, iters, body, init)
    return best_sel, best_obj, best_feas, best_lb


def coordinate_descent(f, A_in, in_mask, T, L, tgt_mask, sel,
                       sweeps: int = 3):
    """Per-target exact re-optimisation given the other targets' choices.

    Monotonically improves a feasible integral selection: for each target
    in turn, pick its min-cost leaf among those not conflicting with the
    current usage of every other target.  O(T * L * r) per sweep.
    """
    r = in_mask.shape[0]
    fT = f.reshape(T, L)
    AT = A_in.T.reshape(T, L, r)

    def usage_of(sel):
        onehot = (jax.nn.one_hot(sel, L, dtype=jnp.float32)
                  * tgt_mask[:, None])                      # [T, L]
        return jnp.einsum('tl,tlr->r', onehot, AT)          # [r]

    def sweep(_, sel):
        def per_target(t, sel):
            usage = usage_of(sel)
            own = AT[t, sel[t]] * tgt_mask[t]
            others = usage - own                            # [r]
            # leaf l feasible iff others + a_l <= 1 on all valid rows
            ok = jnp.all((others[None, :] + AT[t]) * in_mask[None, :]
                         <= 1.0 + 1e-3, axis=1)             # [L]
            cost = jnp.where(ok, fT[t], jnp.inf)
            best = jnp.argmin(cost)
            new_sel = jnp.where(tgt_mask[t] & jnp.isfinite(cost[best]),
                                best, sel[t])
            return sel.at[t].set(new_sel)
        return jax.lax.fori_loop(0, T, per_target, sel)

    return jax.lax.fori_loop(0, sweeps, sweep, sel)


def round_and_repair(tau, f, A_in, in_mask, T, L, tgt_mask,
                     repair_iters: int = 16, banned0=None):
    """Round the fractional LP solution to one leaf per target and repair
    measurement conflicts greedily.

    tau: [T*L]; f: [T*L]; A_in: [r, T*L] measurement-usage rows.
    Returns sel [T] leaf index per target and a feasibility flag.

    Repair loop: while some measurement row is claimed by >1 selected
    leaf, the worst-scoring conflicting target abandons its leaf (the
    leaf is masked out) and re-picks its next-best by LP weight.
    """
    tau2 = tau.reshape(T, L)
    # Prefer high LP weight; break near-ties toward lower cost.
    score = jnp.where(tgt_mask[:, None],
                      tau2 - 1e-4 * f.reshape(T, L), -jnp.inf)
    banned = (jnp.zeros((T, L), bool) if banned0 is None else banned0)

    def pick(score, banned):
        s = jnp.where(banned, -jnp.inf, score)
        return jnp.argmax(s, axis=1)                       # [T]

    def body(i, carry):
        banned, sel, done = carry
        onehot = (jax.nn.one_hot(sel, L, dtype=jnp.float32)
                  * tgt_mask[:, None]).reshape(-1)         # [T*L]
        usage = A_in @ onehot                              # [r]
        viol = (usage > 1.5) & in_mask                     # rows overused
        any_viol = jnp.any(viol)

        # For each target: does its selected leaf sit on a violated row?
        sel_cols = (A_in.T.reshape(T, L, -1)[jnp.arange(T), sel])  # [T, r]
        in_conflict = (sel_cols * viol[None, :]).sum(axis=1) > 0
        in_conflict = in_conflict & tgt_mask
        # Worst conflicting target = largest objective contribution.
        fsel = f.reshape(T, L)[jnp.arange(T), sel]
        worst = jnp.argmax(jnp.where(in_conflict, fsel, -jnp.inf))
        banned = jnp.where(any_viol,
                           banned.at[worst, sel[worst]].set(True),
                           banned)
        sel = jnp.where(any_viol, pick(score, banned), sel)
        return banned, sel, done | ~any_viol

    sel0 = pick(score, banned)
    banned, sel, done = jax.lax.fori_loop(
        0, repair_iters, body, (banned, sel0, jnp.asarray(False)))

    onehot = (jax.nn.one_hot(sel, L, dtype=jnp.float32)
              * tgt_mask[:, None]).reshape(-1)
    usage = A_in @ onehot
    feasible = ~jnp.any((usage > 1.5) & in_mask)
    return sel, feasible
