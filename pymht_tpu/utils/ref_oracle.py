"""Host-side port of the reference's per-scan DECISION logic, used as a
parity oracle for the device tracker.

This is a deliberately slow, readable numpy reimplementation of the
reference pipeline — full hypothesis trees (no beam), exact per-cluster
ILP via scipy/HiGHS instead of OR-Tools CBC, exact GNN via
scipy.optimize.linear_sum_assignment instead of the external Cython
munkres — so tests can assert that the device tracker makes the same
decisions (selected global hypothesis, confirm scans, kill scans) on
whole scenarios:

* grow:        /root/reference/pymht/tracker.py:309-415, pyTarget.py:227-295
* AIS fusion:  /root/reference/pymht/tracker.py:417-552 (two-stage KF:
               AIS at its own timestamp then radar; score
               0.5*nllr1 + 0.5*nllr2 at :502; pure-AIS children
               :513-525; MMSI consistency pyTarget.py:269-302)
* scoring:     /root/reference/pymht/utils/kalman.py:14-22 (nllr),
               pyTarget.py:319-328 (zero hypothesis, -ln(1-P_d))
* cluster:     /root/reference/pymht/tracker.py:961-974 (AIS slots are
               (scan, mmsi) pairs, pyTarget.py:414-430)
* optimise:    /root/reference/pymht/tracker.py:979-1217 (A1/A2/C + ILP)
* terminate:   /root/reference/pymht/tracker.py:891-916, 353-381
* N-scan prune: /root/reference/pymht/tracker.py:1229-1231,
               pyTarget.py:343-356
* m/n initiation: /root/reference/pymht/initiators/m_of_n.py:24-104
               (GNN), :233-378 (prelim pipeline), :380-478 (initiator
               pairing + two-point spawn); tracker.py:262-277 (unused
               measurement routing), :147-160 + pyTarget.py:181-189
               (neighbour rejection)
The reference itself cannot run here (ortools/munkres/pykalman are not
installed), hence this port.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Optional

import numpy as np

from ..models import pv, ais as ais_model


@dataclass
class AisMsg:
    """One AIS transponder message (reference AIS_message,
    classDefinitions.py:428-475)."""
    state: np.ndarray         # [4] full-state observation
    time: float
    mmsi: int                 # > 1e8 (pyTarget.py:25)
    high_accuracy: bool = False

    @property
    def highAccuracy(self):
        # device Tracker._pad_ais reads this reference-style attribute
        return self.high_accuracy


@dataclass
class Node:
    x: np.ndarray             # [4] state estimate
    P: np.ndarray             # [4,4]
    cnllr: float              # cumulative NLLR since birth
    meas: int                 # 0 = missed detection, m >= 1 = measurement m-1
    scan: int                 # scan index of this node
    ais: int = 0              # 0 = none, a >= 1 = AIS message slot a-1
    mmsi: int = 0             # 0 = none (reference mmsi=None)
    parent: Optional["Node"] = None
    children: list = field(default_factory=list)

    def leaves(self):
        if not self.children:
            return [self]
        out = []
        for c in self.children:
            out.extend(c.leaves())
        return out

    def path(self):
        n, out = self, []
        while n is not None:
            out.append(n)
            n = n.parent
        return out[::-1]

    def hist_mmsi(self):
        """reference _getHistoricalMmsi (pyTarget.py:297-302): first
        nonzero mmsi walking towards the root."""
        n = self
        while n is not None:
            if n.mmsi:
                return n.mmsi
            n = n.parent
        return 0


# ----------------------------------------------------------------------
# GNN assignment (reference _solve_global_nearest_neighbour,
# m_of_n.py:24-104), munkres replaced by linear_sum_assignment (both are
# exact min-cost solvers on the same padded matrix).
# ----------------------------------------------------------------------

def _gnn(delta_matrix, gate_distance=np.inf):
    from scipy.optimize import linear_sum_assignment
    cost = np.array(delta_matrix, np.float64, copy=True)
    cost[cost > gate_distance] = np.inf
    valid = cost < np.inf
    if not valid.any():
        return []
    bigM = np.power(10.0, 1.0 + np.ceil(np.log10(1.0 + np.sum(cost[valid]))))
    cost[~valid] = bigM
    validCol = valid.any(axis=0)
    validRow = valid.any(axis=1)
    nR = int(validRow.sum())
    nC = int(validCol.sum())
    n = max(nR, nC)
    maxv = 10.0 * np.max(cost[valid])
    dMat = np.full((n, n), maxv)
    dMat[:nR, :nC] = cost[np.ix_(validRow, validCol)]
    rows, cols = linear_sum_assignment(dMat)
    rowIdx = np.flatnonzero(validRow)
    colIdx = np.flatnonzero(validCol)
    out = []
    for i, j in zip(rows, cols):
        if i < nR and j < nC and valid[rowIdx[i], colIdx[j]]:
            out.append((int(rowIdx[i]), int(colIdx[j])))
    return out


# ----------------------------------------------------------------------
# m/n initiator (reference m_of_n.py:149-478)
# ----------------------------------------------------------------------

@dataclass
class _Prelim:
    state: np.ndarray
    cov: np.ndarray
    n: int = 0
    m: int = 0
    mmsi: int = 0
    predicted: Optional[np.ndarray] = None
    meas_idx: int = -1
    K: Optional[np.ndarray] = None

    def speed(self):
        return float(np.linalg.norm(self.state[2:4]))

    def similarity_nis(self, other_state):
        """reference compareSimilarity (m_of_n.py:196-201)."""
        d = self.state - other_state
        S = self.cov + np.asarray(ais_model.R(False), np.float64)
        return float(d @ np.linalg.inv(S) @ d)


class RefInitiator:
    """reference Initiator (m_of_n.py:215-478)."""

    def __init__(self, M, N, v_max, merge_threshold, gamma):
        self.M, self.N = M, N
        self.v_max = v_max
        self.merge_threshold = merge_threshold
        self.gamma = gamma
        self.C = np.asarray(pv.C_RADAR, np.float64)
        self.R = np.asarray(pv.R_RADAR(), np.float64)
        self.prelims = []
        self.initiators = []      # (pos [2], time)
        self.last_time = None

    def process(self, z, time, ais_msgs=()):
        """z: [n,2] unused radar measurements (already compacted, like
        the reference's scanList.filterUnused).  Returns a list of
        (x0 [4], P0 [4,4]) confirmed new targets."""
        unused, new_targets = self._process_prelims(z, time, ais_msgs)
        unused = self._process_initiators(z, unused, time)
        self.initiators = [(z[i].astype(np.float64), float(time))
                           for i in unused]
        self.last_time = float(time)
        return self._merge_similar(new_targets)

    def _process_prelims(self, z, time, ais_msgs):
        new_targets = []
        n2 = len(z)
        # predict (m_of_n.py:252-258)
        if self.last_time is not None:
            dt = float(time) - self.last_time
            F = np.asarray(pv.Phi(dt), np.float64)
            Q = np.asarray(pv.Q(dt), np.float64)
            for p in self.prelims:
                p.predicted = F @ p.state
                p.cov = F @ p.cov @ F.T + Q
        # AIS-seeded prelims (m_of_n.py:262-278)
        existing = {p.mmsi for p in self.prelims if p.mmsi}
        for msg in ais_msgs:
            if msg.mmsi in existing:
                continue
            dT = float(time) - float(msg.time)
            Phi_a = np.asarray(ais_model.Phi(dT), np.float64)
            st = Phi_a @ np.asarray(msg.state, np.float64)
            cov = (Phi_a @ np.asarray(pv.P0, np.float64) @ Phi_a.T
                   + np.asarray(pv.Q(dT), np.float64))
            cand = _Prelim(state=st, cov=cov, mmsi=int(msg.mmsi),
                           predicted=st)
            if not any(p.similarity_nis(cand.state) <= 1.0
                       for p in self.prelims):
                self.prelims.append(cand)
        n1 = len(self.prelims)
        if n1 == 0:
            return list(range(n2)), new_targets
        if len(ais_msgs) == 0 and n2 == 0:
            return list(range(n2)), new_targets
        # gate + distance matrix (m_of_n.py:296-310)
        delta = np.full((n1, max(n2, 1)), np.inf)
        for i, p in enumerate(self.prelims):
            pred = p.predicted if p.predicted is not None else p.state
            p.predicted = None
            zp = self.C @ pred
            S = self.C @ p.cov @ self.C.T + self.R
            S_inv = np.linalg.inv(S)
            p.K = p.cov @ self.C.T @ S_inv
            p._pred = pred
            if n2:
                d = z - zp[None, :]
                dist = np.linalg.norm(d, axis=1)
                nis = np.einsum('mi,ij,mj->m', d, S_inv, d)
                ok = nis <= self.gamma
                delta[i, :n2][ok] = dist[ok]
        assignments = _gnn(delta[:, :n2]) if n2 else []
        # update (m_of_n.py:315-336)
        assigned = {i for i, _ in assignments}
        for i, j in assignments:
            p = self.prelims[i]
            d = z[j] - self.C @ p._pred
            p.state = p._pred + p.K @ d
            p.cov = p.cov - p.K @ self.C @ p.cov
            p.m += 1
            p.meas_idx = j
        for i, p in enumerate(self.prelims):
            if i not in assigned:
                p.state = p._pred
            p.n += 1
        # destiny (m_of_n.py:340-368)
        keep = []
        for p in self.prelims:
            if p.speed() > self.v_max * 1.5:
                continue
            if p.m >= self.M:                      # CONFIRMED
                new_targets.append((p.state.copy(), p.cov.copy()))
                continue
            if p.n >= self.N and p.m < self.M:     # DEAD
                continue
            keep.append(p)
        self.prelims = keep
        used = {j for _, j in assignments}
        return [j for j in range(n2) if j not in used], new_targets

    def _process_initiators(self, z, unused, time):
        """Pair unused measurements with the previous scan's initiators
        (m_of_n.py:380-413) and spawn two-point prelims (:425-478)."""
        n1 = len(self.initiators)
        n2 = len(unused)
        if n1 == 0 or n2 == 0:
            return unused
        zu = z[unused].astype(np.float64)
        ipos = np.array([p for p, _ in self.initiators])
        dist = np.linalg.norm(zu[None, :, :] - ipos[:, None, :], axis=2)
        dt = float(time) - self.initiators[0][1]
        gate = self.v_max * dt
        assignments = _gnn(dist, gate)
        # two-point spawn (m_of_n.py:455-471)
        for i, j in assignments:
            delta = zu[j] - self.initiators[i][0]
            vel = delta / dt
            x0 = np.concatenate([zu[j], vel])
            cand = _Prelim(state=x0, cov=np.asarray(pv.P0, np.float64))
            if not any(p.similarity_nis(cand.state) <= 1.0
                       for p in self.prelims):
                self.prelims.append(cand)
        used = {unused[j] for _, j in assignments}
        return sorted(j for j in unused if j not in used)

    def _merge_similar(self, new_targets):
        """reference _merge_similar_targets (m_of_n.py:128-147)."""
        if not new_targets:
            return new_targets
        out, used = [], set()
        for i, (x, P) in enumerate(new_targets):
            if i in used:
                continue
            close = [j for j, (x2, _) in enumerate(new_targets)
                     if np.linalg.norm(x[:2] - x2[:2]) < self.merge_threshold
                     and j not in used]
            xs = np.mean([new_targets[j][0] for j in close], axis=0)
            Ps = np.mean([new_targets[j][1] for j in close], axis=0)
            used.update(close)
            out.append((xs, Ps))
        return out


# ----------------------------------------------------------------------
# The oracle tracker
# ----------------------------------------------------------------------

class RefOracle:
    """Full-tree tracker with exact per-cluster selection, optional AIS
    fusion, termination and m/n initiation."""

    def __init__(self, params, sigma_R: float = None, initiate: bool = False,
                 terminate: bool = False, ais_initialization: bool = True):
        self.params = params
        self.C = np.asarray(pv.C_RADAR, np.float64)
        self.R = np.asarray(pv.R_RADAR(sigma_R) if sigma_R is not None
                            else pv.R_RADAR(), np.float64)
        self.roots = []            # tree root per target
        self.sel = []              # selected leaf per target
        self.track_ids = []        # stable id per target
        self.time = None
        self.scan_idx = 0
        self.next_id = 0
        self.do_initiate = initiate
        self.do_terminate = terminate
        self.ais_initialization = ais_initialization
        self.events = []           # ('confirm'|'kill', scan_idx, id, x)
        # Confirmed-history archive for eval-scale metrics parity
        # (round-3 verdict item 5): nodes record to archive[id] exactly
        # once, when they leave the N-scan window (root advance), on
        # kill, or at finalize() for the live window.
        self.scan_times = []       # absolute time of scan k (index k-1)
        self.archive = {}          # id -> list[(scan_idx, meas, mmsi, x)]
        self._recorded = set()     # id(Node) already archived
        p = params
        self.initiator = RefInitiator(
            M=p.M_required, N=p.N_checks, v_max=p.max_speed,
            merge_threshold=p.merge_threshold, gamma=p.gamma_initiator)

    def pre_initialize(self, t, states, mmsi=None):
        self.time = float(t)
        for i, x in enumerate(states):
            n = Node(x=np.asarray(x, np.float64),
                     P=np.asarray(pv.P0, np.float64),
                     cnllr=0.0, meas=0, scan=0,
                     mmsi=int(mmsi[i]) if mmsi is not None else 0)
            self.roots.append(n)
            self.sel.append(n)
            self.track_ids.append(self.next_id)
            self.next_id += 1

    # -- growth (tracker.py:309-415) ----------------------------------
    def _grow_target(self, root, z, dt, ais_msgs, scan_time, lambda_ais,
                     used_radar):
        F = np.asarray(pv.Phi(dt), np.float64)
        Q = np.asarray(pv.Q(dt), np.float64)
        p = self.params
        lam_ex = p.lambda_ex
        nllr_missed = -math.log(1.0 - p.P_d)
        used_mmsi = set()
        for leaf in root.leaves():
            x_bar = F @ leaf.x
            P_bar = F @ leaf.P @ F.T + Q
            S = self.C @ P_bar @ self.C.T + self.R
            S_inv = np.linalg.inv(S)
            K = P_bar @ self.C.T @ S_inv
            P_hat = P_bar - K @ self.C @ P_bar
            # zero hypothesis (pyTarget.py:319-328)
            leaf.children.append(Node(
                x=x_bar, P=P_bar, cnllr=leaf.cnllr + nllr_missed,
                meas=0, scan=self.scan_idx, parent=leaf))
            # gated radar children (pyTarget.py:242-254)
            zt = z - (self.C @ x_bar)[None, :]              # [M,2]
            nis = np.einsum('mi,ij,mj->m', zt, S_inv, zt)
            # nllr (kalman.py:14-22)
            nllr = 0.5 * nis + math.log(
                lam_ex * math.sqrt(np.linalg.det(2 * math.pi * S)) / p.P_d)
            for m in np.nonzero(nis <= p.eta2)[0]:
                used_radar.add(int(m))
                leaf.children.append(Node(
                    x=x_bar + K @ zt[m], P=P_hat,
                    cnllr=leaf.cnllr + float(nllr[m]),
                    meas=int(m) + 1, scan=self.scan_idx,
                    parent=leaf))
            # AIS fusion (tracker.py:417-552): two-stage KF update at
            # the message timestamp, then radar at scan time.
            if not ais_msgs:
                continue
            hist_mmsi = leaf.hist_mmsi()
            for a, msg in enumerate(ais_msgs):
                # MMSI consistency (pyTarget.py:269-272)
                if hist_mmsi and msg.mmsi != hist_mmsi:
                    continue
                dT1 = float(msg.time) - self.time
                F1 = np.asarray(pv.Phi(dT1), np.float64)
                Q1 = np.asarray(pv.Q(dT1), np.float64)
                x_bar1 = F1 @ leaf.x
                P_bar1 = F1 @ leaf.P @ F1.T + Q1
                R1 = np.asarray(ais_model.R(msg.high_accuracy), np.float64)
                S1 = P_bar1 + R1                            # C_ais = I
                S1_inv = np.linalg.inv(S1)
                d1 = np.asarray(msg.state, np.float64) - x_bar1
                nis1 = float(d1 @ S1_inv @ d1)
                if nis1 > p.eta2_ais:
                    continue
                # nllr1: P_d = 1.0 for AIS (tracker.py:481)
                nllr1 = 0.5 * nis1 + math.log(
                    lambda_ais
                    * math.sqrt(np.linalg.det(2 * math.pi * S1)) / 1.0)
                K1 = P_bar1 @ S1_inv
                x_hat1 = x_bar1 + K1 @ d1
                P_hat1 = P_bar1 - K1 @ P_bar1
                # stage 2 (tracker.py:487-511): NOTE the reference uses
                # the DEFAULT radar noise pv.R_RADAR() here, not self.R.
                dT2 = float(scan_time) - float(msg.time)
                F2 = np.asarray(pv.Phi(dT2), np.float64)
                Q2 = np.asarray(pv.Q(dT2), np.float64)
                x_bar2 = F2 @ x_hat1
                P_bar2 = F2 @ P_hat1 @ F2.T + Q2
                R2 = np.asarray(pv.R_RADAR(), np.float64)
                S2 = self.C @ P_bar2 @ self.C.T + R2
                S2_inv = np.linalg.inv(S2)
                K2 = P_bar2 @ self.C.T @ S2_inv
                P_hat2 = P_bar2 - K2 @ self.C @ P_bar2
                zt2 = z - (self.C @ x_bar2)[None, :]
                nis2 = np.einsum('mi,ij,mj->m', zt2, S2_inv, zt2)
                nllr2 = 0.5 * nis2 + math.log(
                    lam_ex * math.sqrt(np.linalg.det(2 * math.pi * S2))
                    / p.P_d)
                gated = np.nonzero(nis2 <= p.eta2)[0]
                for m in gated:
                    used_mmsi.add(msg.mmsi)
                    leaf.children.append(Node(
                        x=x_bar2 + K2 @ zt2[m], P=P_hat2,
                        cnllr=leaf.cnllr
                        + 0.5 * nllr1 + 0.5 * float(nllr2[m]),
                        meas=int(m) + 1, scan=self.scan_idx,
                        ais=a + 1, mmsi=msg.mmsi, parent=leaf))
                if len(gated) == 0:
                    # pure-AIS child (tracker.py:513-525): state is the
                    # radar-time prediction, covariance the radar-UPDATED
                    # P_hat2 (the reference takes P_hat_list2[0]).
                    used_mmsi.add(msg.mmsi)
                    leaf.children.append(Node(
                        x=x_bar2, P=P_hat2,
                        cnllr=leaf.cnllr + nllr1,
                        meas=0, scan=self.scan_idx,
                        ais=a + 1, mmsi=msg.mmsi, parent=leaf))
        return used_mmsi

    # -- clustering + exact selection ----------------------------------
    @staticmethod
    def _node_slots(n):
        """Single-use slots claimed by one node: radar (scan, meas) and
        AIS (scan, mmsi) pairs (getMeasurementSet pyTarget.py:414-430,
        _createA1 tracker.py:1047-1064).  Zero-hypothesis nodes claim
        nothing."""
        out = []
        if n.meas >= 1:
            out.append(('R', n.scan, n.meas))
        if n.mmsi:
            out.append(('A', n.scan, n.mmsi))
        return out

    def _meas_set(self, root):
        out = set()
        for leaf in root.leaves():
            for n in leaf.path():
                out.update(self._node_slots(n))
        return out

    def _clusters(self):
        """Connected components over shared measurements
        (tracker.py:961-974)."""
        sets = [self._meas_set(r) for r in self.roots]
        n = len(sets)
        parent = list(range(n))

        def find(i):
            while parent[i] != i:
                parent[i] = parent[parent[i]]
                i = parent[i]
            return i

        for i in range(n):
            for j in range(i + 1, n):
                if sets[i] & sets[j]:
                    pi, pj = find(i), find(j)
                    if pi != pj:
                        parent[pi] = pj
        groups = {}
        for i in range(n):
            groups.setdefault(find(i), []).append(i)
        return list(groups.values())

    def _solve_cluster(self, members):
        """Exact per-cluster ILP (tracker.py:979-1217) via HiGHS."""
        leaves = []
        owner = []
        for t in members:
            for leaf in self.roots[t].leaves():
                leaves.append(leaf)
                owner.append(t)
        if len(members) == 1:
            # singleton: best hypothesis (pyTarget.py:446-459)
            best = min(range(len(leaves)), key=lambda i: leaves[i].cnllr)
            self.sel[members[0]] = leaves[best]
            return
        from scipy import sparse
        from scipy.optimize import milp, LinearConstraint, Bounds
        nv = len(leaves)
        f = np.array([leaf.cnllr for leaf in leaves])
        slots = {}
        rows, cols = [], []
        for j, leaf in enumerate(leaves):
            for n in leaf.path():
                for key in self._node_slots(n):
                    s = slots.setdefault(key, len(slots))
                    rows.append(s)
                    cols.append(j)
        A1 = sparse.csr_matrix((np.ones(len(rows)), (rows, cols)),
                               shape=(len(slots), nv))
        A1.sum_duplicates()
        A1.data = np.minimum(A1.data, 1.0)   # set semantics
        t_index = {t: i for i, t in enumerate(members)}
        A2 = sparse.csr_matrix(
            (np.ones(nv), ([t_index[o] for o in owner], range(nv))),
            shape=(len(members), nv))
        res = milp(f, constraints=[LinearConstraint(A2, 1, 1),
                                   LinearConstraint(A1, -np.inf, 1)],
                   integrality=np.ones(nv), bounds=Bounds(0, 1))
        assert res.x is not None and res.status == 0, "oracle ILP failed"
        chosen = np.nonzero(res.x > 0.5)[0]
        for j in chosen:
            self.sel[owner[j]] = leaves[j]

    # -- termination (tracker.py:891-916, 353-381) ---------------------
    def _terminate(self):
        p = self.params
        dead = []
        for t, leaf in enumerate(self.sel):
            pos = np.asarray(p.position, np.float64)
            if (math.isfinite(p.radar_range)
                    and np.linalg.norm(self.C @ leaf.x - pos)
                    > p.radar_range):
                dead.append((t, 'range'))
            elif ((leaf.cnllr - self.roots[t].cnllr) / (p.N + 1)
                    > p.score_upper_limit):
                dead.append((t, 'score'))
            elif leaf.cnllr > p.cnllr_upper_limit:
                dead.append((t, 'cnllr'))
        for t, why in reversed(dead):
            self.events.append(('kill', self.scan_idx, self.track_ids[t],
                                self.sel[t].x.copy(), why))
            self._archive_nodes(self.track_ids[t], self.sel[t].path())
            del self.roots[t]
            del self.sel[t]
            del self.track_ids[t]

    def _archive_nodes(self, tid, nodes):
        lst = self.archive.setdefault(tid, [])
        for n in nodes:
            if id(n) in self._recorded:
                continue
            self._recorded.add(id(n))
            lst.append((n.scan, n.meas, n.mmsi, n.x.copy()))

    # -- N-scan prune (tracker.py:1229-1231, pyTarget.py:343-356) ------
    def _prune(self):
        N = self.params.N
        for t, leaf in enumerate(self.sel):
            path = leaf.path()
            if len(path) - 1 > N:
                cut = len(path) - 1 - N
                new_root = path[cut]
                # columns leaving the window are confirmed history
                self._archive_nodes(self.track_ids[t], path[:cut])
                new_root.parent = None
                self.roots[t] = new_root

    # -- initiation (tracker.py:262-277, 147-160) ----------------------
    def _initiate(self, z, scan_time, used_radar, used_mmsi, ais_msgs):
        unused_idx = [m for m in range(len(z)) if m not in used_radar]
        z_unused = (z[unused_idx] if unused_idx
                    else np.zeros((0, 2), np.float64))
        if self.ais_initialization:
            ais_unused = [m for m in ais_msgs if m.mmsi not in used_mmsi]
        else:
            ais_unused = []
        new_targets = self.initiator.process(z_unused, scan_time,
                                             ais_unused)
        for x0, P0 in new_targets:
            # neighbour rejection (pyTarget.py:181-189)
            near = any(np.linalg.norm(leaf.x[:2] - x0[:2])
                       < self.params.merge_threshold
                       for r in self.roots for leaf in r.leaves())
            if near:
                continue
            n = Node(x=np.asarray(x0, np.float64),
                     P=np.asarray(P0, np.float64),
                     cnllr=0.0, meas=0, scan=self.scan_idx)
            self.roots.append(n)
            self.sel.append(n)
            self.track_ids.append(self.next_id)
            self.events.append(('confirm', self.scan_idx, self.next_id,
                                np.asarray(x0, np.float64).copy(), ''))
            self.next_id += 1

    # -- per-scan main loop (tracker.py:162-307) -----------------------
    def step(self, t, z, ais_msgs=()):
        z = np.asarray(z, np.float64).reshape(-1, 2)
        ais_msgs = list(ais_msgs)
        dt = float(t) - self.time if self.time is not None else \
            self.params.radar_period
        if self.time is None:
            self.time = float(t) - self.params.radar_period
        self.scan_idx += 1
        p = self.params
        radar_range = (p.radar_range if math.isfinite(p.radar_range)
                       else 1e4)
        lambda_ais = (len(self.roots) * p.P_ais
                      / (np.pi * radar_range ** 2))
        self.scan_times.append(float(t))
        used_radar, used_mmsi = set(), set()
        for root in self.roots:
            used_mmsi |= self._grow_target(root, z, dt, ais_msgs,
                                           float(t), lambda_ais,
                                           used_radar)
        for members in self._clusters():
            self._solve_cluster(members)
        if self.do_terminate:
            self._terminate()
        self._prune()
        if self.do_initiate:
            self._initiate(z, float(t), used_radar, used_mmsi, ais_msgs)
        self.time = float(t)
        return [(leaf.meas, leaf.x.copy(), leaf.cnllr)
                for leaf in self.sel]

    def selected(self):
        """Per-track selection detail for parity checks:
        (track_id, meas_label, ais_mmsi, x, cnllr)."""
        return [(self.track_ids[t], leaf.meas, leaf.mmsi,
                 leaf.x.copy(), leaf.cnllr)
                for t, leaf in enumerate(self.sel)]

    def objective(self):
        return float(sum(leaf.cnllr for leaf in self.sel))

    def leaf_cost_by_history(self, t, labels):
        """Tie verification: min cnllr over leaves of target ``t`` whose
        association tail matches ``labels`` = [(meas, mmsi), ...] for the
        most recent ``len(labels)`` scans (oldest first); None if no leaf
        matches.  Used to prove that a device selection differing from
        the oracle's is an equal-cost optimum, not a real divergence."""
        best = None
        for leaf in self.roots[t].leaves():
            path = leaf.path()
            tail = path[-len(labels):]
            use = labels[-len(tail):]
            if all((n.meas, n.mmsi) == tuple(lab)
                   for n, lab in zip(tail, use)):
                best = leaf.cnllr if best is None else min(best, leaf.cnllr)
        return best

    def finalize(self):
        """Flush the live windows into the archive (call once, after the
        last scan) so ``sequences`` covers every scan."""
        for t, leaf in enumerate(self.sel):
            self._archive_nodes(self.track_ids[t], leaf.path())

    def sequences(self):
        """{track_id: (times, labels, states, mmsi)} over absolute scan
        times — the device Tracker's _track_measurement_sequences
        vocabulary, so utils.metrics.evaluate can score the oracle run
        directly (via MetricsAdapter)."""
        out = {}
        for tid, rows in self.archive.items():
            rows = sorted(rows, key=lambda r: r[0])
            times, labels, states, mmsi = [], [], [], []
            for scan, meas, mm, x in rows:
                if scan < 1:
                    continue        # pre-initialized root, before scan 1
                times.append(self.scan_times[scan - 1])
                labels.append(meas)
                states.append(x)
                mmsi.append(mm)
            if times:
                out[tid] = (times, labels, states, mmsi)
        return out


class MetricsAdapter:
    """Duck-types the two attributes utils.metrics.evaluate reads
    (``_track_measurement_sequences`` and ``t0``) over a finished
    RefOracle run, so device and oracle are scored by the same code."""

    def __init__(self, oracle: 'RefOracle'):
        oracle.finalize()
        self._seqs = oracle.sequences()
        self.t0 = 0.0               # oracle times are already absolute

    def _track_measurement_sequences(self, include_terminated=False):
        return self._seqs
