"""The per-scan tracker pipeline and host-facing Tracker class.

Device side: one jitted, fixed-shape ``scan_step`` composing
grow -> select -> terminate -> N-scan prune -> initiate -> insert —
the reference's 7-phase ``addMeasurementList`` loop
(/root/reference/pymht/tracker.py:162-307) as a single compiled program.

Host side: the ``Tracker`` class mirrors the reference API surface
(constructor kwargs, ``addMeasurementList``, ``getTrackNodes``,
``getSmoothTracks``) while keeping all hot state on device.  The host
archives each track's *confirmed* past (the window-root spine the
reference keeps as parent pointers) as plain numpy, appended from the
prune outputs each scan.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import numpy as np
import jax
import jax.numpy as jnp

from ..models import pv
from .config import TrackerShapes, TrackerParams
from .state import TrackerState, empty_state, insert_targets
from .grow import Scan, AisBatch, empty_ais, grow
from .select import select, SelectionResult
from .lifecycle import n_scan_prune, terminate
from . import initiator as initiator_mod


class StepOutputs(NamedTuple):
    # Selected track estimate per target slot (post-selection, pre-prune)
    track_mask: jnp.ndarray     # [T] bool — active when selected
    track_id: jnp.ndarray       # [T] i32
    track_x: jnp.ndarray        # [T, 4]
    track_cnllr: jnp.ndarray    # [T]
    sel_hist_valid: jnp.ndarray  # [T, W] bool
    sel_hist_x: jnp.ndarray     # [T, W, 4]
    sel_hist_meas: jnp.ndarray  # [T, W] i32
    sel_hist_mmsi: jnp.ndarray  # [T, W] i32
    # Lifecycle
    dead: jnp.ndarray           # [T] bool
    dead_reason: jnp.ndarray    # [T] i32
    confirmed_mask: jnp.ndarray  # [T, W]
    confirmed_x: jnp.ndarray    # [T, W, 4]
    confirmed_meas: jnp.ndarray  # [T, W]
    confirmed_mmsi: jnp.ndarray  # [T, W]
    # Newly inserted (confirmed) targets this scan: slot mask + the
    # initial covariance of their root leaf (the initiator's two-point
    # covariance — needed so serialized S_inv sequences start from the
    # track's true P, not pv.P0; reference stores per-node S_inv,
    # pyTarget.py:782-784).
    inserted_mask: jnp.ndarray  # [T] bool
    inserted_id: jnp.ndarray    # [T] i32 (post-insert tgt_id)
    inserted_P: jnp.ndarray     # [T, 4, 4]
    # Diagnostics
    n_clusters: jnp.ndarray     # [] i32
    sel_obj: jnp.ndarray        # [] f32
    sel_bound: jnp.ndarray      # [] f32
    sel_feasible: jnp.ndarray   # [] bool
    n_leaves: jnp.ndarray       # [] i32
    leaf_counts: jnp.ndarray    # [T] i32 — live leaves per target
    gated_counts: jnp.ndarray   # [T] i32 — gated pairs (grow-cost proxy)
    used_meas: jnp.ndarray      # [M] bool


def scan_step(state: TrackerState,
              init_state: initiator_mod.InitiatorState,
              scan: Scan,
              ais: AisBatch,
              shapes: TrackerShapes,
              params: TrackerParams,
              method: str = 'ipm',
              use_ais: bool = True,
              ais_initialization: bool = True,
              prune_similar: bool = False,
              compute_clusters: bool = True,
              dynamic_window: bool = False,
              select_kw: Optional[dict] = None):
    """One radar scan through the full pipeline (pure, jittable)."""
    T, L, W = state.hist_meas.shape
    tb = jnp.arange(T)

    # 1. grow ---------------------------------------------------------
    g = grow(state, scan, ais if use_ais else None, shapes, params)
    state = g.state
    if prune_similar:
        from .merge import prune_similar as _ps
        state = _ps(state, shapes, params)

    # 2-3. cluster + global hypothesis selection ---------------------
    sel_res = select(state, shapes, params, method=method,
                     compute_clusters=compute_clusters,
                     **(select_kw or {}))
    state = state.replace(sel_leaf=sel_res.sel, lam=sel_res.lam)

    # snapshot of the selected track nodes (reference __trackNodes__)
    sel = sel_res.sel
    track_x = state.leaf_x[tb, sel]
    track_cnllr = state.leaf_cnllr[tb, sel]
    sel_hist_valid = (jnp.arange(W)[None, :]
                      >= (W - state.tgt_depth)[:, None]) & state.tgt_mask[:, None]
    sel_hist_x = state.hist_x[tb, sel]
    sel_hist_meas = state.hist_meas[tb, sel]
    sel_hist_mmsi = state.hist_mmsi[tb, sel]
    track_mask = state.tgt_mask
    track_id = state.tgt_id

    # 6. terminate ----------------------------------------------------
    term = terminate(state, shapes, params)
    state = term.state

    # 7. N-scan prune -------------------------------------------------
    pr = n_scan_prune(state, shapes, params)
    state = pr.state

    # 8. initiate -----------------------------------------------------
    unused_z = scan.mask & ~g.used_meas
    if use_ais and ais_initialization:
        # AIS messages whose MMSI was associated by any surviving leaf
        # this scan are not available for initiation (tracker.py:267-270).
        cur_mmsi = jnp.where(state.leaf_mask, state.hist_mmsi[:, :, -1], 0)
        used_mmsi_ais = jnp.isin(ais.mmsi, cur_mmsi.reshape(-1))
        ais_for_init = ais._replace(mask=ais.mask & ~used_mmsi_ais)
    else:
        ais_for_init = empty_ais(shapes)
    init_out = initiator_mod.step(init_state, scan.z, unused_z, scan.time,
                                  ais_for_init, shapes, params)
    init_state = init_out.state

    # merge near-duplicate new targets (m_of_n.py:128-147), then reject
    # those neighbouring an existing track (pyTarget.py:181-189).
    new_x, new_mask, new_mmsi = _merge_new_targets(
        init_out.new_x, init_out.new_mask, init_out.new_mmsi,
        params.merge_threshold)
    leaf_pos = state.leaf_x[..., :2].reshape(-1, 2)
    leaf_ok = state.leaf_mask.reshape(-1)
    d = jnp.linalg.norm(new_x[:, None, :2] - leaf_pos[None, :, :], axis=2)
    near = (d < params.merge_threshold) & leaf_ok[None, :]
    new_mask = new_mask & ~near.any(axis=1)
    prev_mask = state.tgt_mask
    state = insert_targets(state, new_x, init_out.new_P, new_mask,
                           new_mmsi, scan.time, params)
    inserted = state.tgt_mask & ~prev_mask

    # 9. on-device dynamic window (graceful degradation for the
    # device-resident streaming path; reference __dynamicWindow,
    # tracker.py:918-950).  Two of the reference's triggers run here —
    # the host wall-clock roof stays in Tracker._dynamic_window (time
    # does not exist inside a compiled step):
    #   * beam saturation: a target whose beam is STILL full after
    #     N-scan pruning is over budget in hypothesis capacity;
    #   * growth-cost share: the reference shrinks a target whose grow
    #     TIME exceeds maxTargetGrowTime (200 ms); its share-based
    #     analogue fires when a target's gated-pair work exceeds
    #     max_target_time/radar_period of the scan total AND its beam is
    #     at least half full (the absolute anchor real time provided).
    # NOTE: shapes are static, so shrinking the window changes no FLOPs
    # — it narrows the surviving hypothesis set (more aggressive
    # N-scan pruning), which is what bounds ambiguity growth under
    # overload, exactly the reference's intent.
    if dynamic_window:
        lc = jnp.sum(state.leaf_mask.astype(jnp.int32), axis=1)      # [T]
        sat = state.tgt_mask & (lc >= L)
        proxy = lc.astype(jnp.float32) * (
            1.0 + g.gated_counts.astype(jnp.float32))
        total = jnp.sum(jnp.where(state.tgt_mask, proxy, 0.0))
        share = params.max_target_time / params.radar_period
        over = (state.tgt_mask & (lc >= L // 2)
                & (proxy > share * jnp.maximum(total, 1.0)))
        shrink = (sat | over) & ~inserted
        tw = jnp.where(shrink, jnp.maximum(state.tgt_window - 1, 1),
                       state.tgt_window)
        state = state.replace(tgt_window=tw)

    outputs = StepOutputs(
        track_mask=track_mask, track_id=track_id, track_x=track_x,  # noqa: E126
        track_cnllr=track_cnllr,
        sel_hist_valid=sel_hist_valid, sel_hist_x=sel_hist_x,
        sel_hist_meas=sel_hist_meas, sel_hist_mmsi=sel_hist_mmsi,
        dead=term.dead, dead_reason=term.reason,
        confirmed_mask=pr.confirmed_mask, confirmed_x=pr.confirmed_x,
        confirmed_meas=pr.confirmed_meas, confirmed_mmsi=pr.confirmed_mmsi,
        inserted_mask=inserted, inserted_id=state.tgt_id,
        inserted_P=state.leaf_P[:, 0],
        n_clusters=sel_res.n_clusters, sel_obj=sel_res.obj,
        sel_bound=sel_res.bound, sel_feasible=sel_res.feasible,
        n_leaves=jnp.sum(state.leaf_mask.astype(jnp.int32)),
        leaf_counts=jnp.sum(state.leaf_mask.astype(jnp.int32), axis=1),
        gated_counts=g.gated_counts,
        used_meas=g.used_meas,
    )
    return state, init_state, outputs


def _merge_new_targets(new_x, new_mask, new_mmsi, threshold):
    """Greedy group-by-proximity merge: each candidate joins the first
    candidate within ``threshold``; group representatives take the mean
    state (reference _merge_targets/_merge_similar_targets)."""
    K = new_x.shape[0]
    d = jnp.linalg.norm(new_x[:, None, :2] - new_x[None, :, :2], axis=2)
    close = (d < threshold) & new_mask[:, None] & new_mask[None, :]
    first = jnp.argmax(close, axis=1)                      # min index close
    rep = first == jnp.arange(K)                           # I'm my own rep
    # member j belongs to representative first[j]
    member_of = jax.nn.one_hot(first, K, dtype=jnp.float32) * new_mask[:, None]
    counts = member_of.sum(axis=0)                         # [K] per rep
    sums = jnp.matmul(member_of.T, new_x,
                      precision=jax.lax.Precision.HIGHEST)  # [K, 4]
    mean_x = sums / jnp.maximum(counts[:, None], 1.0)
    keep = new_mask & rep
    out_x = jnp.where(keep[:, None], mean_x, new_x)
    mmsi = jnp.where(keep, new_mmsi, 0)
    return out_x, keep, mmsi


def scan_many(state, init_state, scans: Scan, ais: AisBatch,
              shapes: TrackerShapes, params: TrackerParams,
              method: str = 'lagrangian', use_ais: bool = True,
              ais_initialization: bool = True,
              compute_clusters: bool = False,
              dynamic_window: bool = False,
              select_kw: Optional[dict] = None):
    """Process a pre-uploaded batch of scans in ONE dispatch via
    lax.scan (device-resident streaming: the production pattern where
    radar frames buffer on device while the tracker computes).

    scans/ais carry a leading time axis.  Returns (state, init_state,
    stacked StepOutputs).
    """
    def body(carry, inp):
        st, ist = carry
        scan_t, ais_t = inp
        st, ist, out = scan_step(st, ist, scan_t, ais_t, shapes, params,
                                 method=method, use_ais=use_ais,
                                 ais_initialization=ais_initialization,
                                 compute_clusters=compute_clusters,
                                 dynamic_window=dynamic_window,
                                 select_kw=select_kw)
        return (st, ist), out

    (state, init_state), outs = jax.lax.scan(
        body, (state, init_state), (scans, ais))
    return state, init_state, outs


@dataclasses.dataclass
class TrackArchive:
    """Host-side confirmed history of one track."""
    track_id: int
    times: list
    states: list           # np [4]
    meas: list             # int labels (0 missed, m>=1 radar)
    mmsi: list
    status: str = 'Active'


class Tracker:
    """Host-facing tracker with the reference's API shape.

    Usage::

        tracker = Tracker(shapes, params)
        for scan in scans:
            tracker.add_measurement_list(t, z)   # z: [n, 2] numpy
        tracks = tracker.get_tracks()
    """

    def __init__(self, shapes: TrackerShapes = TrackerShapes(),
                 params: TrackerParams = TrackerParams(),
                 method: str = 'ipm', use_ais: bool = True,
                 ais_initialization: bool = True,
                 pipeline_outputs: bool = False,
                 prune_similar: bool = False,
                 dynamic_window: bool = False,
                 degrade_on_overload: bool = False):
        self.shapes = shapes
        self.params = params
        self.method = method
        self.pipeline_outputs = pipeline_outputs
        self.dynamic_window = dynamic_window
        self.degrade_on_overload = degrade_on_overload
        self._degrade_cooldown = 0
        self._pending = None      # (device outputs, scan index)
        self.state = empty_state(shapes, params)
        self.init_state = initiator_mod.empty_initiator(shapes)
        self.archives = {}          # id -> TrackArchive
        self.terminated = {}        # id -> TrackArchive
        self.init_P = {}            # id -> initial covariance [4,4]
        self.scan_times = []
        self.scan_history = []      # raw numpy measurements per scan
        self.ais_history = []       # AIS message list per scan
                                    # (reference __aisHistory__, :83)
        from ..utils.timing import RuntimeLog
        self.runtime = RuntimeLog(radar_period=params.radar_period)
        self.runtime_log = []
        self.t0 = None
        self._empty_ais = empty_ais(shapes)   # constant, uploaded once

        self._use_ais = use_ais
        self._ais_initialization = ais_initialization
        self._prune_similar = prune_similar
        self._build_step()

    def _build_step(self):
        """(Re)compile the per-scan step for the CURRENT self.shapes —
        called at construction and again by degrade()."""
        shapes, params = self.shapes, self.params
        method = self.method
        use_ais, ais_init = self._use_ais, self._ais_initialization
        prune_similar = self._prune_similar

        def _unpack_and_step(s, i, packed, ais):
            # packed: [M+1, 2] f32 — rows 0..M-1 measurements, row M is
            # (count, time).  One host->device transfer per scan.
            M = shapes.max_meas
            z = packed[:M]
            count = packed[M, 0].astype(jnp.int32)
            t = packed[M, 1]
            mask = jnp.arange(M) < count
            scan = Scan(z=z, mask=mask, time=t)
            return scan_step(s, i, scan, ais, shapes, params,
                             method=method, use_ais=use_ais,
                             ais_initialization=ais_init,
                             prune_similar=prune_similar)

        # Donate the carried state buffers: the step consumes and
        # replaces them every scan, so in-place reuse saves an
        # allocate+copy of the whole SoA forest per dispatch (the host
        # keeps no reference to the old buffers — self.state/init_state
        # are reassigned from the outputs).  CPU ignores donation with a
        # warning, so only donate on accelerators.
        donate = () if jax.default_backend() == 'cpu' else (0, 1)
        self._step = jax.jit(_unpack_and_step, donate_argnums=donate)

    def degrade(self, beam_factor: int = 2, ais_per_leaf: Optional[int] = None,
                min_leaves: int = 4):
        """Switch to a compiled step with a narrower hypothesis beam —
        COMPUTE-SHEDDING degradation (the reference's __dynamicWindow
        exists to keep a scan inside the radar period,
        tracker.py:918-950; under static shapes only a smaller compiled
        variant actually reduces work).  Converts the device state with
        state.shrink_beam (one gather) and re-jits the step.  Returns
        True if the beam shrank.  One-way by design, like the
        reference's window shrink."""
        from .state import shrink_beam
        L = self.shapes.max_leaves
        new_L = max(min_leaves, L // beam_factor)
        changed = new_L < L
        if changed:
            self.flush()
            self.state = shrink_beam(self.state, new_L)
            kw = dict(max_leaves=new_L)
            if ais_per_leaf is not None:
                kw['ais_per_leaf'] = max(0, min(ais_per_leaf,
                                                self.shapes.max_ais))
            self.shapes = dataclasses.replace(self.shapes, **kw)
            self._build_step()
        return changed

    # -- input padding ------------------------------------------------
    def _pad_scan(self, t, z):
        M = self.shapes.max_meas
        z = np.asarray(z, np.float32).reshape(-1, 2)
        n = min(len(z), M)
        packed = np.zeros((M + 1, 2), np.float32)
        packed[:n] = z[:n]
        packed[M] = (n, t)
        if len(z) > M:
            import logging
            logging.getLogger(__name__).warning(
                "scan has %d measurements; capacity %d — dropping overflow",
                len(z), M)
        return jnp.asarray(packed)

    def _pad_ais(self, messages):
        A = self.shapes.max_ais
        if not messages:
            return self._empty_ais
        st = np.zeros((A, 4), np.float32)
        tm = np.zeros((A,), np.float32)
        mm = np.zeros((A,), np.int32)
        hi = np.zeros((A,), bool)
        mask = np.zeros((A,), bool)
        for i, m in enumerate(messages[:A]):
            st[i] = np.asarray(m.state, np.float32)
            tm[i] = float(m.time) - self.t0
            mm[i] = int(m.mmsi)
            hi[i] = bool(getattr(m, 'highAccuracy', False))
            mask[i] = True
        return AisBatch(state=jnp.asarray(st), time=jnp.asarray(tm),
                        mmsi=jnp.asarray(mm), high_accuracy=jnp.asarray(hi),
                        mask=jnp.asarray(mask))

    def make_stream_inputs(self, scans, ais_groups=None):
        """Build device-resident streaming inputs for ``scan_many``.

        ``scans``: iterable of objects with ``.time`` (absolute) and
        ``.measurements`` [n, 2]; ``ais_groups``: optional per-scan
        lists of AIS messages.  Returns (Scan, AisBatch) pytrees with a
        leading scan axis, with all times converted to the tracker's
        internal origin (``self.t0``) — hand-building these with any
        other base shifts the first-scan dt and silently breaks
        pre-initialized tracks (round-3 streaming-bench bug; see
        tests/test_tracker_e2e.py::test_streaming_timebase_*).

        Call after ``pre_initialize`` (or pass the first scan so the
        origin is established from it).
        """
        scans = list(scans)
        if self.t0 is None:
            self.t0 = float(scans[0].time) - self.params.radar_period
        n = len(scans)
        M = self.shapes.max_meas
        A = self.shapes.max_ais
        n_z_over = n_ais_over = 0
        zb = np.zeros((n, M, 2), np.float32)
        mb = np.zeros((n, M), bool)
        tb = np.zeros((n,), np.float32)
        a_st = np.zeros((n, A, 4), np.float32)
        a_tm = np.zeros((n, A), np.float32)
        a_mm = np.zeros((n, A), np.int32)
        a_hi = np.zeros((n, A), bool)
        a_mk = np.zeros((n, A), bool)
        for i, s in enumerate(scans):
            z = np.asarray(s.measurements, np.float32).reshape(-1, 2)
            k = min(len(z), M)
            n_z_over += max(0, len(z) - M)
            zb[i, :k] = z[:k]
            mb[i, :k] = True
            tb[i] = float(s.time) - self.t0
            group = (ais_groups[i] if ais_groups is not None
                     and i < len(ais_groups) else [])
            n_ais_over += max(0, len(group) - A)
            for j, m in enumerate(group[:A]):
                a_st[i, j] = np.asarray(m.state, np.float32)
                a_tm[i, j] = float(m.time) - self.t0
                a_mm[i, j] = int(m.mmsi)
                a_hi[i, j] = bool(getattr(m, 'highAccuracy', False))
                a_mk[i, j] = True
        if n_z_over or n_ais_over:
            # silent shape overflow invisibly skews streaming results —
            # surface it (advisor round-3 finding)
            import logging
            logging.getLogger(__name__).warning(
                "make_stream_inputs: dropped %d measurements and %d AIS "
                "messages overflowing static shapes (M=%d, A=%d) across "
                "%d scans — raise TrackerShapes.max_meas/max_ais",
                n_z_over, n_ais_over, M, A, n)
        scan_b = Scan(z=jnp.asarray(zb), mask=jnp.asarray(mb),
                      time=jnp.asarray(tb))
        ais_b = AisBatch(state=jnp.asarray(a_st), time=jnp.asarray(a_tm),
                         mmsi=jnp.asarray(a_mm),
                         high_accuracy=jnp.asarray(a_hi),
                         mask=jnp.asarray(a_mk))
        return scan_b, ais_b

    def stream(self, scans, ais_groups=None, chunk: int = 16,
               compute_clusters: bool = False,
               dynamic_window: bool = False):
        """Device-resident streaming with host supervision: process
        ``chunk`` scans per dispatch (``scan_many`` — the per-dispatch
        relay cost amortises across the chunk; the production pattern
        of examples/demo_streaming_deployment.py), absorb every scan's
        outputs into the same per-track archives as
        ``add_measurement_list``, and between chunks apply the
        host-side wall-clock supervision (runtime log/watchdog, and —
        with ``degrade_on_overload`` — the roof-triggered switch to the
        half-beam compiled step; wall-clock triggers can only live
        where wall clocks exist, reference tracker.py:918-950).

        Returns the list of per-chunk stacked StepOutputs (host numpy).
        """
        import time as _time
        scans = list(scans)
        if not scans:
            return []
        if self.t0 is None:
            self.t0 = float(scans[0].time) - self.params.radar_period
        if not hasattr(self, '_stream_jits'):
            self._stream_jits = {}
        outs_all = []
        i0 = 0
        n_chunks_done = 0
        while i0 < len(scans):
            sub = scans[i0:i0 + chunk]
            group = (ais_groups[i0:i0 + chunk]
                     if ais_groups is not None else None)
            scan_b, ais_b = self.make_stream_inputs(sub, group)
            shapes, params = self.shapes, self.params
            key = (shapes, self.method, compute_clusters, dynamic_window,
                   len(sub))
            fn = self._stream_jits.get(key)
            if fn is None:
                use_ais = self._use_ais
                ais_init = self._ais_initialization
                method = self.method

                def fn(s, i, sc, a, shapes=shapes, params=params):
                    return scan_many(s, i, sc, a, shapes, params,
                                     method=method, use_ais=use_ais,
                                     ais_initialization=ais_init,
                                     compute_clusters=compute_clusters,
                                     dynamic_window=dynamic_window)

                fn = jax.jit(fn)
                self._stream_jits[key] = fn
            tic = _time.time()
            self.state, self.init_state, outs = fn(
                self.state, self.init_state, scan_b, ais_b)
            outs_np = jax.device_get(outs)
            dt_wall = _time.time() - tic
            per_scan = dt_wall / len(sub)
            for j, s in enumerate(sub):
                self.scan_history.append(
                    np.asarray(s.measurements, np.float32).reshape(-1, 2))
                self.ais_history.append(
                    list(group[j]) if group is not None and j < len(group)
                    else [])
                self.scan_times.append(float(s.time) - self.t0)
                out_j = jax.tree_util.tree_map(lambda x: x[j], outs_np)
                self._absorb_outputs(out_j, n_scans=len(self.scan_times))
                self.runtime_log.append(per_scan)
                self.runtime.record('Total', per_scan)
            # supervision between chunks; first chunk's wall time is
            # compile-dominated, never a load signal
            if (n_chunks_done >= 1 and self.degrade_on_overload
                    and per_scan > 0.8 * params.radar_period):
                self.degrade()      # next chunk recompiles at L/2
            n_chunks_done += 1
            i0 += chunk
            outs_all.append(outs_np)
        return outs_all

    def pre_initialize(self, t, states, mmsi=None):
        """Seed confirmed targets from known initial states (reference
        preInitialize, tracker.py:139-145)."""
        if self.t0 is None:
            self.t0 = float(t) - self.params.radar_period
        K = len(states)
        T = self.shapes.max_targets
        x = np.zeros((max(K, 1), 4), np.float32)
        x[:K] = np.asarray(states, np.float32)
        P0 = np.broadcast_to(np.asarray(pv.P0), (max(K, 1), 4, 4))
        mask = np.zeros((max(K, 1),), bool)
        mask[:K] = True
        mm = np.zeros((max(K, 1),), np.int32)
        if mmsi is not None:
            mm[:K] = np.asarray(mmsi, np.int32)
        self.state = insert_targets(
            self.state, jnp.asarray(x), jnp.asarray(np.array(P0)),
            jnp.asarray(mask), jnp.asarray(mm),
            jnp.asarray(float(t) - self.t0, jnp.float32), self.params)

    # -- main entry (reference addMeasurementList) --------------------
    def add_measurement_list(self, t, z, ais_messages=None,
                             check_integrity: bool = False, **kwargs):
        """One radar scan (reference addMeasurementList,
        tracker.py:162-307).  ``check_integrity`` mirrors the
        reference's per-scan checkIntegrity kwarg (tracker.py:163-164,
        215,261,289): run the structural invariants after the scan and
        raise AssertionError on violation."""
        import time as _time
        tic = _time.time()
        check_integrity = check_integrity or kwargs.pop(
            'checkIntegrity', False)
        if self.t0 is None:
            # device time is relative to the first scan for fp32 safety
            self.t0 = float(t) - self.params.radar_period
        t_rel = float(t) - self.t0
        self.scan_history.append(np.asarray(z, np.float32).reshape(-1, 2))
        self.ais_history.append(list(ais_messages or []))
        scan = self._pad_scan(t_rel, z)
        ais = self._pad_ais(ais_messages or [])
        self.state, self.init_state, out = self._step(
            self.state, self.init_state, scan, ais)
        self.scan_times.append(t_rel)
        if self.pipeline_outputs:
            # Absorb the PREVIOUS scan's outputs while the device works
            # on this one (dispatch is async; the fetch overlaps).
            if self._pending is not None:
                prev_out, prev_n = self._pending
                self._absorb_outputs(jax.device_get(prev_out),
                                     n_scans=prev_n)
            self._pending = (out, len(self.scan_times))
            dt_wall = _time.time() - tic
            self.runtime_log.append(dt_wall)
            self.runtime.record('Total', dt_wall)
            if check_integrity:
                self.check_integrity()
            return out
        # Single host transfer for the whole outputs tree (one fetch
        # instead of one per array).
        out_np = jax.device_get(out)
        self._absorb_outputs(out_np, n_scans=len(self.scan_times))
        dt_wall = _time.time() - tic
        self.runtime_log.append(dt_wall)
        self.runtime.record('Total', dt_wall)
        if self.dynamic_window:
            self._dynamic_window(dt_wall, out_np.leaf_counts,
                                 out_np.gated_counts)
        if check_integrity:
            self.check_integrity()
        return out_np

    def _dynamic_window(self, dt_wall, leaf_counts, gated_counts=None):
        """Graceful degradation under load (reference __dynamicWindow,
        tracker.py:918-950), three triggers in escalating scope:

        1. per-target TIME budget (tracker.py:918-928): the reference
           shrinks a target's window when growing it took more than
           maxTargetGrowTime (200 ms).  Per-target wall time does not
           exist in a batched step, so each target's share of the scan's
           wall time is estimated from its growth-cost proxy
           (live leaves x gated pairs); a target whose estimated share
           exceeds ``params.max_target_time`` shrinks individually.
        2. beam saturation: a target whose hypothesis beam is full is
           over budget in *capacity* — shrink it.
        3. global roof (tracker.py:943-950): whole-scan wall time above
           80% of the radar period lowers the roof for everyone.
        """
        L = self.shapes.max_leaves
        tw = np.asarray(self.state.tgt_window)
        # Ignore the first scans throughout: their wall time is
        # dominated by XLA compilation, not steady-state load.
        warm = len(self.scan_times) > 2
        if gated_counts is not None and warm:
            lc = np.asarray(leaf_counts, np.float64)
            gc = np.asarray(gated_counts, np.float64)
            proxy = lc * (1.0 + gc)
            total = proxy.sum()
            if total > 0:
                est = dt_wall * proxy / total          # [T] seconds
                over = est > self.params.max_target_time
                if over.any():
                    tw = np.where(over, np.maximum(tw - 1, 1), tw)
        saturated = np.asarray(leaf_counts) >= L
        if saturated.any():
            tw = np.where(saturated, np.maximum(tw - 1, 1), tw)
        roof = dt_wall > 0.8 * self.params.radar_period and warm
        if roof:
            self._n_roof = max(1, getattr(self, '_n_roof', self.params.N) - 1)
            tw = np.minimum(tw, self._n_roof)
        self.state = self.state.replace(tgt_window=jnp.asarray(tw))
        # Compute-shedding escalation: when the roof trigger fires and
        # window shrinking alone cannot help (static shapes), switch to
        # the half-beam compiled step.  A cooldown of 3 scans lets the
        # new program's wall time be observed before shrinking again.
        self._degrade_cooldown = max(0, self._degrade_cooldown - 1)
        if roof and self.degrade_on_overload and self._degrade_cooldown == 0:
            if self.degrade():
                self._degrade_cooldown = 3

    def flush(self):
        """Absorb any pipelined outputs still pending on device."""
        if self._pending is not None:
            prev_out, prev_n = self._pending
            self._absorb_outputs(jax.device_get(prev_out), n_scans=prev_n)
            self._pending = None

    # alias matching the reference name
    addMeasurementList = add_measurement_list

    def print_time_log(self):
        """reference printTimeLog (tracker.py:1425-1464)."""
        print(self.runtime.summary())

    printTimeLog = print_time_log

    def profile_phases(self, t, z, ais_messages=None, record=True):
        """Per-phase timing of one scan (reference tic/toc phases,
        tracker.py:192-259).  The production step is one fused program,
        so phase timing requires de-fused execution
        (utils/timing.phase_profile); with ``record`` the results enter
        ``self.runtime`` and are exported by xml_io.store_run exactly
        like the reference's per-phase Runtime element
        (tracker.py:1512-1533).  Does NOT mutate tracker state."""
        from ..utils.timing import phase_profile
        phases = phase_profile(self, t, z, ais_messages)
        if record:
            for k, v in phases.items():
                self.runtime.record(k, v)
        return phases

    def get_runtime_average(self):
        """reference getRuntimeAverage (tracker.py:958-959)."""
        return self.runtime.averages()

    def print_target_list(self):
        """reference printTargetList (tracker.py:1402-1410): one line per
        active target with id, current best state and leaf count."""
        st = self.state
        mask = np.asarray(st.tgt_mask)
        ids = np.asarray(st.tgt_id)
        sel = np.asarray(st.sel_leaf)
        xs = np.asarray(st.leaf_x)
        nleaf = np.asarray(st.leaf_mask).sum(axis=1)
        cn = np.asarray(st.leaf_cnllr)
        print("Target list:")
        for slot in np.nonzero(mask)[0]:
            x = xs[slot, sel[slot]]
            print(f"  T{int(ids[slot]):<4d} pos=({x[0]:8.1f},{x[1]:8.1f}) "
                  f"vel=({x[2]:6.2f},{x[3]:6.2f}) "
                  f"leaves={int(nleaf[slot]):3d} "
                  f"cnllr={float(cn[slot, sel[slot]]):8.3f}")

    printTargetList = print_target_list

    def print_cluster_list(self):
        """reference printClusterList (tracker.py:1466-1470): clusters of
        targets sharing gated measurements."""
        from .select import cluster
        labels, n = cluster(self.state, self.shapes)
        labels = np.asarray(labels)
        mask = np.asarray(self.state.tgt_mask)
        ids = np.asarray(self.state.tgt_id)
        groups = {}
        for slot in np.nonzero(mask)[0]:
            groups.setdefault(int(labels[slot]), []).append(int(ids[slot]))
        print(f"Cluster list ({int(n)} clusters):")
        for i, (lab, members) in enumerate(sorted(groups.items())):
            print(f"  Cluster {i}: targets {members}")

    printClusterList = print_cluster_list

    def _absorb_outputs(self, out, n_scans=None):
        W = self.shapes.window
        ids = out.track_id
        mask = out.track_mask
        dead = out.dead
        reason = out.dead_reason
        conf_mask = out.confirmed_mask
        conf_x = out.confirmed_x
        conf_meas = out.confirmed_meas
        conf_mmsi = out.confirmed_mmsi
        sel_valid = out.sel_hist_valid
        sel_x = out.sel_hist_x
        sel_meas = out.sel_hist_meas
        sel_mmsi = out.sel_hist_mmsi

        # Window column w corresponds to scan index (n_scans-1) - (W-1-w).
        n = n_scans if n_scans is not None else len(self.scan_times)
        col_time = lambda w: self.scan_times[n - 1 - (W - 1 - w)] \
            if 0 <= n - 1 - (W - 1 - w) < n else None

        # Record the true initial covariance of tracks confirmed this
        # scan (two-point initiator covariance) for S_inv serialization.
        ins_mask = getattr(out, 'inserted_mask', None)
        if ins_mask is not None:
            for slot in np.nonzero(ins_mask)[0]:
                self.init_P[int(out.inserted_id[slot])] = \
                    np.asarray(out.inserted_P[slot], np.float64)

        reasons = {1: 'OutOfRange', 2: 'TooLowScore', 3: 'TooLowScore'}
        for slot in np.nonzero(mask)[0]:
            tid = int(ids[slot])
            arch = self.archives.setdefault(tid, TrackArchive(
                tid, [], [], [], []))
            if dead[slot]:
                # archive the whole remaining window (the reference keeps
                # the selected spine of a terminated track)
                for w in range(W):
                    if sel_valid[slot, w]:
                        arch.times.append(col_time(w))
                        arch.states.append(sel_x[slot, w].copy())
                        arch.meas.append(int(sel_meas[slot, w]))
                        arch.mmsi.append(int(sel_mmsi[slot, w]))
                arch.status = reasons.get(int(reason[slot]), 'Terminated')
                self.terminated[tid] = arch
                self.archives.pop(tid, None)
            else:
                for w in range(W):
                    if conf_mask[slot, w]:
                        arch.times.append(col_time(w))
                        arch.states.append(conf_x[slot, w].copy())
                        arch.meas.append(int(conf_meas[slot, w]))
                        arch.mmsi.append(int(conf_mmsi[slot, w]))

    # -- outputs ------------------------------------------------------
    def get_tracks(self):
        """Active tracks: id -> dict with confirmed history + current
        window of the selected hypothesis."""
        st = self.state
        ids = np.asarray(st.tgt_id)
        mask = np.asarray(st.tgt_mask)
        sel = np.asarray(st.sel_leaf)
        W = self.shapes.window
        depth = np.asarray(st.tgt_depth)
        hist_x = np.asarray(st.hist_x)
        hist_meas = np.asarray(st.hist_meas)
        hist_mmsi = np.asarray(st.hist_mmsi)
        n = len(self.scan_times)
        tracks = {}
        for slot in np.nonzero(mask)[0]:
            tid = int(ids[slot])
            arch = self.archives.get(tid)
            window_states = [hist_x[slot, sel[slot], w]
                             for w in range(W - depth[slot], W)]
            window_times = [self.scan_times[n - 1 - (W - 1 - w)]
                            for w in range(W - depth[slot], W)]
            window_meas = [int(hist_meas[slot, sel[slot], w])
                           for w in range(W - depth[slot], W)]
            window_mmsi = [int(hist_mmsi[slot, sel[slot], w])
                           for w in range(W - depth[slot], W)]
            tracks[tid] = {
                'confirmed_times': list(arch.times) if arch else [],
                'confirmed_states': list(arch.states) if arch else [],
                'confirmed_meas': list(arch.meas) if arch else [],
                'confirmed_mmsi': list(arch.mmsi) if arch else [],
                'window_times': window_times,
                'window_states': window_states,
                'window_meas': window_meas,
                'window_mmsi': window_mmsi,
            }
        return tracks

    def _track_measurement_sequences(self, include_terminated=False):
        """Per track: (times, labels, states, mmsi) per scan, combining
        the confirmed archive with the current selected window."""
        seqs = {}
        tracks = self.get_tracks()
        for tid, tr in tracks.items():
            times = tr['confirmed_times'] + tr['window_times']
            labels = tr['confirmed_meas'] + tr['window_meas']
            states = tr['confirmed_states'] + tr['window_states']
            mmsi = tr['confirmed_mmsi'] + tr['window_mmsi']
            if not times:
                continue
            seqs[tid] = (times, labels, states, mmsi)
        if include_terminated:
            for tid, arch in self.terminated.items():
                if arch.times:
                    seqs[tid] = (list(arch.times), list(arch.meas),
                                 list(arch.states), list(arch.mmsi))
        return seqs

    def get_smooth_tracks(self, em_iters: int = 0,
                          include_terminated: bool = False,
                          em_mode: str = 'scalar'):
        """RTS-smoothed (positions, velocities, ok) per track id —
        reference getSmoothTracks (tracker.py:1273-1274,
        pyTarget.py:580-609).

        All tracks are padded to a common length and smoothed in ONE
        batched device call (ops/smoother.smooth_tracks) — a per-track
        host loop would pay a dispatch round-trip per track.

        Reference parity: pykalman runs EM with n_iter=5
        (pyTarget.py:598-602) refitting Q, R, x0, P0 (its default
        em_vars with Phi/C pinned by the constructor) —
        ``em_iters=5, em_mode='full'`` reproduces that behaviour
        (parity-tested against a host EM oracle in
        tests/test_smoother.py).  The default stays ``em_iters=0``
        (pure RTS on the pv model): the pv matrices are the truth model
        of the simulator, so the EM refit mostly chases noise."""
        from ..ops.smoother import smooth_tracks
        time_to_idx = {t: i for i, t in enumerate(self.scan_times)}
        out = {}
        batch = []                      # (tid, zs [n,2], mask [n], x0)
        for tid, (times, labels, states, _mmsi) in \
                self._track_measurement_sequences(include_terminated).items():
            zs, mask = [], []
            for t, lab in zip(times, labels):
                idx = time_to_idx.get(t)
                if idx is None or lab is None or lab < 1 \
                        or lab - 1 >= len(self.scan_history[idx]):
                    zs.append(np.zeros(2, np.float32))
                    mask.append(False)
                else:
                    zs.append(self.scan_history[idx][lab - 1])
                    mask.append(True)
            zs = np.array(zs, np.float32).reshape(-1, 2)
            mask = np.array(mask, bool)
            if mask.sum() < 2:
                pos = np.where(mask[:, None], zs, np.nan)
                out[tid] = (pos, np.full_like(pos, np.nan), False)
                continue
            batch.append((tid, zs, mask, np.asarray(states[0], np.float32)))
        if not batch:
            return out
        # pad to a power-of-two length so recompiles stay bounded as
        # tracks lengthen scan by scan (trailing masked steps do not
        # perturb the smoothed interior: the filter coasts and the
        # backward correction through coasted steps is identically 0).
        n_max = max(len(b[2]) for b in batch)
        n_pad = 1 << (n_max - 1).bit_length()
        B = len(batch)
        zb = np.zeros((B, n_pad, 2), np.float32)
        mb = np.zeros((B, n_pad), bool)
        x0b = np.zeros((B, 4), np.float32)
        for i, (_, zs, mask, x0) in enumerate(batch):
            zb[i, :len(mask)] = zs
            mb[i, :len(mask)] = mask
            x0b[i] = x0
        P0b = np.broadcast_to(np.asarray(pv.P0, np.float32), (B, 4, 4))
        xs_b, _ = smooth_tracks(
            jnp.asarray(x0b), jnp.asarray(np.array(P0b)), jnp.asarray(zb),
            jnp.asarray(mb), self.params.radar_period,
            em_iters=em_iters, em_mode=em_mode)
        xs_b = np.asarray(xs_b)
        for i, (tid, zs, mask, _) in enumerate(batch):
            xs = xs_b[i, :len(mask)]
            out[tid] = (xs[:, :2], xs[:, 2:], True)
        return out

    getSmoothTracks = get_smooth_tracks

    def check_integrity(self):
        """Structural invariants of the forest state (reference
        _checkTrackerIntegrity, tracker.py:1241-1271).  Raises
        AssertionError on violation."""
        from ..utils.integrity import check_state_integrity
        check_state_integrity(self)

    checkIntegrity = check_integrity

    def get_track_nodes(self):
        """reference getTrackNodes (tracker.py:976-977): current best
        state per active track."""
        ids, states = self.get_track_states()
        return {int(i): s for i, s in zip(ids, states)}

    getTrackNodes = get_track_nodes

    def compare_tracks_with_truth(self, truth_states):
        """reference _compareTracksWithTruth (tracker.py:952-956): NEES
        of each active track against a paired truth state."""
        st = self.state
        mask = np.asarray(st.tgt_mask)
        sel = np.asarray(st.sel_leaf)
        xs = np.asarray(st.leaf_x)
        Ps = np.asarray(st.leaf_P)
        out = []
        slots = np.nonzero(mask)[0]
        for slot, xt in zip(slots, truth_states):
            d = xs[slot, sel[slot]] - np.asarray(xt)
            Pi = np.linalg.inv(Ps[slot, sel[slot]]
                               + 1e-9 * np.eye(4))
            out.append(float(d @ Pi @ d))
        return out

    def get_track_states(self):
        """[n_active, 4] current best state per active track + ids."""
        st = self.state
        mask = np.asarray(st.tgt_mask)
        sel = np.asarray(st.sel_leaf)
        x = np.asarray(st.leaf_x)
        ids = np.asarray(st.tgt_id)
        slots = np.nonzero(mask)[0]
        if len(slots) == 0:
            return ids[:0], np.zeros((0, 4), np.float32)
        return ids[slots], np.stack([x[s, sel[s]] for s in slots])
