"""Scan-level checkpoint/resume of the full tracker.

The reference has no checkpointing (SURVEY §5 — persistence is
write-only XML).  Here the whole tracker — device SoA state, initiator
state, host archives, scan history, config — serialises to a single
.npz + JSON sidecar, enabling exact scan-level resume (bitwise: all
device state is concrete arrays, no RNG lives in the tracker itself).
"""
from __future__ import annotations

import dataclasses
import json
import os

import numpy as np
import jax

from ..core.config import TrackerShapes, TrackerParams
from ..core.state import TrackerState
from ..core.initiator import InitiatorState
from ..core.tracker import Tracker, TrackArchive


def _tree_to_dict(prefix, tree):
    flat = {}
    # pytree_dataclass flattens in field order (utils/pytree.py).
    leaves = jax.tree_util.tree_leaves(tree)
    names = list(type(tree).__dataclass_fields__.keys())
    assert len(leaves) == len(names)
    for n, v in zip(names, leaves):
        flat[f"{prefix}.{n}"] = np.asarray(v)
    return flat


def _dict_to_tree(prefix, cls, data):
    names = list(cls.__dataclass_fields__.keys())
    return cls(**{n: jax.numpy.asarray(data[f"{prefix}.{n}"]) for n in names})


def save(tracker: Tracker, path: str):
    head = os.path.dirname(path)
    if head and not os.path.isdir(head):
        os.makedirs(head)
    arrays = {}
    arrays.update(_tree_to_dict("state", tracker.state))
    arrays.update(_tree_to_dict("init", tracker.init_state))
    for i, z in enumerate(tracker.scan_history):
        arrays[f"scan.{i}"] = z
    np.savez_compressed(path + ".npz", **arrays)

    def arch_dict(a):
        return {"track_id": a.track_id,
                "times": [float(t) if t is not None else None
                          for t in a.times],
                "states": [np.asarray(s).tolist() for s in a.states],
                "meas": [int(m) for m in a.meas],
                "mmsi": [int(m) for m in a.mmsi],
                "status": a.status}

    meta = {
        "shapes": dataclasses.asdict(tracker.shapes),
        "params": dataclasses.asdict(tracker.params),
        "method": tracker.method,
        "t0": tracker.t0,
        "scan_times": [float(t) for t in tracker.scan_times],
        "runtime_log": [float(t) for t in tracker.runtime_log],
        "archives": {str(k): arch_dict(v) for k, v in tracker.archives.items()},
        "terminated": {str(k): arch_dict(v)
                       for k, v in tracker.terminated.items()},
        "n_scans": len(tracker.scan_history),
    }
    with open(path + ".json", "w") as f:
        json.dump(meta, f)


def save_state(path: str, state: TrackerState, init_state: InitiatorState):
    """Snapshot bare device state — the checkpoint primitive for the
    device-resident streaming mode (between ``scan_many`` dispatches)
    and for the target-sharded step (arrays gather to host through
    ``np.asarray`` regardless of their sharding).  Both trees are plain
    pytrees of concrete arrays, so this is also directly consumable by
    orbax if a deployment prefers its async/multi-host machinery."""
    head = os.path.dirname(path)
    if head and not os.path.isdir(head):
        os.makedirs(head)
    arrays = {}
    arrays.update(_tree_to_dict("state", state))
    arrays.update(_tree_to_dict("init", init_state))
    np.savez_compressed(path + ".npz", **arrays)


def load_state(path: str, shardings=None):
    """Restore (TrackerState, InitiatorState) saved by ``save_state``.

    ``shardings``: optional (state_shardings, init_shardings) pytrees of
    NamedSharding to place the restored arrays back on a mesh (as built
    by e.g. parallel.sharded_tracker's spec helpers); None leaves them
    on the default device."""
    data = np.load(path + ".npz")
    state = _dict_to_tree("state", TrackerState, data)
    init = _dict_to_tree("init", InitiatorState, data)
    if shardings is not None:
        s_sh, i_sh = shardings
        state = jax.tree_util.tree_map(jax.device_put, state, s_sh)
        init = jax.tree_util.tree_map(jax.device_put, init, i_sh)
    return state, init


def load(path: str) -> Tracker:
    with open(path + ".json") as f:
        meta = json.load(f)
    shapes = TrackerShapes(**meta["shapes"])
    params_d = meta["params"]
    params_d["position"] = tuple(params_d["position"])
    params = TrackerParams(**params_d)
    tracker = Tracker(shapes, params, method=meta["method"])
    data = np.load(path + ".npz")
    tracker.state = _dict_to_tree("state", TrackerState, data)
    tracker.init_state = _dict_to_tree("init", InitiatorState, data)
    tracker.t0 = meta["t0"]
    tracker.scan_times = list(meta["scan_times"])
    tracker.runtime_log = list(meta["runtime_log"])
    tracker.scan_history = [data[f"scan.{i}"] for i in range(meta["n_scans"])]

    def mk_arch(d):
        return TrackArchive(track_id=d["track_id"], times=list(d["times"]),
                            states=[np.asarray(s, np.float32)
                                    for s in d["states"]],
                            meas=list(d["meas"]), mmsi=list(d["mmsi"]),
                            status=d["status"])

    tracker.archives = {int(k): mk_arch(v)
                        for k, v in meta["archives"].items()}
    tracker.terminated = {int(k): mk_arch(v)
                          for k, v in meta["terminated"].items()}
    return tracker
