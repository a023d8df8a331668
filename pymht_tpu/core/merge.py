"""Similar-state hypothesis merging.

Mirrors Target.pruneSimilarState (/root/reference/pymht/pyTarget.py:358-412):
sibling hypotheses (same history prefix) whose current positions lie
within a threshold are merged into one node carrying the mean state,
covariance and cumulative NLLR.  AIS-labelled hypotheses are exempt,
exactly like the reference (pyTarget.py:372-374).

In the trie representation "siblings" are leaves that agree on every
history column except the newest; the merged representative keeps the
group's minimum-cnllr label and the others free their beam slots.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

from .config import TrackerShapes, TrackerParams
from .state import TrackerState


def prune_similar(state: TrackerState, shapes: TrackerShapes,
                  params: TrackerParams) -> TrackerState:
    T, L, W = state.hist_meas.shape
    threshold = params.prune_threshold

    # Sibling test: identical labels on all but the newest column.
    prefix_eq = (
        jnp.all(state.hist_meas[:, :, None, :-1]
                == state.hist_meas[:, None, :, :-1], axis=3)
        & jnp.all(state.hist_ais[:, :, None, :-1]
                  == state.hist_ais[:, None, :, :-1], axis=3)
        & jnp.all(state.hist_mmsi[:, :, None, :-1]
                  == state.hist_mmsi[:, None, :, :-1], axis=3))  # [T,L,L]

    pos = state.leaf_x[..., :2]
    dist = jnp.linalg.norm(pos[:, :, None, :] - pos[:, None, :, :], axis=3)
    no_ais = state.hist_mmsi[:, :, -1] == 0                     # [T,L]
    # The feasibility spine must never be absorbed (selection repair
    # relies on its existence; see state.spine_leaf).
    not_spine = jnp.arange(L)[None, :] != state.spine_leaf[:, None]
    both_live = state.leaf_mask[:, :, None] & state.leaf_mask[:, None, :]
    mergeable = (prefix_eq & (dist < threshold) & both_live
                 & no_ais[:, :, None] & no_ais[:, None, :]
                 & not_spine[:, :, None] & not_spine[:, None, :])  # [T,L,L]

    # Representative = first (lowest index) mergeable partner; each leaf
    # belongs to exactly one group (its rep), so means are well-defined.
    rep = jnp.argmax(mergeable, axis=2)                          # [T,L]
    has_partner = mergeable.any(axis=2)                          # self counts
    is_rep = has_partner & (rep == jnp.arange(L)[None, :])
    # Guard against chains (j -> r but r itself absorbed into q): only
    # leaves whose rep is a stable rep participate; the rest wait for
    # the next scan.
    rep_is_rep = jnp.take_along_axis(is_rep, rep, axis=1)        # [T,L]
    has_partner = has_partner & rep_is_rep
    is_rep = has_partner & (rep == jnp.arange(L)[None, :])
    # member_of[t, j, r]: leaf j belongs to representative r
    member_of = (has_partner[:, :, None]
                 & (rep[:, :, None] == jnp.arange(L)[None, None, :]))
    w = member_of.astype(jnp.float32)
    counts = w.sum(axis=1)                                       # [T,L(r)]
    hi = jax.lax.Precision.HIGHEST     # no TF32 rounding of states
    mean_x = jnp.einsum('tjr,tji->tri', w, state.leaf_x, precision=hi) \
        / jnp.maximum(counts[..., None], 1.0)
    mean_P = jnp.einsum('tjr,tjik->trik', w, state.leaf_P, precision=hi) \
        / jnp.maximum(counts[..., None, None], 1.0)
    mean_c = jnp.einsum('tjr,tj->tr', w, state.leaf_cnllr, precision=hi) \
        / jnp.maximum(counts, 1.0)

    merged_group = is_rep & (counts > 1.5)                       # groups of >=2
    absorbed = has_partner & ~is_rep                             # [T,L] non-rep

    leaf_x = jnp.where(merged_group[..., None], mean_x, state.leaf_x)
    leaf_P = jnp.where(merged_group[..., None, None], mean_P, state.leaf_P)
    leaf_cnllr = jnp.where(merged_group, mean_c, state.leaf_cnllr)
    hist_cnllr = state.hist_cnllr.at[:, :, -1].set(
        jnp.where(merged_group, mean_c, state.hist_cnllr[:, :, -1]))
    leaf_mask = state.leaf_mask & ~absorbed

    return state.replace(leaf_x=leaf_x, leaf_P=leaf_P,
                         leaf_cnllr=leaf_cnllr, hist_cnllr=hist_cnllr,
                         leaf_mask=leaf_mask)
