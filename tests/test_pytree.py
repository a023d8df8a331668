"""The frozen pytree dataclass behind TrackerState / InitiatorState."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from pymht_tpu.core.config import TrackerShapes, TrackerParams
from pymht_tpu.core.initiator import InitiatorState, empty_initiator
from pymht_tpu.core.state import TrackerState, empty_state
from pymht_tpu.utils import checkpoint

SHAPES = TrackerShapes(max_targets=4, max_leaves=4, max_meas=8, max_ais=2,
                       window=3, max_prelim=4, max_initiators=8)
PARAMS = TrackerParams()


@pytest.mark.parametrize("cls,make", [
    (TrackerState, lambda: empty_state(SHAPES, PARAMS)),
    (InitiatorState, lambda: empty_initiator(SHAPES)),
], ids=["tracker", "initiator"])
def test_flatten_in_field_order(cls, make):
    tree = make()
    leaves, treedef = jax.tree_util.tree_flatten(tree)
    names = [f.name for f in dataclasses.fields(cls)]
    assert len(leaves) == len(names)
    for name, leaf in zip(names, leaves):
        assert leaf is getattr(tree, name)
    back = jax.tree_util.tree_unflatten(treedef, leaves)
    assert type(back) is cls
    assert all(getattr(back, n) is getattr(tree, n) for n in names)


def test_replace_is_functional_and_frozen():
    st = empty_state(SHAPES, PARAMS)
    st2 = st.replace(scan_idx=jnp.asarray(7, jnp.int32))
    assert int(st2.scan_idx) == 7 and int(st.scan_idx) == 0
    assert st2.leaf_x is st.leaf_x
    with pytest.raises(dataclasses.FrozenInstanceError):
        st.scan_idx = jnp.asarray(1)
    with pytest.raises(TypeError):
        st.replace(not_a_field=1)


def test_jit_round_trip():
    st = empty_state(SHAPES, PARAMS)

    @jax.jit
    def bump(s):
        return s.replace(leaf_x=s.leaf_x + 1.0, next_id=s.next_id + 2)

    out = bump(st)
    assert isinstance(out, TrackerState)
    np.testing.assert_array_equal(np.asarray(out.leaf_x), 1.0)
    assert int(out.next_id) == 2
    for name in ("leaf_P", "hist_meas", "lam"):
        np.testing.assert_array_equal(np.asarray(getattr(out, name)),
                                      np.asarray(getattr(st, name)))


def test_checkpoint_round_trip(tmp_path):
    st = empty_state(SHAPES, PARAMS).replace(
        leaf_x=jnp.arange(4 * 4 * 4, dtype=jnp.float32).reshape(4, 4, 4),
        tgt_id=jnp.asarray([3, -1, 5, -1], jnp.int32))
    ist = empty_initiator(SHAPES).replace(has_time=jnp.asarray(True))
    path = str(tmp_path / "ckpt")
    checkpoint.save_state(path, st, ist)
    st2, ist2 = checkpoint.load_state(path)
    for a, b in ((st, st2), (ist, ist2)):
        assert type(a) is type(b)
        for x, y in zip(jax.tree_util.tree_leaves(a),
                        jax.tree_util.tree_leaves(b)):
            np.testing.assert_array_equal(np.asarray(x), np.asarray(y))
            assert np.asarray(x).dtype == np.asarray(y).dtype
