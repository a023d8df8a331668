"""Frozen dataclasses that are JAX pytrees.

The tracker's device state is a struct of arrays.  ``pytree_dataclass``
makes such a struct a frozen dataclass whose fields are its pytree
children, flattened in declaration order (``utils/checkpoint.py`` names
the leaves by that order), with a ``replace(**changes)`` method for
functional updates.
"""
from __future__ import annotations

import dataclasses

import jax


def _replace(self, **changes):
    """Copy with the given fields changed."""
    return dataclasses.replace(self, **changes)


def pytree_dataclass(cls):
    """Class decorator: frozen dataclass + pytree over all its fields."""
    cls = dataclasses.dataclass(frozen=True)(cls)
    cls.replace = _replace
    names = [f.name for f in dataclasses.fields(cls)]
    return jax.tree_util.register_dataclass(cls, data_fields=names,
                                            meta_fields=[])
