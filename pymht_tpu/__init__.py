"""pymht_tpu — track-oriented multi-hypothesis tracking in JAX.

Public API:

    from pymht_tpu import Tracker, TrackerShapes, TrackerParams

Attribute access is lazy (PEP 562) so that multi-host entry points can
run ``pymht_tpu.parallel.multihost.initialize()`` (which must precede
any XLA backend initialisation) before the compute modules — which
create jax arrays at import time — are pulled in.
"""
__version__ = "0.1.0"

_CONFIG = ("TrackerShapes", "TrackerParams")
_TRACKER = ("Tracker", "scan_step", "scan_many")
__all__ = list(_CONFIG + _TRACKER)


def __getattr__(name):
    if name in _CONFIG:
        from .core import config
        return getattr(config, name)
    if name in _TRACKER:
        from .core import tracker
        return getattr(tracker, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def __dir__():
    return sorted(__all__ + ["__version__"])
