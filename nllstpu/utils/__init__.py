"""Utility subpackage: native bindings, checkpointing, profiling, the
compilation-cache placement."""

from . import checkpoint, compile_cache, native, profiling  # noqa: F401
