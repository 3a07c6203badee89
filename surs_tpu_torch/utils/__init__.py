"""Utilities: the synthetic humanoid subject, the mesh-fidelity metrics,
EXR files and the profiling helpers."""

from .profiling import Profiler, annotate, timed

__all__ = ["timed", "Profiler", "annotate"]
