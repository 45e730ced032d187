"""Utilities: device timing, the profiler trace and the build directory (utils/timing.py)."""

from .timing import enable_compilation_cache, measure_device_fn, trace

__all__ = ["enable_compilation_cache", "measure_device_fn", "trace"]
