"""Native host-side helpers (C++, bound with ctypes).

The deposit runs on the card; these helpers keep the host side of the
pipeline (parsing, batch assembly) off the Python interpreter's critical
path.  The shared library is built with g++ at first use into
``build/molvoxel_torch/`` (``python -m molvoxel_torch.native.build`` to
build it now).  Every entry point has a pure-Python fallback, so the package
works without a compiler; ``NATIVE_AVAILABLE`` says which one runs.
"""

from . import fastparse
from .fastparse import FlatMolecules, parse_sdf_buffer, parse_sdf_file, parse_sdf_flat, wire_assemble_native

__all__ = [
    "NATIVE_AVAILABLE",
    "FlatMolecules",
    "parse_sdf_buffer",
    "parse_sdf_file",
    "parse_sdf_flat",
    "wire_assemble_native",
]


def __getattr__(name):
    if name == "NATIVE_AVAILABLE":  # resolved at first use: importing starts no compiler
        return fastparse.native_available()
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
