"""Persistent, serializable interpolator models (pydantic).

One class per reference wrapper (`src/interpn/*.py`), with byte-identical
JSON round-trip and device evaluation.
"""

from .multicubic_rectilinear import MulticubicRectilinear
from .multicubic_regular import MulticubicRegular
from .multilinear_rectilinear import MultilinearRectilinear
from .multilinear_regular import MultilinearRegular
from .nearest_rectilinear import NearestRectilinear
from .nearest_regular import NearestRegular
from .serialization import Array, ArrayF32, ArrayF64
from .spline import TensorSplineRectilinear, TensorSplineRegular

__all__ = [
    "Array",
    "ArrayF32",
    "ArrayF64",
    "MulticubicRectilinear",
    "MulticubicRegular",
    "MultilinearRectilinear",
    "MultilinearRegular",
    "NearestRectilinear",
    "NearestRegular",
    "TensorSplineRectilinear",
    "TensorSplineRegular",
]
