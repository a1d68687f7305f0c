"""Planar complex representation for the device path.

Rule: no complex dtypes on device.  The int8 tensor cores only
multiply real matrices, so the framework carries complex quantities as
explicit (re, im) float32 pairs end-to-end: weights are a ``CVec``, the
GEMM uses
the K-concatenation identity (ops/quantize.py), and the epilogue squares
the planar parts.  NumPy complex appears only in the host golden model.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import numpy as np


class CVec(NamedTuple):
    """A complex array as (re, im) planar float arrays of equal shape."""

    re: jax.Array
    im: jax.Array

    @property
    def shape(self):
        return self.re.shape

    @staticmethod
    def from_numpy(arr: np.ndarray, dtype=np.float32) -> "CVec":
        arr = np.asarray(arr)
        return CVec(
            re=np.ascontiguousarray(arr.real, dtype=dtype),
            im=np.ascontiguousarray(arr.imag, dtype=dtype),
        )

    def to_numpy(self) -> np.ndarray:
        """Fetch to host as numpy complex (never creates device complex)."""
        return np.asarray(self.re) + 1j * np.asarray(self.im)
