"""Golden-model pipeline (the accuracy oracle for every hot-path kernel).

Reference behavior (SURVEY.md §4, C11): the CUDA pipeline was validated
against a NumPy float-precision implementation of the same math —
unpack -> per-channel ``A[f] @ V[f]`` -> ``|B|^2`` -> 16x time average.
This module is that oracle for the rebuild: plain einsum math that runs
in float64 on NumPy or complex64 on device, used by the test suite to
hold the fused kernel and the plain form to the <=1e-3
relative-power-error bar (BASELINE.json north star).
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

from dsabeamformer.ops.packing import unpack_wire_to_complex


def beamform_voltages_ref(weights, volt):
    """Per-channel complex GEMM (the cublasCgemmBatched analog, SURVEY.md C6).

    weights: ``[F, B, A]`` complex; volt: ``[F, T, P, A]`` complex.
    Returns ``[F, T, P, B]`` beamformed voltages.
    """
    xp = jnp if isinstance(weights, jnp.ndarray) else np
    return xp.einsum("fba,ftpa->ftpb", weights, volt, optimize=True)


def detect_ref(bvolt):
    """Power detection summing polarizations (SURVEY.md C7):
    ``[F, T, P, B]`` -> ``[F, T, B]`` with ``P = sum_p |B|^2``."""
    p = (bvolt.real * bvolt.real + bvolt.imag * bvolt.imag).sum(axis=2)
    return p


def average_ref(power, navg_time: int, navg_freq: int = 1):
    """Post-detection accumulation over ``navg_time`` samples and
    ``navg_freq`` adjacent channels (sums, not means — matching the
    accumulate semantics of the reference detect kernel).

    power: ``[F, T, B]`` -> ``[F/navg_f, T/navg_t, B]``.
    """
    f, t, b = power.shape
    p = power.reshape(f // navg_freq, navg_freq, t // navg_time, navg_time, b)
    return p.sum(axis=(1, 3))


def stokes_ref(bvolt):
    """Full-Stokes detection (linear feeds, matching
    ``ops.gemm.beamform_stokes``): ``[F, T, P, B]`` -> ``[F, T, 4, B]``
    ordered [I, Q, U, V] with U/V from ``Bx conj(By)``."""
    xp = jnp if isinstance(bvolt, jnp.ndarray) else np
    bx, by = bvolt[:, :, 0], bvolt[:, :, 1]
    px = bx.real**2 + bx.imag**2
    py = by.real**2 + by.imag**2
    c = bx * xp.conj(by)
    return xp.stack([px + py, px - py, 2 * c.real, 2 * c.imag], axis=2)


def beamform_stokes_ref(weights, wire, layout: str, navg_time: int,
                        navg_freq: int = 1):
    """Golden full-Stokes pipeline: wire -> ``[F/navg_f, T/navg_t, 4, B]``."""
    volt = unpack_wire_to_complex(wire, layout)
    st = stokes_ref(beamform_voltages_ref(weights, volt))
    f, t, four, b = st.shape
    p = st.reshape(f // navg_freq, navg_freq, t // navg_time, navg_time,
                   four, b)
    return p.sum(axis=(1, 3))


def beamform_block_ref(weights, wire, layout: str, navg_time: int,
                       navg_freq: int = 1):
    """Full golden pipeline: 4R4I wire block -> averaged beam powers.

    The same math as ``ops.gemm.beamform_power`` (at higher precision):
    unpack -> GEMM -> |.|^2 -> average.
    Output: ``[F/navg_f, T/navg_t, B]``.
    """
    volt = unpack_wire_to_complex(wire, layout)
    bv = beamform_voltages_ref(weights, volt)
    return average_ref(detect_ref(bv), navg_time, navg_freq)
