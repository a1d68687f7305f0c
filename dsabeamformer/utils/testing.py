"""Tolerance harness: the <=1e-3 relative-power-error gate.

BASELINE.json north star: "Outputs must match the reference beamformer
to <=1e-3 relative power error."  This module defines that metric once
so every test and benchmark gates on the same number (SURVEY.md §4:
golden-model comparison is the primary test strategy).
"""

from __future__ import annotations

import numpy as np

#: The BASELINE.json accuracy bar.
POWER_RTOL = 1e-3


def relative_power_error(p, p_ref) -> float:
    """Max relative power error with a floor tied to the block's peak
    power, so near-zero bins don't blow up the ratio (power is
    non-negative; errors on empty beams are measured against the
    block scale, matching how the reference compared outputs)."""
    p = np.asarray(p, dtype=np.float64)
    p_ref = np.asarray(p_ref, dtype=np.float64)
    if p.shape != p_ref.shape:
        raise ValueError(f"shape mismatch: {p.shape} vs {p_ref.shape}")
    scale = np.max(np.abs(p_ref))
    if scale == 0.0:
        return float(np.max(np.abs(p)))
    denom = np.maximum(np.abs(p_ref), 1e-3 * scale)
    return float(np.max(np.abs(p - p_ref) / denom))


def assert_power_close(p, p_ref, rtol: float = POWER_RTOL, what: str = ""):
    err = relative_power_error(p, p_ref)
    assert err <= rtol, (
        f"relative power error {err:.3e} > {rtol:.1e}" + (f" ({what})" if what else "")
    )
    return err


def sampled_channels(n_chan: int, k: int = 32) -> np.ndarray:
    """``k`` channel indices spread evenly over the band, first and
    last included — where a full-band float64 golden would take too
    long, the golden is computed on these."""
    return np.unique(np.linspace(0, n_chan - 1, min(k, n_chan)).round()
                     .astype(np.int64))


def golden_power_sampled(cfg, wire, chans, cal=None):
    """Float64 golden powers ``[len(chans), T/navg_time, B]`` of the
    4-D host wire block ``wire`` on raw channels ``chans``
    (``navg_freq`` must be 1: averaged groups would need whole
    groups)."""
    from dsabeamformer.models.weights import weights_numpy_golden
    from dsabeamformer.ops.reference import beamform_block_ref

    if cfg.navg_freq != 1:
        raise ValueError("golden_power_sampled needs navg_freq=1")
    chans = np.asarray(chans)
    w = weights_numpy_golden(cfg, cal=cal)[chans]
    wire = np.asarray(wire).reshape(cfg.wire_block_shape)
    sub = wire[:, chans] if cfg.input_layout == "tfpa" else wire[chans]
    return beamform_block_ref(w, sub, cfg.input_layout, cfg.navg_time)
