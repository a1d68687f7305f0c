"""Phase-up calibration solver: per-antenna complex gains from a
calibrator observation.

Closes the calibration loop the reference left to external offline
scripts (SURVEY.md C8: the CUDA pipeline *consumes* a cal table; the
DSA operations flow derives it by observing a bright point source of
known position).  Given one wire block of a calibrator at a known
angle:

1. unpack and remove the known geometric phase, leaving
   ``u_a(f, t) = g_a(f) * s(t) + noise`` per antenna,
2. cross-correlate each antenna against a reference antenna over the
   block's time samples and both pols:
   ``r_a = <u_a conj(u_ref)> = g_a conj(g_ref) |s|^2``,
3. the solution to APPLY (``CalTable`` convention: already inverted) is
   ``1 / (r_a / sqrt(<|u_ref|^2>))`` normalized to unit median
   amplitude and zero phase on the reference antenna.

Amplitude accuracy depends on calibrator SNR per (antenna, channel):
with B-limited noise emission the estimator variance falls as
``1/sqrt(T_block)``; phases converge much faster (they are what
coherence needs).  Solving from N blocks = averaging N single-block
``r_a`` sums — pass accumulated blocks via ``solve_gains_blocks``.
"""

from __future__ import annotations

import numpy as np

from dsabeamformer.config import SPEED_OF_LIGHT_M_S, ObsConfig
from dsabeamformer.models.arrays import ArrayLayout, array_for
from dsabeamformer.models.calibration import CalTable
from dsabeamformer.ops.packing import unpack_4r4i


def _accumulate_block(wire, cfg: ObsConfig, angle_rad: float,
                      layout: ArrayLayout, ref_ant: int,
                      t_chunk: int = 512):
    """One block's cross/auto sums: (r [F, a], auto [F]).

    Processes ``t_chunk`` time samples at a time: the complex128
    expansion is 16x the wire bytes (a whole DSA-10 preset block would
    be ~34 GB), but the estimator is a plain sum over time, so chunking
    bounds peak memory at ~t_chunk/t_block of that.
    """
    wire = np.asarray(wire).reshape(cfg.wire_block_shape)
    act = cfg.n_ant_active
    f = cfg.freqs_hz()[:, None]
    x = layout.positions_m[None, :act]
    steer = np.exp(
        2j * np.pi * f * x * np.sin(angle_rad) / SPEED_OF_LIGHT_M_S
    )  # [F, a]
    r = np.zeros((cfg.n_chan, act), np.complex128)
    auto = np.zeros(cfg.n_chan, np.float64)
    for t0 in range(0, cfg.t_block, t_chunk):
        sl = slice(t0, min(t0 + t_chunk, cfg.t_block))
        chunk = (wire[:, sl] if cfg.input_layout == "ftpa"
                 else wire[sl].transpose(1, 0, 2, 3))  # [F, Tc, P, A]
        cre, cim = unpack_4r4i(np.ascontiguousarray(chunk[..., :act]))
        v = cre.astype(np.complex128)
        v += 1j * cim.astype(np.float64)
        u = v * np.conj(steer)[:, None, None, :]      # geometry removed
        uref = u[..., ref_ant]
        r += np.einsum("ftpa,ftp->fa", u, np.conj(uref))
        auto += (np.abs(uref) ** 2).sum(axis=(1, 2))
    return r, auto


def solve_gains_blocks(blocks, cfg: ObsConfig, angle_rad: float,
                       layout: ArrayLayout | None = None,
                       ref_ant: int = 0) -> CalTable:
    """Solve per-(antenna, channel) gains from wire ``blocks`` of a
    calibrator at ``angle_rad``; returns the ``CalTable`` to APPLY."""
    layout = layout if layout is not None else array_for(cfg)
    act = cfg.n_ant_active
    if not (0 <= ref_ant < act):
        raise ValueError(f"ref_ant={ref_ant} not an active antenna")
    r_sum = np.zeros((cfg.n_chan, act), np.complex128)
    auto_sum = np.zeros(cfg.n_chan, np.float64)
    n = 0
    for wire in blocks:
        r, auto = _accumulate_block(wire, cfg, angle_rad, layout, ref_ant)
        r_sum += r
        auto_sum += auto
        n += 1
    if n == 0:
        raise ValueError("no blocks given")
    # g_a conj(g_ref) |s|^2 / (|g_ref|^2 |s|^2) = g_a / g_ref, up to the
    # noise bias in the reference auto power (small at calibrator SNR).
    g_rel = r_sum / np.maximum(auto_sum[:, None], 1e-30)  # [F, a]
    # Normalize: unit median amplitude over (active antennas, channels),
    # zero phase on the reference antenna (already true by construction:
    # g_rel[:, ref] is real positive up to noise).
    scale = np.median(np.abs(g_rel))
    g_rel = g_rel / np.maximum(scale, 1e-30)
    gains = np.zeros((cfg.n_ant, cfg.n_chan), np.complex64)
    gains[:act] = (1.0 / g_rel.T).astype(np.complex64)
    return CalTable(gains=gains)


def solve_gains(wire, cfg: ObsConfig, angle_rad: float,
                layout: ArrayLayout | None = None,
                ref_ant: int = 0) -> CalTable:
    """Single-block convenience wrapper for ``solve_gains_blocks``."""
    return solve_gains_blocks([wire], cfg, angle_rad, layout=layout,
                              ref_ant=ref_ant)
