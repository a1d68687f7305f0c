"""Synthetic 4R4I voltage-block generators (host-side, NumPy).

Reference behavior (SURVEY.md §4, C11): the CUDA pipeline was tested
with synthetic inputs of known structure — a point source at a known
angle (beam peak analytically checkable) and noise.  These generators
produce wire blocks in either layout for tests, the simulator CLI, and
the streaming benchmarks.

Sign convention matches models/weights.py: a source at angle ``theta``
induces antenna phase ``+2*pi*f*x_a*sin(theta)/c``.
"""

from __future__ import annotations

import numpy as np

from dsabeamformer.config import SPEED_OF_LIGHT_M_S, ObsConfig
from dsabeamformer.models.arrays import ArrayLayout, array_for
from dsabeamformer.ops.packing import pack_4r4i


#: Complex samples per chunk of channels in the point-source generator.
_CHUNK_SAMPLES = 1 << 24


def _emit(cfg: ObsConfig, re: np.ndarray, im: np.ndarray) -> np.ndarray:
    """[F, T, P, A] float re/im -> wire uint8 block in cfg.input_layout."""
    wire = pack_4r4i(np.round(re), np.round(im))
    if cfg.input_layout == "tfpa":
        wire = np.ascontiguousarray(wire.transpose(1, 0, 2, 3))
    return wire


def make_random_bytes_block(cfg: ObsConfig, seed: int = 0) -> np.ndarray:
    """Uniform random 4R4I bytes on active inputs — statistically wrong
    but bit-format-valid, and ~100x faster to generate than Gaussian
    noise.  For throughput benchmarks only (a full-band block is
    ~0.5 GB; Gaussian generation takes minutes per block).  Honors the
    wire contract that zero-padded antenna slots carry zero bytes
    (config.n_ant_compute relies on it)."""
    rng = np.random.default_rng(seed)
    blk = rng.integers(0, 256, size=cfg.wire_block_shape, dtype=np.uint8)
    blk[..., cfg.n_ant_active:] = 0
    return blk


def make_noise_block(cfg: ObsConfig, rms: float = 2.0, seed: int = 0) -> np.ndarray:
    """Gaussian noise on active antennas, zeros on padding."""
    rng = np.random.default_rng(seed)
    shape = (cfg.n_chan, cfg.t_block, cfg.n_pol, cfg.n_ant)
    # float32 normals: the wire is 4-bit after rounding, so f32 draws
    # are statistically identical and ~3x faster at full-band scale
    # (f64 measured ~5.3 min per 2 GiB dsa10 block — too slow to feed
    # the streamed hardware run's producer).
    re = np.zeros(shape, np.float32)
    im = np.zeros(shape, np.float32)
    a = cfg.n_ant_active
    sub = shape[:-1] + (a,)
    re[..., :a] = rng.standard_normal(sub, dtype=np.float32)
    im[..., :a] = rng.standard_normal(sub, dtype=np.float32)
    if rms != 1.0:
        re *= np.float32(rms)
        im *= np.float32(rms)
    return _emit(cfg, re, im)


def make_point_source_block(
    cfg: ObsConfig,
    angle_rad: float,
    layout: ArrayLayout | None = None,
    amplitude: float = 5.0,
    noise_rms: float = 0.5,
    seed: int = 0,
    instrumental_gains: np.ndarray | None = None,
) -> np.ndarray:
    """A single point source at ``angle_rad`` plus receiver noise.

    The per-channel source signal is complex Gaussian (bandwidth-limited
    noise-like emission, the realistic case), identical across antennas
    up to the geometric phase, and identical across pols up to an
    independent realization.

    ``instrumental_gains`` (``[n_ant, n_chan]`` complex, e.g.
    ``CalTable.random(cfg).gains``) corrupts each antenna's SIGNAL path
    with a per-channel complex gain — a calibrator observation through
    an uncalibrated instrument, the input ``models.calsolver`` solves
    from.  (Receiver noise is added after the gain, as in hardware.)
    """
    rng = np.random.default_rng(seed)
    layout = layout if layout is not None else array_for(cfg)
    a = cfg.n_ant_active
    x = layout.positions_m[None, None, :a]                   # [1,1,a]
    g = (None if instrumental_gains is None
         else np.asarray(instrumental_gains)[:a].T)          # [F,a]
    freqs = cfg.freqs_hz()
    wire = np.zeros((cfg.n_chan, cfg.t_block, cfg.n_pol, cfg.n_ant),
                    np.uint8)
    # Channel chunks bound the float64 working set (a full-band block
    # would otherwise hold tens of GB); the draws run chunk by chunk,
    # so a block that fits one chunk is drawn as it always was.
    step = max(1, _CHUNK_SAMPLES // (cfg.t_block * cfg.n_pol * a))
    for c0 in range(0, cfg.n_chan, step):
        c1 = min(c0 + step, cfg.n_chan)
        f = freqs[c0:c1, None, None]                         # [C,1,1]
        steer = np.exp(
            2j * np.pi * f * x * np.sin(angle_rad) / SPEED_OF_LIGHT_M_S
        )  # [C,1,a]
        shape = (c1 - c0, cfg.t_block, cfg.n_pol)
        sig = amplitude / np.sqrt(2) * (
            rng.standard_normal(shape) + 1j * rng.standard_normal(shape)
        )  # [C,T,P]
        v = sig[..., None] * steer[:, :, None, :]            # [C,T,P,a]
        if g is not None:
            v = v * g[c0:c1, None, None, :]
        re = v.real + rng.normal(0.0, noise_rms, v.shape)
        im = v.imag + rng.normal(0.0, noise_rms, v.shape)
        wire[c0:c1, ..., :a] = pack_4r4i(np.round(re), np.round(im))
    if cfg.input_layout == "tfpa":
        wire = np.ascontiguousarray(wire.transpose(1, 0, 2, 3))
    return wire


def make_dispersed_pulse_block(
    cfg: ObsConfig,
    dm: float,
    angle_rad: float = 0.0,
    t0_sample: int = 0,
    width_samples: int = 2,
    layout: ArrayLayout | None = None,
    amplitude: float = 6.0,
    noise_rms: float = 0.5,
    seed: int = 0,
    period_samples: int | None = None,
) -> np.ndarray:
    """A broadband pulse dispersed at ``dm`` on top of receiver noise —
    the injected-FRB end-to-end drill (generator -> kernel -> product
    -> ``dsabf waterfall --dm`` recovery).

    Per raw channel the point-source signal (coherent across antennas
    via the geometric phase, like ``make_point_source_block``) is
    windowed to ``width_samples`` starting at the cold-plasma arrival
    time ``t0 + DM_CONST_S * dm * (f_c^-2 - f_top^-2)`` (top of the
    band arrives first), rounded to wire samples.  Channels whose
    arrival falls past ``t_block`` simply carry no pulse.  Note the
    physical scale: at the real presets' ~30 ns sample period,
    astrophysical DMs disperse across many blocks — tests compute a
    ``dm`` that spans a few samples instead.

    ``period_samples`` makes the pulse a PULSAR: an infinite periodic
    train (pulses at ``t_arr + k*period`` for every integer ``k``,
    before and after ``t0``), the known-source drill for `dsabf fold`.
    Phase-coherent multi-block trains come from shifting ``t0_sample``
    by ``-i * t_block`` per block (see `cli.cmd_simulate`).
    """
    from dsabeamformer.config import dm_delays_s

    if period_samples is not None and period_samples <= width_samples:
        raise ValueError(f"period_samples {period_samples} must exceed "
                         f"width_samples {width_samples}")
    rng = np.random.default_rng(seed)
    layout = layout if layout is not None else array_for(cfg)
    f = cfg.freqs_hz()[:, None, None]                       # [F,1,1]
    x = layout.positions_m[None, None, : cfg.n_ant_active]  # [1,1,a]
    steer = np.exp(
        2j * np.pi * f * x * np.sin(angle_rad) / SPEED_OF_LIGHT_M_S
    )  # [F,1,a]
    f_mhz = cfg.freqs_hz() / 1e6
    delays = dm_delays_s(f_mhz, dm, f_mhz.max())
    t_arr = t0_sample + np.rint(delays / cfg.sample_period_s).astype(int)
    t = np.arange(cfg.t_block)[None, :]                     # [1,T]
    if period_samples is not None:
        # Python's % is non-negative, so the train extends to t < t0
        window = ((t - t_arr[:, None]) % period_samples) < width_samples
    else:
        window = ((t >= t_arr[:, None])
                  & (t < t_arr[:, None] + width_samples))   # [F,T]
    sig = amplitude / np.sqrt(2) * (
        rng.standard_normal((cfg.n_chan, cfg.t_block, cfg.n_pol))
        + 1j * rng.standard_normal((cfg.n_chan, cfg.t_block, cfg.n_pol))
    ) * window[:, :, None]                                  # [F,T,P]
    v = sig[..., None] * steer[:, :, None, :]               # [F,T,P,a]
    shape = (cfg.n_chan, cfg.t_block, cfg.n_pol, cfg.n_ant)
    re = np.zeros(shape, np.float64)
    im = np.zeros(shape, np.float64)
    a = cfg.n_ant_active
    re[..., :a] = v.real + rng.normal(0.0, noise_rms, v.shape)
    im[..., :a] = v.imag + rng.normal(0.0, noise_rms, v.shape)
    return _emit(cfg, re, im)


def make_tone_block(
    cfg: ObsConfig,
    chan: int,
    amplitude: float = 7.0,
    phase_step: float = 0.1,
) -> np.ndarray:
    """Deterministic complex tone in one channel on all active antennas
    (bit-exact regression inputs — no randomness)."""
    shape = (cfg.n_chan, cfg.t_block, cfg.n_pol, cfg.n_ant)
    re = np.zeros(shape, np.float64)
    im = np.zeros(shape, np.float64)
    t = np.arange(cfg.t_block)[:, None, None]
    ph = phase_step * t
    a = cfg.n_ant_active
    re[chan, ..., :a] = amplitude * np.cos(ph)
    im[chan, ..., :a] = amplitude * np.sin(ph)
    return _emit(cfg, re, im)
