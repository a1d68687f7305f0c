"""Incoherent-sum detection: the zero-gain "beam 0" total-power product.

A standard FRB-backend companion to the coherent beams (no direct
reference counterpart — the reference emits only the 256 coherent
beams, SURVEY.md §0 step 6): per channel and time sample, sum
``|v|^2`` over the active antennas and both polarizations, then apply
the same 16x time averaging as the coherent path.  Useful as a
sensitivity-flat detector across the whole primary beam, an RFI
monitor, and a normalization reference for the coherent powers.

Memory-bound, not tensor-core work (one pass over the wire bytes, tiny
output), so it is a plain jitted jnp function — XLA fuses the nibble
unpack, square, and reductions into one pass; no Pallas needed.
Accepts the same wire forms as ``beamform_power`` (canonical
``cfg.device_wire_shape`` or the 4-D host form).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from dsabeamformer.config import ObsConfig
from dsabeamformer.ops.packing import unpack_4r4i


def _unpack_active_power(wire, cfg: ObsConfig):
    """Shared preamble for the wire-block diagnostics: validate the
    wire form (canonical device shape or 4-D host block), reshape to
    the layout's [.., P, A] axes, slice the active antennas, unpack
    4R4I, and square — returns ``(p int32 [T,F,P,A'] or [F,T,P,A'],
    chan_axis)``.  One reader, kept in sync for every consumer."""
    if wire.dtype != jnp.uint8:
        raise ValueError(f"wire must be uint8 4R4I bytes, got {wire.dtype}")
    if wire.shape == cfg.device_wire_shape or wire.shape == cfg.wire_block_shape:
        if cfg.input_layout == "tfpa":
            x = wire.reshape(cfg.t_block, cfg.n_chan, cfg.n_pol, cfg.n_ant)
            chan_axis = 1
        else:
            x = wire.reshape(cfg.n_chan, cfg.t_block, cfg.n_pol, cfg.n_ant)
            chan_axis = 0
    else:
        raise ValueError(
            f"wire shape {wire.shape} is neither {cfg.device_wire_shape} "
            f"nor {cfg.wire_block_shape} for layout {cfg.input_layout!r}"
        )
    x = x[..., : cfg.n_ant_active]
    re, im = unpack_4r4i(x)
    re = re.astype(jnp.int32)
    im = im.astype(jnp.int32)
    return re * re + im * im, chan_axis


@functools.partial(jax.jit, static_argnames=("cfg", "flag_ants"))
def incoherent_power(wire: jax.Array, cfg: ObsConfig,
                     flag_ants: tuple = ()) -> jax.Array:
    """4R4I wire block -> incoherent total power
    ``[F/navg_freq, T/navg_time]``.

    ``sum_{a<n_ant_active, p} (re^2 + im^2)`` per (channel, sample),
    summed over ``navg_time`` consecutive samples and ``navg_freq``
    adjacent channels — the incoherent analog of ``beamform_power``'s
    detection epilogue, channel axis matching ``out_block_shape``
    (power in raw 4-bit units^2; no weights, no calibration).
    ``flag_ants`` (static) excludes bad antennas from the sum — the
    data-side analog of ``models.weights.flag_antennas``.
    """
    p, _ = _unpack_active_power(wire, cfg)
    if flag_ants:
        if min(flag_ants) < 0 or max(flag_ants) >= cfg.n_ant_active:
            raise ValueError(
                f"flag_ants {sorted(flag_ants)} out of range "
                f"[0, n_ant_active={cfg.n_ant_active})")
        import numpy as _np
        keep = _np.ones(cfg.n_ant_active, _np.int32)
        keep[list(flag_ants)] = 0
        p = p * jnp.asarray(keep)
    p = p.sum(axis=(2, 3))  # over (pol, antenna)
    if cfg.input_layout == "tfpa":
        p = p.T  # [T, F] -> [F, T]
    f, t = p.shape
    p = p.reshape(f, t // cfg.navg_time, cfg.navg_time).sum(axis=2)
    p = p.astype(jnp.float32)
    if cfg.navg_freq > 1:
        # Match the coherent product's channel axis (out_block_shape).
        p = p.reshape(f // cfg.navg_freq, cfg.navg_freq, -1).sum(axis=1)
    return p


@functools.partial(jax.jit, static_argnames=("cfg",))
def wire_level_stats(wire: jax.Array, cfg: ObsConfig) -> dict:
    """Per-antenna drive-level diagnostics from one wire block.

    Returns ``{"rms": [A], "clip_fraction": [A]}`` over the active
    antennas (both pols, all channels/samples): the 4-bit wire
    saturates at -8/+7, so operators level-set to keep rms ~2 and the
    clip fraction low before science or calibration scans (clipping
    compresses cal amplitude solutions — models/calsolver.py).

    ``clip_fraction`` is the **at-rail fraction** — the share of
    components sitting exactly on the -8/+7 rails — not a count of
    true saturation events (unobservable post-quantization; rail
    occupancy is the standard proxy).  A healthy Gaussian drive at
    rms~2 legitimately parks ~0.1-0.5% of samples on the rails, so
    compare against that expected rail fraction, not against zero;
    a few percent or more means the ADC drive is hot.
    """
    if wire.dtype != jnp.uint8:
        raise ValueError(f"wire must be uint8 4R4I bytes, got {wire.dtype}")
    if cfg.input_layout == "tfpa":
        x = wire.reshape(cfg.t_block, cfg.n_chan, cfg.n_pol, cfg.n_ant)
    else:
        x = wire.reshape(cfg.n_chan, cfg.t_block, cfg.n_pol, cfg.n_ant)
    x = x[..., : cfg.n_ant_active]
    re, im = unpack_4r4i(x)
    re = re.astype(jnp.int32)
    im = im.astype(jnp.int32)
    n = 2 * x.shape[0] * x.shape[1] * x.shape[2]  # components per antenna
    # Accumulate in f32, NOT int32: a railed DSA-10-scale antenna sums
    # up to 33.5M samples x 128 = 4.3e9, past int32, and would report
    # NaN rms for exactly the broken antenna this tool exists to flag.
    ssq = (re * re + im * im).astype(jnp.float32).sum(axis=(0, 1, 2))
    clipped = (
        (re <= -8) | (re >= 7) | (im <= -8) | (im >= 7)
    ).astype(jnp.float32).sum(axis=(0, 1, 2))
    return {
        "rms": jnp.sqrt(ssq / n),
        "clip_fraction": clipped
        / (x.shape[0] * x.shape[1] * x.shape[2]),
    }


def incoherent_power_golden(wire, cfg: ObsConfig, flag_ants=()):
    """NumPy float64 oracle for ``incoherent_power``."""
    import numpy as np

    from dsabeamformer.ops.packing import unpack_wire_to_complex

    v = unpack_wire_to_complex(np.asarray(wire).reshape(cfg.wire_block_shape),
                               cfg.input_layout)  # [F, T, P, A] complex
    p = np.abs(v[..., : cfg.n_ant_active]) ** 2
    if flag_ants:
        p[..., sorted(flag_ants)] = 0.0
    p = p.sum(axis=(2, 3))
    f, t = p.shape
    p = p.reshape(f, t // cfg.navg_time, cfg.navg_time).sum(axis=2)
    if cfg.navg_freq > 1:
        p = p.reshape(f // cfg.navg_freq, cfg.navg_freq, -1).sum(axis=1)
    return p


@functools.partial(jax.jit, static_argnames=("cfg", "axis"))
def sk_block_stats(wire: jax.Array, cfg: ObsConfig,
                   axis: str = "chan") -> dict:
    """Spectral-kurtosis accumulators from one wire block, resolved
    along ``axis``.

    Returns ``{"s1": [n_chan], "s2": [n_chan]}`` (``axis="chan"``),
    ``{"s1": [n_ant_active], "s2": [...]}`` (``axis="ant"``), or both
    in one pass (``axis="both"``: channel keys plus ``ant_s1``/
    ``ant_s2``) — the sum
    and sum-of-squares of the per-sample powers ``p = re^2 + im^2``
    over every other axis, float32.  Callers accumulate these across
    blocks (in float64 on the host) and form the SK estimator with
    :func:`sk_estimate`; splitting the reduction this way keeps the
    device pass a single cheap memory-bound sweep (like
    ``incoherent_power`` — XLA fuses unpack, square, and both
    reductions into one read of the wire bytes).

    Per-sample powers (rather than per-timestep incoherent sums) make
    the estimator sensitive to both RFI morphologies: a CW carrier
    concentrates ``p`` near a constant (SK << 1), impulsive/bursty
    interference spreads it (SK >> 1); Gaussian noise gives SK ~= 1.
    ``axis="ant"`` localizes broadband/self-generated RFI to the
    offending antenna (the ``--flag-ants`` analog of the per-channel
    ``--zap`` scan).
    """
    if axis not in ("chan", "ant", "both"):
        raise ValueError(f"axis must be chan|ant|both, got {axis!r}")
    p, chan_axis = _unpack_active_power(wire, cfg)
    p = p.astype(jnp.float32)
    p2 = p * p
    out = {}
    if axis in ("chan", "both"):
        axes = tuple(a for a in range(4) if a != chan_axis)
        out["s1"] = p.sum(axis=axes)
        out["s2"] = p2.sum(axis=axes)
    if axis in ("ant", "both"):
        axes = tuple(a for a in range(4) if a != 3)  # antenna: minor
        key = ("ant_s1", "ant_s2") if axis == "both" else ("s1", "s2")
        out[key[0]] = p.sum(axis=axes)
        out[key[1]] = p2.sum(axis=axes)
    return out


def sk_samples_per_block(cfg: ObsConfig, axis: str = "chan") -> int:
    """M contributed to each SK accumulator bin per block."""
    if axis == "ant":
        return cfg.t_block * cfg.n_pol * cfg.n_chan
    return cfg.t_block * cfg.n_pol * cfg.n_ant_active


def sk_estimate(s1, s2, m: int):
    """Generalized spectral-kurtosis estimator from accumulated sums.

    ``SK = (M+1)/(M-1) * (M*S2/S1^2 - 1)`` — expectation 1 for
    Gaussian (chi^2_2 power) noise, variance ~ 4/M.  4-bit
    quantization biases the expectation slightly away from 1, the
    SAME way in every channel — which is why :func:`sk_flags` uses a
    robust cross-channel null (median/MAD) rather than the theoretical
    1 +- k*2/sqrt(M) window.  Dead channels (S1 == 0) return NaN.
    """
    import numpy as np

    s1 = np.asarray(s1, np.float64)
    s2 = np.asarray(s2, np.float64)
    with np.errstate(divide="ignore", invalid="ignore"):
        return (m + 1.0) / (m - 1.0) * (m * s2 / (s1 * s1) - 1.0)


def sk_flags(sk, m: int, threshold: float = 5.0):
    """Robust outlier channels from an SK vector.

    The null is the cross-channel median; scale is the larger of the
    MAD-derived sigma and the theoretical ``2/sqrt(M)`` (so a
    perfectly clean band, whose MAD -> 0, does not flag everything).
    Returns ``(flagged_indices, median, sigma)``; NaN channels (dead:
    zero power) are always flagged.
    """
    import numpy as np

    sk = np.asarray(sk, np.float64)
    good = np.isfinite(sk)
    if not good.any():
        return list(range(sk.size)), float("nan"), float("nan")
    med = float(np.median(sk[good]))
    mad_sigma = 1.4826 * float(np.median(np.abs(sk[good] - med)))
    sigma = max(mad_sigma, 2.0 / np.sqrt(m))
    bad = ~good | (np.abs(sk - med) > threshold * sigma)
    return [int(i) for i in np.nonzero(bad)[0]], med, sigma


def format_zap_spec(channels) -> str:
    """Inverse of ``models.weights.parse_zap``: a sorted index list ->
    the compact ``"12,100-110"`` spec accepted by ``--zap``."""
    chans = sorted(set(int(c) for c in channels))
    if not chans:
        return ""
    runs = []
    start = prev = chans[0]
    for c in chans[1:]:
        if c == prev + 1:
            prev = c
            continue
        runs.append((start, prev))
        start = prev = c
    runs.append((start, prev))
    return ",".join(f"{a}-{b}" if b > a else f"{a}" for a, b in runs)
