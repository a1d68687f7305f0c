"""Steering / fringe / calibration weight generation — jitted, device-side.

Reference behavior (SURVEY.md L6/C8, call stack §3.3): on a pointing or
calibration change the host recomputes

    A[f, b, a] = g_a(f) * exp(-2*pi*i * f * tau(b, a))      (tau = geometric delay)

in C++ loops and re-uploads ~tens of MB to the GPU.  BASELINE.json's
north star requires the rebuild to run this *device-side and jitted*;
here it is a pure jnp function of (positions, gains, pointing, fringe
delay) that XLA fuses into a handful of elementwise kernels — no host
loop, no host->device weight copy beyond the inputs.

Device arrays are planar complex (``CVec`` re/im float32 pairs — see
ops/cplx.py: no complex dtypes on device).

Sign conventions (the single source of truth, matched by
``ingest/generator.py``):

- A plane wave from angle ``theta`` (east of boresight) reaches antenna
  ``x_a`` with phase ``+2*pi*f*x_a*sin(theta)/c`` relative to the array
  center (larger x => phase lead).
- The steering weight for beam ``theta_b`` conjugates that:
  ``exp(-2*pi*i*f*x_a*sin(theta_b)/c)``, so the beamformed sum is
  coherent when ``theta == theta_b``.
- Beams are offsets *relative to the pointing direction*; fringe
  stopping for the pointing center is the ``theta_point`` term plus an
  optional scalar delay ``fringe_delay_s`` applied per channel.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from dsabeamformer.config import SPEED_OF_LIGHT_M_S, ObsConfig
from dsabeamformer.models.arrays import ArrayLayout, array_for
from dsabeamformer.models.calibration import CalTable
from dsabeamformer.ops.cplx import CVec


def _phase_dtype():
    # float64 where x64 is on (CPU tests: oracle precision); float32
    # otherwise.  f32 is sufficient for DSA-scale baselines: the
    # phase is reduced to its fractional turn while still <= ~100 turns,
    # so the f32 ulp is ~1e-5 turn.
    return jnp.float64 if jax.config.jax_enable_x64 else jnp.float32


@jax.jit
def steering_weights(
    positions_m: jax.Array,      # [A]
    beam_angles_rad: jax.Array,  # [B] absolute angles incl. pointing
    freqs_hz: jax.Array,         # [F]
    gains: CVec,                 # [A, F] planar complex calibration gains
    fringe_delay_s: jax.Array | float = 0.0,
) -> CVec:
    """Return planar-complex weights ``A[f, b, a]`` as ``CVec`` float32."""
    dt = _phase_dtype()
    f = freqs_hz.astype(dt)[:, None, None]                    # [F,1,1]
    s = jnp.sin(beam_angles_rad.astype(dt))[None, :, None]    # [1,B,1]
    x = positions_m.astype(dt)[None, None, :]                 # [1,1,A]
    tau = x * s / SPEED_OF_LIGHT_M_S + jnp.asarray(fringe_delay_s, dt)
    turns = f * tau
    # Keep only the fractional turn before any float32 narrowing.
    phase = (-2.0 * jnp.pi) * (turns - jnp.round(turns))
    c = jnp.cos(phase).astype(jnp.float32)
    si = jnp.sin(phase).astype(jnp.float32)
    gr = gains.re.astype(jnp.float32).T[:, None, :]           # [F,1,A]
    gi = gains.im.astype(jnp.float32).T[:, None, :]
    # (c + i*si) * (gr + i*gi)
    return CVec(re=c * gr - si * gi, im=si * gr + c * gi)


def make_weights(
    cfg: ObsConfig,
    layout: ArrayLayout | None = None,
    cal: CalTable | None = None,
    pointing_rad: float = 0.0,
    fringe_delay_s: float = 0.0,
) -> CVec:
    """Convenience wrapper: weights for a config preset -> ``CVec`` with
    re/im float32 ``[F, B, A]`` on the default device."""
    layout = layout if layout is not None else array_for(cfg)
    cal = cal if cal is not None else CalTable.unity(cfg)
    if layout.n_ant < cfg.n_ant:
        # Surveyed tables list only physical dishes; pad to the GEMM dim.
        layout = layout.padded(cfg.n_ant)
    if layout.n_ant != cfg.n_ant:
        raise ValueError(
            f"layout has {layout.n_ant} antennas, config {cfg.name!r} "
            f"expects {cfg.n_ant}"
        )
    if layout.n_active != cfg.n_ant_active:
        raise ValueError(
            f"layout has {layout.n_active} active antennas, config "
            f"{cfg.name!r} expects {cfg.n_ant_active} (override with "
            f"--set n_ant_active={layout.n_active} if the table is right)"
        )
    if cal.gains.shape != (cfg.n_ant, cfg.n_chan):
        raise ValueError(
            f"calibration table shaped {cal.gains.shape} != "
            f"[n_ant, n_chan] = {(cfg.n_ant, cfg.n_chan)}"
        )
    angles = pointing_rad + cfg.beam_angles_rad()
    return steering_weights(
        jnp.asarray(layout.positions_m),
        jnp.asarray(angles),
        jnp.asarray(cfg.freqs_hz()),
        CVec(re=jnp.asarray(cal.gains.real.astype(np.float32)),
             im=jnp.asarray(cal.gains.imag.astype(np.float32))),
        fringe_delay_s,
    )


@jax.jit
def steering_weights_lm(
    positions_ew_m: jax.Array,   # [A]
    positions_ns_m: jax.Array,   # [A]
    beam_l: jax.Array,           # [B] direction cosine (east)
    beam_m: jax.Array,           # [B] direction cosine (north)
    freqs_hz: jax.Array,         # [F]
    gains: CVec,                 # [A, F]
) -> CVec:
    """2-D generalization: weights for a beam grid given in direction
    cosines (l, m) over a 2-D station layout.

    ``steering_weights`` (the reference-parity 1-D fan) is the special
    case ``l = sin(theta_b), m = 0, positions_ns = 0``.  Returns planar
    weights ``[F, B, A]``.
    """
    dt = _phase_dtype()
    f = freqs_hz.astype(dt)[:, None, None]
    le = beam_l.astype(dt)[None, :, None]
    mn = beam_m.astype(dt)[None, :, None]
    xe = positions_ew_m.astype(dt)[None, None, :]
    xn = positions_ns_m.astype(dt)[None, None, :]
    tau = (xe * le + xn * mn) / SPEED_OF_LIGHT_M_S
    turns = f * tau
    phase = (-2.0 * jnp.pi) * (turns - jnp.round(turns))
    c = jnp.cos(phase).astype(jnp.float32)
    si = jnp.sin(phase).astype(jnp.float32)
    gr = gains.re.astype(jnp.float32).T[:, None, :]
    gi = gains.im.astype(jnp.float32).T[:, None, :]
    return CVec(re=c * gr - si * gi, im=si * gr + c * gi)


def make_weights_lm(
    cfg: ObsConfig,
    beam_l: np.ndarray,
    beam_m: np.ndarray,
    layout: ArrayLayout | None = None,
    cal: CalTable | None = None,
) -> CVec:
    """Weights for an arbitrary (l, m) beam grid (2-D arrays).

    ``len(beam_l) == cfg.n_beams`` — the kernel is agnostic to how the
    beam axis was laid out."""
    layout = layout if layout is not None else array_for(cfg)
    cal = cal if cal is not None else CalTable.unity(cfg)
    if len(beam_l) != cfg.n_beams or len(beam_m) != cfg.n_beams:
        raise ValueError(
            f"beam grid has {len(beam_l)} beams, config expects {cfg.n_beams}"
        )
    return steering_weights_lm(
        jnp.asarray(layout.positions_m),
        jnp.asarray(layout.ns),
        jnp.asarray(beam_l),
        jnp.asarray(beam_m),
        jnp.asarray(cfg.freqs_hz()),
        CVec(re=jnp.asarray(cal.gains.real.astype(np.float32)),
             im=jnp.asarray(cal.gains.imag.astype(np.float32))),
    )


def weights_lm_numpy_golden(
    cfg: ObsConfig,
    beam_l: np.ndarray,
    beam_m: np.ndarray,
    layout: ArrayLayout | None = None,
    cal: CalTable | None = None,
) -> np.ndarray:
    layout = layout if layout is not None else array_for(cfg)
    cal = cal if cal is not None else CalTable.unity(cfg)
    f = cfg.freqs_hz()[:, None, None]
    tau = (
        layout.positions_m[None, None, :] * np.asarray(beam_l)[None, :, None]
        + layout.ns[None, None, :] * np.asarray(beam_m)[None, :, None]
    ) / SPEED_OF_LIGHT_M_S
    w = np.exp(-2j * np.pi * f * tau)
    return w * cal.gains.astype(np.complex128).T[:, None, :]


def weights_numpy_golden(
    cfg: ObsConfig,
    layout: ArrayLayout | None = None,
    cal: CalTable | None = None,
    pointing_rad: float = 0.0,
    fringe_delay_s: float = 0.0,
) -> np.ndarray:
    """complex128 NumPy oracle for ``make_weights`` (SURVEY.md §4:
    golden-model testing philosophy — every stage has a float64 host
    oracle)."""
    layout = layout if layout is not None else array_for(cfg)
    cal = cal if cal is not None else CalTable.unity(cfg)
    f = cfg.freqs_hz()[:, None, None]
    s = np.sin(pointing_rad + cfg.beam_angles_rad())[None, :, None]
    x = layout.positions_m[None, None, :]
    tau = x * s / SPEED_OF_LIGHT_M_S + fringe_delay_s
    w = np.exp(-2j * np.pi * f * tau)
    return w * cal.gains.astype(np.complex128).T[:, None, :]


def parse_zap(spec: str) -> list:
    """Parse an RFI channel-zap spec — comma-separated raw channel
    indices and inclusive ranges, e.g. ``"12,100-110,500"`` — into a
    sorted duplicate-free index list."""
    chans: set = set()
    for tok in spec.split(","):
        tok = tok.strip()
        if not tok:
            continue
        if "-" in tok:
            lo, hi = tok.split("-", 1)
            lo, hi = int(lo), int(hi)
            if hi < lo:
                raise ValueError(f"bad zap range {tok!r}")
            chans.update(range(lo, hi + 1))
        else:
            chans.add(int(tok))
    return sorted(chans)


def zap_weights(w: CVec, channels, cfg: ObsConfig) -> CVec:
    """Zero the weight rows of RFI channels (standard excision:
    the CUDA world edits cal files by hand; here it is a flag).

    Zapped channels' beam voltages — and therefore every coherent
    product (power, Stokes) — are EXACTLY zero: zero weights quantize
    to zero integers in every mode (the per-channel scale floor keeps
    the divide finite).  With ``navg_freq > 1``, a zapped raw channel
    contributes nothing to its averaged output group (partial-group
    zaps keep the other channels' signal).  The data-side incoherent
    product is not affected by weights; the CLI masks it at averaged
    resolution (`--zap` + `--incoherent-file`).
    """
    idx = np.asarray(parse_zap(channels) if isinstance(channels, str)
                     else sorted(set(int(c) for c in channels)))
    if idx.size == 0:
        return w
    if idx.min() < 0 or idx.max() >= cfg.n_chan:
        raise ValueError(
            f"zap channels {idx[(idx < 0) | (idx >= cfg.n_chan)].tolist()} "
            f"out of range [0, {cfg.n_chan})")
    return CVec(re=w.re.at[idx].set(0.0), im=w.im.at[idx].set(0.0))


def flag_antennas(w: CVec, ants, cfg: ObsConfig) -> CVec:
    """Zero the weight columns of bad antennas (operator excision —
    the CUDA deployment's analog is hand-editing the cal file to zero
    a dish's gains; here it is a flag).

    Flagged antennas contribute exactly nothing to every coherent
    product in every quantization mode (zero weights quantize to zero
    integers).  No renormalization is applied: the coherent gain drops
    by the flagged fraction, matching what a zeroed cal gain would do —
    downstream S/N estimates should use the surviving-antenna count.
    The data-side incoherent product is masked separately
    (``flag_ants=`` on ``beamform_power``/``incoherent_power``).

    Accepts a spec string (``"3,17-19"``) or an index iterable; indices
    are raw antenna slots and must be ``< n_ant_active`` (the padded
    slots beyond carry zero weights already).
    """
    idx = np.asarray(parse_zap(ants) if isinstance(ants, str)
                     else sorted(set(int(a) for a in ants)))
    if idx.size == 0:
        return w
    if idx.min() < 0 or idx.max() >= cfg.n_ant_active:
        raise ValueError(
            f"flagged antennas "
            f"{idx[(idx < 0) | (idx >= cfg.n_ant_active)].tolist()} out of "
            f"range [0, n_ant_active={cfg.n_ant_active})")
    return CVec(re=w.re.at[..., idx].set(0.0), im=w.im.at[..., idx].set(0.0))


def zap_mask_avg(channels, cfg: ObsConfig) -> np.ndarray:
    """``[n_chan/navg_freq]`` float32 mask for the incoherent product:
    0 for averaged groups containing ANY zapped raw channel, else 1
    (conservative excision — the incoherent sum is computed from the
    data, so a partially-contaminated group stays contaminated)."""
    idx = parse_zap(channels) if isinstance(channels, str) else channels
    mask = np.ones(cfg.n_chan, np.float32)
    mask[np.asarray(sorted(set(int(c) for c in idx)), dtype=int)] = 0.0
    return mask.reshape(-1, cfg.navg_freq).min(axis=1)
