"""Multi-DM incoherent dedispersion search over beam products
(``dsabf search``).

The reference deployment stops at writing SIGPROC filterbanks and
hands single-pulse detection to an external GPU pipeline (heimdall)
[SURVEY.md §2 C9/C12: .fil products are "the heimdall input"].  That
leaves the actual science trigger outside the framework.  This module
closes the loop on the device: a brute-force DM-trial bank, robust
per-trial normalization, boxcar matched filters, and top-k candidate
extraction — all jitted, so one device pass turns a dynamic spectrum
into a candidate list.

Shape of the problem: after 16x time averaging a block's dynamic
spectrum is SMALL (``[T, F]`` float32, a few MB), but the
per-(trial, channel) time shifts are data-dependent gathers.  The
production bank (`conv_dedisperse_bank`, method="conv") reformulates
the two-stage subband algorithm without gathers: stage 1's
within-group shift-sums become one-hot GROUPED CONVOLUTIONS (matrix
work), and stage 2's coarse combination becomes contiguous
`dynamic_slice` reads.  It was built for a machine on which gathers
were slow; which bank is fastest on the GPU is not measured yet
(ROADMAP).  The gather kernels remain as the exact reference
("direct") and the gather two-stage ("subband").  Candidate
extraction uses ``lax.top_k`` per (width, trial) so the host fetch
is a few kB regardless of T.

The delay curve is the package-wide :func:`~dsabeamformer.config.
dm_delays_s` (referenced to the TOP of the band, which arrives
first), so the search agrees with the pulse generator and the
quick-look dedisperser by construction.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np

import jax
import jax.numpy as jnp
from jax import lax

from dsabeamformer.config import DM_CONST_S, dm_delays_s

__all__ = [
    "dm_trial_grid",
    "delay_table",
    "dedisperse_bank",
    "dedisperse_bank_batch",
    "subband_plan",
    "subband_dedisperse_bank",
    "subband_dedisperse_bank_batch",
    "conv_dedisperse_bank",
    "conv_dedisperse_bank_batch",
    "Candidate",
    "coincidence_filter",
    "preprocess_spectrogram",
    "search_spectrogram",
    "search_spectrograms",
    "SearchMonitor",
    "write_candidates",
    "read_candidates",
]

#: Boxcar widths (output samples) matched-filtered by default: powers
#: of two up to 32, the usual single-pulse-search ladder.
DEFAULT_WIDTHS = (1, 2, 4, 8, 16, 32)

def _conv_auto_n_sub(delays: np.ndarray, span_target: int = 64,
                     choices: Tuple[int, ...] = (16, 32, 64, 128)) -> int:
    """Channel-group count for the conv-bank method ("conv"): the
    fewest groups whose worst within-group delay span stays under
    ``span_target`` samples (evaluated on the steepest trial — spans
    of every other trial are smaller).

    The trade: stage 2's per-trial slice count scales with groups,
    but stage 1's one-hot kernel is ``[G*J, C, S1]`` where BOTH the
    coarse-trial count J and the kernel width S1 grow with the
    within-group span — at DSA-10 scale, dm_max=1000 with 16 groups
    is a 3.9 GB kernel and 21 T-MAC per 16k chunk (a worker-killing
    multi-minute dispatch), while 128 groups is 136 MB / 0.75 T-MAC.
    The floor of 16 keeps stage 2's slice count low at monitor scale
    (dm_max=100, span 47)."""
    f = delays.shape[1]
    worst = np.asarray(delays[int(np.argmax(delays.max(axis=1)))],
                       np.int64)
    for n in choices:
        if n >= f:
            break
        c = -(-f // n)
        pad = n * c - f
        w = np.concatenate([worst, np.zeros(pad, np.int64)]) if pad \
            else worst
        g = w.reshape(n, c)
        if int((g.max(axis=1) - g.min(axis=1)).max()) <= span_target:
            return n
    return min(choices[-1], f)


def dm_trial_grid(
    f_lo_mhz: float,
    f_hi_mhz: float,
    tsamp_s: float,
    dm_max: float,
    dm_min: float = 0.0,
    tol: float = 1.25,
) -> np.ndarray:
    """Linear DM trial grid with the classic diagonal-DM spacing: the
    step is chosen so adjacent trials differ by ``tol`` output samples
    of differential delay ACROSS THE BAND —

        step = tol * tsamp / (DM_CONST_S * (f_lo^-2 - f_hi^-2))

    i.e. a pulse at the midpoint between two trials smears by at most
    ``tol/2`` samples relative to either, which is the resolution
    floor the sampling itself imposes.  (A fractional-bandwidth-aware
    non-linear grid buys little for the ~20% fractional bands this
    instrument has, and a linear grid keeps trial index <-> DM
    affine, which the candidate clustering uses.)

    Always includes ``dm_min``; the last trial is the first one
    >= ``dm_max`` so the requested range is covered, not truncated.
    """
    if f_hi_mhz <= f_lo_mhz:
        raise ValueError(f"need f_hi > f_lo, got [{f_lo_mhz}, {f_hi_mhz}]")
    if dm_max < dm_min:
        raise ValueError(f"dm_max {dm_max} < dm_min {dm_min}")
    if tol <= 0 or tsamp_s <= 0:
        raise ValueError("tol and tsamp_s must be positive")
    span = DM_CONST_S * (f_lo_mhz ** -2.0 - f_hi_mhz ** -2.0)  # s per DM unit
    step = tol * tsamp_s / span
    n = int(np.ceil((dm_max - dm_min) / step)) + 1 if dm_max > dm_min else 1
    return dm_min + step * np.arange(n)


def delay_table(
    freqs_mhz: np.ndarray, dms: np.ndarray, tsamp_s: float
) -> np.ndarray:
    """Integer sample delays ``[n_dm, F]`` of each channel relative to
    the highest channel (the band-top reference every other DM user in
    the package shares).  Rounded to nearest — the same rounding the
    quick-look dedisperser applies, so a ``--dm`` waterfall and the
    search see identical shifts."""
    freqs = np.asarray(freqs_mhz, np.float64)
    ref = float(freqs.max())
    delays = np.stack(
        [dm_delays_s(freqs, float(dm), ref) for dm in np.asarray(dms)]
    )
    return np.rint(delays / tsamp_s).astype(np.int32)


def _dedisperse_jit(power_pad_ft, delays, t_out: int):
    """Scan over channels accumulating ``out[d, t] = sum_f
    P[t + delay[d, f], f]``.  One gather per channel from its padded
    column; the accumulator ``[n_dm, t_out]`` stays on device across
    the scan."""
    n_dm = delays.shape[0]
    t_idx = jnp.arange(t_out, dtype=jnp.int32)

    def step(acc, xs):
        col, sh = xs  # [T_pad] one channel, [n_dm] its trial shifts
        acc = acc + col[sh[:, None] + t_idx[None, :]]
        return acc, None

    acc0 = jnp.zeros((n_dm, t_out), jnp.float32)
    out, _ = lax.scan(step, acc0, (power_pad_ft, delays.T))
    return out


# Module-level jit wrappers so repeated same-shape calls (the chunk
# loop in search_spectrogram) hit the compile cache.
_dedisperse_c = jax.jit(_dedisperse_jit, static_argnums=2)


def _subband_jit(power_gct, intra_c, offsets, t1: int, t_out: int):
    """Two-stage (subband) dedispersion.

    Stage 1 — per channel-group, dedisperse over a COARSE trial set
    covering only the within-group relative delays (vmapped scan over
    the group's channels): ``S[g, c, t'] = sum_{f in g}
    P[t' + intra[c, g, f], f]``.  Stage 2 — combine groups over the
    FULL trial set with each group's band-top reference delay, reading
    the nearest coarse row (``offsets`` pre-flattens row+shift):
    ``out[d, t] = sum_g S[g, rep(d), t + inter[d, g]]``.

    Work drops from ``n_dm * F`` to ``n_coarse * F + n_dm * G`` gather
    rows — ~20x at DSA-10 scale — for at most ``max_err_samples`` of
    extra smearing (the plan guarantees the bound; see
    `subband_plan`).
    """
    n_coarse = intra_c.shape[1]
    t1_idx = jnp.arange(t1, dtype=jnp.int32)
    t_idx = jnp.arange(t_out, dtype=jnp.int32)

    def group_fn(p_g, intra_g):  # [C, T_pad], [n_coarse, C]
        def step(acc, xs):
            col, sh = xs
            return acc + col[sh[:, None] + t1_idx[None, :]], None

        acc0 = jnp.zeros((n_coarse, t1), jnp.float32)
        out, _ = lax.scan(step, acc0, (p_g, intra_g.T))
        return out

    s = jax.vmap(group_fn)(power_gct, intra_c)  # [G, n_coarse, T1]

    def step2(acc, xs):
        s_g, off = xs  # [n_coarse, T1], [n_dm]
        flat = s_g.reshape(-1)
        return acc + flat[off[:, None] + t_idx[None, :]], None

    acc0 = jnp.zeros((offsets.shape[1], t_out), jnp.float32)
    out, _ = lax.scan(step2, acc0, (s, offsets))
    return out


_subband_c = jax.jit(_subband_jit, static_argnums=(3, 4))

# Beam-batched variants: the SAME kernels vmapped over a leading beam
# axis, so a multi-beam search is one device dispatch per (chunk,
# beam-group) instead of one per beam: the per-dispatch overhead
# would otherwise dominate per-beam work at search scale.  The
# beam-group size is capped by bank memory (see
# `search_spectrograms`).
_dedisperse_batch_c = jax.jit(
    jax.vmap(_dedisperse_jit, in_axes=(0, None, None)), static_argnums=2)
_subband_batch_c = jax.jit(
    jax.vmap(_subband_jit, in_axes=(0, None, None, None, None)),
    static_argnums=(3, 4))


def _conv_bank_jit(power_btf, fill_bf, kernel, offsets_dg,
                   t_pad: int, g: int, t1: int, t_out: int):
    """Two-stage bank: stage 1 as a convolution, stage 2 as dynamic
    slices — NO gathers anywhere.  This kernel reformulates both
    stages of the scan-gather bank (`_dedisperse_jit`) in dense
    primitives:

    Stage 1 — the within-group shift-sums become a GROUPED
    CONVOLUTION with one-hot kernels: ``S[g, j, t'] = sum_c
    P_g[c, t' + intra[g, j, c]]`` is exactly a 'VALID'
    cross-correlation of the group's ``[C, T_pad]`` block with a
    ``[J, C, S1]`` 0/1 kernel (S1 = intra span).  The convolution eats
    the shift structure: S1x more multiply-adds than the plain sum
    (~51 G-MAC at the DSA-10 monitor geometry), and the one-hot kernel
    is built once per plan on the host.

    Stage 2 — the per-(trial, group) coarse offsets are a `lax.scan`
    over trials of G statically-unrolled `dynamic_slice` reads from
    the flattened stage-1 plane: contiguous vector copies at runtime
    offsets, not per-element loads.

    ``power_btf``: the RAW ``[B, T_ext, F']`` window (F' already
    includes any zero pad channels; any real dtype — uint8 fused
    products upload 4× less and are cast here); ``fill_bf``: the
    ``[B, F']`` tail fill row.  Padding to ``t_pad``, the cast, and
    the corner-turn to ``[B, G*C, t_pad]`` all happen ON DEVICE, not
    in host numpy.  ``kernel``: ``[G*J, C, S1]`` one-hot
    f32; ``offsets_dg``: ``[n_dm, G]`` flat element offsets into the
    ``[G*J*t1]`` stage-1 plane.  Returns ``[B, n_dm, t_out]`` f32.
    HIGHEST precision keeps the 0/1-weighted sums exact in f32 (the
    default would let the GPU round the power samples to TF32).
    """
    b, t_ext, f_pad = power_btf.shape
    gj = kernel.shape[0]
    # uint8 fused products take a bf16 convolution EXACTLY: integers
    # <= 255 are exact in bf16 (8-bit mantissa), the one-hot kernel
    # is 0/1, and the products accumulate in f32 (per-group sums
    # < 2^24), so stage 1 is bit-identical to the f32 HIGHEST conv.
    # The fill row is pre-rounded to integer on this path
    # (`_conv_bank_prep`), so it is exact too.  Float inputs keep
    # HIGHEST, which keeps them out of TF32.
    if power_btf.dtype == jnp.uint8:
        cdt, prec = jnp.bfloat16, lax.Precision.DEFAULT
    else:
        cdt, prec = jnp.float32, lax.Precision.HIGHEST
    x = power_btf.astype(cdt)
    tail = jnp.broadcast_to(
        fill_bf.astype(cdt)[:, None, :],
        (b, t_pad - t_ext, f_pad))
    cols = jnp.concatenate([x, tail], axis=1)        # [B, t_pad, F']
    lhs = cols.transpose(0, 2, 1)                    # [B, G*C, t_pad]
    dn = lax.conv_dimension_numbers(
        lhs.shape, kernel.shape, ("NCW", "OIW", "NCW"))
    s = lax.conv_general_dilated(
        lhs, kernel.astype(cdt), (1,), "VALID", dimension_numbers=dn,
        feature_group_count=g, precision=prec,
        preferred_element_type=jnp.float32)       # [B, G*J, t1]
    s_flat = s.reshape(b, gj * t1)

    n_g = offsets_dg.shape[1]

    def one_beam(flat):
        def step(_, offs):
            acc = lax.dynamic_slice(flat, (offs[0],), (t_out,))
            for gg in range(1, n_g):
                acc = acc + lax.dynamic_slice(flat, (offs[gg],), (t_out,))
            return None, acc

        _, bank = lax.scan(step, None, offsets_dg)
        return bank                               # [n_dm, t_out]

    return jax.vmap(one_beam)(s_flat)


_conv_bank_c = jax.jit(_conv_bank_jit, static_argnums=(4, 5, 6, 7))

#: plan + one-hot kernel cache for the conv bank, keyed by the delay
#: table bytes — the streaming monitor calls every window with the
#: same table, and the kernel build (209k one-hot writes at DSA-10
#: scale) plus device upload should happen once, not per window.
_CONV_PLAN_CACHE: dict = {}


def _conv_plan(delays: np.ndarray, n_sub: int, max_err_samples: int):
    key = (delays.shape, delays.tobytes(), n_sub, max_err_samples)
    hit = _CONV_PLAN_CACHE.get(key)
    if hit is not None:
        return hit
    intra_c, inter, rep_of, pad_f = subband_plan(
        delays, n_sub, max_err_samples)
    g, j, c = intra_c.shape
    s1 = int(intra_c.max()) + 1 if intra_c.size else 1
    kern = np.zeros((g * j, c, s1), np.float32)
    rows = np.repeat(np.arange(g * j), c)
    cols = np.tile(np.arange(c), g * j)
    kern[rows, cols, intra_c.reshape(g * j, c).ravel()] = 1.0
    plan = (intra_c, inter, rep_of, pad_f, jnp.asarray(kern))
    _CONV_PLAN_CACHE.clear()   # one live plan: the kernel is ~40 MB
    _CONV_PLAN_CACHE[key] = plan
    return plan


def _conv_bank_prep(power_btf: np.ndarray, delays: np.ndarray,
                    n_sub: int, max_err_samples: int):
    """Host prep for the conv bank, kept DELIBERATELY light: validate,
    plan (cached), zero-pad the channel tail, and estimate the tail
    fill from a row subsample.  Everything heavy — the f32 cast, time
    padding, corner-turn to groups — happens inside `_conv_bank_jit`:
    host numpy work here is on every live monitor window."""
    b, t, f = power_btf.shape
    if delays.shape[1] != f:
        raise ValueError(
            f"delay table covers {delays.shape[1]} channels, data has {f}")
    if delays.min() < 0:
        raise ValueError("negative delays: delay_table is referenced to the "
                         "band top; check channel ordering (ascending)")
    intra_c, inter, rep_of, pad_f, kern = _conv_plan(
        delays, n_sub, max_err_samples)
    g, n_coarse, c = intra_c.shape
    t1 = t + int(inter.max())
    t_pad = t1 + (kern.shape[2] - 1)
    x = np.asarray(power_btf)
    # Tail fill = per-channel median of a row SUBSAMPLE (<=512 rows).
    # The fill only shapes the data-uncovered tail — beyond valid_len
    # (where candidates are discarded anyway) plus, because the plan's
    # approximated delay may exceed the true max by max_err_samples,
    # the last max_err samples inside valid_len — so a sampled median
    # is statistically identical and much cheaper than np.median over
    # the full monitor window.
    step = max(1, t // 512)
    fill = np.median(x[:, ::step].astype(np.float32, copy=False),
                     axis=1).astype(np.float32)     # [B, F]
    if x.dtype == np.uint8:
        # keep the bf16 stage-1 path exact: an x.5 median would round
        # in bf16 (needs 9 mantissa bits); the fill only shapes the
        # data-uncovered tail, so integer rounding is free
        np.rint(fill, out=fill)
    if pad_f:
        x = np.concatenate(
            [x, np.zeros((b, t, pad_f), x.dtype)], axis=2)
        fill = np.concatenate(
            [fill, np.zeros((b, pad_f), np.float32)], axis=1)
    # flat element offset of (group g, trial d) in the [G*J*t1] plane:
    # (g*J + rep(d)) rows of t1, plus the trial's band-top delay
    offsets = ((np.arange(g)[None, :] * n_coarse + rep_of[:, None]) * t1
               + inter).astype(np.int32)           # [n_dm, G]
    valid_len = np.maximum(t - delays.max(axis=1), 0).astype(np.int64)
    return x, fill, kern, offsets, t_pad, g, t1, valid_len


def conv_dedisperse_bank(
    power_tf: np.ndarray,
    delays: np.ndarray,
    n_sub: Optional[int] = None,
    max_err_samples: int = 1,
) -> Tuple[jax.Array, np.ndarray]:
    """`subband_dedisperse_bank`'s contract (two-stage bank, at most
    ``max_err_samples`` of extra smearing) computed by the
    convolution + dynamic-slice program (`_conv_bank_jit`) — the live
    search monitor's default method.  ``n_sub=None`` (the default)
    picks the fewest channel groups that bound the one-hot kernel's
    width (`_conv_auto_n_sub`): wide groups cut stage 2's slice count,
    but the stage-1 kernel grows ~quadratically with the within-group
    delay span, so high-DM tables need more groups (16 at DSA-10
    dm_max=100 → 128 at dm_max=1000).  Integer inputs (uint8 fused
    products) upload as-is and cast on device — 4× less wire for the
    8-bit product path."""
    t, f = power_tf.shape
    if n_sub is None:
        n_sub = _conv_auto_n_sub(delays)
    x, fill, kern, offsets, t_pad, g, t1, valid_len = _conv_bank_prep(
        np.asarray(power_tf)[None], delays, n_sub, max_err_samples)
    bank = _conv_bank_c(jnp.asarray(x), jnp.asarray(fill), kern,
                        jnp.asarray(offsets), t_pad, g, t1, t)
    return bank[0], valid_len


def conv_dedisperse_bank_batch(
    power_btf: np.ndarray,
    delays: np.ndarray,
    n_sub: Optional[int] = None,
    max_err_samples: int = 1,
) -> Tuple[jax.Array, np.ndarray]:
    """`conv_dedisperse_bank` over a ``[B, T, F]`` beam stack in one
    dispatch (the plan is shared; stage 1 batches in the conv's N
    dim, stage 2 vmaps)."""
    b, t, f = power_btf.shape
    if n_sub is None:
        n_sub = _conv_auto_n_sub(delays)
    x, fill, kern, offsets, t_pad, g, t1, valid_len = _conv_bank_prep(
        np.asarray(power_btf), delays, n_sub, max_err_samples)
    bank = _conv_bank_c(jnp.asarray(x), jnp.asarray(fill), kern,
                        jnp.asarray(offsets), t_pad, g, t1, t)
    return bank, valid_len


def subband_plan(delays: np.ndarray, n_sub: int,
                 max_err_samples: int = 1):
    """Host-side plan for the two-stage bank: contiguous channel
    groups, each referenced to its own band-top channel, and a coarse
    trial subset chosen GREEDILY so every trial's within-group delay
    profile differs from its assigned coarse representative by at most
    ``max_err_samples`` anywhere — an exact error bound, no linearity
    assumption about the delay curve.

    Returns ``(intra_c [G, n_coarse, C], inter [n_dm, G],
    rep_of [n_dm], pad_f)``; ``pad_f`` trailing zero-channels square
    off the last group (they carry zero power and zero delay).
    """
    n_dm, f = delays.shape
    if not 1 <= n_sub <= f:
        raise ValueError(f"n_sub must be in [1, {f}], got {n_sub}")
    c = -(-f // n_sub)
    pad_f = n_sub * c - f
    padded = np.concatenate(
        [delays, np.zeros((n_dm, pad_f), delays.dtype)], axis=1)
    grouped = padded.reshape(n_dm, n_sub, c)
    # ascending frequency within each group: the LAST channel is the
    # group's band top (smallest delay) — except the padded tail of
    # the last group, whose zeros would understate the reference;
    # use the min over real channels (= last real channel).
    inter = grouped[:, :, -1].copy()
    if pad_f:
        inter[:, -1] = grouped[:, -1, : c - pad_f].min(axis=1)
    intra = grouped - inter[:, :, None]  # [n_dm, G, C]
    if pad_f:  # keep zero-power pad channels at zero shift
        intra[:, -1, c - pad_f:] = 0
    reps = [0]
    rep_of = np.zeros(n_dm, np.int64)
    for d in range(1, n_dm):
        if np.abs(intra[d] - intra[reps[-1]]).max() > max_err_samples:
            reps.append(d)
        rep_of[d] = len(reps) - 1
    intra_c = np.ascontiguousarray(
        intra[reps].transpose(1, 0, 2)).astype(np.int32)
    return intra_c, inter.astype(np.int32), rep_of, pad_f


def subband_dedisperse_bank(
    power_tf: np.ndarray,
    delays: np.ndarray,
    n_sub: int = 64,
    max_err_samples: int = 1,
) -> Tuple[jax.Array, np.ndarray]:
    """Approximate `dedisperse_bank` via the two-stage subband
    algorithm: identical contract (channel-median edge padding,
    per-trial ``valid_len``), each output sample the sum of the same
    F input samples with per-channel shifts off by at most
    ``max_err_samples`` — i.e. bounded extra smearing, the same class
    of error the DM-grid quantization itself introduces."""
    t, f = power_tf.shape
    if delays.shape[1] != f:
        raise ValueError(
            f"delay table covers {delays.shape[1]} channels, data has {f}")
    if delays.min() < 0:
        raise ValueError("negative delays: delay_table is referenced to the "
                         "band top; check channel ordering (ascending)")
    intra_c, inter, rep_of, pad_f = subband_plan(
        delays, n_sub, max_err_samples)
    g, n_coarse, c = intra_c.shape
    t1 = t + int(inter.max())
    t_pad = t1 + int(intra_c.max()) if intra_c.size else t1
    fill = np.median(power_tf, axis=0).astype(np.float32)
    cols = np.concatenate([
        np.asarray(power_tf, np.float32),
        np.broadcast_to(fill, (t_pad - t, f)),
    ], axis=0)  # [T_pad, F]
    if pad_f:
        cols = np.concatenate(
            [cols, np.zeros((t_pad, pad_f), np.float32)], axis=1)
    power_gct = np.ascontiguousarray(
        cols.T.reshape(g, c, t_pad))
    # flattened stage-2 read offset per (group, trial): coarse row
    # base + that group's band-top delay for the trial
    offsets = (rep_of[None, :] * t1 + inter.T).astype(np.int32)  # [G, n_dm]
    bank = _subband_c(jnp.asarray(power_gct), jnp.asarray(intra_c),
                      jnp.asarray(offsets), t1, t)
    valid_len = np.maximum(t - delays.max(axis=1), 0).astype(np.int64)
    return bank, valid_len


def dedisperse_bank(
    power_tf: np.ndarray, delays: np.ndarray
) -> Tuple[jax.Array, np.ndarray]:
    """Dedisperse ``[T, F]`` over a ``[n_dm, F]`` integer-delay table.

    Returns ``(bank, valid_len)``: ``bank[d, t]`` is the channel sum
    with trial ``d``'s shifts applied, length T; ``valid_len[d]`` is
    the number of leading samples fully covered by data.  Beyond it,
    shifted channels run off the end of the observation — those reads
    come from padding filled with each channel's MEDIAN, so the tail
    decays toward the baseline instead of ramping (zero padding would
    manufacture a cliff edge that boxcar filters detect as a pulse).
    Candidates found past ``valid_len`` must be discarded by the
    caller.
    """
    t, f = power_tf.shape
    if delays.shape[1] != f:
        raise ValueError(
            f"delay table covers {delays.shape[1]} channels, data has {f}")
    if delays.min() < 0:
        raise ValueError("negative delays: delay_table is referenced to the "
                         "band top; check channel ordering (ascending)")
    max_delay = int(delays.max())
    fill = np.median(power_tf, axis=0).astype(np.float32)  # [F]
    pad = np.broadcast_to(fill, (max_delay, f))
    padded = np.concatenate(
        [np.asarray(power_tf, np.float32), pad], axis=0)  # [T+max, F]
    bank = _dedisperse_c(jnp.asarray(padded.T), jnp.asarray(delays), t)
    valid_len = np.maximum(t - delays.max(axis=1), 0).astype(np.int64)
    return bank, valid_len


def dedisperse_bank_batch(
    power_btf: np.ndarray, delays: np.ndarray
) -> Tuple[jax.Array, np.ndarray]:
    """`dedisperse_bank` over a ``[B, T, F]`` beam stack in one device
    dispatch — bank ``[B, n_dm, T]``; padding fill is each BEAM's own
    per-channel median.  ``valid_len`` is shared (same delay table,
    same T)."""
    b, t, f = power_btf.shape
    if delays.shape[1] != f:
        raise ValueError(
            f"delay table covers {delays.shape[1]} channels, data has {f}")
    if delays.min() < 0:
        raise ValueError("negative delays: delay_table is referenced to the "
                         "band top; check channel ordering (ascending)")
    max_delay = int(delays.max())
    x = np.asarray(power_btf, np.float32)
    fill = np.median(x, axis=1).astype(np.float32)  # [B, F]
    padded = np.concatenate(
        [x, np.broadcast_to(fill[:, None, :], (b, max_delay, f))], axis=1)
    bank = _dedisperse_batch_c(
        jnp.asarray(np.ascontiguousarray(padded.transpose(0, 2, 1))),
        jnp.asarray(delays), t)
    valid_len = np.maximum(t - delays.max(axis=1), 0).astype(np.int64)
    return bank, valid_len


def subband_dedisperse_bank_batch(
    power_btf: np.ndarray,
    delays: np.ndarray,
    n_sub: int = 64,
    max_err_samples: int = 1,
) -> Tuple[jax.Array, np.ndarray]:
    """`subband_dedisperse_bank` over a ``[B, T, F]`` beam stack: the
    plan is computed ONCE (the delay table is shared), stage 1+2 run
    vmapped over beams in one dispatch."""
    b, t, f = power_btf.shape
    if delays.shape[1] != f:
        raise ValueError(
            f"delay table covers {delays.shape[1]} channels, data has {f}")
    if delays.min() < 0:
        raise ValueError("negative delays: delay_table is referenced to the "
                         "band top; check channel ordering (ascending)")
    intra_c, inter, rep_of, pad_f = subband_plan(
        delays, n_sub, max_err_samples)
    g, n_coarse, c = intra_c.shape
    t1 = t + int(inter.max())
    t_pad = t1 + int(intra_c.max()) if intra_c.size else t1
    x = np.asarray(power_btf, np.float32)
    fill = np.median(x, axis=1).astype(np.float32)  # [B, F]
    cols = np.concatenate(
        [x, np.broadcast_to(fill[:, None, :], (b, t_pad - t, f))], axis=1)
    if pad_f:
        cols = np.concatenate(
            [cols, np.zeros((b, t_pad, pad_f), np.float32)], axis=2)
    power_bgct = np.ascontiguousarray(
        cols.transpose(0, 2, 1).reshape(b, g, c, t_pad))
    offsets = (rep_of[None, :] * t1 + inter.T).astype(np.int32)  # [G, n_dm]
    bank = _subband_batch_c(jnp.asarray(power_bgct), jnp.asarray(intra_c),
                            jnp.asarray(offsets), t1, t)
    valid_len = np.maximum(t - delays.max(axis=1), 0).astype(np.int64)
    return bank, valid_len


def _snr_topk_jit(bank, widths: Tuple[int, ...], k: int):
    """Robust-normalize each trial series, then for each boxcar width
    return the top-k S/N peaks per trial.

    Normalization is median/MAD per trial (outlier-immune: the pulse
    being searched for must not inflate its own noise estimate), so
    after it a width-w boxcar SUM has unit-variance ``sqrt(w)`` and

        snr_w[d, t] = (cumsum[t + w] - cumsum[t] - w * 0) / sqrt(w).

    Returns ``(snr, idx)`` each ``[n_w, n_dm, k]`` — a few kB to
    fetch, independent of T.
    """
    med = jnp.median(bank, axis=1, keepdims=True)
    mad = jnp.median(jnp.abs(bank - med), axis=1, keepdims=True)
    sigma = jnp.maximum(mad * 1.4826, 1e-30)
    norm = (bank - med) / sigma  # zero-median, unit-variance per trial
    t = norm.shape[1]
    csum = jnp.concatenate(
        [jnp.zeros((norm.shape[0], 1), norm.dtype),
         jnp.cumsum(norm, axis=1)], axis=1)  # [n_dm, T+1]
    snrs, idxs = [], []
    for w in widths:
        s = (csum[:, w:] - csum[:, :-w]) / np.sqrt(w)  # [n_dm, T-w+1]
        top_v, top_i = lax.top_k(s, k)
        snrs.append(top_v)
        idxs.append(top_i)
    return jnp.stack(snrs), jnp.stack(idxs)


_snr_topk_c = jax.jit(_snr_topk_jit, static_argnums=(1, 2))
_snr_topk_batch_c = jax.jit(
    jax.vmap(_snr_topk_jit, in_axes=(0, None, None)),
    static_argnums=(1, 2))


@dataclasses.dataclass
class Candidate:
    """One clustered single-pulse detection (heimdall-style fields)."""

    snr: float           # best-member matched-filter S/N
    t_samp: int          # start sample of the best-member boxcar
    time_s: float        # t_samp * tsamp
    width: int           # best-member boxcar width [samples]
    dm_idx: int          # best-member trial index
    dm: float            # best-member trial DM [pc cm^-3]
    members: int         # raw (width, trial, peak) points merged in
    dm_lo: float         # DM extent of the cluster
    dm_hi: float
    beam: int = -1       # beam index (-1: single-target search)

    def row(self) -> str:
        return (f"{self.snr:8.2f} {self.t_samp:10d} {self.time_s:12.6f} "
                f"{self.width:6d} {self.dm_idx:7d} {self.dm:10.3f} "
                f"{self.members:8d} {self.dm_lo:10.3f} {self.dm_hi:10.3f} "
                f"{self.beam:5d}")

    HEADER = ("#    snr     t_samp       time_s  width  dm_idx         dm "
              "members      dm_lo      dm_hi  beam")


def _cluster(
    points: List[Tuple[float, int, int, int]],  # (snr, dm_idx, t, w)
    dms: np.ndarray,
    tsamp_s: float,
    band_span: np.ndarray,  # [n_dm] full-band delay sweep per trial
    dm_link: Optional[int] = None,
) -> List[Candidate]:
    """Greedy friends-of-friends merge, strongest point first.

    Two raw detections are the same event iff their band-top arrival
    estimates agree within the DIFFERENTIAL DISPERSION SMEAR between
    their trials: a pulse of true DM ``d0`` detected at a wrong trial
    ``d`` smears over ``|span(d) - span(d0)|`` samples and its peak
    time wanders inside that window, so the link pads the boxcar
    time-overlap test by exactly that trial-pair's span difference.
    A fixed trial-gap gate (the obvious alternative) fragments bright
    pulses — whose ridge spans the whole grid — into dozens of
    candidates (measured on the injected-FRB drill).  ``dm_link``
    optionally restores a hard trial-gap cap for surveys that expect
    simultaneous events at well-separated DMs.
    """
    pts = sorted(points, key=lambda p: -p[0])
    out: List[Candidate] = []
    used = [False] * len(pts)
    for i, (snr, d, t, w) in enumerate(pts):
        if used[i]:
            continue
        used[i] = True
        members, d_lo, d_hi = 1, d, d
        for j in range(i + 1, len(pts)):
            if used[j]:
                continue
            _, dj, tj, wj = pts[j]
            pad = max(w, wj) + abs(int(band_span[d]) - int(band_span[dj]))
            if (tj < t + w + pad and t < tj + wj + pad
                    and (dm_link is None or abs(dj - d) <= dm_link)):
                used[j] = True
                members += 1
                d_lo, d_hi = min(d_lo, dj), max(d_hi, dj)
        out.append(Candidate(
            snr=float(snr), t_samp=int(t), time_s=float(t * tsamp_s),
            width=int(w), dm_idx=int(d), dm=float(dms[d]), members=members,
            dm_lo=float(dms[d_lo]), dm_hi=float(dms[d_hi])))
    return out


def preprocess_spectrogram(
    x: np.ndarray,
    zap: Optional[Sequence[int]] = None,
    zerodm: bool = False,
) -> np.ndarray:
    """RFI conditioning before dedispersion, float32 copy of ``[T, F]``.

    ``zap`` channels are zeroed — a CONSTANT, so they contribute a
    level every trial's median/MAD normalization removes, without
    disturbing the delay table's channel indexing.  (Constant matters:
    the streaming monitor preprocesses block-by-block, and any
    block-dependent fill — e.g. a per-block median — would paint
    steps into the zapped channel that boxcar filters detect as
    pulses.)  ``zerodm``
    subtracts each time sample's mean over the KEPT channels from the
    kept channels (the classic zero-DM filter): broadband impulsive
    RFI is undispersed, so it lives entirely in that projection, while
    a dispersed pulse crosses one channel per sample and loses only
    ~1/F of its amplitude.
    """
    x = np.array(x, np.float32, copy=True)
    keep = np.ones(x.shape[1], bool)
    if zap:
        zap = np.asarray(sorted(set(int(c) for c in zap)))
        if zap.size and (zap[0] < 0 or zap[-1] >= x.shape[1]):
            raise ValueError(
                f"zap channels {zap[zap < 0].tolist() + zap[zap >= x.shape[1]].tolist()} "
                f"outside [0, {x.shape[1]})")
        keep[zap] = False
        if not keep.any():
            raise ValueError("zap spec removes every channel")
        x[:, ~keep] = 0.0
    if zerodm:
        x[:, keep] -= x[:, keep].mean(axis=1, keepdims=True)
    return x


def _search_chunk(
    chunk: np.ndarray,        # [T_ext, F] data incl. extension
    delays: np.ndarray,       # [n_dm, F]
    dms: np.ndarray,
    tsamp_s: float,
    band_span: np.ndarray,
    widths: Tuple[int, ...],
    threshold: float,
    topk: int,
    own: Optional[int],       # samples owned by this window (None =
                              # final: own everything data covers)
    t_offset: int,            # absolute sample index of chunk[0]
    dm_link: Optional[int],
    method: str = "direct",
    n_sub: int = 64,
) -> List[Candidate]:
    """One search window: dedisperse + matched-filter + top-k on the
    device, threshold/ownership-gate/cluster on the host.  Shared by
    the offline chunk loop and the streaming monitor (which carries
    the extension samples forward itself)."""
    max_w = max(widths)
    if method == "conv":
        bank, valid_len = conv_dedisperse_bank(
            chunk, delays, n_sub=None)
    elif method == "subband":
        bank, valid_len = subband_dedisperse_bank(
            chunk, delays, n_sub=min(n_sub, chunk.shape[1]))
    elif method == "direct":
        bank, valid_len = dedisperse_bank(chunk, delays)
    else:
        raise ValueError(
            f"method must be conv|direct|subband, got {method!r}")
    snr, idx = _snr_topk_c(bank, widths,
                           min(topk, bank.shape[1] - max_w + 1))
    points = _threshold_points(np.asarray(snr), np.asarray(idx), widths,
                               valid_len, own, t_offset, threshold)
    return _cluster(points, np.asarray(dms), tsamp_s, band_span, dm_link)


def _threshold_points(
    snr: np.ndarray,          # [n_w, n_dm, k]
    idx: np.ndarray,
    widths: Tuple[int, ...],
    valid_len: np.ndarray,
    own: Optional[int],
    t_offset: int,
    threshold: float,
) -> List[tuple]:
    """Host thresholding of the fetched top-k grid into raw candidate
    points.  The searchable extent of each (width, trial) is the
    data-covered region minus the boxcar, clipped to the samples this
    window OWNS (peaks in the extension belong to the next window)."""
    w_arr = np.asarray(widths, np.int64)[:, None]
    lim = valid_len if own is None else np.minimum(valid_len, own)
    limit = np.minimum(valid_len[None, :] - w_arr + 1, lim[None, :])
    mask = (snr >= threshold) & (idx < limit[:, :, None])
    return [(float(snr[wi, d, kk]), int(d), int(idx[wi, d, kk]) + t_offset,
             int(widths[wi]))
            for wi, d, kk in np.argwhere(mask)]


def _search_chunk_batch(
    chunk_btf: np.ndarray,    # [B, T_ext, F] beam-stacked window
    delays: np.ndarray,
    dms: np.ndarray,
    tsamp_s: float,
    band_span: np.ndarray,
    widths: Tuple[int, ...],
    threshold: float,
    topk: int,
    own: Optional[int],
    t_offset: int,
    dm_link: Optional[int],
    method: str = "direct",
    n_sub: int = 64,
) -> List[List[Candidate]]:
    """`_search_chunk` over a beam stack: TWO device dispatches for the
    whole group (batched bank + batched top-k) instead of two per
    beam; thresholding/clustering stays per-beam on host."""
    max_w = max(widths)
    if method == "conv":
        bank, valid_len = conv_dedisperse_bank_batch(
            chunk_btf, delays, n_sub=None)
    elif method == "subband":
        bank, valid_len = subband_dedisperse_bank_batch(
            chunk_btf, delays, n_sub=min(n_sub, chunk_btf.shape[2]))
    elif method == "direct":
        bank, valid_len = dedisperse_bank_batch(chunk_btf, delays)
    else:
        raise ValueError(
            f"method must be conv|direct|subband, got {method!r}")
    snr, idx = _snr_topk_batch_c(bank, widths,
                                 min(topk, bank.shape[2] - max_w + 1))
    snr, idx = np.asarray(snr), np.asarray(idx)  # [B, n_w, n_dm, k]
    dms = np.asarray(dms)
    return [
        _cluster(_threshold_points(snr[bi], idx[bi], widths, valid_len,
                                   own, t_offset, threshold),
                 dms, tsamp_s, band_span, dm_link)
        for bi in range(chunk_btf.shape[0])
    ]


def search_spectrogram(
    power_tf: np.ndarray,
    freqs_mhz: np.ndarray,
    tsamp_s: float,
    dms: np.ndarray,
    widths: Sequence[int] = DEFAULT_WIDTHS,
    threshold: float = 7.0,
    chunk_t: int = 16384,
    topk: int = 4,
    dm_link: Optional[int] = None,
    zap: Optional[Sequence[int]] = None,
    zerodm: bool = False,
    method: str = "direct",
    n_sub: int = 64,
) -> List[Candidate]:
    """Search an ascending-frequency ``[T, F]`` dynamic spectrum for
    dispersed single pulses over DM trials ``dms``.

    ``method="conv"`` uses the gather-free two-stage bank
    (`_conv_bank_jit`, convolution stage 1 + dynamic-slice stage 2) —
    the live monitor's default, for at most one extra sample of
    smearing.
    ``"subband"`` is the same two-stage plan on the gather kernels;
    keep ``"direct"`` (the offline default) when the trial count is
    small or exactness against the brute-force bank matters.

    Long observations are processed in host-side chunks of ``chunk_t``
    output samples, each extended by ``max_delay + max_width`` so a
    pulse straddling a boundary is fully contained in one chunk (the
    extension samples are searched in the EARLIER chunk only, so
    duplicates can't arise).  Per chunk the device does dedispersion,
    normalization, boxcar filtering and top-k extraction in two
    compiled calls; the host only thresholds, de-duplicates and
    clusters a few thousand points.

    Returns candidates sorted by S/N (strongest first).
    """
    power_tf = preprocess_spectrogram(power_tf, zap, zerodm)
    t_total, f = power_tf.shape
    delays = delay_table(freqs_mhz, dms, tsamp_s)
    widths = tuple(int(w) for w in widths)
    max_w = max(widths)
    overlap = int(delays.max()) + max_w
    band_span = delays.max(axis=1)  # full-band sweep per trial [samples]

    cands: List[Candidate] = []
    start = 0
    while start < t_total:
        stop = min(start + chunk_t, t_total)
        ext_stop = min(stop + overlap, t_total)
        # A chunk whose extension reaches EOF is the last one: it owns
        # every remaining sample (otherwise the loop would spawn a
        # final sliver shorter than the boxcar and drop it).
        final = ext_stop >= t_total
        chunk = power_tf[start:ext_stop]
        if chunk.shape[0] <= max_w:
            break
        cands.extend(_search_chunk(
            chunk, delays, dms, tsamp_s, band_span, widths, threshold,
            topk, own=None if final else (stop - start),
            t_offset=start, dm_link=dm_link, method=method, n_sub=n_sub))
        if final:
            break
        start = stop
    cands.sort(key=lambda c: -c.snr)
    return cands


def search_spectrograms(
    spectra: Sequence[Tuple[int, np.ndarray]],
    freqs_mhz: np.ndarray,
    tsamp_s: float,
    dms: np.ndarray,
    widths: Sequence[int] = DEFAULT_WIDTHS,
    threshold: float = 7.0,
    chunk_t: int = 16384,
    topk: int = 4,
    dm_link: Optional[int] = None,
    zap: Optional[Sequence[int]] = None,
    zerodm: bool = False,
    method: str = "direct",
    n_sub: int = 64,
    beam_batch: Optional[int] = None,
) -> dict:
    """Multi-beam `search_spectrogram`: ``spectra`` is ``[(beam_label,
    [T, F]), ...]`` with ONE shared shape (what a DADA product or a
    per-beam .fil directory of one observation yields); returns
    ``{beam_label: [Candidate, ...]}`` with each candidate's ``beam``
    set.

    Beams are stacked and searched ``beam_batch`` at a time through
    the vmapped bank + top-k kernels — two device dispatches per
    (chunk, group) instead of two PER BEAM, which keeps a 256-beam
    search from paying 256x the per-dispatch cost.  ``beam_batch=None`` sizes groups so the ``[g, n_dm, T]``
    bank plus the padded operand stay under ~256 MB of HBM.  Group
    and chunk shapes are fixed across the run, so the device programs
    compile once (+ one tail-shape each)."""
    if not spectra:
        raise ValueError("no spectra to search")
    labels = [b for b, _ in spectra]
    if len(set(labels)) != len(labels):
        raise ValueError(f"duplicate beam labels: {sorted(labels)}")
    shapes = {x.shape for _, x in spectra}
    if len(shapes) != 1:
        raise ValueError(
            f"beam spectra shapes differ ({sorted(shapes)}): batched "
            f"search needs one [T, F] shape across beams")
    xs = np.stack([preprocess_spectrogram(x, zap, zerodm)
                   for _, x in spectra])  # [B, T, F]
    b, t_total, f = xs.shape
    delays = delay_table(freqs_mhz, dms, tsamp_s)
    widths = tuple(int(w) for w in widths)
    max_w = max(widths)
    overlap = int(delays.max()) + max_w
    band_span = delays.max(axis=1)
    if beam_batch is None:
        t_c = min(chunk_t, t_total)
        per_beam = 4 * (len(dms) * t_c + f * (t_c + overlap))
        beam_batch = max(1, min(b, int(256e6 // max(per_beam, 1))))
    by_beam: dict = {lab: [] for lab in labels}
    start = 0
    while start < t_total:
        stop = min(start + chunk_t, t_total)
        ext_stop = min(stop + overlap, t_total)
        final = ext_stop >= t_total
        chunk = xs[:, start:ext_stop]
        if chunk.shape[1] <= max_w:
            break
        for g0 in range(0, b, beam_batch):
            per_beam_cands = _search_chunk_batch(
                chunk[g0:g0 + beam_batch], delays, dms, tsamp_s,
                band_span, widths, threshold, topk,
                own=None if final else (stop - start), t_offset=start,
                dm_link=dm_link, method=method, n_sub=n_sub)
            for bi, cs in enumerate(per_beam_cands):
                lab = labels[g0 + bi]
                for c in cs:
                    c.beam = lab
                by_beam[lab].extend(cs)
        if final:
            break
        start = stop
    for cs in by_beam.values():
        cs.sort(key=lambda c: -c.snr)
    return by_beam


def coincidence_filter(
    cands_by_beam: dict,
    band_span: np.ndarray,
    n_beams_searched: int,
    frac: float = 0.25,
    min_beams: int = 3,
) -> Tuple[dict, List[dict]]:
    """Cross-beam coincidence RFI rejection.

    An astrophysical pulse enters through ONE sky position: it is
    strong in the pointed beam and falls off through the beam pattern,
    so it triggers a handful of adjacent beams at most.  Terrestrial
    RFI enters through the sidelobes of EVERY beam at comparable
    strength.  Candidates from all beams are linked with the same
    smear-aware rule as in-beam clustering (time spans overlap within
    boxcar widths + the trials' differential dispersion smear); a
    linked cluster seen in ``>= max(min_beams, ceil(frac *
    n_beams_searched))`` distinct beams is tagged RFI and removed.

    Returns ``(kept_by_beam, rfi_events)`` — ``rfi_events`` summarizes
    each rejected cluster by its brightest member plus ``n_beams``
    hit, for the operator log.
    """
    if not 0 < frac <= 1:
        raise ValueError(f"frac must be in (0, 1], got {frac}")
    thresh = max(min_beams, int(np.ceil(frac * n_beams_searched)))
    pts = [(c, b) for b, cs in cands_by_beam.items() for c in cs]
    pts.sort(key=lambda p: -p[0].snr)
    if not pts:
        return dict(cands_by_beam), []
    # Time index: a pair can only link within max(width)+max smear
    # difference of each other, so each seed tests only a time window
    # of candidates instead of every pair — the RFI-storm case this
    # filter exists for is exactly the one where O(N^2) over all
    # beams' candidates would dominate the search itself.
    t_arr = np.array([p[0].t_samp for p in pts], np.int64)
    w_max = int(max(p[0].width for p in pts))
    span_max = (int(band_span.max() - band_span.min())
                if len(band_span) else 0)
    order = np.argsort(t_arr, kind="stable")
    t_sorted = t_arr[order]
    reach = 2 * w_max + span_max  # >= width-sum/2 + |smear diff| bound
    used = [False] * len(pts)
    rfi_members: set = set()
    rfi_events: List[dict] = []
    for i, (c, b) in enumerate(pts):
        if used[i]:
            continue
        used[i] = True
        cluster = [i]
        lo = np.searchsorted(t_sorted, c.t_samp - reach, "left")
        hi = np.searchsorted(t_sorted, c.t_samp + c.width + reach, "right")
        for j in order[lo:hi]:
            if used[j]:
                continue
            cj = pts[j][0]
            pad = (max(c.width, cj.width)
                   + abs(int(band_span[c.dm_idx])
                         - int(band_span[cj.dm_idx])))
            if (cj.t_samp < c.t_samp + c.width + pad
                    and c.t_samp < cj.t_samp + cj.width + pad):
                used[j] = True
                cluster.append(int(j))
        beams_hit = {pts[k][1] for k in cluster}
        if len(beams_hit) >= thresh:
            rfi_members.update(cluster)
            rfi_events.append({
                "snr": round(c.snr, 2), "dm": round(c.dm, 3),
                "t_samp": c.t_samp, "width": c.width,
                "n_beams": len(beams_hit),
                "members": sum(pts[k][0].members for k in cluster),
            })
    rfi_ids = {id(pts[k][0]) for k in rfi_members}
    kept = {b: [c for c in cs if id(c) not in rfi_ids]
            for b, cs in cands_by_beam.items()}
    return kept, rfi_events


class SearchMonitor:
    """Streaming single-pulse search over the beamformer's OWN output
    blocks (``dsabf run --search-dm-max``) — the live FRB trigger the
    reference deployment gets from a separate heimdall fleet reading
    the DADA buffers.

    The pipeline hands :meth:`observe` each drained block's product
    (host-side, after the D2H the sink already paid); the monitor
    keeps a rolling ``[T, F]`` buffer of the selected beam (or the
    incoherent sum; or ``[B, T, F]`` for a beam set / ``beam="all"``),
    and whenever ``chunk_t`` owned samples have accumulated it
    searches them extended by ``max_delay + max_width``
    carried-forward samples — identical windowing to the offline chunk
    loop (`_search_chunk`), so a pulse straddling block or window
    boundaries is found exactly once.  Fixed window shape means the
    two device programs compile once and are reused for the whole run.

    Multi-beam targets run the beam-batched kernels (two dispatches
    per window for the whole set) and apply per-window cross-beam
    coincidence RFI rejection — the live FRB trigger gets the same
    "localized on the sky?" veto the offline multi-file search has.
    Windows are synchronized across beams, so each window's filter
    sees every beam's candidates for the same samples; a cluster
    whose members straddle a window-ownership boundary can split
    across windows and evade the veto (kept, not dropped — the
    conservative failure mode).

    A sequence-number gap (ring overrun drops) breaks the dispersion
    sweep's continuity: the buffer is flushed through a final-owned
    search and restarted, and the gap is counted.  Normalization is
    median/MAD per trial, so uint8 fused-quantized products (per-beam
    scalar scale) search identically to f32 ones.
    """

    def __init__(
        self,
        freqs_mhz: np.ndarray,
        tsamp_s: float,
        dms: np.ndarray,
        *,
        beam=0,
        incoherent: bool = False,
        widths: Sequence[int] = DEFAULT_WIDTHS,
        threshold: float = 7.0,
        chunk_t: int = 4096,
        topk: int = 4,
        dm_link: Optional[int] = None,
        zap: Optional[Sequence[int]] = None,
        zerodm: bool = False,
        method: str = "conv",
        n_sub: int = 64,
        on_candidate=None,
        coincidence: bool = True,
        coincidence_frac: float = 0.25,
        on_rfi=None,
    ):
        if method not in ("conv", "direct", "subband"):
            raise ValueError(
                f"method must be conv|direct|subband, got {method!r}")
        self.freqs_mhz = np.asarray(freqs_mhz, np.float64)
        self.tsamp_s = float(tsamp_s)
        self.dms = np.asarray(dms, np.float64)
        # Beam target: one index (the legacy live path), a set of
        # indices, or "all" — multi-beam targets search through the
        # beam-batched kernels with per-window cross-beam coincidence
        # RFI rejection (`coincidence_filter`).  "all" resolves its
        # labels from the first observed product.
        if isinstance(beam, str) and beam.strip().lower() == "all":
            self._beam_sel = "all"
            self.beam = -1
        elif isinstance(beam, (list, tuple, np.ndarray)):
            sel = [int(b) for b in beam]
            if not sel:
                raise ValueError("empty beam set")
            if len(sel) != len(set(sel)):
                raise ValueError(f"duplicate beams in {sel}")
            if len(sel) == 1:
                self._beam_sel = None
                self.beam = sel[0]
            else:
                self._beam_sel = sel
                self.beam = -1
        else:
            self._beam_sel = None
            self.beam = int(beam)
        self._labels: Optional[List[int]] = (
            self._beam_sel if isinstance(self._beam_sel, list) else None)
        self.coincidence = bool(coincidence)
        if not 0 < coincidence_frac <= 1:
            # fail at construction, not mid-stream in the first window
            raise ValueError(
                f"coincidence_frac must be in (0, 1], got {coincidence_frac}")
        self.coincidence_frac = float(coincidence_frac)
        self.on_rfi = on_rfi
        self.rfi_rejected = 0
        self.incoherent = bool(incoherent)
        if self.incoherent and self._beam_sel is not None:
            raise ValueError("incoherent target is a single spectrogram; "
                             "beam sets/'all' don't apply")
        self.widths = tuple(int(w) for w in widths)
        self.threshold = float(threshold)
        self.topk = int(topk)
        self.dm_link = dm_link
        self.zap = tuple(int(c) for c in zap) if zap else None
        self.zerodm = bool(zerodm)
        self.method = method
        self.n_sub = int(n_sub)
        self.on_candidate = on_candidate
        self.delays = delay_table(self.freqs_mhz, self.dms, self.tsamp_s)
        self.band_span = self.delays.max(axis=1)
        self.max_w = max(self.widths)
        self.overlap = int(self.delays.max()) + self.max_w
        self.chunk_t = int(chunk_t)
        if self.chunk_t < self.max_w:
            raise ValueError(
                f"chunk_t {chunk_t} shorter than the widest boxcar "
                f"{self.max_w}")
        self.candidates: List[Candidate] = []
        self.gaps = 0
        self.searched_windows = 0
        self._buf: List[np.ndarray] = []
        self._buffered = 0
        self._t_base = 0      # absolute sample index of _buf[0][0]
        self._next_seq: Optional[int] = None

    #: True when the monitor needs the per-beam product (the pipeline
    #: then materializes it even with no sink attached).
    @property
    def wants_beams(self) -> bool:
        return not self.incoherent

    def _extract(self, powers: Optional[np.ndarray],
                 inco: Optional[np.ndarray]) -> np.ndarray:
        """One block's ``[T_out, F]`` float32 spectrogram from the
        product the pipeline drained: ``[F, T]`` incoherent,
        ``[F, T, B]`` power, or ``[F, T, 4, B]`` Stokes (plane I).
        Multi-beam targets return ``[B_sel, T_out, F]``."""
        if self.incoherent:
            if inco is None:
                raise ValueError("search monitor targets the incoherent "
                                 "sum but the pipeline has no incoherent "
                                 "product enabled")
            x = np.asarray(inco, np.float32).T
        else:
            if powers is None:
                raise ValueError("search monitor needs the beam product")
            if powers.ndim == 4:
                powers = powers[:, :, 0]  # Stokes I plane
            nb = powers.shape[-1]
            if self._beam_sel is not None:
                if self._labels is None:  # "all": resolve on first block
                    self._labels = list(range(nb))
                bad = [b for b in self._labels if not 0 <= b < nb]
                if bad:
                    raise ValueError(f"search beams {bad} out of range "
                                     f"(product has {nb})")
                x = np.ascontiguousarray(
                    powers[:, :, self._labels].transpose(2, 1, 0)
                ).astype(np.float32)  # [B_sel, T, F]
                if self.zap or self.zerodm:
                    x = np.stack([
                        preprocess_spectrogram(xb, self.zap, self.zerodm)
                        for xb in x])
                return x
            if not 0 <= self.beam < nb:
                raise ValueError(f"search beam {self.beam} out of range "
                                 f"(product has {nb})")
            sel = powers[:, :, self.beam].T
            if sel.dtype == np.uint8 and not (self.zap or self.zerodm):
                # fused-quant8 products stay uint8 to the device: the
                # conv bank casts after upload (4x less window H2D),
                # and median/MAD normalization makes the search
                # scale-invariant; the gather banks cast on host.
                x = np.ascontiguousarray(sel)
            else:
                x = np.ascontiguousarray(sel, dtype=np.float32)
        if self.zap or self.zerodm:
            # Per-block conditioning equals whole-stream conditioning:
            # the zap fill is a constant and zero-DM is per-sample.
            x = preprocess_spectrogram(x, self.zap, self.zerodm)
        return x

    def observe(self, seq: int, powers: Optional[np.ndarray],
                inco: Optional[np.ndarray] = None) -> None:
        x = self._extract(powers, inco)
        if self._next_seq is not None and seq != self._next_seq:
            self.gaps += 1
            self.flush()
            self._t_base += self.overlap  # nominal; times stay per-run
        self._next_seq = seq + 1
        self._buf.append(x)
        self._buffered += x.shape[-2]
        while self._buffered >= self.chunk_t + self.overlap:
            self._search_front()

    def _concat(self) -> np.ndarray:
        # time is the second-to-last axis for both [T, F] and [B, T, F]
        if len(self._buf) > 1:
            self._buf = [np.concatenate(self._buf, axis=-2)]
        return self._buf[0]

    def _emit(self, cands: List[Candidate]) -> None:
        self.searched_windows += 1
        for c in cands:
            self.candidates.append(c)
            if self.on_candidate is not None:
                self.on_candidate(c)

    def _search_window(self, window: np.ndarray,
                       own: Optional[int]) -> List[Candidate]:
        """Search one window — single-beam via `_search_chunk`,
        multi-beam via the batched kernels with per-window cross-beam
        coincidence (windows are synchronized across beams, so the
        filter sees every beam's candidates for these samples)."""
        if self._beam_sel is None:
            cands = _search_chunk(
                window, self.delays, self.dms, self.tsamp_s,
                self.band_span, self.widths, self.threshold, self.topk,
                own=own, t_offset=self._t_base, dm_link=self.dm_link,
                method=self.method, n_sub=self.n_sub)
            if not self.incoherent:
                # label with the target beam (offline searches label
                # in cmd_search; the monitor knows its own target) so
                # .cand vetting inherits the right beam
                for c in cands:
                    c.beam = self.beam
            return cands
        per_beam = _search_chunk_batch(
            window, self.delays, self.dms, self.tsamp_s, self.band_span,
            self.widths, self.threshold, self.topk, own=own,
            t_offset=self._t_base, dm_link=self.dm_link,
            method=self.method, n_sub=self.n_sub)
        by_beam = {}
        for lab, cs in zip(self._labels, per_beam):
            for c in cs:
                c.beam = lab
            by_beam[lab] = cs
        if self.coincidence:
            by_beam, events = coincidence_filter(
                by_beam, self.band_span,
                n_beams_searched=len(self._labels),
                frac=self.coincidence_frac)
            self.rfi_rejected += len(events)
            if self.on_rfi is not None:
                for ev in events:
                    self.on_rfi(ev)
        out = [c for cs in by_beam.values() for c in cs]
        out.sort(key=lambda c: -c.snr)
        return out

    def _search_front(self) -> None:
        x = self._concat()
        window = x[..., : self.chunk_t + self.overlap, :]
        self._emit(self._search_window(window, own=self.chunk_t))
        self._buf = [x[..., self.chunk_t:, :]]
        self._buffered -= self.chunk_t
        self._t_base += self.chunk_t

    def flush(self) -> None:
        """Search whatever remains (final window owns everything its
        data covers), then reset the buffer.  Called at end of stream
        and on a sequence gap."""
        if self._buffered > self.max_w:
            self._emit(self._search_window(self._concat(), own=None))
        self._t_base += self._buffered
        self._buf, self._buffered = [], 0


def write_candidates(path, cands: Sequence[Candidate], meta: dict) -> None:
    """Write a heimdall-style whitespace-column candidate file with a
    ``#``-comment header recording the search parameters."""
    with open(path, "w") as fh:
        for k, v in sorted(meta.items()):
            fh.write(f"# {k} = {v}\n")
        fh.write(Candidate.HEADER + "\n")
        for c in cands:
            fh.write(c.row() + "\n")


def read_candidates(path) -> Tuple[dict, List[Candidate]]:
    """Parse a `write_candidates` file back into ``(meta, cands)``.

    Meta values are restored to int/float where they parse as one
    (the writer stringified them).  Rows missing the ``beam`` column
    (files written before multi-beam search) load with ``beam=-1``.
    """
    meta: dict = {}
    cands: List[Candidate] = []
    with open(path) as fh:
        for line in fh:
            line = line.strip()
            if not line:
                continue
            if line.startswith("#"):
                key, sep, val = line[1:].partition(" = ")
                if sep:
                    val = val.strip()
                    for conv in (int, float):
                        try:
                            val = conv(val)
                            break
                        except ValueError:
                            pass
                    meta[key.strip()] = val
                continue  # the column-header line has no " = "
            f = line.split()
            if len(f) not in (9, 10):
                raise ValueError(f"{path}: expected 9/10 columns, got "
                                 f"{len(f)}: {line!r}")
            cands.append(Candidate(
                snr=float(f[0]), t_samp=int(f[1]), time_s=float(f[2]),
                width=int(f[3]), dm_idx=int(f[4]), dm=float(f[5]),
                members=int(f[6]), dm_lo=float(f[7]), dm_hi=float(f[8]),
                beam=int(f[9]) if len(f) == 10 else -1))
    return meta, cands
