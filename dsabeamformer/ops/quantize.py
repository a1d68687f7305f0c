"""Weight preparation for the GEMM: K-concatenated real form + quantization.

No analog in the reference, which fed complex64 weights straight to
cuBLAS (SURVEY.md C6): a complex GEMM ``B = V @ W^T`` is rewritten as
ONE real GEMM by concatenating real and imaginary parts along the
contraction axis:

    Xc = [Xr | Xi]                      # [T, 2A]
    Wc = [[Wr^T,  Wi^T],
          [-Wi^T, Wr^T]]               # [2A, 2B]
    Xc @ Wc = [Br | Bi]                # [T, 2B]

so the int8 tensor cores, which multiply real matrices, do all of it.
Two K tricks stack on top of the complex concatenation:

- **Antenna slicing** (``a_compute``): the wire format zero-pads the
  antenna axis (DSA-10: 10 active of 64, SURVEY.md §0), and zero data
  rows contribute nothing to the GEMM — the weight matrix keeps only
  the first ``a_compute`` antenna columns, shrinking K by the padding
  ratio before the GEMM ever sees it.
- **``int12`` x16 folding**: 12-bit weights in ONE int8 matmul.
  ``W ~= s * (16*W_hi + W_lo)`` with the 16 moved to the DATA side —
  legal precisely because voltages are 4-bit (``|16x| <= 128`` fits
  int8) — so ``B = [16X | X] @ [[W_hi], [W_lo]]`` is a single
  K-concatenated int8 GEMM of one term, at ~2.5e-4 weight error (the
  1e-3 power bar needs ~12 bits; int8's 8 are too few, int8x2's 16 are
  more than the f32 phase generation can even use).

Modes:

- ``int13``  : one int8 term, TWO K-folded hi+lo pairs summed in the
               dot (K = 8A) — the most accurate one-term mode (~13-bit
               weights).
- ``int12``  : one int8 term, K-folded hi+lo (see above).
- ``int8``   : one int8 term, per-channel scale (fails the bar at ~7e-3;
               kept for throughput comparison).
- ``int8x2`` : hi + lo int8 terms spaced exactly 2^8 (residual
               quantization, ~15-bit effective) — max accuracy at 2x
               the int8 work.  Default.
- ``bf16`` / ``bf16x2`` : bfloat16 single / hi+lo split.
- ``f32``    : exact float32 (validation path).

Voltages are 4-bit integers — exactly representable in every input
dtype — so *all* quantization error lives in the weights, which is why
per-channel weight scaling alone controls end-to-end accuracy.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from dsabeamformer.config import ObsConfig
from dsabeamformer.ops.cplx import CVec


class QuantWeights(NamedTuple):
    """GEMM-ready weights.

    terms:  tuple of ``[F, K, 2B]`` arrays (int8, bfloat16, or float32)
            — a TUPLE, not a stacked array, so each term is its own jit
            parameter and the compiled program never pays a
            slice/unstack pass.  K = 2*a_compute, except int12 where the single term
            holds hi over lo: ``[[W_hi], [W_lo]]`` with K = 4*a_compute.
    scales: ``[F, n_terms]`` float32 — per-channel per-term scale such
            that ``Wc[f] ~= sum_k scales[f, k] * terms[k][f]`` (for
            int12: ``Wc[f] ~= scales[f,0] * (16*hi + lo)``).
    """

    terms: tuple
    scales: jax.Array

    @property
    def n_terms(self) -> int:
        return len(self.terms)

    @property
    def n_chan(self) -> int:
        return self.terms[0].shape[0]

    def dequantize(self, mode: str = "linear") -> jax.Array:
        """Reconstruct ``Wc`` in float32 (test oracle).

        Pass ``mode="int12"`` for x16-folded terms (the K axis holds
        ``[[W_hi], [W_lo]]`` and the data side carries the 16)."""
        if mode == "int12":
            k2 = self.terms[0].shape[1] // 2
            hi = self.terms[0][:, :k2].astype(jnp.float32)
            lo = self.terms[0][:, k2:].astype(jnp.float32)
            return self.scales[:, 0, None, None] * (16.0 * hi + lo)
        if mode == "int13":
            # Rows are [[hi1],[lo1],[hi2],[lo2]] (see _quant_int13).
            t = self.terms[0].astype(jnp.float32)
            k2 = t.shape[1] // 4
            h1, l1 = t[:, :k2], t[:, k2 : 2 * k2]
            h2, l2 = t[:, 2 * k2 : 3 * k2], t[:, 3 * k2 :]
            return self.scales[:, 0, None, None] * (
                16.0 * (h1 + h2) + l1 + l2
            )
        acc = None
        for k, t in enumerate(self.terms):
            part = self.scales[:, k, None, None] * t.astype(jnp.float32)
            acc = part if acc is None else acc + part
        return acc


def cat_weights(weights: CVec, a_compute: int | None = None) -> jax.Array:
    """Planar ``CVec`` ``[F, B, A]`` -> K-concatenated real ``Wc
    [F, 2*a_compute, 2B]``; antennas >= ``a_compute`` (zero-padded wire
    slots) are dropped from the contraction axis."""
    wr = weights.re.astype(jnp.float32)  # [F, B, A]
    wi = weights.im.astype(jnp.float32)
    if a_compute is not None:
        if not (0 < a_compute <= wr.shape[2]):
            raise ValueError(
                f"a_compute={a_compute} out of range for A={wr.shape[2]}"
            )
        wr = wr[:, :, :a_compute]
        wi = wi[:, :, :a_compute]
    wrT = jnp.swapaxes(wr, 1, 2)  # [F, A, B]
    wiT = jnp.swapaxes(wi, 1, 2)
    top = jnp.concatenate([wrT, wiT], axis=2)     # [F, A, 2B]
    bot = jnp.concatenate([-wiT, wrT], axis=2)    # [F, A, 2B]
    return jnp.concatenate([top, bot], axis=1)    # [F, 2A, 2B]


def _per_chan_scale(wc: jax.Array) -> jax.Array:
    s = jnp.max(jnp.abs(wc), axis=(1, 2)) / 127.0
    return jnp.maximum(s, jnp.float32(1e-30))


@jax.jit
def _quant_int8(wc):
    s = _per_chan_scale(wc)
    q = jnp.clip(jnp.round(wc / s[:, None, None]), -127, 127).astype(jnp.int8)
    return (q,), s[:, None]


@jax.jit
def _quant_int8x2(wc):
    s_hi = _per_chan_scale(wc)
    q_hi = jnp.clip(jnp.round(wc / s_hi[:, None, None]), -127, 127).astype(jnp.int8)
    resid = wc - s_hi[:, None, None] * q_hi.astype(jnp.float32)
    # Exactly s_hi / 256 (a power of two): the kernel can then combine the
    # int32 partials as (M_hi << 8) + M_lo and apply ONE scale, keeping the
    # whole epilogue integer until a single f32 convert.  |resid| <= s_hi/2
    # => round(resid/s_lo) in [-128, 128]; the rare +-128 clips to +-127,
    # adding at most 1.5*s_lo error on those elements (~4e-5 relative).
    s_lo = s_hi * jnp.float32(1.0 / 256.0)
    q_lo = jnp.clip(jnp.round(resid / s_lo[:, None, None]), -127, 127).astype(jnp.int8)
    return (q_hi, q_lo), jnp.stack([s_hi, s_lo], axis=1)


@jax.jit
def _quant_bf16(wc):
    ones = jnp.ones((wc.shape[0], 1), jnp.float32)
    return (wc.astype(jnp.bfloat16),), ones


@jax.jit
def _quant_bf16x2(wc):
    # lax.reduce_precision, not astype(bf16).astype(f32): under XLA's
    # allow-excess-precision the astype round-trip is elided and the
    # residual becomes zero.  reduce_precision is an
    # explicit rounding the compiler must honor.
    hi_f32 = jax.lax.reduce_precision(wc, exponent_bits=8, mantissa_bits=7)
    hi = hi_f32.astype(jnp.bfloat16)
    lo = (wc - hi_f32).astype(jnp.bfloat16)
    ones = jnp.ones((wc.shape[0], 2), jnp.float32)
    return (hi, lo), ones


@jax.jit
def _quant_f32(wc):
    return (wc,), jnp.ones((wc.shape[0], 1), jnp.float32)


@jax.jit
def _quant_int13(wc):
    # TWO x16 folds summed inside one dot: ~13-bit weights in ONE int8
    # term.  Each fold spans +-(16*127+127) = +-2159, so T = T1 + T2
    # spans +-4318.  Measured error: 2.9e-3 point-source / 2.6e-4
    # noise vs int12's 7e-3 / 5.6e-4 (BENCH.md).
    #
    # Row layout matches the data operand [X12 | X12] (the int12 plane
    # block repeated, ops/gemm.py): term rows are
    # [[hi1],[lo1],[hi2],[lo2]], each over the complex-concatenated 2A
    # rows.
    s = jnp.maximum(
        jnp.max(jnp.abs(wc), axis=(1, 2)) / jnp.float32(4318.0),
        jnp.float32(1e-30),
    )
    sn = s[:, None, None]
    t = jnp.clip(jnp.round(wc / sn), -4318, 4318)
    t1 = jnp.clip(jnp.round(t * 0.5), -2159, 2159)
    t2 = t - t1  # |t2| <= 2159 by construction
    parts = []
    for tk in (t1, t2):
        hi = jnp.clip(jnp.round(tk / 16.0), -127, 127)
        # |lo| <= 8 in the interior, but when hi clips at +-127
        # (|tk| > 2032) lo absorbs the excess up to +-127 — still int8,
        # and 16*hi + lo == tk exactly for the whole +-2159 range.
        lo = tk - 16.0 * hi
        parts += [hi, lo]
    term = jnp.concatenate(parts, axis=1).astype(jnp.int8)
    return (term,), s[:, None]


@jax.jit
def _quant_int12(wc):
    # ONE term [[W_hi], [W_lo]] stacked along K; the kernel's X operand
    # is [16X | X], so the product is 16*(X@W_hi) + X@W_lo = X@(16Whi+Wlo)
    # in units of s — 12-bit effective weights in one int8 term.
    # s = amax/2040 puts round(wc/(16s)) within +-127.5; the clip
    # handles the boundary, after which |wc/s - 16*hi| <= 8 so lo is a
    # genuine 4-bit residual (it rides the int8 operand regardless).
    s = jnp.maximum(
        jnp.max(jnp.abs(wc), axis=(1, 2)) / jnp.float32(2040.0),
        jnp.float32(1e-30),
    )
    sn = s[:, None, None]
    hi = jnp.clip(jnp.round(wc / (16.0 * sn)), -127, 127)
    lo = jnp.clip(jnp.round(wc / sn - 16.0 * hi), -127, 127)
    term = jnp.concatenate([hi, lo], axis=1).astype(jnp.int8)
    return (term,), s[:, None]


_QUANTIZERS = {
    "int13": _quant_int13,
    "int12": _quant_int12,
    "int8": _quant_int8,
    "int8x2": _quant_int8x2,
    "bf16": _quant_bf16,
    "bf16x2": _quant_bf16x2,
    "f32": _quant_f32,
}


def quantize_weights(
    weights: CVec, mode: str = "int8x2", a_compute: int | None = None
) -> QuantWeights:
    """Planar-complex weights ``[F, B, A]`` -> GEMM-ready ``QuantWeights``.

    ``a_compute`` drops zero-padded antennas from the contraction axis
    (pass ``cfg.a_compute``; None keeps all A).  Pure jitted device-side
    transform: calibration/pointing updates flow ``make_weights ->
    quantize_weights`` with no host round-trip (BASELINE north star:
    device-side weight updates).
    """
    try:
        fn = _QUANTIZERS[mode]
    except KeyError:
        raise ValueError(f"unknown weight mode {mode!r}") from None
    terms, scales = fn(cat_weights(weights, a_compute))
    return QuantWeights(terms=tuple(terms), scales=scales)


def prepare_weights(cfg: ObsConfig, weights: CVec) -> QuantWeights:
    """Config-driven quantization: mode and antenna slicing from cfg."""
    return quantize_weights(weights, cfg.weight_mode, cfg.a_compute)


def save_quant_weights(path: str, qw: QuantWeights) -> None:
    """Persist GEMM-ready weights (the analog of the reference's
    pre-generated weight files, SURVEY.md C8)."""
    import numpy as np

    arrays = {f"term{k}": np.asarray(t) for k, t in enumerate(qw.terms)}
    np.savez(path, scales=np.asarray(qw.scales), **arrays)


def load_quant_weights(path: str) -> QuantWeights:
    import numpy as np

    d = np.load(path)
    if "terms" in d:  # round-1 stacked format
        stacked = d["terms"]
        terms = tuple(jnp.asarray(stacked[k]) for k in range(stacked.shape[0]))
    else:
        keys = sorted(k for k in d.files if k.startswith("term"))
        terms = tuple(jnp.asarray(d[k]) for k in keys)
    return QuantWeights(terms=terms, scales=jnp.asarray(d["scales"]))
