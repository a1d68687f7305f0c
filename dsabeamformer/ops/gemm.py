"""Beamforming detection: 4R4I wire block -> beam powers, Stokes, voltages.

The original CUDA pipeline ran three device stages per block (SURVEY.md
L3-L5): ``expand_input`` (4-bit unpack + corner turn),
``cublasCgemmBatched`` (per-channel complex GEMM) and ``detect_sum``
(|B|^2, pol sum, 16x time average).  Here the same arithmetic has two
implementations:

- **the fused kernel** (``_detect_kernel``, Pallas through Triton): one
  program per (beam tile, time tile, channel) unpacks its wire rows,
  runs the int8 GEMM on the tensor cores and keeps the detected,
  time-averaged product in registers, so beam voltages never reach
  device memory.  It covers the int8 weight family
  (``KERNEL_MODES``);
- **the plain form** (``_plain_detect``): ``jnp``/``lax`` left to XLA,
  in channel groups so the int32 beam voltages of a group (not of a
  block: ~69 GB for dsa10) are what is live at once.  It is the
  validation path, the implementation for the float weight modes, and
  what the kernel is timed against.

``IMPL`` picks one per (product, side outputs, weight mode) on the gpu
backend; the cpu backend runs the plain form unless a caller passes
``interpret=True`` to run the kernel in the Pallas interpreter.

Complex arithmetic uses the K-concatenation of ``ops/quantize.py``:
``[Xr | Xi] @ [[Wr, Wi], [-Wi, Wr]] = [Br | Bi]``.  The int8 modes stay
integer until one f32 convert: int32 accumulation is exact (|x| <= 8,
|w| <= 127, K <= 1024, hi<<8 combine => |acc| < 2^27), and
dequantization is one per-channel scalar on the averaged output.

Public API
----------
``beamform_power``    — wire block -> averaged powers (BASELINE configs 2+3).
``beamform_stokes``   — wire block -> averaged [I, Q, U, V].
``beamform_voltages`` — wire block -> beamformed voltages (validation).
"""

from __future__ import annotations

import functools
import itertools
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as pl_triton

from dsabeamformer.config import ObsConfig
from dsabeamformer.ops.quantize import QuantWeights

WEIGHT_MODES = ("int13", "int12", "int8x2", "int8", "bf16", "bf16x2", "f32")
#: Weight modes the fused kernel implements (int8 tensor-core GEMM).
KERNEL_MODES = ("int13", "int12", "int8x2", "int8")
PRODUCTS = ("power", "stokes")
#: Side outputs a detection call can add, in the order they are returned.
SIDE_OUTPUTS = ("incoherent", "quant8", "sk")
_SIDE_SETS = tuple(
    s for n in range(len(SIDE_OUTPUTS) + 1)
    for s in itertools.combinations(SIDE_OUTPUTS, n)
)

#: Implementation of each (product, side outputs, weight mode) on the gpu
#: backend, from the kernel-against-plain timings on the H100 recorded
#: in PERF.md: the fused kernel wins every int8 row, by 2.6x (dsa110
#: power int12) to 39.5x (dsa10c Stokes int8x2) — the plain form writes
#: each channel group's int32 beam voltages to device memory and reads
#: them back — and the float modes have no kernel.
IMPL = {
    (product, sides, mode): "kernel" if mode in KERNEL_MODES else "plain"
    for product in PRODUCTS for sides in _SIDE_SETS for mode in WEIGHT_MODES
}

#: Kernel tiles per product: (output rows per program — time-averaged
#: samples, the M of each tensor-core product; beams per program).
#: Chosen by the H100 sweep in PERF.md; Stokes keeps four accumulators
#: and two polarisations' voltages live, so it takes fewer rows.
_TILES = {"power": (128, 64), "stokes": (64, 32)}
_NUM_WARPS = 4
_NUM_STAGES = 2

#: The plain form processes this many channels per step (the largest
#: divisor of n_chan up to it).
_PLAIN_CHAN_GROUP = 16


def _pow2(n: int) -> bool:
    return n > 0 and n & (n - 1) == 0


def _unpack(xb):
    """uint8 4R4I bytes -> (re, im) int8 in [-8, 7].

    Real in the high nibble, imag in the low (config.py wire format):
    reinterpret as int8, then arithmetic shifts sign-extend each
    nibble."""
    xs = jax.lax.bitcast_convert_type(xb, jnp.int8)
    return xs >> 4, (xs << 4) >> 4


def _rint_clip_u8(v):
    """``clip(rint(v), 0, 255)`` as uint8, from operations Triton lowers
    (it has no rint): clip first (same result), round half up by
    ``floor(v + 0.5)`` (exact on [0, 255.5]), then move exact ties that
    landed on an odd integer down by one — round half to even."""
    v = jnp.minimum(jnp.maximum(v, 0.0), 255.0)
    r = jnp.floor(v + 0.5)
    odd_tie = ((r - v) == 0.5) & (jnp.floor(r * 0.5) * 2.0 != r)
    return jnp.where(odd_tie, r - 1.0, r).astype(jnp.uint8)


def choose_impl(product: str, sides: tuple, cfg: ObsConfig,
                interpret: bool = False, impl: str | None = None) -> str:
    """The implementation a detection call runs: ``"kernel"`` or
    ``"plain"``.

    gpu backend: ``IMPL``'s row, demoted to the plain form when the
    geometry does not tile (``kernel_tiles``).  cpu backend: the plain
    form, or the kernel in the Pallas interpreter when the caller passes
    ``interpret=True``.  Any other backend raises.  ``impl="plain"``
    asks for the plain form anywhere (what the kernel is validated and
    timed against); ``impl="kernel"`` asks for the kernel and raises
    where it cannot run."""
    if impl not in (None, "kernel", "plain"):
        raise ValueError(f"unknown implementation {impl!r}")
    if impl == "plain":
        return "plain"
    backend = jax.default_backend()
    if interpret or impl == "kernel":
        if cfg.weight_mode not in KERNEL_MODES:
            raise ValueError(
                f"the fused kernel implements {KERNEL_MODES}, not "
                f"{cfg.weight_mode!r}")
        if kernel_tiles(cfg, product, interpret=interpret) is None:
            raise ValueError(f"config {cfg.name!r} does not tile the kernel")
        if not interpret and backend != "gpu":
            raise ValueError(
                f"the compiled kernel cannot run on the {backend!r} "
                f"backend (interpret=True runs it in the interpreter)")
        return "kernel"
    if backend == "gpu":
        impl = IMPL[(product, sides, cfg.weight_mode)]
        if impl == "kernel" and kernel_tiles(cfg, product) is None:
            return "plain"
        return impl
    if backend == "cpu":
        return "plain"
    raise RuntimeError(
        f"no beamforming implementation for the {backend!r} backend "
        f"(gpu runs the fused kernel, cpu the plain form)")


def kernel_tiles(cfg: ObsConfig, product: str = "power",
                 interpret: bool = False):
    """``(rows, beam_tile)`` of the fused kernel for ``cfg`` and
    ``product``, or None when the geometry does not tile it.

    Triton blocks are powers of two: the antenna slice ``a_compute``,
    ``navg_time``, the output rows per program and the beam tile.  A
    compiled tensor-core product also needs every dimension >= 16; the
    interpreter does not, which lets the CPU tests run the kernel at
    tiny shapes."""
    a = cfg.a_compute
    n_out = cfg.t_block // cfg.navg_time
    rows = min(_TILES[product][0], n_out)
    bn = min(_TILES[product][1], cfg.n_beams)
    ok = (_pow2(a) and cfg.n_ant % a == 0 and _pow2(cfg.navg_time)
          and _pow2(rows) and n_out % rows == 0
          and _pow2(bn) and cfg.n_beams % bn == 0)
    if ok and not interpret:
        ok = min(a, rows, bn) >= 16
    return (rows, bn) if ok else None


# --------------------------------------------------------------------- #
# Inputs
# --------------------------------------------------------------------- #


def _check_weights(qw: QuantWeights, cfg: ObsConfig) -> None:
    want = (cfg.n_chan, cfg.gemm_k, 2 * cfg.n_beams)
    for term in qw.terms:
        got = tuple(term.shape)
        if got != want:
            raise ValueError(
                f"quantized weight term shaped {got} does not match config "
                f"{cfg.name!r} (expected [F,K,2B] = {want} for mode "
                f"{cfg.weight_mode!r} / a_compute={cfg.a_compute}); "
                f"regenerate with prepare_weights(cfg, make_weights(cfg))"
            )
    if qw.scales.shape != (cfg.n_chan, len(qw.terms)):
        raise ValueError(
            f"weight scales shaped {tuple(qw.scales.shape)} do not match "
            f"[F, n_terms] = {(cfg.n_chan, len(qw.terms))}"
        )


def _wire_4d(wire: jax.Array, cfg: ObsConfig) -> jax.Array:
    """Wire block (canonical device form or 4-D host form) -> the 4-D
    ``cfg.wire_block_shape`` view, a free reshape of the same bytes."""
    if wire.dtype != jnp.uint8:
        raise ValueError(f"wire must be uint8 4R4I bytes, got {wire.dtype}")
    if wire.shape not in (cfg.device_wire_shape, cfg.wire_block_shape):
        raise ValueError(
            f"wire shape {wire.shape} is neither the canonical device form "
            f"{cfg.device_wire_shape} nor the 4-D host form "
            f"{cfg.wire_block_shape} for layout {cfg.input_layout!r}"
        )
    return wire.reshape(cfg.wire_block_shape)


def device_wire_view(wire, cfg: ObsConfig):
    """Host-side 4-D capture block -> the canonical device form (a free
    reshape view; ``device_put`` this, not the 4-D array)."""
    arr = np.asarray(wire)
    if arr.shape != cfg.wire_block_shape:
        raise ValueError(
            f"wire shape {arr.shape} != host form {cfg.wire_block_shape}"
        )
    return arr.reshape(cfg.device_wire_shape)


class _Plan(NamedTuple):
    """Static description of one detection call."""

    product: str          # "power" | "stokes"
    mode: str             # weight mode
    a: int                # a_compute
    navg: int             # navg_time
    n_terms: int
    incoherent: bool
    n_active: int
    flagged: tuple
    quant8: bool
    quant8_offset: float
    sk: bool

    @property
    def x16(self) -> bool:
        return self.mode in ("int12", "int13")

    @property
    def k_blocks(self) -> int:
        """2a-row K blocks per weight term (ObsConfig.gemm_k / 2a)."""
        return {"int12": 2, "int13": 4}.get(self.mode, 1)


# --------------------------------------------------------------------- #
# Fused kernel (Pallas, Triton route)
# --------------------------------------------------------------------- #


def _kernel_weights(qw: QuantWeights, cfg: ObsConfig, bn: int):
    """Weight terms -> the kernel's operand ``[F, B/bn, 2a, N]`` int8.

    Per beam tile, one matrix for a single tensor-core product per
    polarisation and step:

    - rows interleaved ``(re_0, im_0, re_1, im_1, ...)`` to match the
      data operand, which interleaves each antenna's two nibbles (a
      ``join``, where ``[re | im]`` would need a concatenate the
      Triton route does not have);
    - columns: every (term, 2a-row K block) side by side, each as
      ``[Re beams | Im beams]`` of the tile — ``N = n_blocks * 2 * bn``
      — so int8x2's two terms and the int12/int13 hi/lo folds are one
      wide product instead of many narrow ones.

    A pass over the weights (0.1-0.5 GB) per call; the kernel reads
    each tile once per program."""
    f, a, b = cfg.n_chan, cfg.a_compute, cfg.n_beams
    nb = b // bn
    blocks = [
        term.reshape(f, term.shape[1] // (2 * a), 2, a, 2, nb, bn)
        for term in qw.terms
    ]   # [F, kblock, re/im row, antenna, Re/Im col, beam tile, bn]
    w = jnp.stack(blocks, axis=1)
    w = w.transpose(0, 6, 4, 3, 1, 2, 5, 7)
    # [F, beam tile, antenna, re/im row, term, kblock, Re/Im col, bn]
    return w.reshape(f, nb, 2 * a, -1)


def _kernel_beams(x, w, plan: _Plan):
    """``(Br, Bi)`` float32 ``[rows, bn]`` in quantized units from the
    interleaved data operand ``x [rows, 2a]`` and a weight tile ``w``
    laid out by ``_kernel_weights``.

    One int32 product, split back into its (term, K block, Re/Im)
    column blocks.  int12/int13 hold ``16*hi`` folds along K
    (ops/quantize.py): the even K blocks are hi parts, combined as
    ``(hi << 4) + lo`` — the same integers as the x16 data planes.
    int8x2's terms are spaced by exactly 2^8 and combine as
    ``(M_hi << 8) + M_lo`` before the one f32 convert."""
    n_kb = plan.k_blocks
    parts = jnp.split(jnp.dot(x, w, preferred_element_type=jnp.int32),
                      plan.n_terms * n_kb * 2, axis=1)
    out = []
    for half in range(2):
        m = None
        for t in range(plan.n_terms):
            hi = lo = None
            for k in range(n_kb):
                part = parts[(t * n_kb + k) * 2 + half]
                if plan.x16 and k % 2 == 0:
                    hi = part if hi is None else hi + part
                else:
                    lo = part if lo is None else lo + part
            term = lo if hi is None else (hi << 4) + lo
            m = term if m is None else (m << 8) + term
        out.append(m.astype(jnp.float32))
    return out


def _detect_kernel(x_ref, *refs, plan: _Plan):
    """One (beam tile, time tile, channel) program.

    ``x_ref`` is the channel's ``[rows*navg, P, a]`` wire bytes, ``w_ref``
    its ``[2a, N]`` weight tile (``_kernel_weights``).  Step ``j`` of the
    loop takes rows ``j, j+navg, j+2*navg, ...`` (a strided load), so
    each step yields one sample of every ``navg``-average and the time
    average is a running sum in registers — no reshape, no cross-row
    reduction.  Both polarisations of the same rows are in the program,
    as Stokes needs.

    Side outputs reuse the unpacked planes: the incoherent sum over
    active, unflagged antennas, and per-antenna spectral-kurtosis
    partials S1 = sum p, S2 = sum p^2 of ``p = re^2 + im^2`` over the
    tile (int32, exact), summed over tiles by the caller.  Only the
    programs of beam tile 0 store them."""
    w_ref, dq_ref, *rest = refs
    q_ref = rest.pop(0) if plan.quant8 else None
    o_ref = rest.pop(0)
    i_ref = rest.pop(0) if plan.incoherent else None
    sk_ref = rest.pop(0) if plan.sk else None
    navg, a = plan.navg, plan.a
    rows = x_ref.shape[0] // navg
    bn = w_ref.shape[1] // (2 * plan.n_terms * plan.k_blocks)
    n_acc = 1 if plan.product == "power" else 4
    keep = None
    if plan.incoherent:
        ant = jax.lax.broadcasted_iota(jnp.int32, (rows, a), 1)
        keep = ant < plan.n_active
        for fa in plan.flagged:
            keep = keep & (ant != fa)

    w = w_ref[...]      # loaded once, reused by every step

    def step(j, carry):
        acc, inco, s1, s2 = carry
        beams = []
        for p in range(2):
            re, im = _unpack(x_ref[pl.ds(j, rows, stride=navg), p, :])
            # (re_0, im_0, re_1, im_1, ...): the rows of w.
            x = jnp.concatenate([re[:, :, None], im[:, :, None]], axis=2)
            beams.append(_kernel_beams(x.reshape(rows, 2 * a), w, plan))
            if plan.incoherent or plan.sk:
                r32 = re.astype(jnp.int32)
                i32 = im.astype(jnp.int32)
                pw = r32 * r32 + i32 * i32                  # [rows, a]
                if plan.incoherent:
                    inco = inco + jnp.sum(jnp.where(keep, pw, 0), axis=1,
                                          dtype=jnp.int32)
                if plan.sk:
                    s1 = s1 + jnp.sum(pw, axis=0, dtype=jnp.int32)
                    s2 = s2 + jnp.sum(pw * pw, axis=0, dtype=jnp.int32)
        (bxr, bxi), (byr, byi) = beams
        px = bxr * bxr + bxi * bxi
        py = byr * byr + byi * byi
        if plan.product == "power":
            acc = (acc[0] + (px + py),)
        else:
            cr = bxr * byr + bxi * byi          # Re(Bx By*)
            ci = bxi * byr - bxr * byi          # Im(Bx By*)
            acc = (acc[0] + (px + py), acc[1] + (px - py),
                   acc[2] + (cr + cr), acc[3] + (ci + ci))
        return acc, inco, s1, s2

    zeros_i = functools.partial(jnp.zeros, dtype=jnp.int32)
    init = (
        tuple(jnp.zeros((rows, bn), jnp.float32) for _ in range(n_acc)),
        zeros_i((rows,)) if plan.incoherent else None,
        zeros_i((a,)) if plan.sk else None,
        zeros_i((a,)) if plan.sk else None,
    )
    acc, inco, s1, s2 = jax.lax.fori_loop(0, navg, step, init)

    # Deferred dequantization: every product is quadratic in the same
    # quantized units, so one per-channel s^2 dequantizes them all.
    dq = dq_ref[...]
    for k, v in enumerate(acc):
        v = v * dq
        if plan.quant8:
            # Parenthesized to round exactly like the two-pass path
            # (f32 product stored, then times the beam scale).
            v = v * q_ref[...]
            if k and plan.quant8_offset:
                # Stokes Q/U/V ride the unsigned payload at the file
                # format's midpoint (ingest/sigproc.py STOKES_QUV_OFFSET).
                v = v + jnp.float32(plan.quant8_offset)
            v = _rint_clip_u8(v)
        if plan.product == "power":
            o_ref[...] = v
        else:
            o_ref[:, k, :] = v

    if plan.incoherent or plan.sk:
        @pl.when(pl.program_id(0) == 0)
        def _side():
            if plan.incoherent:
                i_ref[...] = inco.astype(jnp.float32)
            if plan.sk:
                sk_ref[0, :] = s1
                sk_ref[1, :] = s2


def _kernel_detect(x4, qw: QuantWeights, cfg: ObsConfig, plan: _Plan,
                   quant8_scales, interpret: bool):
    """Launch the fused kernel.  Returns ``(out, inco | None, sk_parts |
    None)`` with ``out`` ``[F, T/navg, B]`` (power) or
    ``[F, T/navg, 4, B]`` (Stokes), ``inco`` ``[F, T/navg]`` f32 and
    ``sk_parts`` ``[F, time tiles, 2, a]`` int32."""
    rows, bn = kernel_tiles(cfg, plan.product, interpret=interpret)
    f, t, b, a = cfg.n_chan, cfg.t_block, cfg.n_beams, cfg.a_compute
    tt = rows * cfg.navg_time
    nb, nt = b // bn, t // tt
    # Grid (beam tile, time tile, channel), beam tile fastest: the
    # programs sharing one wire tile run together and hit it in L2, and
    # a channel's weights stay in L2 across its time tiles.
    grid = (nb, nt, f)
    if cfg.input_layout == "tfpa":
        x_spec = pl.BlockSpec((tt, None, 2, a), lambda bi, ti, c: (ti, c, 0, 0))
    else:
        x_spec = pl.BlockSpec((None, tt, 2, a), lambda bi, ti, c: (c, ti, 0, 0))
    w = _kernel_weights(qw, cfg, bn)
    in_specs = [
        x_spec,
        pl.BlockSpec((None, None, 2 * a, w.shape[-1]),
                     lambda bi, ti, c: (c, bi, 0, 0)),
    ]
    operands = [x4, w]
    s = qw.scales[:, -1].astype(jnp.float32)
    in_specs.append(pl.BlockSpec((None,), lambda bi, ti, c: (c,)))
    operands.append(s * s)
    if plan.quant8:
        in_specs.append(pl.BlockSpec((bn,), lambda bi, ti, c: (bi,)))
        operands.append(quant8_scales.astype(jnp.float32))
    out_dtype = jnp.uint8 if plan.quant8 else jnp.float32
    if plan.product == "power":
        out_shape = [jax.ShapeDtypeStruct((f, t // cfg.navg_time, b), out_dtype)]
        out_specs = [pl.BlockSpec((None, rows, bn),
                                  lambda bi, ti, c: (c, ti, bi))]
    else:
        out_shape = [jax.ShapeDtypeStruct((f, t // cfg.navg_time, 4, b),
                                          out_dtype)]
        out_specs = [pl.BlockSpec((None, rows, 4, bn),
                                  lambda bi, ti, c: (c, ti, 0, bi))]
    if plan.incoherent:
        out_shape.append(jax.ShapeDtypeStruct((f, t // cfg.navg_time),
                                              jnp.float32))
        out_specs.append(pl.BlockSpec((None, rows), lambda bi, ti, c: (c, ti)))
    if plan.sk:
        out_shape.append(jax.ShapeDtypeStruct((f, nt, 2, a), jnp.int32))
        out_specs.append(pl.BlockSpec((None, None, 2, a),
                                      lambda bi, ti, c: (c, ti, 0, 0)))
    res = list(pl.pallas_call(
        functools.partial(_detect_kernel, plan=plan),
        grid=grid,
        in_specs=in_specs,
        out_specs=out_specs,
        out_shape=out_shape,
        compiler_params=pl_triton.CompilerParams(
            num_warps=_NUM_WARPS, num_stages=_NUM_STAGES),
        backend="triton",
        interpret=interpret,
        name=f"dsabf_detect_{plan.product}",
    )(*operands))
    out = res.pop(0)
    inco = res.pop(0) if plan.incoherent else None
    sk = res.pop(0) if plan.sk else None
    return out, inco, sk


# --------------------------------------------------------------------- #
# Plain form (jnp / lax, compiled by XLA)
# --------------------------------------------------------------------- #


def _plain_chan_group(n_chan: int) -> int:
    g = _PLAIN_CHAN_GROUP
    while n_chan % g:
        g //= 2
    return g


def _plain_groups(x4, qw: QuantWeights, cfg: ObsConfig):
    """Wire and weights regrouped for ``lax.map``: wire ``[F/g, g, P, T,
    a]`` uint8 (the corner turn, one XLA transpose) and each term
    ``[F/g, g, K, 2B]``."""
    x = x4[..., :cfg.a_compute]
    x = x.transpose(1, 2, 0, 3) if cfg.input_layout == "tfpa" \
        else x.transpose(0, 2, 1, 3)                   # [F, P, T, a]
    g = _plain_chan_group(cfg.n_chan)
    regroup = lambda v: v.reshape(cfg.n_chan // g, g, *v.shape[1:])
    return regroup(x), tuple(regroup(w) for w in qw.terms), regroup


def _plain_beams(xg, terms, mode: str):
    """Beam product of a channel group: ``[g, P, T, a]`` wire bytes ->
    ``[g, P, T, 2B]`` in quantized units (int32 for the int8 modes,
    f32 for the float modes) — the K-concatenated operand
    ``[re | im]`` (x16 modes: ``[16re | 16im | re | im]``, int13
    twice) against each term, combined as in the kernel."""
    re, im = _unpack(xg)
    planes = [re, im]
    if mode in ("int12", "int13"):
        planes = [re << 4, im << 4, re, im]
        if mode == "int13":
            planes = planes + planes
    x = jnp.concatenate(planes, axis=-1)               # [g, P, T, K]
    acc = None
    for w in terms:
        if w.dtype == jnp.int8:
            part = jnp.einsum("gptk,gkn->gptn", x, w,
                              preferred_element_type=jnp.int32)
            acc = part if acc is None else (acc << 8) + part
        else:
            # f32 is the validation mode: HIGHEST keeps the GPU out of
            # TF32, whose 10-bit mantissa would fail the accuracy bar.
            prec = (jax.lax.Precision.HIGHEST if w.dtype == jnp.float32
                    else jax.lax.Precision.DEFAULT)
            part = jnp.einsum("gptk,gkn->gptn", x.astype(w.dtype), w,
                              preferred_element_type=jnp.float32,
                              precision=prec)
            acc = part if acc is None else acc + part
    return acc.astype(jnp.float32)


def _time_avg(v, navg: int):
    """Sum ``navg`` consecutive samples of axis 1 (``[g, T, ...]``)."""
    g, t = v.shape[:2]
    return v.reshape(g, t // navg, navg, *v.shape[2:]).sum(axis=2)


def _plain_detect(x4, qw: QuantWeights, cfg: ObsConfig, plan: _Plan,
                  quant8_scales):
    """The plain form of ``_kernel_detect``: same outputs, except SK as
    ``[F, 2]`` float32 totals (the kernel's are per-tile int32)."""
    xs, terms, regroup = _plain_groups(x4, qw, cfg)
    s = qw.scales[:, -1].astype(jnp.float32)
    dq = regroup(s * s)
    b = cfg.n_beams
    keep = np.zeros(cfg.a_compute, np.int32)
    keep[:plan.n_active] = 1
    keep[list(plan.flagged)] = 0
    q = None if quant8_scales is None else quant8_scales.astype(jnp.float32)

    def group(args):
        xg, tg, dqg = args
        acc = _plain_beams(xg, tg, plan.mode)          # [g, P, T, 2B]
        bxr, bxi = acc[:, 0, :, :b], acc[:, 0, :, b:]
        byr, byi = acc[:, 1, :, :b], acc[:, 1, :, b:]
        px = bxr * bxr + bxi * bxi
        py = byr * byr + byi * byi
        if plan.product == "power":
            planes = [px + py]
        else:
            cr = bxr * byr + bxi * byi
            ci = bxi * byr - bxr * byi
            planes = [px + py, px - py, cr + cr, ci + ci]
        outs = []
        for k, v in enumerate(planes):
            v = _time_avg(v, plan.navg) * dqg[:, None, None]
            if q is not None:
                v = v * q
                if k and plan.quant8_offset:
                    v = v + jnp.float32(plan.quant8_offset)
                v = jnp.clip(jnp.rint(v), 0.0, 255.0).astype(jnp.uint8)
            outs.append(v)
        out = outs[0] if plan.product == "power" else jnp.stack(outs, axis=2)
        res = [out]
        if plan.incoherent or plan.sk:
            re, im = _unpack(xg)
            r32 = re.astype(jnp.int32)
            i32 = im.astype(jnp.int32)
            pw = r32 * r32 + i32 * i32                 # [g, P, T, a]
        if plan.incoherent:
            inco = (pw * keep).sum(axis=(1, 3), dtype=jnp.int32)
            res.append(_time_avg(inco, plan.navg).astype(jnp.float32))
        if plan.sk:
            pf = pw[..., :plan.n_active].astype(jnp.float32)
            res.append(jnp.stack([pf.sum(axis=(1, 2, 3)),
                                  (pf * pf).sum(axis=(1, 2, 3))], axis=1))
        return tuple(res)

    res = jax.lax.map(group, (xs, terms, dq))
    res = [r.reshape(cfg.n_chan, *r.shape[2:]) for r in res]
    out = res.pop(0)
    inco = res.pop(0) if plan.incoherent else None
    sk = res.pop(0) if plan.sk else None
    return out, inco, sk


# --------------------------------------------------------------------- #
# Public entry points
# --------------------------------------------------------------------- #


def _detect(product, wire, qw, cfg, interpret, impl, incoherent, flag_ants,
            quant8_scales, sk_stats, quant8_offset=0.0):
    if quant8_scales is not None and cfg.navg_freq != 1:
        raise ValueError(
            f"quant8_scales requires navg_freq=1 (got {cfg.navg_freq}): "
            f"in-epilogue quantization must be the LAST averaging step; "
            f"use FilterbankSink.device_post for navg_freq > 1")
    if quant8_scales is not None and quant8_scales.shape != (cfg.n_beams,):
        raise ValueError(
            f"quant8_scales must be [n_beams]={cfg.n_beams}, "
            f"got {quant8_scales.shape}")
    _check_weights(qw, cfg)
    if flag_ants and (min(flag_ants) < 0
                      or max(flag_ants) >= cfg.n_ant_active):
        raise ValueError(
            f"flag_ants {sorted(flag_ants)} out of range "
            f"[0, n_ant_active={cfg.n_ant_active})")
    if (incoherent or sk_stats) and cfg.n_ant_active > cfg.a_compute:
        raise ValueError(
            f"incoherent/SK side outputs need n_ant_active="
            f"{cfg.n_ant_active} <= a_compute={cfg.a_compute}")
    x4 = _wire_4d(wire, cfg)
    sides = tuple(name for name, on in zip(
        SIDE_OUTPUTS, (incoherent, quant8_scales is not None, sk_stats)) if on)
    plan = _Plan(
        product=product, mode=cfg.weight_mode, a=cfg.a_compute,
        navg=cfg.navg_time, n_terms=len(qw.terms),
        incoherent=incoherent, n_active=cfg.n_ant_active,
        flagged=tuple(sorted(flag_ants)) if incoherent else (),
        quant8=quant8_scales is not None, quant8_offset=quant8_offset,
        sk=sk_stats)
    if choose_impl(product, sides, cfg, interpret, impl) == "kernel":
        out, inco, sk = _kernel_detect(x4, qw, cfg, plan, quant8_scales,
                                       interpret)
        if sk is not None:
            # Per-tile, per-antenna int32 partials -> [n_chan, 2] over
            # the active antennas (float32, like sk_block_stats).
            sk = sk[..., :cfg.n_ant_active].astype(jnp.float32).sum(
                axis=(1, 3))
    else:
        out, inco, sk = _plain_detect(x4, qw, cfg, plan, quant8_scales)
    if cfg.navg_freq > 1:
        nf = cfg.navg_freq
        out = out.reshape(cfg.n_chan // nf, nf, *out.shape[1:]).sum(axis=1)
        if inco is not None:
            inco = inco.reshape(cfg.n_chan // nf, nf, -1).sum(axis=1)
    parts = [p for p in (out, inco, sk) if p is not None]
    return tuple(parts) if len(parts) > 1 else out


@functools.partial(jax.jit, static_argnames=("cfg", "interpret", "impl",
                                             "incoherent", "flag_ants",
                                             "sk_stats"))
def beamform_power(
    wire: jax.Array,
    qw: QuantWeights,
    cfg: ObsConfig,
    interpret: bool = False,
    incoherent: bool = False,
    flag_ants: tuple = (),
    quant8_scales: jax.Array | None = None,
    sk_stats: bool = False,
    impl: str | None = None,
) -> jax.Array:
    """4R4I wire block -> averaged beam powers.

    Returns float32 ``[F/navg_freq, T/navg_time, B]`` (sum over
    navg_time samples, both pols, and navg_freq adjacent channels —
    matching ``ops.reference.beamform_block_ref``).

    ``incoherent=True`` additionally returns the incoherent-sum total
    power ``[F/navg_freq, T/navg_time]`` (semantics of
    ``ops.incoherent.incoherent_power``) from the same pass over the
    wire bytes.  ``flag_ants`` (static tuple of raw antenna indices)
    excludes bad antennas from the incoherent sum; the coherent product
    is flagged on the weight side instead
    (``models.weights.flag_antennas``), so the tuple only matters with
    ``incoherent=True``.

    ``quant8_scales`` (``[n_beams]`` float32, counts-per-unit-power)
    quantizes the power product to uint8
    ``clip(rint(p * scale_b), 0, 255)`` in the epilogue — byte-identical
    to quantizing the f32 output after the fact, without the f32
    product's round trip through device memory (the fil sink's output
    path; see ``FilterbankSink.fused_quant8_scales``).  Requires
    ``navg_freq == 1``; the incoherent side output stays float32.

    ``sk_stats=True`` appends the per-RAW-channel spectral-kurtosis
    accumulators ``[n_chan, 2]`` (S1, S2 — the semantics of
    ``ops.incoherent.sk_block_stats``) as the LAST output, from the same
    pass over the wire bytes.

    ``interpret=True`` runs the fused kernel in the Pallas interpreter
    (CPU tests of the kernel); otherwise ``choose_impl`` decides, or
    ``impl`` names the implementation.
    """
    return _detect("power", wire, qw, cfg, interpret, impl, incoherent,
                   flag_ants, quant8_scales, sk_stats)


@functools.partial(jax.jit, static_argnames=("cfg", "interpret", "impl",
                                             "incoherent", "flag_ants",
                                             "sk_stats"))
def beamform_stokes(
    wire: jax.Array,
    qw: QuantWeights,
    cfg: ObsConfig,
    interpret: bool = False,
    incoherent: bool = False,
    flag_ants: tuple = (),
    quant8_scales: jax.Array | None = None,
    sk_stats: bool = False,
    impl: str | None = None,
) -> jax.Array:
    """Full-Stokes detection: wire block -> averaged Stokes spectra.

    Returns float32 ``[F/navg_freq, T/navg_time, 4, B]`` with the Stokes
    axis ordered ``[I, Q, U, V]`` for the linear-feed convention

        I = |Bx|^2 + |By|^2        Q = |Bx|^2 - |By|^2
        U = 2 Re(Bx conj(By))      V = 2 Im(Bx conj(By))

    (x = pol 0, y = pol 1 of the wire block).  ``[..., 0, :]`` equals
    ``beamform_power``'s output.  No reference counterpart (the CUDA
    pipeline detects Stokes I only — SURVEY.md L5).

    ``quant8_scales`` (``[n_beams]`` float32) quantizes in the epilogue:
    uint8 ``[F, T/navg, 4, B]`` with ``counts = x*scale_b + offset``
    where offset is 0 for I and ``STOKES_QUV_OFFSET`` (=128, the
    signed-plane midpoint) for Q/U/V — byte-identical to the two-pass
    ``FilterbankSink.device_post`` quantizer.  Requires
    ``navg_freq == 1``.  The other options are ``beamform_power``'s.
    """
    # The midpoint-offset constant lives with the file format it
    # serves; the lazy import keeps ops free of any ingest dependency
    # at module load (sigproc itself only imports config).
    from dsabeamformer.ingest.sigproc import STOKES_QUV_OFFSET

    return _detect("stokes", wire, qw, cfg, interpret, impl, incoherent,
                   flag_ants, quant8_scales, sk_stats,
                   quant8_offset=STOKES_QUV_OFFSET)


@functools.partial(jax.jit, static_argnames=("cfg",))
def beamform_voltages(
    wire: jax.Array,
    qw: QuantWeights,
    cfg: ObsConfig,
) -> jax.Array:
    """Unfused tail: wire block -> beamformed voltages.

    Returns float32 ``[F, T, P, 2B]`` where ``[..., :B]`` is Re and
    ``[..., B:]`` is Im.  Device-memory heavy by design — this is the
    validation path the detection products are checked against
    (BASELINE config 3) and the parity point for config 2.  Plain form
    only, in channel groups.
    """
    _check_weights(qw, cfg)
    xs, terms, regroup = _plain_groups(_wire_4d(wire, cfg), qw, cfg)
    s = regroup(qw.scales[:, -1].astype(jnp.float32))

    def group(args):
        xg, tg, sg = args
        acc = _plain_beams(xg, tg, cfg.weight_mode) * sg[:, None, None, None]
        return acc.transpose(0, 2, 1, 3)              # [g, T, P, 2B]

    out = jax.lax.map(group, (xs, terms, s))
    return out.reshape(cfg.n_chan, *out.shape[2:])


def voltages_to_complex(bv):
    """[F, T, P, 2B] float32 -> [F, T, P, B] complex (test helper).

    NumPy in, NumPy out; a device array is converted with
    ``jax.lax.complex``."""
    b = bv.shape[-1] // 2
    if isinstance(bv, np.ndarray):
        return bv[..., :b] + 1j * bv[..., b:]
    return jax.lax.complex(bv[..., :b], bv[..., b:])
