"""Antenna (tensor-parallel) scale-out: K-split beamforming with a
``psum`` — the second parallelism axis, for DSA-2000-class arrays.

The channel axis (parallel/sharding.py) is the reference's shared-
nothing scale-out (SURVEY.md §2: one GPU per subband, zero inter-device
traffic) and remains the right first axis.  It stops being sufficient
when a SINGLE channel's GEMM outgrows one device: at DSA-2000 scale
(~2000 dishes -> K = 2*2048 = 4096 per weight term) the weight working
set alone is ~n_chan * 4096 * 2B bytes per term.  The answer is the
classic tensor-parallel contraction split, expressed with
``shard_map`` + ``jax.lax.psum`` over the device interconnect:

    B[f] = sum_g  X_g[f] @ W_g[f]          (g = antenna shard)

Each device beamforms only its antenna group's voltages against its K-row
slice of the weights, then one ``psum`` over the ``"ant"`` mesh axis
reduces the partial beam *voltages* — the reduction MUST happen before
detection because |.|^2 is nonlinear.  Detection + averaging then run
replicated (they are ~1/16th of the FLOPs).  This is the one pattern
where beamformed voltages cross devices; per block the all-reduce moves
``F_local * T * P * 2B * 4`` bytes, which is what NVLink between the
cards of one host is for (not the network between hosts).

Composes with channel sharding on a 2-D ``("chan", "ant")`` mesh: the
channel axis stays collective-free, the antenna axis carries the psum.
Quantization scales are computed from the FULL per-channel weight
matrix before slicing, so every shard's integers share one scale and
the psum of dequantized partials is exact (tested to the golden model).

No reference counterpart (the reference never needed TP at 10 dishes);
capability is forward-looking but tested: 8-virtual-device CPU meshes,
1-D antenna and 2-D chan x ant, vs the float64 golden model.
"""

from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from dsabeamformer.config import ObsConfig
from dsabeamformer.models.arrays import ArrayLayout, array_for
from dsabeamformer.models.calibration import CalTable
from dsabeamformer.models.weights import make_weights
from dsabeamformer.ops.cplx import CVec
from dsabeamformer.ops.gemm import beamform_voltages
from dsabeamformer.ops.quantize import QuantWeights, quantize_weights

CHAN_AXIS = "chan"
ANT_AXIS = "ant"


def make_tp_mesh(n_chan_shards: int, n_ant_shards: int) -> Mesh:
    """2-D ``(chan, ant)`` mesh over the first nc*na devices (1-D
    antenna mesh = ``make_tp_mesh(1, na)``)."""
    need = n_chan_shards * n_ant_shards
    devs = jax.devices()
    if need > len(devs):
        raise ValueError(f"requested {need} devices, have {len(devs)}")
    grid = np.asarray(devs[:need]).reshape(n_chan_shards, n_ant_shards)
    return Mesh(grid, (CHAN_AXIS, ANT_AXIS))


def _check_tp(cfg: ObsConfig, nc: int, na: int) -> None:
    if cfg.n_chan % nc:
        raise ValueError(f"n_chan={cfg.n_chan} not divisible by {nc}")
    if cfg.n_ant % na:
        raise ValueError(f"n_ant={cfg.n_ant} not divisible by {na}")
    if (cfg.n_ant // na) % 8:
        raise ValueError("per-shard antennas must be a multiple of 8")
    if cfg.weight_mode not in ("f32", "bf16", "bf16x2", "int8x2"):
        raise ValueError(
            "antenna sharding supports weight_mode f32|bf16|bf16x2|int8x2 "
            "— modes whose terms keep the plain [re | im] K layout and "
            "whose per-channel scales are independent of which K rows a "
            "shard keeps (bf16-family scales are constant 1; int8x2 "
            "scales are computed from the FULL weight table before "
            "slicing, see shard_weights_tp).  int8 is excluded because "
            "its single-term accuracy already fails the 1e-3 bar; "
            "int12/int13 are excluded because their x16 K-folds "
            "restructure the contraction axis itself (hi/lo row blocks "
            "matched to a folded data operand with per-channel amax over "
            "full K), so an antenna split of K would cut across fold "
            "blocks and desynchronize the data-side fold"
        )


def _local_cfg(cfg: ObsConfig, nc: int, na: int) -> ObsConfig:
    a_local = cfg.n_ant // na
    return cfg.replace(
        n_chan=cfg.n_chan // nc,
        n_ant=a_local,
        # Every local antenna row participates (activity masking already
        # happened when the full weight table was built and sliced).
        n_ant_active=a_local,
        n_ant_compute=a_local,
    )


def shard_weights_tp(
    cfg: ObsConfig,
    mesh: Mesh,
    layout: Optional[ArrayLayout] = None,
    cal: Optional[CalTable] = None,
    pointing_rad: float = 0.0,
) -> QuantWeights:
    """Quantize with GLOBAL per-channel scales, then antenna-shard.

    The full ``Wc [F, 2A, 2B]`` is quantized once (per-channel amax —
    identical numbers to the single-chip path), and the K rows are
    regrouped per antenna shard as ``[re_g | im_g]`` so each shard's
    slice is exactly ``cat_weights`` of its antenna group.  Terms land
    sharded ``P(chan, ant, None)``.
    """
    nc = mesh.shape[CHAN_AXIS]
    na = mesh.shape[ANT_AXIS]
    _check_tp(cfg, nc, na)
    layout = layout if layout is not None else array_for(cfg)
    cal = cal if cal is not None else CalTable.unity(cfg)
    w: CVec = make_weights(cfg, layout=layout, cal=cal,
                           pointing_rad=pointing_rad)
    # Full-table quantization (a_compute=None keeps every K row): the
    # per-channel scales see the whole weight matrix, identical to the
    # single-chip path, before the rows are regrouped and sharded.
    qw_full = quantize_weights(w, cfg.weight_mode, None)
    terms, scales = qw_full.terms, qw_full.scales
    a = cfg.n_ant
    a_l = a // na
    # Regroup K rows by antenna shard: [re_0..re_A | im_0..im_A] ->
    # [re_g0 im_g0 | re_g1 im_g1 | ...] so an equal split of the K dim
    # IS the per-group cat_weights layout.
    idx = np.concatenate(
        [np.concatenate([np.arange(g * a_l, (g + 1) * a_l),
                         a + np.arange(g * a_l, (g + 1) * a_l)])
         for g in range(na)]
    )
    term_sh = NamedSharding(mesh, P(CHAN_AXIS, ANT_AXIS, None))
    out_terms = tuple(
        jax.device_put(t[:, idx, :], term_sh) for t in terms
    )
    scale_sh = NamedSharding(mesh, P(CHAN_AXIS, None))
    return QuantWeights(terms=out_terms,
                        scales=jax.device_put(scales, scale_sh))


def tp_wire_sharding(cfg: ObsConfig, mesh: Mesh) -> NamedSharding:
    """Sharding for the 4-D host-form wire block ``[.., P, A]``: channel
    and antenna axes split; each capture NIC feeds its own (subband,
    antenna-group) chip."""
    if cfg.input_layout == "ftpa":
        return NamedSharding(mesh, P(CHAN_AXIS, None, None, ANT_AXIS))
    return NamedSharding(mesh, P(None, CHAN_AXIS, None, ANT_AXIS))


def tp_beamformer(cfg: ObsConfig, mesh: Mesh, *, products: str = "power"):
    """Build the jitted antenna-sharded (optionally x channel-sharded)
    block step: ``step(wire, qw) -> powers`` (or Stokes
    ``[F_l, T/navg, 4, B]`` with ``products="stokes"`` — the detection
    runs post-psum either way, so full Stokes is the same reduction).

    wire: 4-D host-form block sharded per ``tp_wire_sharding`` (the
    antenna axis lives inside the canonical device form's fused lanes,
    so TP uses the explicit 4-D layout).  Output powers are channel-
    sharded, replicated over the antenna axis.
    """
    if products not in ("power", "stokes"):
        raise ValueError(f"products must be power|stokes, got {products!r}")
    nc = mesh.shape[CHAN_AXIS]
    na = mesh.shape[ANT_AXIS]
    _check_tp(cfg, nc, na)
    local = _local_cfg(cfg, nc, na)

    wire_spec = (
        P(CHAN_AXIS, None, None, ANT_AXIS)
        if cfg.input_layout == "ftpa"
        else P(None, CHAN_AXIS, None, ANT_AXIS)
    )
    qw_spec = QuantWeights(
        terms=tuple(P(CHAN_AXIS, ANT_AXIS, None)
                    for _ in range(cfg.n_weight_terms)),
        scales=P(CHAN_AXIS, None),
    )

    def local_step(wire, qw):
        # Partial beam voltages from this chip's antenna group, then the
        # ONE collective: sum the partials over the antenna axis.  Must
        # precede |B|^2 (nonlinear).
        bv = beamform_voltages(wire, qw, local)     # [F_l, T, P, 2B] f32
        bv = jax.lax.psum(bv, ANT_AXIS)
        # Replicated detection + averaging (the reference's detect_sum,
        # here ~1/16th of the FLOPs so replication is cheap).
        b = cfg.n_beams
        f_l, t = bv.shape[0], bv.shape[1]
        nt = cfg.navg_time

        def avg(z):  # [F_l, T, B] -> time (+freq) accumulated
            z = z.reshape(f_l, t // nt, nt, b).sum(axis=2)
            if cfg.navg_freq > 1:
                z = z.reshape(f_l // cfg.navg_freq, cfg.navg_freq,
                              t // nt, b).sum(axis=1)
            return z

        bxr, bxi = bv[:, :, 0, :b], bv[:, :, 0, b:]
        byr, byi = bv[:, :, 1, :b], bv[:, :, 1, b:]
        px = bxr * bxr + bxi * bxi
        py = byr * byr + byi * byi
        if products == "power":
            return avg(px + py)
        cr = bxr * byr + bxi * byi
        ci = bxi * byr - bxr * byi
        return jnp.stack(
            [avg(px + py), avg(px - py), avg(cr + cr), avg(ci + ci)],
            axis=2,
        )

    out_spec = (P(CHAN_AXIS, None, None) if products == "power"
                else P(CHAN_AXIS, None, None, None))
    shard_fn = jax.shard_map(
        local_step,
        mesh=mesh,
        in_specs=(wire_spec, qw_spec),
        out_specs=out_spec,
        check_vma=False,
    )
    return jax.jit(shard_fn)
