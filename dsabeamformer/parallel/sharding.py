"""Channel-sharded beamforming over a device mesh (BASELINE config 5).

Reference scale-out (SURVEY.md §2): shared-nothing frequency sharding —
one process per GPU per subband, arranged by launch scripts and the
upstream packetizer; "multi-GPU correctness reduces to single-GPU
correctness".  Here the same property is expressed in the sharding
system: `shard_map` over a 1-D ``("chan",)`` mesh runs the *identical*
single-device detection kernel on each device's subband.  The
per-channel math needs no collectives; an optional band-total-power
monitor demonstrates the one legitimate reduction (psum over the
channel axis).

The DSA-110 preset (110 ant -> 128, 512 beams) on four cards of one
host is the acceptance configuration; tests exercise it on 8 virtual
CPU devices.  The mesh is 1-D: the cards of a host are joined all to
all, so the layout follows the channel split alone.
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
from dsabeamformer.ops.gemm import beamform_power
from dsabeamformer.ops.quantize import QuantWeights, quantize_weights

AXIS = "chan"


def make_mesh(n_devices: Optional[int] = None) -> Mesh:
    """1-D channel mesh over the first ``n_devices`` devices.

    Each mesh slot owns a contiguous subband (the analog of the
    reference's per-GPU subband assignment)."""
    devs = jax.devices()
    if n_devices is None:
        n_devices = len(devs)
    if n_devices > len(devs):
        raise ValueError(f"requested {n_devices} devices, have {len(devs)}")
    return Mesh(np.asarray(devs[:n_devices]), (AXIS,))


def _check_divisible(cfg: ObsConfig, n: int) -> None:
    if cfg.n_chan % n:
        raise ValueError(f"n_chan={cfg.n_chan} not divisible by mesh size {n}")
    if (cfg.n_chan // n) % cfg.navg_freq:
        raise ValueError("per-shard channels must be a multiple of navg_freq")


def sharded_wire_sharding(cfg: ObsConfig, mesh: Mesh) -> NamedSharding:
    """Sharding for wire blocks in the canonical device form
    (``cfg.device_wire_shape``): the channel axis is split across chips;
    each host/NIC DMAs its own subband directly to its chip (the
    capture-side split the reference relied on upstream).

    - ftpa ``[F, T, P*A]``: channels are the leading dim.
    - tfpa ``[T, F*P*A]``: channels are channel-major in the fused lane
      dim, so an equal split of dim 1 IS the contiguous subband split.
    """
    if cfg.input_layout == "ftpa":
        return NamedSharding(mesh, P(AXIS, None, None))
    return NamedSharding(mesh, P(None, AXIS))


def place_weights(qw: QuantWeights, mesh: Mesh) -> QuantWeights:
    """Re-place an already-quantized ``QuantWeights`` with the
    channel-sharded layout (terms ``[F, B, K]`` split on F, scales
    ``[F, B]`` split on F).  This is the mid-stream weight-update path
    for the mesh driver: trackers/cal solvers produce ordinary
    QuantWeights; the swap-in re-shards without regeneration."""
    term_sharding = NamedSharding(mesh, P(AXIS, None, None))
    return QuantWeights(
        terms=tuple(jax.device_put(t, term_sharding) for t in qw.terms),
        scales=jax.device_put(qw.scales, NamedSharding(mesh, P(AXIS, None))),
    )


def shard_weights(
    cfg: ObsConfig,
    mesh: Mesh,
    layout: Optional[ArrayLayout] = None,
    cal: Optional[CalTable] = None,
    pointing_rad: float = 0.0,
) -> QuantWeights:
    """Generate + quantize weights with channel-sharded placement.

    Weight generation is elementwise over channels, so jitting it with
    sharded output lets XLA partition the computation — each device
    generates exactly its own subband's weights (device-side calibration
    updates stay local, SURVEY.md §3.3)."""
    layout = layout if layout is not None else array_for(cfg)
    cal = cal if cal is not None else CalTable.unity(cfg)
    qw = quantize_weights(
        make_weights(cfg, layout=layout, cal=cal, pointing_rad=pointing_rad),
        cfg.weight_mode,
        cfg.a_compute,
    )
    return place_weights(qw, mesh)


def sharded_beamformer(cfg: ObsConfig, mesh: Mesh, *,
                       with_band_power: bool = False,
                       products: str = "power",
                       incoherent: bool = False,
                       flag_ants: tuple = (),
                       sk_stats: bool = False,
                       fused_quant8: bool = False):
    """Build the jitted multi-chip block step.

    ``wire`` is the canonical device form (``cfg.device_wire_shape``),
    channel-sharded per ``sharded_wire_sharding``; each shard is its
    subband's own canonical form, so the per-chip kernel runs the
    copy-free path.

    The single-device kernel's fused epilogues all ride along, because
    every one of them is per-channel math the channel split leaves
    shared-nothing (their outputs come back channel-sharded):

    - ``products="stokes"`` — fused I/Q/U/V, ``[F/navg_f, T/navg_t,
      4, B]``.
    - ``incoherent=True`` — the incoherent-sum side product
      ``[F/navg_f, T/navg_t]`` from the same kernel pass
      (``flag_ants`` excludes bad antennas from it, as single-device).
    - ``sk_stats=True`` — the per-raw-channel SK accumulators
      ``[n_chan, 2]`` for the streaming RFI monitor.
    - ``fused_quant8=True`` — the step takes a THIRD argument, the
      replicated ``[n_beams]`` scale vector, and the product comes back
      uint8 (in-epilogue filterbank quantization; for Stokes the Q/U/V
      planes carry the file format's midpoint offset, see
      ``beamform_stokes``).
    - ``with_band_power=True`` — appends the all-band total power
      ``[T/navg_t]``: a psum over the channel axis, the single
      deliberate collective (total-power / RFI monitoring).

    Returns ``step(wire, qw[, quant8_scales]) -> out`` or a tuple
    ``(out[, inco][, sk][, band])`` in that fixed order — the same
    ordering the single-device ``beamform_power`` uses, with ``band``
    appended last."""
    if products not in ("power", "stokes"):
        raise ValueError(f"products must be power|stokes, got {products!r}")
    if fused_quant8 and with_band_power:
        raise ValueError("fused_quant8 + with_band_power: band power "
                         "over quantized uint8 counts would be "
                         "scale-distorted; pick one")
    n = mesh.shape[AXIS]
    _check_divisible(cfg, n)
    local_cfg = cfg.replace(n_chan=cfg.n_chan // n)
    stokes = products == "stokes"
    flag_ants = tuple(sorted(flag_ants))

    wire_spec = (
        P(AXIS, None, None)
        if cfg.input_layout == "ftpa"
        else P(None, AXIS)
    )
    qw_spec = QuantWeights(
        terms=tuple(P(AXIS, None, None) for _ in range(cfg.n_weight_terms)),
        scales=P(AXIS, None),
    )
    in_specs = [wire_spec, qw_spec]
    if fused_quant8:
        in_specs.append(P(None))  # replicated per-beam scale vector

    out_specs = [P(AXIS, None, None, None) if stokes
                 else P(AXIS, None, None)]
    if incoherent:
        out_specs.append(P(AXIS, None))
    if sk_stats:
        out_specs.append(P(AXIS, None))
    if with_band_power:
        out_specs.append(P(None))
    single_out = len(out_specs) == 1

    def local_step(wire, qw, *scales):
        if stokes:
            from dsabeamformer.ops.gemm import beamform_stokes

            kw = {"quant8_scales": scales[0]} if fused_quant8 else {}
            res = beamform_stokes(wire, qw, local_cfg,
                                  incoherent=incoherent,
                                  flag_ants=flag_ants, sk_stats=sk_stats,
                                  **kw)
        else:
            kw = {"quant8_scales": scales[0]} if fused_quant8 else {}
            res = beamform_power(wire, qw, local_cfg,
                                 incoherent=incoherent,
                                 flag_ants=flag_ants, sk_stats=sk_stats,
                                 **kw)
        outs = list(res) if isinstance(res, tuple) else [res]
        if with_band_power:
            main = outs[0]
            plane = main[:, :, 0] if stokes else main
            outs.append(jax.lax.psum(plane.sum(axis=(0, 2)), AXIS))
        return outs[0] if single_out else tuple(outs)

    shard_fn = jax.shard_map(
        local_step,
        mesh=mesh,
        in_specs=tuple(in_specs),
        out_specs=out_specs[0] if single_out else tuple(out_specs),
        # The kernel's pallas_call outputs carry no varying-mesh-axes
        # metadata; the sharding here is the trivially-parallel channel
        # split, so the vma check adds nothing.
        check_vma=False,
    )
    return jax.jit(shard_fn)
