"""Compute ops: bit-level packing, golden reference pipeline, weight
quantization, and the fused beamforming kernel."""

from dsabeamformer.ops.packing import (
    pack_4r4i,
    unpack_4r4i,
    unpack_wire_to_complex,
)
from dsabeamformer.ops.reference import (
    average_ref,
    beamform_block_ref,
    beamform_voltages_ref,
    detect_ref,
)
from dsabeamformer.ops.quantize import QuantWeights, quantize_weights
from dsabeamformer.ops.gemm import (
    beamform_power,
    beamform_stokes,
    beamform_voltages,
)
from dsabeamformer.ops.incoherent import incoherent_power

__all__ = [
    "pack_4r4i",
    "unpack_4r4i",
    "unpack_wire_to_complex",
    "beamform_block_ref",
    "beamform_voltages_ref",
    "detect_ref",
    "average_ref",
    "QuantWeights",
    "quantize_weights",
    "beamform_power",
    "beamform_stokes",
    "incoherent_power",
    "beamform_voltages",
]
