"""dsabeamformer — a real-time phased-array voltage beamformer on GPUs.

A ground-up JAX/XLA/Pallas rebuild of the capabilities of the CUDA
DSA-10 beamformer (reference: devincody/DSAbeamformer; see SURVEY.md for
the layer map this framework implements):

- 4-bit packed ("4R4I") voltage ingest with in-kernel unpacking
  (reference: the `expand_input` CUDA kernel, SURVEY.md L3/C5),
- per-frequency-channel complex beamforming GEMM on the int8 tensor
  cores
  (reference: `cublasCgemmBatched` hot loop, SURVEY.md L4/C6),
- fused |B|^2 power detection + time/frequency averaging epilogue
  (reference: `detect_sum` CUDA kernel, SURVEY.md L5/C7),
- jitted device-side steering/fringe/calibration weight generation
  (reference: host-side weight loops, SURVEY.md L6/C8),
- a double-buffered streaming host->device ingest pipeline with a native
  shared-memory ring buffer (reference: PSRDADA + CUDA streams,
  SURVEY.md L1/L2/C3/C4),
- channel-sharded multi-device scale-out via `shard_map` over a mesh
  (reference: one-process-per-GPU subband split, SURVEY.md §2).

Nothing here is a translation of the CUDA code: the hot path is a single
Pallas kernel through Triton (unpack prologue -> K-concatenated int8
complex GEMM -> detection epilogue), and scale-out uses `jax.sharding`
instead of process-level sharding.
"""

from dsabeamformer.config import ObsConfig, DSA10, DSA110, TINY, presets

__version__ = "0.1.0"

__all__ = [
    "ObsConfig",
    "DSA10",
    "DSA110",
    "TINY",
    "presets",
    "make_weights",
    "quantize_weights",
    "beamform_power",
    "beamform_voltages",
    "StreamingBeamformer",
    "run_stream",
    "__version__",
]


def __getattr__(name):
    # Lazy top-level API (keeps `import dsabeamformer` light).
    if name in ("make_weights",):
        from dsabeamformer.models.weights import make_weights

        return make_weights
    if name in ("quantize_weights",):
        from dsabeamformer.ops.quantize import quantize_weights

        return quantize_weights
    if name in ("beamform_power", "beamform_voltages"):
        from dsabeamformer.ops import gemm

        return getattr(gemm, name)
    if name in ("StreamingBeamformer", "run_stream"):
        from dsabeamformer import pipeline

        return getattr(pipeline, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
