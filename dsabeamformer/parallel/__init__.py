"""Multi-device scale-out.

Two axes, composable on a 2-D ``(chan, ant)`` mesh:

- **Channel sharding** (sharding.py) — the reference scaled out by
  running one independent process per GPU on a disjoint 256-channel
  subband, with no inter-GPU communication at all (SURVEY.md §2
  "multi-device scale-out").  Here it is first-class: `shard_map` over
  a device mesh with the frequency-channel axis sharded, so the
  per-channel GEMMs stay embarrassingly parallel and the main path
  needs ZERO cross-device collectives; the interconnect is exercised
  only by the optional band-total-power monitor (a psum) and the
  network only by multi-host ingest fan-out.
- **Antenna (tensor-parallel) sharding** (tensor.py) — the K-split
  contraction with one ``psum`` of partial beam voltages before
  detection, for DSA-2000-class arrays whose per-channel GEMM outgrows
  a single device.  No reference counterpart (10 dishes never needed
  it); tested against the golden model on CPU meshes.
"""

from dsabeamformer.parallel.sharding import (
    make_mesh,
    shard_weights,
    sharded_beamformer,
    sharded_wire_sharding,
)
from dsabeamformer.parallel.tensor import (
    make_tp_mesh,
    shard_weights_tp,
    tp_beamformer,
    tp_wire_sharding,
)

__all__ = [
    "make_mesh",
    "shard_weights",
    "sharded_beamformer",
    "sharded_wire_sharding",
    "make_tp_mesh",
    "shard_weights_tp",
    "tp_beamformer",
    "tp_wire_sharding",
]
