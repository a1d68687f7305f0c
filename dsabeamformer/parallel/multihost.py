"""Multi-host deployment helpers (SURVEY.md §5 "distributed backend").

The reference's full-band deployment split the band across GPUs by
having the packet capture fan out disjoint subbands to each process —
there was no inter-process data path beyond that.  The multi-host
deployment keeps the same shape:

- Each **host** runs one capture/ingest process and copies only its
  own subband onto its local cards (neither the network between hosts
  nor the links between cards carry voltage data — channels are
  shared-nothing).
- ``jax.distributed.initialize`` + the global channel mesh make the
  per-host arrays one logical sharded array, so the same
  ``sharded_beamformer`` step runs unchanged.

The subband arithmetic below is plain host logic (unit-tested on CPU);
``initialize_multihost`` is the thin runtime entry used on a real pod.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import jax

from dsabeamformer.config import ObsConfig


@dataclasses.dataclass(frozen=True)
class HostSubband:
    """The contiguous channel range a host ingests and beamforms."""

    host_index: int
    n_hosts: int
    chan_start: int
    n_chan: int

    def config(self, cfg: ObsConfig) -> ObsConfig:
        """Per-host ObsConfig (correct subband frequencies for weight
        generation)."""
        return cfg.subband(self.chan_start, self.n_chan)


def host_subbands(cfg: ObsConfig, n_hosts: int) -> List[HostSubband]:
    """Disjoint contiguous subband per host — the capture fan-out plan
    (the analog of the reference's per-GPU subband assignment)."""
    if cfg.n_chan % n_hosts:
        raise ValueError(f"n_chan={cfg.n_chan} not divisible by {n_hosts} hosts")
    per = cfg.n_chan // n_hosts
    return [
        HostSubband(h, n_hosts, h * per, per) for h in range(n_hosts)
    ]


def my_subband(cfg: ObsConfig) -> HostSubband:
    """This process's subband under jax.distributed."""
    return host_subbands(cfg, jax.process_count())[jax.process_index()]


def _multihost_driver_cls():
    """Lazy import (pipeline pulls the full ops stack; this module's
    subband arithmetic must stay importable standalone)."""
    import numpy as np
    from jax.sharding import NamedSharding, PartitionSpec as P

    from dsabeamformer.ops.quantize import QuantWeights
    from dsabeamformer.parallel.sharding import AXIS
    from dsabeamformer.pipeline import MeshStreamingBeamformer

    class MultihostMeshStreamingBeamformer(MeshStreamingBeamformer):
        """Per-host streaming driver for a multi-process mesh (SURVEY.md
        §5 distributed row's full deployment story).

        Each process of the pod runs ONE of these in lockstep over the
        same block sequence.  Per block, every host's source yields its
        OWN subband's wire bytes (host capture form, shaped by
        ``my_subband(cfg).config(cfg)``); ``_put`` assembles the global
        channel-sharded array with
        ``jax.make_array_from_process_local_data`` (DCN never carries
        voltage data), the shared ``sharded_beamformer`` step runs
        globally, and the drain fetches only this process's addressable
        product shards — each host's sink sees its own subband product
        (the per-subband ``.fil``/DADA products that ``dsabf splice``
        merges, exactly the reference's per-GPU output shape).

        Mid-stream ``update_weights`` re-shards by the same per-process
        slice assembly: every host passes the same full-band table
        (weights are a pure function of config + cal, so each host
        computes it identically) and contributes its subband's channels.

        The RFI monitor is not supported here (it fetches GLOBAL SK
        device arrays); attach per-host monitors to the local products
        instead.  The search monitor works as-is — it consumes the
        drained (local) product."""

        def __init__(self, cfg, weights, source, sink=None, *, mesh,
                     **kwargs):
            self._sub = my_subband(cfg)
            self._sub_cfg = self._sub.config(cfg)
            self._full_cfg = cfg
            super().__init__(cfg, weights, source, sink, mesh=mesh,
                             **kwargs)

        # -- per-host subband ingest -> global sharded array -----------
        def _zero_block(self):
            return np.zeros(self._sub_cfg.device_wire_shape, np.uint8)

        def _put(self, wire_np):
            local = wire_np.reshape(self._sub_cfg.device_wire_shape)
            return jax.make_array_from_process_local_data(
                self._wire_sharding, local,
                global_shape=self._full_cfg.device_wire_shape)

        # -- weight re-shard by per-process slice assembly --------------
        def _place(self, qw):
            sub = self._sub
            sl = slice(sub.chan_start, sub.chan_start + sub.n_chan)
            term_sh = NamedSharding(self.mesh, P(AXIS, None, None))
            f = self._full_cfg.n_chan
            terms = tuple(
                jax.make_array_from_process_local_data(
                    term_sh, np.asarray(t)[sl],
                    global_shape=(f,) + t.shape[1:])
                for t in qw.terms)
            scales = np.asarray(qw.scales)
            return QuantWeights(
                terms=terms,
                scales=jax.make_array_from_process_local_data(
                    NamedSharding(self.mesh, P(AXIS, None)), scales[sl],
                    global_shape=(f,) + scales.shape[1:]),
            )

        # -- drain only this process's shards ---------------------------
        def _fetch(self, out):
            shards = sorted(out.addressable_shards,
                            key=lambda s: s.index[0].start or 0)
            return np.concatenate([np.asarray(s.data) for s in shards],
                                  axis=0)

    return MultihostMeshStreamingBeamformer


def __getattr__(name):
    if name == "MultihostMeshStreamingBeamformer":
        return _multihost_driver_cls()
    raise AttributeError(name)


def initialize_multihost(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
) -> None:
    """Bring up jax.distributed for a multi-host slice.

    Pass the coordinator address (``host:port``), the process count and
    this process's id: nothing in a plain GPU cluster announces them.
    After this, ``parallel.sharding.make_mesh``
    over ``jax.devices()`` spans the full slice and
    ``jax.make_array_from_process_local_data`` assembles each host's
    ingested subband into the global channel-sharded array.
    """
    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=process_id,
    )
