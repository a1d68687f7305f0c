"""Per-block metrics, the north-star stats line, and device peaks.

Reference behavior (SURVEY.md §5 observability): verbose builds printed
per-block timings via PSRDADA's multilog.  The rebuild's metric stream
IS the north star (BASELINE.json `metric`): per-block ingest GB/s,
real-time factor vs the stream rate, and dropped-block counters, as
structured records.
"""

from __future__ import annotations

import dataclasses
import json
import time

from dsabeamformer.config import ObsConfig

#: Published dense peaks per card, keyed by ``jax.Device.device_kind``.
#: Source: NVIDIA H100 Tensor Core GPU data sheet (SXM5 and PCIe
#: columns; tensor-core rates without sparsity).  They assume the card's
#: full power limit; a card set lower cannot hold its top clock under
#: load, so a share against them is reported with the power limit.
PEAKS = {
    "NVIDIA H100 80GB HBM3": {          # H100 SXM5, 700 W
        "int8_ops_per_s": 1979e12,
        "bf16_flops_per_s": 989e12,
        "hbm_bytes_per_s": 3.35e12,
    },
    "NVIDIA H100 PCIe": {               # H100 PCIe, 350 W
        "int8_ops_per_s": 1513e12,
        "bf16_flops_per_s": 756e12,
        "hbm_bytes_per_s": 2.0e12,
    },
}


def device_peaks(kind: str | None = None) -> dict:
    """``PEAKS`` row of ``kind`` (default: the first JAX device's
    ``device_kind``).  A device not in the table raises: no assumed
    peak."""
    if kind is None:
        import jax

        kind = jax.devices()[0].device_kind
    try:
        return PEAKS[kind]
    except KeyError:
        raise ValueError(
            f"no published peaks for device kind {kind!r}; add a PEAKS "
            f"row with its data-sheet source") from None


def roofline_share(ops: float, bytes_moved: float, seconds: float,
                   kind: str | None = None, op_key: str = "int8_ops_per_s"
                   ) -> dict:
    """Roofline share of one measured call: the least time the card
    could take — the larger of ``ops`` over the compute peak and
    ``bytes_moved`` over the memory peak — divided by ``seconds``, with
    the bound that sets it (``"compute"`` or ``"memory"``)."""
    peaks = device_peaks(kind)
    t_ops = ops / peaks[op_key]
    t_mem = bytes_moved / peaks["hbm_bytes_per_s"]
    return {"share": max(t_ops, t_mem) / seconds,
            "bound": "compute" if t_ops >= t_mem else "memory"}


@dataclasses.dataclass
class BlockStats:
    """One record per processed block — the structured analog of the
    reference's verbose per-block print line."""

    block_idx: int
    seq: int                 # ring sequence number (== block_idx for file input)
    wall_s: float            # wall time attributed to this block
    bytes_in: int
    dropped: int             # cumulative ring drops at this point
    skipped: int             # cumulative reader skip-aheads

    def line(self, cfg: ObsConfig) -> str:
        gbs = self.bytes_in / self.wall_s / 1e9 if self.wall_s > 0 else 0.0
        rt = cfg.block_duration_s / self.wall_s if self.wall_s > 0 else 0.0
        return (
            f"block {self.block_idx:6d} seq {self.seq:6d} "
            f"{self.wall_s * 1e3:7.2f} ms  {gbs:6.2f} GB/s  {rt:6.2f}x RT  "
            f"dropped {self.dropped}  skipped {self.skipped}"
        )


@dataclasses.dataclass
class StreamStats:
    """Aggregate over a streaming run — the benchmark record."""

    cfg_name: str
    n_blocks: int = 0
    bytes_in: int = 0
    wall_s: float = 0.0
    dropped: int = 0
    skipped: int = 0
    _t_start: float = dataclasses.field(default_factory=time.perf_counter)

    def finish(self) -> "StreamStats":
        self.wall_s = time.perf_counter() - self._t_start
        return self

    @property
    def gb_per_s(self) -> float:
        return self.bytes_in / self.wall_s / 1e9 if self.wall_s else 0.0

    def realtime_factor(self, cfg: ObsConfig) -> float:
        data_s = self.n_blocks * cfg.block_duration_s
        return data_s / self.wall_s if self.wall_s else 0.0

    def record(self, cfg: ObsConfig) -> dict:
        return {
            "config": self.cfg_name,
            "blocks": self.n_blocks,
            "bytes": self.bytes_in,
            "wall_s": round(self.wall_s, 6),
            "gb_per_s": round(self.gb_per_s, 3),
            "realtime_factor": round(self.realtime_factor(cfg), 3),
            "dropped": self.dropped,
            "skipped": self.skipped,
        }

    def json_line(self, cfg: ObsConfig) -> str:
        return json.dumps(self.record(cfg))
