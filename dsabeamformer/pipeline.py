"""Streaming driver: the per-block hot loop (SURVEY.md §3.2, C1/C4/C9).

Reference behavior: ``main()`` reads fixed-size blocks from the PSRDADA
ring, uploads async on rotating CUDA streams so block *n+1* transfers
while block *n* computes, runs unpack -> GEMM -> detect, and copies the
averaged powers out to the downstream consumer.

Here JAX dispatch is already asynchronous — the driver keeps a bounded
queue of in-flight blocks (`depth` plays the role of the CUDA stream
count), so ``device_put`` (H2D copy) and the detection kernel for block
*n+1* overlap with block *n*'s compute,
and the only synchronization is draining the oldest in-flight block
(the reference's event-wait).  Weight/calibration updates swap in a new
``QuantWeights`` between blocks without stalling the stream (the
executable is already compiled; SURVEY.md §3.3).

Sources and sinks mirror the reference's I/O surfaces: a dsaring
shared-memory ring (PSRDADA analog), a raw block file (the DEBUG
file-input build), or a synthetic generator (test mode).
"""

from __future__ import annotations

import collections
import time
from pathlib import Path
from typing import Callable, List, Optional, Tuple

import jax
import numpy as np

from dsabeamformer.config import ObsConfig
from dsabeamformer.ingest import dada
from dsabeamformer.ingest.ring import RingBuffer
from dsabeamformer.ops.gemm import beamform_power, beamform_stokes
from dsabeamformer.ops.quantize import QuantWeights
from dsabeamformer.utils.metrics import BlockStats, StreamStats

Block = Tuple[int, np.ndarray]


# --------------------------------------------------------------------- #
# Sources
# --------------------------------------------------------------------- #

def staging_pool_size(wire_block_bytes: int, depth: int) -> int:
    """Host staging-buffer count for a RingSource at pipeline depth
    ``depth``: the driver needs depth+2 (in-flight + being-enqueued +
    one safety slot); small-block configs (< 512 MiB wire blocks,
    where host RAM is not a constraint) keep an 8-buffer floor that
    absorbs consumer stalls of several block periods.  The single
    sizing rule shared by `dsabf run` and `dsabf info` — keep the two
    in lockstep."""
    if wire_block_bytes >= 512 * 2**20:
        return depth + 2
    return max(depth + 2, 8)


class RingSource:
    """Blocks from a dsaring shared-memory ring (the PSRDADA client).

    ``latest=True`` applies the skip-ahead overrun policy (SURVEY.md §5).
    Validates the stream header against the config on attach.
    """

    def __init__(self, cfg: ObsConfig, ring: RingBuffer, *,
                 latest: bool = False, timeout_s: float = 5.0,
                 validate: bool = True, n_host_buffers: int = 8):
        self.cfg = cfg
        self.ring = ring
        self.latest = latest
        self.timeout_s = timeout_s
        if validate:
            dada.validate_header(cfg, ring.read_header(timeout_s=timeout_s))
        # Round-robin host staging pool (the pinned-buffer rotation of the
        # reference's multi-stream pipeline): ``device_put`` is async and
        # on some backends aliases host memory, so a block's staging
        # buffer must not be overwritten while it may still be in flight.
        # Pool size must exceed the driver's in-flight depth + 1;
        # StreamingBeamformer.run() enforces this via ``n_host_buffers``.
        self._pool = [
            np.empty(cfg.wire_block_bytes, dtype=np.uint8)
            for _ in range(n_host_buffers)
        ]
        self._pool_i = 0

    @property
    def n_host_buffers(self) -> int:
        return len(self._pool)

    def read_block(self) -> Optional[Block]:
        buf = self._pool[self._pool_i]
        self._pool_i = (self._pool_i + 1) % len(self._pool)
        got = self.ring.read_block(buf, timeout_s=self.timeout_s,
                                   latest=self.latest)
        if got is None:
            return None
        seq, flat = got
        return seq, flat.reshape(self.cfg.wire_block_shape)

    @property
    def dropped(self) -> int:
        return self.ring.dropped

    @property
    def skipped(self) -> int:
        return self.ring.skipped


class SyntheticSource:
    """Cycles pre-generated wire blocks, optionally paced to a target
    real-time factor (test/benchmark mode; the reference's generated-
    input DEBUG build)."""

    def __init__(self, cfg: ObsConfig, blocks: List[np.ndarray],
                 n_blocks: int, rate_factor: Optional[float] = None):
        self.cfg = cfg
        self.blocks = blocks
        self.n_blocks = n_blocks
        self.rate_factor = rate_factor
        self._i = 0
        self._t0 = None
        self.dropped = 0
        self.skipped = 0

    def read_block(self) -> Optional[Block]:
        if self._i >= self.n_blocks:
            return None
        if self.rate_factor:
            if self._t0 is None:
                self._t0 = time.perf_counter()
            due = self._i * self.cfg.block_duration_s / self.rate_factor
            now = time.perf_counter() - self._t0
            if now < due:
                time.sleep(due - now)
        blk = self.blocks[self._i % len(self.blocks)]
        seq = self._i
        self._i += 1
        return seq, blk


class FileSource:
    """Raw concatenated wire blocks from a file (the reference's DEBUG
    file-input mode, SURVEY.md §4).  ``offset`` skips a leading header
    block (e.g. a PSRDADA file's HDR_SIZE bytes — see ingest/dada.py
    ``read_dada_file`` / ``open_dada_file``)."""

    def __init__(self, cfg: ObsConfig, path: str | Path, offset: int = 0):
        self.cfg = cfg
        self._f = open(path, "rb")
        if offset:
            self._f.seek(offset)
        self._seq = 0
        self.dropped = 0
        self.skipped = 0

    def read_block(self) -> Optional[Block]:
        data = self._f.read(self.cfg.wire_block_bytes)
        if len(data) < self.cfg.wire_block_bytes:
            self._f.close()
            return None
        blk = np.frombuffer(data, dtype=np.uint8).reshape(
            self.cfg.wire_block_shape
        )
        seq = self._seq
        self._seq += 1
        return seq, blk


# --------------------------------------------------------------------- #
# Sinks (downstream hand-off, SURVEY.md C9/L7)
# --------------------------------------------------------------------- #

class CollectSink:
    """Keeps fetched power blocks in memory (tests / small runs)."""

    def __init__(self):
        self.outputs: List[Tuple[int, np.ndarray]] = []

    def write(self, seq: int, powers: np.ndarray) -> None:
        self.outputs.append((seq, powers))

    def close(self) -> None:
        pass


class FileSink:
    """Appends float32 power blocks to a raw file.

    With a config and a ``.dada`` path, a DADA-style header block is
    written first (PAYLOAD=BEAM_POWERS + output geometry) so downstream
    PSRDADA tooling can parse the product — the file analog of
    RingSink's output stream header."""

    def __init__(self, path: str | Path, cfg: Optional[ObsConfig] = None,
                 products: str = "power", extra_header=None):
        self._f = open(path, "wb")
        if cfg is not None and str(path).endswith(".dada"):
            f_out, t_out, b_out = cfg.out_block_shape
            payload = {"power": "BEAM_POWERS",
                       "stokes": "BEAM_STOKES_IQUV",
                       "incoherent": "INCOHERENT_POWER"}[products]
            extra = {"OUT_NSTOKES": 4} if products == "stokes" else {}
            if products != "incoherent":
                # The incoherent product has no beam axis ([F', T']).
                extra["OUT_NBEAM"] = b_out
            extra.update(extra_header or {})
            text = dada.encode_header(
                cfg,
                HDR_SIZE=dada.DADA_HDR_SIZE,
                PAYLOAD=payload,
                OUT_DTYPE="float32",
                OUT_NCHAN=f_out,
                OUT_NTIME=t_out,
                **extra,
            ).encode("ascii")
            self._f.write(text.ljust(dada.DADA_HDR_SIZE, b"\0"))

    def write(self, seq: int, powers: np.ndarray) -> None:
        self._f.write(np.ascontiguousarray(powers, dtype=np.float32).tobytes())

    def close(self):
        self._f.close()


class RingSink:
    """Writes power blocks into an output dsaring for the downstream
    consumer (the FRB-search hand-off, SURVEY.md L7).

    Commits a stream header describing the power format (the output
    DADA header analog) when given the config."""

    def __init__(self, ring: RingBuffer, cfg: Optional[ObsConfig] = None,
                 products: str = "power", extra_header=None):
        self.ring = ring
        if cfg is not None:
            f, t, b = cfg.out_block_shape
            extra = {"OUT_NSTOKES": 4} if products == "stokes" else {}
            extra.update(extra_header or {})
            self.ring.write_header(dada.encode_header(
                cfg,
                PAYLOAD=("BEAM_STOKES_IQUV" if products == "stokes"
                         else "BEAM_POWERS"),
                OUT_DTYPE="float32",
                OUT_NCHAN=f,
                OUT_NTIME=t,
                OUT_NBEAM=b,
                **extra,
            ))

    def write(self, seq: int, powers: np.ndarray) -> None:
        self.ring.write_block(np.ascontiguousarray(powers, dtype=np.float32))

    @property
    def dropped(self) -> int:
        """Product blocks the ring discarded because the downstream
        consumer was absent or too slow (writer never blocks)."""
        return self.ring.dropped

    def close(self) -> None:
        """Mark end-of-data for the downstream consumer, then detach.
        Safe on every exit path (idempotent at the C layer)."""
        self.ring.set_eod()
        self.ring.close()


# --------------------------------------------------------------------- #
# Driver
# --------------------------------------------------------------------- #

class StreamingBeamformer:
    """The per-block streaming loop.

    depth = number of blocks allowed in flight (H2D + kernel + D2H
    overlap), the analog of the reference's CUDA stream count.
    """

    def __init__(
        self,
        cfg: ObsConfig,
        weights: QuantWeights,
        source,
        sink=None,
        *,
        depth: int = 2,
        on_block: Optional[Callable[[BlockStats], None]] = None,
        tracker=None,
        products: str = "power",
        incoherent_sink=None,
        flag_ants: tuple = (),
    ):
        if products not in ("power", "stokes"):
            raise ValueError(f"products must be power|stokes, got {products!r}")
        self.cfg = cfg
        self.weights = weights
        self.source = source
        self.sink = sink
        self.depth = depth
        self.on_block = on_block
        # Detection product: "power" (Stokes I, the reference path) or
        # "stokes" (fused I/Q/U/V — [F, T/navg, 4, B] blocks to the sink).
        self.products = products
        self._detect = beamform_stokes if products == "stokes" else beamform_power
        # Optional side-channel: incoherent-sum total power per block
        # ([F/navg_freq, T/navg_time] float32 ->
        # incoherent_sink.write(seq, arr)).
        self.incoherent_sink = incoherent_sink
        # Bad antennas excluded from the incoherent sum (the coherent
        # products flag on the weight side — models.weights.flag_antennas
        # is applied before quantization, so `weights` already reflects
        # the flags there).
        self.flag_ants = tuple(sorted(flag_ants))
        # Optional fringe/cal tracker (models/tracking.py): polled once
        # per block with the stream time; a non-None return swaps in new
        # weights for subsequent blocks without stalling.
        self.tracker = tracker
        # Optional streaming RFI monitor (ops/rfi.py): observed at
        # dispatch, polled at drain; its on_event callback typically
        # regenerates weights and calls update_weights.
        self.rfi_monitor = None
        # Optional streaming single-pulse search (ops/dedisperse.py
        # SearchMonitor): fed each drained product block, flushed at
        # end of stream.
        self.search_monitor = None
        self._inflight: collections.deque = collections.deque()
        self._block_idx = 0
        self._stream_t = 0.0
        self._stats: Optional[StreamStats] = None

    def _check_staging_pool(self) -> None:
        """A source staging buffer must never be recycled while its
        async ``device_put`` may still be in flight: the pool has to
        hold every in-flight block (depth) plus the one being enqueued
        and one safety slot."""
        pool_n = getattr(self.source, "n_host_buffers", None)
        if pool_n is not None and self.depth + 2 > pool_n:
            raise ValueError(
                f"depth={self.depth} requires at least depth+2="
                f"{self.depth + 2} host staging buffers, but the source "
                f"has only {pool_n}; raise RingSource(n_host_buffers=...) "
                f"or lower --depth"
            )

    def _step(self, wire_dev, quant8_scales=None, sk_stats=None):
        """One block's device dispatch ->
        ``(detect_out, inco_or_None, sk_or_None)``.

        With an incoherent sink, both products come from ONE fused
        kernel call (power or Stokes — the wire bytes are read from
        device memory once, where the standalone product is a second
        pass).

        ``quant8_scales`` fuses the sink's 8-bit quantization into the
        kernel epilogue (power and Stokes) — ``detect_out`` comes back
        uint8 and the f32 product never touches device memory.

        With an RFI monitor attached, the kernel additionally emits
        the per-channel SK accumulators (``sk_stats=True``) so the
        monitor costs no second HBM pass over the wire bytes; the
        return becomes ``(detect_out, inco_or_None, sk_or_None)``.
        ``sk_stats`` overrides that default per block: the emission is
        not free, so the run loop passes the monitor's sampling-grid
        answer and unsampled blocks run the variant without it."""
        kw = {} if quant8_scales is None else {"quant8_scales": quant8_scales}
        sk_on = (self.rfi_monitor is not None) if sk_stats is None \
            else sk_stats
        if sk_on:
            kw["sk_stats"] = True
        if self.incoherent_sink is not None:
            res = self._detect(wire_dev, self.weights, self.cfg,
                               incoherent=True, flag_ants=self.flag_ants,
                               **kw)
            if sk_on:
                out, inco, sk = res
            else:
                (out, inco), sk = res, None
        elif sk_on:
            (out, sk), inco = self._detect(wire_dev, self.weights, self.cfg,
                                           **kw), None
        else:
            out, inco, sk = self._detect(
                wire_dev, self.weights, self.cfg, **kw), None, None
        return out, inco, sk

    def _fused_quant8(self):
        """The sink's in-kernel quantization hook, when usable:
        navg_freq=1 (the kernel's quantize-last rule) + a sink that
        offers per-beam scales.  Covers both products — power quantizes
        ``p*scale_b``; Stokes additionally offsets the signed Q/U/V
        planes to the file format's midpoint (``beamform_stokes``
        ``quant8_scales``).  Returns a nullary callable yielding the
        current device scale vector (None until the sink's
        auto-calibration has seen a float block) or None if the fused
        path does not apply — the ``device_post`` two-pass path then
        covers it."""
        if self.cfg.navg_freq != 1:
            return None
        if getattr(self.sink, "nbits", None) != 8:
            # 32-bit sinks offer the hook too (it returns None forever);
            # gating here keeps warmup() from compiling a uint8 kernel
            # variant that would never run.
            return None
        return getattr(self.sink, "fused_quant8_scales", None)

    def current_stats(self) -> StreamStats:
        """Stats for the in-progress (or completed) run, wall-clocked
        from the loop start — safe to call from an interrupt handler."""
        if self._stats is None:
            self._stats = StreamStats(cfg_name=self.cfg.name)
        self._stats.dropped = getattr(self.source, "dropped", 0)
        self._stats.skipped = getattr(self.source, "skipped", 0)
        return self._stats.finish()

    def _put(self, wire_np: np.ndarray):
        """H2D placement of one wire block in the canonical device form
        (async).  The mesh driver overrides this with a channel-sharded
        ``device_put`` — everything else in the loop is placement-
        agnostic."""
        return jax.device_put(wire_np.reshape(self.cfg.device_wire_shape))

    def _fetch(self, out) -> np.ndarray:
        """D2H of one drained product.  Hook: the multihost driver
        fetches only its process's addressable subband shards (a full
        ``np.asarray`` of a non-fully-addressable global array would
        raise)."""
        return np.asarray(out)

    def _zero_block(self) -> np.ndarray:
        """A zero wire block shaped like what this driver's source
        yields (hook: the multihost driver's sources yield per-host
        subband blocks, not the full band)."""
        return np.zeros(self.cfg.device_wire_shape, dtype=np.uint8)

    def warmup(self) -> None:
        """Compile the block step before attaching to a live stream (a
        cold compile would otherwise stall the first blocks and overrun
        the ring)."""
        zero_dev = self._put(self._zero_block())
        out, inco, sk = self._step(zero_dev)
        self._fetch(out)  # full round trip
        if inco is not None:
            self._fetch(inco)
        if sk is not None:
            # The SK accumulators ride the same kernel (sk_stats=True)
            # — compiled by the _step above; just complete the fetch.
            self._fetch(sk)
        # With --rfi-sample N>1 the steady state alternates between the
        # SK and the plain kernel variant (run() gates the emission on
        # the monitor's sampling grid) — compile the plain one too.
        sk_sampling = (self.rfi_monitor is not None
                       and getattr(self.rfi_monitor, "sample", 1) > 1)
        if sk_sampling:
            self._fetch(self._step(zero_dev, sk_stats=False)[0])
        if self._fused_quant8() is not None:
            # The steady-state step is the fused uint8 variant (its
            # scales only exist after the first live block) — compile
            # it now with dummy scales so block 1 doesn't stall.
            ones = jax.device_put(np.ones(self.cfg.n_beams, np.float32))
            out_q, inco_q, sk_q = self._step(zero_dev, ones)
            self._fetch(out_q)
            if inco_q is not None:
                self._fetch(inco_q)
            if sk_sampling:
                self._fetch(self._step(zero_dev, ones, sk_stats=False)[0])
            return
        # Compile the sink's device-side post-transform (e.g. the
        # FilterbankSink 8-bit quantizer) at its runtime shapes too —
        # a first-live-block compile would stall the stream.
        post = getattr(self.sink, "device_post", None)
        if post is not None:
            np.asarray(post(out, warmup=True))

    def update_weights(self, weights: QuantWeights) -> None:
        """Swap in new (already-quantized) weights for subsequent blocks
        — the asynchronous calibration/pointing update path (SURVEY.md
        §3.3) with no stream stall."""
        self.weights = weights

    def _post_drain(self, seq: int, out, arr) -> None:
        """Hook after a block's products are drained (mesh driver's
        band-power hand-off)."""

    def _drain_one(self) -> None:
        seq, out, inco, t_enq = self._inflight.popleft()
        inco_np = self._fetch(inco) if inco is not None else None
        if inco_np is not None:
            self.incoherent_sink.write(seq, inco_np)
        sm = self.search_monitor
        if self.sink is not None or (sm is not None and sm.wants_beams):
            arr = self._fetch(out)  # D2H of the averaged powers
            if self.sink is not None:
                self.sink.write(seq, arr)
        else:
            jax.block_until_ready(out)
            arr = None
        if sm is not None:
            # Live single-pulse search over the drained product
            # (ops/dedisperse.py); host+device cost is bounded by the
            # monitor's chunking.
            sm.observe(seq, arr, inco_np)
        self._post_drain(seq, out, arr)
        wall = time.perf_counter() - t_enq
        bs = BlockStats(
            block_idx=self._block_idx,
            seq=seq,
            wall_s=wall,
            bytes_in=self.cfg.wire_block_bytes,
            dropped=getattr(self.source, "dropped", 0),
            skipped=getattr(self.source, "skipped", 0),
        )
        self._block_idx += 1
        if self.rfi_monitor is not None:
            # Fetch only stats for blocks already drained: touching a
            # just-dispatched block's stats would block on the whole
            # device queue and serialize the depth-pipelining.
            self.rfi_monitor.poll(self._block_idx)
        if self.on_block is not None:
            self.on_block(bs)

    def run(self, max_blocks: Optional[int] = None) -> StreamStats:
        cfg = self.cfg
        self._check_staging_pool()
        self._stats = stats = StreamStats(cfg_name=cfg.name)
        # Device-side product transform offered by the sink (e.g.
        # 8-bit quantization so D2H moves 1 byte/sample, not 4).
        post = getattr(self.sink, "device_post", None)
        # In-kernel variant of the same: once the sink's per-beam
        # scales exist, the kernel epilogue quantizes and device_post
        # is bypassed entirely (the f32 product never touches HBM).
        fused_q8 = self._fused_quant8()
        n = 0
        while max_blocks is None or n < max_blocks:
            item = self.source.read_block()
            if item is None:
                break
            seq, wire_np = item
            if self.tracker is not None:
                new_qw = self.tracker.maybe_update(seq * cfg.block_duration_s)
                if new_qw is not None:
                    # Through update_weights so the mesh driver re-shards
                    # tracker-produced tables before the swap-in.
                    self.update_weights(new_qw)
            # Canonical device form (free view of the staging buffer):
            # uploads with the kernel's exact layout, no on-device copy.
            wire_dev = self._put(wire_np)               # H2D (async)
            q8 = fused_q8() if fused_q8 is not None else None
            mon = self.rfi_monitor
            # Emit the SK accumulators only on the monitor's sampling
            # grid: --rfi-sample N cuts the emission's kernel cost to
            # 1/N.
            sk_want = mon is not None and mon.wants_stats()
            out, inco, sk = self._step(
                wire_dev, q8, sk_stats=sk_want)         # async dispatch
            if mon is not None:
                # The monitor fetches sampled stats at drain and may
                # excise channels through update_weights mid-stream
                # (ops/rfi.py); no second HBM pass over the wire bytes.
                mon.observe_stats(sk)
            if q8 is None and post is not None:
                out = post(out)
            self._inflight.append((seq, out, inco, time.perf_counter()))
            stats.n_blocks += 1
            stats.bytes_in += cfg.wire_block_bytes
            n += 1
            while len(self._inflight) > self.depth:
                self._drain_one()
            if fused_q8 is not None and q8 is None:
                # Auto-cal scales are learned at drain time (the sink
                # sees the f32 block in write()).  Drain synchronously
                # until they exist so the fused uint8 kernel engages at
                # block 1, not block depth+1 — a one-time startup
                # stall, after which the pipeline refills.
                while self._inflight and fused_q8() is None:
                    self._drain_one()
        while self._inflight:
            self._drain_one()
        if self.rfi_monitor is not None:
            self.rfi_monitor.flush()
        if self.search_monitor is not None:
            self.search_monitor.flush()
        stats.dropped = getattr(self.source, "dropped", 0)
        stats.skipped = getattr(self.source, "skipped", 0)
        return stats.finish()


class MeshStreamingBeamformer(StreamingBeamformer):
    """Streams blocks through the channel-sharded multi-chip step
    (BASELINE configs 4x5 composed: the streaming driver's pipelining
    with `parallel/sharding.py`'s shard_map execution).

    Per block: the wire bytes upload with `sharded_wire_sharding` (each
    device receives exactly its own contiguous subband — the analog of
    the reference's per-GPU capture split), the shard_map step runs the
    identical single-device detection kernel on every shard, and the
    drain assembles the channel-sharded product
    for the sink (per-shard D2H; the host sees the full-band block).
    Mid-stream weight updates (tracker or explicit `update_weights`)
    re-shard the fresh table and swap with zero stream stall — the
    sharded executable is already compiled.

    Every single-device fused epilogue rides along — the channel split
    leaves them shared-nothing (`parallel.sharding.sharded_beamformer`):
    the fused incoherent side product, the fused SK accumulators for
    the streaming RFI monitor (whose excisions re-shard through
    `update_weights`), the fused uint8 filterbank quantization, the
    search monitor (host-side, on the drained product), and the
    optional band-total-power psum (`with_band_power=True` +
    `on_band_power(seq, band)`) — the one deliberate collective.
    """

    def __init__(
        self,
        cfg: ObsConfig,
        weights: QuantWeights,
        source,
        sink=None,
        *,
        mesh,
        depth: int = 2,
        on_block: Optional[Callable[[BlockStats], None]] = None,
        tracker=None,
        products: str = "power",
        incoherent_sink=None,
        flag_ants: tuple = (),
        with_band_power: bool = False,
        on_band_power: Optional[Callable[[int, np.ndarray], None]] = None,
    ):
        from dsabeamformer.parallel.sharding import sharded_wire_sharding

        super().__init__(cfg, weights, source, sink, depth=depth,
                         on_block=on_block, tracker=tracker,
                         products=products, incoherent_sink=incoherent_sink,
                         flag_ants=flag_ants)
        self.mesh = mesh
        self.with_band_power = with_band_power
        self.on_band_power = on_band_power
        self._wire_sharding = sharded_wire_sharding(cfg, mesh)
        # Mesh steps are built lazily per monitor combination: the RFI
        # monitor is attached AFTER construction (the CLI pattern), and
        # each (incoherent, sk, quant8) combination is a distinct
        # shard_map signature.  jax.jit caches the compiled executable,
        # this dict caches the wrapper.
        self._mesh_steps: dict = {}
        self.weights = self._place(weights)
        # In-flight band-power device arrays, FIFO — drains happen in
        # dispatch order (the inflight deque pops left), so position
        # alone pairs each band with its block.
        self._pending_band: collections.deque = collections.deque()

    def _put(self, wire_np: np.ndarray):
        return jax.device_put(
            wire_np.reshape(self.cfg.device_wire_shape), self._wire_sharding
        )

    def _place(self, qw: QuantWeights) -> QuantWeights:
        """Channel-shard a weight table across the mesh.  Hook: the
        multihost driver assembles each process's subband slice instead
        (``device_put`` of a host-local full table cannot place onto a
        multi-process sharding)."""
        from dsabeamformer.parallel.sharding import place_weights

        return place_weights(qw, self.mesh)

    def _fused_quant8(self):
        if self.with_band_power:
            # Band power over quantized uint8 counts would be scale-
            # distorted; the sink's device_post path covers 8-bit output.
            return None
        return super()._fused_quant8()

    def _get_step(self, inco: bool, sk: bool, q8: bool):
        key = (inco, sk, q8)
        step = self._mesh_steps.get(key)
        if step is None:
            from dsabeamformer.parallel.sharding import (
                sharded_beamformer,
            )

            step = self._mesh_steps[key] = sharded_beamformer(
                self.cfg, self.mesh, products=self.products,
                incoherent=inco, flag_ants=self.flag_ants, sk_stats=sk,
                fused_quant8=q8, with_band_power=self.with_band_power,
            )
        return step

    def _step(self, wire_dev, quant8_scales=None, sk_stats=None):
        inco_on = self.incoherent_sink is not None
        sk_on = (self.rfi_monitor is not None) if sk_stats is None \
            else sk_stats
        q8 = quant8_scales is not None
        step = self._get_step(inco_on, sk_on, q8)
        args = (wire_dev, self.weights) + (
            (quant8_scales,) if q8 else ())
        res = step(*args)
        outs = list(res) if isinstance(res, tuple) else [res]
        if self.with_band_power:
            self._pending_band.append(outs.pop())
        out = outs[0]
        inco = outs[1] if inco_on else None
        sk = outs[1 + inco_on] if sk_on else None
        return out, inco, sk

    def warmup(self) -> None:
        super().warmup()
        # The warmup dispatch is discarded, never drained — drop its
        # band so the FIFO pairing starts clean at block 0.
        self._pending_band.clear()

    def _post_drain(self, seq: int, out, arr) -> None:
        if not self._pending_band:
            return
        band = self._pending_band.popleft()
        if self.on_band_power is not None:
            self.on_band_power(seq, np.asarray(band))

    def update_weights(self, weights: QuantWeights) -> None:
        self.weights = self._place(weights)


def run_stream(
    cfg: ObsConfig,
    weights: QuantWeights,
    source,
    sink=None,
    *,
    depth: int = 2,
    max_blocks: Optional[int] = None,
    on_block: Optional[Callable[[BlockStats], None]] = None,
) -> StreamStats:
    return StreamingBeamformer(
        cfg, weights, source, sink, depth=depth, on_block=on_block
    ).run(max_blocks)
