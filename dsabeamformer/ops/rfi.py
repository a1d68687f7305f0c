"""Streaming RFI monitor: in-band spectral kurtosis with automatic
channel excision (``dsabf run --rfi-auto``).

The offline scan (``dsabf rfi``, `ops/incoherent.py`) tells an
operator what to ``--zap`` before a run; this monitor closes the loop
DURING a run: it samples wire blocks already in device memory, folds
their per-channel SK accumulators into a rolling window, and — when a
channel's SK walks out of the robust cross-channel null — reports it
for excision through the pipeline's asynchronous weight-update path
(SURVEY.md §3.3; the reference has no equivalent — its weights change
only on external cal/pointing updates [K]).

Cost model: the pipeline path gets the SK accumulators FROM the
detection kernel (``beamform_power(sk_stats=True)`` — computed from
the unpacked planes the kernel already holds, no second pass over the
wire bytes), and ``sample=1`` is the CLI default.  The standalone
:meth:`RFIMonitor.observe` path (and ``dsabf rfi``'s offline scan)
pays a separate ``sk_block_stats`` sweep over the wire block; there,
sampling amortizes the cost.  Decisions
are made every ``interval`` OBSERVED blocks on pooled accumulators,
so sparser sampling widens the decision cadence rather than
weakening the statistic.

Excision is sticky (a channel, once zapped, stays zapped for the run
— weight regeneration re-applies the full set) and capped: if the
flagged set would exceed ``max_fraction`` of the band the monitor
reports a ``cap`` event instead of excising, because "most of the
band looks like RFI" means the null is broken (wrong levels, dead
feed), not that the band should be silently deleted.
"""

from __future__ import annotations

from collections import deque
from typing import Callable, Iterable, Optional

import numpy as np

from dsabeamformer.config import ObsConfig
from dsabeamformer.ops.incoherent import (
    sk_block_stats,
    sk_estimate,
    sk_flags,
    sk_samples_per_block,
)

__all__ = ["RFIMonitor"]


class RFIMonitor:
    """Rolling spectral-kurtosis monitor over the streaming wire blocks.

    The pipeline calls :meth:`observe` at dispatch time (the stats
    reduction rides the same async queue as the block's beamform) and
    :meth:`poll` at drain time (fetching a tiny ``[n_chan]`` pair, by
    which point the device work is long done).  ``on_event`` receives
    dicts::

        {"type": "excise", "new": [...], "zapped": [...],
         "sk_median": ..., "sk_sigma": ..., "blocks": N}
        {"type": "cap",    "flagged": [...], "max_channels": ...}

    with channel indices in the config's LOCAL frame (callers owning a
    subband translate, as with ``--zap``).  ``seed_zapped`` pre-loads
    channels already excised at startup so they are not re-reported.
    """

    def __init__(
        self,
        cfg: ObsConfig,
        *,
        interval: int = 8,
        sample: int = 1,
        threshold: float = 5.0,
        max_fraction: float = 0.25,
        on_event: Optional[Callable[[dict], None]] = None,
        seed_zapped: Iterable[int] = (),
    ):
        if interval < 1 or sample < 1:
            raise ValueError(
                f"interval/sample must be >= 1, got {interval}/{sample}")
        if not 0.0 < max_fraction <= 1.0:
            raise ValueError(f"max_fraction must be in (0, 1], "
                             f"got {max_fraction}")
        self.cfg = cfg
        self.interval = interval
        self.sample = sample
        self.threshold = threshold
        self.max_channels = max(1, int(max_fraction * cfg.n_chan))
        self.on_event = on_event
        self.zapped: set = set(int(c) for c in seed_zapped)
        # Emitted events for post-run stats, bounded (a broken null
        # could otherwise emit one event per window for hours).
        self.events: list = []
        self.events_dropped = 0
        self._max_events = 256
        self._seen = 0
        self._pending: deque = deque()  # (dispatch_index, stats)
        self._s1 = np.zeros(cfg.n_chan, np.float64)
        self._s2 = np.zeros(cfg.n_chan, np.float64)
        self._n = 0
        self._final = False
        self._last_cap: Optional[frozenset] = None

    def warmup(self, wire_dev) -> None:
        """Compile the SK reduction before the stream attaches (the
        pipeline calls this from its own warmup) — a first-live-block
        jit compile would stall the ring.  Fetches and discards."""
        st = sk_block_stats(wire_dev, self.cfg)
        np.asarray(st["s1"])
        np.asarray(st["s2"])

    def _take_next(self):
        """One sampling-grid step shared by both observe paths: the
        dispatch index if this block is sampled, else None."""
        take = self._seen % self.sample == 0
        idx = self._seen
        self._seen += 1
        return idx if take else None

    def wants_stats(self) -> bool:
        """True iff the NEXT observe call falls on the sampling grid —
        a peek, no grid advance.  The pipeline asks this BEFORE each
        block's dispatch and only compiles-in the SK accumulators when
        the answer is yes: the fused emission is not free, so with
        ``sample=N`` its kernel cost amortizes to 1/N."""
        return self._seen % self.sample == 0

    def observe(self, wire_dev) -> None:
        """Dispatch the standalone SK reduction for this block if it
        falls on the sampling grid (device-side, async — do not fetch
        here).  This is a second pass over the wire bytes; the
        pipeline prefers :meth:`observe_stats`
        with the detection kernel's fused accumulators."""
        idx = self._take_next()
        if idx is not None:
            self._pending.append((idx, sk_block_stats(wire_dev, self.cfg)))

    def observe_stats(self, sk_dev) -> None:
        """Record the detection kernel's fused SK accumulators
        (``beamform_power(..., sk_stats=True)``'s ``[n_chan, 2]`` last
        output) for this block.  Same sampling grid as :meth:`observe`
        so the two paths are interchangeable block-for-block — though
        here the pipeline consults :meth:`wants_stats` first and skips
        the accumulator emission entirely on unsampled blocks
        (``sk_dev=None``)."""
        idx = self._take_next()
        if idx is not None:
            if sk_dev is None:
                raise ValueError(
                    "observe_stats(None) on a sampled block: the caller "
                    "must dispatch with sk_stats=True whenever "
                    "wants_stats() is True (pipeline/monitor grid skew)")
            self._pending.append((idx, sk_dev))

    def poll(self, n_drained: Optional[int] = None) -> None:
        """Fetch stats for blocks the pipeline has already drained and
        decide when a window is full.  ``n_drained`` gates the fetch:
        only stats whose block (dispatch order) has been drained are
        touched — fetching a just-dispatched block's stats would block
        on the whole device queue and serialize the depth-pipelining.
        ``None`` fetches everything (end of stream)."""
        while self._pending and (
            n_drained is None or self._pending[0][0] < n_drained
        ):
            _, st = self._pending.popleft()
            if isinstance(st, dict):  # standalone sk_block_stats
                s1 = np.asarray(st["s1"], np.float64)
                s2 = np.asarray(st["s2"], np.float64)
            else:  # fused [n_chan, 2] kernel output
                arr = np.asarray(st, np.float64)
                s1, s2 = arr[:, 0], arr[:, 1]
            self._s1 += s1
            self._s2 += s2
            self._n += 1
            if self._n >= self.interval:
                self._decide()

    def flush(self) -> None:
        """End-of-stream: decide on any partial window (>= 2 blocks,
        else the estimator is too noisy to act on).  Events emitted
        here carry ``"final": True`` — there are no further blocks to
        apply an excision to, so callers should log but not act."""
        self._final = True
        self.poll()
        if self._n >= 2:
            self._decide()

    def _decide(self) -> None:
        m = self._n * sk_samples_per_block(self.cfg)
        sk = sk_estimate(self._s1, self._s2, m)
        flagged, med, sigma = sk_flags(sk, m, threshold=self.threshold)
        self._s1[:] = 0.0
        self._s2[:] = 0.0
        blocks, self._n = self._n, 0
        new = sorted(set(flagged) - self.zapped)
        if not new:
            return
        total = self.zapped | set(new)
        if len(total) > self.max_channels:
            # Refuse, but do not re-spam an unchanged refusal every
            # window (a broken null re-flags the same set for hours).
            if self._last_cap != frozenset(new):
                self._last_cap = frozenset(new)
                self._emit({"type": "cap", "flagged": new,
                            "zapped": sorted(self.zapped),
                            "max_channels": self.max_channels})
            return
        self._last_cap = None
        self.zapped = total
        def _fin(v, nd):
            return round(float(v), nd) if np.isfinite(v) else None
        ev = {
            "type": "excise",
            "new": new,
            "zapped": sorted(self.zapped),
            "sk_median": _fin(med, 5),
            "sk_sigma": _fin(sigma, 6),
            "blocks": blocks,
        }
        if self._final:
            ev["final"] = True
        self._emit(ev)

    def _emit(self, event: dict) -> None:
        if len(self.events) < self._max_events:
            self.events.append(event)
        else:
            self.events_dropped += 1
        if self.on_event is not None:
            self.on_event(event)
