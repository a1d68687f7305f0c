"""Long-soak regression (VERDICT r1 item 10): 10^4 blocks through the
real dsaring + StreamingBeamformer stack under a jittery-rate producer.

Asserts the three steady-state properties the observatory cares about:
zero drops at a sub-realtime sustained rate, strictly monotone block
sequence numbers, and flat host RSS (the bounded in-flight queue +
staging pool must not accumulate).
"""

import os
import threading
import time
import uuid

import numpy as np

from dsabeamformer.ingest import dada
from dsabeamformer.ingest.generator import make_noise_block
from dsabeamformer.ingest.ring import RingBuffer
from dsabeamformer.models.weights import make_weights
from dsabeamformer.ops.quantize import quantize_weights
from dsabeamformer.pipeline import RingSource, StreamingBeamformer

from dsabeamformer.utils.hostenv import process_rss_mb as _rss_mb

N_BLOCKS = int(os.environ.get("DSABF_SOAK_BLOCKS", "10000"))


class _MonotoneSink:
    """Checks seq monotonicity and output sanity without storing blocks
    (storage would itself grow RSS and mask leaks)."""

    def __init__(self):
        self.n = 0
        self.last_seq = -1
        self.ok = True

    def write(self, seq, powers):
        if seq != self.last_seq + 1 or not np.isfinite(powers[0, 0, 0]):
            self.ok = False
        self.last_seq = seq
        self.n += 1


def test_soak_jittery_ring_producer(tiny_cfg):
    cfg = tiny_cfg
    qw = quantize_weights(make_weights(cfg), cfg.weight_mode, cfg.a_compute)
    name = f"soak-{uuid.uuid4().hex[:8]}"
    blocks = [make_noise_block(cfg, seed=s) for s in range(4)]
    rng = np.random.default_rng(7)
    with RingBuffer(name, create=True, nbufs=16,
                    bufsz=cfg.wire_block_bytes) as ring:
        ring.write_header(dada.encode_header(cfg))

        source = RingSource(cfg, RingBuffer(name), timeout_s=10.0)
        sink = _MonotoneSink()
        rss = {}

        def on_block(bs):
            if bs.block_idx == 2000:
                rss["early"] = _rss_mb()

        bf = StreamingBeamformer(cfg, qw, source, sink, depth=2,
                                 on_block=on_block)
        bf.warmup()

        # Calibrate the producer to the consumer's END-TO-END block
        # time measured in situ — ring read + dispatch + sink checksum
        # + stats, not just the kernel (kernel-only calibration
        # under-paces the producer on a loaded 1-core CI host, where
        # the Python per-block overhead dominates; that made this test
        # flake in full-suite runs).  Jittered sleeps averaging ~2.3x
        # the measured cost keep the sustained rate sub-realtime while
        # the 16-slot ring absorbs jitter bursts.
        M = 12
        for i in range(M):
            ring.write_block(blocks[i % 4])
        t0 = time.perf_counter()
        bf.run(max_blocks=M)
        t_block = (time.perf_counter() - t0) / M
        sleeps = rng.uniform(1.2 * t_block, 3.4 * t_block, N_BLOCKS)

        def produce():
            for i in range(N_BLOCKS):
                ring.write_block(blocks[i % 4])
                time.sleep(sleeps[i])
            ring.set_eod()

        t = threading.Thread(target=produce, daemon=True)
        t.start()
        stats = bf.run()
        t.join(timeout=60)

    assert stats.n_blocks == N_BLOCKS, stats.n_blocks
    assert stats.dropped == 0 and stats.skipped == 0
    assert sink.ok and sink.n == M + N_BLOCKS
    assert sink.last_seq == M + N_BLOCKS - 1
    rss_end = _rss_mb()
    if "early" in rss:  # only meaningful on a full-length soak
        growth = rss_end - rss["early"]
        assert growth < 40.0, (
            f"RSS grew {growth:.1f} MB between block 2000 and {N_BLOCKS}"
        )
