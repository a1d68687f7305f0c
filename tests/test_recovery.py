"""Failure / restart semantics (SURVEY.md §5: stateless restart +
re-attach, dropped-block accounting, skip-ahead catch-up)."""

import threading
import time
import uuid

import numpy as np

from dsabeamformer.ingest import dada
from dsabeamformer.ingest.generator import make_noise_block
from dsabeamformer.ingest.ring import RingBuffer
from dsabeamformer.models.weights import make_weights
from dsabeamformer.ops.quantize import quantize_weights
from dsabeamformer.pipeline import CollectSink, RingSource, run_stream


def test_consumer_restart_reattaches(tiny_cfg):
    """Kill the consumer mid-stream, start a fresh one: it re-attaches,
    re-validates the header, skips to the newest data, and continues —
    the reference's whole failure-recovery story (process restart +
    ring re-attach, losing only the unread blocks)."""
    cfg = tiny_cfg
    name = f"rec-{uuid.uuid4().hex[:8]}"
    qw = quantize_weights(make_weights(cfg), cfg.weight_mode)
    blocks = [make_noise_block(cfg, rms=2.0, seed=s) for s in range(2)]
    n_total = 40
    stop = threading.Event()

    with RingBuffer(name, create=True, nbufs=4,
                    bufsz=cfg.wire_block_bytes) as prod:
        prod.write_header(dada.encode_header(cfg))

        def produce():
            for i in range(n_total):
                while not prod.write_block(blocks[i % 2]):
                    if stop.is_set():
                        return
                    time.sleep(0.001)
            prod.set_eod()

        t = threading.Thread(target=produce)
        t.start()
        try:
            # First consumer: takes a few blocks, then "dies".
            ring1 = RingBuffer(name)
            src1 = RingSource(cfg, ring1, timeout_s=10.0)
            stats1 = run_stream(cfg, qw, src1, CollectSink(), depth=1,
                                max_blocks=3)
            assert stats1.n_blocks == 3
            ring1.close()  # abrupt exit — no handshake with the producer

            # Restarted consumer: re-attach, skip-ahead to newest.
            ring2 = RingBuffer(name)
            src2 = RingSource(cfg, ring2, latest=True, timeout_s=10.0)
            sink2 = CollectSink()
            stats2 = run_stream(cfg, qw, src2, sink2, depth=1)
            ring2.close()
        finally:
            stop.set()
            t.join()

    # The restarted consumer drained the stream to EOD.
    assert stats2.n_blocks >= 1
    seqs = [s for s, _ in sink2.outputs]
    assert seqs[-1] == n_total - 1  # reached the end of the stream
    assert seqs == sorted(seqs)
    # Total accounting: every block was either processed by one of the
    # consumers, dropped by the writer, or skipped by the catch-up.
    processed = stats1.n_blocks + stats2.n_blocks
    assert processed + stats2.skipped + stats2.dropped >= n_total - 4


def test_producer_restart_new_ring(tiny_cfg):
    """Producer restart = fresh segment (dsaring_create unlinks any
    stale one); a consumer attaching afterwards sees only the new
    stream."""
    cfg = tiny_cfg
    name = f"rec-{uuid.uuid4().hex[:8]}"
    with RingBuffer(name, create=True, nbufs=2,
                    bufsz=cfg.wire_block_bytes) as prod1:
        prod1.write_header(dada.encode_header(cfg))
        prod1.write_block(make_noise_block(cfg, seed=1))
    # "crash" + restart:
    with RingBuffer(name, create=True, nbufs=2,
                    bufsz=cfg.wire_block_bytes) as prod2:
        prod2.write_header(dada.encode_header(cfg))
        cons = RingBuffer(name)
        assert cons.n_written == 0  # old data gone with the old segment
        cons.close()
