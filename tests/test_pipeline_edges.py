"""Streaming-driver edge cases."""

import numpy as np
import pytest

from dsabeamformer.ingest.generator import make_noise_block
from dsabeamformer.models.weights import make_weights
from dsabeamformer.ops.quantize import quantize_weights
from dsabeamformer.pipeline import (
    CollectSink,
    StreamingBeamformer,
    SyntheticSource,
    run_stream,
)


@pytest.fixture()
def qw(tiny_cfg):
    return quantize_weights(make_weights(tiny_cfg), tiny_cfg.weight_mode)


def test_empty_source(tiny_cfg, qw):
    stats = run_stream(tiny_cfg, qw, SyntheticSource(tiny_cfg, [], n_blocks=0))
    assert stats.n_blocks == 0 and stats.wall_s >= 0


def test_depth_zero_is_fully_synchronous(tiny_cfg, qw):
    blocks = [make_noise_block(tiny_cfg, seed=0)]
    sink = CollectSink()
    bf = StreamingBeamformer(
        tiny_cfg, qw, SyntheticSource(tiny_cfg, blocks, n_blocks=4), sink,
        depth=0,
    )
    stats = bf.run()
    assert stats.n_blocks == 4 and len(sink.outputs) == 4


def test_max_blocks_stops_early_and_resumes(tiny_cfg, qw):
    blocks = [make_noise_block(tiny_cfg, seed=0)]
    src = SyntheticSource(tiny_cfg, blocks, n_blocks=6)
    sink = CollectSink()
    bf = StreamingBeamformer(tiny_cfg, qw, src, sink, depth=2)
    s1 = bf.run(max_blocks=2)
    s2 = bf.run(max_blocks=4)
    assert s1.n_blocks == 2 and s2.n_blocks == 4
    assert [s for s, _ in sink.outputs] == list(range(6))


def test_deep_pipeline_order_preserved(tiny_cfg, qw):
    """depth > number of distinct blocks: outputs still arrive in seq
    order and match per-block content (guards the staging-pool size
    interaction)."""
    blocks = [make_noise_block(tiny_cfg, seed=s) for s in range(4)]
    src = SyntheticSource(tiny_cfg, blocks, n_blocks=8)
    sink = CollectSink()
    stats = run_stream(tiny_cfg, qw, src, sink, depth=6)
    assert stats.n_blocks == 8
    assert [s for s, _ in sink.outputs] == list(range(8))
    # Blocks 0 and 4 are the same input -> identical output.
    np.testing.assert_array_equal(sink.outputs[0][1], sink.outputs[4][1])
    assert not np.array_equal(sink.outputs[0][1], sink.outputs[1][1])


def test_rate_paced_source(tiny_cfg, qw):
    import time

    blocks = [make_noise_block(tiny_cfg, seed=0)]
    # Pace to 0.5x realtime over 4 blocks: should take ~8 block durations.
    src = SyntheticSource(tiny_cfg, blocks, n_blocks=4, rate_factor=0.5)
    t0 = time.perf_counter()
    run_stream(tiny_cfg, qw, src)
    elapsed = time.perf_counter() - t0
    assert elapsed >= 3 * tiny_cfg.block_duration_s / 0.5


class _PooledNullSource:
    """Source stub exposing a staging pool size (like RingSource) that
    immediately reports end-of-stream."""

    n_host_buffers = 8
    dropped = 0
    skipped = 0

    def read_block(self):
        return None


def test_depth_exceeding_staging_pool_rejected(tiny_cfg, qw):
    # depth+2 buffers are required (in-flight + enqueueing + safety);
    # 8-deep pipeline against the default 8-buffer pool would recycle a
    # staging buffer whose async device_put may still be in flight.
    bf = StreamingBeamformer(tiny_cfg, qw, _PooledNullSource(), depth=8)
    with pytest.raises(ValueError, match="staging buffers"):
        bf.run(max_blocks=1)


def test_depth_within_staging_pool_accepted(tiny_cfg, qw):
    bf = StreamingBeamformer(tiny_cfg, qw, _PooledNullSource(), depth=6)
    stats = bf.run(max_blocks=1)
    assert stats.n_blocks == 0


def test_current_stats_after_interrupt(tiny_cfg, qw):
    """Interrupting a run must yield stats clocked from the loop start
    (the old CLI handler built fresh StreamStats at interrupt time,
    reporting astronomically inflated GB/s)."""
    blocks = [make_noise_block(tiny_cfg, seed=0)]
    src = SyntheticSource(tiny_cfg, blocks, n_blocks=100)

    def boom(bs):
        raise KeyboardInterrupt

    bf = StreamingBeamformer(tiny_cfg, qw, src, depth=0, on_block=boom)
    with pytest.raises(KeyboardInterrupt):
        bf.run()
    s = bf.current_stats()
    assert s.n_blocks >= 1 and s.wall_s > 0
    # Sanity: the rate must reflect real loop wall time, not ~zero.
    assert s.gb_per_s < 1000.0


def test_current_stats_matches_completed_run(tiny_cfg, qw):
    blocks = [make_noise_block(tiny_cfg, seed=0)]
    bf = StreamingBeamformer(
        tiny_cfg, qw, SyntheticSource(tiny_cfg, blocks, n_blocks=3), depth=2
    )
    s = bf.run()
    cur = bf.current_stats()
    assert cur.n_blocks == 3
    assert cur.bytes_in == 3 * tiny_cfg.wire_block_bytes
    assert cur.wall_s >= s.wall_s > 0
