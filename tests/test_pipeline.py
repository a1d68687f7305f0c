"""Streaming-driver tests (BASELINE config 4 shape): end-to-end blocks
through sources/sinks, output correctness vs golden, mid-stream weight
updates, ring-fed streaming with header validation."""

import threading
import uuid

import numpy as np
import pytest

from dsabeamformer.ingest import dada
from dsabeamformer.ingest.generator import make_noise_block, make_point_source_block
from dsabeamformer.ingest.ring import RingBuffer
from dsabeamformer.models.calibration import CalTable
from dsabeamformer.models.weights import make_weights, weights_numpy_golden
from dsabeamformer.ops.quantize import quantize_weights
from dsabeamformer.ops.reference import beamform_block_ref
from dsabeamformer.pipeline import (
    CollectSink,
    FileSource,
    RingSource,
    StreamingBeamformer,
    SyntheticSource,
    run_stream,
)
from dsabeamformer.utils.testing import assert_power_close


@pytest.fixture()
def qw(tiny_cfg):
    return quantize_weights(make_weights(tiny_cfg), tiny_cfg.weight_mode)


def test_synthetic_stream_outputs_match_golden(tiny_cfg, qw):
    blocks = [make_noise_block(tiny_cfg, rms=2.0, seed=s) for s in range(3)]
    src = SyntheticSource(tiny_cfg, blocks, n_blocks=3)
    sink = CollectSink()
    stats = run_stream(tiny_cfg, qw, src, sink, depth=2)
    assert stats.n_blocks == 3
    assert len(sink.outputs) == 3
    assert [s for s, _ in sink.outputs] == [0, 1, 2]
    w_ref = weights_numpy_golden(tiny_cfg)
    for seq, powers in sink.outputs:
        p_ref = beamform_block_ref(
            w_ref, blocks[seq], tiny_cfg.input_layout, tiny_cfg.navg_time
        )
        assert_power_close(powers, p_ref, rtol=2e-4, what=f"block {seq}")


def test_stream_stats_accounting(tiny_cfg, qw):
    blocks = [make_noise_block(tiny_cfg, rms=1.0, seed=0)]
    stats = run_stream(
        tiny_cfg, qw, SyntheticSource(tiny_cfg, blocks, n_blocks=5), depth=3
    )
    assert stats.n_blocks == 5
    assert stats.bytes_in == 5 * tiny_cfg.wire_block_bytes
    assert stats.wall_s > 0
    rec = stats.record(tiny_cfg)
    assert rec["blocks"] == 5 and rec["dropped"] == 0


def test_midstream_weight_update_applies(tiny_cfg):
    """Calibration update path (SURVEY.md §3.3): new weights affect
    subsequent blocks only, without restarting the stream."""
    w1 = quantize_weights(make_weights(tiny_cfg), "int8x2")
    cal = CalTable.random(tiny_cfg, seed=3, amp_sigma=0.5)
    w2 = quantize_weights(make_weights(tiny_cfg, cal=cal), "int8x2")

    blocks = [make_noise_block(tiny_cfg, rms=2.0, seed=7)]
    src = SyntheticSource(tiny_cfg, blocks, n_blocks=2)
    sink = CollectSink()
    bf = StreamingBeamformer(tiny_cfg, w1, src, sink, depth=0)  # sync drain
    stats_first = bf.run(max_blocks=1)
    bf.update_weights(w2)
    bf.run(max_blocks=1)
    assert stats_first.n_blocks == 1 and len(sink.outputs) == 2
    p1, p2 = sink.outputs[0][1], sink.outputs[1][1]
    assert not np.allclose(p1, p2)
    ref2 = beamform_block_ref(
        weights_numpy_golden(tiny_cfg, cal=cal), blocks[0],
        tiny_cfg.input_layout, tiny_cfg.navg_time,
    )
    assert_power_close(p2, ref2, rtol=2e-4, what="post-update block")


def test_file_source_roundtrip(tiny_cfg, qw, tmp_path):
    blocks = [make_noise_block(tiny_cfg, rms=2.0, seed=s) for s in range(2)]
    path = tmp_path / "blocks.raw"
    with open(path, "wb") as f:
        for b in blocks:
            f.write(b.tobytes())
    sink = CollectSink()
    stats = run_stream(tiny_cfg, qw, FileSource(tiny_cfg, path), sink)
    assert stats.n_blocks == 2
    np.testing.assert_array_equal(
        sink.outputs[0][1].shape, tiny_cfg.out_block_shape
    )


def test_ring_fed_stream(tiny_cfg, qw):
    """Capture-process -> dsaring -> beamformer, with header validation
    (the full reference ingest topology in-process)."""
    name = f"pipe-{uuid.uuid4().hex[:8]}"
    blocks = [make_noise_block(tiny_cfg, rms=2.0, seed=s) for s in range(4)]
    with RingBuffer(
        name, create=True, nbufs=4, bufsz=tiny_cfg.wire_block_bytes
    ) as prod:
        prod.write_header(dada.encode_header(tiny_cfg))

        def produce():
            for b in blocks:
                while not prod.write_block(b):
                    pass
            prod.set_eod()

        t = threading.Thread(target=produce)
        t.start()
        cons_ring = RingBuffer(name)
        src = RingSource(tiny_cfg, cons_ring, timeout_s=10.0)
        sink = CollectSink()
        stats = run_stream(tiny_cfg, qw, src, sink, depth=2)
        t.join()
        cons_ring.close()
    assert stats.n_blocks == 4
    assert stats.dropped == 0
    w_ref = weights_numpy_golden(tiny_cfg)
    p_ref = beamform_block_ref(
        w_ref, blocks[2], tiny_cfg.input_layout, tiny_cfg.navg_time
    )
    assert_power_close(sink.outputs[2][1], p_ref, rtol=2e-4)


def test_ring_header_mismatch_rejected(tiny_cfg):
    name = f"pipe-{uuid.uuid4().hex[:8]}"
    bad_cfg = tiny_cfg.replace(n_beams=tiny_cfg.n_beams * 2)
    with RingBuffer(
        name, create=True, nbufs=2, bufsz=tiny_cfg.wire_block_bytes
    ) as prod:
        prod.write_header(dada.encode_header(bad_cfg))
        cons = RingBuffer(name)
        with pytest.raises(ValueError, match="NBEAM"):
            RingSource(tiny_cfg, cons)
        cons.close()


def test_point_source_through_stream(tiny_cfg, qw):
    angles = tiny_cfg.beam_angles_rad()
    target = 5
    blocks = [
        make_point_source_block(tiny_cfg, angles[target], noise_rms=0.2, seed=9)
    ]
    sink = CollectSink()
    run_stream(tiny_cfg, qw, SyntheticSource(tiny_cfg, blocks, n_blocks=1), sink)
    p = sink.outputs[0][1]
    assert int(np.argmax(p.sum(axis=(0, 1)))) == target


def test_stream_stokes_products(tiny_cfg, qw):
    """products='stokes': the driver streams I/Q/U/V blocks to the sink."""
    import numpy as np

    from dsabeamformer.models.weights import weights_numpy_golden
    from dsabeamformer.ops.reference import beamform_stokes_ref
    from dsabeamformer.pipeline import StreamingBeamformer

    blocks = [make_noise_block(tiny_cfg, rms=2.0, seed=s) for s in range(2)]
    src = SyntheticSource(tiny_cfg, blocks, n_blocks=2)
    sink = CollectSink()
    bf = StreamingBeamformer(tiny_cfg, qw, src, sink, depth=1,
                             products="stokes")
    stats = bf.run()
    assert stats.n_blocks == 2
    w_ref = weights_numpy_golden(tiny_cfg)
    for seq, st in sink.outputs:
        assert st.shape == (tiny_cfg.n_chan,
                            tiny_cfg.t_block // tiny_cfg.navg_time, 4,
                            tiny_cfg.n_beams)
        ref = beamform_stokes_ref(w_ref, blocks[seq], tiny_cfg.input_layout,
                                  tiny_cfg.navg_time)
        scale = np.abs(ref[:, :, 0]).max()
        assert np.abs(st - ref).max() / scale < 3e-4


def test_stream_incoherent_side_channel(tiny_cfg, qw):
    import numpy as np

    from dsabeamformer.ops.incoherent import incoherent_power_golden
    from dsabeamformer.pipeline import StreamingBeamformer

    blocks = [make_noise_block(tiny_cfg, rms=2.0, seed=s) for s in range(2)]
    src = SyntheticSource(tiny_cfg, blocks, n_blocks=2)
    sink = CollectSink()
    inco = CollectSink()
    bf = StreamingBeamformer(tiny_cfg, qw, src, sink, depth=1,
                             incoherent_sink=inco)
    bf.run()
    assert len(inco.outputs) == 2
    for seq, p in inco.outputs:
        np.testing.assert_allclose(
            p, incoherent_power_golden(blocks[seq], tiny_cfg), rtol=1e-6)


def test_bad_products_rejected(tiny_cfg, qw):
    import pytest

    from dsabeamformer.pipeline import StreamingBeamformer

    with pytest.raises(ValueError, match="power|stokes"):
        StreamingBeamformer(tiny_cfg, qw, None, products="nope")
