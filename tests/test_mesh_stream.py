"""Streaming THROUGH the channel mesh (BASELINE configs 4x5 composed):
the `MeshStreamingBeamformer` drives `sharded_beamformer` block by
block — sharded H2D, per-shard compute, assembled drain, mid-stream
sharded weight updates, drop accounting — on the 8-virtual-CPU-device
mesh.  The reference never had this surface (its scale-out was one
process per GPU, SURVEY.md §2); here one process drives all the cards
of a host."""

import numpy as np
import pytest

from dsabeamformer.config import TINY
from dsabeamformer.ingest.generator import make_noise_block
from dsabeamformer.models.calibration import CalTable
from dsabeamformer.models.weights import (
    make_weights,
    weights_numpy_golden,
)
from dsabeamformer.ops.quantize import quantize_weights
from dsabeamformer.ops.reference import beamform_block_ref
from dsabeamformer.parallel.sharding import make_mesh
from dsabeamformer.pipeline import (
    CollectSink,
    MeshStreamingBeamformer,
    SyntheticSource,
)
from dsabeamformer.utils.testing import assert_power_close


@pytest.fixture(scope="module")
def mesh():
    return make_mesh(8)


@pytest.fixture(scope="module")
def cfg():
    # TINY geometry with the DSA-110 sharding structure: 16 channels
    # divide the 8-way mesh.
    return TINY.replace(n_chan=16, n_chan_total=16)


def _golden(cfg, wire, cal=None):
    return beamform_block_ref(
        weights_numpy_golden(cfg, cal=cal), np.asarray(wire),
        cfg.input_layout, cfg.navg_time, cfg.navg_freq,
    )


def test_mesh_stream_16_blocks_golden(cfg, mesh):
    """>=16 blocks through the 8-device mesh: every drained block must
    match the float64 golden pipeline at the BASELINE bar, and the
    stats line must account for all of them."""
    blocks = [np.asarray(make_noise_block(cfg, rms=2.0, seed=s))
              for s in range(4)]
    qw = quantize_weights(make_weights(cfg), cfg.weight_mode)
    src = SyntheticSource(cfg, blocks, n_blocks=16)
    sink = CollectSink()
    bf = MeshStreamingBeamformer(cfg, qw, src, sink, mesh=mesh, depth=2)
    bf.warmup()
    stats = bf.run()
    assert stats.n_blocks == 16
    assert len(sink.outputs) == 16
    refs = [_golden(cfg, b) for b in blocks]
    for seq, p in sink.outputs:
        assert p.shape == cfg.out_block_shape
        assert_power_close(p, refs[seq % 4], what=f"mesh stream block {seq}")


def test_mesh_stream_midstream_weight_update(cfg, mesh):
    """Swapping a fresh (re-sharded) weight table mid-stream must apply
    from the next dispatched block on, with both regimes golden."""
    wire = np.asarray(make_noise_block(cfg, rms=2.0, seed=11))
    qw0 = quantize_weights(make_weights(cfg), cfg.weight_mode)
    # A distinguishable second table: per-antenna gain twist.
    cal = CalTable.random(cfg, seed=5)
    qw1 = quantize_weights(make_weights(cfg, cal=cal), cfg.weight_mode)

    src = SyntheticSource(cfg, [wire], n_blocks=8)
    sink = CollectSink()
    bf = MeshStreamingBeamformer(cfg, qw0, src, sink, mesh=mesh, depth=2)
    swapped_at = 4

    def on_block(bs):
        if bs.block_idx == swapped_at - 1:
            # Drain of block 3: blocks 0..4 (depth ahead) may already be
            # dispatched; the swap is guaranteed visible from the next
            # *read* block on.
            bf.update_weights(qw1)

    bf.on_block = on_block
    bf.warmup()
    stats = bf.run()
    assert stats.n_blocks == 8
    ref0, ref1 = _golden(cfg, wire), _golden(cfg, wire, cal=cal)
    # The swap lands between the drain callback and the dispatch loop's
    # read of the next block; with depth=2 the first post-swap block is
    # no later than swapped_at + depth.  Every block must match one of
    # the two regimes, with regime 0 strictly before regime 1.
    first_new = None
    for seq, p in sink.outputs:
        err0 = np.abs(p - ref0).max()
        err1 = np.abs(p - ref1).max()
        regime = 0 if err0 < err1 else 1
        if regime == 1 and first_new is None:
            first_new = seq
        if regime == 0:
            assert first_new is None, f"block {seq} reverted to old weights"
            assert_power_close(p, ref0, what=f"pre-swap block {seq}")
        else:
            assert_power_close(p, ref1, what=f"post-swap block {seq}")
    assert first_new is not None and swapped_at <= first_new <= swapped_at + 2


def test_mesh_stream_band_power_collective(cfg, mesh):
    """The optional band-total-power psum (the one deliberate
    collective) streams alongside the products."""
    wire = np.asarray(make_noise_block(cfg, rms=2.0, seed=21))
    qw = quantize_weights(make_weights(cfg), cfg.weight_mode)
    src = SyntheticSource(cfg, [wire], n_blocks=5)
    sink = CollectSink()
    bands = {}
    bf = MeshStreamingBeamformer(
        cfg, qw, src, sink, mesh=mesh, depth=2,
        with_band_power=True,
        on_band_power=lambda seq, band: bands.__setitem__(seq, band),
    )
    bf.warmup()
    bf.run()
    assert sorted(bands) == list(range(5))
    for seq, p in sink.outputs:
        np.testing.assert_allclose(
            bands[seq], p.sum(axis=(0, 2)), rtol=1e-5,
            err_msg=f"band power of block {seq}",
        )


def test_mesh_stream_stokes(cfg, mesh):
    """products='stokes' through the mesh driver."""
    from dsabeamformer.ops.reference import beamform_stokes_ref

    wire = np.asarray(make_noise_block(cfg, rms=2.0, seed=31))
    qw = quantize_weights(make_weights(cfg), cfg.weight_mode)
    src = SyntheticSource(cfg, [wire], n_blocks=3)
    sink = CollectSink()
    bf = MeshStreamingBeamformer(cfg, qw, src, sink, mesh=mesh, depth=2,
                                 products="stokes")
    bf.warmup()
    stats = bf.run()
    assert stats.n_blocks == 3
    ref = beamform_stokes_ref(
        weights_numpy_golden(cfg), wire, cfg.input_layout, cfg.navg_time,
        cfg.navg_freq,
    )
    scale = np.abs(ref[:, :, 0]).max()
    for seq, st in sink.outputs:
        assert st.shape == ref.shape
        assert np.abs(st - ref).max() / scale < 3e-4


def test_mesh_stream_fused_incoherent(cfg, mesh):
    """The fused incoherent side product rides the mesh step (one
    kernel pass per shard, channel-sharded [F', T'] assembled at
    drain) and matches its float64 oracle."""
    from dsabeamformer.ops.incoherent import incoherent_power_golden

    wire = np.asarray(make_noise_block(cfg, rms=2.0, seed=61))
    qw = quantize_weights(make_weights(cfg), cfg.weight_mode)
    src = SyntheticSource(cfg, [wire], n_blocks=4)
    sink, inco_sink = CollectSink(), CollectSink()
    bf = MeshStreamingBeamformer(cfg, qw, src, sink, mesh=mesh, depth=2,
                                 incoherent_sink=inco_sink)
    bf.warmup()
    stats = bf.run()
    assert stats.n_blocks == 4 and len(inco_sink.outputs) == 4
    ref_p = _golden(cfg, wire)
    ref_i = incoherent_power_golden(wire, cfg)
    for (seq, p), (_, inco) in zip(sink.outputs, inco_sink.outputs):
        assert_power_close(p, ref_p, what=f"mesh inco block {seq}")
        np.testing.assert_allclose(inco, ref_i, rtol=1e-6)


def test_mesh_stream_fused_sk_monitor(cfg, mesh):
    """The streaming RFI monitor on the mesh: the kernel emits the
    channel-sharded SK accumulators, the monitor polls them at drain,
    and an excision event re-shards fresh weights mid-stream."""
    from dsabeamformer.ops.incoherent import sk_block_stats
    from dsabeamformer.ops.rfi import RFIMonitor

    wire = np.asarray(make_noise_block(cfg, rms=2.0, seed=71))
    qw = quantize_weights(make_weights(cfg), cfg.weight_mode)
    ref_sk = {k: np.asarray(v) for k, v in sk_block_stats(wire, cfg).items()}

    # First: the sharded accumulators equal the single-device pass.
    from dsabeamformer.ops.gemm import device_wire_view
    from dsabeamformer.parallel.sharding import (
        shard_weights,
        sharded_beamformer,
        sharded_wire_sharding,
    )
    import jax

    step = sharded_beamformer(cfg, mesh, sk_stats=True)
    wire_sh = jax.device_put(device_wire_view(wire, cfg),
                             sharded_wire_sharding(cfg, mesh))
    _, sk = step(wire_sh, shard_weights(cfg, mesh))
    sk = np.asarray(sk)
    assert sk.shape == (cfg.n_chan, 2)
    np.testing.assert_allclose(sk[:, 0], ref_sk["s1"], rtol=1e-6)
    np.testing.assert_allclose(sk[:, 1], ref_sk["s2"], rtol=1e-6)

    # Then: the monitor runs live on the mesh stream without error and
    # observes every block (noise input: no excision expected).
    src = SyntheticSource(cfg, [wire], n_blocks=4)
    bf = MeshStreamingBeamformer(cfg, qw, src, CollectSink(), mesh=mesh,
                                 depth=2)
    events = []
    bf.rfi_monitor = RFIMonitor(cfg, interval=2, sample=1,
                                on_event=events.append)
    bf.warmup()
    stats = bf.run()
    assert stats.n_blocks == 4
    assert not bf.rfi_monitor._pending  # every block's stats fetched
    assert not [e for e in events if e["type"] == "excise" and e.get("new")]


def test_mesh_stream_fused_quant8(cfg, mesh):
    """The fused uint8 filterbank quantization through shard_map:
    byte-equal to quantizing the assembled f32 product."""
    import jax

    from dsabeamformer.ops.gemm import device_wire_view
    from dsabeamformer.parallel.sharding import (
        shard_weights,
        sharded_beamformer,
        sharded_wire_sharding,
    )

    wire = np.asarray(make_noise_block(cfg, rms=2.0, seed=91))
    qw_sh = shard_weights(cfg, mesh)
    wire_sh = jax.device_put(device_wire_view(wire, cfg),
                             sharded_wire_sharding(cfg, mesh))
    p32 = np.asarray(sharded_beamformer(cfg, mesh)(wire_sh, qw_sh))
    scales = np.full(cfg.n_beams, 0.5, np.float32)
    step_q = sharded_beamformer(cfg, mesh, fused_quant8=True)
    pq = np.asarray(step_q(wire_sh, qw_sh, jax.device_put(scales)))
    assert pq.dtype == np.uint8
    expect = np.clip(np.rint(p32 * scales), 0, 255).astype(np.uint8)
    np.testing.assert_array_equal(pq, expect)


def test_mesh_stream_with_search_monitor(cfg, mesh):
    """The live single-pulse search monitor rides the mesh stream: it
    observes every drained (assembled) product block and recovers an
    injected post-detection pulse."""
    from dsabeamformer.ops.dedisperse import (
        SearchMonitor,
        dm_trial_grid,
    )

    cfg = cfg.replace(navg_time=2)  # 32 output samples/block
    wire = np.asarray(make_noise_block(cfg, rms=2.0, seed=3))
    qw = quantize_weights(make_weights(cfg), cfg.weight_mode)
    tsamp = cfg.sample_period_s * cfg.navg_time
    freqs = cfg.freqs_hz() / 1e6
    dms = dm_trial_grid(float(freqs.min()), float(freqs.max()), tsamp,
                        dm_max=5.0)

    t_out = cfg.t_block // cfg.navg_time

    class PulseSink(CollectSink):
        """Injects a boxcar into beam 0 at global samples 40..45 on the
        way to the monitor (post-detection injection keeps the physics
        independent of the beamformer under test)."""

    src = SyntheticSource(cfg, [wire], n_blocks=4)
    sink = CollectSink()
    bf = MeshStreamingBeamformer(cfg, qw, src, sink, mesh=mesh, depth=2)
    pulse_t0, pulse_w = 40, 4

    mon = SearchMonitor(freqs, tsamp, dms, beam=0, threshold=8.0,
                        coincidence=False)
    orig_observe = mon.observe

    def observe_with_pulse(seq, arr, inco=None):
        arr = np.array(arr)
        lo, hi = seq * t_out, (seq + 1) * t_out
        a, b = max(pulse_t0, lo), min(pulse_t0 + pulse_w, hi)
        if a < b:
            arr[:, a - lo: b - lo, 0] += 30.0 * float(np.median(arr))
        return orig_observe(seq, arr, inco)

    mon.observe = observe_with_pulse
    bf.search_monitor = mon
    bf.warmup()
    stats = bf.run()
    assert stats.n_blocks == 4
    assert mon.candidates, "mesh-stream search monitor missed the pulse"
    best = max(mon.candidates, key=lambda c: c.snr)
    assert abs(best.t_samp - pulse_t0) <= 8


def test_mesh_rejects_quant8_with_band_power(cfg, mesh):
    from dsabeamformer.parallel.sharding import sharded_beamformer

    with pytest.raises(ValueError, match="band power"):
        sharded_beamformer(cfg, mesh, fused_quant8=True,
                           with_band_power=True)


def test_mesh_stream_fused_quant8_driver_byte_equal(cfg, mesh, tmp_path):
    """Driver-level: an 8-bit filterbank MESH run engages the fused
    in-kernel quantizer after auto-cal and produces byte-identical
    .fil products to the single-device driver on the same capture."""
    from dsabeamformer.ingest.sigproc import (
        FilterbankSink,
        read_filterbank,
    )
    from dsabeamformer.pipeline import FileSource, StreamingBeamformer

    wires = [np.asarray(make_noise_block(cfg, rms=2.0, seed=s))
             for s in (51, 52, 53)]
    raw = tmp_path / "cap.raw"
    raw.write_bytes(b"".join(w.tobytes() for w in wires))
    qw = quantize_weights(make_weights(cfg), cfg.weight_mode)

    def run_one(name, klass, **kw):
        sink = FilterbankSink(tmp_path / name, cfg, nbits=8, beams=[0, 3])
        bf = klass(cfg, qw, FileSource(cfg, raw), sink, **kw)
        engaged = []
        orig_step = bf._step
        bf._step = lambda w, q8=None, sk_stats=None: (
            engaged.append(q8 is not None),
            orig_step(w, q8, sk_stats=sk_stats))[1]
        assert bf._fused_quant8() is not None
        bf.run()
        # Block 0 travels f32 (auto-cal learns scales at its drain);
        # every later block takes the fused uint8 kernel.
        assert engaged == [False, True, True], engaged
        sink.close()
        return sink

    s_mesh = run_one("mesh", MeshStreamingBeamformer, mesh=mesh)
    s_single = run_one("single", StreamingBeamformer)
    assert s_mesh.scales == s_single.scales
    for b in (0, 3):
        _, d_mesh = read_filterbank(tmp_path / "mesh" / f"beam{b:04d}.fil")
        _, d_one = read_filterbank(tmp_path / "single" / f"beam{b:04d}.fil")
        np.testing.assert_array_equal(d_mesh, d_one)


def test_mesh_stream_drop_accounting(cfg, mesh):
    """Source drop/skip counters flow into the mesh stream's stats."""
    wire = np.asarray(make_noise_block(cfg, rms=2.0, seed=41))
    qw = quantize_weights(make_weights(cfg), cfg.weight_mode)

    class DroppySource(SyntheticSource):
        def read_block(self):
            item = super().read_block()
            self.dropped = 3
            self.skipped = 1
            return item

    src = DroppySource(cfg, [wire], n_blocks=4)
    bf = MeshStreamingBeamformer(cfg, qw, src, CollectSink(), mesh=mesh)
    bf.warmup()
    stats = bf.run()
    assert stats.n_blocks == 4
    assert stats.dropped == 3
    assert stats.skipped == 1


def test_mesh_stream_tracker_resharding(cfg, mesh):
    """A FringeTracker's per-block updates flow through update_weights
    and get re-sharded: the stream must track the golden pipeline built
    from the tracker's own tables."""
    from dsabeamformer.models.tracking import FringeTracker

    wire = np.asarray(make_noise_block(cfg, rms=2.0, seed=51))
    qw = quantize_weights(make_weights(cfg), cfg.weight_mode)
    src = SyntheticSource(cfg, [wire], n_blocks=4)
    sink = CollectSink()
    tracker = FringeTracker(cfg, pointing0_rad=0.0)
    bf = MeshStreamingBeamformer(cfg, qw, src, sink, mesh=mesh, depth=1,
                                 tracker=tracker)
    bf.warmup()
    stats = bf.run()
    assert stats.n_blocks == 4
    # Every drained block golden-checks against the fringe-tracked
    # pointing for SOME update time <= its own block time (the tracker
    # only regenerates when the drift exceeds its phase budget, and the
    # swap lags dispatch by <= depth blocks).
    from dsabeamformer.utils.testing import relative_power_error

    cand_refs = [
        beamform_block_ref(
            weights_numpy_golden(
                cfg, pointing_rad=tracker.pointing_at(
                    t * cfg.block_duration_s)),
            wire, cfg.input_layout, cfg.navg_time, cfg.navg_freq,
        )
        for t in range(5)
    ]
    for seq, p in sink.outputs:
        errs = [relative_power_error(p, r) for r in cand_refs[: seq + 1]]
        assert min(errs) < 1e-3, (
            f"block {seq} matches no tracked pointing: {errs}"
        )
