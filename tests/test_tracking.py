"""Fringe/pointing tracking tests (SURVEY.md §3.3 weight-update path)."""

import numpy as np

from dsabeamformer.ingest.generator import make_point_source_block
from dsabeamformer.models.calibration import CalTable
from dsabeamformer.models.tracking import EARTH_ROT_RAD_S, FringeTracker
from dsabeamformer.pipeline import CollectSink, StreamingBeamformer, SyntheticSource


def test_update_interval_scales_with_phase_budget(tiny_cfg):
    t1 = FringeTracker(tiny_cfg, max_phase_error_rad=0.05)
    t2 = FringeTracker(tiny_cfg, max_phase_error_rad=0.10)
    assert t2.update_interval_s > t1.update_interval_s
    assert t1.update_interval_s > 0


def test_maybe_update_cadence(tiny_cfg):
    tr = FringeTracker(tiny_cfg)
    dt = tr.update_interval_s
    assert tr.maybe_update(0.0) is not None
    assert tr.maybe_update(0.1 * dt) is None
    assert tr.maybe_update(1.1 * dt) is not None
    assert tr.n_updates == 2


def test_cal_update_forces_regeneration(tiny_cfg):
    tr = FringeTracker(tiny_cfg)
    assert tr.maybe_update(0.0) is not None
    assert tr.maybe_update(0.0) is None
    tr.set_calibration(CalTable.random(tiny_cfg, seed=5))
    assert tr.maybe_update(0.0) is not None


def test_tracked_stream_follows_source(tiny_cfg):
    """A source drifting at the sidereal rate stays in the SAME beam
    when the tracker updates pointing, and walks out of it when the
    weights are frozen."""
    cfg = tiny_cfg
    angles = cfg.beam_angles_rad()
    target = len(angles) // 2
    # Pick times so the drift spans ~4 beam spacings (staying inside
    # the fan — beyond it the peak lands on a grating lobe).
    beam_step = np.diff(angles).mean()
    t_step = 2 * beam_step / EARTH_ROT_RAD_S

    tr = FringeTracker(cfg, pointing0_rad=0.0)
    blocks, peaks_tracked, peaks_frozen = [], [], []
    qw0 = tr.weights_at(0.0)
    for i in range(3):
        t = i * t_step
        drift = EARTH_ROT_RAD_S * t
        blocks.append(
            make_point_source_block(cfg, angles[target] + drift,
                                    noise_rms=0.0, seed=i)
        )
        # tracked weights at that time:
        from dsabeamformer.ops.gemm import beamform_power
        import jax

        p_tracked = np.asarray(
            beamform_power(jax.device_put(blocks[-1]), tr.weights_at(t), cfg)
        )
        p_frozen = np.asarray(
            beamform_power(jax.device_put(blocks[-1]), qw0, cfg)
        )
        peaks_tracked.append(int(np.argmax(p_tracked.sum(axis=(0, 1)))))
        peaks_frozen.append(int(np.argmax(p_frozen.sum(axis=(0, 1)))))

    assert peaks_tracked == [target] * 3, peaks_tracked
    assert peaks_frozen[0] == target
    assert peaks_frozen[-1] > target  # source drifted out of the fixed beam


def test_pipeline_applies_tracker_updates(tiny_cfg):
    cfg = tiny_cfg
    tr = FringeTracker(cfg, max_phase_error_rad=1e-9)  # update every block
    blocks = [make_point_source_block(cfg, 0.0, noise_rms=0.5, seed=9)]
    src = SyntheticSource(cfg, blocks, n_blocks=3)
    sink = CollectSink()
    bf = StreamingBeamformer(cfg, tr.weights_at(0.0), src, sink, depth=0,
                             tracker=tr)
    stats = bf.run()
    assert stats.n_blocks == 3
    assert tr.n_updates == 3  # polled and refreshed each block
