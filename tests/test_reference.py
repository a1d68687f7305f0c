"""Golden-model physics tests (SURVEY.md §4): a synthetic point source
must peak in the beam nearest its true angle — the analytic end-to-end
check the reference used."""

import numpy as np

from dsabeamformer.ingest.generator import (
    make_noise_block,
    make_point_source_block,
    make_tone_block,
)
from dsabeamformer.models.weights import weights_numpy_golden
from dsabeamformer.ops.reference import (
    average_ref,
    beamform_block_ref,
    beamform_voltages_ref,
    detect_ref,
)


def test_point_source_peaks_at_true_beam(tiny_cfg):
    angles = tiny_cfg.beam_angles_rad()
    target = len(angles) // 3
    wire = make_point_source_block(
        tiny_cfg, angle_rad=angles[target], noise_rms=0.0, seed=3
    )
    w = weights_numpy_golden(tiny_cfg)
    p = beamform_block_ref(w, wire, tiny_cfg.input_layout, tiny_cfg.navg_time)
    beam_profile = p.sum(axis=(0, 1))  # [B]
    assert int(np.argmax(beam_profile)) == target


def test_point_source_peak_with_noise(tiny_cfg):
    angles = tiny_cfg.beam_angles_rad()
    target = 2 * len(angles) // 3
    wire = make_point_source_block(
        tiny_cfg, angle_rad=angles[target], amplitude=6.0, noise_rms=0.5, seed=4
    )
    w = weights_numpy_golden(tiny_cfg)
    p = beamform_block_ref(w, wire, tiny_cfg.input_layout, tiny_cfg.navg_time)
    assert int(np.argmax(p.sum(axis=(0, 1)))) == target


def test_coherent_gain_scales_with_antennas(tiny_cfg):
    """Boresight source: beamformed power on the matched beam ~ A^2 *
    per-antenna power (the phased-array coherence law)."""
    angles = tiny_cfg.beam_angles_rad()
    target = int(np.argmin(np.abs(angles)))
    wire = make_point_source_block(
        tiny_cfg, angle_rad=angles[target], amplitude=5.0, noise_rms=0.0, seed=5
    )
    w = weights_numpy_golden(tiny_cfg)
    from dsabeamformer.ops.packing import unpack_wire_to_complex

    volt = unpack_wire_to_complex(wire, tiny_cfg.input_layout)
    bv = beamform_voltages_ref(w, volt)
    a = tiny_cfg.n_ant_active
    per_ant = np.mean(np.abs(volt[..., :a]) ** 2)
    matched = np.mean(np.abs(bv[..., target]) ** 2)
    ratio = matched / (per_ant * a**2)
    assert 0.8 < ratio < 1.2


def test_average_ref_shapes_and_sums(tiny_cfg):
    f, t, b = 4, 32, 8
    p = np.arange(f * t * b, dtype=np.float64).reshape(f, t, b)
    avg = average_ref(p, navg_time=16, navg_freq=2)
    assert avg.shape == (2, 2, 8)
    np.testing.assert_allclose(avg.sum(), p.sum())


def test_detect_sums_pols():
    bv = np.array([[[[1 + 1j], [2 - 1j]]]])  # [1,1,2,1]
    p = detect_ref(bv)
    np.testing.assert_allclose(p, [[[2 + 5]]])


def test_tone_block_single_channel(tiny_cfg):
    wire = make_tone_block(tiny_cfg, chan=3)
    w = weights_numpy_golden(tiny_cfg)
    p = beamform_block_ref(w, wire, tiny_cfg.input_layout, tiny_cfg.navg_time)
    energy = p.sum(axis=(1, 2))
    assert energy[3] > 0
    mask = np.ones(tiny_cfg.n_chan, bool)
    mask[3] = False
    np.testing.assert_array_equal(energy[mask], 0.0)


def test_noise_block_statistics(tiny_cfg):
    wire = make_noise_block(tiny_cfg, rms=2.0, seed=9)
    from dsabeamformer.ops.packing import unpack_wire_to_complex

    v = unpack_wire_to_complex(wire, tiny_cfg.input_layout)
    act = v[..., : tiny_cfg.n_ant_active]
    assert 1.5 < np.std(act.real) < 2.5
    np.testing.assert_array_equal(v[..., tiny_cfg.n_ant_active:], 0.0)
