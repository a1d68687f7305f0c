"""ObsConfig validation + derived-quantity tests (SURVEY.md C2)."""

import numpy as np
import pytest

from dsabeamformer.config import DSA10, DSA110, TINY, ObsConfig, presets


def test_presets_valid():
    for name, cfg in presets().items():
        assert cfg.name == name
        assert cfg.wire_block_bytes > 0
        assert cfg.out_block_shape[2] == cfg.n_beams


def test_dsa10_stream_rate():
    # 8.192 us per channelized sample; padded full-band wire rate.
    assert abs(DSA10.sample_period_s - 8.192e-6) < 1e-12
    rate = DSA10.realtime_bytes_per_s
    expected = DSA10.n_chan * DSA10.n_pol * DSA10.n_ant / DSA10.sample_period_s
    assert abs(rate - expected) / expected < 1e-12


def test_dsa110_geometry():
    assert DSA110.n_ant == 128 and DSA110.n_ant_active == 110
    assert DSA110.n_beams == 512


@pytest.mark.parametrize("field,value,msg", [
    ("t_block", 100, "multiple of navg_time"),
    ("navg_freq", 3, "multiple of navg_freq"),
    ("n_ant_compute", 12, "multiple of 8"),
    ("n_ant_active", 1000, "n_ant_active"),
    ("weight_mode", "fp4", "weight_mode"),
    ("input_layout", "fpta", "input_layout"),
])
def test_invalid_configs_rejected(field, value, msg):
    with pytest.raises(ValueError, match=msg):
        TINY.replace(**{field: value})


def test_t_block_navg_divisibility():
    with pytest.raises(ValueError, match="multiple of navg_time"):
        TINY.replace(t_block=24)


def test_beam_angles_uniform_in_sin():
    s = np.sin(DSA10.beam_angles_rad())
    np.testing.assert_allclose(np.diff(s), np.diff(s)[0], rtol=1e-9)
    assert len(s) == DSA10.n_beams


def test_subband_slicing():
    sub = DSA10.subband(256, 256)
    np.testing.assert_allclose(sub.freqs_hz(), DSA10.freqs_hz()[256:512])


def test_config_hashable_for_jit():
    d = {DSA10: 1, TINY: 2}
    assert d[DSA10] == 1
    assert DSA10.replace(t_block=1024) != DSA10


def test_wire_dtype_rejected(tiny_cfg):
    import jax.numpy as jnp

    from dsabeamformer.models.weights import make_weights
    from dsabeamformer.ops.gemm import beamform_power
    from dsabeamformer.ops.quantize import quantize_weights

    qw = quantize_weights(make_weights(tiny_cfg), tiny_cfg.weight_mode)
    bad = jnp.zeros(tiny_cfg.wire_block_shape, jnp.int8)
    with pytest.raises(ValueError, match="uint8"):
        beamform_power(bad, qw, tiny_cfg)


def test_mismatched_cal_rejected(tiny_cfg):
    from dsabeamformer.models.calibration import CalTable
    from dsabeamformer.models.weights import make_weights

    bad_cal = CalTable.unity(tiny_cfg.replace(n_chan=4, n_chan_total=4))
    with pytest.raises(ValueError, match="calibration"):
        make_weights(tiny_cfg, cal=bad_cal)

def test_dsa10_compact_preset():
    from dsabeamformer.config import DSA10, DSA10_COMPACT, presets

    c = DSA10_COMPACT
    assert presets()["dsa10c"] is c
    assert c.n_ant == 16 and c.n_ant_active == DSA10.n_ant_active
    assert c.n_beams == DSA10.n_beams and c.n_chan == DSA10.n_chan
    # 4x less wire than the padded reference format, same sky time.
    assert c.wire_block_bytes * 4 == DSA10.wire_block_bytes
    assert c.block_duration_s == DSA10.block_duration_s
    assert c.a_compute == 16

