"""Multi-chip scale-out tests on the 8-virtual-CPU-device mesh
(BASELINE config 5: DSA-110 channel-sharded shard_map)."""

import jax
import numpy as np
import pytest

from dsabeamformer.config import DSA110
from dsabeamformer.ingest.generator import make_noise_block, make_point_source_block
from dsabeamformer.models.weights import make_weights, weights_numpy_golden
from dsabeamformer.ops.gemm import beamform_power, device_wire_view
from dsabeamformer.ops.quantize import quantize_weights
from dsabeamformer.ops.reference import beamform_block_ref
from dsabeamformer.parallel.sharding import (
    make_mesh,
    shard_weights,
    sharded_beamformer,
    sharded_wire_sharding,
)
from dsabeamformer.utils.testing import assert_power_close


@pytest.fixture(scope="module")
def mesh():
    return make_mesh(8)


@pytest.fixture(scope="module")
def shard_cfg(request):
    # Tiny-geometry stand-in with the DSA-110 *sharding structure*:
    # channels divide 8-way.
    from dsabeamformer.config import TINY

    return TINY.replace(n_chan=16, n_chan_total=16)


def test_sharded_matches_single_device(shard_cfg, mesh):
    cfg = shard_cfg
    wire = make_noise_block(cfg, rms=2.0, seed=1)
    qw = quantize_weights(make_weights(cfg), cfg.weight_mode)
    p_single = np.asarray(beamform_power(jax.device_put(wire), qw, cfg))

    step = sharded_beamformer(cfg, mesh)
    qw_sh = shard_weights(cfg, mesh)
    wire_sh = jax.device_put(device_wire_view(wire, cfg),
                             sharded_wire_sharding(cfg, mesh))
    p_sharded = np.asarray(step(wire_sh, qw_sh))
    np.testing.assert_allclose(p_sharded, p_single, rtol=1e-5, atol=1e-2)


def test_sharded_point_source_peak(shard_cfg, mesh):
    cfg = shard_cfg
    angles = cfg.beam_angles_rad()
    target = 7
    wire = make_point_source_block(cfg, angles[target], noise_rms=0.2, seed=3)
    step = sharded_beamformer(cfg, mesh)
    qw_sh = shard_weights(cfg, mesh)
    wire_sh = jax.device_put(device_wire_view(wire, cfg),
                             sharded_wire_sharding(cfg, mesh))
    p = np.asarray(step(wire_sh, qw_sh))
    assert int(np.argmax(p.sum(axis=(0, 1)))) == target
    p_ref = beamform_block_ref(
        weights_numpy_golden(cfg), wire, cfg.input_layout, cfg.navg_time,
        cfg.navg_freq,
    )
    # Point-source blocks have near-empty off-peak bins where int8
    # weight quantization error is relatively larger; gate at the
    # canonical BASELINE bar.
    assert_power_close(p, p_ref, what="sharded point source")


def test_band_power_psum(shard_cfg, mesh):
    cfg = shard_cfg
    wire = make_noise_block(cfg, rms=2.0, seed=5)
    step = sharded_beamformer(cfg, mesh, with_band_power=True)
    qw_sh = shard_weights(cfg, mesh)
    wire_sh = jax.device_put(device_wire_view(wire, cfg),
                             sharded_wire_sharding(cfg, mesh))
    powers, band = step(wire_sh, qw_sh)
    powers, band = np.asarray(powers), np.asarray(band)
    assert band.shape == (cfg.t_block // cfg.navg_time,)
    np.testing.assert_allclose(band, powers.sum(axis=(0, 2)), rtol=1e-5)


def test_dsa110_structure_compiles_small(mesh):
    """DSA-110 sharding structure (128 ant, 512 beams) with reduced
    channel/time extents: the shard_map path must compile and give
    golden-accurate output on 8 devices."""
    cfg = DSA110.replace(
        n_chan=16, n_chan_total=2048, t_block=64, n_beams=64,
    )
    wire = make_noise_block(cfg, rms=2.0, seed=9)
    step = sharded_beamformer(cfg, mesh)
    qw_sh = shard_weights(cfg, mesh)
    wire_sh = jax.device_put(device_wire_view(wire, cfg),
                             sharded_wire_sharding(cfg, mesh))
    p = np.asarray(step(wire_sh, qw_sh))
    p_ref = beamform_block_ref(
        weights_numpy_golden(cfg), wire, cfg.input_layout, cfg.navg_time,
        cfg.navg_freq,
    )
    assert_power_close(p, p_ref, rtol=2e-4, what="dsa110 structure")


def test_mesh_size_must_divide_channels(mesh, shard_cfg):
    cfg = shard_cfg.replace(n_chan=12, n_chan_total=12)
    with pytest.raises(ValueError, match="divisible"):
        sharded_beamformer(cfg, mesh)


def test_sharded_stokes_matches_golden(shard_cfg, mesh):
    """products='stokes' on the channel mesh: I/Q/U/V sharded over
    channels, every plane matching the golden model."""
    from dsabeamformer.ops.reference import beamform_stokes_ref

    cfg = shard_cfg
    wire = make_noise_block(cfg, rms=2.0, seed=17)
    step = sharded_beamformer(cfg, mesh, products="stokes",
                              with_band_power=True)
    qw_sh = shard_weights(cfg, mesh)
    wire_sh = jax.device_put(device_wire_view(wire, cfg),
                             sharded_wire_sharding(cfg, mesh))
    st, band = step(wire_sh, qw_sh)
    st, band = np.asarray(st), np.asarray(band)
    ref = beamform_stokes_ref(
        weights_numpy_golden(cfg), wire, cfg.input_layout, cfg.navg_time,
        cfg.navg_freq,
    )
    assert st.shape == ref.shape
    scale = np.abs(ref[:, :, 0]).max()
    assert np.abs(st - ref).max() / scale < 3e-4
    # Band power is the Stokes-I psum across channels.
    np.testing.assert_allclose(band, st[:, :, 0].sum(axis=(0, 2)), rtol=1e-5)
