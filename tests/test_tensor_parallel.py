"""Antenna (tensor-parallel) sharding vs the float64 golden model on the
8-virtual-CPU-device mesh: the K-split contraction with a psum of
partial beam voltages before detection (parallel/tensor.py), 1-D over
antennas and composed 2-D chan x ant."""

import jax
import numpy as np
import pytest

from dsabeamformer.config import TINY
from dsabeamformer.ingest.generator import make_noise_block, make_point_source_block
from dsabeamformer.models.calibration import CalTable
from dsabeamformer.models.weights import weights_numpy_golden
from dsabeamformer.ops.reference import beamform_block_ref
from dsabeamformer.parallel.tensor import (
    make_tp_mesh,
    shard_weights_tp,
    tp_beamformer,
    tp_wire_sharding,
)
from dsabeamformer.utils.testing import assert_power_close


def _golden(cfg, wire, cal=None):
    return beamform_block_ref(
        weights_numpy_golden(cfg, cal=cal), wire, cfg.input_layout,
        cfg.navg_time, cfg.navg_freq,
    )


@pytest.mark.parametrize("mode,rtol", [("f32", 1e-5), ("int8x2", 3e-4),
                                       ("bf16x2", 1e-4)])
def test_antenna_sharded_matches_golden(mode, rtol):
    cfg = TINY.replace(weight_mode=mode)  # n_ant=16 -> 2 groups of 8
    mesh = make_tp_mesh(1, 2)
    cal = CalTable.random(cfg, seed=5)
    wire = make_noise_block(cfg, rms=2.0, seed=11)
    qw = shard_weights_tp(cfg, mesh, cal=cal)
    step = tp_beamformer(cfg, mesh)
    wire_sh = jax.device_put(np.asarray(wire), tp_wire_sharding(cfg, mesh))
    p = np.asarray(step(wire_sh, qw))
    assert p.shape == cfg.out_block_shape
    assert_power_close(p, _golden(cfg, wire, cal=cal), rtol=rtol,
                       what=f"antenna-sharded {mode}")


def test_chan_x_ant_2d_mesh():
    """Composed 2-D mesh: channels collective-free, antennas psum."""
    cfg = TINY.replace(n_chan=8, n_chan_total=8)
    mesh = make_tp_mesh(4, 2)  # 4 chan shards x 2 antenna groups
    wire = make_noise_block(cfg, rms=2.0, seed=13)
    qw = shard_weights_tp(cfg, mesh)
    step = tp_beamformer(cfg, mesh)
    wire_sh = jax.device_put(np.asarray(wire), tp_wire_sharding(cfg, mesh))
    p = np.asarray(step(wire_sh, qw))
    assert_power_close(p, _golden(cfg, wire), rtol=3e-4, what="2-D chan x ant")


def test_antenna_sharded_point_source_peak():
    cfg = TINY
    mesh = make_tp_mesh(2, 4)  # 8 antennas... 16/4 = 4 -> not mult of 8
    # 16 antennas / 4 groups = 4 rows each: rejected (sub-sublane shards)
    with pytest.raises(ValueError, match="multiple of 8"):
        tp_beamformer(cfg, mesh)

    mesh = make_tp_mesh(2, 2)
    angles = cfg.beam_angles_rad()
    target = 9
    wire = make_point_source_block(cfg, angles[target], noise_rms=0.2, seed=3)
    qw = shard_weights_tp(cfg, mesh)
    step = tp_beamformer(cfg, mesh)
    wire_sh = jax.device_put(np.asarray(wire), tp_wire_sharding(cfg, mesh))
    p = np.asarray(step(wire_sh, qw))
    assert int(np.argmax(p.sum(axis=(0, 1)))) == target
    assert_power_close(p, _golden(cfg, wire), what="tp point source")


def test_unsupported_mode_rejected():
    cfg = TINY.replace(weight_mode="int12")
    mesh = make_tp_mesh(1, 2)
    with pytest.raises(ValueError, match="antenna sharding supports"):
        tp_beamformer(cfg, mesh)



def test_antenna_sharded_stokes():
    """Full Stokes over the TP psum: all planes match the golden."""
    from dsabeamformer.ops.reference import beamform_stokes_ref

    cfg = TINY.replace(weight_mode="f32")
    mesh = make_tp_mesh(2, 2)
    wire = make_noise_block(cfg, rms=2.0, seed=31)
    qw = shard_weights_tp(cfg, mesh)
    step = tp_beamformer(cfg, mesh, products="stokes")
    wire_sh = jax.device_put(np.asarray(wire), tp_wire_sharding(cfg, mesh))
    st = np.asarray(step(wire_sh, qw))
    ref = beamform_stokes_ref(
        weights_numpy_golden(cfg), wire, cfg.input_layout, cfg.navg_time,
        cfg.navg_freq,
    )
    assert st.shape == ref.shape
    scale = np.abs(ref[:, :, 0]).max()
    assert np.abs(st - ref).max() / scale < 1e-5
