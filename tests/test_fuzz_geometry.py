"""Property test: random valid geometries through the fused kernel vs
the float64 golden model (the plain form on the CPU backend).

The reference was only ever compiled at one geometry; this framework
treats geometry as data, so the accuracy contract must hold across the
config space — antenna counts (with zero padding and auto slicing),
beam counts, odd channel splits, both wire layouts, every
averaging combination.
"""

import numpy as np
import pytest

from dsabeamformer.config import ObsConfig
from dsabeamformer.ingest.generator import make_noise_block
from dsabeamformer.models.calibration import CalTable
from dsabeamformer.models.weights import make_weights, weights_numpy_golden
from dsabeamformer.ops.gemm import beamform_power
from dsabeamformer.ops.quantize import quantize_weights
from dsabeamformer.ops.reference import beamform_block_ref
from dsabeamformer.utils.testing import assert_power_close

MODES = ["int8x2", "int12", "f32", "bf16x2", "int13"]
RTOL = {"int8x2": 3e-4, "int12": 2e-3, "f32": 1e-5, "bf16x2": 3e-4,
        "int13": 1e-3}


def _random_cfg(rng: np.random.Generator, i: int) -> ObsConfig:
    navg_time = int(rng.choice([2, 4, 8, 16]))
    time_tile = navg_time * int(rng.choice([2, 4, 8]))
    t_block = time_tile * int(rng.choice([1, 2, 3]))
    chan_tile = int(rng.choice([1, 2, 4]))
    navg_freq = int(rng.choice([1, 2]))
    n_chan = chan_tile * navg_freq * int(rng.choice([1, 2, 3]))
    n_ant = int(rng.choice([8, 16, 24, 32]))
    n_ant_active = int(rng.integers(2, n_ant + 1))
    n_beams = int(rng.choice([8, 16, 32]))
    return ObsConfig(
        name=f"fuzz{i}",
        n_ant=n_ant,
        n_ant_active=n_ant_active,
        n_beams=n_beams,
        n_chan=n_chan,
        n_chan_total=n_chan * int(rng.choice([1, 4])),
        t_block=t_block,
        navg_time=navg_time,
        navg_freq=navg_freq,
        weight_mode=MODES[i % len(MODES)],
        input_layout=str(rng.choice(["tfpa", "ftpa"])),
    )


@pytest.mark.parametrize("i", range(10))
def test_random_geometry_matches_golden(i):
    rng = np.random.default_rng(1000 + i)
    cfg = _random_cfg(rng, i)
    cal = CalTable.random(cfg, seed=i)
    wire = make_noise_block(cfg, rms=2.0, seed=i)
    qw = quantize_weights(make_weights(cfg, cal=cal), cfg.weight_mode,
                          cfg.a_compute)
    p = np.asarray(beamform_power(wire, qw, cfg))
    assert p.shape == cfg.out_block_shape
    ref = beamform_block_ref(
        weights_numpy_golden(cfg, cal=cal), wire, cfg.input_layout,
        cfg.navg_time, cfg.navg_freq,
    )
    assert_power_close(p, ref, rtol=RTOL[cfg.weight_mode],
                       what=f"{cfg.name} {cfg.weight_mode} "
                            f"A={cfg.n_ant}/{cfg.n_ant_active} "
                            f"a_c={cfg.a_compute} {cfg.input_layout}")
    # The canonical device-wire form must agree bit-for-bit with the
    # 4-D host form at every geometry (both layouts, every mode).
    from dsabeamformer.ops.gemm import device_wire_view

    p_dev = np.asarray(
        beamform_power(device_wire_view(wire, cfg), qw, cfg)
    )
    np.testing.assert_array_equal(p, p_dev)
    # Full-Stokes shares the GEMM with the power path; fuzz it on a
    # third of the geometries (its I plane must match p bit-for-bit in
    # math, and every plane must match the golden).
    if i % 3 == 0:
        from dsabeamformer.ops.gemm import beamform_stokes
        from dsabeamformer.ops.reference import beamform_stokes_ref

        st = np.asarray(beamform_stokes(wire, qw, cfg))
        np.testing.assert_allclose(st[:, :, 0], p, rtol=1e-6)
        st_ref = beamform_stokes_ref(
            weights_numpy_golden(cfg, cal=cal), wire, cfg.input_layout,
            cfg.navg_time, cfg.navg_freq,
        )
        scale = np.abs(st_ref[:, :, 0]).max()
        assert np.abs(st - st_ref).max() / scale <= RTOL[cfg.weight_mode]
