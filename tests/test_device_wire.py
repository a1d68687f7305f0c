"""Canonical device-wire forms (cfg.device_wire_shape) must agree with
the 4-D host form and the float64 golden model, and the fused kernel
(Pallas interpreter) must agree with the plain form on both forms, both
layouts, the int8 weight family and both wire widths.

The canonical form is what the streaming driver uploads: a free
host-side view of the capture buffer, so no copy is made to fit it.
"""

import numpy as np
import pytest

from dsabeamformer.ingest.generator import make_noise_block
from dsabeamformer.models.weights import make_weights, weights_numpy_golden
from dsabeamformer.ops.gemm import beamform_power, device_wire_view
from dsabeamformer.ops.quantize import quantize_weights
from dsabeamformer.ops.reference import beamform_block_ref
from dsabeamformer.utils.testing import assert_power_close


@pytest.mark.parametrize("layout", ["ftpa", "tfpa"])
def test_device_form_equals_host_form(tiny_cfg, layout):
    cfg = tiny_cfg.replace(input_layout=layout)
    wire4 = make_noise_block(cfg, rms=2.0, seed=33)
    qw = quantize_weights(make_weights(cfg), cfg.weight_mode, cfg.a_compute)
    p4 = np.asarray(beamform_power(wire4, qw, cfg))
    wire_dev = device_wire_view(wire4, cfg)
    assert wire_dev.shape == cfg.device_wire_shape
    # A view, not a copy: same underlying bytes.
    assert np.asarray(wire_dev).base is not None
    p_dev = np.asarray(beamform_power(wire_dev, qw, cfg))
    np.testing.assert_array_equal(p4, p_dev)


@pytest.mark.parametrize("layout", ["ftpa", "tfpa"])
def test_device_form_vs_golden(tiny_cfg, layout):
    cfg = tiny_cfg.replace(input_layout=layout)
    wire4 = make_noise_block(cfg, rms=2.0, seed=34)
    qw = quantize_weights(make_weights(cfg), cfg.weight_mode, cfg.a_compute)
    p = np.asarray(beamform_power(device_wire_view(wire4, cfg), qw, cfg))
    w = weights_numpy_golden(cfg)
    p_ref = beamform_block_ref(w, wire4, cfg.input_layout, cfg.navg_time,
                               cfg.navg_freq)
    assert_power_close(p, p_ref, rtol=2e-4, what=f"device-wire {layout}")


def test_bad_wire_shape_rejected(tiny_cfg):
    qw = quantize_weights(make_weights(tiny_cfg), tiny_cfg.weight_mode,
                          tiny_cfg.a_compute)
    bad = np.zeros((3, 5), np.uint8)
    with pytest.raises(ValueError, match="neither the canonical"):
        beamform_power(bad, qw, tiny_cfg)


# Small shapes with the preset's structure: the padded 64-slot wire
# (a_compute 32 of 64 slots) and the compact 16-slot wire (all 16).
KERNEL_GEOMETRIES = {
    "dsa10like": dict(n_ant=64, n_ant_active=10, n_beams=32, n_chan=4,
                      n_chan_total=4, t_block=128),
    "compact": dict(n_ant=16, n_ant_active=10, n_beams=32, n_chan=4,
                    n_chan_total=4, t_block=128),
}
KERNEL_CASES = [
    (mode, layout, geom)
    for mode in ("int8x2", "int12", "int13", "int8")
    for layout in ("tfpa", "ftpa")
    for geom in KERNEL_GEOMETRIES
]


def _kernel_case(tiny_cfg, mode, layout, geom, seed):
    cfg = tiny_cfg.replace(weight_mode=mode, input_layout=layout,
                           **KERNEL_GEOMETRIES[geom])
    wire = device_wire_view(make_noise_block(cfg, rms=2.0, seed=seed), cfg)
    qw = quantize_weights(make_weights(cfg), mode, cfg.a_compute)
    return cfg, wire, qw


@pytest.mark.parametrize("mode,layout,geom", KERNEL_CASES)
def test_kernel_power_matches_plain(tiny_cfg, mode, layout, geom):
    """Integer GEMM on both paths: only the f32 averaging order differs."""
    cfg, wire, qw = _kernel_case(tiny_cfg, mode, layout, geom, seed=36)
    p_plain = np.asarray(beamform_power(wire, qw, cfg))
    p_kern = np.asarray(beamform_power(wire, qw, cfg, interpret=True))
    assert p_kern.shape == cfg.out_block_shape
    np.testing.assert_allclose(p_kern, p_plain, rtol=1e-6)


@pytest.mark.parametrize("mode,layout,geom", KERNEL_CASES)
def test_kernel_stokes_matches_plain(tiny_cfg, mode, layout, geom):
    from dsabeamformer.ops.gemm import beamform_stokes

    cfg, wire, qw = _kernel_case(tiny_cfg, mode, layout, geom, seed=37)
    s_plain = np.asarray(beamform_stokes(wire, qw, cfg))
    s_kern = np.asarray(beamform_stokes(wire, qw, cfg, interpret=True))
    assert s_kern.shape == (*cfg.out_block_shape[:2], 4, cfg.n_beams)
    scale = np.abs(s_plain[:, :, 0]).max()
    assert np.abs(s_kern - s_plain).max() <= 1e-6 * scale


@pytest.mark.parametrize("mode,layout,geom", KERNEL_CASES)
def test_kernel_quant8_byte_equal(tiny_cfg, mode, layout, geom):
    """The kernel's in-epilogue uint8 power and Stokes equal the
    two-pass quantizers applied to its own float32 output, byte for
    byte (round half to even, rails, Q/U/V midpoint offset)."""
    import jax

    from dsabeamformer.ingest.sigproc import _get_quant8_stokes
    from dsabeamformer.ops.gemm import beamform_stokes

    cfg, wire, qw = _kernel_case(tiny_cfg, mode, layout, geom, seed=38)
    p32 = np.asarray(beamform_power(wire, qw, cfg, interpret=True))
    scales = (64.0 / np.median(p32)
              * np.linspace(0.5, 3.0, cfg.n_beams)).astype(np.float32)
    sc = jax.device_put(scales)
    got = np.asarray(beamform_power(wire, qw, cfg, interpret=True,
                                    quant8_scales=sc))
    want = np.clip(np.rint(p32 * scales), 0, 255).astype(np.uint8)
    np.testing.assert_array_equal(got, want)
    assert (got == 255).any()
    st = beamform_stokes(wire, qw, cfg, interpret=True)
    got = np.asarray(beamform_stokes(wire, qw, cfg, interpret=True,
                                     quant8_scales=sc))
    np.testing.assert_array_equal(
        got, np.asarray(_get_quant8_stokes()(st, sc)))


@pytest.mark.parametrize("mode,layout,geom", KERNEL_CASES)
def test_kernel_side_outputs(tiny_cfg, mode, layout, geom):
    """Incoherent sum (with a flagged antenna) and the per-tile SK
    partials reduced by the caller, against the standalone passes."""
    from dsabeamformer.ops.incoherent import incoherent_power, sk_block_stats

    cfg, wire, qw = _kernel_case(tiny_cfg, mode, layout, geom, seed=39)
    p0 = np.asarray(beamform_power(wire, qw, cfg, interpret=True))
    p, inco, sk = beamform_power(wire, qw, cfg, interpret=True,
                                 incoherent=True, flag_ants=(2,),
                                 sk_stats=True)
    np.testing.assert_array_equal(np.asarray(p), p0)
    np.testing.assert_array_equal(
        np.asarray(inco), np.asarray(incoherent_power(wire, cfg,
                                                      flag_ants=(2,))))
    ref = sk_block_stats(wire, cfg)
    sk = np.asarray(sk)
    np.testing.assert_allclose(sk[:, 0], np.asarray(ref["s1"]), rtol=1e-6)
    np.testing.assert_allclose(sk[:, 1], np.asarray(ref["s2"]), rtol=1e-6)
