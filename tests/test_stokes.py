"""Full-Stokes fused kernel (ops.gemm.beamform_stokes) vs the float64
golden model.  No reference counterpart (the CUDA pipeline is Stokes I
only, SURVEY.md L5)."""

import numpy as np
import pytest

from dsabeamformer.ingest.generator import (
    make_noise_block,
    make_point_source_block,
)
from dsabeamformer.models.weights import make_weights, weights_numpy_golden
from dsabeamformer.ops.gemm import (
    beamform_power,
    beamform_stokes,
    device_wire_view,
)
from dsabeamformer.ops.packing import pack_4r4i, unpack_4r4i
from dsabeamformer.ops.quantize import quantize_weights
from dsabeamformer.ops.reference import beamform_stokes_ref
from dsabeamformer.utils.testing import assert_power_close


@pytest.mark.parametrize("layout", ["tfpa", "ftpa"])
@pytest.mark.parametrize("mode,rtol", [("int8x2", 3e-4), ("f32", 1e-5)])
def test_stokes_vs_golden(tiny_cfg, layout, mode, rtol):
    cfg = tiny_cfg.replace(input_layout=layout, weight_mode=mode)
    wire = make_noise_block(cfg, rms=2.5, seed=77)
    qw = quantize_weights(make_weights(cfg), mode, cfg.a_compute)
    st = np.asarray(beamform_stokes(device_wire_view(wire, cfg), qw, cfg))
    ref = beamform_stokes_ref(weights_numpy_golden(cfg), wire,
                              cfg.input_layout, cfg.navg_time, cfg.navg_freq)
    assert st.shape == (cfg.n_chan, cfg.t_block // cfg.navg_time, 4,
                        cfg.n_beams)
    # Q/U/V swing negative and through zero; gate each plane against the
    # Stokes-I peak (the natural scale), like the power metric's floor.
    scale = np.abs(ref[:, :, 0]).max()
    for k, name in enumerate("IQUV"):
        err = np.abs(st[:, :, k] - ref[:, :, k]).max() / scale
        assert err <= rtol, (name, err)


def test_stokes_i_equals_power(tiny_cfg):
    cfg = tiny_cfg
    wire = make_noise_block(cfg, rms=2.0, seed=5)
    qw = quantize_weights(make_weights(cfg), cfg.weight_mode, cfg.a_compute)
    st = np.asarray(beamform_stokes(wire, qw, cfg))
    p = np.asarray(beamform_power(wire, qw, cfg))
    np.testing.assert_allclose(st[:, :, 0], p, rtol=1e-6)


def test_fused_stokes_quant8_byte_equal(tiny_cfg):
    """In-epilogue 8-bit Stokes quantization (quant8_scales) is
    byte-identical to the two-pass path (f32 Stokes block -> the
    sink's on-device quantizer), including the Q/U/V midpoint offset."""
    import jax

    from dsabeamformer.ingest.sigproc import _get_quant8_stokes

    cfg = tiny_cfg
    wire = make_noise_block(cfg, rms=2.5, seed=91)
    qw = quantize_weights(make_weights(cfg), cfg.weight_mode, cfg.a_compute)
    f32 = beamform_stokes(wire, qw, cfg)
    # Auto-cal-style scales (I-plane median to mid-rail 64), so the
    # signed-plane midpoint check below is meaningful (arbitrary large
    # scales would rail the payload without exercising the offset).
    med = np.median(np.asarray(f32)[:, :, 0, :], axis=(0, 1))
    scales = (64.0 / med).astype(np.float32)
    want = np.asarray(_get_quant8_stokes()(f32, jax.device_put(scales)))
    got = np.asarray(beamform_stokes(wire, qw, cfg,
                                     quant8_scales=jax.device_put(scales)))
    assert got.dtype == np.uint8
    assert got.shape == (cfg.n_chan, cfg.t_block // cfg.navg_time, 4,
                         cfg.n_beams)
    np.testing.assert_array_equal(got, want)
    # The signed planes really use the midpoint: zero-polarization noise
    # should center Q/U/V near 128 and I near its scaled level.
    assert np.abs(got[:, :, 1:].astype(np.float32).mean() - 128.0) < 8.0


def test_fused_stokes_quant8_requires_navg_freq_1(tiny_cfg):
    import jax

    cfg = tiny_cfg.replace(navg_freq=2)
    wire = make_noise_block(cfg, rms=2.0, seed=3)
    qw = quantize_weights(make_weights(cfg), cfg.weight_mode, cfg.a_compute)
    with pytest.raises(ValueError, match="navg_freq"):
        beamform_stokes(wire, qw, cfg,
                        quant8_scales=jax.device_put(
                            np.ones(cfg.n_beams, np.float32)))


def test_fused_stokes_quant8_pipeline_byte_equal(tiny_cfg, tmp_path,
                                                 monkeypatch):
    """Driver-level equivalence for Stokes products: an 8-bit Stokes
    filterbank run through the fused in-kernel quantizer produces
    byte-identical .fil files to the two-pass device_post path."""
    from dsabeamformer.ingest.sigproc import (
        FilterbankSink,
        read_filterbank,
    )
    from dsabeamformer.pipeline import FileSource, StreamingBeamformer

    cfg = tiny_cfg
    wires = [make_noise_block(cfg, rms=2.0, seed=s) for s in (61, 62, 63)]
    raw = tmp_path / "cap.raw"
    raw.write_bytes(b"".join(w.tobytes() for w in wires))
    qw = quantize_weights(make_weights(cfg), cfg.weight_mode, cfg.a_compute)

    def run_one(name, fused):
        if not fused:
            monkeypatch.setattr(StreamingBeamformer, "_fused_quant8",
                                lambda self: None)
        sink = FilterbankSink(tmp_path / name, cfg, nbits=8,
                              products="stokes")
        bf = StreamingBeamformer(cfg, qw, FileSource(cfg, raw), sink,
                                 products="stokes")
        engaged = []
        orig_step = bf._step
        bf._step = lambda w, q8=None, sk_stats=None: (
            engaged.append(q8 is not None),
            orig_step(w, q8, sk_stats=sk_stats))[1]
        if fused:
            assert bf._fused_quant8() is not None
        bf.run()
        # Block 0 travels f32 (auto-cal); later blocks take the fused
        # path only in the fused run.
        assert engaged == [False] + [fused] * (len(wires) - 1), engaged
        sink.close()
        monkeypatch.undo()
        return sink

    s_fused = run_one("fused", True)
    s_post = run_one("post", False)
    assert s_fused.scales == s_post.scales
    for b in range(cfg.n_beams):
        hf, df = read_filterbank(tmp_path / "fused" / f"beam{b:04d}.fil")
        _, dp = read_filterbank(tmp_path / "post" / f"beam{b:04d}.fil")
        assert hf["nifs"] == 4
        np.testing.assert_array_equal(df, dp)


def test_pure_x_polarization(tiny_cfg):
    """A noiseless X-only source: Q == I, U == V == 0."""
    cfg = tiny_cfg
    wire = np.asarray(
        make_point_source_block(cfg, cfg.beam_angles_rad()[10],
                                noise_rms=0.0, seed=2)
    ).copy()
    # Zero the Y-pol bytes (pol axis is dim 2 of the 4-D host form).
    re, im = unpack_4r4i(wire)
    re[:, :, 1] = 0
    im[:, :, 1] = 0
    wire = pack_4r4i(re, im)
    qw = quantize_weights(make_weights(cfg), "f32", cfg.a_compute)
    st = np.asarray(beamform_stokes(wire, qw, cfg))
    i_pk = np.abs(st[:, :, 0]).max()
    np.testing.assert_allclose(st[:, :, 1], st[:, :, 0], atol=1e-5 * i_pk)
    assert np.abs(st[:, :, 2]).max() <= 1e-5 * i_pk
    assert np.abs(st[:, :, 3]).max() <= 1e-5 * i_pk
