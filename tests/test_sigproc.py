"""SIGPROC filterbank output (ingest/sigproc.py): header encoding,
per-beam payload layout (descending channels), Stokes nifs=4, beam
selection, multi-block append, and the CLI sink wiring."""

import numpy as np
import pytest

from dsabeamformer.ingest.sigproc import (
    FilterbankSink,
    encode_filterbank_header,
    read_filterbank,
)


def _write_blocks(tmp_path, cfg, blocks, **kw):
    sink = FilterbankSink(tmp_path / "fil", cfg, **kw)
    for seq, blk in enumerate(blocks):
        sink.write(seq, blk)
    sink.close()
    return tmp_path / "fil"


def test_header_roundtrip_and_geometry(tiny_cfg, tmp_path):
    cfg = tiny_cfg
    f_out, t_out, b_out = cfg.out_block_shape
    d = _write_blocks(tmp_path, cfg,
                      [np.zeros((f_out, t_out, b_out), np.float32)])
    hdr, data = read_filterbank(d / "beam0000.fil")
    assert hdr["nchans"] == f_out and hdr["nifs"] == 1
    assert hdr["nbits"] == 32 and hdr["data_type"] == 1
    assert hdr["ibeam"] == 0 and hdr["nbeams"] == cfg.n_beams
    # tsamp = averaged output cadence; fch1 = HIGHEST averaged center,
    # foff negative (descending — the dedispersion tools' convention).
    assert hdr["tsamp"] == pytest.approx(
        cfg.sample_period_s * cfg.navg_time)
    # az_start carries the beam's fan angle (deg)
    assert hdr["az_start"] == pytest.approx(
        np.rad2deg(cfg.beam_angles_rad()[0]))
    df_avg = cfg.bandwidth_hz / cfg.n_chan_total * cfg.navg_freq
    assert hdr["foff"] == pytest.approx(-df_avg / 1e6)
    favg = cfg.freqs_hz().reshape(-1, cfg.navg_freq).mean(axis=1) / 1e6
    assert hdr["fch1"] == pytest.approx(favg[-1])
    assert data.shape == (t_out, 1, f_out)


def test_payload_matches_block_with_channel_flip(tiny_cfg, tmp_path):
    cfg = tiny_cfg
    f_out, t_out, b_out = cfg.out_block_shape
    rng = np.random.default_rng(3)
    blocks = [rng.standard_normal((f_out, t_out, b_out)).astype(np.float32)
              for _ in range(3)]
    d = _write_blocks(tmp_path, cfg, blocks)
    for b in range(b_out):
        hdr, data = read_filterbank(d / f"beam{b:04d}.fil")
        assert data.shape == (3 * t_out, 1, f_out)
        want = np.concatenate(
            [blk[::-1, :, b].T for blk in blocks], axis=0)
        np.testing.assert_array_equal(data[:, 0, :], want)


def test_stokes_nifs4(tiny_cfg, tmp_path):
    cfg = tiny_cfg
    f_out, t_out, b_out = cfg.out_block_shape
    rng = np.random.default_rng(5)
    blk = rng.standard_normal((f_out, t_out, 4, b_out)).astype(np.float32)
    d = _write_blocks(tmp_path, cfg, [blk], products="stokes",
                      beams=[1])
    hdr, data = read_filterbank(d / "beam0001.fil")
    assert hdr["nifs"] == 4
    assert data.shape == (t_out, 4, f_out)
    np.testing.assert_array_equal(
        data, np.transpose(blk[..., 1], (1, 2, 0))[..., ::-1])


def test_beam_selection_and_validation(tiny_cfg, tmp_path):
    cfg = tiny_cfg
    f_out, t_out, b_out = cfg.out_block_shape
    d = _write_blocks(tmp_path, cfg,
                      [np.zeros((f_out, t_out, b_out), np.float32)],
                      beams=[0, 2])
    assert sorted(p.name for p in d.iterdir()) == [
        "beam0000.fil", "beam0002.fil"]
    with pytest.raises(ValueError, match="out of range"):
        FilterbankSink(tmp_path / "bad", cfg, beams=[b_out])
    with pytest.raises(ValueError, match="products"):
        FilterbankSink(tmp_path / "bad2", cfg, products="voltages")


def test_reader_rejects_non_filterbank(tmp_path):
    p = tmp_path / "x.fil"
    p.write_bytes(b"\x04\x00\x00\x00junk")
    with pytest.raises(ValueError):
        read_filterbank(p)


def test_cli_run_writes_filterbank(tiny_cfg, tmp_path):
    """End-to-end through the CLI: simulate a capture file, dsabf run
    --fil-dir, check per-beam files parse and match the golden
    pipeline's per-beam powers."""
    from dsabeamformer.cli import main as cli_main
    from dsabeamformer.ingest.generator import make_noise_block
    from dsabeamformer.models.weights import weights_numpy_golden
    from dsabeamformer.ops.reference import beamform_block_ref

    cfg = tiny_cfg
    wire = make_noise_block(cfg, rms=2.0, seed=8)
    raw = tmp_path / "capture.raw"
    raw.write_bytes(wire.tobytes())
    fil_dir = tmp_path / "fil"
    rc = cli_main([
        "run", "--config", "tiny", "--input-file", str(raw),
        "--fil-dir", str(fil_dir), "--fil-beams", "0,3",
        "--tstart-mjd", "60000.5",
    ])
    assert rc == 0
    ref = beamform_block_ref(weights_numpy_golden(cfg), wire,
                             cfg.input_layout, cfg.navg_time,
                             cfg.navg_freq)
    for b in (0, 3):
        hdr, data = read_filterbank(fil_dir / f"beam{b:04d}.fil")
        assert hdr["tstart"] == pytest.approx(60000.5)
        want = ref[::-1, :, b].T  # [T', F'], descending channels
        scale = np.abs(want).max()
        assert np.abs(data[:, 0, :] - want).max() / scale < 1e-3


def test_cli_fil_dir_exclusive_with_output_file(tiny_cfg, tmp_path):
    from dsabeamformer.cli import main as cli_main

    rc = cli_main([
        "run", "--config", "tiny",
        "--input-file", str(tmp_path / "nope.raw"),
        "--fil-dir", str(tmp_path / "fil"),
        "--output-file", str(tmp_path / "out.dat"),
    ])
    assert rc == 2


def test_8bit_roundtrip_explicit_scale(tiny_cfg, tmp_path):
    cfg = tiny_cfg
    f_out, t_out, b_out = cfg.out_block_shape
    rng = np.random.default_rng(9)
    blk = rng.uniform(0.0, 10.0,
                      (f_out, t_out, b_out)).astype(np.float32)
    sink = FilterbankSink(tmp_path / "f8", cfg, beams=[0], nbits=8,
                          scale=20.0)
    sink.write(0, blk)
    sink.close()
    hdr, data = read_filterbank(tmp_path / "f8" / "beam0000.fil")
    assert hdr["nbits"] == 8 and data.dtype == np.uint8
    want = blk[::-1, :, 0].T
    np.testing.assert_allclose(data[:, 0, :] / 20.0, want,
                               atol=0.5 / 20.0 + 1e-6)


def test_8bit_auto_scale_constant_across_blocks(tiny_cfg, tmp_path):
    cfg = tiny_cfg
    f_out, t_out, b_out = cfg.out_block_shape
    rng = np.random.default_rng(11)
    sink = FilterbankSink(tmp_path / "f8a", cfg, beams=[0], nbits=8)
    assert sink.scales[0] is None  # not calibrated yet
    quiet = rng.uniform(0.5, 1.5, (f_out, t_out, b_out)).astype(np.float32)
    sink.write(0, quiet)
    s0 = sink.scales[0]
    assert s0 is not None and abs(s0 * np.median(quiet[:, :, 0]) - 64.0) < 1.0
    sink.write(1, 100.0 * quiet)  # a later loud block must NOT rescale
    assert sink.scales[0] == s0
    sink.close()
    _, data = read_filterbank(tmp_path / "f8a" / "beam0000.fil")
    # loud block rails at 255 under the frozen scale.
    assert data[t_out:].max() == 255


def test_8bit_stokes_offset_encoding(tiny_cfg, tmp_path):
    """8-bit Stokes: I at offset 0 (reads like a power file), Q/U/V at
    the 128 midpoint, one I-derived scale per beam, offset recorded in
    the sidecar."""
    import json

    from dsabeamformer.ingest.sigproc import STOKES_QUV_OFFSET

    cfg = tiny_cfg
    f_out, t_out, b_out = cfg.out_block_shape
    rng = np.random.default_rng(8)
    blk = np.zeros((f_out, t_out, 4, b_out), np.float32)
    blk[:, :, 0] = rng.uniform(1.0, 3.0, (f_out, t_out, b_out))  # I
    for s in (1, 2, 3):  # |Q/U/V| < I
        blk[:, :, s] = blk[:, :, 0] * rng.uniform(-0.4, 0.4,
                                                  (f_out, t_out, b_out))
    sink = FilterbankSink(tmp_path / "s8", cfg, products="stokes", nbits=8)
    sink.write(0, blk)
    sink.close()
    scale = sink.scales[0]
    hdr, data = read_filterbank(tmp_path / "s8" / "beam0000.fil")
    assert hdr["nifs"] == 4 and hdr["nbits"] == 8
    want = blk[::-1, :, :, 0] * scale  # descending channels
    want[:, :, 1:] += STOKES_QUV_OFFSET
    want = np.clip(np.rint(want), 0, 255)
    # data: [T, 4, F'] -> compare against [F', T, 4]
    np.testing.assert_array_equal(np.transpose(data, (2, 0, 1)), want)
    # I plane median sits at mid-rail 64, Q/U/V near the 128 midpoint
    assert abs(np.median(data[:, 0, :]) - 64) <= 2
    assert abs(np.median(data[:, 1, :].astype(float)) - 128) <= 8
    side = json.loads((tmp_path / "s8" / "scales.json").read_text())
    assert side["__quv_offset__"] == STOKES_QUV_OFFSET
    assert side["beam0000.fil"] == scale


def test_8bit_stokes_device_post_matches_host(tiny_cfg, tmp_path):
    """The on-device Stokes quantizer is byte-identical to the host
    path once scales exist (same scale, same per-IF offsets)."""
    import jax

    cfg = tiny_cfg
    f_out, t_out, b_out = cfg.out_block_shape
    rng = np.random.default_rng(12)
    def mk():
        b = np.zeros((f_out, t_out, 4, b_out), np.float32)
        b[:, :, 0] = rng.uniform(1.0, 3.0, (f_out, t_out, b_out))
        for s in (1, 2, 3):
            b[:, :, s] = b[:, :, 0] * rng.uniform(-0.5, 0.5,
                                                  (f_out, t_out, b_out))
        return b
    b0, b1 = mk(), mk()
    host = FilterbankSink(tmp_path / "h", cfg, products="stokes", nbits=8)
    dev = FilterbankSink(tmp_path / "d", cfg, products="stokes", nbits=8)
    for s, use_dev in ((host, False), (dev, True)):
        out0 = s.device_post(jax.device_put(b0)) if use_dev else b0
        assert np.asarray(out0).dtype == np.float32  # autocal pass
        s.write(0, np.asarray(out0))
        out1 = s.device_post(jax.device_put(b1)) if use_dev else b1
        if use_dev:
            assert np.asarray(out1).dtype == np.uint8
        s.write(1, np.asarray(out1))
        s.close()
    assert host.scales == dev.scales
    for b in range(cfg.n_beams):
        _, dh = read_filterbank(tmp_path / "h" / f"beam{b:04d}.fil")
        _, dd = read_filterbank(tmp_path / "d" / f"beam{b:04d}.fil")
        np.testing.assert_array_equal(dh, dd)


def test_cmd_fil_inspector(tiny_cfg, tmp_path, capsys):
    import json

    from dsabeamformer.cli import main as cli_main

    cfg = tiny_cfg
    f_out, t_out, b_out = cfg.out_block_shape
    blk = np.full((f_out, t_out, b_out), 3.0, np.float32)
    d = _write_blocks(tmp_path, cfg, [blk, blk])
    rc = cli_main(["fil", str(d / "beam0000.fil")])
    assert rc == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["n_samples"] == 2 * t_out and out["finite"]
    assert out["mean"] == pytest.approx(3.0)
    assert out["bandpass_ripple"] == pytest.approx(1.0)
    assert cli_main(["fil", str(tmp_path / "missing.fil")]) == 1


def test_gap_zero_fill_keeps_time_axis_contiguous(tiny_cfg, tmp_path):
    """seq gaps (dropped/skipped blocks) are zero-filled so SIGPROC
    consumers' contiguous-tsamp assumption holds across the splice."""
    cfg = tiny_cfg
    f_out, t_out, b_out = cfg.out_block_shape
    rng = np.random.default_rng(11)
    b0 = rng.uniform(1, 2, (f_out, t_out, b_out)).astype(np.float32)
    b2 = rng.uniform(1, 2, (f_out, t_out, b_out)).astype(np.float32)
    sink = FilterbankSink(tmp_path / "fil", cfg, beams=[1])
    sink.write(0, b0)
    sink.write(2, b2)  # seq 1 dropped
    assert sink.n_splices == 1 and sink.filled_samples == t_out
    sink.close()
    hdr, data = read_filterbank(tmp_path / "fil" / "beam0001.fil")
    assert data.shape[0] == 3 * t_out
    np.testing.assert_array_equal(data[:t_out, 0, :], b0[::-1, :, 1].T)
    assert (data[t_out:2 * t_out] == 0).all()
    np.testing.assert_array_equal(data[2 * t_out:, 0, :], b2[::-1, :, 1].T)


def test_8bit_scales_sidecar_written_on_close(tiny_cfg, tmp_path):
    """scales.json records the per-beam counts-per-unit-power scales
    (no SIGPROC header field exists for them)."""
    import json

    cfg = tiny_cfg
    f_out, t_out, b_out = cfg.out_block_shape
    blk = np.full((f_out, t_out, b_out), 2.0, np.float32)
    sink = FilterbankSink(tmp_path / "fil", cfg, beams=[0, 2], nbits=8)
    sink.write(0, blk)
    scales = sink.scales
    sink.close()
    side = json.loads((tmp_path / "fil" / "scales.json").read_text())
    assert side == {"beam0000.fil": scales[0], "beam0002.fil": scales[2]}
    assert side["beam0000.fil"] == pytest.approx(32.0)  # 64/median(2.0)


def test_truncated_header_clean_error(tiny_cfg, tmp_path):
    """A .fil cut off mid-header raises ValueError (not struct.error),
    so `dsabf fil` reports a clean error."""
    from dsabeamformer.cli import main as cli_main

    cfg = tiny_cfg
    hdr = encode_filterbank_header(cfg, beam=0)
    p = tmp_path / "cut.fil"
    p.write_bytes(hdr[:len(hdr) // 2])
    with pytest.raises(ValueError, match="truncated"):
        read_filterbank(p)
    assert cli_main(["fil", str(p)]) == 1


def test_cli_fil_flag_errors_are_clean_and_prewarmup(tiny_cfg, tmp_path,
                                                     capsys):
    """Bad --fil-scale / --fil-beams fail with rc 2 and a clean error
    BEFORE weight generation + warmup compile."""
    from dsabeamformer.cli import main as cli_main
    from dsabeamformer.ingest.generator import make_noise_block

    raw = tmp_path / "cap.raw"
    raw.write_bytes(make_noise_block(tiny_cfg, rms=2.0, seed=5).tobytes())
    base = ["run", "--config", "tiny", "--input-file", str(raw),
            "--fil-dir", str(tmp_path / "fil")]
    for extra in (["--fil-scale", "bogus"],
                  ["--fil-scale", "-1", "--fil-bits", "8"],
                  ["--fil-beams", "0,99"]):
        capsys.readouterr()
        assert cli_main(base + extra) == 2
        assert "error:" in capsys.readouterr().err


def test_cmd_fil_stokes_bandpass_uses_stokes_i(tiny_cfg, tmp_path, capsys):
    """The inspector's bandpass stats come from IF 0 (Stokes I) only —
    Q/U/V near-zero means must not pollute them."""
    import json

    from dsabeamformer.cli import main as cli_main

    cfg = tiny_cfg
    f_out, t_out, b_out = cfg.out_block_shape
    blk = np.zeros((f_out, t_out, 4, b_out), np.float32)
    blk[:, :, 0, :] = 5.0   # I
    blk[:, :, 1, :] = -4.0  # Q strongly negative
    d = _write_blocks(tmp_path, cfg, [blk], products="stokes")
    rc = cli_main(["fil", str(d / "beam0000.fil")])
    assert rc == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["bandpass_min"] == pytest.approx(5.0)
    assert out["bandpass_ripple"] == pytest.approx(1.0)


def test_device_post_quantizes_on_device_after_autocal(tiny_cfg, tmp_path):
    """The 8-bit sink's device hook: block 0 travels f32 (sets auto
    scales), every later block is quantized ON DEVICE and written as
    uint8 — byte-identical to the host quantization path."""
    import jax

    cfg = tiny_cfg
    f_out, t_out, b_out = cfg.out_block_shape
    rng = np.random.default_rng(17)
    b0, b1 = (rng.uniform(0.5, 3.0, (f_out, t_out, b_out))
              .astype(np.float32) for _ in range(2))
    host = FilterbankSink(tmp_path / "host", cfg, nbits=8)
    dev = FilterbankSink(tmp_path / "dev", cfg, nbits=8)
    for s, use_dev in ((host, False), (dev, True)):
        # block 0: hook passes f32 through (scales unknown)
        out0 = s.device_post(jax.device_put(b0)) if use_dev else b0
        assert np.asarray(out0).dtype == np.float32
        s.write(0, np.asarray(out0))
        out1 = s.device_post(jax.device_put(b1)) if use_dev else b1
        if use_dev:
            assert np.asarray(out1).dtype == np.uint8
        s.write(1, np.asarray(out1))
        s.close()
    assert host.scales == dev.scales
    for b in range(b_out):
        _, dh = read_filterbank(tmp_path / "host" / f"beam{b:04d}.fil")
        _, dd = read_filterbank(tmp_path / "dev" / f"beam{b:04d}.fil")
        np.testing.assert_array_equal(dh, dd)


def test_device_post_explicit_scale_immediate(tiny_cfg, tmp_path):
    """With an explicit --fil-scale the device path engages from block
    0; warmup compiles the quantizer with dummy scales."""
    import jax

    cfg = tiny_cfg
    f_out, t_out, b_out = cfg.out_block_shape
    blk = np.full((f_out, t_out, b_out), 2.0, np.float32)
    sink = FilterbankSink(tmp_path / "fil", cfg, nbits=8, scale=10.0)
    warm = sink.device_post(jax.device_put(blk), warmup=True)
    assert np.asarray(warm).dtype == np.uint8  # compiled, discarded
    out = sink.device_post(jax.device_put(blk))
    assert np.asarray(out).dtype == np.uint8
    sink.write(0, np.asarray(out))
    sink.close()
    _, data = read_filterbank(tmp_path / "fil" / "beam0000.fil")
    assert (data == 20).all()
    # 32-bit sinks pass through untouched.
    s32 = FilterbankSink(tmp_path / "f32", cfg)
    assert s32.device_post(blk) is blk


def test_cli_8bit_run_uses_device_path(tiny_cfg, tmp_path):
    """End-to-end 2-block 8-bit CLI run: the pipeline engages the
    device quantizer from block 1; payload matches the golden powers
    quantized with the block-0 auto scale."""
    import json

    from dsabeamformer.cli import main as cli_main
    from dsabeamformer.ingest.generator import make_noise_block
    from dsabeamformer.models.weights import weights_numpy_golden
    from dsabeamformer.ops.reference import beamform_block_ref

    cfg = tiny_cfg
    wires = [make_noise_block(cfg, rms=2.0, seed=s) for s in (21, 22)]
    raw = tmp_path / "cap.raw"
    raw.write_bytes(b"".join(w.tobytes() for w in wires))
    fil_dir = tmp_path / "fil"
    rc = cli_main(["run", "--config", "tiny", "--input-file", str(raw),
                   "--fil-dir", str(fil_dir), "--fil-bits", "8",
                   "--fil-beams", "2"])
    assert rc == 0
    scale = json.loads((fil_dir / "scales.json").read_text())["beam0002.fil"]
    hdr, data = read_filterbank(fil_dir / "beam0002.fil")
    assert hdr["nbits"] == 8 and data.shape[0] == 2 * cfg.out_block_shape[1]
    refs = [beamform_block_ref(weights_numpy_golden(cfg), w,
                               cfg.input_layout, cfg.navg_time,
                               cfg.navg_freq) for w in wires]
    want = np.concatenate([r[::-1, :, 2].T for r in refs], axis=0)
    want_q = np.clip(np.rint(want * scale), 0, 255)
    # device (block 1) and host (block 0) quantization agree to the
    # golden within 1 count (f32 kernel vs f64 golden rounding).
    assert np.abs(data[:, 0, :].astype(np.int32) - want_q).max() <= 1


def test_fused_quant8_pipeline_byte_equal(tiny_cfg, tmp_path, monkeypatch):
    """Driver-level equivalence: an 8-bit filterbank run through the
    fused in-kernel quantizer (quant8_scales) produces byte-identical
    .fil files to the two-pass device_post path (kernel f32 -> HBM ->
    quantizer).  Block 0 travels f32 either way (auto-cal); every later
    block takes the fused path only in the first run."""
    from dsabeamformer.models.weights import make_weights
    from dsabeamformer.ops.quantize import quantize_weights
    from dsabeamformer.ingest.generator import make_noise_block
    from dsabeamformer.pipeline import (
        FileSource,
        StreamingBeamformer,
    )

    cfg = tiny_cfg
    wires = [make_noise_block(cfg, rms=2.0, seed=s) for s in (31, 32, 33)]
    raw = tmp_path / "cap.raw"
    raw.write_bytes(b"".join(w.tobytes() for w in wires))
    qw = quantize_weights(make_weights(cfg), cfg.weight_mode, cfg.a_compute)

    def run_one(name, fused):
        if not fused:
            monkeypatch.setattr(StreamingBeamformer, "_fused_quant8",
                                lambda self: None)
        sink = FilterbankSink(tmp_path / name, cfg, nbits=8)
        bf = StreamingBeamformer(cfg, qw, FileSource(cfg, raw), sink)
        # Prove the fused kernel actually runs (a depth-2 pipeline
        # could otherwise dispatch every block before block 0's drain
        # sets the auto-cal scales, making this comparison vacuous).
        engaged = []
        orig_step = bf._step
        bf._step = lambda w, q8=None, sk_stats=None: (
            engaged.append(q8 is not None),
            orig_step(w, q8, sk_stats=sk_stats))[1]
        if fused:
            assert bf._fused_quant8() is not None  # hook engaged
        bf.run()
        assert engaged == [False] + [fused] * (len(wires) - 1), engaged
        sink.close()
        monkeypatch.undo()
        return sink

    s_fused = run_one("fused", True)
    s_post = run_one("post", False)
    assert s_fused.scales == s_post.scales
    for b in range(cfg.n_beams):
        _, df = read_filterbank(tmp_path / "fused" / f"beam{b:04d}.fil")
        _, dp = read_filterbank(tmp_path / "post" / f"beam{b:04d}.fil")
        np.testing.assert_array_equal(df, dp)


def test_fused_quant8_hook_gated_to_8bit(tiny_cfg, tmp_path):
    """A 32-bit sink must NOT engage the fused-quant8 pipeline hook
    (warmup would compile a uint8 kernel variant that never runs)."""
    from dsabeamformer.models.weights import make_weights
    from dsabeamformer.ops.quantize import quantize_weights
    from dsabeamformer.ingest.generator import make_noise_block
    from dsabeamformer.pipeline import StreamingBeamformer, SyntheticSource

    cfg = tiny_cfg
    qw = quantize_weights(make_weights(cfg), cfg.weight_mode, cfg.a_compute)
    blocks = [make_noise_block(cfg, rms=2.0, seed=41)]
    s32 = FilterbankSink(tmp_path / "f32", cfg)
    bf = StreamingBeamformer(cfg, qw, SyntheticSource(cfg, blocks, 1), s32)
    assert bf._fused_quant8() is None
    s8 = FilterbankSink(tmp_path / "f8", cfg, nbits=8)
    bf8 = StreamingBeamformer(cfg, qw, SyntheticSource(cfg, blocks, 1), s8)
    assert bf8._fused_quant8() is not None


def test_cli_8bit_stokes_run(tiny_cfg, tmp_path):
    """End-to-end 8-bit Stokes .fil run: device quantizer engages from
    block 1, nifs=4 uint8 payload, sidecar carries the Q/U/V offset."""
    import json

    from dsabeamformer.cli import main as cli_main
    from dsabeamformer.ingest.generator import make_noise_block
    from dsabeamformer.ingest.sigproc import STOKES_QUV_OFFSET

    cfg = tiny_cfg
    wires = [make_noise_block(cfg, rms=2.0, seed=s) for s in (25, 26)]
    raw = tmp_path / "cap.raw"
    raw.write_bytes(b"".join(w.tobytes() for w in wires))
    fil_dir = tmp_path / "fil"
    rc = cli_main(["run", "--config", "tiny", "--input-file", str(raw),
                   "--products", "stokes",
                   "--fil-dir", str(fil_dir), "--fil-bits", "8",
                   "--fil-beams", "1"])
    assert rc == 0
    hdr, data = read_filterbank(fil_dir / "beam0001.fil")
    assert hdr["nifs"] == 4 and hdr["nbits"] == 8
    assert data.dtype == np.uint8
    f_out, t_out, _ = cfg.out_block_shape
    assert data.shape == (2 * t_out, 4, f_out)
    # I near mid-rail 64; Q/U/V near the midpoint (noise: pol ~ 0)
    assert abs(float(np.median(data[:, 0, :])) - 64) < 12
    for s in (1, 2, 3):
        assert abs(float(np.median(data[:, s, :])) - 128) < 8
    side = json.loads((fil_dir / "scales.json").read_text())
    assert side["__quv_offset__"] == STOKES_QUV_OFFSET


def test_splice_subband_filterbanks(tiny_cfg, tmp_path):
    """Per-subband sinks -> dsabf splice == the full-band sink's file,
    byte-for-byte (header geometry and payload)."""
    import json

    from dsabeamformer.cli import main as cli_main
    from dsabeamformer.ingest.sigproc import splice_filterbanks

    cfg = tiny_cfg
    f_out, t_out, b_out = cfg.out_block_shape
    rng = np.random.default_rng(21)
    blk = rng.uniform(0.5, 3.0, (f_out, t_out, b_out)).astype(np.float32)
    # full-band reference file
    full = FilterbankSink(tmp_path / "full", cfg, beams=[1])
    full.write(0, blk)
    full.close()
    # two subband children (the launch split): each writes its slice
    n_sub = 2
    w = cfg.n_chan // n_sub
    parts = []
    for i in range(n_sub):
        sub = cfg.subband(i * w, w)
        sink = FilterbankSink(tmp_path / f"sub{i}", sub, beams=[1])
        lo, hi = i * w // cfg.navg_freq, (i + 1) * w // cfg.navg_freq
        sink.write(0, blk[lo:hi])
        sink.close()
        parts.append(tmp_path / f"sub{i}" / "beam0001.fil")
    out = tmp_path / "merged.fil"
    hdr = splice_filterbanks(parts, out)
    h_full, d_full = read_filterbank(tmp_path / "full" / "beam0001.fil")
    h_m, d_m = read_filterbank(out)
    assert h_m["nchans"] == h_full["nchans"]
    assert h_m["fch1"] == pytest.approx(h_full["fch1"])
    assert h_m["foff"] == pytest.approx(h_full["foff"])
    np.testing.assert_array_equal(d_m, d_full)
    assert hdr["_dropped_samples"] == 0
    # CLI wrapper + JSON line
    out2 = tmp_path / "merged2.fil"
    assert cli_main(["splice", *map(str, reversed(parts)),
                     "--out", str(out2)]) == 0
    _, d2 = read_filterbank(out2)
    np.testing.assert_array_equal(d2, d_full)


def test_splice_rejects_mismatched_inputs(tiny_cfg, tmp_path):
    from dsabeamformer.ingest.sigproc import splice_filterbanks

    cfg = tiny_cfg
    f_out, t_out, b_out = cfg.out_block_shape
    blk = np.ones((f_out, t_out, b_out), np.float32)
    a = FilterbankSink(tmp_path / "a", cfg, beams=[0])
    a.write(0, blk)
    a.close()
    b = FilterbankSink(tmp_path / "b", cfg, beams=[0])  # same band!
    b.write(0, blk)
    b.close()
    with pytest.raises(ValueError, match="tile contiguously"):
        splice_filterbanks([tmp_path / "a" / "beam0000.fil",
                            tmp_path / "b" / "beam0000.fil"],
                           tmp_path / "x.fil")
    # different nbits
    c8 = FilterbankSink(tmp_path / "c8", cfg.subband(0, cfg.n_chan // 2),
                        beams=[0], nbits=8, scale=10.0)
    c8.write(0, blk[: f_out // 2])
    c8.close()
    d32 = FilterbankSink(tmp_path / "d32",
                         cfg.subband(cfg.n_chan // 2, cfg.n_chan // 2),
                         beams=[0])
    d32.write(0, blk[f_out // 2:])
    d32.close()
    with pytest.raises(ValueError, match="nbits"):
        splice_filterbanks([tmp_path / "c8" / "beam0000.fil",
                            tmp_path / "d32" / "beam0000.fil"],
                           tmp_path / "y.fil")


def test_splice_8bit_scale_mismatch_warns(tiny_cfg, tmp_path, capsys):
    """8-bit subbands with different auto scales merge, but the CLI
    warns about the stepped bandpass; identical explicit scales don't."""
    from dsabeamformer.cli import main as cli_main

    cfg = tiny_cfg
    f_out, t_out, b_out = cfg.out_block_shape
    w = cfg.n_chan // 2

    def sub_fil(i, blk, **kw):
        sub = cfg.subband(i * w, w)
        sink = FilterbankSink(tmp_path / f"s{i}{kw.get('scale','a')}",
                              sub, beams=[0], nbits=8, **kw)
        lo, hi = i * w // cfg.navg_freq, (i + 1) * w // cfg.navg_freq
        sink.write(0, blk[lo:hi])
        sink.close()
        return tmp_path / f"s{i}{kw.get('scale','a')}" / "beam0000.fil"

    rng = np.random.default_rng(31)
    blk = rng.uniform(0.5, 2.0, (f_out, t_out, b_out)).astype(np.float32)
    blk[f_out // 2:] *= 10  # second subband auto-calibrates 10x lower
    parts = [sub_fil(0, blk), sub_fil(1, blk)]
    assert cli_main(["splice", *map(str, parts),
                     "--out", str(tmp_path / "m8.fil")]) == 0
    assert "stepped bandpass" in capsys.readouterr().err
    # explicit shared scale: clean
    parts = [sub_fil(0, blk, scale=5.0), sub_fil(1, blk, scale=5.0)]
    assert cli_main(["splice", *map(str, parts),
                     "--out", str(tmp_path / "m8b.fil")]) == 0
    assert "stepped bandpass" not in capsys.readouterr().err


def test_splice_edge_cases(tiny_cfg, tmp_path, capsys):
    """Straggler trim, out==input guard, empty input, missing sidecars,
    and the consistent-scale sidecar carry-forward."""
    import json

    from dsabeamformer.cli import main as cli_main
    from dsabeamformer.ingest.sigproc import splice_filterbanks

    cfg = tiny_cfg
    f_out, t_out, b_out = cfg.out_block_shape
    w = cfg.n_chan // 2
    blk = np.full((f_out, t_out, b_out), 2.0, np.float32)

    def sub_fil(i, name, n_blocks=1, **kw):
        sub = cfg.subband(i * w, w)
        sink = FilterbankSink(tmp_path / name, sub, beams=[0], **kw)
        lo, hi = i * w // cfg.navg_freq, (i + 1) * w // cfg.navg_freq
        for s in range(n_blocks):
            sink.write(s, blk[lo:hi])
        sink.close()
        return tmp_path / name / "beam0000.fil"

    # straggler: subband 1 wrote one block fewer
    a = sub_fil(0, "tr0", n_blocks=3)
    b = sub_fil(1, "tr1", n_blocks=2)
    hdr = splice_filterbanks([a, b], tmp_path / "trim.fil")
    assert hdr["_n_samples"] == 2 * t_out
    assert hdr["_dropped_samples"] == t_out
    _, d = read_filterbank(tmp_path / "trim.fil")
    assert d.shape[0] == 2 * t_out
    # out == input
    with pytest.raises(ValueError, match="also\\s+an input"):
        splice_filterbanks([a, b], a)
    # empty input list
    with pytest.raises(ValueError, match="no input"):
        splice_filterbanks([], tmp_path / "x.fil")
    # 8-bit with DELETED sidecars: unknown scales must warn
    a8 = sub_fil(0, "u0", nbits=8, scale=5.0)
    b8 = sub_fil(1, "u1", nbits=8, scale=5.0)
    (tmp_path / "u0" / "scales.json").unlink()
    (tmp_path / "u1" / "scales.json").unlink()
    assert cli_main(["splice", str(a8), str(b8),
                     "--out", str(tmp_path / "u.fil")]) == 0
    assert "UNKNOWN" in capsys.readouterr().err
    # consistent scales: sidecar carried forward next to the output
    a8 = sub_fil(0, "c0", nbits=8, scale=5.0)
    b8 = sub_fil(1, "c1", nbits=8, scale=5.0)
    out = tmp_path / "merged" / "full.fil"
    out.parent.mkdir()
    splice_filterbanks([a8, b8], out)
    side = json.loads((out.parent / "scales.json").read_text())
    assert side["full.fil"] == 5.0
