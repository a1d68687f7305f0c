"""Quick-look waterfall (utils/quicklook.py + `dsabf waterfall`):
format sniffing over both product formats, block-mean downsampling,
robust contrast, ASCII/PGM rendering, and the CLI wiring."""

import numpy as np
import pytest

import dsabeamformer.utils.quicklook as dedisperse_mod
from dsabeamformer.utils.quicklook import (
    ASCII_RAMP,
    downsample_mean,
    load_dynamic_spectrum,
    percentile_scale,
    render_ascii,
    write_pgm,
)


def test_downsample_mean_partitions_every_pixel():
    """Every input pixel lands in exactly one output cell: the grand
    mean is preserved exactly (weighted by cell counts)."""
    rng = np.random.default_rng(0)
    x = rng.uniform(0, 5, (37, 53))
    small = downsample_mean(x, 8, 7)
    assert small.shape == (8, 7)
    tb = np.linspace(0, 37, 9).astype(int)
    fb = np.linspace(0, 53, 8).astype(int)
    counts = np.diff(tb)[:, None] * np.diff(fb)[None, :]
    np.testing.assert_allclose((small * counts).sum(), x.sum(), rtol=1e-12)
    # A single hot pixel brightens its cell, never vanishes.
    x2 = np.zeros((37, 53))
    x2[19, 30] = 1000.0
    s2 = downsample_mean(x2, 8, 7)
    assert (s2 > 0).sum() == 1


def test_downsample_no_upscale_and_errors():
    x = np.arange(12.0).reshape(3, 4)
    assert downsample_mean(x, 100, 100).shape == (3, 4)
    np.testing.assert_allclose(downsample_mean(x, 100, 100), x)
    with pytest.raises(ValueError):
        downsample_mean(np.zeros((0, 4)), 8, 8)
    with pytest.raises(ValueError):
        downsample_mean(np.zeros(5), 8, 8)


def test_percentile_scale_robust_to_rfi_and_degenerate():
    x = np.ones((10, 10))
    x[0, 0] = 1e9  # one RFI pixel must not flatten the frame
    y = percentile_scale(x)
    assert y[0, 0] == 1.0
    # the clean pixels keep a defined (clipped) level, not ~0/NaN
    assert np.isfinite(y).all()
    # constant input -> mid-gray, no divide-by-zero
    np.testing.assert_array_equal(percentile_scale(np.full((4, 4), 7.0)), 0.5)
    # NaN/inf pixels clip to window edges
    x2 = np.outer(np.arange(10.0), np.ones(10))
    x2[3, 3] = np.nan
    x2[4, 4] = np.inf
    y2 = percentile_scale(x2)
    assert y2[3, 3] == 0.0 and y2[4, 4] == 1.0


def test_render_ascii_ramp_and_shape():
    scaled = np.array([[0.0, 0.5], [0.999, 1.0]])
    lines = render_ascii(scaled).split("\n")
    assert len(lines) == 2 and all(len(l) == 2 for l in lines)
    assert lines[0][0] == ASCII_RAMP[0]
    assert lines[1][1] == ASCII_RAMP[-1]


def test_write_pgm_roundtrip(tmp_path):
    scaled = np.linspace(0, 1, 12).reshape(3, 4)
    p = tmp_path / "x.pgm"
    write_pgm(p, scaled)
    raw = p.read_bytes()
    assert raw.startswith(b"P5\n4 3\n255\n")
    data = np.frombuffer(raw.split(b"255\n", 1)[1], np.uint8).reshape(3, 4)
    np.testing.assert_array_equal(data, np.round(scaled * 255))


def _write_product(tmp_path, cfg, wires, name="out.dada"):
    from dsabeamformer.models.weights import make_weights
    from dsabeamformer.ops.quantize import quantize_weights
    from dsabeamformer.pipeline import FileSink, FileSource, run_stream

    raw = tmp_path / "cap.raw"
    raw.write_bytes(b"".join(w.tobytes() for w in wires))
    qw = quantize_weights(make_weights(cfg), cfg.weight_mode, cfg.a_compute)
    sink = FileSink(tmp_path / name, cfg)
    run_stream(cfg, qw, FileSource(cfg, raw), sink)
    sink.close()
    return tmp_path / name


def test_load_dynamic_spectrum_dada(tiny_cfg, tmp_path):
    from dsabeamformer.ingest.generator import make_noise_block
    from dsabeamformer.ingest.dada import read_product_file

    cfg = tiny_cfg
    wires = [make_noise_block(cfg, rms=2.0, seed=s) for s in (51, 52)]
    path = _write_product(tmp_path, cfg, wires)
    meta, x = load_dynamic_spectrum(path, beam=1)
    f_out, t_out, _ = cfg.out_block_shape
    assert meta["format"] == "dada" and meta["beam"] == 1
    assert x.shape == (2 * t_out, f_out)
    _, powers = read_product_file(path)
    np.testing.assert_allclose(x[:t_out], powers[0, :, :, 1].T)
    np.testing.assert_allclose(x[t_out:], powers[1, :, :, 1].T)
    with pytest.raises(ValueError, match="beam"):
        load_dynamic_spectrum(path, beam=cfg.n_beams)
    with pytest.raises(ValueError, match="stokes"):
        load_dynamic_spectrum(path, stokes="X")


def test_load_dynamic_spectrum_fil(tiny_cfg, tmp_path):
    from dsabeamformer.ingest.sigproc import FilterbankSink

    cfg = tiny_cfg
    f_out, t_out, b_out = cfg.out_block_shape
    rng = np.random.default_rng(3)
    blk = rng.uniform(0.5, 2.0, (f_out, t_out, b_out)).astype(np.float32)
    sink = FilterbankSink(tmp_path / "fil", cfg, beams=[2])
    sink.write(0, blk)
    sink.close()
    meta, x = load_dynamic_spectrum(tmp_path / "fil" / "beam0002.fil")
    assert meta["format"] == "sigproc"
    assert x.shape == (t_out, f_out)
    # .fil stores descending frequency; the loader flips back to the
    # kernel's ascending order so both formats render identically
    np.testing.assert_allclose(x, blk[:, :, 2].T)
    assert meta["f_lo_mhz"] < meta["f_hi_mhz"]
    # Q/U/V from a power-only (nifs=1) file must error, not render I
    with pytest.raises(ValueError, match="nifs=1"):
        load_dynamic_spectrum(tmp_path / "fil" / "beam0002.fil", stokes="V")


def test_formats_agree_on_orientation(tiny_cfg, tmp_path):
    """The same observation rendered from .fil and .dada output is the
    SAME image: equal dynamic spectra and band edges (the .fil flip is
    undone by the loader)."""
    from dsabeamformer.ingest.generator import make_noise_block
    from dsabeamformer.ingest.sigproc import FilterbankSink
    from dsabeamformer.models.weights import make_weights
    from dsabeamformer.ops.quantize import quantize_weights
    from dsabeamformer.pipeline import FileSource, run_stream

    cfg = tiny_cfg
    wires = [make_noise_block(cfg, rms=2.0, seed=91)]
    dada = _write_product(tmp_path, cfg, wires)
    raw = tmp_path / "cap.raw"
    qw = quantize_weights(make_weights(cfg), cfg.weight_mode, cfg.a_compute)
    fsink = FilterbankSink(tmp_path / "fil", cfg, beams=[1])
    run_stream(cfg, qw, FileSource(cfg, raw), fsink)
    fsink.close()
    m_f, x_f = load_dynamic_spectrum(tmp_path / "fil" / "beam0001.fil")
    m_d, x_d = load_dynamic_spectrum(dada, beam=1)
    np.testing.assert_allclose(x_f, x_d, rtol=1e-6)
    assert m_f["f_lo_mhz"] == pytest.approx(m_d["f_lo_mhz"])
    assert m_f["f_hi_mhz"] == pytest.approx(m_d["f_hi_mhz"])
    # power-only DADA products reject Q/U/V too
    with pytest.raises(ValueError, match="power-only"):
        load_dynamic_spectrum(dada, stokes="Q")


def test_cmd_waterfall_end_to_end(tiny_cfg, tmp_path, capsys):
    from dsabeamformer.cli import main as cli_main
    from dsabeamformer.ingest.generator import make_noise_block

    cfg = tiny_cfg
    wires = [make_noise_block(cfg, rms=2.0, seed=s) for s in (61, 62)]
    path = _write_product(tmp_path, cfg, wires)
    pgm = tmp_path / "wf.pgm"
    rc = cli_main(["waterfall", str(path), "--beam", "1",
                   "--rows", "8", "--cols", "16", "--out", str(pgm)])
    assert rc == 0
    out = capsys.readouterr().out
    lines = out.rstrip("\n").split("\n")
    assert lines[0].startswith("#") and "beam=1" in lines[0]
    f_out, t_out, _ = cfg.out_block_shape
    rows = min(8, 2 * t_out)
    cols = min(16, f_out)
    assert len(lines) == 1 + rows and len(lines[1]) == cols
    assert pgm.read_bytes().startswith(
        f"P5\n{cols} {rows}\n255\n".encode())
    # missing file -> clean error
    assert cli_main(["waterfall", str(tmp_path / "nope.fil")]) == 1


def test_cmd_waterfall_full_pgm_and_fil(tiny_cfg, tmp_path, capsys):
    from dsabeamformer.cli import main as cli_main
    from dsabeamformer.ingest.sigproc import FilterbankSink

    cfg = tiny_cfg
    f_out, t_out, b_out = cfg.out_block_shape
    blk = np.full((f_out, t_out, b_out), 3.0, np.float32)
    sink = FilterbankSink(tmp_path / "fil", cfg, beams=[0])
    sink.write(0, blk)
    sink.close()
    pgm = tmp_path / "native.pgm"
    rc = cli_main(["waterfall", str(tmp_path / "fil" / "beam0000.fil"),
                   "--out", str(pgm), "--full"])
    assert rc == 0
    assert pgm.read_bytes().startswith(
        f"P5\n{f_out} {t_out}\n255\n".encode())
    # constant product renders the mid-gray ramp char, not a crash
    frame = capsys.readouterr().out.split("\n")[1]
    assert set(frame) == {ASCII_RAMP[len(ASCII_RAMP) // 2]}


def test_cmd_waterfall_clip_validation(tiny_cfg, tmp_path, capsys):
    from dsabeamformer.cli import main as cli_main
    from dsabeamformer.ingest.sigproc import FilterbankSink

    cfg = tiny_cfg
    f_out, t_out, b_out = cfg.out_block_shape
    sink = FilterbankSink(tmp_path / "fil", cfg, beams=[0])
    sink.write(0, np.ones((f_out, t_out, b_out), np.float32))
    sink.close()
    fil = str(tmp_path / "fil" / "beam0000.fil")
    for bad in (["1", "101"], ["-2", "99"], ["60", "40"]):
        assert cli_main(["waterfall", fil, "--clip", *bad]) == 1
        assert "error: --clip" in capsys.readouterr().err


def test_incoherent_dada_product_and_waterfall(tiny_cfg, tmp_path, capsys):
    """--incoherent-file with a .dada path now writes a parseable
    product (PAYLOAD=INCOHERENT_POWER, no beam axis); read_product_file
    and dsabf waterfall both handle it."""
    from dsabeamformer.cli import main as cli_main
    from dsabeamformer.ingest.dada import read_product_file
    from dsabeamformer.ingest.generator import make_noise_block
    from dsabeamformer.ops.incoherent import incoherent_power_golden

    cfg = tiny_cfg
    wires = [make_noise_block(cfg, rms=2.0, seed=s) for s in (71, 72)]
    raw = tmp_path / "cap.raw"
    raw.write_bytes(b"".join(w.tobytes() for w in wires))
    out = tmp_path / "out.dada"
    inco = tmp_path / "inco.dada"
    rc = cli_main(["run", "--config", "tiny", "--input-file", str(raw),
                   "--output-file", str(out),
                   "--incoherent-file", str(inco)])
    assert rc == 0
    hdr, p = read_product_file(inco)
    assert hdr["PAYLOAD"] == "INCOHERENT_POWER"
    f_out, t_out, _ = cfg.out_block_shape
    assert p.shape == (2, f_out, t_out)
    for i, w in enumerate(wires):
        np.testing.assert_allclose(p[i], incoherent_power_golden(w, cfg),
                                   rtol=1e-5)
    capsys.readouterr()
    rc = cli_main(["waterfall", str(inco), "--rows", "6", "--cols", "8"])
    assert rc == 0
    head = capsys.readouterr().out.splitlines()[0]
    assert "beam=incoherent" in head
    # Q on an incoherent product errors cleanly
    assert cli_main(["waterfall", str(inco), "--stokes", "Q"]) == 1


def test_dedisperse_aligns_synthetic_pulse():
    """A pulse injected with the cold-plasma delay curve lines up in
    one time bin after dedispersing at the true DM; DM 0 is identity;
    vacated samples are median-filled."""
    from dsabeamformer.utils.quicklook import DM_CONST_S, dedisperse

    meta = {"f_lo_mhz": 1280.0, "f_hi_mhz": 1530.0, "tsamp_s": 1e-3}
    t, nf, dm, t0 = 256, 32, 50.0, 10
    freqs = np.linspace(meta["f_lo_mhz"], meta["f_hi_mhz"], nf)
    shifts = np.rint(DM_CONST_S * dm * (freqs**-2 - meta["f_hi_mhz"]**-2)
                     / meta["tsamp_s"]).astype(int)
    x = np.ones((t, nf))
    for c, s in enumerate(shifts):
        x[t0 + s, c] = 100.0  # pulse arrives later at lower freqs
    d = dedisperse(x, meta, dm)
    assert (d[t0] == 100.0).all()  # aligned
    assert (d == 100.0).sum() == nf  # exactly one pulse sample per chan
    np.testing.assert_array_equal(dedisperse(x, meta, 0.0), x)
    # vacated tail samples carry the channel median (1.0)
    assert (d[-shifts.max():, 0] == 1.0).all()
    with pytest.raises(ValueError, match="DM"):
        dedisperse(x, meta, -1.0)
    with pytest.raises(ValueError, match="tsamp_s"):
        dedisperse(x, {"f_lo_mhz": 1.0, "f_hi_mhz": 2.0}, 10.0)


def test_cmd_waterfall_dm(tiny_cfg, tmp_path, capsys):
    from dsabeamformer.cli import main as cli_main
    from dsabeamformer.ingest.generator import make_noise_block

    cfg = tiny_cfg
    wires = [make_noise_block(cfg, rms=2.0, seed=s) for s in (75, 76)]
    path = _write_product(tmp_path, cfg, wires)
    rc = cli_main(["waterfall", str(path), "--beam", "1",
                   "--rows", "6", "--cols", "10", "--dm", "25"])
    assert rc == 0
    out = capsys.readouterr().out
    assert "DM 25" in out.splitlines()[0]
    prof = [l for l in out.splitlines() if l.startswith("# profile")]
    assert len(prof) == 1 and "@ DM 25" in prof[0]


def _pulse_dm(cfg, span_samples, tsamp):
    """DM whose band-edge delay spans ~span_samples at tsamp."""
    from dsabeamformer.config import DM_CONST_S

    f = cfg.freqs_hz() / 1e6
    return span_samples * tsamp / (DM_CONST_S * (f.min()**-2 - f.max()**-2))


def test_dispersed_pulse_end_to_end_recovery(tiny_cfg, tmp_path):
    """Injected-FRB drill: generator -> beamform pipeline -> product ->
    dedisperse at the true DM -> the pulse stands up in one output
    bin; at DM 0 it stays smeared across the sweep."""
    from dsabeamformer.config import DM_CONST_S
    from dsabeamformer.ingest.generator import make_dispersed_pulse_block

    cfg = tiny_cfg.replace(navg_time=2)
    tsamp_out = cfg.sample_period_s * cfg.navg_time
    # band-edge sweep of ~20 OUTPUT bins = 40 raw samples, inside the
    # 64-sample block with t0=4 and the pulse width
    dm = _pulse_dm(cfg, span_samples=20, tsamp=tsamp_out)
    wire = make_dispersed_pulse_block(cfg, dm, t0_sample=4,
                                      width_samples=2 * cfg.navg_time,
                                      amplitude=7.0, noise_rms=0.5, seed=3)
    path = _write_product(tmp_path, cfg, [wire])
    meta, x = load_dynamic_spectrum(path, beam=cfg.n_beams // 2)
    assert meta["tsamp_s"] == pytest.approx(tsamp_out)
    d = dedisperse_mod.dedisperse(x, meta, dm)
    prof_d = d.mean(axis=1)
    prof_0 = x.mean(axis=1)
    # dedispersed: power concentrates -> much higher peak over median
    snr_d = (prof_d.max() - np.median(prof_d)) / (np.median(prof_d) + 1e-30)
    snr_0 = (prof_0.max() - np.median(prof_0)) / (np.median(prof_0) + 1e-30)
    assert snr_d > 2 * snr_0, (snr_d, snr_0)
    # the aligned peak sits near the injected start (output frame)
    assert abs(int(np.argmax(prof_d)) - 4 // cfg.navg_time) <= 2
    # per-channel arrival in the RAW frame follows the delay curve
    f_mhz = cfg.freqs_hz() / 1e6
    want = (4 + np.rint(DM_CONST_S * dm * (f_mhz**-2 - f_mhz.max()**-2)
                        / cfg.sample_period_s)) // cfg.navg_time
    got = x.argmax(axis=0)  # [F] peak sample per channel (ascending)
    assert np.abs(got - want).max() <= 1


def test_cli_simulate_pulse_capture_roundtrip(tiny_cfg, tmp_path, capsys):
    """dsabf simulate --pulse-dm writes a capture whose block 0 carries
    the dispersed pulse; the full CLI chain recovers it."""
    from dsabeamformer.cli import main as cli_main
    from dsabeamformer.config import DM_CONST_S

    cfg = tiny_cfg.replace(navg_time=2)
    f = cfg.freqs_hz() / 1e6
    dm = (20 * cfg.sample_period_s * cfg.navg_time
          / (DM_CONST_S * (f.min() ** -2 - f.max() ** -2)))
    cap = tmp_path / "cap.dada"
    rc = cli_main(["simulate", "--config", "tiny", "--set", "navg_time=2",
                   "--pulse-dm", str(dm), "--pulse-t0", "4",
                   "--pulse-width", "4", "--blocks", "1", "--distinct", "1",
                   "--out-file", str(cap)])
    assert rc == 0
    out = tmp_path / "out.dada"
    rc = cli_main(["run", "--config", "tiny", "--set", "navg_time=2",
                   "--input-file", str(cap), "--output-file", str(out)])
    assert rc == 0
    capsys.readouterr()
    rc = cli_main(["waterfall", str(out), "--beam",
                   str(cfg.n_beams // 2), "--dm", str(dm),
                   "--rows", "32", "--cols", "8"])
    assert rc == 0
    lines = capsys.readouterr().out.splitlines()
    prof = [l for l in lines if l.startswith("# profile")][0]
    # the dedispersed profile's bright char sits at the pulse start
    ramp_part = prof.split(": ", 1)[1]
    assert ramp_part.index(max(ramp_part)) <= max(2, len(ramp_part) // 8)


def test_cli_simulate_pulse_only_first_block(tiny_cfg, tmp_path, capsys):
    """The injected pulse appears ONCE (block 0), not cycled through
    the distinct-block pool; --dm 0 still prints the profile line."""
    from dsabeamformer.cli import main as cli_main
    from dsabeamformer.config import DM_CONST_S
    from dsabeamformer.ingest.dada import read_dada_file
    from dsabeamformer.ops.incoherent import incoherent_power_golden

    cfg = tiny_cfg.replace(navg_time=2)
    f = cfg.freqs_hz() / 1e6
    dm = (10 * cfg.sample_period_s * cfg.navg_time
          / (DM_CONST_S * (f.min() ** -2 - f.max() ** -2)))
    cap = tmp_path / "cap.dada"
    rc = cli_main(["simulate", "--config", "tiny", "--set", "navg_time=2",
                   "--pulse-dm", str(dm), "--pulse-width", "8",
                   "--blocks", "4", "--distinct", "2",
                   "--out-file", str(cap)])
    assert rc == 0
    cfg2, hdr, off = read_dada_file(str(cap), cfg)
    raw = np.fromfile(cap, np.uint8, offset=off)
    blocks = raw.reshape(4, *cfg.wire_block_shape)
    # block 0 is the pulse (max incoherent power well above pure noise)
    p = [incoherent_power_golden(b, cfg).max() for b in blocks]
    assert p[0] > 2 * max(p[1:])
    # blocks 2 (= 0 mod distinct) must NOT repeat the pulse
    assert p[2] <= max(p[1:]) * 1.01
    # --distinct 0 gets a clean error
    assert cli_main(["simulate", "--config", "tiny", "--distinct", "0",
                     "--pulse-dm", "1", "--out-file",
                     str(tmp_path / "x.dada")]) == 2
    # explicit --dm 0 still renders a profile line
    out = tmp_path / "out.dada"
    assert cli_main(["run", "--config", "tiny", "--set", "navg_time=2",
                     "--input-file", str(cap), "--output-file",
                     str(out)]) == 0
    capsys.readouterr()
    assert cli_main(["waterfall", str(out), "--dm", "0",
                     "--rows", "4", "--cols", "4"]) == 0
    text = capsys.readouterr().out
    assert "DM 0" in text and "# profile" in text


def test_fold_spectrogram_recovers_pulsar():
    """Folding at the true period stands the pulse up at its phase;
    a wrong period spreads it; validation errors are clean."""
    from dsabeamformer.utils.quicklook import (
        fold_spectrogram, profile_snr)

    rng = np.random.default_rng(5)
    tsamp, period, t, f = 1e-3, 0.05, 4000, 32  # 50 samples/period
    x = rng.normal(size=(t, f)).astype(np.float32)
    for k in range(int(t * tsamp / period)):  # pulses at phase 0.3
        t0 = int(round((k + 0.3) * period / tsamp))
        if t0 < t:
            x[t0] += 3.0
    prof, counts = fold_spectrogram(x, tsamp, period, n_bins=25)
    snr, peak = profile_snr(prof)
    assert snr > 20
    assert abs((peak + 0.5) / prof.shape[0] - 0.3) < 0.1
    assert counts.sum() == t
    # wrong period: the fold spreads the pulse and S/N collapses
    prof_w, counts_w = fold_spectrogram(x, tsamp, period * 1.37, n_bins=25)
    snr_w, _ = profile_snr(prof_w)
    assert snr_w < snr / 3
    # validation
    with pytest.raises(ValueError, match="exceed"):
        fold_spectrogram(x, tsamp, tsamp / 2)
    with pytest.raises(ValueError, match="2 periods"):
        fold_spectrogram(x[:50], tsamp, period)
    with pytest.raises(ValueError, match="n_bins"):
        fold_spectrogram(x, tsamp, period, n_bins=1)
    # bins are capped at period/tsamp (finer bins would be empty)
    prof_c, _ = fold_spectrogram(x, tsamp, period, n_bins=1000)
    assert prof_c.shape[0] == 50


def test_cmd_fold_end_to_end(tmp_path, capsys):
    """dsabf fold on a synthetic-pulsar .fil: JSON summary carries a
    strong S/N at the injected phase; PGM written; clean errors."""
    import json

    from dsabeamformer.cli import main as cli_main
    from dsabeamformer.ingest.sigproc import _encode_header_dict

    rng = np.random.default_rng(7)
    tsamp, period, t, f = 1e-3, 0.05, 3000, 16
    x = rng.normal(size=(t, f)).astype(np.float32)
    for k in range(int(t * tsamp / period)):
        x[int(round((k + 0.5) * period / tsamp))] += 4.0
    hdr = {"fch1": 1500.0, "foff": -1.0, "nchans": f, "nbits": 32,
           "nifs": 1, "tsamp": tsamp, "ibeam": 0}
    p = tmp_path / "psr.fil"
    with open(p, "wb") as fh:
        fh.write(_encode_header_dict(hdr))
        fh.write(np.ascontiguousarray(x[:, ::-1]).astype("<f4").tobytes())
    out = tmp_path / "fold.pgm"
    rc = cli_main(["fold", str(p), "--period", str(period),
                   "--bins", "20", "--out", str(out)])
    assert rc == 0
    txt = capsys.readouterr().out
    summary = json.loads(txt.strip().splitlines()[-1])
    assert summary["snr"] > 10
    assert abs(summary["peak_phase"] - 0.5) < 0.1
    assert summary["n_periods"] == pytest.approx(60, abs=1)
    assert summary["min_bin_occupancy"] > 0
    assert out.exists()
    assert "# profile(phase):" in txt
    # period shorter than a sample: clean error, not a traceback
    assert cli_main(["fold", str(p), "--period", str(tsamp / 3)]) == 1
    assert "error:" in capsys.readouterr().err


def test_cli_pulsar_fold_drill(tiny_cfg, tmp_path, capsys):
    """simulate --pulse-period -> run -> fold: the injected pulsar
    train survives the full pipeline (phase-coherent across block
    boundaries) and stands up at its phase; a wrong period collapses."""
    import json

    from dsabeamformer.cli import main as cli_main

    cfg = tiny_cfg.replace(navg_time=2)
    period = 16  # wire samples = 8 output samples; 4 pulses/block
    cap = tmp_path / "psr.dada"
    assert cli_main(["simulate", "--config", "tiny", "--set", "navg_time=2",
                     "--pulse-period", str(period), "--pulse-width", "2",
                     "--pulse-t0", "3", "--blocks", "8",
                     "--out-file", str(cap)]) == 0
    out = tmp_path / "out.dada"
    assert cli_main(["run", "--config", "tiny", "--set", "navg_time=2",
                     "--input-file", str(cap),
                     "--output-file", str(out)]) == 0
    capsys.readouterr()
    period_s = period * cfg.sample_period_s
    beam = str(cfg.n_beams // 2)
    rc = cli_main(["fold", str(out), "--period", str(period_s),
                   "--beam", beam, "--bins", "8"])
    assert rc == 0
    summary = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert summary["snr"] > 10
    assert summary["n_periods"] == pytest.approx(32, abs=0.1)
    # pulses start at wire sample 3 -> phase ~3/16 of the period
    assert abs(summary["peak_phase"] - 3 / 16) < 0.2
    # wrong period: the fold spreads the train and S/N collapses
    capsys.readouterr()
    rc = cli_main(["fold", str(out), "--period", str(period_s * 1.29),
                   "--beam", beam, "--bins", "8"])
    assert rc == 0
    s2 = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert s2["snr"] < summary["snr"] / 2
    # period <= width is a clean simulate error
    assert cli_main(["simulate", "--config", "tiny",
                     "--pulse-period", "4", "--pulse-width", "8",
                     "--out-file", str(tmp_path / "x.dada")]) == 2
