"""PSRDADA file interop (SURVEY.md L1/C3 capability parity): header
parse -> ObsConfig mapping, file round trip, and `dsabf run` on a .dada
capture."""

import json

import numpy as np
import pytest

from dsabeamformer.config import TINY
from dsabeamformer.ingest import dada
from dsabeamformer.ingest.generator import make_noise_block


def test_write_read_roundtrip(tmp_path, tiny_cfg):
    blocks = [make_noise_block(tiny_cfg, seed=s) for s in range(2)]
    path = tmp_path / "cap.dada"
    dada.write_dada_file(path, tiny_cfg, blocks, UTC_START="2026-08-16-00:00:00")
    # Parse against a deliberately different base: every geometry field
    # must come back from the header.
    base = tiny_cfg.replace(n_chan=4, n_chan_total=4, t_block=32,
                            f_start_hz=1e9)
    cfg, h, off = dada.read_dada_file(path, base)
    assert off == dada.DADA_HDR_SIZE
    assert cfg.n_chan == tiny_cfg.n_chan
    assert cfg.n_ant == tiny_cfg.n_ant
    assert cfg.t_block == tiny_cfg.t_block
    assert cfg.input_layout == tiny_cfg.input_layout
    np.testing.assert_allclose(cfg.freqs_hz(), tiny_cfg.freqs_hz())
    assert h["UTC_START"] == "2026-08-16-00:00:00"
    # Raw payload intact after the header block.
    raw = path.read_bytes()[off:]
    assert raw == b"".join(b.tobytes() for b in blocks)


def test_standard_psrdada_keys_only(tmp_path, tiny_cfg):
    """A foreign capture using only classic PSRDADA keys (MHz/us units,
    band-centre FREQ) maps onto the right ObsConfig."""
    df = tiny_cfg.bandwidth_hz / tiny_cfg.n_chan_total
    centre_mhz = (tiny_cfg.f_start_hz + tiny_cfg.n_chan * df / 2) / 1e6
    text = "\n".join([
        "HDR_VERSION 1.0",
        f"HDR_SIZE {dada.DADA_HDR_SIZE}",
        "NBIT 4",
        "NDIM 2",
        f"NPOL {tiny_cfg.n_pol}",
        f"NCHAN {tiny_cfg.n_chan}",
        f"NANT {tiny_cfg.n_ant}",
        f"FREQ {centre_mhz!r}",
        f"BW {tiny_cfg.n_chan * df / 1e6!r}",
        f"TSAMP {tiny_cfg.sample_period_s * 1e6!r}",
        "ORDER TFPA",
    ]) + "\n"
    path = tmp_path / "foreign.dada"
    with open(path, "wb") as f:
        f.write(text.encode().ljust(dada.DADA_HDR_SIZE, b"\0"))
    base = tiny_cfg.replace(f_start_hz=0.9e9)
    cfg, h, off = dada.read_dada_file(path, base)
    assert cfg.n_chan == tiny_cfg.n_chan and cfg.n_ant == tiny_cfg.n_ant
    assert cfg.n_chan_total == tiny_cfg.n_chan_total
    assert cfg.input_layout == "tfpa"
    np.testing.assert_allclose(cfg.freqs_hz(), tiny_cfg.freqs_hz(), rtol=1e-9)
    # n_ant == base's so active count is inherited; all slots assumed
    # live when NANT differs and no NANT_ACTIVE is given.
    cfg2, _, _ = dada.read_dada_file(path, base.replace(n_ant=8,
                                                        n_ant_active=4,
                                                        n_ant_compute=0))
    assert cfg2.n_ant == tiny_cfg.n_ant and cfg2.n_ant_active == tiny_cfg.n_ant


def test_bad_nbit_rejected(tmp_path, tiny_cfg):
    with pytest.raises(ValueError, match="NBIT"):
        dada.config_from_dada_header({"NBIT": "8"}, tiny_cfg)
    with pytest.raises(ValueError, match="ORDER"):
        dada.config_from_dada_header({"ORDER": "TFP"}, tiny_cfg)


def test_sniff(tmp_path, tiny_cfg):
    p1 = tmp_path / "cap.dada"
    dada.write_dada_file(p1, tiny_cfg, [make_noise_block(tiny_cfg, seed=0)])
    assert dada.is_dada_file(p1)
    p2 = tmp_path / "raw.bin"
    p2.write_bytes(make_noise_block(tiny_cfg, seed=0).tobytes())
    assert not dada.is_dada_file(p2)


def test_cli_run_on_dada_file(tmp_path, capsys, tiny_cfg):
    """`dsabf run --input-file x.dada` — header-driven config, outputs
    identical to the raw-file path (VERDICT r1 item 7)."""
    from dsabeamformer import cli

    blocks = [make_noise_block(tiny_cfg, rms=2.0, seed=s) for s in range(2)]
    dpath = tmp_path / "cap.dada"
    dada.write_dada_file(dpath, tiny_cfg, blocks)
    rpath = tmp_path / "cap.raw"
    with open(rpath, "wb") as f:
        for b in blocks:
            f.write(b.tobytes())
    out_d, out_r = tmp_path / "d.out", tmp_path / "r.out"
    # Run the DADA file against a mismatched preset geometry: the
    # header must win.
    rc = cli.main(["run", "--config", "tiny", "--set", "n_chan=4",
                   "--set", "n_chan_total=4",
                   "--input-file", str(dpath), "--output-file", str(out_d)])
    assert rc == 0
    summary = json.loads(capsys.readouterr().out.strip())
    assert summary["blocks"] == 2
    rc = cli.main(["run", "--config", "tiny", "--input-file", str(rpath),
                   "--output-file", str(out_r)])
    assert rc == 0
    capsys.readouterr()
    np.testing.assert_array_equal(
        np.fromfile(out_d, np.float32), np.fromfile(out_r, np.float32)
    )


def test_simulate_to_dada_file_then_run(tmp_path, capsys, tiny_cfg):
    """Full file loop: dsabf simulate --out-file -> dsabf run, with the
    output also DADA-framed."""
    from dsabeamformer import cli

    cap = tmp_path / "cap.dada"
    rc = cli.main(["simulate", "--config", "tiny", "--blocks", "3",
                   "--source-angle", "0.4", "--out-file", str(cap)])
    assert rc == 0
    meta = json.loads(capsys.readouterr().out.strip())
    assert meta["written"] == 3
    out = tmp_path / "powers.dada"
    rc = cli.main(["run", "--config", "tiny", "--input-file", str(cap),
                   "--output-file", str(out)])
    assert rc == 0
    summary = json.loads(capsys.readouterr().out.strip())
    assert summary["blocks"] == 3
    # Output is DADA-framed: header block then f32 powers.
    cfg2, h, off = dada.read_dada_file(out, tiny_cfg)
    assert h["PAYLOAD"] == "BEAM_POWERS"
    payload = np.frombuffer(out.read_bytes()[off:], np.float32)
    assert payload.size == 3 * int(np.prod(tiny_cfg.out_block_shape))
    assert np.isfinite(payload).all()


def test_product_file_roundtrip(tmp_path, tiny_cfg):
    """run --output-file x.dada -> read_product_file recovers the exact
    power blocks (and the Stokes variant its 5-D shape)."""
    from dsabeamformer.ingest import dada
    from dsabeamformer.ingest.generator import make_noise_block
    from dsabeamformer.models.weights import make_weights
    from dsabeamformer.ops.gemm import beamform_power
    from dsabeamformer.ops.quantize import quantize_weights
    from dsabeamformer.pipeline import FileSink, SyntheticSource, run_stream

    cfg = tiny_cfg
    qw = quantize_weights(make_weights(cfg), cfg.weight_mode, cfg.a_compute)
    blocks = [make_noise_block(cfg, rms=2.0, seed=s) for s in range(2)]
    path = str(tmp_path / "prod.dada")
    sink = FileSink(path, cfg)
    run_stream(cfg, qw, SyntheticSource(cfg, blocks, n_blocks=2), sink,
               depth=1)
    sink.close()
    h, powers = dada.read_product_file(path)
    assert h["PAYLOAD"] == "BEAM_POWERS"
    assert powers.shape == (2, *cfg.out_block_shape)
    for seq in range(2):
        expect = np.asarray(beamform_power(blocks[seq], qw, cfg))
        np.testing.assert_array_equal(powers[seq], expect)

    # Stokes product: 5-D with OUT_NSTOKES.
    from dsabeamformer.pipeline import StreamingBeamformer

    spath = str(tmp_path / "stokes.dada")
    ssink = FileSink(spath, cfg, products="stokes")
    bf = StreamingBeamformer(cfg, qw, SyntheticSource(cfg, blocks, 1),
                             ssink, depth=1, products="stokes")
    bf.run()
    ssink.close()
    h, st = dada.read_product_file(spath)
    assert h["PAYLOAD"] == "BEAM_STOKES_IQUV"
    f, t, b = cfg.out_block_shape
    assert st.shape == (1, f, t, 4, b)

    # A voltage capture is rejected.
    vpath = str(tmp_path / "volt.dada")
    dada.write_dada_file(vpath, cfg, [blocks[0]])
    with pytest.raises(ValueError, match="not a beam-product"):
        dada.read_product_file(vpath)


def test_product_file_torn_write_and_extended_header(tmp_path, tiny_cfg):
    """Crash-recovery + header-size edges of read_product_file: a torn
    trailing block is dropped, a header-only file yields [0, ...], and
    an extended (HDR_SIZE > 4096) header parses."""
    import os

    from dsabeamformer.ingest.generator import make_noise_block
    from dsabeamformer.models.weights import make_weights
    from dsabeamformer.ops.quantize import quantize_weights
    from dsabeamformer.pipeline import FileSink, SyntheticSource, run_stream

    cfg = tiny_cfg
    qw = quantize_weights(make_weights(cfg), cfg.weight_mode, cfg.a_compute)
    blocks = [make_noise_block(cfg, rms=2.0, seed=s) for s in range(2)]
    path = str(tmp_path / "torn.dada")
    sink = FileSink(path, cfg)
    run_stream(cfg, qw, SyntheticSource(cfg, blocks, n_blocks=2), sink,
               depth=1)
    sink.close()
    # Tear the last block mid-float (interrupted write).
    full = os.path.getsize(path)
    per_block = int(np.prod(cfg.out_block_shape)) * 4
    os.truncate(path, full - per_block // 2 - 1)
    h, powers = dada.read_product_file(path)
    assert powers.shape[0] == 1  # torn trailing block dropped

    # Header-only file (interrupted before the first block).
    os.truncate(path, dada.DADA_HDR_SIZE)
    h, powers = dada.read_product_file(path)
    assert powers.shape == (0, *cfg.out_block_shape)

    # Extended header: keys past byte 4096 still parse.
    big = str(tmp_path / "big.dada")
    f_out, t_out, b_out = cfg.out_block_shape
    text = dada.encode_header(
        cfg, HDR_SIZE=8192, PAYLOAD="BEAM_POWERS", OUT_DTYPE="float32",
        COMMENT="x" * 5000, OUT_NCHAN=f_out, OUT_NTIME=t_out,
        OUT_NBEAM=b_out,
    ).encode("ascii")
    assert len(text) > 4096
    with open(big, "wb") as f:
        f.write(text.ljust(8192, b"\0"))
        f.write(np.ones(int(np.prod(cfg.out_block_shape)),
                        np.float32).tobytes())
    h, powers = dada.read_product_file(big)
    assert powers.shape == (1, *cfg.out_block_shape)
    assert float(powers[0].max()) == 1.0
