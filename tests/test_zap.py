"""RFI channel zapping (models/weights.zap_weights + `--zap`):
zeroed weight rows make every coherent product read exactly 0 on the
zapped channels, in every quantization mode; the CLI translates
full-band specs into subband frames and masks the data-side
incoherent product."""

import json

import numpy as np
import pytest

from dsabeamformer.models.weights import (
    make_weights,
    parse_zap,
    zap_mask_avg,
    zap_weights,
)


def test_parse_zap():
    assert parse_zap("12,100-103, 5,12") == [5, 12, 100, 101, 102, 103]
    assert parse_zap("") == []
    with pytest.raises(ValueError, match="bad zap range"):
        parse_zap("9-3")
    with pytest.raises(ValueError):
        parse_zap("abc")


def test_zap_weights_exact_zero_all_modes(tiny_cfg):
    """Zapped channels' powers are EXACTLY zero (zero weights quantize
    to zero integers in every mode); unzapped channels are bit-identical
    to the unzapped run (per-channel scales are independent)."""
    import jax

    from dsabeamformer.ingest.generator import make_point_source_block
    from dsabeamformer.ops import beamform_power
    from dsabeamformer.ops.quantize import prepare_weights

    zapped = [1, 3]
    for mode in ("int8x2", "f32", "int13"):
        cfg = tiny_cfg.replace(weight_mode=mode)
        wire = make_point_source_block(
            cfg, angle_rad=cfg.beam_angles_rad()[2], noise_rms=0.5, seed=9)
        w = make_weights(cfg)
        p0 = np.asarray(beamform_power(
            jax.device_put(wire), prepare_weights(cfg, w), cfg))
        pz = np.asarray(beamform_power(
            jax.device_put(wire),
            prepare_weights(cfg, zap_weights(w, zapped, cfg)), cfg))
        # Averaged output groups containing a zapped raw channel:
        g = sorted({c // cfg.navg_freq for c in zapped})
        if cfg.navg_freq == 1:
            assert (pz[zapped] == 0).all(), mode
        keep = [c for c in range(cfg.n_chan // cfg.navg_freq)
                if c not in g or cfg.navg_freq > 1]
        if cfg.navg_freq == 1:
            np.testing.assert_array_equal(pz[keep], p0[keep], err_msg=mode)


def test_zap_weights_range_check(tiny_cfg):
    w = make_weights(tiny_cfg)
    with pytest.raises(ValueError, match="out of range"):
        zap_weights(w, [tiny_cfg.n_chan], tiny_cfg)
    # Empty zap is a no-op passthrough.
    assert zap_weights(w, [], tiny_cfg) is w


def test_zap_mask_avg(tiny_cfg):
    m = zap_mask_avg([0], tiny_cfg)
    assert m.shape == (tiny_cfg.n_chan // tiny_cfg.navg_freq,)
    assert m[0] == 0.0 and (m[1:] == 1.0).all()


def test_cli_run_zap_and_incoherent_mask(tiny_cfg, tmp_path, capsys):
    """End-to-end: --zap zeroes the coherent output channels and masks
    the incoherent product's averaged groups."""
    from dsabeamformer.cli import main as cli_main
    from dsabeamformer.ingest.generator import make_noise_block

    cfg = tiny_cfg
    raw = tmp_path / "cap.raw"
    raw.write_bytes(make_noise_block(cfg, rms=2.0, seed=13).tobytes())
    out = tmp_path / "out.dat"
    inco = tmp_path / "inco.dat"
    rc = cli_main(["run", "--config", "tiny", "--input-file", str(raw),
                   "--output-file", str(out),
                   "--incoherent-file", str(inco),
                   "--zap", f"0,{cfg.n_chan - 1}"])
    assert rc == 0
    f_out, t_out, b_out = cfg.out_block_shape
    p = np.fromfile(out, np.float32).reshape(f_out, t_out, b_out)
    gz = sorted({0 // cfg.navg_freq, (cfg.n_chan - 1) // cfg.navg_freq})
    if cfg.navg_freq == 1:
        assert (p[gz] == 0).all()
        assert (p[1:-1] > 0).all()
    q = np.fromfile(inco, np.float32).reshape(f_out, -1)
    assert (q[gz] == 0).all() and (np.delete(q, gz, axis=0) > 0).all()


def test_cli_zap_subband_frame(tiny_cfg, tmp_path):
    """--zap indices are FULL-band: a subband child zaps only the
    intersection, translated into its local frame."""
    from dsabeamformer.cli import main as cli_main
    from dsabeamformer.ingest.generator import make_noise_block

    cfg = tiny_cfg
    width = cfg.n_chan // 2
    sb = cfg.subband(width, width)
    raw = tmp_path / "cap1.raw"
    raw.write_bytes(make_noise_block(sb, rms=2.0, seed=14).tobytes())
    out = tmp_path / "out1.dat"
    # Zap one channel from each half; only the second-half one is ours.
    rc = cli_main(["run", "--config", "tiny", "--subband", "1/2",
                   "--input-file", str(raw), "--output-file", str(out),
                   "--zap", f"0,{width + 1}"])
    assert rc == 0
    f_out, t_out, b_out = cfg.out_block_shape
    p = np.fromfile(out, np.float32).reshape(f_out // 2, t_out, b_out)
    if cfg.navg_freq == 1:
        assert (p[1] == 0).all()
        assert (np.delete(p, 1, axis=0) > 0).all()


def test_cli_zap_errors(tiny_cfg, tmp_path):
    from dsabeamformer.cli import main as cli_main
    from dsabeamformer.ingest.generator import make_noise_block

    cfg = tiny_cfg
    raw = tmp_path / "cap.raw"
    raw.write_bytes(make_noise_block(cfg, rms=2.0, seed=2).tobytes())
    with pytest.raises(SystemExit, match="out of range"):
        cli_main(["run", "--config", "tiny", "--input-file", str(raw),
                  "--output-file", str(tmp_path / "o.dat"),
                  "--zap", str(cfg.n_chan)])
    with pytest.raises(SystemExit, match="pre-quantized"):
        cli_main(["run", "--config", "tiny", "--input-file", str(raw),
                  "--output-file", str(tmp_path / "o.dat"),
                  "--weights", str(tmp_path / "w.npz"), "--zap", "0"])


def test_cmd_weights_zap_persists(tiny_cfg, tmp_path, capsys):
    """`dsabf weights --zap` bakes the excision into the saved table;
    a run loading it gets the zeroed channels."""
    import jax

    from dsabeamformer.cli import main as cli_main
    from dsabeamformer.ingest.generator import make_noise_block
    from dsabeamformer.ops import beamform_power
    from dsabeamformer.ops.quantize import load_quant_weights

    cfg = tiny_cfg
    wpath = tmp_path / "w.npz"
    rc = cli_main(["weights", "--config", "tiny", "--out", str(wpath),
                   "--zap", "2"])
    assert rc == 0
    qw = load_quant_weights(str(wpath))
    wire = make_noise_block(cfg, rms=2.0, seed=4)
    p = np.asarray(beamform_power(jax.device_put(wire), qw, cfg))
    if cfg.navg_freq == 1:
        assert (p[2] == 0).all() and (np.delete(p, 2, axis=0) > 0).all()
