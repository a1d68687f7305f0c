"""Bad-antenna excision (models/weights.flag_antennas + `--flag-ants`):
zeroed weight columns remove an antenna from every coherent product;
the data-side incoherent sum excludes it via a compile-time mask in the
fused kernel (and in the standalone incoherent_power)."""

import numpy as np
import pytest

from dsabeamformer.models.weights import flag_antennas, make_weights


def test_flag_antennas_matches_golden(tiny_cfg):
    """Flagging on the device path == zeroing the same antennas in the
    float64 golden weights (the oracle for what excision means)."""
    import jax

    from dsabeamformer.ingest.generator import make_point_source_block
    from dsabeamformer.models.weights import weights_numpy_golden
    from dsabeamformer.ops import beamform_power
    from dsabeamformer.ops.quantize import prepare_weights
    from dsabeamformer.ops.reference import beamform_block_ref
    from dsabeamformer.utils.testing import relative_power_error

    cfg = tiny_cfg
    flags = [0, cfg.n_ant_active - 1]
    wire = make_point_source_block(
        cfg, angle_rad=cfg.beam_angles_rad()[2], noise_rms=0.5, seed=21)
    w = flag_antennas(make_weights(cfg), flags, cfg)
    p = np.asarray(beamform_power(
        jax.device_put(wire), prepare_weights(cfg, w), cfg))
    wg = weights_numpy_golden(cfg).copy()
    wg[..., flags] = 0.0
    p_ref = beamform_block_ref(wg, wire, cfg.input_layout, cfg.navg_time)
    assert relative_power_error(p, p_ref) <= 1e-3


def test_flag_antennas_range_and_noop(tiny_cfg):
    w = make_weights(tiny_cfg)
    with pytest.raises(ValueError, match="out of range"):
        flag_antennas(w, [tiny_cfg.n_ant_active], tiny_cfg)
    assert flag_antennas(w, [], tiny_cfg) is w
    # Spec-string form parses like --zap.
    wf = flag_antennas(w, "0,2-3", tiny_cfg)
    assert (np.asarray(wf.re)[..., [0, 2, 3]] == 0).all()
    assert (np.asarray(wf.im)[..., [0, 2, 3]] == 0).all()


def test_incoherent_flag_ants_standalone(tiny_cfg):
    """Standalone incoherent_power(flag_ants=...) == golden with the
    flagged antennas zeroed, == the full sum minus their contribution."""
    import jax

    from dsabeamformer.ingest.generator import make_noise_block
    from dsabeamformer.ops.incoherent import (
        incoherent_power, incoherent_power_golden,
    )

    cfg = tiny_cfg
    flags = (1,)
    wire = make_noise_block(cfg, rms=2.0, seed=22)
    p = np.asarray(incoherent_power(jax.device_put(wire), cfg,
                                    flag_ants=flags))
    ref = incoherent_power_golden(wire, cfg, flag_ants=flags)
    np.testing.assert_allclose(p, ref, rtol=1e-6)
    # Strictly less power than the unflagged sum (noise in every slot).
    p0 = np.asarray(incoherent_power(jax.device_put(wire), cfg))
    assert (p < p0).all()
    with pytest.raises(ValueError, match="out of range"):
        incoherent_power(jax.device_put(wire), cfg,
                         flag_ants=(cfg.n_ant_active,))


def test_fused_incoherent_flag_ants(tiny_cfg):
    """The fused kernel's incoherent side-product honors flag_ants
    (compile-time mask in the antenna-reduction matvec)."""
    import jax

    from dsabeamformer.ingest.generator import make_noise_block
    from dsabeamformer.models.weights import make_weights
    from dsabeamformer.ops import beamform_power
    from dsabeamformer.ops.incoherent import incoherent_power_golden
    from dsabeamformer.ops.quantize import prepare_weights

    cfg = tiny_cfg
    flags = (0, 2)
    wire = make_noise_block(cfg, rms=2.0, seed=23)
    qw = prepare_weights(cfg, make_weights(cfg))
    _, inco = beamform_power(jax.device_put(wire), qw, cfg,
                             incoherent=True, flag_ants=flags)
    ref = incoherent_power_golden(wire, cfg, flag_ants=flags)
    np.testing.assert_allclose(np.asarray(inco), ref, rtol=1e-5)
    with pytest.raises(ValueError, match="out of range"):
        beamform_power(jax.device_put(wire), qw, cfg, incoherent=True,
                       flag_ants=(cfg.n_ant_active,))


def test_tracker_preserves_excision(tiny_cfg):
    """FringeTracker regenerates weights; the edit hook re-applies
    zap/flag excision so --track doesn't un-excise after an update."""
    from dsabeamformer.models.tracking import FringeTracker
    from dsabeamformer.models.weights import zap_weights

    cfg = tiny_cfg

    def edit(w):
        return flag_antennas(zap_weights(w, [1], cfg), [0], cfg)

    tr = FringeTracker(cfg, edit=edit)
    qw = tr.weights_at(1000.0)
    for t in qw.terms:
        t = np.asarray(t)
        assert (t[1] == 0).all()  # zapped channel: whole K x 2B block


def test_cli_run_flag_ants(tiny_cfg, tmp_path):
    """End-to-end: --flag-ants drops the antennas from both products;
    output still has signal from the surviving antennas."""
    from dsabeamformer.cli import main as cli_main
    from dsabeamformer.ingest.generator import make_noise_block
    from dsabeamformer.ops.incoherent import incoherent_power_golden

    cfg = tiny_cfg
    raw = tmp_path / "cap.raw"
    wire = make_noise_block(cfg, rms=2.0, seed=24)
    raw.write_bytes(wire.tobytes())
    out = tmp_path / "out.dat"
    inco = tmp_path / "inco.dat"
    rc = cli_main(["run", "--config", "tiny", "--input-file", str(raw),
                   "--output-file", str(out),
                   "--incoherent-file", str(inco),
                   "--flag-ants", "1"])
    assert rc == 0
    f_out, t_out, b_out = cfg.out_block_shape
    p = np.fromfile(out, np.float32).reshape(f_out, t_out, b_out)
    assert (p > 0).all()
    q = np.fromfile(inco, np.float32).reshape(f_out, -1)
    np.testing.assert_allclose(
        q, incoherent_power_golden(wire, cfg, flag_ants=(1,)), rtol=1e-5)


def test_cli_flag_ants_errors(tiny_cfg, tmp_path):
    from dsabeamformer.cli import main as cli_main
    from dsabeamformer.ingest.generator import make_noise_block

    cfg = tiny_cfg
    raw = tmp_path / "cap.raw"
    raw.write_bytes(make_noise_block(cfg, rms=2.0, seed=2).tobytes())
    with pytest.raises(SystemExit, match="out of range"):
        cli_main(["run", "--config", "tiny", "--input-file", str(raw),
                  "--output-file", str(tmp_path / "o.dat"),
                  "--flag-ants", str(cfg.n_ant_active)])
    with pytest.raises(SystemExit, match="pre-quantized"):
        cli_main(["run", "--config", "tiny", "--input-file", str(raw),
                  "--output-file", str(tmp_path / "o.dat"),
                  "--weights", str(tmp_path / "w.npz"),
                  "--flag-ants", "0"])


def test_cmd_weights_flag_ants_persists(tiny_cfg, tmp_path):
    """`dsabf weights --flag-ants` bakes the excision into the table."""
    from dsabeamformer.cli import main as cli_main
    from dsabeamformer.ops.quantize import load_quant_weights

    wpath = tmp_path / "w.npz"
    rc = cli_main(["weights", "--config", "tiny", "--out", str(wpath),
                   "--flag-ants", "0"])
    assert rc == 0
    qw = load_quant_weights(str(wpath))
    # Antenna 0's weight rows (re row 0, im row a_compute) are zero in
    # every term.
    a = tiny_cfg.a_compute
    for t in qw.terms:
        t = np.asarray(t)
        assert (t[:, 0, :] == 0).all() and (t[:, a, :] == 0).all()
