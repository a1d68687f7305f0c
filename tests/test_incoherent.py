"""Incoherent-sum detection (ops/incoherent.py) vs its float64 oracle,
both wire layouts and both wire forms."""

import numpy as np
import pytest

from dsabeamformer.ingest.generator import make_noise_block
from dsabeamformer.ops.gemm import device_wire_view
from dsabeamformer.ops.incoherent import (
    incoherent_power,
    incoherent_power_golden,
)


@pytest.mark.parametrize("layout", ["tfpa", "ftpa"])
def test_incoherent_matches_golden(tiny_cfg, layout):
    cfg = tiny_cfg.replace(input_layout=layout)
    wire = make_noise_block(cfg, rms=2.5, seed=42)
    p = np.asarray(incoherent_power(wire, cfg))
    ref = incoherent_power_golden(wire, cfg)
    assert p.shape == (cfg.n_chan, cfg.t_block // cfg.navg_time)
    # The device path is integer arithmetic end-to-end; the float64
    # oracle carries ~1e-13 summation rounding, hence allclose not
    # array_equal.
    np.testing.assert_allclose(p, ref, rtol=1e-12)
    # Canonical device form agrees exactly too.
    p_dev = np.asarray(incoherent_power(device_wire_view(wire, cfg), cfg))
    np.testing.assert_array_equal(p_dev, p)


@pytest.mark.parametrize("mode", ["int8x2", "int12", "int13", "f32"])
def test_fused_incoherent_matches_golden(tiny_cfg, mode):
    """beamform_power(incoherent=True): the in-kernel incoherent output
    (one HBM pass over the wire for both products) must match the
    float64 oracle exactly, in every weight mode's x_all layout."""
    import jax

    from dsabeamformer.models.weights import make_weights
    from dsabeamformer.ops.gemm import beamform_power
    from dsabeamformer.ops.quantize import quantize_weights

    cfg = tiny_cfg.replace(weight_mode=mode)
    wire = make_noise_block(cfg, rms=2.0, seed=7)
    qw = quantize_weights(make_weights(cfg), cfg.weight_mode, cfg.a_compute)
    dev = jax.device_put(device_wire_view(wire, cfg))
    p0 = np.asarray(beamform_power(dev, qw, cfg))
    p, inco = beamform_power(dev, qw, cfg, incoherent=True)
    np.testing.assert_allclose(np.asarray(p), p0, rtol=1e-6)
    np.testing.assert_allclose(np.asarray(inco),
                               incoherent_power_golden(wire, cfg),
                               rtol=1e-12)


def test_fused_incoherent_freq_averaging(tiny_cfg):
    import jax

    from dsabeamformer.models.weights import make_weights
    from dsabeamformer.ops.gemm import beamform_power
    from dsabeamformer.ops.quantize import quantize_weights

    cfg = tiny_cfg.replace(navg_freq=2)
    wire = make_noise_block(cfg, rms=2.0, seed=9)
    qw = quantize_weights(make_weights(cfg), cfg.weight_mode, cfg.a_compute)
    _, inco = beamform_power(jax.device_put(device_wire_view(wire, cfg)),
                             qw, cfg, incoherent=True)
    assert np.asarray(inco).shape == (cfg.n_chan // 2,
                                      cfg.t_block // cfg.navg_time)
    np.testing.assert_allclose(np.asarray(inco),
                               incoherent_power_golden(wire, cfg),
                               rtol=1e-12)


def test_fused_incoherent_stokes_path(tiny_cfg):
    """beamform_stokes(incoherent=True): all four Stokes planes AND the
    incoherent product from one kernel call, both matching goldens."""
    import jax

    from dsabeamformer.models.weights import make_weights, weights_numpy_golden
    from dsabeamformer.ops.gemm import beamform_stokes
    from dsabeamformer.ops.quantize import quantize_weights
    from dsabeamformer.ops.reference import beamform_stokes_ref

    cfg = tiny_cfg
    wire = make_noise_block(cfg, rms=2.0, seed=11)
    qw = quantize_weights(make_weights(cfg), cfg.weight_mode, cfg.a_compute)
    st, inco = beamform_stokes(jax.device_put(device_wire_view(wire, cfg)),
                               qw, cfg, incoherent=True)
    st, inco = np.asarray(st), np.asarray(inco)
    ref = beamform_stokes_ref(weights_numpy_golden(cfg), wire,
                              cfg.input_layout, cfg.navg_time, cfg.navg_freq)
    scale = np.abs(ref[:, :, 0]).max()
    assert np.abs(st - ref).max() / scale < 3e-4
    np.testing.assert_allclose(inco, incoherent_power_golden(wire, cfg),
                               rtol=1e-12)


def test_incoherent_scales_with_signal(tiny_cfg):
    quiet = make_noise_block(tiny_cfg, rms=0.5, seed=1)
    loud = make_noise_block(tiny_cfg, rms=3.0, seed=1)
    pq = float(np.asarray(incoherent_power(quiet, tiny_cfg)).mean())
    pl = float(np.asarray(incoherent_power(loud, tiny_cfg)).mean())
    assert pl > 4 * pq


def test_wire_level_stats(tiny_cfg):
    """rms tracks the generator drive level; clip fires on hot signals."""
    from dsabeamformer.ops.incoherent import wire_level_stats

    quiet = make_noise_block(tiny_cfg, rms=1.0, seed=3)
    hot = make_noise_block(tiny_cfg, rms=6.0, seed=3)
    sq = {k: np.asarray(v) for k, v in wire_level_stats(quiet, tiny_cfg).items()}
    sh = {k: np.asarray(v) for k, v in wire_level_stats(hot, tiny_cfg).items()}
    act = tiny_cfg.n_ant_active
    assert sq["rms"].shape == (act,)
    assert np.all(np.abs(sq["rms"] - 1.0) < 0.1)
    assert np.all(sq["clip_fraction"] < 0.02)
    # rms=6 noise saturates the 4-bit rails hard.
    assert np.all(sh["clip_fraction"] > 0.2)


def test_cli_levels(tmp_path, capsys, tiny_cfg):
    import json

    from dsabeamformer import cli
    from dsabeamformer.ingest import dada

    cap = str(tmp_path / "cap.dada")
    dada.write_dada_file(
        cap, tiny_cfg,
        (make_noise_block(tiny_cfg, rms=2.0, seed=s) for s in range(2)),
    )
    assert cli.main(["levels", "--config", "tiny", "--input-file", cap]) == 0
    rec = json.loads(capsys.readouterr().out)
    assert rec["blocks"] == 2
    assert len(rec["rms"]) == tiny_cfg.n_ant_active
    assert all(abs(v - 2.0) < 0.25 for v in rec["rms"])
    assert rec["worst_clip"] < 0.05


def _sk_golden(wire, cfg):
    """f64 oracle: per-channel SK over per-sample powers."""
    from dsabeamformer.ops.packing import unpack_wire_to_complex

    v = unpack_wire_to_complex(np.asarray(wire).reshape(cfg.wire_block_shape),
                               cfg.input_layout)[..., : cfg.n_ant_active]
    p = np.abs(v).astype(np.float64) ** 2  # [F, T, P, A]
    m = p[0].size
    s1 = p.sum(axis=(1, 2, 3))
    s2 = (p * p).sum(axis=(1, 2, 3))
    with np.errstate(divide="ignore", invalid="ignore"):
        return (m + 1) / (m - 1) * (m * s2 / s1**2 - 1), m


def test_sk_matches_golden(tiny_cfg):
    from dsabeamformer.ops.incoherent import (
        sk_block_stats,
        sk_estimate,
        sk_samples_per_block,
    )

    wire = make_noise_block(tiny_cfg, rms=2.0, seed=9)
    st = sk_block_stats(wire, tiny_cfg)
    m = sk_samples_per_block(tiny_cfg)
    sk = sk_estimate(st["s1"], st["s2"], m)
    want, m_want = _sk_golden(wire, tiny_cfg)
    assert m == m_want
    np.testing.assert_allclose(sk, want, rtol=1e-5)
    # clean noise: every channel's SK sits near 1
    assert np.all(np.abs(sk - 1.0) < 0.5)


def test_sk_flags_tone_and_impulse(tiny_cfg):
    """A CW carrier (constant-modulus power) drives SK far below 1; an
    impulsive burst drives it far above; both get flagged, the clean
    channels don't."""
    from dsabeamformer.ingest.generator import make_tone_block
    from dsabeamformer.ops.incoherent import (
        sk_block_stats,
        sk_estimate,
        sk_flags,
        sk_samples_per_block,
    )

    cfg = tiny_cfg
    wire = make_noise_block(cfg, rms=2.0, seed=10).reshape(
        cfg.t_block, cfg.n_chan, cfg.n_pol, cfg.n_ant).copy()
    tone = make_tone_block(cfg, chan=2, amplitude=6.0).reshape(
        cfg.t_block, cfg.n_chan, cfg.n_pol, cfg.n_ant)
    wire[:, 2] = tone[:, 2]                 # CW carrier in channel 2
    wire[: cfg.t_block - 4, 5] = 0          # channel 5: 4-sample burst
    st = sk_block_stats(wire.reshape(cfg.wire_block_shape), cfg)
    m = sk_samples_per_block(cfg)
    sk = sk_estimate(st["s1"], st["s2"], m)
    assert sk[2] < 0.3                      # carrier: concentrated power
    assert sk[5] > 3.0                      # burst: heavy tail
    flagged, med, sigma = sk_flags(sk, m)
    assert 2 in flagged and 5 in flagged
    assert all(c in (2, 5) for c in flagged)
    assert abs(med - 1.0) < 0.3 and sigma > 0


def test_sk_dead_channel_flagged(tiny_cfg):
    from dsabeamformer.ops.incoherent import (
        sk_block_stats,
        sk_estimate,
        sk_flags,
        sk_samples_per_block,
    )

    cfg = tiny_cfg
    wire = make_noise_block(cfg, rms=2.0, seed=11).reshape(
        cfg.t_block, cfg.n_chan, cfg.n_pol, cfg.n_ant).copy()
    wire[:, 3] = 0  # dead channel: S1 == 0 -> NaN SK
    st = sk_block_stats(wire.reshape(cfg.wire_block_shape), cfg)
    sk = sk_estimate(st["s1"], st["s2"], sk_samples_per_block(cfg))
    assert np.isnan(sk[3])
    flagged, _, _ = sk_flags(sk, sk_samples_per_block(cfg))
    assert 3 in flagged


def test_format_zap_spec_roundtrip():
    from dsabeamformer.models.weights import parse_zap
    from dsabeamformer.ops.incoherent import format_zap_spec

    for chans in ([], [5], [1, 2, 3], [0, 2, 3, 4, 9], [7, 7, 6]):
        spec = format_zap_spec(chans)
        assert parse_zap(spec) == sorted(set(chans))
    assert format_zap_spec([1, 2, 3, 10]) == "1-3,10"


def test_cli_rfi(tmp_path, capsys, tiny_cfg):
    import json

    from dsabeamformer import cli
    from dsabeamformer.ingest import dada
    from dsabeamformer.ingest.generator import make_tone_block
    from dsabeamformer.models.weights import parse_zap

    cfg = tiny_cfg

    def rfi_block(seed):
        w = make_noise_block(cfg, rms=2.0, seed=seed).reshape(
            cfg.t_block, cfg.n_chan, cfg.n_pol, cfg.n_ant).copy()
        tone = make_tone_block(cfg, chan=6, amplitude=6.0).reshape(
            cfg.t_block, cfg.n_chan, cfg.n_pol, cfg.n_ant)
        w[:, 6] = tone[:, 6]
        return w.reshape(cfg.wire_block_shape)

    cap = str(tmp_path / "cap.dada")
    dada.write_dada_file(cap, cfg, (rfi_block(s) for s in range(3)))
    assert cli.main(["rfi", "--config", "tiny", "--input-file", cap,
                     "--sk-values"]) == 0
    rec = json.loads(capsys.readouterr().out)
    assert rec["blocks"] == 3
    assert 6 in rec["flagged"]
    assert parse_zap(rec["zap"]) == rec["flagged"]
    assert len(rec["sk"]) == cfg.n_chan and rec["sk"][6] < 0.5


def test_sk_ant_axis_localizes_bad_antenna(tiny_cfg):
    """axis='ant': an antenna with impulsive output stands out; clean
    antennas sit at SK~1."""
    from dsabeamformer.ops.incoherent import (
        sk_block_stats,
        sk_estimate,
        sk_flags,
        sk_samples_per_block,
    )

    cfg = tiny_cfg
    wire = make_noise_block(cfg, rms=2.0, seed=14).reshape(
        cfg.t_block, cfg.n_chan, cfg.n_pol, cfg.n_ant).copy()
    # antenna 4: silent except a 4-sample full-scale burst (impulsive)
    wire[:, :, :, 4] = 0
    wire[: 4, :, :, 4] = 0x77
    st = sk_block_stats(wire.reshape(cfg.wire_block_shape), cfg, axis="ant")
    m = sk_samples_per_block(cfg, axis="ant")
    assert st["s1"].shape == (cfg.n_ant_active,)
    sk = sk_estimate(st["s1"], st["s2"], m)
    assert sk[4] > 3.0
    flagged, med, _ = sk_flags(sk, m)
    assert flagged == [4] and abs(med - 1.0) < 0.3
    with pytest.raises(ValueError, match="axis"):
        sk_block_stats(wire.reshape(cfg.wire_block_shape), cfg, axis="pol")


def test_cli_rfi_per_ant(tmp_path, capsys, tiny_cfg):
    import json

    from dsabeamformer import cli
    from dsabeamformer.ingest import dada
    from dsabeamformer.models.weights import parse_zap

    cfg = tiny_cfg

    def bad_ant_block(seed):
        w = make_noise_block(cfg, rms=2.0, seed=seed).reshape(
            cfg.t_block, cfg.n_chan, cfg.n_pol, cfg.n_ant).copy()
        w[:, :, :, 2] = 0
        w[: 4, :, :, 2] = 0x77
        return w.reshape(cfg.wire_block_shape)

    cap = str(tmp_path / "cap.dada")
    dada.write_dada_file(cap, cfg, (bad_ant_block(s) for s in range(2)))
    assert cli.main(["rfi", "--config", "tiny", "--input-file", cap,
                     "--per-ant"]) == 0
    rec = json.loads(capsys.readouterr().out)
    assert rec["flagged_ants"] == [2]
    assert parse_zap(rec["flag_ants"]) == [2]
    assert "ant_sk" not in rec  # only with --sk-values
