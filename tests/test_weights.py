"""Weight-generation tests: jitted device path vs float64 NumPy oracle,
calibration folding, pointing (SURVEY.md C8, §3.3)."""

import numpy as np

from dsabeamformer.models.arrays import array_for
from dsabeamformer.models.calibration import CalTable
from dsabeamformer.models.weights import make_weights, weights_numpy_golden


def test_weights_match_numpy_golden(tiny_cfg):
    w = make_weights(tiny_cfg).to_numpy()
    w_ref = weights_numpy_golden(tiny_cfg)
    assert w.shape == (tiny_cfg.n_chan, tiny_cfg.n_beams, tiny_cfg.n_ant)
    np.testing.assert_allclose(w, w_ref, atol=5e-6)


def test_weights_unit_modulus_on_active(tiny_cfg):
    w = make_weights(tiny_cfg).to_numpy()
    act = np.abs(w[:, :, : tiny_cfg.n_ant_active])
    np.testing.assert_allclose(act, 1.0, atol=1e-5)
    # Padded antennas have zero gain -> zero weight.
    np.testing.assert_array_equal(w[:, :, tiny_cfg.n_ant_active:], 0.0)


def test_calibration_gains_folded(tiny_cfg):
    cal = CalTable.random(tiny_cfg, seed=7)
    w = make_weights(tiny_cfg, cal=cal).to_numpy()
    w_ref = weights_numpy_golden(tiny_cfg, cal=cal)
    np.testing.assert_allclose(w, w_ref, atol=5e-6)


def test_pointing_shifts_weights(tiny_cfg):
    w0 = make_weights(tiny_cfg, pointing_rad=0.0).to_numpy()
    w1 = make_weights(tiny_cfg, pointing_rad=0.01).to_numpy()
    w1_ref = weights_numpy_golden(tiny_cfg, pointing_rad=0.01)
    assert not np.allclose(w0, w1)
    np.testing.assert_allclose(w1, w1_ref, atol=5e-6)


def test_fringe_delay_is_common_phase(tiny_cfg):
    # A pure delay multiplies each channel by a common phase: power
    # patterns are unchanged.
    layout = array_for(tiny_cfg)
    w0 = weights_numpy_golden(tiny_cfg, layout=layout)
    w1 = weights_numpy_golden(tiny_cfg, layout=layout, fringe_delay_s=1e-9)
    ratio = w1[:, :, : tiny_cfg.n_ant_active] / w0[:, :, : tiny_cfg.n_ant_active]
    # Ratio constant across beams/antennas per channel.
    r0 = ratio[:, :1, :1]
    np.testing.assert_allclose(ratio, np.broadcast_to(r0, ratio.shape), atol=1e-9)
    np.testing.assert_allclose(np.abs(r0), 1.0, atol=1e-12)


def test_text_position_table_roundtrip(tmp_path, tiny_cfg):
    """A surveyed plain-text position table (one row per physical dish)
    loads, pads to the GEMM dim, and drives weight generation
    (SURVEY.md C2/C8: the reference compiled such a table in)."""
    import numpy as np

    from dsabeamformer.models.arrays import ArrayLayout, array_for
    from dsabeamformer.models.weights import make_weights

    ref_layout = array_for(tiny_cfg)
    path = tmp_path / "positions.txt"
    with open(path, "w") as f:
        f.write("# east-west meters\n")
        for x in ref_layout.positions_m[: tiny_cfg.n_ant_active]:
            f.write(f"{x}\n")
    loaded = ArrayLayout.load(str(path))
    assert loaded.n_ant == tiny_cfg.n_ant_active
    padded = loaded.padded(tiny_cfg.n_ant)
    np.testing.assert_allclose(padded.positions_m, ref_layout.positions_m)
    # make_weights pads automatically and matches the default layout.
    w1 = make_weights(tiny_cfg, layout=loaded)
    w0 = make_weights(tiny_cfg)
    np.testing.assert_allclose(np.asarray(w1.re), np.asarray(w0.re))


def test_layout_active_count_mismatch_rejected(tiny_cfg):
    import pytest

    from dsabeamformer.models.arrays import linear_array
    from dsabeamformer.models.weights import make_weights

    bad = linear_array(tiny_cfg.n_ant, tiny_cfg.n_ant_active + 2, 5.0)
    with pytest.raises(ValueError, match="active"):
        make_weights(tiny_cfg, layout=bad)


def test_cli_layout_flag(tmp_path, capsys, tiny_cfg):
    import json

    from dsabeamformer import cli
    from dsabeamformer.models.arrays import array_for

    layout = array_for(tiny_cfg)
    path = tmp_path / "pos.txt"
    with open(path, "w") as f:
        for x in layout.positions_m[: tiny_cfg.n_ant_active]:
            f.write(f"{x} 0.0\n")
    rc = cli.main(["weights", "--config", "tiny", "--layout", str(path),
                   "--out", str(tmp_path / "w.npz")])
    assert rc == 0
    assert json.loads(capsys.readouterr().out.strip())["terms"] == 2
