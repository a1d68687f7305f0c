"""Beam-pattern analysis tests (SURVEY.md C11: the beam-response
validation the reference did by visual plots, made quantitative)."""

import numpy as np

from dsabeamformer.models.beampattern import beam_fwhm_rad, beam_response


def test_matched_beams_on_diagonal(tiny_cfg):
    angles = tiny_cfg.beam_angles_rad()
    resp = beam_response(tiny_cfg, angles)  # sweep exactly over beam angles
    # Each swept source is brightest in its matched beam.
    np.testing.assert_array_equal(np.argmax(resp, axis=1), np.arange(len(angles)))
    # Matched response ~ coherent gain (normalized to 1).
    diag = np.diag(resp)
    np.testing.assert_allclose(diag, 1.0, atol=1e-6)


def test_off_axis_suppression(tiny_cfg):
    angles = tiny_cfg.beam_angles_rad()
    fwhm = beam_fwhm_rad(tiny_cfg)
    # A source several beamwidths away from beam 0 is suppressed.
    far = angles[0] + 5 * fwhm
    resp = beam_response(tiny_cfg, np.array([far]))
    assert resp[0, 0] < 0.5


def test_fwhm_matches_analytic(tiny_cfg):
    """Measured half-power width of the central beam agrees with the
    0.886*lambda/aperture estimate within 30%."""
    angles = tiny_cfg.beam_angles_rad()
    b = len(angles) // 2
    fwhm_est = beam_fwhm_rad(tiny_cfg)
    sweep = angles[b] + np.linspace(-3, 3, 601) * fwhm_est
    resp = beam_response(tiny_cfg, sweep)[:, b]
    above = sweep[resp >= 0.5 * resp.max()]
    measured = above.max() - above.min()
    assert 0.7 < measured / fwhm_est < 1.3
