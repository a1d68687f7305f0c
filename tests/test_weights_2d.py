"""2-D array / direction-cosine beam grid tests (capability extension
beyond the reference's 1-D east-west fan)."""

import numpy as np
import pytest

from dsabeamformer.config import SPEED_OF_LIGHT_M_S
from dsabeamformer.ingest.generator import _emit
from dsabeamformer.models.arrays import ArrayLayout
from dsabeamformer.models.weights import (
    make_weights,
    make_weights_lm,
    weights_lm_numpy_golden,
)
from dsabeamformer.ops.gemm import beamform_power
from dsabeamformer.ops.quantize import quantize_weights


@pytest.fixture()
def cfg2d(tiny_cfg):
    # 6x6 direction-cosine beam grid needs a square beam count.
    return tiny_cfg.replace(n_beams=36)


@pytest.fixture()
def layout_2d(cfg2d, rng):
    ew = np.zeros(cfg2d.n_ant)
    ns = np.zeros(cfg2d.n_ant)
    a = cfg2d.n_ant_active
    ew[:a] = rng.uniform(-20, 20, a)
    ns[:a] = rng.uniform(-20, 20, a)
    return ArrayLayout(positions_m=ew, n_active=a, positions_ns_m=ns)


def _beam_grid(cfg):
    """Small (l, m) grid covering the fan in both axes."""
    n_side = int(np.sqrt(cfg.n_beams))
    assert n_side * n_side == cfg.n_beams, "tiny config beams must be square"
    half = np.sin(np.deg2rad(cfg.beam_span_deg / 2))
    l = np.linspace(-half, half, n_side)
    ll, mm = np.meshgrid(l, l, indexing="ij")
    return ll.ravel(), mm.ravel()


def test_lm_matches_golden(cfg2d, layout_2d):
    l, m = _beam_grid(cfg2d)
    w = make_weights_lm(cfg2d, l, m, layout=layout_2d).to_numpy()
    w_ref = weights_lm_numpy_golden(cfg2d, l, m, layout=layout_2d)
    np.testing.assert_allclose(w, w_ref, atol=5e-6)


def test_lm_reduces_to_1d_fan(tiny_cfg):
    """With m=0 and no NS offsets, the lm path equals the 1-D fan."""
    angles = tiny_cfg.beam_angles_rad()
    w_fan = make_weights(tiny_cfg).to_numpy()
    w_lm = make_weights_lm(
        tiny_cfg, np.sin(angles), np.zeros_like(angles)
    ).to_numpy()
    np.testing.assert_allclose(w_fan, w_lm, atol=5e-6)


def test_2d_point_source_peaks_in_matching_beam(cfg2d, layout_2d, rng):
    """A source at (l0, m0) over a 2-D array peaks in the nearest grid
    beam — the full pipeline works unchanged with lm weights."""
    cfg = cfg2d
    l, m = _beam_grid(cfg)
    target = 27
    f = cfg.freqs_hz()[:, None, None]
    a = cfg.n_ant_active
    steer = np.exp(
        2j * np.pi * f
        * (layout_2d.positions_m[None, None, :a] * l[target]
           + layout_2d.ns[None, None, :a] * m[target])
        / SPEED_OF_LIGHT_M_S
    )
    sig = 5.0 / np.sqrt(2) * (
        rng.standard_normal((cfg.n_chan, cfg.t_block, cfg.n_pol))
        + 1j * rng.standard_normal((cfg.n_chan, cfg.t_block, cfg.n_pol))
    )
    v = sig[..., None] * steer[:, :, None, :]
    shape = (cfg.n_chan, cfg.t_block, cfg.n_pol, cfg.n_ant)
    re = np.zeros(shape)
    im = np.zeros(shape)
    re[..., :a] = v.real
    im[..., :a] = v.imag
    wire = _emit(cfg, re, im)

    qw = quantize_weights(make_weights_lm(cfg, l, m, layout=layout_2d),
                          cfg.weight_mode)
    p = np.asarray(beamform_power(wire, qw, cfg))
    assert int(np.argmax(p.sum(axis=(0, 1)))) == target


def test_layout_2d_roundtrip(tmp_path, layout_2d):
    path = str(tmp_path / "layout.npz")
    layout_2d.save(path)
    back = ArrayLayout.load(path)
    np.testing.assert_array_equal(back.positions_m, layout_2d.positions_m)
    np.testing.assert_array_equal(back.ns, layout_2d.ns)

def test_beam_response_lm_peaks(cfg2d, layout_2d):
    """Each (l, m) beam's response peaks at its own grid direction."""
    from dsabeamformer.models.beampattern import beam_response_lm

    n = 6
    lg = np.linspace(-0.01, 0.01, n)
    ll, mm = np.meshgrid(lg, lg, indexing="ij")
    beam_l, beam_m = ll.ravel(), mm.ravel()
    resp = beam_response_lm(cfg2d, beam_l, beam_m, beam_l, beam_m,
                            layout=layout_2d, chan=0)
    assert resp.shape == (cfg2d.n_beams, cfg2d.n_beams)
    # Sweep point i == beam direction i: the diagonal must dominate.
    assert (np.argmax(resp, axis=1) == np.arange(cfg2d.n_beams)).all()
    assert np.abs(np.diag(resp) - 1.0).max() < 1e-6
