"""Stored-block regression test.

BASELINE.json gates accuracy "on recorded voltage test blocks": with no
reference binary available, the committed fixture
(tests/data/golden_tiny_block.npz, float64 golden-model output on a
recorded synthetic block) pins the numerics — any refactor that shifts
the pipeline's output beyond the bar, or the golden model itself,
fails here."""

from pathlib import Path

import numpy as np
import pytest

from dsabeamformer.models.calibration import CalTable
from dsabeamformer.models.weights import make_weights, weights_numpy_golden
from dsabeamformer.ops.gemm import beamform_power
from dsabeamformer.ops.quantize import quantize_weights
from dsabeamformer.ops.reference import beamform_block_ref
from dsabeamformer.utils.testing import assert_power_close

FIXTURE = Path(__file__).parent / "data" / "golden_tiny_block.npz"


@pytest.fixture(scope="module")
def fixture():
    d = np.load(FIXTURE)
    return d


def test_golden_model_is_stable(tiny_cfg, fixture):
    """The float64 golden model reproduces the stored output bit-near-
    exactly (guards against silent semantic drift in the oracle)."""
    cal = CalTable(gains=fixture["cal_gains"])
    w = weights_numpy_golden(tiny_cfg, cal=cal)
    p = beamform_block_ref(
        w, fixture["wire"], tiny_cfg.input_layout, tiny_cfg.navg_time,
        tiny_cfg.navg_freq,
    )
    np.testing.assert_allclose(p, fixture["powers"], rtol=1e-12)


def test_kernel_matches_recorded_block(tiny_cfg, fixture):
    """The production path meets the <=1e-3 bar on the recorded block."""
    cal = CalTable(gains=fixture["cal_gains"])
    qw = quantize_weights(make_weights(tiny_cfg, cal=cal),
                          tiny_cfg.weight_mode)
    p = np.asarray(beamform_power(fixture["wire"], qw, tiny_cfg))
    assert_power_close(p, fixture["powers"], what="recorded block")
    profile = p.sum(axis=(0, 1))
    assert int(np.argmax(profile)) == int(fixture["target_beam"])


def test_weight_shape_mismatch_rejected(tiny_cfg, fixture):
    bad_cfg = tiny_cfg.replace(n_beams=tiny_cfg.n_beams * 2)
    qw = quantize_weights(make_weights(tiny_cfg), tiny_cfg.weight_mode)
    with pytest.raises(ValueError, match="match config"):
        beamform_power(fixture["wire"], qw, bad_cfg)
