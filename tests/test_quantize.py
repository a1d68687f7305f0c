"""Weight quantization: K-concatenated layout correctness and per-mode
error bounds (ops/quantize.py)."""

import numpy as np
import jax.numpy as jnp
import pytest

from dsabeamformer.models.weights import make_weights
from dsabeamformer.ops.quantize import cat_weights, quantize_weights


def test_cat_weights_layout(tiny_cfg):
    w = make_weights(tiny_cfg)
    wc = np.asarray(cat_weights(w))
    f, b, a = w.shape
    assert wc.shape == (f, 2 * a, 2 * b)
    wr = np.asarray(w.re)
    wi = np.asarray(w.im)
    np.testing.assert_allclose(wc[:, :a, :b], wr.transpose(0, 2, 1), atol=1e-7)
    np.testing.assert_allclose(wc[:, :a, b:], wi.transpose(0, 2, 1), atol=1e-7)
    np.testing.assert_allclose(wc[:, a:, :b], -wi.transpose(0, 2, 1), atol=1e-7)
    np.testing.assert_allclose(wc[:, a:, b:], wr.transpose(0, 2, 1), atol=1e-7)


def test_cat_gemm_equals_complex_gemm(tiny_cfg, rng):
    """[Xr|Xi] @ Wc == [Re(V W^T) | Im(V W^T)] — the K-concat identity."""
    w = make_weights(tiny_cfg)
    f, b, a = w.shape
    xr = rng.integers(-8, 8, size=(5, a)).astype(np.float32)
    xi = rng.integers(-8, 8, size=(5, a)).astype(np.float32)
    wc = np.asarray(cat_weights(w))
    xc = np.concatenate([xr, xi], axis=1)
    out = xc @ wc[2]  # channel 2
    v = xr + 1j * xi
    bv = v @ w.to_numpy()[2].T
    np.testing.assert_allclose(out[:, :b], bv.real, rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(out[:, b:], bv.imag, rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize(
    "mode,bound",
    [
        ("int8", 1.0 / 120),
        # s_lo = s_hi/256 with clip at 127: worst case 1.5*s_lo
        # => 1.5/(256*127) ~ 4.6e-5.
        ("int8x2", 6.0e-5),
        # 12-bit x16 folding: s = amax/2040, residual <= s/2
        # => 0.5/2040 ~ 2.45e-4.
        ("int12", 3.0e-4),
        ("bf16", 1.0 / 200),
        ("bf16x2", 1.0 / 50000),
        ("f32", 1e-7),
    ],
)
def test_dequantize_error_bound(tiny_cfg, mode, bound):
    w = make_weights(tiny_cfg)
    wc = np.asarray(cat_weights(w))
    qw = quantize_weights(w, mode)
    approx = np.asarray(qw.dequantize("int12" if mode == "int12" else "linear"))
    err = np.max(np.abs(approx - wc)) / np.max(np.abs(wc))
    assert err <= bound, f"{mode}: {err:.3e} > {bound:.3e}"


def test_modes_term_counts(tiny_cfg):
    w = make_weights(tiny_cfg)
    f, b, a = w.shape
    assert quantize_weights(w, "int8").n_terms == 1
    assert quantize_weights(w, "int8x2").n_terms == 2
    assert quantize_weights(w, "int8x2").terms[0].dtype == jnp.int8
    assert quantize_weights(w, "bf16x2").terms[0].dtype == jnp.bfloat16
    # int12: ONE term with hi/lo folded along K (4A rows).
    q12 = quantize_weights(w, "int12")
    assert len(q12.terms) == 1
    assert q12.terms[0].shape == (f, 4 * a, 2 * b)
    assert q12.terms[0].dtype == jnp.int8
    with pytest.raises(ValueError):
        quantize_weights(w, "nope")


def test_cat_weights_a_compute_slices_k(tiny_cfg):
    w = make_weights(tiny_cfg)
    f, b, a = w.shape
    wc = np.asarray(cat_weights(w))
    wc8 = np.asarray(cat_weights(w, 8))
    assert wc8.shape == (f, 16, 2 * b)
    np.testing.assert_array_equal(wc8[:, :8], wc[:, :8])
    np.testing.assert_array_equal(wc8[:, 8:], wc[:, a : a + 8])
