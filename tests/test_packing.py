"""Bit-exact tests for the 4R4I wire format (SURVEY.md C5: the unpack
kernel must be exact — these pin the bit semantics for every path)."""

import jax.numpy as jnp
import numpy as np

from dsabeamformer.ops.packing import pack_4r4i, unpack_4r4i, unpack_wire_to_complex


def test_roundtrip_all_nibble_pairs():
    re, im = np.meshgrid(np.arange(-8, 8), np.arange(-8, 8), indexing="ij")
    b = pack_4r4i(re, im)
    re2, im2 = unpack_4r4i(b)
    np.testing.assert_array_equal(re2, re)
    np.testing.assert_array_equal(im2, im)


def test_unpack_all_256_bytes_numpy_vs_jnp():
    b = np.arange(256, dtype=np.uint8).reshape(16, 16)
    re_np, im_np = unpack_4r4i(b)
    re_j, im_j = unpack_4r4i(jnp.asarray(b))
    np.testing.assert_array_equal(np.asarray(re_j), re_np)
    np.testing.assert_array_equal(np.asarray(im_j), im_np)
    assert re_np.min() >= -8 and re_np.max() <= 7
    assert im_np.min() >= -8 and im_np.max() <= 7


def test_pack_clips_out_of_range():
    b = pack_4r4i(np.array([100, -100]), np.array([-100, 100]))
    re, im = unpack_4r4i(b)
    np.testing.assert_array_equal(re, [7, -8])
    np.testing.assert_array_equal(im, [-8, 7])


def test_known_bit_patterns():
    # real=-1 (0b1111), imag=0 -> 0xF0; real=0, imag=-8 (0b1000) -> 0x08.
    assert pack_4r4i(np.array(-1), np.array(0)) == 0xF0
    assert pack_4r4i(np.array(0), np.array(-8)) == 0x08
    assert pack_4r4i(np.array(7), np.array(7)) == 0x77
    re, im = unpack_4r4i(np.array(0x8F, dtype=np.uint8))
    assert re == -8 and im == -1


def test_unpack_wire_layouts_agree(rng):
    f, t, p, a = 3, 4, 2, 5
    ftpa = rng.integers(0, 256, size=(f, t, p, a), dtype=np.uint8)
    tfpa = np.ascontiguousarray(ftpa.transpose(1, 0, 2, 3))
    v1 = unpack_wire_to_complex(ftpa, "ftpa")
    v2 = unpack_wire_to_complex(tfpa, "tfpa")
    np.testing.assert_array_equal(v1, v2)
    assert v1.shape == (f, t, p, a)
