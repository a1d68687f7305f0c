"""Detection products vs the float64 golden model — the core accuracy
gates (BASELINE configs 2 & 3): <=1e-3 relative power error, detection
vs the unfused voltage path, both wire layouts — plus the choice of
implementation, the plain form's channel groups, and the kernel's
lowering for CUDA."""

import numpy as np
import pytest

from dsabeamformer.ingest.generator import make_noise_block, make_point_source_block
from dsabeamformer.models.calibration import CalTable
from dsabeamformer.models.weights import make_weights, weights_numpy_golden
from dsabeamformer.ops.gemm import (
    beamform_power,
    beamform_voltages,
    voltages_to_complex,
)
from dsabeamformer.ops.packing import unpack_wire_to_complex
from dsabeamformer.ops.quantize import quantize_weights
from dsabeamformer.ops.reference import beamform_block_ref, beamform_voltages_ref
from dsabeamformer.utils.testing import assert_power_close


def _golden_power(cfg, wire, cal=None):
    w = weights_numpy_golden(cfg, cal=cal)
    return beamform_block_ref(w, wire, cfg.input_layout, cfg.navg_time, cfg.navg_freq)


# Accuracy budget per weight mode (measured; the BASELINE <=1e-3 bar is
# met by the hi+lo residual-quantized modes — which is why int8x2 is the
# default — while single-term int8/bf16 are fast modes that trade ~5e-3
# error on noise-dominated bins for 2x fewer MACs).
@pytest.mark.parametrize(
    "mode,rtol",
    [
        ("int13", 5e-4),
        ("int12", 8e-4),
        ("int8x2", 2e-4),
        ("bf16x2", 2e-4),
        ("f32", 1e-5),
        ("int8", 2e-2),
        ("bf16", 1e-2),
    ],
)
def test_fused_power_vs_golden(tiny_cfg, mode, rtol):
    cfg = tiny_cfg.replace(weight_mode=mode)
    cal = CalTable.random(cfg, seed=11)
    wire = make_noise_block(cfg, rms=2.5, seed=21)
    qw = quantize_weights(make_weights(cfg, cal=cal), mode, cfg.a_compute)
    p = np.asarray(beamform_power(wire, qw, cfg))
    p_ref = _golden_power(cfg, wire, cal=cal)
    assert p.shape == cfg.out_block_shape
    assert_power_close(p, p_ref, rtol=rtol, what=mode)


def test_ant_slicing_exact(tiny_cfg):
    """Dropping zero-padded antennas from K (n_ant_compute) is bit-exact
    in f32 mode: the sliced rows contribute only structural zeros."""
    cfg_full = tiny_cfg.replace(weight_mode="f32")
    cfg_sl = tiny_cfg.replace(weight_mode="f32", n_ant_compute=8)
    wire = make_noise_block(cfg_full, rms=2.0, seed=71)
    w = make_weights(cfg_full)
    p_full = np.asarray(
        beamform_power(wire, quantize_weights(w, "f32", 16), cfg_full)
    )
    p_sl = np.asarray(
        beamform_power(wire, quantize_weights(w, "f32", 8), cfg_sl)
    )
    np.testing.assert_array_equal(p_full, p_sl)


def test_int12_sliced_point_source_peak(tiny_cfg):
    """The fast path (int12 + antenna slicing) still puts the beam peak
    exactly at the injected source.

    Note the loose rtol: under the sidelobe-floored error metric
    (denominator clamped at 1e-3*peak, utils/testing.py) a coherent
    point source amplifies 12-bit weight error to ~5e-3 in ~-30 dB
    sidelobe bins — which is why int12 is NOT the default mode; int8x2
    stays within the 1e-3 bar on this same input (the parametrized
    golden test above covers the noise-block gate where int12 measures
    ~4e-4)."""
    cfg = tiny_cfg.replace(weight_mode="int12", n_ant_compute=8)
    angles = cfg.beam_angles_rad()
    target = len(angles) // 4
    wire = make_point_source_block(cfg, angles[target], noise_rms=0.3, seed=5)
    qw = quantize_weights(make_weights(cfg), "int12", cfg.a_compute)
    p = np.asarray(beamform_power(wire, qw, cfg))
    assert int(np.argmax(p.sum(axis=(0, 1)))) == target
    p_ref = _golden_power(cfg, wire)
    assert_power_close(p, p_ref, rtol=1e-2, what="int12 sliced")


def test_fused_power_point_source_peak(tiny_cfg):
    angles = tiny_cfg.beam_angles_rad()
    target = len(angles) // 4
    wire = make_point_source_block(tiny_cfg, angles[target], noise_rms=0.3, seed=5)
    qw = quantize_weights(make_weights(tiny_cfg), tiny_cfg.weight_mode)
    p = np.asarray(beamform_power(wire, qw, tiny_cfg))
    assert int(np.argmax(p.sum(axis=(0, 1)))) == target


def test_unfused_voltages_vs_golden(tiny_cfg):
    wire = make_noise_block(tiny_cfg, rms=2.0, seed=31)
    w = make_weights(tiny_cfg)
    qw = quantize_weights(w, "int8x2")
    bv = voltages_to_complex(np.asarray(beamform_voltages(wire, qw, tiny_cfg)))
    w_ref = weights_numpy_golden(tiny_cfg)
    volt = unpack_wire_to_complex(wire, tiny_cfg.input_layout)
    bv_ref = beamform_voltages_ref(w_ref, volt)
    assert bv.shape == bv_ref.shape
    scale = np.max(np.abs(bv_ref))
    np.testing.assert_allclose(np.asarray(bv), bv_ref, atol=2e-4 * scale)


def test_fused_equals_unfused_detection(tiny_cfg):
    """BASELINE config 3: the fused epilogue must match detect+average
    applied to the unfused voltage path, same quantized weights."""
    wire = make_noise_block(tiny_cfg, rms=2.0, seed=41)
    qw = quantize_weights(make_weights(tiny_cfg), "int8x2")
    p_fused = np.asarray(beamform_power(wire, qw, tiny_cfg))
    bv = voltages_to_complex(np.asarray(beamform_voltages(wire, qw, tiny_cfg)))
    from dsabeamformer.ops.reference import average_ref, detect_ref

    p_unfused = average_ref(detect_ref(bv), tiny_cfg.navg_time, tiny_cfg.navg_freq)
    assert_power_close(p_fused, p_unfused, rtol=1e-5, what="fused vs unfused")


def test_layouts_agree(tiny_cfg):
    """ftpa and tfpa (XLA corner-turn) must produce identical powers."""
    cfg_f = tiny_cfg.replace(input_layout="ftpa")
    cfg_t = tiny_cfg.replace(input_layout="tfpa")
    wire_f = make_noise_block(cfg_f, rms=2.0, seed=51)
    wire_t = np.ascontiguousarray(wire_f.transpose(1, 0, 2, 3))
    qw = quantize_weights(make_weights(cfg_f), "int8x2")
    p_f = np.asarray(beamform_power(wire_f, qw, cfg_f))
    p_t = np.asarray(beamform_power(wire_t, qw, cfg_t))
    np.testing.assert_allclose(p_f, p_t, rtol=1e-6)


def test_freq_averaging(tiny_cfg):
    cfg = tiny_cfg.replace(navg_freq=2)
    wire = make_noise_block(cfg, rms=2.0, seed=61)
    qw = quantize_weights(make_weights(cfg), "int8x2")
    p = np.asarray(beamform_power(wire, qw, cfg))
    assert p.shape == cfg.out_block_shape
    p_ref = _golden_power(cfg, wire)
    assert_power_close(p, p_ref, rtol=2e-4, what="navg_freq=2")


def test_fused_quant8_byte_equal(tiny_cfg):
    """In-epilogue 8-bit quantization (quant8_scales): byte-identical
    to quantizing the f32 output after the fact — same rint/clip, same
    f32 rounding order (the fil sink's fused output path)."""
    import jax

    cfg = tiny_cfg
    wire = make_noise_block(cfg, rms=2.0, seed=71)
    qw = quantize_weights(make_weights(cfg), cfg.weight_mode, cfg.a_compute)
    p32 = np.asarray(beamform_power(wire, qw, cfg))
    rng = np.random.default_rng(5)
    scales = (64.0 / np.median(p32)
              * rng.uniform(0.5, 2.0, cfg.n_beams)).astype(np.float32)
    want = np.clip(np.rint(p32 * scales[None, None, :]), 0, 255
                   ).astype(np.uint8)
    got = np.asarray(beamform_power(wire, qw, cfg,
                                    quant8_scales=jax.device_put(scales)))
    assert got.dtype == np.uint8
    np.testing.assert_array_equal(got, want)
    # Rails must actually engage (the clip is load-bearing).
    assert (got == 255).any() or scales.max() * p32.max() < 255


def test_fused_quant8_with_incoherent(tiny_cfg):
    """quant8 composes with the fused incoherent side-product: uint8
    coherent plane, float32 incoherent plane, one kernel."""
    import jax

    from dsabeamformer.ops.incoherent import incoherent_power_golden

    cfg = tiny_cfg
    wire = make_noise_block(cfg, rms=2.0, seed=72)
    qw = quantize_weights(make_weights(cfg), cfg.weight_mode, cfg.a_compute)
    scales = np.full(cfg.n_beams, 0.5, np.float32)
    p, inco = beamform_power(wire, qw, cfg, incoherent=True,
                             quant8_scales=jax.device_put(scales))
    p, inco = np.asarray(p), np.asarray(inco)
    assert p.dtype == np.uint8 and inco.dtype == np.float32
    p32 = np.asarray(beamform_power(wire, qw, cfg))
    np.testing.assert_array_equal(
        p, np.clip(np.rint(p32 * 0.5), 0, 255).astype(np.uint8))
    np.testing.assert_allclose(inco, incoherent_power_golden(wire, cfg),
                               rtol=1e-12)


def test_fused_quant8_rejects_navg_freq(tiny_cfg):
    """Quantization must be the LAST averaging step: navg_freq > 1
    configs get a clean error pointing at the device_post fallback."""
    import jax

    cfg = tiny_cfg.replace(navg_freq=2)
    wire = make_noise_block(cfg, rms=2.0, seed=73)
    qw = quantize_weights(make_weights(cfg), cfg.weight_mode, cfg.a_compute)
    with pytest.raises(ValueError, match="navg_freq"):
        beamform_power(wire, qw, cfg,
                       quant8_scales=jax.device_put(
                           np.ones(cfg.n_beams, np.float32)))
    with pytest.raises(ValueError, match="n_beams"):
        beamform_power(wire, qw, tiny_cfg,
                       quant8_scales=jax.device_put(
                           np.ones(3, np.float32)))


def test_fused_sk_stats_matches_standalone(tiny_cfg):
    """sk_stats=True: the kernel's S1/S2 accumulators equal the
    standalone sk_block_stats pass (same raw units, all active
    antennas), composing with incoherent and quant8 outputs."""
    import jax

    from dsabeamformer.ops.incoherent import sk_block_stats

    cfg = tiny_cfg
    wire = make_noise_block(cfg, rms=2.0, seed=81)
    qw = quantize_weights(make_weights(cfg), cfg.weight_mode, cfg.a_compute)
    ref = {k: np.asarray(v) for k, v in sk_block_stats(wire, cfg).items()}
    p0 = np.asarray(beamform_power(wire, qw, cfg))

    p, sk = beamform_power(wire, qw, cfg, sk_stats=True)
    np.testing.assert_allclose(np.asarray(p), p0, rtol=1e-6)
    sk = np.asarray(sk)
    assert sk.shape == (cfg.n_chan, 2)
    np.testing.assert_allclose(sk[:, 0], ref["s1"], rtol=1e-6)
    np.testing.assert_allclose(sk[:, 1], ref["s2"], rtol=1e-6)

    p, inco, sk2 = beamform_power(wire, qw, cfg, incoherent=True,
                                  sk_stats=True)
    np.testing.assert_allclose(np.asarray(sk2), sk, rtol=1e-7)

    scales = np.full(cfg.n_beams, 0.5, np.float32)
    pq, sk3 = beamform_power(wire, qw, cfg, sk_stats=True,
                             quant8_scales=jax.device_put(scales))
    assert np.asarray(pq).dtype == np.uint8
    np.testing.assert_allclose(np.asarray(sk3), sk, rtol=1e-7)


def test_fused_sk_stats_stokes(tiny_cfg):
    from dsabeamformer.ops.gemm import beamform_stokes
    from dsabeamformer.ops.incoherent import sk_block_stats

    cfg = tiny_cfg
    wire = make_noise_block(cfg, rms=2.0, seed=82)
    qw = quantize_weights(make_weights(cfg), cfg.weight_mode, cfg.a_compute)
    ref = {k: np.asarray(v) for k, v in sk_block_stats(wire, cfg).items()}
    st, sk = beamform_stokes(wire, qw, cfg, sk_stats=True)
    assert np.asarray(st).shape == (*cfg.out_block_shape[:2], 4,
                                    cfg.n_beams)
    np.testing.assert_allclose(np.asarray(sk)[:, 0], ref["s1"], rtol=1e-6)
    st2, inco, sk2 = beamform_stokes(wire, qw, cfg, incoherent=True,
                                     sk_stats=True)
    np.testing.assert_allclose(np.asarray(sk2), np.asarray(sk), rtol=1e-7)


# --------------------------------------------------------------------- #
# Implementation choice, plain-form chunking, kernel lowering
# --------------------------------------------------------------------- #

from dsabeamformer.ops import gemm  # noqa: E402


@pytest.mark.parametrize("mode", gemm.WEIGHT_MODES)
@pytest.mark.parametrize("product", gemm.PRODUCTS)
def test_choice_table_on_gpu(monkeypatch, product, mode):
    """On the gpu backend the table's row runs: the kernel for the int8
    family, the plain form for the float modes — with or without side
    outputs."""
    from dsabeamformer.config import DSA10

    monkeypatch.setattr(gemm.jax, "default_backend", lambda: "gpu")
    cfg = DSA10.replace(weight_mode=mode)
    want = "kernel" if mode in gemm.KERNEL_MODES else "plain"
    for sides in ((), ("incoherent", "quant8", "sk")):
        assert gemm.IMPL[(product, sides, mode)] == want
        assert gemm.choose_impl(product, sides, cfg) == want


def test_choice_cpu_runs_plain_unless_interpret(tiny_cfg):
    assert gemm.choose_impl("power", (), tiny_cfg) == "plain"
    assert gemm.choose_impl("power", (), tiny_cfg, interpret=True) == "kernel"
    with pytest.raises(ValueError, match="implements"):
        gemm.choose_impl("power", (), tiny_cfg.replace(weight_mode="bf16"),
                         interpret=True)


@pytest.mark.parametrize("backend", ["rocm", "metal", "neuron"])
def test_choice_unknown_backend_raises(monkeypatch, tiny_cfg, backend):
    monkeypatch.setattr(gemm.jax, "default_backend", lambda: backend)
    with pytest.raises(RuntimeError, match="no beamforming implementation"):
        gemm.choose_impl("power", (), tiny_cfg)


def test_choice_untileable_geometry_runs_plain(monkeypatch):
    """A geometry the kernel cannot tile (a_compute 112 is not a power
    of two: dsa110 at int13) runs the plain form on the gpu backend."""
    from dsabeamformer.config import DSA110

    monkeypatch.setattr(gemm.jax, "default_backend", lambda: "gpu")
    cfg = DSA110.replace(weight_mode="int13")
    assert cfg.a_compute == 112 and gemm.kernel_tiles(cfg) is None
    assert gemm.choose_impl("power", (), cfg) == "plain"


@pytest.mark.parametrize("name,product,want", [
    ("dsa10", "power", (128, 64)), ("dsa10", "stokes", (64, 32)),
    ("dsa10c", "power", (128, 64)), ("dsa110", "power", (128, 64)),
    ("dsa110", "stokes", (64, 32)),
])
def test_kernel_tiles_presets(name, product, want):
    from dsabeamformer.config import presets

    assert gemm.kernel_tiles(presets()[name], product) == want


def test_kernel_tiles_small_shapes(tiny_cfg):
    """Tiny shapes tile only in the interpreter: a compiled
    tensor-core product needs every dimension >= 16."""
    assert gemm.kernel_tiles(tiny_cfg) is None
    assert gemm.kernel_tiles(tiny_cfg, interpret=True) == (4, 32)


@pytest.mark.parametrize("group", [1, 2, 4])
def test_plain_chunking_equivalence(tiny_cfg, monkeypatch, group):
    """The plain form's channel groups change only what is live at
    once, never the result: every group size gives identical output."""
    from dsabeamformer.ops.gemm import beamform_stokes

    cfg = tiny_cfg
    wire = make_noise_block(cfg, rms=2.0, seed=93)
    qw = quantize_weights(make_weights(cfg), cfg.weight_mode, cfg.a_compute)
    ref_p = np.asarray(beamform_power(wire, qw, cfg, incoherent=True,
                                      sk_stats=True)[0])
    ref_s = np.asarray(beamform_stokes(wire, qw, cfg))
    ref_v = np.asarray(beamform_voltages(wire, qw, cfg))
    monkeypatch.setattr(gemm, "_PLAIN_CHAN_GROUP", group)
    cfg2 = cfg.replace(name=f"tiny-g{group}")  # new jit cache entry
    assert gemm._plain_chan_group(cfg2.n_chan) == group
    np.testing.assert_array_equal(
        np.asarray(beamform_power(wire, qw, cfg2, incoherent=True,
                                  sk_stats=True)[0]), ref_p)
    np.testing.assert_array_equal(np.asarray(beamform_stokes(wire, qw, cfg2)),
                                  ref_s)
    np.testing.assert_array_equal(
        np.asarray(beamform_voltages(wire, qw, cfg2)), ref_v)


@pytest.mark.parametrize("mode", gemm.KERNEL_MODES)
@pytest.mark.parametrize("product", gemm.PRODUCTS)
def test_kernel_lowers_for_cuda(monkeypatch, product, mode):
    """The kernel lowers through Pallas's Triton route for CUDA at the
    preset's real widths (the lowering runs here; compiling the Triton
    IR needs the card).  Side outputs on, as the deployed stack runs."""
    import jax
    import jax.numpy as jnp

    from dsabeamformer.config import DSA10

    cfg = DSA10.replace(weight_mode=mode, n_chan=64)
    monkeypatch.setattr(gemm.jax, "default_backend", lambda: "gpu")
    fn = gemm.beamform_power if product == "power" else gemm.beamform_stokes
    wire = jax.ShapeDtypeStruct(cfg.device_wire_shape, jnp.uint8)
    terms = tuple(
        jax.ShapeDtypeStruct((cfg.n_chan, cfg.gemm_k, 2 * cfg.n_beams),
                             jnp.int8) for _ in range(cfg.n_weight_terms))
    qw = gemm.QuantWeights(terms, jax.ShapeDtypeStruct(
        (cfg.n_chan, cfg.n_weight_terms), jnp.float32))
    q8 = jax.ShapeDtypeStruct((cfg.n_beams,), jnp.float32)
    lowered = jax.jit(
        lambda w, q, s: fn(w, q, cfg, incoherent=True, flag_ants=(3,),
                           quant8_scales=s, sk_stats=True)
    ).trace(wire, qw, q8).lower(lowering_platforms=("cuda",))
    assert "__gpu$xla.gpu.triton" in lowered.as_text()


def test_impl_override(tiny_cfg):
    """impl="plain" runs the plain form anywhere; impl="kernel" raises
    where the compiled kernel cannot run (here: the cpu backend)."""
    assert gemm.choose_impl("power", (), tiny_cfg, impl="plain") == "plain"
    assert gemm.choose_impl("power", (), tiny_cfg, interpret=True,
                            impl="plain") == "plain"
    with pytest.raises(ValueError, match="does not tile"):
        gemm.choose_impl("power", (), tiny_cfg, impl="kernel")
    from dsabeamformer.config import DSA10

    with pytest.raises(ValueError, match="cannot run on the 'cpu'"):
        gemm.choose_impl("power", (), DSA10, impl="kernel")
    with pytest.raises(ValueError, match="unknown implementation"):
        gemm.choose_impl("power", (), tiny_cfg, impl="xla")
