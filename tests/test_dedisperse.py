"""Dedispersion search (`ops/dedisperse.py`, `dsabf search`): grid
math, golden-model agreement, pulse recovery, false-alarm floor, and
chunking invariance."""

import dataclasses

import numpy as np
import pytest

from dsabeamformer.config import DM_CONST_S, dm_delays_s
from dsabeamformer.ops.dedisperse import (
    Candidate,
    dedisperse_bank,
    delay_table,
    dm_trial_grid,
    search_spectrogram,
    write_candidates,
)

F_LO, F_HI = 1280.0, 1530.0  # MHz, the dsa10 band
TSAMP = 1.048576e-3          # s (dsa10 averaged-output cadence class)


def _freqs(nf):
    return np.linspace(F_LO, F_HI, nf)


def test_dm_grid_spacing():
    dms = dm_trial_grid(F_LO, F_HI, TSAMP, dm_max=500.0, tol=1.25)
    assert dms[0] == 0.0
    assert dms[-1] >= 500.0
    # adjacent trials differ by exactly tol output samples of
    # band-edge differential delay
    step = dms[1] - dms[0]
    span = DM_CONST_S * step * (F_LO ** -2.0 - F_HI ** -2.0)
    assert span == pytest.approx(1.25 * TSAMP, rel=1e-12)
    # linear grid
    assert np.allclose(np.diff(dms), step)


def test_dm_grid_validation():
    with pytest.raises(ValueError):
        dm_trial_grid(F_HI, F_LO, TSAMP, 100.0)
    with pytest.raises(ValueError):
        dm_trial_grid(F_LO, F_HI, TSAMP, dm_max=1.0, dm_min=2.0)
    single = dm_trial_grid(F_LO, F_HI, TSAMP, dm_max=7.0, dm_min=7.0)
    assert single.tolist() == [7.0]


def test_delay_table_convention():
    freqs = _freqs(64)
    dms = np.array([0.0, 50.0, 300.0])
    d = delay_table(freqs, dms, TSAMP)
    assert d.shape == (3, 64)
    assert d.dtype == np.int32
    # band top arrives first: zero delay there, monotone growth down
    assert np.all(d[:, -1] == 0)
    assert np.all(np.diff(d, axis=1) <= 0)
    assert np.all(d[0] == 0)
    # matches the package-wide curve with round-to-nearest
    expect = np.rint(dm_delays_s(freqs, 300.0, freqs[-1]) / TSAMP)
    assert np.array_equal(d[2], expect.astype(np.int32))


def test_dedisperse_bank_matches_numpy_golden():
    rng = np.random.default_rng(7)
    t, nf = 128, 16
    x = rng.normal(size=(t, nf)).astype(np.float32)
    dms = np.array([0.0, 30.0, 120.0, 400.0])
    delays = delay_table(_freqs(nf), dms, TSAMP * 50)  # big steps
    assert delays.max() > 0
    bank, valid = dedisperse_bank(x, delays)
    bank = np.asarray(bank)

    fill = np.median(x, axis=0)
    padded = np.concatenate(
        [x, np.broadcast_to(fill, (int(delays.max()), nf))], axis=0)
    golden = np.zeros((len(dms), t), np.float64)
    for d in range(len(dms)):
        for f in range(nf):
            golden[d] += padded[delays[d, f]: delays[d, f] + t, f]
    assert np.allclose(bank, golden, rtol=1e-5, atol=1e-4)
    assert np.array_equal(valid, t - delays.max(axis=1))
    # DM=0 trial is the straight channel sum
    assert np.allclose(bank[0], x.sum(axis=1), rtol=1e-5, atol=1e-4)


def test_dedisperse_bank_rejects_bad_tables():
    x = np.zeros((32, 8), np.float32)
    with pytest.raises(ValueError, match="channels"):
        dedisperse_bank(x, np.zeros((2, 4), np.int32))
    with pytest.raises(ValueError, match="negative"):
        dedisperse_bank(x, np.full((2, 8), -1, np.int32))


def _pulse_spectrogram(t, nf, dm, t0, width, amp, seed=0):
    """White noise + a dispersed boxcar pulse of per-channel height
    ``amp`` sigma and ``width`` samples, arriving at the band top at
    sample ``t0``."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(t, nf)).astype(np.float32)
    freqs = _freqs(nf)
    shifts = np.rint(
        dm_delays_s(freqs, dm, freqs[-1]) / TSAMP).astype(int)
    for f in range(nf):
        a = t0 + shifts[f]
        x[a: a + width, f] += amp
    return x, freqs


def test_search_recovers_injected_pulse():
    dm_true, t0, w_true = 90.0, 700, 4
    x, freqs = _pulse_spectrogram(2048, 64, dm_true, t0, w_true, amp=1.0)
    dms = dm_trial_grid(F_LO, F_HI, TSAMP, dm_max=300.0, tol=1.25)
    cands = search_spectrogram(x, freqs, TSAMP, dms, threshold=7.0)
    assert cands, "injected pulse not detected"
    best = cands[0]
    # per-sample channel-sum S/N is amp*sqrt(nf)=8; the width-matched
    # boxcar gets ~amp*sqrt(nf*w)=16
    assert best.snr > 10.0
    step = dms[1] - dms[0]
    assert abs(best.dm - dm_true) <= 2 * step
    assert abs(best.t_samp - t0) <= 2 * w_true
    assert best.width in (w_true // 2, w_true, 2 * w_true)
    assert best.members > 1  # the (t, dm) ridge clustered into one
    # the ridge must NOT also appear as weaker separate candidates at
    # essentially the same (t, dm)
    dupes = [c for c in cands[1:]
             if abs(c.t_samp - t0) < 32 and abs(c.dm - dm_true) < 4 * step]
    assert not dupes, f"ridge fragmented: {dupes}"


def test_search_pure_noise_is_quiet():
    rng = np.random.default_rng(3)
    x = rng.normal(size=(2048, 64)).astype(np.float32)
    dms = dm_trial_grid(F_LO, F_HI, TSAMP, dm_max=300.0, tol=1.25)
    cands = search_spectrogram(x, _freqs(64), TSAMP, dms, threshold=8.0)
    assert cands == []


def test_search_chunked_matches_whole():
    dm_true, t0 = 120.0, 1500
    x, freqs = _pulse_spectrogram(4096, 64, dm_true, t0, 4, amp=1.0, seed=5)
    dms = dm_trial_grid(F_LO, F_HI, TSAMP, dm_max=300.0, tol=1.25)
    whole = search_spectrogram(x, freqs, TSAMP, dms, threshold=7.5)
    # chunk boundary at 1024/2048/3072: the pulse (t0=1500) straddles
    # the second chunk's interior; its sweep extends past 2048
    chunked = search_spectrogram(
        x, freqs, TSAMP, dms, threshold=7.5, chunk_t=1024)
    assert whole and chunked
    assert abs(whole[0].t_samp - chunked[0].t_samp) <= 4
    assert abs(whole[0].dm - chunked[0].dm) <= 2 * (dms[1] - dms[0])
    # one event -> one cluster in both
    near = [c for c in chunked if abs(c.t_samp - t0) < 64]
    assert len(near) == 1


def test_subband_plan_error_bound():
    """Every trial's within-group delay profile sits within
    max_err_samples of its assigned coarse representative — the bound
    the two-stage bank's accuracy claim rests on — and the coarse set
    is substantially smaller than the trial set."""
    from dsabeamformer.ops.dedisperse import subband_plan

    freqs = _freqs(96)  # not divisible by n_sub=10 -> exercises pad
    dms = dm_trial_grid(F_LO, F_HI, TSAMP, dm_max=400.0, tol=1.25)
    delays = delay_table(freqs, dms, TSAMP)
    n_sub, err = 10, 1
    intra_c, inter, rep_of, pad_f = subband_plan(delays, n_sub, err)
    g, n_coarse, c = intra_c.shape
    assert g == n_sub and pad_f == n_sub * c - 96
    assert n_coarse < len(dms) / 3
    padded = np.concatenate(
        [delays, np.zeros((len(dms), pad_f), delays.dtype)], axis=1)
    grouped = padded.reshape(len(dms), n_sub, c)
    intra = grouped - inter[:, :, None]
    intra[:, -1, c - pad_f:] = 0
    for d in range(len(dms)):
        assert np.abs(intra[d] - intra_c[:, rep_of[d], :]).max() <= err
    # reconstruction: inter + intra == delays on real channels
    recon = inter[:, :, None] + intra
    assert np.array_equal(recon.reshape(len(dms), -1)[:, :96], delays)


def test_subband_bank_exact_at_zero_budget():
    """With max_err_samples=0 the two-stage bank must equal the
    brute-force bank to float tolerance (same sums, same shifts)."""
    from dsabeamformer.ops.dedisperse import subband_dedisperse_bank

    rng = np.random.default_rng(2)
    x = rng.normal(size=(512, 32)).astype(np.float32)
    dms = dm_trial_grid(F_LO, F_HI, TSAMP, dm_max=200.0, tol=1.25)
    delays = delay_table(_freqs(32), dms, TSAMP)
    b0, v0 = dedisperse_bank(x, delays)
    b1, v1 = subband_dedisperse_bank(x, delays, n_sub=4,
                                     max_err_samples=0)
    assert np.array_equal(v0, v1)
    assert np.allclose(np.asarray(b0), np.asarray(b1),
                       rtol=1e-4, atol=1e-3)


def test_subband_search_recovers_pulse_comparably():
    """method='subband' finds the injected pulse at the same (t, DM)
    with S/N within ~10% of the exact bank (<=1 sample extra smear)."""
    dm_true, t0 = 150.0, 900
    x, freqs = _pulse_spectrogram(2048, 64, dm_true, t0, 4, amp=1.0,
                                  seed=31)
    dms = dm_trial_grid(F_LO, F_HI, TSAMP, dm_max=300.0, tol=1.25)
    direct = search_spectrogram(x, freqs, TSAMP, dms, threshold=7.5)
    sub = search_spectrogram(x, freqs, TSAMP, dms, threshold=7.5,
                             method="subband", n_sub=8)
    assert direct and sub
    d0, s0 = direct[0], sub[0]
    assert abs(s0.t_samp - d0.t_samp) <= 4
    assert abs(s0.dm - d0.dm) <= 4 * (dms[1] - dms[0])
    assert s0.snr > 0.9 * d0.snr
    # pure noise stays quiet under the approximate bank too
    rng = np.random.default_rng(6)
    noise = rng.normal(size=(2048, 64)).astype(np.float32)
    assert search_spectrogram(noise, freqs, TSAMP, dms, threshold=8.0,
                              method="subband", n_sub=8) == []


def test_conv_bank_matches_subband_bank():
    """The conv bank computes the SAME two-stage plan as the
    gather subband bank — identical sums, so identical output to
    float tolerance at every n_sub (the only difference is the
    primitive: one-hot grouped conv + dynamic slices vs gathers)."""
    from dsabeamformer.ops.dedisperse import (
        conv_dedisperse_bank, subband_dedisperse_bank)

    rng = np.random.default_rng(3)
    x = rng.normal(size=(768, 96)).astype(np.float32)  # 96: pad path
    dms = dm_trial_grid(F_LO, F_HI, TSAMP, dm_max=300.0, tol=1.25)
    delays = delay_table(_freqs(96), dms, TSAMP)
    for n_sub in (4, 10):
        b_sub, v_sub = subband_dedisperse_bank(x, delays, n_sub=n_sub)
        b_conv, v_conv = conv_dedisperse_bank(x, delays, n_sub=n_sub)
        assert np.array_equal(v_sub, v_conv)
        assert np.allclose(np.asarray(b_sub), np.asarray(b_conv),
                           rtol=1e-4, atol=1e-3)


def test_conv_bank_exact_at_zero_budget():
    """max_err_samples=0 collapses the plan to one coarse trial per
    trial — the conv bank must then equal the brute-force bank."""
    from dsabeamformer.ops.dedisperse import conv_dedisperse_bank

    rng = np.random.default_rng(2)
    x = rng.normal(size=(512, 32)).astype(np.float32)
    dms = dm_trial_grid(F_LO, F_HI, TSAMP, dm_max=200.0, tol=1.25)
    delays = delay_table(_freqs(32), dms, TSAMP)
    b0, v0 = dedisperse_bank(x, delays)
    b1, v1 = conv_dedisperse_bank(x, delays, n_sub=4, max_err_samples=0)
    assert np.array_equal(v0, v1)
    assert np.allclose(np.asarray(b0), np.asarray(b1),
                       rtol=1e-4, atol=1e-3)


def test_conv_bank_batch_and_plan_cache():
    """The batched conv bank matches per-beam calls, and the one-hot
    kernel is built once per delay table (the streaming monitor calls
    every window)."""
    from dsabeamformer.ops import dedisperse as dd

    rng = np.random.default_rng(5)
    xb = rng.normal(size=(3, 512, 32)).astype(np.float32)
    dms = dm_trial_grid(F_LO, F_HI, TSAMP, dm_max=150.0, tol=1.25)
    delays = delay_table(_freqs(32), dms, TSAMP)
    bb, vb = dd.conv_dedisperse_bank_batch(xb, delays, n_sub=4)
    for i in range(3):
        bi, vi = dd.conv_dedisperse_bank(xb[i], delays, n_sub=4)
        assert np.array_equal(vb, vi)
        assert np.allclose(np.asarray(bb)[i], np.asarray(bi),
                           rtol=1e-5, atol=1e-4)
    plan1 = dd._conv_plan(delays, 4, 1)
    plan2 = dd._conv_plan(delays, 4, 1)
    assert plan1 is plan2  # cached: kernel upload happens once


def test_conv_auto_n_sub_bounds_kernel_span():
    """The auto group count grows with the DM range so the one-hot
    kernel's width stays bounded (dm_max=1000 with 16 groups is a
    3.9 GB kernel at DSA-10 scale — a worker-killing dispatch), and
    the conv bank still honors the max_err_samples contract at the
    auto pick."""
    from dsabeamformer.config import DSA10
    from dsabeamformer.ops.dedisperse import (
        _conv_auto_n_sub, conv_dedisperse_bank, subband_dedisperse_bank)

    cfg = DSA10
    ts = cfg.sample_period_s * cfg.navg_time
    f = cfg.freqs_hz() / 1e6
    picks = {}
    for dm in (100.0, 1000.0):
        dms = dm_trial_grid(float(f.min()), float(f.max()), ts, dm_max=dm)
        delays = delay_table(f, dms, ts)
        n = picks[dm] = _conv_auto_n_sub(delays)
        # the worst within-group span is actually bounded at the pick
        worst = np.asarray(
            delays[int(np.argmax(delays.max(axis=1)))], np.int64)
        c = -(-len(worst) // n)
        pad = n * c - len(worst)
        g = np.concatenate([worst, np.zeros(pad, np.int64)]).reshape(n, c)
        assert (g.max(axis=1) - g.min(axis=1)).max() <= 64
    assert picks[100.0] == 16       # the measured monitor geometry
    assert picks[1000.0] > picks[100.0]

    # auto default equals the gather bank on a small table (same plan)
    rng = np.random.default_rng(11)
    x = rng.normal(size=(512, 64)).astype(np.float32)
    dms = dm_trial_grid(F_LO, F_HI, TSAMP, dm_max=200.0, tol=1.25)
    delays = delay_table(_freqs(64), dms, TSAMP)
    b_auto, v_auto = conv_dedisperse_bank(x, delays)
    from dsabeamformer.ops.dedisperse import _conv_auto_n_sub as auto
    b_ref, v_ref = subband_dedisperse_bank(x, delays, n_sub=auto(delays))
    assert np.array_equal(v_auto, v_ref)
    assert np.allclose(np.asarray(b_auto), np.asarray(b_ref),
                       rtol=1e-4, atol=1e-3)


def test_conv_bank_uint8_bf16_path_bit_exact():
    """uint8 products take the bf16 convolution; it must be
    BIT-identical to the f32 HIGHEST path in the guaranteed-data
    region (integers <= 255 are exact in bf16, the kernel is one-hot,
    accumulation is f32) — the fused-quant8 live monitor's fast path
    is not an approximation."""
    from dsabeamformer.ops.dedisperse import conv_dedisperse_bank

    rng = np.random.default_rng(7)
    x8 = rng.integers(0, 256, size=(1024, 64), dtype=np.uint8)
    dms = dm_trial_grid(F_LO, F_HI, TSAMP, dm_max=250.0, tol=1.25)
    delays = delay_table(_freqs(64), dms, TSAMP)
    b8, v8 = conv_dedisperse_bank(x8, delays)
    bf, vf = conv_dedisperse_bank(x8.astype(np.float32) + 0.0, delays)
    assert np.array_equal(v8, vf)
    a8, af = np.asarray(b8), np.asarray(bf)
    for d in range(len(dms)):
        n = max(0, int(v8[d]) - 1)  # plan may overshoot by max_err
        assert np.array_equal(a8[d, :n], af[d, :n]), d


def test_conv_bank_prep_device_split_matches_wrapper():
    """`scripts/measure_search.py`'s stage decomposition drives
    `_conv_bank_prep` + device-resident `_conv_bank_c` directly (host /
    H2D / device split at the monitor geometry); that split path must
    equal the `conv_dedisperse_bank` wrapper bit-for-bit, or the
    decomposition times a different program than production runs."""
    import jax

    from dsabeamformer.ops import dedisperse as dd

    rng = np.random.default_rng(7)
    t_out = 256
    dms = dm_trial_grid(F_LO, F_HI, TSAMP, dm_max=150.0, tol=1.25)
    delays = delay_table(_freqs(32), dms, TSAMP)
    x = rng.normal(
        size=(1, t_out + int(delays.max()), 32)).astype(np.float32)
    b_wrap, v_wrap = dd.conv_dedisperse_bank(x[0], delays, n_sub=4)
    xp, fill, kern, offsets, t_pad, g, t1, v_split = dd._conv_bank_prep(
        x, delays, 4, 1)
    dev = [jax.device_put(a) for a in
           (xp, fill, np.asarray(kern), offsets)]
    b_split = dd._conv_bank_c(dev[0], dev[1], dev[2], dev[3],
                              t_pad, g, t1, x.shape[1])[0]
    assert np.array_equal(v_wrap, v_split)
    assert np.array_equal(np.asarray(b_wrap), np.asarray(b_split))


def test_conv_search_recovers_pulse_comparably():
    """method='conv' (the live default) finds the injected pulse at
    the same (t, DM) with S/N within ~10% of the exact bank, and pure
    noise stays quiet."""
    dm_true, t0 = 150.0, 900
    x, freqs = _pulse_spectrogram(2048, 64, dm_true, t0, 4, amp=1.0,
                                  seed=31)
    dms = dm_trial_grid(F_LO, F_HI, TSAMP, dm_max=300.0, tol=1.25)
    direct = search_spectrogram(x, freqs, TSAMP, dms, threshold=7.5)
    conv = search_spectrogram(x, freqs, TSAMP, dms, threshold=7.5,
                              method="conv")
    assert direct and conv
    d0, c0 = direct[0], conv[0]
    assert abs(c0.t_samp - d0.t_samp) <= 4
    assert abs(c0.dm - d0.dm) <= 4 * (dms[1] - dms[0])
    assert c0.snr > 0.9 * d0.snr
    rng = np.random.default_rng(6)
    noise = rng.normal(size=(2048, 64)).astype(np.float32)
    assert search_spectrogram(noise, freqs, TSAMP, dms, threshold=8.0,
                              method="conv") == []


def test_search_method_validation():
    """Unknown bank methods fail loudly everywhere they can be set."""
    from dsabeamformer.ops.dedisperse import SearchMonitor

    dms = dm_trial_grid(F_LO, F_HI, TSAMP, dm_max=100.0, tol=1.25)
    with pytest.raises(ValueError, match="conv|direct|subband"):
        SearchMonitor(_freqs(32), TSAMP, dms, method="fft")
    x = np.zeros((256, 32), np.float32)
    with pytest.raises(ValueError, match="conv|direct|subband"):
        search_spectrogram(x, _freqs(32), TSAMP, dms, method="fft")


def test_zerodm_kills_broadband_rfi_keeps_pulse():
    """A broadband undispersed spike triggers at DM~0; the zero-DM
    filter removes it while the dispersed pulse survives."""
    dm_true, t0 = 90.0, 700
    x, freqs = _pulse_spectrogram(2048, 64, dm_true, t0, 4, amp=1.2,
                                  seed=13)
    x[300:302, :] += 4.0  # broadband impulsive RFI, all channels
    dms = dm_trial_grid(F_LO, F_HI, TSAMP, dm_max=300.0, tol=1.25)
    dirty = search_spectrogram(x, freqs, TSAMP, dms, threshold=7.5)
    rfi_hits = [c for c in dirty if abs(c.t_samp - 300) < 16]
    assert rfi_hits and rfi_hits[0].dm < 10.0  # fires near DM 0
    clean = search_spectrogram(x, freqs, TSAMP, dms, threshold=7.5,
                               zerodm=True)
    assert not [c for c in clean if abs(c.t_samp - 300) < 16]
    pulse = [c for c in clean if abs(c.t_samp - t0) < 32]
    assert pulse and abs(pulse[0].dm - dm_true) < 10.0


def test_zap_kills_bursty_channel_keeps_pulse():
    """One bursty channel manufactures candidates; zapping it
    neutralizes them and the pulse (in other channels) survives."""
    rng = np.random.default_rng(17)
    dm_true, t0 = 90.0, 700
    x, freqs = _pulse_spectrogram(2048, 64, dm_true, t0, 4, amp=1.2,
                                  seed=17)
    bursts = rng.choice(1800, size=40, replace=False)
    x[bursts, 20] += 30.0  # hot bursty channel
    dms = dm_trial_grid(F_LO, F_HI, TSAMP, dm_max=300.0, tol=1.25)
    dirty = search_spectrogram(x, freqs, TSAMP, dms, threshold=7.5)
    clean = search_spectrogram(x, freqs, TSAMP, dms, threshold=7.5,
                               zap=[20])
    assert len(clean) < len(dirty)
    pulse = [c for c in clean if abs(c.t_samp - t0) < 32]
    assert pulse and abs(pulse[0].dm - dm_true) < 10.0
    # only the pulse remains
    assert len(clean) == 1


def test_preprocess_validation():
    from dsabeamformer.ops.dedisperse import preprocess_spectrogram

    x = np.ones((16, 4), np.float32)
    with pytest.raises(ValueError, match="outside"):
        preprocess_spectrogram(x, zap=[4])
    with pytest.raises(ValueError, match="every channel"):
        preprocess_spectrogram(x, zap=[0, 1, 2, 3])
    y = preprocess_spectrogram(x, zap=[1], zerodm=True)
    assert np.all(y[:, 1] == 0.0)
    assert np.allclose(y[:, [0, 2, 3]], 0.0)  # constant rows -> mean out
    assert x[0, 1] == 1.0  # input untouched


def _write_fil(path, x_ascending, tsamp, ibeam=0):
    """Minimal nbits=32 SIGPROC file via the package's own header
    encoder, stored in the standard descending-channel order."""
    from dsabeamformer.ingest.sigproc import _encode_header_dict

    t, nf = x_ascending.shape
    hdr = {"fch1": F_HI, "foff": -(F_HI - F_LO) / (nf - 1),
           "nchans": nf, "nbits": 32, "nifs": 1, "tsamp": tsamp,
           "ibeam": ibeam}
    with open(path, "wb") as fh:
        fh.write(_encode_header_dict(hdr))
        fh.write(np.ascontiguousarray(
            x_ascending[:, ::-1], np.float32).tobytes())


def test_cli_search_fil_end_to_end(tmp_path, capsys):
    """dsabf search on a .fil with an injected dispersed pulse: table
    printed, candidate file written, DM recovered."""
    from dsabeamformer.cli import main as cli_main

    dm_true = 90.0
    x, _ = _pulse_spectrogram(2048, 64, dm_true, 700, 4, amp=1.0, seed=11)
    fil = tmp_path / "beam.fil"
    _write_fil(fil, x, TSAMP)
    cand = tmp_path / "beam.cand"
    rc = cli_main(["search", str(fil), "--dm-max", "300",
                   "--threshold", "7", "--cand", str(cand)])
    assert rc == 0
    out = capsys.readouterr().out
    rows = [l for l in out.splitlines()
            if l.strip() and not l.startswith("#")]
    assert rows, out
    best = rows[0].split()
    assert float(best[0]) > 10.0          # snr
    assert abs(float(best[5]) - dm_true) < 10.0  # dm column
    body = cand.read_text()
    assert "# threshold = 7.0" in body
    assert "# n_dm_trials" in body


def test_batched_search_matches_per_beam():
    """search_spectrograms (vmapped beam-batched device path) returns
    exactly search_spectrogram's candidates per beam, for both bank
    methods, across chunk boundaries and partial beam groups."""
    from dsabeamformer.ops.dedisperse import (
        search_spectrogram, search_spectrograms)

    freqs = _freqs(64)
    dms = dm_trial_grid(F_LO, F_HI, TSAMP, dm_max=300.0)
    spectra = []
    for b in range(5):
        x, _ = _pulse_spectrogram(1500, 64, 90.0, 400 + 50 * b, 4,
                                  amp=0.8 if b % 2 else 0.0, seed=b)
        spectra.append((b, x))
    for method in ("direct", "subband"):
        by_beam = search_spectrograms(
            spectra, freqs, TSAMP, dms, threshold=7.0, chunk_t=512,
            method=method, beam_batch=2)  # 2+2+1: exercises tail group
        for b, x in spectra:
            ref = search_spectrogram(x, freqs, TSAMP, dms,
                                     threshold=7.0, chunk_t=512,
                                     method=method)
            got = by_beam[b]
            assert len(got) == len(ref), (method, b)
            for cg, cr in zip(got, ref):
                assert cg == dataclasses.replace(cr, beam=b), (method, b)


def test_batched_search_validation():
    from dsabeamformer.ops.dedisperse import search_spectrograms

    freqs = _freqs(16)
    dms = dm_trial_grid(F_LO, F_HI, TSAMP, dm_max=50.0)
    x = np.zeros((256, 16), np.float32)
    with pytest.raises(ValueError, match="no spectra"):
        search_spectrograms([], freqs, TSAMP, dms)
    with pytest.raises(ValueError, match="duplicate"):
        search_spectrograms([(0, x), (0, x)], freqs, TSAMP, dms)
    with pytest.raises(ValueError, match="shapes differ"):
        search_spectrograms([(0, x), (1, x[:-1])], freqs, TSAMP, dms)


def test_coincidence_filter_unit():
    """A cluster hitting most beams is RFI; a two-beam pulse is kept."""
    from dsabeamformer.ops.dedisperse import coincidence_filter

    dms = dm_trial_grid(F_LO, F_HI, TSAMP, dm_max=300.0, tol=1.25)
    delays = delay_table(_freqs(64), dms, TSAMP)
    span = delays.max(axis=1)

    def cand(snr, t, w, d, beam):
        return Candidate(snr=snr, t_samp=t, time_s=t * TSAMP, width=w,
                         dm_idx=d, dm=float(dms[d]), members=5,
                         dm_lo=float(dms[d]), dm_hi=float(dms[d]),
                         beam=beam)

    by_beam = {}
    for b in range(24):
        cs = []
        if b < 20:  # broadband RFI fires low-DM in 20 of 24 beams
            cs.append(cand(9.0 + 0.1 * b, 300, 2, 1, b))
        if b in (3, 4):  # the sky pulse: two adjacent beams
            cs.append(cand(14.0 - b, 700, 4, 30, b))
        by_beam[b] = cs
    kept, rfi = coincidence_filter(by_beam, span, n_beams_searched=24)
    assert len(rfi) == 1 and rfi[0]["n_beams"] == 20
    assert rfi[0]["t_samp"] == 300
    remaining = [c for cs in kept.values() for c in cs]
    assert sorted(c.beam for c in remaining) == [3, 4]
    # frac validation
    with pytest.raises(ValueError):
        coincidence_filter(by_beam, span, 24, frac=0.0)


def test_cli_search_multibeam_fil_coincidence(tmp_path, capsys):
    """Eight per-beam .fil files: an undispersed spike in every beam
    is coincidence-rejected; a dispersed pulse in two beams survives
    with its beam recorded."""
    from dsabeamformer.cli import main as cli_main

    dm_true, t0 = 90.0, 700
    paths = []
    for b in range(8):
        x, _ = _pulse_spectrogram(2048, 64, dm_true, t0, 4,
                                  amp=1.0 if b in (3, 4) else 0.0,
                                  seed=40 + b)
        x[300:302, :] += 3.0  # broadband RFI in EVERY beam
        p = tmp_path / f"beam_{b:04d}.fil"
        _write_fil(p, x, TSAMP, ibeam=b)
        paths.append(str(p))
    cand = tmp_path / "multi.cand"
    rc = cli_main(["search", *paths, "--dm-max", "300",
                   "--threshold", "7", "--cand", str(cand)])
    assert rc == 0
    cap = capsys.readouterr()
    assert "rfi-coincidence" in cap.err
    rows = [l.split() for l in cap.out.splitlines()
            if l.strip() and not l.startswith("#")]
    assert rows, cap.out
    beams = {int(r[9]) for r in rows}
    assert beams <= {3, 4}
    assert all(abs(int(r[1]) - t0) < 32 for r in rows)
    # and with --no-coincidence the spike candidates come back
    capsys.readouterr()
    rc = cli_main(["search", *paths, "--dm-max", "300",
                   "--threshold", "7", "--no-coincidence"])
    assert rc == 0
    out = capsys.readouterr().out
    rows = [l.split() for l in out.splitlines()
            if l.strip() and not l.startswith("#")]
    assert any(abs(int(r[1]) - 300) < 16 for r in rows)


def test_cli_search_dada_all_beams(tiny_cfg, tmp_path, capsys):
    """--beam all on a DADA product searches every beam from one file
    read; the drill pulse's strongest candidate sits in the pointed
    beam."""
    from dsabeamformer.cli import main as cli_main
    from dsabeamformer.config import DM_CONST_S

    cfg = tiny_cfg.replace(navg_time=2)
    f = cfg.freqs_hz() / 1e6
    tsamp_out = cfg.sample_period_s * cfg.navg_time
    dm = (16 * tsamp_out
          / (DM_CONST_S * (f.min() ** -2 - f.max() ** -2)))
    cap = tmp_path / "cap.dada"
    assert cli_main(["simulate", "--config", "tiny", "--set", "navg_time=2",
                     "--pulse-dm", str(dm), "--pulse-t0", "8",
                     "--pulse-width", "6", "--blocks", "6", "--distinct",
                     "2", "--out-file", str(cap)]) == 0
    out = tmp_path / "out.dada"
    assert cli_main(["run", "--config", "tiny", "--set", "navg_time=2",
                     "--input-file", str(cap),
                     "--output-file", str(out)]) == 0
    capsys.readouterr()
    # a coherent injected point source lands in MANY beams via
    # sidelobes — exactly what coincidence rejects — so this drill
    # runs with --no-coincidence and checks the beam ranking instead
    # explicit --dm-max: at tiny's ns-scale cadence the tol-spaced
    # grid to the default 1000 pc/cm^3 would need millions of trials
    # (cmd_search now refuses; see its grid-size guard)
    rc = cli_main(["search", str(out), "--beam", "all",
                   "--threshold", "8", "--no-coincidence",
                   "--dm-max", str(2 * dm), "--widths", "1", "2", "4"])
    assert rc == 0
    capd = capsys.readouterr()
    assert f"{cfg.n_beams} beam(s)" in capd.err
    rows = [l.split() for l in capd.out.splitlines()
            if l.strip() and not l.startswith("#")]
    assert rows
    # linspace(-half, half, n_beams) has no beam AT boresight for even
    # counts: the source sits between beams 15 and 16 — either may win
    assert int(rows[0][9]) in (cfg.n_beams // 2 - 1, cfg.n_beams // 2)


def test_cli_search_rejects_absurd_dm_grid(tmp_path, capsys):
    """A fast-cadence product searched to a huge --dm-max fails with
    the knobs named, instead of allocating a multi-GB delay table."""
    from dsabeamformer.cli import main as cli_main

    x = np.random.default_rng(0).normal(size=(64, 16)).astype(np.float32)
    p = tmp_path / "fast.fil"
    _write_fil(p, x, tsamp=1e-9)
    rc = cli_main(["search", str(p), "--dm-max", "1000"])
    assert rc == 1
    err = capsys.readouterr().err
    assert "trials" in err and "--dm-step" in err


def test_cli_search_rejects_headerless_product(tmp_path, capsys):
    """A product whose header can't give the band/cadence fails with a
    clean message, not a traceback."""
    from dsabeamformer.cli import main as cli_main

    p = tmp_path / "x.fil"
    p.write_bytes(b"garbage")
    assert cli_main(["search", str(p)]) == 1
    assert "error:" in capsys.readouterr().err


def _feed_monitor(mon, x, t_out, beam=1, n_beams=4, seq0=0, skip=None):
    """Slice ``[T, F]`` into ``[F, t_out, n_beams]`` product blocks
    (spectrogram in ``beam``, noise elsewhere) and feed observe()."""
    rng = np.random.default_rng(99)
    t = x.shape[0]
    for i in range(t // t_out):
        if skip is not None and i == skip:
            continue
        sl = x[i * t_out: (i + 1) * t_out]  # [t_out, F]
        block = rng.normal(size=(x.shape[1], t_out, n_beams)
                           ).astype(np.float32)
        block[:, :, beam] = sl.T
        mon.observe(seq0 + i, block)


def test_search_monitor_matches_offline():
    """Streaming windows (block-fed, overlap carried) find the same
    event the offline chunk loop finds on the identical spectrogram."""
    from dsabeamformer.ops.dedisperse import SearchMonitor

    dm_true, t0 = 90.0, 700
    x, freqs = _pulse_spectrogram(2048, 64, dm_true, t0, 4, amp=1.0, seed=21)
    dms = dm_trial_grid(F_LO, F_HI, TSAMP, dm_max=300.0, tol=1.25)
    offline = search_spectrogram(x, freqs, TSAMP, dms, threshold=7.5,
                                 chunk_t=512)
    # method="direct" pins both sides to the exact bank: this test
    # asserts SNR equality to 1e-5, which only holds when the monitor
    # and the offline loop run the same bank (the monitor's production
    # default is "conv"; its agreement is tested separately).
    mon = SearchMonitor(freqs, TSAMP, dms, beam=1, threshold=7.5,
                        chunk_t=512, method="direct")
    _feed_monitor(mon, x, t_out=128)
    mon.flush()
    assert mon.searched_windows >= 3
    assert offline and mon.candidates
    best_off = offline[0]
    best_live = max(mon.candidates, key=lambda c: c.snr)
    assert best_live.t_samp == best_off.t_samp
    assert best_live.dm == best_off.dm
    assert best_live.snr == pytest.approx(best_off.snr, rel=1e-5)
    # one event -> one cluster live too
    assert len([c for c in mon.candidates
                if abs(c.t_samp - t0) < 64]) == 1


def test_search_monitor_gap_resets():
    """A dropped block (sequence gap) flushes and restarts the sweep
    buffer instead of stitching discontinuous data."""
    from dsabeamformer.ops.dedisperse import SearchMonitor

    x, freqs = _pulse_spectrogram(1024, 64, 90.0, 200, 4, amp=1.0, seed=4)
    dms = dm_trial_grid(F_LO, F_HI, TSAMP, dm_max=300.0, tol=1.25)
    mon = SearchMonitor(freqs, TSAMP, dms, beam=1, threshold=7.5,
                        chunk_t=512)
    _feed_monitor(mon, x, t_out=128, skip=5)  # drop block 5 (t 640-768)
    mon.flush()
    assert mon.gaps == 1
    # the pulse (t~200, fully inside pre-gap data) is still found
    assert any(abs(c.t_samp - 200) < 32 for c in mon.candidates)


def test_search_monitor_incoherent_and_stokes_extraction():
    from dsabeamformer.ops.dedisperse import SearchMonitor

    x, freqs = _pulse_spectrogram(512, 32, 60.0, 100, 4, amp=1.5, seed=8)
    dms = dm_trial_grid(F_LO, F_HI, TSAMP, dm_max=150.0, tol=1.25)
    # incoherent target: [F, T] blocks via the inco argument
    mon = SearchMonitor(freqs, TSAMP, dms, incoherent=True, threshold=7.0,
                        chunk_t=256)
    assert not mon.wants_beams
    for i in range(4):
        mon.observe(i, None, inco=x[i * 128:(i + 1) * 128].T)
    mon.flush()
    assert any(abs(c.t_samp - 100) < 16 for c in mon.candidates)
    # missing incoherent product is a clean error
    with pytest.raises(ValueError, match="incoherent"):
        mon.observe(99, np.zeros((32, 8, 2), np.float32), inco=None)
    # Stokes product [F, T, 4, B]: plane I is searched
    mon2 = SearchMonitor(freqs, TSAMP, dms, beam=0, threshold=7.0,
                         chunk_t=256)
    for i in range(4):
        blk = np.zeros((32, 128, 4, 2), np.float32)
        blk[:, :, 0, 0] = x[i * 128:(i + 1) * 128].T
        blk[:, :, 1:, :] = 0.1
        mon2.observe(i, blk)
    mon2.flush()
    assert any(abs(c.t_samp - 100) < 16 for c in mon2.candidates)
    # beam out of range
    mon3 = SearchMonitor(freqs, TSAMP, dms, beam=7, chunk_t=256)
    with pytest.raises(ValueError, match="out of range"):
        mon3.observe(0, np.zeros((32, 128, 2), np.float32))


def test_search_monitor_multibeam_coincidence():
    """beam='all' live-searches every beam batched: broadband RFI that
    fires in all beams is rejected per window, the localized pulse
    survives with its beam label; a beam-set target and coincidence=False
    behave as documented."""
    from dsabeamformer.ops.dedisperse import SearchMonitor

    dm_true, t0 = 90.0, 700
    n_beams, t_out, T = 8, 128, 2048
    xs, freqs = [], None
    for b in range(n_beams):
        x, freqs = _pulse_spectrogram(T, 64, dm_true, t0, 4,
                                      amp=1.0 if b in (3, 4) else 0.0,
                                      seed=60 + b)
        x[300:302, :] += 3.0  # broadband RFI in EVERY beam
        xs.append(x)
    blocks = [np.stack([xs[b][i * t_out:(i + 1) * t_out].T
                        for b in range(n_beams)], axis=-1)  # [F, t, B]
              for i in range(T // t_out)]
    dms = dm_trial_grid(F_LO, F_HI, TSAMP, dm_max=300.0, tol=1.25)

    rfi_log = []
    mon = SearchMonitor(freqs, TSAMP, dms, beam="all", threshold=7.0,
                        chunk_t=512, on_rfi=rfi_log.append)
    assert mon.wants_beams
    for i, blk in enumerate(blocks):
        mon.observe(i, blk)
    mon.flush()
    assert mon.rfi_rejected >= 1 and rfi_log
    assert max(ev["n_beams"] for ev in rfi_log) >= 6
    hits = {c.beam for c in mon.candidates if abs(c.t_samp - t0) < 32}
    assert hits and hits <= {3, 4}
    assert not any(abs(c.t_samp - 300) < 16 for c in mon.candidates)

    # beam-set target: only those beams searched; thresh=max(3, 1) so
    # the 4-beam RFI still rejects while the 2-beam pulse survives
    mon2 = SearchMonitor(freqs, TSAMP, dms, beam=[2, 3, 4, 5],
                         threshold=7.0, chunk_t=512)
    for i, blk in enumerate(blocks):
        mon2.observe(i, blk)
    mon2.flush()
    assert mon2.rfi_rejected >= 1
    labels = {c.beam for c in mon2.candidates}
    assert labels <= {2, 3, 4, 5}
    assert any(abs(c.t_samp - t0) < 32 for c in mon2.candidates)

    # coincidence off: the RFI candidates come through, labelled
    mon3 = SearchMonitor(freqs, TSAMP, dms, beam="all", threshold=7.0,
                         chunk_t=512, coincidence=False)
    for i, blk in enumerate(blocks):
        mon3.observe(i, blk)
    mon3.flush()
    assert mon3.rfi_rejected == 0
    assert any(abs(c.t_samp - 300) < 16 for c in mon3.candidates)

    # constructor validation
    with pytest.raises(ValueError, match="duplicate"):
        SearchMonitor(freqs, TSAMP, dms, beam=[1, 1])
    with pytest.raises(ValueError, match="empty"):
        SearchMonitor(freqs, TSAMP, dms, beam=[])
    with pytest.raises(ValueError, match="incoherent"):
        SearchMonitor(freqs, TSAMP, dms, beam="all", incoherent=True)
    mon4 = SearchMonitor(freqs, TSAMP, dms, beam=[1, 99])
    with pytest.raises(ValueError, match="out of range"):
        mon4.observe(0, np.zeros((64, 128, 8), np.float32))


def test_cli_run_live_search(tiny_cfg, tmp_path, capsys):
    """dsabf run --search-dm-max: the injected-FRB drill fires the
    live trigger and writes a candidate file at exit."""
    from dsabeamformer.cli import main as cli_main
    from dsabeamformer.config import DM_CONST_S

    cfg = tiny_cfg.replace(navg_time=2)
    f = cfg.freqs_hz() / 1e6
    tsamp_out = cfg.sample_period_s * cfg.navg_time
    dm = (16 * tsamp_out
          / (DM_CONST_S * (f.min() ** -2 - f.max() ** -2)))
    cap = tmp_path / "cap.dada"
    assert cli_main(["simulate", "--config", "tiny", "--set", "navg_time=2",
                     "--pulse-dm", str(dm), "--pulse-t0", "8",
                     "--pulse-width", "6", "--blocks", "6", "--distinct",
                     "2", "--out-file", str(cap)]) == 0
    cand = tmp_path / "live.cand"
    capsys.readouterr()
    rc = cli_main(["run", "--config", "tiny", "--set", "navg_time=2",
                   "--input-file", str(cap),
                   "--search-dm-max", str(3 * dm),
                   "--search-beam", str(cfg.n_beams // 2),
                   "--search-threshold", "6",
                   "--search-cand", str(cand)])
    assert rc == 0
    err = capsys.readouterr().err
    assert "[dsabf] search {" in err
    assert "candidate(s)" in err
    rows = [l for l in cand.read_text().splitlines()
            if l.strip() and not l.startswith("#")]
    assert rows
    # strongest candidate is the injected pulse, in output-frame time
    best = rows[0].split()
    assert abs(int(best[1]) - 8 // cfg.navg_time) <= 8
    # incoherent target works without --incoherent-file (discard sink)
    capsys.readouterr()
    rc = cli_main(["run", "--config", "tiny", "--set", "navg_time=2",
                   "--input-file", str(cap),
                   "--search-dm-max", str(3 * dm),
                   "--search-beam", "incoherent",
                   "--search-threshold", "6"])
    assert rc == 0
    err = capsys.readouterr().err
    assert "incoherent sum" in err
    assert "[dsabf] search {" in err
    # multi-beam live target: every beam searched batched, events carry
    # the beam label (coincidence off — a coherent injected source
    # lights many beams via sidelobes, exactly what the veto rejects)
    capsys.readouterr()
    rc = cli_main(["run", "--config", "tiny", "--set", "navg_time=2",
                   "--input-file", str(cap),
                   "--search-dm-max", str(3 * dm),
                   "--search-beam", "all", "--search-no-coincidence",
                   "--search-threshold", "8"])
    assert rc == 0
    err = capsys.readouterr().err
    assert "all 32 beams" in err
    assert '"beam":' in err


def test_write_candidates_roundtrip(tmp_path):
    c = Candidate(snr=12.5, t_samp=700, time_s=0.7339, width=4, dm_idx=31,
                  dm=90.2, members=17, dm_lo=85.0, dm_hi=95.5)
    p = tmp_path / "out.cand"
    write_candidates(p, [c], {"threshold": 7.0, "file": "x.fil"})
    lines = p.read_text().splitlines()
    assert any(line.startswith("# threshold = 7.0") for line in lines)
    header = [line for line in lines if line.startswith("#    snr")]
    assert header
    row = lines[-1].split()
    assert float(row[0]) == 12.5
    assert int(row[1]) == 700
    assert float(row[5]) == pytest.approx(90.2)
    # and back: read_candidates restores meta types and every field
    from dsabeamformer.ops.dedisperse import read_candidates

    meta, back = read_candidates(p)
    assert meta["threshold"] == 7.0 and meta["file"] == "x.fil"
    assert len(back) == 1 and back[0] == dataclasses.replace(c, beam=-1)
    # a pre-multibeam 9-column row still parses (beam defaults to -1)
    p9 = tmp_path / "old.cand"
    p9.write_text(" ".join(c.row().split()[:9]) + "\n")
    _, old = read_candidates(p9)
    assert old[0].beam == -1 and old[0].t_samp == 700
    # junk column counts fail with the path named
    pbad = tmp_path / "bad.cand"
    pbad.write_text("1 2 3\n")
    with pytest.raises(ValueError, match="columns"):
        read_candidates(pbad)


def test_cli_waterfall_cand_vetting(tmp_path, capsys):
    """`dsabf waterfall --cand f --idx 0` inherits the row's DM and
    windows the frame on the detection."""
    from dsabeamformer.cli import main as cli_main

    dm_true, t0 = 90.0, 1500
    x, _ = _pulse_spectrogram(4096, 64, dm_true, t0, 4, amp=1.2, seed=3)
    fil = tmp_path / "b.fil"
    _write_fil(fil, x, TSAMP, ibeam=5)
    cand = tmp_path / "b.cand"
    assert cli_main(["search", str(fil), "--dm-max", "300",
                     "--threshold", "7", "--cand", str(cand)]) == 0
    capsys.readouterr()
    rc = cli_main(["waterfall", str(fil), "--cand", str(cand)])
    assert rc == 0
    cap = capsys.readouterr()
    assert "# candidate 0:" in cap.err and "t_samp 1500" in cap.err
    dm_vetted = float(cap.err.split("DM ")[1].split()[0])
    assert abs(dm_vetted - dm_true) < 5  # nearest DM trial to truth
    # the frame is the window, not the whole file
    legend = [l for l in cap.out.splitlines() if l.startswith("#")][0]
    n_samp = int(legend.split(" samples")[0].split()[-1])
    assert n_samp < 4096
    assert "profile(t)" in cap.out  # DM was inherited -> profile shown
    # out-of-range --idx fails cleanly
    assert cli_main(["waterfall", str(fil), "--cand", str(cand),
                     "--idx", "999"]) == 1


def test_cli_search_rejects_bad_coincidence_frac(tmp_path, capsys):
    """An out-of-range --coincidence-frac fails BEFORE the search runs
    (a bad value after minutes of dedispersion would be a traceback)."""
    from dsabeamformer.cli import main as cli_main

    p = tmp_path / "b.fil"
    _write_fil(p, np.zeros((64, 8), np.float32), TSAMP)
    rc = cli_main(["search", str(p), str(p), "--dm-max", "10",
                   "--coincidence-frac", "1.5"])
    assert rc == 1
    assert "coincidence-frac" in capsys.readouterr().err


def test_cli_search_live_ring(tiny_cfg, tmp_path, capsys):
    """The separate-process search consumer: `dsabf run --output-key`
    writes products into a ring, `dsabf search --key` attaches and
    finds the drill pulse — the reference's heimdall-reads-the-DADA-
    buffer topology."""
    import os as _os

    from dsabeamformer.cli import main as cli_main
    from dsabeamformer.ingest.ring import RingBuffer

    cfg = tiny_cfg.replace(navg_time=2)
    f = cfg.freqs_hz() / 1e6
    tsamp_out = cfg.sample_period_s * cfg.navg_time
    dm = (16 * tsamp_out
          / (DM_CONST_S * (f.min() ** -2 - f.max() ** -2)))
    cap = tmp_path / "cap.dada"
    assert cli_main(["simulate", "--config", "tiny", "--set", "navg_time=2",
                     "--pulse-dm", str(dm), "--pulse-t0", "8",
                     "--pulse-width", "6", "--blocks", "6", "--distinct",
                     "2", "--out-file", str(cap)]) == 0
    key = f"tsearch{_os.getpid()}"
    try:
        assert cli_main(["run", "--config", "tiny", "--set", "navg_time=2",
                         "--input-file", str(cap), "--output-key", key,
                         "--nbufs", "10"]) == 0
        capsys.readouterr()
        cand = tmp_path / "ring.cand"
        rc = cli_main(["search", "--key", key, "--beam", "all",
                       "--no-coincidence", "--dm-max", str(2 * dm),
                       "--threshold", "8", "--widths", "1", "2", "4",
                       "--cand", str(cand), "--timeout", "2"])
        assert rc == 0
        out = capsys.readouterr()
        assert "attached to 1 ring(s)" in out.err
        rows = [l.split() for l in out.out.splitlines()
                if l.strip() and not l.startswith("#")]
        assert rows
        assert int(rows[0][9]) in (cfg.n_beams // 2 - 1, cfg.n_beams // 2)
        assert "# ring = " + key in cand.read_text()
    finally:
        try:
            RingBuffer(key, connect_timeout_s=1).destroy()
        except Exception:
            pass
    # a non-product ring is rejected with guidance
    key2 = f"tsearchw{_os.getpid()}"
    with RingBuffer(key2, create=True, nbufs=2, bufsz=1024) as r:
        r.write_header("HDR_VERSION 1.0\nNCHAN 8\n")
        capsys.readouterr()
        assert cli_main(["search", "--key", key2, "--dm-max", "10",
                         "--timeout", "1"]) == 1
        assert "not a beam product" in capsys.readouterr().err
        r.destroy()
    # files + --key is ambiguous; neither is an error too
    capsys.readouterr()
    assert cli_main(["search", str(cap), "--key", "x",
                     "--dm-max", "10"]) == 1
    assert cli_main(["search", "--dm-max", "10"]) == 1


def test_cli_search_live_ring_join(tiny_cfg, tmp_path, capsys):
    """Joined multi-subband live search: two `run --output-key`
    producers (one per subband capture) feed one `dsabf search --key
    k0,k1` consumer, which band-orders the rings (keys given
    reversed), validates contiguity, and searches the joined full
    band."""
    import os as _os

    from dsabeamformer.cli import main as cli_main
    from dsabeamformer.ingest.ring import RingBuffer

    cfg = tiny_cfg.replace(navg_time=2)
    f = cfg.freqs_hz() / 1e6
    tsamp_out = cfg.sample_period_s * cfg.navg_time
    # ~2 output samples of sweep across the FULL band: effectively
    # undispersed, so the per-subband generators (each referenced to
    # its own band top) stay aligned when joined
    dm = (2 * tsamp_out
          / (DM_CONST_S * (f.min() ** -2 - f.max() ** -2)))
    keys = []
    try:
        for i in range(2):
            cap = tmp_path / f"cap{i}.dada"
            assert cli_main(["simulate", "--config", "tiny",
                             "--set", "navg_time=2", "--subband", f"{i}/2",
                             "--pulse-dm", str(dm), "--pulse-t0", "8",
                             "--pulse-width", "6", "--blocks", "6",
                             "--distinct", "2", "--out-file", str(cap)]) == 0
            key = f"tjoin{_os.getpid()}_{i}"
            keys.append(key)
            assert cli_main(["run", "--config", "tiny",
                             "--set", "navg_time=2",
                             "--input-file", str(cap), "--output-key", key,
                             "--nbufs", "10"]) == 0
        capsys.readouterr()
        rc = cli_main(["search", "--key", f"{keys[1]},{keys[0]}",
                       "--beam", "all", "--no-coincidence",
                       "--dm-max", str(4 * dm), "--threshold", "8",
                       "--widths", "1", "2", "4", "--timeout", "2"])
        assert rc == 0
        out = capsys.readouterr()
        assert "attached to 2 ring(s)" in out.err
        # band-ordered despite reversed keys, channels joined
        assert f"joined {cfg.n_chan // cfg.navg_freq} chan" in out.err
        rows = [l.split() for l in out.out.splitlines()
                if l.strip() and not l.startswith("#")]
        assert rows
        assert int(rows[0][9]) in (cfg.n_beams // 2 - 1, cfg.n_beams // 2)
        assert abs(int(rows[0][1]) - 8 // cfg.navg_time) <= 8
        # non-contiguous join (two copies of the SAME subband) rejected
        key2 = f"tjoin{_os.getpid()}_dup"
        cap0 = tmp_path / "cap0.dada"
        assert cli_main(["run", "--config", "tiny", "--set", "navg_time=2",
                         "--input-file", str(cap0), "--output-key", key2,
                         "--nbufs", "10"]) == 0
        keys.append(key2)
        capsys.readouterr()
        rc = cli_main(["search", "--key", f"{keys[0]},{key2}",
                       "--dm-max", str(4 * dm), "--timeout", "1"])
        assert rc == 1
        assert "not band-contiguous" in capsys.readouterr().err
    finally:
        for key in keys:
            try:
                RingBuffer(key, connect_timeout_s=1).destroy()
            except Exception:
                pass


def test_cli_search_join_one_ring_eods_early(tiny_cfg, tmp_path, capsys):
    """Joined-ring failure mode (VERDICT r3 #6): one subband producer
    dies early (its ring EODs with fewer blocks) — the consumer must
    search the common prefix, flush, and exit cleanly."""
    import os as _os

    from dsabeamformer.cli import main as cli_main
    from dsabeamformer.ingest.ring import RingBuffer

    cfg = tiny_cfg.replace(navg_time=2)
    keys = []
    try:
        for i, blocks in enumerate((6, 3)):  # subband 1 dies at block 3
            cap = tmp_path / f"cap{i}.dada"
            assert cli_main(["simulate", "--config", "tiny",
                             "--set", "navg_time=2", "--subband", f"{i}/2",
                             "--blocks", str(blocks), "--distinct", "2",
                             "--out-file", str(cap)]) == 0
            key = f"teod{_os.getpid()}_{i}"
            keys.append(key)
            assert cli_main(["run", "--config", "tiny",
                             "--set", "navg_time=2",
                             "--input-file", str(cap), "--output-key", key,
                             "--nbufs", "10"]) == 0
        capsys.readouterr()
        rc = cli_main(["search", "--key", ",".join(keys), "--beam", "0",
                       "--dm-max", "5", "--threshold", "8",
                       "--widths", "1", "2", "--timeout", "2"])
        assert rc == 0
        err = capsys.readouterr().err
        assert "3 block(s)" in err  # only the common prefix searched
    finally:
        for key in keys:
            try:
                RingBuffer(key, connect_timeout_s=1).destroy()
            except Exception:
                pass


def test_cli_search_join_mismatched_headers(tiny_cfg, tmp_path, capsys):
    """Joined-ring failure modes (VERDICT r3 #6): subband rings whose
    headers disagree beyond the channel axis (different beam counts)
    and rings with mixed payloads are rejected with a clear error."""
    import os as _os

    from dsabeamformer.cli import main as cli_main
    from dsabeamformer.ingest.ring import RingBuffer
    from dsabeamformer.pipeline import RingSink

    cfg = tiny_cfg.replace(navg_time=2)
    f_out, t_out, b_out = cfg.out_block_shape
    width = cfg.n_chan // 2
    sub0, sub1 = cfg.subband(0, width), cfg.subband(width, width)
    pid = _os.getpid()
    rings = {}
    try:
        # (a) beam-count mismatch: sub1's ring claims half the beams.
        sub1_half = sub1.replace(n_beams=cfg.n_beams // 2)
        for name, (sub, products) in {
            f"tmh{pid}_a0": (sub0, "power"),
            f"tmh{pid}_a1": (sub1_half, "power"),
            # (b) mixed payloads: a power ring + an incoherent ring.
            f"tmh{pid}_b0": (sub0, "power"),
            f"tmh{pid}_b1": (sub1, "incoherent"),
        }.items():
            fo, to, bo = sub.out_block_shape
            n_el = fo * to * (1 if products == "incoherent" else bo)
            ring = RingBuffer(name, create=True, nbufs=4, bufsz=n_el * 4)
            rings[name] = ring
            sink = RingSink(ring, sub, products=(
                "power" if products == "power" else "power"))
            if products == "incoherent":
                # Rewrite the header as the incoherent product.
                from dsabeamformer.ingest import dada

                ring.write_header(dada.encode_header(
                    sub, PAYLOAD="INCOHERENT_POWER", OUT_DTYPE="float32",
                    OUT_NCHAN=fo, OUT_NTIME=to))
                ring.write_block(np.zeros(n_el, np.float32))
            else:
                sink.write(0, np.zeros((fo, to, bo), np.float32))
            ring.set_eod()
        capsys.readouterr()
        rc = cli_main(["search", "--key", f"tmh{pid}_a0,tmh{pid}_a1",
                       "--dm-max", "5", "--timeout", "1"])
        assert rc == 1
        assert "disagree beyond the channel axis" in capsys.readouterr().err
        rc = cli_main(["search", "--key", f"tmh{pid}_b0,tmh{pid}_b1",
                       "--dm-max", "5", "--timeout", "1"])
        assert rc == 1
        assert "mixed payloads" in capsys.readouterr().err
    finally:
        for ring in rings.values():
            try:
                ring.destroy()
            except Exception:
                pass


def test_cli_search_join_skew_candidate_straddles(tiny_cfg, tmp_path,
                                                  capsys):
    """Joined-ring failure modes (VERDICT r3 #6): one ring lost its
    early blocks (drop storm / stale consumer), so the join force-
    aligns to the common seq — the consumer must count the skew, skip
    the other ring's stale blocks, and still find a pulse that lives
    entirely AFTER the forced join (the straddling prefix is gone with
    the dropped data; what must not happen is a crash or a missed
    post-join candidate)."""
    import os as _os

    from dsabeamformer.cli import main as cli_main
    from dsabeamformer.ingest.ring import RingBuffer
    from dsabeamformer.pipeline import RingSink

    cfg = tiny_cfg.replace(navg_time=2)
    width = cfg.n_chan // 2
    subs = [cfg.subband(0, width), cfg.subband(width, width)]
    t_out = cfg.t_block // cfg.navg_time  # 32 output samples per block
    # Boxcar pulse at global output samples 130..135 — inside seq 4,
    # i.e. entirely AFTER the forced join at seq 3 — injected into
    # beam 0 of both subbands' product streams.
    pulse_t0, pulse_w, beam = 130, 6, 0
    rng = np.random.default_rng(7)
    keys = [f"tskew{_os.getpid()}_{i}" for i in range(2)]
    rings = []
    try:
        for i, sub in enumerate(subs):
            fo, to, bo = sub.out_block_shape
            ring = RingBuffer(keys[i], create=True, nbufs=8,
                              bufsz=fo * to * bo * 4)
            rings.append(ring)
            sink = RingSink(ring, sub, products="power")
            for seq in range(6):
                blk = rng.standard_normal((fo, to, bo)).astype(np.float32)
                lo, hi = seq * t_out, (seq + 1) * t_out
                a, b = max(pulse_t0, lo), min(pulse_t0 + pulse_w, hi)
                if a < b:
                    blk[:, a - lo : b - lo, beam] += 4.0
                sink.write(seq, blk)
            ring.set_eod()
        # Ring 1 "lost" its first 3 blocks: a stale consumer reads and
        # discards them (the observable state after a drop storm — its
        # next available seq is 3 while ring 0 still holds seq 0).
        with RingBuffer(keys[1], connect_timeout_s=1) as r1:
            for _ in range(3):
                assert r1.read_block(timeout_s=1) is not None
        capsys.readouterr()
        rc = cli_main(["search", "--key", ",".join(keys), "--beam", "0",
                       "--dm-max", "5", "--threshold", "8",
                       "--widths", "1", "2", "4", "--timeout", "2"])
        assert rc == 0
        out = capsys.readouterr()
        assert "join skew" in out.err          # the skew was counted
        assert "skipped" in out.err            # ring 0's stale blocks
        assert "3 block(s)" in out.err         # seqs 3,4,5 searched
        rows = [l.split() for l in out.out.splitlines()
                if l.strip() and not l.startswith("#")]
        assert rows, "post-join pulse not found"
        # Candidate at the pulse's output time (column 1 = t_samp),
        # within the matched filter's width tolerance.  The monitor's
        # time origin is the first OBSERVED seq (3): what was dropped
        # is gone, so candidates are stamped relative to the join.
        t_found = int(rows[0][1])
        assert abs((t_found % (3 * t_out)) - (pulse_t0 - 3 * t_out)) <= 8
        # The straddle bookkeeping: whether the monitor reports the
        # leading seq jump as a stream gap or adopts seq 3 as its
        # epoch, the invariant is the clean exit (rc 0) plus the
        # recovered post-join candidate asserted above.
    finally:
        for ring in rings:
            try:
                ring.destroy()
            except Exception:
                pass


def test_search_review_fixes(tmp_path, capsys):
    """Review regressions: (a) an explicit --beam on an incoherent
    product errors instead of silently searching the sum; (b) live
    single-beam candidates carry their beam label; (c) a headered but
    empty ring exits cleanly at --max-idle."""
    import os as _os

    import dataclasses as _dc

    from dsabeamformer.cli import main as cli_main
    from dsabeamformer.ingest.ring import RingBuffer
    from dsabeamformer.ops.dedisperse import SearchMonitor

    # (a) incoherent product + --beam 7
    from dsabeamformer.utils.quicklook import load_dynamic_spectra
    from dsabeamformer.ingest.dada import encode_header
    from dsabeamformer.config import TINY

    cfg = TINY
    inco = tmp_path / "inco.dada"
    f_out, t_out, _ = cfg.out_block_shape
    hdr = encode_header(cfg, PAYLOAD="INCOHERENT_POWER",
                        OUT_DTYPE="float32", OUT_NCHAN=f_out,
                        OUT_NTIME=t_out)
    with open(inco, "wb") as fh:
        fh.write(hdr.encode().ljust(4096, b"\0"))
        fh.write(np.zeros((f_out, t_out), np.float32).tobytes())
    with pytest.raises(ValueError, match="no beam axis"):
        load_dynamic_spectra(inco, beams=[7])
    capsys.readouterr()
    assert cli_main(["search", str(inco), "--beam", "7",
                     "--dm-max", "0.001"]) == 1
    assert "no beam axis" in capsys.readouterr().err

    # (b) single-beam monitor labels its candidates
    dm_true, t0 = 90.0, 700
    x, freqs = _pulse_spectrogram(2048, 64, dm_true, t0, 4, amp=1.0,
                                  seed=21)
    dms = dm_trial_grid(F_LO, F_HI, TSAMP, dm_max=300.0, tol=1.25)
    mon = SearchMonitor(freqs, TSAMP, dms, beam=1, threshold=7.5,
                        chunk_t=512)
    blk = np.zeros((64, 2048, 3), np.float32)
    blk[:, :, 1] = x.T
    mon.observe(0, blk)
    mon.flush()
    assert mon.candidates and all(c.beam == 1 for c in mon.candidates)

    # (c) headered-but-empty ring + --max-idle exits cleanly
    key = f"tidle{_os.getpid()}"
    with RingBuffer(key, create=True, nbufs=2,
                    bufsz=f_out * t_out * 4) as r:
        r.write_header(hdr)
        capsys.readouterr()
        rc = cli_main(["search", "--key", key, "--dm-max", "0.001",
                       "--timeout", "0.2", "--max-idle", "0.5"])
        err = capsys.readouterr().err
        assert rc == 0, err
        assert "waiting for data" in err and "--max-idle" in err
        r.destroy()


def test_cli_search_stream_matches_whole(tiny_cfg, tmp_path, capsys):
    """--stream (block-fed monitor) finds the same candidates as the
    whole-load search on the same DADA product."""
    from dsabeamformer.cli import main as cli_main

    cfg = tiny_cfg.replace(navg_time=2)
    f = cfg.freqs_hz() / 1e6
    tsamp_out = cfg.sample_period_s * cfg.navg_time
    dm = (16 * tsamp_out
          / (DM_CONST_S * (f.min() ** -2 - f.max() ** -2)))
    cap = tmp_path / "cap.dada"
    assert cli_main(["simulate", "--config", "tiny", "--set", "navg_time=2",
                     "--pulse-dm", str(dm), "--pulse-t0", "8",
                     "--pulse-width", "6", "--blocks", "6", "--distinct",
                     "2", "--out-file", str(cap)]) == 0
    out = tmp_path / "out.dada"
    assert cli_main(["run", "--config", "tiny", "--set", "navg_time=2",
                     "--input-file", str(cap),
                     "--output-file", str(out)]) == 0
    base = ["search", str(out), "--beam", "all", "--no-coincidence",
            "--dm-max", str(2 * dm), "--threshold", "8",
            "--widths", "1", "2", "4"]
    capsys.readouterr()
    assert cli_main(base) == 0
    whole = [l for l in capsys.readouterr().out.splitlines()
             if l.strip() and not l.startswith("#")]
    assert cli_main(base + ["--stream"]) == 0
    streamed = [l for l in capsys.readouterr().out.splitlines()
                if l.strip() and not l.startswith("#")]
    assert whole and streamed == whole
    # --stream with several paths is rejected; bad beam too
    capsys.readouterr()
    assert cli_main(["search", str(out), str(out), "--stream",
                     "--dm-max", "1"]) == 1
    assert cli_main(["search", str(out), "--stream", "--beam", "99",
                     "--dm-max", str(2 * dm)]) == 1
    assert "out of range" in capsys.readouterr().err


def test_cli_run_reports_output_ring_drops(tiny_cfg, tmp_path, capsys):
    """Writer-never-blocks on the output product ring must be VISIBLE:
    with no consumer and a small ring, run warns about dropped product
    blocks."""
    import os as _os

    from dsabeamformer.cli import main as cli_main
    from dsabeamformer.ingest.ring import RingBuffer

    cap = tmp_path / "cap.dada"
    assert cli_main(["simulate", "--config", "tiny", "--blocks", "6",
                     "--out-file", str(cap)]) == 0
    key = f"tdrop{_os.getpid()}"
    capsys.readouterr()
    try:
        assert cli_main(["run", "--config", "tiny",
                         "--input-file", str(cap), "--output-key", key,
                         "--nbufs", "2"]) == 0
        err = capsys.readouterr().err
        assert "output ring dropped" in err
    finally:
        try:
            RingBuffer(key, connect_timeout_s=1).destroy()
        except Exception:
            pass


def test_epoch_stamping_flows_to_cand(tiny_cfg, tmp_path, capsys):
    """run --utc-start/--tstart-mjd stamp the DADA product header and
    the epoch rides into the .cand file, anchoring candidate times."""
    from dsabeamformer.cli import main as cli_main
    from dsabeamformer.ingest.dada import read_product_file
    from dsabeamformer.ops.dedisperse import read_candidates

    cfg = tiny_cfg.replace(navg_time=2)
    f = cfg.freqs_hz() / 1e6
    tsamp_out = cfg.sample_period_s * cfg.navg_time
    dm = (16 * tsamp_out
          / (DM_CONST_S * (f.min() ** -2 - f.max() ** -2)))
    cap = tmp_path / "cap.dada"
    assert cli_main(["simulate", "--config", "tiny", "--set", "navg_time=2",
                     "--pulse-dm", str(dm), "--pulse-t0", "8",
                     "--pulse-width", "6", "--blocks", "6", "--distinct",
                     "2", "--out-file", str(cap)]) == 0
    out = tmp_path / "out.dada"
    assert cli_main(["run", "--config", "tiny", "--set", "navg_time=2",
                     "--input-file", str(cap), "--output-file", str(out),
                     "--utc-start", "2026-08-18-04:00:00",
                     "--tstart-mjd", "61270.1666"]) == 0
    hdr, _ = read_product_file(out)
    assert hdr["UTC_START"] == "2026-08-18-04:00:00"
    assert float(hdr["MJD_START"]) == pytest.approx(61270.1666)
    cand = tmp_path / "e.cand"
    capsys.readouterr()
    assert cli_main(["search", str(out), "--beam", "all",
                     "--no-coincidence", "--dm-max", str(2 * dm),
                     "--threshold", "8", "--widths", "1", "2", "4",
                     "--cand", str(cand)]) == 0
    meta, _ = read_candidates(cand)
    assert meta["utc_start"] == "2026-08-18-04:00:00"
    assert float(meta["tstart_mjd"]) == pytest.approx(61270.1666)


def test_cli_search_live_ring_stokes(tiny_cfg, tmp_path, capsys):
    """The ring consumer searches Stokes products (plane I of
    [F, T, 4, B] blocks) end-to-end."""
    import os as _os

    from dsabeamformer.cli import main as cli_main
    from dsabeamformer.ingest.ring import RingBuffer

    cfg = tiny_cfg.replace(navg_time=2)
    f = cfg.freqs_hz() / 1e6
    tsamp_out = cfg.sample_period_s * cfg.navg_time
    dm = (16 * tsamp_out
          / (DM_CONST_S * (f.min() ** -2 - f.max() ** -2)))
    cap = tmp_path / "cap.dada"
    assert cli_main(["simulate", "--config", "tiny", "--set", "navg_time=2",
                     "--pulse-dm", str(dm), "--pulse-t0", "8",
                     "--pulse-width", "6", "--blocks", "6", "--distinct",
                     "2", "--out-file", str(cap)]) == 0
    key = f"tstok{_os.getpid()}"
    try:
        assert cli_main(["run", "--config", "tiny", "--set", "navg_time=2",
                         "--input-file", str(cap), "--output-key", key,
                         "--products", "stokes", "--nbufs", "10"]) == 0
        capsys.readouterr()
        rc = cli_main(["search", "--key", key, "--beam", "all",
                       "--no-coincidence", "--dm-max", str(2 * dm),
                       "--threshold", "8", "--widths", "1", "2", "4",
                       "--timeout", "2"])
        assert rc == 0
        out = capsys.readouterr()
        assert "BEAM_STOKES_IQUV" in out.err
        rows = [l.split() for l in out.out.splitlines()
                if l.strip() and not l.startswith("#")]
        assert rows
        assert int(rows[0][9]) in (cfg.n_beams // 2 - 1, cfg.n_beams // 2)
    finally:
        try:
            RingBuffer(key, connect_timeout_s=1).destroy()
        except Exception:
            pass
