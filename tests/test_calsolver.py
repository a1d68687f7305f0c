"""Phase-up calibration solver (models/calsolver.py): recover
per-antenna complex gains from a corrupted calibrator observation and
restore the beam."""

import numpy as np
import pytest

from dsabeamformer.ingest.generator import make_point_source_block
from dsabeamformer.models.calibration import CalTable
from dsabeamformer.models.calsolver import solve_gains, solve_gains_blocks
from dsabeamformer.models.weights import make_weights
from dsabeamformer.ops.gemm import beamform_power
from dsabeamformer.ops.quantize import quantize_weights


def _corrupted_calibrator(cfg, angle, seed=3, noise_rms=0.15):
    # Drive level chosen below the 4-bit wire's clip point even for the
    # highest-gain antennas (real operations level-set before a cal
    # scan); clipping compresses amplitude estimates.
    rng = np.random.default_rng(seed)
    act = cfg.n_ant_active
    g = np.zeros((cfg.n_ant, cfg.n_chan), np.complex128)
    amp = 1.0 + 0.15 * rng.standard_normal((act, cfg.n_chan))
    ph = 1.5 * rng.standard_normal((act, cfg.n_chan))
    g[:act] = amp * np.exp(1j * ph)
    wire = make_point_source_block(cfg, angle, amplitude=2.5,
                                   noise_rms=noise_rms, seed=seed,
                                   instrumental_gains=g)
    return wire, g


def test_solved_gains_invert_instrument(tiny_cfg):
    cfg = tiny_cfg
    angle = cfg.beam_angles_rad()[20]
    wire, g = _corrupted_calibrator(cfg, angle)
    cal = solve_gains(wire, cfg, angle)
    act = cfg.n_ant_active
    # solved * instrumental should be constant across antennas per
    # channel (a global per-channel factor is unobservable).  Phases
    # are what beam coherence needs and converge fast; amplitudes carry
    # the 4-bit quantization/clipping bias, hence the looser gate.
    prod = cal.gains[:act] * g[:act]  # [a, F]
    rel = prod / prod[0:1]
    np.testing.assert_allclose(np.abs(rel), 1.0, atol=0.15)
    assert np.abs(np.angle(rel)).max() < 0.08


def test_solved_cal_restores_beam(tiny_cfg):
    cfg = tiny_cfg
    target = 20
    angle = cfg.beam_angles_rad()[target]
    wire, g = _corrupted_calibrator(cfg, angle)
    # Uncalibrated: the corrupted phases defocus the beam.
    qw_raw = quantize_weights(make_weights(cfg), cfg.weight_mode,
                              cfg.a_compute)
    p_raw = np.asarray(beamform_power(wire, qw_raw, cfg)).sum(axis=(0, 1))
    # Calibrated with the solved table: peak restored at the target.
    cal = solve_gains(wire, cfg, angle)
    qw_cal = quantize_weights(make_weights(cfg, cal=cal), cfg.weight_mode,
                              cfg.a_compute)
    p_cal = np.asarray(beamform_power(wire, qw_cal, cfg)).sum(axis=(0, 1))
    assert int(np.argmax(p_cal)) == target
    # Clean-instrument reference peak: solved-cal recovers most of the
    # coherent gain the corruption destroyed.
    clean = make_point_source_block(cfg, angle, amplitude=2.5,
                                    noise_rms=0.15, seed=3)
    p_ref = np.asarray(beamform_power(clean, qw_raw, cfg)).sum(axis=(0, 1))
    assert p_cal[target] > 0.8 * p_ref[target]
    assert p_cal[target] > 1.5 * p_raw[target]


def test_multi_block_solve_tightens(tiny_cfg):
    cfg = tiny_cfg
    angle = cfg.beam_angles_rad()[10]
    act = cfg.n_ant_active
    rng = np.random.default_rng(7)
    g = np.zeros((cfg.n_ant, cfg.n_chan), np.complex128)
    g[:act] = np.exp(1j * rng.standard_normal((act, cfg.n_chan)))
    blocks = [
        make_point_source_block(cfg, angle, amplitude=3.0, noise_rms=0.8,
                                seed=s, instrumental_gains=g)
        for s in range(4)
    ]

    def phase_err(cal):
        prod = cal.gains[:act] * g[:act]
        rel = prod / prod[0:1]
        return np.abs(np.angle(rel)).max()

    e1 = phase_err(solve_gains(blocks[0], cfg, angle))
    e4 = phase_err(solve_gains_blocks(blocks, cfg, angle))
    assert e4 < e1


def test_cli_calibrate_roundtrip(tmp_path, capsys, tiny_cfg):
    """dsabf calibrate on a clean calibrator capture -> near-unity
    CalTable that dsabf run accepts."""
    import json

    from dsabeamformer import cli
    from dsabeamformer.ingest import dada

    cfg = tiny_cfg
    angle_deg = float(np.rad2deg(cfg.beam_angles_rad()[10]))
    cap = str(tmp_path / "cal.dada")
    blocks = (make_point_source_block(cfg, np.deg2rad(angle_deg),
                                      amplitude=2.5, noise_rms=0.2, seed=s)
              for s in range(2))
    dada.write_dada_file(cap, cfg, blocks)
    out = str(tmp_path / "solved.npz")
    rc = cli.main(["calibrate", "--config", "tiny", "--input-file", cap,
                   "--angle", str(angle_deg), "--out", out])
    assert rc == 0
    rec = json.loads(capsys.readouterr().out)
    assert rec["blocks"] == 2
    assert abs(rec["median_amp"] - 1.0) < 0.1
    assert rec["max_phase_rad"] < 0.1  # clean instrument -> ~zero phases

    cal = CalTable.load(out)
    assert cal.gains.shape == (cfg.n_ant, cfg.n_chan)

    # The solved table feeds straight back into the run path.
    pout = str(tmp_path / "p.raw")
    rc = cli.main(["run", "--config", "tiny", "--input-file", cap,
                   "--cal", out, "--output-file", pout, "--blocks", "1"])
    assert rc == 0


@pytest.mark.parametrize("i", range(3))
def test_solver_fuzz_geometry(i):
    """Random geometry + random instrumental phases: the solver must
    recover phases tightly whatever the array shape."""
    from dsabeamformer.config import ObsConfig

    rng = np.random.default_rng(400 + i)
    n_ant = int(rng.choice([8, 16, 32]))
    cfg = ObsConfig(
        name=f"calfuzz{i}",
        n_ant=n_ant,
        n_ant_active=int(rng.integers(3, n_ant + 1)),
        n_beams=16,
        n_chan=int(rng.choice([4, 8])),
        n_chan_total=8,
        t_block=256,
        navg_time=16,
    )
    act = cfg.n_ant_active
    g = np.zeros((cfg.n_ant, cfg.n_chan), np.complex128)
    g[:act] = np.exp(1j * rng.uniform(-np.pi, np.pi, (act, cfg.n_chan)))
    angle = float(rng.uniform(-0.02, 0.02))
    wire = make_point_source_block(cfg, angle, amplitude=2.5,
                                   noise_rms=0.2, seed=i,
                                   instrumental_gains=g)
    cal = solve_gains(wire, cfg, angle)
    prod = cal.gains[:act] * g[:act]
    rel = prod / prod[0:1]
    assert np.abs(np.angle(rel)).max() < 0.1, np.abs(np.angle(rel)).max()


def test_cli_calibrate_live_ring(tiny_cfg, tmp_path, capsys):
    """dsabf calibrate --key solves from a live ring, same solution
    path as the capture file."""
    import json
    import threading

    from dsabeamformer import cli
    from dsabeamformer.ingest import dada
    from dsabeamformer.ingest.generator import make_point_source_block
    from dsabeamformer.ingest.ring import RingBuffer
    from dsabeamformer.models.calibration import CalTable

    cfg = tiny_cfg
    angles = cfg.beam_angles_rad()
    blocks = [make_point_source_block(cfg, angles[cfg.n_beams // 2],
                                      noise_rms=0.3, seed=s)
              for s in range(2)]

    def produce():
        with RingBuffer("calscan", create=True, nbufs=4,
                        bufsz=cfg.wire_block_bytes) as ring:
            ring.write_header(dada.encode_header(cfg))
            for b in blocks:
                ring.write_block(b)
            ring.set_eod()
            import time as _t
            deadline = _t.monotonic() + 30
            while _t.monotonic() < deadline and ring.n_read < len(blocks):
                _t.sleep(0.05)

    out = tmp_path / "cal.npz"
    prod = threading.Thread(target=produce)
    prod.start()
    try:
        rc = cli.main(["calibrate", "--config", "tiny", "--key", "calscan",
                       "--blocks", "2",
                       "--angle", str(np.rad2deg(angles[cfg.n_beams // 2])),
                       "--out", str(out)])
    finally:
        prod.join()
    assert rc == 0
    rec = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rec["n_ant_active"] == cfg.n_ant_active
    cal = CalTable.load(out)
    assert cal.gains.shape[0] == cfg.n_ant
