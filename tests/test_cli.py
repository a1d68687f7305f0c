"""CLI surface tests (in-process main() calls on the CPU backend)."""

import json

import numpy as np
import pytest

from dsabeamformer import cli
from dsabeamformer.ingest.generator import make_noise_block


def test_selftest(capsys):
    assert cli.main(["selftest"]) == 0
    out = json.loads(capsys.readouterr().out.strip())
    assert out["ok"] and out["beam_peak"] == out["beam_expected"]
    assert out["rel_power_error"] <= out["bar"]


def test_weights_roundtrip(tmp_path, capsys, tiny_cfg):
    path = str(tmp_path / "w.npz")
    assert cli.main(["weights", "--config", "tiny", "--out", path]) == 0
    meta = json.loads(capsys.readouterr().out.strip())
    assert meta["terms"] == 2
    from dsabeamformer.models.weights import make_weights
    from dsabeamformer.ops.quantize import load_quant_weights, quantize_weights

    qw = load_quant_weights(path)
    ref = quantize_weights(make_weights(tiny_cfg), tiny_cfg.weight_mode)
    np.testing.assert_array_equal(np.asarray(qw.terms), np.asarray(ref.terms))


def test_run_from_file_with_saved_weights(tmp_path, capsys, tiny_cfg):
    wpath = str(tmp_path / "w.npz")
    assert cli.main(["weights", "--config", "tiny", "--out", wpath]) == 0
    capsys.readouterr()
    blocks = [make_noise_block(tiny_cfg, rms=2.0, seed=s) for s in range(2)]
    inpath = tmp_path / "in.raw"
    with open(inpath, "wb") as f:
        for b in blocks:
            f.write(b.tobytes())
    outpath = tmp_path / "out.raw"
    statspath = tmp_path / "stats.jsonl"
    rc = cli.main([
        "run", "--config", "tiny", "--input-file", str(inpath),
        "--weights", wpath, "--output-file", str(outpath),
        "--stats-file", str(statspath),
    ])
    assert rc == 0
    summary = json.loads(capsys.readouterr().out.strip())
    assert summary["blocks"] == 2 and summary["dropped"] == 0
    powers = np.fromfile(outpath, dtype=np.float32)
    assert powers.size == 2 * int(np.prod(tiny_cfg.out_block_shape))
    lines = [json.loads(line) for line in open(statspath)]
    assert len(lines) == 2 and lines[1]["block"] == 1


def test_interrupt_flushes_product_file(tmp_path, capsys, tiny_cfg,
                                        monkeypatch):
    """Operator Ctrl-C mid-run must not truncate the product file's tail
    blocks: every exit path closes (and thereby flushes) the FileSink
    and the stats handle, and the .dada product parses completely."""
    from dsabeamformer import pipeline
    from dsabeamformer.ingest.dada import read_product_file

    blocks = [make_noise_block(tiny_cfg, rms=2.0, seed=s) for s in range(3)]
    inpath = tmp_path / "in.raw"
    with open(inpath, "wb") as f:
        for b in blocks:
            f.write(b.tobytes())
    outpath = tmp_path / "out.dada"
    statspath = tmp_path / "stats.jsonl"

    orig_run = pipeline.StreamingBeamformer.run

    def run_then_interrupt(self, max_blocks=None):
        orig_run(self, max_blocks=2)
        raise KeyboardInterrupt

    monkeypatch.setattr(pipeline.StreamingBeamformer, "run",
                        run_then_interrupt)
    rc = cli.main([
        "run", "--config", "tiny", "--input-file", str(inpath),
        "--output-file", str(outpath), "--stats-file", str(statspath),
    ])
    assert rc == 130
    summary = json.loads(capsys.readouterr().out.strip())
    assert summary["blocks"] == 2
    h, powers = read_product_file(outpath)
    assert h["PAYLOAD"] == "BEAM_POWERS"
    assert powers.shape[0] == 2  # both processed blocks fully on disk
    assert np.isfinite(np.asarray(powers)).all()
    lines = [json.loads(line) for line in open(statspath)]
    assert len(lines) == 2  # stats handle flushed on the interrupt path


def test_run_mesh_streams_sharded(tmp_path, capsys, tiny_cfg):
    """`dsabf run --mesh 8`: the channel-mesh streaming driver end to
    end on the 8-virtual-device backend, golden-checked."""
    cfg = tiny_cfg.replace(n_chan=16, n_chan_total=16)
    blocks = [make_noise_block(cfg, rms=2.0, seed=s) for s in range(3)]
    inpath = tmp_path / "in.raw"
    with open(inpath, "wb") as f:
        for b in blocks:
            f.write(np.asarray(b).tobytes())
    outpath = tmp_path / "out.raw"
    rc = cli.main([
        "run", "--config", "tiny", "--set", "n_chan_total=16",
        "--set", "n_chan=16", "--mesh", "8",
        "--input-file", str(inpath), "--output-file", str(outpath),
    ])
    assert rc == 0
    summary = json.loads(capsys.readouterr().out.strip())
    assert summary["blocks"] == 3 and summary["dropped"] == 0
    from dsabeamformer.models.weights import weights_numpy_golden
    from dsabeamformer.ops.reference import beamform_block_ref
    from dsabeamformer.utils.testing import assert_power_close

    powers = np.fromfile(outpath, dtype=np.float32).reshape(
        (3,) + cfg.out_block_shape)
    for i, b in enumerate(blocks):
        ref = beamform_block_ref(
            weights_numpy_golden(cfg), np.asarray(b), cfg.input_layout,
            cfg.navg_time, cfg.navg_freq,
        )
        assert_power_close(powers[i], ref, what=f"--mesh block {i}")


def test_run_mesh_rejects_device_pin(tmp_path, capsys):
    rc = cli.main([
        "run", "--config", "tiny", "--mesh", "8", "--device", "0",
        "--input-file", str(tmp_path / "none.raw"),
    ])
    assert rc == 2
    assert "--device" in capsys.readouterr().err


def test_run_mesh_with_monitors(tmp_path, capsys, tiny_cfg):
    """--mesh composes with the fused monitors (--rfi-auto's SK
    accumulators and --incoherent-file ride the sharded kernel)."""
    from dsabeamformer.ingest.dada import read_product_file
    from dsabeamformer.ops.incoherent import incoherent_power_golden

    cfg = tiny_cfg.replace(n_chan=16, n_chan_total=16)
    blocks = [make_noise_block(cfg, rms=2.0, seed=s) for s in range(2)]
    inpath = tmp_path / "in.raw"
    with open(inpath, "wb") as f:
        for b in blocks:
            f.write(np.asarray(b).tobytes())
    inco_path = tmp_path / "inco.dada"
    rc = cli.main([
        "run", "--config", "tiny", "--set", "n_chan_total=16",
        "--set", "n_chan=16", "--mesh", "8",
        "--input-file", str(inpath),
        "--incoherent-file", str(inco_path),
        "--rfi-auto", "--rfi-interval", "2",
    ])
    assert rc == 0
    summary = json.loads(capsys.readouterr().out.strip())
    assert summary["blocks"] == 2
    hdr, inco = read_product_file(inco_path)
    assert hdr["PAYLOAD"] == "INCOHERENT_POWER"
    np.testing.assert_allclose(
        np.asarray(inco)[0], incoherent_power_golden(blocks[0], cfg),
        rtol=1e-6)


def test_run_mesh_must_divide_channels(tmp_path, capsys, tiny_cfg):
    inpath = tmp_path / "in.raw"
    with open(inpath, "wb") as f:
        f.write(np.asarray(make_noise_block(tiny_cfg, seed=0)).tobytes())
    rc = cli.main([
        "run", "--config", "tiny", "--mesh", "3",
        "--input-file", str(inpath),
    ])
    assert rc == 2
    assert "divisible" in capsys.readouterr().err


def test_run_mesh_per_shard_tile_violation_is_clean(tmp_path, capsys,
                                                    tiny_cfg):
    # tiny at navg_freq=2: --mesh 8 gives 1 chan/shard, which divides
    # n_chan but not navg_freq.  Must take the same rc=2 + stderr path
    # as the divisibility error, not a raw traceback out of warmup().
    inpath = tmp_path / "in.raw"
    with open(inpath, "wb") as f:
        f.write(np.asarray(make_noise_block(tiny_cfg, seed=0)).tobytes())
    rc = cli.main([
        "run", "--config", "tiny", "--set", "navg_freq=2", "--mesh", "8",
        "--input-file", str(inpath),
    ])
    assert rc == 2
    assert "navg_freq" in capsys.readouterr().err


def test_config_override(capsys):
    rc = cli.main(["weights", "--config", "tiny", "--set", "n_beams=64",
                   "--out", "/tmp/w-override.npz"])
    assert rc == 0
    meta = json.loads(capsys.readouterr().out.strip())
    assert meta["shape"][-1] == 128  # 2*n_beams


def test_bad_config_key_fails():
    with pytest.raises(AttributeError):
        cli.main(["weights", "--config", "tiny", "--set", "nope=1",
                  "--out", "/tmp/x.npz"])


def test_set_bool_coercion_tokens():
    # bool("false") is True -- the CLI must parse bool tokens explicitly.
    assert cli._coerce_field(True, "false") is False
    assert cli._coerce_field(True, "0") is False
    assert cli._coerce_field(False, "TRUE") is True
    assert cli._coerce_field(False, "on") is True
    with pytest.raises(ValueError, match="bool"):
        cli._coerce_field(True, "nope")


def test_run_pinned_nonzero_device_single_compile(tmp_path, capsys, caplog,
                                                  tiny_cfg):
    """--device N must pin weights + warmup + the stream to device N:
    with everything under one jax.default_device, the block step
    compiles at most once (warmup), never again on the first live
    block."""
    import logging

    import jax

    blocks = [make_noise_block(tiny_cfg, rms=2.0, seed=s) for s in range(2)]
    inpath = tmp_path / "in.raw"
    with open(inpath, "wb") as f:
        for b in blocks:
            f.write(b.tobytes())
    jax.config.update("jax_log_compiles", True)
    try:
        with caplog.at_level(logging.WARNING):
            rc = cli.main(["run", "--config", "tiny",
                           "--input-file", str(inpath),
                           "--device", "1", "--blocks", "2"])
    finally:
        jax.config.update("jax_log_compiles", False)
    assert rc == 0
    summary = json.loads(capsys.readouterr().out.strip())
    assert summary["blocks"] == 2
    compiles = [r for r in caplog.records
                if "beamform_power" in r.getMessage()
                and "Compiling" in r.getMessage()]
    assert len(compiles) <= 1, [r.getMessage() for r in compiles]


def test_ring_monitor(capsys):
    """`dsabf ring` prints the counters of a live ring (dada_dbmonitor
    analog)."""
    import json

    import numpy as np

    from dsabeamformer import cli
    from dsabeamformer.ingest.ring import RingBuffer

    with RingBuffer("clitestmon", create=True, nbufs=4, bufsz=64) as ring:
        ring.write_header("HDR 1.0\n")
        ring.write_block(np.zeros(64, np.uint8))
        ring.write_block(np.ones(64, np.uint8))
        assert cli.main(["ring", "--key", "clitestmon"]) == 0
        rec = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
        assert rec["written"] == 2 and rec["backlog"] == 2
        assert rec["nbufs"] == 4 and rec["bufsz"] == 64
        assert rec["dropped"] == 0 and rec["eod"] is False


def test_subband_flag(capsys):
    """--subband I/N = the reference's process-per-subband split."""
    import json

    import numpy as np

    from dsabeamformer import cli
    from dsabeamformer.config import DSA10

    assert cli.main(["info", "--config", "dsa10", "--subband", "3/8"]) == 0
    rec = json.loads(capsys.readouterr().out)
    sub = DSA10.subband(3 * 256, 256)
    assert rec["wire_block_bytes"] == sub.wire_block_bytes
    # Full-band rate is set by n_chan_total, so a subband instance's
    # realtime target is 1/N of the aggregate.
    assert rec["realtime_gb_per_s"] == round(sub.realtime_bytes_per_s / 1e9, 3)

    import pytest

    with pytest.raises(SystemExit, match="I/N"):
        cli.main(["info", "--config", "dsa10", "--subband", "3"])
    with pytest.raises(SystemExit, match="divide"):
        cli.main(["info", "--config", "dsa10", "--subband", "0/7"])


def test_subband_end_to_end(tmp_path, capsys, tiny_cfg):
    """A subband capture round-trips: the recorded DADA header carries
    the subband geometry, so the consumer needs no --subband (and the
    redundant/conflicting combination is rejected loudly)."""
    import pytest

    from dsabeamformer import cli

    out = str(tmp_path / "cap.dada")
    assert cli.main(["simulate", "--config", "tiny", "--subband", "1/2",
                     "--blocks", "2", "--out-file", out]) == 0
    capsys.readouterr()
    pout = str(tmp_path / "powers.raw")
    rc = cli.main(["run", "--config", "tiny",
                   "--input-file", out, "--output-file", pout, "--blocks", "2"])
    assert rc == 0
    import os

    import numpy as np

    sub = tiny_cfg.subband(tiny_cfg.n_chan // 2, tiny_cfg.n_chan // 2)
    assert os.path.getsize(pout) == 2 * int(np.prod(sub.out_block_shape)) * 4

    # --subband + a DADA capture would let the header silently override
    # the slice; the CLI must reject the combination.
    with pytest.raises(SystemExit, match="DADA capture"):
        cli.main(["run", "--config", "tiny", "--subband", "1/2",
                  "--input-file", out, "--output-file", pout])


def test_launch_subband_processes(tiny_cfg, tmp_path, monkeypatch, capsys):
    """dsabf launch: N per-subband run children with {i}/{n} templating,
    aggregated JSON exit report, per-subband outputs written."""
    import json

    import numpy as np

    from dsabeamformer.cli import main as cli_main
    from dsabeamformer.ingest.generator import make_noise_block

    cfg = tiny_cfg
    n = 2
    width = cfg.n_chan // n
    for i in range(n):
        sb = cfg.subband(i * width, width)
        (tmp_path / f"cap{i}.raw").write_bytes(
            make_noise_block(sb, rms=2.0, seed=20 + i).tobytes())
    monkeypatch.setenv("JAX_PLATFORMS", "cpu")
    rc = cli_main([
        "launch", "--subbands", str(n), "--",
        "--config", "tiny",
        "--input-file", str(tmp_path / "cap{i}.raw"),
        "--output-file", str(tmp_path / "out{i}.dat"),
    ])
    assert rc == 0
    rep = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rep["ok"] and len(rep["subbands"]) == n
    for i, sb_rep in enumerate(rep["subbands"]):
        assert sb_rep["rc"] == 0 and sb_rep["subband"] == f"{i}/{n}"
        assert sb_rep["blocks"] == 1
        out = np.fromfile(tmp_path / f"out{i}.dat", dtype=np.float32)
        f_out, t_out, b_out = cfg.out_block_shape
        assert out.size == (f_out // n) * t_out * b_out
        assert np.isfinite(out).all() and out.min() >= 0


def test_launch_ring_topology_joined_search_equals_fullband(
        tiny_cfg, tmp_path, monkeypatch, capsys):
    """The deployment topology end to end (VERDICT r3 #4): `dsabf
    launch --subbands 2` supervises two per-subband `run` children
    writing product RINGS; the joined `dsabf search --key k0,k1`
    consumer must report candidate-for-candidate exactly what the
    full-band search of the same data reports (same monitor machinery
    fed by a joined product file)."""
    import os as _os

    from dsabeamformer.config import DM_CONST_S
    from dsabeamformer.ingest import dada
    from dsabeamformer.ingest.ring import RingBuffer
    from dsabeamformer.pipeline import FileSink

    monkeypatch.setenv("JAX_PLATFORMS", "cpu")
    cfg = tiny_cfg.replace(navg_time=2)
    f = cfg.freqs_hz() / 1e6
    tsamp_out = cfg.sample_period_s * cfg.navg_time
    # ~2 output samples of sweep across the full band (see
    # test_dedisperse.test_cli_search_live_ring_join for why).
    dm = (2 * tsamp_out
          / (DM_CONST_S * (f.min() ** -2 - f.max() ** -2)))
    search_flags = ["--beam", "all", "--no-coincidence",
                    "--dm-max", str(4 * dm), "--threshold", "8",
                    "--widths", "1", "2", "4", "--timeout", "2"]

    # Per-subband RAW captures with the injected pulse (simulate writes
    # a DADA capture; strip its header so the launch children can apply
    # their --subband i/2 split to a headerless file).
    for i in range(2):
        cap = tmp_path / f"cap{i}.dada"
        assert cli.main(["simulate", "--config", "tiny",
                         "--set", "navg_time=2", "--subband", f"{i}/2",
                         "--pulse-dm", str(dm), "--pulse-t0", "8",
                         "--pulse-width", "6", "--blocks", "6",
                         "--distinct", "2", "--out-file", str(cap)]) == 0
        raw = cap.read_bytes()[dada.DADA_HDR_SIZE:]
        (tmp_path / f"cap{i}.raw").write_bytes(raw)

    keys = [f"ttopo{_os.getpid()}_{i}" for i in range(2)]
    try:
        # The topology: launch supervises both subband producers.
        rc = cli.main([
            "launch", "--subbands", "2", "--",
            "--config", "tiny", "--set", "navg_time=2",
            "--input-file", str(tmp_path / "cap{i}.raw"),
            "--output-key", f"ttopo{_os.getpid()}_" + "{i}",
            "--nbufs", "12",
        ])
        assert rc == 0
        rep = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
        assert rep["ok"] and all(s["blocks"] == 6 for s in rep["subbands"])

        # Joined live consumer over the two rings.
        rc = cli.main(["search", "--key", ",".join(keys)] + search_flags)
        assert rc == 0
        out = capsys.readouterr()
        assert "attached to 2 ring(s)" in out.err
        rows_live = [l for l in out.out.splitlines()
                     if l.strip() and not l.startswith("#")]
        assert rows_live, "joined live search found no candidates"

        # Full-band ground truth: per-subband product FILES from the
        # same captures, joined along the channel axis, searched
        # through the same monitor machinery (--stream).
        prods = []
        for i in range(2):
            prod = tmp_path / f"prod{i}.dada"
            assert cli.main(["run", "--config", "tiny",
                             "--set", "navg_time=2",
                             "--subband", f"{i}/2",
                             "--input-file", str(tmp_path / f"cap{i}.raw"),
                             "--output-file", str(prod)]) == 0
            _, powers = dada.read_product_file(prod)
            prods.append(np.asarray(powers))
        joined = np.concatenate(prods, axis=1)  # [N, F_full, T', B]
        jpath = tmp_path / "joined.dada"
        sink = FileSink(jpath, cfg, products="power")
        for i in range(joined.shape[0]):
            sink.write(i, joined[i])
        sink.close()
        capsys.readouterr()
        rc = cli.main(["search", str(jpath), "--stream"] + search_flags)
        assert rc == 0
        rows_full = [l for l in capsys.readouterr().out.splitlines()
                     if l.strip() and not l.startswith("#")]
        assert rows_live == rows_full
    finally:
        for key in keys:
            try:
                RingBuffer(key, connect_timeout_s=1).destroy()
            except Exception:
                pass


def test_launch_gives_each_child_its_own_card(monkeypatch, capsys):
    """--devices: child i sees only card devices[i] and pins device 0
    of what it sees (one JAX process per card)."""
    import json as _json
    import subprocess

    seen = []

    class FakePopen:
        returncode = 0

        def __init__(self, argv, env=None, **kw):
            seen.append((argv, env))

        def communicate(self):
            return _json.dumps({"blocks": 1}) + "\n", None

        def poll(self):
            return 0

    monkeypatch.setattr(subprocess, "Popen", FakePopen)
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "0,1,2,3")
    rc = cli.main(["launch", "--subbands", "2", "--devices", "3,1",
                   "--", "--config", "tiny", "--input-file", "x{i}.raw"])
    assert rc == 0
    assert [env["CUDA_VISIBLE_DEVICES"] for _, env in seen] == ["3", "1"]
    for i, (argv, _) in enumerate(seen):
        assert argv[argv.index("--device") + 1] == "0"
        assert argv[argv.index("--subband") + 1] == f"{i}/2"
        assert f"x{i}.raw" in argv
    assert _json.loads(capsys.readouterr().out.strip())["ok"] is True


def test_launch_without_devices_inherits_env(monkeypatch, capsys):
    import json as _json
    import subprocess

    seen = []

    class FakePopen:
        returncode = 0

        def __init__(self, argv, env=None, **kw):
            seen.append((argv, env))

        def communicate(self):
            return _json.dumps({"blocks": 1}) + "\n", None

        def poll(self):
            return 0

    monkeypatch.setattr(subprocess, "Popen", FakePopen)
    assert cli.main(["launch", "--subbands", "2", "--", "--config",
                     "tiny"]) == 0
    assert [env for _, env in seen] == [None, None]
    assert all("--device" not in argv for argv, _ in seen)


def test_launch_validates_devices_count(capsys):
    from dsabeamformer.cli import main as cli_main

    rc = cli_main(["launch", "--subbands", "2", "--devices", "0",
                   "--", "--config", "tiny"])
    assert rc == 2


def test_launch_failing_child_fails_aggregate(tiny_cfg, tmp_path,
                                              monkeypatch, capsys):
    """One subband child failing (missing input file) must fail the
    aggregate report and the supervisor exit code, while healthy
    subbands still complete and report."""
    import json

    from dsabeamformer.cli import main as cli_main
    from dsabeamformer.ingest.generator import make_noise_block

    monkeypatch.setenv("JAX_PLATFORMS", "cpu")
    cfg = tiny_cfg
    width = cfg.n_chan // 2
    # Only subband 0's capture exists; child 1 exits nonzero.
    sb = cfg.subband(0, width)
    (tmp_path / "cap0.raw").write_bytes(
        make_noise_block(sb, rms=2.0, seed=31).tobytes())
    rc = cli_main([
        "launch", "--subbands", "2", "--",
        "--config", "tiny",
        "--input-file", str(tmp_path / "cap{i}.raw"),
        "--output-file", str(tmp_path / "out{i}.dat"),
    ])
    assert rc != 0
    rep = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rep["ok"] is False
    rcs = {s["subband"]: s["rc"] for s in rep["subbands"]}
    assert rcs["0/2"] == 0 and rcs["1/2"] != 0
