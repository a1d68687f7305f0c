"""Streaming RFI monitor (ops/rfi.py) + the --rfi-auto CLI path:
window pooling, sticky excision, the cap guard, and mid-stream weight
regeneration zeroing the excised channel in the product."""

import json

import numpy as np
import pytest

from dsabeamformer.ingest.generator import make_noise_block, make_tone_block
from dsabeamformer.ops.rfi import RFIMonitor


def _tone_infected(cfg, seed, chan=2, amp=6.0):
    w = make_noise_block(cfg, rms=2.0, seed=seed).reshape(
        cfg.t_block, cfg.n_chan, cfg.n_pol, cfg.n_ant).copy()
    tone = make_tone_block(cfg, chan=chan, amplitude=amp).reshape(
        cfg.t_block, cfg.n_chan, cfg.n_pol, cfg.n_ant)
    w[:, chan] = tone[:, chan]
    return w.reshape(cfg.wire_block_shape)


def test_monitor_excises_once_and_stays_sticky(tiny_cfg):
    cfg = tiny_cfg
    events = []
    mon = RFIMonitor(cfg, interval=2, on_event=events.append)
    for s in range(6):
        mon.observe(_tone_infected(cfg, seed=s))
        mon.poll()
    # 3 full windows saw the same carrier; it is excised exactly once
    assert [e["type"] for e in events] == ["excise"]
    assert events[0]["new"] == [2] and events[0]["blocks"] == 2
    assert mon.zapped == {2}


def test_monitor_sampling_and_flush(tiny_cfg):
    cfg = tiny_cfg
    events = []
    mon = RFIMonitor(cfg, interval=4, sample=2, on_event=events.append)
    for s in range(6):  # samples blocks 0,2,4 -> 3 observed < interval
        mon.observe(_tone_infected(cfg, seed=10 + s))
        mon.poll()
    assert events == []  # window never filled
    mon.flush()          # partial window (3 >= 2) decides at EOS
    assert [e["type"] for e in events] == ["excise"]
    assert events[0]["blocks"] == 3


def test_wants_stats_peeks_sampling_grid(tiny_cfg):
    """wants_stats() predicts each observe call's sampling decision
    without advancing the grid, and observe_stats(None) on a sampled
    block is a contract violation (the caller skipped the emission the
    monitor was promised)."""
    mon = RFIMonitor(tiny_cfg, sample=3)
    decisions = []
    for s in range(7):
        want = mon.wants_stats()
        assert mon.wants_stats() == want  # peek, no advance
        if want:
            mon.observe_stats(np.ones((tiny_cfg.n_chan, 2), np.float32))
        else:
            mon.observe_stats(None)
        decisions.append(want)
    assert decisions == [True, False, False] * 2 + [True]
    mon2 = RFIMonitor(tiny_cfg, sample=2)
    assert mon2.wants_stats()
    with pytest.raises(ValueError):
        mon2.observe_stats(None)  # sampled block without stats


def test_sampled_sk_gates_kernel_variant(tiny_cfg):
    """--rfi-sample N with the fused path: unsampled blocks dispatch
    the PLAIN kernel variant (the SK emission measures +11.3 ms/block
    at the dsa10 preset — not free), sampled blocks carry the
    accumulators, and the monitor still excises from the sampled
    subset.  Warmup compiles both variants so neither stalls live."""
    from dsabeamformer.models.weights import make_weights
    from dsabeamformer.ops.quantize import quantize_weights
    from dsabeamformer.pipeline import (
        CollectSink, StreamingBeamformer, SyntheticSource)

    cfg = tiny_cfg
    qw = quantize_weights(make_weights(cfg), cfg.weight_mode)
    events = []
    mon = RFIMonitor(cfg, interval=2, sample=2, on_event=events.append)
    blocks = [_tone_infected(cfg, seed=50 + s) for s in range(6)]
    bf = StreamingBeamformer(
        cfg, qw, SyntheticSource(cfg, blocks, n_blocks=6),
        CollectSink(), depth=1)
    bf.rfi_monitor = mon
    calls = []
    inner = bf._detect
    def spy(*a, **k):
        calls.append(bool(k.get("sk_stats", False)))
        return inner(*a, **k)
    bf._detect = spy
    bf.warmup()
    assert calls == [True, False]  # both variants pre-compiled
    calls.clear()
    bf.run(max_blocks=6)
    assert calls == [True, False] * 3  # grid-gated dispatch
    # sampled blocks 0/2/4 pool into interval=2 windows -> excision
    assert [e["type"] for e in events] == ["excise"]
    assert events[0]["new"] == [2]


def test_monitor_cap_refuses_wholesale_zap(tiny_cfg):
    cfg = tiny_cfg
    events = []
    # max_fraction tiny -> max_channels=1; two RFI channels trip the cap
    mon = RFIMonitor(cfg, interval=2, max_fraction=0.01,
                     on_event=events.append)
    for s in range(2):
        w = _tone_infected(cfg, seed=20 + s, chan=2).reshape(
            cfg.t_block, cfg.n_chan, cfg.n_pol, cfg.n_ant).copy()
        t5 = make_tone_block(cfg, chan=5, amplitude=6.0).reshape(
            cfg.t_block, cfg.n_chan, cfg.n_pol, cfg.n_ant)
        w[:, 5] = t5[:, 5]
        mon.observe(w.reshape(cfg.wire_block_shape))
        mon.poll()
    assert [e["type"] for e in events] == ["cap"]
    assert mon.zapped == set()  # nothing excised


def test_monitor_seed_not_rereported(tiny_cfg):
    cfg = tiny_cfg
    events = []
    mon = RFIMonitor(cfg, interval=2, on_event=events.append,
                     seed_zapped=[2])
    for s in range(4):
        mon.observe(_tone_infected(cfg, seed=30 + s))
        mon.poll()
    assert events == []  # the carrier channel was already zapped at start


def test_monitor_validation(tiny_cfg):
    with pytest.raises(ValueError):
        RFIMonitor(tiny_cfg, interval=0)
    with pytest.raises(ValueError):
        RFIMonitor(tiny_cfg, sample=0)
    with pytest.raises(ValueError):
        RFIMonitor(tiny_cfg, max_fraction=0.0)


def test_cli_rfi_auto_zeroes_channel_midstream(tiny_cfg, tmp_path, capsys):
    from dsabeamformer import cli
    from dsabeamformer.ingest.dada import read_product_file

    cfg = tiny_cfg
    raw = tmp_path / "cap.raw"
    raw.write_bytes(b"".join(
        _tone_infected(cfg, seed=40 + s, chan=6).tobytes() for s in range(6)))
    out = tmp_path / "out.dada"
    rc = cli.main(["run", "--config", "tiny", "--input-file", str(raw),
                   "--output-file", str(out),
                   "--rfi-auto", "--rfi-interval", "1"])
    assert rc == 0
    err = capsys.readouterr().err
    ev_lines = [l for l in err.splitlines() if l.startswith("[dsabf] rfi ")]
    assert ev_lines, err
    ev = json.loads(ev_lines[0][len("[dsabf] rfi "):])
    assert ev["type"] == "excise" and 6 in ev["new"]
    _, powers = read_product_file(out)
    assert powers.shape[0] == 6
    # block 0 ran with the original weights: carrier power present
    assert powers[0, 6].max() > 0
    # by the last block the excision has propagated: exactly zero
    assert powers[-1, 6].max() == 0
    # other channels unaffected throughout
    assert powers[-1, 3].max() > 0


def test_cli_rfi_auto_rejects_prequantized_weights(tiny_cfg, tmp_path,
                                                   capsys):
    from dsabeamformer import cli

    cfg = tiny_cfg
    raw = tmp_path / "cap.raw"
    raw.write_bytes(make_noise_block(cfg, rms=2.0, seed=1).tobytes())
    wfile = tmp_path / "w.npz"
    assert cli.main(["weights", "--config", "tiny", "--out", str(wfile)]) == 0
    rc = cli.main(["run", "--config", "tiny", "--input-file", str(raw),
                   "--weights", str(wfile), "--rfi-auto"])
    assert rc == 2
    assert "--rfi-auto" in capsys.readouterr().err


def test_monitor_poll_gated_by_drained_count(tiny_cfg):
    """poll(n_drained) must not touch stats for blocks still in
    flight — fetching them would serialize the depth-pipelining."""
    cfg = tiny_cfg
    mon = RFIMonitor(cfg, interval=100)  # never decides
    for s in range(3):
        mon.observe(_tone_infected(cfg, seed=50 + s))
    mon.poll(0)
    assert mon._n == 0 and len(mon._pending) == 3
    mon.poll(1)
    assert mon._n == 1 and len(mon._pending) == 2
    mon.poll(3)
    assert mon._n == 3 and not mon._pending
    # None = end of stream: everything
    mon.observe(_tone_infected(cfg, seed=53))
    mon.poll(None)
    assert mon._n == 4


def test_monitor_cap_not_respammed(tiny_cfg):
    cfg = tiny_cfg
    events = []
    mon = RFIMonitor(cfg, interval=1, max_fraction=0.01,
                     on_event=events.append)
    for s in range(4):  # 4 windows, identical broken-null flag set
        w = _tone_infected(cfg, seed=60 + s, chan=2).reshape(
            cfg.t_block, cfg.n_chan, cfg.n_pol, cfg.n_ant).copy()
        t5 = make_tone_block(cfg, chan=5, amplitude=6.0).reshape(
            cfg.t_block, cfg.n_chan, cfg.n_pol, cfg.n_ant)
        w[:, 5] = t5[:, 5]
        mon.observe(w.reshape(cfg.wire_block_shape))
        mon.poll(None)
    caps = [e for e in events if e["type"] == "cap"]
    assert len(caps) == 1  # deduped
    # a later SMALL flag set still excises (cap refusal zaps nothing)
    # -- covered implicitly: zapped stays empty so capacity remains
    assert mon.zapped == set()


def test_monitor_flush_event_is_final(tiny_cfg):
    cfg = tiny_cfg
    events = []
    mon = RFIMonitor(cfg, interval=100, on_event=events.append)
    for s in range(2):
        mon.observe(_tone_infected(cfg, seed=70 + s))
    mon.flush()
    assert len(events) == 1 and events[0].get("final") is True


def test_monitor_warmup_no_state(tiny_cfg):
    cfg = tiny_cfg
    mon = RFIMonitor(cfg, interval=1)
    mon.warmup(_tone_infected(cfg, seed=80))
    assert mon._n == 0 and not mon._pending and mon.zapped == set()


def test_cli_rfi_auto_with_tracker_uses_current_pointing(tiny_cfg,
                                                        tmp_path, capsys):
    """--track + --rfi-auto: excision must ride the tracker (current
    pointing), not a t=0 regeneration; the zap still lands."""
    from dsabeamformer import cli
    from dsabeamformer.ingest.dada import read_product_file

    cfg = tiny_cfg
    raw = tmp_path / "cap.raw"
    raw.write_bytes(b"".join(
        _tone_infected(cfg, seed=90 + s, chan=6).tobytes() for s in range(6)))
    out = tmp_path / "out.dada"
    rc = cli.main(["run", "--config", "tiny", "--input-file", str(raw),
                   "--output-file", str(out), "--track",
                   "--rfi-auto", "--rfi-interval", "1"])
    assert rc == 0
    err = capsys.readouterr().err
    assert "[dsabf] rfi " in err
    _, powers = read_product_file(out)
    assert powers[0, 6].max() > 0       # pre-excision
    assert powers[-1, 6].max() == 0     # tracker regeneration zapped it
    assert powers[-1, 3].max() > 0


def test_cli_rfi_json_has_no_nan(tiny_cfg, tmp_path, capsys):
    """A dead channel must yield null, not bare NaN, in the JSON."""
    import json

    from dsabeamformer import cli
    from dsabeamformer.ingest import dada

    cfg = tiny_cfg

    def dead_block(seed):
        w = make_noise_block(cfg, rms=2.0, seed=seed).reshape(
            cfg.t_block, cfg.n_chan, cfg.n_pol, cfg.n_ant).copy()
        w[:, 3] = 0
        return w.reshape(cfg.wire_block_shape)

    cap = str(tmp_path / "cap.dada")
    dada.write_dada_file(cap, cfg, (dead_block(s) for s in range(2)))
    assert cli.main(["rfi", "--config", "tiny", "--input-file", cap,
                     "--sk-values"]) == 0
    text = capsys.readouterr().out
    assert "NaN" not in text
    rec = json.loads(text)
    assert rec["sk"][3] is None and 3 in rec["flagged"]


def test_cli_rfi_auto_stokes_products(tiny_cfg, tmp_path, capsys):
    """--rfi-auto composes with --products stokes: the Stokes kernel
    emits the SK accumulators too, and the excised channel zeroes in
    all four planes."""
    from dsabeamformer import cli
    from dsabeamformer.ingest.dada import read_product_file

    cfg = tiny_cfg
    raw = tmp_path / "cap.raw"
    raw.write_bytes(b"".join(
        _tone_infected(cfg, seed=95 + s, chan=6).tobytes() for s in range(6)))
    out = tmp_path / "out.dada"
    rc = cli.main(["run", "--config", "tiny", "--input-file", str(raw),
                   "--output-file", str(out), "--products", "stokes",
                   "--rfi-auto", "--rfi-interval", "1"])
    assert rc == 0
    assert "[dsabf] rfi " in capsys.readouterr().err
    _, powers = read_product_file(out)  # [n, F, T, 4, B]
    assert powers.ndim == 5
    assert np.abs(powers[0, 6]).max() > 0
    assert np.abs(powers[-1, 6]).max() == 0
    assert np.abs(powers[-1, 3]).max() > 0


def test_cli_rfi_live_ring_scan(tiny_cfg, tmp_path, capsys):
    """dsabf rfi --key scans a live ring (bounded default blocks) and
    flags the carrier just like the file path; exactly-one-input is
    enforced."""
    import threading

    from dsabeamformer import cli
    from dsabeamformer.ingest import dada
    from dsabeamformer.ingest.ring import RingBuffer

    cfg = tiny_cfg
    blocks = [_tone_infected(cfg, seed=110 + s, chan=4) for s in range(4)]

    def produce():
        with RingBuffer("rfiscan", create=True, nbufs=4,
                        bufsz=cfg.wire_block_bytes) as ring:
            ring.write_header(dada.encode_header(cfg))
            for b in blocks:
                ring.write_block(b)
            ring.set_eod()
            import time as _t
            deadline = _t.monotonic() + 30
            while _t.monotonic() < deadline and ring.n_read < len(blocks):
                _t.sleep(0.05)  # wait for actual consumption, not a guess

    prod = threading.Thread(target=produce)
    prod.start()
    try:
        rc = cli.main(["rfi", "--config", "tiny", "--key", "rfiscan"])
    finally:
        prod.join()
    assert rc == 0
    rec = json.loads(capsys.readouterr().out)
    assert rec["blocks"] == 4 and 4 in rec["flagged"]
    # exactly one input source
    assert cli.main(["rfi", "--config", "tiny"]) == 2
    assert cli.main(["rfi", "--config", "tiny", "--key", "x",
                     "--input-file", "y"]) == 2
