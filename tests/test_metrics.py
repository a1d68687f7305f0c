"""Metrics/observability unit tests (SURVEY.md §5: the per-block stats
stream IS the north-star metric)."""

import json
import time

import pytest

from dsabeamformer.config import TINY
from dsabeamformer.utils.bench import run_benchmark
from dsabeamformer.utils.metrics import BlockStats, StreamStats


def test_block_stats_line_format():
    bs = BlockStats(block_idx=3, seq=5, wall_s=0.002, bytes_in=TINY.wire_block_bytes,
                    dropped=1, skipped=2)
    line = bs.line(TINY)
    assert "block      3" in line and "dropped 1" in line and "skipped 2" in line


def test_stream_stats_record():
    st = StreamStats(cfg_name="tiny")
    st.n_blocks = 4
    st.bytes_in = 4 * TINY.wire_block_bytes
    time.sleep(0.01)
    st.finish()
    rec = st.record(TINY)
    assert rec["blocks"] == 4
    assert rec["gb_per_s"] > 0
    assert rec["realtime_factor"] > 0
    json.loads(st.json_line(TINY))  # valid JSON


def test_realtime_factor_definition():
    """RT factor is time-based: data seconds / wall seconds."""
    st = StreamStats(cfg_name="tiny")
    st.n_blocks = 10
    st.wall_s = 10 * TINY.block_duration_s  # exactly realtime
    assert abs(st.realtime_factor(TINY) - 1.0) < 1e-9


def test_bench_kernel_record_on_cpu():
    rec = run_benchmark(TINY, n_blocks=2, mode="kernel")
    assert rec["mode"] == "kernel"
    assert rec["ms_per_block"] > 0
    assert rec["realtime_factor"] > 0


def test_bench_stream_record_on_cpu():
    rec = run_benchmark(TINY, n_blocks=3, mode="stream")
    assert rec["mode"] == "stream"
    assert rec["blocks"] == 3


def test_trace_capture_and_summary(tmp_path, tiny_cfg):
    """profiling.profile_block_step captures a real device trace and
    returns a per-op duration breakdown (works on the CPU backend)."""
    from dsabeamformer.utils.profiling import profile_block_step

    rows = profile_block_step(tiny_cfg, n_blocks=2, log_dir=str(tmp_path))
    assert rows and all({"name", "count", "total_ms"} <= set(r) for r in rows)
    assert any("beamform" in r["name"] for r in rows)


def test_cli_trace(tmp_path, capsys):
    import json as _json

    from dsabeamformer import cli

    rc = cli.main(["trace", "--config", "tiny", "--blocks", "2",
                   "--out", str(tmp_path)])
    assert rc == 0
    out = _json.loads(capsys.readouterr().out.strip())
    assert out["ops"]


@pytest.mark.parametrize("kind", ["cpu", "Tesla T4", "NVIDIA A100-SXM4-80GB"])
def test_peak_table_raises_on_unknown_kind(kind):
    """No assumed peak: a device the table does not know is an error."""
    from dsabeamformer.utils import metrics

    with pytest.raises(ValueError, match="no published peaks"):
        metrics.device_peaks(kind)


@pytest.mark.parametrize("kind", ["NVIDIA H100 80GB HBM3", "NVIDIA H100 PCIe"])
def test_peak_table_h100_rows(kind):
    from dsabeamformer.utils import metrics

    pk = metrics.device_peaks(kind)
    assert set(pk) == {"int8_ops_per_s", "bf16_flops_per_s",
                       "hbm_bytes_per_s"}
    # int8 tensor-core rate is twice the bf16 rate on Hopper.
    assert pk["int8_ops_per_s"] == pytest.approx(2 * pk["bf16_flops_per_s"],
                                                 rel=0.01)


def test_roofline_share_names_its_bound():
    from dsabeamformer.utils import metrics

    kind = "NVIDIA H100 80GB HBM3"
    pk = metrics.PEAKS[kind]
    # 1 s of peak int8 work and a trivial byte count, done in 2 s.
    r = metrics.roofline_share(pk["int8_ops_per_s"], 1.0, 2.0, kind)
    assert r == {"share": pytest.approx(0.5), "bound": "compute"}
    r = metrics.roofline_share(1.0, pk["hbm_bytes_per_s"], 4.0, kind)
    assert r == {"share": pytest.approx(0.25), "bound": "memory"}


def test_bench_records_name_the_device():
    rec = run_benchmark(TINY, n_blocks=1, mode="kernel")
    assert rec["device"] == {"platform": "cpu", "kind": "cpu", "count": 8}
