"""Profiler integration (SURVEY.md §5 tracing/profiling).

The reference relied on CUDA events + external nvprof timelines; here
the equivalents are ``jax.profiler`` traces (viewable in
XProf/TensorBoard/Perfetto) plus the per-block metrics stream
(utils/metrics.py).  Kernel times come from the trace: use
``trace()`` around a few streaming blocks and sum the device events
of each kernel.
"""

from __future__ import annotations

import contextlib
from pathlib import Path

import jax


@contextlib.contextmanager
def trace(log_dir: str | Path = "/tmp/dsabf-trace"):
    """Context manager: capture a device trace around the enclosed block.

    View with: ``tensorboard --logdir <log_dir>`` (profile plugin) or
    upload the contained ``.trace.json.gz``/``xplane`` to Perfetto/XProf.
    """
    log_dir = str(log_dir)
    jax.profiler.start_trace(log_dir)
    try:
        yield log_dir
    finally:
        jax.profiler.stop_trace()


def annotate(name: str):
    """Named region that shows up in profiler timelines."""
    return jax.profiler.TraceAnnotation(name)


def summarize_trace(log_dir: str | Path, top: int = 12) -> list[dict]:
    """Aggregate per-op durations from the newest captured trace.

    Reads the ``*.trace.json.gz`` the profiler wrote under ``log_dir``
    and returns the ``top`` entries by total duration as
    ``{"name", "count", "total_ms"}`` dicts — the measured stage
    breakdown (detection kernel vs copies vs fusions) that the
    reference surfaced via nvprof timelines (SURVEY.md §5)."""
    import gzip
    import json

    traces = sorted(Path(log_dir).glob("**/*.trace.json.gz"),
                    key=lambda p: p.stat().st_mtime)
    if not traces:
        raise FileNotFoundError(f"no .trace.json.gz under {log_dir}")
    with gzip.open(traces[-1]) as f:
        events = json.load(f).get("traceEvents", [])
    agg: dict = {}
    for e in events:
        if e.get("ph") != "X":
            continue
        name = e.get("name", "?")
        rec = agg.setdefault(name, [0, 0.0])
        rec[0] += 1
        rec[1] += e.get("dur", 0) / 1e3  # us -> ms
    rows = sorted(agg.items(), key=lambda kv: -kv[1][1])[:top]
    return [
        {"name": n, "count": c, "total_ms": round(ms, 3)}
        for n, (c, ms) in rows
    ]


def profile_block_step(cfg, n_blocks: int = 3,
                       log_dir: str | Path = "/tmp/dsabf-trace") -> list[dict]:
    """Capture a device trace of ``n_blocks`` block steps and return the
    per-op duration summary (the `dsabf trace` command)."""
    from dsabeamformer.ingest.generator import make_random_bytes_block
    from dsabeamformer.models.weights import make_weights
    from dsabeamformer.ops.gemm import beamform_power, device_wire_view
    from dsabeamformer.ops.quantize import quantize_weights

    qw = quantize_weights(make_weights(cfg), cfg.weight_mode, cfg.a_compute)
    wire = jax.device_put(
        device_wire_view(make_random_bytes_block(cfg, seed=0), cfg)
    )
    jax.block_until_ready(beamform_power(wire, qw, cfg))  # compile first
    with trace(log_dir) as d:
        for _ in range(n_blocks):
            out = beamform_power(wire, qw, cfg)
        jax.block_until_ready(out)
    return summarize_trace(d)
