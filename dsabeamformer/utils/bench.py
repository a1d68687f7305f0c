"""Single-device benchmarks: the north-star measurement
(BASELINE.json `metric`: voltage GB/s per device; real-time factor vs
the stream rate).

Two modes:

- ``stream``: end-to-end host->device ingest through the streaming
  driver (BASELINE config 4) — what the observatory would sustain.
- ``kernel``: device-resident hot loop — blocks pre-staged in device
  memory, n_blocks back-to-back *dispatches* of the block step (the
  production streaming shape: one dispatch per block), closed by
  ``block_until_ready``.  Dispatches queue on the device and execute
  serially, so wall/n_blocks is the per-block device time including
  the per-dispatch cost the streaming driver pays.

Every record names the device it ran on.
"""

from __future__ import annotations

import time

import jax

from dsabeamformer.config import ObsConfig
from dsabeamformer.ingest.generator import make_random_bytes_block
from dsabeamformer.models.weights import make_weights
from dsabeamformer.ops.gemm import beamform_power, device_wire_view
from dsabeamformer.ops.quantize import quantize_weights
from dsabeamformer.pipeline import SyntheticSource, run_stream


def device_record() -> dict:
    """The device a measurement ran on, as JAX reports it."""
    dev = jax.devices()[0]
    return {"platform": dev.platform, "kind": dev.device_kind,
            "count": len(jax.devices())}


def bench_kernel(cfg: ObsConfig, n_blocks: int = 16, n_distinct: int = 2,
                 repeats: int = 3) -> dict:
    qw = quantize_weights(make_weights(cfg), cfg.weight_mode, cfg.a_compute)
    blocks = [
        jax.device_put(
            device_wire_view(make_random_bytes_block(cfg, seed=s), cfg)
        )
        for s in range(n_distinct)
    ]
    jax.block_until_ready(beamform_power(blocks[0], qw, cfg))  # compile
    best = float("inf")
    for _ in range(repeats):
        t0 = time.perf_counter()
        for i in range(n_blocks):
            out = beamform_power(blocks[i % n_distinct], qw, cfg)
        jax.block_until_ready(out)
        best = min(best, (time.perf_counter() - t0) / n_blocks)
    return {
        "mode": "kernel",
        "config": cfg.name,
        "device": device_record(),
        "ms_per_block": best * 1e3,
        "gb_per_s": cfg.wire_block_bytes / best / 1e9,
        "realtime_factor": cfg.block_duration_s / best,
    }


def bench_stream(cfg: ObsConfig, n_blocks: int = 16, n_distinct: int = 4,
                 depth: int = 4) -> dict:
    qw = quantize_weights(make_weights(cfg), cfg.weight_mode, cfg.a_compute)
    blocks = [make_random_bytes_block(cfg, seed=s) for s in range(n_distinct)]
    # Warm-up run compiles and primes transfers.
    run_stream(cfg, qw, SyntheticSource(cfg, blocks, n_blocks=2), depth=depth)
    src = SyntheticSource(cfg, blocks, n_blocks=n_blocks)
    stats = run_stream(cfg, qw, src, depth=depth)
    rec = stats.record(cfg)
    rec["mode"] = "stream"
    rec["device"] = device_record()
    rec["ms_per_block"] = stats.wall_s / max(stats.n_blocks, 1) * 1e3
    return rec


def run_benchmark(cfg: ObsConfig, n_blocks: int = 16,
                  mode: str = "stream") -> dict:
    if mode == "kernel":
        return bench_kernel(cfg, n_blocks=n_blocks)
    return bench_stream(cfg, n_blocks=n_blocks)
