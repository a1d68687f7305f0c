#!/usr/bin/env python
"""North-star benchmark — prints ONE JSON line:

  {"metric": ..., "value": N, "unit": ..., "vs_baseline": N, "device": {...}}

Metric (BASELINE.json): sustained real-time factor beamforming the full
DSA-10 band (64 ant, 256 beams, 2048 chan, dual pol, 4R4I wire format)
on ONE card — unpack + int8 complex GEMM + |B|^2 + 16x time averaging,
the detection kernel's block step.

The measured configuration is the deployed default: the unmodified
DSA10 preset — time-major 'tfpa' wire order (what the capture stage
produces), int8x2 weights (the mode that meets the <=1e-3 accuracy bar
on every input class), t_block=8192 samples.

value = (seconds of telescope data processed) / (wall seconds).
Timing: blocks resident in device memory, n back-to-back dispatches of
the block step (one per block — the streaming driver's shape) closed by
``block_until_ready``.  `dsabf bench --bench-mode stream` measures the
end-to-end ingest path.

vs_baseline: the reference CUDA pipeline was ~order-1x real time per
GPU on its 1/8-band subband (BASELINE.md [K]); we credit it a full 1x
real-time FULL-BAND factor per device (8x generous) and report
value / 1.0.

Needs a GPU: on any other platform it exits non-zero without a result.
Diagnostics — the device as JAX reports it and the card's name and
power limit from nvidia-smi — go to stderr; stdout carries one line.
"""

import json
import subprocess
import sys
import time


def main() -> int:
    import jax

    from dsabeamformer.utils.hostenv import enable_compile_cache

    enable_compile_cache()

    from dsabeamformer.config import DSA10
    from dsabeamformer.ingest.generator import make_random_bytes_block
    from dsabeamformer.models.weights import make_weights
    from dsabeamformer.ops.gemm import beamform_power, device_wire_view
    from dsabeamformer.ops.quantize import quantize_weights
    from dsabeamformer.utils.bench import device_record
    from dsabeamformer.utils.metrics import roofline_share

    dev = device_record()
    if dev["platform"] != "gpu":
        print(f"[bench] no GPU (platform {dev['platform']!r})",
              file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
    ).stdout.strip()
    print(f"[bench] device {dev} card {card!r}", file=sys.stderr)

    cfg = DSA10  # the deployed default, unmodified
    n_blocks = 16
    print(f"[bench] config: mode={cfg.weight_mode} wire={cfg.input_layout} "
          f"t_block={cfg.t_block} a_compute={cfg.a_compute}",
          file=sys.stderr)
    qw = quantize_weights(make_weights(cfg), cfg.weight_mode, cfg.a_compute)
    blocks = [
        jax.device_put(device_wire_view(make_random_bytes_block(cfg, seed=s),
                                        cfg))
        for s in range(2)
    ]

    t0 = time.perf_counter()
    jax.block_until_ready(beamform_power(blocks[0], qw, cfg))
    print(f"[bench] compile+warm {time.perf_counter() - t0:.1f}s",
          file=sys.stderr)

    best = float("inf")
    for rep in range(3):
        t0 = time.perf_counter()
        for i in range(n_blocks):
            out = beamform_power(blocks[i % 2], qw, cfg)
        jax.block_until_ready(out)
        dt = (time.perf_counter() - t0) / n_blocks
        best = min(best, dt)
        print(f"[bench] rep {rep}: {dt * 1e3:.3f} ms/block", file=sys.stderr)

    rt = cfg.block_duration_s / best
    gbs = cfg.wire_block_bytes / best / 1e9
    # Roofline share against the card's published peaks: int8 work over
    # the sliced antenna axis, and the bytes the kernel must move (the
    # wire slots it reads, the weights, the f32 product).
    ops = 2 * cfg.macs_per_block * cfg.n_weight_terms
    moved = (cfg.wire_block_bytes * cfg.a_compute // cfg.n_ant
             + cfg.n_chan * cfg.gemm_k * 2 * cfg.n_beams * cfg.n_weight_terms
             + 4 * cfg.n_chan * cfg.t_block // cfg.navg_time * cfg.n_beams)
    roof = roofline_share(ops, moved, best, dev["kind"])
    print(
        f"[bench] {best * 1e3:.3f} ms/block | {gbs:.2f} GB/s wire | "
        f"{rt:.3f}x realtime | roofline share {roof['share']:.4f} "
        f"({roof['bound']}-bound) on {card}",
        file=sys.stderr,
    )

    print(json.dumps({
        "metric": "dsa10_fullband_realtime_factor_1card",
        "value": round(rt, 3),
        "unit": "x_realtime",
        "vs_baseline": round(rt / 1.0, 3),
        "device": dev,
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
