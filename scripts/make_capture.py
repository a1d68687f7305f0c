"""Write a DADA capture file of random-bytes wire blocks — fast.

`dsabf simulate --out-file` generates Gaussian noise (minutes per
full-band block on this host); the streamed-throughput measurement
(BENCH.md "Streamed run on hardware") only needs bit-format-valid
bytes, since driver timing is content-independent (same methodology as
bench.py / measure_deployed.py).  This writes `--blocks` blocks cycling
a `--distinct` pool of `make_random_bytes_block` outputs.

  python scripts/make_capture.py --config dsa10 --blocks 6 \
      --distinct 2 --out /dev/shm/dsa10.dada
"""
import argparse
import json
import time

from dsabeamformer.config import presets
from dsabeamformer.ingest import dada
from dsabeamformer.ingest.generator import make_random_bytes_block


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--config", default="dsa10")
    ap.add_argument("--blocks", type=int, default=6)
    ap.add_argument("--distinct", type=int, default=2)
    ap.add_argument("--out", required=True)
    args = ap.parse_args()

    cfg = presets()[args.config]
    t0 = time.perf_counter()
    pool = [make_random_bytes_block(cfg, seed=s)
            for s in range(args.distinct)]
    gen_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    dada.write_dada_file(
        args.out, cfg,
        (pool[i % len(pool)] for i in range(args.blocks)),
    )
    print(json.dumps({
        "out": args.out, "blocks": args.blocks,
        "block_bytes": int(cfg.wire_block_bytes),
        "gen_s": round(gen_s, 1),
        "write_s": round(time.perf_counter() - t0, 1),
    }))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
