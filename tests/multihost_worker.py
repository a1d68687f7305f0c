"""One process of an n-process CPU 'pod' (spawned by test_multihost.py).

Exercises the REAL multi-host runtime path (parallel/multihost.py):
``initialize_multihost`` -> ``my_subband`` -> per-host subband capture
-> ``jax.make_array_from_process_local_data`` assembly of the global
channel-sharded arrays -> the global ``sharded_beamformer`` step ->
per-host golden check of the addressable output shards.  This is the
multi-host deployment shape (each host copies only its own subband; the
network carries no voltage data) executed on n processes x m CPU
devices.

argv: coordinator n_proc pid devices_per_proc preset(tiny|dsa110s) [mode]

mode "step" (default): one global sharded step, golden-checked shards.
mode "stream": the full deployment story (VERDICT r4 #6) — each process
feeds its own subband for 8 blocks through
``MultihostMeshStreamingBeamformer`` with one mid-stream re-sharded
weight update; both weight regimes golden-checked per host.
"""

import sys


def _preset(name: str):
    from dsabeamformer.config import DSA110, TINY

    if name == "tiny":
        return TINY
    if name == "dsa110s":
        # The DSA-110 deployment structure (128-ant K dim, 2048-total
        # band frame) at test scale: 16 channels over the 8-slot global
        # mesh (4 hosts x 2 devices), reduced beams/time for speed.
        return DSA110.replace(
            n_chan=16, n_chan_total=2048, t_block=64, n_beams=64,
        )
    raise SystemExit(f"unknown preset {name!r}")


def run_stream(cfg, pid: int) -> int:
    """Stream 8 blocks through the multi-process mesh with a mid-stream
    re-sharded weight update (the MeshStreamingBeamformer pattern with
    make_array_from_process_local_data per block)."""
    import jax
    import numpy as np

    from dsabeamformer.ingest.generator import make_noise_block
    from dsabeamformer.models.calibration import CalTable
    from dsabeamformer.models.weights import (
        make_weights,
        weights_numpy_golden,
    )
    from dsabeamformer.ops.quantize import quantize_weights
    from dsabeamformer.ops.reference import beamform_block_ref
    from dsabeamformer.parallel.multihost import (
        MultihostMeshStreamingBeamformer,
        my_subband,
    )
    from dsabeamformer.parallel.sharding import make_mesh
    from dsabeamformer.pipeline import CollectSink, SyntheticSource
    from dsabeamformer.utils.testing import relative_power_error

    mesh = make_mesh(len(jax.devices()))
    sub = my_subband(cfg)
    # Capture fan-out: the band is deterministic; each host "receives"
    # only its own subband slice (host capture form [T, F_local, P*A]).
    wire = np.asarray(make_noise_block(cfg, rms=2.0, seed=9))
    local = np.ascontiguousarray(
        wire[:, sub.chan_start : sub.chan_start + sub.n_chan])
    qw0 = quantize_weights(make_weights(cfg), cfg.weight_mode,
                           cfg.a_compute)
    cal = CalTable.random(cfg, seed=5)
    qw1 = quantize_weights(make_weights(cfg, cal=cal), cfg.weight_mode,
                           cfg.a_compute)
    src = SyntheticSource(sub.config(cfg), [local], n_blocks=8)
    sink = CollectSink()
    bf = MultihostMeshStreamingBeamformer(cfg, qw0, src, sink, mesh=mesh,
                                          depth=2)

    def on_block(bs):
        if bs.block_idx == 2:
            # Every process swaps the same deterministic table at the
            # same loop position — lockstep is preserved.
            bf.update_weights(qw1)

    bf.on_block = on_block
    bf.warmup()
    stats = bf.run()
    assert stats.n_blocks == 8 and len(sink.outputs) == 8, stats
    refs = [
        beamform_block_ref(weights_numpy_golden(cfg, cal=c), wire,
                           cfg.input_layout, cfg.navg_time, cfg.navg_freq)
        for c in (None, cal)
    ]
    fsl = slice(sub.chan_start // cfg.navg_freq,
                (sub.chan_start + sub.n_chan) // cfg.navg_freq)
    r0, r1 = refs[0][fsl], refs[1][fsl]
    first_new = None
    for seq, p in sink.outputs:
        assert p.shape == r0.shape, (p.shape, r0.shape)
        regime = 0 if np.abs(p - r0).max() < np.abs(p - r1).max() else 1
        if regime and first_new is None:
            first_new = seq
        err = relative_power_error(p, r1 if regime else r0)
        assert err <= 1e-3, f"proc {pid} block {seq}: {err:.3e}"
    # Depth-2 pipelining: the update at drain 2 must land in [3, 5],
    # and every later block must stay in the new regime.
    assert first_new is not None and 3 <= first_new <= 5, first_new
    print(f"proc {pid} OK", flush=True)
    return 0


def main() -> int:
    coord, n_proc, pid = sys.argv[1], int(sys.argv[2]), int(sys.argv[3])
    n_dev = int(sys.argv[4]) if len(sys.argv) > 4 else 2
    preset = sys.argv[5] if len(sys.argv) > 5 else "tiny"
    mode = sys.argv[6] if len(sys.argv) > 6 else "step"
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_num_cpu_devices", n_dev)

    from dsabeamformer.parallel.multihost import (
        initialize_multihost,
        my_subband,
    )

    initialize_multihost(coord, n_proc, pid)
    assert jax.process_count() == n_proc, jax.process_count()

    if mode == "stream":
        return run_stream(_preset(preset), pid)

    import numpy as np
    from jax.sharding import NamedSharding, PartitionSpec as P

    from dsabeamformer.ingest.generator import make_noise_block
    from dsabeamformer.models.weights import (
        make_weights,
        weights_numpy_golden,
    )
    from dsabeamformer.ops.quantize import QuantWeights, quantize_weights
    from dsabeamformer.ops.reference import beamform_block_ref
    from dsabeamformer.parallel.sharding import (
        AXIS,
        make_mesh,
        sharded_beamformer,
        sharded_wire_sharding,
    )
    from dsabeamformer.utils.testing import relative_power_error

    cfg = _preset(preset)
    mesh = make_mesh(len(jax.devices()))
    sub = my_subband(cfg)

    # The capture fan-out: the full-band block is deterministic, each
    # host "receives" only its subband slice and stages it in the
    # canonical device form ([T, F_local*P*A] for tfpa wire).
    wire = np.asarray(make_noise_block(cfg, rms=2.0, seed=9))
    pa = cfg.n_pol * cfg.n_ant
    local_wire = np.ascontiguousarray(
        wire[:, sub.chan_start : sub.chan_start + sub.n_chan]
    ).reshape(cfg.t_block, sub.n_chan * pa)
    wire_sh = jax.make_array_from_process_local_data(
        sharded_wire_sharding(cfg, mesh), local_wire
    )

    # Weights are a pure function of config -> each host computes the
    # full table and contributes its channel slice.
    qw_full = quantize_weights(make_weights(cfg), cfg.weight_mode,
                               cfg.a_compute)
    scales = np.asarray(qw_full.scales)
    sl = slice(sub.chan_start, sub.chan_start + sub.n_chan)
    term_sharding = NamedSharding(mesh, P(AXIS, None, None))
    qw = QuantWeights(
        terms=tuple(
            jax.make_array_from_process_local_data(
                term_sharding, np.asarray(t)[sl]
            )
            for t in qw_full.terms
        ),
        scales=jax.make_array_from_process_local_data(
            NamedSharding(mesh, P(AXIS, None)), scales[sl]
        ),
    )

    step = sharded_beamformer(cfg, mesh, with_band_power=True)
    powers, band = step(wire_sh, qw)

    ref = beamform_block_ref(
        weights_numpy_golden(cfg), wire, cfg.input_layout, cfg.navg_time,
        cfg.navg_freq,
    )
    for shard in powers.addressable_shards:
        err = relative_power_error(np.asarray(shard.data), ref[shard.index])
        assert err <= 1e-3, f"proc {pid} shard {shard.index}: {err:.3e}"
    # Band power is the psum across the channel axis -> replicated.
    np.testing.assert_allclose(
        np.asarray(band), ref.sum(axis=(0, 2)), rtol=1e-4
    )
    print(f"proc {pid} OK", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
