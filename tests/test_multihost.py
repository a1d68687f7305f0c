"""Multi-host fan-out plan tests (SURVEY.md §5 distributed backend —
the subband arithmetic is plain host logic, testable without a pod)."""

import pytest

from dsabeamformer.config import DSA10
from dsabeamformer.parallel.multihost import HostSubband, host_subbands


def test_subbands_partition_band():
    subs = host_subbands(DSA10, 4)
    assert len(subs) == 4
    covered = []
    for s in subs:
        covered.extend(range(s.chan_start, s.chan_start + s.n_chan))
    assert covered == list(range(DSA10.n_chan))


def test_subband_config_frequencies():
    subs = host_subbands(DSA10, 8)
    cfg2 = subs[2].config(DSA10)
    assert cfg2.n_chan == DSA10.n_chan // 8
    df = DSA10.bandwidth_hz / DSA10.n_chan_total
    expected_start = DSA10.f_start_hz + subs[2].chan_start * df
    assert abs(cfg2.f_start_hz - expected_start) < 1e-3
    # Subband channel freqs are the matching slice of the full band's.
    full = DSA10.freqs_hz()
    sub = cfg2.freqs_hz()
    import numpy as np

    np.testing.assert_allclose(
        sub, full[subs[2].chan_start : subs[2].chan_start + cfg2.n_chan]
    )


def test_indivisible_hosts_rejected():
    with pytest.raises(ValueError):
        host_subbands(DSA10, 7)

def _run_pod(n_proc: int, n_dev: int, preset: str, timeout_s: float = 300,
             mode: str = "step"):
    """Spawn an n_proc x n_dev CPU 'pod' of multihost_worker.py processes
    and assert every one golden-checks its shards."""
    import os
    import socket
    import subprocess
    import sys
    from pathlib import Path

    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    coord = f"localhost:{port}"
    worker = Path(__file__).parent / "multihost_worker.py"
    env = dict(os.environ)
    env.update(JAX_PLATFORMS="cpu")
    env["PYTHONPATH"] = str(Path(__file__).resolve().parents[1]) + (
        os.pathsep + env["PYTHONPATH"] if env.get("PYTHONPATH") else ""
    )
    procs = [
        subprocess.Popen(
            [sys.executable, str(worker), coord, str(n_proc), str(pid),
             str(n_dev), preset, mode],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True,
        )
        for pid in range(n_proc)
    ]
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=timeout_s)
            outs.append(out)
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        raise
    for pid, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"proc {pid} failed:\n{out[-3000:]}"
        assert f"proc {pid} OK" in out


def test_multihost_runtime_two_processes(tmp_path):
    """The real jax.distributed runtime path (multihost.py:
    initialize_multihost / my_subband / make_array_from_process_local_data
    assembly): 2 processes x 2 CPU devices run the global channel-sharded
    step and golden-check their local output shards."""
    _run_pod(2, 2, "tiny")


def test_multihost_runtime_deployment_shape(tmp_path):
    """The DSA-110 deployment shape (VERDICT r3 #4): 4 processes x 2
    devices = an 8-slot global channel mesh with the 128-antenna
    K dim and the 2048-total band frame, per-host subband ingest,
    golden-checked shards, and the band-power psum crossing process
    boundaries."""
    _run_pod(4, 2, "dsa110s", timeout_s=420)


def test_multihost_streaming_with_update(tmp_path):
    """STREAMING through the multi-process mesh (VERDICT r4 #6): each
    of 4 processes feeds its own subband for 8 blocks through
    ``MultihostMeshStreamingBeamformer``
    (``make_array_from_process_local_data`` per block), with one
    mid-stream re-sharded weight update; each host golden-checks its
    local subband products in both weight regimes."""
    _run_pod(4, 2, "dsa110s", timeout_s=420, mode="stream")
