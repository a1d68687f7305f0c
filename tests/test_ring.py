"""Native dsaring shared-memory ring buffer tests (SURVEY.md C3 + §5:
drop accounting, skip-ahead overrun policy, header handshake, and a
threaded producer/consumer stress run)."""

import threading
import uuid

import numpy as np
import pytest

from dsabeamformer.ingest.ring import RingBuffer


@pytest.fixture()
def ring_name():
    return f"test-{uuid.uuid4().hex[:8]}"


def test_create_connect_roundtrip(ring_name):
    with RingBuffer(ring_name, create=True, nbufs=4, bufsz=1024) as prod:
        cons = RingBuffer(ring_name)
        assert cons.nbufs == 4 and cons.bufsz == 1024
        blk = np.arange(1024, dtype=np.uint8)
        assert prod.write_block(blk)
        got = cons.read_block(timeout_s=1.0)
        assert got is not None
        seq, data = got
        assert seq == 0
        np.testing.assert_array_equal(data, blk)
        cons.close()


def test_header_handshake(ring_name):
    with RingBuffer(ring_name, create=True, nbufs=2, bufsz=64) as prod:
        prod.write_header("NCHAN 8\nNBEAM 32\n")
        cons = RingBuffer(ring_name)
        assert "NCHAN 8" in cons.read_header()
        cons.close()


def test_writer_drops_when_full(ring_name):
    with RingBuffer(ring_name, create=True, nbufs=2, bufsz=16) as prod:
        blk = np.zeros(16, dtype=np.uint8)
        assert prod.write_block(blk)
        assert prod.write_block(blk)
        assert not prod.write_block(blk)  # full -> dropped
        assert prod.dropped == 1


def test_reader_skip_ahead_latest(ring_name):
    with RingBuffer(ring_name, create=True, nbufs=8, bufsz=16) as prod:
        for i in range(5):
            prod.write_block(np.full(16, i, dtype=np.uint8))
        cons = RingBuffer(ring_name)
        seq, data = cons.read_block(timeout_s=1.0, latest=True)
        assert seq == 4
        assert data[0] == 4
        assert cons.skipped == 4
        cons.close()


def test_eod_ends_stream(ring_name):
    with RingBuffer(ring_name, create=True, nbufs=2, bufsz=16) as prod:
        prod.write_block(np.zeros(16, dtype=np.uint8))
        prod.set_eod()
        cons = RingBuffer(ring_name)
        assert cons.read_block(timeout_s=1.0) is not None
        assert cons.read_block(timeout_s=1.0) is None  # EOD, no more data
        assert cons.eod()
        cons.close()


def test_read_timeout_returns_none(ring_name):
    with RingBuffer(ring_name, create=True, nbufs=2, bufsz=16):
        cons = RingBuffer(ring_name)
        assert cons.read_block(timeout_s=0.05) is None
        cons.close()


def test_wrong_block_size_rejected(ring_name):
    with RingBuffer(ring_name, create=True, nbufs=2, bufsz=16) as prod:
        with pytest.raises(ValueError):
            prod.write_block(np.zeros(17, dtype=np.uint8))


def test_connect_missing_ring_fails():
    with pytest.raises(OSError):
        RingBuffer("definitely-not-there-xyz")


def test_threaded_stress_in_order(ring_name):
    """Producer thread writes 200 sequenced blocks; consumer reads them
    all in order with no corruption (the race-detection stance of
    SURVEY.md §5: stress the only racy surface)."""
    n, bufsz = 200, 4096
    received = []

    with RingBuffer(ring_name, create=True, nbufs=8, bufsz=bufsz) as prod:
        def produce():
            i = 0
            while i < n:
                blk = np.full(bufsz, i % 251, dtype=np.uint8)
                blk[:8] = np.frombuffer(np.int64(i).tobytes(), dtype=np.uint8)
                if prod.write_block(blk):
                    i += 1
            prod.set_eod()

        t = threading.Thread(target=produce)
        t.start()
        cons = RingBuffer(ring_name)
        while True:
            got = cons.read_block(timeout_s=5.0)
            if got is None:
                break
            seq, data = got
            idx = int(np.frombuffer(data[:8].tobytes(), dtype=np.int64)[0])
            assert (data[8:] == idx % 251).all()
            received.append((seq, idx))
        t.join()
        cons.close()

    seqs = [s for s, _ in received]
    idxs = [i for _, i in received]
    assert seqs == list(range(n))
    assert idxs == list(range(n))


def test_reader_counter_advisory(tiny_cfg):
    """The best-effort readers counter: 0 until a handle reads, +1 per
    reading handle, -1 on close — the scan commands' second-consumer
    warning input."""
    import numpy as np

    from dsabeamformer.ingest.ring import RingBuffer

    with RingBuffer("rdrcnt", create=True, nbufs=2, bufsz=64) as ring:
        assert ring.readers == 0
        ring.write_block(np.zeros(64, np.uint8))
        r1 = RingBuffer("rdrcnt")
        assert r1.readers == 0  # attached, not yet reading
        assert r1.read_block(timeout_s=1.0) is not None
        assert ring.readers == 1
        r2 = RingBuffer("rdrcnt")
        ring.write_block(np.zeros(64, np.uint8))
        assert r2.read_block(timeout_s=1.0) is not None
        assert ring.readers == 2
        r1.close()
        assert ring.readers == 1
        r2.close()
        assert ring.readers == 0
