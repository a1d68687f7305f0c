"""Stream-header encode/parse and PSRDADA file interop.

Reference behavior (SURVEY.md L1, §3.1): a PSRDADA stream starts with a
text header of ``KEY value`` lines (observation parameters), parsed once
to sanity-check against the compiled-in constants.  The rebuild keeps
the same convention on the dsaring header area, generated from and
validated against ``ObsConfig``.

PSRDADA *file* interop (SURVEY.md L1/C3 capability parity): a recorded
DADA file is a fixed-size ASCII header block (``HDR_SIZE`` bytes,
traditionally 4096) followed by raw sample data.  ``read_dada_file``
parses such a header — accepting both the standard PSRDADA keys
(NBIT/NDIM/NPOL/NCHAN/NANT/FREQ [MHz, band centre]/BW [MHz]/TSAMP
[us]/ORDER) and this package's native keys — and maps it onto an
``ObsConfig`` so a real observatory capture can feed ``dsabf run
--input-file x.dada`` directly.
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict, Tuple

from dsabeamformer.config import ObsConfig

_HEADER_VERSION = "1.0"

#: Traditional PSRDADA header block size.
DADA_HDR_SIZE = 4096


def encode_header(cfg: ObsConfig, **extra) -> str:
    kv = {
        "HDR_VERSION": _HEADER_VERSION,
        "INSTRUMENT": "dsabeamformer",
        "CONFIG": cfg.name,
        "NANT": cfg.n_ant,
        "NANT_ACTIVE": cfg.n_ant_active,
        "NBEAM": cfg.n_beams,
        "NCHAN": cfg.n_chan,
        "NCHAN_TOTAL": cfg.n_chan_total,
        "NPOL": cfg.n_pol,
        "TBLOCK": cfg.t_block,
        "NAVG_TIME": cfg.navg_time,
        "NAVG_FREQ": cfg.navg_freq,
        "FREQ_START_HZ": repr(cfg.f_start_hz),
        "BW_HZ": repr(cfg.bandwidth_hz),
        "ORDER": cfg.input_layout.upper(),
        "BLOCK_BYTES": cfg.wire_block_bytes,
    }
    kv.update(extra)
    return "".join(f"{k} {v}\n" for k, v in kv.items())


def parse_header(text: str) -> Dict[str, str]:
    out: Dict[str, str] = {}
    for line in text.splitlines():
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        parts = line.split(None, 1)
        if len(parts) == 2:
            out[parts[0]] = parts[1]
    return out


def config_from_dada_header(h: Dict[str, str],
                            base: ObsConfig) -> ObsConfig:
    """Map a parsed DADA header onto an ObsConfig.

    Geometry/band keys present in the header override ``base``; fields
    a capture header cannot know (beam count, averaging, kernel tiles)
    come from ``base``.  Standard PSRDADA conventions honored: FREQ is
    the band-centre frequency in MHz, BW in MHz, TSAMP in microseconds,
    NBIT=4 + NDIM=2 is the packed 4R4I complex sample.
    """
    kw = {}
    if "NBIT" in h and int(h["NBIT"]) != 4:
        raise ValueError(f"DADA stream has NBIT={h['NBIT']}; the 4R4I "
                         f"wire format requires NBIT=4")
    if "NDIM" in h and int(h["NDIM"]) != 2:
        raise ValueError(f"DADA stream has NDIM={h['NDIM']}; complex "
                         f"voltages require NDIM=2")
    if "NANT" in h:
        kw["n_ant"] = int(h["NANT"])
    if "NANT_ACTIVE" in h:
        kw["n_ant_active"] = int(h["NANT_ACTIVE"])
    elif "NANT" in h and int(h["NANT"]) != base.n_ant:
        # Without an active count, assume every slot carries signal.
        kw["n_ant_active"] = int(h["NANT"])
    if "NPOL" in h:
        kw["n_pol"] = int(h["NPOL"])
    if "NCHAN" in h:
        kw["n_chan"] = int(h["NCHAN"])
    if "NBEAM" in h:
        kw["n_beams"] = int(h["NBEAM"])
    if "TBLOCK" in h:
        kw["t_block"] = int(h["TBLOCK"])
    if "NAVG_TIME" in h:
        kw["navg_time"] = int(h["NAVG_TIME"])
    if "NAVG_FREQ" in h:
        kw["navg_freq"] = int(h["NAVG_FREQ"])
    if "ORDER" in h:
        order = h["ORDER"].strip().lower()
        if order not in ("tfpa", "ftpa"):
            raise ValueError(f"unsupported DADA ORDER {h['ORDER']!r} "
                             f"(expected TFPA or FTPA)")
        kw["input_layout"] = order
    # Band geometry: native Hz keys win; else standard MHz keys.
    if "BW_HZ" in h:
        kw["bandwidth_hz"] = float(h["BW_HZ"])
    elif "BW" in h:
        kw["bandwidth_hz"] = abs(float(h["BW"])) * 1e6
    n_chan = kw.get("n_chan", base.n_chan)
    if "NCHAN_TOTAL" in h:
        kw["n_chan_total"] = int(h["NCHAN_TOTAL"])
    elif "TSAMP" in h:
        # TSAMP [us] = n_chan_total / bandwidth for a critically-sampled
        # channelizer — recover the full-band channel count.
        bw = kw.get("bandwidth_hz", base.bandwidth_hz)
        kw["n_chan_total"] = int(round(float(h["TSAMP"]) * 1e-6 * bw))
    elif n_chan != base.n_chan:
        kw["n_chan_total"] = n_chan
    if "FREQ_START_HZ" in h:
        kw["f_start_hz"] = float(h["FREQ_START_HZ"])
    elif "FREQ" in h:
        # PSRDADA FREQ = band centre in MHz for the channels in the
        # stream; recover the band start edge.
        bw_stream = (kw.get("bandwidth_hz", base.bandwidth_hz)
                     * n_chan / kw.get("n_chan_total", base.n_chan_total))
        kw["f_start_hz"] = float(h["FREQ"]) * 1e6 - bw_stream / 2.0
    return base.replace(**kw) if kw else base


def read_dada_file(path: str | Path,
                   base: ObsConfig) -> Tuple[ObsConfig, Dict[str, str], int]:
    """Parse a DADA file's header block.

    Returns ``(cfg, header, data_offset)`` where ``cfg`` is ``base``
    overridden by the header's geometry and ``data_offset`` is where
    the raw samples start (the header's own HDR_SIZE, default 4096).
    """
    with open(path, "rb") as f:
        head = f.read(DADA_HDR_SIZE)
    text = head.split(b"\0", 1)[0].decode("ascii", errors="replace")
    h = parse_header(text)
    hdr_size = int(h.get("HDR_SIZE", DADA_HDR_SIZE))
    if hdr_size > DADA_HDR_SIZE:
        with open(path, "rb") as f:
            text = f.read(hdr_size).split(b"\0", 1)[0].decode(
                "ascii", errors="replace")
        h = parse_header(text)
    return config_from_dada_header(h, base), h, hdr_size


def read_product_file(path: str | Path):
    """Read a beam-product DADA file written by ``pipeline.FileSink``
    (``PAYLOAD=BEAM_POWERS`` or ``BEAM_STOKES_IQUV``) — the downstream
    consumer's view of ``dsabf run --output-file x.dada``.

    Returns ``(header_dict, powers)`` where ``powers`` is a read-only
    float32 memmap shaped ``[n_blocks, OUT_NCHAN, OUT_NTIME, B]`` for
    powers, ``[n_blocks, OUT_NCHAN, OUT_NTIME, 4, B]`` for Stokes, or
    ``[n_blocks, OUT_NCHAN, OUT_NTIME]`` for the beam-axis-free
    incoherent product (``PAYLOAD=INCOHERENT_POWER``).
    Partial trailing data (a write interrupted mid-block — the
    crash-recovery case a product reader exists for) is dropped; a
    header-only file yields an empty ``[0, ...]`` array.
    """
    import os

    import numpy as np

    # Same extended-header handling as read_dada_file: re-read when the
    # header declares itself larger than the default 4096.
    with open(path, "rb") as f:
        head = f.read(DADA_HDR_SIZE)
    h = parse_header(head.split(b"\0", 1)[0].decode("ascii",
                                                    errors="replace"))
    hdr_size = int(h.get("HDR_SIZE", DADA_HDR_SIZE))
    if hdr_size > DADA_HDR_SIZE:
        with open(path, "rb") as f:
            h = parse_header(f.read(hdr_size).split(b"\0", 1)[0].decode(
                "ascii", errors="replace"))
    payload = h.get("PAYLOAD", "")
    if payload not in ("BEAM_POWERS", "BEAM_STOKES_IQUV",
                       "INCOHERENT_POWER"):
        raise ValueError(
            f"{path}: PAYLOAD={payload!r} is not a beam-product file"
        )
    shape = [int(h["OUT_NCHAN"]), int(h["OUT_NTIME"])]
    if payload == "BEAM_STOKES_IQUV":
        shape.append(int(h.get("OUT_NSTOKES", 4)))
    if payload != "INCOHERENT_POWER":  # incoherent has no beam axis
        shape.append(int(h["OUT_NBEAM"]))
    per_block = int(np.prod(shape))
    payload_bytes = max(os.path.getsize(path) - hdr_size, 0)
    n_blocks = payload_bytes // (per_block * 4)
    if n_blocks == 0:
        return h, np.empty((0, *shape), np.float32)
    data = np.memmap(path, dtype=np.uint8, mode="r", offset=hdr_size,
                     shape=(n_blocks * per_block * 4,))
    powers = data.view(np.float32).reshape(n_blocks, *shape)
    return h, powers


def is_dada_file(path: str | Path) -> bool:
    """Sniff: does the file start with a DADA-style ASCII header?"""
    try:
        with open(path, "rb") as f:
            head = f.read(512)
    except OSError:
        return False
    text = head.split(b"\0", 1)[0].decode("ascii", errors="replace")
    h = parse_header(text)
    return "HDR_VERSION" in h or "HDR_SIZE" in h or (
        "NCHAN" in h and "NBIT" in h
    )


def write_dada_file(path: str | Path, cfg: ObsConfig, blocks,
                    hdr_size: int = DADA_HDR_SIZE, **extra) -> None:
    """Write a DADA file: padded ASCII header + raw wire blocks
    (round-trip/test tooling; the standard MHz/us keys are included so
    other PSRDADA consumers can read the geometry)."""
    df = cfg.bandwidth_hz / cfg.n_chan_total
    centre_hz = cfg.f_start_hz + cfg.n_chan * df / 2.0
    text = encode_header(
        cfg,
        HDR_SIZE=hdr_size,
        NBIT=4,
        NDIM=2,
        FREQ=repr(centre_hz / 1e6),
        BW=repr(cfg.n_chan * df / 1e6),
        TSAMP=repr(cfg.sample_period_s * 1e6),
        **extra,
    ).encode("ascii")
    if len(text) > hdr_size:
        raise ValueError("header exceeds HDR_SIZE")
    import numpy as np

    with open(path, "wb") as f:
        f.write(text.ljust(hdr_size, b"\0"))
        for b in blocks:
            f.write(np.ascontiguousarray(b, dtype=np.uint8).tobytes())


def validate_header(cfg: ObsConfig, text: str) -> None:
    """Raise ValueError if the stream header disagrees with the config
    (the reference's start-of-stream sanity check)."""
    h = parse_header(text)
    checks = {
        "NANT": cfg.n_ant,
        "NBEAM": cfg.n_beams,
        "NCHAN": cfg.n_chan,
        "NPOL": cfg.n_pol,
        "TBLOCK": cfg.t_block,
        "BLOCK_BYTES": cfg.wire_block_bytes,
        "ORDER": cfg.input_layout.upper(),
    }
    for key, want in checks.items():
        if key not in h:
            raise ValueError(f"stream header missing {key}")
        if str(h[key]) != str(want):
            raise ValueError(
                f"stream header {key}={h[key]} != config {want} "
                f"(config {cfg.name!r})"
            )
