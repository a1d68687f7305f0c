"""SIGPROC filterbank output — the downstream search stage's native
on-disk format.

The reference hands averaged beam powers to the FRB search stage
through a PSRDADA buffer (SURVEY.md §3 step 6, L7); the search tools
themselves (heimdall, PRESTO, sigproc) natively consume per-beam
``.fil`` files.  This module closes that last gap: ``dsabf run
--fil-dir`` writes one filterbank file per (selected) beam, so the
beamformer's output drops straight into a standard single-pulse /
dedispersion pipeline with no adapter.  (The DADA-style product file
and output ring remain the raw-format paths: `pipeline.FileSink` /
`RingSink`.)

Format (SIGPROC's ``filterbank`` flavor):

- header: ``<i32 len><ascii keyword>`` tokens with little-endian
  binary values (int32 / float64), bracketed by ``HEADER_START`` /
  ``HEADER_END``; payload follows immediately.
- payload: time-major samples, each ``[nifs, nchans]`` float32
  (``nbits=32``); ``nifs=1`` for power products, ``nifs=4`` for
  full-Stokes (I,Q,U,V — SIGPROC's IF axis).
- channels are written in DESCENDING frequency (``fch1`` = highest
  averaged-channel center, ``foff`` < 0) — the convention the
  dedispersion tools assume; the writer flips the channel axis.

This is an output/host path (one transpose+copy of the averaged
product per block, ~1 GB/block at the full dsa10 preset across all 256
beams) — select beams via ``beams=`` / ``--fil-beams`` when the
search only wants a subset.
"""

from __future__ import annotations

import struct
from pathlib import Path
from typing import Dict, Optional, Sequence, Tuple

import numpy as np

from dsabeamformer.config import ObsConfig

__all__ = ["encode_filterbank_header", "FilterbankSink", "read_filterbank",
           "read_filterbank_header", "splice_filterbanks"]

_quant8 = None
_quant8_stokes = None


def _get_quant8():
    """Jitted on-device 8-bit quantizer (lazy: this module is
    otherwise numpy-only).  ``[F', T', B] f32 × [B] scales ->
    uint8`` — the same clip(rint(x*scale)) the host path applies."""
    global _quant8
    if _quant8 is None:
        import jax
        import jax.numpy as jnp

        @jax.jit
        def q(x, s):
            return jnp.clip(jnp.rint(x * s[None, None, :]),
                            0, 255).astype(jnp.uint8)

        _quant8 = q
    return _quant8


# Signed Q/U/V planes ride the unsigned 8-bit payload at this fixed
# midpoint offset (recorded in scales.json; SIGPROC has no field for
# it).  I keeps offset 0 so power-only consumers read it unchanged.
STOKES_QUV_OFFSET = 128.0
_QUV_OFF = None  # [4] f32 per-IF offsets, device-lazy


def _quv_offsets_np():
    import numpy as _np

    return _np.array([0.0] + [STOKES_QUV_OFFSET] * 3, _np.float32)


def _get_quant8_stokes():
    """Stokes variant: ``[F', T', 4, B] f32 × [B] scales -> uint8``
    with the per-IF midpoint offset applied before clipping."""
    global _quant8_stokes
    if _quant8_stokes is None:
        import jax
        import jax.numpy as jnp

        off = jnp.asarray(_quv_offsets_np())

        @jax.jit
        def q(x, s):
            return jnp.clip(
                jnp.rint(x * s[None, None, None, :] + off[None, None, :, None]),
                0, 255).astype(jnp.uint8)

        _quant8_stokes = q
    return _quant8_stokes


def _kw(keyword: str) -> bytes:
    b = keyword.encode("ascii")
    return struct.pack("<i", len(b)) + b


def _kw_int(keyword: str, v: int) -> bytes:
    return _kw(keyword) + struct.pack("<i", int(v))


def _kw_dbl(keyword: str, v: float) -> bytes:
    return _kw(keyword) + struct.pack("<d", float(v))


def _kw_str(keyword: str, v: str) -> bytes:
    return _kw(keyword) + _kw(v)


def _avg_freqs_mhz(cfg: ObsConfig) -> np.ndarray:
    """Center frequencies (MHz) of the navg_freq-averaged output
    channels, ascending — mean of each averaged group's raw centers
    (matches the kernel epilogue's adjacent-channel sum)."""
    f = cfg.freqs_hz().reshape(cfg.n_chan // cfg.navg_freq, cfg.navg_freq)
    return f.mean(axis=1) / 1e6


def encode_filterbank_header(
    cfg: ObsConfig,
    *,
    beam: int,
    nifs: int = 1,
    nbits: int = 32,
    tstart_mjd: float = 0.0,
    source_name: str = "DSABF",
    telescope_id: int = 0,
    machine_id: int = 0,
) -> bytes:
    """SIGPROC filterbank header for one beam of this config's output.

    ``ibeam``/``nbeams`` record the fan position; ``az_start`` carries
    the beam's fan angle (degrees east of boresight) so downstream
    candidates localize to a sky offset without the beam table;
    ``tsamp`` is the averaged output cadence; ``fch1``/``foff``
    describe the DESCENDING channel order the sink writes.
    """
    favg = _avg_freqs_mhz(cfg)
    foff = -(cfg.bandwidth_hz / cfg.n_chan_total * cfg.navg_freq) / 1e6
    return b"".join([
        _kw("HEADER_START"),
        _kw_str("source_name", source_name),
        _kw_int("telescope_id", telescope_id),
        _kw_int("machine_id", machine_id),
        _kw_int("data_type", 1),  # 1 = filterbank
        _kw_dbl("fch1", favg[-1]),  # highest averaged center first
        _kw_dbl("foff", foff),
        _kw_int("nchans", len(favg)),
        _kw_int("nbits", nbits),
        _kw_int("nifs", nifs),
        _kw_dbl("tstart", tstart_mjd),
        _kw_dbl("tsamp", cfg.sample_period_s * cfg.navg_time),
        _kw_int("ibeam", beam),
        _kw_int("nbeams", cfg.n_beams),
        _kw_dbl("src_raj", 0.0),
        _kw_dbl("src_dej", 0.0),
        _kw_dbl("az_start",
                float(np.rad2deg(cfg.beam_angles_rad()[beam]))),
        _kw_dbl("za_start", 0.0),
        _kw("HEADER_END"),
    ])


class FilterbankSink:
    """Per-beam SIGPROC ``.fil`` writer with the pipeline sink API
    (``write(seq, block)`` / ``close()``).

    ``block`` is the device product fetched by the driver:
    ``[F', T', B]`` float32 for power, ``[F', T', 4, B]`` for Stokes
    (``F' = n_chan/navg_freq``, ``T' = t_block/navg_time``).  Each
    selected beam appends ``T'`` samples of ``[nifs, F']`` with the
    channel axis flipped to descending frequency.

    ``nbits=8`` quarters the product IO (full-band dsa10 writes
    ~16 GB/s of float32 across all 256 beams — 8-bit is what real
    search back-ends ingest): samples are ``clip(round(x * scale), 0,
    255)`` uint8.  SIGPROC has no per-block scale field, so ``scale``
    must be constant per file; ``scale="auto"`` calibrates PER BEAM
    from each file's own first block (median mapped to mid-rail 64 —
    a pooled scale would rail an on-source beam's file, measured on
    hardware) and keeps it — fine for the stationary noise floor of a
    drift search, wrong if the first block is pathological (then pass
    an explicit float, e.g. from ``dsabf levels``).  The per-beam
    scales in effect are written to ``<dir>/scales.json`` on close —
    SIGPROC headers have no scale field, so that sidecar is the only
    durable record of the counts-per-unit-power calibration.

    8-bit **Stokes** (nifs=4) stores the signed Q/U/V planes at the
    fixed midpoint offset ``STOKES_QUV_OFFSET`` (=128; recorded in the
    sidecar as ``__quv_offset__``): ``counts = x*scale + offset``,
    with I at offset 0 so intensity-only consumers read it exactly
    like a power file.  The scale is auto-calibrated from the I plane
    — ``|Q|,|U|,|V| <= I`` per sample bounds the signed planes, so
    rails only engage on strongly-polarized bright pixels.

    Dropped/skipped stream blocks (``seq`` gaps) are ZERO-FILLED so
    the file's time axis stays contiguous — SIGPROC consumers
    (heimdall/PRESTO) assume uninterrupted ``tsamp`` sampling, and a
    silent splice would shift every later candidate's time/DM.  Zeros
    are unambiguous flagged data in every payload (real 8-bit data
    sits near mid-rail 64, Q/U/V near their 128 midpoint).
    ``n_splices`` / ``filled_samples`` count what was filled.
    """

    def __init__(
        self,
        dir_path: str | Path,
        cfg: ObsConfig,
        beams: Optional[Sequence[int]] = None,
        products: str = "power",
        tstart_mjd: float = 0.0,
        source_name: str = "DSABF",
        nbits: int = 32,
        scale: float | str = "auto",
    ):
        if products not in ("power", "stokes"):
            raise ValueError(f"unknown products {products!r}")
        if nbits not in (8, 32):
            raise ValueError(f"nbits must be 8 or 32, got {nbits}")
        self.cfg = cfg
        self.nifs = 4 if products == "stokes" else 1
        self._stokes = products == "stokes"
        self.nbits = nbits
        explicit = None if scale == "auto" else float(scale)
        if nbits == 8 and explicit is not None and explicit <= 0:
            raise ValueError("scale must be positive")
        self.beams = (list(range(cfg.n_beams)) if beams is None
                      else sorted(set(int(b) for b in beams)))
        bad = [b for b in self.beams if not 0 <= b < cfg.n_beams]
        if bad:
            raise ValueError(
                f"beam indices {bad} out of range [0, {cfg.n_beams})")
        self._scales: Dict[int, Optional[float]] = {
            b: explicit for b in self.beams}
        self._dev_scales = None
        self._last_seq: Optional[int] = None
        self.n_splices = 0
        self.filled_samples = 0
        d = Path(dir_path)
        d.mkdir(parents=True, exist_ok=True)
        self._dir = d
        self._files = {}
        for b in self.beams:
            f = open(d / f"beam{b:04d}.fil", "wb")
            f.write(encode_filterbank_header(
                cfg, beam=b, nifs=self.nifs, nbits=nbits,
                tstart_mjd=tstart_mjd, source_name=source_name))
            self._files[b] = f

    @property
    def scales(self) -> Dict[int, Optional[float]]:
        """Per-beam 8-bit counts-per-unit-power scales in effect (a
        beam's entry is None until auto-calibration sees its first
        block; empty at 32-bit)."""
        return dict(self._scales) if self.nbits == 8 else {}

    def device_post(self, out_dev, *, warmup: bool = False):
        """Pipeline hook (StreamingBeamformer calls it at dispatch
        when present): quantize the power product to uint8 ON DEVICE
        once per-beam scales are known, so the D2H fetch carries
        1 byte/sample instead of 4 — the output path's bandwidth is
        the fil sink's floor at full beam count.  Returns ``out_dev``
        unchanged at nbits=32 or while auto-calibration still needs a
        float block (the first); ``warmup=True`` compiles the
        quantizer at runtime shapes with dummy scales."""
        if self.nbits != 8:
            return out_dev
        q = _get_quant8_stokes() if self._stokes else _get_quant8()
        if warmup:
            import jax.numpy as jnp

            return q(out_dev, jnp.ones((out_dev.shape[-1],), jnp.float32))
        s = self._device_scale_vec(out_dev.shape[-1])
        if s is None:
            return out_dev
        return q(out_dev, s)

    def fused_quant8_scales(self):
        """Per-beam scale vector for IN-KERNEL 8-bit quantization
        (``beamform_power(quant8_scales=...)``), or None while
        auto-calibration still needs a float block / at nbits=32.

        Preferred over ``device_post`` when the pipeline can use it
        (power products, navg_freq=1): the f32 product then never
        touches HBM — the epilogue stores uint8 directly (saves ~2.1 GB
        of HBM round-trip per full dsa10 block vs kernel-writes-f32 +
        quantizer-pass).  Math and bytes are identical either way."""
        if self.nbits != 8:
            return None
        return self._device_scale_vec(self.cfg.n_beams)

    def _device_scale_vec(self, n_beams: int):
        """[n_beams] f32 scale vector on device, or None until every
        selected beam's auto scale is known (unselected beams get 1.0
        — their quantized values are never written)."""
        if self._dev_scales is None:
            if any(self._scales[b] is None for b in self.beams):
                return None
            import jax

            vec = np.ones(n_beams, np.float32)
            for b, s in self._scales.items():
                vec[b] = s
            self._dev_scales = jax.device_put(vec)
        return self._dev_scales

    def write(self, seq: int, block: np.ndarray) -> None:
        block = np.asarray(block)
        # uint8 means the block was already scaled+clipped on device
        # (device_post) — only the layout work remains here.
        pre_quantized = block.dtype == np.uint8
        if not pre_quantized:
            block = block.astype(np.float32, copy=False)
        if self._stokes:
            # [F', T', 4, B] -> [B, T', 4, F'], channels descending.
            arr = np.transpose(block, (3, 1, 2, 0))[..., ::-1]
        else:
            # [F', T', B] -> [B, T', F'], channels descending.
            arr = np.transpose(block, (2, 1, 0))[..., ::-1]
        t_out = arr.shape[1]
        if self._last_seq is not None and seq > self._last_seq + 1:
            # Stream gap (dropped/skipped blocks): zero-fill to keep
            # the time axis contiguous for dedispersion consumers.
            gap = (seq - self._last_seq - 1) * t_out
            fill = np.zeros(
                (gap,) + arr.shape[2:],
                dtype=np.uint8 if self.nbits == 8 else np.float32)
            for f in self._files.values():
                f.write(fill)
            self.n_splices += 1
            self.filled_samples += gap
        self._last_seq = seq
        for b, f in self._files.items():
            out = arr[b]
            if self.nbits == 8 and not pre_quantized:
                if self._scales[b] is None:
                    # Auto-cal from the Stokes-I plane either way:
                    # |Q|,|U|,|V| <= I per sample, so the I-derived
                    # scale bounds the signed planes too (mid-rail 64
                    # for I; Q/U/V sit near their 128 midpoint at the
                    # usual small polarization fractions).
                    med = float(np.median(out[:, 0, :] if self._stokes
                                          else out))
                    self._scales[b] = 64.0 / med if med > 0 else 1.0
                scaled = out * self._scales[b]
                if self._stokes:
                    scaled = scaled + _quv_offsets_np()[None, :, None]
                out = np.clip(np.rint(scaled), 0, 255).astype(np.uint8)
            # write() takes the buffer directly — one contiguous copy
            # max, no tobytes() duplicate (this is a ~GB/block path).
            f.write(np.ascontiguousarray(out))

    def close(self) -> None:
        for f in self._files.values():
            f.close()
        if self.nbits == 8:
            # The only durable record of the 8-bit calibration (no
            # SIGPROC header field exists for it).
            import json

            rec = {f"beam{b:04d}.fil": s for b, s in self._scales.items()}
            if self._stokes:
                # counts = x*scale + offset (I: 0; Q/U/V: midpoint).
                rec["__quv_offset__"] = STOKES_QUV_OFFSET
            (self._dir / "scales.json").write_text(
                json.dumps(rec, indent=0) + "\n")


def _encode_header_dict(hdr: Dict) -> bytes:
    """SIGPROC header bytes from a parsed header dict (the splice
    path re-emits a merged header; field set mirrors
    ``encode_filterbank_header``)."""
    return b"".join([
        _kw("HEADER_START"),
        _kw_str("source_name", str(hdr.get("source_name", "DSABF"))),
        _kw_int("telescope_id", int(hdr.get("telescope_id", 0))),
        _kw_int("machine_id", int(hdr.get("machine_id", 0))),
        _kw_int("data_type", int(hdr.get("data_type", 1))),
        _kw_dbl("fch1", float(hdr["fch1"])),
        _kw_dbl("foff", float(hdr["foff"])),
        _kw_int("nchans", int(hdr["nchans"])),
        _kw_int("nbits", int(hdr.get("nbits", 32))),
        _kw_int("nifs", int(hdr.get("nifs", 1))),
        _kw_dbl("tstart", float(hdr.get("tstart", 0.0))),
        _kw_dbl("tsamp", float(hdr["tsamp"])),
        _kw_int("ibeam", int(hdr.get("ibeam", 0))),
        _kw_int("nbeams", int(hdr.get("nbeams", 1))),
        _kw_dbl("src_raj", float(hdr.get("src_raj", 0.0))),
        _kw_dbl("src_dej", float(hdr.get("src_dej", 0.0))),
        _kw_dbl("az_start", float(hdr.get("az_start", 0.0))),
        _kw_dbl("za_start", float(hdr.get("za_start", 0.0))),
        _kw("HEADER_END"),
    ])


def read_filterbank_header(path: str | Path) -> Tuple[Dict, int]:
    """Parse only the SIGPROC header -> (header dict, payload offset)
    — the streaming entry point (``dsabf splice`` memmaps payloads
    instead of loading them)."""
    ints = {"telescope_id", "machine_id", "data_type", "nchans", "nbits",
            "nifs", "ibeam", "nbeams", "barycentric", "pulsarcentric"}
    dbls = {"fch1", "foff", "tstart", "tsamp", "src_raj", "src_dej",
            "az_start", "za_start", "refdm", "period"}
    strs = {"source_name", "rawdatafile"}
    hdr: Dict = {}
    with open(path, "rb") as f:
        def rd(n: int) -> bytes:
            b = f.read(n)
            if len(b) != n:  # truncated header -> clean ValueError,
                raise ValueError(   # not struct.error (dsabf fil path)
                    f"truncated SIGPROC header (wanted {n} bytes, "
                    f"got {len(b)})")
            return b

        def rd_kw() -> str:
            (n,) = struct.unpack("<i", rd(4))
            if not 0 < n < 64:
                raise ValueError(f"bad SIGPROC keyword length {n}")
            return rd(n).decode("ascii")

        if rd_kw() != "HEADER_START":
            raise ValueError("not a SIGPROC filterbank file")
        while True:
            kw = rd_kw()
            if kw == "HEADER_END":
                break
            if kw in ints:
                (hdr[kw],) = struct.unpack("<i", rd(4))
            elif kw in dbls:
                (hdr[kw],) = struct.unpack("<d", rd(8))
            elif kw in strs:
                hdr[kw] = rd_kw()
            else:
                raise ValueError(f"unknown SIGPROC keyword {kw!r}")
        nbits = hdr.get("nbits", 32)
        if nbits not in (8, 32):
            raise ValueError(f"only nbits 8/32 payloads supported, "
                             f"got {nbits}")
        return hdr, f.tell()


def read_filterbank(path: str | Path) -> Tuple[Dict, np.ndarray]:
    """Parse a SIGPROC filterbank file -> (header dict, data).

    Data comes back ``[T, nifs, nchans]`` in the file's own
    (descending-frequency) channel order — float32 for nbits=32, uint8
    for nbits=8 (raw counts; divide by the writer's scale to recover
    power units).  Validation/analysis path — loads the whole payload.
    """
    hdr, off = read_filterbank_header(path)
    nbits = hdr.get("nbits", 32)
    with open(path, "rb") as f:
        f.seek(off)
        data = np.frombuffer(
            f.read(), dtype=np.uint8 if nbits == 8 else np.float32)
    nifs, nchans = hdr.get("nifs", 1), hdr["nchans"]
    return hdr, data.reshape(-1, nifs, nchans)


def splice_filterbanks(paths, out_path: str | Path,
                       chunk_samples: int = 4096) -> Dict:
    """Merge per-subband ``.fil`` files into one full-band file — the
    downstream step of the ``dsabf launch`` per-subband deployment
    (each child writes its own band slice; the search stage wants one
    file).  Files may be given in any order; they are sorted by
    frequency and must tile the band contiguously with identical
    tsamp/tstart/nifs/nbits/beam.  Payloads are memmapped and spliced
    in bounded chunks, so full-scale products never load whole.
    Returns the merged header.  Trailing samples beyond the SHORTEST
    file are dropped (a straggler subband otherwise desynchronizes
    the time axis), with the drop count in ``_dropped_samples``.
    """
    paths = list(paths)
    if not paths:
        raise ValueError("cannot splice: no input files given")
    out_res = Path(out_path).resolve()
    metas = []
    for p in paths:
        if Path(p).resolve() == out_res:
            # Truncating a memmapped input would destroy the recorded
            # subband and SIGBUS mid-splice.
            raise ValueError(f"cannot splice: --out {out_path} is also "
                             f"an input")
        hdr, off = read_filterbank_header(p)
        metas.append((hdr, off, Path(p)))
    # Optional keys compare with the reader's defaults applied (a
    # foreign file legally omits nifs/ibeam/etc.).
    defaults = {"tstart": 0.0, "nifs": 1, "nbits": 32, "ibeam": 0}
    for k in ("tsamp", "tstart", "nifs", "nbits", "foff", "ibeam"):
        vals = {m[0].get(k, defaults.get(k)) for m in metas}
        if len(vals) != 1:
            raise ValueError(f"cannot splice: {k} differs across inputs "
                             f"({sorted(map(str, vals))})")
    foff = metas[0][0]["foff"]
    if foff == 0:
        raise ValueError("cannot splice: foff is 0 (no channel axis)")
    # File order follows the channel direction: descending-frequency
    # files (dsabf's convention, foff<0) lead with the highest fch1;
    # ascending foreign files with the lowest.
    metas.sort(key=lambda m: m[0]["fch1"], reverse=foff < 0)
    h0 = metas[0][0]
    nbits = h0.get("nbits", 32)
    itemsize = 1 if nbits == 8 else 4
    nifs = h0.get("nifs", 1)
    for (ha, _, pa), (hb, _, pb) in zip(metas, metas[1:]):
        expect = ha["fch1"] + ha["nchans"] * ha["foff"]
        if abs(hb["fch1"] - expect) > 1e-6 * abs(ha["foff"]) + 1e-9:
            raise ValueError(
                f"cannot splice: {pb.name} starts at {hb['fch1']} MHz, "
                f"expected {expect} MHz after {pa.name} (bands must "
                f"tile contiguously)")
    if nbits == 8:
        # Each 8-bit subband file was quantized with ITS OWN
        # counts-per-unit-power scale (per-beam auto-cal, recorded in
        # the sibling scales.json).  Splicing different scales gives a
        # stepped bandpass in counts — surface them so the caller can
        # warn / the operator can re-run with an explicit --fil-scale.
        import json as _json

        scales = []
        for hdr, off, p in metas:
            side = p.parent / "scales.json"
            try:
                scales.append(_json.loads(side.read_text()).get(p.name))
            except (OSError, ValueError):
                scales.append(None)
        if None not in scales:
            lo, hi = min(scales), max(scales)
            # None = known-consistent; a list = warn (values or None
            # entries for missing sidecars — unknown is NOT consistent).
            merged_scales = scales if hi > lo * 1.01 else None
        else:
            merged_scales = scales
    maps = []
    n_samps = []
    for hdr, off, p in metas:
        row = hdr.get("nifs", 1) * hdr["nchans"]
        n = (p.stat().st_size - off) // (row * itemsize)
        n_samps.append(n)
        maps.append(np.memmap(p, dtype=np.uint8 if nbits == 8
                              else np.float32, mode="r", offset=off,
                              shape=(n, nifs, hdr["nchans"])))
    t_out = min(n_samps)
    merged = dict(h0, nchans=sum(m[0]["nchans"] for m in metas))
    with open(out_path, "wb") as f:
        f.write(_encode_header_dict(merged))
        for t0 in range(0, t_out, chunk_samples):
            t1 = min(t0 + chunk_samples, t_out)
            f.write(np.ascontiguousarray(np.concatenate(
                [m[t0:t1] for m in maps], axis=2)))
    merged["_dropped_samples"] = int(max(n_samps) - t_out)
    merged["_n_samples"] = int(t_out)
    if nbits == 8:
        merged["_subband_scales"] = merged_scales  # None = consistent
        if merged_scales is None:
            # Consistent scale: carry the calibration forward — the
            # sidecar is the only durable record of counts-per-unit-
            # power (and the Q/U/V offset).  Merge into any existing
            # sidecar in the output directory rather than clobbering.
            import json as _json

            out_p = Path(out_path)
            side_p = out_p.parent / "scales.json"
            rec = {}
            try:
                rec = _json.loads(side_p.read_text())
            except (OSError, ValueError):
                pass
            rec[out_p.name] = scales[0]
            for hdr, off, p in metas:
                try:
                    src = _json.loads(
                        (p.parent / "scales.json").read_text())
                except (OSError, ValueError):
                    continue
                if "__quv_offset__" in src:
                    rec["__quv_offset__"] = src["__quv_offset__"]
            side_p.write_text(_json.dumps(rec, indent=0) + "\n")
    return merged
