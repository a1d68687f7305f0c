"""Observation configuration.

Replacement for the reference's compile-time constant header
(SURVEY.md L0/C2: ``N_BEAMS``/``N_ANTENNAS``/``N_FREQUENCIES``/
``N_AVERAGING`` C preprocessor macros in ``beamformer.h``): one frozen
dataclass consumed as a jit-static argument, so changing the array
geometry re-traces instead of re-compiling C code.

Wire format
-----------
The on-wire voltage sample is the reference's "4R4I" byte: a packed
complex integer with the **real part in the high nibble** and the
**imaginary part in the low nibble**, each a 4-bit two's-complement value
in [-8, 7] (SURVEY.md §0 step 2).  A wire *block* is a uint8 array in one
of two layouts:

- ``"tfpa"`` — ``[T, F, P, A]`` (time-major): the order a packet capture
  naturally produces, matching the reference's need for a corner-turn
  (SURVEY.md L3).
- ``"ftpa"`` — ``[F, T, P, A]`` (channel-major): the GEMM-friendly order;
  per-channel time series are contiguous.

``A`` is the zero-padded antenna axis (the GEMM contraction dim) and
``P`` the polarization axis; only ``n_ant_active`` antennas carry signal.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np

SPEED_OF_LIGHT_M_S = 299_792_458.0

#: Cold-plasma dispersion: delay_s = DM_CONST_S * DM[pc cm^-3] * f[MHz]^-2
#: (shared by the pulse generator and the quick-look dedisperser).
DM_CONST_S = 4.148808e3


def dm_delays_s(f_mhz, dm: float, ref_mhz: float):
    """Cold-plasma arrival delays [s] of channels ``f_mhz`` relative
    to ``ref_mhz`` (conventionally the top of the band, which arrives
    first).  THE one definition of the curve — the pulse generator and
    the quick-look dedisperser must stay aligned through it."""
    f = np.asarray(f_mhz, np.float64)
    return DM_CONST_S * dm * (f ** -2.0 - float(ref_mhz) ** -2.0)


@dataclasses.dataclass(frozen=True)
class ObsConfig:
    """Static observation configuration.

    Instances are hashable and immutable so they can be passed as
    ``jax.jit`` static arguments.
    """

    name: str = "dsa10"
    # --- array geometry (reference: beamformer.h constants, SURVEY.md C2) ---
    n_ant: int = 64            # padded GEMM contraction (K) dim
    n_ant_active: int = 10     # physical dishes carrying signal
    n_beams: int = 256
    n_chan: int = 2048         # channels processed by this instance
    n_chan_total: int = 2048   # channels in the full band (sets sample rate)
    n_pol: int = 2
    # --- streaming block geometry ---
    t_block: int = 2048        # time samples per ingest block
    navg_time: int = 16        # post-detection time averaging (reference N_AVERAGING)
    navg_freq: int = 1         # optional adjacent-channel averaging
    # --- band / beam geometry ---
    f_start_hz: float = 1.28e9
    bandwidth_hz: float = 250e6
    beam_span_deg: float = 2.6   # full fan width, beams uniform in sin(theta)
    # --- numerics ---
    weight_mode: str = "int8x2"  # one of: int13 | int12 | int8x2 | int8
                                 #         | bf16 | bf16x2 | f32
    n_ant_compute: int = 0       # antennas the GEMM contracts over; 0 = auto
                                 # (n_ant_active rounded up to 32 — or 16
                                 # for int13, see a_compute — capped at
                                 # n_ant).  Wire slots >= this index MUST be
                                 # zero (they are in the reference's padded
                                 # 4R4I format, SURVEY.md §0), so dropping
                                 # them from K changes nothing numerically
                                 # while skipping tensor-core work and
                                 # unpack spent on structural zeros.
    input_layout: str = "tfpa"   # wire layout delivered by the capture
                                 # stage.  'tfpa' (time-major) is read
                                 # time-major by the kernel: each program
                                 # loads its channel's rows, so the
                                 # corner-turn is never materialized

    def __post_init__(self):
        if self.n_pol != 2:
            raise ValueError("n_pol must be 2 (wire format and epilogue assume dual pol)")
        if self.n_ant_active > self.n_ant:
            raise ValueError("n_ant_active must be <= n_ant")
        if self.t_block % self.navg_time:
            raise ValueError("t_block must be a multiple of navg_time")
        if self.n_chan % self.navg_freq:
            raise ValueError("n_chan must be a multiple of navg_freq")
        if self.weight_mode not in ("int13", "int12", "int8x2", "int8",
                                    "bf16", "bf16x2", "f32"):
            raise ValueError(f"unknown weight_mode: {self.weight_mode}")
        if self.input_layout not in ("tfpa", "ftpa"):
            raise ValueError(f"unknown input_layout: {self.input_layout}")
        if self.n_ant_compute:
            if self.n_ant_compute % 8:
                raise ValueError("n_ant_compute must be a multiple of 8")
            if not (self.n_ant_active <= self.n_ant_compute <= self.n_ant):
                raise ValueError(
                    "n_ant_compute must satisfy "
                    "n_ant_active <= n_ant_compute <= n_ant"
                )

    # ------------------------------------------------------------------ #
    # Derived quantities
    # ------------------------------------------------------------------ #

    @property
    def sample_period_s(self) -> float:
        """Per-channel complex sample period of the critically-sampled
        channelizer (DSA-10: 2048 ch / 250 MHz = 8.192 us)."""
        return self.n_chan_total / self.bandwidth_hz

    @property
    def block_duration_s(self) -> float:
        return self.t_block * self.sample_period_s

    @property
    def wire_block_shape(self) -> Tuple[int, int, int, int]:
        if self.input_layout == "tfpa":
            return (self.t_block, self.n_chan, self.n_pol, self.n_ant)
        return (self.n_chan, self.t_block, self.n_pol, self.n_ant)

    @property
    def wire_block_bytes(self) -> int:
        return self.t_block * self.n_chan * self.n_pol * self.n_ant

    @property
    def device_wire_shape(self) -> Tuple[int, ...]:
        """The canonical DEVICE-side wire block shape — what the driver
        should ``device_put`` (a free host-side view of the 4-D capture
        buffer, same bytes).

        Row-major, like the 4-D form, so the two are free reshapes of
        each other on the device too.

        - ``ftpa``: ``[F, T, P*A]`` — channel-major rows.
        - ``tfpa``: ``[T, F*P*A]`` — time-major rows, as captured.
        """
        pa = self.n_pol * self.n_ant
        if self.input_layout == "tfpa":
            return (self.t_block, self.n_chan * pa)
        return (self.n_chan, self.t_block, pa)

    @property
    def out_block_shape(self) -> Tuple[int, int, int]:
        """[F/navg_f, T/navg_t, B] float32 averaged beam powers."""
        return (
            self.n_chan // self.navg_freq,
            self.t_block // self.navg_time,
            self.n_beams,
        )

    @property
    def realtime_bytes_per_s(self) -> float:
        """Wire byte rate of a 1x real-time stream for this config."""
        return self.wire_block_bytes / self.block_duration_s

    def freqs_hz(self) -> np.ndarray:
        """Center frequency of each channel processed by this instance.

        A subband instance (``n_chan < n_chan_total``) can be offset via
        ``subband(start)``; the base config covers the band start.
        """
        df = self.bandwidth_hz / self.n_chan_total
        return self.f_start_hz + df * (np.arange(self.n_chan) + 0.5)

    def beam_angles_rad(self) -> np.ndarray:
        """Beam steering angles, uniform in sin(theta) across the fan."""
        half = np.sin(np.deg2rad(self.beam_span_deg / 2.0))
        s = np.linspace(-half, half, self.n_beams)
        return np.arcsin(s)

    def subband(self, chan_start: int, n_chan: int) -> "ObsConfig":
        """Config for a contiguous subband slice (multi-chip sharding)."""
        df = self.bandwidth_hz / self.n_chan_total
        return dataclasses.replace(
            self,
            n_chan=n_chan,
            f_start_hz=self.f_start_hz + chan_start * df,
        )

    def replace(self, **kw) -> "ObsConfig":
        return dataclasses.replace(self, **kw)

    @property
    def a_compute(self) -> int:
        """Resolved GEMM antenna count (see ``n_ant_compute``).

        Auto mode rounds the active count up to 32, except ``int13``
        which rounds to 16 (its double fold multiplies K by 8; DSA-10's
        10 active paths fit).  Both are steps the int8 tensor cores
        take: their products run K in steps of 32 bytes, and the fused
        kernel's Triton blocks want powers of two."""
        if self.n_ant_compute:
            return self.n_ant_compute
        mult = 16 if self.weight_mode == "int13" else 32
        return min(self.n_ant, -(-self.n_ant_active // mult) * mult)

    @property
    def gemm_k(self) -> int:
        """Contraction length of each weight term's GEMM: the complex
        K-concatenation gives 2*A rows; int12 additionally concatenates
        its hi/lo sub-terms along K (the x16 data trick, ops/quantize.py)
        for 4*A rows in a single term, and int13 repeats the fold for
        8*A rows."""
        mult = {"int12": 4, "int13": 8}.get(self.weight_mode, 2)
        return mult * self.a_compute

    # Operation accounting for roofline metrics (SURVEY.md §6): per
    # weight term the GEMM is [P*T, gemm_k] @ [gemm_k, 2B] per channel.
    @property
    def macs_per_block(self) -> int:
        """Real multiply-accumulates per block for ONE weight term."""
        return (self.n_pol * self.t_block * self.gemm_k
                * 2 * self.n_beams * self.n_chan)

    @property
    def n_weight_terms(self) -> int:
        return 2 if self.weight_mode in ("int8x2", "bf16x2") else 1


# --------------------------------------------------------------------- #
# Presets (BASELINE.json configs)
# --------------------------------------------------------------------- #

#: DSA-10 full band on one card: 64 ant (10 active), 256 beams, 2048 chan.
#: t_block=8192 (67 ms of sky, 2.1 GB wire): large blocks amortize the
#: fixed per-dispatch cost of each block step; latency is irrelevant at
#: FRB-search timescales and device memory holds depth+1 blocks
#: comfortably.
DSA10 = ObsConfig(name="dsa10", t_block=8192)

#: DSA-10 with a COMPACT 16-slot wire: same science (10 active dishes,
#: 256 beams, 2048 chan) but the capture packs antennas into 16 slots
#: instead of the reference's 64, cutting the full-band wire rate from
#: 32 GB/s to 8 GB/s — inside a real host's PCIe budget.  Use when
#: the capture stage is ours to configure; `dsa10` remains the
#: reference-format-compatible preset.
DSA10_COMPACT = DSA10.replace(name="dsa10c", n_ant=16)

#: DSA-110 scale-out config: 110 ant padded to 128, 512 beams
#: (BASELINE.json configs[4]); channel-sharded across a mesh of cards.
DSA110 = ObsConfig(
    name="dsa110",
    n_ant=128,
    n_ant_active=110,
    n_beams=512,
    n_chan=2048,
    n_chan_total=2048,
    # t_block=4096 (34 ms of sky): 4.3 GB of wire and 2.1 GB of output
    # per in-flight block at 8192 would make depth-2 streaming tight at
    # full band on one card; 4096 halves that.
    t_block=4096,
)

#: Tiny geometry for CPU unit tests and quick end-to-end drives.
TINY = ObsConfig(
    name="tiny",
    n_ant=16,
    n_ant_active=6,
    n_beams=32,
    n_chan=8,
    n_chan_total=8,
    t_block=64,
    navg_time=16,
    f_start_hz=1.4e9,
    bandwidth_hz=250e6,
)


def presets() -> dict:
    return {"dsa10": DSA10, "dsa10c": DSA10_COMPACT, "dsa110": DSA110,
            "tiny": TINY}

