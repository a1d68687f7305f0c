"""Antenna array layouts.

The reference carries an antenna E-W position table compiled into the
binary / loaded from a file (SURVEY.md C2/C8).  The reference mount was
unreadable at survey time, so the concrete coordinates below are
*synthetic but physically plausible* linear east-west layouts; the
framework treats positions as data, so swapping in surveyed coordinates
is a one-line change (``ArrayLayout(positions_m=...)`` or
``ArrayLayout.load``).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from dsabeamformer.config import ObsConfig


@dataclasses.dataclass(frozen=True)
class ArrayLayout:
    """Antenna coordinates for a phased array.

    ``positions_m`` is the east-west coordinate, length ``n_ant`` (the
    padded GEMM dim); entries beyond the active antennas are zero and
    carry no signal (their wire samples are zero, so their weights are
    irrelevant — but we also zero their calibration gains for hygiene).

    ``positions_ns_m`` (optional north-south coordinate) generalizes to
    2-D station layouts; when None the array is the reference's 1-D
    east-west line and beams form a fan in sin(theta).
    """

    positions_m: np.ndarray  # [n_ant] float64, east-west
    n_active: int
    positions_ns_m: np.ndarray | None = None  # [n_ant] float64, north-south

    @property
    def n_ant(self) -> int:
        return len(self.positions_m)

    @property
    def ns(self) -> np.ndarray:
        if self.positions_ns_m is None:
            return np.zeros_like(self.positions_m)
        return self.positions_ns_m

    @property
    def active_mask(self) -> np.ndarray:
        m = np.zeros(self.n_ant, dtype=bool)
        m[: self.n_active] = True
        return m

    def padded(self, n_ant: int) -> "ArrayLayout":
        """Zero-pad the antenna axis to the config's padded GEMM dim
        (a surveyed table lists only physical dishes)."""
        if n_ant < self.n_ant:
            raise ValueError(
                f"cannot pad {self.n_ant} antennas down to {n_ant}"
            )
        if n_ant == self.n_ant:
            return self
        pos = np.zeros(n_ant, dtype=np.float64)
        pos[: self.n_ant] = self.positions_m
        ns = None
        if self.positions_ns_m is not None:
            ns = np.zeros(n_ant, dtype=np.float64)
            ns[: self.n_ant] = self.positions_ns_m
        return ArrayLayout(positions_m=pos, n_active=self.n_active,
                           positions_ns_m=ns)

    def save(self, path: str) -> None:
        np.savez(path, positions_m=self.positions_m, n_active=self.n_active,
                 positions_ns_m=self.ns)

    @staticmethod
    def load(path: str) -> "ArrayLayout":
        """Load a position table.

        Two formats: the package's ``.npz`` (``save``), or a plain-text
        table (the form observatory position files usually take — the
        reference compiled such a table into its binary, SURVEY.md
        C2/C8): one row per PHYSICAL antenna, 1 column (east-west
        meters) or 2 columns (east-west, north-south); ``#`` comments
        allowed.  Text tables list only active dishes — pad to the
        config's GEMM dim with ``.padded(cfg.n_ant)`` (make_weights
        does this automatically).
        """
        if str(path).endswith(".npz"):
            d = np.load(path)
            ns = None
            if "positions_ns_m" in d and np.any(d["positions_ns_m"]):
                ns = np.asarray(d["positions_ns_m"], dtype=np.float64)
            return ArrayLayout(
                positions_m=np.asarray(d["positions_m"], dtype=np.float64),
                n_active=int(d["n_active"]),
                positions_ns_m=ns,
            )
        table = np.atleast_2d(np.loadtxt(path, comments="#", ndmin=2))
        if table.shape[1] not in (1, 2):
            raise ValueError(
                f"position table {path!r} has {table.shape[1]} columns "
                f"(expected 1 [EW] or 2 [EW, NS])"
            )
        ew = np.ascontiguousarray(table[:, 0], dtype=np.float64)
        ns = (np.ascontiguousarray(table[:, 1], dtype=np.float64)
              if table.shape[1] == 2 and np.any(table[:, 1]) else None)
        return ArrayLayout(positions_m=ew, n_active=len(ew),
                           positions_ns_m=ns)


def linear_array(n_ant: int, n_active: int, spacing_m: float) -> ArrayLayout:
    pos = np.zeros(n_ant, dtype=np.float64)
    pos[:n_active] = np.arange(n_active) * spacing_m
    # Center the active array so beam phases are balanced around 0.
    pos[:n_active] -= pos[:n_active].mean()
    return ArrayLayout(positions_m=pos, n_active=n_active)


def array_for(cfg: ObsConfig) -> ArrayLayout:
    """Default layout for a config preset.

    DSA-10: 10 dishes on an E-W line, ~5 m pitch (4.5 m dishes).
    DSA-110: 110 dishes, same pitch class.  Synthetic coordinates — see
    module docstring.
    """
    spacing = 5.0
    return linear_array(cfg.n_ant, cfg.n_ant_active, spacing)
