"""Fringe / pointing tracking over time.

Reference behavior (SURVEY.md §3.3, C8): as the sky rotates, the fringe
phase for the pointing center drifts, and the host periodically
recomputes + re-uploads the weight matrices.  Here the whole update is
the jitted device-side ``make_weights -> quantize_weights`` chain, and
``FringeTracker`` decides *when* to rerun it: when the accumulated
pointing drift would cost more than ``max_phase_error_rad`` of phase at
the band edge on the longest baseline.

The streaming driver polls ``maybe_update(t)`` between blocks
(pipeline.py), so updates never stall the stream — the new weights are
already on device when they swap in.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from dsabeamformer.config import SPEED_OF_LIGHT_M_S, ObsConfig
from dsabeamformer.models.arrays import ArrayLayout, array_for
from dsabeamformer.models.calibration import CalTable
from dsabeamformer.models.weights import make_weights
from dsabeamformer.ops.quantize import QuantWeights, quantize_weights

#: Earth rotation rate (sidereal), rad/s.
EARTH_ROT_RAD_S = 7.2921159e-5


@dataclasses.dataclass
class FringeTracker:
    """Drift-scan pointing model: the tracked direction moves across the
    fan at the sidereal rate (projected by cos(declination))."""

    cfg: ObsConfig
    layout: Optional[ArrayLayout] = None
    cal: Optional[CalTable] = None
    pointing0_rad: float = 0.0
    declination_rad: float = 0.0
    max_phase_error_rad: float = 0.05
    #: Optional CVec -> CVec edit applied to every regenerated table
    #: BEFORE quantization (channel zap / antenna flags — without it,
    #: the first tracker update would silently un-excise a --zap or
    #: --flag-ants run).
    edit: Optional[callable] = None
    _last_update_t: float = dataclasses.field(default=None, init=False)  # type: ignore
    _n_updates: int = dataclasses.field(default=0, init=False)

    def __post_init__(self):
        if self.layout is None:
            self.layout = array_for(self.cfg)
        if self.cal is None:
            self.cal = CalTable.unity(self.cfg)

    def pointing_at(self, t_s: float) -> float:
        return (
            self.pointing0_rad
            + EARTH_ROT_RAD_S * np.cos(self.declination_rad) * t_s
        )

    @property
    def update_interval_s(self) -> float:
        """Time for the drift to accumulate ``max_phase_error_rad`` at
        the top of the band on the longest baseline."""
        x = self.layout.positions_m[: self.cfg.n_ant_active]
        bl = float(x.max() - x.min()) if len(x) > 1 else 1.0
        f_max = float(self.cfg.freqs_hz().max())
        dphase_dt = (
            2 * np.pi * f_max * bl / SPEED_OF_LIGHT_M_S
            * EARTH_ROT_RAD_S * abs(np.cos(self.declination_rad))
        )
        return self.max_phase_error_rad / max(dphase_dt, 1e-30)

    def weights_at(self, t_s: float) -> QuantWeights:
        w = make_weights(
            self.cfg,
            layout=self.layout,
            cal=self.cal,
            pointing_rad=self.pointing_at(t_s),
        )
        if self.edit is not None:
            w = self.edit(w)
        return quantize_weights(w, self.cfg.weight_mode, self.cfg.a_compute)

    def maybe_update(self, t_s: float) -> Optional[QuantWeights]:
        """Return fresh weights if the drift since the last update
        exceeds the phase budget, else None."""
        if (
            self._last_update_t is not None
            and t_s - self._last_update_t < self.update_interval_s
        ):
            return None
        self._last_update_t = t_s
        self._n_updates += 1
        return self.weights_at(t_s)

    @property
    def n_updates(self) -> int:
        return self._n_updates

    def set_calibration(self, cal: CalTable) -> None:
        """New calibration solution: force regeneration at next poll
        (the reference's cal-update trigger)."""
        self.cal = cal
        self._last_update_t = None

    def invalidate(self) -> None:
        """Force regeneration at the next per-block poll — at the
        CURRENT stream pointing.  The RFI monitor's excision path uses
        this instead of building weights itself, which would rewind
        the pointing to t=0 (the monitor's zap set reaches the fresh
        table through ``edit``)."""
        self._last_update_t = None
