"""Array models: antenna layouts, steering/calibration weight generation.

The equivalent of the reference's host-side weight machinery
(SURVEY.md L6/C8): weights are a pure jitted function of
(positions, beam angles, channel freqs, pointing, calibration gains),
generated device-side so calibration/pointing updates never stall the
stream with a host round-trip.
"""

from dsabeamformer.models.arrays import ArrayLayout, array_for
from dsabeamformer.models.calibration import CalTable
from dsabeamformer.models.weights import make_weights, steering_weights

__all__ = [
    "ArrayLayout",
    "array_for",
    "CalTable",
    "make_weights",
    "steering_weights",
]
