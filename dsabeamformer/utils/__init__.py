"""Utilities: tolerance metrics, per-block stats, profiling helpers."""

from dsabeamformer.utils.testing import assert_power_close, relative_power_error

__all__ = ["relative_power_error", "assert_power_close"]
