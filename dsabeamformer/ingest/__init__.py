"""Ingest: synthetic voltage generation, wire-block encoding, and the
native shared-memory ring buffer (the PSRDADA-equivalent, SURVEY.md
L1/C3)."""

from dsabeamformer.ingest.generator import (
    make_noise_block,
    make_dispersed_pulse_block,
    make_point_source_block,
    make_tone_block,
)

__all__ = [
    "make_noise_block",
    "make_dispersed_pulse_block",
    "make_point_source_block",
    "make_tone_block",
]
