"""Beam-pattern analysis (SURVEY.md C11/L8: the reference's offline
beam-response plots, used to validate the weight math end-to-end).

``beam_response`` sweeps a synthetic point source across angle and
returns the formed-beam power response matrix — the quantitative
version of the reference's sanity plots; ``plot_beam_pattern`` renders
it when matplotlib is present (optional, not needed in the hot path).
"""

from __future__ import annotations

import numpy as np

from dsabeamformer.config import SPEED_OF_LIGHT_M_S, ObsConfig
from dsabeamformer.models.arrays import ArrayLayout, array_for
from dsabeamformer.models.weights import weights_numpy_golden


def beam_response(
    cfg: ObsConfig,
    sweep_angles_rad: np.ndarray,
    layout: ArrayLayout | None = None,
    chan: int | None = None,
) -> np.ndarray:
    """Power response of every formed beam to a unit plane wave swept
    across ``sweep_angles_rad``.

    Returns ``[n_sweep, n_beams]`` normalized so a matched beam at
    boresight = 1.  Uses the float64 golden weight model (this is
    analysis tooling, not the hot path).
    """
    layout = layout if layout is not None else array_for(cfg)
    w = weights_numpy_golden(cfg, layout=layout)  # [F, B, A]
    if chan is not None:
        w = w[chan : chan + 1]
        freqs = cfg.freqs_hz()[chan : chan + 1]
    else:
        freqs = cfg.freqs_hz()
    x = layout.positions_m[: cfg.n_ant_active]
    f = freqs[:, None, None]                                   # [F,1,1]
    s = np.sin(sweep_angles_rad)[None, :, None]                # [1,S,1]
    arrival = np.exp(
        2j * np.pi * f * x[None, None, :] * s / SPEED_OF_LIGHT_M_S
    )  # [F,S,a]
    # B[f,s,b] = sum_a w[f,b,a] * v[f,s,a]
    b = np.einsum("fba,fsa->fsb", w[:, :, : cfg.n_ant_active], arrival)
    power = (np.abs(b) ** 2).mean(axis=0)  # average over channels -> [S,B]
    return power / cfg.n_ant_active**2


def beam_response_lm(
    cfg: ObsConfig,
    beam_l: np.ndarray,
    beam_m: np.ndarray,
    sweep_l: np.ndarray,
    sweep_m: np.ndarray,
    layout: ArrayLayout | None = None,
    chan: int | None = None,
) -> np.ndarray:
    """2-D analog of ``beam_response`` for (l, m) beam grids
    (``make_weights_lm``): power response of every beam to unit plane
    waves arriving from the ``(sweep_l[i], sweep_m[i])`` direction
    cosines.

    Returns ``[n_sweep, n_beams]`` normalized so a matched beam at
    boresight = 1 (build a 2-D map by passing a flattened meshgrid and
    reshaping).  No reference counterpart (the reference's beam fan is
    strictly 1-D east-west).
    """
    from dsabeamformer.models.weights import weights_lm_numpy_golden

    layout = layout if layout is not None else array_for(cfg)
    w = weights_lm_numpy_golden(cfg, beam_l, beam_m, layout=layout)
    if chan is not None:
        w = w[chan : chan + 1]
        freqs = cfg.freqs_hz()[chan : chan + 1]
    else:
        freqs = cfg.freqs_hz()
    act = cfg.n_ant_active
    x = layout.positions_m[:act]
    ns = layout.ns[:act]
    f = freqs[:, None, None]                                   # [F,1,1]
    path = (x[None, None, :] * np.asarray(sweep_l)[None, :, None]
            + ns[None, None, :] * np.asarray(sweep_m)[None, :, None])
    arrival = np.exp(2j * np.pi * f * path / SPEED_OF_LIGHT_M_S)  # [F,S,a]
    b = np.einsum("fba,fsa->fsb", w[:, :, :act], arrival)
    power = (np.abs(b) ** 2).mean(axis=0)
    return power / act**2


def beam_fwhm_rad(cfg: ObsConfig, layout: ArrayLayout | None = None) -> float:
    """Analytic beam width estimate: lambda / (N*d) for the uniform
    line array (sanity anchor for tests)."""
    layout = layout if layout is not None else array_for(cfg)
    x = layout.positions_m[: cfg.n_ant_active]
    aperture = x.max() - x.min()
    lam = SPEED_OF_LIGHT_M_S / np.median(cfg.freqs_hz())
    return 0.886 * lam / aperture


def plot_beam_pattern(cfg: ObsConfig, out_path: str,
                      n_sweep: int = 512) -> str:
    """Render the beam-pattern matrix to an image file.  Requires
    matplotlib (optional dependency)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    half = cfg.beam_span_deg * 0.75
    sweep = np.deg2rad(np.linspace(-half, half, n_sweep))
    resp = beam_response(cfg, sweep)
    fig, ax = plt.subplots(figsize=(10, 5))
    im = ax.imshow(
        10 * np.log10(np.maximum(resp.T, 1e-6)),
        aspect="auto",
        origin="lower",
        extent=[-half, half, 0, cfg.n_beams],
        vmin=-30,
        vmax=0,
    )
    ax.set_xlabel("source angle (deg)")
    ax.set_ylabel("beam index")
    ax.set_title(f"{cfg.name}: formed-beam response (dB)")
    fig.colorbar(im, ax=ax, label="dB")
    fig.tight_layout()
    fig.savefig(out_path, dpi=120)
    plt.close(fig)
    return out_path
