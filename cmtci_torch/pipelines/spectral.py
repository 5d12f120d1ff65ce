"""Spectral pipeline (``cmtci spectral``; port of ``cmtci/pipelines/spectral.py``).

References: spatial_stats_phase4.py (ordered boundary FFT + low-mode
reconstructions), spectral_decay_exponent.py (amplitude slope fits over 4
ranges), phase4b_spectral_bootstrap.py (power-spectrum slopes with 200
bootstrap resamples over 2 ranges). The FFTs and fits are host numpy; the
bootstrap resamples run on `device` over host-drawn indices
(``stats/spectral.py``).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from cmtci_torch.io import writers
from cmtci_torch.stats import spectral as sp


@dataclass
class SpectralConfig:
    amplitude_ranges: tuple = ((1e-4, 1e-3), (1e-3, 1e-2), (1e-2, 1e-1), (1e-1, 0.5))
    power_ranges: tuple = ((1e-3, 1e-2), (1e-2, 1e-1))
    n_bootstrap: int = 200
    n_modes_report: int = 10
    seed: int = 0


def run_spectral(c_pts, m_pts, cfg: SpectralConfig, out_prefix: str | None = None,
                 plots: bool = True, device="cuda"):
    """Full spectral comparison of two point sets. Returns dict of results;
    with `out_prefix` writes _slopes.txt, _bootstrap.csv and _meta.txt, and
    the reconstruction figure unless plots=False."""
    out = {}
    # phase4: ordered FFT spectra + first modes
    freq_c, f_c = sp.boundary_fft(c_pts)
    freq_m, f_m = sp.boundary_fft(m_pts)
    amp_c = np.abs(f_c) / np.abs(f_c).max()
    amp_m = np.abs(f_m) / np.abs(f_m).max()
    out["modes"] = [
        {"mode": k, "construct": float(amp_c[k]), "mandelbrot": float(amp_m[k])}
        for k in range(1, cfg.n_modes_report + 1)
    ]

    # decay-exponent fits on amplitude spectra (spectral_decay_exponent.py)
    fa_c, aa_c = sp.amplitude_spectrum(c_pts)
    fa_m, aa_m = sp.amplitude_spectrum(m_pts)
    rows = []
    for fmin, fmax in cfg.amplitude_ranges:
        for label, fr, am in (("Construct", fa_c, aa_c), ("Mandelbrot", fa_m, aa_m)):
            fit = sp.fit_decay_exponent(fr, am, fmin, fmax)
            if fit is None:
                continue
            slope, r2, npts = fit
            rows.append({"label": label, "fmin": fmin, "fmax": fmax,
                         "slope": slope, "R2": r2, "n": npts})
    out["amplitude_slopes"] = rows

    # phase4b: power-spectrum bootstrap CIs
    fp_c, pp_c = sp.power_spectrum(c_pts)
    fp_m, pp_m = sp.power_spectrum(m_pts)
    boot = []
    for fmin, fmax in cfg.power_ranges:
        for label, fr, ps in (("Construct", fp_c, pp_c), ("Mandelbrot", fp_m, pp_m)):
            slope, r2, (lo, hi) = sp.fit_slope_bootstrap(
                fr, ps, fmin, fmax, cfg.n_bootstrap, cfg.seed, device=device
            )
            boot.append({"label": label, "fmin": fmin, "fmax": fmax,
                         "slope": slope, "R2": r2, "ci_lo": lo, "ci_hi": hi})
    out["power_slopes_bootstrap"] = boot

    if out_prefix:
        writers.ensure_dir(f"{out_prefix}_slopes.txt")
        with open(f"{out_prefix}_slopes.txt", "w") as f:
            f.write("Label, fmin, fmax, slope, R2\n")
            for r in rows:
                f.write(f"{r['label']},{r['fmin']},{r['fmax']},{r['slope']},{r['R2']}\n")
        writers.write_dict_rows_csv(f"{out_prefix}_bootstrap.csv", boot)
        writers.write_config_meta(f"{out_prefix}_meta.txt", cfg,
                                  extra={"n_construct": len(np.asarray(c_pts)),
                                         "n_mandel": len(np.asarray(m_pts))})
        modes = tuple(m for m in (5, 10, 30, 100) if m < min(len(f_c), len(f_m)) // 2)
        if plots and modes:
            from cmtci_torch.io import plots as plot_io

            plot_io.plot_fft_reconstructions(c_pts, m_pts,
                                             f"{out_prefix}_fft_reconstructions.png",
                                             modes=modes, ffts=(f_c, f_m))
    return out
