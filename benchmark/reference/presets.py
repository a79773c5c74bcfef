"""The TbSpectra sweep's per-frequency presets: a frozen copy of
raytracinggrff_tpu_torch/cli/tb_spectra.py's select_params (the reference
script/pub/TbSpectra_gen.py:27-88), quantize_params (the lattice that
rounds a preset up onto the JAX sweep's grid) and sweep_frequencies, so
that the reference works the presets out again from the frequencies."""

from __future__ import annotations

import numpy as np


def _lowband_params(freq_hz):
    scale = (100e6 / freq_hz) ** 0.5
    return {
        "grid_n": 256, "grid_extent": 4.0, "z_observer": 4.0, "x_fov": 2.8,
        "dt": 6e-3 * scale,
        "n_steps": max(1200, int(round(4000 / max(scale, 1e-12)))),
        "record_stride": max(1, int(round(5 * scale))),
    }


_HIGHBAND_ANCHORS = {
    280e6: {"grid_n": 400, "grid_extent": 1.75, "z_observer": 1.75,
            "x_fov": 1.44, "dt": 1.0e-3, "n_steps": 4500,
            "record_stride": 10},
    550e6: {"grid_n": 440, "grid_extent": 1.45, "z_observer": 1.45,
            "x_fov": 1.44, "dt": 0.8e-3, "n_steps": 7500,
            "record_stride": 5},
    800e6: {"grid_n": 520, "grid_extent": 1.45, "z_observer": 1.44,
            "x_fov": 1.44, "dt": 0.4e-3, "n_steps": 12000,
            "record_stride": 5},
}


def _interp_log_freq_params(freq_hz, f0, p0, f1, p1):
    t = (np.log(freq_hz) - np.log(f0)) / (np.log(f1) - np.log(f0))
    t = float(np.clip(t, 0.0, 1.0))
    return {k: (1.0 - t) * p0[k] + t * p1[k] for k in p0}


def _highband_params(freq_hz):
    a = _HIGHBAND_ANCHORS
    if freq_hz <= 550e6:
        p = _interp_log_freq_params(freq_hz, 280e6, a[280e6], 550e6, a[550e6])
    else:
        p = _interp_log_freq_params(freq_hz, 550e6, a[550e6], 800e6, a[800e6])
    for k in ("grid_n", "n_steps", "record_stride"):
        p[k] = int(round(p[k]))
    return p


def select_params(freq_hz):
    """Frequency-dependent tracer presets."""
    if freq_hz <= 150e6:
        return _lowband_params(freq_hz)
    if freq_hz >= 280e6:
        return _highband_params(freq_hz)
    p = _interp_log_freq_params(freq_hz, 150e6, _lowband_params(150e6),
                                280e6, _highband_params(280e6))
    for k in ("grid_n", "n_steps", "record_stride"):
        p[k] = int(round(p[k]))
    return p


def quantize_params(p, seg_records=25):
    """A preset rounded onto the lattice: extent up to 0.25 R_sun, grid_n
    up to a multiple of 128 (or 576) that keeps the cell size, stride down
    to a power of two, n_steps up to whole seg_records x stride blocks."""
    q = dict(p)
    ext = float(p["grid_extent"])
    dx_preset = 2.0 * ext / int(p["grid_n"])
    ext_q = float(np.ceil(ext / 0.25) * 0.25)
    q["grid_extent"] = ext_q
    n_min = int(np.ceil(2.0 * ext_q / dx_preset))
    q["grid_n"] = next(n for n in sorted(
        [128 * k for k in range(1, 33)] + [576]) if n >= n_min)
    stride = int(p["record_stride"])
    q["record_stride"] = stride = max(1, 2 ** int(np.log2(stride)))
    n_rec = -(-int(p["n_steps"]) // stride)
    n_rec = -(-n_rec // seg_records) * seg_records
    q["n_steps"] = n_rec * stride
    return q


def sweep_frequencies(fmin_mhz, fmax_mhz, n_freq):
    """The sweep's log-spaced frequencies in Hz."""
    return np.logspace(np.log10(fmin_mhz), np.log10(fmax_mhz), n_freq) * 1e6


def sweep_preset(freq_hz, exact_presets=False):
    """The preset a sweep map at freq_hz runs."""
    p = select_params(float(freq_hz))
    return p if exact_presets else quantize_params(p)
