"""Gaussian beam convolution for emission maps, in torch.

The reference convolves with scipy.ndimage.gaussian_filter, sigma =
beam_fwhm / (x span) * N_pix pixels (script/resample_with_ray_tracing.py:
618-624). This is a separable periodic Gaussian by FFT with scipy's
kernel truncation (raytracinggrff_tpu/utils/beam.py).
"""

from __future__ import annotations

import numpy as np
import torch


def _gaussian_kernel_1d(sigma, n):
    """The length-n periodic kernel, centred on index 0, as float64 numpy;
    radius int(4 sigma + 0.5) as in scipy."""
    pad = np.zeros(n)
    if sigma <= 0:
        pad[0] = 1.0
        return pad
    radius = int(4.0 * sigma + 0.5)
    x = np.arange(-radius, radius + 1)
    k = np.exp(-0.5 * (x / sigma) ** 2)
    k /= k.sum()
    pad[:radius + 1] = k[radius:]
    pad[n - radius:] = k[:radius]
    return pad


def gaussian_beam_convolve(img, sigma_pix, device="cuda"):
    """Separable periodic Gaussian blur of a 2D map (sigma in pixels) on
    `device`, in float64; NaNs count as zero. Matches
    scipy.ndimage.gaussian_filter away from the edges (scipy reflects at
    the edges; emission maps are about zero there). Returns a tensor."""
    img = torch.as_tensor(np.asarray(img, np.float64), device=device)
    img = torch.where(torch.isfinite(img), img, 0.0)
    ny, nx = img.shape
    ky = torch.as_tensor(_gaussian_kernel_1d(float(sigma_pix), ny),
                         device=device)
    kx = torch.as_tensor(_gaussian_kernel_1d(float(sigma_pix), nx),
                         device=device)
    f = torch.fft.rfft2(img)
    fy = torch.fft.fft(ky)
    fx = torch.fft.rfft(kx)
    return torch.fft.irfft2(f * fy[:, None] * fx[None, :], s=(ny, nx))
