"""Coordinate conversions with the reference's orientation conventions.

Image-cube Cartesian (x, y, z) maps to MAS spherical coordinates through the
axis swap cart_to_sph(x, -z, y, phi0): the MAS polar axis is the image's +y
axis and the observer looks down -z (build_rays.py:93).
"""

from __future__ import annotations

import math

import torch


def cart_to_sph(x, y, z, phi0_offset_deg=0.0):
    """Cartesian tensors -> (r, colatitude in [0, pi], longitude in
    [0, 2pi)). The degree offset is added to the longitude before the wrap
    (build_rays.py:35-45). A tensor offset keeps the f32 arithmetic of the
    JAX version, which receives it as a float32 scalar."""
    r = torch.sqrt(x ** 2 + y ** 2 + z ** 2)
    colat = torch.arccos(torch.clamp(z / r, -1.0, 1.0))
    lon = torch.arctan2(y, x)
    lon = lon + phi0_offset_deg * math.pi / 180.0
    lon = torch.where(lon < 0, lon + 2.0 * math.pi, lon)
    return r, colat, lon


def sph_to_cart(r, colat, lon):
    """Spherical tensors -> Cartesian (x, y, z)
    (script/resampling_MAS_LOS.py:70-77)."""
    x = r * torch.sin(colat) * torch.cos(lon)
    y = r * torch.sin(colat) * torch.sin(lon)
    z = r * torch.cos(colat)
    return x, y, z


def image_xyz_to_mas_sph(x, y, z, phi0_offset_deg=0.0):
    """Image-frame Cartesian -> MAS (r, colat, lon) with the (x, -z, y)
    swap that every resampler of the reference uses."""
    return cart_to_sph(x, -z, y, phi0_offset_deg)
