"""Multi-band observation loading (FITS / HDF5 / npz).

The reference's observed-spectrum workflow reads OVRO-LWA level-1.5
products: a FITS file whose primary HDU holds a (nstokes, nband, ny, nx)
image cube in kelvin with solar plate-scale geometry in the header, and a
BINTABLE extension carrying the per-band center frequencies
(script/pub/compare_ovro_Tb_spec.py:52-77); the same data also ships as
HDF5 (converted via ovrolwasolar.utils.recover_fits_from_h5). This module
loads either container — plus plain npz — into one normalized form with no
observatory-specific dependencies.

The port's own copy of raytracinggrff_tpu/utils/obs.py (numpy, and h5py
for HDF5 files).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np

from .fits import read_fits_bintable, read_fits_image


class ObservationCube(NamedTuple):
    img_k: np.ndarray      # (nband, ny, nx) brightness temperature, K
    freqs_hz: np.ndarray   # (nband,)
    x_rsun: np.ndarray     # (nx,) pixel-center coords in R_sun
    y_rsun: np.ndarray     # (ny,)


def _solar_axes(header, nx, ny):
    """Pixel-center coordinates in R_sun from FITS plate-scale cards
    (1-based CRPIX convention)."""
    rsun_arcsec = float(header.get("RSUN_OBS", 945.0))
    x = ((np.arange(nx) + 1.0 - float(header.get("CRPIX1", nx / 2 + 0.5)))
         * float(header.get("CDELT1", 1.0))) / rsun_arcsec
    y = ((np.arange(ny) + 1.0 - float(header.get("CRPIX2", ny / 2 + 0.5)))
         * float(header.get("CDELT2", 1.0))) / rsun_arcsec
    return x, y


def _load_fits_cube(path):
    data, header = read_fits_image(path)
    img = np.asarray(data, float)
    if img.ndim == 4:        # (nstokes, nband, ny, nx): take Stokes I
        img = img[0]
    elif img.ndim == 2:
        img = img[None]
    if img.ndim != 3:
        raise ValueError(f"expected 2-4D FITS image, got {img.ndim}-D")
    nb, ny, nx = img.shape
    try:
        cols = read_fits_bintable(path)
    except ValueError:
        cols = {}
    freqs = None
    for key in ("cfreqs", "CFREQS", "freq", "freqs", "frequency"):
        if key in cols:
            freqs = np.asarray(cols[key], float).reshape(-1)[:nb]
            break
    if freqs is None:
        restfrq = header.get("RESTFRQ") or header.get("CRVAL3")
        freqs = np.full(nb, float(restfrq)) if restfrq else np.full(nb,
                                                                    np.nan)
    x, y = _solar_axes(header, nx, ny)
    return ObservationCube(img, freqs, x, y)


def _walk_h5(group, prefix=""):
    import h5py
    out = {}
    for name, item in group.items():
        full = f"{prefix}/{name}" if prefix else name
        if isinstance(item, h5py.Group):
            out.update(_walk_h5(item, full))
        else:
            out[full] = item
    return out


def _load_h5_cube(path, image_key=None, freq_key=None):
    """Load an HDF5 observation.

    With no explicit keys, the image is the largest >=2-D float dataset and
    frequencies come from the first 1-D dataset whose name contains 'freq'.
    Plate-scale geometry is taken from the image dataset's attrs (or the
    file root's) using the same FITS card names when present."""
    import h5py

    with h5py.File(path, "r") as f:
        dsets = _walk_h5(f)
        if image_key is not None:
            img_ds = f[image_key]
        else:
            img_ds = None
            for ds in dsets.values():
                if ds.ndim >= 2 and ds.dtype.kind in "fiu":
                    if img_ds is None or ds.size > img_ds.size:
                        img_ds = ds
            if img_ds is None:
                raise ValueError(f"no image dataset found in {path}")
        img = np.asarray(img_ds[...], float)
        if img.ndim == 4:
            img = img[0]
        elif img.ndim == 2:
            img = img[None]
        nb, ny, nx = img.shape

        if freq_key is not None:
            freqs = np.asarray(f[freq_key][...], float).reshape(-1)[:nb]
        else:
            freqs = np.full(nb, np.nan)
            for name, ds in dsets.items():
                if ("freq" in name.lower() and ds.ndim <= 1
                        and ds.dtype.kind in "fiu" and ds is not img_ds):
                    freqs = np.asarray(ds[...], float).reshape(-1)[:nb]
                    break

        header = dict(f.attrs)
        header.update(dict(img_ds.attrs))
        x, y = _solar_axes(header, nx, ny)
    return ObservationCube(img, freqs, x, y)


def load_multiband_observation(path, image_key=None, freq_key=None):
    """Load a multi-band observation from .fits, .hdf/.h5, or .npz — or a
    glob of single-band FITS maps (one file per frequency, band centers
    from each file's RESTFRQ/CRVAL3 card), stacked frequency-sorted.

    npz convention: 'img_k' (nband, ny, nx), 'freqs_hz', and either
    'x_rsun'/'y_rsun' or 'x_coords'/'y_coords' in meters."""
    p = str(path)
    if any(ch in p for ch in "*?["):
        import glob
        files = sorted(glob.glob(p))
        if not files:
            raise FileNotFoundError(f"no observation files match {p}")
        bands = [_load_fits_cube(f) for f in files]
        order = np.argsort([b.freqs_hz[0] for b in bands])
        return ObservationCube(
            np.concatenate([bands[i].img_k for i in order]),
            np.concatenate([bands[i].freqs_hz for i in order]),
            bands[order[0]].x_rsun, bands[order[0]].y_rsun)
    if p.endswith((".fits", ".fts", ".fit")):
        return _load_fits_cube(p)
    if p.endswith((".hdf", ".h5", ".hdf5")):
        return _load_h5_cube(p, image_key, freq_key)
    data = np.load(p)
    img = np.asarray(data["img_k"], float)
    if img.ndim == 2:
        img = img[None]
    freqs = np.asarray(data["freqs_hz"], float).reshape(-1)
    if "x_rsun" in data:
        x, y = np.asarray(data["x_rsun"]), np.asarray(data["y_rsun"])
    else:
        from ..constants import R_SUN_M
        x = np.asarray(data["x_coords"], float) / R_SUN_M
        y = np.asarray(data["y_coords"], float) / R_SUN_M
    return ObservationCube(img, freqs, x, y)
