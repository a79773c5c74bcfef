"""Minimal FITS image reader (no astropy dependency).

Covers what the observation-comparison workflows need (the reference loads
OVRO-LWA / suncasa FITS images via astropy in script/pub/compare_ovro_*.py):
uncompressed primary-HDU (or first image-extension) N-D image data with
BSCALE/BZERO, plus the header cards needed for solar plate-scale geometry
(CDELTn, CRPIXn, CRVALn, NAXISn).

The port's own copy of raytracinggrff_tpu/utils/fits.py (numpy only).
"""

from __future__ import annotations

import numpy as np

_BLOCK = 2880

_BITPIX_DTYPE = {
    8: np.dtype(">u1"), 16: np.dtype(">i2"), 32: np.dtype(">i4"),
    64: np.dtype(">i8"), -32: np.dtype(">f4"), -64: np.dtype(">f8"),
}


def _parse_header(buf, pos):
    """Parse one header unit starting at pos; returns (cards, new_pos)."""
    cards = {}
    while True:
        block = buf[pos:pos + _BLOCK]
        if len(block) < _BLOCK:
            raise ValueError("truncated FITS header")
        pos += _BLOCK
        done = False
        for i in range(0, _BLOCK, 80):
            card = block[i:i + 80].decode("ascii", "replace")
            key = card[:8].strip()
            if key == "END":
                done = True
                break
            if "=" not in card[8:10]:
                continue
            val = card[10:].split("/")[0].strip()
            if val.startswith("'"):
                cards[key] = val.strip("'").strip()
            elif val in ("T", "F"):
                cards[key] = val == "T"
            else:
                try:
                    cards[key] = int(val)
                except ValueError:
                    try:
                        cards[key] = float(val)
                    except ValueError:
                        cards[key] = val
        if done:
            break
    return cards, pos


def read_fits_hdus(path):
    """Parse every HDU into (header dict, raw data bytes) pairs."""
    with open(path, "rb") as f:
        buf = f.read()
    hdus = []
    pos = 0
    while pos < len(buf):
        header, pos = _parse_header(buf, pos)
        naxis = int(header.get("NAXIS", 0))
        shape = [int(header[f"NAXIS{i}"]) for i in range(naxis, 0, -1)]
        n_items = int(np.prod(shape)) if shape else 0
        itemsize = abs(int(header.get("BITPIX", 8))) // 8
        # binary tables append a heap of PCOUNT bytes after the main table
        nbytes = n_items * itemsize + int(header.get("PCOUNT", 0))
        hdus.append((header, buf[pos:pos + nbytes]))
        pos += -(-nbytes // _BLOCK) * _BLOCK
    return hdus


def _decode_image(header, raw):
    naxis = int(header.get("NAXIS", 0))
    shape = [int(header[f"NAXIS{i}"]) for i in range(naxis, 0, -1)]
    n_items = int(np.prod(shape)) if shape else 0
    if n_items == 0:
        return None
    dtype = _BITPIX_DTYPE[int(header.get("BITPIX", 8))]
    data = np.frombuffer(raw, dtype=dtype, count=n_items).reshape(shape)
    data = data.astype(np.float64)
    bscale = float(header.get("BSCALE", 1.0))
    bzero = float(header.get("BZERO", 0.0))
    if bscale != 1.0 or bzero != 0.0:
        data = data * bscale + bzero
    return data


def read_fits_image(path):
    """Read the first HDU containing image data.

    Returns (data ndarray with NAXIS axes reversed (C order), header dict).
    """
    for header, raw in read_fits_hdus(path):
        if header.get("XTENSION", "IMAGE").strip() not in ("IMAGE",):
            continue
        data = _decode_image(header, raw)
        if data is not None:
            return data, header
    raise ValueError(f"no image HDU found in {path}")


# TFORM letter -> numpy big-endian dtype (scalar/array numeric columns)
_TFORM_DTYPE = {
    "L": np.dtype(">u1"), "B": np.dtype(">u1"), "I": np.dtype(">i2"),
    "J": np.dtype(">i4"), "K": np.dtype(">i8"), "E": np.dtype(">f4"),
    "D": np.dtype(">f8"),
}

# FITS logical columns store ASCII 'T'/'F' bytes, not 0/1
def _decode_logical(arr):
    return arr == ord("T")


def read_fits_bintable(path, hdu_index=None):
    """Read the first (or hdu_index-th) BINTABLE extension.

    Returns a dict mapping column name (TTYPEn) to an (nrows,) or
    (nrows, repeat) array. Non-numeric columns (strings, var-length) are
    skipped. Covers what the observation workflows need: pulling per-band
    center frequencies (e.g. the 'cfreqs' column of OVRO-LWA level-1.5
    FITS, ref compare_ovro_Tb_spec.py:55-58)."""
    seen = 0
    for header, raw in read_fits_hdus(path):
        if header.get("XTENSION", "").strip() != "BINTABLE":
            continue
        if hdu_index is not None and seen != hdu_index:
            seen += 1
            continue
        nrow = int(header["NAXIS2"])
        rowbytes = int(header["NAXIS1"])
        table = np.frombuffer(raw[:nrow * rowbytes],
                              np.uint8).reshape(nrow, rowbytes)
        cols = {}
        offset = 0
        for i in range(1, int(header["TFIELDS"]) + 1):
            tform = str(header.get(f"TFORM{i}", "")).strip()
            name = str(header.get(f"TTYPE{i}", f"col{i}")).strip()
            j = 0
            while j < len(tform) and tform[j].isdigit():
                j += 1
            repeat = int(tform[:j]) if j else 1
            code = tform[j:j + 1]
            if code == "A":
                offset += repeat           # string column: skip
                continue
            if code == "P" or code == "Q":
                offset += (8 if code == "P" else 16) * repeat
                continue                   # var-length heap pointer: skip
            dt = _TFORM_DTYPE.get(code)
            if dt is None:
                raise ValueError(f"unsupported TFORM {tform!r}")
            width = dt.itemsize * repeat
            colbytes = table[:, offset:offset + width]
            arr = np.frombuffer(colbytes.tobytes(), dt).reshape(nrow, repeat)
            if code == "L":
                arr = _decode_logical(arr)
            cols[name] = arr[:, 0] if repeat == 1 else arr
            offset += width
        return cols
    raise ValueError(f"no BINTABLE extension found in {path}")


def _format_card(key, val):
    if isinstance(val, bool):
        s = f"{key:<8}= {'T' if val else 'F':>20}"
    elif isinstance(val, (int, np.integer)):
        s = f"{key:<8}= {val:>20d}"
    elif isinstance(val, (float, np.floating)):
        s = f"{key:<8}= {val:>20.12G}"
    else:
        s = f"{key:<8}= '{val}'"
    return s[:80].ljust(80)


def _header_block(cards):
    text = "".join(_format_card(k, v) for k, v in cards) + "END".ljust(80)
    pad = -(len(text)) % _BLOCK
    return (text + " " * pad).encode("ascii")


def _pad_block(raw):
    return raw + b"\0" * (-(len(raw)) % _BLOCK)


def write_fits_image(path, data, header_cards=None, table_columns=None):
    """Write a minimal FITS file: one primary image HDU (float32) plus an
    optional BINTABLE extension of scalar float64 columns.

    Enough to exercise/produce the multi-band observation contract the
    comparison workflows read (image cube + 'cfreqs' table); not a general
    FITS writer."""
    data = np.asarray(data, np.float32)
    cards = [("SIMPLE", True), ("BITPIX", -32), ("NAXIS", data.ndim)]
    cards += [(f"NAXIS{i}", data.shape[data.ndim - i])
              for i in range(1, data.ndim + 1)]
    if table_columns:
        cards += [("EXTEND", True)]
    cards += list((header_cards or {}).items())
    out = _header_block(cards)
    out += _pad_block(data.astype(">f4").tobytes())

    if table_columns:
        names = list(table_columns)
        arrays = [np.asarray(table_columns[n], ">f8").reshape(-1)
                  for n in names]
        nrow = len(arrays[0])
        tcards = [("XTENSION", "BINTABLE"), ("BITPIX", 8), ("NAXIS", 2),
                  ("NAXIS1", 8 * len(names)), ("NAXIS2", nrow),
                  ("PCOUNT", 0), ("GCOUNT", 1), ("TFIELDS", len(names))]
        for i, n in enumerate(names, 1):
            tcards += [(f"TTYPE{i}", n), (f"TFORM{i}", "D")]
        # np.stack silently drops the explicit big-endian byte order
        rows = np.stack(arrays, axis=1).astype(">f8")
        out += _header_block(tcards) + _pad_block(rows.tobytes())
    with open(path, "wb") as f:
        f.write(out)


def load_observation_map(path):
    """Load a 2D observation map from .fits or .npz.

    npz convention: keys 'map' (2D) and optionally 'x_coords'/'y_coords'
    (meters, as the framework writes). FITS maps are squeezed to 2D.
    Returns (map2d, x_coords_m or None, y_coords_m or None, meta dict).
    """
    path = str(path)
    if path.endswith((".fits", ".fts", ".fit")):
        data, header = read_fits_image(path)
        img = np.squeeze(data)
        if img.ndim != 2:
            raise ValueError(f"FITS data is {img.ndim}-D after squeeze")
        return img, None, None, dict(header)
    data = np.load(path)
    if "map" in data:
        img = data["map"]
    elif "emission_cube" in data:
        img = data["emission_cube"][:, :, 0]
    else:
        raise KeyError("npz must contain 'map' or 'emission_cube'")
    return (img, data.get("x_coords"), data.get("y_coords"),
            {k: None for k in data.files})
