"""HDF4 scientific-dataset writer: a frozen copy of write_hdf4_sds from
raytracinggrff_tpu_torch/mas/hdf4.py (DFSD style: NDG + SDD + SD + SDS
[+ SDL]), so that the benchmark writes the MAS files the program reads
without importing the program."""

from __future__ import annotations

import struct

import numpy as np

HDF4_MAGIC = b"\x0e\x03\x13\x01"

DFTAG_VERSION = 30
DFTAG_NT = 106
DFTAG_SDD = 701
DFTAG_SD = 702
DFTAG_SDS = 703
DFTAG_SDL = 704
DFTAG_NDG = 720

DTYPE_TO_DFNT = {"f4": 5, "f8": 6, "i1": 20, "u1": 21,
                 "i2": 22, "u2": 23, "i4": 24, "u4": 25}


def write_hdf4_sds(path, data: np.ndarray, scales=None, label=None):
    """Write one SDS holding `data` with per-dimension `scales`."""
    data = np.asarray(data)
    rank = data.ndim
    dims = data.shape
    if scales is None:
        scales = [None] * rank
    be = data.dtype.str.lstrip("<>=|")
    if be not in DTYPE_TO_DFNT:
        data = data.astype(np.float32)
        be = "f4"

    elements = []  # (tag, ref, payload bytes)
    ref_counter = [1]

    def add(tag, payload):
        ref = ref_counter[0]
        ref_counter[0] += 1
        elements.append((tag, ref, payload))
        return ref

    def nt_payload(dtype_code):
        typ = DTYPE_TO_DFNT[dtype_code]
        width = int(dtype_code[1]) * 8
        return struct.pack(">BBBB", 1, typ, width, 0)

    add(DFTAG_VERSION, struct.pack(">III", 4, 2, 15) + b"rgrff-tpu\x00")
    data_nt_ref = add(DFTAG_NT, nt_payload(be))

    scale_nt_refs = []
    scale_payload = bytearray()
    flags = bytearray()
    for i in range(rank):
        s = scales[i]
        if s is None:
            flags.append(0)
            scale_nt_refs.append(data_nt_ref)
        else:
            s = np.asarray(s, np.float64)
            if len(s) != dims[i]:
                raise ValueError("scale length mismatch")
            flags.append(1)
            scale_nt_refs.append(add(DFTAG_NT, nt_payload("f8")))
            scale_payload += s.astype(">f8").tobytes()

    sdd = struct.pack(">h", rank) + struct.pack(f">{rank}i", *dims)
    sdd += struct.pack(">HH", DFTAG_NT, data_nt_ref)
    for r in scale_nt_refs:
        sdd += struct.pack(">HH", DFTAG_NT, r)
    sdd_ref = add(DFTAG_SDD, bytes(sdd))

    sd_ref = add(DFTAG_SD, data.astype(f">{be}").tobytes())
    sds_ref = add(DFTAG_SDS, bytes(flags) + bytes(scale_payload))

    ndg_members = [(DFTAG_SDD, sdd_ref), (DFTAG_SD, sd_ref),
                   (DFTAG_SDS, sds_ref)]
    if label:
        sdl_ref = add(DFTAG_SDL, label.encode("ascii") + b"\x00")
        ndg_members.append((DFTAG_SDL, sdl_ref))
    ndg = b"".join(struct.pack(">HH", t, r) for t, r in ndg_members)
    add(DFTAG_NDG, ndg)

    # layout: magic + one DD block + payloads
    header_len = 4 + 6 + 12 * len(elements)
    offset = header_len
    dd_entries = []
    for tag, ref, payload in elements:
        dd_entries.append((tag, ref, offset, len(payload)))
        offset += len(payload)

    with open(path, "wb") as f:
        f.write(HDF4_MAGIC)
        f.write(struct.pack(">hI", len(elements), 0))
        for tag, ref, off, length in dd_entries:
            f.write(struct.pack(">HHII", tag, ref, off, length))
        for _, _, payload in elements:
            f.write(payload)
