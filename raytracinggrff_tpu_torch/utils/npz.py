"""np.savez_compressed with the deflate spread over the host's cores.

The port writes its .npz files at zlib's default level, as numpy does
(zipfile's ZIP_DEFLATED), but on one zlib thread the write of a map's two
float64 256^2 x 3 cubes outlasts the map's device work. savez_compressed
here cuts each member's bytes (the .npy header and data numpy writes) into
chunks of at least CHUNK bytes and deflates the chunks of every member
together on a thread pool, as pigz does: each chunk is a raw deflate
stream at the default level, primed with the WINDOW bytes before it and
ended by a sync flush (the member's last chunk by a finish), so that the
chunks joined in order are one deflate stream. zlib releases the
interpreter lock while it deflates. The chunks follow from the members'
sizes alone, so the file does not depend on the number of threads: the
CPUs the process may use, at most one a chunk.

The ZIP is written here, since zipfile cannot store data deflated
elsewhere: members "<key>.npy" with their CRC-32 and sizes in the local
and central headers, and ZIP64 fields where a size, an offset or the
central directory passes zipfile's ZIP64_LIMIT.
"""

from __future__ import annotations

import io
import itertools
import os
import struct
import threading
import time
import zipfile
import zlib
from concurrent.futures import ThreadPoolExecutor, wait

import numpy as np

CHUNK = 128 * 1024        # least bytes of a deflate job
WINDOW = 32 * 1024        # deflate's window: a chunk's dictionary
_LIMIT = zipfile.ZIP64_LIMIT
_FULL32 = 0xFFFFFFFF

_pool_lock = threading.Lock()
_pool = None              # (pid, workers, ThreadPoolExecutor)


def _executor(workers):
    """The process's deflate pool of `workers` threads, made on first use
    and made anew in a forked child or when the CPUs the process may use
    have changed."""
    global _pool
    with _pool_lock:
        if _pool is None or _pool[:2] != (os.getpid(), workers):
            _pool = (os.getpid(), workers,
                     ThreadPoolExecutor(workers,
                                        thread_name_prefix="npz-deflate"))
        return _pool[2]


def _member(array):
    """The .npy bytes numpy's savez writes for `array`, as buffers: the
    header and a view of the array's memory, copied only where numpy's
    order is not the array's own. Object and structured dtypes go through
    numpy's writer whole."""
    array = np.asanyarray(array)
    if array.dtype.hasobject or array.dtype.names:
        buf = io.BytesIO()
        np.lib.format.write_array(buf, array, allow_pickle=True)
        return [buf.getbuffer()]
    head = io.BytesIO()
    header = np.lib.format.header_data_from_array_1_0(array)
    np.lib.format.write_array_header_1_0(head, header)
    data = array.T if header["fortran_order"] else np.ascontiguousarray(array)
    return [head.getvalue(), memoryview(data.reshape(-1).view(np.uint8))]


def _pieces(parts, start, end):
    """Views of bytes [start, end) of the buffers `parts` joined."""
    out, at = [], 0
    for p in parts:
        lo, hi = max(start - at, 0), min(end - at, len(p))
        if lo < hi:
            out.append(p[lo:hi])
        at += len(p)
    return out


def _bounds(size):
    """(start, end) of a member's chunks: size // CHUNK of them (one at
    least), as near equal as whole bytes allow, so none is below CHUNK
    unless the member is."""
    n = max(1, size // CHUNK)
    edges = [size * i // n for i in range(n + 1)]
    return list(zip(edges[:-1], edges[1:]))


def _deflate(parts, start, end, size):
    """Bytes [start, end) of a member of `size` bytes as a raw deflate
    stream at zlib's default level, primed with the WINDOW bytes before
    them and ended by a sync flush, or by a finish at the member's end."""
    dictionary = ({"zdict": b"".join(_pieces(parts, start - WINDOW, start))}
                  if start else {})
    c = zlib.compressobj(zlib.Z_DEFAULT_COMPRESSION, zlib.DEFLATED, -15,
                         **dictionary)
    out = [c.compress(p) for p in _pieces(parts, start, end)]
    out.append(c.flush(zlib.Z_FINISH if end == size else zlib.Z_SYNC_FLUSH))
    return b"".join(out)


def _name(key):
    """A member's name and flags, as zipfile gives them: ASCII, else
    UTF-8 under flag bit 11."""
    name = f"{key}.npy"
    try:
        return name.encode("ascii"), 0
    except UnicodeEncodeError:
        return name.encode("utf-8"), 0x800


def _dos_time():
    t = time.localtime()
    return ((t.tm_hour << 11) | (t.tm_min << 5) | (t.tm_sec // 2),
            ((t.tm_year - 1980) << 9) | (t.tm_mon << 5) | t.tm_mday)


def _local_header(name, flags, crc, csize, usize, dos):
    zip64 = csize > _LIMIT or usize > _LIMIT
    extra = struct.pack("<HHQQ", 1, 16, usize, csize) if zip64 else b""
    if zip64:
        csize = usize = _FULL32
    return struct.pack("<IHHHHHIIIHH", 0x04034B50, 45 if zip64 else 20,
                       flags, zipfile.ZIP_DEFLATED, *dos, crc, csize, usize,
                       len(name), len(extra)) + name + extra


def _central_header(name, flags, crc, csize, usize, offset, dos):
    large = [v for v in (usize, csize, offset) if v > _LIMIT]
    extra = (struct.pack(f"<HH{len(large)}Q", 1, 8 * len(large), *large)
             if large else b"")
    usize, csize, offset = (_FULL32 if v > _LIMIT else v
                            for v in (usize, csize, offset))
    version = 45 if large else 20
    return struct.pack("<IHHHHHHIIIHHHHHII", 0x02014B50, (3 << 8) | version,
                       version, flags, zipfile.ZIP_DEFLATED, *dos, crc,
                       csize, usize, len(name), len(extra), 0, 0, 0,
                       0o600 << 16, offset) + name + extra


def _end_records(count, cd_size, cd_offset):
    end = b""
    if count >= 0xFFFF or cd_size > _LIMIT or cd_offset > _LIMIT:
        end = struct.pack("<IQHHIIQQQQ", 0x06064B50, 44, 45, 45, 0, 0, count,
                          count, cd_size, cd_offset)
        end += struct.pack("<IIQI", 0x07064B50, 0, cd_offset + cd_size, 1)
    return end + struct.pack("<IHHHHIIH", 0x06054B50, 0, 0,
                             min(count, 0xFFFF), min(count, 0xFFFF),
                             min(cd_size, _FULL32), min(cd_offset, _FULL32), 0)


def savez_compressed(file, **arrays):
    """Write `arrays` to the .npz file at path `file` as
    np.savez_compressed(file, **arrays) does (".npz" is appended to a name
    that lacks it), the deflate spread over the CPUs the process may use.
    The file is written and closed, and every deflate job has ended, on
    return. Returns (the deflate jobs, the threads that ran them)."""
    file = os.fspath(file)
    if not file.endswith(".npz"):
        file += ".npz"
    members = []
    for k, v in arrays.items():
        parts = _member(v)
        members.append((*_name(k), parts, sum(map(len, parts))))
    cpus = len(os.sched_getaffinity(0))
    pool = _executor(cpus)
    jobs = [[pool.submit(_deflate, parts, *b, size) for b in _bounds(size)]
            for _, _, parts, size in members]
    dos = _dos_time()
    central = []
    try:
        with open(file, "wb") as f:
            for (name, flags, parts, size), member_jobs in zip(members, jobs):
                crc = 0
                for p in parts:
                    crc = zlib.crc32(p, crc)
                out = [job.result() for job in member_jobs]
                csize = sum(map(len, out))
                offset = f.tell()
                f.write(_local_header(name, flags, crc, csize, size, dos))
                f.writelines(out)
                central.append(_central_header(name, flags, crc, csize, size,
                                               offset, dos))
            cd_offset = f.tell()
            f.writelines(central)
            f.write(_end_records(len(central), f.tell() - cd_offset,
                                 cd_offset))
    finally:
        every = list(itertools.chain.from_iterable(jobs))
        for job in every:
            job.cancel()
        wait(every)
    return len(every), min(cpus, len(every))
