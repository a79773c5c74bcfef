"""utils/npz.savez_compressed against np.savez_compressed: the same arrays,
dtypes, orders and member names read back, a ZIP that zipfile and np.load
accept (ZIP64 fields included), the same path rule, the same deflate
level within 1% of numpy's size, and a file that does not depend on the
number of threads."""

import os
import threading
import time
import zipfile
import zlib

import numpy as np
import pytest

from raytracinggrff_tpu_torch.utils import npz

SHAPES = {
    "0d": lambda a: a[:1].reshape(()),
    "empty": lambda a: a[:0],
    "1d": lambda a: a,
    "map": lambda a: np.resize(a, (256, 256, 3)),
    "fortran": lambda a: np.asfortranarray(np.resize(a, (40, 30))),
    "strided": lambda a: np.resize(a, (40, 30))[::3, 1::2],
}


def map_like(rng, shape=(256, 256, 3)):
    """A float64 T_b-like cube: a smooth disk with float32 noise."""
    x = np.linspace(-1.0, 1.0, shape[0])
    disk = 1e6 * np.exp(-(x[:, None] ** 2 + x[None, :] ** 2))
    noise = 1.0 + 1e-3 * rng.standard_normal(shape)
    return (disk[:, :, None] * noise).astype(np.float32).astype(np.float64)


def both(tmp_path, **arrays):
    """The files of np.savez_compressed and of npz.savez_compressed."""
    np.savez_compressed(tmp_path / "numpy.npz", **arrays)
    npz.savez_compressed(tmp_path / "port.npz", **arrays)
    return tmp_path / "numpy.npz", tmp_path / "port.npz"


def assert_same_arrays(a_path, b_path):
    with np.load(a_path, allow_pickle=True) as a, \
            np.load(b_path, allow_pickle=True) as b:
        assert a.files == b.files
        for k in a.files:
            x, y = a[k], b[k]
            assert (x.dtype, x.shape) == (y.dtype, y.shape), k
            assert x.flags.f_contiguous == y.flags.f_contiguous, k
            assert x.flags.c_contiguous == y.flags.c_contiguous, k
            if x.dtype.hasobject:
                assert x.tolist() == y.tolist(), k
            else:
                np.testing.assert_array_equal(x, y, strict=True)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("dtype", [np.float64, np.float32, np.int64, bool])
def test_round_trip_matches_numpy(tmp_path, dtype, shape):
    base = np.random.default_rng(7).normal(0.0, 1e3, 1200).astype(dtype)
    arrays = {"a": SHAPES[shape](base), "b": base[:5]}
    numpy_file, port_file = both(tmp_path, **arrays)
    assert_same_arrays(numpy_file, port_file)
    with zipfile.ZipFile(port_file) as z:
        assert z.testzip() is None
        assert z.namelist() == ["a.npy", "b.npy"]
        assert all(i.compress_type == zipfile.ZIP_DEFLATED
                   for i in z.infolist())


def test_odd_members_match_numpy(tmp_path):
    """Objects and structured dtypes (numpy's writer whole), a non-ASCII
    name, a byte-swapped array, and no member at all."""
    arrays = {
        "objects": np.array([{"a": 1}, None, "x"], dtype=object),
        "record": np.zeros(4, dtype=[("x", "<f4"), ("y", "<i8")]),
        "température": np.arange(5.0),
        "swapped": np.arange(6, dtype=">i4"),
        "text": np.array(["ab", "c"]),
    }
    assert_same_arrays(*both(tmp_path, **arrays))
    with zipfile.ZipFile(tmp_path / "port.npz") as z:
        assert z.testzip() is None
        assert "température.npy" in z.namelist()
    assert_same_arrays(*both(tmp_path))


@pytest.mark.parametrize("name", ["map", "map.npz", "map.npy", "m.npz.bak"])
def test_npz_is_appended_as_numpy_does(tmp_path, name):
    for write, where in ((np.savez_compressed, "numpy"),
                         (npz.savez_compressed, "port")):
        (tmp_path / where).mkdir()
        write(tmp_path / where / name, x=np.arange(3))
        write(str(tmp_path / where / ("str_" + name)), x=np.arange(3))
    made = sorted(os.listdir(tmp_path / "port"))
    assert made == sorted(os.listdir(tmp_path / "numpy"))
    assert all(m.endswith(".npz") for m in made) and len(made) == 2


def test_map_member_size_within_one_percent_of_numpy(tmp_path):
    rng = np.random.default_rng(3)
    numpy_file, port_file = both(tmp_path, emission_cube=map_like(rng))
    numpy_size, port_size = (os.path.getsize(p) for p in (numpy_file,
                                                          port_file))
    assert abs(port_size - numpy_size) <= 0.01 * numpy_size
    assert_same_arrays(numpy_file, port_file)


def test_chunks_follow_the_member_size():
    """A 256^2 x 3 float64 cube is cut into chunks of at least CHUNK; a
    128^2 map (a sweep's) is one job; the chunks tile the member."""
    for size, n in [(256 * 256 * 3 * 8 + 128, 12), (128 * 128 * 8 + 128, 1),
                    (100, 1), (0, 1), (2 * npz.CHUNK - 1, 1)]:
        bounds = npz._bounds(size)
        assert len(bounds) == n
        assert bounds[0][0] == 0 and bounds[-1][1] == size
        assert all(b[1] == c[0] for b, c in zip(bounds, bounds[1:]))
        assert all(e - s >= npz.CHUNK for s, e in bounds) or n == 1


def test_chunks_join_into_one_deflate_stream():
    data = memoryview(map_like(np.random.default_rng(5)).tobytes())
    bounds = npz._bounds(len(data))
    assert len(bounds) > 1
    stream = b"".join(npz._deflate([data], s, e, len(data))
                      for s, e in bounds)
    assert zlib.decompress(stream, -15) == data.tobytes()
    serial = zlib.compressobj(zlib.Z_DEFAULT_COMPRESSION, zlib.DEFLATED, -15)
    whole = serial.compress(data) + serial.flush()
    assert len(stream) <= 1.01 * len(whole)


@pytest.mark.parametrize("cpus", [1, 8])
def test_threads_follow_the_cpus(tmp_path, monkeypatch, cpus):
    """With 1 and with 8 CPUs the file reads back as numpy's and its
    members' bytes are the same; the counts report the jobs and the
    threads that ran them."""
    rng = np.random.default_rng(11)
    arrays = {"emission_cube": map_like(rng),
              "emission_polVI_cube": map_like(rng) * 1e-9,
              "frequencies_Hz": np.array([75e6, 84e6, 94e6])}
    ran = []
    deflate = npz._deflate

    def counted(*args):
        ran.append(threading.current_thread().name)
        return deflate(*args)

    monkeypatch.setattr(npz, "_deflate", counted)
    monkeypatch.setattr(os, "sched_getaffinity", lambda pid: set(range(cpus)))
    chunks, threads = npz.savez_compressed(tmp_path / "port.npz", **arrays)
    assert chunks == len(ran) == 12 + 12 + 1
    assert threads == min(cpus, chunks)
    assert 1 <= len(set(ran)) <= threads
    assert all(name.startswith("npz-deflate") for name in ran)
    np.savez_compressed(tmp_path / "numpy.npz", **arrays)
    assert_same_arrays(tmp_path / "numpy.npz", tmp_path / "port.npz")
    monkeypatch.setattr(os, "sched_getaffinity", lambda pid: {0, 1, 2})
    npz.savez_compressed(tmp_path / "three.npz", **arrays)
    with zipfile.ZipFile(tmp_path / "port.npz") as a, \
            zipfile.ZipFile(tmp_path / "three.npz") as b:
        for x, y in zip(a.infolist(), b.infolist()):
            assert (x.CRC, x.compress_size) == (y.CRC, y.compress_size)


def test_zip64_fields_read_back(tmp_path, monkeypatch):
    """With the ZIP64 limit at 0 every size, offset and the central
    directory take their ZIP64 fields; zipfile and np.load read the file
    as numpy's."""
    monkeypatch.setattr(npz, "_LIMIT", 0)
    rng = np.random.default_rng(13)
    numpy_file, port_file = both(tmp_path, a=map_like(rng, (64, 64, 2)),
                                 b=np.arange(10), c=np.zeros(()))
    assert_same_arrays(numpy_file, port_file)
    with zipfile.ZipFile(port_file) as z:
        assert z.testzip() is None
        assert [i.header_offset > 0 for i in z.infolist()] == [False, True,
                                                                True]
    raw = port_file.read_bytes()
    assert raw.count(b"PK\x06\x06") == 1 and raw.count(b"PK\x06\x07") == 1


def test_a_failed_job_ends_every_job(tmp_path, monkeypatch):
    """An error in one deflate job is raised, and on return every job
    that started has ended and none starts later."""
    deflate = npz._deflate
    events = []

    def failing(parts, start, end, size):
        events.append("start")
        try:
            if start == 0:
                raise MemoryError("planted")
            return deflate(parts, start, end, size)
        finally:
            events.append("end")

    monkeypatch.setattr(npz, "_deflate", failing)
    rng = np.random.default_rng(17)
    with pytest.raises(MemoryError, match="planted"):
        npz.savez_compressed(tmp_path / "x.npz", a=map_like(rng),
                             b=map_like(rng))
    seen = list(events)
    assert seen.count("start") == seen.count("end") >= 1
    time.sleep(0.2)
    assert events == seen
