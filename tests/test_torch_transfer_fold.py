"""The transfer folds of ops/transfer_fold.py on the CPU: the plain record
fold against a JAX lax.scan of make_voxel_update built as the JAX
pipeline's stream_seg builds it (raytracinggrff_tpu/pipeline.py:377-396),
the plain voxel fold against the JAX package's grff_transfer, the carry
across calls, the wrappers' dispatch and checks, and the kernel's
parameter struct against its CUDA source. The kernels themselves run in
tests/test_torch_cuda.py on a card.

Tolerance, float32 against float32 (JAX's XLA and torch's CPU kernels
round exp, log and pow differently in the last bits): rtol 1e-5 on flux
and on finite tau, with atol 1e-30 for the denormal range, where one
library flushes to zero and the other does not; the sets of zero flux and
of infinite tau (evanescent voxels) equal. With gyroresonance (mechanism
bit 2) rtol 2e-4, the bar of tests/test_torch_gyroresonance.py for the
float32 harmonic sum: its terms are exp(log_term) with log_term near -100,
where one last bit of the argument is 7.6e-6 of the term."""

import ctypes
import math
import re
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from raytracinggrff_tpu.grff import transfer as jtr
from raytracinggrff_tpu_torch import pipeline as ppipe
from raytracinggrff_tpu_torch.grff import transfer as ptr
from raytracinggrff_tpu_torch.ops import _build
from raytracinggrff_tpu_torch.ops import transfer_fold as tf

torch.set_num_threads(1)
AREA = (0.045 * 6.957e10) ** 2
R_SUN_CM = 6.957e10
THETA_DEG = 70.0
RTOL, RTOL_GR, ATOL = 1e-5, 2e-4, 1e-30


def _records(seed, n_rays=48, n_rec=32):
    """(n_rec, 8, n_rays) float32 records of rays walking from `start`,
    with invalid records of every kind: NaN positions (a ray that left,
    from some record on), S = 0 and S < 0, cos theta NaN, ne NaN on an
    otherwise valid record, and overdense voxels (ne 3e8 cm^-3: n^2 <= 0 in
    both modes at 75-89 MHz). cos theta spans [-1, 1] with exact zeros
    (the perpendicular dead zone)."""
    rng = np.random.default_rng(seed)
    start = rng.uniform(-1.0, 1.0, (n_rays, 3)).astype(np.float32)
    pos = start[None] + np.cumsum(rng.normal(0.0, 0.01, (n_rec, n_rays, 3)),
                                  axis=0)
    rec = np.empty((n_rec, 8, n_rays))
    rec[:, 0:3] = pos.transpose(0, 2, 1)
    rec[:, 3] = rng.uniform(0.2, 2.0, (n_rec, n_rays))
    rec[:, 4] = 10 ** rng.uniform(5.0, 7.6, (n_rec, n_rays))
    rec[:, 5] = 10 ** rng.uniform(4.0, 6.5, (n_rec, n_rays))
    rec[:, 6] = rng.uniform(0.0, 15.0, (n_rec, n_rays))
    rec[:, 7] = rng.uniform(-1.0, 1.0, (n_rec, n_rays))
    u = rng.random((n_rec, n_rays))
    rec[:, 7][u < 0.05] = 0.0
    rec[:, 3][(u > 0.05) & (u < 0.09)] = 0.0
    rec[:, 3][(u > 0.09) & (u < 0.11)] = -0.5
    rec[:, 7][(u > 0.11) & (u < 0.15)] = np.nan
    rec[:, 4][(u > 0.15) & (u < 0.17)] = np.nan
    rec[:, 4][(u > 0.17) & (u < 0.19)] = 3e8
    for ray, first in ((0, 5), (1, 20), (2, 0)):
        rec[first:, 0:3, ray] = np.nan
    return rec.astype(np.float32), start


def _jax_stream(recs_list, start, freqs, mechanism, gaunt, theta_los, s_on,
                s_max=30):
    """The JAX pipeline's stream_seg over consecutive segments: the ds/valid
    scan and make_voxel_update, with records whose row 7 is not finite
    masked under theta_los (the port's departure; README "Where the port
    departs", test_angle_less_records_match_masked_jax)."""
    update = jtr.make_voxel_update(freqs, AREA, THETA_DEG, mechanism,
                                   s_max=s_max, gaunt=gaunt)
    area32 = jnp.float32(AREA)
    scale = jnp.float32(R_SUN_CM)

    @jax.jit
    def stream_seg(tcarry, prev_pos, recs):
        def body(c, rec):
            tc, prev = c
            pos = rec[0:3].T
            s = rec[3]
            valid = (jnp.all(jnp.isfinite(pos), axis=1)
                     & jnp.isfinite(s) & (s > 0))
            if theta_los:
                valid = valid & jnp.isfinite(rec[7])
            psafe = jnp.where(valid[:, None], pos, prev)
            dsv = jnp.sqrt(jnp.sum((psafe - prev) ** 2, axis=1)) * scale
            dsv = jnp.where(valid, dsv, 0.0)
            sarea = s * area32 if s_on else jnp.zeros_like(s)
            theta_k = (jnp.arccos(jnp.clip(rec[7], -1.0, 1.0))
                       if theta_los else None)
            tc = update(tc, dsv, rec[5], rec[4], rec[6], valid, sarea,
                        theta_k)
            return (tc, psafe), None

        (tc, prev), _ = jax.lax.scan(body, (tcarry, prev_pos), recs)
        return tc, prev

    carry = jtr.transfer_carry_init(start.shape[0], len(freqs))
    prev = jnp.asarray(start)
    for recs in recs_list:
        carry, prev = stream_seg(carry, prev, jnp.asarray(recs))
    return [np.asarray(c) for c in carry], np.asarray(prev)


def _assert_carry_close(out, ref, mechanism):
    """Flux and finite tau to RTOL, or RTOL_GR with gyroresonance (ATOL
    for denormals); the zero-flux and infinite-tau sets equal."""
    rtol = RTOL_GR if mechanism & 2 else RTOL
    for i, (a, b) in enumerate(zip(out, ref)):
        a, b = np.asarray(a), np.asarray(b)
        np.testing.assert_array_equal(np.isinf(a), np.isinf(b), err_msg=i)
        np.testing.assert_array_equal(a == 0, b == 0, err_msg=i)
        fin = np.isfinite(b)
        np.testing.assert_allclose(a[fin], b[fin], rtol=rtol, atol=ATOL,
                                   err_msg=str(i))


def _freqs():
    return jtr.log_spaced_freqs(75e6, 3, 0.05)


def _t(a, dtype=torch.float32):
    return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype)


@pytest.mark.parametrize("s_on", [False, True])
@pytest.mark.parametrize("theta_los", [False, True])
@pytest.mark.parametrize("gaunt", ["dulk", "exact"])
@pytest.mark.parametrize("mechanism", [1, 5, 7])
def test_fold_records_plain_matches_jax_stream_seg(mechanism, gaunt,
                                                   theta_los, s_on):
    """Two segments of 16 records (48 rays, Nf 3) folded one after the
    other, as the pipelines fold them."""
    rec, start = _records(mechanism + 10 * theta_los + 20 * s_on)
    segs = [rec[:16], rec[16:]]
    freqs = _freqs()
    ref, ref_prev = _jax_stream(segs, start, freqs, mechanism, gaunt,
                                theta_los, s_on)
    carry = ptr.transfer_carry_init(start.shape[0], 3, "cpu")
    prev = _t(start)
    for seg in segs:
        carry, prev = tf.fold_records_plain(
            _t(seg), carry, prev, _t(freqs), AREA, THETA_DEG, mechanism,
            gaunt=gaunt, s_on=s_on, theta_los=theta_los)
    _assert_carry_close(carry, ref, mechanism)
    np.testing.assert_array_equal(prev.numpy(), ref_prev)
    assert np.isinf(ref[2]).any() and np.isfinite(ref[2]).any()
    assert (ref[0] > 0).mean() > 0.3


def _voxels(seed, nz=24, n_pix=40):
    """Step-major (nz, n_pix) voxels: ds, te, ne, b float32, valid bool,
    source areas (half 0: the pixel area), theta in degrees with exact 90s
    and values past 90 (swapped slots), and mechanism flags 0/1/4/5/7 per
    voxel; invalid voxels, a NaN ne on some, ds = 0 on some, and
    overdense ones."""
    rng = np.random.default_rng(seed)
    shape = (nz, n_pix)
    v = dict(ne=10 ** rng.uniform(5.0, 7.6, shape),
             te=10 ** rng.uniform(4.0, 6.5, shape),
             b=rng.uniform(0.0, 15.0, shape),
             ds=10 ** rng.uniform(8.0, 10.0, shape),
             sarea=np.where(rng.random(shape) < 0.5,
                            rng.uniform(0.2, 3.0, shape) * AREA, 0.0),
             theta=rng.uniform(2.0, 178.0, shape))
    v = {k: a.astype(np.float32) for k, a in v.items()}
    u = rng.random(shape)
    v["valid"] = u > 0.1
    v["ne"][(u > 0.1) & (u < 0.13)] = np.nan
    v["ds"][(u > 0.13) & (u < 0.15)] = 0.0
    v["ne"][(u > 0.15) & (u < 0.18)] = 3e8
    v["theta"][(u > 0.18) & (u < 0.22)] = 90.0
    v["mech"] = rng.choice(np.array([0, 1, 4, 5, 7], np.int32), shape)
    return v


@pytest.mark.parametrize("variant", ["fixed", "theta_sarea", "mech",
                                     "theta_mech_sarea"])
@pytest.mark.parametrize("gaunt", ["dulk", "exact"])
@pytest.mark.parametrize("mechanism", [1, 5, 7])
def test_fold_voxels_plain_matches_jax_grff_transfer(mechanism, gaunt,
                                                     variant):
    """fold_voxels_plain against the JAX package's grff_transfer (its
    _grff_transfer_jit scan) at a fixed or per-voxel theta, with or without
    source areas and a per-voxel mechanism mask (whose union is
    `mechanism`'s bits; mask values outside them are cut to them)."""
    v = _voxels(mechanism + 10 * len(variant))
    freqs = _freqs()
    per_theta = "theta" in variant
    sarea = v["sarea"] if "sarea" in variant else None
    mech = None
    mech_arg = mechanism
    if "mech" in variant:
        mech = v["mech"] & mechanism
        mech_arg = mech
        mechanism = int(np.bitwise_or.reduce(mech.reshape(-1)))
    theta_arg = v["theta"] if per_theta else THETA_DEG
    ref = jtr.grff_transfer(v["ds"], v["te"], v["ne"], v["b"], v["valid"],
                            freqs, AREA, s_area_cm2=sarea,
                            theta_deg=theta_arg, mechanism=mech_arg,
                            gaunt=gaunt)
    ref = [np.asarray(getattr(ref, k))
           for k in ("flux_o", "flux_x", "tau_o", "tau_x")]
    out = tf.fold_voxels_plain(
        _t(v["ds"]), _t(v["te"]), _t(v["ne"]), _t(v["b"]),
        _t(v["valid"], torch.bool), _t(freqs), AREA,
        None if sarea is None else _t(sarea),
        torch.deg2rad(_t(v["theta"])) if per_theta else None,
        None if mech is None else _t(mech, torch.int32),
        -1.0 if per_theta else THETA_DEG, mechanism, gaunt=gaunt)
    _assert_carry_close(out, ref, mechanism)
    assert np.isinf(ref[2]).any() and np.isfinite(ref[2]).any()
    # the GET_MW entry on the CPU runs this fold
    res = ptr.grff_transfer(v["ds"], v["te"], v["ne"], v["b"], v["valid"],
                            freqs, AREA, s_area_cm2=sarea,
                            theta_deg=theta_arg, mechanism=mech_arg,
                            gaunt=gaunt, device="cpu")
    for a, b in zip((res.flux_o, res.flux_x, res.tau_o, res.tau_x), out):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


@pytest.mark.parametrize("entry", ["records", "voxels"])
def test_carry_continues_across_calls(entry):
    """Two calls, the second from the first's carry (and last valid
    positions), equal one call over both halves, through the wrappers."""
    freqs = _t(_freqs())
    if entry == "records":
        rec, start = _records(3)
        rec, prev = _t(rec), _t(start)
        kw = dict(mechanism=7, gaunt="exact", s_on=True, theta_los=True)
        carry0 = ptr.transfer_carry_init(rec.shape[2], 3, "cpu")
        whole, prev_w = tf.fold_records(rec, carry0, prev, freqs, AREA,
                                        THETA_DEG, **kw)
        half, prev_h = tf.fold_records(rec[:11].contiguous(), carry0, prev,
                                       freqs, AREA, THETA_DEG, **kw)
        split, prev_s = tf.fold_records(rec[11:].contiguous(), half, prev_h,
                                        freqs, AREA, THETA_DEG, **kw)
        torch.testing.assert_close(prev_s, prev_w, rtol=0, atol=0,
                                   equal_nan=True)
    else:
        v = _voxels(4)
        args = [_t(v[k]) for k in ("ds", "te", "ne", "b")] + [
            _t(v["valid"], torch.bool)]
        extra = [_t(v["sarea"]), torch.deg2rad(_t(v["theta"])),
                 _t(v["mech"] & 5, torch.int32)]
        kw = dict(theta_deg=-1.0, mechanism=5)
        whole = tf.fold_voxels(*args, freqs, AREA, *extra, **kw)
        half = tf.fold_voxels(*(a[:9].contiguous() for a in args), freqs,
                              AREA, *(a[:9].contiguous() for a in extra),
                              **kw)
        split = tf.fold_voxels(*(a[9:].contiguous() for a in args), freqs,
                               AREA, *(a[9:].contiguous() for a in extra),
                               carry=half, **kw)
    for a, b in zip(split, whole):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert torch.isinf(whole[2]).any() and (whole[0] > 0).any()


def test_wrappers_run_the_plain_folds_on_the_cpu_and_check_inputs():
    """On CPU tensors each wrapper returns its plain version's result and
    launches nothing; a device with no kernel, mixed devices, a wrong type,
    shape or layout and an unknown Gaunt factor are refused; any harmonic
    cap is taken up to the device check."""
    rec, start = _records(5, n_rays=16, n_rec=6)
    rec, prev, freqs = _t(rec), _t(start), _t(_freqs())
    carry = ptr.transfer_carry_init(16, 3, "cpu")
    counts = dict(tf.LAUNCHES)
    out, prev_out = tf.fold_records(rec, carry, prev, freqs, AREA,
                                    theta_los=True, s_on=True)
    ref, prev_ref = tf.fold_records_plain(rec, carry, prev, freqs, AREA,
                                          theta_los=True, s_on=True)
    for a, b in zip((*out, prev_out), (*ref, prev_ref)):
        torch.testing.assert_close(a, b, rtol=0, atol=0, equal_nan=True)
    v = _voxels(6, nz=5, n_pix=16)
    vox = [_t(v[k]) for k in ("ds", "te", "ne", "b")] + [
        _t(v["valid"], torch.bool)]
    for a, b in zip(tf.fold_voxels(*vox, freqs, AREA),
                    tf.fold_voxels_plain(*vox, freqs, AREA)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert tf.LAUNCHES == counts

    meta = [t.to("meta") for t in (rec, prev, freqs)]
    with pytest.raises(ValueError, match="no transfer-fold kernel"):
        tf.fold_records(meta[0], tuple(c.to("meta") for c in carry),
                        meta[1], meta[2], AREA)
    with pytest.raises(ValueError, match="is on"):
        tf.fold_records(rec, carry, prev.to("meta"), freqs, AREA)
    with pytest.raises(TypeError, match="float32"):
        tf.fold_records(rec.double(), carry, prev, freqs, AREA)
    with pytest.raises(ValueError, match="contiguous"):
        tf.fold_records(rec, carry, prev.T.contiguous().T, freqs, AREA)
    with pytest.raises(ValueError, match="recs must be"):
        tf.fold_records(rec[:, :7].contiguous(), carry, prev, freqs, AREA)
    with pytest.raises(ValueError, match="gaunt"):
        tf.fold_records(rec, carry, prev, freqs, AREA, gaunt="born")
    with pytest.raises(TypeError, match="torch.bool"):
        tf.fold_voxels(*vox[:4], vox[4].to(torch.uint8), freqs, AREA)
    with pytest.raises(ValueError, match="sarea must be"):
        tf.fold_voxels(*vox, freqs, AREA, sarea=vox[0][:, :8].contiguous())
    for mechanism in (5, 7):
        with pytest.raises(ValueError, match="no transfer-fold kernel"):
            tf.fold_voxels(*(t.to("meta") for t in vox), freqs.to("meta"),
                           AREA, mechanism=mechanism, s_max=200)
        with pytest.raises(ValueError, match="no transfer-fold kernel"):
            tf.fold_records(meta[0], tuple(c.to("meta") for c in carry),
                            meta[1], meta[2], AREA, mechanism=mechanism,
                            s_max=200)


def test_fold_params_mirror_the_cuda_struct():
    """ops/_build._FoldParams lists the fields of struct FoldParams in
    csrc/transfer_fold.cu in its order and types, scalars only (the harmonic
    tables are a device array of their own), and the parameters carry the
    physics constants as the float32 values the plain version's torch ops
    use, and the lanes a ray."""
    src = (Path(_build.CSRC) / "transfer_fold.cu").read_text()
    body = re.search(r"struct FoldParams \{(.*?)\n\};", src, re.S).group(1)
    fields = []
    for ctype, names in re.findall(r"^\s*(\w+) ([^;]+);", body, re.M):
        for name in names.split(","):
            fields.append((name.strip(), ctype))
    want = [(name, "int" if ct is ctypes.c_int else "float")
            for name, ct in _build._FoldParams._fields_]
    assert fields == want
    assert all(ct in (ctypes.c_int, ctypes.c_float)
               for _, ct in _build._FoldParams._fields_)
    p = tf.fold_params(8, 3, 4, AREA, 120.0, 7, 30, "exact", True, True)
    assert (p.mechanism, p.gaunt_exact, p.s_max, p.theta_per_voxel,
            p.s_on, p.group) == (7, 1, 30, 1, 1, 8)
    assert p.theta0 == np.float32(np.deg2rad(120.0))
    assert p.fpe_sq == np.float32(8.93e3 ** 2)
    assert p.inv_mec2 == np.float32(1.0) / np.float32(9.1094e-28
                                                       * 2.998e10 ** 2)
    # enough rays: the next power of two >= min(Nf, 8)
    assert [tf.group_size(nf, 2 ** 20) for nf in range(1, 12)] == [
        1, 2, 4, 4, 8, 8, 8, 8, 8, 8, 8]
    # the canonical segment and the sweep's (65,536 and 16,384 rays)
    assert tf.group_size(3, 65536) == 4 and tf.group_size(1, 65536) == 1
    assert tf.group_size(1, 16384) == 4 and tf.group_size(4, 16384) == 4
    assert tf.group_size(1, 8192) == 8 and tf.group_size(1, 1) == 8
    n = 65536 * 4
    assert tf.fold_params(n, 9, 4, AREA, 90.0, 5, 30, "dulk", False).group \
        == 8


def test_harmonic_tables_keep_their_float32_values_and_grow_with_s_max():
    """_build._harmonic_tables(s_max): 2 ln s and lgamma(s + 1) at column s
    as float32, the values the fold's table held up to s = 128 and the
    plain version's per-harmonic tensors hold, for any s_max."""
    for s_max in (30, 128, 200, 1000):
        tab = _build._harmonic_tables(s_max)
        assert tab.shape == (2, s_max + 1) and tab.dtype == np.float32
        assert (tab[:, :2] == 0).all()
        for s in sorted({2, 3, 30, min(128, s_max), s_max}):
            assert tab[0, s] == np.float32(2.0 * math.log(s))
            assert tab[1, s] == np.float32(math.lgamma(s + 1))
        harmonics = range(2, s_max + 1)
        np.testing.assert_array_equal(
            tab[0, 2:], torch.tensor([2.0 * math.log(k) for k in harmonics],
                                     dtype=torch.float32).numpy())
        np.testing.assert_array_equal(
            tab[1, 2:], torch.tensor([math.lgamma(k + 1) for k in harmonics],
                                     dtype=torch.float32).numpy())
    small, large = _build._harmonic_tables(128), _build._harmonic_tables(200)
    np.testing.assert_array_equal(large[:, :129], small)
    assert np.isfinite(large).all() and (np.diff(large[:, 2:]) > 0).all()
    assert _build._harmonic_tables(0).shape == (2, 2)


@pytest.mark.parametrize("entry", ["records", "voxels"])
def test_plain_folds_match_jax_above_128_harmonics(entry):
    """The plain folds at s_max = 200 (Parms[7] above the kernel's former
    cap of 128), mechanism 7, against the JAX stream_seg and grff_transfer
    (_grff_transfer_jit) at the same cap, to the mechanism-7 tolerance."""
    freqs = _freqs()
    if entry == "records":
        rec, start = _records(41)
        segs = [rec[:16], rec[16:]]
        ref, ref_prev = _jax_stream(segs, start, freqs, 7, "dulk", True,
                                    True, s_max=200)
        carry = ptr.transfer_carry_init(start.shape[0], 3, "cpu")
        prev = _t(start)
        for seg in segs:
            carry, prev = tf.fold_records_plain(
                _t(seg), carry, prev, _t(freqs), AREA, THETA_DEG, 7,
                s_max=200, s_on=True, theta_los=True)
        np.testing.assert_array_equal(prev.numpy(), ref_prev)
    else:
        v = _voxels(42)
        ref = jtr.grff_transfer(v["ds"], v["te"], v["ne"], v["b"],
                                v["valid"], freqs, AREA,
                                s_area_cm2=v["sarea"], theta_deg=v["theta"],
                                mechanism=7, s_max=200)
        ref = [np.asarray(getattr(ref, k))
               for k in ("flux_o", "flux_x", "tau_o", "tau_x")]
        carry = tf.fold_voxels_plain(
            _t(v["ds"]), _t(v["te"]), _t(v["ne"]), _t(v["b"]),
            _t(v["valid"], torch.bool), _t(freqs), AREA, _t(v["sarea"]),
            torch.deg2rad(_t(v["theta"])), theta_deg=-1.0, mechanism=7,
            s_max=200)
    _assert_carry_close(carry, ref, 7)
    assert np.isinf(ref[2]).any() and np.isfinite(ref[2]).any()


def test_pipelines_fold_once_per_segment_and_per_call(monkeypatch):
    """run_ray_tracing_emission folds each trace segment with one
    fold_records call, and get_mw_slice (the LOS chain's synthetic_ff)
    folds every voxel with one fold_voxels call."""
    calls = {"records": 0, "voxels": 0}
    records, voxels = tf.fold_records, tf.fold_voxels

    def count(name, fn):
        def wrapped(*args, **kw):
            calls[name] += 1
            return fn(*args, **kw)
        return wrapped

    monkeypatch.setattr(tf, "fold_records", count("records", records))
    monkeypatch.setattr(tf, "fold_voxels", count("voxels", voxels))
    n = 24
    grid_ax = np.linspace(-2.0, 2.0, n)
    x, y, z = np.meshgrid(grid_ax, grid_ax, grid_ax, indexing="ij")
    r = np.sqrt(x * x + y * y + z * z)
    ne = np.where(r >= 1.0, 4.2e4 * 10 ** (4.32 / np.maximum(r, 0.9)),
                  0.0).astype(np.float32)
    cubes = {"omega_pe": (8.93e3 * np.sqrt(ne) * 2 * np.pi).astype(
        np.float32), "ne": ne, "te": np.full_like(ne, 1.4e6),
        "b": np.ones_like(ne)}
    timings = {}
    res = ppipe.run_ray_tracing_emission(
        cubes=cubes, n_pix=4, x_fov=1.3, freq_hz=150e6, grid_n=n,
        grid_extent=2.0, z_observer=2.0, dt=1e-2, n_steps=300, nfreq=2,
        seg_records=8, verbose=False, device="cpu", timings=timings)
    assert timings["segments"] == 4 == calls["records"]
    assert calls["voxels"] == 0
    assert np.isfinite(res["emission_cube"]).all()
    ptr.get_mw_slice(*(np.ones((5, 3)) * k for k in (1e9, 1e6, 1e8, 1.0)),
                     np.ones((5, 3), bool), 300e6, 2, 0.1, AREA,
                     device="cpu")
    assert calls == {"records": 4, "voxels": 1}
