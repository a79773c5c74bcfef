"""Sample the model fields (Ne, Te, |B|) along traced rays, with segment
lengths, in torch (gpu_raytrace.py:632-759; raytracinggrff_tpu/sampler.py).

The three fields share their corner gathers through one packed table, and
ds is the distance between consecutive *valid* samples, anchored at the
ray start (_compute_ds_from_valid, gpu_raytrace.py:473-486), a scan that
ops/los_scans.py runs (los_scans.record_step is its one step):

    valid_mask = all(isfinite(pos)) & isfinite(s) & (s > 0)
    ne/te/b: out-of-bounds or non-finite field value -> fill_ne/te/b
    ds[t] = |p[t] - prev_valid| * r_sun_cm at valid t, else 0
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .constants import FILL_B, FILL_NE, FILL_TE, R_SUN_CM
from .grids import UniformGrid
from .ops.los_scans import valid_ds
from .ops.trilinear import pack_fields, trilinear_packed


class LosSamples(NamedTuple):
    ne: torch.Tensor          # (n_steps, n_rays)
    te: torch.Tensor
    b: torch.Tensor
    ds: torch.Tensor          # cm
    valid_mask: torch.Tensor  # bool
    s: torch.Tensor           # cross-section ratio as passed in
    cos_theta: torch.Tensor | None = None  # signed cos(B, k); None w/o bvec


def pack_model_table(ne_cube, te_cube, b_cube, bvec=None):
    """Pack the field cubes into one (N, C) gather table; with `bvec` (the
    three image-frame B-component cubes) it has 6 channels and the
    sampler also returns cos(theta) between B and the propagation
    direction (theta_mode='los')."""
    if bvec is None:
        return pack_fields(ne_cube, te_cube, b_cube)
    return pack_fields(ne_cube, te_cube, b_cube, *bvec)


def valid_and_ds(pos, s, ray_start, r_sun_cm=R_SUN_CM, usable=None):
    """The validity mask and ds of records pos (n_steps, n_rays, 3) and s
    (n_steps, n_rays), scanned from ray_start (n_rays, 3), with an optional
    bool `usable` (n_steps, n_rays): ops/los_scans.valid_ds, a CUDA kernel
    on the card and one los_scans.record_step a record on the CPU."""
    return valid_ds(pos.contiguous(), s.contiguous(), ray_start.contiguous(),
                    r_sun_cm,
                    None if usable is None else usable.contiguous())


def sample_model_with_rays(model_table, grid: UniformGrid, r_record, s_arr,
                           ray_start, r_sun_cm: float = R_SUN_CM,
                           fill_ne: float = FILL_NE,
                           fill_te: float = FILL_TE,
                           fill_b: float = FILL_B,
                           k_record=None) -> LosSamples:
    """Sample a packed table along records r_record (n_steps, n_rays, 3)
    with cross-sections s_arr (n_steps, n_rays) and ray starts (n_rays,
    3), all on the table's device. With a 6-channel table, cos_theta is
    taken against k_record (n_steps, n_rays, 3), the wave vectors at the
    records, or else against the record-to-record direction."""
    device = model_table.device

    def t(a):
        return torch.as_tensor(a, dtype=torch.float32, device=device)

    pos, s, ray_start = t(r_record), t(s_arr), t(ray_start)
    v, _ = trilinear_packed(model_table, grid, pos[..., 0], pos[..., 1],
                            pos[..., 2])
    nch = v.shape[-1]
    fills = t([fill_ne, fill_te, fill_b] + [0.0] * (nch - 3))
    v = torch.where(torch.isfinite(v), v, fills)
    valid, ds = valid_and_ds(pos, s, ray_start, r_sun_cm)
    cos_t = None
    if nch >= 6:
        cos_t = (cos_theta_signed(t(k_record), v[..., 3:6])
                 if k_record is not None
                 else _cos_theta_from_records(pos, v[..., 3:6]))
    return LosSamples(ne=v[..., 0], te=v[..., 1], b=v[..., 2], ds=ds,
                      valid_mask=valid, s=s, cos_theta=cos_t)


def _signed_cos(bv, dirs):
    num = torch.sum(bv * dirs, dim=-1)
    den = (torch.sqrt(torch.sum(bv * bv, dim=-1))
           * torch.sqrt(torch.sum(dirs * dirs, dim=-1)))
    return torch.clamp(num / torch.clamp(den, min=1e-30), -1.0, 1.0)


def cos_theta_signed(kvec, bv):
    """Signed cos(theta) between the sampled B vector and the wave vector
    at the record step, the definition the trace kernel evaluates for
    record row 7. Zero B or zero k give cos = 0, the theta = 90 fallback
    (Parms[4], resample_with_ray_tracing.py:489-501)."""
    return _signed_cos(bv, kvec)


def _cos_theta_from_records(pos, bv):
    """Without wave vectors: signed cos(theta) between B and the
    record-to-record direction, the last record reusing the previous one;
    zero-length steps or zero B give cos = 0."""
    if pos.shape[0] > 1:
        d = pos[1:] - pos[:-1]
        dirs = torch.cat([d, d[-1:]], dim=0)
    else:
        dirs = torch.zeros_like(pos)
    return _signed_cos(bv, dirs)


def los_from_records(r_record, s_arr, ne, te, b, ray_start,
                     r_sun_cm=R_SUN_CM):
    """LosSamples from records whose fields the trace kernel already
    sampled: only the validity mask and ds remain to compute. Tensors on
    one device."""
    f32 = torch.float32
    pos = r_record.to(f32)
    s = s_arr.to(f32)
    valid, ds = valid_and_ds(pos, s, ray_start.to(f32), r_sun_cm)
    return LosSamples(ne=ne.to(f32), te=te.to(f32), b=b.to(f32), ds=ds,
                      valid_mask=valid, s=s)


def sample_model_with_rays_arrays(x_grid, y_grid, z_grid, ne_xyz, te_xyz,
                                  b_xyz, r_record, s_arr, ray_start,
                                  r_sun_cm=R_SUN_CM, fill_ne=FILL_NE,
                                  fill_te=FILL_TE, fill_b=FILL_B,
                                  device="cuda"):
    """Reference-signature wrapper (gpu_raytrace.py:712-759) on `device`,
    returning a dict of tensors."""
    grid = UniformGrid.from_arrays(x_grid, y_grid, z_grid)
    table = pack_model_table(*(torch.as_tensor(c, dtype=torch.float32,
                                               device=device)
                               for c in (ne_xyz, te_xyz, b_xyz)))
    out = sample_model_with_rays(table, grid, r_record, s_arr, ray_start,
                                 float(r_sun_cm), float(fill_ne),
                                 float(fill_te), float(fill_b))
    return {"ne": out.ne, "te": out.te, "b": out.b, "ds": out.ds,
            "valid_mask": out.valid_mask, "s": out.s}
