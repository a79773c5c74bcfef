"""NaN patching for emission maps (raytracingGRFF/util.py:6-77).

Each NaN pixel becomes the mean of the nearest finite pixel in the four
axis directions (directions with none are left out), for up to 10 passes,
stopping once nothing is NaN or nothing could be fixed.

`patch_nan_emission_map` is the reference-exact NumPy version: it patches
in place in row-major order within a pass, so a pixel fixed earlier in a
pass feeds later pixels of the same pass ([1, nan, nan, 4] becomes
[1, 2.5, 3.25, 4]). `patch_nan_emission_map_sim` is the torch variant for
large maps: all NaNs of a pass update at once, so isolated NaNs match the
reference exactly while the inside of wide NaN blobs can differ.
"""

from __future__ import annotations

import numpy as np
import torch


def _patch_2d_seq(a: np.ndarray, max_passes: int = 10) -> None:
    """Sequential in-place passes with the reference's propagation order."""
    for _ in range(max_passes):
        bad = np.argwhere(~np.isfinite(a))      # row-major order
        if bad.size == 0:
            return
        fixed = 0
        for i, j in bad:
            vals = []
            row = a[i]
            col = a[:, j]
            left = np.flatnonzero(np.isfinite(row[:j]))
            if left.size:
                vals.append(row[left[-1]])
            right = np.flatnonzero(np.isfinite(row[j + 1:]))
            if right.size:
                vals.append(row[j + 1 + right[0]])
            down = np.flatnonzero(np.isfinite(col[:i]))
            if down.size:
                vals.append(col[down[-1]])
            up = np.flatnonzero(np.isfinite(col[i + 1:]))
            if up.size:
                vals.append(col[i + 1 + up[0]])
            if vals:
                a[i, j] = np.mean(vals)
                fixed += 1
        if fixed == 0:
            return


def patch_nan_emission_map(emission, inplace: bool = False):
    """Patch the NaN pixels of a 2D (ny, nx) or 3D (ny, nx, nf) map, in
    the reference's sequential order (see the module docstring)."""
    out = (emission if inplace and isinstance(emission, np.ndarray)
           else np.array(emission, dtype=np.float64, copy=True))
    if out.ndim == 2:
        _patch_2d_seq(out)
    elif out.ndim == 3:
        for k in range(out.shape[2]):
            _patch_2d_seq(out[:, :, k])
    else:
        raise ValueError("emission must be 2D or 3D")
    return out


def _nearest_finite_before(a, finite, dim):
    """Value of the nearest finite element strictly before each position
    along `dim` (NaN where there is none), from a running max of the
    indices of finite elements."""
    n = a.shape[dim]
    shape = [1] * a.dim()
    shape[dim] = n
    idx = torch.arange(n, device=a.device).reshape(shape).expand(a.shape)
    last = torch.cummax(torch.where(finite, idx, -1), dim=dim).values
    last = torch.cat([torch.full_like(last.narrow(dim, 0, 1), -1),
                      last.narrow(dim, 0, n - 1)], dim=dim)
    vals = torch.gather(a, dim, torch.clamp(last, min=0))
    return torch.where(last >= 0, vals, torch.nan)


def _patch_pass(a):
    finite = torch.isfinite(a)
    near = []
    for dim in (1, 0):
        near.append(_nearest_finite_before(a, finite, dim))
        near.append(_nearest_finite_before(
            a.flip(dim), finite.flip(dim), dim).flip(dim))
    stack = torch.stack(near)
    ok = torch.isfinite(stack)
    cnt = ok.sum(dim=0)
    mean = (torch.where(ok, stack, 0.0).sum(dim=0)
            / torch.clamp(cnt, min=1))
    return torch.where(finite | (cnt == 0), a, mean)


def patch_nan_emission_map_sim(emission, inplace: bool = False,
                               max_passes: int = 10, device="cuda"):
    """Simultaneous-update NaN patch of a 2D or 3D map on `device`, in
    float64: the directional-mean contract of patch_nan_emission_map
    without its in-pass sequential propagation. Returns float64 numpy."""
    arr = np.array(emission, dtype=np.float64, copy=True)
    if arr.ndim not in (2, 3):
        raise ValueError("emission must be 2D or 3D")
    a = torch.as_tensor(arr, device=device)
    planes = [a] if a.dim() == 2 else list(a.unbind(dim=2))
    for i, p in enumerate(planes):
        for _ in range(max_passes):
            p = _patch_pass(p)
        planes[i] = p
    out = (planes[0] if a.dim() == 2
           else torch.stack(planes, dim=2)).cpu().numpy()
    if inplace and isinstance(emission, np.ndarray):
        emission[...] = out
        return emission
    return out
