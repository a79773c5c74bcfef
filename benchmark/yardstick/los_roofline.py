"""The LOS chain's kernels' operations, bytes and bounds: frozen copies of
chip_smoke.py's SAMPLE_FLOPS, sample_bound and fold_voxels_bound, so that
a change to the program cannot move the yardstick.

Each bound takes counts where chip_smoke takes the tensors themselves:
the sampler's points, values (points times variables) and the floats of
the distinct arrays and axes it reads; the voxel fold's voxels, those
flagged valid and those it takes. What the configuration fixes comes from
the configuration (sample_counts, and the voxels n_pix^2 x n_z); the
program gives only what the data decide, the voxels flagged and taken,
summed over its calls, in a unit's timings ("los_flagged", "los_taken")
while traced. The arithmetic is chip_smoke's.
"""

from __future__ import annotations

from .fold_roofline import fold_flops
from .roofline import bound

# float32 operations of a sample at one point and one variable:
# csrc/resample_sph.cu's fmod 1, three axis fractions 3 each, the r bounds
# 2 and seven lerps 4 each
SAMPLE_FLOPS = 40
# the kernels' names in the profiler's events
SAMPLE_KERNEL = "sample_sph_kernel"
FOLD_KERNEL = "fold_voxels_kernel"
FOLD_COUNTS = ("los_flagged", "los_taken")
# the MAS variables the LOS chain samples: rho, t, br, bt, bp
N_VARIABLES = 5


def sample_counts(n_pix, n_z, scene):
    """(points, values, scene floats) of one sampler launch of the LOS
    chain at n_pix^2 pixels and n_z samples a pixel on the scene of the
    configuration: N_VARIABLES values a point, and N_VARIABLES fields on
    the scene's one (nphi, ntheta, nr) mesh (benchmark/gen/mas.py) with
    the three axes they share, each read once; phi is read closed by one
    periodic column, as a MAS reader pads it (the reference's
    mas_model)."""
    points = n_pix ** 2 * n_z
    axes = (scene["nphi"] + 1, scene["ntheta"], scene["nr"])
    mesh = axes[0] * axes[1] * axes[2]
    return points, N_VARIABLES * points, N_VARIABLES * mesh + sum(axes)


def sample_bound_ms(points, sampled, scene_floats):
    """Least time for sampler launches of `points` query points and
    `sampled` values: SAMPLE_FLOPS a value, the three queries read once,
    each value written once and each distinct array and axis read once.
    Returns (ms, "operations" or "bytes")."""
    nbytes = 4 * (3 * points + sampled + scene_floats)
    return bound(SAMPLE_FLOPS * sampled, nbytes)


def fold_voxels_bound_ms(voxels, flagged, taken, n_pix, nf, mechanism,
                         gaunt="dulk", extra=0, theta=False, carry=False):
    """Least time for one voxel fold of `voxels` voxels over n_pix pixels
    at nf frequencies, of which `flagged` were flagged valid and `taken`
    taken (finite fields, ds > 0). Operations: fold_flops of the voxels
    taken, and sin and cos of a per-voxel theta. Bytes: the flags of all
    voxels, ds/te/ne/b of the flagged ones, the `extra` per-voxel arrays
    (sarea, theta, mech) of the taken ones, the frequencies, the carry
    read (with `carry`) and written once. Returns (ms, "operations" or
    "bytes")."""
    ops = taken * (fold_flops(nf, mechanism, gaunt) + 2 * int(theta))
    nbytes = (voxels + 4 * (4 * flagged + extra * taken + nf)
              + 4 * 4 * n_pix * nf * (1 + int(carry)))
    return bound(ops, nbytes)


def _counted(run, names):
    return [u["timings"] for u in run.units
            if all(k in u.get("timings", {}) for k in names)]


def _kernel_ms(run, kernel):
    return sum(us for name, us in run.kernel_us.items()
               if kernel in name) / 1e3


def sample_roofline(run, points, sampled, scene_floats):
    """The sampler's least time over the window's units (one launch of
    sample_counts' `points`, `sampled` and `scene_floats` a unit), over
    its kernel's device time in the profiler's events, %. None where no
    unit completed or no sampler kernel ran."""
    kernel_ms = _kernel_ms(run, SAMPLE_KERNEL)
    if not run.units or not kernel_ms:
        return None
    least = len(run.units) * sample_bound_ms(points, sampled,
                                             scene_floats)[0]
    return 100.0 * least / kernel_ms


def voxel_fold_roofline(run, n_pix, n_z, nf, mechanism, gaunt="dulk"):
    """The voxel fold's least time over the window's units (one fold of
    n_z voxels x n_pix pixels a unit), from their counts of voxels flagged
    and taken, over its kernel's device time in the profiler's events, %.
    None where no unit carries the counts or no voxel-fold kernel ran."""
    units, kernel_ms = _counted(run, FOLD_COUNTS), _kernel_ms(run,
                                                              FOLD_KERNEL)
    if not units or not kernel_ms:
        return None
    least = sum(fold_voxels_bound_ms(n_z * n_pix, *(t[k] for k in
                                                    FOLD_COUNTS),
                                     n_pix, nf, mechanism, gaunt)[0]
                for t in units)
    return 100.0 * least / kernel_ms
