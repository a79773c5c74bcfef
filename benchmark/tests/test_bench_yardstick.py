"""The frozen arithmetic gives the numbers of the code it was copied
from."""

import pytest
import torch

import chip_smoke
import profile_slice
from benchmark.yardstick import device_trace, roofline
from raytracinggrff_tpu_torch.harness import steps_run


def test_steps_run():
    assert roofline.steps_run(5000, 10) == 4991 == steps_run(5000, 10)
    for n, stride in ((1, 1), (12000, 5), (2200, 8), (7, 3)):
        assert roofline.steps_run(n, stride) == steps_run(n, stride)


def test_constants_match_chip_smoke():
    assert roofline.PEAK_F32_FLOPS == chip_smoke.PEAK_F32_FLOPS
    assert roofline.PEAK_BYTES_S == chip_smoke.PEAK_BYTES_S
    assert roofline.FLOPS_PER_STEP == chip_smoke.FLOPS_PER_STEP
    assert roofline.FLOPS_PER_RECORD == chip_smoke.FLOPS_PER_RECORD


@pytest.mark.parametrize("n_first, channels", [(1, 4), (10, 4), (10, 8)])
def test_segment_bound_matches_chip_smoke(n_first, channels):
    """On a fixed record array with rays frozen part way (S = 0) the live
    step count and the bound are chip_smoke's."""
    g = torch.Generator().manual_seed(3)
    n_rays, rps, n = 4096, 64, 32
    rec = torch.rand((rps, 8, n_rays), generator=g) + 0.5
    exit_at = torch.randint(0, rps + 8, (n_rays,), generator=g)
    rec[:, 3] = torch.where(torch.arange(rps)[:, None] < exit_at[None], 1.0,
                            0.0)
    tcube = torch.zeros((n, n, n, 4))
    scube = torch.zeros((n, n, n, channels))
    state = torch.zeros((7, n_rays))
    want = chip_smoke.segment_bound_ms(tcube, scube, state, rec, n_first, 10)
    live = (rec[:, 3] > 0).sum(dim=1).numpy()
    got = roofline.segment_bound_ms(tcube.numel(), scube.numel(), channels,
                                    state.numel(), rec.numel(), live,
                                    n_first, 10)
    assert got == want
    assert got[1] == "operations"


def test_busy_seconds_on_overlapping_intervals():
    spans = [(0.0, 10.0), (5.0, 12.0), (20.0, 25.0), (21.0, 22.0),
             (30.0, 30.0), (24.0, 26.0)]
    assert device_trace.busy_seconds(spans) == pytest.approx(18e-6)

    class Ev:
        def __init__(self, s, e):
            self.time_range = type("R", (), {"start": s, "end": e})()

    assert device_trace.busy_seconds(spans) == profile_slice.busy_seconds(
        [Ev(s, e) for s, e in spans])


def test_idle_gaps_and_labels():
    gaps = device_trace.idle_gaps([(2, 4), (3, 5), (8, 9)], (0, 12))
    assert gaps == [(0, 2), (5, 8), (9, 12)]
    host = [("outer", 0, 12), ("npz", 5, 8.5), ("aten::copy_", 9, 9.2)]
    labels = device_trace.label_gaps(gaps, host)
    assert labels == pytest.approx({"outer": 2e-6 + 3e-6, "npz": 3e-6})
    assert device_trace.label_gaps([(0, 1)], []) == {
        "host, outside torch": pytest.approx(1e-6)}


def test_readers_never_read_zero_shares():
    """A reader with nothing to read returns None, never 0."""
    from benchmark.harness import Run, reader
    run = Run(None, 1.0, 1, "cpu")
    for name in ("trace_roofline.trace", "device_idle.trace", "device_idle.map", "device_idle.sweep",
                 "ray_steps_per_s", "s_per_sweep", "resample_ms.map",
                 "host_s.sweep"):
        assert reader(name)(run) is None
