"""External physics anchors for the port's GRFF transfer, the twins of
tests/test_physics_anchor.py through raytracinggrff_tpu_torch on the CPU.

The port's other transfer tests hold it to the JAX package; these pin it
to physics facts that do not depend on either implementation:

  * thermodynamic limit: an optically thick isothermal slab radiates
    T_b = T_e (Rayleigh-Jeans blackbody), to better than 1%;
  * quiet-Sun brightness: a Newkirk (1961) corona at T_e = 1.4 MK gives a
    disk-centre T_b of 0.3-0.8 MK at 20-30 MHz, the low edge of the
    observed quiet-Sun band (script/pub/compare_ovro_Tb_spec.py:192);
  * monotonicity and saturation: T_b rises with frequency toward T_e as
    the emitting layer deepens, reaching (1 - e^-tau) T_e at 300 MHz.
"""

import numpy as np
import pytest
import torch

from raytracinggrff_tpu_torch.constants import R_SUN_CM
from raytracinggrff_tpu_torch.grff.transfer import grff_transfer, tb_from_sfu

torch.set_num_threads(1)
AREA = (0.1 * R_SUN_CM) ** 2


def _tb(ds, te, ne, b, freqs):
    res = grff_transfer(ds, te, ne, b, np.ones(ds.shape, bool), freqs, AREA,
                        device="cpu")
    tb = tb_from_sfu((res.flux_o + res.flux_x).numpy(), freqs[None, :], AREA)
    return tb[0], res.tau_o.numpy()[0]


def test_optically_thick_slab_radiates_te():
    """tau >> 1 => T_b = T_e (blackbody limit), independent of density."""
    n_vox = 50
    te_k = 8.5e5
    ds = np.full((n_vox, 1), 1e10)
    te = np.full((n_vox, 1), te_k)
    ne = np.full((n_vox, 1), 2e9)       # f_pe ~ 400 MHz < 600 MHz: propagates
    b = np.zeros((n_vox, 1))
    tb, tau = _tb(ds, te, ne, b, np.array([600e6]))
    assert tau[0] > 20.0
    np.testing.assert_allclose(tb[0], te_k, rtol=1e-2)


@pytest.fixture(scope="module")
def newkirk_los():
    """Disk-centre LOS through a Newkirk quiet-Sun corona, surface -> 4 Rs."""
    r = 1.0 + np.geomspace(1e-4, 3.0, 2000)
    ne = 4.2e4 * 10 ** (4.32 / r)
    te = np.full_like(r, 1.4e6)
    b = np.zeros_like(r)
    ds = np.gradient(r) * R_SUN_CM
    return ds[:, None], te[:, None], ne[:, None], b[:, None]


def test_quiet_sun_low_band_in_literature_range(newkirk_los):
    ds, te, ne, b = newkirk_los
    tb, _ = _tb(ds, te, ne, b, np.array([20e6, 30e6]))
    # literature quiet-Sun T_b band over 20-90 MHz: 0.3-0.8 MK
    assert np.all((tb > 0.3e6) & (tb < 0.8e6)), tb


def test_quiet_sun_tb_rises_to_te(newkirk_los):
    ds, te, ne, b = newkirk_los
    tb, tau = _tb(ds, te, ne, b, np.array([20e6, 45e6, 90e6, 150e6, 300e6]))
    assert np.all(np.diff(tb) > 0), tb           # deeper layers are hotter
    # at 300 MHz the LOS is optically thick-ish: T_b = (1 - e^-tau) T_e
    expected = (1.0 - np.exp(-tau[-1])) * 1.4e6
    np.testing.assert_allclose(tb[-1], expected, rtol=2e-2)
    assert tb[-1] < 1.4e6                         # never exceeds T_e
