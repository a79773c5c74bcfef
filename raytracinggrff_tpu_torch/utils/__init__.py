"""Map utilities: NaN patching, beam convolution and plots."""

from .beam import gaussian_beam_convolve
from .nanpatch import patch_nan_emission_map, patch_nan_emission_map_sim

__all__ = ["gaussian_beam_convolve", "patch_nan_emission_map",
           "patch_nan_emission_map_sim"]
