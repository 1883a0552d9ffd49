"""Signal-processing models over the dsc_tpu_torch API (dsc_tpu/models)."""

from .filter_fft import fft_convolve

__all__ = ['fft_convolve']
