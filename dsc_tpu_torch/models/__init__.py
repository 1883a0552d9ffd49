"""Signal-processing models over the dsc_tpu_torch API (dsc_tpu/models)."""

from .czt import CZT, ZoomFFT, czt, czt_points, zoom_fft
from .filter_fft import fft_convolve

__all__ = ['CZT', 'ZoomFFT', 'czt', 'czt_points', 'fft_convolve', 'zoom_fft']
