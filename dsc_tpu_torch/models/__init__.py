"""Signal-processing models over the dsc_tpu_torch API (dsc_tpu/models)."""

from .czt import CZT, ZoomFFT, czt, czt_points, zoom_fft
from .filter_fft import (FilterFFT, convolve, convolve2d, correlate, correlate2d, fft_convolve,
                         fft_convolve2, oaconvolve)
from .ola import OverlapSave, overlap_save_convolve
from .stft import ISTFT, STFT, spectrogram

__all__ = ['CZT', 'ZoomFFT', 'czt', 'czt_points', 'zoom_fft', 'FilterFFT', 'convolve',
           'convolve2d', 'correlate', 'correlate2d', 'fft_convolve', 'fft_convolve2',
           'oaconvolve', 'OverlapSave', 'overlap_save_convolve', 'ISTFT', 'STFT',
           'spectrogram']
