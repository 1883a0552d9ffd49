"""Signal-processing models over the dsc_tpu_torch API (dsc_tpu/models)."""

from .cwt import cwt, find_peaks_cwt, morlet2, ricker
from .czt import CZT, ZoomFFT, czt, czt_points, zoom_fft
from .filter_fft import (FilterFFT, convolve, convolve2d, correlate, correlate2d, fft_convolve,
                         fft_convolve2, oaconvolve)
from .fir import (firls, firwin, firwin2, firwin_2d, gammatone, kaiser_atten, kaiser_beta,
                  kaiserord, minimum_phase, savgol_coeffs, savgol_filter)
from .multitaper import lombscargle, multitaper
from .ola import OverlapSave, overlap_save_convolve
from .psd import coherence, csd, detrend, periodogram, psd_spectrogram, welch
from .short_time_fft import ShortTimeFFT
from .spectral import envelope, hilbert, hilbert2, resample, resample_poly, upfirdn
from .stft import ISTFT, STFT, spectrogram
from .stft_scipy import (check_COLA, check_NOLA, closest_STFT_dual_window, istft, stft,
                         stft_dual_window)

__all__ = ['CZT', 'ZoomFFT', 'czt', 'czt_points', 'zoom_fft', 'FilterFFT', 'convolve',
           'convolve2d', 'correlate', 'correlate2d', 'fft_convolve', 'fft_convolve2',
           'oaconvolve', 'OverlapSave', 'overlap_save_convolve', 'ISTFT', 'STFT',
           'spectrogram', 'ShortTimeFFT', 'stft', 'istft', 'check_COLA', 'check_NOLA',
           'stft_dual_window', 'closest_STFT_dual_window', 'welch', 'periodogram', 'csd',
           'coherence', 'psd_spectrogram', 'detrend', 'cwt', 'find_peaks_cwt', 'ricker',
           'morlet2', 'multitaper', 'lombscargle', 'resample', 'resample_poly', 'upfirdn',
           'hilbert', 'hilbert2', 'envelope', 'firwin', 'firwin2', 'firls', 'gammatone',
           'firwin_2d', 'kaiserord', 'kaiser_beta', 'kaiser_atten', 'savgol_coeffs',
           'savgol_filter', 'minimum_phase']
