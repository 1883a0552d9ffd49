"""Signal-processing models over the dsc_tpu_torch API (dsc_tpu/models)."""

from .cwt import cwt, find_peaks_cwt, morlet2, ricker
from .czt import CZT, ZoomFFT, czt, czt_points, zoom_fft
from .filter_extras import (abcd_normalize, besselap, bilinear_zpk, buttap, cheb1ap, cheb2ap,
                            choose_conv_method, dbode, dfreqresp, ellipap, fftconvolve,
                            findfreqs, freqz_sos, lfiltic, lp2bp, lp2bp_zpk, lp2bs, lp2bs_zpk,
                            lp2hp, lp2hp_zpk, lp2lp, lp2lp_zpk, unique_roots)
from .filter_fft import (FilterFFT, convolve, convolve2d, correlate, correlate2d, fft_convolve,
                         fft_convolve2, oaconvolve)
from .griffin_lim import GriffinLim
from .fir import (firls, firwin, firwin2, firwin_2d, gammatone, kaiser_atten, kaiser_beta,
                  kaiserord, minimum_phase, savgol_coeffs, savgol_filter)
from .iir import (butter, cheby1, cheby2, decimate, filtfilt, freqz, group_delay, lfilter,
                  lfilter_zi, sos2tf, sosfilt, sosfilt_zi, sosfiltfilt, sosfreqz, tf2sos)
from .iirdesign import (band_stop_obj, bessel, buttord, cheb1ord, cheb2ord, ellip, ellipord,
                        iircomb, iirfilter, iirnotch, iirpeak)
from .lti import (BadCoefficients, bilinear, deconvolve, normalize, sos2zpk, tf2zpk,
                  unit_impulse, zpk2sos, zpk2tf)
# after .lti: the package's name ``lti`` is the factory, as in the JAX
# package; reach the module with importlib.import_module
from .ltisys import StateSpace, TransferFunction, ZerosPolesGain, dlti, lti
from .multitaper import lombscargle, multitaper
from .nonlinear import medfilt, medfilt2d, order_filter, wiener
from .ola import OverlapSave, overlap_save_convolve
from .peaks import (argrelextrema, argrelmax, argrelmin, find_peaks, peak_prominences,
                    peak_widths)
from .pfe import invres, invresz, residue, residuez
from .placepoles import place_poles
from .psd import coherence, csd, detrend, periodogram, psd_spectrogram, welch
from .remez import remez
from .response import (bode, correlation_lags, freqresp, freqs, freqs_zpk, freqz_zpk,
                       iirdesign)
from .short_time_fft import ShortTimeFFT
from .spectral import envelope, hilbert, hilbert2, resample, resample_poly, upfirdn
from .splines import (cspline1d, cspline1d_eval, cspline2d, gauss_spline, qspline1d,
                      qspline1d_eval, qspline2d, sepfir2d, spline_filter, symiirorder1,
                      symiirorder2)
from .statespace import (cont2discrete, dimpulse, dlsim, dstep, impulse, lsim, ss2tf, ss2zpk,
                         step, tf2ss, zpk2ss)
from .stft import ISTFT, STFT, spectrogram
from .stft_scipy import (check_COLA, check_NOLA, closest_STFT_dual_window, istft, stft,
                         stft_dual_window)
from .waveforms import (chirp, gausspulse, max_len_seq, sawtooth, square, sweep_poly,
                        vectorstrength)

__all__ = ['CZT', 'ZoomFFT', 'czt', 'czt_points', 'zoom_fft', 'FilterFFT', 'convolve',
           'convolve2d', 'correlate', 'correlate2d', 'fft_convolve', 'fft_convolve2',
           'oaconvolve', 'GriffinLim', 'OverlapSave', 'overlap_save_convolve', 'ISTFT', 'STFT',
           'spectrogram', 'ShortTimeFFT', 'stft', 'istft', 'check_COLA', 'check_NOLA',
           'stft_dual_window', 'closest_STFT_dual_window', 'welch', 'periodogram', 'csd',
           'coherence', 'psd_spectrogram', 'detrend', 'cwt', 'find_peaks_cwt', 'ricker',
           'morlet2', 'multitaper', 'lombscargle', 'resample', 'resample_poly', 'upfirdn',
           'hilbert', 'hilbert2', 'envelope', 'firwin', 'firwin2', 'firls', 'gammatone',
           'firwin_2d', 'kaiserord', 'kaiser_beta', 'kaiser_atten', 'savgol_coeffs',
           'savgol_filter', 'minimum_phase', 'butter', 'cheby1', 'cheby2', 'decimate',
           'filtfilt', 'freqz', 'group_delay', 'lfilter', 'lfilter_zi', 'sos2tf', 'sosfilt',
           'sosfilt_zi', 'sosfiltfilt', 'sosfreqz', 'tf2sos', 'BadCoefficients', 'bilinear',
           'deconvolve', 'normalize', 'sos2zpk', 'tf2zpk', 'unit_impulse', 'zpk2sos', 'zpk2tf',
           'cspline1d', 'cspline2d', 'cspline1d_eval', 'gauss_spline', 'qspline1d',
           'qspline1d_eval', 'qspline2d', 'sepfir2d', 'spline_filter', 'symiirorder1',
           'symiirorder2', 'cont2discrete', 'dimpulse', 'dlsim', 'dstep', 'impulse', 'lsim',
           'ss2tf', 'ss2zpk', 'step', 'tf2ss', 'zpk2ss', 'residue', 'residuez', 'invres',
           'invresz', 'ellip', 'bessel', 'iirfilter', 'buttord', 'cheb1ord', 'cheb2ord',
           'ellipord', 'band_stop_obj', 'iirnotch', 'iirpeak', 'iircomb', 'iirdesign', 'freqs',
           'freqs_zpk', 'freqz_zpk', 'freqresp', 'bode', 'correlation_lags', 'chirp', 'square',
           'sawtooth', 'gausspulse', 'sweep_poly', 'max_len_seq', 'vectorstrength', 'medfilt',
           'medfilt2d', 'order_filter', 'wiener', 'buttap', 'cheb1ap', 'cheb2ap', 'ellipap',
           'besselap', 'lp2lp', 'lp2hp', 'lp2bp', 'lp2bs', 'lp2lp_zpk', 'lp2hp_zpk',
           'lp2bp_zpk', 'lp2bs_zpk', 'bilinear_zpk', 'lfiltic', 'unique_roots', 'findfreqs',
           'dfreqresp', 'dbode', 'fftconvolve', 'freqz_sos', 'choose_conv_method',
           'abcd_normalize', 'lti', 'dlti', 'TransferFunction', 'ZerosPolesGain',
           'StateSpace', 'place_poles', 'remez', 'find_peaks', 'peak_prominences',
           'peak_widths', 'argrelextrema', 'argrelmax', 'argrelmin']
