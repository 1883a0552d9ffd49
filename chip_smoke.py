"""On-GPU smoke test of the dsc_tpu_torch port on one CUDA card: the
filterFFT main path (rfft -> spectrum multiply -> irfft), the eager
elementwise tier, the batched FFT suite, the single-vector transforms
into and out of the T spectrum layout, and the fusion tier (dsc.compile
as CUDA graphs, dsc.map as generated kernels) with the STFT and
OverlapSave models, the FFT-shaped model tier (welch, cwt,
ShortTimeFFT and the rest of psd, stft_scipy, multitaper, spectral, fir),
the scipy.fft-parity transforms tier (exact-length Bluestein DFT,
DCT/DST, FFTLog), the IIR recurrence (sosfilt, lfilter, sosfiltfilt,
decimate), the affine-scan tier (dlsim, lsim, step, impulse, the
splines), the signal-generation and design tier (the waves, the
median, rank and Wiener filters, iirdesign) and the system-object and
design-support tier (fftconvolve, lfiltic, the lti / dlti classes,
find_peaks, remez, place_poles), the sharded tier (FFTs over a mesh of
devices) and the C front door.

    python3 chip_smoke.py

Phases, each raising on failure (exit code 0 means all passed):

1. the card's name and power limit (nvidia-smi), torch and CUDA versions;
2. build the CUDA kernels from dsc_tpu_torch/csrc (nvcc, sm_90a, one
   process per source), init the port on the card and measure the 256 MiB
   device-to-device copy rate, the ceiling the kernels' bytes are held to;
3. each kernel against its plain PyTorch version on the same inputs on
   the card (K12 base FFT at n = 256 ... 4096, 65536 x 256 among them;
   packed rfft K1, K2 and irfft K3, K4 phase by phase at 2^20, 2^21, 2^24
   and 2^26, K3 also on a spectrum whose X[0] and X[n/2] are not real, and
   the 2^24 irfft of that spectrum against np.fft; K1 on the unpadded
   operands of the filterFFT (2^20 samples and 255 taps at n = 2^21, 2^23
   samples, 4097 taps and 2^23 - 3 samples at n = 2^24) against the plain
   version on the zero-padded signal; K5 streaming map: every float32
   body at 2^26, scalars on each side, a 1-element tensor, a broadcast
   row, clip with one and two bounds, a ragged count, the complex bodies
   at 2^23 + 1, and every instantiation (body and operand kinds,
   stream_map.INSTANTIATIONS) at 2^21, one 16-byte group past a block's
   chunk, a chunk and a group on, and a ragged or odd count; the
   streaming four-step K6, K7 in every variant at the batched suite's
   shapes and a single 2^24 vector; the Hermitian reconstruction K11 at
   2^18, 2^19 and 2^24, exactly; K6 once more and K8, K9 and K10 (within
   1e-6) at every single-vector shape of phase 4d: 2^18, 2^19, 2^21, 2^24
   and 2^26, T and half-T layouts), K12 at the model tier's launch shapes
   (welch's 8191 x 512 and 8176 x 512, ShortTimeFFT's 4099 x 512) and K6/K7
   at cwt's 64 x 2^17 rows, and the rfft against np.fft in float64;
4. the public API at full size, as four paths, each with every launch count
   set to 0 just before it and read just after:
   a. the README quick start (2^20 samples, 255 taps, n = 2^21) and the
      4097-tap shape against np.convolve in float64, a 2^24 rfft -> irfft
      round trip and an n = 4096 rfft/irfft pair (K1-K4, K12); the quick
      start runs once more under dsc.profile; each kernel's launches held
      to the routing (K1, K2 5, K3, K4 3, K12 2);
   b. bench.py's fma and sin rows (dsc.add and dsc.sin of 2^26 float32)
      against NumPy in float64, a sweep of add/mul/exp/sum/max over sizes
      and dtypes in which K5 must launch exactly where the routing rule
      says, and the filterFFT at n = 2^24 (2^23 samples, 4097 taps) against
      a float64 FFT convolution (K5, K1-K4);
   c. BASELINE config 3, the batched FFT suite (benchmarks/bench_fft.py):
      fft and ifft of 256 x 2^16, 64 x 2^18, 16 x 2^20 and 4 x 2^22
      complex64, rfft -> irfft of 16 x 2^20 float32, rfft over axis 0 of
      (2^18, 64), fft2 and rfft2 -> irfft2 of (256, 2^16), the irfft of
      dense single spectra at 2^18 and 2^19, irfft(x, out=o) at 2^24 and
      the ifft of one 2^24 vector, each against np.fft in float64, with the
      launches of every kernel held to the routing table (K6, K7, K11,
      K12); then the plan cache under 22 distinct plans, which must end at
      16;
   d. single vectors: fft -> ifft of complex64 at 2^18, 2^21, 2^24 and
      2^26 (K6 + K8 into the T layout, K9 + K10 out of it; against np.fft
      in float64 up to 2^24, the round trip at 2^26), rfft -> irfft at
      2^18 and 2^19 (the half-T layout), fft_convolve at n = 2^19 against
      np.convolve and the chirp-z transform of 10^6 points (fft_n = 2^21)
      against np.fft, every call with the counts set to 0 before it and
      held to the routing after it;
5. CUDA-event timings of each kernel, its plain version and the one
   PyTorch call that computes the same function (a yardstick the port never
   calls), each as device time per call over 50 calls back to back, the
   kernel also as the median of 25 single launches (K1, K3 and K4 at 2^21,
   2^24 and 2^26, K1 also on the filterFFT's unpadded operands); the
   filterFFT step at n = 2^21 and 2^24 (median of 25); each batched-suite
   row through the public API beside the torch.fft call on the same shape; K5 at
   2^26 for every float32 body, mul by a scalar, add of a 1-element tensor,
   clip with tensor bounds, the broadcast-row add and the complex bodies
   at 2^23 + 1; K12 at
   2048 x 1, 4096 x 1000 and 65536 x 256; and K8, K9, K10 at 2^24 (T and
   half-T), 2^19 (half-T), 2^26 and 2^18 (T);
6. the fusion tier and the models that ride it, every call with the counts
   set to 0 before it and read after it:
   a. dsc.compile: FilterFFT(129 random taps, block 2^20) (n = 2^21),
      entry() (2^20 samples, 4097 Blackman taps) and FilterFFT(4097 taps,
      block 2^23) (n = 2^24, whose spectrum multiply is K5), each held to a
      float64 FFT convolution (1e-4 of the largest value) and to its eager
      chain (1e-6), with the launches of the trace run and the capture
      counted (each kernel twice) and a replay's (none); torch.profiler over
      20 replays shows the graph's kernels (K1-K4, K5 at n = 2^24) and no
      kernel launched from the host (cudaLaunchKernel 0, cudaGraphLaunch
      20); each compiled step against its eager step on the host clock, with
      the device's busy share of each;
   b. dsc.map at 2^26 float32 of clip(x * y + 0.5, -1, 1), a broadcast row
      and a 1-element tensor (t * row + k) and a two-output body: K5g
      (a source generated on K5's skeleton, built with nvcc) against its
      plain interpreter (3e-5) and against the eager chain of K5 launches,
      timed beside its bound and the eager chain, with nvcc's seconds;
   c. STFT(1024, 256, 'hann') log power of 1 x 2^20 and 16 x 2^18 inside
      dsc.profile(xprof_dir=...), whose trace must hold the stft op events
      and K12's device events; STFT complex -> ISTFT of 4 x 2^18;
      OverlapSave(129 taps, fft_n = 8192) of 1 x 2^22 and 8 x 2^20; each
      against NumPy in float64 with the tolerances of the JAX package's
      tests, and timed with its device busy share.

7. the model tier, every call with the counts set to 0 before it and held
   to the routing after it, each against scipy.signal or NumPy in float64
   with the tolerances of the JAX package's tests: the rows of
   benchmarks/results_models.json at full size, welch (nperseg 1024) of
   1 x 2^22 and 16 x 2^18 (K12), cwt (ricker, 64 widths) of 2^16 (K12 on
   the signal row, K6 + K7 on the 64 kernel rows and their inverse) and
   ShortTimeFFT(hann 1024, hop 256).stft of 2^20 (K12), each timed on the
   host clock (median of 25) with its device time by kernel (torch.profiler
   over 10 calls), busy share and, for the K12 rows, the plain untangle's
   device time alone; then one call each of csd and coherence of 2 x 2^20,
   periodogram of 2^22, stft -> istft of 2^20, multitaper of 2^18,
   lombscargle of 4096 points at 4096 frequencies, hilbert of 2^22,
   resample 2^22 -> 2^21, resample_poly(3, 2) of 2^20 (K6, K7, K11),
   firwin(255) and savgol_filter(31, 3) of 2^20 (K1-K4). Every kernel
   launch these calls make is held to its plain version on the same inputs
   just after it (REL_BOUND), at whatever shape and static arguments the
   model gave it.

8. the transforms tier (dsc_tpu_torch.transforms), every call with the
   counts set to 0 before it and held after it to the launches the FFT
   core's rule gives its inner transforms (core_launches), each against
   scipy.fft in float64 within 2e-4 of the largest value: fft of 1 x 10^6
   complex64 (Bluestein, m = 2^21, K6 + K7), rfft of a minute of 48 kHz
   float32 audio (2 880 000 samples, m = 2^23) and the irfft of that
   spectrum, dct II ortho of (4096, 1000) (Bluestein m = 4096 over 4096
   rows, K12), dctn II ortho of (2048, 2048) and its idctn (K12), dst IV of
   (64, 2^16) (complex 2^17-point rows, K6 + K7), fht and ifht of
   (16, 4096) (K12) and the irfft at n = 2^22 of one half spectrum (K11 +
   K6 + K7); every kernel launch held to its plain version (REL_BOUND);
   then each call's host time (median of 25), its device time by kernel
   against the plain passes and its busy share (torch.profiler over 10
   calls).

9. the IIR recurrence (models/iir.py), every call with the counts set to
   0 before it and held after it, each against scipy.signal in float64 with
   the JAX package's bounds: sosfilt(butter(4, 0.25)) of 1 x 2^22 and 8 x
   2^20 (the sosfilt rows of benchmarks/results_models.json) and lfilter of
   the same filter in 'ba' form at 2^22 (1e-4; no kernel: the recurrence is
   matrix products), sosfiltfilt of 2^22 (1e-4), decimate(q 4) of 2^22 with
   ftype 'iir' (1e-3) and 'fir' (2e-6; its FFT convolution's launches held
   to the core's rule and each to its plain version, REL_BOUND); sosfilt at
   2^22 once more with allow_tf32 = True set by the phase, and the error the
   TF32 products would give without the guard; 'sequential' against
   'parallel' at 4096 with the sequential call's time; sosfilt -> welch
   (nperseg 256) of 4 x 4096 under dsc.compile against scipy and within
   1e-6 of the eager chain, cudaLaunchKernel 0 over 20 replays; then each
   full-size row's host time (median of 25), device time by kernel and op
   (torch.profiler over 10 calls), busy share, the Toeplitz products'
   bound, peak device memory and the constant cache's size.

10. the affine-scan tier (models/statespace.py, splines.py: float64 on the
   card, no kernel), every call with the counts set to 0 before it and held
   at 0 after it, each against scipy.signal in float64: dlsim of the zoh
   discretization (dt = 1e-3) of the analog butter(4, 2 pi 50), 4 states,
   over 2^22 steps on the Tensor path (y against lfilter of the same
   discrete system, x over the first 2^18 steps against dlsim, 1e-5) and
   over 2^20 steps on the numpy path (dlsim, 1e-10); lsim (first-order
   hold) over 10^6 times, step and impulse of N = 10^5 (1e-10); cspline1d
   of 2^22 at lamb 0 and 1 and qspline1d of 2^22 (1e-6), and the cspline1d
   program's float64 result on the card before its cast (1e-12); symiirorder1
   (2, 0.5) and symiirorder2 (0.8, 1.2) of (64, 2^16) row by row (1e-6,
   2e-6); cspline2d (lamb 0: 1e-5; lamb 5: 5e-3 and 5e-4 inside the
   border), spline_filter (lamb 5) and sepfir2d (two 5-tap kernels, 1e-5)
   of a 2048 x 2048 image; the smoothing cspline1d's host table build and
   upload; then each full-size row's host time (median of 25; for the
   smoothing cspline1d, whose host tables take seconds, its checked call),
   device time by op (torch.profiler over 10 calls; 1), busy share, kernels
   and copies a call, the checked call's peak device memory above the input,
   the bound of its float64 array arguments and results over the memory
   rate, and the host time of the checked call beside its scipy references'.

11. the signal-generation and design tier (models/waveforms.py,
   nonlinear.py, iirdesign.py), every call with the counts set to 0 before
   it and held after it, each against scipy.signal in float64 of the same
   values (computed in 8 threads): chirp (all four methods), square,
   sawtooth, gausspulse and sweep_poly on float64 and float32 Tensor time
   axes of 2^24 samples, in float32 (1e-4) and float64 (1e-9 of the largest
   value), square and sawtooth also exactly as the JAX package's float64
   formula in NumPy (scipy's square differs only within 8 ulps of a jump),
   and chirp of a host axis equal to chirp of the same Tensor axis (no
   kernel); medfilt of 1 x 2^22 (k 21) and (64, 2^16) (k 7, scipy row by
   row), medfilt2d of 2048^2 (5 x 5), order_filter of 2048^2 (3 x 3, ranks 0,
   4, 8) and of 2^22 (an 11-tap domain of 7 taps, rank 3; scipy on the
   signal as a 1-row image, since its 1-D path counts the domain's zeros as
   taps), exactly, and
   wiener of 2^22 (mysize 21, noise 0.5 and estimated; 1e-4 of max(1,
   largest value)) (no kernel); the chain chirp of 2^22 + seeded noise ->
   iirdesign ellip (host) -> sosfilt -> medfilt(5) -> welch(nperseg 1024),
   each stage against scipy applied to the port's previous stage (1e-4,
   exactly, 2e-4), the add's K5 and welch's K12 launches held to the
   routing and each to its plain version, then the chain under dsc.compile
   within 1e-6 of eager; then each row's host time (median of 25), device
   time by op (torch.profiler over 10 calls), busy share, the checked
   call's peak device memory above what it was given, the bound of its
   bytes (a wave's float64 axis and float32 result, a filter's float32
   signal and result) over the memory rate, and the phase's time split
   into scipy's references, the checked calls and the timing.

12. the system-object and design-support tier (models/filter_extras.py,
   ltisys.py, peaks.py, remez.py, placepoles.py), every call with the
   counts set to 0 before it and held after it, each against scipy.signal
   in float64 of the same values (computed in 8 threads): fftconvolve of
   2^23 float32 samples and 4097 taps in 'full', 'same' and 'valid' mode
   (fft_n = 2^24: K1 + K2 for both operands, K5 on the spectra's product,
   K3 + K4), of 8 x 2^20 rows and 255 taps (K6 + K7 for the rows, K1 + K2
   for the taps) and of a 2048^2 image and a 5 x 5 kernel in 'full' and
   'same' mode (K12 on the 4096-point rows and columns, K5), within 1e-4 of
   the largest value, their launches held to the routing (conv_launches)
   and each to its plain version (REL_BOUND); lfilter(butter(4, 0.25)) of
   2^22 samples in two halves, the second from lfiltic's state, within
   1e-5 of the one-pass filter and 1e-4 of scipy; dlti (the zoh at dt 0.1
   of the analog butter(4, 2 pi 0.5), 4 states).output of a 2^22-step
   float32 Tensor (y against lfilter of its ss2tf, x over the first 2^16
   steps against dlsim, 1e-5); lti(analog butter(4, 2 pi 50)).output of
   10^6 times and its step and impulse of N = 10^5 (the first 2^16 steps
   against scipy's lsim, step and impulse, 1e-10); dlti([1], [1, -0.5],
   dt=0.1).bode(n=4096), whose phase equals scipy's within 1e-9 degrees
   (ROADMAP F9); find_peaks (height, distance, prominence, width, wlen,
   plateau_size) of a 2^22 float32 Tensor of 600 rounded Gaussian pulses
   (the indices equal to scipy's, the properties within 1e-12),
   peak_widths (1e-12) and argrelmax(order=3) (equal); remez at 73 and 101
   taps (1e-4); place_poles of a 4-state single-input system (the gain
   within 1e-8 of scipy's) and a 6-state 2-input one (the poles within
   1e-8 of the request) (no kernel but fftconvolve's); then each device
   row's host time (median of 25), device time by op (torch.profiler over
   10 calls), busy share, the checked call's peak device memory and the
   bound of its bytes, the peak finder's rows' (median of 5, 3 calls) and
   the host rows' host time, and the phase's time split.

13. the sharded tier (parallel/) and the C front door: the local K6 and
   K7 of the sharded four-step (pallas_stream.py:753, :792) against their
   plain versions at n = 2^24 over d = 4 (each col0) and d = 8 and at 2^26
   over d = 4, both directions and K7's real output (REL_BOUND); then on
   a virtual mesh of 4 entries of cuda:0 and on the mesh of every card,
   distributed_fft_stream of 2^24 complex64 (against np.fft in float64
   and the single-card K6 + K7 of the same vector) and its inverse, the
   distributed rfft -> irfft pair of 2^24 float32, sharded_batched_fft
   and sharded_batched_rfft of 16 x 2^20 on (d, 1) and distributed_fft of
   4 x 2^22 on (1, d), each within 1e-4 of np.fft, its launches held to
   the routing and no plain version run on a CUDA shard; each call's host
   and device time (tensor in, gathered out) beside the single-card call
   on the same data, the copies' share of its device time, the local
   kernels against their bytes' bound; and cpp/tests/test_filterfft.cpp
   over dsc_tpu_torch.capi (dsc_tpu_torch/cpp, g++ beside the card work)
   on the card, which must print "ALL OK".

The last lines are the kernels' JSON record (its ``launches_by_path``
holds each path's launches, 'models', 'transforms', 'recurrence',
'scans', 'signals', 'systems' and 'sharded' among them), the card line and the
result line. Without a CUDA device the script exits non-zero before any of
them.

    python3 chip_smoke.py --profile

runs phases 1-2 and then, in place of the checks, times K12 and the column
pass of K6, K7, K8, K10, K1 and K4 (2^21, 2^24, 2^26, and K1 on 4097 taps
at 2^24) with blocks of 4096, 8192 and 16384 points and the C its wrapper
takes, K2 and K3 with 2-16 row pairs a block, and K9 (T layout) with
blocks of 4096, 8192 and 16384 points and the R its wrapper takes, each
side by side, and measures
where the filterFFT step's time goes (the copies and fills among the
kernels): the step at n = 2^21 on CUDA events and on the
host clock over five repeats in one process, K1 timed one launch at a time
and 200 launches back to back, and torch.profiler's device time per kernel
and the device's busy share of the step at n = 2^21 and at n = 2^24; and
the same breakdown for rows of the batched FFT suite (fft, rfft and irfft
of 16 x 2^20, rfft over axis 0 of (2^18, 64), fft2 of (256, 2^16)) and of
the single-vector ifft(fft(x)) at 2^24 and irfft(rfft(x)) at 2^19.

    python3 chip_smoke.py --wrappers

runs phases 1-2 and then times the wrappers of K6, K8, K9 and K10 at 2^19
(their host time) with the irfft(rfft(x)) call there, K6, K7, K8 and
K10 at 2^24 in turns with torch.fft.fft and ifft, K1 and K4 at 2^21, 2^24
and 2^26 in turns, K3 and K9 at 2^24 and 2^26 in turns, and the filterFFT
step at n = 2^21 and 2^24 with the single ifft(fft(x)) of 2^24 points. It calls
only the wrappers and the public API, so it also runs from an earlier
tree of the port.

    python3 chip_smoke.py --fusion

runs phases 1-2 and then phase 6 alone.

    python3 chip_smoke.py --models

runs phases 1-2, phase 3's checks at the model tier's launch shapes and
phase 7 alone.

    python3 chip_smoke.py --transforms

runs phases 1-2 and phase 8 alone.

    python3 chip_smoke.py --recurrence

runs phases 1-2 and phase 9 alone.

    python3 chip_smoke.py --scans

runs phases 1-2 and phase 10 alone.

    python3 chip_smoke.py --signals

runs phases 1-2 and phase 11 alone.

    python3 chip_smoke.py --systems

runs phases 1-2 and phase 12 alone.

    python3 chip_smoke.py --sharded

runs phases 1-2 and phase 13 alone.

    python3 chip_smoke.py --map-candidates TREE [TREE ...]

times K5 of each TREE (a checkout of the port, unpacked under the ignored
build/) in a process of its own, in turns (the trees in order, then
backwards): nvcc's time and ptxas's registers and spills for
stream_map.cu alone, the device time per launch at 2^26 add, sin, clip,
mul by a scalar and add of a 1-element tensor, the broadcast-row add and
the 2^23 + 1 complex multiply beside the PyTorch call computing each, and
the host time of an eager add, clip and mul by a scalar.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import math
import os
import subprocess
import sys
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.abspath(__file__))
REL_BOUND = 3e-5        # kernel vs plain version, relative to max |plain|
T_BOUND = 1e-6          # K8, K9, K10 vs plain: float32 FFTs of one length and the same
                        # tables; K9's store twiddles are products within ~4e-7 of plain's
NUMPY_BOUND = 1e-4      # vs np.fft / np.convolve in float64 (BASELINE.md)
ORACLE = 1e-5           # elementwise vs NumPy, atol = rtol (tests/conftest.py)
RUNS = 25
WARMUP_S = 0.25
STEP_N = 2**21          # the README quick start: 2^20 samples, n = 2^21
BIG_N = 2**24           # bench.py's headline size
MAP_N = 2**26           # bench.py's fma and sin rows: 256 MiB of float32
# H100 SXM data sheet: device memory rate and
# float32 rate outside the tensor cores
PEAK_BYTES_S = 3.35e12
PEAK_F32_S = 67e12

KERNELS = {  # name -> (source, TPU kernel it replaces)
    'rfft_phase_a': ('dsc_tpu_torch/csrc/packed_rfft.cu',
                     'dsc_tpu/fourier/packed_fused.py:122'),
    'rfft_phase_b': ('dsc_tpu_torch/csrc/packed_rfft.cu',
                     'dsc_tpu/fourier/packed_fused.py:248'),
    'irfft_phase_a': ('dsc_tpu_torch/csrc/packed_rfft.cu',
                      'dsc_tpu/fourier/packed_fused.py:487'),
    'irfft_phase_b': ('dsc_tpu_torch/csrc/packed_rfft.cu',
                      'dsc_tpu/fourier/packed_fused.py:721'),
    'base_fft': ('dsc_tpu_torch/csrc/base_fft.cu',
                 'dsc_tpu/fourier/pallas_kernels.py:55'),
    'stream_map': ('dsc_tpu_torch/csrc/stream_map.cu',
                   'dsc_tpu/ops/pallas_map.py:83'),
    'stream_phase_a': ('dsc_tpu_torch/csrc/fourstep_stream.cu',
                       'dsc_tpu/fourier/pallas_stream.py:352'),
    'stream_phase_b': ('dsc_tpu_torch/csrc/fourstep_stream.cu',
                       'dsc_tpu/fourier/pallas_stream.py:519'),
    'reconstruct': ('dsc_tpu_torch/csrc/reconstruct.cu',
                    'dsc_tpu/fourier/pallas_reconstruct.py:95'),
    'stream_phase_b_t': ('dsc_tpu_torch/csrc/fourstep_stream_t.cu',
                         'dsc_tpu/fourier/pallas_stream_t.py:108'),
    'stream_inv_phase_a_t': ('dsc_tpu_torch/csrc/fourstep_stream_t.cu',
                             'dsc_tpu/fourier/pallas_stream_t.py:202'),
    'stream_inv_phase_b_t': ('dsc_tpu_torch/csrc/fourstep_stream_t.cu',
                             'dsc_tpu/fourier/pallas_stream_t.py:469'),
    # K5g: K5's skeleton with a body generated from a dsc.map function
    'stream_map_gen': ('dsc_tpu_torch/csrc/stream_map.cuh',
                       'dsc_tpu/ops/pallas_map.py:83'),
    # the sharded four-step's per-shard sites (parallel/sharded_fft.py)
    'stream_phase_a_local': ('dsc_tpu_torch/csrc/fourstep_stream.cu',
                             'dsc_tpu/fourier/pallas_stream.py:753'),
    'stream_phase_b_local': ('dsc_tpu_torch/csrc/fourstep_stream.cu',
                             'dsc_tpu/fourier/pallas_stream.py:792'),
}
# the launches the filterFFT path must make (fourier/config.py): K1 + K2 for
# each packed rfft (two per filterFFT, one for the 2^24 round trip), K3 + K4
# for each packed irfft, K12 for the n = 4096 pair's half-size rfft and irfft
FFT_PATH_LAUNCHES = {'rfft_phase_a': 5, 'rfft_phase_b': 5, 'irfft_phase_a': 3,
                     'irfft_phase_b': 3, 'base_fft': 2}
MAP_PATH = ('stream_map', 'rfft_phase_a', 'rfft_phase_b', 'irfft_phase_a', 'irfft_phase_b')
# BASELINE config 3's batched rows: (batch, n), 2^24 complex64 values each
SUITE = ((256, 2**16), (64, 2**18), (16, 2**20), (4, 2**22))
# the launches the batched path must make (fourier/config.py): one K6+K7
# pair per 1-D transform (18), K11 for each single-row irfft off the packed
# route (3), K12 for the 256-point axis of fft2, rfft2 and irfft2 (3)
SUITE_LAUNCHES = {'stream_phase_a': 18, 'stream_phase_b': 18, 'reconstruct': 3, 'base_fft': 3}
# the single-vector path's launches per call (fourier/config.py 'stream_t')
INTO_T = {'stream_phase_a': 1, 'stream_phase_b_t': 1}
OUT_OF_T = {'stream_inv_phase_a_t': 1, 'stream_inv_phase_b_t': 1}

# K5 float32 bodies: operations per element (arithmetic of the fast sin/cos
# polynomial; for the libm bodies an estimate of their instruction count)
MAP_OPS = {'add': 1, 'sub': 1, 'mul': 1, 'div': 1, 'sin': 17, 'cos': 18,
           'exp': 8, 'logn': 8, 'log2': 8, 'log10': 9, 'sqrt': 1, 'sinc': 20,
           'clip': 2}
# the complex bodies: float operations per complex value
CMAP_OPS = {'add': 2, 'sub': 2, 'mul': 6, 'div': 11}
# the one PyTorch call computing each body (a yardstick only)
LIBRARY = {'add': torch.add, 'sub': torch.sub, 'mul': torch.mul, 'div': torch.div,
           'sin': torch.sin, 'cos': torch.cos, 'exp': torch.exp, 'logn': torch.log,
           'log2': torch.log2, 'log10': torch.log10, 'sqrt': torch.sqrt,
           'sinc': torch.sinc, 'clip': torch.clamp}


# K5: floats a block takes per operand (512 float4 groups); the counts every
# instantiation is held to its plain version at: 2^21, one 16-byte group
# past a block's chunk, a chunk and a group on
K5_CHUNK = 4 * 512
K5_COUNTS = (2**21, 2**21 + 4, 2**21 + K5_CHUNK + 4)


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(msg)


def rel_err(got: torch.Tensor, ref: torch.Tensor) -> float:
    require(got.shape == ref.shape and got.dtype == ref.dtype,
            f'shape/dtype {tuple(got.shape)} {got.dtype} != '
            f'{tuple(ref.shape)} {ref.dtype}')
    return float((got - ref).abs().max() / ref.abs().max())


def card_line() -> str:
    out = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit', '--format=csv,noheader'],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, runs: int = RUNS) -> float:
    """Median device time of one call of ``fn`` over ``runs`` calls, each
    bracketed by CUDA events, after WARMUP_S seconds of warm-up calls (the
    first tens of filterFFT steps in a process read up to 1.6x slower)."""
    stop = time.perf_counter() + WARMUP_S
    while time.perf_counter() < stop:
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def host_ms(fn, runs: int = RUNS) -> float:
    """Median host-clock time of one call of ``fn`` followed by a
    synchronize, after WARMUP_S seconds of warm-up calls."""
    stop = time.perf_counter() + WARMUP_S
    while time.perf_counter() < stop:
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t0))
    return float(np.median(times))


def call_ms(fn, runs: int = 100) -> float:
    """Median host-clock time of the call of ``fn`` alone, the device idle
    before it (a synchronize, then the clock around the call): the host
    work of a wrapper and its launch."""
    cuda_ms(fn, runs=1)
    times = []
    for _ in range(runs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        times.append(1e3 * (time.perf_counter() - t0))
    torch.cuda.synchronize()
    return float(np.median(times))


def back_to_back_ms(fn, runs: int = 200) -> float:
    """Time of one call of ``fn`` when ``runs`` calls run between two CUDA
    events, so that launch latency hides behind the previous call."""
    cuda_ms(fn, runs=1)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(runs):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / runs


def copy_ceiling(card: str) -> float:
    """Read+write bytes per ms of a 256 MiB device-to-device copy."""
    src = torch.empty(MAP_N, dtype=torch.float32, device='cuda')
    dst = torch.empty_like(src)
    ms = cuda_ms(lambda: dst.copy_(src))
    rate = 2 * src.numel() * 4 / ms
    print(f'copy 256 MiB device to device: {ms:.4f} ms, {rate / 1e6:.1f} GB/s '
          f'read+write [{card}]')
    return rate


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors if isinstance(t, torch.Tensor))


def draw(gen, shape, dtype=torch.float32):
    """Normal values on the card from the torch.Generator ``gen``, with no
    exact zeros (randn there draws some in 2^26: a division would give inf
    in the kernel and its plain version alike, and inf - inf no error)."""
    x = torch.randn(shape, generator=gen, device='cuda', dtype=dtype)
    return torch.where(x == 0, 1.0, x)


def k5_operands(gen, dtype, body, kinds, n):
    """Operands of ``kinds`` for K5's ``body``, n elements drawn on the card
    from the torch.Generator ``gen``: full operands of (n,), or of (rows, M)
    beside a broadcast row of M (the longest that divides n, M % 4 == 0,
    M <= 2^14); scalars as Python values and 1-element tensors in turn."""
    shape = (n,)
    if 'brow' in kinds:
        m = max(m for m in range(4, 2**14 + 1, 4) if n % m == 0 and n // m >= 2)
        shape = (n // m, m)
    ops = []
    for i, kind in enumerate(kinds):
        if kind == 'scalar':
            v = (0.25, -0.5, 0.75)[i] if dtype == torch.float32 else (0.5 - 1.25j, 2.0 - 0.5j)[i]
            ops.append(v if (i + n) % 2 else torch.tensor([v], dtype=dtype, device='cuda'))
            continue
        x = draw(gen, shape if kind == 'full' else shape[-1:], dtype)
        if body in ('logn', 'log2', 'log10', 'sqrt'):
            x = x.abs() + 1e-3
        ops.append(x)
    return ops


def filter_fft(dsc, sig, taps, n_taps: int, n: int = STEP_N):
    """The README quick start through the public API: full convolution of
    ``sig`` with ``taps`` by rfft -> spectrum multiply -> irfft at ``n``."""
    spec = dsc.rfft(sig, n=n) * dsc.rfft(taps, n=n)
    return dsc.irfft(spec)[: sig.shape[0] + n_taps - 1]


EMPTY_PROFILE_TRIES = 3


def device_profile(fn, what: str, steps: int = 20, tries: int = 3):
    """torch.profiler over ``steps`` calls of ``fn``: [(device ms per call,
    launches per call, kernel or copy name)], largest first, and the profile.
    A kernel recorded a number of times that is no multiple of the calls
    means the trace lost events: the calls are profiled again, at most
    ``tries`` times in all. A trace with no device event at all is profiled
    again whatever ``tries`` says, at most EMPTY_PROFILE_TRIES times in all
    (the rows are then empty: see device_busy)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for attempt in range(max(tries, EMPTY_PROFILE_TRIES)):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(steps):
                fn()
            torch.cuda.synchronize()
        events = [e for e in prof.key_averages()
                  if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
        if events and all(e.count % steps == 0 for e in events):
            break
        last = attempt + 1 >= (tries if events else EMPTY_PROFILE_TRIES)
        print(f'  torch.profiler lost events ({what}: '
              f'{sorted(e.count for e in events)} over {steps} calls), '
              f'{"kept as read" if last else "profiling again"}')
        if last:
            break
    rows = sorted(((e.self_device_time_total / steps / 1e3, e.count // steps, e.key)
                   for e in events), reverse=True)
    return rows, prof


def print_profile(rows, what: str, wall: float, card: str, steps: int = 20) -> float:
    """Print ``device_profile``'s rows and the busy share of a ``wall`` ms
    call; returns the device ms per call."""
    print(f'torch.profiler, {what}, {steps} calls, device time per call [{card}]:')
    for dev_ms, count, key in rows:
        print(f'  {dev_ms:9.4f} ms  x{count:<3d} {key[:100]}')
    busy = sum(r[0] for r in rows)
    if busy:
        print(f'  all device work {busy:.4f} ms of a {wall:.4f} ms call (host clock + '
              f'synchronize): busy share {busy / wall:.3f} [{card}]')
    else:
        print('  torch.profiler recorded no device time: busy share not measured')
    return busy


def device_busy(fn, what: str, wall: float, card: str, steps: int, tries: int = 1):
    """device_profile and print_profile of a row that must show device
    work: (device ms a call, the rows, the profile, how the time was read).
    Where torch.profiler recorded no device event in any profile, the device
    time is one call's span between CUDA events instead (median of 3; the
    idle gaps inside the call count, so it bounds the busy time from above)."""
    rows, prof = device_profile(fn, what, steps=steps, tries=tries)
    busy = print_profile(rows, what, wall, card, steps)
    if busy:
        return busy, rows, prof, 'torch.profiler'
    span = cuda_ms(fn, runs=3)
    print(f'  {what}: device time by CUDA events instead: a call spans {span:.4f} ms on the '
          f'device (median of 3, idle gaps inside the call included) [{card}]')
    return span, rows, prof, 'CUDA events span'


def profile_step(dsc, card: str) -> None:
    """--profile: where the filterFFT step's time goes on the card."""
    from dsc_tpu_torch.fourier import packed_fused as pf, plan

    gen = np.random.default_rng(0)
    sig = dsc.from_numpy(gen.standard_normal(2**20).astype(np.float32))
    taps = dsc.from_numpy(np.blackman(255).astype(np.float32))

    def step():
        return filter_fft(dsc, sig, taps, 255)

    t = plan.get_plan(STEP_N, 'packed', torch.complex64)[1]
    x = torch.from_numpy(gen.standard_normal(STEP_N).astype(np.float32)).cuda()

    def k1():
        return pf.rfft_phase_a(x, t)

    print('filterFFT step, 2^20 x 255 taps, n=2^21, public API:')
    for rep in range(5):
        print(f'  repeat {rep}: CUDA events {cuda_ms(step):.4f} ms, host clock + '
              f'synchronize {host_ms(step):.4f} ms; K1 one launch {cuda_ms(k1):.4f} ms, '
              f'back to back {back_to_back_ms(k1):.4f} ms [{card}]')

    big_sig = dsc.from_numpy(gen.standard_normal(BIG_N // 2).astype(np.float32))
    big_taps = dsc.from_numpy(np.blackman(4097).astype(np.float32))

    def c64(shape):
        return (gen.standard_normal(shape) + 1j * gen.standard_normal(shape)).astype(np.complex64)

    r = dsc.from_numpy(gen.standard_normal((16, 2**20)).astype(np.float32))
    spec = dsc.rfft(r)
    c, f = dsc.from_numpy(c64((16, 2**20))), dsc.from_numpy(c64((256, 2**16)))
    a = dsc.from_numpy(gen.standard_normal((2**18, 64)).astype(np.float32))
    v = dsc.from_numpy(c64(BIG_N))
    w = dsc.from_numpy(gen.standard_normal(2**19).astype(np.float32))
    for what, fn in (('filterFFT step 2^20 x 255 taps, n=2^21', step),
                     ('filterFFT step 2^23 x 4097 taps, n=2^24',
                      lambda: filter_fft(dsc, big_sig, big_taps, 4097, BIG_N)),
                     ('batched fft 16 x 2^20', lambda: dsc.fft(c)),
                     ('batched rfft 16 x 2^20', lambda: dsc.rfft(r)),
                     ('batched irfft 16 x 2^20', lambda: dsc.irfft(spec)),
                     ('rfft over axis 0 of (2^18, 64)', lambda: dsc.rfft(a, axis=0)),
                     ('fft2 (256, 2^16)', lambda: dsc.fft2(f)),
                     ('single ifft(fft(x)) 2^24', lambda: dsc.ifft(dsc.fft(v))),
                     ('single irfft(rfft(x)) 2^19', lambda: dsc.irfft(dsc.rfft(w)))):
        wall = host_ms(fn)
        print_profile(device_profile(fn, what)[0], what, wall, card)


COLUMN_CANDIDATES = (4096, 8192, 16384)   # C*L points a block of the column pass


def column_candidates(card: str) -> None:
    """--profile: the column pass of K6, K7, K8, K10, K1 and K4 with blocks
    of each size of COLUMN_CANDIDATES (C = points / L columns) and with the
    C its wrapper takes, back to back in turns (a, b, c, c, b, a) at the
    batched suite's shapes and the single 2^24 vector's, complex64 and (K7,
    K10) float32 output, and for K1 and K4 at the packed splits of 2^21,
    2^24 and 2^26, K1 also on the 4097 taps of the 2^24 filterFFT; the
    table the wrappers take C from is stream.COLUMNS."""
    from dsc_tpu_torch.fourier import packed_fused as pf, plan, stream, stream_t
    from dsc_tpu_torch.fourier.stream import block_columns, factors

    gen = np.random.default_rng(5)

    def cnormal(shape):
        z = gen.standard_normal(shape) + 1j * gen.standard_normal(shape)
        return torch.from_numpy(z.astype(np.complex64)).cuda()

    cases = []  # (what, L, the wrapper's C, a launch with c columns a block)
    for batch, n in SUITE + ((1, BIG_N),):
        n1, n2 = factors(n)
        t = plan.get_plan(n, 'stream', torch.complex64)[1]
        x = cnormal((batch, n))
        z = stream.phase_a(x, t, False)
        shape = f'{batch} x 2^{n.bit_length() - 1}'
        cases += [(f'K6 {shape}', n1, block_columns(n1, n2, batch),
                   lambda c, x=x, t=t: stream._launch_phase_a(x, t, False, c)),
                  (f'K7 {shape}', n2, block_columns(n2, n1, batch),
                   lambda c, z=z, t=t: stream._launch_phase_b(z, t, False, False, c)),
                  (f'K7 {shape} inverse real output', n2, block_columns(n2, n1, batch, 4),
                   lambda c, z=z, t=t: stream._launch_phase_b(z, t, True, True, c))]
        if batch == 1:
            y = cnormal((n1, n2))
            cases += [(f'K8 {shape} T', n2, block_columns(n2, n1, 1),
                       lambda c, z=z, t=t: stream_t._launch_phase_b_t(z, t, False, c)),
                      (f'K10 {shape} T', n1, block_columns(n1, n2, 1),
                       lambda c, y=y, t=t: stream_t._launch_inv_phase_b_t(y, t, False, c)),
                      (f'K10 {shape} real output', n1, block_columns(n1, n2, 1, 4),
                       lambda c, y=y, t=t: stream_t._launch_inv_phase_b_t(y, t, True, c))]
    for e in (21, 24, 26):
        n = 2**e
        n1, m2 = factors(n)[0], factors(n)[1] // 2
        t = plan.get_plan(n, 'packed', torch.complex64)[1]
        x = torch.from_numpy(gen.standard_normal(n).astype(np.float32)).cuda()
        y = cnormal((n1, m2))
        c_table = block_columns(n1, m2, 1)
        cases += [(f'K1 2^{e}', n1, c_table, lambda c, x=x, t=t: pf._launch_phase_a(x, t, c)),
                  (f'K4 2^{e}', n1, c_table,
                   lambda c, y=y, t=t: pf._launch_inv_phase_b(y, t, c))]
        if n == BIG_N:
            taps = torch.from_numpy(np.blackman(4097).astype(np.float32)).cuda()
            cases.append((f'K1 2^{e} on 4097 taps', n1, c_table,
                          lambda c, x=taps, t=t: pf._launch_phase_a(x, t, c)))
    print(f'column pass, block size candidates, ms per launch, 50 launches back to back, '
          f'in turns [{card}]:')
    for what, L, c_table, launch in cases:
        cols = sorted({max(1, p // L) for p in COLUMN_CANDIDATES} | {c_table})
        times = {c: [] for c in cols}
        for c in cols + cols[::-1]:
            times[c].append(back_to_back_ms(lambda c=c: launch(c), 50))
        print(f'  {what} (L={L}, the wrapper takes C={c_table}): ' + '; '.join(
            f'C={c} ({c * L} points): {float(np.mean(times[c])):.4f} ms' for c in cols))


ROW_CANDIDATES = (4096, 8192, 16384)      # R*n points a block of K12
PAIR_CANDIDATES = (2, 4, 8, 16)           # row pairs a block of K2 and K3


def row_candidates(card: str) -> None:
    """--profile: K12 with blocks of each size of ROW_CANDIDATES (R = points
    / n rows) at n = 256 ... 4096, over 2^24 values and over 1000 rows, and
    K2 and K3 with each P of PAIR_CANDIDATES that 1024 threads allow at
    n = 2^20 ... 2^26, K9 in the T layout with blocks of each size of
    ROW_CANDIDATES and the R its wrapper takes at 2^18 ... 2^26, back to
    back in turns (a, b, c, c, b, a); the tables the wrappers take R and P
    from are base_fft.ROWS, packed_fused.PAIRS and INV_PAIRS and
    stream_t.ROWS."""
    from dsc_tpu_torch.fourier import base_fft, packed_fused as pf, plan, stream_t
    from dsc_tpu_torch.fourier.stream import factors

    gen = np.random.default_rng(6)

    def cnormal(shape):
        z = gen.standard_normal(shape) + 1j * gen.standard_normal(shape)
        return torch.from_numpy(z.astype(np.complex64)).cuda()

    cases = []  # (what, {block shape: a launch with it})
    for n in (256, 512, 1024, 2048, 4096):
        w = plan.get_plan(n, 'complex', torch.complex64)[1]
        for batch in (2**24 // n, 1000):
            x = cnormal((batch, n))
            cases.append((f'K12 {batch} x {n}', {
                f'{p} points (R={p // n})': lambda r=p // n, x=x, w=w: base_fft._launch(x, w, r)
                for p in ROW_CANDIDATES}))
    for e in range(20, 27):
        t = plan.get_plan(2**e, 'packed', torch.complex64)[1]
        n1, n2 = factors(2**e)
        m2 = n2 // 2
        pairs = [p for p in PAIR_CANDIDATES if 2 * p * m2 // 16 <= 1024 and n1 % (2 * p) == 0]
        at = cnormal((n1, m2))
        spec = cnormal(n1 * m2 + 1)
        cases.append((f'K2 2^{e} (n1={n1}, m2={m2})', {
            f'P={p}': lambda p=p, at=at, t=t: pf._launch_phase_b(at, t, p) for p in pairs}))
        cases.append((f'K3 2^{e} (n1={n1}, m2={m2}, the wrapper takes '
                       f'P={pf.block_pairs(m2, inverse=True)})', {
            f'P={p}': lambda p=p, spec=spec, t=t: pf._launch_inv_phase_a(spec, t, p)
            for p in pairs}))
        del at, spec
    for e in range(18, 27):
        t = plan.get_plan(2**e, 'stream', torch.complex64)[1]
        n1, n2 = factors(2**e)
        s = cnormal((n1, n2))
        table = stream_t.block_rows(n2)
        rows = sorted({max(1, p // n2) for p in ROW_CANDIDATES} | {table})
        cases.append((f'K9 2^{e} T (n1={n1}, n2={n2}, the wrapper takes R={table})', {
            f'R={r} ({r * n2} points)':
                lambda r=r, s=s, t=t: stream_t._launch_inv_phase_a_t(s, t, False, r)
            for r in rows if r * n2 // 16 <= 1024}))
        del s
    print(f'row passes, block shape candidates, ms per launch, 50 launches back to back, '
          f'in turns [{card}]:')
    for what, launches in cases:
        times = {shape: [] for shape in launches}
        for shape in list(launches) + list(launches)[::-1]:
            times[shape].append(back_to_back_ms(launches[shape], 50))
        print(f'  {what}: ' + '; '.join(f'{shape}: {float(np.mean(ms)):.4f} ms'
                                        for shape, ms in times.items()))


def wrapper_times(dsc, card: str) -> None:
    """--wrappers: at 2^19, where a launch takes less device time than its
    wrapper's Python, K6, K8, K9 and K10 back to back (the wrappers' host
    time) and the irfft(rfft(x)) call on the host clock; at 2^24, K6, K7,
    K8 and K10 in turns (a ... f f ... a) with torch.fft.fft and ifft of
    the same vector; K1 and K4 at 2^21, 2^24 and 2^26 in turns; K3 and K9
    (T) at 2^24 and 2^26 in turns; the filterFFT step at n = 2^21 and 2^24
    and the single ifft(fft(x)) of 2^24 points in turns. It calls only the
    wrappers, whose arguments have not changed since they were ported, and
    the public API, so an earlier tree of the port runs it too."""
    from dsc_tpu_torch.fourier import packed_fused as pf, plan, stream, stream_t

    gen = np.random.default_rng(7)
    n = 2**19
    t = plan.get_plan(n, 'stream', torch.complex64)[1]
    x = torch.from_numpy(gen.standard_normal((1, n)).astype(np.float32)).cuda()
    z = stream.phase_a(x, t, False)
    s = stream_t.phase_b_t(z, t, True)
    y = stream_t.inv_phase_a_t(s, t, True)
    print(f'wrappers at 2^19, ms per call, 200 calls back to back [{card}]:')
    for what, fn in (('K6 real input', lambda: stream.phase_a(x, t, False)),
                     ('K8 half-T', lambda: stream_t.phase_b_t(z, t, True)),
                     ('K9 half-T', lambda: stream_t.inv_phase_a_t(s, t, True)),
                     ('K10 real output', lambda: stream_t.inv_phase_b_t(y, t, True))):
        print(f'  {what}: {back_to_back_ms(fn):.4f} ms')
    w = dsc.from_numpy(x.cpu().numpy().reshape(-1))
    print(f'  irfft(rfft(x)) 2^19, host clock + synchronize, median of {RUNS}: '
          f'{host_ms(lambda: dsc.irfft(dsc.rfft(w))):.4f} ms')
    n = BIG_N
    t = plan.get_plan(n, 'stream', torch.complex64)[1]
    n1, n2 = stream.factors(n)
    v = torch.from_numpy((gen.standard_normal((1, n)) + 1j * gen.standard_normal((1, n)))
                         .astype(np.complex64)).cuda()
    z = stream.phase_a(v, t, False)
    y = v.reshape(n1, n2)
    rows = (('K6', lambda: stream.phase_a(v, t, False)),
            ('K7', lambda: stream.phase_b(z, t, False)),
            ('K8 T', lambda: stream_t.phase_b_t(z, t, False)),
            ('K10 T', lambda: stream_t.inv_phase_b_t(y, t, False)),
            ('torch.fft.fft', lambda: torch.fft.fft(v)),
            ('torch.fft.ifft', lambda: torch.fft.ifft(v)))
    times = {what: [] for what, _ in rows}
    for what, fn in rows + rows[::-1]:
        times[what].append(back_to_back_ms(fn, 50))
    print(f'one 2^24 vector, ms per call, 50 calls back to back, in turns [{card}]:')
    for what, ms in times.items():
        print(f'  {what}: {ms[0]:.4f} / {ms[1]:.4f} ms')
    del v, z, y
    # the packed column passes K1, K4 and the filterFFT step (public API)
    rows = []
    for e in (21, 24, 26):
        n = 2**e
        t = plan.get_plan(n, 'packed', torch.complex64)[1]
        x = torch.from_numpy(gen.standard_normal(n).astype(np.float32)).cuda()
        y = pf.irfft_phase_a(pf.rfft_phase_b(pf.rfft_phase_a(x, t), t), t)
        rows += [(f'K1 2^{e}', lambda x=x, t=t: pf.rfft_phase_a(x, t)),
                 (f'K4 2^{e}', lambda y=y, t=t: pf.irfft_phase_b(y, t))]
    times = {what: [] for what, _ in rows}
    for what, fn in rows + rows[::-1]:
        times[what].append(back_to_back_ms(fn, 50))
    print(f'K1 and K4, ms per call, 50 calls back to back, in turns [{card}]:')
    for what, ms in times.items():
        print(f'  {what}: {ms[0]:.4f} / {ms[1]:.4f} ms')
    del rows, x, y
    # the inverse row passes K3 (packed) and K9 (T layout) at 2^24 and 2^26
    rows = []
    for e in (24, 26):
        n = 2**e
        t = plan.get_plan(n, 'packed', torch.complex64)[1]
        spec = torch.from_numpy((gen.standard_normal(n // 2 + 1)
                                 + 1j * gen.standard_normal(n // 2 + 1)).astype(np.complex64)).cuda()
        rows.append((f'K3 2^{e}', lambda spec=spec, t=t: pf.irfft_phase_a(spec, t)))
        ts = plan.get_plan(n, 'stream', torch.complex64)[1]
        s = torch.from_numpy((gen.standard_normal(stream.factors(n))
                              + 1j * gen.standard_normal(stream.factors(n)))
                             .astype(np.complex64)).cuda()
        rows.append((f'K9 2^{e} T', lambda s=s, t=ts: stream_t.inv_phase_a_t(s, t, False)))
    times = {what: [] for what, _ in rows}
    for what, fn in rows + rows[::-1]:
        times[what].append(back_to_back_ms(fn, 50))
    print(f'K3 and K9, ms per call, 50 calls back to back, in turns [{card}]:')
    for what, ms in times.items():
        print(f'  {what}: {ms[0]:.4f} / {ms[1]:.4f} ms')
    del rows, spec, s
    steps = []
    for n, k in ((STEP_N, 255), (BIG_N, 4097)):
        sig = dsc.from_numpy(gen.standard_normal(n // 2).astype(np.float32))
        taps = dsc.from_numpy(np.blackman(k).astype(np.float32))
        steps.append((f'filterFFT step n=2^{n.bit_length() - 1}',
                      lambda sig=sig, taps=taps, k=k, n=n: filter_fft(dsc, sig, taps, k, n)))
    v = dsc.from_numpy((gen.standard_normal(BIG_N) + 1j * gen.standard_normal(BIG_N))
                       .astype(np.complex64))
    steps.append(('single ifft(fft(x)) 2^24', lambda: dsc.ifft(dsc.fft(v))))
    times = {what: [] for what, _ in steps}
    for what, fn in steps + steps[::-1]:
        times[what].append(cuda_ms(fn))
    print(f'filterFFT step and single pair, public API, median of {RUNS} on CUDA events, '
          f'in turns [{card}]:')
    for what, ms in times.items():
        print(f'  {what}: {ms[0]:.4f} / {ms[1]:.4f} ms')


def ptxas_report(log: str) -> dict:
    """K5's kernels in nvcc's ``-Xptxas -v`` output: template arguments ->
    registers, stack frame and spill bytes."""
    import re
    report, name = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'|Function properties for (\S+)", line)
        if m:
            mangled = m.group(1) or m.group(2)
            k = re.search(r'(c?map_kernel)I', mangled)
            name = (f'{k.group(1)}<{", ".join(re.findall(r"Li(\d+)E", mangled[k.end():]))}>'
                    if k else None)
            continue
        if name is None:
            continue
        row = report.setdefault(name, {})
        m = re.search(r'(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill loads', line)
        if m:
            row.update(stack=int(m.group(1)), spill_stores=int(m.group(2)),
                       spill_loads=int(m.group(3)))
        m = re.search(r'Used (\d+) registers', line)
        if m:
            row['registers'] = int(m.group(1))
    return report


def map_times(tree: str) -> int:
    """--map-times TREE: K5 of the port in TREE (a checkout of any PR), in
    this process: nvcc's time and ptxas's registers and spills for
    stream_map.cu alone; device time per launch (50 back to back) at 2^26
    add, sin, clip, mul by a scalar and add of a 1-element tensor, the
    broadcast-row add and the 2^23+1 complex multiply, each beside the
    PyTorch call computing it; the host time of an eager add, clip and mul
    by a scalar through ops/kernels.py (the call alone on the host clock,
    and one launch between two events minus the time back to back); and
    the host time of one ``classify``. Calls only the wrapper's public
    signature, which every tree of the port shares. The last line is one
    JSON object."""
    root = os.path.abspath(tree)
    sys.path.insert(0, root)
    import dsc_tpu_torch as dsc
    from dsc_tpu_torch.kernels import build
    from dsc_tpu_torch.ops import kernels as ops_kernels, stream_map as sm
    require(dsc.__file__.startswith(root + os.sep), f'{dsc.__file__} is not under {root}')
    card = card_line()
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.time()
    out = subprocess.run([build.nvcc_path(), *build.COMPILE_FLAGS, '-Xptxas', '-v', '-c', '-o',
                          str(build.BUILD_DIR / 'stream_map_alone.o'),
                          str(build.CSRC_DIR / 'stream_map.cu')], capture_output=True, text=True)
    nvcc_s = time.time() - t0
    require(out.returncode == 0, f'nvcc stream_map.cu:\n{out.stdout}{out.stderr}')
    registers = ptxas_report(out.stdout + out.stderr)
    build.load()
    dsc.init(2**34, device='cuda')
    gen = torch.Generator(device='cuda').manual_seed(9)
    x, y, rows, row = (draw(gen, shape) for shape in (MAP_N, MAP_N, (4096, 16384), 16384))
    one = torch.tensor([1.75], device='cuda')
    a, b = (draw(gen, BIG_N // 2 + 1, torch.complex64) for _ in range(2))
    cases = (  # what, kernel, PyTorch call, bytes moved
        ('add 2^26', lambda: sm.stream_map('add', x, y), lambda: torch.add(x, y), 3 * nbytes(x)),
        ('sin 2^26', lambda: sm.stream_map('sin', x), lambda: torch.sin(x), 2 * nbytes(x)),
        ('clip 2^26 [-0.5, 0.75]', lambda: sm.stream_map('clip', x, -0.5, 0.75),
         lambda: torch.clamp(x, -0.5, 0.75), 2 * nbytes(x)),
        ('mul 2^26 by 2.5', lambda: sm.stream_map('mul', x, 2.5), lambda: torch.mul(x, 2.5),
         2 * nbytes(x)),
        ('add 2^26 + 1-element tensor', lambda: sm.stream_map('add', x, one),
         lambda: torch.add(x, one), 2 * nbytes(x) + nbytes(one)),
        ('add (4096, 16384) + row (16384,)', lambda: sm.stream_map('add', rows, row),
         lambda: torch.add(rows, row), 2 * nbytes(rows) + nbytes(row)),
        ('complex mul 2^23+1', lambda: sm.stream_map('mul', a, b), lambda: torch.mul(a, b),
         3 * nbytes(a)),
    )
    times = {}
    for what, kernel, library, n_bytes in cases:
        times[what] = {'ms': back_to_back_ms(kernel, 50), 'library_ms': back_to_back_ms(library, 50),
                       'bound_ms': n_bytes / PEAK_BYTES_S * 1e3}
    host = {}
    for what, fn in (('add', lambda: ops_kernels.binary('add', x, y)),
                     ('clip', lambda: ops_kernels.clip(x, -0.5, 0.75)),
                     ('mul by 2.5', lambda: ops_kernels.binary('mul', x, 2.5))):
        single, ms = cuda_ms(fn), back_to_back_ms(fn, 50)
        host[what] = {'single_ms': single, 'ms': ms, 'host_ms': single - ms,
                      'call_ms': call_ms(fn)}
    shapes, reps = [tuple(x.shape), tuple(y.shape)], 20000
    t0 = time.perf_counter()
    for _ in range(reps):
        sm.classify(shapes)
    classify_ms = 1e3 * (time.perf_counter() - t0) / reps
    print(json.dumps({'tree': tree, 'card': card, 'nvcc_s': nvcc_s, 'registers': registers,
                      'times': times, 'host': host, 'classify_ms': classify_ms}))
    return 0


def map_candidates(trees) -> int:
    """--map-candidates TREE...: --map-times of each tree in a process of
    its own, in turns (the trees in order, then backwards: one reading
    each way), and the table of them: ms per launch, share of the bytes'
    bound and ratio to the PyTorch call of the same process."""
    order = list(trees) + list(trees)[::-1]
    runs = {tree: [] for tree in trees}
    for tree in order:
        proc = subprocess.run([sys.executable, os.path.abspath(__file__), '--map-times', tree],
                              capture_output=True, text=True, timeout=1200)
        require(proc.returncode == 0,
                f'--map-times {tree} failed:\n{proc.stdout[-4000:]}\n{proc.stderr[-4000:]}')
        runs[tree].append(json.loads(proc.stdout.strip().splitlines()[-1]))
        print(f'  --map-times {tree}: done')
    card = runs[trees[0]][0]['card']
    print(f'K5 candidates, ms per launch (50 back to back), readings in turns '
          f'{" ".join(order)}; share of the bytes bound; ratio to the PyTorch call '
          f'in the same process [{card}]:')
    for what in runs[trees[0]][0]['times']:
        bound = runs[trees[0]][0]['times'][what]['bound_ms']
        cells = []
        for tree in trees:
            rs = [r['times'][what] for r in runs[tree]]
            cells.append(f'{tree}: ' + ' / '.join(f'{r["ms"]:.4f}' for r in rs)
                         + f' ms, {bound / np.mean([r["ms"] for r in rs]):.0%}, '
                         + ' / '.join(f'{r["ms"] / r["library_ms"]:.2f}x' for r in rs))
        lib = [r['times'][what]['library_ms'] for tree in trees for r in runs[tree]]
        print(f'  {what} (bound {bound:.4f} ms; PyTorch {min(lib):.4f}-{max(lib):.4f} ms): '
              + '; '.join(cells))
    print(f'host time of an eager op through ops/kernels.py, ms: the call alone on the host '
          f'clock (median of 100, the device idle before it); one launch between two events '
          f'minus 50 back to back [{card}]:')
    for what in runs[trees[0]][0]['host']:
        print(f'  {what}: ' + '; '.join(
            f'{tree}: ' + ' / '.join(f'{r["host"][what]["call_ms"]:.4f}' for r in runs[tree])
            + '; ' + ' / '.join(f'{r["host"][what]["host_ms"]:.4f}' for r in runs[tree])
            for tree in trees))
    print('  one stream_map.classify of two operands on the host clock, ms: ' + '; '.join(
        f'{tree}: ' + ' / '.join(f'{r["classify_ms"]:.4f}' for r in runs[tree]) for tree in trees))
    print('stream_map.cu alone, nvcc -Xptxas -v: seconds; per kernel, registers '
          '(stack frame / spill bytes where not 0):')
    for tree in trees:
        regs = runs[tree][0]['registers']
        spilled = {k: v for k, v in regs.items()
                   if v.get('stack') or v.get('spill_stores') or v.get('spill_loads')}
        print(f'  {tree}: ' + ' / '.join(f'{r["nvcc_s"]:.1f} s' for r in runs[tree])
              + f', {len(regs)} kernels, '
              + ', '.join(f'{k} {v.get("registers")}' for k, v in sorted(regs.items()))
              + (f'; stack or spills: {spilled}' if spilled else '; no stack frame, no spills'))
    return 0


# the kernels of a compiled filterFFT step, by a part of their names in
# torch.profiler: K1 and K4 are the column pass (stream_columns.cuh)
GRAPH_KERNELS = {'K1+K4': 'stream_column_kernel', 'K2': 'rfft_phase_b_kernel',
                 'K3': 'irfft_phase_a_kernel', 'K5': 'map_kernel'}


def fusion_phase(dsc, card: str, compare, timed) -> dict:
    """Phase 6: the fusion tier and the models that ride it. Each of its
    three paths runs with every launch count set to 0 just before each call
    and read just after; returns the launches of each kernel over them."""
    from dsc_tpu_torch.entry import entry
    from dsc_tpu_torch.kernels import build
    from dsc_tpu_torch.models import ISTFT, STFT, FilterFFT, OverlapSave

    gen = np.random.default_rng(6)
    launches = dict.fromkeys(KERNELS, 0)

    def counted(fn, what, want=None):
        build.reset_launches()
        res = fn()
        torch.cuda.synchronize()
        got = {name: count for name, count in build.launches.items() if count}
        require(want is None or got == want, f'{what}: launches {got}, want {want}')
        for name, count in got.items():
            launches[name] += count
        return res, got

    def conv64(sig, taps, n):
        """The full convolution of each row of ``sig`` with ``taps`` by a
        float64 FFT of ``n`` points."""
        spec = np.fft.rfft(sig.astype(np.float64), n) * np.fft.rfft(taps.astype(np.float64), n)
        return np.fft.irfft(spec, n)[..., :sig.shape[-1] + taps.shape[-1] - 1]

    def held(what, got, ref, bound=NUMPY_BOUND):
        out = got.numpy() if hasattr(got, 'numpy') else got
        require(out.shape == ref.shape and bool(np.isfinite(out).all()),
                f'{what}: shape {out.shape} (want {ref.shape}) or not finite')
        e = float(np.abs(out - ref).max() / max(np.abs(ref).max(), 1.0))
        print(f'  {what}: {e:.3e}')
        require(e <= bound, f'{what}: {e} > {bound}')

    # -- 6a. dsc.compile ----------------------------------------------------
    print('phase 6a: dsc.compile, one captured CUDA graph per signature')
    taps_np = gen.standard_normal(129).astype(np.float32)
    blk_np = gen.standard_normal(2**20).astype(np.float32)
    ff = FilterFFT(taps_np, 2**20)
    blk = dsc.from_numpy(blk_np)
    # the trace run and the capture each launch every kernel once; a replay
    # runs no Python and counts nothing
    packed = {'rfft_phase_a': 2, 'rfft_phase_b': 2, 'irfft_phase_a': 2, 'irfft_phase_b': 2}
    out, _ = counted(lambda: ff(blk), 'FilterFFT 2^20 x 129 taps, trace + capture', packed)
    counted(lambda: ff(blk), 'FilterFFT 2^20 x 129 taps, a replay', {})
    eager = dsc.irfft(dsc.mul(dsc.rfft(blk, n=ff.fft_n), ff.kernel_spec))[:ff.out_len]
    held('compiled FilterFFT 2^20 x 129 taps, n=2^21, vs float64 FFT convolution', out,
         conv64(blk_np, taps_np, ff.fft_n))
    held('  the same, vs the eager chain', out, eager.numpy(), 1e-6)
    fn, args = entry()
    out, _ = counted(lambda: fn(*args), 'entry() trace + capture',
                     {'rfft_phase_a': 4, 'rfft_phase_b': 4, 'irfft_phase_a': 2,
                      'irfft_phase_b': 2})
    held('entry() (2^20 x 4097 Blackman taps, n=2^21) vs float64 FFT convolution', out,
         conv64(args[0].numpy(), args[1].numpy(), STEP_N))
    held('  the same, vs the eager chain', out, fn._fn(*args).numpy(), 1e-6)
    big_np = gen.standard_normal(BIG_N // 2).astype(np.float32)
    big_taps = np.blackman(4097).astype(np.float32)
    big_ff = FilterFFT(big_taps, BIG_N // 2)
    big = dsc.from_numpy(big_np)
    out, _ = counted(lambda: big_ff(big), 'FilterFFT 2^23 x 4097 taps, trace + capture',
                     {**packed, 'stream_map': 2})
    held('compiled FilterFFT 2^23 x 4097 taps, n=2^24, vs float64 FFT convolution', out,
         conv64(big_np, big_taps, BIG_N))
    eager = dsc.irfft(dsc.mul(dsc.rfft(big, n=BIG_N), big_ff.kernel_spec))[:big_ff.out_len]
    held('  the same, vs the eager chain', out, eager.numpy(), 1e-6)
    del eager, out
    steps = (('entry() step, n=2^21', lambda: fn(*args), lambda: fn._fn(*args),
              {'K1+K4': 3, 'K2': 2, 'K3': 1}),
             ('FilterFFT 2^20 x 129 taps, n=2^21', lambda: ff(blk),
              lambda: ff._step._fn(blk), {'K1+K4': 2, 'K2': 1, 'K3': 1}),
             ('FilterFFT 2^23 x 4097 taps, n=2^24', lambda: big_ff(big),
              lambda: big_ff._step._fn(big),
              {'K1+K4': 2, 'K2': 1, 'K3': 1, 'K5': 1}))
    for what, compiled, eager_fn, want in steps:
        rows, prof = device_profile(compiled, what)
        got = {tag: sum(count for _, count, key in rows if part in key)
               for tag, part in GRAPH_KERNELS.items()}
        got = {tag: count for tag, count in got.items() if count}
        host = {e.key: e.count for e in prof.key_averages()}
        print(f'  {what}, 20 replays: kernels per call {got}, host calls '
              f'cudaGraphLaunch {host.get("cudaGraphLaunch", 0)}, '
              f'cudaLaunchKernel {host.get("cudaLaunchKernel", 0)}')
        require(got == want, f'{what}: the graph ran {got}, want {want}')
        require(host.get('cudaGraphLaunch', 0) == 20 and host.get('cudaLaunchKernel', 0) == 0,
                f'{what}: kernels launched from the host between the graph\'s')
        wall, eager_wall = host_ms(compiled), host_ms(eager_fn)
        busy = print_profile(rows, f'compiled {what}', wall, card)
        eager_busy = print_profile(device_profile(eager_fn, what)[0], f'eager {what}',
                                   eager_wall, card)
        print(f'  {what}: compiled {wall:.4f} ms, busy share {busy / wall:.3f}; eager '
              f'{eager_wall:.4f} ms, busy share {eager_busy / eager_wall:.3f}; '
              f'{eager_wall / wall:.2f}x [{card}]')
    del big, big_ff, ff, blk, fn, args

    # -- 6b. dsc.map --------------------------------------------------------
    print('phase 6b: dsc.map, bodies generated on the skeleton of K5 (K5g)')
    mg = torch.Generator(device='cuda').manual_seed(6)
    x, y = dsc.Tensor(draw(mg, MAP_N)), dsc.Tensor(draw(mg, MAP_N))
    t = dsc.Tensor(draw(mg, (4096, 16384)))
    row, k = dsc.Tensor(draw(mg, 16384)), dsc.Tensor(np.array([0.25], np.float32))
    # (what, fn, arguments, float operations per element, the one PyTorch
    # call of the same function where there is one)
    bodies = (('clip(x * y + 0.5, -1, 1)', lambda a, b: dsc.clip(a * b + 0.5, -1.0, 1.0),
               (x, y), 6, None),
              ('t * row + k, a broadcast row and a 1-element tensor',
               lambda a, r, s: a * r + s, (t, row, k), 2,
               lambda: torch.addcmul(k.torch, t.torch, row.torch)),
              ('(x + y, x * y), two outputs', lambda a, b: (a + b, a * b), (x, y), 2, None))
    for what, fn, fargs, ops, library_fn in bodies:
        mapped = dsc.map(fn)
        res, _ = counted(lambda: mapped(*fargs), f'dsc.map {what}', {'stream_map_gen': 1})
        kind, kernel, _ = next(iter(mapped._programs.values()))
        require(kind == 'stream', f'dsc.map {what}: route {kind}')
        nvcc_s = build.gen_build_seconds.get(build.source_hash(kernel.source))
        operands = [a.torch for a in fargs]
        outs = kernel(operands)
        for q, (o, p) in enumerate(zip(outs, kernel.plain(operands))):
            compare('stream_map_gen', o, p, f'{what} 2^26, output {q}')
        chain = fn(*fargs)
        chain = chain if isinstance(chain, tuple) else (chain,)
        res = res if isinstance(res, tuple) else (res,)
        for q, (o, c) in enumerate(zip(res, chain)):
            e = rel_err(o.torch, c.torch)
            print(f'  dsc.map {what}, output {q} vs the eager chain (K5 op by op): {e:.3e}')
            require(e <= REL_BOUND, f'dsc.map {what} vs eager: {e}')
        n_bytes = nbytes(*operands) + nbytes(*outs)
        row_ = timed('stream_map_gen', f'{what} 2^26 f32', lambda: kernel(operands),
                     lambda: kernel.plain(operands), library_fn, n_bytes, ops * MAP_N)
        row_['eager_ms'] = back_to_back_ms(lambda: fn(*fargs), 50)
        row_['nvcc_s'] = nvcc_s
        print(f'    eager chain {row_["eager_ms"]:.4f} ms ({row_["eager_ms"] / row_["ms"]:.2f}x '
              f'K5g), nvcc {nvcc_s if nvcc_s is None else round(nvcc_s, 2)} s [{card}]')
    del x, y, t, row, k, res, chain, outs, operands

    # -- 6c. the models -----------------------------------------------------
    print('phase 6c: models: STFT, STFT -> ISTFT, OverlapSave')
    model_rows = []
    st = STFT(1024, 256, 'hann')
    win = np.hanning(1024)

    def np_stft(sig):
        frames = np.lib.stride_tricks.sliding_window_view(sig.astype(np.float64), 1024, axis=-1)
        return np.fft.rfft(frames[..., ::256, :] * win, axis=-1)

    # every K12 launch of the models' runs below, by (batch, n), to hold
    # the kernel to its plain version at those launch shapes after them
    from dsc_tpu_torch.fourier import base_fft, plan
    fft_base, k12_shapes = base_fft.fft_base, set()

    def spy(x, w):
        k12_shapes.add(tuple(x.shape))
        return fft_base(x, w)

    base_fft.fft_base = spy
    trace = os.path.join(REPO, 'build', 'chip_smoke_stft_traces.json')
    xprof = os.path.join(REPO, 'build', 'chip_smoke_xprof')
    sigs = {'1 x 2^20': gen.standard_normal(2**20).astype(np.float32),
            '16 x 2^18': gen.standard_normal((16, 2**18)).astype(np.float32)}
    tens = {what: dsc.from_numpy(v) for what, v in sigs.items()}
    # torch.profiler now and then drops a device event (device_profile);
    # a trace that lacks K12's is taken again from the same two calls,
    # uncounted, at most twice
    for attempt in range(3):
        with dsc.profile(trace, serve=False, xprof_dir=xprof):
            if attempt == 0:
                got = {what: counted(lambda t=t: st(t), f'STFT {what}')[0]
                       for what, t in tens.items()}
            else:
                for t in tens.values():
                    st(t)
                torch.cuda.synchronize()
        with open(trace) as f:
            events = json.load(f)['traceEvents']
        n_stft = sum(ev.get('name') == 'stft' and ev.get('ph') == 'B' for ev in events)
        k12 = [ev for ev in events if ev.get('pid', 0) >= 1 << 22 and 'base_fft_kernel' in
               ev.get('name', '')]
        print(f'  STFT trace ({trace}): {len(events)} events, {n_stft} stft op events, '
              f'{len(k12)} K12 device events')
        if len(k12) >= 2:
            break
        print('  torch.profiler lost K12 device events of the STFT trace, tracing again')
    require(n_stft == 2 and len(k12) >= 2, 'the STFT trace lacks op or K12 device events')
    for what, sig in sigs.items():
        # the power, exp(log(p + eps)) - eps, held as tests/test_models.py
        # holds the JAX package's (atol = rtol = 1e-3): the log of a bin
        # near 0 magnifies float32 rounding without bound
        ref = np.abs(np_stft(sig)) ** 2
        out = np.exp(got[what].numpy().astype(np.float64)) - 1e-10
        ok = out.shape == ref.shape and np.allclose(out, ref, atol=1e-3, rtol=1e-3)
        print(f'  STFT(1024, 256, hann) log power {what}: the power vs NumPy float64, max abs '
              f'err {float(np.abs(out - ref).max()):.3e} of a largest {float(ref.max()):.1f}')
        require(ok, f'STFT {what}: the power not within atol = rtol = 1e-3 of NumPy')
        model_rows.append((f'STFT log power {what}', lambda t=tens[what]: st(t)))
    del got, tens, sigs
    four = gen.standard_normal((4, 2**18)).astype(np.float32)
    t4 = dsc.from_numpy(four)
    stc, ist = STFT(1024, 256, 'hann', mode='complex'), ISTFT(1024, 256, 'hann')
    z, _ = counted(lambda: stc(t4), 'STFT complex 4 x 2^18')
    held('STFT complex 4 x 2^18 vs NumPy float64', z.numpy(), np_stft(four), 1e-3)
    back, _ = counted(lambda: ist(z, length=2**18), 'ISTFT 4 x 2^18')
    e = float(np.abs(back.numpy()[:, 1024:-1024] - four[:, 1024:-1024]).max())
    print(f'  ISTFT(STFT(x)) 4 x 2^18, interior max abs err: {e:.3e}')
    require(e < 1e-4, f'ISTFT round trip: {e}')
    model_rows.append(('STFT complex -> ISTFT 4 x 2^18', lambda: ist(stc(t4), length=2**18)))
    ola = OverlapSave(taps_np, fft_n=8192)
    for what, shape in (('1 x 2^22', 2**22), ('8 x 2^20', (8, 2**20))):
        sig = gen.standard_normal(shape).astype(np.float32)
        ts = dsc.from_numpy(sig)
        out, _ = counted(lambda: ola(ts), f'OverlapSave {what}')
        held(f'OverlapSave 129 taps, fft_n=8192, {what} vs float64 FFT convolution', out,
             conv64(sig, taps_np, 2 * sig.shape[-1]))
        model_rows.append((f'OverlapSave 129 taps fft_n=8192 {what}', lambda ts=ts: ola(ts)))
    base_fft.fft_base = fft_base
    require(launches['base_fft'] > 0, 'K12 was not launched by the models')
    print(f'  K12 at the models\' launch shapes (batch, n): {sorted(k12_shapes)}')
    kg = torch.Generator(device='cuda').manual_seed(12)
    for b, n in sorted(k12_shapes):
        w = plan.get_plan(n, 'complex', torch.complex64)[1]
        z = torch.complex(draw(kg, (b, n)), draw(kg, (b, n)))
        compare('base_fft', base_fft.fft_base(z, w), base_fft.fft_base_plain(z, w),
                f'n={n} batch={b} (R={base_fft.block_rows(n, b)}), a models\' shape')
    del z
    for what, model_fn in model_rows:
        wall = host_ms(model_fn)
        busy = print_profile(device_profile(model_fn, what, steps=10)[0], what, wall, card, 10)
        print(f'  {what}: {wall:.4f} ms a call, device {busy:.4f} ms, busy share '
              f'{busy / wall:.3f} [{card}]')
    print(f'  launches on the fusion and models path: {launches}')
    return launches


# the device kernels of the port, by a part of their names in torch.profiler
PORT_KERNEL_NAMES = ('base_fft_kernel', 'stream_column_kernel', 'rfft_phase_b_kernel',
                     'irfft_phase_a_kernel', 'inv_phase_a_t_kernel', 'reconstruct_kernel',
                     'map_kernel')
# phase 7: the launches each model call must make (fourier/config.py). A
# 1024-sample segment (welch, csd, coherence, stft, istft, ShortTimeFFT) is
# one K12 launch on the 512-point half-size rows of all segments; cwt at
# 2^16 x 64 widths (fft_n = 2^17): the signal row is under the streaming
# batch rule and rides the plain four-step (512 x 256 base cases, K12
# twice), the kernel stack's rfft and the irfft of its 64 rows take K6 + K7
# each (the rows' reconstruction is plain); a single row or 7 tapers at
# 2^18-2^22 stream (K6 + K7 a transform), and a single-row irfft there
# reconstructs its spectrum with K11 first; savgol_filter's fft_convolve at
# n = 2^21 is the packed K1 + K2 twice and K3 + K4 once
K12_ONCE = {'base_fft': 1}
STREAM_ONCE = {'stream_phase_a': 1, 'stream_phase_b': 1}
STREAM_ROUND_TRIP = {'stream_phase_a': 2, 'stream_phase_b': 2, 'reconstruct': 1}


def model_wrappers():
    """The wrappers of the kernels a model call can reach: (module, name,
    plain version, kernel's name in build.launches)."""
    from dsc_tpu_torch.fourier import base_fft, packed_fused as pf, reconstruct, stream
    from dsc_tpu_torch.ops import stream_map as sm

    return ((base_fft, 'fft_base', base_fft.fft_base_plain, 'base_fft'),
            (stream, 'phase_a', stream.phase_a_plain, 'stream_phase_a'),
            (stream, 'phase_b', stream.phase_b_plain, 'stream_phase_b'),
            (reconstruct, 'reconstruct_spectrum', reconstruct.reconstruct_plain, 'reconstruct'),
            (pf, 'rfft_phase_a', pf.rfft_phase_a_plain, 'rfft_phase_a'),
            (pf, 'rfft_phase_b', pf.rfft_phase_b_plain, 'rfft_phase_b'),
            (pf, 'irfft_phase_a', pf.irfft_phase_a_plain, 'irfft_phase_a'),
            (pf, 'irfft_phase_b', pf.irfft_phase_b_plain, 'irfft_phase_b'),
            (sm, 'stream_map', lambda *a, layout=None: sm.stream_map_plain(*a), 'stream_map'))


def describe(args) -> str:
    """A launch's inputs: tensor shapes and dtypes, and static arguments."""
    parts = []
    for a in args:
        if isinstance(a, torch.Tensor):
            parts.append('x'.join(map(str, a.shape)) + ' ' + str(a.dtype).replace('torch.', ''))
        elif isinstance(a, (bool, int, float, str)):
            parts.append(repr(a))
    return ', '.join(parts)


@contextlib.contextmanager
def held_launches(compare, where):
    """Within the block, every launch of a kernel of model_wrappers() is held
    to its plain version on the same inputs just after it, at REL_BOUND, and
    labelled with ``where()`` and its inputs. The plain versions launch
    nothing, so the launch counts stay those of the calls."""
    from dsc_tpu_torch.kernels import build

    saved = []
    for module, name, plain, kernel in model_wrappers():
        fn = getattr(module, name)

        def spy(*args, fn=fn, plain=plain, kernel=kernel, **kw):
            before = build.launches[kernel]
            out = fn(*args, **kw)
            if build.launches[kernel] > before:
                compare(kernel, out, plain(*args, **kw), f'{where()}: {describe(args)}')
            return out

        saved.append((module, name, fn))
        setattr(module, name, spy)
    try:
        yield
    finally:
        for module, name, fn in saved:
            setattr(module, name, fn)


def ricker64(points: int, a: float) -> np.ndarray:
    """The Ricker wavelet in float64 (scipy's _ricker formula)."""
    x = np.arange(points) - (points - 1.0) / 2.0
    return (2.0 / (np.sqrt(3.0 * a) * np.pi ** 0.25) * (1.0 - x * x / (a * a))
            * np.exp(-x * x / (2.0 * a * a)))


def cwt64(x: np.ndarray, widths) -> np.ndarray:
    """scipy's cwt of ``x`` with ricker wavelets in float64: per width, the
    'same' part of the full convolution with the time-reversed wavelet of
    min(10 w, n) points, by np.fft."""
    n = x.size
    kernels = [ricker64(int(min(10 * w, n)), w)[::-1] for w in widths]
    fft_n = 1 << (n + max(k.size for k in kernels) - 2).bit_length()
    xs = np.fft.rfft(x, fft_n)
    out = np.empty((len(widths), n))
    for i, k in enumerate(kernels):
        off = (k.size - 1) // 2
        out[i] = np.fft.irfft(xs * np.fft.rfft(k, fft_n), fft_n)[off:off + n]
    return out


def model_shapes() -> dict:
    """The launch shapes the model tier gives K12 and K6/K7 at phase 7's
    sizes: (batch, n) of K12 for welch 1 x 2^22 and 16 x 2^18 (nperseg
    1024, hop 512) and ShortTimeFFT(hann 1024, hop 256) of 2^20; of K6/K7
    for cwt's 64 kernel rows at fft_n = 2^17."""
    import scipy.signal as sps

    from dsc_tpu_torch.models import ShortTimeFFT

    sft = ShortTimeFFT(sps.get_window('hann', 1024), 256, 1.0)
    return {'base_fft': [(1 + (2**22 - 1024) // 512, 512), (16 * (1 + (2**18 - 1024) // 512), 512),
                         (sft.p_num(2**20), 512)],
            'stream': [(64, 2**17)]}


def model_shape_checks(compare, normal, cnormal) -> None:
    """K12 and K6/K7 against their plain versions at the model tier's launch
    shapes (model_shapes)."""
    from dsc_tpu_torch.fourier import base_fft, plan, stream

    shapes = model_shapes()
    w = plan.get_plan(512, 'complex', torch.complex64)[1]
    for b, n in shapes['base_fft']:
        x = cnormal((b, n))
        compare('base_fft', base_fft.fft_base(x, w), base_fft.fft_base_plain(x, w),
                f'n={n} batch={b} (R={base_fft.block_rows(n, b)}), a model shape')
    for b, n in shapes['stream']:
        t = plan.get_plan(n, 'stream', torch.complex64)[1]
        shape = f'{b} x 2^{n.bit_length() - 1}, a model shape'
        # cwt's rfft of real rows and the inverse of their product's spectra
        x = normal((b, n))
        z = stream.phase_a(x, t, False)
        compare('stream_phase_a', z, stream.phase_a_plain(x, t, False), f'{shape} real forward')
        compare('stream_phase_b', stream.phase_b(z, t, False), stream.phase_b_plain(z, t, False),
                f'{shape} forward')
        x = cnormal((b, n))
        z = stream.phase_a(x, t, True)
        compare('stream_phase_a', z, stream.phase_a_plain(x, t, True), f'{shape} inverse')
        compare('stream_phase_b', stream.phase_b(z, t, True, True),
                stream.phase_b_plain(z, t, True, True), f'{shape} inverse real output')
    del x, z
    torch.cuda.synchronize()


def models_phase(dsc, card: str, compare) -> dict:
    """Phase 7: the FFT-shaped model tier at the sizes of
    benchmarks/results_models.json and one call of each other model, each
    against scipy.signal or NumPy in float64 with the tolerances of the JAX
    package's tests, with every launch count set to 0 just before each call
    and held to the routing just after, and every kernel launch held to its
    plain version (held_launches). Returns the launches of each kernel over
    the phase."""
    import scipy.signal as sps

    from dsc_tpu_torch import models as M
    from dsc_tpu_torch.fourier import core, plan
    from dsc_tpu_torch.kernels import build

    print('phase 7: the model tier: welch, cwt, ShortTimeFFT at full size; csd, coherence, '
          'periodogram, stft -> istft, multitaper, lombscargle, hilbert, resample, '
          'resample_poly, firwin, savgol_filter')
    gen = np.random.default_rng(7)
    launches = dict.fromkeys(KERNELS, 0)
    current = ['']

    def to64(v):
        a = v.numpy() if hasattr(v, 'numpy') else np.asarray(v)
        return a.astype(np.complex128 if np.iscomplexobj(a) else np.float64)

    def run(what, fn, want, ref, bound, scale='max'):
        """One call with the counts set to 0 before it and held to ``want``
        after it; the result against ``ref`` within ``bound`` times the
        largest |ref| ('max'), max(1, largest |ref|) ('max1') or absolutely
        ('abs')."""
        current[0] = what.split(' vs ')[0]
        build.reset_launches()
        out = fn()
        torch.cuda.synchronize()
        got = {name: count for name, count in build.launches.items() if count}
        for name, count in got.items():
            launches[name] += count
        res = to64(out)
        require(res.shape == ref.shape and bool(np.isfinite(res).all()),
                f'{what}: shape {res.shape} (want {ref.shape}) or not finite')
        err = float(np.abs(res - ref).max())
        den = {'max': float(np.abs(ref).max()), 'max1': max(1.0, float(np.abs(ref).max())),
               'abs': 1.0}[scale]
        print(f'  {what}: {err / den:.3e} ({"abs" if scale == "abs" else "rel"}, bound '
              f'{bound:g}), launches {got}')
        require(err <= bound * den, f'{what}: {err / den} > {bound}')
        require(got == want, f'{what}: launches {got}, routing says {want}')
        return out

    timed_rows = []
    with held_launches(compare, lambda: current[0]):
        # -- full size: the results_models.json rows ------------------------
        x22 = gen.standard_normal(2**22).astype(np.float32)
        t22 = dsc.from_numpy(x22)
        run('welch 1 x 2^22 (nperseg 1024) vs scipy.signal.welch float64',
            lambda: M.welch(t22, nperseg=1024)[1], K12_ONCE,
            sps.welch(x22.astype(np.float64), nperseg=1024)[1], 2e-4)
        timed_rows.append(('welch 1 x 2^22', lambda: M.welch(t22, nperseg=1024)[1]))
        x16 = gen.standard_normal((16, 2**18)).astype(np.float32)
        t16 = dsc.from_numpy(x16)
        run('welch 16 x 2^18 (nperseg 1024) vs scipy.signal.welch float64',
            lambda: M.welch(t16, nperseg=1024)[1], K12_ONCE,
            sps.welch(x16.astype(np.float64), nperseg=1024, axis=-1)[1], 2e-4)
        timed_rows.append(('welch 16 x 2^18', lambda: M.welch(t16, nperseg=1024)[1]))
        xc = gen.standard_normal(2**16).astype(np.float32)
        tc = dsc.from_numpy(xc)
        widths = np.arange(1, 65).astype(np.float64)
        run('cwt 2^16 x 64 ricker widths vs float64 np.fft convolution per width',
            lambda: M.cwt(tc, M.ricker, widths),
            {'base_fft': 2, 'stream_phase_a': 2, 'stream_phase_b': 2},
            cwt64(xc.astype(np.float64), widths), 1e-5)
        timed_rows.append(('cwt 2^16 x 64 widths', lambda: M.cwt(tc, M.ricker, widths)))
        xs = gen.standard_normal(2**20).astype(np.float32)
        ts = dsc.from_numpy(xs)
        w_hann = sps.get_window('hann', 1024)
        sft = M.ShortTimeFFT(w_hann, 256, 1.0)
        run('ShortTimeFFT(hann 1024, hop 256).stft 2^20 vs scipy.signal.ShortTimeFFT float64',
            lambda: sft.stft(ts), K12_ONCE,
            sps.ShortTimeFFT(w_hann, hop=256, fs=1.0).stft(xs.astype(np.float64)), 2e-4,
            'max1')
        timed_rows.append(('ShortTimeFFT 2^20', lambda: sft.stft(ts)))
        # -- one call each: the rest of the tier ------------------------------
        xa = gen.standard_normal((2, 2**20)).astype(np.float32)
        xb = (0.7 * xa + 0.3 * gen.standard_normal((2, 2**20))).astype(np.float32)
        ta, tb = dsc.from_numpy(xa), dsc.from_numpy(xb)
        a64, b64 = xa.astype(np.float64), xb.astype(np.float64)
        run('csd 2 x 2^20 (nperseg 1024) vs scipy.signal.csd float64',
            lambda: M.csd(ta, tb, nperseg=1024)[1], K12_ONCE,
            sps.csd(a64, b64, nperseg=1024, axis=-1)[1], 2e-4)
        run('coherence 2 x 2^20 (nperseg 1024) vs scipy.signal.coherence float64',
            lambda: M.coherence(ta, tb, nperseg=1024)[1], K12_ONCE,
            sps.coherence(a64, b64, nperseg=1024, axis=-1)[1], 5e-4, 'abs')
        run('periodogram 2^22 vs scipy.signal.periodogram float64',
            lambda: M.periodogram(t22)[1], STREAM_ONCE,
            sps.periodogram(x22.astype(np.float64))[1], 2e-4)
        zxx = run('stft 2^20 (nperseg 1024) vs scipy.signal.stft float64',
                  lambda: M.stft(ts, nperseg=1024)[2], K12_ONCE,
                  sps.stft(xs.astype(np.float64), nperseg=1024)[2], 1e-5)
        run('istft(stft(x)) 2^20 (nperseg 1024) vs x',
            lambda: M.istft(zxx, nperseg=1024)[1][:2**20], K12_ONCE,
            xs.astype(np.float64), 1e-5, 'abs')
        xm = gen.standard_normal(2**18).astype(np.float32)
        tapers, lam = sps.windows.dpss(2**18, 4.0, 7, return_ratios=True)
        pm = ((lam / lam.sum())[:, None]
              * np.abs(np.fft.rfft(tapers * xm.astype(np.float64), axis=-1)) ** 2).sum(0)
        pm[1:-1] *= 2.0
        run('multitaper 2^18 (nw 4, 7 tapers, eigen) vs float64 direct eigenspectra',
            lambda: M.multitaper(dsc.from_numpy(xm), nw=4.0, k=7, weighting='eigen')[1],
            STREAM_ONCE, pm, 1e-5)
        tl = np.sort(gen.uniform(0.0, 100.0, 4096))
        yl = np.cos(2 * np.pi * 0.7 * tl) + 0.4 * gen.standard_normal(4096)
        fl = np.linspace(0.01, 10.0, 4096)
        run('lombscargle 4096 points x 4096 frequencies vs scipy.signal.lombscargle',
            lambda: M.lombscargle(dsc.from_numpy(tl), dsc.from_numpy(yl), dsc.from_numpy(fl)),
            {}, sps.lombscargle(tl, yl, fl), 1e-6)
        run('hilbert 2^22 vs scipy.signal.hilbert float64', lambda: M.hilbert(t22),
            STREAM_ROUND_TRIP, sps.hilbert(x22.astype(np.float64)), 1e-4, 'abs')
        run('resample 2^22 -> 2^21 vs scipy.signal.resample float64',
            lambda: M.resample(t22, 2**21), STREAM_ROUND_TRIP,
            sps.resample(x22.astype(np.float64), 2**21), 1e-4, 'abs')
        run('resample_poly(up 3, down 2) 2^20 vs scipy.signal.resample_poly float64',
            lambda: M.resample_poly(ts, 3, 2),
            {'stream_phase_a': 3, 'stream_phase_b': 3, 'reconstruct': 1},
            sps.resample_poly(xs.astype(np.float64), 3, 2), 1e-4, 'max1')
        run('firwin(255, 0.2) vs scipy.signal.firwin', lambda: M.firwin(255, 0.2), {},
            sps.firwin(255, 0.2), 1e-5, 'abs')
        run('savgol_filter(2^20, 31, 3) vs scipy.signal.savgol_filter float64',
            lambda: M.savgol_filter(ts, 31, 3),
            {'rfft_phase_a': 2, 'rfft_phase_b': 2, 'irfft_phase_a': 1, 'irfft_phase_b': 1},
            sps.savgol_filter(xs.astype(np.float64), 31, 3), 1e-4)
    for name in ('base_fft', 'stream_phase_a', 'stream_phase_b', 'reconstruct'):
        require(launches[name] > 0, f'kernel {name} was not launched by the model tier')
    # the full-size rows: host clock, and device time by kernel over 10 calls;
    # the share of the plain untangle of each K12 row (R9), timed alone at
    # the K12 output's shape
    k12_of = dict(zip(('welch 1 x 2^22', 'welch 16 x 2^18', 'ShortTimeFFT 2^20'),
                      model_shapes()['base_fft']))
    wu = plan.get_plan(1024, 'real', torch.complex64)[1][1]
    for what, fn in timed_rows:
        wall = host_ms(fn)
        rows, _ = device_profile(fn, what, steps=10)
        busy = print_profile(rows, what, wall, card, 10)
        ours = sum(r[0] for r in rows if any(part in r[2] for part in PORT_KERNEL_NAMES))
        line = (f'  {what}: {wall:.4f} ms a call, device {busy:.4f} ms, busy share '
                f'{busy / wall:.3f}; the port\'s kernels {ours:.4f} ms, plain torch '
                f'{busy - ours:.4f} ms')
        if what in k12_of:
            b = k12_of[what]
            z = torch.complex(torch.randn(b, device='cuda'), torch.randn(b, device='cuda'))
            # its device time (torch.profiler): back to back, its short
            # kernels would time the host's launches
            u_ms = sum(r[0] for r in device_profile(lambda: core.untangle(z, wu),
                                                    'untangle', steps=10)[0])
            line += (f'; the plain untangle alone at {b[0]} x {b[1]}: ' + (
                f'device {u_ms:.4f} ms, {u_ms / busy:.2f} of the device time (R9)' if u_ms
                else 'not measured (torch.profiler recorded no device time)'))
        print(line + f' [{card}]')
    print(f'  launches on the models path: {launches}')
    return launches


def core_launches(steps) -> dict:
    """The launches the FFT core's calls ``steps`` make on the card by its
    own rule (fourier/core.py, config.py): each step (kind, batch, n) one
    fft_batched ('c2c'), rfft_batched ('r2c') or irfft_batched ('c2r') of
    float32/complex64 rows. Streamed rows take K6 + K7 (a single c2r row
    K11 first, where the kernel takes its size); the plain core launches
    K12 once for each complex64 base case of its plan (the half-size plan
    of a real transform up to plan.RFFT_PACK_MAX)."""
    from dsc_tpu_torch.fourier import config, plan, reconstruct

    def k12(spec):
        if spec[0] == 'base':
            return int(config.use_base_kernel(np.complex64, spec[1]))
        return k12(spec[3]) + k12(spec[4])

    want = dict.fromkeys(KERNELS, 0)
    for kind, batch, n in steps:
        real = kind != 'c2c'
        one_row = torch.empty((batch, 0), dtype=torch.complex64, device='meta')
        if kind == 'c2r' and n > plan.RFFT_PACK_MAX:
            want['reconstruct'] += int(reconstruct.kernel_takes(one_row, n))
        if config.core_streams(batch, n, real):
            want['stream_phase_a'] += 1
            want['stream_phase_b'] += 1
        else:
            half = real and n <= plan.RFFT_PACK_MAX
            want['base_fft'] += k12(plan.build_spec(max(n // 2, 1) if half else n))
    return {name: count for name, count in want.items() if count}


def transforms_phase(dsc, card: str, compare) -> dict:
    """Phase 8: the scipy.fft-parity tier (dsc_tpu_torch.transforms) at full
    size, each call against scipy.fft in float64 within 2e-4 of the largest
    value (tests/test_transforms.py ``_close``), with every launch count set
    to 0 just before it and held to the core's routing just after
    (core_launches), and every kernel launch held to its plain version
    (held_launches). Then each call's host time, its device time by kernel
    and the device's busy share. Returns the launches of each kernel over
    the phase."""
    import scipy.fft as sft

    import dsc_tpu_torch.transforms as tf
    from dsc_tpu_torch.kernels import build

    print(f'phase 8: the transforms tier: Bluestein fft, rfft -> irfft, dct, dctn -> idctn, '
          f'dst IV, fht -> ifht, a streamed irfft [{card}]')
    gen = np.random.default_rng(8)
    launches = dict.fromkeys(KERNELS, 0)
    current = ['']

    def f64(t):
        a = t.numpy()
        return a.astype(np.complex128 if np.iscomplexobj(a) else np.float64)

    def run(what, fn, steps, ref):
        """One call with the counts set to 0 before it and held to the
        core's routing of ``steps`` after it; the result against ``ref``
        within 2e-4 of its largest value."""
        current[0] = what
        build.reset_launches()
        out = fn()
        torch.cuda.synchronize()
        got = {name: count for name, count in build.launches.items() if count}
        for name, count in got.items():
            launches[name] += count
        res = f64(out)
        require(res.shape == ref.shape and bool(np.isfinite(res).all()),
                f'{what}: shape {res.shape} (want {ref.shape}) or not finite')
        err = float(np.abs(res - ref).max() / np.abs(ref).max())
        want = core_launches(steps)
        print(f'  {what}: {err:.3e} (rel, bound 2e-4), launches {got} [{card}]')
        require(err <= 2e-4, f'{what}: {err} > 2e-4')
        require(got == want, f'{what}: launches {got}, routing says {want}')
        return out

    z1 = (gen.standard_normal(10**6) + 1j * gen.standard_normal(10**6)).astype(np.complex64)
    audio = gen.standard_normal(2_880_000).astype(np.float32)  # a minute at 48 kHz
    x3 = gen.standard_normal((4096, 1000)).astype(np.float32)
    x4 = gen.standard_normal((2048, 2048)).astype(np.float32)
    x5 = gen.standard_normal((64, 2**16)).astype(np.float32)
    x6 = gen.standard_normal((16, 4096)).astype(np.float32)
    h7 = (gen.standard_normal(2**21 + 1) + 1j * gen.standard_normal(2**21 + 1)).astype(
        np.complex64)
    t1, ta, t3, t4, t5, t6, t7 = (dsc.from_numpy(a) for a in (z1, audio, x3, x4, x5, x6, h7))
    dln, mu = 0.05, 0.5  # benchmarks/tpu_smoke.py:471-476
    off = tf.fhtoffset(dln, mu)
    na = audio.size
    m1, m2 = 2**21, 2**23  # the Bluestein sizes of 10^6 and 2 880 000 points
    # (what, call of the previous row's result, the core's calls, scipy.fft
    # of the previous row's result in float64): an inverse row takes the
    # forward row's result
    rows = [
        ('T1 fft 1 x 10^6 complex64 (Bluestein m = 2^21)', lambda _: tf.fft(t1),
         [('c2c', 1, m1)] * 2, lambda _: sft.fft(z1.astype(np.complex128))),
        ('T2 rfft 2 880 000 float32 (Bluestein m = 2^23)', lambda _: tf.rfft(ta),
         [('c2c', 1, m2)] * 2, lambda _: sft.rfft(audio.astype(np.float64))),
        ('T2 irfft n = 2 880 000 of that spectrum', lambda s: tf.irfft(s, n=na),
         [('c2c', 1, m2)] * 2, lambda s64: sft.irfft(s64, n=na)),
        ('T3 dct II ortho (4096, 1000) (rdft of 2000, Bluestein m = 4096)',
         lambda _: tf.dct(t3, type=2, norm='ortho'), [('c2c', 4096, 4096)] * 2,
         lambda _: sft.dct(x3.astype(np.float64), type=2, norm='ortho')),
        ('T4 dctn II ortho (2048, 2048) (real 4096-point rows)',
         lambda _: tf.dctn(t4, type=2, norm='ortho'), [('r2c', 2048, 4096)] * 2,
         lambda _: sft.dctn(x4.astype(np.float64), type=2, norm='ortho')),
        ('T4 idctn II ortho of that', lambda s: tf.idctn(s, type=2, norm='ortho'),
         [('c2c', 2048, 4096)] * 2, lambda s64: sft.idctn(s64, type=2, norm='ortho')),
        ('T5 dst IV (64, 2^16) (complex 2^17-point rows)', lambda _: tf.dst(t5, type=4),
         [('c2c', 64, 2**17)], lambda _: sft.dst(x5.astype(np.float64), type=4)),
        (f'T6 fht (16, 4096) dln {dln} mu {mu} offset fhtoffset',
         lambda _: tf.fht(t6, dln, mu, offset=off), [('r2c', 16, 4096), ('c2r', 16, 4096)],
         lambda _: sft.fht(x6.astype(np.float64), dln, mu, offset=off)),
        ('T6 ifht of that', lambda s: tf.ifht(s, dln, mu, offset=off),
         [('r2c', 16, 4096), ('c2r', 16, 4096)],
         lambda s64: sft.ifht(s64, dln, mu, offset=off)),
        ('T7 irfft n = 2^22 of one complex64 half spectrum (K11 + K6 + K7)',
         lambda _: tf.irfft(t7, n=2**22), [('c2r', 1, 2**22)],
         lambda _: sft.irfft(h7.astype(np.complex128), n=2**22)),
    ]
    timed_rows = []
    with held_launches(compare, lambda: current[0]):
        prev = None
        for what, call, steps, ref_of in rows:
            fn = (lambda call=call, src=prev: call(src))
            ref = ref_of(None if prev is None else f64(prev))
            prev = run(what, fn, steps, ref)
            timed_rows.append((what, fn))
    for name in ('base_fft', 'stream_phase_a', 'stream_phase_b', 'reconstruct'):
        require(launches[name] > 0, f'kernel {name} was not launched by the transforms tier')
    # host clock (median of 25 after 0.25 s), device time by kernel and busy
    # share (torch.profiler over 10 calls)
    for what, fn in timed_rows:
        wall = host_ms(fn)
        rows_, _ = device_profile(fn, what, steps=10)
        busy = print_profile(rows_, what, wall, card, 10)
        ours = sum(r[0] for r in rows_ if any(part in r[2] for part in PORT_KERNEL_NAMES))
        print(f'  {what}: {wall:.4f} ms a call, device {busy:.4f} ms, busy share '
              f'{busy / wall:.3f}; the port\'s kernels {ours:.4f} ms, plain passes (chirp '
              f'products, pads, slices, untangle, copies) {busy - ours:.4f} ms [{card}]')
    print(f'  launches on the transforms path: {launches} [{card}]')
    return launches


def toeplitz_bound(batch: int, n: int, m: int, sections: int) -> tuple:
    """(bound ms, 'bytes' or 'operations') of the Toeplitz products of
    ``sections`` sections of order ``m`` over (batch, n) rows: 2 b n (256 +
    m) flops a section over the float32 rate, against the bytes they move
    (the chunked signal read, the (b n/256, 256 + m) product written, the
    (256, 256 + m) weights read) over the memory rate."""
    chunks = batch * -(-n // 256)
    flops = sections * 2.0 * chunks * 256 * (256 + m)
    n_bytes = sections * 4.0 * (chunks * 256 + chunks * (256 + m) + 256 * (256 + m))
    t_ops, t_bytes = flops / PEAK_F32_S * 1e3, n_bytes / PEAK_BYTES_S * 1e3
    return max(t_ops, t_bytes), 'operations' if t_ops >= t_bytes else 'bytes'


def recurrence_phase(dsc, card: str, compare) -> dict:
    """Phase 9: the IIR recurrence (models/iir.py) at the size of the sosfilt
    rows of benchmarks/results_models.json, each call against scipy.signal
    in float64 with the JAX package's bounds, with every launch count set
    to 0 just before it and held just after (no kernel, but decimate's 'fir'
    FFT convolution, whose launches are held to the core's rule and each to
    its plain version); TF32 allowed by the caller; 'sequential' against
    'parallel'; sosfilt -> welch under dsc.compile. Then each full-size
    row's host time, device time by kernel and op, busy share, bound and
    the device memory it holds. Returns the launches of each kernel."""
    import scipy.signal as sps

    from dsc_tpu_torch import models as M
    from dsc_tpu_torch.kernels import build
    from dsc_tpu_torch.models import iir

    print(f'phase 9: the IIR recurrence: sosfilt, lfilter, sosfiltfilt, decimate at 2^22 '
          f'[{card}]')
    gen = np.random.default_rng(9)
    launches = dict.fromkeys(KERNELS, 0)
    current = ['']

    def f64(v):
        return v.numpy().astype(np.float64)

    def run(what, fn, ref, bound, want=None):
        """One call with the counts set to 0 before it and held to ``want``
        (no launch by default) after it; the result within ``bound`` of the
        largest |ref|."""
        current[0] = what
        build.reset_launches()
        out = fn()
        torch.cuda.synchronize()
        got = {name: count for name, count in build.launches.items() if count}
        for name, count in got.items():
            launches[name] += count
        res = f64(out[0] if isinstance(out, tuple) else out)
        require(res.shape == ref.shape and bool(np.isfinite(res).all()),
                f'{what}: shape {res.shape} (want {ref.shape}) or not finite')
        err = float(np.abs(res - ref).max() / np.abs(ref).max())
        print(f'  {what}: {err:.3e} (rel, bound {bound:g}), launches {got} [{card}]')
        require(err <= bound, f'{what}: {err} > {bound}')
        require(got == (want or {}), f'{what}: launches {got}, want {want or {}}')
        return out

    sos = M.butter(4, 0.25)
    b, a = M.butter(4, 0.25, output='ba')
    x22 = gen.standard_normal(2**22).astype(np.float32)
    x8 = gen.standard_normal((8, 2**20)).astype(np.float32)
    t22, t8 = dsc.from_numpy(x22), dsc.from_numpy(x8)
    x22_64, x8_64 = x22.astype(np.float64), x8.astype(np.float64)
    sosfilt22 = sps.sosfilt(sos, x22_64)
    fir_steps = [('r2c', 1, 2**23)] * 2 + [('c2r', 1, 2**23)]  # resample_poly's, fft_n 2^23
    rows = [  # (what, call, batch, length, order, sections)
        ('sosfilt butter(4, 0.25) 1 x 2^22', lambda: M.sosfilt(sos, t22), 1, 2**22, 2, 2),
        ('sosfilt butter(4, 0.25) 8 x 2^20', lambda: M.sosfilt(sos, t8), 8, 2**20, 2, 2),
        ("lfilter butter(4, 0.25) 'ba' 1 x 2^22", lambda: M.lfilter(b, a, t22), 1, 2**22, 4,
         1),
        ('sosfiltfilt butter(4, 0.25) 1 x 2^22', lambda: M.sosfiltfilt(sos, t22), 1,
         2**22 + 30, 2, 4),
        ("decimate q 4 'iir' 1 x 2^22 (cheby1(8), sosfiltfilt)",
         lambda: M.decimate(t22, 4), 1, 2**22 + 54, 2, 8),
        ("decimate q 4 'fir' 1 x 2^22 (81 taps, resample_poly)",
         lambda: M.decimate(t22, 4, ftype='fir'), 1, 2**22, 0, 0)]
    refs = [sosfilt22, sps.sosfilt(sos, x8_64, axis=-1), sps.lfilter(b, a, x22_64),
            sps.sosfiltfilt(sos, x22_64), sps.decimate(x22_64, 4),
            sps.decimate(x22_64, 4, ftype='fir')]
    # the JAX package's bounds (tests/test_iir.py): sosfilt and lfilter 1e-4,
    # sosfiltfilt 1e-4 here, decimate 'iir' 1e-3 and 'fir' 2e-6
    bounds = [1e-4, 1e-4, 1e-4, 1e-4, 1e-3, 2e-6]
    with held_launches(compare, lambda: current[0]):
        for (what, fn, *_), ref, bound in zip(rows, refs, bounds):
            want = core_launches(fir_steps) if "'fir'" in what else None
            run(f'{what} vs scipy.signal float64', fn, ref, bound, want)
            held_mib = sum(t.numel() * 4 for entry in iir._PLAN_CACHE.values()
                           for t in _tensors_in(entry)) / 2**20
            print(f'    the constant cache after it: {len(iir._PLAN_CACHE)} entries, '
                  f'{held_mib:.3f} MiB on the device')
    require(all(launches[k] > 0 for k in ('stream_phase_a', 'stream_phase_b')),
            "decimate 'fir' launched no FFT kernel")

    # TF32 allowed by the caller: the recurrence still runs in full float32,
    # and the caller's setting is as it was after the call
    matmul = torch.backends.cuda.matmul
    matmul.allow_tf32 = True
    try:
        run('sosfilt 1 x 2^22 with allow_tf32 = True vs scipy.signal float64',
            lambda: M.sosfilt(sos, t22), sosfilt22, 1e-4)
        require(matmul.allow_tf32 is True, 'sosfilt changed the caller\'s allow_tf32')
        # what the guard prevents, measured once: the same call with TF32 on
        with contextlib.ExitStack() as stack:
            saved = iir._full_f32
            iir._full_f32 = contextlib.nullcontext
            stack.callback(setattr, iir, '_full_f32', saved)
            raw = f64(M.sosfilt(sos, t22))
        print(f'  the same call with TF32 on the products (the guard removed): '
              f'{float(np.abs(raw - sosfilt22).max() / np.abs(sosfilt22).max()):.3e} '
              f'(rel) [{card}]')
    finally:
        matmul.allow_tf32 = False

    # 'sequential' (the exact step, a loop over time) against 'parallel'
    x4k = gen.standard_normal(4096).astype(np.float32)
    t4k = dsc.from_numpy(x4k)
    par = run('sosfilt 4096 parallel vs scipy.signal float64', lambda: M.sosfilt(sos, t4k),
              sps.sosfilt(sos, x4k.astype(np.float64)), 1e-4)
    seq = run('sosfilt 4096 sequential vs parallel',
              lambda: M.sosfilt(sos, t4k, method='sequential'), f64(par), 1e-4)
    seq_ms = host_ms(lambda: M.sosfilt(sos, t4k, method='sequential'), runs=5)
    par_ms = host_ms(lambda: M.sosfilt(sos, t4k))
    print(f'  sosfilt 4096: sequential {seq_ms:.3f} ms a call (median of 5), parallel '
          f'{par_ms:.4f} ms (median of 25) [{card}]')
    del seq

    # sosfilt -> welch under dsc.compile: one captured graph, no host launch
    xw = gen.standard_normal((4, 4096)).astype(np.float32)
    sos3 = M.butter(4, 0.3)

    def pipe(s):
        return M.welch(M.sosfilt(sos3, s), nperseg=256)[1]

    compiled = dsc.compile(pipe)
    tw = dsc.from_numpy(xw)
    want_w = {k: 2 * v for k, v in core_launches([('r2c', 4 * 31, 256)]).items()}
    got_w = run('compiled sosfilt -> welch(nperseg 256) 4 x 4096 vs scipy float64, trace + '
                'capture', lambda: compiled(tw), sps.welch(sps.sosfilt(
                    sos3, xw.astype(np.float64), axis=-1), nperseg=256, axis=-1)[1], 2e-4,
                want_w)
    eager_w = pipe(tw)
    e = rel_err(got_w.torch, eager_w.torch)
    print(f'  the replay vs the eager chain: {e:.3e} (rel, bound 1e-6)')
    require(e <= 1e-6, f'compiled sosfilt -> welch vs eager: {e}')
    require(compiled.n_programs == 1, 'compiled sosfilt -> welch: more than one program')
    rows_w, prof = device_profile(lambda: compiled(tw), 'compiled sosfilt -> welch')
    host = {ev.key: ev.count for ev in prof.key_averages()}
    print(f'  compiled sosfilt -> welch, 20 replays: host calls cudaGraphLaunch '
          f'{host.get("cudaGraphLaunch", 0)}, cudaLaunchKernel {host.get("cudaLaunchKernel", 0)}')
    require(host.get('cudaGraphLaunch', 0) == 20 and host.get('cudaLaunchKernel', 0) == 0,
            'compiled sosfilt -> welch: kernels launched from the host between the graph\'s')
    wall, eager_wall = host_ms(lambda: compiled(tw)), host_ms(lambda: pipe(tw))
    busy = print_profile(rows_w, 'compiled sosfilt -> welch 4 x 4096', wall, card)
    eager_busy = print_profile(device_profile(lambda: pipe(tw), 'eager sosfilt -> welch')[0],
                               'eager sosfilt -> welch 4 x 4096', eager_wall, card)
    print(f'  sosfilt -> welch 4 x 4096: compiled {wall:.4f} ms (busy {busy / wall:.3f}), '
          f'eager {eager_wall:.4f} ms (busy {eager_busy / eager_wall:.3f}) [{card}]')

    # the full-size rows: host clock, device time by kernel and op over 10
    # calls, busy share, the Toeplitz products' bound, peak device memory
    for what, fn, batch, n, m, sections in rows:
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        fn()
        torch.cuda.synchronize()
        peak = (torch.cuda.max_memory_allocated() - base) / 2**20
        wall = host_ms(fn)
        rows_, prof = device_profile(fn, what, steps=10)
        busy = print_profile(rows_, what, wall, card, 10)
        if what.startswith('sosfilt') and batch == 1:
            # where the host time goes: the torch ops by their own CPU time
            # (under the profiler, which adds its own), largest first
            events = [e for e in prof.key_averages() if e.self_cpu_time_total > 0]
            cpu = sorted(((e.self_cpu_time_total / 10 / 1e3, e.count // 10, e.key)
                          for e in events), reverse=True)[:12]
            print(f'  {what}, host: {sum(e.count for e in events) // 10} profiled host calls a '
                  f'call (aten ops, views and CUDA runtime calls); by self CPU time a call under '
                  f'the profiler ({sum(r[0] for r in cpu):.4f} ms in these 12):')
            for ms, count, key in cpu:
                print(f'    {ms:9.4f} ms  x{count:<3d} {key[:80]}')
        mm = sum(r[0] for r in rows_ if 'gemm' in r[2].lower() or 'gemv' in r[2].lower())
        line = (f'  {what}: {wall:.4f} ms a call, device {busy:.4f} ms, busy share '
                f'{busy / wall:.3f}, {sum(r[1] for r in rows_)} kernels and copies a call; '
                f'matrix products (cuBLAS gemm/gemv) {mm:.4f} ms; peak device memory above the '
                f'input {peak:.1f} MiB')
        if sections:
            bound, bound_by = toeplitz_bound(batch, n, m, sections)
            line += f'; bound of the Toeplitz products {bound:.4f} ms ({bound_by})'
        print(line + f' [{card}]')
    print(f'  launches on the recurrence path: {launches} [{card}]')
    return launches


def scans_phase(dsc, card: str) -> dict:
    """Phase 10: the affine-scan tier (models/statespace.py, splines.py) at the
    sizes a user of a state-space simulator or a spline smoother runs on one
    card, every call against scipy.signal in float64, with the launch counts
    set to 0 just before it and held at 0 just after (the tier reaches no
    kernel); then each full-size row's host time, device time by op, busy
    share, device launches a call, peak device memory above the input and the
    bound of its float64 input and output bytes. Returns the launches of each
    kernel (all 0)."""
    import scipy.signal as sps

    from dsc_tpu_torch import models as M
    from dsc_tpu_torch.kernels import build
    from dsc_tpu_torch.models import splines

    print(f'phase 10: the affine-scan tier: dlsim, lsim, step, impulse, the splines [{card}]')
    gen = np.random.default_rng(10)

    # cuBLAS's handle and workspace, made by the first matrix product of a
    # process, are not counted in the first row's peak
    torch.ones((4, 4), dtype=torch.float64, device='cuda').matmul(
        torch.ones((4, 4), dtype=torch.float64, device='cuda'))
    t_phase = time.perf_counter()
    first = {}   # row -> (host ms, peak device MiB above what was allocated before it)
    ref_ms = {}  # row -> host ms of its scipy references

    def run(what, fn):
        """``fn()`` with the counts set to 0 before it; no kernel launched.
        The call's host time and its peak device memory above what was
        allocated before it are kept in ``first``."""
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        build.reset_launches()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        ms = 1e3 * (time.perf_counter() - t0)
        first[what] = (ms, (torch.cuda.max_memory_allocated() - base) / 2**20)
        got = {name: count for name, count in build.launches.items() if count}
        require(not got, f'{what}: launched {got}')
        return out

    def ref(what, fn):
        """scipy's ``fn()``, its host time added to the row's in ``ref_ms``."""
        t0 = time.perf_counter()
        out = fn()
        ref_ms[what] = ref_ms.get(what, 0.0) + 1e3 * (time.perf_counter() - t0)
        return out

    def check(what, got, ref, bound, tail=''):
        """``got`` within ``bound`` of the largest |ref|, finite, as shaped."""
        got = np.asarray(got.numpy() if isinstance(got, dsc.Tensor) else got, np.float64)
        require(got.shape == ref.shape and bool(np.isfinite(got).all()),
                f'{what}: shape {got.shape} (want {ref.shape}) or not finite')
        err = float(np.abs(got - ref).max() / np.abs(ref).max())
        print(f'  {what}: {err:.3e} (rel, bound {bound:g}){tail} [{card}]')
        require(err <= bound, f'{what}: {err} > {bound}')

    # the full-size rows: what -> (call, values of its array arguments, values
    # of its array results, host runs). Each row's first call is the one that
    # is checked against scipy, and gives its peak memory; the smoothing
    # cspline1d builds its tables each call (seconds), so that first call is
    # also its host time, and one more call its profile
    ssc = M.tf2ss(*sps.butter(4, 2 * np.pi * 50, analog=True))
    sysd = M.cont2discrete(ssc, 1e-3)
    u22 = gen.standard_normal(2**22).astype(np.float32)
    u22t = dsc.from_numpy(u22)
    u20 = u22[:2**20].astype(np.float64)
    t6 = np.arange(10**6) * 1e-4
    U6 = gen.standard_normal(10**6)
    b64 = gen.standard_normal((64, 2**16)).astype(np.float32)
    b64t = dsc.from_numpy(b64)
    im = gen.standard_normal((2048, 2048)).astype(np.float32)
    imt, im64 = dsc.from_numpy(im), im.astype(np.float64)
    hrow, hcol = np.array([1.0, 4.0, 6.0, 4.0, 1.0]) / 16, np.array([-1.0, 2.0, 5.0, 2.0, -1.0]) / 7
    rows = {
        'dlsim 4 states x 2^22, Tensor path': (lambda: M.dlsim(sysd, u22t), 2**22, 6 * 2**22,
                                               RUNS),
        'dlsim 4 states x 2^20, numpy path': (lambda: M.dlsim(sysd, u20), 2**20, 6 * 2**20,
                                              RUNS),
        'lsim foh 10^6 times': (lambda: M.lsim(ssc, U6, t6), 2 * 10**6, 6 * 10**6, RUNS),
        'step N = 10^5': (lambda: M.step(ssc, N=10**5), 0, 2 * 10**5, RUNS),
        'impulse N = 10^5': (lambda: M.impulse(ssc, N=10**5), 0, 2 * 10**5, RUNS),
        'cspline1d lamb 0.0 2^22': (lambda: M.cspline1d(u22t), 2**22, 2**22, RUNS),
        'cspline1d lamb 1.0 2^22': (lambda: M.cspline1d(u22t, 1.0), 2**22, 2**22, 1),
        'qspline1d 2^22': (lambda: M.qspline1d(u22t), 2**22, 2**22, RUNS),
        'symiirorder1 (64, 2^16)': (lambda: M.symiirorder1(b64t, 2.0, 0.5), 2**22, 2**22, RUNS),
        'symiirorder2 (64, 2^16)': (lambda: M.symiirorder2(b64t, 0.8, 1.2), 2**22, 2**22, RUNS),
        'cspline2d lamb 0 2048 x 2048': (lambda: M.cspline2d(imt, 0.0), 2**22, 2**22, RUNS),
        'cspline2d lamb 5 2048 x 2048': (lambda: M.cspline2d(imt, 5.0), 2**22, 2**22, RUNS),
        'spline_filter lamb 5 2048 x 2048': (lambda: M.spline_filter(imt, 5.0), 2**22, 2**22,
                                             RUNS),
        'sepfir2d 5 x 5 taps 2048 x 2048': (lambda: M.sepfir2d(imt, hrow, hcol), 2**22, 2**22,
                                            RUNS)}

    # dlsim: the zoh discretization of the analog butter(4, 2 pi 50) at 1 kHz
    num, den = sps.ss2tf(*sysd[:4])
    _, y_ref, x_ref = ref('dlsim 4 states x 2^20, numpy path',
                          lambda: sps.dlsim(sysd, u20))  # a Python loop over 2^20 steps
    what = 'dlsim 4 states x 2^22, Tensor path'
    _, y, x = run(what, rows[what][0])
    require(y.device.type == 'cuda' and x.dtype == dsc.Dtype.F32,
            'dlsim Tensor path: results not float32 on the card')
    check(f'{what}: y vs scipy.signal.lfilter float64', y.numpy()[:, 0],
          ref(what, lambda: sps.lfilter(num[0], den, u22.astype(np.float64))), 1e-5)
    check('  x, the first 2^18 steps, vs scipy.signal.dlsim', x.numpy()[:2**18],
          x_ref[:2**18], 1e-5)
    what = 'dlsim 4 states x 2^20, numpy path'
    _, y, x = run(what, rows[what][0])
    require(y.dtype == x.dtype == np.float64, 'dlsim numpy path: results not float64')
    check(f'{what}: y vs scipy.signal.dlsim (the loop above)', y, y_ref, 1e-10)
    check('  x', x, x_ref, 1e-10)
    del y, x, x_ref, y_ref
    what = 'lsim foh 10^6 times'
    _, y, _ = run(what, rows[what][0])
    check(f'{what} vs scipy.signal.lsim', y, ref(what, lambda: sps.lsim(ssc, U6, t6))[1], 1e-10)
    for name in ('step', 'impulse'):
        what = f'{name} N = 10^5'
        t, y = run(what, rows[what][0])
        t_ref, y_ref = ref(what, lambda name=name: getattr(sps, name)(ssc, N=10**5))
        require(np.allclose(t, t_ref, rtol=1e-12, atol=0), f'{name}: horizon differs from scipy')
        check(f'{what} vs scipy.signal.{name}', y, y_ref, 1e-10)
    del y

    # the splines, 1-D, batched and 2-D
    x22_64 = u22.astype(np.float64)
    c_ref = {}
    for lamb in (0.0, 1.0):
        what = f'cspline1d lamb {lamb} 2^22'
        c_ref[lamb] = ref(what, lambda lamb=lamb: sps.cspline1d(x22_64, lamb))
        check(f'{what} vs scipy.signal.cspline1d', run(what, rows[what][0]), c_ref[lamb], 1e-6)
    # the coefficient program in float64 on the card before the final cast:
    # a scan run in float32 would miss this bound by orders of magnitude
    rows64 = torch.from_numpy(x22_64[None]).to('cuda')
    got = run('the cspline1d program', lambda: splines._spline_coeff_program(
        rows64, float(-2.0 + np.sqrt(3.0)), 6.0))
    require(got.dtype == torch.float64 and got.device.type == 'cuda',
            f'the cspline1d program: {got.dtype} on {got.device}')
    check('  its float64 coefficients on the card before the cast vs scipy', got.cpu().numpy()[0],
          c_ref[0.0], 1e-12)
    del rows64, got, c_ref
    what = 'qspline1d 2^22'
    check(f'{what} vs scipy.signal.qspline1d', run(what, rows[what][0]),
          ref(what, lambda: sps.qspline1d(x22_64)), 1e-6)
    what = 'symiirorder1 (64, 2^16)'
    check(f'{what}, (2, 0.5), vs scipy.signal.symiirorder1 row by row', run(what, rows[what][0]),
          ref(what, lambda: np.stack([sps.symiirorder1(r.astype(np.float64), 2.0, 0.5)
                                      for r in b64])), 1e-6)
    what = 'symiirorder2 (64, 2^16)'
    check(f'{what}, (0.8, 1.2), vs scipy.signal.symiirorder2 row by row', run(what, rows[what][0]),
          ref(what, lambda: np.stack([sps.symiirorder2(r.astype(np.float64), 0.8, 1.2)
                                      for r in b64])), 2e-6)
    what = 'cspline2d lamb 0 2048 x 2048'
    check(f'{what} vs scipy.signal.cspline2d', run(what, rows[what][0]),
          ref(what, lambda: sps.cspline2d(im64, 0.0)), 1e-5)
    # the smoothing cases: scipy stops each boundary series at its first
    # small term (tests/test_splines.py: 5e-3 overall, 5e-4 inside)
    for what, ref_fn in (('cspline2d lamb 5 2048 x 2048', lambda: sps.cspline2d(im64, 5.0)),
                         ('spline_filter lamb 5 2048 x 2048',
                          lambda: sps.spline_filter(im64, 5.0))):
        want = ref(what, ref_fn)
        got = run(what, rows[what][0]).numpy().astype(np.float64)
        inner = float(np.abs(got - want)[4:-4, 4:-4].max() / np.abs(want).max())
        require(inner <= 5e-4, f'{what}: inside the border {inner} > 5e-4')
        check(f'{what} vs scipy.signal', got, want, 5e-3,
              f', {inner:.3e} inside the border (bound 5e-4)')
    what = 'sepfir2d 5 x 5 taps 2048 x 2048'
    check(f'{what} vs scipy.signal.sepfir2d', run(what, rows[what][0]),
          ref(what, lambda: sps.sepfir2d(im64, hrow, hcol)), 1e-5)
    checked_s = time.perf_counter() - t_phase

    # the smoothing cspline1d's host boundary tables: built and uploaded each call
    rho, omega = splines._coeff_smooth_params(1.0)
    t0 = time.perf_counter()
    _, tables = splines._symiir2_host_tables(rho, omega, 2**22, 0.0, 'cspline1d')
    build_ms = 1e3 * (time.perf_counter() - t0)
    upload_ms = host_ms(lambda: torch.from_numpy(tables).to('cuda'), runs=5)
    print(f'  cspline1d lamb 1 at 2^22: its four 2^22 float64 boundary tables take {build_ms:.1f} '
          f'ms to build on the host (one build) and {upload_ms:.2f} ms to upload '
          f'({tables.nbytes / 2**20:.0f} MiB, median of 5) [{card}]')
    del tables

    # each row's host time, device time by op over 10 calls (the smoothing
    # cspline1d: its checked call, and one profiled call), busy share,
    # launches, the first call's peak memory and its float64 bytes' bound
    t_timed = time.perf_counter()
    for what, (fn, n_in, n_out, runs) in rows.items():
        first_ms, peak = first[what]
        wall = host_ms(fn, runs=runs) if runs > 1 else first_ms
        steps = 10 if runs > 1 else 1
        # torch.profiler drops the same events at every attempt on these
        # rows, so one profile, its short counts printed
        busy, prof_rows, _, how = device_busy(fn, what, wall, card, steps)
        require(busy > 0, f'{what}: no device time')
        bound = 8.0 * (n_in + n_out) / PEAK_BYTES_S * 1e3
        timing = f'median of {runs}' if runs > 1 else 'the checked call'
        print(f'  {what}: {wall:.4f} ms a call ({timing}), device {busy:.4f} ms ({how}), busy '
              f'share {busy / wall:.3f}, {sum(r[1] for r in prof_rows)} kernels and copies a '
              f'call; peak device memory above the input {peak:.1f} MiB; bound of its float64 '
              f'input and output bytes {bound:.4f} ms ({busy / bound:.1f}x); the checked call '
              f'{first_ms:.1f} ms, its scipy references {ref_ms[what]:.1f} ms [{card}]')
    timed_s = time.perf_counter() - t_timed
    print(f'  phase 10: {time.perf_counter() - t_phase:.1f} s: the checks {checked_s:.1f} s '
          f'(scipy references {sum(ref_ms.values()) / 1e3:.1f} s, the port\'s checked calls '
          f'{sum(ms for ms, _ in first.values()) / 1e3:.1f} s), the tables {build_ms / 1e3:.1f} s, '
          f'timing and profiles {timed_s:.1f} s [{card}]')
    return dict.fromkeys(KERNELS, 0)



class TierRows:
    """The checked calls of a tier's phase (11, 12): each row's launches,
    added up in ``launches``, the row being checked in ``current[0]`` (for
    held_launches), and each checked call's host ms and peak device MiB
    above what was allocated before it in ``first``."""

    def __init__(self, card: str):
        self.card = card
        self.launches = dict.fromkeys(KERNELS, 0)
        self.current = ['']
        self.first = {}

    def run(self, what, fn, want=None):
        """``fn()`` with the counts set to 0 before it and held to ``want``
        (no launch by default) after it; the call's host time and peak device
        memory above what was allocated before it are kept in ``first``."""
        from dsc_tpu_torch.kernels import build

        self.current[0] = what
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        build.reset_launches()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        self.first[what] = (1e3 * (time.perf_counter() - t0),
                            (torch.cuda.max_memory_allocated() - base) / 2**20)
        got = {name: count for name, count in build.launches.items() if count}
        for name, count in got.items():
            self.launches[name] += count
        require(got == (want or {}), f'{what}: launches {got}, want {want or {}}')
        return out

    def time_row(self, what, fn, n_bytes):
        """The row's host time (median of RUNS), device time by op
        (torch.profiler over 10 calls) and busy share, the checked call's host
        time and peak memory, and the bound of its ``n_bytes`` (0: none) over
        the memory rate: the line to print, and the profile."""
        wall = host_ms(fn)
        busy, prof_rows, prof, how = device_busy(fn, what, wall, self.card, 10)
        require(busy > 0, f'{what}: no device time')
        line = (f'  {what}: {wall:.4f} ms a call, device {busy:.4f} ms ({how}), busy share '
                f'{busy / wall:.3f}, {sum(r[1] for r in prof_rows)} kernels and copies a call')
        if what in self.first:
            line += (f'; the checked call {self.first[what][0]:.1f} ms, peak device memory '
                     f'above what it was given {self.first[what][1]:.1f} MiB')
        if n_bytes:
            bound = n_bytes / PEAK_BYTES_S * 1e3
            line += f'; bound of its bytes {bound:.4f} ms ({busy / bound:.1f}x)'
        return line, prof

    def check(self, what, got, ref, bound, exact=False, scale='max'):
        """``got`` (a Tensor, or a host array) against the float64 host
        ``ref`` where ``got`` lies: equal (``exact``) or within ``bound`` times the
        largest |ref| ('max') or max(1, largest |ref|) ('max1'); finite, as
        shaped."""
        g = torch.from_numpy(got) if isinstance(got, np.ndarray) else got.torch
        r = torch.from_numpy(np.ascontiguousarray(ref)).to(g.device)
        require(tuple(g.shape) == tuple(r.shape) and bool(torch.isfinite(g).all()),
                f'{what}: shape {tuple(g.shape)} (want {tuple(r.shape)}) or not finite')
        if exact:
            n_diff = int((g.to(torch.float64) != r).sum())
            print(f'  {what}: {n_diff} samples differ (bound: none) [{self.card}]')
            require(n_diff == 0, f'{what}: {n_diff} samples differ')
            return
        top = float(r.abs().max())
        den = max(1.0, top) if scale == 'max1' else top
        err = float((g.to(torch.float64) - r).abs().max()) / den
        print(f'  {what}: {err:.3e} (rel, bound {bound:g}) [{self.card}]')
        require(err <= bound, f'{what}: {err} > {bound}')


# phase 11's sizes: the waves' time axes, the 1-D filters' signals and the
# images' side
WAVE_N = 2**24
FILTER_N = 2**22
IMAGE_SIDE = 2048


def square_formula(v: np.ndarray, duty: float) -> np.ndarray:
    """The JAX package's square wave (dsc_tpu/models/waveforms.py:77) in
    float64 NumPy: jnp.mod's remainder, one division, a comparison."""
    r = np.fmod(v, 2 * np.pi)
    return np.where(np.where(r < 0, r + 2 * np.pi, r) / (2 * np.pi) < duty, 1.0, -1.0)


def sawtooth_formula(v: np.ndarray, width: float) -> np.ndarray:
    """The JAX package's sawtooth (dsc_tpu/models/waveforms.py:92) in
    float64 NumPy."""
    r = np.fmod(v, 2 * np.pi)
    frac = np.where(r < 0, r + 2 * np.pi, r) / (2 * np.pi)
    return np.where(frac < width, 2.0 * frac / width - 1.0,
                    2.0 * (1.0 - frac) / (1.0 - width) - 1.0)


def signals_phase(dsc, card: str, compare) -> dict:
    """Phase 11: the signal-generation and design tier (models/waveforms.py,
    nonlinear.py; iirdesign.py on the host) at full size, every call with
    the launch counts set to 0 just before it and held to the routing just
    after, each against scipy.signal in float64 applied to the same values:
    the five waves on float64 and float32 time axes of WAVE_N samples in
    both output dtypes (no kernel), the nonlinear filters of FILTER_N
    samples and IMAGE_SIDE^2 images (no kernel), and the chain chirp + noise
    -> sosfilt(iirdesign ellip) -> medfilt(5) -> welch(1024) of FILTER_N
    samples stage by stage (K5 on the add, K12 in welch, each launch held to
    its plain version), eager and under dsc.compile. Then each row's host
    time, device time by op, busy share, peak device memory above its input
    and the bound of its bytes. Returns the launches of each kernel."""
    from concurrent.futures import ThreadPoolExecutor

    import scipy.signal as sps

    from dsc_tpu_torch import models as M

    print(f'phase 11: the signal-generation and design tier: five waves of {WAVE_N} samples, '
          f'medfilt / medfilt2d / order_filter / wiener, chirp -> sosfilt(ellip) -> medfilt -> '
          f'welch [{card}]')
    gen = np.random.default_rng(11)
    rows = TierRows(card)
    launches, current, first, run, check = rows.launches, rows.current, rows.first, rows.run, \
        rows.check
    t_phase = time.perf_counter()

    # -- the inputs, and scipy's float64 references in 8 threads (numpy
    #    releases the interpreter lock in its array loops)
    t_np = np.arange(WAVE_N) / 1e7  # 1.68 s at 10 MHz: phases up to ~5e4 rad
    t1 = float(t_np[-1])
    tc_np = t_np - t1 / 2           # centred, for the pulse
    ph_np = 2 * np.pi * 1000.0 * t_np
    poly = [-500.0, 3000.0, 2000.0]
    axes = {}  # (axis, precision) -> (the port's Tensor, the float64 values it holds)
    for axis, values in (('t', t_np), ('tc', tc_np), ('phase', ph_np)):
        axes[axis, 'f64'] = (dsc.from_numpy(values), values)
        v32 = values.astype(np.float32)
        axes[axis, 'f32'] = (dsc.from_numpy(v32), v32.astype(np.float64))
    waves = {  # row -> (axis, the port's wave of an axis Tensor, scipy's of float64 values)
        f'chirp {m}': ('t', lambda t, d, m=m: M.chirp(t, 100.0, t1, 1e4, method=m, dtype=d),
                       lambda v, m=m: sps.chirp(v, 100.0, t1, 1e4, method=m))
        for m in ('linear', 'quadratic', 'logarithmic', 'hyperbolic')}
    waves.update({
        'square duty 0.3': ('phase', lambda t, d: M.square(t, 0.3, dtype=d),
                            lambda v: sps.square(v, 0.3)),
        'sawtooth width 0.7': ('phase', lambda t, d: M.sawtooth(t, 0.7, dtype=d),
                               lambda v: sps.sawtooth(v, 0.7)),
        'gausspulse fc 20 bw 0.5': ('tc', lambda t, d: M.gausspulse(t, 20.0, 0.5, dtype=d),
                                    lambda v: sps.gausspulse(v, 20.0, 0.5)),
        'sweep_poly (-500, 3000, 2000)': ('t', lambda t, d: M.sweep_poly(t, poly, dtype=d),
                                          lambda v: sps.sweep_poly(v, poly))})

    x22 = gen.standard_normal(FILTER_N).astype(np.float32)
    b64 = gen.standard_normal((64, FILTER_N // 64)).astype(np.float32)
    im = gen.standard_normal((IMAGE_SIDE, IMAGE_SIDE)).astype(np.float32)
    x22t, b64t, imt = dsc.from_numpy(x22), dsc.from_numpy(b64), dsc.from_numpy(im)
    x22_64, im64 = x22.astype(np.float64), im.astype(np.float64)
    dom11 = np.array([1, 1, 0, 1, 0, 1, 0, 1, 0, 1, 1])
    filters = {  # row -> (call, scipy's float64 result, exact, bound)
        f'medfilt 1 x 2^{FILTER_N.bit_length() - 1} k 21': (
            lambda: M.medfilt(x22t, 21), lambda: sps.medfilt(x22_64, 21), True, 0),
        f'medfilt (64, {FILTER_N // 64}) k 7, scipy row by row': (
            lambda: M.medfilt(b64t, 7),
            lambda: np.stack([sps.medfilt(r.astype(np.float64), 7) for r in b64]), True, 0),
        f'medfilt2d {IMAGE_SIDE}^2 5 x 5': (
            lambda: M.medfilt2d(imt, 5), lambda: sps.medfilt2d(im64, 5), True, 0),
        **{f'order_filter {IMAGE_SIDE}^2 3 x 3 rank {r}': (
            lambda r=r: M.order_filter(imt, np.ones((3, 3)), r),
            lambda r=r: sps.order_filter(im64, np.ones((3, 3)), r), True, 0) for r in (0, 4, 8)},
        # scipy on the signal as a 1-row image: its 1-D path (ndimage's
        # rank_filter) counts a domain's zeros as taps (scipy 1.17)
        f'order_filter 1 x 2^{FILTER_N.bit_length() - 1}, 11-tap domain (7 taps), rank 3': (
            lambda: M.order_filter(x22t, dom11, 3),
            lambda: sps.order_filter(x22_64[None], dom11[None], 3)[0], True, 0),
        # tests/test_psd_fir.py: 1e-4 of max(1, largest |ref|)
        f'wiener 1 x 2^{FILTER_N.bit_length() - 1} mysize 21, noise 0.5': (
            lambda: M.wiener(x22t, 21, 0.5), lambda: sps.wiener(x22_64, 21, 0.5), False, 1e-4),
        f'wiener 1 x 2^{FILTER_N.bit_length() - 1} mysize 21, noise estimated': (
            lambda: M.wiener(x22t, 21), lambda: sps.wiener(x22_64, 21), False, 1e-4)}

    # square and sawtooth, also as the JAX package computes them (its
    # formula, not scipy's: they part one ulp from a jump)
    formulas = {'square duty 0.3': lambda v: square_formula(v, 0.3),
                'sawtooth width 0.7': lambda v: sawtooth_formula(v, 0.7)}
    t_refs = time.perf_counter()
    with ThreadPoolExecutor(8) as pool:
        wave_refs = {(what, prec): pool.submit(ref, axes[axis, prec][1])
                     for what, (axis, _, ref) in waves.items() for prec in ('f64', 'f32')}
        formula_refs = {(what, prec): pool.submit(fn, axes['phase', prec][1])
                        for what, fn in formulas.items() for prec in ('f64', 'f32')}
        filter_refs = {what: pool.submit(row[1]) for what, row in filters.items()}
        wave_refs = {key: f.result() for key, f in wave_refs.items()}
        formula_refs = {key: f.result() for key, f in formula_refs.items()}
        filter_refs = {key: f.result() for key, f in filter_refs.items()}
    refs_s = time.perf_counter() - t_refs

    def square_vs_scipy(row, out, values, ref, duty):
        """Where the square wave differs from scipy's, the phase lies within
        8 ulps of a jump (duty * 2 pi, or 0 = 2 pi)."""
        idx = torch.nonzero(out.torch.to(torch.float64)
                            != torch.from_numpy(ref).to(out.device)).flatten().cpu().numpy()
        tmod = np.mod(values[idx], 2 * np.pi)
        dist = np.minimum(np.abs(tmod - duty * 2 * np.pi), np.minimum(tmod, 2 * np.pi - tmod))
        near = dist <= 8 * np.spacing(2 * np.pi)
        print(f'  {row} vs scipy.signal.square float64: {idx.size} of {values.size} samples '
              f'differ, all within 8 ulps of a jump: {bool(near.all())} [{card}]')
        require(bool(near.all()), f'{row}: samples away from a jump differ from scipy')

    # -- the waves: both axes, both dtypes; no kernel
    t_checks = time.perf_counter()
    for what, (axis, wave, _) in waves.items():
        for prec in ('f64', 'f32'):
            tt, values = axes[axis, prec]
            for dtype, bound in ((dsc.Dtype.F32, 1e-4), (dsc.Dtype.F64, 1e-9)):
                row = f'{what}, {prec} axis, dtype {dtype.name}'
                out = run(row, lambda: wave(tt, dtype))
                require(out.dtype == dtype and out.device == tt.device,
                        f'{row}: {out.dtype} on {out.device}')
                ref = wave_refs[what, prec]
                if (what, prec) in formula_refs:
                    exact = formula_refs[what, prec]
                    if dtype == dsc.Dtype.F32:
                        exact = exact.astype(np.float32).astype(np.float64)
                    check(f"{row} vs the JAX package's float64 formula in NumPy", out, exact, 0,
                          exact=True)
                if what.startswith('square'):
                    square_vs_scipy(row, out, values, ref, 0.3)
                else:
                    check(f'{row} vs scipy.signal float64', out, ref, bound)
    # a host time axis is uploaded to the card: the same wave
    host = run('chirp linear, host f64 axis, dtype F32',
               lambda: M.chirp(t_np, 100.0, t1, 1e4, dtype=dsc.Dtype.F32))
    same = run('chirp linear, f64 axis, dtype F32',
               lambda: waves['chirp linear'][1](axes['t', 'f64'][0], dsc.Dtype.F32))
    require(host.device == same.device and torch.equal(host.torch, same.torch),
            'chirp of a host axis differs from chirp of the same Tensor axis')
    print(f'  chirp linear of the host f64 axis: on {host.device}, equal to the Tensor axis\'s '
          f'[{card}]')
    del out, host, same

    # -- the nonlinear filters; no kernel
    for what, (fn, _, exact, bound) in filters.items():
        out = run(what, fn)
        check(f'{what} vs scipy.signal float64', out, filter_refs[what], bound, exact,
              'max1' if what.startswith('wiener') else 'max')
    del filter_refs

    # -- the chain: chirp + noise -> ellip design -> sosfilt -> medfilt -> welch
    n = FILTER_N
    tp_np = np.arange(n) / 48000.0
    tp = dsc.from_numpy(tp_np)
    noise = dsc.from_numpy((0.1 * gen.standard_normal(n)).astype(np.float32))
    t0 = time.perf_counter()
    sos = M.iirdesign(0.1, 0.15, 1.0, 60.0, ftype='ellip')
    design_ms = 1e3 * (time.perf_counter() - t0)
    print(f'  iirdesign(0.1, 0.15, 1 dB, 60 dB, ellip) on the host: {sos.shape[0]} sections, '
          f'{design_ms:.2f} ms [{card}]')
    segments = (n - 1024) // 512 + 1
    welch_launches = core_launches([('r2c', segments, 1024)])

    def chain(t, s):
        x = M.chirp(t, 50.0, tp_np[-1], 5000.0) + s
        return M.welch(M.medfilt(M.sosfilt(sos, x), 5), nperseg=1024)[1]

    with held_launches(compare, lambda: current[0]):
        x = run('chain: chirp + noise', lambda: M.chirp(tp, 50.0, tp_np[-1], 5000.0) + noise,
                {'stream_map': 1})
        x64 = x.numpy().astype(np.float64)
        y = run('chain: sosfilt', lambda: M.sosfilt(sos, x))
        check('chain: sosfilt vs scipy.signal.sosfilt float64 of the chirp + noise', y,
              sps.sosfilt(sos, x64), 1e-4)
        y64 = y.numpy().astype(np.float64)
        z = run('chain: medfilt 5', lambda: M.medfilt(y, 5))
        check('chain: medfilt 5 vs scipy.signal.medfilt float64 of the sosfilt output', z,
              sps.medfilt(y64, 5), 0, exact=True)
        p = run('chain: welch 1024', lambda: M.welch(z, nperseg=1024)[1], welch_launches)
        check('chain: welch(nperseg 1024) vs scipy.signal.welch float64 of the medfilt output',
              p, sps.welch(z.numpy().astype(np.float64), nperseg=1024)[1], 2e-4)
        eager = run('chain eager (no design)', lambda: chain(tp, noise),
                    {'stream_map': 1, **welch_launches})
        e = rel_err(eager.torch, p.torch)
        require(e <= 1e-6, f'the eager chain vs its checked stages: {e}')
    del x, y, z, x64, y64

    compiled = dsc.compile(chain)
    twice = {k: 2 * v for k, v in {'stream_map': 1, **welch_launches}.items()}
    got = run('chain compiled: trace + capture', lambda: compiled(tp, noise), twice)
    e = rel_err(got.torch, eager.torch)
    print(f'  the compiled chain vs the eager chain: {e:.3e} (rel, bound 1e-6) [{card}]')
    require(e <= 1e-6, f'compiled chain vs eager: {e}')
    require(compiled.n_programs == 1, 'compiled chain: more than one program')
    checked_s = time.perf_counter() - t_checks

    # -- each row's host time, device time by op over 10 calls, busy share,
    #    launches, the checked call's peak memory; the filters' bytes' bound
    t_timed = time.perf_counter()
    # (row, call, the bytes of its array arguments and results: a wave reads
    # its float64 axis and writes float32, a filter reads and writes float32)
    timed = [(f'{w}, f64 axis, dtype F32', lambda w=w: waves[w][1](axes[waves[w][0], 'f64'][0],
                                                                     dsc.Dtype.F32), 12 * WAVE_N)
             for w in waves]
    timed += [(what, fn, 8 * (IMAGE_SIDE ** 2 if '^2' in what else FILTER_N))
              for what, (fn, *_) in filters.items() if 'rank 0' not in what and 'rank 8' not in what]
    timed += [('chain eager (no design)', lambda: chain(tp, noise), 0),
              ('chain compiled (replays)', lambda: compiled(tp, noise), 0)]
    for what, fn, n_bytes in timed:
        line, prof = rows.time_row(what, fn, n_bytes)
        if what == 'chain compiled (replays)':
            host = {ev.key: ev.count for ev in prof.key_averages()}
            line += (f'; cudaGraphLaunch {host.get("cudaGraphLaunch", 0)}, cudaLaunchKernel '
                     f'{host.get("cudaLaunchKernel", 0)} over 10 replays')
            require(host.get('cudaLaunchKernel', 0) == 0,
                    'compiled chain: kernels launched from the host between the graph\'s')
        print(line + f' [{card}]')
    timed_s = time.perf_counter() - t_timed
    require(launches['base_fft'] > 0, 'the chain launched no K12')
    print(f'  phase 11: {time.perf_counter() - t_phase:.1f} s: scipy references {refs_s:.1f} s '
          f'(8 threads), the port\'s checked calls and checks {checked_s:.1f} s (the calls '
          f'{sum(ms for ms, _ in first.values()) / 1e3:.1f} s), timing and profiles '
          f'{timed_s:.1f} s [{card}]')
    print(f'  launches on the signals path: {launches} [{card}]')
    return launches

# phase 12's sizes: fftconvolve's signal, taps, batch and image; the signals
# of the lfilter continuation, the dlti output and the peak finder; the
# continuous output's times and the step and impulse responses' points; and
# the first steps on which scipy's simulators (Python loops) are held
CONV_N = 2**23
CONV_TAPS = 4097
CONV_BATCH = (8, 2**20)
CONV_BATCH_TAPS = 255
CONV_IMAGE = 2048
SYSTEM_N = 2**22
LSIM_N = 10**6
RESPONSE_N = 10**5
SCIPY_STEPS = 2**16


def fft_route_launches(steps) -> dict:
    """The launches of the real and complex FFTs ``steps`` (kind, batch, n)
    on the card by the routing of fourier/config.py: K1 + K2 for an rfft
    ('r2c') and K3 + K4 for an irfft ('c2r') on the packed route, the core's
    rule (core_launches) for the rest; a route into the T layout fails."""
    from dsc_tpu_torch.dtype import Dtype
    from dsc_tpu_torch.fourier import config

    want, rest = dict.fromkeys(KERNELS, 0), []
    for kind, batch, n in steps:
        route = (config.rfft_route(Dtype.F32, batch, n) if kind == 'r2c' else
                 config.fft_route(Dtype.C32, batch, n, False) if kind == 'c2c' else
                 config.irfft_route(Dtype.C32, batch, n))
        require(route != 'stream_t', f'{kind} of {batch} x {n}: the T layout is not modelled here')
        if kind == 'r2c' and route == 'packed':
            want['rfft_phase_a'] += 1
            want['rfft_phase_b'] += 1
        elif kind == 'c2r' and route == 'packed':
            want['irfft_phase_a'] += 1
            want['irfft_phase_b'] += 1
        else:
            rest.append((kind, batch, n))
    for name, count in core_launches(rest).items():
        want[name] += count
    return {name: count for name, count in want.items() if count}


def conv_launches(sig_shape, k_shape) -> dict:
    """The launches of fftconvolve (models/filter_fft.py) of a float32
    signal or batch of rows ``sig_shape`` with taps ``k_shape``: the 1-D
    route (rfft of both at the next power of two, the spectra's product,
    irfft) or, for two 2-D operands, the 2-D one (rfft over rows, fft over
    columns, and back), K5 on the complex64 product where ops/stream_map.py's
    route takes it."""
    from dsc_tpu_torch.fourier.plan import next_pow2
    from dsc_tpu_torch.ops import stream_map as sm

    if len(sig_shape) == 2 and len(k_shape) == 2:
        (m, n), (p, q) = sig_shape, k_shape
        s0, s1 = next_pow2(m + p - 1), next_pow2(n + q - 1)
        half = s1 // 2 + 1
        steps = [('r2c', m, s1), ('c2c', half, s0), ('r2c', p, s1), ('c2c', half, s0),
                 ('c2c', half, s0), ('c2r', s0, s1)]
        spectra = ((s0, half), (s0, half))
    else:
        batch, n, k = math.prod(sig_shape[:-1]), sig_shape[-1], k_shape[-1]
        fft_n = next_pow2(n + k - 1)
        half = fft_n // 2 + 1
        steps = [('r2c', batch, fft_n), ('r2c', 1, fft_n), ('c2r', batch, fft_n)]
        spectra = ((*sig_shape[:-1], half), (half,))
    want = fft_route_launches(steps)
    if sm.eligible_complex(*spectra):
        want['stream_map'] = want.get('stream_map', 0) + 1
    return want


def peak_signal(gen, n: int) -> np.ndarray:
    """``n`` float32 samples: 600 Gaussian pulses (heights 0.5-2, widths
    4-40 samples) at random places on a slow sine of amplitude 0.2, rounded
    to 1/1024, so that the pulses' tops are plateaus of 1-3 samples."""
    x = 0.2 * np.sin(2 * np.pi * 3 * np.arange(n) / n)
    at = np.sort(gen.choice(n - 400, 600, replace=False) + 200)
    for c, amp, width in zip(at, gen.uniform(0.5, 2.0, at.size), gen.uniform(4.0, 40.0, at.size)):
        j = np.arange(c - 160, c + 161)
        x[j] += amp * np.exp(-0.5 * ((j - c) / width) ** 2)
    return (np.round(x * 1024) / 1024).astype(np.float32)


def systems_phase(dsc, card: str, compare) -> dict:
    """Phase 12: the system-object and design-support tier
    (models/filter_extras.py, ltisys.py, placepoles.py, remez.py, peaks.py)
    at full size, every call with the launch counts set to 0 just before it
    and held to the routing just after, each against scipy.signal in float64
    on the same values: fftconvolve 1-D (CONV_N x CONV_TAPS, three modes; a
    CONV_BATCH batch) and 2-D (CONV_IMAGE^2 x 5 x 5) with every kernel launch
    held to its plain version; lfilter of SYSTEM_N samples in two halves, the
    second from lfiltic's state; dlti.output of a SYSTEM_N-step Tensor input,
    lti(tf).output of LSIM_N times, step and impulse of RESPONSE_N points (no
    kernel: the float64 affine scan), scipy's Python-loop simulators on the
    first SCIPY_STEPS steps; dlti([1], [1, -0.5], dt=0.1).bode (F9),
    find_peaks, peak_widths and argrelmax of a SYSTEM_N float32 Tensor,
    remez and place_poles (the host). Then each row's host time, device time
    by op, busy share, peak device memory and the bound of its bytes, and the
    phase's time split. Returns the launches of each kernel."""
    from concurrent.futures import ThreadPoolExecutor

    import scipy.signal as sps

    from dsc_tpu_torch import models as M

    print(f'phase 12: the system-object and design-support tier: fftconvolve 2^'
          f'{CONV_N.bit_length() - 1} x {CONV_TAPS}, {CONV_BATCH[0]} x 2^'
          f'{CONV_BATCH[1].bit_length() - 1} x {CONV_BATCH_TAPS} and {CONV_IMAGE}^2 x 5 x 5, '
          f'lfiltic, lti / dlti, find_peaks, remez, place_poles [{card}]')
    gen = np.random.default_rng(12)
    rows = TierRows(card)
    run, check, first = rows.run, rows.check, rows.first
    t_phase = time.perf_counter()

    # -- the inputs
    sig = gen.standard_normal(CONV_N).astype(np.float32)
    taps = gen.standard_normal(CONV_TAPS).astype(np.float32)
    batch = gen.standard_normal(CONV_BATCH).astype(np.float32)
    btaps = gen.standard_normal(CONV_BATCH_TAPS).astype(np.float32)
    image = gen.standard_normal((CONV_IMAGE, CONV_IMAGE)).astype(np.float32)
    kernel = gen.standard_normal((5, 5)).astype(np.float32)
    b, a = sps.butter(4, 0.25)
    xf = gen.standard_normal(SYSTEM_N).astype(np.float32)
    # the zero-order hold at dt 0.1 of the analog butter(4, 2 pi 0.5): 4 states
    sysd = M.lti(*sps.butter(4, 2 * np.pi * 0.5, analog=True, output='zpk')).to_ss() \
        .to_discrete(0.1)
    u = gen.standard_normal(SYSTEM_N).astype(np.float32)
    # phase 10's analog butter(4, 2 pi 50) as a transfer function
    tf = sps.butter(4, 2 * np.pi * 50, analog=True)
    times = np.arange(LSIM_N) * 1e-4
    U = np.sin(2 * np.pi * 30.0 * times) + 0.5 * gen.standard_normal(LSIM_N)
    xp = peak_signal(gen, SYSTEM_N)
    peak_kw = {'height': 0.4, 'distance': 64, 'prominence': 0.3, 'width': (4, 200),
               'wlen': 257, 'plateau_size': (1, 32)}
    remez_cases = {73: ([0, 0.2, 0.25, 0.5], [1, 0]), 101: ([0, 0.1, 0.15, 0.5], [1, 0])}
    pp = np.random.default_rng(13)
    a4, b4 = pp.standard_normal((4, 4)), pp.standard_normal((4, 1))
    a6, b6 = pp.standard_normal((6, 6)), pp.standard_normal((6, 2))
    p4 = np.array([-1.0, -2.0, -3.0, -4.0])
    p6 = np.array([-1 + 1j, -1 - 1j, -2.0, -2.5, -3.0, -4.0])
    modes = ('full', 'same', 'valid')

    # -- scipy's float64 references in 8 threads
    t_refs = time.perf_counter()
    x64 = xf.astype(np.float64)
    u64 = u.astype(np.float64)
    num, den = sps.ss2tf(sysd.A, sysd.B, sysd.C, sysd.D)
    with ThreadPoolExecutor(8) as pool:
        jobs = {f'conv {mode}': pool.submit(sps.fftconvolve, sig.astype(np.float64),
                                            taps.astype(np.float64), mode)
                for mode in modes}
        jobs['conv batch'] = pool.submit(sps.fftconvolve, batch.astype(np.float64),
                                         btaps.astype(np.float64)[None], 'full', -1)
        jobs.update({f'conv2 {mode}': pool.submit(sps.fftconvolve, image.astype(np.float64),
                                                  kernel.astype(np.float64), mode)
                     for mode in ('full', 'same')})
        jobs['lfilter'] = pool.submit(sps.lfilter, b, a, x64)
        jobs['dlti y'] = pool.submit(sps.lfilter, num[0], den, u64)
        jobs['dlti x'] = pool.submit(sps.dlsim, (sysd.A, sysd.B, sysd.C, sysd.D, 0.1),
                                     u64[:SCIPY_STEPS])
        jobs['lsim'] = pool.submit(sps.lsim, tf, U[:SCIPY_STEPS], times[:SCIPY_STEPS])
        jobs['peaks'] = pool.submit(sps.find_peaks, xp.astype(np.float64), **peak_kw)
        jobs['argrelmax'] = pool.submit(sps.argrelmax, xp.astype(np.float64), order=3)
        jobs['bode'] = pool.submit(lambda: sps.dlti([1.0], [1.0, -0.5], dt=0.1).bode(n=4096))
        jobs.update({f'remez {n}': pool.submit(sps.remez, n, *case)
                     for n, case in remez_cases.items()})
        jobs['place 4'] = pool.submit(sps.place_poles, a4, b4, p4)
        refs = {key: job.result() for key, job in jobs.items()}
    refs_s = time.perf_counter() - t_refs

    def equal(what, ok, detail=''):
        print(f'  {what}: {"equal" if ok else "differ"}{detail} [{card}]')
        require(ok, f'{what}: differ{detail}')

    # -- fftconvolve: K1-K4 and K5 (1-D), K6/K7 (the batch), K12 and K5 (2-D)
    t_checks = time.perf_counter()
    sig_t, taps_t = dsc.from_numpy(sig), dsc.from_numpy(taps)
    batch_t, btaps_t = dsc.from_numpy(batch), dsc.from_numpy(btaps)
    image_t, kernel_t = dsc.from_numpy(image), dsc.from_numpy(kernel)
    conv_rows = {  # row -> (call, reference, launches, float32 values read and written)
        **{f'fftconvolve 2^{CONV_N.bit_length() - 1} x {CONV_TAPS} {mode}': (
            lambda mode=mode: M.fftconvolve(sig_t, taps_t, mode=mode), f'conv {mode}',
            conv_launches(sig.shape, taps.shape), sig.size + taps.size) for mode in modes},
        f'fftconvolve {CONV_BATCH[0]} x 2^{CONV_BATCH[1].bit_length() - 1} x '
        f'{CONV_BATCH_TAPS} full': (lambda: M.fftconvolve(batch_t, btaps_t), 'conv batch',
                                    conv_launches(batch.shape, btaps.shape),
                                    batch.size + btaps.size),
        **{f'fftconvolve {CONV_IMAGE}^2 x 5 x 5 {mode}': (
            lambda mode=mode: M.fftconvolve(image_t, kernel_t, mode=mode), f'conv2 {mode}',
            conv_launches(image.shape, kernel.shape), image.size + kernel.size)
           for mode in ('full', 'same')}}
    with held_launches(compare, lambda: rows.current[0]):
        for what, (fn, ref, want, _) in conv_rows.items():
            out = run(what, fn, want)
            check(f'{what} vs scipy.signal.fftconvolve float64', out, refs[ref], NUMPY_BOUND)
    del out

    # -- lfilter in two halves, the second from lfiltic's state (no kernel)
    half = SYSTEM_N // 2
    xt = dsc.from_numpy(xf)
    whole = run(f'lfilter 2^{SYSTEM_N.bit_length() - 1} in one pass', lambda: M.lfilter(b, a, xt))
    first_half = run('lfilter, the first half', lambda: M.lfilter(b, a, xt[:half]))
    zi = M.lfiltic(b, a, first_half[half - 4:].numpy()[::-1].astype(np.float64),
                   xf[half - 4:half][::-1].astype(np.float64))
    second = xt[half:]
    cont, _ = run('lfilter, the second half from lfiltic', lambda: M.lfilter(b, a, second, zi=zi))
    e = rel_err(cont.torch.to(torch.float64), whole.torch[half:].to(torch.float64))
    print(f'  the second half from lfiltic vs the one-pass filter: {e:.3e} (rel, bound 1e-5) '
          f'[{card}]')
    require(e <= 1e-5, f'lfiltic continuation vs one pass: {e}')
    check('the second half from lfiltic vs scipy.signal.lfilter float64', cont,
          refs['lfilter'][half:], 1e-4)

    # -- the class API (no kernel: the float64 affine scan)
    ut = dsc.from_numpy(u)
    _, y, x = run(f'dlti (4 states, dt 0.1).output 2^{SYSTEM_N.bit_length() - 1} Tensor',
                  lambda: sysd.output(ut))
    require(isinstance(y, dsc.Tensor) and y.device == ut.device, 'dlti.output left the device')
    check('dlti.output y vs scipy.signal.lfilter of its ss2tf, float64', y, refs['dlti y'][:, None],
          1e-5)
    check(f'dlti.output x, the first {SCIPY_STEPS} steps, vs scipy.signal.dlsim float64',
          x[:SCIPY_STEPS], refs['dlti x'][2], 1e-5)
    sys_tf = M.lti(*tf)
    _, ly, _ = run(f'lti(tf).output of {LSIM_N} times', lambda: sys_tf.output(U, times))
    check(f'lti(tf).output, the first {SCIPY_STEPS} steps, vs scipy.signal.lsim float64',
          ly[:SCIPY_STEPS], refs['lsim'][1], 1e-10)
    for kind, ref_fn in (('step', sps.step), ('impulse', sps.impulse)):
        t_r, y_r = run(f'lti(tf).{kind} N {RESPONSE_N}',
                       lambda kind=kind: getattr(sys_tf, kind)(N=RESPONSE_N))
        _, want = ref_fn(tf, T=t_r[:SCIPY_STEPS])
        check(f'lti(tf).{kind}, the first {SCIPY_STEPS} points, vs scipy.signal.{kind} '
              f'float64', y_r[:SCIPY_STEPS], want, 1e-10)
    w, mag, phase = run('dlti([1], [1, -0.5], dt=0.1).bode(n=4096)',
                        lambda: M.dlti([1.0], [1.0, -0.5], dt=0.1).bode(n=4096))
    ws, mags, phases = refs['bode']
    e = float(np.abs(phase - phases).max())
    print(f'  dlti bode vs scipy.signal.dlti.bode (F9): phase {e:.3e} deg (bound 1e-9), '
          f'magnitude {np.abs(mag - mags).max():.3e} dB, w {np.abs(w - ws).max():.3e} [{card}]')
    require(e <= 1e-9 and np.allclose(w, ws, rtol=1e-14) and np.abs(mag - mags).max() <= 1e-9,
            f'dlti bode vs scipy: phase {e}')

    # -- peaks of a Tensor (one download each)
    xpt = dsc.from_numpy(xp)
    peaks, props = run(f'find_peaks 2^{SYSTEM_N.bit_length() - 1} Tensor',
                       lambda: M.find_peaks(xpt, **peak_kw))
    want_peaks, want_props = refs['peaks']
    prop_err = max(float(np.abs(props[k] - want_props[k]).max(initial=0.0))
                   / max(1.0, float(np.abs(want_props[k]).max(initial=0.0))) for k in want_props)
    equal(f'find_peaks: {peaks.size} peaks, indices vs scipy.signal.find_peaks',
          np.array_equal(peaks, want_peaks) and sorted(props) == sorted(want_props),
          f'; properties {prop_err:.3e} (rel, bound 1e-12)')
    require(peaks.size > 100 and prop_err <= 1e-12, f'find_peaks properties: {prop_err}')
    widths = run('peak_widths rel_height 1', lambda: M.peak_widths(xpt, peaks, 1.0, wlen=257))
    e = max(float(np.abs(g - r).max()) for g, r in
            zip(widths, sps.peak_widths(xp.astype(np.float64), peaks, 1.0, wlen=257)))
    print(f'  peak_widths vs scipy.signal.peak_widths float64: {e:.3e} (bound 1e-12) [{card}]')
    require(e <= 1e-12, f'peak_widths: {e}')
    got = run('argrelmax order 3', lambda: M.argrelmax(xpt, 3))
    equal(f'argrelmax order 3: {got[0].size} maxima vs scipy.signal.argrelmax',
          np.array_equal(got[0], refs['argrelmax'][0]))

    # -- the host designs
    for n, (bands, desired) in remez_cases.items():
        got = run(f'remez {n} taps', lambda n=n, bands=bands, desired=desired:
                  M.remez(n, bands, desired))
        require(got.device == xpt.device, f'remez {n}: taps on {got.device}')
        check(f'remez {n} taps vs scipy.signal.remez', got, refs[f'remez {n}'], 1e-4, scale='max1')
    got = run('place_poles 4 states, 1 input', lambda: M.place_poles(a4, b4, p4))
    want = refs['place 4'].gain_matrix
    e = float(np.abs(got.gain_matrix - want).max()) / max(1.0, float(np.abs(want).max()))
    print(f'  place_poles 4 x 1 gain vs scipy.signal.place_poles: {e:.3e} (rel, bound 1e-8) '
          f'[{card}]')
    require(e <= 1e-8, f'place_poles gain: {e}')
    got = run('place_poles 6 states, 2 inputs', lambda: M.place_poles(a6, b6, p6))
    e = float(np.abs(got.computed_poles - np.sort_complex(p6)).max())
    print(f'  place_poles 6 x 2 computed poles vs the request: {e:.3e} (bound 1e-8) [{card}]')
    require(e <= 1e-8, f'place_poles poles: {e}')
    checked_s = time.perf_counter() - t_checks

    # -- each row's host time, device time by op over 10 calls, busy share,
    #    the checked call's peak memory, the bound of its bytes: float32
    #    operands and results, the dlti's float32 input, y and x (4 states),
    #    lti's float64 U uploaded and y and x (4 states) downloaded, the
    #    peak finder's download of the float32 signal
    t_timed = time.perf_counter()
    timed = [(what, fn, 4 * (n_in + refs[ref].size))
             for what, (fn, ref, _, n_in) in conv_rows.items()]
    timed += [('lfilter, the second half from lfiltic',
               lambda: M.lfilter(b, a, second, zi=zi), 8 * (SYSTEM_N - half)),
              (f'dlti (4 states, dt 0.1).output 2^{SYSTEM_N.bit_length() - 1} Tensor',
               lambda: sysd.output(ut), 4 * SYSTEM_N * (1 + 1 + 4)),
              (f'lti(tf).output of {LSIM_N} times', lambda: sys_tf.output(U, times),
               8 * LSIM_N * (1 + 1 + 4)),
              (f'lti(tf).step N {RESPONSE_N}', lambda: sys_tf.step(N=RESPONSE_N), 0),
              (f'lti(tf).impulse N {RESPONSE_N}', lambda: sys_tf.impulse(N=RESPONSE_N), 0)]
    for what, fn, n_bytes in timed:
        print(rows.time_row(what, fn, n_bytes)[0] + f' [{card}]')
    # the peak finder's rows are host loops of 0.1-0.5 s a call: median of 5,
    # device time over 3 calls (the download)
    for what, fn in ((f'find_peaks 2^{SYSTEM_N.bit_length() - 1} Tensor',
                      lambda: M.find_peaks(xpt, **peak_kw)),
                     ('peak_widths rel_height 1', lambda: M.peak_widths(xpt, peaks, 1.0, wlen=257)),
                     ('argrelmax order 3', lambda: M.argrelmax(xpt, 3))):
        wall = host_ms(fn, runs=5)
        prof_rows, _ = device_profile(fn, what, steps=3, tries=1)
        busy = print_profile(prof_rows, what, wall, card, 3)
        device = (f'device {busy:.4f} ms, busy share {busy / wall:.4f}' if busy else
                  'device time not measured (torch.profiler recorded no device event)')
        print(f'  {what}: {wall:.4f} ms a call (median of 5), {device}; the checked call '
              f'{first[what][0]:.1f} ms; bound of its bytes '
              f'{4 * SYSTEM_N / PEAK_BYTES_S * 1e3:.4f} ms [{card}]')
    for what, fn in (('dlti([1], [1, -0.5], dt=0.1).bode(n=4096)',
                      lambda: M.dlti([1.0], [1.0, -0.5], dt=0.1).bode(n=4096)),
                     ('remez 101 taps', lambda: M.remez(101, *remez_cases[101])),
                     ('place_poles 6 states, 2 inputs', lambda: M.place_poles(a6, b6, p6))):
        print(f'  {what}: {host_ms(fn):.4f} ms a call on the host (median of {RUNS}) [{card}]')
    timed_s = time.perf_counter() - t_timed
    print(f'  phase 12: {time.perf_counter() - t_phase:.1f} s: scipy references {refs_s:.1f} s '
          f'(8 threads), the port\'s checked calls and checks {checked_s:.1f} s (the calls '
          f'{sum(ms for ms, _ in first.values()) / 1e3:.1f} s), timing and profiles '
          f'{timed_s:.1f} s [{card}]')
    print(f'  launches on the systems path: {rows.launches} [{card}]')
    return rows.launches


# phase 13's sizes: the local kernels' (n_total, d) cases; the sharded
# streaming fft and rfft pair; the DP rows (on (d, 1)); distributed_fft's
# rows (on (1, d))
LOCAL_CASES = ((2**24, 4), (2**24, 8), (2**26, 4))
SHARD_N = 2**24
SHARD_ROWS = (16, 2**20)
SHARD_TP = (4, 2**22)
LOCAL_KERNELS = ('stream_phase_a_local', 'stream_phase_b_local')


def plain_versions():
    """The plain versions a call of the sharded tier can reach through a
    wrapper: (module, name)."""
    from dsc_tpu_torch.fourier import base_fft, reconstruct, stream

    return ((stream, 'phase_a_local_plain'), (stream, 'phase_b_local_plain'),
            (stream, 'phase_a_plain'), (stream, 'phase_b_plain'),
            (base_fft, 'fft_base_plain'), (reconstruct, 'reconstruct_plain'))


@contextlib.contextmanager
def no_plain_on_cuda():
    """Within the block, a wrapper that runs its plain version on a CUDA
    tensor raises: a CUDA shard takes the kernel or fails."""
    saved = []
    for module, name in plain_versions():
        fn = getattr(module, name)

        def spy(*args, name=name, fn=fn, **kw):
            if any(isinstance(a, torch.Tensor) and a.is_cuda for a in args):
                raise RuntimeError(f'{name} ran on a CUDA tensor')
            return fn(*args, **kw)

        saved.append((module, name, fn))
        setattr(module, name, spy)
    try:
        yield
    finally:
        for module, name, fn in saved:
            setattr(module, name, fn)


def copy_share(rows) -> float:
    """Device ms a call of the copy kernels and memcpys among
    ``device_profile``'s rows."""
    return sum(ms for ms, _, key in rows if 'copy' in key.lower() or 'memcpy' in key.lower())


def sharded_phase(dsc, card: str, compare, timed) -> dict:
    """Phase 13, the sharded tier (parallel/): the local K6/K7 (the
    sharded four-step's per-shard sites) against their plain versions at
    their sharded shapes; then on a virtual mesh of 4 entries of cuda:0 and
    on the mesh of every card, distributed_fft_stream, the rfft -> irfft
    pair, sharded_batched_fft / _rfft and distributed_fft at full size
    against np.fft in float64, each call's launches held to the routing and
    no plain version run on a CUDA shard; then the calls' host and device
    time beside the single-card call on the same data, the exchange copies'
    share, the local kernels against their bytes' bound; and the C++ harness
    over the port's C front door on the card. Returns the launches of each
    kernel."""
    import threading

    from dsc_tpu_torch.cpp import build as cbuild
    from dsc_tpu_torch.fourier import core, plan, stream
    from dsc_tpu_torch.kernels import build
    from dsc_tpu_torch.parallel import (distributed_fft, distributed_fft_stream,
                                        distributed_irfft_stream, distributed_rfft_stream,
                                        make_mesh, sharded_batched_fft, sharded_batched_rfft,
                                        sharded_fft)

    t_phase = time.perf_counter()
    n_cards = torch.cuda.device_count()
    print(f'phase 13: the sharded tier on a virtual mesh of 4 x cuda:0 and on the {n_cards} '
          f'card(s); the C front door [{card}]')
    # the C harness compiles (g++, host only) while the card works
    harness = {}
    gxx = threading.Thread(target=lambda: harness.update(
        path=cbuild.build(cbuild.OUT_DIR)), daemon=True)
    t_gxx = time.perf_counter()
    gxx.start()
    dev0 = torch.device('cuda', 0)
    gen = torch.Generator(device='cuda').manual_seed(13)

    def cn(shape):
        return torch.randn(shape, dtype=torch.complex64, device=dev0, generator=gen)

    # -- 13a. the local kernels at their sharded shapes ----------------------
    for n, d in LOCAL_CASES:
        n1, n2 = stream.factors(n)
        t = plan.get_plan(n, 'stream', torch.complex64, dev0)[1]
        x = cn((n1, n2))
        for p in range(d):
            col0 = p * n2 // d
            blk = x[:, col0:col0 + n2 // d].contiguous()
            for inv in (False, True):
                compare('stream_phase_a_local', stream.phase_a_local(blk, t, col0, inv),
                        stream.phase_a_local_plain(blk, t, col0, inv),
                        f'2^{n.bit_length() - 1} d={d} col0={col0} '
                        f'{"inverse" if inv else "forward"}')
        z = cn((n2, n1 // d))
        for inv, real_output in ((False, False), (True, False), (True, True)):
            compare('stream_phase_b_local', stream.phase_b_local(z, t, n1 // d, inv, real_output),
                    stream.phase_b_local_plain(z, t, n1 // d, inv, real_output),
                    f'2^{n.bit_length() - 1} d={d} {"inverse" if inv else "forward"}'
                    f'{" real output" if real_output else ""}')
        del x, z, blk

    # -- 13b. the public calls at full size, launches held to the routing ------
    rng = np.random.default_rng(13)
    v_np = (rng.standard_normal(SHARD_N) + 1j * rng.standard_normal(SHARD_N)).astype(np.complex64)
    r_np = rng.standard_normal(SHARD_N).astype(np.float32)
    b_np = (rng.standard_normal(SHARD_ROWS)
            + 1j * rng.standard_normal(SHARD_ROWS)).astype(np.complex64)
    rows_np = rng.standard_normal(SHARD_ROWS).astype(np.float32)
    tp_np = (rng.standard_normal(SHARD_TP)
             + 1j * rng.standard_normal(SHARD_TP)).astype(np.complex64)
    t_ref = time.perf_counter()
    refs = {'fft': np.fft.fft(v_np.astype(np.complex128)),
            'rfft': np.fft.rfft(r_np.astype(np.float64)),
            'rows': np.fft.fft(b_np.astype(np.complex128), axis=-1),
            'rows rfft': np.fft.rfft(rows_np.astype(np.float64), axis=-1),
            'tp': np.fft.fft(tp_np.astype(np.complex128), axis=-1)}
    refs_s = time.perf_counter() - t_ref
    v, r, b, rows, tp = (torch.from_numpy(a).to(dev0) for a in (v_np, r_np, b_np, rows_np, tp_np))
    n1, n2 = stream.factors(SHARD_N)
    single = stream.fourstep_stream(v.reshape(1, -1), n1, n2, False).reshape(-1)

    def scaled(want, k):
        return {name: count * k for name, count in want.items()}

    launches = dict.fromkeys(KERNELS, 0)

    def routed(what, fn, want):
        build.reset_launches()
        with no_plain_on_cuda():
            out = fn()
        torch.cuda.synchronize()
        got = {name: count for name, count in build.launches.items() if count}
        require(got == want, f'{what}: launches {got}, routing says {want}')
        for name, count in got.items():
            launches[name] += count
        return out

    def against(what, got, ref, relative=True):
        g = np.asarray(got)
        require(g.shape == ref.shape and np.isfinite(g).all(),
                f'{what}: shape {g.shape} (want {ref.shape}) or not finite')
        e = float(np.abs(g - ref).max()) / (float(np.abs(ref).max()) if relative else 1.0)
        print(f'  {what}: {e:.3e} ({"rel" if relative else "abs"}, bound {NUMPY_BOUND:g}) '
              f'[{card}]')
        require(e <= NUMPY_BOUND, f'{what}: {e} > {NUMPY_BOUND}')

    meshes = [('virtual 4 x cuda:0', [dev0] * 4),
              (f'{n_cards} card(s)', [torch.device('cuda', i) for i in range(n_cards)])]
    calls = {}
    for label, devs in meshes:
        d = len(devs)
        tp_mesh, dp_mesh = make_mesh((1, d), devices=devs), make_mesh((d, 1), devices=devs)
        local = {'stream_phase_a_local': d, 'stream_phase_b_local': d}
        spec = routed(f'distributed_fft_stream 2^24 on {label}',
                      lambda: distributed_fft_stream(v, tp_mesh), local)
        against(f'distributed_fft_stream 2^24 on {label} vs np.fft', spec, refs['fft'])
        e = rel_err(spec.full(), single)
        print(f'  distributed_fft_stream 2^24 on {label} vs the single-card K6+K7: {e:.3e} '
              f'(bound {REL_BOUND:g})')
        require(e <= REL_BOUND, f'sharded vs single-card fft: {e}')
        back = routed(f'inverse distributed_fft_stream 2^24 on {label}',
                      lambda: distributed_fft_stream(spec, tp_mesh, inverse=True), local)
        against(f'inverse(distributed_fft_stream) 2^24 on {label} vs x', back, v_np)
        half = routed(f'distributed_rfft_stream 2^24 on {label}',
                      lambda: distributed_rfft_stream(r, tp_mesh), local)
        against(f'distributed_rfft_stream 2^24 on {label} vs np.fft', half, refs['rfft'])
        back = routed(f'distributed_irfft_stream 2^24 on {label}',
                      lambda: distributed_irfft_stream(half, tp_mesh), local)
        against(f'distributed_irfft_stream(rfft) 2^24 on {label} vs x', back, r_np, False)
        rb, rn = SHARD_ROWS
        got = routed(f'sharded_batched_fft {rb} x 2^20 on {label}',
                     lambda: sharded_batched_fft(b, dp_mesh),
                     scaled(core_launches([('c2c', rb // d, rn)]), d))
        against(f'sharded_batched_fft {rb} x 2^20 on ({d}, 1) {label} vs np.fft', got,
                refs['rows'])
        got = routed(f'sharded_batched_rfft {rb} x 2^20 on {label}',
                     lambda: sharded_batched_rfft(rows, dp_mesh),
                     scaled(core_launches([('r2c', rb // d, rn)]), d))
        against(f'sharded_batched_rfft {rb} x 2^20 on ({d}, 1) {label} vs np.fft', got,
                refs['rows rfft'])
        tb, tn = SHARD_TP
        t1 = 1 << ((tn.bit_length() - 1) // 2)
        t2 = tn // t1
        want = core_launches([('c2c', tb * t2 // d, t1)])
        for name, count in core_launches([('c2c', tb * t1 // d, t2)]).items():
            want[name] = want.get(name, 0) + count
        got = routed(f'distributed_fft {tb} x 2^22 on {label}',
                     lambda: distributed_fft(tp, tp_mesh), scaled(want, d))
        against(f'distributed_fft {tb} x 2^22 on (1, {d}) {label} vs np.fft', got, refs['tp'])
        calls[label] = (tp_mesh, dp_mesh)
        del spec, back, half, got
    print(f'  launches on the sharded path: {launches}')
    for name in LOCAL_KERNELS:
        require(launches[name] > 0, f'kernel {name} was not launched on the sharded path')
    checked_s = time.perf_counter() - t_phase

    # -- 13c. time: each call beside the single-card call on the same data ----
    t_timed = time.perf_counter()
    tables = plan.get_plan(SHARD_N, 'stream', torch.complex64, dev0)[1]
    row_plan = plan.get_plan(SHARD_ROWS[1], 'complex', torch.complex64, dev0)
    rrow_plan = plan.get_plan(SHARD_ROWS[1], 'real', torch.complex64, dev0)
    tp_plan = plan.get_plan(SHARD_TP[1], 'complex', torch.complex64, dev0)
    r_t = dsc.from_numpy(r_np)
    half_t = dsc.rfft(r_t)
    rows_timed = [
        ('distributed_fft_stream 2^24, tensor in, gathered out',
         lambda m: distributed_fft_stream(v, m[0]).full(),
         lambda: stream.fourstep_stream(v.reshape(1, -1), n1, n2, False),
         'K6+K7 natural order (fourier/stream.py fourstep_stream)', 3 * nbytes(v)),
        ('distributed_rfft_stream 2^24, tensor in, gathered out',
         lambda m: distributed_rfft_stream(r, m[0]).full(), lambda: dsc.rfft(r_t),
         'dsc.rfft (K1+K2)', 3 * nbytes(r) + 8 * (SHARD_N // 2 + 1)),
        ('distributed_irfft_stream 2^24 of a placed half spectrum, gathered out',
         None, lambda: dsc.irfft(half_t), 'dsc.irfft (K3+K4)', 3 * nbytes(r)),
        ('sharded_batched_fft 16 x 2^20, gathered out',
         lambda m: sharded_batched_fft(b, m[1]).full(),
         lambda: core.fft_batched(b, *row_plan, False), 'core.fft_batched', 2 * nbytes(b)),
        ('sharded_batched_rfft 16 x 2^20, gathered out',
         lambda m: sharded_batched_rfft(rows, m[1]).full(),
         lambda: core.rfft_batched(rows, *rrow_plan, SHARD_ROWS[1]), 'core.rfft_batched',
         2 * nbytes(rows)),
        ('distributed_fft 4 x 2^22, gathered out', lambda m: distributed_fft(tp, m[0]).full(),
         lambda: core.fft_batched(tp, *tp_plan, False), 'core.fft_batched', 2 * nbytes(tp)),
    ]
    h1, h2 = stream.factors(SHARD_N // 2)
    for label, devs in meshes:
        m = calls[label]
        # a mesh of one card: the first row alone shows the tier's cost at d = 1
        timed_rows = rows_timed if len(devs) > 1 else rows_timed[:1]
        # the half spectrum laid out as the irfft takes it: (n1, n2) blocks
        # of its first n/2 bins and the last bin
        placed_half = sharded_fft._place(distributed_rfft_stream(r, m[0]).full(), m[0], 'model',
                                         1, (h1, h2), (SHARD_N // 2 + 1,), torch.complex64,
                                         has_tail=True)
        for what, fn, single_fn, single_what, n_bytes in timed_rows:
            if fn is None:
                call = lambda m=m, h=placed_half: distributed_irfft_stream(h, m[0]).full()  # noqa: E731
            else:
                call = lambda fn=fn, m=m: fn(m)  # noqa: E731
            wall, wall1 = host_ms(call, 10), host_ms(single_fn, 10)
            busy, prof_rows, _, how = device_busy(call, f'{what} on {label}', wall, card, 5)
            busy1, _, _, how1 = device_busy(single_fn, f'single card: {single_what}', wall1,
                                            card, 5)
            require(busy > 0 and busy1 > 0, f'{what} on {label}: no device time')
            copies = copy_share(prof_rows)
            print(f'  {what} on {label}: host {wall:.4f} ms, device {busy:.4f} ms ({how}), '
                  f'copies and memcpys {copies:.4f} ms ({copies / busy:.3f} of the device '
                  f'time); single card {single_what}: host {wall1:.4f} ms, device '
                  f'{busy1:.4f} ms ({how1}); sharded / single host time {wall / wall1:.2f}x; '
                  f'bound of the copies scatter, exchange and gather '
                  f'{n_bytes * 2 / PEAK_BYTES_S * 1e3:.4f} ms [{card}]')
        del placed_half
    del half_t, r_t
    # the local kernels against their bytes' bound, one shard's block
    for n, d in ((2**24, 4), (2**26, 4)):
        ln1, ln2 = stream.factors(n)
        t = tables if n == SHARD_N else plan.get_plan(n, 'stream', torch.complex64, dev0)[1]
        tb_ = nbytes(t.w_n1, t.w_n2, t.twiddle.lo, t.twiddle.hi)
        blk, col0 = cn((ln1, ln2 // d)), ln2 // d
        z = stream.phase_a_local(blk, t, col0, False)
        zx = cn((ln2, ln1 // d))
        what = f'2^{n.bit_length() - 1} d={d}: one shard\'s block'
        # no single PyTorch call computes K6 local's DFT, twiddle and
        # transpose; torch.fft.fft over the columns computes K7 local's function
        timed('stream_phase_a_local', f'{what} ({ln1}, {ln2 // d}) at col0={col0}',
              lambda: stream.phase_a_local(blk, t, col0, False),
              lambda: stream.phase_a_local_plain(blk, t, col0, False), None,
              nbytes(blk, z) + tb_, fft_ops(blk.numel(), ln1) + 6 * blk.numel())
        timed('stream_phase_b_local', f'{what} ({ln2}, {ln1 // d})',
              lambda: stream.phase_b_local(zx, t, ln1 // d, False),
              lambda: stream.phase_b_local_plain(zx, t, ln1 // d, False),
              lambda: torch.fft.fft(zx, dim=0), 2 * nbytes(zx) + tb_, fft_ops(zx.numel(), ln2))
        del blk, z, zx
    timed_s = time.perf_counter() - t_timed

    # -- 13d. the C++ harness over the port's C front door, on the card ------
    gxx.join()
    gxx_s = time.perf_counter() - t_gxx
    require('path' in harness, 'the C front door did not build (g++)')
    t_run = time.perf_counter()
    rc, out = cbuild.run(harness['path'], 'cuda', timeout=300)
    run_s = time.perf_counter() - t_run
    print('  C++ harness (cpp/tests/test_filterfft.cpp over dsc_tpu_torch.capi, DSC_DEVICE='
          f'cuda): exit {rc}, {run_s:.1f} s (g++ {gxx_s:.1f} s, beside the card work): '
          + ' | '.join(line for line in out.splitlines() if line.strip())[-400:])
    require(rc == 0 and 'ALL OK' in out, f'C++ harness on the card: exit {rc}: {out[-2000:]}')
    print(f'  phase 13: {time.perf_counter() - t_phase:.1f} s: checks {checked_s:.1f} s '
          f'(np.fft references {refs_s:.1f} s), timing and profiles {timed_s:.1f} s, the C '
          f'harness {run_s:.1f} s [{card}]')
    return launches


def _tensors_in(entry):
    """The torch tensors of a cache entry of models/iir.py (nested tuples)."""
    if isinstance(entry, torch.Tensor):
        return [entry]
    if isinstance(entry, (tuple, list)):
        return [t for e in entry for t in _tensors_in(e)]
    return []


def fft_ops(n: int, points: int) -> float:
    """Flops of complex FFTs of ``points`` points over ``n`` values in all
    (5 N log2 N each)."""
    return 5.0 * n * math.log2(points)


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    parser.add_argument('--profile', action='store_true',
                        help='measure where the filterFFT step time goes '
                             'in place of the checks')
    parser.add_argument('--wrappers', action='store_true',
                        help='time the column-pass wrappers at 2^19 and 2^24 '
                             'in place of the checks')
    parser.add_argument('--fusion', action='store_true',
                        help='run phase 6 (the fusion tier and the models) alone after the build')
    parser.add_argument('--models', action='store_true',
                        help='run the model-shape kernel checks of phase 3 and phase 7 (the '
                             'model tier) alone after the build')
    parser.add_argument('--transforms', action='store_true',
                        help='run phase 8 (the transforms tier) alone after the build')
    parser.add_argument('--recurrence', action='store_true',
                        help='run phase 9 (the IIR recurrence) alone after the build')
    parser.add_argument('--scans', action='store_true',
                        help='run phase 10 (the affine-scan tier) alone after the build')
    parser.add_argument('--signals', action='store_true',
                        help='run phase 11 (the signal-generation and design tier) alone after '
                             'the build')
    parser.add_argument('--systems', action='store_true',
                        help='run phase 12 (the system-object and design-support tier) alone '
                             'after the build')
    parser.add_argument('--sharded', action='store_true',
                        help='run phase 13 (the sharded tier and the C front door) alone after '
                             'the build')
    parser.add_argument('--map-candidates', nargs='+', metavar='TREE',
                        help='time K5 of each tree (a checkout of the port) in turns, '
                             'in place of the checks')
    parser.add_argument('--map-times', metavar='TREE', help=argparse.SUPPRESS)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print('chip_smoke: no CUDA device', file=sys.stderr)
        return 1
    if args.map_times:
        return map_times(args.map_times)
    if args.map_candidates:
        return map_candidates(args.map_candidates)
    sys.path.insert(0, REPO)
    import dsc_tpu_torch as dsc
    from dsc_tpu_torch.fourier import (base_fft, packed_fused as pf, plan, reconstruct, stream,
                                       stream_t)
    from dsc_tpu_torch.fourier.stream import factors
    from dsc_tpu_torch.kernels import build
    from dsc_tpu_torch.ops import kernels as ops_kernels
    from dsc_tpu_torch.ops import stream_map as sm

    # -- 1. the card -------------------------------------------------------
    card = card_line()
    print(f'card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}, '
          f'{torch.cuda.get_device_name(0)} x {torch.cuda.device_count()}')

    # -- 2. build + init + copy ceiling ------------------------------------
    t_start = t0 = time.time()
    log = build.build(extra_flags=('-Xptxas', '-v'))
    build.load()
    print(f'build: {time.time() - t0:.1f} s ({build.LIB_PATH})')
    regs = [int(w) for line in log.splitlines() if 'registers' in line
            for w, nxt in zip(line.split(), line.split()[1:]) if nxt == 'registers,']
    spills = [line.strip() for line in log.splitlines()
              if 'spill' in line and ' 0 bytes spill stores, 0 bytes spill loads' not in line]
    print(f'  ptxas: {len(regs)} kernels, {min(regs)}-{max(regs)} registers a thread, '
          f'{len(spills)} with spills {spills}')
    dsc.init(2**34, device='cuda')
    ceiling = copy_ceiling(card)
    if args.profile:
        row_candidates(card)
        column_candidates(card)
        profile_step(dsc, card)
        return 0
    if args.wrappers:
        wrapper_times(dsc, card)
        return 0
    dev = torch.device('cuda')
    gen = np.random.default_rng(0)
    errs = dict.fromkeys(KERNELS, 0.0)

    def compare(name, got, ref, what, bound=REL_BOUND):
        e = rel_err(got, ref)
        errs[name] = max(errs[name], float((got - ref).abs().max()))
        print(f'  {name:14s} {what}: rel err {e:.3e}')
        require(e <= bound, f'{name} {what}: {e} > {bound}')

    def normal(shape, dtype=np.float32):
        return torch.from_numpy(gen.standard_normal(shape).astype(dtype)).to(dev)

    def cnormal(n):
        z = gen.standard_normal(n) + 1j * gen.standard_normal(n)
        return torch.from_numpy(z.astype(np.complex64)).to(dev)

    def taps_of(k):
        return torch.from_numpy(np.blackman(k).astype(np.float32)).to(dev)

    map_gen = torch.Generator(device='cuda').manual_seed(1)

    def map_operands(body, n):
        # K5's operands drawn on the card: 2^26 values take ~1 s each in numpy
        xs = k5_operands(map_gen, torch.float32, body, ['full'] * sm.REAL_BODIES[body], n)
        if body == 'clip':
            xs[1:] = [-0.5, 0.75]
        return xs

    cases = {name: [] for name in KERNELS}

    def timed(name, what, kernel_fn, plain_fn, library_fn, n_bytes, n_ops):
        """Time the kernel, its plain version and the library call, each
        as device time per call over 50 calls back to back (host dispatch
        hidden behind the previous call), and the kernel also one launch at
        a time (host dispatch included); the bounds from this run's bytes
        and operations."""
        ms, single_ms = back_to_back_ms(kernel_fn, 50), cuda_ms(kernel_fn)
        plain_ms = back_to_back_ms(plain_fn, 50)
        library_ms = None if library_fn is None else back_to_back_ms(library_fn, 50)
        t_bytes, t_ops = n_bytes / PEAK_BYTES_S * 1e3, n_ops / PEAK_F32_S * 1e3
        row = {'what': what, 'ms': ms, 'single_ms': single_ms, 'plain_ms': plain_ms,
               'bound_ms': max(t_bytes, t_ops),
               'bound_by': 'bytes' if t_bytes >= t_ops else 'operations',
               'copy_bound_ms': n_bytes / ceiling, 'library_ms': library_ms}
        cases[name].append(row)
        library = 'none' if library_ms is None else f'{library_ms:.4f} ms'
        print(f'  {name:14s} {what}: kernel {ms:.4f} ms (one launch {single_ms:.4f}), '
              f'plain {plain_ms:.4f} ms, library {library}, bound '
              f'{row["bound_ms"]:.4f} ms ({row["bound_by"]}), copy-ceiling bound '
              f'{row["copy_bound_ms"]:.4f} ms [{card}]')
        return row

    if args.fusion:
        fusion_phase(dsc, card, compare, timed)
        return 0
    if args.models:
        model_shape_checks(compare, normal, cnormal)
        models_phase(dsc, card, compare)
        return 0
    if args.transforms:
        transforms_phase(dsc, card, compare)
        return 0
    if args.recurrence:
        recurrence_phase(dsc, card, compare)
        return 0
    if args.scans:
        scans_phase(dsc, card)
        return 0
    if args.signals:
        signals_phase(dsc, card, compare)
        return 0
    if args.systems:
        systems_phase(dsc, card, compare)
        return 0
    if args.sharded:
        sharded_phase(dsc, card, compare, timed)
        return 0

    # -- 3. kernels vs plain versions --------------------------------------
    print('phase 3: kernels vs plain versions')
    for n, batches in ((256, (1, 128, 1000, 65536)), (512, (1, 128, 1000)),
                       (1024, (1, 128, 1000)), (2048, (1, 128, 1000)), (4096, (1, 128, 1000))):
        w = plan.get_plan(n, 'complex', torch.complex64)[1]
        for batch in batches:
            x = cnormal((batch, n))
            compare('base_fft', base_fft.fft_base(x, w),
                    base_fft.fft_base_plain(x, w), f'n={n} batch={batch}')
    # the packed splits of 2^20 (the smallest), the two filterFFT sizes and
    # 2^26 (the largest): K1 and K4 take C = 1, 1, 4 and 2 columns a block
    for n in (2**20, STEP_N, BIG_N, 2**26):
        t = plan.get_plan(n, 'packed', torch.complex64)[1]
        x_np = gen.standard_normal(n).astype(np.float32)
        x = torch.from_numpy(x_np).to(dev)
        at = pf.rfft_phase_a(x, t)
        compare('rfft_phase_a', at, pf.rfft_phase_a_plain(x, t), f'n=2^{n.bit_length() - 1}')
        spec = pf.rfft_phase_b(at, t)
        compare('rfft_phase_b', spec, pf.rfft_phase_b_plain(at, t),
                f'n=2^{n.bit_length() - 1}')
        if n in (STEP_N, BIG_N):
            ref = np.fft.rfft(x_np.astype(np.float64))
            e = float(np.abs(spec.cpu().numpy() - ref).max() / np.abs(ref).max())
            print(f'  rfft K1+K2 vs np.fft float64 n=2^{n.bit_length() - 1}: {e:.3e}')
            require(e <= NUMPY_BOUND, f'rfft vs np.fft: {e}')
        y = pf.irfft_phase_a(spec, t)
        compare('irfft_phase_a', y, pf.irfft_phase_a_plain(spec, t),
                f'n=2^{n.bit_length() - 1}')
        back = pf.irfft_phase_b(y, t)
        compare('irfft_phase_b', back, pf.irfft_phase_b_plain(y, t),
                f'n=2^{n.bit_length() - 1}')
        e = float((back - x).abs().max())
        print(f'  irfft(rfft(x)) - x, max abs: {e:.3e}')
        require(e <= 2e-4, f'round trip {e}')
        # a spectrum whose X[0] and X[n/2] are not real: K3 reads their
        # real parts, as np.fft.irfft does
        wild = cnormal(n // 2 + 1)
        compare('irfft_phase_a', pf.irfft_phase_a(wild, t), pf.irfft_phase_a_plain(wild, t),
                f'n=2^{n.bit_length() - 1} non-Hermitian spectrum')
        if n == BIG_N:
            wild_np = wild.cpu().numpy()
        del x, at, spec, y, back, wild
    # K1 on the filterFFT's operands as the public path hands them over,
    # unpadded (the samples past their end count as zeros), against the
    # plain version on the zero-padded signal; 2^23 - 3 samples end in half
    # a complex pair
    for n, x, what in ((STEP_N, normal(2**20), 'the quick start\'s 2^20 samples'),
                       (STEP_N, taps_of(255), '255 taps'),
                       (BIG_N, normal(BIG_N // 2), '2^23 samples'),
                       (BIG_N, taps_of(4097), '4097 taps'),
                       (BIG_N, normal(BIG_N // 2 - 3), '2^23 - 3 samples')):
        t = plan.get_plan(n, 'packed', torch.complex64)[1]
        padded = torch.nn.functional.pad(x, (0, n - x.numel()))
        compare('rfft_phase_a', pf.rfft_phase_a(x, t), pf.rfft_phase_a_plain(padded, t),
                f'n=2^{n.bit_length() - 1} on {what}, unpadded')
    del x, padded
    got = dsc.irfft(dsc.from_numpy(wild_np)).numpy()
    ref = np.fft.irfft(wild_np.astype(np.complex128))
    e = float(np.abs(got - ref).max() / np.abs(ref).max())
    print(f'  dsc.irfft of a non-Hermitian 2^23+1 spectrum vs np.fft float64: {e:.3e}')
    require(got.shape == ref.shape and e <= NUMPY_BOUND, f'irfft non-Hermitian 2^24: {e}')
    del wild_np, got, ref
    for body in sm.REAL_BODIES:
        xs = map_operands(body, MAP_N)
        compare('stream_map', sm.stream_map(body, *xs), sm.stream_map_plain(body, *xs),
                f'{body} 2^26')
    x = draw(map_gen, MAP_N)
    one = torch.tensor([1.75], device=dev)
    for body in ('add', 'sub', 'mul', 'div'):
        for ops, what in (((x, 2.5), 'tensor, 2.5'), ((2.5, x), '2.5, tensor'),
                          ((x, one), 'tensor, 1-element tensor'),
                          ((one, x), '1-element tensor, tensor')):
            compare('stream_map', sm.stream_map(body, *ops), sm.stream_map_plain(body, *ops),
                    f'{body} 2^26 {what}')
    rows = draw(map_gen, (4096, 16384))
    row = draw(map_gen, 16384)
    compare('stream_map', sm.stream_map('add', rows, row), sm.stream_map_plain('add', rows, row),
            'add (4096, 16384) + row (16384,)')
    compare('stream_map', sm.stream_map('mul', row, rows), sm.stream_map_plain('mul', row, rows),
            'mul row (16384,) * (4096, 16384)')
    for lo, hi in ((-0.5, 0.75), (-math.inf, 0.25), (-0.25, math.inf)):
        compare('stream_map', sm.stream_map('clip', x, lo, hi),
                sm.stream_map_plain('clip', x, lo, hi), f'clip 2^26 [{lo}, {hi}]')
    # every instantiation (body, operand kinds) at K5_COUNTS, a ragged count
    # where no broadcast row forbids it and an odd complex count
    dgen = torch.Generator(device='cuda').manual_seed(5)
    for (dtype, body, kinds), kernel in sm.INSTANTIATIONS.items():
        counts = list(K5_COUNTS)
        if 'brow' not in kinds:
            counts.append(2**21 + (1 if dtype == torch.complex64 else 3))
        worst = 0.0
        for n in counts:
            ops = k5_operands(dgen, dtype, body, kinds, n)
            got, ref = sm.stream_map(body, *ops), sm.stream_map_plain(body, *ops)
            e = rel_err(got, ref)
            errs['stream_map'] = max(errs['stream_map'], float((got - ref).abs().max()))
            require(e <= REL_BOUND, f'stream_map {kernel} n={n}: {e} > {REL_BOUND}')
            worst = max(worst, e)
        print(f'  stream_map     {kernel} at n = {", ".join(map(str, counts))}: '
              f'rel err <= {worst:.3e}')
    del ops, got, ref
    ragged = 2**21 + 4 * 1000 + 3
    for body in ('add', 'sin'):
        xs = map_operands(body, ragged)
        compare('stream_map', sm.stream_map(body, *xs), sm.stream_map_plain(body, *xs),
                f'{body} {ragged} (ragged)')
    a, b = cnormal(BIG_N // 2 + 1), cnormal(BIG_N // 2 + 1)
    for body in sm.COMPLEX_BODIES:
        for ops, what in (((a, b), 'tensors'), ((a, 0.5 - 2j), 'complex scalar right'),
                          ((1.5 + 1j, b), 'complex scalar left')):
            compare('stream_map', sm.stream_map(body, *ops), sm.stream_map_plain(body, *ops),
                    f'complex {body} 2^23+1 {what}')
    del x, rows, row, a, b
    for batch, n in SUITE + ((1, BIG_N),):
        t = plan.get_plan(n, 'stream', torch.complex64)[1]
        shape = f'{batch} x 2^{n.bit_length() - 1}'
        for inverse in (False, True):
            for x in (cnormal((batch, n)), normal((batch, n))):
                kind = 'complex' if x.is_complex() else 'real'
                z = stream.phase_a(x, t, inverse)
                compare('stream_phase_a', z, stream.phase_a_plain(x, t, inverse),
                        f'{shape} {kind} {"inverse" if inverse else "forward"}')
            for real_output in (False, True):
                compare('stream_phase_b', stream.phase_b(z, t, inverse, real_output),
                        stream.phase_b_plain(z, t, inverse, real_output),
                        f'{shape} {"inverse" if inverse else "forward"}'
                        f'{" real output" if real_output else ""}')
        del x, z
    for e in (18, 19, 24):
        n = 2**e
        spec = cnormal((1, n // 2 + 1))
        spec.imag[0, -1] = 0  # a valid spectrum's Nyquist bin is real
        got, ref = reconstruct.reconstruct_spectrum(spec, n), reconstruct.reconstruct_plain(spec, n)
        require(got.shape == ref.shape and torch.equal(got, ref), f'reconstruct n=2^{e} differs')
        errs['reconstruct'] = max(errs['reconstruct'], float((got - ref).abs().max()))
        print(f'  {"reconstruct":14s} n=2^{e}: equal to the plain version')
    del spec, got, ref
    # every shape phase 4d gives K6 and K8-K10: 2^18 and 2^21 (fft -> ifft,
    # the czt of 10^6 points), 2^19 (rfft -> irfft) and 2^24, and 2^26.
    # There the column pass takes C = 1 (K6 and K10 at 2^18 and 2^19: a
    # grid of 512 blocks from one vector), C = 2 (K6 and K10 at 2^21,
    # every pass at 2^26) and C = 4 (at 2^24), blocks the suite never uses
    for e, layouts in ((18, (False, True)), (19, (True,)), (21, (False,)),
                       (24, (False, True)), (26, (False,))):
        n = 2**e
        t = plan.get_plan(n, 'stream', torch.complex64)[1]
        for half in layouts:
            what = f'n=2^{e} {"half-T" if half else "T"}'
            x = normal((1, n)) if half else cnormal((1, n))
            z = stream.phase_a(x, t, False)
            compare('stream_phase_a', z, stream.phase_a_plain(x, t, False),
                    f'{what} {"real" if half else "complex"} forward')
            s = stream_t.phase_b_t(z, t, half)
            compare('stream_phase_b_t', s, stream_t.phase_b_t_plain(z, t, half), what, T_BOUND)
            y = stream_t.inv_phase_a_t(s, t, half)
            compare('stream_inv_phase_a_t', y, stream_t.inv_phase_a_t_plain(s, t, half), what,
                    T_BOUND)
            back = stream_t.inv_phase_b_t(y, t, half)
            compare('stream_inv_phase_b_t', back, stream_t.inv_phase_b_t_plain(y, t, half),
                    f'{what}{" real output" if half else ""}', T_BOUND)
            e_rt = rel_err(back, x.reshape(-1))
            print(f'  K6+K8+K9+K10 round trip {what}: rel err {e_rt:.3e}')
            require(e_rt <= NUMPY_BOUND, f'T round trip {what}: {e_rt}')
    del x, z, s, y, back
    torch.cuda.synchronize()

    # K12 at welch's and ShortTimeFFT's launch shapes, K6/K7 at cwt's rows
    model_shape_checks(compare, normal, cnormal)

    # -- 4a. the public filterFFT path at full size ------------------------
    print('phase 4a: public API, the filterFFT path at n = 2^21, 2^24 round trip, n = 4096')
    sig_np = gen.standard_normal(2**20).astype(np.float32)
    build.reset_launches()
    sig = dsc.from_numpy(sig_np)
    for n_taps in (255, 4097):
        taps_np = np.blackman(n_taps).astype(np.float32)
        got = filter_fft(dsc, sig, dsc.from_numpy(taps_np), n_taps)
        ref = np.convolve(sig_np.astype(np.float64), taps_np.astype(np.float64))
        require(got.shape == ref.shape and got.numpy().dtype == np.float32,
                f'filterFFT shape {got.shape} dtype {got.dtype}')
        out = got.numpy()
        require(bool(np.isfinite(out).all()), 'filterFFT output not finite')
        e = float(np.abs(out - ref).max() / np.abs(ref).max())
        print(f'  filterFFT 2^20 x {n_taps} taps vs np.convolve float64: {e:.3e}')
        require(e <= NUMPY_BOUND, f'filterFFT {n_taps} taps: {e}')
    big_np = gen.standard_normal(BIG_N).astype(np.float32)
    big = dsc.from_numpy(big_np)
    spec = dsc.rfft(big)
    require(spec.shape == (BIG_N // 2 + 1,), f'rfft shape {spec.shape}')
    ref = np.fft.rfft(big_np.astype(np.float64))
    e = float(np.abs(spec.numpy() - ref).max() / np.abs(ref).max())
    print(f'  dsc.rfft 2^24 vs np.fft float64: {e:.3e}')
    require(e <= NUMPY_BOUND, f'rfft 2^24: {e}')
    back = dsc.irfft(spec).numpy()
    e = float(np.abs(back - big_np).max())
    print(f'  dsc.irfft(dsc.rfft(x)) 2^24, max abs err: {e:.3e}')
    require(back.shape == big_np.shape and e <= 2e-4, f'round trip 2^24: {e}')
    small_np = gen.standard_normal(4096).astype(np.float32)
    s_spec = dsc.rfft(dsc.from_numpy(small_np))
    ref = np.fft.rfft(small_np.astype(np.float64))
    e = float(np.abs(s_spec.numpy() - ref).max() / np.abs(ref).max())
    e2 = float(np.abs(dsc.irfft(s_spec).numpy() - small_np).max())
    print(f'  rfft/irfft n=4096 (K12 base cases): {e:.3e}, round trip {e2:.3e}')
    require(e <= NUMPY_BOUND and e2 <= 1e-5, 'n=4096 pair')
    torch.cuda.synchronize()
    fft_launches = dict(build.launches)
    print(f'  launches on the filterFFT path: {fft_launches}')
    want = {name: FFT_PATH_LAUNCHES.get(name, 0) for name in KERNELS}
    require(fft_launches == want, f'filterFFT path launches {fft_launches}, routing says {want}')
    del big, spec, back

    trace = os.path.join(REPO, 'build', 'chip_smoke_traces.json')
    os.makedirs(os.path.dirname(trace), exist_ok=True)
    with dsc.profile(trace, serve=False):
        filter_fft(dsc, sig, dsc.from_numpy(np.blackman(255).astype(np.float32)), 255)
    with open(trace) as f:
        names = {ev['name'] for ev in json.load(f)['traceEvents']}
    print(f'  trace events: {sorted(names)}')
    require({'rfft', 'mul', 'irfft', 'get'} <= names, f'trace events {names}')

    # -- 4b. the public elementwise path at full size ----------------------
    print('phase 4b: public API, bench.py fma/sin rows, elementwise sweep, '
          'filterFFT at n = 2^24')
    build.reset_launches()
    a_np = gen.standard_normal(MAP_N).astype(np.float32)
    b_np = gen.standard_normal(MAP_N).astype(np.float32)
    fa, fb = dsc.from_numpy(a_np), dsc.from_numpy(b_np)
    a64, b64 = a_np.astype(np.float64), b_np.astype(np.float64)

    def oracle(what, got, ref):
        require(got.shape == ref.shape, f'{what}: shape {got.shape} != {ref.shape}')
        ok = bool(np.isfinite(got).all()) and np.allclose(got, ref, atol=ORACLE, rtol=ORACLE)
        e = float(np.abs(got - ref).max())
        print(f'  {what}: max abs err vs NumPy float64 {e:.3e}')
        require(ok, f'{what}: not within atol = rtol = {ORACLE} of NumPy')

    def launched(fn, expect, what):
        before = build.launches['stream_map']
        res = fn()
        torch.cuda.synchronize()
        n = build.launches['stream_map'] - before
        require(n == int(expect), f'{what}: K5 launched {n} times, routing rule says {expect}')
        return res

    got = launched(lambda: dsc.add(fa, fb), True, 'fma')
    oracle('dsc.add 2^26 f32 (bench fma)', got.numpy(), a64 + b64)
    got = launched(lambda: dsc.sin(fa), True, 'sin')
    oracle('dsc.sin 2^26 f32 (bench sin)', got.numpy(), np.sin(a64))
    del got
    sweep = [(np.float32, e) for e in (8, 16, 21, 26)] + [(np.float64, 21), (np.complex64, 21)]
    for dtype, e in sweep:
        n = 2**e
        x_np, y_np = a_np[:n], b_np[:n]
        if dtype == np.complex64:
            x_np, y_np = x_np + 1j * b_np[-n:], y_np + 1j * a_np[-n:]
        x_np, y_np = x_np.astype(dtype), y_np.astype(dtype)
        wide = np.complex128 if dtype == np.complex64 else np.float64
        x64, y64 = x_np.astype(wide), y_np.astype(wide)
        tx, ty = dsc.from_numpy(x_np), dsc.from_numpy(y_np)
        what = f'{np.dtype(dtype).name} 2^{e}'
        for name, fn, ref in (('add', dsc.add, np.add), ('mul', dsc.mul, np.multiply)):
            got = launched(lambda: fn(tx, ty), ops_kernels.streams(name, tx.torch, ty.torch),
                           f'{name} {what}')
            oracle(f'{name} {what}', got.numpy(), ref(x64, y64))
        got = launched(lambda: dsc.exp(tx),
                       dtype == np.float32 and sm.eligible([tx.shape], [tx.torch.dtype]),
                       f'exp {what}')
        oracle(f'exp {what}', got.numpy(), np.exp(x64))
        got = launched(lambda: dsc.sum(tx), False, f'sum {what}')
        oracle(f'sum {what}', got.numpy(), np.sum(x64, keepdims=True))
        got = launched(lambda: dsc.max(tx), False, f'max {what}')
        ref = (x64[np.lexsort((x64.imag, x64.real))[-1:]] if dtype == np.complex64
               else np.max(x64, keepdims=True))
        oracle(f'max {what}', got.numpy(), ref)
    m_np, r_np = a_np[:4096 * 512].reshape(4096, 512), b_np[:512]
    tm, tr = dsc.from_numpy(m_np), dsc.from_numpy(r_np)
    got = launched(lambda: dsc.add(tm, tr),
                   sm.eligible([tm.shape, tr.shape], [torch.float32] * 2),
                   'add (4096, 512) + (512,)')
    oracle('add (4096, 512) + row (512,) f32', got.numpy(),
           m_np.astype(np.float64) + r_np.astype(np.float64))
    c_np, d_np = a_np[:2048].reshape(2048, 1), b_np[:2048].reshape(1, 2048)
    got = launched(lambda: dsc.mul(dsc.from_numpy(c_np), dsc.from_numpy(d_np)), False,
                   'mul (2048, 1) * (1, 2048)')
    oracle('mul (2048, 1) * (1, 2048) f32 (outer, plain)', got.numpy(),
           c_np.astype(np.float64) * d_np.astype(np.float64))
    del fa, fb, a64, b64, got

    long_np = gen.standard_normal(BIG_N // 2).astype(np.float32)
    taps_np = np.blackman(4097).astype(np.float32)
    long_sig, long_taps = dsc.from_numpy(long_np), dsc.from_numpy(taps_np)
    got = launched(lambda: filter_fft(dsc, long_sig, long_taps, 4097, BIG_N), True,
                   'filterFFT 2^24')
    spec64 = (np.fft.rfft(long_np.astype(np.float64), BIG_N)
              * np.fft.rfft(taps_np.astype(np.float64), BIG_N))
    ref = np.fft.irfft(spec64, BIG_N)[: BIG_N // 2 + 4096]
    out = got.numpy()
    require(out.shape == ref.shape and out.dtype == np.float32 and np.isfinite(out).all(),
            f'filterFFT 2^24 shape {out.shape} dtype {out.dtype}')
    e = float(np.abs(out - ref).max() / np.abs(ref).max())
    print(f'  filterFFT 2^23 x 4097 taps, n=2^24, vs float64 FFT convolution: {e:.3e}')
    require(e <= NUMPY_BOUND, f'filterFFT 2^24: {e}')
    torch.cuda.synchronize()
    map_launches = dict(build.launches)
    print(f'  launches on the elementwise path: {map_launches}')
    for name in MAP_PATH:
        require(map_launches[name] > 0, f'kernel {name} was not launched on the elementwise path')

    # -- 4c. the batched FFT suite at full size ----------------------------
    print('phase 4c: public API, BASELINE config 3 (the batched FFT suite) at full size')

    def against_numpy(what, got, ref):
        out = got.numpy()
        require(out.shape == ref.shape and bool(np.isfinite(out).all()),
                f'{what}: shape {out.shape} (want {ref.shape}) or not finite')
        e = float(np.abs(out - ref).max() / np.abs(ref).max())
        print(f'  {what}: {e:.3e} vs np.fft float64')
        require(e <= NUMPY_BOUND, f'{what}: {e} > {NUMPY_BOUND}')

    def cnp(shape):
        return (gen.standard_normal(shape) + 1j * gen.standard_normal(shape)).astype(np.complex64)

    build.reset_launches()
    for batch, n in SUITE:
        x_np = cnp((batch, n))
        x, x64 = dsc.from_numpy(x_np), x_np.astype(np.complex128)
        shape = f'{batch} x 2^{n.bit_length() - 1}'
        against_numpy(f'fft {shape}', dsc.fft(x), np.fft.fft(x64))
        against_numpy(f'ifft {shape}', dsc.ifft(x), np.fft.ifft(x64))
    del x, x_np, x64
    r_np = gen.standard_normal((16, 2**20)).astype(np.float32)
    spec = dsc.rfft(dsc.from_numpy(r_np))
    against_numpy('rfft 16 x 2^20', spec, np.fft.rfft(r_np.astype(np.float64)))
    against_numpy('irfft 16 x 2^20', dsc.irfft(spec), np.fft.irfft(spec.numpy().astype(np.complex128)))
    a_np = gen.standard_normal((2**18, 64)).astype(np.float32)
    against_numpy('rfft axis 0 of (2^18, 64)', dsc.rfft(dsc.from_numpy(a_np), axis=0),
                  np.fft.rfft(a_np.astype(np.float64), axis=0))
    f_np = cnp((256, 2**16))
    against_numpy('fft2 (256, 2^16)', dsc.fft2(dsc.from_numpy(f_np)),
                  np.fft.fft2(f_np.astype(np.complex128)))
    g_np = gen.standard_normal((256, 2**16)).astype(np.float32)
    spec2 = dsc.rfft2(dsc.from_numpy(g_np))
    against_numpy('rfft2 (256, 2^16)', spec2, np.fft.rfft2(g_np.astype(np.float64)))
    against_numpy('irfft2 (256, 2^15+1)', dsc.irfft2(spec2),
                  np.fft.irfft2(spec2.numpy().astype(np.complex128)))
    del spec, spec2, r_np, a_np, f_np, g_np
    for e in (18, 19):
        sp = np.fft.rfft(gen.standard_normal(2**e)).astype(np.complex64)
        against_numpy(f'irfft of a dense 2^{e} spectrum', dsc.irfft(dsc.from_numpy(sp)),
                      np.fft.irfft(sp.astype(np.complex128)))
    sp = np.fft.rfft(gen.standard_normal(BIG_N)).astype(np.complex64)
    o = dsc.from_numpy(np.zeros(BIG_N, np.float32))
    dsc.irfft(dsc.from_numpy(sp), out=o)
    against_numpy('irfft(x, out=o) 2^24', o, np.fft.irfft(sp.astype(np.complex128)))
    v_np = cnp(BIG_N)
    against_numpy('ifft single 2^24', dsc.ifft(dsc.from_numpy(v_np)),
                  np.fft.ifft(v_np.astype(np.complex128)))
    del sp, o, v_np
    torch.cuda.synchronize()
    suite_launches = dict(build.launches)
    print(f'  launches on the batched path: {suite_launches}')
    want = {name: SUITE_LAUNCHES.get(name, 0) for name in KERNELS}
    require(suite_launches == want, f'batched path launches {suite_launches}, routing says {want}')

    dsc.clear()
    n_plans = 0
    for e in range(6, 16):
        c_np, r_np = cnp(2**e), gen.standard_normal(2**e).astype(np.float32)
        against_numpy(f'plan stress: fft 2^{e}', dsc.fft(dsc.from_numpy(c_np)),
                      np.fft.fft(c_np.astype(np.complex128)))
        against_numpy(f'plan stress: rfft 2^{e}', dsc.rfft(dsc.from_numpy(r_np)),
                      np.fft.rfft(r_np.astype(np.float64)))
        n_plans += 2
    c_np = cnp((4, 2**18))
    against_numpy('plan stress: fft 4 x 2^18 (stream plan)', dsc.fft(dsc.from_numpy(c_np)),
                  np.fft.fft(c_np.astype(np.complex128)))
    r_np = gen.standard_normal(2**20).astype(np.float32)
    against_numpy('plan stress: rfft 2^20 (packed plan)', dsc.rfft(dsc.from_numpy(r_np)),
                  np.fft.rfft(r_np.astype(np.float64)))
    n_plans += 2
    print(f'  plan cache after {n_plans} distinct plans: {plan.num_plans()} '
          f'(DSC_MAX_FFT_PLANS = {plan.MAX_FFT_PLANS})')
    require(plan.num_plans() == plan.MAX_FFT_PLANS == 16, 'plan cache did not end at 16')
    del c_np, r_np

    # -- 4d. the single-vector path at full size ---------------------------
    print('phase 4d: public API, single vectors into and out of the T layout')
    single_launches = dict.fromkeys(KERNELS, 0)

    def routed(what, fn, want):
        """``fn()`` with every launch count set to 0 just before it, and the
        counts read just after it held to ``want``."""
        build.reset_launches()
        res = fn()
        torch.cuda.synchronize()
        got = {name: count for name, count in build.launches.items() if count}
        require(got == want, f'{what}: launches {got}, routing says {want}')
        for name, count in got.items():
            single_launches[name] += count
        return res

    for e in (18, 21, 24, 26):
        n = 2**e
        v_np = cnp(n)
        v = dsc.from_numpy(v_np)
        spec = routed(f'fft 2^{e}', lambda: dsc.fft(v), INTO_T)
        require(spec._layout == (*factors(n), False), f'fft 2^{e}: layout {spec._layout}')
        if e <= 24:
            against_numpy(f'fft single 2^{e} (T layout)', spec,
                          np.fft.fft(v_np.astype(np.complex128)))
        back = routed(f'ifft 2^{e}', lambda: dsc.ifft(spec), OUT_OF_T)
        against_numpy(f'ifft(fft(x)) single 2^{e}', back, v_np)
        del v, spec, back
    for e in (18, 19):
        r_np = gen.standard_normal(2**e).astype(np.float32)
        spec = routed(f'rfft 2^{e}', lambda: dsc.rfft(dsc.from_numpy(r_np)), INTO_T)
        require(spec._layout == (*factors(2**e), True), f'rfft 2^{e}: layout {spec._layout}')
        against_numpy(f'rfft single 2^{e} (half-T layout)', spec,
                      np.fft.rfft(r_np.astype(np.float64)))
        back = routed(f'irfft 2^{e}', lambda: dsc.irfft(spec), OUT_OF_T)
        require(back.numpy().dtype == np.float32, f'irfft 2^{e} dtype {back.dtype}')
        against_numpy(f'irfft(rfft(x)) single 2^{e}', back, r_np)
    sig_np = gen.standard_normal(2**18 + 10000).astype(np.float32)
    taps_np = np.blackman(255).astype(np.float32)
    got = routed('fft_convolve n=2^19', lambda: dsc.models.fft_convolve(
        dsc.from_numpy(sig_np), dsc.from_numpy(taps_np)),
        {'stream_phase_a': 2, 'stream_phase_b_t': 2, **OUT_OF_T})
    against_numpy('fft_convolve (2^18 + 10000) x 255 taps, n=2^19, vs np.convolve', got,
                  np.convolve(sig_np.astype(np.float64), taps_np.astype(np.float64)))
    # the chirp kernel's spectrum and the signal's (K6 + K8 each), their
    # product (K5: 2^21 complex64 values), the inverse (K9 + K10)
    z_np = cnp(10**6)
    got = routed('czt 10^6', lambda: dsc.models.czt(dsc.from_numpy(z_np)),
                 {'stream_phase_a': 2, 'stream_phase_b_t': 2, 'stream_map': 1, **OUT_OF_T})
    against_numpy('czt of 10^6 points (fft_n = 2^21) vs np.fft', got,
                  np.fft.fft(z_np.astype(np.complex128)))
    del sig_np, z_np, got
    print(f'  launches on the single-vector path: {single_launches}')
    for name in ('stream_phase_a', *INTO_T, *OUT_OF_T):
        require(single_launches[name] > 0, f'kernel {name} was not launched on the single path')

    launches = {**fft_launches, 'stream_map': map_launches['stream_map'],
                **{k: suite_launches[k] for k in ('stream_phase_a', 'stream_phase_b',
                                                  'reconstruct')},
                **{k: single_launches[k] for k in ('stream_phase_b_t', 'stream_inv_phase_a_t',
                                                   'stream_inv_phase_b_t')}}
    by_path = {name: {'filterfft': fft_launches[name], 'elementwise': map_launches[name],
                      'batched': suite_launches[name], 'single': single_launches[name]}
               for name in KERNELS}

    # -- 5. timings --------------------------------------------------------
    print(f'phase 5: timings, CUDA events [{card}]')

    for n in (STEP_N, BIG_N, 2**26):
        t = plan.get_plan(n, 'packed', torch.complex64)[1]
        tables = nbytes(t.w_n1, t.w_m2, t.twiddle.lo, t.twiddle.hi, t.untangle.lo,
                        t.untangle.hi)
        n1, n2 = factors(n)
        nh = n // 2
        x = normal(n)
        at = pf.rfft_phase_a(x, t)
        spec = pf.rfft_phase_b(at, t)
        y = pf.irfft_phase_a(spec, t)
        what = f'n=2^{n.bit_length() - 1} {factors(n)}'
        # library: torch.fft.rfft / irfft, the whole K1+K2 / K3+K4 function
        # flops: 5 N log2 N of each pass's DFTs plus ~6-10 per value of twiddle
        # or (un)tangle arithmetic
        timed('rfft_phase_a', what, lambda: pf.rfft_phase_a(x, t),
              lambda: pf.rfft_phase_a_plain(x, t), lambda: torch.fft.rfft(x),
              nbytes(x, at) + tables, fft_ops(nh, n1) + 6 * nh)
        timed('irfft_phase_b', what, lambda: pf.irfft_phase_b(y, t),
              lambda: pf.irfft_phase_b_plain(y, t), lambda: torch.fft.irfft(spec, n),
              nbytes(y, x) + tables, fft_ops(nh, n1) + 2 * n)
        timed('irfft_phase_a', what, lambda: pf.irfft_phase_a(spec, t),
              lambda: pf.irfft_phase_a_plain(spec, t), lambda: torch.fft.irfft(spec, n),
              nbytes(spec, y) + tables, fft_ops(nh, n2 // 2) + 16 * nh)
        if n == 2**26:  # K2 and K1 on unpadded operands at the filterFFT's two sizes only
            continue
        timed('rfft_phase_b', what, lambda: pf.rfft_phase_b(at, t),
              lambda: pf.rfft_phase_b_plain(at, t), lambda: torch.fft.rfft(x),
              nbytes(at, spec) + tables, fft_ops(nh, n2 // 2) + 10 * nh)
        # K1 on the filterFFT's operands, unpadded: it reads only their
        # samples (the bound counts those) and writes all of At
        for xs, kind in ((normal(n // 2), 'samples'),
                         (taps_of(255 if n == STEP_N else 4097), 'taps')):
            timed('rfft_phase_a', f'{what} on {xs.numel()} {kind}, unpadded',
                  lambda: pf.rfft_phase_a(xs, t), lambda: pf.rfft_phase_a_plain(xs, t),
                  lambda: torch.fft.rfft(xs, n), nbytes(xs, at) + tables,
                  fft_ops(nh, n1) + 6 * nh)
    del x, at, spec, y, xs
    # K12 at the n = 4096 pair's 2048 x 1, at 4096 x 1000 and at fft2
    # (256, 2^16)'s axis-0 shape, 65536 x 256 (2^24 values, cold in L2)
    for n, batch in ((2048, 1), (4096, 1000), (256, 65536)):
        w = plan.get_plan(n, 'complex', torch.complex64)[1]
        x = cnormal((batch, n))
        timed('base_fft', f'n={n} batch={batch}', lambda: base_fft.fft_base(x, w),
              lambda: base_fft.fft_base_plain(x, w), lambda: torch.fft.fft(x),
              2 * nbytes(x) + nbytes(w), fft_ops(n * batch, n))
    for body in sm.REAL_BODIES:
        xs = map_operands(body, MAP_N)
        timed('stream_map', f'{body} 2^26 f32', lambda: sm.stream_map(body, *xs),
              lambda: sm.stream_map_plain(body, *xs), lambda: LIBRARY[body](*xs),
              nbytes(*xs) + 4 * MAP_N, MAP_OPS[body] * MAP_N)
    rows = draw(map_gen, (4096, 16384))
    row = draw(map_gen, 16384)
    timed('stream_map', 'add (4096, 16384) + row (16384,) f32',
          lambda: sm.stream_map('add', rows, row), lambda: sm.stream_map_plain('add', rows, row),
          lambda: torch.add(rows, row), 2 * nbytes(rows) + nbytes(row), rows.numel())
    del rows, row
    x = draw(map_gen, MAP_N)
    timed('stream_map', 'mul 2^26 f32 by 2.5', lambda: sm.stream_map('mul', x, 2.5),
          lambda: sm.stream_map_plain('mul', x, 2.5), lambda: torch.mul(x, 2.5),
          2 * nbytes(x), MAP_N)
    one = torch.tensor([1.75], device=dev)
    timed('stream_map', 'add 2^26 f32 + 1-element tensor', lambda: sm.stream_map('add', x, one),
          lambda: sm.stream_map_plain('add', x, one), lambda: torch.add(x, one),
          2 * nbytes(x) + nbytes(one), MAP_N)
    lo, hi = torch.tensor([-0.5], device=dev), torch.tensor([0.75], device=dev)
    timed('stream_map', 'clip 2^26 f32, 1-element tensor bounds',
          lambda: sm.stream_map('clip', x, lo, hi), lambda: sm.stream_map_plain('clip', x, lo, hi),
          lambda: torch.clamp(x, lo, hi), 2 * nbytes(x) + nbytes(lo, hi), 2 * MAP_N)
    del x, one, lo, hi
    a, b = cnormal(BIG_N // 2 + 1), cnormal(BIG_N // 2 + 1)
    for body in sm.COMPLEX_BODIES:
        timed('stream_map', f'complex {body} 2^23+1 c64', lambda: sm.stream_map(body, a, b),
              lambda: sm.stream_map_plain(body, a, b), lambda: LIBRARY[body](a, b),
              3 * nbytes(a), CMAP_OPS[body] * a.numel())
    del a, b
    # K6/K7 at the suite's shapes; library: the torch.fft call computing the
    # whole K6+K7 function; flops: 5 N log2 N of each pass's DFTs plus ~6
    # per value of twiddle arithmetic in K6
    for batch, n in SUITE:
        n1, n2 = factors(n)
        t = plan.get_plan(n, 'stream', torch.complex64)[1]
        tables = nbytes(t.w_n1, t.w_n2, t.twiddle.lo, t.twiddle.hi)
        x = cnormal((batch, n))
        z = stream.phase_a(x, t, False)
        what = f'{batch} x 2^{n.bit_length() - 1} {(n1, n2)}'
        timed('stream_phase_a', what, lambda: stream.phase_a(x, t, False),
              lambda: stream.phase_a_plain(x, t, False), lambda: torch.fft.fft(x),
              nbytes(x, z) + tables, fft_ops(batch * n, n1) + 6 * batch * n)
        timed('stream_phase_b', what, lambda: stream.phase_b(z, t, False),
              lambda: stream.phase_b_plain(z, t, False), lambda: torch.fft.fft(x),
              2 * nbytes(z) + tables, fft_ops(batch * n, n2))
    # the rfft -> irfft row: real-input K6, real-output inverse K7
    t = plan.get_plan(2**20, 'stream', torch.complex64)[1]
    tables = nbytes(t.w_n1, t.w_n2, t.twiddle.lo, t.twiddle.hi)
    r = normal((16, 2**20))
    z = stream.phase_a(r, t, False)
    spec = torch.fft.rfft(r)
    timed('stream_phase_a', '16 x 2^20 real input', lambda: stream.phase_a(r, t, False),
          lambda: stream.phase_a_plain(r, t, False), lambda: torch.fft.rfft(r),
          nbytes(r, z) + tables, fft_ops(16 * 2**20, 1024) / 2 + 6 * 16 * 2**20)
    timed('stream_phase_b', '16 x 2^20 inverse real output',
          lambda: stream.phase_b(z, t, True, True), lambda: stream.phase_b_plain(z, t, True, True),
          lambda: torch.fft.irfft(spec, 2**20), nbytes(z, r) + tables, fft_ops(16 * 2**20, 1024))
    del x, z, r, spec
    for e in (19, 24):
        n = 2**e
        spec = cnormal((1, n // 2 + 1))
        full = reconstruct.reconstruct_spectrum(spec, n)
        timed('reconstruct', f'n=2^{e} c64', lambda: reconstruct.reconstruct_spectrum(spec, n),
              lambda: reconstruct.reconstruct_plain(spec, n), None, nbytes(spec, full), 0)
    del spec, full
    # K8, K9, K10 at the single-vector shapes, the largest (2^26, K9's
    # 8192-point rows) and smallest (2^18) T splits among them; library: the
    # torch.fft call computing the whole function of K6+K8 (fft, rfft) or
    # K9+K10 (ifft, irfft) on the same vector; flops: 5 N log2 N of the
    # pass's DFTs, plus ~6 per value of twiddle arithmetic in K9
    for e, half in ((24, False), (24, True), (19, True), (26, False), (18, False)):
        n = 2**e
        n1, n2 = factors(n)
        t = plan.get_plan(n, 'stream', torch.complex64)[1]
        x = normal((1, n)) if half else cnormal((1, n))
        z = stream.phase_a(x, t, False)
        s = stream_t.phase_b_t(z, t, half)
        y = stream_t.inv_phase_a_t(s, t, half)
        back = stream_t.inv_phase_b_t(y, t, half)
        nat = torch.fft.rfft(x) if half else torch.fft.fft(x)
        lib_fwd = (lambda: torch.fft.rfft(x)) if half else (lambda: torch.fft.fft(x))
        lib_inv = (lambda: torch.fft.irfft(nat, n)) if half else (lambda: torch.fft.ifft(nat))
        what = f'n=2^{e} {(n1, n2)} {"half-T" if half else "T"}'
        timed('stream_phase_b_t', what, lambda: stream_t.phase_b_t(z, t, half),
              lambda: stream_t.phase_b_t_plain(z, t, half), lib_fwd,
              nbytes(z, s, t.w_n2), fft_ops(n, n2))
        timed('stream_inv_phase_a_t', what, lambda: stream_t.inv_phase_a_t(s, t, half),
              lambda: stream_t.inv_phase_a_t_plain(s, t, half), lib_inv,
              nbytes(s, y, t.w_n2, t.twiddle.lo, t.twiddle.hi), fft_ops(n, n2) + 6 * n)
        timed('stream_inv_phase_b_t', f'{what}{" real output" if half else ""}',
              lambda: stream_t.inv_phase_b_t(y, t, half),
              lambda: stream_t.inv_phase_b_t_plain(y, t, half), lib_inv,
              nbytes(y, back, t.w_n1), fft_ops(n, n1))
    del x, z, s, y, back, nat
    # the suite's rows through the public API, beside the torch.fft call on
    # the same shape; the rest of a row's time over its K6+K7 launches is the
    # reconstruction, the movedim copies and the host
    print(f'  batched suite, public API, device time per call, 20 calls back to back [{card}]:')
    suite_rows = []
    for batch, n in SUITE:
        x = dsc.from_numpy(cnp((batch, n)))
        suite_rows.append((f'fft {batch} x 2^{n.bit_length() - 1}', lambda x=x: dsc.fft(x),
                           lambda x=x: torch.fft.fft(x.torch)))
        suite_rows.append((f'ifft {batch} x 2^{n.bit_length() - 1}', lambda x=x: dsc.ifft(x),
                           lambda x=x: torch.fft.ifft(x.torch)))
    r = dsc.from_numpy(gen.standard_normal((16, 2**20)).astype(np.float32))
    spec = dsc.rfft(r)
    a = dsc.from_numpy(gen.standard_normal((2**18, 64)).astype(np.float32))
    f = dsc.from_numpy(cnp((256, 2**16)))
    suite_rows += [('rfft 16 x 2^20', lambda: dsc.rfft(r), lambda: torch.fft.rfft(r.torch)),
                   ('irfft 16 x 2^20', lambda: dsc.irfft(spec),
                    lambda: torch.fft.irfft(spec.torch, 2**20)),
                   ('rfft axis 0 (2^18, 64)', lambda: dsc.rfft(a, axis=0),
                    lambda: torch.fft.rfft(a.torch, dim=0)),
                   ('fft2 (256, 2^16)', lambda: dsc.fft2(f), lambda: torch.fft.fft2(f.torch))]
    for what, fn, lib in suite_rows:
        ms, lib_ms = back_to_back_ms(fn, 20), back_to_back_ms(lib, 20)
        print(f'    {what}: {ms:.4f} ms, torch.fft {lib_ms:.4f} ms ({ms / lib_ms:.2f}x) [{card}]')
    del suite_rows, x, r, spec, a, f
    taps = dsc.from_numpy(np.blackman(255).astype(np.float32))
    step_ms = cuda_ms(lambda: filter_fft(dsc, sig, taps, 255))
    print(f'  filterFFT step (2^20 x 255 taps, n=2^21, public API): {step_ms:.4f} ms [{card}]')
    big_ms = cuda_ms(lambda: filter_fft(dsc, long_sig, long_taps, 4097, BIG_N))
    print(f'  filterFFT step (2^23 x 4097 taps, n=2^24, public API): {big_ms:.4f} ms [{card}]')
    del sig, taps, long_sig, long_taps

    # -- 6. the fusion tier and the models -----------------------------------
    fusion_launches = fusion_phase(dsc, card, compare, timed)
    launches['stream_map_gen'] = fusion_launches['stream_map_gen']
    for name in KERNELS:
        by_path[name]['fusion'] = fusion_launches[name]

    # -- 7. the model tier ---------------------------------------------------
    model_launches = models_phase(dsc, card, compare)
    for name in KERNELS:
        by_path[name]['models'] = model_launches[name]

    # -- 8. the transforms tier -----------------------------------------------
    transform_launches = transforms_phase(dsc, card, compare)
    for name in KERNELS:
        by_path[name]['transforms'] = transform_launches[name]

    # -- 9. the IIR recurrence ------------------------------------------------
    recurrence_launches = recurrence_phase(dsc, card, compare)
    for name in KERNELS:
        by_path[name]['recurrence'] = recurrence_launches[name]

    # -- 10. the affine-scan tier ---------------------------------------------
    scan_launches = scans_phase(dsc, card)
    for name in KERNELS:
        by_path[name]['scans'] = scan_launches[name]

    # -- 11. the signal-generation and design tier ---------------------------
    signal_launches = signals_phase(dsc, card, compare)
    for name in KERNELS:
        by_path[name]['signals'] = signal_launches[name]

    # -- 12. the system-object and design-support tier -----------------------
    system_launches = systems_phase(dsc, card, compare)
    for name in KERNELS:
        by_path[name]['systems'] = system_launches[name]

    # -- 13. the sharded tier and the C front door ----------------------------
    shard_launches = sharded_phase(dsc, card, compare, timed)
    for name in KERNELS:
        by_path[name]['sharded'] = shard_launches[name]
    launches.update({name: shard_launches[name] for name in LOCAL_KERNELS})

    # the main path's shape of each kernel: the filterFFT at n = 2^21 for the
    # packed passes, the n = 4096 pair's 2048 x 1 for K12, bench's fma for K5,
    # the suite's 16 x 2^20 for K6/K7 (where they lose most to torch.fft),
    # the 2^19 irfft for K11, the 2^24 single fft -> ifft for K8, K9, K10,
    # the clip chain of phase 6 for K5g, one shard's block of the 4-way
    # sharded 2^24 four-step for the local K6/K7
    main_case = {name: rows_[0] for name, rows_ in cases.items()}
    main_case['stream_map'] = next(r for r in cases['stream_map'] if r['what'].startswith('add 2^26'))
    for name in ('stream_phase_a', 'stream_phase_b'):
        main_case[name] = next(r for r in cases[name] if r['what'].startswith('16 x 2^20 '))
    record = {'kernels': [
        {'name': name, 'route': 'cuda', 'source': src, 'replaces': rep,
         'launches': launches[name], 'max_abs_err': errs[name],
         'ms': main_case[name]['ms'], 'plain_ms': main_case[name]['plain_ms'],
         'bound_ms': main_case[name]['bound_ms'], 'bound_by': main_case[name]['bound_by'],
         'library_ms': main_case[name]['library_ms'], 'shape': main_case[name]['what'],
         'launches_by_path': by_path[name], 'cases': cases[name]}
        for name, (src, rep) in KERNELS.items()]}
    print(f'chip_smoke: {time.time() - t_start:.1f} s')
    print(json.dumps(record))
    print(card)
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}))
    return 0


if __name__ == '__main__':
    sys.exit(main())
