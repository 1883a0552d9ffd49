"""filterFFT through dsc_tpu_torch's public API, as the README writes it: the full linear
convolution of each signal with a windowed-sinc lowpass by ``irfft(rfft(s, n) * rfft(b, n))``
at n = next_pow2(m + k - 1), cut to the signal's m samples.

The port's ``irfft`` takes no ``n`` here: its ``n`` follows the dsc convention (an output of
2 * next_pow2(n - 1) samples), and a spectrum of n/2 + 1 bins gives n samples without it.
"""

from __future__ import annotations

import math
from typing import Any, Dict

import numpy as np
import torch

import dsc_tpu_torch as dsc
from portbench import traffic as traffic_gen

# the port's byte cap: above what any cell holds, below the card's 80 GB
MEM_BYTES = 64 * 2**30


def next_pow2(n: int) -> int:
    return 1 << (n - 1).bit_length()


def taps(config: Dict[str, Any]) -> np.ndarray:
    """The windowed-sinc lowpass of examples/filter_fft.py: ``taps`` taps, cut-off
    ``cutoff_hz`` at ``sample_rate_hz``, a Blackman window; computed in float64."""
    k = int(config['taps'])
    cutoff = float(config['cutoff_hz']) / float(config['sample_rate_hz'])
    j = np.arange(k) - (k - 1) / 2
    return (2 * cutoff * np.sinc(2 * cutoff * j) * np.blackman(k)).astype(np.float32)


def make_inputs(config, traffic, seed: int, device) -> list:
    """The pool: each input a signal of the traffic's shape and the taps, on ``device``."""
    b = torch.from_numpy(taps(config)).to(device)
    return [{'signal': s, 'taps': b} for s in traffic_gen.signals(traffic, seed, device)]


def setup(config, traffic, device) -> Dict[str, Any]:
    dsc.init(MEM_BYTES, device=device)
    m = int(traffic['shape'][-1])
    return {'m': m, 'n': next_pow2(m + int(config['taps']) - 1),
            'cut': (slice(None),) * (len(traffic['shape']) - 1) + (slice(0, m),)}


def prepare(state, raw) -> tuple:
    """A user's upload: the signal and the taps as Tensors of the port."""
    return dsc.Tensor(raw['signal']), dsc.Tensor(raw['taps'])


def call(state, args, span):
    s, b = args
    n = state['n']
    with span('rfft'):
        xs = dsc.rfft(s, n=n)
    with span('rfft'):
        bs = dsc.rfft(b, n=n)
    with span('multiply'):
        p = xs * bs
    with span('irfft'):
        y = dsc.irfft(p)
    with span('slice'):
        return y[state['cut']]


def result(out) -> torch.Tensor:
    return out.torch


def teardown() -> None:
    dsc.clear()
    dsc.shutdown()


def samples(config, traffic) -> int:
    return traffic_gen.samples(traffic)


def bytes_needed(config, traffic) -> int:
    """Each public op reads its arguments once and writes its result once (float32 4 bytes,
    complex64 8): rfft of the signal and of the taps, the multiply (the taps' spectrum is
    read once, whatever the broadcast), irfft; the cut to m samples is a view."""
    shape = [int(s) for s in traffic['shape']]
    rows = math.prod(shape[:-1])
    m, k = shape[-1], int(config['taps'])
    n = next_pow2(m + k - 1)
    bins = n // 2 + 1
    rfft_s = 4 * rows * m + 8 * rows * bins
    rfft_b = 4 * k + 8 * bins
    multiply = 8 * rows * bins + 8 * bins + 8 * rows * bins
    irfft = 8 * rows * bins + 4 * rows * n
    return rfft_s + rfft_b + multiply + irfft
