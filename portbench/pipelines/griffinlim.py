"""Fast Griffin-Lim through dsc_tpu_torch's public API, as a user writes it:
``dsc.models.GriffinLim(frame, hop, window, n_iter, momentum, center=True, eps)`` called on a
(clips, frames, 513) float32 batch of magnitudes with the initial phasors, back to (clips,
samples) float32 audio.

The pool's inputs are the traffic's clips turned into what such a user holds: their STFT
magnitudes (torch.stft on the device, ``center=True`` with zero padding, the periodic Hann
window, in float64 and then rounded to float32) and a uniform random initial phase drawn from
the seed as unit complex64 phasors. The clips themselves are not kept.
"""

from __future__ import annotations

import math
from typing import Any, Dict

import scipy.signal
import torch

import dsc_tpu_torch as dsc
from portbench import traffic as traffic_gen

MEM_BYTES = 64 * 2**30
# the initial phase's random stream, apart from the one the traffic's clips come from
PHASE_STREAM = 0x9E3779B97F4A7C15


def frames(config, traffic) -> int:
    """Frames of a clip with centre padding: 1 + n // hop."""
    return 1 + int(traffic['shape'][-1]) // int(config['hop'])


def _window(config, device) -> torch.Tensor:
    if config['window'] != 'periodic_hann':
        raise ValueError(f'window {config["window"]!r}: only periodic_hann is configured')
    return torch.from_numpy(scipy.signal.get_window('hann', int(config['win_length']))).to(device)


def make_inputs(config, traffic, seed: int, device) -> list:
    """The pool: each input the magnitudes of a batch of clips, their initial phasors and the
    clips' length."""
    n_fft, hop, win = int(config['n_fft']), int(config['hop']), int(config['win_length'])
    w = _window(config, device)
    gen = traffic_gen.generator(seed ^ PHASE_STREAM, device)
    out = []
    for clips in traffic_gen.signals(traffic, seed, device):
        z = torch.stft(clips.to(torch.float64), n_fft, hop, win, w, center=True,
                       pad_mode='constant', return_complex=True)
        mags = z.abs().to(torch.float32).transpose(-1, -2).contiguous()
        del z
        phase = 2 * math.pi * torch.rand(mags.shape, generator=gen, device=device,
                                         dtype=torch.float64)
        angles = torch.polar(torch.ones_like(phase), phase).to(torch.complex64)
        out.append({'magnitudes': mags, 'angles': angles, 'length': clips.shape[-1]})
    return out


def setup(config, traffic, device) -> Dict[str, Any]:
    dsc.init(MEM_BYTES, device=device)
    if config['pad_mode'] != 'constant':
        raise ValueError(f'pad_mode {config["pad_mode"]!r}: the port pads with zeros')
    gl = dsc.models.GriffinLim(frame=int(config['win_length']), hop=int(config['hop']),
                               window=_window(config, 'cpu').numpy(),
                               n_iter=int(config['n_iter']), momentum=float(config['momentum']),
                               center=bool(config['center']), eps=float(config['eps']))
    if gl.fft_n != int(config['n_fft']):
        raise ValueError(f'GriffinLim transforms {gl.fft_n} points, the configuration '
                         f'states n_fft {config["n_fft"]}')
    return {'gl': gl, 'length': int(traffic['shape'][-1])}


def prepare(state, raw) -> tuple:
    return dsc.Tensor(raw['magnitudes']), dsc.Tensor(raw['angles'])


def call(state, args, span):
    with span('griffin_lim'):
        return state['gl'](args[0], length=state['length'], angles=args[1])


def result(out) -> torch.Tensor:
    return out.torch


def teardown() -> None:
    dsc.clear()
    dsc.shutdown()


def samples(config, traffic) -> int:
    """The audio samples a call gives back."""
    return traffic_gen.samples(traffic)


def bytes_needed(config, traffic) -> int:
    """Each iteration reads the magnitudes (4 bytes a bin) and the phase (8), writes the
    rebuilt spectrum (8) and reads the previous one (8), and writes and reads the audio once
    (8 bytes a sample); then the last inverse reads the magnitudes and phase and writes the
    audio."""
    rows = int(traffic['shape'][0])
    bins = rows * frames(config, traffic) * (int(config['n_fft']) // 2 + 1)
    n = traffic_gen.samples(traffic)
    return int(config['n_iter']) * (28 * bins + 8 * n) + 12 * bins + 4 * n
