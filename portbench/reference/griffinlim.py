"""The plain reference of the Griffin-Lim configuration: fast Griffin-Lim (Perraudin, Balazs &
Søndergaard 2013, as librosa.griffinlim and torchaudio's GriffinLim run it) by torch.stft and
torch.istft with ``center=True`` and constant (zero) padding, the periodic Hann window, in
float64, a block of clips at a time:

    z = S * angles, bins 0 and n_fft/2 read as real
    n_iter times:  x = istft(z, length);  rebuilt = stft(x)
                   angles = rebuilt - momentum / (1 + momentum) * previous rebuilt
                   angles /= |angles| + eps;  z = S * angles
    answer: istft(z, length)

Its control is the same with each step's result rounded to bfloat16, the precision below the
configuration's float32.

Plain PyTorch: nothing of dsc_tpu_torch, dsc_tpu or JAX. It takes the raw magnitudes and
initial phasors the benchmark made, never what the program made from them.
"""

from __future__ import annotations

import math

import torch

# a float32 product on the card in float32, not TF32
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

BLOCK = 8  # clips a block


def hann_periodic(n: int, device, dtype=torch.float64) -> torch.Tensor:
    """scipy.signal.get_window('hann', n): the periodic Hann window."""
    k = torch.arange(n, dtype=torch.float64, device=device)
    return (0.5 - 0.5 * torch.cos(2 * math.pi * k / n)).to(dtype)


def _griffin_lim(config, S, angles, length: int, rnd):
    """Fast Griffin-Lim of magnitudes S (b, frames, bins) from the phasors ``angles``; ``rnd``
    rounds each step's result."""
    n_fft, hop, win = int(config['n_fft']), int(config['hop']), int(config['win_length'])
    w = rnd(hann_periodic(win, S.device, S.dtype))
    c = float(config['momentum']) / (1 + float(config['momentum']))
    eps = float(config['eps'])

    def istft(z):
        return torch.istft(z.transpose(-1, -2), n_fft, hop, win, w, center=True,
                           length=length)

    def stft(x):
        return torch.stft(x, n_fft, hop, win, w, center=True, pad_mode='constant',
                          return_complex=True).transpose(-1, -2)

    z = rnd(S * angles)
    # bins 0 and n_fft/2 are read as real, as numpy.fft.irfft reads them: cuFFT's float32
    # c2r keeps part of their imaginary parts, its float64 one and the CPU's drop them
    torch.view_as_real(z)[..., ::z.shape[-1] - 1, 1] = 0
    prev = None
    for _ in range(int(config['n_iter'])):
        rebuilt = rnd(stft(rnd(istft(z))))
        a = rebuilt if prev is None else rnd(rebuilt - c * prev)
        a = rnd(a / (a.abs() + eps))
        z = rnd(S * a)
        prev = rebuilt
    return rnd(istft(z))


def _blocks(config, raw, rnd, real, cplx):
    S, angles = raw['magnitudes'], raw['angles']
    parts = [_griffin_lim(config, S[i:i + BLOCK].to(real), angles[i:i + BLOCK].to(cplx),
                          int(raw['length']), rnd)
             for i in range(0, S.shape[0], BLOCK)]
    return torch.cat(parts)


def run(config, raw) -> torch.Tensor:
    """(clips, length) float64 audio from raw['magnitudes'] (clips, frames, bins) and the
    initial phasors raw['angles']."""
    return _blocks(config, raw, lambda t: t, torch.float64, torch.complex128)


def _bf16(x: torch.Tensor) -> torch.Tensor:
    if x.is_complex():
        return torch.complex(_bf16(x.real), _bf16(x.imag))
    return x.to(torch.bfloat16).to(torch.float32)


def control(config, raw) -> torch.Tensor:
    """The reference with the window, the product, each inverse, each spectrum, the momentum
    step and the phasors rounded to bfloat16."""
    return _blocks(config, raw, _bf16, torch.float32, torch.complex64)
