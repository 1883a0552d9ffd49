"""The plain reference of the log-spectrogram configuration: frames of ``win_length``
samples every ``hop``, times a symmetric Hann window (np.hanning's), the ``n_fft``-point
real DFT by torch.fft, the power, and log(power + log_eps); in float64, a block of clips at a
time. Its control is the same in bfloat16, the precision below the configuration's float32.

Plain PyTorch: nothing of dsc_tpu_torch, dsc_tpu or JAX. It takes the raw clips the
benchmark made, never what the program made from them.
"""

from __future__ import annotations

import math

import torch

BLOCK = 8  # clips a block


def hann(n: int, device) -> torch.Tensor:
    k = torch.arange(n, dtype=torch.float64, device=device)
    return 0.5 - 0.5 * torch.cos(2 * math.pi * k / (n - 1))


def _frames(config, x: torch.Tensor) -> torch.Tensor:
    frame, hop = int(config['win_length']), int(config['hop'])
    count = 1 + (x.shape[-1] - frame) // hop
    return x.unfold(-1, frame, hop)[:, :count]


def _blocks(config, raw, fn, dtype):
    x = raw['clips']
    rows = x.reshape(-1, x.shape[-1])
    parts = [fn(rows[i:i + BLOCK]) for i in range(0, rows.shape[0], BLOCK)]
    out = torch.cat(parts)
    return out.reshape(*x.shape[:-1], *out.shape[-2:]).to(dtype)


def run(config, raw) -> torch.Tensor:
    n_fft, eps = int(config['n_fft']), float(config['log_eps'])

    def block(x):
        x = x.to(torch.float64)
        f = _frames(config, x) * hann(int(config['win_length']), x.device)
        z = torch.fft.rfft(f, n=n_fft)
        return torch.log(z.real * z.real + z.imag * z.imag + eps)

    return _blocks(config, raw, block, torch.float64)


def _bf16(x: torch.Tensor) -> torch.Tensor:
    if x.is_complex():
        return torch.complex(_bf16(x.real), _bf16(x.imag))
    return x.to(torch.bfloat16).to(torch.float32)


def control(config, raw) -> torch.Tensor:
    """The reference in bfloat16: the windowed frames, the spectrum, the power and the log
    each rounded to bfloat16."""
    n_fft, eps = int(config['n_fft']), float(config['log_eps'])

    def block(x):
        w = _bf16(hann(int(config['win_length']), x.device).float())
        f = _bf16(_frames(config, _bf16(x.float())) * w)
        z = _bf16(torch.fft.rfft(f, n=n_fft))
        return _bf16(torch.log(_bf16(z.real * z.real + z.imag * z.imag) + eps))

    return _blocks(config, raw, block, torch.float32)
