"""The plain reference of the filterFFT configuration: the full linear convolution of each
signal with the taps by torch.fft in float64, cut to the signal's m samples; and its control,
the same in bfloat16, the precision below the configuration's float32.

Plain PyTorch: nothing of dsc_tpu_torch, dsc_tpu or JAX. It takes the raw inputs the
benchmark made, never what the program made from them.
"""

from __future__ import annotations

import torch


def next_pow2(n: int) -> int:
    return 1 << (n - 1).bit_length()


def _rows(raw):
    s, b = raw['signal'], raw['taps']
    m, k = s.shape[-1], b.shape[-1]
    return s.reshape(-1, m), b, m, next_pow2(m + k - 1)


def run(config, raw) -> torch.Tensor:
    """The float64 result, computed a row at a time."""
    s, b, m, n = _rows(raw)
    bs = torch.fft.rfft(b.to(torch.float64), n=n)
    out = torch.empty(s.shape, dtype=torch.float64, device=s.device)
    for i in range(s.shape[0]):
        out[i] = torch.fft.irfft(torch.fft.rfft(s[i].to(torch.float64), n=n) * bs, n=n)[:m]
    return out.reshape(raw['signal'].shape)


def _bf16(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to bfloat16 (each part of a complex value), kept in float32 for the
    arithmetic: the storage a bfloat16 pipeline has between its steps."""
    if x.is_complex():
        return torch.complex(_bf16(x.real), _bf16(x.imag))
    return x.to(torch.bfloat16).to(torch.float32)


def control(config, raw) -> torch.Tensor:
    """The reference in bfloat16: inputs, both spectra, their product and the result each
    rounded to bfloat16."""
    s, b, m, n = _rows(raw)
    bs = _bf16(torch.fft.rfft(_bf16(b.float()), n=n))
    out = torch.empty(s.shape, dtype=torch.float32, device=s.device)
    for i in range(s.shape[0]):
        xs = _bf16(torch.fft.rfft(_bf16(s[i].float()), n=n))
        out[i] = _bf16(torch.fft.irfft(_bf16(xs * bs), n=n)[:m])
    return out.reshape(raw['signal'].shape)
