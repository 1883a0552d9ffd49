"""The one generator of the benchmark's signals: a traffic file's parameters and a seed in,
the pool of float32 signals out, made on the device in a few large calls.

A traffic file (workloads/<cell>.json) gives:

- ``shape``: one signal's shape, ``[samples]`` or ``[rows, samples]``;
- ``pool``: how many signals the loop cycles through (4 or more, so that the card's 50 MB L2
  holds none of them when its turn comes again);
- ``sample_rate_hz``, ``tones`` (sinusoids a row), ``tone_hz`` ([lowest, highest]),
  ``noise_rms``: each row is white noise plus ``tones`` sinusoids of random frequency,
  amplitude (up to 1) and phase;
- ``valid_s`` (optional, [shortest, longest]): a row holds that many seconds of signal and
  zeros after it, as a loader pads a batch of clips to its longest. The lengths are the same
  evenly spaced set for every seed, in an order the seed draws, so that every seed gives the
  same amount of signal.

The same seed gives the same signals on the same device.
"""

from __future__ import annotations

import math
from typing import Any, Dict, List

import torch


def generator(seed: int, device) -> torch.Generator:
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % 2**64)
    return gen


def signals(traffic: Dict[str, Any], seed: int, device) -> List[torch.Tensor]:
    shape = [int(s) for s in traffic['shape']]
    rows, n = (1, shape[0]) if len(shape) == 1 else shape
    fs = float(traffic['sample_rate_hz'])
    lo_hz, hi_hz = traffic['tone_hz']
    gen = generator(seed, device)
    t = torch.arange(n, dtype=torch.float64, device=device) / fs
    out = []
    for _ in range(int(traffic['pool'])):
        x = torch.randn(rows, n, generator=gen, device=device, dtype=torch.float64)
        x *= float(traffic['noise_rms'])
        k = int(traffic['tones'])
        hz = lo_hz + (hi_hz - lo_hz) * torch.rand(rows, k, 1, generator=gen, device=device,
                                                  dtype=torch.float64)
        amp = torch.rand(rows, k, 1, generator=gen, device=device, dtype=torch.float64)
        phase = 2 * math.pi * torch.rand(rows, k, 1, generator=gen, device=device,
                                         dtype=torch.float64)
        for j in range(k):
            x += amp[:, j] * torch.sin(2 * math.pi * hz[:, j] * t + phase[:, j])
        if 'valid_s' in traffic:
            lo_s, hi_s = traffic['valid_s']
            lengths = torch.linspace(lo_s * fs, hi_s * fs, rows, dtype=torch.float64,
                                     device=device).round().long().clamp(max=n)
            lengths = lengths[torch.randperm(rows, generator=gen, device=device)]
            keep = torch.arange(n, device=device)[None, :] < lengths[:, None]
            x *= keep
        out.append(x.to(torch.float32).reshape(shape).contiguous())
    return out


def samples(traffic: Dict[str, Any]) -> int:
    """Input samples in one call."""
    return math.prod(int(s) for s in traffic['shape'])
