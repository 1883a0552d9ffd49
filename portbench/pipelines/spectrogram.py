"""The log-power spectrogram through dsc_tpu_torch's public API, as a user writes it:
``dsc.models.STFT(frame, hop, window, mode='log')`` over a (clips, samples) float32 batch."""

from __future__ import annotations

from typing import Any, Dict

import torch

import dsc_tpu_torch as dsc
from portbench import traffic as traffic_gen

MEM_BYTES = 64 * 2**30


def make_inputs(config, traffic, seed: int, device) -> list:
    return [{'clips': s} for s in traffic_gen.signals(traffic, seed, device)]


def setup(config, traffic, device) -> Dict[str, Any]:
    dsc.init(MEM_BYTES, device=device)
    stft = dsc.models.STFT(frame=int(config['win_length']), hop=int(config['hop']),
                           window=config['window'], mode='log',
                           log_eps=float(config['log_eps']))
    if stft.fft_n != int(config['n_fft']):
        raise ValueError(f'STFT transforms {stft.fft_n} points, the configuration '
                         f'states n_fft {config["n_fft"]}')
    return {'stft': stft}


def prepare(state, raw) -> tuple:
    return (dsc.Tensor(raw['clips']),)


def call(state, args, span):
    with span('stft'):
        return state['stft'](args[0])


def result(out) -> torch.Tensor:
    return out.torch


def teardown() -> None:
    dsc.clear()
    dsc.shutdown()


def samples(config, traffic) -> int:
    return traffic_gen.samples(traffic)


def frames(config, traffic) -> int:
    return 1 + (int(traffic['shape'][-1]) - int(config['win_length'])) // int(config['hop'])


def bytes_needed(config, traffic) -> int:
    """One public op: the clips read once, the float32 spectrogram written once."""
    rows, n = (int(s) for s in traffic['shape'])
    bins = int(config['n_fft']) // 2 + 1
    return 4 * rows * n + 4 * rows * frames(config, traffic) * bins
