"""dsc_tpu_torch.transforms: the scipy.fft-parity tier
(dsc_tpu/transforms/__init__.py).

Exact-length transforms for any n (the dsc FFT surface keeps the
reference's pad-to-pow2 identity, reference dsc.cpp:2023-2028; this tier
mirrors scipy.fft instead): the full DFT family with norms and n-D
variants, DCT/DST types 1-4, the FFTLog Hankel transform, shifts and
fast-length helpers. Powers of two ride the port's FFT core and its
kernels (K12, K6/K7, K11), every other length Bluestein (_dft.py).
``dsc_tpu_torch`` does not import this package: ``import
dsc_tpu_torch.transforms``.
"""

from .exact import (
    fft,
    fft2,
    fftfreq,
    fftn,
    fftshift,
    get_workers,
    hfft,
    hfft2,
    hfftn,
    ifft,
    ifft2,
    ifftn,
    ifftshift,
    ihfft,
    ihfft2,
    ihfftn,
    irfft,
    irfft2,
    irfftn,
    next_fast_len,
    prev_fast_len,
    rfft,
    rfft2,
    rfftfreq,
    rfftn,
    set_workers,
)
from .fftlog import fht, fhtoffset, ifht
from .trig import dct, dctn, dst, dstn, idct, idctn, idst, idstn

__all__ = [
    'fft', 'ifft', 'rfft', 'irfft', 'hfft', 'ihfft',
    'fft2', 'ifft2', 'rfft2', 'irfft2', 'hfft2', 'ihfft2',
    'fftn', 'ifftn', 'rfftn', 'irfftn', 'hfftn', 'ihfftn',
    'fftshift', 'ifftshift', 'fftfreq', 'rfftfreq',
    'next_fast_len', 'prev_fast_len',
    'dct', 'idct', 'dst', 'idst',
    'dctn', 'idctn', 'dstn', 'idstn',
    'fht', 'ifht', 'fhtoffset',
    'get_workers', 'set_workers',
]
