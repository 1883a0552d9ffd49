"""dsc_tpu_torch: the dsc array framework on PyTorch and CUDA.

The port of dsc_tpu (JAX on a TPU) to PyTorch on an NVIDIA Hopper GPU.
Plain tensor code is PyTorch; each TPU kernel on a ported path is a CUDA
kernel written for sm_90a (csrc/), built at first use (kernels/build.py).
The device is explicit: ``init(main_mem, device='cuda')``, or
``device='cpu'`` to run every kernel's plain PyTorch version instead.

Ported so far: the context, dtypes, tracing, the Tensor with the whole
eager op set of dsc_tpu (elementwise, clip, pow, reductions, creation,
layout, indexing with write-through views) and the FFT family, whose
filterFFT path (rfft -> spectrum multiply -> irfft) runs on the card
through kernels K1-K4 and K12, whose batched, non-last-axis and fft2
transforms run the streaming four-step K6/K7 with the Hermitian
reconstruction K11, and whose single-vector transforms in the streaming
range go into and out of the T spectrum layout through K6/K8 and K9/K10
(the chirp-z transform, models.czt, rides them). Large float32 and
complex64 elementwise ops run kernel K5 (ops/stream_map.py). The fusion
tier (fuse.py): ``dsc.compile`` captures one CUDA graph per argument
signature, and ``dsc.map`` runs an elementwise function as one generated
streaming kernel, K5g (ops/map_gen.py). The window generators
(windows.py), ``profile(xprof_dir=)`` and the FilterFFT, OverlapSave and
STFT models ride them. The scipy.fft-parity tier (exact-length FFTs by
Bluestein, DCT/DST, FFTLog) is a subpackage of its own, not imported
here: ``import dsc_tpu_torch.transforms``. ROADMAP.md lists what remains.
"""

from . import models, windows
from .fuse import compile, map  # noqa: A004
from .context import clear, init, manual_seed, print_mem_usage, shutdown, used_mem
from .dtype import Dtype
from .fourier import (fft, fft2, fftfreq, ifft, ifft2, irfft, irfft2, plan_fft, rfft, rfft2,
                      rfftfreq)
from .interop import from_half_t, from_t
from .profiler import profile, start_recording, stop_recording
from .tensor import (
    Tensor,
    absolute,
    add,
    angle,
    arange,
    cast,
    clip,
    concat,
    conj,
    cos,
    empty,
    empty_like,
    exp,
    from_numpy,
    full,
    full_like,
    i0,
    imag,
    log2,
    log10,
    logn,
    max,
    mean,
    min,
    mul,
    ones,
    ones_like,
    power,
    randn,
    real,
    reshape,
    sin,
    sinc,
    sqrt,
    sub,
    sum,
    transpose,
    true_div,
    view,
    zeros,
    zeros_like,
)
from .windows import bartlett, blackman, get_window, hamming, hanning, kaiser, tukey

__version__ = '0.1.0'

__all__ = [
    'init',
    'clear',
    'shutdown',
    'used_mem',
    'print_mem_usage',
    'manual_seed',
    'compile',
    'map',
    'Tensor',
    'Dtype',
    'from_numpy',
    'from_half_t',
    'from_t',
    'reshape',
    'concat',
    'transpose',
    'view',
    'cast',
    'arange',
    'randn',
    'cos',
    'sin',
    'sinc',
    'logn',
    'log2',
    'log10',
    'exp',
    'sqrt',
    'absolute',
    'angle',
    'conj',
    'real',
    'imag',
    'add',
    'sub',
    'mul',
    'true_div',
    'sum',
    'mean',
    'max',
    'min',
    'clip',
    'power',
    'i0',
    'ones',
    'ones_like',
    'zeros',
    'zeros_like',
    'full',
    'full_like',
    'empty',
    'empty_like',
    'plan_fft',
    'fft',
    'ifft',
    'rfft',
    'irfft',
    'fft2',
    'ifft2',
    'rfft2',
    'irfft2',
    'fftfreq',
    'rfftfreq',
    'profile',
    'start_recording',
    'stop_recording',
    'models',
    'windows',
    'hanning',
    'hamming',
    'blackman',
    'kaiser',
    'bartlett',
    'tukey',
    'get_window',
]
