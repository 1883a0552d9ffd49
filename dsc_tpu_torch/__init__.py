"""dsc_tpu_torch: the dsc array framework on PyTorch and CUDA.

The port of dsc_tpu (JAX on a TPU) to PyTorch on an NVIDIA Hopper GPU.
Plain tensor code is PyTorch; each TPU kernel on a ported path is a CUDA
kernel written for sm_90a (csrc/), built at first use (kernels/build.py).
The device is explicit: ``init(main_mem, device='cuda')``, or
``device='cpu'`` to run every kernel's plain PyTorch version instead.

Ported so far: the context, dtypes, tracing, a Tensor subset (creation,
reshape, basic slicing, add/sub/mul/true_div) and the FFT family, whose
filterFFT path (rfft -> spectrum multiply -> irfft) runs on the card
through kernels K1-K4 and K12. ROADMAP.md lists what remains.
"""

from . import models
from .context import clear, init, manual_seed, print_mem_usage, shutdown, used_mem
from .dtype import Dtype
from .fourier import fft, fftfreq, ifft, irfft, plan_fft, rfft, rfftfreq
from .interop import from_half_t
from .profiler import profile, start_recording, stop_recording
from .tensor import Tensor, add, from_numpy, mul, randn, reshape, sub, true_div

__version__ = '0.1.0'

__all__ = [
    'init',
    'clear',
    'shutdown',
    'used_mem',
    'print_mem_usage',
    'manual_seed',
    'Tensor',
    'Dtype',
    'from_numpy',
    'from_half_t',
    'reshape',
    'randn',
    'add',
    'sub',
    'mul',
    'true_div',
    'plan_fft',
    'fft',
    'ifft',
    'rfft',
    'irfft',
    'fftfreq',
    'rfftfreq',
    'profile',
    'start_recording',
    'stop_recording',
    'models',
]
