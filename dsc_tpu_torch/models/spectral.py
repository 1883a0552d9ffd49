"""FFT-domain signal utilities (dsc_tpu/models/spectral.py): ``resample``,
``upfirdn``, ``resample_poly``, ``hilbert``, ``hilbert2`` and ``envelope``.

Each runs as one chain of torch ops over the batched rfft/irfft of the FFT
core, a batched input as one call: at the streaming sizes a row takes
K6 + K7, and the irfft of a single complex64 row there reconstructs its
spectrum with K11 first (fourier/config.py). ``hilbert2`` composes the
public fft2/ifft2. ``envelope`` is the JAX package's parity path on
exact-length FFTs (XLA's native FFT there), here torch.fft.

``resample`` and ``hilbert`` require power-of-two lengths: the dsc FFT
rounds sizes up to the next power of two, and padding would change what
they compute, so other lengths raise.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

from .. import tracing
from ..fourier import core as fft_core
from ..fourier import plan as fft_plan
from ..tensor import Tensor
from .psd import _f32, _rows
from .stft import _device_array, _fft_convolve_rows


def _check_signal(x: Tensor, who: str) -> tuple:
    if x.n_dim > 2:
        raise RuntimeError(f'{who}: expected a 1-D or 2-D signal, got {x.n_dim}-D')
    n = x.shape[-1]
    if n < 2 or n & (n - 1):
        raise RuntimeError(
            f'{who}: length {n} is not a power of two (the dsc FFT family '
            'is power-of-two; pad/crop explicitly first)')
    return x.n_dim == 2, n


def _out(y: torch.Tensor, batched: bool) -> Tensor:
    return Tensor._from_torch(y if batched else y[0])


def _zero_stuff(x: torch.Tensor, up: int) -> torch.Tensor:
    """(b, n) -> (b, n*up) with x[:, i] at i*up and zeros between."""
    if up == 1:
        return x
    xu = x.new_zeros(x.shape[0], x.shape[1] * up)
    xu[:, ::up] = x
    return xu


def resample(x: Tensor, num: int) -> Tensor:
    """Resample a real signal to ``num`` samples by the Fourier method
    (scipy.signal.resample semantics). x: (n,) or (batch, n) float32 with n
    and num powers of two; returns (num,) / (batch, num) float32."""
    batched, n = _check_signal(x, 'resample')
    if num < 2 or num & (num - 1):
        raise RuntimeError(f'resample: num ({num}) must be a power of two >= 2')
    if x.dtype.is_complex:
        raise RuntimeError('resample expects a real signal')
    spec_in, tables_in = fft_plan.get_plan(n, 'real', torch.complex64)
    spec_out, tables_out = fft_plan.get_plan(num, 'real', torch.complex64)
    with tracing.trace_op('resample', 'op;pipeline', tracing.tensor_args(x=x)):
        z = fft_core.rfft_batched(_rows(x), spec_in, tables_in, n)
        nb = num // 2 + 1
        if num < n:
            y = z[:, :nb].clone()
            # the new Nyquist bin gathers X[num/2] and its mirror
            # X[n - num/2] = conj(X[num/2]): 2*Re
            y[:, -1] = 2.0 * z[:, num // 2].real
        elif num > n:
            y = torch.nn.functional.pad(z, (0, nb - (n // 2 + 1)))
            # the old Nyquist energy splits between bin n/2 and its new
            # mirror num - n/2; the half spectrum stores only bin n/2
            y[:, n // 2] *= 0.5
        else:
            y = z
        out = fft_core.irfft_batched(y, spec_out, tables_out, num) * _f32(num / n)
        res = _out(out, batched)
    return res


def upfirdn(h, x: Tensor, up: int = 1, down: int = 1) -> Tensor:
    """Upsample by ``up``, FIR filter with ``h``, downsample by ``down``
    (scipy.signal.upfirdn semantics, with the full-convolution output
    length ceil(((n-1)*up + len(h)) / down)), by one batched FFT
    convolution."""
    if up < 1 or down < 1:
        raise RuntimeError(f'upfirdn: up ({up}) and down ({down}) must be >= 1')
    if x.n_dim > 2:
        raise RuntimeError(f'upfirdn: expected a 1-D or 2-D signal, got {x.n_dim}-D')
    if x.dtype.is_complex:
        raise RuntimeError('upfirdn expects a real signal')
    h_np = np.asarray(h.numpy() if isinstance(h, Tensor) else h, np.float32)
    if h_np.ndim != 1 or h_np.size == 0:
        raise RuntimeError('upfirdn: h must be a nonempty 1-D filter')
    n = x.shape[-1]
    full = (n - 1) * up + len(h_np)
    n_out = -(-full // down)
    fft_n = fft_plan.next_pow2(full)
    data = _rows(x)
    with tracing.trace_op('upfirdn', 'op;pipeline', tracing.tensor_args(x=x)):
        xu = _zero_stuff(data, int(up))[:, :(n - 1) * up + 1]
        conv = _fft_convolve_rows(xu, _device_array(h_np[None, :], data), fft_n)
        res = _out(conv[:, :(n_out - 1) * down + 1:down], x.n_dim == 2)
    return res


def resample_poly(x: Tensor, up: int, down: int, window=('kaiser', 5.0)) -> Tensor:
    """Polyphase rational-rate resampling (scipy.signal.resample_poly
    semantics): upsample by ``up``, apply a zero-phase kaiser-windowed
    anti-alias FIR (:func:`~dsc_tpu_torch.models.firwin` at cutoff
    1/max(up, down)), downsample by ``down``, as one batched FFT
    convolution padded to the next power of two. x: (n,) or (batch, n)
    real; returns ceil(n*up/down) samples."""
    if up < 1 or down < 1:
        raise RuntimeError(f'resample_poly: up ({up}) and down ({down}) must be >= 1')
    if x.n_dim > 2:
        raise RuntimeError(f'resample_poly: expected a 1-D or 2-D signal, got {x.n_dim}-D')
    if x.dtype.is_complex:
        raise RuntimeError('resample_poly expects a real signal')
    g = math.gcd(int(up), int(down))
    up, down = int(up) // g, int(down) // g
    if up == 1 and down == 1:
        return x
    from ..dtype import Dtype
    from .fir import firwin

    n = x.shape[-1]
    max_rate = max(up, down)
    data = _rows(x)
    if isinstance(window, (str, tuple)) or window is None:
        hl = 10 * max_rate
        h64 = firwin(2 * hl + 1, 1.0 / max_rate, window=window, dtype=Dtype.F64)
        h = (h64 * float(up)).cast(Dtype.F32).torch
    else:
        # explicit FIR taps (scipy's array-window semantics): the window is
        # the anti-alias filter, scaled by the upsampling gain
        taps = np.asarray(window.numpy() if isinstance(window, Tensor) else window,
                          np.float64) * float(up)
        if taps.ndim != 1 or taps.size < 1:
            raise RuntimeError('resample_poly: window taps must be 1-D')
        hl = (taps.size - 1) // 2
        h = torch.from_numpy(taps.astype(np.float32)).to(data.device)
    n_out = -(-n * up // down)
    fft_n = fft_plan.next_pow2(n * up + 2 * hl)
    with tracing.trace_op('resample_poly', 'op;pipeline', tracing.tensor_args(x=x)):
        conv = _fft_convolve_rows(_zero_stuff(data, up), h[None, :], fft_n)
        res = _out(conv[:, hl:hl + (n_out - 1) * down + 1:down], x.n_dim == 2)
    return res


def hilbert(x: Tensor) -> Tensor:
    """Analytic signal x + i*HT(x) (scipy.signal.hilbert semantics).
    x: (n,) or (batch, n) float32, n a power of two; returns a complex64
    Tensor of the same shape whose real part is the input. HT(x) is the
    irfft of -i*sign(k)*X, on the half spectrum (Im X, -Re X) with DC and
    Nyquist zeroed."""
    batched, n = _check_signal(x, 'hilbert')
    if x.dtype.is_complex:
        raise RuntimeError('hilbert expects a real signal')
    spec, tables = fft_plan.get_plan(n, 'real', torch.complex64)
    data = _rows(x)
    with tracing.trace_op('hilbert', 'op;pipeline', tracing.tensor_args(x=x)):
        z = fft_core.rfft_batched(data, spec, tables, n)
        hz = torch.complex(z.imag, -z.real)
        hz[:, 0] = 0
        hz[:, -1] = 0
        ht = fft_core.irfft_batched(hz, spec, tables, n)
        res = _out(torch.complex(data, ht), batched)
    return res


def hilbert2(x: Tensor) -> Tensor:
    """2-D analytic signal (scipy.signal.hilbert2 semantics):
    ifft2(fft2(x) * h_m x h_n) with the 1-D analytic step vectors
    h = [1, 2...2, 0...0] on each axis, composed from the public fft2/ifft2.
    x: (m, n) real with power-of-two sides; returns a complex64 Tensor."""
    from ..fourier import fft2, ifft2
    from ..tensor import from_numpy, mul

    if x.n_dim != 2:
        raise RuntimeError(f'hilbert2: expected a 2-D signal, got {x.n_dim}-D')
    if x.dtype.is_complex:
        raise RuntimeError('hilbert2 expects a real signal')
    m, n = x.shape
    if m & (m - 1) or n & (n - 1) or m < 2 or n < 2:
        raise RuntimeError(f'hilbert2: shape {x.shape} must have power-of-two sides')

    def steps(sz):
        # 1 + sign with the sign +1 on positive bins, -1 on negative bins
        # and Nyquist (scipy >= 1.17's single-orthant convention)
        h = np.zeros(sz, np.float32)
        h[0] = 1.0
        h[1:sz // 2] = 2.0
        return h

    mask = from_numpy(np.outer(steps(m), steps(n)))
    with tracing.trace_op('hilbert2', 'op;pipeline', tracing.tensor_args(x=x)):
        out = ifft2(mul(fft2(x), mask))
    return out


def _envelope_program(x, n, n_out, b0, b1, squared, residual):
    """(dsc_tpu/models/spectral.py:305-357) on torch.fft."""
    fak = n_out / n
    zf = torch.fft.rfft(x)  # (b, n//2+1)
    nb = n // 2 + 1
    full = x.new_zeros(x.shape[0], n, dtype=zf.dtype)
    full[:, :nb] = zf
    if b0 > 0:
        full[:, b0:b1] *= 2.0
    elif b1 > 0:
        full[:, 1:b1] *= 2.0
    if not b0 <= 0 < b1:
        zbb = torch.fft.ifft(full[:, b0:b1], n=n_out, dim=-1) * fak
    else:
        shifted = torch.fft.fftshift(full, dim=-1)
        zbb = torch.fft.ifft(shifted[:, b0 + n // 2:b1 + n // 2], n=n_out, dim=-1) * fak
    env = zbb.real ** 2 + zbb.imag ** 2 if squared else zbb.abs()
    if residual is None:
        return env, None
    if not b0 <= 0 < b1:
        full[:, b0:b1] = 0.0
    else:
        full[:, :b1] = 0.0
        full[:, b0:] = 0.0
    if residual == 'lowpass':
        if b1 > 0:
            full[:, b1:(n + 1) // 2] = 0.0
        else:
            full[:, b0:] = 0.0
            full[:, 0:(n + 1) // 2] = 0.0
    m = min(n, n_out)
    zc = full[:, :n_out // 2 + 1]
    if n_out != n and m % 2 == 0:
        zc = zc.clone()
        zc[:, m // 2] *= 2.0 if n_out < n else 0.5
    res = fak * torch.fft.irfft(zc, n=n_out, dim=-1)
    return env, res


def envelope(z: Tensor, bp_in=(1, None), n_out: Optional[int] = None, squared: bool = False,
             residual: str = 'lowpass'):
    """Envelope and residual of a real signal (scipy.signal.envelope
    semantics): band-limit to the ``bp_in`` bin range, take the
    analytic-signal magnitude (optionally squared, optionally resampled to
    ``n_out``), and return the out-of-band ``residual`` ('lowpass' | 'all' |
    None). z: (n,) or (batch, n) real. Returns a stacked (2, ...) Tensor of
    (envelope, residual), or the envelope alone when ``residual=None``.
    Exact-length FFTs (torch.fft, as the JAX package uses XLA's): a parity
    path, not a hot path."""
    if z.dtype.is_complex:
        raise RuntimeError('envelope: complex input not supported (the real rfft '
                           'construction)')
    if z.n_dim > 2:
        raise RuntimeError(f'envelope: expected 1-D or 2-D, got {z.n_dim}-D')
    if residual not in ('lowpass', 'all', None):
        raise RuntimeError(f'envelope: unknown residual {residual!r}')
    if len(bp_in) != 2:
        raise RuntimeError('envelope: bp_in must be a 2-tuple')
    n = z.shape[-1]
    n_out = n if n_out is None else int(n_out)
    b0 = bp_in[0] if bp_in[0] is not None else -(n // 2)
    b1 = bp_in[1] if bp_in[1] is not None else (n + 1) // 2
    if not -(n // 2) <= b0 < b1 <= (n + 1) // 2:
        raise RuntimeError(f'envelope: invalid bp_in {bp_in} for n={n}')
    batched = z.n_dim == 2
    with tracing.trace_op('envelope', 'op;pipeline', tracing.tensor_args(x=z)):
        env, res = _envelope_program(_rows(z), n, n_out, int(b0), int(b1), bool(squared),
                                     residual)
        if res is None:
            out = _out(env, batched)
        else:
            both = torch.stack([env, res])
            out = Tensor._from_torch(both if batched else both[:, 0, :])
    return out
