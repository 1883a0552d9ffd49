"""FFT compute core: Stockham autosort + Bailey four-step in plain PyTorch
(dsc_tpu/fourier/core.py).

This is the plain path of the port: every transform the routing
(config.py) sends to 'core', and the numerics the kernels are held to.
Complex values are torch complex tensors; the JAX package's planar (re, im)
float pairs are a TPU workaround and are not carried over.

- **Stockham autosort** (iterative radix-2, natural order in and out) for
  base cases; complex64 base cases of 256..4096 points go to the base-case
  kernel K12 instead (base_fft.py), whose wrapper runs Stockham itself on
  CPU tensors;
- **Bailey four-step** (n = n1*n2: column FFTs -> twiddle -> row FFTs ->
  transpose) above 4096 points (plan.build_spec);
- inverse transforms use ifft(x) = conj(fft(conj(x)))/n.

``fft_batched``, ``rfft_batched`` and ``irfft_batched`` run the engine
config.batched_engine names: K6+K7 (stream.py) where the JAX core streams
or the caller's ``streams`` (the public API's route) says so, K12r / K12ir
(base_fft.py) where a real transform's half size is a K12 base case, else
the plain path here; the irfft's Hermitian reconstruction runs K11 where
the JAX package runs it (reconstruct.py). A transform over a non-last axis
streams as a batch, with ``movedim`` copies around the kernels. The
single-vector entries into and out of the T layout (``fft_stream_t`` and
its kin) run K6+K8 and K9+K10 (stream_t.py).
"""

from __future__ import annotations

from typing import Any, Optional, Tuple

import numpy as np
import torch

from .. import tracing
from . import config, reconstruct, stream, stream_t


def stockham_fft(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """DFT of each row of ``x`` (B, n), Stockham autosort radix-2 DIF.

    ``w`` holds the stage twiddles w[p] = exp(-2i*pi*p/n), p < n/2 (pass
    ``w.conj()`` for the unscaled inverse); the stage with current length
    ``cur`` uses w[::n//cur][:cur//2]."""
    b, n = x.shape
    cur, s = n, 1
    while cur > 1:
        m = cur // 2
        x3 = x.reshape(b, cur, s)
        a, c = x3[:, :m], x3[:, m:]
        wp = w[::s][:m].reshape(1, m, 1)
        x = torch.stack([a + c, (a - c) * wp], dim=2).reshape(b, n)
        cur, s = m, s * 2
    return x


def _base_fft(x: torch.Tensor, w: torch.Tensor, n: int) -> torch.Tensor:
    """Base-case n-point batched FFT: kernel K12 where the JAX package runs
    its Pallas base kernel, Stockham elsewhere."""
    if x.dtype == torch.complex64 and config.use_base_kernel(np.complex64, n):
        from . import base_fft

        return base_fft.fft_base(x, w)
    return stockham_fft(x, w)


def fft_apply(x: torch.Tensor, spec: Tuple, tables: Any) -> torch.Tensor:
    """Forward FFT of each row (B, n) following ``spec`` (plan.build_spec)."""
    if spec[0] == 'base':
        return _base_fft(x.contiguous(), tables, spec[1])
    _, n1, n2, s1, s2 = spec
    tt, t1, t2 = tables
    b = x.shape[0]
    # x[j] with j = n2*j1 + j2 -> columns (over j1) batched as rows
    m = x.reshape(b, n1, n2).transpose(1, 2).reshape(b * n2, n1)
    a = fft_apply(m, s1, t1).reshape(b, n2, n1)
    # inter-stage twiddle T[j2, k1] = exp(-2i*pi*k1*j2/n), then row FFTs
    a = (a * tt[None]).transpose(1, 2).reshape(b * n1, n2)
    c = fft_apply(a, s2, t2)
    # X[k1 + n1*k2] = C[k1, k2]
    return c.reshape(b, n1, n2).transpose(1, 2).reshape(b, n1 * n2)


def fft_batched(x: torch.Tensor, spec: Tuple, tables: Any, inverse: bool,
                streams: Optional[bool] = None) -> torch.Tensor:
    """(B, n) -> (B, n), forward or inverse (1/n scaled); ``streams``: run
    K6+K7 (float32 rows take K6's real-input variant), None: the core's
    rule."""
    n = x.shape[-1]
    if config.batched_engine('c2c', x.dtype, x.shape[0], n, streams) == 'stream':
        return stream.fourstep_stream(x, *stream.factors(n), inverse)
    if inverse:
        return torch.conj_physical(
            fft_apply(torch.conj_physical(x), spec, tables)) / n
    return fft_apply(x, spec, tables)


def untangle(z: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Real spectrum X (..., nh+1) from Z (..., nh), the FFT of the packed
    z[t] = x[2t] + i*x[2t+1]: X[k] = (Z[k] + conj Z[nh-k])/2
    - i*w[k]*(Z[k] - conj Z[nh-k])/2 with Z[nh] = Z[0], w[k] = W_n^k."""
    with tracing.trace_op('untangle', 'plain;fft'):
        ze = torch.cat([z, z[..., :1]], dim=-1)
        zr = ze.flip(-1).conj()
        return 0.5 * (ze + zr) - 0.5j * (w * (ze - zr))


def entangle(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Inverse of ``untangle``: Z (..., nh) from X (..., nh+1), Z[k] =
    (X[k] + conj X[nh-k])/2 + i*conj(w[k])*(X[k] - conj X[nh-k])/2, with
    w[k] = W_n^k for k < nh."""
    nh = x.shape[-1] - 1
    with tracing.trace_op('entangle', 'plain;fft'):
        f, g = x[..., :nh], x.flip(-1)[..., :nh].conj()
        return 0.5 * (f + g) + 0.5j * (w.conj() * (f - g))


def rfft_batched(x: torch.Tensor, spec: Tuple, tables: Any, n: int,
                 streams: Optional[bool] = None) -> torch.Tensor:
    """(B, n) real -> (B, n/2+1) complex.

    Streaming (``streams``, None: the core's rule): the full-size K6+K7
    transform, then the n/2+1 lower bins. Otherwise, up to
    plan.RFFT_PACK_MAX: half-size complex transform of the packed
    z[t] = x[2t] + i*x[2t+1] plus the untangling pass (reference
    dsc_real_fft, dsc_fft.h:178-238), both in K12r where the half-size
    transform is a K12 base case; above: the full-size transform."""
    nh = n // 2
    engine = config.batched_engine('r2c', x.dtype, x.shape[0], n, streams)
    if engine == 'stream':
        return stream.fourstep_stream(x, *stream.factors(n), False)[:, :nh + 1]
    w_tables, wu = tables
    if engine == 'base':
        from . import base_fft

        return base_fft.rfft_base(x.contiguous(), w_tables, wu)
    if wu is None:
        cdt = torch.complex64 if x.dtype == torch.float32 else torch.complex128
        return fft_apply(x.to(cdt), spec, w_tables)[:, :nh + 1]
    if nh == 0:
        return x.to(wu.dtype)
    b = x.shape[0]
    z = torch.view_as_complex(x.contiguous().reshape(b, nh, 2))
    return untangle(fft_apply(z, spec, w_tables), wu)


def irfft_batched(x: torch.Tensor, spec: Tuple, tables: Any, n: int,
                  streams: Optional[bool] = None) -> torch.Tensor:
    """(B, n/2+1) complex -> (B, n) real: full-spectrum reconstruction
    (K11 on a single complex64 row) + full-size inverse (large n; K6 + the
    real-output K7 when streaming, ``streams`` None: the core's rule), or
    the inverse untangle + half-size inverse (small n), both in K12ir where
    the half-size transform is a K12 base case."""
    nh = n // 2
    engine = config.batched_engine('c2r', x.dtype, x.shape[0], n, streams)
    if engine == 'stream':
        full = reconstruct.reconstruct_spectrum(x, n)
        return stream.fourstep_stream(full, *stream.factors(n), True, real_output=True)
    w_tables, wu = tables
    if engine == 'base':
        from . import base_fft

        return base_fft.irfft_base(x, w_tables, wu)
    if wu is None:
        full = reconstruct.reconstruct_spectrum(x, n)
        return fft_apply(torch.conj_physical(full), spec, w_tables).real / n
    if nh == 0:
        return x.real.contiguous()
    b = x.shape[0]
    z = entangle(x, wu[:nh])
    y = torch.conj_physical(fft_apply(torch.conj_physical(z), spec, w_tables)) / nh
    return torch.view_as_real(y.contiguous()).reshape(b, n)


def _pad_crop(x: torch.Tensor, target: int) -> torch.Tensor:
    """Crop or zero-pad the last axis to ``target`` (reference pad/crop to
    pow2, dsc.cpp:2019-2032)."""
    cur = x.shape[-1]
    if cur == target:
        return x
    if cur > target:
        return x[..., :target]
    with tracing.trace_op('pad', 'plain;fft'):
        out = x.new_zeros(*x.shape[:-1], target)
        out[..., :cur] = x
        return out


def _rows(x: torch.Tensor, axis: int, n: int):
    """Move ``axis`` last, pad/crop it to ``n``; (B, n) rows + lead shape."""
    x = _pad_crop(torch.movedim(x, axis, -1), n)
    return x.reshape(-1, n), x.shape[:-1]


def _unrows(y: torch.Tensor, lead, axis: int) -> torch.Tensor:
    y = torch.movedim(y.reshape(*lead, y.shape[-1]), -1, axis)
    if y.is_contiguous():
        return y
    with tracing.trace_op('unrows', 'plain;fft'):
        return y.contiguous()


def fft_nd(x, tables, spec, n: int, axis: int, inverse: bool, cdtype,
           streams: Optional[bool] = None) -> torch.Tensor:
    """fft/ifft over ``axis``; rows that stream keep a float32 input real
    (K6's real-input variant), the rest are cast to ``cdtype``."""
    xb, lead = _rows(x, axis, n)
    streams = config.batched_engine('c2c', xb.dtype, xb.shape[0], n, streams) == 'stream'
    if not streams:
        xb = xb.to(cdtype)
    return _unrows(fft_batched(xb, spec, tables, inverse, streams), lead, axis)


def rfft_nd(x, tables, spec, n: int, axis: int,
            streams: Optional[bool] = None) -> torch.Tensor:
    xb, lead = _rows(x, axis, n)
    return _unrows(rfft_batched(xb, spec, tables, n, streams), lead, axis)


def irfft_nd(x, tables, spec, n: int, axis: int, cdtype,
             streams: Optional[bool] = None) -> torch.Tensor:
    xb, lead = _rows(x.to(cdtype), axis, n // 2 + 1)
    return _unrows(irfft_batched(xb, spec, tables, n, streams), lead, axis)


# ---- the T / half-T layout of one vector (stream_t.py) ----------------


def fft_stream_t(x: torch.Tensor, n1: int, n2: int) -> torch.Tensor:
    """One float32 or complex64 vector, padded or cropped to n = n1*n2 ->
    its spectrum in the T layout (n1, n2): K6 + K8."""
    return stream_t.fourstep_to_t(_pad_crop(x.reshape(-1), n1 * n2), n1, n2, False)


def ifft_stream_from_t(s: torch.Tensor, n1: int, n2: int) -> torch.Tensor:
    """T-layout spectrum (n1, n2) -> the natural (n,) inverse: K9 + K10."""
    return stream_t.fourstep_from_t(s, n1, n2, False, False)


def rfft_stream_half_t(x: torch.Tensor, n1: int, n2: int) -> torch.Tensor:
    """One float32 vector, padded or cropped to n = n1*n2 -> its spectrum
    in the half-T layout (n1, n2/2 + 1): K6 (real input) + K8."""
    return stream_t.fourstep_to_t(_pad_crop(x.reshape(-1), n1 * n2), n1, n2, True)


def irfft_stream_from_half_t(s: torch.Tensor, n1: int, n2: int) -> torch.Tensor:
    """Half-T spectrum (n1, n2/2 + 1) -> the (n,) real inverse: K9 + the
    real-output K10."""
    return stream_t.fourstep_from_t(s, n1, n2, True, True)
