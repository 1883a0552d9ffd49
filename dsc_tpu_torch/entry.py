"""The flagship step of the port (__graft_entry__.entry of the JAX
package): the README filterFFT pipeline at 2^20 samples and 4097 Blackman
taps (BASELINE.json config 1), n = 2^21, as one ``dsc.compile`` program.

    fn, args = entry()
    out = fn(*args)     # (2^20 + 4096,) float32

The step takes the signal and the taps and computes both spectra, the
product and the inverse, as the JAX entry's step does; on a CUDA context
its calls replay one captured graph of K1-K4 (twice K1+K2, K5, K3+K4).
It runs on the context's device: the card unless ``init(device='cpu')``.

``dryrun_multichip(n_devices)`` (__graft_entry__.dryrun_multichip) runs
one step of each leg of the sharded tier over an n_devices ('data',
'model') mesh, each held to np.fft: the cards where there are n_devices,
else a virtual mesh of n_devices entries of cuda:0, or of the CPU with
``device='cpu'``.
"""

from __future__ import annotations

import numpy as np

from .fourier import irfft, rfft
from .fourier.plan import next_pow2
from .fuse import compile as _compile
from .tensor import Tensor, from_numpy, mul

# vs np.fft in float64, relative to max(1, max |ref|) (the irfft: absolute)
DRYRUN_BOUND = 1e-4


def entry(n: int = 2**20, taps: int = 4097):
    """(fn, example_args): the compiled filterFFT step over ``n`` samples
    and ``taps`` Blackman taps, and its arguments (a seeded normal signal,
    the taps)."""
    fft_n = next_pow2(n + taps - 1)
    out_len = n + taps - 1

    @_compile
    def filter_fft_step(signal: Tensor, kernel: Tensor) -> Tensor:
        spec = mul(rfft(signal, n=fft_n), rfft(kernel, n=fft_n))
        return irfft(spec)[:out_len]

    sig = from_numpy(np.random.default_rng(0).standard_normal(n).astype(np.float32))
    ker = from_numpy(np.blackman(taps).astype(np.float32))
    return filter_fft_step, (sig, ker)


def _check(what: str, got, ref, relative: bool = True) -> float:
    err = float(np.abs(np.asarray(got) - ref).max())
    if relative:
        err /= max(float(np.abs(ref).max()), 1.0)
    if err > DRYRUN_BOUND:
        raise RuntimeError(f'{what} mismatch: {err}')
    return err


def dryrun_multichip(n_devices: int = 8, device: str = 'cuda') -> None:
    """One step of the sharded tier over an n_devices mesh, each leg held
    to np.fft in float64 within DRYRUN_BOUND: the DP leg (a batch-sharded
    STFT power), the transform-sharded leg on a 'model' axis of 2
    (distributed_fft at 1024 points, distributed_fft_stream and the
    distributed rfft -> irfft pair at 2^20) and the model=4 leg
    (distributed_fft at 4096, distributed_rfft_stream at 2^21). On fewer
    cards than n_devices the mesh repeats cuda:0; ``device='cpu'`` builds
    it of the CPU. The mesh-compiled legs of the JAX entry
    (dsc.compile(mesh=...)) are not here."""
    import torch

    from .parallel import (distributed_fft, distributed_fft_stream, distributed_irfft_stream,
                           distributed_rfft_stream, make_mesh, sharded_batched_rfft)

    if device == 'cpu':
        devs = [torch.device('cpu')] * n_devices
    elif not torch.cuda.is_available():
        raise RuntimeError('dryrun_multichip: no CUDA device (device="cpu" runs it on the CPU)')
    elif torch.cuda.device_count() >= n_devices:
        devs = [torch.device('cuda', i) for i in range(n_devices)]
    else:
        devs = [torch.device('cuda', 0)] * n_devices
    model = 2 if n_devices % 2 == 0 else 1
    mesh = make_mesh((n_devices // model, model), devices=devs)

    # --- DP leg: batch-sharded STFT power (tiny shapes) ---------------------
    batch = mesh.shape['data'] * 2
    frame, sig_len = 64, 256
    x = np.random.default_rng(1).standard_normal((batch, sig_len)).astype(np.float32)
    frames = x.reshape(-1, frame)
    z = np.asarray(sharded_batched_rfft(frames, mesh, 'data'))
    power = np.log(np.abs(z) ** 2 + 1e-10)
    ref = np.log(np.abs(np.fft.rfft(frames.astype(np.float64), axis=-1)) ** 2 + 1e-10)
    _check('DP STFT power', power, ref)

    # --- transform-sharded leg on 'model' -----------------------------------
    if model > 1:
        n = 1024  # n1 = n2 = 32, divisible by the model axis
        c = (np.random.default_rng(2).standard_normal((2, n))
             + 1j * np.random.default_rng(3).standard_normal((2, n))).astype(np.complex64)
        _check('distributed fft', distributed_fft(c, mesh, axis='model'),
               np.fft.fft(c.astype(np.complex128), axis=-1))
        ns = 2**20
        cs = (np.random.default_rng(6).standard_normal(ns)
              + 1j * np.random.default_rng(7).standard_normal(ns)).astype(np.complex64)
        _check('distributed STREAM fft', distributed_fft_stream(cs, mesh, axis='model'),
               np.fft.fft(cs.astype(np.complex128)))
        xr = np.random.default_rng(8).standard_normal(ns).astype(np.float32)
        rr = np.fft.rfft(xr.astype(np.float64))
        _check('distributed STREAM rfft', distributed_rfft_stream(xr, mesh, axis='model'), rr)
        _check('distributed STREAM irfft',
               distributed_irfft_stream(rr.astype(np.complex64), mesh, axis='model'), xr,
               relative=False)

    # --- model=4 leg: 4-way transform sharding on a reshaped mesh ------------
    if n_devices % 4 == 0:
        mesh4 = make_mesh((n_devices // 4, 4), devices=devs)
        n4 = 4096  # n1 = n2 = 64, divisible by 4
        c4 = (np.random.default_rng(11).standard_normal((2, n4))
              + 1j * np.random.default_rng(12).standard_normal((2, n4))).astype(np.complex64)
        _check('model=4 distributed fft', distributed_fft(c4, mesh4, axis='model'),
               np.fft.fft(c4.astype(np.complex128), axis=-1))
        nr4 = 2**21  # half-size factors 1024 x 1024, divisible by 4
        x4 = np.random.default_rng(13).standard_normal(nr4).astype(np.float32)
        _check('model=4 STREAM rfft', distributed_rfft_stream(x4, mesh4, axis='model'),
               np.fft.rfft(x4.astype(np.float64)))
    print(f'dryrun_multichip OK: mesh={dict(mesh.shape)} devices={sorted(set(map(str, devs)))}')
