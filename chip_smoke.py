"""On-GPU smoke test of the dsc_tpu_torch port: the filterFFT main path
(rfft -> spectrum multiply -> irfft) on one CUDA card.

    python3 chip_smoke.py

Phases, each raising on failure (exit code 0 means all passed):

1. the card's name and power limit (nvidia-smi), torch and CUDA versions;
2. build the CUDA kernels from dsc_tpu_torch/csrc (nvcc, sm_90a) and
   init the port on the card;
3. each kernel against its plain PyTorch version on the same inputs on
   the card (K12 base FFT; packed rfft K1, K2 and irfft K3, K4 phase by
   phase at 2^21 and 2^24), and the rfft against np.fft in float64;
4. the public API at full size: the README quick start (2^20 samples,
   255 taps, n = 2^21) and the 4097-tap shape, against np.convolve in
   float64, a 2^24 rfft -> irfft round trip and an n = 4096 rfft/irfft
   pair; every kernel's launch count must rise in this phase, and the
   quick start runs once under dsc.profile;
5. CUDA-event timings (median of 25 runs after warm-up) of each kernel and
   its plain version, and of the whole filterFFT step.

The last lines are the kernels' JSON record, the card line and the result
line. Without a CUDA device the script exits non-zero before any of them.

    python3 chip_smoke.py --profile

runs phases 1-2 and then, in place of the checks, measures where the
filterFFT step's time goes: the device-to-device copy rate (the ceiling the
kernels' bytes are held to), the step on CUDA events and on the host clock
over five repeats in one process, K1 timed one launch at a time and 200
launches back to back, and torch.profiler's device time per kernel and the
device's busy share of the step.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.abspath(__file__))
REL_BOUND = 3e-5        # kernel vs plain version, relative to max |plain|
NUMPY_BOUND = 1e-4      # vs np.fft / np.convolve in float64 (BASELINE.md)
RUNS = 25
WARMUP_S = 0.25
STEP_N = 2**21          # the README quick start: 2^20 samples, n = 2^21

KERNELS = {  # name -> (source, TPU kernel it replaces)
    'rfft_phase_a': ('dsc_tpu_torch/csrc/packed_rfft.cu',
                     'dsc_tpu/fourier/packed_fused.py:122'),
    'rfft_phase_b': ('dsc_tpu_torch/csrc/packed_rfft.cu',
                     'dsc_tpu/fourier/packed_fused.py:248'),
    'irfft_phase_a': ('dsc_tpu_torch/csrc/packed_rfft.cu',
                      'dsc_tpu/fourier/packed_fused.py:487'),
    'irfft_phase_b': ('dsc_tpu_torch/csrc/packed_rfft.cu',
                      'dsc_tpu/fourier/packed_fused.py:721'),
    'base_fft': ('dsc_tpu_torch/csrc/base_fft.cu',
                 'dsc_tpu/fourier/pallas_kernels.py:55'),
}


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(msg)


def rel_err(got: torch.Tensor, ref: torch.Tensor) -> float:
    require(got.shape == ref.shape and got.dtype == ref.dtype,
            f'shape/dtype {tuple(got.shape)} {got.dtype} != '
            f'{tuple(ref.shape)} {ref.dtype}')
    return float((got - ref).abs().max() / ref.abs().max())


def card_line() -> str:
    out = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit', '--format=csv,noheader'],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, runs: int = RUNS) -> float:
    """Median device time of one call of ``fn`` over ``runs`` calls, each
    bracketed by CUDA events, after WARMUP_S seconds of warm-up calls (the
    first tens of filterFFT steps in a process read up to 1.6x slower)."""
    stop = time.perf_counter() + WARMUP_S
    while time.perf_counter() < stop:
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def host_ms(fn, runs: int = RUNS) -> float:
    """Median host-clock time of one call of ``fn`` followed by a
    synchronize, after WARMUP_S seconds of warm-up calls."""
    stop = time.perf_counter() + WARMUP_S
    while time.perf_counter() < stop:
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t0))
    return float(np.median(times))


def back_to_back_ms(fn, runs: int = 200) -> float:
    """Time of one call of ``fn`` when ``runs`` calls run between two CUDA
    events, so that launch latency hides behind the previous call."""
    cuda_ms(fn, runs=1)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(runs):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / runs


def filter_fft(dsc, sig, taps, n_taps: int):
    """The README quick start through the public API: full convolution of
    ``sig`` with ``taps`` by rfft -> spectrum multiply -> irfft at STEP_N."""
    spec = dsc.rfft(sig, n=STEP_N) * dsc.rfft(taps, n=STEP_N)
    return dsc.irfft(spec)[: sig.shape[0] + n_taps - 1]


def profile_step(dsc, card: str) -> None:
    """--profile: where the filterFFT step's time goes on the card."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from dsc_tpu_torch.fourier import packed_fused as pf, plan

    gen = np.random.default_rng(0)
    src = torch.empty(2**26, dtype=torch.float32, device='cuda')
    dst = torch.empty_like(src)
    ms = cuda_ms(lambda: dst.copy_(src))
    print(f'copy 256 MiB device to device: {ms:.4f} ms, '
          f'{2 * 2**28 / ms / 1e6:.1f} GB/s read+write [{card}]')
    del src, dst

    sig = dsc.from_numpy(gen.standard_normal(2**20).astype(np.float32))
    taps = dsc.from_numpy(np.blackman(255).astype(np.float32))

    def step():
        return filter_fft(dsc, sig, taps, 255)

    t = plan.get_plan(STEP_N, 'packed', torch.complex64)[1]
    x = torch.from_numpy(gen.standard_normal(STEP_N).astype(np.float32)).cuda()

    def k1():
        return pf.rfft_phase_a(x, t)

    print('filterFFT step, 2^20 x 255 taps, n=2^21, public API:')
    for rep in range(5):
        print(f'  repeat {rep}: CUDA events {cuda_ms(step):.4f} ms, host clock + '
              f'synchronize {host_ms(step):.4f} ms; K1 one launch {cuda_ms(k1):.4f} ms, '
              f'back to back {back_to_back_ms(k1):.4f} ms [{card}]')

    steps = 20
    wall = host_ms(step)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            step()
        torch.cuda.synchronize()
    rows = sorted(((e.self_device_time_total / steps / 1e3, e.count // steps, e.key)
                   for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0),
                  reverse=True)
    print(f'torch.profiler, {steps} steps, device time per step [{card}]:')
    for dev_ms, count, key in rows:
        print(f'  {dev_ms:9.4f} ms  x{count:<3d} {key[:100]}')
    busy = sum(r[0] for r in rows)
    if busy:
        print(f'  all device work {busy:.4f} ms of a {wall:.4f} ms step (host clock + '
              f'synchronize): busy share {busy / wall:.3f} [{card}]')
    else:
        print('  torch.profiler recorded no device time: busy share not measured')


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    parser.add_argument('--profile', action='store_true',
                        help='measure where the filterFFT step time goes '
                             'in place of the checks')
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print('chip_smoke: no CUDA device', file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    import dsc_tpu_torch as dsc
    from dsc_tpu_torch.fourier import base_fft, packed_fused as pf, plan
    from dsc_tpu_torch.fourier.stream import factors
    from dsc_tpu_torch.kernels import build

    # -- 1. the card -------------------------------------------------------
    card = card_line()
    print(f'card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}, '
          f'{torch.cuda.get_device_name(0)} x {torch.cuda.device_count()}')

    # -- 2. build + init ---------------------------------------------------
    t0 = time.time()
    log = build.build(extra_flags=('-Xptxas', '-v'))
    build.load()
    print(f'build: {time.time() - t0:.1f} s ({build.LIB_PATH})')
    for line in log.splitlines():
        if 'registers' in line or 'spill' in line:
            print(f'  ptxas: {line.strip()}')
    dsc.init(2**34, device='cuda')
    if args.profile:
        profile_step(dsc, card)
        return 0
    dev = torch.device('cuda')
    gen = np.random.default_rng(0)
    errs = dict.fromkeys(KERNELS, 0.0)

    def compare(name, got, ref, what):
        e = rel_err(got, ref)
        errs[name] = max(errs[name], float((got - ref).abs().max()))
        print(f'  {name:14s} {what}: rel err {e:.3e}')
        require(e <= REL_BOUND, f'{name} {what}: {e} > {REL_BOUND}')

    # -- 3. kernels vs plain versions --------------------------------------
    print('phase 3: kernels vs plain versions')
    for n in (256, 512, 2048, 4096):
        w = plan.get_plan(n, 'complex', torch.complex64)[1]
        for batch in (1, 128, 1000):
            x = torch.from_numpy(
                (gen.standard_normal((batch, n)) + 1j * gen.standard_normal((batch, n)))
                .astype(np.complex64)).to(dev)
            compare('base_fft', base_fft.fft_base(x, w),
                    base_fft.fft_base_plain(x, w), f'n={n} batch={batch}')
    for n in (2**21, 2**24):
        t = plan.get_plan(n, 'packed', torch.complex64)[1]
        x_np = gen.standard_normal(n).astype(np.float32)
        x = torch.from_numpy(x_np).to(dev)
        at = pf.rfft_phase_a(x, t)
        compare('rfft_phase_a', at, pf.rfft_phase_a_plain(x, t), f'n=2^{n.bit_length() - 1}')
        spec = pf.rfft_phase_b(at, t)
        compare('rfft_phase_b', spec, pf.rfft_phase_b_plain(at, t),
                f'n=2^{n.bit_length() - 1}')
        ref = np.fft.rfft(x_np.astype(np.float64))
        e = float(np.abs(spec.cpu().numpy() - ref).max() / np.abs(ref).max())
        print(f'  rfft K1+K2 vs np.fft float64 n=2^{n.bit_length() - 1}: {e:.3e}')
        require(e <= NUMPY_BOUND, f'rfft vs np.fft: {e}')
        y = pf.irfft_phase_a(spec, t)
        compare('irfft_phase_a', y, pf.irfft_phase_a_plain(spec, t),
                f'n=2^{n.bit_length() - 1}')
        back = pf.irfft_phase_b(y, t)
        compare('irfft_phase_b', back, pf.irfft_phase_b_plain(y, t),
                f'n=2^{n.bit_length() - 1}')
        e = float((back - x).abs().max())
        print(f'  irfft(rfft(x)) - x, max abs: {e:.3e}')
        require(e <= 2e-4, f'round trip {e}')
    torch.cuda.synchronize()

    # -- 4. the public path at full size -----------------------------------
    print('phase 4: public API, full size')
    sig_np = gen.standard_normal(2**20).astype(np.float32)
    build.reset_launches()
    sig = dsc.from_numpy(sig_np)
    for n_taps in (255, 4097):
        taps_np = np.blackman(n_taps).astype(np.float32)
        got = filter_fft(dsc, sig, dsc.from_numpy(taps_np), n_taps)
        ref = np.convolve(sig_np.astype(np.float64), taps_np.astype(np.float64))
        require(got.shape == ref.shape and got.numpy().dtype == np.float32,
                f'filterFFT shape {got.shape} dtype {got.dtype}')
        out = got.numpy()
        require(bool(np.isfinite(out).all()), 'filterFFT output not finite')
        e = float(np.abs(out - ref).max() / np.abs(ref).max())
        print(f'  filterFFT 2^20 x {n_taps} taps vs np.convolve float64: {e:.3e}')
        require(e <= NUMPY_BOUND, f'filterFFT {n_taps} taps: {e}')
    big_np = gen.standard_normal(2**24).astype(np.float32)
    big = dsc.from_numpy(big_np)
    spec = dsc.rfft(big)
    require(spec.shape == (2**23 + 1,), f'rfft shape {spec.shape}')
    ref = np.fft.rfft(big_np.astype(np.float64))
    e = float(np.abs(spec.numpy() - ref).max() / np.abs(ref).max())
    print(f'  dsc.rfft 2^24 vs np.fft float64: {e:.3e}')
    require(e <= NUMPY_BOUND, f'rfft 2^24: {e}')
    back = dsc.irfft(spec).numpy()
    e = float(np.abs(back - big_np).max())
    print(f'  dsc.irfft(dsc.rfft(x)) 2^24, max abs err: {e:.3e}')
    require(back.shape == big_np.shape and e <= 2e-4, f'round trip 2^24: {e}')
    small_np = gen.standard_normal(4096).astype(np.float32)
    s_spec = dsc.rfft(dsc.from_numpy(small_np))
    ref = np.fft.rfft(small_np.astype(np.float64))
    e = float(np.abs(s_spec.numpy() - ref).max() / np.abs(ref).max())
    e2 = float(np.abs(dsc.irfft(s_spec).numpy() - small_np).max())
    print(f'  rfft/irfft n=4096 (K12 base cases): {e:.3e}, round trip {e2:.3e}')
    require(e <= NUMPY_BOUND and e2 <= 1e-5, 'n=4096 pair')
    torch.cuda.synchronize()
    launches = dict(build.launches)
    print(f'  launches on the public path: {launches}')
    for name in KERNELS:
        require(launches[name] > 0, f'kernel {name} was not launched on the public path')

    trace = os.path.join(REPO, 'build', 'chip_smoke_traces.json')
    os.makedirs(os.path.dirname(trace), exist_ok=True)
    with dsc.profile(trace, serve=False):
        filter_fft(dsc, sig, dsc.from_numpy(np.blackman(255).astype(np.float32)), 255)
    with open(trace) as f:
        names = {ev['name'] for ev in json.load(f)['traceEvents']}
    print(f'  trace events: {sorted(names)}')
    require({'rfft', 'mul', 'irfft', 'get'} <= names, f'trace events {names}')

    # -- 5. timings --------------------------------------------------------
    print(f'phase 5: timings, CUDA events, median of {RUNS} [{card}]')
    timings = {}

    def time_pair(name, kernel_fn, plain_fn, what):
        ms, plain_ms = cuda_ms(kernel_fn), cuda_ms(plain_fn)
        print(f'  {name:14s} {what}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms [{card}]')
        return ms, plain_ms

    for n in (2**21, 2**24):
        t = plan.get_plan(n, 'packed', torch.complex64)[1]
        x = torch.from_numpy(gen.standard_normal(n).astype(np.float32)).to(dev)
        at = pf.rfft_phase_a(x, t)
        spec = pf.rfft_phase_b(at, t)
        y = pf.irfft_phase_a(spec, t)
        what = f'n=2^{n.bit_length() - 1} {factors(n)}'
        res = {
            'rfft_phase_a': time_pair('rfft_phase_a', lambda: pf.rfft_phase_a(x, t),
                                      lambda: pf.rfft_phase_a_plain(x, t), what),
            'rfft_phase_b': time_pair('rfft_phase_b', lambda: pf.rfft_phase_b(at, t),
                                      lambda: pf.rfft_phase_b_plain(at, t), what),
            'irfft_phase_a': time_pair('irfft_phase_a', lambda: pf.irfft_phase_a(spec, t),
                                       lambda: pf.irfft_phase_a_plain(spec, t), what),
            'irfft_phase_b': time_pair('irfft_phase_b', lambda: pf.irfft_phase_b(y, t),
                                       lambda: pf.irfft_phase_b_plain(y, t), what),
        }
        if n == 2**21:
            timings.update(res)
    for n, batch in ((2048, 1), (4096, 1000)):
        w = plan.get_plan(n, 'complex', torch.complex64)[1]
        x = torch.from_numpy(
            (gen.standard_normal((batch, n)) + 1j * gen.standard_normal((batch, n)))
            .astype(np.complex64)).to(dev)
        res = time_pair('base_fft', lambda: base_fft.fft_base(x, w),
                        lambda: base_fft.fft_base_plain(x, w), f'n={n} batch={batch}')
        if batch == 1:
            timings['base_fft'] = res
    taps = dsc.from_numpy(np.blackman(255).astype(np.float32))
    step_ms = cuda_ms(lambda: filter_fft(dsc, sig, taps, 255))
    print(f'  filterFFT step (2^20 x 255 taps, n=2^21, public API): {step_ms:.4f} ms [{card}]')

    record = {'kernels': [
        {'name': name, 'route': 'cuda', 'source': src, 'replaces': rep,
         'launches': launches[name], 'max_abs_err': errs[name],
         'ms': timings[name][0], 'plain_ms': timings[name][1]}
        for name, (src, rep) in KERNELS.items()]}
    print(json.dumps(record))
    print(card)
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}))
    return 0


if __name__ == '__main__':
    sys.exit(main())
