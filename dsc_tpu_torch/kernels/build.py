"""Build, load and launch the hand-written CUDA kernels (csrc/).

The sources are compiled with nvcc for Hopper (sm_90a), one nvcc process
per source, all started together, and linked into one shared library with
a plain C interface, ``build/kernels/libdsc_tpu_torch_kernels.so`` under the
repository root, the first time a kernel is launched (again whenever a
source is newer than the library). The library is loaded with
ctypes; every entry point takes raw device pointers and PyTorch's current
CUDA stream, launches without synchronising, and returns
``cudaGetLastError()``, which ``launch`` turns into an exception.

``launches`` counts, per kernel, the launches made since the last
``reset_launches()``: a run can show which kernels its path went through.
A launch captured into a CUDA graph (dsc.compile) counts once, at the
capture; the graph's replays run no Python and count nothing.

``build_generated`` compiles a generated source (dsc.map's bodies, K5g:
ops/map_gen.py) on its own into ``build/kernels/gen/<hash>.so``, keyed by
the hash of the source and the headers it includes, and loads it the same
way; ``launch_generated`` launches its entry point and counts it under
``'stream_map_gen'``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path
from typing import Dict, Optional, Sequence

import torch

PACKAGE_DIR = Path(__file__).resolve().parents[1]
CSRC_DIR = PACKAGE_DIR / 'csrc'
BUILD_DIR = PACKAGE_DIR.parent / 'build' / 'kernels'
LIB_PATH = BUILD_DIR / 'libdsc_tpu_torch_kernels.so'
SOURCES = ('base_fft.cu', 'packed_rfft.cu', 'stream_map.cu', 'fourstep_stream.cu',
           'fourstep_stream_t.cu', 'reconstruct.cu')
HEADERS = ('fft_core.cuh', 'fft_radix.cuh', 'fft_rows_reg.cuh', 'stream_columns.cuh',
           'stream_map.cuh')
GEN_DIR = BUILD_DIR / 'gen'
# the headers a generated source includes
GEN_HEADERS = ('stream_map.cuh',)
ARCH_FLAGS = ('-gencode', 'arch=compute_90a,code=sm_90a')
COMPILE_FLAGS = (*ARCH_FLAGS, '-std=c++17', '-O3', '-Xcompiler', '-fPIC')

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_L = ctypes.c_longlong

# kernel -> (C entry point, argument types before the trailing stream)
KERNELS = {
    # x, y, batch, n, w, rows a block
    'base_fft': ('dsc_base_fft', (_P, _P, _I, _I, _P, _I)),
    # x, at, floats of x, n1, m2, w_n1, twiddle lo, hi, bits, columns a block
    'rfft_phase_a': ('dsc_rfft_phase_a', (_P, _P, _L, _I, _I, _P, _P, _P, _I, _I)),
    # at, spec, n1, m2, w_m2, untangle lo, hi, bits, row pairs a block
    'rfft_phase_b': ('dsc_rfft_phase_b', (_P, _P, _I, _I, _P, _P, _P, _I, _I)),
    # spec, y, n1, m2, w_m2, untangle lo, hi, bits, twiddle lo, hi, bits,
    # row pairs a block
    'irfft_phase_a': ('dsc_irfft_phase_a',
                      (_P, _P, _I, _I, _P, _P, _P, _I, _P, _P, _I, _I)),
    # y, out, n1, m2, w_n1, scale, columns a block
    'irfft_phase_b': ('dsc_irfft_phase_b', (_P, _P, _I, _I, _P, _F, _I)),
    # op code; (pointer, re, im, kind, brow length) for three operands; out, n
    'stream_map': ('dsc_stream_map', (_I, *(_P, _F, _F, _I, _I) * 3, _P, _L)),
    # x, z, batch, n1, n2, real input, inverse, w_n1, twiddle lo, hi, bits,
    # columns a block
    'stream_phase_a': ('dsc_stream_phase_a',
                       (_P, _P, _I, _I, _I, _I, _I, _P, _P, _P, _I, _I)),
    # z, out, batch, n1, n2, inverse, real output, w_n2, scale, columns a block
    'stream_phase_b': ('dsc_stream_phase_b', (_P, _P, _I, _I, _I, _I, _I, _P, _F, _I)),
    # one shard of the sharded four-step (fourier/stream.py phase_a_local):
    # x, z, n1, columns of the shard, col0, real input, inverse, w_n1,
    # twiddle lo, hi, bits, columns a block
    'stream_phase_a_local': ('dsc_stream_phase_a_local',
                             (_P, _P, _I, _I, _I, _I, _I, _P, _P, _P, _I, _I)),
    # K7's entry point over one shard's exchanged block, counted apart
    # (phase_b_local): z, out, 1, n1/d, n2, inverse, real output, w_n2,
    # 1/n or 1, columns a block
    'stream_phase_b_local': ('dsc_stream_phase_b', (_P, _P, _I, _I, _I, _I, _I, _P, _F, _I)),
    # z, s, n1, n2, half, w_n2, columns a block
    'stream_phase_b_t': ('dsc_stream_phase_b_t', (_P, _P, _I, _I, _I, _P, _I)),
    # s, y, n1, n2, half, w_n2, twiddle lo, hi, bits, rows a block
    'stream_inv_phase_a_t': ('dsc_stream_inv_phase_a_t',
                             (_P, _P, _I, _I, _I, _P, _P, _P, _I, _I)),
    # y, out, n1, n2, real output, w_n1, scale, columns a block
    'stream_inv_phase_b_t': ('dsc_stream_inv_phase_b_t', (_P, _P, _I, _I, _I, _P, _F, _I)),
    'reconstruct': ('dsc_reconstruct', (_P, _P, _L)),
}

launches: Dict[str, int] = dict.fromkeys((*KERNELS, 'stream_map_gen'), 0)

_lib: Optional[ctypes.CDLL] = None
_lib_lock = threading.Lock()
# hash of a generated source -> its loaded library
_generated: Dict[str, ctypes.CDLL] = {}
# nvcc seconds of each generated source built in this process
gen_build_seconds: Dict[str, float] = {}


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


def nvcc_path() -> str:
    cuda_home = os.environ.get('CUDA_HOME', '/usr/local/cuda')
    cand = os.path.join(cuda_home, 'bin', 'nvcc')
    if os.path.exists(cand):
        return cand
    found = shutil.which('nvcc')
    if found is None:
        raise RuntimeError('nvcc not found (set CUDA_HOME or put nvcc on PATH): '
                           'the CUDA kernels are built from source at first use')
    return found


def _stale() -> bool:
    if not LIB_PATH.exists():
        return True
    built = LIB_PATH.stat().st_mtime
    return any((CSRC_DIR / f).stat().st_mtime > built
               for f in SOURCES + HEADERS)


def _run_all(cmds) -> str:
    """Run the commands side by side; raise with the output of the first
    that fails, else return their output."""
    procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True) for cmd in cmds]
    outs = [p.communicate()[0] for p in procs]
    for cmd, p, out in zip(cmds, procs, outs):
        if p.returncode != 0:
            raise RuntimeError(f'nvcc failed ({" ".join(cmd)}):\n{out}')
    return ''.join(outs)


def build(extra_flags: Sequence[str] = ()) -> str:
    """Compile csrc/ into LIB_PATH; returns nvcc's output. Each source
    compiles in its own nvcc process, all at once; the objects are linked
    under a temporary name and renamed, so a concurrent loader never sees a
    partial file."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp_dir:
        objs = [os.path.join(tmp_dir, Path(s).stem + '.o') for s in SOURCES]
        log = _run_all([[nvcc, *COMPILE_FLAGS, *extra_flags, '-c', '-o', obj,
                         str(CSRC_DIR / src)] for src, obj in zip(SOURCES, objs)])
        tmp = os.path.join(tmp_dir, LIB_PATH.name)
        log += _run_all([[nvcc, *ARCH_FLAGS, '-shared', '-o', tmp, *objs]])
        os.replace(tmp, LIB_PATH)
    return log


def load() -> ctypes.CDLL:
    """The kernel library, built first if missing or stale."""
    global _lib
    with _lib_lock:
        if _lib is None:
            if _stale():
                build()
            lib = ctypes.CDLL(str(LIB_PATH))
            for entry, argtypes in KERNELS.values():
                fn = getattr(lib, entry)
                fn.argtypes = [*argtypes, _P]
                fn.restype = _I
            lib.dsc_error_string.argtypes = [_I]
            lib.dsc_error_string.restype = ctypes.c_char_p
            _lib = lib
    return _lib


def source_hash(source: str) -> str:
    """The cache key of a generated source: its text and the headers it
    includes."""
    h = hashlib.sha256(source.encode())
    for name in GEN_HEADERS:
        h.update((CSRC_DIR / name).read_bytes())
    return h.hexdigest()[:24]


def build_generated(source: str) -> ctypes.CDLL:
    """The library of a generated source, built with nvcc on first use into
    GEN_DIR/<hash>.so (one nvcc process for this source and the headers it
    includes, not the main library's sources) and loaded once a process."""
    key = source_hash(source)
    with _lib_lock:
        lib = _generated.get(key)
        if lib is not None:
            return lib
        so = GEN_DIR / f'{key}.so'
        if not so.exists():
            GEN_DIR.mkdir(parents=True, exist_ok=True)
            t0 = time.perf_counter()
            with tempfile.TemporaryDirectory(dir=GEN_DIR) as tmp_dir:
                src = os.path.join(tmp_dir, f'{key}.cu')
                with open(src, 'w') as f:
                    f.write(source)
                tmp = os.path.join(tmp_dir, so.name)
                _run_all([[nvcc_path(), *COMPILE_FLAGS, '-shared', '-I', str(CSRC_DIR),
                           '-o', tmp, src]])
                os.replace(tmp, so)
            gen_build_seconds[key] = time.perf_counter() - t0
        lib = ctypes.CDLL(str(so))
        lib.dsc_map_gen.argtypes = [_P, _P, _P, _L, _P]
        lib.dsc_map_gen.restype = _I
        _generated[key] = lib
    return lib


def launch_generated(lib: ctypes.CDLL, inputs: Sequence[torch.Tensor], rows: Sequence[int],
                     outputs: Sequence[torch.Tensor], n: int) -> None:
    """Launch a generated source's entry point on the current stream:
    ``inputs`` and ``outputs`` are CUDA tensors, ``rows`` the broadcast-row
    length of each input (0 for the other kinds); raise if the launch was
    refused."""
    ins = (_P * len(inputs))(*[t.data_ptr() for t in inputs])
    row_arr = (_I * len(rows))(*rows)
    outs = (_P * len(outputs))(*[t.data_ptr() for t in outputs])
    err = lib.dsc_map_gen(ins, row_arr, outs, n, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        msg = load().dsc_error_string(err).decode()
        raise RuntimeError(f'dsc_map_gen failed: CUDA error {err} ({msg})')
    launches['stream_map_gen'] += 1


def check(t: torch.Tensor, dtype: torch.dtype, shape, name: str) -> None:
    """Raise unless ``t`` is a contiguous CUDA tensor of ``dtype``/``shape``
    whose data is 16-byte aligned."""
    if not t.is_cuda:
        raise RuntimeError(f'{name}: expected a CUDA tensor, got {t.device}')
    if t.dtype != dtype or tuple(t.shape) != tuple(shape):
        raise RuntimeError(f'{name}: expected {dtype} {tuple(shape)}, '
                           f'got {t.dtype} {tuple(t.shape)}')
    if not t.is_contiguous() or t.data_ptr() % 16:
        raise RuntimeError(f'{name}: expected contiguous, 16-byte aligned data')


def aligned(t: torch.Tensor) -> torch.Tensor:
    """``t`` if it is contiguous with 16-byte aligned data, else a copy
    that is."""
    if t.is_contiguous() and t.data_ptr() % 16 == 0:
        return t
    return t.clone(memory_format=torch.contiguous_format)


def launch(kernel: str, *args, device: Optional[torch.device] = None) -> None:
    """Launch ``kernel`` with ``args`` on the current stream of ``device``
    (the device of the tensors the pointers come from; None: the current
    device); raise if the launch was refused."""
    lib = load()
    entry = KERNELS[kernel][0]
    if device is None:
        err = getattr(lib, entry)(*args, torch.cuda.current_stream().cuda_stream)
    else:
        with torch.cuda.device(device):
            err = getattr(lib, entry)(*args, torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        msg = lib.dsc_error_string(err).decode()
        raise RuntimeError(f'{entry} failed: CUDA error {err} ({msg})')
    launches[kernel] += 1
