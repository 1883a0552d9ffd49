"""Variants of the cluster column pass of K6 local and K7 local
(dsc_tpu_torch/csrc/cluster_columns.cuh), timed side by side on the card.

    python3 chip_local_variants.py

Each variant is the committed source with one edit, built on its own
(nvcc with -Xptxas -v) into build/local_variants/<name>/ and loaded beside
the others in one process:

  as_built   the source as it stands
  w8         W = 8 columns a group for complex64 too (one CTA of 512
             threads a SM; 64-byte runs)
  k7x2       K7 local at two CTAs a SM (128 registers) in place of three
  k6x3       K6 local at three CTAs a SM (80 registers) in place of two
  stamps     as_built with clock64() stamps of each CTA's thread 0: the
             cycles a group spends in each step of the kernel

For each it prints ptxas's registers and spills a kernel, then at the
sharded four-step's blocks (2^24 over 4 and 8 shards, 2^26 over 4) the time
of K6 local and K7 local (50 launches back to back between CUDA events),
their error against the plain versions, and (stamps) the cycles a group
by step; then 10 calls of each variant at four blocks, counting results
off their plain version by more than 3e-5. It needs a CUDA device and
exits non-zero without one; it changes nothing in the build of the
package (build/kernels).
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import sys

import numpy as np
import torch

REPO = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(REPO, 'dsc_tpu_torch', 'csrc')
OUT = os.path.join(REPO, 'build', 'local_variants')
BLOCKS = ((2**24, 4), (2**24, 8), (2**26, 4))
STRESS = ((2**24, 4), (2**24, 8), (2**26, 4), (2**26, 8))
REL_BOUND = 3e-5


def rep(text: str, old: str, new: str) -> str:
    if text.count(old) != 1:
        raise RuntimeError(f'variant edit does not apply: {old[:60]!r}')
    return text.replace(old, new)


def stamps(h: str) -> str:
    """clock64() around the steps of a group; thread 0 of each CTA sums them
    and writes them to g_stamps at the end."""
    h = rep(h, 'namespace cg = cooperative_groups;',
            'namespace cg = cooperative_groups;\n__device__ long long g_stamps[8 * 8192];')
    h = rep(h, '  uint32_t parity = 0;\n  bool ran = false;\n',
            '  uint32_t parity = 0;\n  bool ran = false;\n'
            '  long long acc[6] = {0, 0, 0, 0, 0, 0};\n')
    h = rep(h, '    mbar_wait(bar, parity);\n',
            '    long long s0 = clock64();\n    mbar_wait(bar, parity);\n'
            '    long long s1 = clock64();\n')
    h = rep(h, '    ran = true;\n', '    ran = true;\n    long long s2 = clock64();\n')
    h = rep(h, '    // 3. v[u] is value', '    long long s3 = clock64();\n    // 3. v[u] is value')
    h = rep(h, '    cluster_arrive();  // 4.\n    cluster_wait();\n',
            '    cluster_arrive();  // 4.\n    cluster_wait();\n    long long s4 = clock64();\n')
    h = rep(h, '    }\n  }\n  if (ran) cluster_wait();  // 7. no CTA',
            '    }\n    long long s5 = clock64();\n    acc[0] += s1 - s0; acc[1] += s2 - s1; '
            'acc[2] += s3 - s2; acc[3] += s4 - s3; acc[4] += s5 - s4; acc[5] += 1;\n  }\n'
            '  if (threadIdx.x == 0)\n    for (int i = 0; i < 6; ++i) '
            'g_stamps[blockIdx.x * 8 + i] = acc[i];\n  if (ran) cluster_wait();  // 7. no CTA')
    return h


VARIANTS = {
    'as_built': lambda h: h,
    'w8': lambda h: rep(h, 'return real ? 3 : 2;', 'return 3;'),
    'k7x2': lambda h: rep(h, 'return log2w == 2 ? (rows_out ? 2 : 3) : 1;',
                          'return log2w == 2 ? 2 : 1;'),
    'k6x3': lambda h: rep(h, 'return log2w == 2 ? (rows_out ? 2 : 3) : 1;',
                          'return log2w == 2 ? 3 : 1;'),
    'stamps': stamps,
}
STAMPS_ENTRY = ('\nextern "C" int dsc_stamps_read(void* host, int n) {\n'
                '  return (int)cudaMemcpyFromSymbol(host, g_stamps, (size_t)n * 8);\n}\n')
STEPS = ('wait for the TMA', 'tile read + cluster wait', 'passes', 'step 3 + cluster barrier',
         'distributed reads + DFT_Q + stores')


def build_variants(nvcc: str, flags) -> dict:
    """Build every variant at once; returns name -> (library, ptxas lines)."""
    header = open(os.path.join(SRC, 'cluster_columns.cuh')).read()
    entry = open(os.path.join(SRC, 'stream_local.cu')).read()
    procs = {}
    for name, edit in VARIANTS.items():
        d = os.path.join(OUT, name)
        shutil.rmtree(d, ignore_errors=True)
        os.makedirs(d)
        for f in ('fft_core.cuh', 'fft_radix.cuh'):
            shutil.copy(os.path.join(SRC, f), d)
        with open(os.path.join(d, 'cluster_columns.cuh'), 'w') as f:
            f.write(edit(header))
        with open(os.path.join(d, 'stream_local.cu'), 'w') as f:
            f.write(entry + (STAMPS_ENTRY if name == 'stamps' else ''))
        procs[name] = subprocess.Popen(
            [nvcc, *flags, '-Xptxas', '-v', '-shared', '-o', os.path.join(d, 'lib.so'),
             os.path.join(d, 'stream_local.cu')],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    _P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    libs = {}
    for name, p in procs.items():
        out = p.communicate()[0]
        if p.returncode:
            raise RuntimeError(f'{name}: nvcc failed:\n{out[-3000:]}')
        lines = out.splitlines()
        rows = []
        for i, line in enumerate(lines):
            if 'Compiling entry' in line and 'cluster_column_kernel' in line:
                at = line.index('kernelI') + 7
                rows.append(line[at:at + 17] + ' ' + ' '.join(
                    x.split(':', 1)[-1].strip() for x in lines[i + 1:i + 4]
                    if 'spill' in x or 'Used' in x))
        lib = ctypes.CDLL(os.path.join(OUT, name, 'lib.so'))
        lib.dsc_stream_phase_a_local.argtypes = [_P, _P] + [_I] * 5 + [_P] * 3 + [_I] * 4 + [_P]
        lib.dsc_stream_phase_b_local.argtypes = [_P, _P] + [_I] * 4 + [_P, _F] + [_I] * 3 + [_P]
        lib.dsc_stream_local_info.argtypes = [_I] * 7 + [_P]
        libs[name] = (lib, rows)
    return libs


def main() -> int:
    if not torch.cuda.is_available():
        print('chip_local_variants: no CUDA device', file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    import chip_smoke as cs
    import dsc_tpu_torch as dsc
    from dsc_tpu_torch.fourier import plan, stream
    from dsc_tpu_torch.kernels import build

    card = cs.card_line()
    print(f'card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}')
    libs = build_variants(build.nvcc_path(), build.COMPILE_FLAGS)
    for name, (_, rows) in libs.items():
        print(f'{name}: ptxas [<INV, REAL_IN, ROWS_OUT, REAL_OUT> registers, spills]')
        for row in rows:
            print(f'  {row}')
    dsc.init(2**34, device='cuda')
    dev = torch.device('cuda', 0)
    gen = torch.Generator(device='cuda').manual_seed(19)

    def cn(shape):
        return torch.randn(shape, dtype=torch.complex64, device=dev, generator=gen)

    def launchers(lib, name, n, d, t, xa, za, zb, ob):
        """K6 and K7 local of one variant on one shard's blocks."""
        n1, n2 = stream.factors(n)
        w = 8 if name == 'w8' else 4
        calls = []
        for phase_b, L, M in ((0, n1, n2 // d), (1, n2, n1 // d)):
            q = max(1, L // stream.LOCAL_MAX_ROWS)
            info = (ctypes.c_int * 5)()
            err = lib.dsc_stream_local_info(phase_b, 0, 0, L, M, w, q, info)
            cs.require(err == 0 and info[0] > 0, f'{name}: no cluster fits ({err})')
            calls.append((q, stream.grid_clusters(M, stream.LocalGeometry(w, q, 0, 0), info[0])))
        s = torch.cuda.current_stream().cuda_stream
        (qa, ca), (qb, cb) = calls

        def k6():
            cs.require(lib.dsc_stream_phase_a_local(
                xa.data_ptr(), za.data_ptr(), n1, n2 // d, n2 // d, 0, 0, t.w_n1.data_ptr(),
                t.twiddle.lo.data_ptr(), t.twiddle.hi.data_ptr(), t.twiddle.bits, w, qa, ca,
                s) == 0, f'{name}: K6 local refused')

        def k7():
            cs.require(lib.dsc_stream_phase_b_local(
                zb.data_ptr(), ob.data_ptr(), n2, n1 // d, 0, 0, t.w_n2.data_ptr(), 1.0, w, qb,
                cb, s) == 0, f'{name}: K7 local refused')

        return k6, k7, (qa * ca, qb * cb)

    for n, d in BLOCKS:
        n1, n2 = stream.factors(n)
        t = plan.get_plan(n, 'stream', torch.complex64, dev)[1]
        xa, zb = cn((n1, n2 // d)), cn((n2, n1 // d))
        za = torch.empty((n2 // d, n1), dtype=torch.complex64, device=dev)
        ob = torch.empty_like(zb)
        ra = stream.phase_a_local_plain(xa, t, n2 // d, False)
        rb = stream.phase_b_local_plain(zb, t, n1 // d, False)
        for name, (lib, _) in libs.items():
            k6, k7, ctas = launchers(lib, name, n, d, t, xa, za, zb, ob)
            k6()
            k7()
            torch.cuda.synchronize()
            ea, eb = cs.rel_err(za, ra), cs.rel_err(ob, rb)
            ta, tb = cs.back_to_back_ms(k6, 50), cs.back_to_back_ms(k7, 50)
            print(f'2^{n.bit_length() - 1} over {d}, {name:8s}: K6 local ({n1}, {n2 // d}) '
                  f'{ta:.4f} ms (rel err {ea:.2e}), K7 local ({n2}, {n1 // d}) {tb:.4f} ms '
                  f'(rel err {eb:.2e}) [{card}]')
            if name != 'stamps':
                continue
            for which, fn, n_ctas in (('K6 local', k6, ctas[0]), ('K7 local', k7, ctas[1])):
                fn()
                torch.cuda.synchronize()
                buf = np.zeros(8 * 8192, dtype=np.int64)
                cs.require(lib.dsc_stamps_read(buf.ctypes.data, len(buf)) == 0, 'stamps')
                a = buf.reshape(-1, 8)[:n_ctas]
                per = a[:, :5].sum(0) / a[:, 5].sum()
                print(f'    {which} cycles a group (thread 0, mean over CTAs): '
                      + ', '.join(f'{s} {c:.0f}' for s, c in zip(STEPS, per))
                      + f'; groups a CTA {a[:, 5].min()}..{a[:, 5].max()} [{card}]')
        del xa, zb, za, ob
    print('10 calls of each variant at each block, results off the plain version by more '
          f'than {REL_BOUND:g}:')
    bad_all = 0
    for name, (lib, _) in libs.items():
        bad = []
        for n, d in STRESS:
            n1, n2 = stream.factors(n)
            t = plan.get_plan(n, 'stream', torch.complex64, dev)[1]
            xa, zb = cn((n1, n2 // d)), cn((n2, n1 // d))
            za = torch.empty((n2 // d, n1), dtype=torch.complex64, device=dev)
            ob = torch.empty_like(zb)
            ra = stream.phase_a_local_plain(xa, t, n2 // d, False)
            rb = stream.phase_b_local_plain(zb, t, n1 // d, False)
            k6, k7, _ = launchers(lib, name, n, d, t, xa, za, zb, ob)
            for i in range(10):
                za.zero_()
                ob.zero_()
                k6()
                k7()
                for which, got, ref in (('K6', za, ra), ('K7', ob, rb)):
                    e = cs.rel_err(got, ref)
                    if not e <= REL_BOUND:
                        bad.append((which, n, d, i, e))
        bad_all += len(bad)
        print(f'  {name}: {len(bad)} of {20 * len(STRESS)} off {bad[:4]}')
    print(card)
    return 1 if bad_all else 0


if __name__ == '__main__':
    sys.exit(main())
