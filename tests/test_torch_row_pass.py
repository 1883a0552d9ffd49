"""The index maps of the register-resident row pass (dsc_tpu_torch/csrc/
fft_rows_reg.cuh) and of the five kernels built on it, K12 (csrc/base_fft.cu),
K2 and K3 (csrc/packed_rfft.cu rfft_phase_b_kernel, irfft_phase_a_kernel),
K9 (csrc/fourstep_stream_t.cu inv_phase_a_t_kernel), K12r (csrc/base_fft.cu
base_rfft_kernel, K12 with the real FFT's untangle in its store) and K12ir
(base_irfft_kernel, K12's inverse with the entangle in its load), emulated thread by
thread in numpy: each block's loads, the Stockham passes (fft_radix.cuh
pass_store and pad16, the twiddle products of row_radix_pass), the
shared-memory exchanges and the stores (K3 and K9 with the twiddle products
of row_store_twiddled), against np.fft and the kernels' plain versions.
Every shared-memory access of a full warp must take the least wavefronts
(two for 8-byte accesses), K2 must store and K3 load the spectrum in runs
of P values, and K3 and K9 must store each warp's values as one 256-byte
run. No CUDA compiler runs on a CPU machine: this checks the kernels'
indexing before the card runs them."""

import numpy as np
import pytest

torch = pytest.importorskip('torch')

from dsc_tpu_torch.fourier import packed_fused as pf  # noqa: E402
from dsc_tpu_torch.fourier import plan, stream, stream_t  # noqa: E402

RADIX, LOG2_RADIX = 16, 4


def pad16(o):
    return o + (o >> 4)


def padded_row(L):
    return L + L // 16


def column_stride(L, C):
    return L + L // 16 + (1 if C >= 16 else 16 // C)


def wavefronts(addr, active):
    """Wavefronts of each warp of one 8-byte shared-memory access: each half
    warp takes as many as the most distinct active float2 slots on one pair
    of 4-byte banks. ``addr`` and ``active`` hold one entry a thread."""
    key = np.where(active, addr, -1).reshape(-1, 16)
    srt = np.sort(key, axis=1)
    first = np.ones_like(srt, dtype=bool)
    first[:, 1:] = srt[:, 1:] != srt[:, :-1]
    distinct = (srt >= 0) & first
    counts = np.zeros((len(srt), 16), dtype=int)
    halves = np.broadcast_to(np.arange(len(srt))[:, None], srt.shape)
    np.add.at(counts, (halves[distinct], srt[distinct] % 16), 1)
    return counts.max(axis=1).reshape(-1, 2).sum(axis=1)


class Shared:
    """One block's shared memory, counting the wavefronts of every access."""

    def __init__(self, slots):
        self.mem = np.full(slots, np.nan + 0j)
        self.counts = []   # (wavefronts per warp, warp fully active, least wavefronts?)

    def _count(self, addr, active, least=True):
        assert len(addr) % 32 == 0
        self.counts.append((wavefronts(addr, active),
                            active.reshape(-1, 32).all(axis=1), least))

    def store(self, addr, vals, active=None):
        active = np.ones(len(addr), bool) if active is None else active
        assert len(np.unique(addr[active])) == active.sum()   # no two threads on one slot
        self._count(addr, active)
        self.mem[addr[active]] = vals[active]

    def load(self, addr, active=None, least=True):
        active = np.ones(len(addr), bool) if active is None else active
        self._count(addr, active, least)
        got = np.where(active, self.mem[np.where(active, addr, 0)], 0)
        assert not np.isnan(got).any()
        return got

    def check_wavefronts(self):
        for per_warp, full, least in self.counts:
            if least:
                assert (per_warp[full] == 2).all(), per_warp
            assert (per_warp <= (2 if least else 4)).all(), per_warp


def stage_twiddle(w, e, log2L):
    half = 1 << (log2L - 1)
    t = w[e & (half - 1)]
    return np.where(e & half, -t, t)


def twiddle_factors(w, e, log2L, r):
    """fft_rows_reg.cuh twiddle_butterfly: W^(e*q), q < r, as products of
    the table's W^e and W^(4e)."""
    w1 = stage_twiddle(w, e, log2L)
    f = [np.ones_like(w1), w1, w1 * w1, w1 * w1 * w1][:r]
    if r > 4:
        w4 = m = stage_twiddle(w, 4 * e, log2L)
        for a in range(1, r // 4):
            if a > 1:
                m = m * w4
            f += [m, m * f[1], m * f[2], m * f[3]]
    return f


def row_radix_pass(v, t, log2L, log2Ns, w, log2r):
    """fft_rows_reg.cuh row_radix_pass (fft_radix.cuh radix_pass at Ns = 1):
    v (threads, 16), thread t of its row."""
    r, g, log2T = 1 << log2r, RADIX >> log2r, log2L - LOG2_RADIX
    shift = log2L - log2Ns - log2r
    for s in range(g):
        if log2Ns > 0:
            k = (t + (s << log2T)) & ((1 << log2Ns) - 1)
            f = twiddle_factors(w, k << shift, log2L, r)
            for q in range(1, r):
                v[:, s + q * g] *= f[q]
    for s in range(g):
        idx = [s + q * g for q in range(r)]
        v[:, idx] = np.fft.fft(v[:, idx], axis=1)


def row_exchange(sh, base, v, t, log2L, log2Ns):
    """fft_rows_reg.cuh row_exchange: pass_store of a radix-16 pass, then
    the reads of values t + u*T."""
    log2T = log2L - LOG2_RADIX
    o0 = ((t >> log2Ns) << (log2Ns + LOG2_RADIX)) + (t & ((1 << log2Ns) - 1))
    for q in range(RADIX):
        sh.store(base + pad16(o0 + (q << log2Ns)), v[:, q])
    for u in range(RADIX):
        v[:, u] = sh.load(base + pad16(t + (u << log2T)))


def row_fft(sh, base, v, t, log2L, w, inverse=False):
    """fft_rows_reg.cuh row_fft; ``inverse`` (INV, the conjugated table and
    butterfly constants) as the conjugate of the forward transform of the
    conjugate, over the same index maps."""
    if inverse:
        v[:] = np.conj(v)
    row_radix_pass(v, t, log2L, 0, w, 4)
    row_exchange(sh, base, v, t, log2L, 0)
    row_radix_pass(v, t, log2L, 4, w, 4)
    if log2L > 8:
        row_exchange(sh, base, v, t, log2L, 4)
        if log2L == 13:   # 16*16*16*2: a third exchange
            row_radix_pass(v, t, log2L, 8, w, 4)
            row_exchange(sh, base, v, t, log2L, 8)
            row_radix_pass(v, t, log2L, 12, w, 1)
        else:
            row_radix_pass(v, t, log2L, 8, w, log2L - 8)
    if inverse:
        v[:] = np.conj(v)


def emulate_k12(x, w, rows):
    """base_fft_kernel over every block, ``rows`` rows a block."""
    batch, n = x.shape
    log2n = n.bit_length() - 1
    log2T = log2n - LOG2_RADIX
    tid = np.arange(rows << log2T)
    r, t = tid >> log2T, tid & ((1 << log2T) - 1)
    u = np.arange(RADIX)
    y = np.full(x.shape, np.nan + 0j)
    for b in range(-(-batch // rows)):
        row = b * rows + r
        live = row < batch
        v = np.zeros((len(tid), RADIX), complex)
        cols = t[:, None] + (u[None, :] << log2T)
        v[live] = x[row[live][:, None], cols[live]]
        sh = Shared(rows * padded_row(n))
        row_fft(sh, r * padded_row(n), v, t, log2n, w)
        sh.check_wavefronts()
        y[row[live][:, None], cols[live]] = v[live]
    return y


@pytest.mark.parametrize('points', [4096, 8192, 16384])
@pytest.mark.parametrize('n', [256, 512, 1024, 2048, 4096])
def test_k12_index_maps(n, points):
    """K12 with each block size of chip_smoke.py --profile, on a batch that
    leaves a ragged last block: every row once, in natural order."""
    rows = points // n
    rng = np.random.default_rng(n + points)
    batch = 2 * rows + 1
    x = rng.standard_normal((batch, n)) + 1j * rng.standard_normal((batch, n))
    w = plan.get_plan(n, 'complex', torch.complex64, 'cpu')[1].numpy().astype(complex)
    got = emulate_k12(x, w, rows)
    ref = np.fft.fft(x, axis=1)
    assert np.abs(got - ref).max() / np.abs(ref).max() < 1e-6


def emulate_k12r(x, w, wu, rows):
    """base_rfft_kernel over every block, ``rows`` rows a block: the (B, nh
    + 1) real spectrum of the float rows ``x`` (B, 2nh), every bin written
    once, and the runs of neighbouring bins each warp's stores make."""
    batch, n = x.shape
    nh = n // 2
    log2n = nh.bit_length() - 1
    log2T = log2n - LOG2_RADIX
    tid = np.arange(rows << log2T)
    r, t = tid >> log2T, tid & ((1 << log2T) - 1)
    u = np.arange(RADIX)
    z = x[:, 0::2] + 1j * x[:, 1::2]   # a float2 load of x
    y = np.full((batch, nh + 1), np.nan + 0j)
    written = np.zeros((batch, nh + 1), int)
    runs = []
    for b in range(-(-batch // rows)):
        row = b * rows + r
        live = row < batch
        v = np.zeros((len(tid), RADIX), complex)
        cols = t[:, None] + (u[None, :] << log2T)
        v[live] = z[row[live][:, None], cols[live]]
        sh = Shared(rows * padded_row(nh))
        base = r * padded_row(nh)
        row_fft(sh, base, v, t, log2n, w)
        for q in range(RADIX):   # Z[k] at slot k, unpadded
            sh.store(base + t + (q << log2T), v[:, q])
        for q in range(RADIX):
            k = t + (q << log2T)
            mir = sh.load(base + ((nh - k) & (nh - 1)), live)
            a, bc = v[:, q], np.conj(mir)
            val = 0.5 * (a + bc) - 1j * (wu[k] * (0.5 * (a - bc)))
            y[row[live], k[live]] = val[live]
            np.add.at(written, (row[live], k[live]), 1)
            runs += warp_runs(row * (nh + 1) + k, live)
        last = live & (t == 0)   # thread 0 of a row: X[nh] from Z[nh] = Z[0]
        a = v[last, 0]
        y[row[last], nh] = 0.5 * (a + np.conj(a)) - 1j * (wu[nh] * (0.5 * (a - np.conj(a))))
        written[row[last], nh] += 1
        sh.check_wavefronts()
    assert (written == 1).all()
    return y, runs


@pytest.mark.parametrize('points', [4096, 8192, 16384])
@pytest.mark.parametrize('nh', [256, 512, 1024, 2048, 4096])
def test_k12r_index_maps(nh, points):
    """K12r with each block size K12 takes, on a batch that leaves a ragged
    last block: every bin of every row once, the untangle of each Z[k]
    against its mirror read from the unpadded row in the least wavefronts,
    and each warp's stores as neighbouring bins of a row."""
    rows = points // nh
    rng = np.random.default_rng(nh + points + 1)
    batch = 2 * rows + 1
    x = rng.standard_normal((batch, 2 * nh))
    spec, (w, wu) = plan.get_plan(2 * nh, 'real', torch.complex64, 'cpu')
    assert spec == ('base', nh)
    w, wu = (tab.numpy().astype(complex) for tab in (w, wu))
    got, runs = emulate_k12r(x, w, wu, rows)
    ref = np.fft.rfft(x, axis=1)
    assert np.abs(got - ref).max() / np.abs(ref).max() < 1e-6
    # a warp stores one run of 32 bins, two of 16 where a row has 16 threads
    assert all((lengths == min(32, nh // 16)).all() for lengths in runs)


def emulate_k12s_load(mem, offset, batch, row_stride, start, valid, n_frames, hop, window, nh,
                      rows):
    """base_stft_kernel's load over every block, ``rows`` rows a block: the
    (batch * n_frames, 2nh) float32 rows it hands K12r's row pass, frame i
    of signal row b read from ``mem`` (the signal's memory, float32) at
    offset + b*row_stride + start + i*hop + j times window[j], zero outside
    the frame and the row's ``valid`` samples; on an even geometry as float2
    pairs, pair u of a thread read where lo <= u < hi (the kernel's range of
    pairs inside the row and the frame), else as two floats tested each;
    every read held inside the row and the window, every float2 read 8-byte
    aligned (``mem`` is), and the runs of neighbouring float2 each warp's
    signal reads make in frames that lie inside the signal."""
    frame = window.shape[0]
    pairs = not (offset | row_stride | start | valid | hop | frame) & 1
    log2T = nh.bit_length() - 1 - LOG2_RADIX
    tid = np.arange(rows << log2T)
    r, t = tid >> log2T, tid & ((1 << log2T) - 1)
    total = batch * n_frames
    out = np.full((total, 2 * nh), np.nan, np.float32)
    runs = []
    for blk in range(-(-total // rows)):
        row = blk * rows + r
        live = row < total
        b = row // n_frames
        p0 = start + (row - b * n_frames) * hop
        whole = live & (p0 >= 0) & (p0 + frame <= valid)
        first = p0 + 2 * t   # the kernel's pair range: lo <= u < hi
        step = 2 << log2T
        lo = np.minimum(np.where(first >= 0, 0, (step - 1 - first) // step), RADIX)
        left = np.minimum(valid - first, frame - 2 * t)
        hi = np.where(live & (left > 0), np.minimum((left + step - 1) // step, RADIX), 0)
        for q in range(RADIX):
            j = 2 * (t + (q << log2T))
            p = p0 + j
            got = np.zeros((len(tid), 2), np.float32)
            for half in (0, 1):
                if pairs:
                    inside = (lo <= q) & (q < hi)
                else:
                    inside = (live & (j + half < frame) & (p + half >= 0)
                              & (p + half < valid))
                addr = offset + b * row_stride + p + half
                assert (p[inside] + half >= 0).all() and (p[inside] + half < valid).all()
                assert (j[inside] + half < frame).all()
                got[inside, half] = mem[addr[inside]] * window[j[inside] + half]
            if pairs:  # one float2 read of the pair
                inside = (lo <= q) & (q < hi)
                assert ((offset + b * row_stride + p)[inside] % 2 == 0).all()
                runs += warp_runs((offset + b * row_stride + p) // 2, inside & whole)
            out[row[live], j[live]] = got[live, 0]
            out[row[live], j[live] + 1] = got[live, 1]
    return out, pairs, runs


# (batch, valid, row stride, offset, start, frames, hop, frame): the
# spectrogram's framing; Griffin-Lim's centre on its cropped view; frames
# past the signal's end; a frame shorter than the transform; an odd hop,
# start and row stride, and a misaligned view, on the scalar path
K12S_CASES = [(3, 4096, 4096, 0, 0, 13, 256, 1024), (2, 4000, 4512, 256, -512, 15, 256, 1024),
              (2, 3000, 3000, 0, 0, 11, 256, 1024), (2, 5000, 5000, 0, 0, 17, 256, 1000),
              (3, 3001, 3010, 1, -3, 19, 125, 1000), (2, 2048, 2048, 0, -256, 9, 256, 512)]


@pytest.mark.parametrize('case', K12S_CASES)
def test_k12s_load(case):
    """K12s's load gives, bit for bit, the windowed frames, zero-padded to
    the transform, that its plain version hands the batched rfft, in a
    ragged last block; on the pair path each warp reads the signal as one
    run of 32 neighbouring float2, 16 where a row has 16 threads, except at
    a frame's edges. The full K12s (this load, then K12r's emulated row
    pass and untangle) against np.fft in float64."""
    from dsc_tpu_torch.fourier import base_fft

    batch, valid, stride, offset, start, n_frames, hop, frame = case
    fft_n = plan.next_pow2(max(frame, 512))
    nh = fft_n // 2
    mem = np.random.default_rng(valid + frame).standard_normal(
        offset + batch * stride).astype(np.float32)
    window = np.hanning(frame).astype(np.float32)
    rows = 4  # and a ragged last block: no case has a multiple of 4 frames
    got, pairs, runs = emulate_k12s_load(mem, offset, batch, stride, start, valid, n_frames, hop,
                                         window, nh, rows)
    assert pairs == (case[4] % 2 == 0 and case[6] % 2 == 0 and case[3] % 2 == 0)
    x = torch.from_numpy(mem)[offset:].as_strided((batch, valid), (stride, 1))
    frames = []
    base_fft.stft_plain(x, start, n_frames, hop, torch.from_numpy(window), fft_n, 'complex',
                        0.0, lambda fx: frames.append(fx) or fx)
    np.testing.assert_array_equal(got, frames[0].numpy())
    # a warp's float2 reads of a whole frame: one run a row it covers, cut
    # short only at the end of a frame shorter than the transform
    full = min(32, nh // 16)
    assert all(len(lengths) <= 32 // full and (lengths <= full).all() for lengths in runs)
    assert frame < fft_n or all((lengths == full).all() for lengths in runs)
    assert bool(runs) == pairs
    spec, (w, wu) = plan.get_plan(fft_n, 'real', torch.complex64, 'cpu')
    w, wu = (tab.numpy().astype(complex) for tab in (w, wu))
    y, _ = emulate_k12r(got.astype(np.float64), w, wu, rows)
    ref = np.fft.rfft(got.astype(np.float64), axis=1)
    assert np.abs(y - ref).max() / np.abs(ref).max() < 1e-6


def emulate_k12ir(x, w, wu, rows):
    """base_irfft_kernel over every block, ``rows`` rows a block: the (B,
    2nh) real rows of the half spectra ``x`` (B, nh + 1), every output
    value written once, and the runs of neighbouring bins each warp's loads
    of ``x`` and stores of the rows make."""
    batch, m = x.shape
    nh = m - 1
    log2n = nh.bit_length() - 1
    log2T = log2n - LOG2_RADIX
    tid = np.arange(rows << log2T)
    r, t = tid >> log2T, tid & ((1 << log2T) - 1)
    u = np.arange(RADIX)
    z = np.full((batch, nh), np.nan + 0j)   # the float2 rows of the output
    written = np.zeros((batch, nh), int)
    load_runs, store_runs = [], []
    for b in range(-(-batch // rows)):
        row = b * rows + r
        live = row < batch
        sh = Shared(rows * padded_row(nh))
        base = r * padded_row(nh)
        v = np.zeros((len(tid), RADIX), complex)
        for q in range(RADIX):   # X[k] at slot k, unpadded
            k = t + (q << log2T)
            v[live, q] = x[row[live], k[live]]
            load_runs += warp_runs(row * (nh + 1) + k, live)
            sh.store(base + k, v[:, q])
        first = t == 0   # thread 0 of a row: X[nh] at slot nh
        last = np.zeros(len(tid), complex)
        last[first & live] = x[row[first & live], nh]
        sh.store(base + nh, last, first)
        for q in range(RADIX):
            k = t + (q << log2T)
            a, bc = v[:, q], np.conj(sh.load(base + nh - k))
            v[:, q] = 0.5 * (a + bc) + 1j * (np.conj(wu[k]) * (0.5 * (a - bc)))
        row_fft(sh, base, v, t, log2n, w, inverse=True)
        sh.check_wavefronts()
        for q in range(RADIX):
            k = t + (q << log2T)
            z[row[live], k[live]] = v[live, q] / nh
            np.add.at(written, (row[live], k[live]), 1)
            store_runs += warp_runs(row * nh + k, live)
    assert (written == 1).all()
    y = np.empty((batch, 2 * nh))
    y[:, 0::2], y[:, 1::2] = z.real, z.imag
    return y, load_runs, store_runs


@pytest.mark.parametrize('points', [4096, 8192, 16384])
@pytest.mark.parametrize('nh', [256, 512, 1024, 2048, 4096])
def test_k12ir_index_maps(nh, points):
    """K12ir with each block size K12 takes, on a batch that leaves a ragged
    last block: every value of every row once, the entangle of each X[k]
    against its mirror X[nh-k] read from the unpadded staged row in the
    least wavefronts (k = 0 against X[nh]), each warp's loads and stores
    as neighbouring bins of a row, and the rows of the half spectra's
    inverse against np.fft.irfft and the plain version, whose X[0] and
    X[nh] keep their imaginary parts."""
    from dsc_tpu_torch.fourier import base_fft

    rows = points // nh
    rng = np.random.default_rng(nh + points + 2)
    batch = 2 * rows + 1
    sig = rng.standard_normal((batch, 2 * nh))
    spec, (w, wu) = plan.get_plan(2 * nh, 'real', torch.complex128, 'cpu')
    assert spec == ('base', nh)
    x = np.fft.rfft(sig, axis=1)
    x[:, [0, nh]] += 1j * rng.standard_normal((batch, 2))
    got, load_runs, store_runs = emulate_k12ir(x, w.numpy(), wu.numpy(), rows)
    want = base_fft.irfft_base_plain(torch.from_numpy(x), w, wu).numpy()
    assert np.abs(got - want).max() / np.abs(want).max() < 1e-12
    real = x.copy()
    real[:, [0, nh]] = real[:, [0, nh]].real
    got_real, _, _ = emulate_k12ir(real, w.numpy(), wu.numpy(), rows)
    assert np.abs(got_real - sig).max() / np.abs(sig).max() < 1e-12
    # a warp loads and stores one run of 32 bins, two of 16 where a row has
    # 16 threads
    for runs in (load_runs, store_runs):
        assert all((lengths == min(32, nh // 16)).all() for lengths in runs)


def slot_row(b, npairs, P, n1, slot):
    if b == npairs:
        return np.zeros_like(slot)
    k = b * P + 1 + np.where(slot < P, slot, slot - P)
    return np.where(slot < P, k, n1 - k)


def slot_k2(b, npairs, P, m2, i):
    if b == npairs:
        return np.zeros_like(i), i
    g = i >= P * m2
    u = i - g * P * m2
    return np.where(g, P + (P - 1 - (u & (P - 1))), u & (P - 1)), u // P


def emulate_k2(at, t, P):
    """rfft_phase_b_kernel over every block: the natural spectrum, and the
    runs of neighbouring bins each warp's stores make."""
    n1, m2 = at.shape
    nh = n1 * m2
    log2m2 = m2.bit_length() - 1
    log2T = log2m2 - LOG2_RADIX
    npairs = n1 // (2 * P)
    sstride = column_stride(m2, P)
    w = t.w_m2.numpy().astype(complex)
    lo, hi = (tab.numpy().astype(complex) for tab in (t.untangle.lo, t.untangle.hi))
    bits = t.untangle.bits
    spec = np.full(nh + 1, np.nan + 0j)
    written = np.zeros(nh + 1, int)
    runs = []   # (pair block?, run lengths of one warp's store)
    threads = 2 * P << log2T
    tid = np.arange(threads)
    s, tt = tid >> log2T, tid & ((1 << log2T) - 1)
    u = np.arange(RADIX)
    for b in range(npairs + 1):
        slots = 1 if b == npairs else 2 * P
        v = at[slot_row(b, npairs, P, n1, s)[:, None], tt[:, None] + (u[None, :] << log2T)]
        v = v.astype(complex)
        sh = Shared(2 * P * sstride)
        row_fft(sh, s * sstride, v, tt, log2m2, w)
        for j in range(RADIX):
            sh.store(s * sstride + pad16(tt + (j << log2T)), v[:, j])
        for i0 in range(0, slots * m2, threads):
            i = i0 + tid
            sl, k2 = slot_k2(b, npairs, P, m2, i)
            row = slot_row(b, npairs, P, n1, sl)
            act = (i < slots * m2) & ~((sl >= P) & (2 * row == n1))
            a = sh.load(sl * sstride + pad16(k2), act)
            ms = np.where(sl < P, sl + P, sl - P)
            # the row-0 block's mirror Z[0, (m2 - k2) mod m2] wraps at the
            # row's end: two wavefronts a half warp in that one block
            mir = sh.load(np.where(row == 0, pad16((m2 - k2) & (m2 - 1)),
                                   ms * sstride + pad16(m2 - 1 - k2)), act, b < npairs)
            k = row + n1 * k2
            tw = hi[k >> bits] * lo[k & ((1 << bits) - 1)]
            bc = np.conj(mir)
            x = 0.5 * (a + bc) - 1j * tw * 0.5 * (a - bc)
            spec[k[act]] = x[act]
            np.add.at(written, k[act], 1)
            nyq = act & (row == 0) & (k2 == 0)
            if nyq.any():
                spec[nh] = a[nyq][0].real - a[nyq][0].imag
                written[nh] += 1
            for warp in range(0, threads, 32):
                ks = np.sort(k[warp:warp + 32][act[warp:warp + 32]])
                if len(ks):
                    cuts = np.flatnonzero(np.diff(ks) != 1) + 1
                    runs.append((b < npairs - 1, np.diff(np.r_[0, cuts, len(ks)])))
        sh.check_wavefronts()
    assert (written == 1).all()
    return spec, runs


def _k2_cases():
    return [(m2, p) for m2 in (512, 1024, 2048, 4096) for p in (1, 2, 4, 8, 16)
            if 2 * p * m2 // 16 <= 1024]


@pytest.mark.parametrize('m2,P', _k2_cases())
def test_k2_index_maps(m2, P):
    """K2 with every P that 1024 threads allow, at each m2 the packed route
    meets (n1 = 64 rows): every bin once, the untangle of each row against
    its mirror, and stores in runs of P bins outside the block that holds
    row n1/2 twice."""
    n1 = 64
    rng = np.random.default_rng(m2 + P)
    at = (rng.standard_normal((n1, m2)) + 1j * rng.standard_normal((n1, m2))).astype(np.complex64)
    t = plan.packed_tables(n1, 2 * m2, torch.complex64, 'cpu')
    got, runs = emulate_k2(at.astype(complex), t, P)
    ref = pf.rfft_phase_b_plain(torch.from_numpy(at), t).numpy()
    assert np.abs(got - ref).max() / np.abs(ref).max() < 1e-5
    for pair_block, lengths in runs:
        if pair_block:
            assert (lengths == P).all(), lengths


def warp_runs(addr, active):
    """Run lengths of neighbouring addresses in each warp's access."""
    runs = []
    for warp in range(0, len(addr), 32):
        a = np.unique(addr[warp:warp + 32][active[warp:warp + 32]])
        if len(a):
            cuts = np.flatnonzero(np.diff(a) != 1) + 1
            runs.append(np.diff(np.r_[0, cuts, len(a)]))
    return runs


def factored(tab):
    lo, hi = (x.numpy().astype(complex) for x in (tab.lo, tab.hi))
    return lambda e: hi[e >> tab.bits] * lo[e & ((1 << tab.bits) - 1)]


def store_twiddles(W, e0, d):
    """fft_rows_reg.cuh row_store_twiddled: W^(e0 + u*d), u < 16, from the
    three lookups W^e0, W^d, W^(4d)."""
    base, s1, s4 = W(e0), W(d), W(4 * d)
    s2, b1 = s1 * s1, base * s1
    q = [base, b1, base * s2, b1 * s2]
    m = [None, s4, s4 * s4]
    m.append(m[2] * s4)
    return [q[a] if c == 0 else q[a] * m[c] for c in range(4) for a in range(4)]


def emulate_k9(s, t, half, rows, blocks):
    """inv_phase_a_t_kernel<log2(n2), half> over ``blocks``, ``rows`` rows a
    block (T layout): the rows they store, and the runs of each warp's
    device loads and stores."""
    n1, n2 = 2 * t.w_n1.shape[0], 2 * t.w_n2.shape[0]
    log2n2 = n2.bit_length() - 1
    log2T = log2n2 - LOG2_RADIX
    stride = padded_row(n2)
    w = t.w_n2.numpy().astype(complex)
    W = factored(t.twiddle)
    slots = 2 if half else rows
    tid = np.arange(slots << log2T)
    r, tt = tid >> log2T, tid & ((1 << log2T) - 1)
    full = np.ones(len(tid), bool)
    y, loads, stores = {}, [], []
    for b in blocks:
        sh = Shared(slots * stride)
        v = np.zeros((len(tid), RADIX), complex)
        if half:
            h = n2 // 2
            width = h + 1
            row = np.where(r == 1, n1 // 2 if b == 0 else n1 - b, b)
            for k0 in range(0, width, 1 << log2T):
                k2 = k0 + tt
                act = k2 < width
                k2 = np.where(act, k2, 0)
                loads += warp_runs(row * width + k2, act)
                sh.store(r * stride + pad16(k2), s[row, k2], act)
            mirror = r if b == 0 else 1 - r
            flip = np.where(row == 0, n2, n2 - 1)
            for u in range(RADIX):
                k2 = tt + (u << log2T)
                own = k2 <= h
                a = sh.load(r * stride + pad16(np.where(own, k2, 0)), own)
                # row 0's mirror S[0, n2 - k2] lies one value off the
                # 16-value groups: up to three wavefronts a warp in block 0
                m = sh.load(mirror * stride + pad16(np.where(own, 0, flip - k2)), ~own,
                            least=b != 0)
                v[:, u] = np.where(own, a, np.conj(m))
        else:
            row = b * rows + r
            for u in range(RADIX):
                k2 = tt + (u << log2T)
                loads += warp_runs(row * n2 + k2, full)
                v[:, u] = s[row, k2]
        row_fft(sh, r * stride, v, tt, log2n2, w, inverse=True)
        sh.check_wavefronts()
        f = store_twiddles(W, row * tt, row << log2T)
        for u in range(RADIX):
            j2 = tt + (u << log2T)
            stores += warp_runs(row * n2 + j2, full)
            for rr in np.unique(row):
                sel = row == rr
                y.setdefault(int(rr), np.full(n2, np.nan + 0j))[j2[sel]] = v[sel, u] * np.conj(
                    f[u][sel])
    return y, loads, stores


def _k9_cases():
    """(n2, R): every R of the block sizes chip_smoke.py --profile times
    (4096, 8192 and 16384 points a block) within 1024 threads."""
    return [(n2, r) for n2 in (512, 1024, 2048, 4096, 8192)
            for r in sorted({max(1, p // n2) for p in (4096, 8192, 16384)})
            if r * n2 // 16 <= 1024]


def _check_rows(y, ref):
    for row, got in y.items():
        assert not np.isnan(got).any(), row
        assert np.abs(got - ref[row]).max() / np.abs(ref).max() < 1e-5, row


@pytest.mark.parametrize('n2,R', _k9_cases())
def test_k9_t_index_maps(n2, R):
    """K9 in the T layout with R rows a block, its first and last blocks
    (n1 = 4R rows), against its plain version; n2 = 8192 runs the row
    pass's third exchange. Loads and stores are 256-byte runs a warp."""
    n1 = 4 * R
    rng = np.random.default_rng(n2 + R)
    s = (rng.standard_normal((n1, n2)) + 1j * rng.standard_normal((n1, n2))).astype(np.complex64)
    t = plan.stream_tables(n1, n2, torch.complex64, 'cpu')
    y, loads, stores = emulate_k9(s.astype(complex), t, False, R, [0, n1 // R - 1])
    assert sorted(y) == list(range(R)) + list(range(n1 - R, n1))
    _check_rows(y, stream_t.inv_phase_a_t_plain(torch.from_numpy(s), t, False).numpy())
    assert all((runs == [32]).all() for runs in loads + stores)


@pytest.mark.parametrize('n1,n2', [(512, 512), (1024, 512)])
def test_k9_half_t_index_maps(n1, n2):
    """K9 in the half-T layout at the routed splits: block 0 (rows 0 and
    n1/2, each its own mirror) and block n1/2 - 1 (rows n1/2 - 1 and
    n1/2 + 1), against its plain version; each warp loads one run of its
    row's stored values and stores one 256-byte run."""
    rng = np.random.default_rng(n1 + n2)
    width = stream_t.width(n2, True)
    s = (rng.standard_normal((n1, width)) + 1j * rng.standard_normal((n1, width))).astype(
        np.complex64)
    t = plan.stream_tables(n1, n2, torch.complex64, 'cpu')
    y, loads, stores = emulate_k9(s.astype(complex), t, True, 1, [0, n1 // 2 - 1])
    assert sorted(y) == [0, n1 // 2 - 1, n1 // 2, n1 // 2 + 1]
    _check_rows(y, stream_t.inv_phase_a_t_plain(torch.from_numpy(s), t, True).numpy())
    assert all(len(runs) == 1 for runs in loads)
    assert all((runs == [32]).all() for runs in stores)


def emulate_k3(spec, t, P, blocks):
    """irfft_phase_a_kernel<log2(m2)> over ``blocks``, P row pairs a block:
    the rows they store, the runs of each warp's spectrum loads (pair blocks
    only) and of its stores."""
    n1, m2, nh = pf._sizes(t)
    log2m2 = m2.bit_length() - 1
    log2T = log2m2 - LOG2_RADIX
    npairs = n1 // (2 * P)
    sstride = column_stride(m2, P)
    w = t.w_m2.numpy().astype(complex)
    Wn, Wnh = factored(t.untangle), factored(t.twiddle)
    threads = 2 * P << log2T
    tid = np.arange(threads)
    s, tt = tid >> log2T, tid & ((1 << log2T) - 1)
    y, loads, stores = {}, [], []
    for b in blocks:
        row0 = b == npairs
        sh = Shared(2 * P * sstride)
        count = m2 if row0 else 2 * P * m2
        for i0 in range(0, count, threads):
            i = i0 + tid
            act = i < count
            sl, k2 = slot_k2(b, npairs, P, m2, np.where(act, i, 0))
            k = slot_row(b, npairs, P, n1, sl) + n1 * k2
            if not row0:
                loads += warp_runs(k, act)
            sh.store(sl * sstride + pad16(k2), spec[k], act)
        if row0:   # X[nh], the mirror of k2 = 0, as value m2 of slot 0
            sh.store(np.full(threads, pad16(m2)), np.full(threads, spec[nh]), tid == 0)
        row = slot_row(b, npairs, P, n1, s)
        own = np.zeros_like(s) if row0 else s * sstride
        mirror = np.zeros_like(s) if row0 else np.where(s < P, s + P, s - P) * sstride
        flip = m2 if row0 else m2 - 1
        wt = np.conj(Wn(row + n1 * tt))
        v = np.zeros((threads, RADIX), complex)
        for u in range(RADIX):
            k2 = tt + (u << log2T)
            a = sh.load(own + pad16(k2))
            # the row-0 block's mirror X[n1*(m2 - k2)] wraps at the row's end:
            # up to three wavefronts a half warp in that one block
            bc = np.conj(sh.load(mirror + pad16(flip - k2), least=not row0))
            zero = (row == 0) & (k2 == 0)
            a, bc = np.where(zero, a.real, a), np.where(zero, bc.real, bc)
            d = wt * np.exp(2j * np.pi * u / 32) * 0.5 * (a - bc)
            v[:, u] = 0.5 * (a + bc) + 1j * d
        row_fft(sh, s * sstride, v, tt, log2m2, w, inverse=True)
        sh.check_wavefronts()
        keep = ~((row0 & (s > 0)) | ((s >= P) & (2 * row == n1)))
        f = store_twiddles(Wnh, row * tt, row << log2T)
        for u in range(RADIX):
            j2 = tt + (u << log2T)
            stores += warp_runs(row * m2 + j2, keep)
            for rr in np.unique(row[keep]):
                sel = keep & (row == rr)
                out = y.setdefault(int(rr), np.full(m2, np.nan + 0j))
                assert np.isnan(out[j2[sel]]).all()   # each value stored once
                out[j2[sel]] = v[sel, u] * np.conj(f[u][sel])
    return y, loads, stores


@pytest.mark.parametrize('m2,P', _k2_cases())
def test_k3_index_maps(m2, P):
    """K3 with every P that 1024 threads allow, at each m2 the packed route
    meets (n1 = 64 rows), over its first pair block, the last one (row
    n1/2 twice, stored once) and the row-0 block (X[nh] as row 0's mirror
    of k2 = 0), against its plain version, on a spectrum whose X[0] and
    X[nh] are not real (only their real parts count, as in np.fft.irfft):
    the spectrum loaded in runs of P bins a warp, each bin once, and each
    warp's stores one 256-byte run."""
    n1 = 64
    nh = n1 * m2
    rng = np.random.default_rng(m2 + P)
    spec = (rng.standard_normal(nh + 1) + 1j * rng.standard_normal(nh + 1)).astype(np.complex64)
    assert spec[0].imag != 0 and spec[nh].imag != 0
    t = plan.packed_tables(n1, 2 * m2, torch.complex64, 'cpu')
    npairs = n1 // (2 * P)
    y, loads, stores = emulate_k3(spec.astype(complex), t, P, sorted({0, npairs - 1, npairs}))
    first = list(range(1, P + 1)) + list(range(n1 - P, n1))
    last = list(range(n1 // 2 - P + 1, n1 // 2 + P))
    assert sorted(y) == sorted({0, *first, *last})
    _check_rows(y, pf.irfft_phase_a_plain(torch.from_numpy(spec), t).numpy())
    assert all((runs == P).all() for runs in loads)
    assert all((runs == [32]).all() for runs in stores)


@pytest.mark.parametrize('n1,n2', [(4096, 4096), (8192, 8192)])
def test_store_twiddle_products_in_float32(n1, n2):
    """row_store_twiddled's 16 factors, formed in float32 from the float32
    tables (numpy complex64 arithmetic), stay within 5e-7 of the table's
    own factor (the plain versions') over sampled rows of K9's 2^24 and
    2^26 splits: the margin under K9's 1e-6 bound against its plain
    version."""
    t = plan.stream_tables(n1, n2, torch.complex64, 'cpu')
    lo, hi, bits = t.twiddle.lo.numpy(), t.twiddle.hi.numpy(), t.twiddle.bits

    def W(e):
        return hi[e >> bits] * lo[e & ((1 << bits) - 1)]

    T = n2 // 16
    rows = np.random.default_rng(n1).choice(n1, 64, replace=False)[:, None].astype(np.int64)
    tt = np.arange(T, dtype=np.int64)[None, :]
    f = store_twiddles(W, rows * tt, rows * T + 0 * tt)
    err = max(float(np.abs(f[u] - W(rows * (tt + u * T))).max()) for u in range(RADIX))
    assert f[0].dtype == np.complex64 and err < 5e-7, err


# ---------------------------------------------------------------------------
# the cluster column pass of K6 local and K7 local (csrc/cluster_columns.cuh)
# ---------------------------------------------------------------------------


def local_radix_pass(v, t, log2P, log2L, log2Ns, w, log2r):
    """cluster_columns.cuh local_radix_pass: a Stockham pass over the P
    values of a decimated column, the stage twiddles read one a value from
    the L-point table."""
    r, g, log2T = 1 << log2r, RADIX >> log2r, log2P - LOG2_RADIX
    shift = log2L - log2Ns - log2r
    for s in range(g):
        if log2Ns > 0:
            k = (t + (s << log2T)) & ((1 << log2Ns) - 1)
            for q in range(1, r):
                v[:, s + q * g] *= stage_twiddle(w, (k * q) << shift, log2L)
    for s in range(g):
        idx = [s + q * g for q in range(r)]
        v[:, idx] = np.fft.fft(v[:, idx], axis=1)


def local_pass_store(sh, base, v, t, log2P, log2Ns, log2r):
    """fft_radix.cuh pass_store into the column at ``base``."""
    r, g, log2T = 1 << log2r, RADIX >> log2r, log2P - LOG2_RADIX
    for s in range(g):
        jj = t + (s << log2T)
        o0 = ((jj >> log2Ns) << (log2Ns + log2r)) + (jj & ((1 << log2Ns) - 1))
        for q in range(r):
            sh.store(base + pad16(o0 + (q << log2Ns)), v[:, s + q * g])


def emulate_cluster_pass(x, w, geo, groups, rows_out, tw=None, col0=0, scale=1.0):
    """cluster_column_kernel (forward) over the column groups ``groups`` of
    the (L, M) block x (complex, or float for the real input), each as the
    Q CTAs of one cluster take it: the stored values {address: value} of
    the (M, L) output (``rows_out``, K6 local, times ``tw``(k*(col0 + m)))
    or the (L, M) one (K7 local, times ``scale``), the shared memory (tile
    and exchange buffer) of every CTA, and the runs of each warp's device
    stores."""
    L, M = x.shape
    W, Q = geo.columns, geo.cluster
    P = L // Q
    log2P, log2L, log2Q = P.bit_length() - 1, L.bit_length() - 1, Q.bit_length() - 1
    log2W = W.bit_length() - 1
    log2T, log2K, log2NT = log2P - LOG2_RADIX, log2P - log2Q, log2P + log2W - LOG2_RADIX
    cstride = column_stride(P, W)
    assert geo.threads == 1 << log2NT and geo.smem == (P * W + W * cstride) * 8 + 8
    tid = np.arange(1 << log2NT)
    c, t = tid & (W - 1), tid >> log2W

    def slot(k, col):   # cluster_columns.cuh exchange_slot
        return col * cstride + pad16(k) if rows_out else k * W + col

    out, runs, shared, stored = {}, [], [], 0
    for grp in groups:
        m0 = grp * W
        exch = []
        for q in range(Q):
            # 1. the TMA tile: tile[i*W + c] = x[i*Q + q, m0 + c]
            tile = x[q::Q, m0:m0 + W].reshape(-1)
            if np.iscomplexobj(x):
                sh = Shared(P * W)
                sh.mem[:] = tile
                v = np.stack([sh.load((t + (u << log2T)) * W + c) for u in range(RADIX)], 1)
                shared.append(sh)
            else:   # floats: 32 lanes on 128 contiguous bytes, one wavefront
                v = np.stack([tile[(t + (u << log2T)) * W + c] for u in range(RADIX)],
                             1).astype(complex)
            # 2. the P-point FFT of each column
            sh = Shared(W * cstride)
            base = c * cstride
            log2Ns = 0
            while True:
                log2r = min(LOG2_RADIX, log2P - log2Ns)
                local_radix_pass(v, t, log2P, log2L, log2Ns, w, log2r)
                if log2Ns + log2r == log2P:
                    break
                local_pass_store(sh, base, v, t, log2P, log2Ns, log2r)
                log2Ns += log2r
                v = np.stack([sh.load(base + pad16(t + (u << log2T))) for u in range(RADIX)], 1)
            # 3. times W_L^(q*k'), into the exchange buffer
            for u in range(RADIX):
                k = t + (u << log2T)
                sh.store(slot(k, c), v[:, u] * stage_twiddle(w, q * k, log2L))
            exch.append(sh)
        # 5-6. CTA q: its G = 16/Q pairs a thread, the DFT_Q over the ranks
        G = RADIX // Q
        for q in range(Q):
            for g in range(G):
                p = tid + (g << log2NT)
                cc = (p >> log2K) if rows_out else p & (W - 1)
                kk = (q << log2K) + ((p & ((1 << log2K) - 1)) if rows_out else p >> log2W)
                vals = np.stack([exch[j].load(slot(kk, cc)) for j in range(Q)], 1)
                X = np.fft.fft(vals, axis=1)          # X[k' + r*P], r < Q
                m = m0 + cc
                for r in range(Q):
                    k = kk + (r << log2P)
                    if rows_out:   # W^(k'(col0 + m)) * W^(P(col0 + m))^r
                        f = tw(kk * (col0 + m)) * tw(P * (col0 + m)) ** r
                        addr, y = m * L + k, X[:, r] * f
                    else:
                        addr, y = k * M + m, X[:, r] * scale
                    stored += len(addr)
                    out.update(zip(addr.tolist(), y))
                    runs += warp_runs(addr, np.ones(len(tid), bool))
        shared += exch
    assert stored == len(out)   # no value stored twice
    return out, shared, runs


def _local_cases():
    """(L, phase): each column length a shard's block has (P = 512 and
    1024 rows a CTA, Q = 1, 2, 4, 8), K6 local ('a') and K7 local ('b')."""
    return [(L, ph) for L in (512, 1024, 2048, 4096, 8192) for ph in ('a', 'b')]


@pytest.mark.parametrize('variant', ['forward', 'inverse', 'real'])
@pytest.mark.parametrize('L,phase', _local_cases())
def test_cluster_column_pass_index_maps(L, phase, variant):
    """K6 local (the (L, 256) block at col0 = 256 of an (L, 1024) matrix)
    and K7 local (an (L, 256) block of n = L*1024, scale 1/n) at
    ``stream.local_geometry``, emulated CTA by CTA over the first and last
    column groups, against their plain versions; the inverse as the
    conjugate of the forward over the same maps ('real': K6 local's float32
    input, K7 local's inverse with the float32 real output). Every
    shared-memory access of a full warp, the distributed reads of step 5
    among them, takes the least wavefronts; K6 local stores 256-byte runs a
    warp, K7 local 32-byte runs (W lanes a row: 4 complex64, 8 float32)."""
    M, other = 256, 1024
    rng = np.random.default_rng(L + len(variant))
    inverse = variant != 'forward' and not (variant == 'real' and phase == 'a')
    real_out = variant == 'real' and phase == 'b'
    x = rng.standard_normal((L, M)) + 1j * rng.standard_normal((L, M))
    if variant == 'real' and phase == 'a':
        x = x.real
    x = x.astype(np.complex64 if np.iscomplexobj(x) else np.float32)
    if phase == 'a':
        t = plan.stream_tables(L, other, torch.complex64, 'cpu')
        w = t.w_n1.numpy().astype(complex)
        geo = stream.local_geometry(L, M, 8, 8 if np.iscomplexobj(x) else 4)
        tw, col0 = factored(t.twiddle), 256
        ref = stream.phase_a_local_plain(torch.from_numpy(x), t, col0, inverse).numpy()
    else:
        t = plan.stream_tables(other, L, torch.complex64, 'cpu')
        w = t.w_n2.numpy().astype(complex)
        geo = stream.local_geometry(L, M, 4 if real_out else 8)
        tw, col0 = None, 0
        ref = stream.phase_b_local_plain(torch.from_numpy(x), t, M, inverse, real_out).numpy()
    xin = x.astype(complex) if np.iscomplexobj(x) else x.astype(np.float64)
    if inverse:   # INV: the conjugate of the forward pass of the conjugate
        xin = np.conj(xin)
    groups = [0, M // geo.columns - 1]
    scale = 1.0 / (L * other) if inverse and phase == 'b' else 1.0
    out, shared, runs = emulate_cluster_pass(xin, w, geo, groups, phase == 'a', tw, col0, scale)
    for sh in shared:
        sh.check_wavefronts()
    addr = np.array(sorted(out))
    got = np.array([out[a] for a in addr])
    if inverse:
        got = np.conj(got)
    if real_out:
        got = got.real
    want = ref.reshape(-1)[addr]
    assert np.abs(got - want).max() / np.abs(ref).max() < 1e-5
    cols = (addr // L if phase == 'a' else addr % M)
    assert sorted(set(cols.tolist())) == [c for g in groups
                                          for c in range(g * geo.columns, (g + 1) * geo.columns)]
    assert len(addr) == 2 * geo.columns * L
    run = 32 if phase == 'a' else geo.columns
    assert all((r == run).all() for r in runs)
