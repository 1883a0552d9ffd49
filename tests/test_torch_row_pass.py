"""The index maps of the register-resident row pass (dsc_tpu_torch/csrc/
fft_rows_reg.cuh) and of the two kernels built on it, K12 (csrc/base_fft.cu)
and K2 (csrc/packed_rfft.cu rfft_phase_b_kernel), emulated thread by
thread in numpy: each block's loads, the Stockham passes (fft_radix.cuh
pass_store and pad16, the twiddle products of row_radix_pass), the
shared-memory exchanges and the stores, against np.fft and K2's plain
version. Every shared-memory access of a full warp must take the least
wavefronts (two for 8-byte accesses), and K2 must store the spectrum in
runs of P values. No CUDA compiler runs on a CPU machine: this checks the
kernels' indexing before the card runs them."""

import numpy as np
import pytest

torch = pytest.importorskip('torch')

from dsc_tpu_torch.fourier import packed_fused as pf  # noqa: E402
from dsc_tpu_torch.fourier import plan  # noqa: E402

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


def row_fft(sh, base, v, t, log2L, w):
    """fft_rows_reg.cuh row_fft."""
    row_radix_pass(v, t, log2L, 0, w, 4)
    row_exchange(sh, base, v, t, log2L, 0)
    row_radix_pass(v, t, log2L, 4, w, 4)
    if log2L == 8:
        return
    row_exchange(sh, base, v, t, log2L, 4)
    row_radix_pass(v, t, log2L, 8, w, log2L - 8)


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
