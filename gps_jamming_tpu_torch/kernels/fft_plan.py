"""The pass schedule of the register FFT (`csrc/fft_reg.cuh`), in Python.

The CUDA header fixes the schedule at compile time, one template
instantiation per power of two; this module mirrors its index arithmetic
so that the CPU tests can run the schedule in NumPy (`emulate`) and hold it
against `np.fft`. Every rule here has a twin in `fft_reg.cuh`
(`RegShape`, `kRadix`, `reg_slot`, the two-level `reg_twiddle` and its
`fine_slot`).

A power-of-two n is split over T = n / P threads, P points each (P = 8 for
n <= 512, else 16). The transform is a Stockham autosort of radix-P passes
and, where log2(n) is no multiple of log2(P), one last pass of a smaller
radix: every pass reads in[i + r*n/R] (r < R) for its butterfly i and
writes out[(i - i%Ns)*R + i%Ns + r*Ns], Ns being the product of the
earlier radices, so input and output are both in natural order. Thread t
owns butterflies i = t + u*T (u < P/R). Between passes the points go
through shared memory at the XOR-swizzled float2 slot `swizzle(a, p)`,
which keeps every pass's reads and writes free of bank conflicts; the
fine twiddle entries sit at `fine_slot`, which does the same for the
twiddle reads (`bank_ways` counts both).
"""
from __future__ import annotations

import numpy as np

FINE_BITS = 6                    # the fine twiddle table's 64 entries


def points_per_thread(n: int) -> int:
    """P: the points each thread holds in registers."""
    return 8 if n <= 512 else 16


def radices(n: int) -> list[int]:
    """The passes' radices: radix-P passes, then the remainder."""
    p = points_per_thread(n)
    out, m = [], n
    while m >= p:
        out.append(p)
        m //= p
    if m > 1:
        out.append(m)
    return out


def threads(n: int) -> int:
    return n // points_per_thread(n)


def swizzle(a, p: int):
    """Shared-memory float2 slot of exchange index a at P = p points per
    thread: a XOR the four bits above its low log2(p) (16 float2 slots
    span the 32 four-byte banks)."""
    return a ^ ((a >> (p.bit_length() - 1)) & 15)


def twiddle_table(n: int) -> np.ndarray:
    """(n/64 + 64,) complex64: coarse exp(-2*pi*i*64*h/n), h < n/64, then
    fine exp(-2*pi*i*l/n), l < 64; computed in float64, stored float32."""
    coarse = np.exp(-2j * np.pi * np.arange(n >> FINE_BITS) * 64.0 / n)
    fine = np.exp(-2j * np.pi * np.arange(1 << FINE_BITS) / n)
    return np.concatenate([coarse, fine]).astype(np.complex64)


def fine_slot(l):
    """Shared-memory slot of fine entry l < 64 (past the coarse entries):
    l XOR its two high bits, so that no pass's twiddle reads conflict."""
    return l ^ (l >> 4)


def _twiddle_addrs(e: int, n: int) -> tuple[int, int]:
    """Shared-memory slots (coarse, fine) of exponent e's two entries."""
    return e >> FINE_BITS, (n >> FINE_BITS) + fine_slot(e & 63)


def stage_table(table: np.ndarray) -> np.ndarray:
    """The table as the kernel stages it in shared memory: coarse entries
    in place, fine entry l at its fine_slot."""
    n_coarse = table.size - (1 << FINE_BITS)
    staged = table.copy()
    staged[n_coarse + fine_slot(np.arange(1 << FINE_BITS))] = \
        table[n_coarse:]
    return staged


def _twiddle(staged: np.ndarray, e: int, n: int, inverse: bool):
    """exp(-+2*pi*i*e/n) as the kernel forms it from the staged table:
    coarse * fine, float32."""
    c, f = _twiddle_addrs(e, n)
    w = np.complex64(staged[c] * staged[f])
    return np.conj(w) if inverse else w


def pass_io(n: int, ns: int, radix: int, t: int, u: int, r: int):
    """(read index, write index) of point r of thread t's u-th butterfly
    in the pass of radix `radix` after earlier radices of product ns."""
    i = t + u * threads(n)
    m = i % ns
    return i + r * (n // radix), (i - m) * radix + m + r * ns


def emulate(x: np.ndarray, inverse: bool = False) -> np.ndarray:
    """The register FFT of a (n,) complex64 row by the kernel's schedule,
    index maps and twiddles, thread by thread, in float32 (no 1/n)."""
    n = x.size
    tab = stage_table(twiddle_table(n))
    n_t, sign = threads(n), (1.0 if inverse else -1.0)
    p = points_per_thread(n)
    slot = np.array([swizzle(a, p) for a in range(n)])
    # the first pass reads the row from device memory, unswizzled
    buf = np.empty(n, np.complex64)
    buf[slot] = x
    ns = 1
    for radix in radices(n):
        nxt = np.empty_like(buf)
        e_r = np.exp(sign * 2j * np.pi * np.arange(radix)[:, None]
                     * np.arange(radix)[None, :] / radix)
        for t in range(n_t):
            for u in range(p // radix):
                idx = [pass_io(n, ns, radix, t, u, r) for r in range(radix)]
                v = np.array([buf[slot[rd]] for rd, _ in idx], np.complex64)
                m = (t + u * n_t) % ns
                if ns > 1:
                    # w^r by repeated products, as the kernel forms them
                    w = _twiddle(tab, m * (n // (ns * radix)), n, inverse)
                    wr = w
                    for r in range(1, radix):
                        v[r] = np.complex64(v[r] * wr)
                        wr = np.complex64(wr * w)
                v = (e_r @ v).astype(np.complex64)
                for r, (_, wr) in enumerate(idx):
                    nxt[slot[wr]] = v[r]
        buf, ns = nxt, ns * radix
    # the last pass's points stay in registers, in natural order
    return buf[slot]


def _ways(addrs) -> int:
    """Bank-pair ways of one half-warp's float2 slots: lanes reading the
    same slot share one access (a broadcast)."""
    return int(max(np.bincount([a % 16 for a in set(addrs)])))


def bank_ways(n: int) -> int:
    """The most distinct float2 slots of one half-warp (16 lanes, 128
    bytes) that share a bank pair, over every pass's exchange reads and
    writes and its twiddle-table reads."""
    worst, ns, n_t, p = 1, 1, threads(n), points_per_thread(n)
    for radix in radices(n):
        for u in range(p // radix):
            for t0 in range(0, n_t, 16):
                lanes = range(t0, min(t0 + 16, n_t))
                for r in range(radix):
                    for which in (0, 1):
                        worst = max(worst, _ways(
                            swizzle(pass_io(n, ns, radix, t, u, r)[which], p)
                            for t in lanes))
                if ns > 1:
                    addrs = [_twiddle_addrs(((t + u * n_t) % ns)
                                            * (n // (ns * radix)), n)
                             for t in lanes]
                    for which in (0, 1):
                        worst = max(worst, _ways(a[which] for a in addrs))
        ns *= radix
    return worst
