"""The pass schedules of the register FFT (`csrc/fft_reg.cuh`), in Python.

The CUDA header fixes each size's schedule at compile time, one template
instantiation per size; this module mirrors its index arithmetic so that
the CPU tests can run the schedules in NumPy (`emulate`) and hold them
against `np.fft`. The sizes and their schedules are read from the header's
table (`SCHEDULES`), and the code periods that kernels B1 and B3 run on it
from `csrc/pcf_correlate.cuh` (`CORRELATE_SIZES`), so both sides run one
table. Every rule here has a twin in the header (`RegShape`, `reg_slot`,
`reg_twiddle` with its `coarse_slot` and `fine_slot`, `split_radix`).

Each size has T threads, an exchange swizzle (pad, shift) and radices in
pass order. A pass of radix R has B = n/R butterflies; thread t runs
i = t + u*T, u < ceil(B/T) (idle past B). Butterfly i reads
in[i + r*B] (r < R) and writes out[(i - i%Ns)*R + i%Ns + r*Ns], Ns being
the product of the earlier radices, so input and output are both in
natural order. Between passes the points go through shared memory at
`slot(a, n)`; the two-level twiddle table sits at `coarse_slot` and
`fine_slot` (`bank_ways` counts the bank conflicts of all three).
"""
from __future__ import annotations

import re
from pathlib import Path

import numpy as np

FINE_BITS = 6                    # the fine twiddle table's 64 entries
_CSRC = Path(__file__).resolve().parent.parent / "csrc"


def _macro_args(header: str, name: str) -> list[list[int]]:
    """The integer arguments of every X(...) in `#define name(X)`."""
    text = (_CSRC / header).read_text()
    block = text[text.index(f"#define {name}(X)"):]
    block = block[:block.index("\n\n")]
    return [[int(a) for a in args.split(",")]
            for args in re.findall(r"X\(([\d,\s]+)\)", block)]


def _read_schedules() -> dict[int, tuple[int, int, int, tuple[int, ...]]]:
    """{n: (T, pad, shift, radices)} from csrc/fft_reg.cuh."""
    return {n: (t, pad, shift, tuple(rad)) for n, t, pad, shift, *rad
            in _macro_args("fft_reg.cuh", "GJT_REG_SCHEDULES")}


SCHEDULES = _read_schedules()
CORRELATE_SIZES = tuple(a[0] for a in _macro_args("pcf_correlate.cuh",
                                                  "GJT_CORR_SIZES"))
LARGE_REG_SIZES = tuple(a[0] for a in _macro_args("fft_large.cuh",
                                                  "GJT_LARGE_REG_SIZES"))


def threads(n: int) -> int:
    return SCHEDULES[n][0]


def radices(n: int) -> tuple[int, ...]:
    return SCHEDULES[n][3]


def slot(a, n: int):
    """Shared-memory float2 slot of exchange index a of an n-point row:
    XOR (pad 0) or padded (pad 1) by the bits above `shift` (16 float2
    slots span the 32 four-byte banks)."""
    _, pad, shift, _ = SCHEDULES[n]
    return a + (a >> shift) if pad else a ^ ((a >> shift) & 15)


def butterflies_per_thread(n: int, radix: int) -> int:
    return -(-(n // radix) // threads(n))


def points(n: int) -> int:
    """P: the most points a thread holds in any pass (its register array)."""
    return max(butterflies_per_thread(n, r) * r for r in radices(n))


def twiddle_table(n: int) -> np.ndarray:
    """(ceil(n/64) + 64,) complex64: coarse exp(-2*pi*i*64*h/n), h <
    ceil(n/64), then fine exp(-2*pi*i*l/n), l < 64; computed in float64,
    stored float32."""
    coarse = np.exp(-2j * np.pi * np.arange(-(-n >> FINE_BITS)) * 64.0 / n)
    fine = np.exp(-2j * np.pi * np.arange(1 << FINE_BITS) / n)
    return np.concatenate([coarse, fine]).astype(np.complex64)


def fine_slot(l):
    """Shared-memory slot of fine entry l < 64 (past the coarse entries):
    l XOR its two high bits, so that no pass's twiddle reads conflict."""
    return l ^ (l >> 4)


def coarse_slot(h, n: int):
    """Shared-memory slot of coarse entry h of an n-point table: h at a
    power of two, else h XOR its next four bits."""
    return h if n & (n - 1) == 0 else h ^ ((h >> 4) & 15)


def _coarse_slots(n: int) -> int:
    """Slots before the fine entries in shared memory: ceil(n/64), rounded
    up to 16."""
    return -(-(-(-n >> FINE_BITS)) // 16) * 16


def _twiddle_addrs(e, n: int):
    """Shared-memory slots (coarse, fine) of exponent e's two entries."""
    return (coarse_slot(e >> FINE_BITS, n),
            _coarse_slots(n) + fine_slot(e & 63))


def stage_table(table: np.ndarray, n: int) -> np.ndarray:
    """The n-point table as the kernel stages it in shared memory: coarse
    entry h at its coarse_slot, fine entry l at its fine_slot."""
    n_coarse = table.size - (1 << FINE_BITS)
    staged = np.zeros(_coarse_slots(n) + (1 << FINE_BITS), np.complex64)
    staged[coarse_slot(np.arange(n_coarse), n)] = table[:n_coarse]
    staged[_coarse_slots(n) + fine_slot(np.arange(1 << FINE_BITS))] = \
        table[n_coarse:]
    return staged


def _twiddle(staged: np.ndarray, e, n: int, inverse: bool):
    """exp(-+2*pi*i*e/n) as the kernel forms it from the staged table:
    coarse * fine, float32 (e a scalar or an array)."""
    c, f = _twiddle_addrs(e, n)
    w = (staged[c] * staged[f]).astype(np.complex64)
    return np.conj(w) if inverse else w


def split_radix(r: int) -> int:
    """A of a composite radix R = A*B: the largest power-of-two factor,
    else the smallest odd prime factor."""
    if r & -r > 1:
        return r & -r
    f = 3
    while r % f:
        f += 2
    return f


def _dft_nat(v: np.ndarray, radix: int, inverse: bool, tab: np.ndarray,
             n: int) -> np.ndarray:
    """The kernel's in-register radix-point DFT of the rows of v (k,
    radix), natural order out: power-of-two and prime radices directly, a
    composite A*B by B-point DFTs, the table's twiddles W_R^(n1*k2) and
    A-point DFTs."""
    sign = 1.0 if inverse else -1.0
    if radix & (radix - 1) == 0 or radix in (3, 5, 7):
        e = np.exp(sign * 2j * np.pi * np.outer(np.arange(radix),
                                                np.arange(radix)) / radix)
        return (v.astype(np.complex128) @ e.T).astype(np.complex64)
    a = split_radix(radix)
    b = radix // a
    y = np.empty_like(v)
    for n1 in range(a):                       # v[n1 + a*n2], over n2
        y[:, n1 + a * np.arange(b)] = _dft_nat(v[:, n1 + a * np.arange(b)],
                                               b, inverse, tab, n)
    for n1 in range(1, a):
        for k2 in range(1, b):
            w = _twiddle(tab, (n1 * k2 % radix) * (n // radix), n, inverse)
            y[:, n1 + a * k2] = (y[:, n1 + a * k2] * w).astype(np.complex64)
    out = np.empty_like(v)
    for k2 in range(b):                       # y[n1 + a*k2], over n1
        out[:, k2 + b * np.arange(a)] = _dft_nat(y[:, np.arange(a) + a * k2],
                                                 a, inverse, tab, n)
    return out


def emulate(x: np.ndarray, inverse: bool = False) -> np.ndarray:
    """The register FFT of a (n,) complex64 row by the kernel's schedule,
    index maps, twiddles (w^r by repeated products) and R-point DFTs, every
    butterfly of a pass at once, in float32 (no 1/n)."""
    n = x.size
    tab = stage_table(twiddle_table(n), n)
    slots = slot(np.arange(n), n)
    buf = np.zeros(int(slots.max()) + 1, np.complex64)
    buf[slots] = x
    ns = 1
    for radix in radices(n):
        b = n // radix
        i = np.arange(b)
        m = i % ns
        v = buf[slot(i[:, None] + b * np.arange(radix)[None, :], n)]
        if ns > 1:
            w = _twiddle(tab, m * (n // (ns * radix)), n, inverse)
            wr = w
            for r in range(1, radix):
                v[:, r] = (v[:, r] * wr).astype(np.complex64)
                wr = (wr * w).astype(np.complex64)
        v = _dft_nat(v, radix, inverse, tab, n)
        nxt = np.zeros_like(buf)
        out = ((i - m) * radix + m)[:, None] + ns * np.arange(radix)[None, :]
        nxt[slot(out, n)] = v
        buf, ns = nxt, ns * radix
    return buf[slots]


def _ways(addrs) -> int:
    """Bank-pair ways of one half-warp's float2 slots: lanes reading the
    same slot share one access (a broadcast)."""
    return int(max(np.bincount([int(a) % 16 for a in set(
        np.asarray(list(addrs)).ravel().tolist())])))


def bank_ways(n: int) -> int:
    """The most distinct float2 slots of one half-warp (16 lanes, 128
    bytes) that share a bank pair, over every pass's exchange reads and
    writes and its twiddle reads, over the half-warps of lanes that run a
    butterfly (the composite radices' own twiddles are one address per
    pass, a broadcast)."""
    n_t, worst, ns = threads(n), 1, 1
    for radix in radices(n):
        b = n // radix
        for u in range(butterflies_per_thread(n, radix)):
            for t0 in range(0, n_t, 16):
                i = np.arange(t0, min(t0 + 16, n_t)) + u * n_t
                i = i[i < b]
                if i.size == 0:
                    continue
                m = i % ns
                for r in range(radix):
                    worst = max(worst, _ways(slot(i + r * b, n)),
                                _ways(slot((i - m) * radix + m + r * ns, n)))
                if ns > 1:
                    c, f = _twiddle_addrs(m * (n // (ns * radix)), n)
                    worst = max(worst, _ways(c), _ways(f))
        ns *= radix
    return worst


# The four-step FFT of csrc/fft_large.cuh, above one block's 16384 points.

def large_split(n: int, max_row: int = 16384) -> tuple[int, int] | None:
    """(n1, n2) of `large_plan`: n1 the least of 2, 4, 8 and 16 with n2 =
    n/n1 <= max_row; None where there is none."""
    for n1 in (2, 4, 8, 16):
        if n % n1 == 0 and n // n1 <= max_row:
            return n1, n // n1
    return None


def large_twiddle(n: int, e, inverse: bool = False):
    """exp(-+2*pi*i*e/n) as `large_twiddle` forms it: the product of two
    entries of the n-point two-level table, float32."""
    tab = twiddle_table(n)
    e = np.asarray(e)
    w = (tab[e >> FINE_BITS] * tab[-(-n >> FINE_BITS) + (e & 63)]).astype(
        np.complex64)
    return np.conj(w) if inverse else w


def four_step_forward(x: np.ndarray) -> np.ndarray:
    """The forward FFT of the rows of x (rows, n) as launch_large_forward
    runs it: the column pass (n1-point DFTs of x[j2 + n2*j1], the twiddle
    w_n^(k1*j2)), then n2-point row FFTs. Returns (rows, n) in the
    permuted order [k1*n2 + k2] = X[k1 + n1*k2], complex64."""
    rows, n = x.shape
    n1, n2 = large_split(n)
    j2 = np.arange(n2)
    cols = x.reshape(rows, n1, n2).astype(np.complex128)    # [j1][j2]
    a = np.fft.fft(cols, axis=1).astype(np.complex64)        # [k1][j2]
    a = a * large_twiddle(n, np.arange(n1)[:, None] * j2[None, :])
    return np.fft.fft(a.astype(np.complex128), axis=2).astype(
        np.complex64).reshape(rows, n)


def four_step_correlate(yp: np.ndarray, rep: np.ndarray,
                        shift: int) -> np.ndarray:
    """|ifft(Y * rep shifted)|^2 * n^2 of one forward row as the correlate
    stage runs it (RowsCorr, then large_cols_corr): yp (n,) in the
    permuted order of `four_step_forward`, rep (n,) natural order. The row
    pass takes the n2-point inverse over k2 of yp[k1*n2 + k2] *
    rep[(k1 - shift + n1*k2) mod n] and multiplies by w_n^-(k1*t2); the
    column pass the n1-point inverse over k1, lag t2 + n2*t1. Returns the
    (n,) float32 power in natural lag order (no 1/n)."""
    n = yp.size
    n1, n2 = large_split(n)
    k1 = np.arange(n1)[:, None]
    k2 = np.arange(n2)[None, :]
    z = yp.reshape(n1, n2) * rep[(k1 - shift + n1 * k2) % n]
    b = (np.fft.ifft(z.astype(np.complex128), axis=1) * n2).astype(
        np.complex64)                                        # [k1][t2]
    b = b * large_twiddle(n, k1 * k2, inverse=True)          # k2 as t2
    x = (np.fft.ifft(b.astype(np.complex128), axis=0) * n1).astype(
        np.complex64)                                        # [t1][t2]
    return (np.abs(x) ** 2).astype(np.float32).reshape(n)


def four_step_depermute(v: np.ndarray) -> np.ndarray:
    """Natural bin order out of the permuted [k1*n2 + k2] = X[k1 + n1*k2]
    (as welch_seg_sum writes its row)."""
    n = v.shape[-1]
    n1, n2 = large_split(n)
    return np.swapaxes(v.reshape(v.shape[:-1] + (n1, n2)), -1, -2).reshape(
        v.shape)


# The mixed-radix shared-memory FFT of csrc/fft_smem.cuh (`fft_mixed`), the
# row FFT of every n off the register FFT's table: the four-step's rows take
# odd primes up to 1021, each above 127 in the direct stage
# (`fft_radix_p_direct`).

def mixed_plan(n: int, max_radix: int = 1021) -> tuple[int, list[int]] | None:
    """(log2 of the power of two, the odd primes ascending) of `make_plan`;
    None where a prime factor is above max_radix."""
    a = (n & -n).bit_length() - 1
    m, odd, p = n >> a, [], 3
    while m > 1 and p <= max_radix:
        while m % p == 0:
            odd.append(p)
            m //= p
        p += 2
    return (a, odd) if m == 1 else None


def digit_rev(i, n: int):
    """`digit_rev`: the slot of input sample i in the digit-reversed row."""
    a, odd = mixed_plan(n)
    i = np.asarray(i)
    pos, r, w = np.zeros_like(i), i.copy(), n
    for p in reversed(odd):
        q = r // p
        w //= p
        pos += (r - q * p) * w
        r = q
    if a:
        rev = np.zeros_like(r)
        for b in range(a):
            rev |= ((r >> b) & 1) << (a - 1 - b)
        pos += rev
    return pos


def half_table(n: int) -> np.ndarray:
    """The shared-memory FFT's table exp(-2*pi*i*k/n), k < (n+1)//2,
    computed in float64, stored float32 (`build.twiddles`)."""
    k = np.arange((n + 1) // 2, dtype=np.float64)
    return np.exp(-2j * np.pi * k / n).astype(np.complex64)


def _half_twiddle(tw: np.ndarray, k, n: int, inverse: bool):
    """`twiddle`: exp(-+2*pi*i*k/n) for 0 <= k < n from the half table."""
    k = np.asarray(k)
    half = (n + 1) // 2
    w = np.where(k < half, tw[np.minimum(k, half - 1)],
                 np.conj(tw[np.clip(n - k, 0, half - 1)]))
    w = np.where(2 * k == n, np.complex64(-1.0), w).astype(np.complex64)
    return np.conj(w) if inverse else w


DIRECT_RUN = 16                 # `kDirectRun` of csrc/fft_smem.cuh


def mixed_fft(x: np.ndarray, inverse: bool = False) -> np.ndarray:
    """`fft_mixed` of a (n,) complex64 row in float32 (no 1/n): the
    digit-reversed load, the radix-2 stages, then one stage per odd prime
    ascending: a butterfly per (group, position) up to 127, the direct
    stage above it (each slot the sum of its p inputs; the twiddle
    W_L^(m*r) the table's at every DIRECT_RUN-th m, products by W_L^r
    between)."""
    n = x.size
    a, odd = mixed_plan(n)
    tw = half_table(n)
    buf = np.empty(n, np.complex64)
    buf[digit_rev(np.arange(n), n)] = x
    for st in range(1, a + 1):
        half, tstride = 1 << (st - 1), n >> st
        j = np.arange(n >> 1)
        pos = j & (half - 1)
        i0 = ((j >> (st - 1)) << st) + pos
        w = tw[pos * tstride]
        w = np.conj(w) if inverse else w
        u, v = buf[i0], (buf[i0 + half] * w).astype(np.complex64)
        buf[i0], buf[i0 + half] = u + v, u - v
    lp = 1 << a
    for p in odd:
        big_l, stride_l = lp * p, n // (lp * p)
        if p <= 127:
            b = np.arange(n // p)
            g, j = b // lp, b % lp
            base = g * big_l + j
            v = np.stack([buf[base + m * lp] for m in range(p)])
            for m in range(1, p):
                v[m] = (v[m] * _half_twiddle(tw, j * m * stride_l, n,
                                             inverse)).astype(np.complex64)
            wp = _half_twiddle(tw, np.arange(p) * (n // p), n, inverse)
            for q in range(p):
                acc = v[0].copy()
                for m in range(1, p):
                    acc += (v[m] * wp[q * m % p]).astype(np.complex64)
                buf[base + q * lp] = acc
        else:
            k = np.arange(n)
            g = k // big_l
            r = k - g * big_l
            q = r // lp
            base = g * big_l + r - q * lp
            ws = _half_twiddle(tw, r * stride_l, n, inverse)
            acc = np.zeros(n, np.complex64)
            for m0 in range(0, p, DIRECT_RUN):
                w = _half_twiddle(tw, (m0 * r % big_l) * stride_l, n,
                                  inverse)
                for m in range(m0, min(m0 + DIRECT_RUN, p)):
                    acc += (buf[base + m * lp] * w).astype(np.complex64)
                    w = (w * ws).astype(np.complex64)
            buf = acc
        lp *= p
    return buf


# The correlate stage in one thread-block cluster per cell
# (csrc/pcf_correlate.cuh, `pcf_correlate_cluster`, `cluster_n1`).

SMEM_PER_BLOCK = 227 * 1024
CLUSTER_WORDS = 136             # red, redi and the published statistics


def _reg_row_bytes(n: int) -> int:
    """The register FFT's exchange buffer and staged table of an n-point
    row above 4096 (one buffer), bytes."""
    _, pad, _, _ = SCHEDULES[n]
    buf = int(slot(n - 1, n)) + 1 if pad else n
    return 8 * (buf + _coarse_slots(n) + (1 << FINE_BITS))


def cluster_smem_bytes(n1: int, n2: int) -> int:
    """A cluster CTA's shared memory in an n1 * n2 plan: its n2-point row
    and table with the power slice (n2 floats) at LARGE_REG_SIZES (the
    register FFT), else the row and its half table (the power slice in
    registers); the n-point two-level table; and CLUSTER_WORDS."""
    tabn = 8 * (-(-(n1 * n2) >> FINE_BITS) + (1 << FINE_BITS))
    if n2 in LARGE_REG_SIZES:
        return _reg_row_bytes(n2) + tabn + 4 * (n2 + CLUSTER_WORDS)
    return 8 * (n2 + (n2 + 1) // 2) + tabn + 4 * CLUSTER_WORDS


def cluster_split(n: int) -> tuple[int, int] | None:
    """(n1, n2) where the cluster plan runs the correlate stage of an
    n-point search above 16384 (`cluster_n1`): n1 <= 8, n2 a multiple of
    n1 and a CTA within SMEM_PER_BLOCK; None where it stays on the
    four-step's two passes."""
    sp = large_split(n)
    if sp is None or sp[0] > 8 or sp[1] % sp[0]:
        return None
    return sp if cluster_smem_bytes(*sp) <= SMEM_PER_BLOCK else None


def cluster_lags(n: int) -> np.ndarray:
    """(n1, n2) int: the lag of CTA k1's power slot t1*S + j (S = n2/n1),
    column t2 = k1*S + j: t1*n2 + t2. A thread of T takes the columns j =
    t + i*T and walks its slots by (t1, i), so its lags ascend."""
    n1, n2 = cluster_split(n)
    s = n2 // n1
    k1 = np.arange(n1)[:, None, None]
    t1 = np.arange(n1)[None, :, None]
    j = np.arange(s)[None, None, :]
    return (t1 * n2 + k1 * s + j).reshape(n1, n2)


def cluster_correlate(yp: np.ndarray, rep: np.ndarray,
                      shift: int) -> np.ndarray:
    """|ifft(Y * rep shifted)|^2 * n^2 of one forward row as the cluster
    runs it: CTA k1's row B[k1] is the n2-point inverse over k2 of
    yp[k1*n2 + k2] * rep[(k1 - shift + n1*k2) mod n]; CTA c then takes its
    columns t2 in [c*S, c*S + S), multiplies B[q][t2] by w_n^-(q*t2), runs
    the n1-point inverse over q and puts |.|^2 into its slot t1*S + t2 -
    c*S, and the slots land at `cluster_lags`. Returns the (n,) float32
    power in natural lag order (no 1/n)."""
    n = yp.size
    n1, n2 = cluster_split(n)
    s = n2 // n1
    k1 = np.arange(n1)[:, None]
    k2 = np.arange(n2)[None, :]
    z = yp.reshape(n1, n2) * rep[(k1 - shift + n1 * k2) % n]
    rows = (np.fft.ifft(z.astype(np.complex128), axis=1) * n2).astype(
        np.complex64)                                        # B[k1][t2]
    slices = np.empty((n1, n2), np.float32)
    for c in range(n1):                                      # CTA c
        t2 = np.arange(c * s, (c + 1) * s)[None, :]
        cols = rows[:, c * s:(c + 1) * s] * large_twiddle(
            n, k1 * t2, inverse=True)
        x = (np.fft.ifft(cols.astype(np.complex128), axis=0) * n1).astype(
            np.complex64)
        slices[c] = (np.abs(x) ** 2).astype(np.float32).reshape(n2)
    out = np.empty(n, np.float32)
    out[cluster_lags(n)] = slices
    return out
