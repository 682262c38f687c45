"""Which sizes kernels B1, B3 and B2 take, and which the JAX package's
Pallas kernels take: one rule, in one place. `ops.cuda_pcf`,
`ops.cuda_caf`, `ops.cuda_psd` and `ops.caf.plain_on_card` read it here.

Up to build.FFT_MAX_N a row runs in one block: n from build.FFT_MIN_N with
every prime factor <= build.FFT_MAX_RADIX (the C gate gets the same bounds
as -D defines). Above it a row runs the four-step FFT of csrc/fft_large.cuh
(rows of at most build.FFT_MAX_N points with prime factors up to
build.FFT_ROW_MAX_RADIX), at the sizes that the JAX package's Pallas kernel
for the same computation takes there: B1 up to v3's 32768, B2 up to
`pallas_psd`'s 131072, B3 every multiple of 128 up to build.FFT_STD_MAX_N.
The rule they meet together: for every n <= build.FFT_STD_MAX_N that a
Pallas kernel takes, the port's kernel takes n too.
"""
from __future__ import annotations

import math

from . import build

# Above build.FFT_MAX_N the wrappers allocate the four-step's scratch per
# call, in chunks of at most this many bytes.
LARGE_SCRATCH_BYTES = 512 << 20

# The JAX package's gates for its Pallas kernels, copied:
# `pallas_caf.factorization` (v1), `factorization_v2`, `factorization_v3`,
# `supported_v3`, `supported_pcf` and `pallas_psd.supported`. An n that
# none of them takes is one the reference computes in XLA.
_LANE, _MAX_N2, _MAX_LANES_V3 = 128, 1024, 4096
_V2_N1S = (128, 64, 32, 16, 8, 4, 2, 1)
_V3_N1S = (32, 16, 8, 4, 2, 1)

# B2 up to 16384: the mixed-radix nperseg of the TPU kernel
# (`pallas_psd.supported`: 128 * 2^a * {3, 5, 7}); the C gate of
# csrc/welch_psd.cu lists the same sizes, each a schedule of the register
# FFT (csrc/fft_reg.cuh, `fft_plan.SCHEDULES`).
MIXED_NPERSEG = (384, 640, 768, 896, 1280, 1536, 1792, 2560, 3072, 3584,
                 5120, 6144, 7168, 10240, 12288, 14336)


def tpu_n2(n: int, n1s) -> tuple[int, int] | None:
    """The first (n1, n/n1) over n1s with n/n1 a lane multiple, or None
    when there is none or its n/n1 is above the cap."""
    for n1 in n1s:
        if n % n1 == 0 and (n // n1) % _LANE == 0:
            return (n1, n // n1) if n // n1 <= _MAX_N2 else None
    return None


def tpu_v1(n: int) -> bool:
    return any(n % n1 == 0 and (n // n1) % _LANE == 0
               for n1 in range(2, 257))


def tpu_v3(n: int, n_prn: int | None = None) -> bool:
    """v3's factorization, and with n_prn its cap on lanes."""
    f = tpu_n2(n, _V3_N1S)
    if f is None or n_prn is None:
        return f is not None
    step = _LANE // math.gcd(_LANE, f[0])
    return -(-n_prn // step) * step * f[0] <= _MAX_LANES_V3


def tpu_kernel_takes(n: int, n_prn: int, pcf: bool) -> bool:
    """Does the JAX package run a Pallas kernel for this search on a TPU?
    PCF: only v3 (`supported_pcf`); std: v3, v2 or v1 (`fused_dispatch`)."""
    if pcf:
        return tpu_v3(n, n_prn)
    return tpu_v3(n, n_prn) or tpu_n2(n, _V2_N1S) is not None or tpu_v1(n)


def tpu_psd_takes(nperseg: int) -> bool:
    """Does the JAX package's Pallas Welch kernel take this nperseg?
    (`pallas_psd.supported`: `factorization_v2`, up to 128 * 1024.)"""
    return tpu_n2(nperseg, _V2_N1S) is not None


def small_primes(n: int, max_radix: int = build.FFT_MAX_RADIX) -> bool:
    """Are all of n's prime factors <= max_radix?"""
    for p in range(2, max_radix + 1):
        while n % p == 0:
            n //= p
        if n == 1:
            return True
    return n == 1


def _one_block(n: int) -> bool:
    return build.FFT_MIN_N <= n <= build.FFT_MAX_N and small_primes(n)


def _one_block_reason(n: int) -> str:
    if n < build.FFT_MIN_N:
        return f"n {n} is below {build.FFT_MIN_N}"
    return f"n {n} has a prime factor above {build.FFT_MAX_RADIX}"


def pcf_supported(n: int) -> bool:
    """Kernel B1's code-period lengths: up to 16384 every n from 128 whose
    prime factors are all <= 127 (the register FFT for powers of two,
    csrc/fft_reg.cuh; the mixed-radix shared-memory FFT for the rest,
    csrc/fft_smem.cuh); above it the n that v3 factorizes (n1 = 32, n2 a
    lane multiple up to 1024: 20480, 24576, 28672 and 32768)."""
    if n > build.FFT_MAX_N:
        return n <= build.FFT_LARGE_MAX_N and tpu_v3(n)
    return _one_block(n)


def pcf_unsupported_reason(n: int) -> str:
    if n > build.FFT_MAX_N:
        return (f"n {n} above {build.FFT_MAX_N} is not one the JAX "
                f"package's v3 factorizes (32 x a multiple of 128 up to "
                f"1024)")
    return _one_block_reason(n)


def std_supported(n: int) -> bool:
    """Kernel B3's code-period lengths: up to 16384 those of B1; above it
    every multiple of 128 up to 262144 whose prime factors are all <= 1021
    (the JAX package's v1 takes n1*128*m with n1 <= 256, its v2 n up to
    128*1024; up to 262144 their n have no prime factor above 1021)."""
    if n > build.FFT_MAX_N:
        return (n <= build.FFT_STD_MAX_N and n % _LANE == 0
                and small_primes(n, build.FFT_ROW_MAX_RADIX))
    return _one_block(n)


def std_unsupported_reason(n: int) -> str:
    if n > build.FFT_STD_MAX_N:
        return (f"n {n} is above {build.FFT_STD_MAX_N}, the cap of kernel "
                f"B3's four-step FFT")
    if n > build.FFT_MAX_N and n % _LANE:
        return f"n {n} above {build.FFT_MAX_N} is not a multiple of {_LANE}"
    if n > build.FFT_MAX_N:
        return (f"n {n} has a prime factor above "
                f"{build.FFT_ROW_MAX_RADIX}")
    return _one_block_reason(n)


def psd_supported(nperseg: int) -> bool:
    """Kernel B2's nperseg: a power of two in [64, 16384] or one of
    MIXED_NPERSEG (one block per segment); above 16384 every nperseg the
    TPU kernel takes (20480 ... 131072)."""
    if nperseg > build.FFT_MAX_N:
        return nperseg <= build.FFT_LARGE_MAX_N and tpu_psd_takes(nperseg)
    return (64 <= nperseg and nperseg & (nperseg - 1) == 0) \
        or nperseg in MIXED_NPERSEG
