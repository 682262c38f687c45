"""Build and load the port's CUDA kernels.

The sources under `gps_jamming_tpu_torch/csrc/` are compiled by `nvcc`, one
process per source, all started together, and linked into one shared
library with a plain C interface, at first use, and loaded with `ctypes`.
The library lands in `gps_jamming_tpu_torch/_build/` under a name that
carries a hash of the sources and flags, so an edit rebuilds and an
unchanged tree reuses the file. Nothing is built when the package is
imported.

Every launching entry point is called through `launch`, which counts the
launch in `LAUNCHES`.
"""
from __future__ import annotations

import collections
import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import NamedTuple

import torch

from . import fft_plan

PKG_DIR = Path(__file__).resolve().parent.parent
CSRC = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"
SOURCES = ("welch_psd.cu", "pcf.cu", "caf_std.cu", "block_front.cu")
HEADERS = ("fft_smem.cuh", "fft_reg.cuh", "fft_large.cuh",
           "pcf_correlate.cuh")
ARCH = ("-gencode", "arch=compute_90a,code=sm_90a")
# The code-period lengths the FFTs of kernels B1 and B3 take:
# n in [FFT_MIN_N, FFT_MAX_N] with every prime factor <= FFT_MAX_RADIX. The
# C gate (`row_plan`, csrc/pcf_correlate.cuh) gets them as -D defines, and
# kernels/gates.py reads them here: one rule for both.
FFT_MIN_N, FFT_MAX_N, FFT_MAX_RADIX = 128, 16384, 127
# Above FFT_MAX_N the rows of kernels B1, B3 and B2 run the four-step FFT
# of csrc/fft_large.cuh, n = n1 * n2 with n2 <= FFT_MAX_N and every prime
# factor of n2 <= FFT_ROW_MAX_RADIX, up to FFT_LARGE_MAX_N for B1 and B2
# and FFT_STD_MAX_N for B3 (GJT_FFT_* in the C gate, `large_plan`). The
# JAX package's v1 takes n = n1 * 128 * m with n1 <= 256, so up to 262144
# every prime factor of such an n is at most 1021.
FFT_LARGE_MAX_N = 131072
FFT_STD_MAX_N = 262144
FFT_ROW_MAX_RADIX = 1021
# The most power chunks kernel F1 takes in one call (a power of two: its
# last block sorts them in shared memory, 32 KB at the most).
FRONT_MAX_CHUNKS = 8192
NVCC_FLAGS = (*ARCH, "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
              f"-DGJT_FFT_MIN_N={FFT_MIN_N}", f"-DGJT_FFT_MAX_N={FFT_MAX_N}",
              f"-DGJT_FFT_MAX_RADIX={FFT_MAX_RADIX}",
              f"-DGJT_FFT_ROW_MAX_RADIX={FFT_ROW_MAX_RADIX}",
              f"-DGJT_FFT_LARGE_MAX_N={FFT_LARGE_MAX_N}",
              f"-DGJT_FFT_STD_MAX_N={FFT_STD_MAX_N}",
              f"-DGJT_FRONT_MAX_CHUNKS={FRONT_MAX_CHUNKS}")

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    "gjt_welch_scratch_bytes": [_I],
    "gjt_welch_psd": [_P, _P, _P, _P, _P, _I, _I, _I, ctypes.c_float, _P],
    "gjt_pcf": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                _I, _I, _P],
    "gjt_caf_std": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P],
    "gjt_welch_psd_large": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I,
                            _I, ctypes.c_float, _P],
    "gjt_pcf_large": [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                      _I, _I, _I, _I, _P],
    "gjt_caf_std_large": [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                          _I, _I, _P],
    "gjt_corr_cluster_n1": [_I],
    "gjt_front_scratch_bytes": [],
    "gjt_block_front": [_P, _P, _P, _P, _P, ctypes.c_longlong, _I,
                        ctypes.c_float, ctypes.c_float, _P],
}
# The launching entry points, each with the kernel it counts under in
# LAUNCHES (the names chip_smoke.py prints).
KERNEL_OF = {
    "gjt_welch_psd": "welch_psd", "gjt_welch_psd_large": "welch_psd",
    "gjt_pcf": "pcf", "gjt_pcf_large": "pcf",
    "gjt_caf_std": "caf_std", "gjt_caf_std_large": "caf_std",
    "gjt_block_front": "front",
}
# The launching entry points that take a `Scratch` argument.
TAKES_SCRATCH = frozenset({"gjt_welch_psd", "gjt_block_front"})
# Launches made through `launch`, per kernel: one per wrapper call (B2:
# one per row).
LAUNCHES: collections.Counter = collections.Counter()


class Scratch(NamedTuple):
    """An argument of `launch`: zeroed uint8 scratch of `sizer(*args)`
    bytes, `sizer` the C entry point that sizes a kernel's scratch. The
    kernels leave its tickets at zero after every call, so calls on one
    stream may reuse it; another stream gets its own."""
    sizer: str
    args: tuple = ()


def find_nvcc() -> str | None:
    """$CUDA_HOME/bin/nvcc, then nvcc on PATH, then /usr/local/cuda."""
    cands = []
    if os.environ.get("CUDA_HOME"):
        cands.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    on_path = shutil.which("nvcc")
    if on_path:
        cands.append(on_path)
    cands.append("/usr/local/cuda/bin/nvcc")
    for c in cands:
        if os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    return None


def source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES + HEADERS:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    return h.hexdigest()[:16]


def library_path() -> Path:
    return BUILD_DIR / f"libgjt_kernels_{source_hash()}.so"


def _run(procs: list[tuple[list[str], subprocess.Popen]],
         verbose: bool) -> None:
    """Wait for every nvcc process; raise with the first failure's stderr."""
    failed = None
    for cmd, proc in procs:
        _, err = proc.communicate()
        if proc.returncode != 0 and failed is None:
            failed = (proc.returncode, cmd, err)
        elif verbose and err:
            print(err)
    if failed is not None:
        rc, cmd, err = failed
        raise RuntimeError(f"nvcc failed ({rc}): {' '.join(cmd)}\n{err}")


def build(verbose: bool = False) -> Path:
    """Compile the kernels if the hashed library is missing; return its
    path. Each source compiles in its own nvcc process, all at once, then
    one nvcc links them. Raises RuntimeError (with nvcc's stderr) when nvcc
    is missing or fails."""
    out = library_path()
    if out.exists():
        return out
    nvcc = find_nvcc()
    if nvcc is None:
        raise RuntimeError(
            "nvcc not found ($CUDA_HOME/bin, PATH, /usr/local/cuda/bin): the "
            "CUDA kernels of gps_jamming_tpu_torch can only be built on a "
            "machine with the CUDA toolkit and an sm_90a (Hopper) card")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs, procs = [], []
        for src in SOURCES:
            obj = os.path.join(tmp, src + ".o")
            cmd = [nvcc, *NVCC_FLAGS, *(["-Xptxas", "-v"] if verbose else []),
                   "-c", "-o", obj, str(CSRC / src)]
            objs.append(obj)
            procs.append((cmd, subprocess.Popen(
                cmd, stdout=subprocess.DEVNULL, stderr=subprocess.PIPE,
                text=True)))
        _run(procs, verbose)
        lib = os.path.join(tmp, out.name)
        cmd = [nvcc, *ARCH, "-shared", "-o", lib, *objs]
        _run([(cmd, subprocess.Popen(cmd, stdout=subprocess.DEVNULL,
                                     stderr=subprocess.PIPE, text=True))],
             verbose)
        os.replace(lib, out)
    return out


@functools.lru_cache(maxsize=1)
def load() -> ctypes.CDLL:
    """The loaded kernel library, built at first use."""
    lib = ctypes.CDLL(str(build()))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


def check(err: int, name: str) -> None:
    """Raise if a C entry point returned a non-zero cudaError_t."""
    if err != 0:
        raise RuntimeError(f"{name} failed: {torch.cuda.CudaError(err)}")


def launch(entry: str, device: torch.device, *args) -> None:
    """Call the launching C entry point `entry` with `args` and `device`'s
    current stream as its last argument, on `device`; raise RuntimeError
    naming `entry` if it fails, else count one launch of its kernel. A
    `Scratch` argument of an entry in TAKES_SCRATCH becomes the pointer to
    that scratch on this device and stream."""
    kernel = KERNEL_OF[entry]
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream().cuda_stream
        if entry in TAKES_SCRATCH:
            args = [_scratch(a, device, stream).data_ptr()
                    if type(a) is Scratch else a for a in args]
        err = getattr(load(), entry)(*args, stream)
    check(err, entry)
    LAUNCHES[kernel] += 1


def launch_counts() -> dict[str, int]:
    """LAUNCHES with every kernel's key, 0 where it made none."""
    return {k: LAUNCHES[k] for k in KERNEL_OF.values()}


@functools.lru_cache(maxsize=32)
def _scratch(spec: Scratch, device: torch.device,
             stream: int) -> torch.Tensor:
    return torch.zeros(getattr(load(), spec.sizer)(*spec.args),
                       dtype=torch.uint8, device=device)


def scratch(spec: Scratch, device: torch.device) -> torch.Tensor:
    """The scratch that `launch` passes for `spec` on `device`'s current
    stream."""
    with torch.cuda.device(device):
        return _scratch(spec, device, torch.cuda.current_stream().cuda_stream)


@functools.lru_cache(maxsize=16)
def twiddles(n: int, device) -> torch.Tensor:
    """((n+1)//2,) complex64 exp(-2*pi*i*k/n), computed in float64 on the
    host: the half table of fft_smem.cuh (n/2 entries for even n), which
    the rows of B1 and B3 read at an n off `fft_plan.CORRELATE_SIZES`.
    Cached per (n, device); read-only."""
    return torch.from_numpy(fft_plan.half_table(n)).to(device)


@functools.lru_cache(maxsize=16)
def reg_twiddles(n: int, device) -> torch.Tensor:
    """The two-level table of the register FFT (csrc/fft_reg.cuh;
    `fft_plan.twiddle_table`: ceil(n/64) coarse, then 64 fine entries,
    computed in float64), which kernel B2 takes at every nperseg. Cached per
    (n, device); read-only."""
    return torch.from_numpy(fft_plan.twiddle_table(n)).to(device)


def row_twiddles(n: int, device) -> torch.Tensor:
    """The table kernels B1 and B3 take for an n-point row: `reg_twiddles`
    at a size of `fft_plan.CORRELATE_SIZES` (the register FFT), else
    `twiddles(n)`."""
    if n in fft_plan.CORRELATE_SIZES:
        return reg_twiddles(n, device)
    return twiddles(n, device)


def large_row_twiddles(n: int, device) -> torch.Tensor:
    """The table of the n2-point rows of an n-point four-step FFT
    (csrc/fft_large.cuh, `fft_plan.large_split`): the two-level table at a
    size of `fft_plan.LARGE_REG_SIZES` (the register FFT), else the half
    table (the shared-memory FFT)."""
    n2 = fft_plan.large_split(n)[1]
    if n2 in fft_plan.LARGE_REG_SIZES:
        return reg_twiddles(n2, device)
    return twiddles(n2, device)
