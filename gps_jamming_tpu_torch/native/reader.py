"""ctypes binding and lazy build of the native capture reader (counterpart
of gps_jamming_tpu.native.reader).

`CaptureReader` iterates (sample_offset, planar int8 block) tuples with
overlap-save halos, prefetched by a C++ producer thread
(`capture_reader.cpp`, a byte-for-byte copy of the JAX package's: the
sdrrcv.c:3-107 ring-buffer role). `quantpack` is its fused quantize and
bit-pack of the packed upload widths. The library is built by `g++` at
first use into `gps_jamming_tpu_torch/_build/`, under a name that carries
a hash of the source, and never when the module is imported. Where no
toolchain is available the NumPy reader (`force_numpy`) gives the same
blocks: host I/O either way.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

_HERE = Path(__file__).resolve().parent
SOURCE = _HERE / "capture_reader.cpp"
BUILD_DIR = _HERE.parent / "_build"
_LOCK = threading.Lock()
_LIB = None
_BUILD_ERR: str | None = None
_P8 = ctypes.POINTER(ctypes.c_int8)


def library_path() -> Path:
    h = hashlib.sha256(SOURCE.read_bytes()).hexdigest()[:16]
    return BUILD_DIR / f"capture_reader_{h}.so"


def _build(so: Path) -> str | None:
    """Compile the shared library unless it exists. Returns an error
    message, or None."""
    if so.exists():
        return None
    try:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
        r = subprocess.run(["g++", "-O3", "-std=c++17", "-shared", "-fPIC",
                            "-pthread", str(SOURCE), "-o", str(tmp)],
                           capture_output=True, text=True, timeout=120)
        if r.returncode != 0:
            return r.stderr[-2000:]
        os.replace(tmp, so)
        return None
    except Exception as e:          # no toolchain, read-only tree, ...
        return repr(e)


def _load():
    global _LIB, _BUILD_ERR
    with _LOCK:
        if _LIB is not None or _BUILD_ERR is not None:
            return _LIB
        so = library_path()
        err = _build(so)
        if err is not None:
            _BUILD_ERR = err
            return None
        lib = ctypes.CDLL(str(so))
        lib.rdr_open.restype = ctypes.c_void_p
        lib.rdr_open.argtypes = [ctypes.c_char_p, ctypes.c_int64,
                                 ctypes.c_int64, ctypes.c_int, ctypes.c_int]
        lib.rdr_next.restype = ctypes.c_int64
        lib.rdr_next.argtypes = [ctypes.c_void_p, ctypes.POINTER(_P8),
                                 ctypes.POINTER(ctypes.c_int64)]
        lib.rdr_release.argtypes = [ctypes.c_void_p]
        lib.rdr_close.argtypes = [ctypes.c_void_p]
        lib.rdr_quantpack.restype = None
        lib.rdr_quantpack.argtypes = [_P8, ctypes.c_int64, ctypes.c_int64,
                                      _P8, ctypes.c_int, _P8]
        _LIB = lib
        return _LIB


def native_available() -> bool:
    return _load() is not None


def quantpack_available() -> bool:
    return native_available()


def build_error() -> str | None:
    """Why the native library did not build (None: it built, or no build
    was tried yet)."""
    return _BUILD_ERR


def quantpack(w: np.ndarray, lut: np.ndarray, bits: int) -> np.ndarray:
    """Fused quantize and bit-pack of planar int8 planes (C++, GIL-free).

    w: (n_planes, W) C-contiguous int8; lut: 256 int8 levels indexed by
    the raw byte's uint8 value; bits in {4, 2, 1}, W divisible by 8 //
    bits. Returns (n_planes, W * bits // 8) int8 in the BLOCK wire layout
    (byte j carries samples j + k * W * bits / 8) that the streaming
    receiver's unpack expects. Raises ValueError on any other input and
    RuntimeError where the library did not build (`quantpack_available`).
    """
    if not isinstance(w, np.ndarray) or w.dtype != np.int8 or w.ndim != 2 \
            or not w.flags.c_contiguous:
        raise ValueError("quantpack: w must be a 2-D C-contiguous int8 array")
    if bits not in (4, 2, 1):
        raise ValueError(f"quantpack: bits must be 4, 2 or 1, got {bits}")
    n_planes, width = w.shape
    if width % (8 // bits):
        raise ValueError(f"quantpack: width {width} is not divisible by "
                         f"{8 // bits}")
    lut = np.ascontiguousarray(lut, np.int8)
    if lut.shape != (256,):
        raise ValueError(f"quantpack: lut must hold 256 levels, got "
                         f"{lut.shape}")
    lib = _load()
    if lib is None:
        raise RuntimeError(f"quantpack: the native library did not build: "
                           f"{_BUILD_ERR}")
    out = np.empty((n_planes, width * bits // 8), np.int8)
    lib.rdr_quantpack(w.ctypes.data_as(_P8), ctypes.c_int64(n_planes),
                      ctypes.c_int64(width), lut.ctypes.data_as(_P8),
                      ctypes.c_int(bits), out.ctypes.data_as(_P8))
    return out


def quantpack_numpy(w: np.ndarray, lut: np.ndarray, bits: int) -> np.ndarray:
    """`quantpack` in NumPy: the same bytes, for hosts without g++."""
    q = np.asarray(lut, np.int8)[w.view(np.uint8)]
    width = w.shape[1]
    if bits == 4:
        h = width // 2
        return ((q[:, :h] & 15) | (q[:, h:] << 4)).astype(np.int8)
    if bits == 2:                                   # four samples per byte
        qr = q.reshape(w.shape[0], 4, width // 4)
        return ((qr[:, 0] & 3) | ((qr[:, 1] & 3) << 2)
                | ((qr[:, 2] & 3) << 4) | (qr[:, 3] << 6)).astype(np.int8)
    qr = q.reshape(w.shape[0], 8, width // 8).view(np.uint8)   # sign bits
    acc = np.zeros((w.shape[0], width // 8), np.uint8)
    for k in range(8):
        acc |= (qr[:, k] & 1) << k
    return acc.view(np.int8)


class CaptureReader:
    """Stream a uint8 I/Q capture as planar int8 blocks with halos.

    Iterating yields (sample_offset, block) where block is an int8 array of
    shape (2, halo + n), row 0 the I plane and row 1 the Q plane, and
    sample_offset indexes the first sample after the halo. The last block
    may be shorter than `block_samples`.
    """

    def __init__(self, path: str, block_samples: int,
                 halo_samples: int = 0, n_buffers: int = 4,
                 force_numpy: bool = False):
        self.path = path
        self.block = int(block_samples)
        self.halo = int(halo_samples)
        self.n_buffers = int(n_buffers)
        self._h = None
        self._lib = None if force_numpy else _load()
        if self._lib is not None:
            self._h = self._lib.rdr_open(os.fsencode(path), self.block,
                                         self.halo, self.n_buffers, 1)
            if not self._h:
                raise FileNotFoundError(path)
        elif not os.path.exists(path):
            raise FileNotFoundError(path)

    @property
    def using_native(self) -> bool:
        return self._h is not None

    def __iter__(self):
        if self._h is not None:
            yield from self._iter_native()
        else:
            yield from self._iter_numpy()

    def _iter_native(self):
        data = _P8()
        off = ctypes.c_int64()
        while True:
            n = self._lib.rdr_next(self._h, ctypes.byref(data),
                                   ctypes.byref(off))
            if n == 0:
                return
            total = self.halo + n
            buf = np.ctypeslib.as_array(data, shape=(2 * total,))
            out = buf.reshape(2, total).copy()    # copy before release
            self._lib.rdr_release(self._h)
            yield int(off.value), out

    def _iter_numpy(self):
        halo = np.zeros((2, self.halo), np.int8)
        offset = 0
        with open(self.path, "rb") as f:
            while True:
                raw = np.frombuffer(f.read(2 * self.block), dtype=np.uint8)
                n = raw.size // 2
                if n == 0:
                    return
                conv = (raw[: 2 * n] ^ 0x80).view(np.int8)
                block = np.stack([conv[0::2], conv[1::2]])
                out = np.concatenate([halo, block], axis=1)
                if self.halo:
                    halo = out[:, -self.halo:]
                yield offset, out
                offset += n

    def close(self) -> None:
        if self._h is not None:
            self._lib.rdr_close(self._h)
            self._h = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
