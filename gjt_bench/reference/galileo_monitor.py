"""Plain PyTorch reference of one block of the Galileo E1B block monitor:
what the monitor reports for a block of complex-sampled I/Q (interleaved
uint8, centred at 127.5), in float64 on any device (the CPU in tests, the
card in the cell's check).

- PSD: two-sided Welch (periodic Hann, 50 % overlap, each segment's complex
  mean removed, density scaling 1 / (fs * sum w^2)), natural FFT order.
- Chunk power: mean |x|^2 (+1e-10) per chunk, the last partial chunk
  included; flags: power above the block's 5th percentile (linear
  interpolation) times 10^(6/10), a baseline <= 0 taken as 1.
- Per-PRN peak of the PCF acquisition search over the first `n_periods`
  code periods of n samples, as `reference/monitor.py` states it for GPS:
  2 groups of n_periods / 2 periods; rows (c, s, f) for every integer bin
  shift c (fs / n, 250 Hz at 8.192 MS/s and 32768) within +/- max_doppler,
  sub-bin sets s * fs / (2 n) (s = 0, 1) and fine offsets f of -200, 0 and
  +200 Hz applied as a phase per code period;
  P[p, lag] = sum_g |IFFT(FFT(y_sfg) * conj(FFT(code_p))[k - c])[lag]|^2,
  y_sfg(t) = e^{-j2pi s fs/(2n) t} sum_{b in g} e^{-j2pi (f + s fs/(2n)) b T}
  x_b(t); the peak is the maximum over rows and lags. Each PRN's surface
  (n_c * 6 rows of n lags) is made and reduced alone, so that 36 PRNs at
  32768 lags fit the card.

Departures from the ICD and the upstream, kept because the port keeps them:
the fine offsets are the GPS search's +/-200 Hz, applied per 4 ms period,
where 200 Hz is 0.8 of a cycle: the labels of the fine rows alias (their
phase steps are those of -50, 0 and +50 Hz), which the peak does not read;
the replica is the E1B code alone, with no E1C pilot; the 250 sps symbols
flip the sign of whole periods inside a coherent group, as on the air.

The E1B primary codes are this module's own copy of the ICD's memory codes
(`data/e1b_primary_codes.txt`, hex, most significant bit first, logical 0
as +1), BOC(1,1) written from the ICD: the sine-phased 1.023 MHz
subcarrier is +1 over the first half of each chip and -1 over the second,
so each chip becomes the half-chips (+c, -c) at 2.046 MHz; a sample takes
the half-chip under its time (floor).

Every stage's result passes through `round_to`, which leaves the float64
reference as it is and rounds the control to bfloat16, as
`precision.round_to` does for the GPS reference.
"""
from __future__ import annotations

import functools
from pathlib import Path

import torch

CODES_FILE = Path(__file__).resolve().parent / "data" / "e1b_primary_codes.txt"
E1B_CODE_LEN = 4092
E1B_CHIP_RATE_HZ = 1.023e6
E1B_PERIOD_S = 4e-3
E1_HZ = 1575.42e6
F64, C128 = torch.float64, torch.complex128


def round_to(t: torch.Tensor, precision: str) -> torch.Tensor:
    """`t` (real or complex) rounded to `precision`, returned in float64 /
    complex128: 'float64' leaves it as it is, 'bfloat16' rounds the real
    and imaginary parts to the nearest bfloat16."""
    if precision == "float64":
        return t
    if precision != "bfloat16":
        raise ValueError(f"unknown precision {precision!r}")
    if t.is_complex():
        return torch.complex(round_to(t.real, precision),
                             round_to(t.imag, precision))
    return t.to(torch.bfloat16).to(F64)


@functools.lru_cache(maxsize=1)
def _code_bits() -> dict[int, tuple[int, ...]]:
    out = {}
    for line in CODES_FILE.read_text().splitlines():
        if not line.strip() or line.startswith("#"):
            continue
        prn, hexdigits = line.split()
        bits = bin(int(hexdigits, 16))[2:].zfill(4 * len(hexdigits))
        out[int(prn)] = tuple(int(b) for b in bits[:E1B_CODE_LEN])
    return out


def e1b_code(prn: int, device="cpu") -> torch.Tensor:
    """(4092,) float64 +/-1 E1B primary code of `prn` (1..50 in the file)."""
    bits = torch.tensor(_code_bits()[prn], dtype=F64, device=device)
    return 1.0 - 2.0 * bits


def e1b_boc(prn: int, device="cpu") -> torch.Tensor:
    """(8184,) float64 BOC(1,1) half-chips of `prn`'s E1B code."""
    c = e1b_code(prn, device)
    return torch.stack([c, -c], dim=-1).reshape(-1)


def sampled(code: torch.Tensor, rate_hz: float, fs: float,
            n: int) -> torch.Tensor:
    """The chip held over each of n samples: floor(i * rate / fs)."""
    i = torch.arange(n, dtype=F64, device=code.device)
    idx = torch.floor(i * (rate_hz / fs)).to(torch.int64) % code.numel()
    return code[idx]


def iq_from_bytes(raw_u8: torch.Tensor) -> torch.Tensor:
    """Interleaved uint8 I/Q -> complex128, centred (u - 127.5)."""
    v = raw_u8.to(F64) - 127.5
    return torch.complex(v[0::2], v[1::2])


def welch(x: torch.Tensor, fs: float, nperseg: int = 1024,
          precision: str = "float64") -> torch.Tensor:
    hop = nperseg // 2
    seg = x.unfold(0, nperseg, hop)
    seg = round_to(seg - seg.mean(dim=1, keepdim=True), precision)
    k = torch.arange(nperseg, dtype=F64, device=x.device)
    w = 0.5 - 0.5 * torch.cos(2.0 * torch.pi * k / nperseg)
    spec = round_to(torch.fft.fft(round_to(seg * w, precision), dim=1),
                    precision)
    p = round_to(spec.real ** 2 + spec.imag ** 2, precision)
    return round_to(p.mean(dim=0) / (fs * torch.sum(w * w)), precision)


def chunk_power(x: torch.Tensor, chunk: int,
                precision: str = "float64") -> torch.Tensor:
    p = round_to(x.real ** 2 + x.imag ** 2, precision)
    n_full = p.numel() // chunk
    out = [p[: n_full * chunk].reshape(n_full, chunk).mean(dim=1)]
    if p.numel() % chunk:
        out.append(p[n_full * chunk:].mean().reshape(1))
    return round_to(torch.cat(out) + 1e-10, precision)


def power_flags(pm: torch.Tensor, percentile: float = 5.0,
                rise_db: float = 6.0) -> torch.Tensor:
    base = float(torch.quantile(pm, percentile / 100.0))
    if base <= 0:
        base = 1.0
    return pm > base * 10.0 ** (rise_db / 10.0)


def pcf_peaks(x: torch.Tensor, fs: float, prns=range(1, 37),
              n_code: int = 32768, n_periods: int = 10,
              max_doppler_hz: float = 7000.0, n_sets: int = 2,
              fine_hz=(-200.0, 0.0, 200.0), n_groups: int = 2,
              precision: str = "float64") -> torch.Tensor:
    """(len(prns),) PCF search peak per PRN over the first n_periods code
    periods of x, one PRN's surface at a time."""
    def r(a):
        return round_to(a, precision)

    dev = x.device
    blocks = x[: n_periods * n_code].reshape(n_groups,
                                             n_periods // n_groups, n_code)
    period = n_code / fs
    set_off = fs / n_code / n_sets
    t = torch.arange(n_code, dtype=F64, device=dev) / fs
    b = torch.arange(n_periods, dtype=F64, device=dev).reshape(
        n_groups, -1) * period                                # (G, gl)
    rows = []
    for s in range(n_sets):
        for f in fine_hz:
            wf = f + s * set_off
            w = torch.exp(torch.complex(torch.zeros_like(b),
                                        -2.0 * torch.pi * wf * b))
            y = torch.einsum("gb,gbn->gn", w, blocks)
            mix = torch.exp(torch.complex(torch.zeros_like(t),
                                          -2.0 * torch.pi * s * set_off * t))
            rows.append(r(y * mix))
    Y = r(torch.fft.fft(torch.stack(rows), dim=-1))           # (R, G, n)
    n_c = 2 * int(max_doppler_hz // (fs / n_code)) + 1
    shifts = torch.arange(n_c, device=dev) - n_c // 2
    k = torch.arange(n_code, device=dev)
    idx = (k[None, :] - shifts[:, None]) % n_code             # (C, n)
    peaks = []
    for prn in prns:
        code = sampled(e1b_boc(prn, dev), 2.0 * E1B_CHIP_RATE_HZ, fs, n_code)
        rep = torch.conj(torch.fft.fft(code.to(C128)))
        repc = r(rep[idx])                                    # (C, n)
        prod = r(repc[:, None, None, :] * Y[None])            # (C, R, G, n)
        v = r(torch.fft.ifft(prod, dim=-1))
        del prod
        surf = r(r(v.real ** 2 + v.imag ** 2).sum(dim=2))     # (C, R, n)
        del v
        peaks.append(surf.max())
    return torch.stack(peaks)


def block(raw_u8: torch.Tensor, cfg: dict,
          precision: str = "float64") -> dict:
    """The four answers of one block from its bytes (on their device),
    under the configuration `cfg` (`configs/galileo_e1b_8m192.json`'s
    keys), as float64 / bool tensors on that device."""
    fs = float(cfg["sample_rate_hz"])
    acq, det = cfg["acquisition"], cfg["detector"]
    lo, hi = cfg["prns"]
    x = round_to(iq_from_bytes(raw_u8), precision)
    pm = chunk_power(x, det["power_chunk_samples"], precision)
    return {"psd": welch(x, fs, cfg["psd_nperseg"], precision), "pm": pm,
            "flags": power_flags(pm, det["baseline_percentile"],
                                 det["power_rise_db"]),
            "peak": pcf_peaks(x, fs, range(lo, hi + 1), acq["code_samples"],
                              acq["code_periods"], acq["max_doppler_hz"],
                              precision=precision)}
