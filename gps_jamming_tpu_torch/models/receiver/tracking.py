"""Code/carrier tracking: batched PLL/DLL/FLL channel loops (counterpart of
gps_jamming_tpu.models.receiver.tracking).

The reference (`sdrtrk.c`) runs one thread per channel and grabs a
variable-length window per epoch so each correlation spans one code period.
Like the JAX package, the port uses the fixed-rate form: every epoch takes
a FIXED window of `n_epoch = fs * epoch` samples, and the code phase lives
in the carry as a fractional chip remainder (`code_rem_chips`) advanced by
the tracked code frequency. Per epoch and channel:
  1. carrier wipe-off by the NCO phasor (mixcarr, sdrcmn.c:581-705);
  2. 2*n_taps+1 tap correlations: shifted code replicas x the mixed window,
     one batched matmul (dot_21/22/23, sdrcmn.c:251-358);
  3. discriminators and 2nd-order loop filters (sdrtrk.c:66-109) with the
     0.53-rule coefficients (sdrinit.c:187-207);
  4. FLL assist during pull-in, locked bandwidths after `pullin_ms`.

`run` is a Python loop over epochs on the input's device; the carry is
batched over channels. It never reads a value back to the host inside the
loop: the pull-in/locked switches are `torch.where` on the epoch-index
tensor, so a per-channel epoch (the streaming receiver's slot ages) costs
nothing extra. No kernel is hand-written here: the JAX package had no
Pallas kernel for tracking either.

Float32 arithmetic is the JAX package's, operation for operation, with
two rules that give the card the CPU's rounding (the loops then differ
only by sums in another order and the last bit of cos, sin and atan2):
- every division by a constant divides by a 0-dim tensor (`_const`), never
  by a Python float, which CUDA rounds as a multiply by its reciprocal;
- every float mod is `torch.remainder` (floor mod, as `jnp.mod` and `%`),
  never `torch.fmod`.
(Jitted, the JAX package itself multiplies by the reciprocal: XLA folds
`x / c` into `x * f32(1/c)` and `x / fs * n` into `x * f32(n/fs)`. The
port keeps the exact quotient; tests/test_torch_tracking.py states what
that does to the closed loop's agreement.)

`jax.lax.dynamic_slice` clamps its start so the slice fits; torch indexing
does not. The tap window starts at s < n_period in a table of
2*n_period + 2*margin + 1 entries, so its slice of n + 2*margin + 1 never
needs the clamp (n == n_period on that path). The chunked gather of `run`
with `start_offsets` reproduces the clamp (`torch.clamp` of the starts to
[0, len(x) - K*n_epoch]); it engages only when a caller asks for more
epochs than the capture holds past its largest offset, which the default
n_epochs never does.
"""
from __future__ import annotations

import functools
import math
from typing import NamedTuple

import numpy as np
import torch

from ...config import TrackingConfig
from ...utils import constants as C
from ...device import as_device
from ...ops import codes as codes_ops


class LoopCoeffs(NamedTuple):
    """2nd-order loop filter coefficients (SoftGNSS/Kaplan form)."""
    c1: torch.Tensor   # proportional: applied to (err - err_prev)
    c2: torch.Tensor   # integral: applied to err * 1 (per epoch)


def loop_coeffs(bw_hz: float, damping: float, dt: float,
                gain: float = 1.0) -> tuple[float, float]:
    """Classic 0.53-rule coefficients: wn = bw/0.53 (sdrinit.c:187-207).

    tau1 = gain / wn^2, tau2 = 2*damping/wn;
    update: freq += c1*(e - e_prev) + c2*e  with c1 = tau2/tau1,
    c2 = dt/tau1.
    """
    wn = bw_hz / 0.53
    tau1 = gain / (wn * wn)
    tau2 = 2.0 * damping / wn
    return tau2 / tau1, dt / tau1


class TrackState(NamedTuple):
    """Per-channel tracking carry (all float32 tensors of shape (n_ch,))."""
    carr_freq_hz: torch.Tensor      # carrier Doppler estimate
    carr_phase_rad: torch.Tensor    # NCO phase at window start
    code_freq_hz: torch.Tensor      # code NCO frequency
    code_nco_hz: torch.Tensor       # accumulated DLL correction [Hz]
    code_rem_chips: torch.Tensor    # code phase (chips) at window start
    perr_prev: torch.Tensor         # previous PLL discriminator
    derr_prev: torch.Tensor         # previous DLL discriminator
    ip_prev: torch.Tensor           # previous prompt I (FLL)
    qp_prev: torch.Tensor           # previous prompt Q (FLL)
    noise_ema: torch.Tensor         # off-peak power EMA (C/N0 denominator)
    sig_ema: torch.Tensor           # prompt power EMA (C/N0 numerator)


class TrackOutputs(NamedTuple):
    """Per-epoch outputs ((n_ch,) per step; (n_epochs, n_ch) from run)."""
    i_prompt: torch.Tensor
    q_prompt: torch.Tensor
    carr_freq_hz: torch.Tensor
    code_freq_hz: torch.Tensor
    code_rem_chips: torch.Tensor
    carr_phase_rad: torch.Tensor
    cn0_dbhz: torch.Tensor
    perr: torch.Tensor
    derr: torch.Tensor


@functools.lru_cache(maxsize=64)
def _const(value: float, device: torch.device) -> torch.Tensor:
    """A cached read-only 0-dim float32 tensor on `device`: the divisor of
    every division by a constant (see the module docstring)."""
    return torch.full((), value, dtype=torch.float32, device=device)


@functools.lru_cache(maxsize=16)
def _ramp(n: int, sample_rate: float, device: torch.device) -> torch.Tensor:
    """Cached float32 t_i = i / fs, i < n (`codes.sample_times`)."""
    return codes_ops.sample_times(n, sample_rate, device)


def _vec(v, n_ch: int, device: torch.device) -> torch.Tensor:
    """A scalar or (n_ch,) value as a float32 (n_ch,) tensor."""
    if isinstance(v, torch.Tensor):
        t = v.to(device=device, dtype=torch.float32)
    else:
        t = torch.as_tensor(np.asarray(v, np.float32), device=device)
    return t.expand(n_ch).clone() if t.dim() == 0 or t.numel() == 1 \
        else t.reshape(n_ch).clone()


def init_state(n_ch: int, doppler_hz, code_phase_samples, sample_rate: float,
               code_len: int = C.GPS_CA_CODE_LEN,
               chip_rate: float = C.GPS_CA_CHIP_RATE_HZ,
               carrier_hz=C.GPS_L1_FREQ_HZ,
               nominal_offset_hz=0.0, device=None) -> TrackState:
    """Seed tracking state from acquisition results.

    `code_phase_samples` is the acquisition peak lag: the sample index
    within the block where the code begins (sdracq.c -> sdrtrk handover),
    so the code phase at window start is code_len - lag*chips_per_sample
    (mod code_len). `doppler_hz` is the Doppler relative to each channel's
    carrier; `nominal_offset_hz` (scalar or per channel) is a static
    baseband offset the carrier NCO also tracks (GLONASS FDMA,
    sdrinit.c:391-399): the stored carr_freq is offset + Doppler.

    device: where the state lives; None takes doppler_hz's device when it
    is a tensor, else the card (`device.as_device`).
    """
    if device is None:
        device = (doppler_hz.device if isinstance(doppler_hz, torch.Tensor)
                  else None)
    dev = as_device(device)
    doppler = _vec(doppler_hz, n_ch, dev)
    offset = _vec(nominal_offset_hz, n_ch, dev)
    carrier = _vec(carrier_hz, n_ch, dev)
    lag = _vec(code_phase_samples, n_ch, dev)
    chips_per_sample = chip_rate / sample_rate
    rem = torch.remainder(-lag * chips_per_sample, code_len)
    # carrier-aided code frequency (sdrtrk.c:105-107)
    fcode = chip_rate * (1.0 + doppler / carrier)
    z = torch.zeros(n_ch, dtype=torch.float32, device=dev)
    one = torch.ones(n_ch, dtype=torch.float32, device=dev)
    return TrackState(
        carr_freq_hz=doppler + offset, carr_phase_rad=z,
        code_freq_hz=fcode, code_nco_hz=z.clone(), code_rem_chips=rem,
        perr_prev=z.clone(), derr_prev=z.clone(), ip_prev=z.clone(),
        qp_prev=z.clone(), noise_ema=one, sig_ema=one.clone())


def _mix_nco(x: torch.Tensor, state: TrackState, sample_rate: float,
             n: int) -> torch.Tensor:
    """Carrier wipe-off per channel: x * e^{-j(phi + 2 pi f t)}.

    x: (n,) complex64 shared by every channel, or (n_ch, n). Returns
    (n_ch, n) complex64."""
    t = _ramp(n, float(sample_rate), x.device)
    phase = (state.carr_phase_rad[:, None]
             + (2.0 * math.pi) * state.carr_freq_hz[:, None] * t[None, :])
    nco = torch.polar(torch.ones_like(phase), -phase)
    return (x[None, :] if x.dim() == 1 else x) * nco


def _corr_taps(taps: torch.Tensor, mixed: torch.Tensor):
    """(n_ch, n_tap, n) replicas x (n_ch, n) mixed -> (I, Q), each
    (n_ch, n_tap), as one float32 batched matmul."""
    iq = torch.bmm(taps, torch.view_as_real(mixed))       # (n_ch, n_tap, 2)
    return iq[..., 0], iq[..., 1]


def _tap_correlate(x: torch.Tensor, code_table: torch.Tensor,
                   state: TrackState, n_taps: int, tap_spacing: int,
                   sample_rate: float,
                   code_len: int) -> tuple[torch.Tensor, torch.Tensor]:
    """All-tap correlation for every channel (exact gather formulation).

    x: (n,) window shared by all channels, or (n_ch, n). code_table:
    (n_ch, code_len) +/-1 chips. Returns (I, Q) of shape (n_ch, 2*n_taps+1),
    taps ordered [-n_taps..+n_taps] * tap_spacing samples (early -> late).
    The tracker takes `_tap_correlate_base` whenever a code period is an
    integer number of samples; this exact path is the oracle.
    """
    n = x.shape[-1]
    n_ch = code_table.shape[0]
    dev = x.device
    chips_per_sample = state.code_freq_hz / _const(float(sample_rate), dev)
    mixed = _mix_nco(x, state, sample_rate, n)
    tap_off = (torch.arange(-n_taps, n_taps + 1, dtype=torch.float32,
                            device=dev) * tap_spacing)         # samples
    i_idx = torch.arange(n, dtype=torch.float32, device=dev)
    chip_phase = (state.code_rem_chips[:, None, None]
                  + (i_idx[None, None, :] + tap_off[None, :, None])
                  * chips_per_sample[:, None, None])
    idx = torch.remainder(torch.floor(chip_phase).to(torch.int64), code_len)
    taps = torch.gather(code_table, 1, idx.reshape(n_ch, -1)).reshape(
        n_ch, 2 * n_taps + 1, n)
    return _corr_taps(taps, mixed)


def resample_base_table(code_table: np.ndarray, chips_per_sample: float,
                        n_period: int, margin: int) -> np.ndarray:
    """Host-precomputed NN-resampled code, tiled for shift extraction.

    base[c, j] = chips[c, floor((j - margin) * cps) mod L] for
    j in [0, 2*n_period + 2*margin + 1): one code period resampled to the
    sample grid (the role of `rescode`, sdrcmn.c:527-579), tiled twice plus
    tap margin so any circular shift in [0, n_period) plus tap offsets in
    [-margin, margin] is a contiguous window.
    """
    n_ch, code_len = code_table.shape
    j = np.arange(2 * n_period + 2 * margin + 1)
    idx = np.floor((j - margin) * chips_per_sample).astype(np.int64) % code_len
    return np.ascontiguousarray(code_table[:, idx], dtype=np.float32)


def resample_base_table_torch(code_table: torch.Tensor,
                              chips_per_sample: float, n_period: int,
                              margin: int) -> torch.Tensor:
    """`resample_base_table` of a code table already on the device (the
    counterpart of `resample_base_table_jnp`): one gather per `run` call."""
    code_len = code_table.shape[-1]
    j = np.arange(2 * n_period + 2 * margin + 1)
    idx = np.floor((j - margin) * chips_per_sample).astype(np.int64) % code_len
    return torch.index_select(code_table, -1,
                              torch.from_numpy(idx).to(code_table.device))


def _tap_correlate_base(x: torch.Tensor, base3: torch.Tensor,
                        state: TrackState, n_taps: int, tap_spacing: int,
                        sample_rate: float, chip_rate: float, n_period: int
                        ) -> tuple[torch.Tensor, torch.Tensor]:
    """Shift-based all-tap correlation (no per-epoch code gather).

    The replica at code phase `rem` is a circular shift of the
    base-resampled code by sigma = rem/cps samples: the integer part picks
    a window of the tiled table `base3` (n_ch, 2*n_period + 2*margin + 1),
    the fractional part blends two neighbouring shifts linearly. The start
    s = floor(sigma) mod n_period < n_period, so the window of
    n + 2*margin + 1 samples always fits (n == n_period here).
    """
    n = x.shape[-1]
    dev = x.device
    margin = n_taps * tap_spacing
    mixed = _mix_nco(x, state, sample_rate, n)
    sigma = state.code_rem_chips / _const(chip_rate / sample_rate, dev)
    fl = torch.floor(sigma)
    s = torch.remainder(fl.to(torch.int64), n_period)
    lam = sigma - fl
    win_len = n + 2 * margin + 1
    win = torch.gather(base3, 1, s[:, None] + torch.arange(win_len,
                                                           device=dev))
    blended = (1.0 - lam[:, None]) * win[:, :-1] + lam[:, None] * win[:, 1:]
    taps = blended.unfold(1, n, tap_spacing)             # (n_ch, n_tap, n)
    return _corr_taps(taps, mixed)


def _discriminators(corr_i: torch.Tensor, corr_q: torch.Tensor,
                    state: TrackState, n_taps: int, dt: float):
    """PLL (Costas atan), FLL (cross/dot), DLL (E-L envelope) errors.

    Mirrors pll/dll of sdrtrk.c:66-109. The FLL's cross*sign(dot) form is
    invariant under a data-symbol flip between the prompts (the JAX
    package's note on Galileo E1B); range +/-1/(4*dt).
    """
    ip = corr_i[:, n_taps]
    qp = corr_q[:, n_taps]
    perr = torch.atan2(qp * torch.sign(ip), torch.abs(ip))
    cross = state.ip_prev * qp - state.qp_prev * ip
    dot = state.ip_prev * ip + state.qp_prev * qp
    dsign = torch.where(dot >= 0.0, 1.0, -1.0)
    ferr = torch.atan2(cross * dsign, torch.abs(dot) + 1e-12) \
        / _const(2.0 * math.pi * dt, ip.device)
    ie, qe = corr_i[:, n_taps - 1], corr_q[:, n_taps - 1]
    il, ql = corr_i[:, n_taps + 1], corr_q[:, n_taps + 1]
    e_env = torch.sqrt(ie * ie + qe * qe)
    l_env = torch.sqrt(il * il + ql * ql)
    derr = (e_env - l_env) / torch.clamp(e_env + l_env, min=1e-12) / 2.0
    return perr, ferr, derr, ip, qp


def _largest_divisor(n: int, cap: int = 16) -> int:
    """The largest divisor of n that is <= cap (1 for n < 1)."""
    for cand in range(min(cap, n), 0, -1):
        if n % cand == 0:
            return cand
    return 1


def make_tracker(code_table: np.ndarray, sample_rate: float,
                 cfg: TrackingConfig,
                 code_len: int = C.GPS_CA_CODE_LEN,
                 chip_rate: float = C.GPS_CA_CHIP_RATE_HZ,
                 carrier_hz=C.GPS_L1_FREQ_HZ,
                 epoch_ms: float = 1.0,
                 nominal_offset_hz=0.0):
    """Build the multi-channel tracking step and its runner.

    code_table: (n_ch, code_len) host numpy +/-1 chips for the tracked PRNs.
    carrier_hz / nominal_offset_hz: scalar or per-channel (n_ch,): FDMA
    constellations track carr_freq = channel offset + Doppler, and the
    carrier-aided code NCO scales only the Doppler part by chip_rate/carrier
    (sdrtrk.c:105-107 with the sdrinit.c:391-399 mapping). Returns
    (step, run, n_epoch):
      step(state, (x_window, epoch_idx)) -> (state', TrackOutputs of one
        epoch); x_window (n_epoch,) or (n_ch, n_epoch) complex64;
      run(state, x) -> (state', TrackOutputs stacked (n_epochs, n_ch)).
    The constant tables move to the input's device at first use there.

    `run` also takes (table_arg, carrier_arg, offset_arg) tensors that
    override the build-time constants (which then only fix shapes), so one
    tracker serves any channel-to-slot assignment, as the streaming
    receiver's re-acquisition cycle needs (sdrmain.c:248-400).
    """
    dt = epoch_ms * 1e-3
    n_epoch = int(round(sample_rate * dt))
    table_np = np.asarray(code_table, np.float32)
    n_ch_static = table_np.shape[0]
    # shift-based fast correlator: one code period is an integer number of
    # samples (2048 @ 2.048 MS/s GPS, 16384 @ 4.096 MS/s E1B, 10000 @
    # 10 MS/s G1)
    cps0 = chip_rate / sample_rate
    period_f = code_len / cps0
    n_period = int(round(period_f))
    margin = cfg.n_taps * cfg.tap_spacing_samples
    use_base = abs(period_f - n_period) < 1e-6 and n_period == n_epoch
    base_np = (resample_base_table(table_np, cps0, n_period, margin)
               if use_base else None)
    carrier_np = np.broadcast_to(np.asarray(carrier_hz, np.float32),
                                 (n_ch_static,)).copy()
    offset_np = np.broadcast_to(np.asarray(nominal_offset_hz, np.float32),
                                (n_ch_static,)).copy()
    n_taps = cfg.n_taps
    # the configured bandwidths assume 1 ms epochs; clamp so the
    # proportional gain stays at <= 0.5 of the discrete-time stability
    # bound c1*2*pi*dt < 2 at longer epochs (Galileo's 4 ms)
    bw_max = 0.5 / (2.0 * np.pi * (2.0 * cfg.damping / 0.53) * dt)
    c1p_pull, c2p_pull = loop_coeffs(min(cfg.pll_bw_pullin_hz, bw_max),
                                     cfg.damping, dt)
    c1p_lock, c2p_lock = loop_coeffs(min(cfg.pll_bw_locked_hz, bw_max),
                                     cfg.damping, dt)
    c1d_pull, c2d_pull = loop_coeffs(min(cfg.dll_bw_pullin_hz, bw_max),
                                     cfg.damping, dt)
    c1d_lock, c2d_lock = loop_coeffs(min(cfg.dll_bw_locked_hz, bw_max),
                                     cfg.damping, dt)
    # staged pull-in: a 1st-order FLL closes the coarse frequency error,
    # then the PLL takes over (the reference's prm1/prm2 switch)
    kf = 4.0 * cfg.fll_bw_pullin_hz * dt * 0.25
    fll_epochs = int(cfg.pullin_ms / epoch_ms) // 4
    pullin_epochs = int(cfg.pullin_ms / epoch_ms)
    ema = 1.0 / max(cfg.snr_smooth_ms / epoch_ms, 1.0)
    two_pi = 2.0 * math.pi

    @functools.lru_cache(maxsize=4)
    def consts(device: torch.device):
        """(table, base3, carrier, offset) on `device`, built once."""
        def to(a):
            return None if a is None else torch.from_numpy(a).to(device)
        return to(table_np), to(base_np), to(carrier_np), to(offset_np)

    def step_with(state: TrackState, inputs, tab, carr, offs_hz,
                  base_tab=None):
        x, epoch_idx = inputs
        dev = x.device
        epoch_idx = torch.as_tensor(epoch_idx, device=dev)
        fll_stage = epoch_idx < fll_epochs
        locked = epoch_idx >= pullin_epochs
        if base_tab is not None:
            corr_i, corr_q = _tap_correlate_base(
                x, base_tab, state, n_taps, cfg.tap_spacing_samples,
                sample_rate, chip_rate, n_period)
        else:
            corr_i, corr_q = _tap_correlate(
                x, tab, state, n_taps, cfg.tap_spacing_samples, sample_rate,
                code_len)
        perr, ferr, derr, ip, qp = _discriminators(corr_i, corr_q, state,
                                                   n_taps, dt)
        c1p = torch.where(locked, c1p_lock, c1p_pull)
        c2p = torch.where(locked, c2p_lock, c2p_pull)
        c1d = torch.where(locked, c1d_lock, c1d_pull)
        c2d = torch.where(locked, c2d_lock, c2d_pull)

        carr_freq = torch.where(
            fll_stage,
            state.carr_freq_hz + kf * ferr,
            state.carr_freq_hz
            + c1p * (perr - state.perr_prev) + c2p * perr)
        # carrier-aided code NCO (sdrtrk.c:105-107) minus the accumulated
        # DLL correction (SoftGNSS codeNco form)
        code_nco = (state.code_nco_hz
                    + c1d * (derr - state.derr_prev) + c2d * derr)
        code_freq = chip_rate * (1.0 + (carr_freq - offs_hz) / carr) \
            - code_nco

        # advance the NCO phases over the epoch
        carr_phase = torch.remainder(
            state.carr_phase_rad + two_pi * state.carr_freq_hz * dt, two_pi)
        code_rem = torch.remainder(
            state.code_rem_chips
            + state.code_freq_hz / _const(float(sample_rate), dev) * n_epoch,
            float(code_len))

        # C/N0: prompt power vs outermost-tap power, EMA-smoothed
        p_sig = ip * ip + qp * qp
        p_noise = corr_i[:, 0] ** 2 + corr_q[:, 0] ** 2
        sig_ema = state.sig_ema + ema * (p_sig - state.sig_ema)
        noise_ema = state.noise_ema + ema * (p_noise - state.noise_ema)
        snr_lin = torch.clamp(sig_ema - noise_ema, min=1e-12) / \
            torch.clamp(noise_ema, min=1e-12)
        cn0 = 10.0 * torch.log10(snr_lin / _const(dt, dev))

        new = TrackState(
            carr_freq_hz=carr_freq, carr_phase_rad=carr_phase,
            code_freq_hz=code_freq, code_nco_hz=code_nco,
            code_rem_chips=code_rem,
            perr_prev=perr, derr_prev=derr, ip_prev=ip, qp_prev=qp,
            noise_ema=noise_ema, sig_ema=sig_ema)
        out = TrackOutputs(
            i_prompt=ip, q_prompt=qp, carr_freq_hz=carr_freq,
            code_freq_hz=code_freq, code_rem_chips=state.code_rem_chips,
            carr_phase_rad=state.carr_phase_rad, cn0_dbhz=cn0,
            perr=perr, derr=derr)
        return new, out

    def step(state: TrackState, inputs):
        table, base3, carrier_v, offset_v = consts(inputs[0].device)
        return step_with(state, inputs, table, carrier_v, offset_v, base3)

    def run(state: TrackState, x: torch.Tensor, start_epoch=0,
            start_offsets=None, table_arg=None, carrier_arg=None,
            offset_arg=None, n_epochs: int | None = None):
        """Run the tracker over a capture x (n,) complex64 on x's device.

        start_offsets: optional (n_ch,) int per-channel window starts.
        With offsets, channel c's epoch-k window is
        x[off_c + k*n_epoch : ...]: aligning each channel to its acquired
        code boundary keeps data-symbol edges out of the windows (essential
        for Galileo E1B's one symbol per 4 ms code period). Windows are
        gathered K epochs at a time (K the largest divisor of n_epochs
        <= 16), one (n_ch, K*n_epoch) gather per chunk, so they are
        exactly the JAX package's. start_epoch: an int or a per-channel
        (n_ch,) epoch index of the first window (slot ages).

        table_arg / carrier_arg / offset_arg: tensors on x's device that
        override the build-time constants.
        """
        dev = x.device
        table, base3, carrier_v, offset_v = consts(dev)
        tab = table if table_arg is None else table_arg
        carr = carrier_v if carrier_arg is None else carrier_arg
        offs_hz = offset_v if offset_arg is None else offset_arg
        if not use_base:
            base = None
        elif table_arg is None:
            base = base3
        else:
            # one device-side resample per run, outside the epoch loop
            base = resample_base_table_torch(tab, cps0, n_period, margin)

        st0 = torch.as_tensor(start_epoch, device=dev).to(torch.int64)
        outs: list[TrackOutputs] = []
        st = state
        if start_offsets is None:
            n_ep = x.shape[-1] // n_epoch if n_epochs is None else n_epochs
            windows = x[..., : n_ep * n_epoch].reshape(n_ep, n_epoch)
            idx = torch.arange(n_ep, device=dev) + st0
            for e in range(n_ep):
                st, o = step_with(st, (windows[e], idx[e]), tab, carr,
                                  offs_hz, base)
                outs.append(o)
        else:
            offs_np = np.asarray(
                start_offsets.cpu() if isinstance(start_offsets, torch.Tensor)
                else start_offsets, np.int64).reshape(-1)
            if n_epochs is None:
                n_epochs = int((x.shape[-1] - int(offs_np.max())) // n_epoch)
            K = _largest_divisor(n_epochs)
            n_ch = offs_np.size
            offs = torch.from_numpy(offs_np).to(dev)
            span = torch.arange(K * n_epoch, device=dev)
            # the clamp of jax.lax.dynamic_slice (see the module docstring)
            hi = max(x.shape[-1] - K * n_epoch, 0)
            idx = (torch.arange(n_epochs, device=dev)[:, None]
                   + st0.reshape(-1)[None, :])        # (n_epochs, n_ch|1)
            for c in range(n_epochs // K):
                starts = torch.clamp(offs + c * (K * n_epoch), 0, hi)
                wins = x[starts[:, None] + span].reshape(n_ch, K, n_epoch)
                for k in range(K):
                    st, o = step_with(st, (wins[:, k], idx[c * K + k]), tab,
                                      carr, offs_hz, base)
                    outs.append(o)
        if not outs:
            empty = torch.empty((0,) + tuple(state.carr_freq_hz.shape),
                                dtype=torch.float32, device=dev)
            return st, TrackOutputs(*([empty] * len(TrackOutputs._fields)))
        return st, TrackOutputs(*[torch.stack(f) for f in zip(*outs)])

    return step, run, n_epoch
