"""Per-sample NumPy oracles mirroring the reference engine's DSP semantics.

These are deliberately naive sample-by-sample loops written from the
behavioural spec in SURVEY.md (reference file:line cited per function); the
JAX implementations are validated against them within tight tolerances.
"""

from __future__ import annotations

import math

import numpy as np

F32 = np.float32
EPS100 = 100.0 * np.finfo(np.float32).eps
MINUS_INF_DB = -200.0


def linear_to_db(v: float) -> float:
    # reference: src/utils.rs:25-36
    if v < 0.0 or math.isnan(v):
        return float("nan")
    if v == 1.0:
        return 0.0
    if v > 1e-12:
        return math.log(v) * (20.0 / math.log(10.0))
    return MINUS_INF_DB


def db_to_linear(v: float) -> float:
    # reference: src/utils.rs:40-51
    if math.isnan(v):
        return float("nan")
    if v == 0.0:
        return 1.0
    if v > MINUS_INF_DB:
        return math.exp(v * (math.log(10.0) / 20.0))
    return 0.0


def panning_factors(pan: float) -> tuple[float, float]:
    # reference: src/utils.rs:55-63
    n = (min(max(pan, -1.0), 1.0) + 1.0) / 2.0
    return math.sqrt(1.0 - n) * math.sqrt(2.0), math.sqrt(n) * math.sqrt(2.0)


# ---------------------------------------------------------------------------
# Smoothers (src/utils/smoothing.rs) — exact per-sample state machines.
# ---------------------------------------------------------------------------


class ExpSmoother:
    """src/utils/smoothing.rs:122-233 (f32 state machine)."""

    def __init__(self, value: float, sample_rate: int, inertia: float = 1.0 / 256.0):
        self.current = F32(value)
        self.target = F32(value)
        self.inertia = F32(inertia)
        self.comp = F32(44100.0 / sample_rate)

    def _inc(self) -> np.float32:
        return F32((self.target - self.current) * self.inertia * self.comp)

    def need_ramp(self) -> bool:
        return abs(self._inc()) > EPS100

    def set_target(self, t: float):
        self.target = F32(t)
        if not self.need_ramp():
            self.current = self.target

    def next(self) -> float:
        if self.need_ramp():
            self.current = F32(self.current + self._inc())
            return float(self.current)
        return float(self.target)

    def run(self, n: int) -> np.ndarray:
        return np.array([self.next() for _ in range(n)], np.float32)


class LinSmoother:
    """src/utils/smoothing.rs:238-420."""

    def __init__(self, value: float, sample_rate: int, step: float = 0.01):
        self.current = F32(value)
        self.target = F32(value)
        self.step = F32(step)
        self.comp = F32(44100.0 / sample_rate)
        self.current_step = F32(0.0)
        self.pending = 0

    def set_target(self, t: float):
        self.target = F32(t)
        if self.current == self.target:
            self.pending = 0
            return
        self.current_step = F32(
            -self.step * self.comp if self.current > self.target else self.step * self.comp
        )
        self.pending = max(int(round(float((self.target - self.current) / self.current_step))), 0)
        if self.pending == 0:
            self.current = self.target

    def next(self) -> float:
        if self.pending > 0:
            self.current = F32(self.current + self.current_step)
            self.pending -= 1
            if self.pending == 0:
                self.current = self.target
            return float(self.current)
        return float(self.target)

    def run(self, n: int) -> np.ndarray:
        return np.array([self.next() for _ in range(n)], np.float32)


class SpringSmoother:
    """src/utils/smoothing.rs:424-545."""

    def __init__(self, value: float, sample_rate: int, duration: int = 4410):
        self.current = F32(value)
        self.velocity = F32(0.0)
        self.target = F32(value)
        self.omega = F32(5.5 / duration)
        self.comp = F32(44100.0 / sample_rate)

    def need_ramp(self) -> bool:
        return abs(self.velocity) > EPS100 or abs(self.target - self.current) > EPS100

    def set_target(self, t: float):
        self.target = F32(t)

    def next(self) -> float:
        if self.need_ramp():
            w = F32(self.omega * self.comp)
            k = F32(w * w)
            d = F32(2.0 * w)
            self.velocity = F32(
                self.velocity + (self.target - self.current) * k - self.velocity * d
            )
            self.current = F32(self.current + self.velocity)
            return float(self.current)
        return float(self.target)

    def run(self, n: int) -> np.ndarray:
        return np.array([self.next() for _ in range(n)], np.float32)


def error_db(a: np.ndarray, b: np.ndarray, ref_peak: float | None = None) -> float:
    """Peak error in dB relative to the reference signal's peak."""
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    peak = ref_peak if ref_peak is not None else max(np.max(np.abs(b)), 1e-12)
    err = np.max(np.abs(a - b))
    if err == 0.0:
        return -np.inf
    return 20.0 * math.log10(err / peak)


# ---------------------------------------------------------------------------
# TPT filter core (src/utils/dsp/filters/biquad.rs:320-340, svf.rs:215-235)
# ---------------------------------------------------------------------------


def tpt_filter(x, a1, a2, a3, m0, m1, m2, ic1=0.0, ic2=0.0):
    """f64 per-sample oracle. Coefficients may be scalars or arrays[n]."""
    x = np.asarray(x, np.float64)
    n = len(x)
    a1, a2, a3, m0, m1, m2 = [np.broadcast_to(np.asarray(c, np.float64), (n,)) for c in (a1, a2, a3, m0, m1, m2)]
    y = np.empty(n)
    for i in range(n):
        v0 = x[i]
        v3 = v0 - ic2
        v1 = a1[i] * ic1 + a2[i] * v3
        v2 = ic2 + a2[i] * ic1 + a3[i] * v3
        ic1 = 2.0 * v1 - ic1
        ic2 = 2.0 * v2 - ic2
        y[i] = m0[i] * v0 + m1[i] * v1 + m2[i] * v2
    return y, (ic1, ic2)


def dc_filter(x, r, y1=0.0, x1=0.0):
    x = np.asarray(x, np.float64)
    y = np.empty(len(x))
    for i, s in enumerate(x):
        y1 = s - x1 + r * y1
        x1 = s
        y[i] = y1
    return y


# ---------------------------------------------------------------------------
# AHDSR state machine (src/utils/ahdsr.rs) — f32, unscaled path
# ---------------------------------------------------------------------------


class Ahdsr:
    def __init__(self, sr, attack, hold, decay, sustain, release):
        self.sr = sr
        self.attack_rate = F32(1.0 / (attack * sr)) if attack > 0 else np.float32(np.finfo(np.float32).max)
        self.hold_time = hold
        self.decay_time = decay
        self.decay_rate = F32((1.0 - sustain) / (decay * sr)) if decay > 0 else np.float32(np.finfo(np.float32).max)
        self.sustain = F32(sustain)
        self.release_time = release
        self.release_rate = F32(1.0 / (release * sr)) if release > 0 else np.float32(np.finfo(np.float32).max)
        self.stage = "idle"
        self.output = F32(0.0)
        self.target_volume = F32(0.0)
        self.hold_remaining = F32(0.0)
        self.release_output = F32(0.0)

    def note_on(self, volume):
        self.target_volume = F32(volume)
        if self.attack_rate == np.finfo(np.float32).max:
            self.output = F32(volume)
            if self.hold_time > 0:
                self.stage = "hold"
                self.hold_remaining = F32(self.hold_time * self.sr)
            else:
                self.stage = "decay"
        else:
            self.output = F32(0.0)
            self.stage = "attack"

    def note_off(self):
        if self.release_time > 0:
            self.target_volume = F32(0.0)
            self.release_output = self.output
            self.stage = "release" if self.release_output > np.finfo(np.float32).eps else "idle"
        else:
            self.output = F32(0.0)
            self.release_output = F32(0.0)
            self.stage = "idle"

    def run(self):
        if self.stage == "attack":
            self.output = F32(self.output + self.attack_rate)
            if self.output >= self.target_volume:
                self.output = self.target_volume
                self.target_volume = self.sustain
                if self.hold_time > 0:
                    self.stage = "hold"
                    self.hold_remaining = F32(self.hold_time * self.sr)
                else:
                    self.stage = "decay"
        elif self.stage == "hold":
            self.hold_remaining = F32(self.hold_remaining - 1.0)
            if self.hold_remaining <= 0.0:
                self.stage = "sustain" if self.decay_time == 0 else "decay"
        elif self.stage == "decay":
            if self.output > self.sustain:
                self.output = F32(self.output - self.decay_rate)
                if self.output <= self.sustain:
                    self.output = self.sustain
                    self.stage = "sustain"
            else:
                self.output = F32(self.output + self.decay_rate)
                if self.output >= self.sustain:
                    self.output = self.sustain
                    self.stage = "sustain"
        elif self.stage == "release":
            self.output = F32(self.output - self.release_output * self.release_rate)
            if self.output <= 0.001:
                self.output = F32(0.0)
                self.stage = "idle"
        return float(self.output)

    def run_block(self, n):
        return np.array([self.run() for _ in range(n)], np.float32)


# ---------------------------------------------------------------------------
# LFO deterministic waveforms (src/utils/dsp/lfo.rs)
# ---------------------------------------------------------------------------


def sine_approx(x):
    B = 4.0 / math.pi
    C = -4.0 / (math.pi * math.pi)
    P = 0.225
    y = B * x + C * x * abs(x)
    return P * (y * abs(y) - y) + y


def lfo_run(waveform, phase0, inc, n):
    phase = phase0
    out = np.empty(n, np.float32)
    for i in range(n):
        if waveform == "sine":
            p = phase * 2 * math.pi if phase < 0.5 else (phase - 1.0) * 2 * math.pi
            out[i] = sine_approx(p)
        elif waveform == "triangle":
            out[i] = phase * 4 if phase < 0.25 else (2.0 - phase * 4 if phase < 0.75 else phase * 4 - 4)
        elif waveform == "ramp_up":
            out[i] = phase * 2 - 1
        elif waveform == "ramp_down":
            out[i] = 1 - phase * 2
        elif waveform == "square":
            out[i] = 1.0 if phase < 0.5 else -1.0
        phase += inc
        if phase >= 1.0:
            phase -= 1.0
    return out


def envelope_follower(x, attack_coef, release_coef, y0=0.0):
    y = np.float32(y0)
    out = np.empty(len(x), np.float32)
    for i, v in enumerate(np.asarray(x, np.float32)):
        c = attack_coef if v > y else release_coef
        y = F32(v + c * (y - v))
        out[i] = y
    return out


class Fader:
    """src/utils/fader.rs (per-frame gain only)."""

    def __init__(self, sr):
        self.sr = sr
        self.state = "stopped"
        self.current = F32(1.0)
        self.target = F32(1.0)
        self.inertia = F32(1.0)

    def start(self, from_v, to_v, duration):
        if duration == 0:
            self.current = F32(to_v)
            self.target = F32(to_v)
            self.state = "finished"
        else:
            self.state = "running"
            self.current = F32(from_v)
            self.target = F32(to_v)
            samples = self.sr * duration / 4.605
            self.inertia = F32(1.0 - math.exp(-1.0 / samples))

    def gains(self, n):
        """per-frame gains for one block, reference block semantics"""
        out = np.empty(n, np.float32)
        if self.state != "running":
            out[:] = self.target if self.state == "finished" else 1.0
            return out
        for i in range(n):
            self.current = F32(self.current + (self.target - self.current) * self.inertia)
            out[i] = self.current
        if abs(self.current - self.target) < 0.0001:
            self.state = "finished"
        return out


# ---------------------------------------------------------------------------
# Distortion waveshapers (src/effect/distortion.rs:124-188)
# ---------------------------------------------------------------------------

MAX_DRIVE = 4.0


def shaper_soft_clip(x, drive):
    t = drive / MAX_DRIVE
    gain = 1.0 + t * t * 14.0
    xg = x * gain
    if xg >= 1.0:
        return 1.0
    if xg > -1.0:
        return x if gain <= 1.0 else 1.5 * (xg - xg**3 / 3.0)
    return -1.0


def shaper_hard_clip(x, drive):
    t = drive / MAX_DRIVE
    gain = 1.0 + t * t * 24.0
    thr = 1.0 / gain
    return min(max(x, -thr), thr) * gain


def shaper_diode(x, drive):
    t = drive / MAX_DRIVE
    curve = 0.6 * t * t + 0.4 * t
    gain = 1.0 + curve * 19.0
    d = math.exp((0.1 * x) / (0.0253 * 1.68)) - 1.0
    return 2.0 / math.pi * math.atan(d * gain)


def shaper_fuzz(x, drive):
    t = drive / MAX_DRIVE
    gain = 1.0 + (1.0 - math.exp(-3.0 * t)) * 29.0
    amp = x * gain
    sat = -(1.0 - math.exp(-abs(amp))) if amp < 0 else (1.0 - math.exp(-abs(amp)))
    return 1.5 * (sat + abs(sat))


def shaper_fold(x, drive):
    t = drive / MAX_DRIVE
    gain = 1.0 + t * t * 3.0
    xg = x * gain
    thr = 1.0 / gain
    if xg > thr or xg < -thr:
        return abs(math.fmod(abs(xg - thr), thr * 4.0) - thr * 2.0) - thr
    return xg


SHAPERS = {
    "SoftClip": shaper_soft_clip, "HardClip": shaper_hard_clip,
    "Diode": shaper_diode, "Fuzz": shaper_fuzz, "Fold": shaper_fold,
}


# ---------------------------------------------------------------------------
# Gate (src/effect/gate.rs:147-195)
# ---------------------------------------------------------------------------


def gate_gains(stereo, sr, threshold, attack, hold, release, range_db):
    """Per-frame gain factors the reference gate would apply."""
    env = -120.0
    hold_counter = 0
    gain_db = range_db
    ac = math.exp(-1.0 / (attack * sr))
    rc = math.exp(-1.0 / (release * sr))
    hold_samples = int(hold * sr)
    n = stereo.shape[1]
    gains = np.empty(n)
    for i in range(n):
        peak = max(abs(stereo[0, i]), abs(stereo[1, i]))
        in_db = 20.0 * math.log10(peak) if peak > 1e-6 else -120.0
        c = ac if in_db > env else rc
        env = in_db + c * (env - in_db)
        if env >= threshold:
            hold_counter = hold_samples
            target = 0.0
        elif hold_counter > 0:
            hold_counter -= 1
            target = 0.0
        else:
            target = range_db
        c2 = ac if target > gain_db else rc
        gain_db = c2 * gain_db + (1.0 - c2) * target
        gains[i] = 0.0 if gain_db <= -60.0 else db_to_linear(gain_db)
    return gains


# ---------------------------------------------------------------------------
# Compressor (src/effect/compressor.rs + LookupDelayLine, dsp/delay.rs:160-280)
# ---------------------------------------------------------------------------


def compressor(stereo, sr, threshold, ratio, knee, attack, release, makeup, lookahead):
    n = stereo.shape[1]
    d = int(math.ceil(lookahead * sr))
    buf = np.zeros((max(d, 1), 2))
    env = -120.0 if ratio >= 20.0 else 0.0
    ac = math.exp(-1.0 / (attack * sr))
    rc = math.exp(-1.0 / (release * sr))
    out = np.empty_like(stereo)
    hist = np.zeros(n + d)  # |peak| history for the sliding window
    for i in range(n):
        frame = stereo[:, i]
        if d > 0:
            delayed = buf[i % d].copy()
            buf[i % d] = frame
        else:
            delayed = frame
        fp = max(abs(frame[0]), abs(frame[1]))
        hist[i + d] = fp
        if ratio >= 20.0:
            peak = hist[i + 1 : i + d + 1].max() if d > 0 else fp
        else:
            peak = fp
        in_db = 20.0 * math.log10(peak) if peak > 1e-6 else -120.0
        c = ac if in_db > env else rc
        env = in_db + c * (env - in_db)
        slope = 1.0 if ratio >= 20.0 else 1.0 - 1.0 / ratio
        lower, upper = threshold - knee / 2, threshold + knee / 2
        if knee > 0.0 and lower < env < upper:
            xk = (env - lower) / knee
            gr = xk * xk * slope * knee / 2.0
        elif env > upper:
            gr = (env - threshold) * slope
        else:
            gr = 0.0
        gain = db_to_linear(makeup - gr)
        out[:, i] = delayed * gain
    return out


# ---------------------------------------------------------------------------
# Dub delay (src/effect/delay.rs) — per-sample oracle, f64 state
# ---------------------------------------------------------------------------


class InterpDelayLine:
    """src/utils/dsp/delay.rs:79-160 (single channel)."""

    def __init__(self, max_size):
        size = 1
        while size < max_size:
            size *= 2
        self.buf = np.zeros(size)
        self.mask = size - 1
        self.wpos = 0

    def process(self, x, feedback, delay):
        rp = self.wpos - delay
        ip = math.floor(rp)
        frac = rp - ip
        v1 = self.buf[ip & self.mask]
        v2 = self.buf[(ip + 1) & self.mask]
        out = v1 + (v2 - v1) * frac
        self.buf[self.wpos & self.mask] = x + out * feedback
        self.wpos += 1
        return out


class SvfState:
    def __init__(self):
        self.ic1 = 0.0
        self.ic2 = 0.0

    def run(self, x, g, k):
        a1 = 1.0 / (1.0 + g * (g + k))
        a2 = g * a1
        a3 = g * a2
        v3 = x - self.ic2
        v1 = a1 * self.ic1 + a2 * v3
        v2 = self.ic2 + a2 * self.ic1 + a3 * v3
        self.ic1 = 2.0 * v1 - self.ic1
        self.ic2 = 2.0 * v2 - self.ic2
        return v1, v2


def delay_saturate(x, drive):
    if drive < 0.001:
        return x
    gain = 1.0 + drive * 4.0
    xg = x * gain
    x2 = xg * xg
    return xg * (27.0 + x2) / (27.0 + 9.0 * x2) / math.sqrt(gain)


def dub_delay(stereo, sr, mode, delay_ms, feedback, ftype, cutoff_hz, drive,
              wet, width, lfo_rate=1.0, lfo_depth_time=0.0, lfo_depth_fb=0.0,
              lfo_depth_filter=0.0, min_delay_samples=0):
    """Port of DelayEffect::process with the engine's deterministic sine LFO
    (phase 0) and the engine's minimum-delay clamp."""
    n = stereo.shape[1]
    max_samples = int(math.ceil((4000.0 + 50.0) * sr / 1000.0)) + 4
    dl = InterpDelayLine(max_samples)
    dr = InterpDelayLine(max_samples)
    svf_l, svf_r = SvfState(), SvfState()
    dc_rc = 1.0 - 2.0 * math.pi * 5.0 / sr
    dcl = {"y1": 0.0, "x1": 0.0}
    dcr = {"y1": 0.0, "x1": 0.0}
    fb_l = fb_r = 0.0
    k = max(2.0 * (1.0 - 0.302 * 0.97), 0.03)
    out = np.empty_like(stereo)
    phase = 0.0

    def dc_run(st, x):
        st["y1"] = x - st["x1"] + dc_rc * st["y1"]
        st["x1"] = x
        return st["y1"]

    def fb_path(svf, dcst, delayed, drv):
        g = math.tan(math.pi * cut / sr)
        v1, v2 = svf.run(delayed, g, k)
        if ftype == "Lowpass":
            filt = v2
        elif ftype == "Bandpass":
            filt = v1
        else:
            filt = delayed - k * v1 - v2
        sat = delay_saturate(filt, drv)
        clean = dc_run(dcst, sat)
        return min(max(clean, -4.0), 4.0)

    for i in range(n):
        p = phase if phase < 0.5 else phase - 1.0
        lfo = sine_approx(p * 2.0 * math.pi)
        phase += lfo_rate / sr
        if phase >= 1.0:
            phase -= 1.0

        dms = max(delay_ms + lfo * lfo_depth_time * 50.0, 1.0)
        dsamp = max(dms * 0.001 * sr, min_delay_samples)
        fb = min(max(feedback + lfo * lfo_depth_fb * (1.0 - abs(feedback)), 0.0), 0.999)
        cut = min(max(cutoff_hz * 2.0 ** (lfo * lfo_depth_filter * 2.0), 20.0), sr / 2.0)
        drv = drive

        li, ri = float(stereo[0, i]), float(stereo[1, i])
        if mode == "Stereo":
            l_in = li + fb_l * fb
            delayed_l = dl.process(l_in, 0.0, dsamp)
            fb_l = fb_path(svf_l, dcl, delayed_l, drv)
            r_in = ri + fb_r * fb
            delayed_r = dr.process(r_in, 0.0, dsamp)
            fb_r = fb_path(svf_r, dcr, delayed_r, drv)
        else:
            mono = (li + ri) * 0.5
            l_in = mono + fb_r * fb
            delayed_l = dl.process(l_in, 0.0, dsamp)
            new_fb_l = fb_path(svf_l, dcl, delayed_l, drv)
            r_in = fb_l * fb
            delayed_r = dr.process(r_in, 0.0, dsamp)
            fb_r = fb_path(svf_r, dcr, delayed_r, drv)
            fb_l = new_fb_l
        wet_l, wet_r = fb_l, fb_r

        dry_gain = min((1.0 - wet) * 2.0, 1.0)
        wet_gain = min(wet * 2.0, 1.0)
        ol = li * dry_gain + wet_l * wet_gain
        orr = ri * dry_gain + wet_r * wet_gain
        mid = (ol + orr) * 0.5
        side = (ol - orr) * 0.5
        out[0, i] = mid + side * width
        out[1, i] = mid - side * width
    return out


# ---------------------------------------------------------------------------
# Chorus (src/effect/chorus.rs) — per-sample oracle
# ---------------------------------------------------------------------------


def chorus(stereo, sr, rate, phase, depth, feedback, delay_ms, wet,
           cutoff_hz, resonance, min_pos_samples=0.0):
    n = stereo.shape[1]
    lfo_range = 256.0 * sr / 44100.0
    max_size = 2 + int(math.ceil(100.0 * sr / 1000.0)) + 2 * int(math.ceil(lfo_range)) + 1
    dl = InterpDelayLine(max_size)
    dr = InterpDelayLine(max_size)
    svf_l, svf_r = SvfState(), SvfState()
    k = max(2.0 * (1.0 - resonance * 0.97), 0.03)
    g = math.tan(math.pi * min(max(cutoff_hz, 20.0), sr / 2.0) / sr)
    out = np.empty_like(stereo)
    ph_l = 0.0
    ph_r = (phase / (2.0 * math.pi)) % 1.0
    fb = min(max(feedback, -0.999), 0.999)
    for i in range(n):
        li, ri = float(stereo[0, i]), float(stereo[1, i])
        # input filter (lowpass)
        v1l, v2l = svf_l.run(li, g, k)
        v1r, v2r = svf_r.run(ri, g, k)
        fl, fr = v2l, v2r
        # sine LFOs (value before advance)
        def lfo_val(ph):
            p = ph * 2 * math.pi if ph < 0.5 else (ph - 1.0) * 2 * math.pi
            return sine_approx(p)
        lv, rv = lfo_val(ph_l), lfo_val(ph_r)
        ph_l = (ph_l + rate / sr) % 1.0
        ph_r = (ph_r + rate / sr) % 1.0

        dsamp = delay_ms * sr * 0.001
        depth_s = lfo_range * depth
        pos_l = max(2.0 + dsamp + (1.0 + lv) * depth_s, min_pos_samples)
        pos_r = max(2.0 + dsamp + (1.0 + rv) * depth_s, min_pos_samples)

        wl = dl.process(fl, fb, pos_l)
        wr = dr.process(fr, fb, pos_r)
        out[0, i] = li * (1.0 - wet) + wl * wet
        out[1, i] = ri * (1.0 - wet) + wr * wet
    return out


# ---------------------------------------------------------------------------
# Reverb (src/effect/reverb.rs) — per-sample oracle, f64, fixed params
# ---------------------------------------------------------------------------


class TptBiquad:
    def __init__(self, sr, cutoff, q):
        g = math.tan(math.pi * min(max(cutoff, 20.0), sr / 2.0) / sr)
        kk = 1.0 / q
        self.a1 = 1.0 / (1.0 + g * (g + kk))
        self.a2 = g * self.a1
        self.a3 = g * self.a2
        self.ic1 = 0.0
        self.ic2 = 0.0

    def run(self, x):  # lowpass
        v3 = x - self.ic2
        v1 = self.a1 * self.ic1 + self.a2 * v3
        v2 = self.ic2 + self.a2 * self.ic1 + self.a3 * v3
        self.ic1 = 2.0 * v1 - self.ic1
        self.ic2 = 2.0 * v2 - self.ic2
        return v2


class RevLine:
    def __init__(self, size, depth, delay, phases):
        self.buf = np.zeros((size + 1, 2))
        self.count = 1
        self.delay = delay
        self.depth = depth
        self.fb = [0.0, 0.0]
        self.phase = list(phases)

    def set(self, vals):
        self.buf[self.count, 0] = vals[0] + self.fb[0]
        self.buf[self.count, 1] = vals[1] + self.fb[1]

    def step(self, speed):
        self.count += 1
        if self.count > self.delay:
            self.count = 0
        self.phase[0] += self.depth * speed
        self.phase[1] += self.depth * speed

    def get(self, vib_depth, blend):
        out = [0.0, 0.0]
        for ch in range(2):
            offset = (math.sin(self.phase[ch]) + 1.0) * vib_depth
            working = self.count + offset
            w_floor = math.floor(working)
            w_frac = working - w_floor
            r1 = int(w_floor)
            if r1 > self.delay:
                r1 -= self.delay + 1
            r2 = int(w_floor) + 1
            if r2 > self.delay:
                r2 -= self.delay + 1
            v1, v2 = self.buf[r1, ch], self.buf[r2, ch]
            out[ch] = (1.0 - blend) * (v1 * (1.0 - w_frac) + v2 * w_frac) + v1 * blend
        return out


class RevAllpass:
    def __init__(self, size, delay):
        self.buf = np.zeros((size, 2))
        self.delay = delay
        self.wpos = 0

    def process(self, vals):
        rp = self.wpos + 1
        if rp > self.delay:
            rp = 0
        delayed = self.buf[rp].copy()
        w = [vals[0] - delayed[0] * 0.5, vals[1] - delayed[1] * 0.5]
        out = [w[0] * 0.5, w[1] * 0.5]
        self.buf[self.wpos] = w
        self.wpos += 1
        if self.wpos > self.delay:
            self.wpos = 0
        nd = self.buf[self.wpos]
        return [out[0] + nd[0], out[1] + nd[1]]


def reverb(stereo, sr, room, wet, vib_phases, vib_depth=7.0, line_depth=None):
    """vib_phases: [8][2] initial vibrato phases (pass the engine's)."""
    n = stereo.shape[1]
    size = room * room * 75.0 + 25.0
    cutoff = 10000.0 - room * wet * 3000.0
    depth_factor = 1.0 - (1.0 - (0.82 - ((1.0 - room) * 0.7 + size * 0.002))) ** 4
    blend = 0.955 - size * 0.007
    regen = depth_factor * 0.5

    factors = [79.0, 73.0, 71.0, 67.0, 61.0, 59.0, 53.0, 47.0]
    depths = [0.003251, 0.002999, 0.002917, 0.002749, 0.002503, 0.002423, 0.002146, 0.002088]
    sizes = [8111, 7511, 7311, 6911, 6311, 6111, 5511, 4911]
    lines = [RevLine(sizes[i], depths[i] if line_depth is None else line_depth,
                     int(factors[i] * size), vib_phases[i]) for i in range(8)]
    aps = [RevAllpass(s, int(f * size))
           for s, f in zip([4511, 4311, 3911, 3311], [43.0, 41.0, 37.0, 31.0])]
    predelay = int(29.0 * size)
    prebuf = np.zeros((4096, 2))
    prepos = 0
    bq_a = [TptBiquad(sr, cutoff, 1.618034) for _ in range(2)]
    bq_b = [TptBiquad(sr, cutoff, 0.618034) for _ in range(2)]
    bq_c = [TptBiquad(sr, cutoff, 0.5) for _ in range(2)]
    out = np.empty_like(stereo)

    for i in range(n):
        il, ir = float(stereo[0, i]), float(stereo[1, i])
        dry_l, dry_r = il, ir
        # predelay: write then read
        prebuf[prepos % 4096] = [il, ir]
        rd = prebuf[(prepos - predelay) % 4096]
        prepos += 1
        il, ir = rd[0], rd[1]
        il, ir = bq_a[0].run(il), bq_a[1].run(ir)
        il, ir = math.sin(il * wet), math.sin(ir * wet)

        oi = aps[0].process([il, ir])
        oj = aps[1].process(oi)
        ok = aps[2].process(oj)
        ol = aps[3].process(ok)

        ins = [ol, ok, oj, oi, oi, oj, ok, ol]
        for ln, v in zip(lines, ins):
            ln.set(v)
        for ln in lines:
            ln.step(0.1)
        interp = [ln.get(vib_depth, blend) for ln in lines]

        fb = []
        for grp in (interp[:4], interp[4:]):
            s0 = [sum(v[0] for v in grp), sum(v[1] for v in grp)]
            for v in grp:
                fb.append([(2.0 * v[0] - s0[0]) * regen, (2.0 * v[1] - s0[1]) * regen])
        for ln, f in zip(lines, fb):
            ln.fb = f

        ml = sum(v[0] for v in interp) / 8.0
        mr = sum(v[1] for v in interp) / 8.0
        ml, mr = bq_b[0].run(ml), bq_b[1].run(mr)
        ml = math.asin(min(max(ml, -1.0), 1.0))
        mr = math.asin(min(max(mr, -1.0), 1.0))
        ml, mr = bq_c[0].run(ml), bq_c[1].run(mr)
        out[0, i] = ml + dry_l * (1.0 - wet)
        out[1, i] = mr + dry_r * (1.0 - wet)
    return out
