"""Formant-synthesized pseudo-speech for training and quality checks where no
speech corpus is mounted (counterpart of nsynth_wavenet_tpu/data/synthetic.py;
numpy on both sides, so one seed gives the same corpus bit for bit).

An utterance is a random syllable stream of voiced segments (a glottal pulse
train on a time-varying f0 contour plus breath noise, through formant
resonators), fricatives, plosive bursts and pauses, from a per-utterance
speaker profile, with f0 and amplitude declination.  The segment order is
random, so the mel carries what the autoregressive context cannot predict.
"""

import numpy as np
from scipy import signal as sps


def _resonator_coeffs(freq_hz, bw_hz, sr):
    """Two-pole resonator (digital formant filter) at freq with bandwidth."""
    r = np.exp(-np.pi * bw_hz / sr)
    theta = 2 * np.pi * freq_hz / sr
    a = np.array([1.0, -2 * r * np.cos(theta), r * r])
    b = np.array([1.0 - r])
    return b, a


def _glottal_pulses(f0_contour, sr, rng):
    """Impulse train following a per-sample f0 contour, with 1% jitter."""
    n = len(f0_contour)
    phase = np.cumsum(f0_contour / sr * (1.0 + 0.01 * rng.standard_normal(n)))
    pulses = np.zeros(n, np.float32)
    pulses[1:] = (np.floor(phase[1:]) != np.floor(phase[:-1])).astype(np.float32)
    return pulses


def _smooth_contour(n, lo, hi, n_knots, rng):
    """Piecewise-linear random contour in [lo, hi] over n samples."""
    knots = rng.uniform(lo, hi, size=n_knots)
    return np.interp(np.arange(n), np.linspace(0, n - 1, n_knots), knots)


def _apply_formants(src, f1, f2, sr):
    """Filter src through two time-varying resonators (blockwise, 20 ms
    blocks, filter state carried across block boundaries)."""
    n = len(src)
    block = sr // 50
    out = np.zeros(n, np.float32)
    zi1 = zi2 = None
    for s in range(0, n, block):
        e = min(s + block, n)
        b1, a1 = _resonator_coeffs(float(np.mean(f1[s:e])), 120.0, sr)
        b2, a2 = _resonator_coeffs(float(np.mean(f2[s:e])), 180.0, sr)
        if zi1 is None:
            zi1 = sps.lfilter_zi(b1, a1) * 0.0
            zi2 = sps.lfilter_zi(b2, a2) * 0.0
        y, zi1 = sps.lfilter(b1, a1, src[s:e], zi=zi1)
        y, zi2 = sps.lfilter(b2, a2, y, zi=zi2)
        out[s:e] = y
    return out


def _speaker_profile(rng):
    """Per-utterance speaker draw: f0 register and vocal-tract length scale
    (formants shift together), covering male-through-female ranges so the
    corpus is multi-speaker like LJSpeech-adjacent real data is multi-style."""
    f0_lo = rng.uniform(75, 200)
    f0_hi = f0_lo * rng.uniform(1.4, 2.0)
    vt = rng.uniform(0.85, 1.2)  # formant scale (shorter tract -> higher)
    breath = rng.uniform(0.01, 0.06)  # aspiration noise mixed into voicing
    return {"f0_lo": f0_lo, "f0_hi": f0_hi, "vt": vt, "breath": breath}


def make_speechlike_utterance(rng, sr=16000, duration=2.0):
    """One pseudo-speech utterance: syllable stream of voiced segments,
    fricatives, plosive bursts (closure silence + release burst), and
    pauses, from a per-utterance speaker profile, with utterance-final
    amplitude/f0 declination and leading/trailing silence — the segment
    classes and prosodic structure a vocoder meets in real speech."""
    n = int(sr * duration)
    spk = _speaker_profile(rng)
    wav = np.zeros(n, np.float32)
    pos = int(rng.uniform(0.01, 0.06) * sr)  # utterance-initial silence
    end_sil = int(rng.uniform(0.02, 0.08) * sr)
    while pos < n - end_sil - sr // 20:
        kind = rng.choice(
            ["voiced", "voiced", "voiced", "fricative", "plosive", "pause"]
        )
        if kind == "plosive":
            # closure gap then a short wide-band release burst
            gap = int(rng.uniform(0.02, 0.06) * sr)
            burst_len = int(rng.uniform(0.008, 0.03) * sr)
            seg_len = min(gap + burst_len, n - end_sil - pos)
            seg = np.zeros(seg_len, np.float32)
            bl = max(min(burst_len, seg_len - gap), 0)
            if bl > 0:
                burst = rng.standard_normal(bl).astype(np.float32)
                fc = rng.uniform(1500, 6500) * spk["vt"]
                b, a = _resonator_coeffs(min(fc, sr * 0.45), 2500.0, sr)
                burst = sps.lfilter(b, a, burst).astype(np.float32)
                burst *= np.exp(-np.arange(bl) / (0.25 * bl + 1))  # sharp decay
                seg[gap : gap + bl] = 0.5 * burst / (np.max(np.abs(burst)) + 1e-6)
            fade = 0  # bursts must keep their attack transient
        elif kind == "voiced":
            seg_len = min(int(rng.uniform(0.1, 0.35) * sr), n - end_sil - pos)
            decl = 1.0 - 0.25 * pos / n  # f0 declination over the utterance
            f0 = _smooth_contour(seg_len, spk["f0_lo"] * decl, spk["f0_hi"] * decl, 3, rng)
            f1 = _smooth_contour(seg_len, 280 * spk["vt"], 950 * spk["vt"], 2, rng)
            f2 = _smooth_contour(seg_len, 950 * spk["vt"], 2500 * spk["vt"], 2, rng)
            f3 = rng.uniform(2400, 3200) * spk["vt"]
            src = _glottal_pulses(f0, sr, rng)
            src = src + spk["breath"] * rng.standard_normal(seg_len).astype(np.float32)
            seg = _apply_formants(src, f1, f2, sr)
            b3, a3 = _resonator_coeffs(min(f3, sr * 0.45), 280.0, sr)
            seg = (seg + 0.25 * sps.lfilter(b3, a3, seg)).astype(np.float32)
            seg = seg / (np.max(np.abs(seg)) + 1e-6)
            fade = min(sr // 100, seg_len // 2)
        elif kind == "fricative":
            seg_len = min(int(rng.uniform(0.06, 0.2) * sr), n - end_sil - pos)
            noise = rng.standard_normal(seg_len).astype(np.float32)
            fc = rng.uniform(2000, 6500) * spk["vt"]
            b, a = _resonator_coeffs(min(fc, sr * 0.45), 1500.0, sr)
            seg = sps.lfilter(b, a, noise).astype(np.float32)
            seg = 0.3 * seg / (np.max(np.abs(seg)) + 1e-6)
            fade = min(sr // 100, seg_len // 2)
        else:  # pause (inter-word silence, shorter than plosive closure tail)
            seg_len = min(int(rng.uniform(0.04, 0.18) * sr), n - end_sil - pos)
            seg = np.zeros(seg_len, np.float32)
            fade = 0
        if seg_len <= 0:
            break
        # raised-cosine fades to avoid clicks (not on bursts/pauses)
        if fade > 0:
            env = np.ones(seg_len, np.float32)
            ramp = 0.5 - 0.5 * np.cos(np.pi * np.arange(fade) / max(fade, 1))
            env[:fade] *= ramp
            env[seg_len - fade :] *= ramp[::-1]
            seg = seg * env
        # amplitude declination toward the utterance end
        wav[pos : pos + seg_len] = seg * (1.0 - 0.3 * pos / n)
        pos += seg_len
    wav = 0.6 * wav / (np.max(np.abs(wav)) + 1e-6)
    wav += 0.002 * rng.standard_normal(n).astype(np.float32)
    return np.clip(wav, -0.99, 0.99).astype(np.float32)


def make_speechlike_corpus(n_utts=24, sr=16000, duration=2.0, seed=0):
    """Returns (waves list[np.float32 [n]], ids list[str])."""
    rng = np.random.default_rng(seed)
    waves, ids = [], []
    for i in range(n_utts):
        waves.append(make_speechlike_utterance(rng, sr, duration))
        ids.append(f"pseudo_{i:03d}")
    return waves, ids
