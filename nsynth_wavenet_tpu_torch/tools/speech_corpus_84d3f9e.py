"""The speech-like corpus and held-out clips of the JAX package's passing
30k-step Gauss (ClariNet) student smoke (git 84d3f9e), kept as the port's
own copy so that its quality smoke can run on them.

That run (``quality_smoke --student --pairing gauss --corpus speech --steps
30000``) is the only recorded passing Gauss student smoke.  The commit after
it replaced the corpus with the richer one of ``data/synthetic.py`` (speaker
profiles, plosives, breath noise, a third formant), which the smoke uses
now.  This module is a line-for-line copy of 84d3f9e's
``nsynth_wavenet_tpu/data/synthetic.py`` lines 30-118 (the resonator, pulse
train, contours, formant filter, utterance and corpus), plus ``held_out_wavs``
as 84d3f9e's ``tools/quality_smoke.py`` (lines 160-165) made the held-out
clips.  numpy and scipy only: one seed gives the same audio bit for bit.

Formant-synthesized pseudo-speech: random syllable sequences of voiced
segments (glottal pulse train with a time-varying f0 contour, shaped by 2
time-varying formant resonators), unvoiced noise bursts, and silences.
"""

import numpy as np
from scipy import signal as sps

HELD_OUT_SEED = 1234  # disjoint from the training corpus's seed
N_HELD_OUT = 4
HELD_OUT_SECONDS = 1.0


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


def make_speechlike_utterance(rng, sr=16000, duration=2.0):
    """One pseudo-speech utterance: 4-8 syllables of voiced/unvoiced/silence."""
    n = int(sr * duration)
    wav = np.zeros(n, np.float32)
    pos = 0
    while pos < n - sr // 10:
        kind = rng.choice(["voiced", "voiced", "unvoiced", "silence"])
        seg_len = int(rng.uniform(0.12, 0.35) * sr)
        seg_len = min(seg_len, n - pos)
        if kind == "voiced":
            f0 = _smooth_contour(seg_len, 90, 280, 3, rng)
            f1 = _smooth_contour(seg_len, 300, 900, 2, rng)
            f2 = _smooth_contour(seg_len, 1000, 2400, 2, rng)
            src = _glottal_pulses(f0, sr, rng)
            seg = _apply_formants(src, f1, f2, sr)
            seg = seg / (np.max(np.abs(seg)) + 1e-6)
        elif kind == "unvoiced":
            noise = rng.standard_normal(seg_len).astype(np.float32)
            fc = rng.uniform(2000, 6000)
            b, a = _resonator_coeffs(fc, 1500.0, sr)
            seg = sps.lfilter(b, a, noise).astype(np.float32)
            seg = 0.3 * seg / (np.max(np.abs(seg)) + 1e-6)
        else:
            seg = np.zeros(seg_len, np.float32)
        # 10 ms raised-cosine fades to avoid clicks
        fade = min(sr // 100, seg_len // 2)
        env = np.ones(seg_len, np.float32)
        ramp = 0.5 - 0.5 * np.cos(np.pi * np.arange(fade) / max(fade, 1))
        env[:fade] *= ramp
        env[seg_len - fade :] *= ramp[::-1]
        wav[pos : pos + seg_len] = seg * env
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


def held_out_wavs(sr=16000):
    """The held-out clips [N_HELD_OUT, sr * HELD_OUT_SECONDS] of 84d3f9e's
    speech smoke."""
    rng = np.random.default_rng(HELD_OUT_SEED)
    return np.stack([make_speechlike_utterance(rng, sr, HELD_OUT_SECONDS)
                     for _ in range(N_HELD_OUT)])
