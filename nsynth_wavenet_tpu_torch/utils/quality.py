"""Conditioning-tracking metrics and the golden quality gate (the port's own
copy of ``_mcd`` and ``mel_track_metrics`` in tools/quality_smoke.py, without
the wav writing, and of the gate in tests/test_golden_regression.py).

A generated clip should follow the mel it was conditioned on: its own mel
is compared with every conditioning mel of the batch, the same index
"matched", the others "mismatched", by Pearson correlation, RMS distance and
mel-cepstral distortion.  The gate asks for a matched correlation above the
mismatched one by 0.05 and within a margin of the one recorded when the
golden checkpoint was trained (0.2 for a teacher, 0.15 for the student), and
a matched MCD under the mismatched one.
"""

import numpy as np

from nsynth_wavenet_tpu_torch.ops import stft as stft_ops

TEACHER_MARGIN = 0.2
STUDENT_MARGIN = 0.15
MISMATCH_GAP = 0.05  # matched corr over the mismatched


def mcd(mel_a, mel_b, n_coef: int = 13) -> float:
    """Mel-cepstral distortion (dB) between two normalised-dB mels [T, num_mel]
    (dB = norm * 100 - 100): (10 / ln 10) * sqrt(2 * sum_{k=1..K-1} (c_a[k] -
    c_b[k])^2) averaged over frames, cepstra from an orthonormal DCT-II over
    the mel bins, coefficient 0 (energy) left out."""
    from scipy.fftpack import dct

    ca = dct(mel_a * 100.0, type=2, axis=-1, norm="ortho")[:, 1:n_coef]
    cb = dct(mel_b * 100.0, type=2, axis=-1, norm="ortho")[:, 1:n_coef]
    d = np.sqrt(2.0 * np.sum((ca - cb) ** 2, axis=-1))
    return float((10.0 / np.log(10.0)) * np.mean(d))


def mel_track_metrics(audio, mels, n_samples):
    """{'corr', 'msd', 'mcd': (matched mean, mismatched mean)} of the first
    n_samples of each clip audio[i] against every conditioning mel mels[j]."""
    vals = {m: ([], []) for m in ("corr", "msd", "mcd")}
    for i in range(len(mels)):
        gen_mel = stft_ops.melspectrogram_np(np.asarray(audio[i])[:n_samples])
        n = gen_mel.shape[0]
        for j in range(len(mels)):
            ref = np.asarray(mels[j, :n])
            k = 0 if i == j else 1
            vals["corr"][k].append(float(np.corrcoef(gen_mel.ravel(), ref.ravel())[0, 1]))
            vals["msd"][k].append(float(np.sqrt(np.mean((gen_mel - ref) ** 2))))
            vals["mcd"][k].append(mcd(gen_mel, ref))
    return {m: (float(np.mean(a)), float(np.mean(b))) for m, (a, b) in vals.items()}


def eval_mels(seeds, duration: float = 1.0):
    """The golden checkpoints' held-out conditioning: one speech-like
    utterance per seed (a golden meta.json's 'eval_seeds'), and its mel.
    Returns (mels [n, T, num_mel], wavs [n, N])."""
    from nsynth_wavenet_tpu_torch.data.synthetic import make_speechlike_utterance

    wav = np.stack([make_speechlike_utterance(np.random.default_rng(s), duration=duration)
                    for s in seeds]).astype(np.float32)
    return stft_ops.melspectrogram_np(wav), wav


def golden_gate(metrics, recorded_corr: float, margin: float):
    """(passed, reading) of the JAX package's golden gate: matched corr >
    mismatched corr + 0.05, matched corr > recorded_corr - margin, and
    matched MCD < mismatched MCD."""
    (m_corr, mm_corr), (m_mcd, mm_mcd) = metrics["corr"], metrics["mcd"]
    ok = (m_corr > mm_corr + MISMATCH_GAP and m_corr > recorded_corr - margin
          and m_mcd < mm_mcd)
    reading = (f"matched corr {m_corr:.4f} (gate > {recorded_corr - margin:.4f} and > "
               f"{mm_corr + MISMATCH_GAP:.4f}), mismatched {mm_corr:.4f}; MCD matched "
               f"{m_mcd:.1f} vs mismatched {mm_mcd:.1f}")
    return ok, reading
