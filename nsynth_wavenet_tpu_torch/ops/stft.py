"""Mel-spectrogram frontend and the student's power-loss STFT (counterpart
of nsynth_wavenet_tpu/ops/stft.py):

  * ``stft_center``: librosa semantics (centred frames, reflect padding,
    hann(win_length) centred in an n_fft frame), for the mel features;
  * ``stft_pad_end``: tf.signal.stft(pad_end=True) semantics (frames from
    the start, zero padding at the end, hann(win_length) frames right-padded
    to n_fft), for the power loss.

Slaney mel filterbank, normalised dB.  A numpy twin of the mel serves
host-side file loading.  The torch functions run on their input's device,
keep float64 input in float64 and are differentiable; the JAX package
computes the rfft as a DFT matmul, the port with ``torch.fft.rfft`` (the
same sums in another order)."""

import dataclasses
from functools import lru_cache

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class MelParams:
    sample_rate: int = 16000
    num_freq: int = 1025
    num_mel: int = 80
    frame_shift_ms: float = 12.5
    frame_length_ms: float = 50.0
    min_level_db: float = -140.0
    ref_level_db: float = 40.0
    mel_fmin: float = 125.0
    mel_fmax: float = 7600.0
    min_amp: float = 1e-5

    @property
    def n_fft(self) -> int:
        return (self.num_freq - 1) * 2

    @property
    def hop_length(self) -> int:
        return int(self.frame_shift_ms * self.sample_rate / 1000.0)

    @property
    def win_length(self) -> int:
        return int(self.frame_length_ms * self.sample_rate / 1000.0)


MEL_PARAMS = MelParams()
# the 3 kHz bin: the power loss weighs the bins below it twice
PRIORITY_FREQ = int(3000 / (MEL_PARAMS.sample_rate * 0.5) * MEL_PARAMS.num_freq)


def hann_window(win_length: int) -> np.ndarray:
    """Periodic hann window."""
    n = np.arange(win_length)
    return (0.5 - 0.5 * np.cos(2.0 * np.pi * n / win_length)).astype(np.float32)


def _hz_to_mel_slaney(hz):
    hz = np.asarray(hz, dtype=np.float64)
    f_sp = 200.0 / 3
    min_log_hz = 1000.0
    min_log_mel = min_log_hz / f_sp
    logstep = np.log(6.4) / 27.0
    mel = hz / f_sp
    log_region = hz >= min_log_hz
    return np.where(
        log_region, min_log_mel + np.log(np.maximum(hz, min_log_hz) / min_log_hz) / logstep, mel
    )


def _mel_to_hz_slaney(mel):
    mel = np.asarray(mel, dtype=np.float64)
    f_sp = 200.0 / 3
    min_log_hz = 1000.0
    min_log_mel = min_log_hz / f_sp
    logstep = np.log(6.4) / 27.0
    hz = mel * f_sp
    log_region = mel >= min_log_mel
    return np.where(log_region, min_log_hz * np.exp(logstep * (mel - min_log_mel)), hz)


@lru_cache(maxsize=4)
def mel_filterbank(
    sample_rate: int = MEL_PARAMS.sample_rate,
    n_fft: int = MEL_PARAMS.n_fft,
    num_mel: int = MEL_PARAMS.num_mel,
    fmin: float = MEL_PARAMS.mel_fmin,
    fmax: float = MEL_PARAMS.mel_fmax,
) -> np.ndarray:
    """[num_mel, n_fft//2 + 1] Slaney-normalised triangular mel filterbank
    (read-only: the cached array is shared)."""
    fftfreqs = np.linspace(0, sample_rate / 2, 1 + n_fft // 2)
    mel_pts = np.linspace(_hz_to_mel_slaney(fmin), _hz_to_mel_slaney(fmax), num_mel + 2)
    hz_pts = _mel_to_hz_slaney(mel_pts)
    fdiff = np.diff(hz_pts)
    ramps = hz_pts[:, None] - fftfreqs[None, :]
    lower = -ramps[:-2] / fdiff[:-1, None]
    upper = ramps[2:] / fdiff[1:, None]
    weights = np.maximum(0.0, np.minimum(lower, upper))
    enorm = 2.0 / (hz_pts[2 : num_mel + 2] - hz_pts[:num_mel])
    weights = (weights * enorm[:, None]).astype(np.float32)
    weights.setflags(write=False)
    return weights


def _centred_window(p: MelParams) -> np.ndarray:
    window = np.zeros(p.n_fft, dtype=np.float32)
    lpad = (p.n_fft - p.win_length) // 2
    window[lpad : lpad + p.win_length] = hann_window(p.win_length)
    return window


def melspectrogram_np(y: np.ndarray, p: MelParams = MEL_PARAMS) -> np.ndarray:
    """[..., L] float wav -> [..., 1 + L // hop, num_mel] normalised-dB mel."""
    y = np.asarray(y, np.float32)
    n_fft, hop = p.n_fft, p.hop_length
    n_frames = 1 + y.shape[-1] // hop
    pad = n_fft // 2
    y_padded = np.pad(y, [(0, 0)] * (y.ndim - 1) + [(pad, pad)], mode="reflect")
    idx = np.arange(n_frames)[:, None] * hop + np.arange(n_fft)[None, :]
    frames = y_padded[..., idx] * _centred_window(p)
    spec = np.abs(np.fft.rfft(frames, n=n_fft)).astype(np.float32)
    basis = mel_filterbank(p.sample_rate, p.n_fft, p.num_mel, p.mel_fmin, p.mel_fmax)
    mel = spec @ basis.T
    db = 20.0 * np.log10(np.maximum(p.min_amp, mel))
    return np.clip((db - p.min_level_db) / -p.min_level_db, 0.0, 1.0).astype(np.float32)


def _float(y: torch.Tensor) -> torch.Tensor:
    return y if y.dtype == torch.float64 else y.to(torch.float32)


def stft_center(y: torch.Tensor, p: MelParams = MEL_PARAMS) -> torch.Tensor:
    """librosa-style STFT: [..., L] -> complex [..., 1 + L // hop, num_freq]."""
    n_fft, hop = p.n_fft, p.hop_length
    pad = n_fft // 2
    y = _float(y)
    lead = y.shape[:-1]
    flat = y.reshape(-1, 1, y.shape[-1])
    y_padded = torch.nn.functional.pad(flat, (pad, pad), mode="reflect")[:, 0]
    frames = y_padded.reshape(*lead, -1).unfold(-1, n_fft, hop)  # [..., T, n_fft]
    window = torch.from_numpy(_centred_window(p)).to(y.device)
    return torch.fft.rfft(frames * window, n=n_fft)


def stft_pad_end(y: torch.Tensor, p: MelParams = MEL_PARAMS) -> torch.Tensor:
    """tf.signal.stft(pad_end=True) semantics: [..., L] -> complex
    [..., ceil(L / hop), num_freq]; hann(win_length) frames, zero-padded at
    the signal's end and on each frame's right to n_fft."""
    n_fft, hop, win = p.n_fft, p.hop_length, p.win_length
    y = _float(y)
    length = y.shape[-1]
    n_frames = -(-length // hop)
    pad_amt = max(0, (n_frames - 1) * hop + win - length)
    frames = torch.nn.functional.pad(y, (0, pad_amt)).unfold(-1, win, hop)  # [..., n_frames, win]
    window = torch.from_numpy(hann_window(win)).to(y.device)
    return torch.fft.rfft(frames * window, n=n_fft)


def amp_to_db(x: torch.Tensor, p: MelParams = MEL_PARAMS) -> torch.Tensor:
    return 20.0 * torch.log10(torch.clamp(x, min=p.min_amp))


def db_normalize(s: torch.Tensor, p: MelParams = MEL_PARAMS) -> torch.Tensor:
    return torch.clamp((s - p.min_level_db) / -p.min_level_db, 0.0, 1.0)


def melspec_from_spec(spec: torch.Tensor, p: MelParams = MEL_PARAMS) -> torch.Tensor:
    """The mel filterbank applied to a magnitude spectrogram [..., num_freq]."""
    basis = torch.from_numpy(
        mel_filterbank(p.sample_rate, p.n_fft, p.num_mel, p.mel_fmin, p.mel_fmax).copy()
    ).to(spec.device)
    return spec @ basis.T.to(spec.dtype)


def melspectrogram(y: torch.Tensor, p: MelParams = MEL_PARAMS) -> torch.Tensor:
    """Torch twin of :func:`melspectrogram_np` on y's device: [B, L] -> [B, T, num_mel]."""
    return db_normalize(amp_to_db(melspec_from_spec(torch.abs(stft_center(y, p)), p), p), p)


def melspectrogram2(y: torch.Tensor, p: MelParams = MEL_PARAMS) -> torch.Tensor:
    """The reference's alternate mel extractor: the pad-end STFT instead of
    the centred one, then mel, dB and normalisation."""
    return db_normalize(amp_to_db(melspec_from_spec(torch.abs(stft_pad_end(y, p)), p), p), p)


def num_mel_frames(length: int, p: MelParams = MEL_PARAMS) -> int:
    """Frames that :func:`melspectrogram` makes of ``length`` samples."""
    return 1 + length // p.hop_length
