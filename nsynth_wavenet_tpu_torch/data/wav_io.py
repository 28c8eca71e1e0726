"""Wav I/O through scipy (counterpart of read_wav / write_wav in
nsynth_wavenet_tpu/data/dataset.py)."""

import numpy as np


def read_wav(path: str, expect_sr: int = None):
    """Read a wav file -> (float32 mono waveform in [-1, 1], sample_rate)."""
    from scipy.io import wavfile

    sr, data = wavfile.read(path)
    if data.dtype == np.int16:
        wav = data.astype(np.float32) / 32768.0
    elif data.dtype == np.int32:
        wav = data.astype(np.float32) / 2147483648.0
    elif data.dtype == np.uint8:
        wav = (data.astype(np.float32) - 128.0) / 128.0
    else:
        wav = data.astype(np.float32)
    if wav.ndim == 2:
        wav = wav.mean(axis=1)
    if expect_sr is not None and sr != expect_sr:
        raise ValueError(f"{path}: sample rate {sr} != expected {expect_sr}")
    return wav, sr


def write_wav(path: str, wav: np.ndarray, sr: int = 16000):
    """Write a float waveform as 16-bit PCM, clipped to [-1, 1]."""
    from scipy.io import wavfile

    wav = np.clip(np.asarray(wav, np.float32), -1.0, 1.0)
    wavfile.write(path, sr, (wav * 32767.0).astype(np.int16))
