"""Dataset files and the random-crop loader (counterpart of
nsynth_wavenet_tpu/data/dataset.py).

Format, shared with the JAX package: one flat ``data.bin`` of concatenated
float32 PCM and an ``index.json`` with the sample rate and one (id, offset,
length) record per utterance.  The loader memory-maps ``data.bin`` and takes
seeded numpy random crops; records and starts come from the same numpy
generator calls as the JAX package's, so one seed gives the same crops on
both sides.  The mel is computed on the device inside the training step.
The gather runs in the native C++ sampler (data/native) when it builds, else
in numpy; the two give the same bits.  ``spec_feat_mean_std`` gives the
student's power-loss statistics.
"""

import glob
import json
import os
import queue
import threading

import numpy as np

from nsynth_wavenet_tpu_torch.data.native import native as native_lib
from nsynth_wavenet_tpu_torch.data.wav_io import read_wav

INDEX_NAME = "index.json"
DATA_NAME = "data.bin"


def _write(records_iter, save_dir, sample_rate):
    """(id, float32 wav) pairs -> data.bin + index.json; returns the index."""
    os.makedirs(save_dir, exist_ok=True)
    records, offset = [], 0
    with open(os.path.join(save_dir, DATA_NAME), "wb") as f:
        for audio_id, wav in records_iter:
            wav = np.asarray(wav, np.float32)
            f.write(wav.tobytes())
            records.append({"id": audio_id, "offset": offset, "length": len(wav)})
            offset += len(wav)
    index = {"sample_rate": sample_rate, "records": records}
    with open(os.path.join(save_dir, INDEX_NAME), "wt") as f:
        json.dump(index, f)
    return index


def build_dataset(wave_dir: str, save_dir: str, sample_rate: int = 16000, min_len: int = 16000,
                  num_workers: int = 10):
    """Directory of .wav files -> {data.bin, index.json}.  Records shorter
    than ``min_len`` are zero-padded to it; prints the corpus duration."""
    from concurrent.futures import ThreadPoolExecutor

    wave_files = sorted(glob.glob(os.path.join(wave_dir, "*.wav")))
    if not wave_files:
        raise ValueError(f"no .wav files in {wave_dir}")

    def _load(wf):
        wav, sr = read_wav(wf)
        if sr != sample_rate:
            raise ValueError(f"{wf}: sample rate {sr} != {sample_rate}; resample first")
        orig_len = len(wav)
        if orig_len < min_len:
            wav = np.pad(wav, (0, min_len - orig_len))
        return os.path.splitext(os.path.basename(wf))[0], wav.astype(np.float32), orig_len

    with ThreadPoolExecutor(max_workers=num_workers) as ex:
        results = list(ex.map(_load, wave_files))
    index = _write(((i, w) for i, w, _ in results), save_dir, sample_rate)
    total = sum(n for _, _, n in results)
    padded = sum(int(n < min_len) for _, _, n in results)
    print(f"total duration: {total / sample_rate / 3600.0:.5f} hours")
    print(f"padded samples: {padded}/{len(results)} pieces")
    return index


def build_dataset_from_arrays(waves, ids, save_dir, sample_rate: int = 16000):
    """In-memory arrays -> a dataset directory."""
    return _write(zip(ids, waves), save_dir, sample_rate)


class Dataset:
    """Memory-mapped random-crop loader over one process's share of the
    records (``process_index::process_count``).  use_native: gather the crops
    in the C++ sampler, single-threaded, when it builds and loads
    (``self.native``), else in numpy."""

    def __init__(self, path: str, process_index: int = 0, process_count: int = 1,
                 use_native: bool = True):
        if path.endswith(".json"):
            path = os.path.dirname(path)
        self.dir = path
        with open(os.path.join(path, INDEX_NAME), "rt") as f:
            index = json.load(f)
        self.sample_rate = index["sample_rate"]
        self.records = index["records"][process_index::process_count]
        if not self.records:
            raise ValueError("dataset shard is empty")
        self.data = np.memmap(os.path.join(path, DATA_NAME), dtype=np.float32, mode="r")
        self._offsets = np.array([r["offset"] for r in self.records], np.int64)
        self._lengths = np.array([r["length"] for r in self.records], np.int64)
        self.native = use_native and native_lib.load() is not None

    def __len__(self):
        return len(self.records)

    def get_record(self, i: int) -> np.ndarray:
        o, l = int(self._offsets[i]), int(self._lengths[i])
        return np.asarray(self.data[o : o + l])

    def _gather(self, idx, starts, length):
        """Rows idx cropped at starts; records not longer than ``length`` are
        taken whole and zero-padded at the end."""
        out = np.empty((len(idx), length), np.float32)
        if self.native:
            native_lib.crop_gather(self.data, self._offsets, self._lengths, idx, starts, length,
                                   out)
            return out
        for j, i in enumerate(idx):
            o, l = int(self._offsets[i]), int(self._lengths[i])
            if l <= length:
                out[j, :l] = self.data[o : o + l]
                out[j, l:] = 0.0
            else:
                start = int(starts[j])
                out[j] = self.data[o + start : o + start + length]
        return out

    def random_crop_batch(self, rng: np.random.Generator, batch_size: int, length: int):
        """Uniformly drawn records, each cropped to ``length`` at a uniform
        start: float32 [batch_size, length]."""
        idx = rng.integers(0, len(self.records), size=batch_size)
        spans = np.maximum(self._lengths[idx] - length + 1, 1)
        starts = rng.integers(0, spans, size=batch_size).astype(np.int64)
        return self._gather(idx, starts, length)

    def batch_iterator(self, batch_size: int, length: int, seed: int = 0, prefetch: int = 2):
        """Infinite iterator of random crop batches, filled by a background
        thread; ``close()`` stops the thread."""
        rng = np.random.default_rng(seed)
        q: "queue.Queue[np.ndarray]" = queue.Queue(maxsize=prefetch)
        stop = threading.Event()

        def _worker():
            while not stop.is_set():
                batch = self.random_crop_batch(rng, batch_size, length)
                while not stop.is_set():
                    try:
                        q.put(batch, timeout=0.5)
                        break
                    except queue.Full:
                        continue

        thread = threading.Thread(target=_worker, daemon=True)
        thread.start()

        class _Iter:
            def __iter__(self):
                return self

            def __next__(self):
                return q.get()

            def close(self):
                stop.set()
                thread.join(timeout=5)

        return _Iter()

    def sequential_batches(self, batch_size: int, length: int):
        """One epoch of in-order batches of front-of-record crops, float32
        [<= batch_size, length]."""
        n = len(self.records)
        for start in range(0, n, batch_size):
            idx = np.arange(start, min(start + batch_size, n), dtype=np.int64)
            yield self._gather(idx, np.zeros(len(idx), np.int64), length)

    def get_init_batch(self, batch_size: int, seq_len: int, first_n: int = 1000, seed: int = 0):
        """Random crops from the first ``first_n`` records, for the
        data-dependent init (records drawn with replacement when there are
        fewer than ``batch_size``)."""
        rng = np.random.default_rng(seed)
        n = min(first_n, len(self.records))
        chosen = rng.permutation(n)[:batch_size]
        if len(chosen) < batch_size:
            chosen = rng.integers(0, n, size=batch_size)
        chosen = chosen.astype(np.int64)
        spans = np.maximum(self._lengths[chosen] - seq_len + 1, 1)
        starts = rng.integers(0, spans, size=batch_size).astype(np.int64)
        return self._gather(chosen, starts, seq_len)


def spec_feat_mean_std(train_path: str, feat_fn, batch_size: int = 4096, seq_len: int = 7680,
                       first_n: int = 10000, chunk: int = 256, seed: int = 0, device="cuda"):
    """Per-frequency (mean, std), f32 numpy, of an STFT feature over an init
    batch of crops (the student's power-loss normalisation): feat_fn of
    stft_pad_end, on ``device`` in chunks of ``chunk`` crops, the moments
    merged chunk by chunk in f64."""
    import torch

    from nsynth_wavenet_tpu_torch.ops import stft as stft_ops

    waves = Dataset(train_path).get_init_batch(batch_size, seq_len, first_n=first_n, seed=seed)
    count, mean, m2 = 0, None, None
    for i in range(0, batch_size, chunk):
        with torch.no_grad():
            w = torch.from_numpy(waves[i : i + chunk]).to(device)
            feat = feat_fn(stft_ops.stft_pad_end(w)).cpu().numpy()
        f2 = feat.reshape(-1, feat.shape[-1]).astype(np.float64)
        n, cm, cv = f2.shape[0], f2.mean(axis=0), f2.var(axis=0)
        if mean is None:
            count, mean, m2 = n, cm, cv * n
        else:
            delta, tot = cm - mean, count + n
            mean = mean + delta * n / tot
            m2 = m2 + cv * n + delta**2 * count * n / tot
            count = tot
    return mean.astype(np.float32), np.sqrt(m2 / count).astype(np.float32)


def make_synthetic_dataset(save_dir, n_records=32, length=32000, sr=16000, seed=0):
    """Harmonic tones with a slow envelope and a little noise, as a dataset
    directory, for tests and timing where no corpus is mounted."""
    rng = np.random.default_rng(seed)
    waves, ids = [], []
    t = np.arange(length) / sr
    for i in range(n_records):
        f0 = rng.uniform(80, 250)
        env = 0.4 * (0.6 + 0.4 * np.sin(2 * np.pi * rng.uniform(1, 4) * t))
        w = env * (
            np.sin(2 * np.pi * f0 * t)
            + 0.4 * np.sin(2 * np.pi * 2 * f0 * t + rng.uniform(0, 6))
            + 0.15 * np.sin(2 * np.pi * 3 * f0 * t + rng.uniform(0, 6))
        )
        w = w + 0.02 * rng.standard_normal(length)
        waves.append(np.clip(w, -0.999, 0.999).astype(np.float32))
        ids.append(f"synthetic_{i:04d}")
    return build_dataset_from_arrays(waves, ids, save_dir, sample_rate=sr)
