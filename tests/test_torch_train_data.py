"""The port's dataset files, loader and synthetic corpus
(nsynth_wavenet_tpu_torch/data/) against the JAX package's, on the CPU:
each side reads what the other writes, one seed gives the same crops, and
the speech-like corpus is equal bit for bit.  The JAX loader runs with its
numpy gather (use_native=False) and with its C++ sampler where that builds."""

import json
import os

import numpy as np
import pytest

from nsynth_wavenet_tpu.data import dataset as jdata
from nsynth_wavenet_tpu.data import synthetic as jsyn
from nsynth_wavenet_tpu_torch.data import dataset as tdata
from nsynth_wavenet_tpu_torch.data import synthetic as tsyn


def _waves(seed=0, n=7):
    rng = np.random.default_rng(seed)
    # lengths on both sides of the crop (1280), one exactly the crop
    lengths = [900, 1280, 1281, 3000, 5000, 400, 2600][:n]
    return [rng.uniform(-0.9, 0.9, L).astype(np.float32) for L in lengths], \
        [f"utt_{i}" for i in range(n)]


def _dirs(tmp_path):
    waves, ids = _waves()
    jdata.build_dataset_from_arrays(waves, ids, str(tmp_path / "jax"))
    tdata.build_dataset_from_arrays(waves, ids, str(tmp_path / "torch"))
    return waves, str(tmp_path / "jax"), str(tmp_path / "torch")


def test_written_files_equal(tmp_path):
    _, jd, td = _dirs(tmp_path)
    for name in (tdata.DATA_NAME, tdata.INDEX_NAME):
        with open(os.path.join(jd, name), "rb") as a, open(os.path.join(td, name), "rb") as b:
            assert a.read() == b.read(), name


@pytest.mark.parametrize("use_native", (False, True))
def test_each_side_reads_the_other(tmp_path, use_native):
    waves, jd, td = _dirs(tmp_path)
    for src in (jd, td):
        j = jdata.Dataset(src, use_native=use_native)
        t = tdata.Dataset(src)
        assert len(t) == len(j) == len(waves) and t.sample_rate == j.sample_rate == 16000
        for i, w in enumerate(waves):
            np.testing.assert_array_equal(t.get_record(i), w)
            np.testing.assert_array_equal(j.get_record(i), w)


@pytest.mark.parametrize("use_native", (False, True))
def test_same_seed_same_crops(tmp_path, use_native):
    _, jd, td = _dirs(tmp_path)
    j, t = jdata.Dataset(jd, use_native=use_native), tdata.Dataset(td)
    rj, rt = np.random.default_rng(5), np.random.default_rng(5)
    for B in (1, 3, 8):
        np.testing.assert_array_equal(t.random_crop_batch(rt, B, 1280),
                                      j.random_crop_batch(rj, B, 1280))
    for B, first_n in ((4, 1000), (12, 3)):  # 12 > 7 records: drawn with replacement
        np.testing.assert_array_equal(t.get_init_batch(B, 1280, first_n=first_n, seed=9),
                                      j.get_init_batch(B, 1280, first_n=first_n, seed=9))
    got = list(t.sequential_batches(3, 1280))
    want = list(j.sequential_batches(3, 1280))
    assert [g.shape for g in got] == [w.shape for w in want] == [(3, 1280), (3, 1280), (1, 1280)]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_batch_iterator_and_sharding(tmp_path):
    _, jd, td = _dirs(tmp_path)
    it_t = tdata.Dataset(td).batch_iterator(2, 1280, seed=3)
    it_j = jdata.Dataset(jd, use_native=False).batch_iterator(2, 1280, seed=3)
    try:
        for _ in range(4):
            np.testing.assert_array_equal(next(it_t), next(it_j))
    finally:
        it_t.close()
        it_j.close()
    for k in (0, 1):
        t = tdata.Dataset(td, process_index=k, process_count=2)
        j = jdata.Dataset(jd, process_index=k, process_count=2)
        assert [r["id"] for r in t.records] == [r["id"] for r in j.records]


def test_build_dataset_from_wav_dir(tmp_path):
    waves, _ = _waves()
    wav_dir = tmp_path / "wavs"
    wav_dir.mkdir()
    for i, w in enumerate(waves):
        jdata.write_wav(str(wav_dir / f"u{i}.wav"), w)
    jdata.build_dataset(str(wav_dir), str(tmp_path / "jax"), min_len=2000)
    tdata.build_dataset(str(wav_dir), str(tmp_path / "torch"), min_len=2000)
    for name in (tdata.DATA_NAME, tdata.INDEX_NAME):
        assert (tmp_path / "jax" / name).read_bytes() == (tmp_path / "torch" / name).read_bytes()
    index = json.loads((tmp_path / "torch" / tdata.INDEX_NAME).read_text())
    assert min(r["length"] for r in index["records"]) == 2000


def test_synthetic_dataset_equal(tmp_path):
    jdata.make_synthetic_dataset(str(tmp_path / "jax"), n_records=3, length=4000, seed=2)
    tdata.make_synthetic_dataset(str(tmp_path / "torch"), n_records=3, length=4000, seed=2)
    for name in (tdata.DATA_NAME, tdata.INDEX_NAME):
        assert (tmp_path / "jax" / name).read_bytes() == (tmp_path / "torch" / name).read_bytes()


def test_speechlike_corpus_bit_equal():
    jw, jids = jsyn.make_speechlike_corpus(n_utts=3, duration=0.5, seed=4)
    tw, tids = tsyn.make_speechlike_corpus(n_utts=3, duration=0.5, seed=4)
    assert tids == jids
    for a, b in zip(tw, jw):
        assert a.dtype == b.dtype == np.float32
        np.testing.assert_array_equal(a, b)
