"""The port's native C++ crop gather (data/native, its own copy of the JAX
package's sampler.cpp) against the numpy gather: a mirror of
tests/test_native_sampler.py's six cases on the port's Dataset, and the
JAX package's Dataset giving the same crops from the same seed."""

import numpy as np
import pytest
import torch

from nsynth_wavenet_tpu.data import dataset as jdata
from nsynth_wavenet_tpu_torch.data import dataset as ds_lib
from nsynth_wavenet_tpu_torch.data.native import native as native_mod


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One torch thread: the step loops' small products gain nothing from
    more, and the other test workers share the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def built(tmp_path_factory):
    d = tmp_path_factory.mktemp("native_ds")
    rng = np.random.default_rng(0)
    # mixed lengths: shorter than, equal to, and longer than the crop
    waves = [rng.standard_normal(n).astype(np.float32) for n in (500, 1000, 3000, 9000)]
    ds_lib.build_dataset_from_arrays(waves, [f"u{i}" for i in range(len(waves))], str(d))
    return str(d)


def test_native_builds_into_the_build_dir_and_loads():
    assert native_mod.load() is not None, "g++ is in this image; the build must work"
    path = native_mod.library_path()
    assert path.exists() and path.parent.name == "_build"
    assert path.name.startswith("libsampler-") and path.suffix == ".so"


def test_crop_batch_native_matches_numpy(built):
    crop = 1000
    a = ds_lib.Dataset(built, use_native=True)
    b = ds_lib.Dataset(built, use_native=False)
    assert a.native and not b.native
    for seed in range(3):
        out_a = a.random_crop_batch(np.random.default_rng(seed), 16, crop)
        out_b = b.random_crop_batch(np.random.default_rng(seed), 16, crop)
        np.testing.assert_array_equal(out_a, out_b)
        # the JAX package's loader draws the same crops from the same seed
        jd = jdata.Dataset(built, use_native=False)
        np.testing.assert_array_equal(out_a, jd.random_crop_batch(np.random.default_rng(seed),
                                                                  16, crop))
    # short records are zero-padded past their end
    out = a.random_crop_batch(np.random.default_rng(0), 64, 2000)
    assert out.shape == (64, 2000) and np.isfinite(out).all()


def test_crop_batch_deterministic_per_seed(built):
    a = ds_lib.Dataset(built, use_native=True)
    x1 = a.random_crop_batch(np.random.default_rng(7), 8, 640)
    x2 = a.random_crop_batch(np.random.default_rng(7), 8, 640)
    np.testing.assert_array_equal(x1, x2)


def test_crop_gather_threaded_matches_single(built):
    a = ds_lib.Dataset(built, use_native=True)
    rng = np.random.default_rng(3)
    idx = rng.integers(0, len(a), size=32).astype(np.int64)
    starts = np.zeros(32, np.int64)
    out1 = np.empty((32, 800), np.float32)
    out8 = np.empty((32, 800), np.float32)
    assert native_mod.crop_gather(a.data, a._offsets, a._lengths, idx, starts, 800, out1,
                                  n_threads=0)
    assert native_mod.crop_gather(a.data, a._offsets, a._lengths, idx, starts, 800, out8,
                                  n_threads=8)
    np.testing.assert_array_equal(out1, out8)


def test_init_batch_and_sequential_native_match_numpy(built):
    a = ds_lib.Dataset(built, use_native=True)
    b = ds_lib.Dataset(built, use_native=False)
    np.testing.assert_array_equal(a.get_init_batch(16, 1200, seed=5),
                                  b.get_init_batch(16, 1200, seed=5))
    for xa, xb in zip(a.sequential_batches(3, 2000), b.sequential_batches(3, 2000)):
        np.testing.assert_array_equal(xa, xb)


def test_crop_gather_defensive_bad_index_and_checks(built):
    a = ds_lib.Dataset(built, use_native=True)
    idx = np.array([len(a) + 5, -1], np.int64)  # out of range -> silence
    starts = np.zeros(2, np.int64)
    out = np.full((2, 100), 7.0, np.float32)
    assert native_mod.crop_gather(a.data, a._offsets, a._lengths, idx, starts, 100, out,
                                  n_threads=0)
    np.testing.assert_array_equal(out, np.zeros((2, 100), np.float32))
    with pytest.raises(TypeError, match="int64"):
        native_mod.crop_gather(a.data, a._offsets, a._lengths, idx.astype(np.int32), starts,
                               100, out)
    with pytest.raises(ValueError, match="shape"):
        native_mod.crop_gather(a.data, a._offsets, a._lengths, idx, starts, 99, out)


def test_runner_gathers_with_the_native_sampler(tmp_path, monkeypatch):
    """The teacher runner's crop stream goes through the native sampler and
    says so in train.log."""
    import json
    import os

    from nsynth_wavenet_tpu_torch.training import runner

    cfg = tmp_path / "te.json"
    cfg.write_text(json.dumps(dict(num_layers=2, num_stages=2, width=16, skip_width=8,
                                   deconv_width=16, wave_length=1280, loss_type="mol",
                                   deconv_config=[[40, 10], [80, 20]], lr_schedule=[[0, 1e-3]],
                                   compute_dtype="float32")))
    gathers = []

    def counting_gather(*args, **kw):
        gathers.append(len(args[3]))
        return real_gather(*args, **kw)

    real_gather = native_mod.crop_gather
    monkeypatch.setattr(native_mod, "crop_gather", counting_gather)
    ds = tmp_path / "ds"
    rng = np.random.default_rng(1)
    ds_lib.build_dataset_from_arrays([rng.uniform(-0.5, 0.5, 4000).astype(np.float32)
                                      for _ in range(3)], ["a", "b", "c"], str(ds))
    run_dir, state = runner.train_wavenet(str(ds), config_path=str(cfg),
                                          log_root=str(tmp_path / "runs"), total_batch_size=2,
                                          num_steps=2, ckpt_every_steps=2, device="cpu")
    assert state["step"] == 2
    with open(os.path.join(run_dir, "train.log")) as f:
        text = f.read()
    assert "crop gather: the native C++ sampler" in text
    assert len(gathers) >= 2
