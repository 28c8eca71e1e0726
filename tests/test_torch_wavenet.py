"""The port's teacher forward and weight loading against the JAX package on
the committed golden checkpoints (tests/golden/tiny_{ce,mol,gauss}), CPU."""

import os

import jax
import numpy as np
import pytest
import torch

from nsynth_wavenet_tpu.ops import stft as jstft
from nsynth_wavenet_tpu_torch import config as tconfig
from nsynth_wavenet_tpu_torch import weights
from nsynth_wavenet_tpu_torch.models.wavenet import Wavenet as TWavenet
from tools.make_golden_ckpt import golden_dir, load_golden

HEADS = ("ce", "mol", "gauss")


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}['{k}']"))
        return out
    if isinstance(tree, (list, tuple)):
        out = {}
        for i, v in enumerate(tree):
            out.update(_flat(v, f"{prefix}[{i}]"))
        return out
    return {prefix: np.asarray(tree)}


def _inputs(n=2, crop=1280):
    rng = np.random.RandomState(0)
    t = np.arange(crop) / 16000.0
    wav = 0.4 * np.sin(2 * np.pi * 180 * t)[None] + 0.05 * rng.randn(n, crop)
    return np.clip(wav, -0.99, 0.99).astype(np.float32)


@pytest.mark.parametrize("head", HEADS)
def test_load_npz_equals_from_jax_params(head):
    _, jparams, _ = load_golden(head)
    from_jax = _flat(weights.from_jax_params(jax.tree_util.tree_map(np.asarray, jparams),
                                             device="cpu"))
    from_npz = _flat(weights.load_npz(os.path.join(golden_dir(head), "params.npz"), device="cpu"))
    assert from_jax.keys() == from_npz.keys()
    for k in from_jax:
        np.testing.assert_array_equal(from_npz[k], from_jax[k], err_msg=k)


@pytest.mark.parametrize("head", HEADS)
def test_feed_forward_matches_jax_on_golden(head):
    jmodel, jparams, _ = load_golden(head)
    d = golden_dir(head)
    cfg = tconfig.load_config(os.path.join(d, "meta.json"))
    assert cfg == tconfig.wavenet_config_from_dict(dict(jmodel.cfg.__dict__))
    wav = _inputs()
    mel = jstft.melspectrogram_np(wav)
    enc = jmodel.encode_signal({"wav": wav})
    ff, _ = jmodel.feed_forward(jparams, {"wav_scaled": enc["wav_scaled"], "mel": mel})
    want = np.asarray(ff["out_params"])

    model = TWavenet(cfg)
    params = weights.load_npz(os.path.join(d, "params.npz"), device="cpu")
    tenc = model.encode_signal(torch.from_numpy(wav))
    got = model.feed_forward(params, {"wav_scaled": tenc["wav_scaled"],
                                      "mel": torch.from_numpy(mel)})["out_params"].numpy()
    assert got.shape == want.shape == (2, wav.shape[1], cfg.out_width)
    np.testing.assert_allclose(got, want, atol=1e-4 * max(np.abs(want).max(), 1.0), rtol=0)


def test_full_size_config_loads_unchanged():
    cfg = tconfig.load_config("configs/wavenet_mol.json")
    assert (cfg.width, cfg.gate_width, cfg.skip_width, cfg.deconv_width) == (512, 512, 256, 256)
    assert cfg.num_layers == 30 and cfg.loss_type == "mol" and cfg.frame_shift == 200
    params = TWavenet(cfg.__class__(**{**cfg.__dict__, "num_layers": 2})).init_params(0, device="cpu")
    assert params["layers"][1]["dilated"]["w"].shape == (3, 512, 512)
    assert abs(float(params["layers"][0]["dilated"]["w"].std()) - 0.05) < 0.002
