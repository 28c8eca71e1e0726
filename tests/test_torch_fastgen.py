"""The port's AR generation against the JAX package, on the CPU.

Fastgen.generate (the plain step loop) is held against the JAX lax.scan
path, and fastgen_kernel.generate_plain (the CUDA kernel's plain version)
against the JAX Pallas kernel in interpret mode, both teacher-forced so
sampling cannot diverge.  Sampling itself is gated by the Philox uniform
statistics and by a golden free-run that must track its conditioning.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nsynth_wavenet_tpu import config as jconfig
from nsynth_wavenet_tpu.models.fastgen import Fastgen as JFastgen
from nsynth_wavenet_tpu.models.wavenet import Wavenet as JWavenet
from nsynth_wavenet_tpu.ops import fastgen_kernel as jfk
from nsynth_wavenet_tpu.ops import stft as jstft
from nsynth_wavenet_tpu_torch import config as tconfig
from nsynth_wavenet_tpu_torch import weights
from nsynth_wavenet_tpu_torch.data import wav_io
from nsynth_wavenet_tpu_torch.models.fastgen import Fastgen
from nsynth_wavenet_tpu_torch.models.wavenet import Wavenet
from nsynth_wavenet_tpu_torch.ops import fastgen_kernel as fk
from nsynth_wavenet_tpu_torch.ops import stft as tstft
from tools.make_golden_ckpt import eval_mels, golden_dir, load_golden

# the lane-aligned config of tests/test_fastgen_kernel.py
SMALL = dict(num_layers=4, num_stages=2, width=128, skip_width=128, deconv_width=128,
             wave_length=1280, compute_dtype="float32", upsample_act="leaky_relu")
KERNEL_CASES = [("mol", False, False), ("gauss", False, False), ("ce", True, False),
                ("ce", True, True)]


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One torch thread: the step loops' small products gain nothing from
    more, and the other test workers share the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _port(jmodel, jparams):
    cfg = tconfig.wavenet_config_from_dict(dict(jmodel.cfg.__dict__))
    params = weights.from_jax_params(jax.tree_util.tree_map(np.asarray, jparams), device="cpu")
    return Wavenet(cfg), params


def _small(loss_type, use_mu_law, double_gate, B=8, seed=0):
    cfg = jconfig.WavenetConfig(loss_type=loss_type, use_mu_law=use_mu_law,
                                double_gate_width=double_gate, **SMALL)
    model = JWavenet(cfg)
    params = model.init_params(jax.random.PRNGKey(seed))
    rng = np.random.RandomState(seed)
    t = np.arange(1280) / 16000.0
    wav = 0.4 * np.sin(2 * np.pi * 220 * t)[None] + 0.05 * rng.randn(B, 1280)
    return model, params, np.clip(wav, -0.99, 0.99).astype(np.float32)


def _golden_inputs(head, B=2, crop=1280):
    jmodel, jparams, _ = load_golden(head)
    _, wav = eval_mels(n=B)
    return jmodel, jparams, np.ascontiguousarray(wav[:, :crop])


def _kernel_parity(jmodel, jparams, wav, L):
    """generate_plain vs the JAX Pallas kernel (interpret), teacher-forced + greedy."""
    cfg = jmodel.cfg
    B = wav.shape[0]
    mel = jstft.melspectrogram_np(wav)
    enc, _ = jmodel.deconv_stack(jparams, jnp.asarray(mel))
    off = (enc.shape[1] - wav.shape[1]) // 2
    enc_t = jnp.transpose(enc, (1, 0, 2))[off : off + L]
    tf = np.ascontiguousarray(wav[:, :L].T)

    jkw = jfk.build_kernel_weights(cfg, jparams)
    jseg = jkw.pop("out_pad_seg")
    jkw.pop("out_pad")
    gen = jfk.make_generate_fn(cfg, B, L, teacher_forced=True, collect_out_params=True,
                               greedy=True, interpret=True)
    want_audio, want = (np.asarray(a) for a in gen(jkw, enc_t, 123, tf=jnp.asarray(tf)))
    if cfg.loss_type == "mol":
        nr = cfg.mol_mix
        want = np.concatenate([want[..., s * jseg : s * jseg + nr] for s in range(3)], -1)
    else:
        want = want[..., : cfg.out_width]

    model, params = _port(jmodel, jparams)
    kw = fk.build_kernel_weights(model.cfg, params)
    enc_bf = torch.from_numpy(np.array(enc_t.astype(jnp.float32))).to(torch.bfloat16)
    audio, outp = fk.generate(kw, enc_bf, 123, greedy=True, tf=torch.from_numpy(tf),
                              collect_out_params=True)
    got = fk.unpack_head(model.cfg, outp).numpy()
    assert audio.shape == (B, L) and got.shape == want.shape
    scale = max(np.abs(want).max(), 1.0)
    np.testing.assert_allclose(got, want, atol=5e-3 * scale, rtol=0)
    return audio.numpy(), want_audio


@pytest.mark.parametrize("head", ["ce", "mol", "gauss"])
def test_step_loop_matches_jax_scan_on_golden(head):
    jmodel, jparams, wav = _golden_inputs(head)
    L = 64
    mel = jstft.melspectrogram_np(wav)
    enc, _ = jmodel.deconv_stack(jparams, jnp.asarray(mel))
    off = (enc.shape[1] - wav.shape[1]) // 2
    _, want = JFastgen(jmodel).generate(jparams, mel, jax.random.PRNGKey(1), length=L,
                                        teacher_force=jnp.asarray(wav), cond_offset=off,
                                        collect_out_params=True)
    want = np.asarray(want)

    model, params = _port(jmodel, jparams)
    audio, got = Fastgen(model).generate(
        params, torch.from_numpy(mel), torch.Generator().manual_seed(1), length=L,
        teacher_force=torch.from_numpy(wav), cond_offset=off, collect_out_params=True)
    assert audio.shape == (2, L) and torch.isfinite(audio).all()
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4 * max(np.abs(want).max(), 1.0),
                               rtol=0)


@pytest.mark.parametrize("head,mu_law,double_gate", KERNEL_CASES[:1] + KERNEL_CASES[3:])
def test_kernel_weights_match_jax_packing(head, mu_law, double_gate):
    jmodel, jparams, _ = _small(head, mu_law, double_gate)
    jkw = jfk.build_kernel_weights(jmodel.cfg, jparams)
    model, params = _port(jmodel, jparams)
    kw = fk.build_kernel_weights(model.cfg, params)

    def np32(x):
        return np.asarray(jnp.asarray(x).astype(jnp.float32))

    for name in ("w_comb", "b_comb", "w_rs", "b_rs", "w_skip0", "w_out1"):
        np.testing.assert_array_equal(kw[name].float().numpy(), np32(jkw[name]), err_msg=name)
    for name in ("b_start", "b_skip0", "b_out1"):
        np.testing.assert_array_equal(kw[name].numpy(), np32(jkw[name])[0], err_msg=name)
    np.testing.assert_array_equal(kw["w_start"].numpy(), np32(jkw["w_start"])[:3])
    # the head: same columns once each layout is unpacked
    seg, cfg = jkw["out_pad_seg"], model.cfg
    for name, axis in (("w_out2", -1), ("b_out2", -1)):
        j = np32(jkw[name])
        if cfg.loss_type == "mol":
            j = np.concatenate([j[..., s * seg : s * seg + cfg.mol_mix] for s in range(3)], axis)
        else:
            j = j[..., : cfg.out_width]
        got = fk.unpack_head(cfg, kw[name].float()).numpy()
        np.testing.assert_array_equal(got, j.reshape(got.shape), err_msg=name)


@pytest.mark.parametrize("head,mu_law,double_gate", KERNEL_CASES)
def test_plain_kernel_matches_jax_kernel(head, mu_law, double_gate):
    jmodel, jparams, wav = _small(head, mu_law, double_gate)
    audio, want_audio = _kernel_parity(jmodel, jparams, wav, L=96)
    # greedy audio agrees wherever no argmax or quantization boundary flipped
    assert np.mean(np.abs(audio - want_audio) <= 2.0 / jmodel.cfg.quant_chann) > 0.9


@pytest.mark.parametrize("head,mu_law,double_gate", KERNEL_CASES[:3])
def test_sampled_run_replays_from_its_out_params(head, mu_law, double_gate):
    """A sampled free run is its sampler applied to its own head outputs with
    the same Philox draws: the check chip_smoke.py makes of the CUDA kernel."""
    jmodel, jparams, _ = _small(head, mu_law, double_gate, B=4)
    model, params = _port(jmodel, jparams)
    kw = fk.build_kernel_weights(model.cfg, params)
    enc = torch.rand((48, 4, 128), generator=torch.Generator().manual_seed(2))
    audio, outp = fk.generate(kw, enc.to(torch.bfloat16), 11, collect_out_params=True)
    assert torch.isfinite(audio).all() and audio.abs().max() <= 1.0
    assert audio.std() > 0
    torch.testing.assert_close(fk.resample_plain(model.cfg, outp, 11), audio, rtol=0, atol=0)
    # the feedback is what the network saw: teacher forcing with the run's own
    # audio reproduces its head outputs
    _, again = fk.generate(kw, enc.to(torch.bfloat16), 11, tf=audio.T, collect_out_params=True)
    torch.testing.assert_close(again, outp, rtol=0, atol=0)


def test_serving_path_windows_the_conditioning():
    """generate_cuda(cond_offset=k) runs the kernel on conditioning frames
    [k, k + L) of the deconv output, as generate_pallas slices them."""
    jmodel, jparams, wav = _small("mol", False, False, B=2)
    model, params = _port(jmodel, jparams)
    mel = torch.from_numpy(tstft.melspectrogram_np(wav[:, :640]))
    enc_t = model.deconv_stack(params, mel).transpose(0, 1)
    kw = fk.build_kernel_weights(model.cfg, params)
    fg = Fastgen(model)
    got = fg.generate_cuda(params, mel, seed=3, length=24, cond_offset=100, kw=kw)
    want = fk.generate(kw, enc_t[100:124].to(torch.bfloat16).contiguous(), 3)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    with pytest.raises(ValueError):
        fg.generate_cuda(params, mel, seed=3, length=24, cond_offset=enc_t.shape[0] - 10, kw=kw)


def test_plain_kernel_matches_jax_kernel_on_golden_mol():
    jmodel, jparams, wav = _golden_inputs("mol")
    _kernel_parity(jmodel, jparams, wav, L=64)


def test_philox_matches_known_answers_and_is_uniform():
    # Random123 known-answer vectors for philox4x32_10, first output word
    zero = torch.zeros(1, dtype=torch.int64)
    assert int(fk.philox_bits(zero, zero, zero, zero, 0)) == 0x6627E8D5
    ones = zero + 0xFFFFFFFF
    assert int(fk.philox_bits(ones, ones, ones, ones, -1)) == 0x408F276D

    u = fk.philox_uniform_plain(7, 11, 256, 1024, 0).numpy()
    assert u.dtype == np.float32 and u.shape == (256, 1024)
    assert u.min() >= 1e-5 and u.max() <= 1 - 1e-5
    assert (u <= 1e-5).mean() < 1e-2  # no pile-up at the floor (a signed shift would)
    assert u.max() > 0.99 and abs(u.mean() - 0.5) < 0.02
    assert abs(np.var(u) - 1 / 12) < 2e-3
    # other steps and the second draw are different streams
    other = [fk.philox_uniform_plain(7, 12, 256, 1024, 0).numpy(),
             fk.philox_uniform_plain(7, 11, 256, 1024, 1).numpy(),
             fk.philox_uniform_plain(8, 11, 256, 1024, 0).numpy()]
    for v in other:
        assert abs(np.corrcoef(u.ravel(), v.ravel())[0, 1]) < 0.01


def _mel_corr(audio, mels, n):
    """Mean mel correlation of each clip with its own conditioning (matched)
    and with the other clips' (mismatched)."""
    matched, mismatched = [], []
    for i in range(len(audio)):
        gen = tstft.melspectrogram_np(audio[i][:n])
        for j in range(len(mels)):
            c = np.corrcoef(gen.ravel(), mels[j, : gen.shape[0]].ravel())[0, 1]
            (matched if i == j else mismatched).append(c)
    return float(np.mean(matched)), float(np.mean(mismatched))


def test_golden_freerun_tracks_conditioning():
    """Sampled free run of the plain kernel version on the trained MoL golden:
    the sampler, Philox draws and feedback must produce audio that follows its
    own mel more than the other utterance's."""
    n = 8000
    wavs = [wav_io.read_wav(os.path.join("tests", "golden", f"gen_golden_mol_{i}.wav"),
                            expect_sr=16000)[0] for i in (0, 1)]
    mels = tstft.melspectrogram_np(np.stack([w[:n] for w in wavs]))
    d = golden_dir("mol")
    model = Wavenet(tconfig.load_config(os.path.join(d, "meta.json")))
    params = weights.load_npz(os.path.join(d, "params.npz"), device="cpu")
    audio = Fastgen(model).generate_cuda(params, torch.from_numpy(mels), seed=7, length=n).numpy()
    assert audio.shape == (2, n) and np.isfinite(audio).all() and np.abs(audio).max() <= 1.0
    matched, mismatched = _mel_corr(audio, mels, n)
    assert matched > mismatched + 0.05, (matched, mismatched)
