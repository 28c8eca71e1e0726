"""The port's W8A8 static serving mode and its streaming state against the JAX
package, on the CPU.

The int8 weights, scales and quantisers must equal the JAX package's; the
plain version of the W8A8 CUDA kernels (fastgen_kernel.generate_plain on int8
weights) is held against the JAX Pallas kernel in interpret mode with
weight_dtype=int8, act_scale="static", gate_scale="static", teacher-forced so
that sampling cannot diverge; chained chunks must equal one call bit for bit
in both modes, greedy and sampled.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nsynth_wavenet_tpu.models.fastgen import Fastgen as JFastgen
from nsynth_wavenet_tpu.ops import fastgen_kernel as jfk
from nsynth_wavenet_tpu.ops import stft as jstft
from nsynth_wavenet_tpu_torch import config as tconfig
from nsynth_wavenet_tpu_torch import weights
from nsynth_wavenet_tpu_torch.data import wav_io
from nsynth_wavenet_tpu_torch.evaluation import generate_wavenet
from nsynth_wavenet_tpu_torch.models.fastgen import Fastgen
from nsynth_wavenet_tpu_torch.models.wavenet import Wavenet
from nsynth_wavenet_tpu_torch.ops import fastgen_kernel as fk
from nsynth_wavenet_tpu_torch.ops import stft as tstft
from test_torch_fastgen import KERNEL_CASES, _golden_inputs, _mel_corr, _port, _small
from tools.make_golden_ckpt import golden_dir

GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The step loops here are thousands of tiny ops: one thread runs them as
    fast as many, and it keeps this file's worker from fighting the other
    test workers' thread pools for the cores (two step-loop tests side by side
    on full pools ran 70 times slower than alone)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _np32(x):
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _strict(fn, *args, **kwargs):
    """fn(*args, **kwargs) compiled without XLA's excess precision.  By default
    XLA on the CPU keeps a fused bf16 product in f32 (xla_allow_excess_precision),
    so the jitted kernel's conditioning quantiser skips the bf16 rounding that
    the same function makes op by op (and that the port mirrors): about a tenth
    of its int8 values then move by one, and the head outputs by up to
    5e-3 x scale.  With the flag off the two sides agree to 1e-6 x scale."""
    compiled = jax.jit(fn).lower(*args, **kwargs).compile(
        compiler_options={"xla_allow_excess_precision": False})
    return compiled(*args, **kwargs)


def _w8a8_setup(jmodel, jparams, wav):
    """Calibrated W8A8-static packed weights on both sides from the same
    parameters and the same calibration audio (the JAX amax feeds both, so
    the comparison is of the kernels, not of the calibration)."""
    mel = jstft.melspectrogram_np(wav)
    amax = JFastgen(jmodel).calibrate_act_amax(jparams, jnp.asarray(wav), jnp.asarray(mel))
    jkw = jfk.build_kernel_weights(jmodel.cfg, jparams, weight_dtype=jnp.int8, act_amax=amax,
                                   gate_static=True)
    model, params = _port(jmodel, jparams)
    kw = fk.build_kernel_weights(model.cfg, params, weight_dtype="int8",
                                 act_amax=np.array(amax), gate_static=True)
    return mel, jkw, model, params, kw


@pytest.mark.parametrize("head,mu_law,double_gate", KERNEL_CASES[:1] + KERNEL_CASES[3:])
def test_int8_weights_and_scales_equal_jax(head, mu_law, double_gate):
    jmodel, jparams, wav = _small(head, mu_law, double_gate)
    _, jkw, model, _, kw = _w8a8_setup(jmodel, jparams, wav)
    assert kw["w_comb"].dtype == torch.int8 and kw["w_rs"].dtype == torch.int8
    for name in ("w_comb", "w_rs"):
        np.testing.assert_array_equal(kw[name].numpy(), np.asarray(jkw[name]), err_msg=name)
    # the same f32 operations in the same order on both sides: bit for bit
    for name in ("s_comb", "s_rs", "s_main", "s_act_inv", "b_comb", "b_rs"):
        assert kw[name].dtype == torch.float32
        np.testing.assert_array_equal(kw[name].numpy(), _np32(jkw[name]), err_msg=name)
    for name in ("w_skip0", "w_out1"):  # the head stays bf16 in every mode
        assert kw[name].dtype == torch.bfloat16
        np.testing.assert_array_equal(kw[name].float().numpy(), _np32(jkw[name]), err_msg=name)
    # the CUDA kernels' layout holds the same matrix: word (k/4, n) = k..k+3 of column n
    for name in ("w_comb", "w_rs"):
        k4 = kw[name + "_k4"]
        nl, k, n = kw[name].shape
        assert k4.shape == (nl, k // 4, n, 4) and k4.is_contiguous()
        assert torch.equal(k4.permute(0, 1, 3, 2).reshape(nl, k, n), kw[name])


def test_int8_weights_without_scales_and_refusals():
    jmodel, jparams, wav = _small("mol", False, False, B=2)
    model, params = _port(jmodel, jparams)
    # int8 weights alone are the calibration-free mode: packed as the JAX package packs them ...
    jkw = jfk.build_kernel_weights(jmodel.cfg, jparams, weight_dtype=jnp.int8)
    kw = fk.build_kernel_weights(model.cfg, params, weight_dtype="int8")
    np.testing.assert_array_equal(kw["w_comb"].numpy(), np.asarray(jkw["w_comb"]))
    np.testing.assert_array_equal(kw["s_rs"].numpy(), _np32(jkw["s_rs"]))
    assert "s_act_inv" not in kw and tuple(fk.kernel_mode(kw)) == ("row", "row")
    # ... and they run, with per-row scales, where they used to be refused
    enc = torch.zeros((4, 2, 128), dtype=torch.bfloat16)
    audio = fk.generate(kw, enc, 0)
    assert audio.shape == (2, 4) and torch.isfinite(audio).all()
    mel = torch.from_numpy(tstft.melspectrogram_np(wav[:, :640]))
    fg = Fastgen(model)
    audio = fg.generate_cuda(params, mel, seed=0, length=8, weight_dtype="int8")
    assert audio.shape == (2, 8) and torch.isfinite(audio).all()
    amax = np.ones(model.cfg.num_layers, np.float32)
    audio = fg.generate_cuda(params, mel, seed=0, length=8, weight_dtype="int8", act_amax=amax)
    assert audio.shape == (2, 8) and torch.isfinite(audio).all()  # static activations, per-row gate
    # what is still refused: scales that the weights' type has no use for
    with pytest.raises(ValueError, match="act_amax"):
        fk.build_kernel_weights(model.cfg, params, act_amax=amax)
    with pytest.raises(ValueError, match="gate_static"):
        fk.build_kernel_weights(model.cfg, params, gate_static=True)
    with pytest.raises(ValueError, match="gate_static"):
        fk.build_kernel_weights(model.cfg, params, weight_dtype="int8", rs_dtype="bf16",
                                gate_static=True)
    with pytest.raises(ValueError, match="act_amax"):
        fg.generate_cuda(params, mel, seed=0, length=8, act_amax=amax)
    with pytest.raises(ValueError, match="rs_dtype"):
        fk.build_kernel_weights(model.cfg, params, rs_dtype="fp8")


def _quantizer_inputs():
    rng = np.random.RandomState(3)
    x = rng.randn(6, 128).astype(np.float32) * np.array([[1e-4], [0.3], [1.0], [5.0], [30.0], [1.0]],
                                                         np.float32)
    x[5] = 0.0  # an all-zero row takes the 1e-8 floor
    # row 2: amax = 127 makes the multiplier 1, so these land exactly on ties
    x[2, :8] = [127.0, 0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 126.5]
    # row 3 (bf16 case): amax 1.0059 gives a multiplier that rounds UP in bf16 (126.5), and a
    # value near amax whose bf16 product reaches 127.5 -> rounds to 128 without the clip
    x[3] = np.clip(x[3], -0.9, 0.9)
    x[3, :2] = [1.00390625, -1.00390625]
    return x


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quant_rows_dyn_equals_jax(dtype):
    x = _quantizer_inputs()
    jx = jnp.asarray(x).astype(dtype)
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    want_q, want_r = jfk._quant_rows_dyn(jx)
    got_q, got_r = fk.quant_rows_dyn(tx)
    assert got_q.dtype == torch.int8 and got_r.dtype == torch.float32 and got_r.shape == (6, 1)
    np.testing.assert_array_equal(got_q.numpy(), np.asarray(want_q))
    np.testing.assert_array_equal(got_r.numpy(), np.asarray(want_r))
    assert np.abs(got_q.numpy()).max() == 127
    if dtype == "bfloat16":
        # the clip is load-bearing: the unclipped bf16 product rounds past 127 somewhere
        amax = tx.abs().amax(-1, keepdim=True).float().clamp(min=1e-8)
        prod = (tx * (amax.new_tensor(127.0) / amax).to(tx.dtype)).float()
        assert float(torch.round(prod).abs().max()) > 127


def test_quant_static_equals_jax():
    x = _quantizer_inputs()
    for inv in (1.0, 127.0 / 5.0, 127.0 / 0.37):
        want = np.asarray(jfk._quant_static(jnp.asarray(x), jnp.float32(inv)))
        got = fk.quant_static(torch.from_numpy(x), torch.tensor(inv))
        assert got.dtype == torch.int8
        np.testing.assert_array_equal(got.numpy(), want)
    # ties round to even, loud values clip symmetrically
    got = fk.quant_static(torch.tensor([0.5, 1.5, 2.5, -0.5, -1.5, 300.0, -300.0]), torch.tensor(1.0))
    assert got.tolist() == [0, 2, 2, 0, -2, 127, -127]


@pytest.mark.parametrize("head,mu_law,double_gate", KERNEL_CASES[:1] + KERNEL_CASES[2:3])
def test_calibrate_act_amax_matches_jax(head, mu_law, double_gate):
    jmodel, jparams, wav = _small(head, mu_law, double_gate, B=4)
    mel = jstft.melspectrogram_np(wav)
    want = np.asarray(JFastgen(jmodel).calibrate_act_amax(jparams, jnp.asarray(wav),
                                                          jnp.asarray(mel)))
    model, params = _port(jmodel, jparams)
    got = Fastgen(model).calibrate_act_amax(params, torch.from_numpy(wav), torch.from_numpy(mel))
    assert got.shape == (model.cfg.num_layers,) and got.dtype == torch.float32
    assert (got > 0).all()
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=0)


def _w8a8_parity(jmodel, jparams, wav, L):
    """generate_plain (W8A8 static) vs the JAX Pallas kernel in the same mode
    (interpret, see _strict), teacher-forced + greedy.  The integer products
    are exact on both sides; what remains is an LSB flip of a quantiser where
    the f32 values before it differ in their last bits (readings: 3e-8 to
    3e-4 x scale), so the limit is 1e-3 x scale, five times tighter than the
    bf16 mode's."""
    cfg = jmodel.cfg
    B = wav.shape[0]
    mel, jkw, model, _, kw = _w8a8_setup(jmodel, jparams, wav)
    enc, _ = jmodel.deconv_stack(jparams, jnp.asarray(mel))
    off = (enc.shape[1] - wav.shape[1]) // 2
    enc_t = jnp.transpose(enc, (1, 0, 2))[off : off + L]
    tf = np.ascontiguousarray(wav[:, :L].T)
    jseg = jkw.pop("out_pad_seg")
    jkw.pop("out_pad")
    gen = jfk.make_generate_fn(cfg, B, L, weight_dtype=jnp.int8, act_scale="static",
                               gate_scale="static", teacher_forced=True, collect_out_params=True,
                               greedy=True, interpret=True)
    _, want = (np.asarray(a) for a in _strict(gen, jkw, enc_t, 123, tf=jnp.asarray(tf)))
    if cfg.loss_type == "mol":
        want = np.concatenate([want[..., s * jseg : s * jseg + cfg.mol_mix] for s in range(3)], -1)
    else:
        want = want[..., : cfg.out_width]
    enc_bf = torch.from_numpy(np.array(enc_t.astype(jnp.float32))).to(torch.bfloat16)
    audio, outp = fk.generate(kw, enc_bf, 123, greedy=True, tf=torch.from_numpy(tf),
                              collect_out_params=True)
    got = fk.unpack_head(model.cfg, outp).numpy()
    assert audio.shape == (B, L) and got.shape == want.shape
    scale = max(np.abs(want).max(), 1.0)
    print(f"W8A8 plain vs JAX kernel {cfg.loss_type}: max|d| {np.abs(got - want).max():.3e}, "
          f"scale {scale:.3f}")
    np.testing.assert_allclose(got, want, atol=1e-3 * scale, rtol=0)
    return kw, enc_bf, tf, got


@pytest.mark.parametrize("head,mu_law,double_gate", KERNEL_CASES[:3])
def test_plain_w8a8_matches_jax_kernel(head, mu_law, double_gate):
    jmodel, jparams, wav = _small(head, mu_law, double_gate)
    kw, enc_bf, tf, got = _w8a8_parity(jmodel, jparams, wav, L=64)
    if head == "mol":
        # and W8A8 stays within 5 % of the bf16 mode's output scale (the reference's own gate)
        model, params = _port(jmodel, jparams)
        _, outp = fk.generate(fk.build_kernel_weights(model.cfg, params), enc_bf, 123, greedy=True,
                              tf=torch.from_numpy(tf), collect_out_params=True)
        bf = fk.unpack_head(model.cfg, outp).numpy()
        assert np.abs(got - bf).max() < 0.05 * np.abs(bf).max()


def test_plain_w8a8_matches_jax_kernel_on_golden_mol():
    jmodel, jparams, wav = _golden_inputs("mol")
    _w8a8_parity(jmodel, jparams, wav, L=64)


def _chained(kw, enc, seed, splits, **kwargs):
    state, pieces, outs = None, [], []
    c0 = 0
    for n in splits:
        tf = kwargs.get("tf")
        res = fk.generate(kw, enc[c0 : c0 + n], seed, greedy=kwargs.get("greedy", False),
                          tf=None if tf is None else tf[c0 : c0 + n], collect_out_params=True,
                          state=state, return_state=True)
        pieces.append(res[0])
        outs.append(res[1])
        state = res[2]
        c0 += n
    assert c0 == enc.shape[0] and state[2] == c0
    return torch.cat(pieces, 1), torch.cat(outs, 1), state


@pytest.mark.parametrize("mode", ["bf16", "w8a8"])
@pytest.mark.parametrize("greedy", [True, False])
def test_chained_chunks_equal_one_call(mode, greedy):
    jmodel, jparams, wav = _small("mol", False, False, B=4)
    if mode == "w8a8":
        _, _, model, params, kw = _w8a8_setup(jmodel, jparams, wav)
    else:
        model, params = _port(jmodel, jparams)
        kw = fk.build_kernel_weights(model.cfg, params)
    enc = torch.rand((96, 4, 128), generator=torch.Generator().manual_seed(4)).to(torch.bfloat16)
    audio, outp, state = fk.generate(kw, enc, 9, greedy=greedy, collect_out_params=True,
                                     return_state=True)
    assert state[0].dtype == (torch.int8 if mode == "w8a8" else torch.bfloat16)
    assert state[1].shape == (3, 4) and state[2] == 96
    if not greedy:
        assert audio.std() > 0
    # 32 of 96, and a ragged split with chunks shorter than the largest 2d (4 at 2 stages)
    for splits in ((32, 32, 32), (3, 50, 1, 42)):
        a, o, st = _chained(kw, enc, 9, splits, greedy=greedy)
        assert torch.equal(a, audio) and torch.equal(o, outp)
        assert torch.equal(st[0], state[0]) and torch.equal(st[1], state[1])
    # the random counter runs on the global step: the replay of a later chunk needs its t0
    if not greedy:
        assert torch.equal(fk.resample_plain(model.cfg, outp[:, 50:], 9, t0=50), audio[:, 50:])


@pytest.mark.parametrize("mode", ["bf16", "w8a8"])
def test_generate_cuda_chunked_equals_one_shot(mode):
    jmodel, jparams, wav = _small("mol", False, False, B=4)
    mel, _, model, params, kw = _w8a8_setup(jmodel, jparams, wav)
    tkwargs = {}
    if mode == "w8a8":
        tkwargs = dict(weight_dtype="int8", act_amax=127.0 / kw["s_act_inv"], gate_static=True)
    fg = Fastgen(model)
    tmel = torch.from_numpy(mel)
    for greedy in (True, False):
        full = fg.generate_cuda(params, tmel, 3, length=96, greedy=greedy, **tkwargs)
        for chunk in (32, 40):  # 40 does not divide 96: the last chunk runs at 16
            got = fg.generate_cuda(params, tmel, 3, length=96, greedy=greedy, chunk=chunk, **tkwargs)
            assert got.shape == (4, 96) and torch.equal(got, full)
    # an encoding upsampled by the caller takes the mel's place
    enc = model.deconv_stack(params, tmel)
    got = fg.generate_cuda(params, None, 3, length=96, chunk=40, encoding=enc, **tkwargs)
    assert torch.equal(got, full)


@pytest.mark.parametrize("mode", ["bf16", "w8a8"])
def test_streamed_plain_tracks_jax_streaming_kernel(mode):
    """The JAX kernel built with streaming=True and chained over chunks of 32
    against the port's chained calls.  Teacher-forced and greedy, as the
    one-shot parity test is: a free greedy run feeds back its own samples, and
    a head difference far below any tolerance then moves every later sample by
    several of the 65536 bins."""
    jmodel, jparams, wav = _small("mol", False, False)
    cfg, B, L, chunk = jmodel.cfg, wav.shape[0], 96, 32
    mel, jkw, model, params, kw = _w8a8_setup(jmodel, jparams, wav)
    jopts = dict(weight_dtype=jnp.int8, act_scale="static", gate_scale="static")
    if mode == "bf16":
        jkw, jopts = jfk.build_kernel_weights(cfg, jparams), {}
        kw = fk.build_kernel_weights(model.cfg, params)
    jkw.pop("out_pad_seg"), jkw.pop("out_pad")
    enc, _ = jmodel.deconv_stack(jparams, jnp.asarray(mel))
    off = (enc.shape[1] - wav.shape[1]) // 2
    enc_t = jnp.transpose(enc, (1, 0, 2))[off : off + L]
    tf = np.ascontiguousarray(wav[:, :L].T)
    gen = jfk.make_generate_fn(cfg, B, chunk, streaming=True, teacher_forced=True, greedy=True,
                               interpret=True, **jopts)
    state, want = None, []
    for c0 in range(0, L, chunk):
        audio, state = _strict(gen, jkw, enc_t[c0 : c0 + chunk], 123,
                               tf=jnp.asarray(tf[c0 : c0 + chunk]), state=state)
        want.append(np.asarray(audio))
    want = np.concatenate(want, 1)
    enc_bf = torch.from_numpy(np.array(enc_t.astype(jnp.float32))).to(torch.bfloat16)
    got, _, tstate = _chained(kw, enc_bf, 123, (chunk,) * 3, greedy=True, tf=torch.from_numpy(tf))
    assert np.mean(np.abs(got.numpy() - want) <= 2.0 / cfg.quant_chann) > 0.9
    # the carried state is the same object on both sides: ring rows, taps, step
    jl, jxh, jt0 = state
    assert int(jt0) == tstate[2] == L
    np.testing.assert_allclose(tstate[1].numpy(), np.asarray(jxh)[:3], atol=1e-6, rtol=0)
    if mode == "w8a8":
        ring = np.abs(tstate[0].numpy().astype(np.int32) - np.asarray(jl).astype(np.int32))
        assert ring.max() <= 1 and (ring > 0).mean() < 0.01


@pytest.mark.parametrize("head", ["mol", "ce"])
def test_step_loop_streaming_equals_one_call(head):
    jmodel, jparams, wav = _golden_inputs(head)
    model, params = _port(jmodel, jparams)
    fg = Fastgen(model)
    mel = torch.from_numpy(jstft.melspectrogram_np(wav[:, :400]))
    full = fg.generate(params, mel, torch.Generator().manual_seed(5), length=70)
    assert full.std() > 0
    for chunk in (32, 7):
        got = fg.generate_streaming(params, mel, torch.Generator().manual_seed(5), length=70,
                                    chunk=chunk)
        assert got.shape == (2, 70) and torch.equal(got, full)
    # the carry is a value a caller can hold: two chained calls by hand
    enc = model.deconv_stack(params, mel)
    carry = fg.init_carry(2, torch.Generator().manual_seed(5), "cpu")
    a, carry = fg.generate(params, None, encoding=enc[:, :30], carry_in=carry, return_carry=True)
    b, carry = fg.generate(params, None, encoding=enc[:, 30:70], carry_in=carry, return_carry=True)
    assert carry[3] == 70 and torch.equal(torch.cat([a, b], 1), full)


def test_step_loop_carry_matches_jax_carry_teacher_forced():
    """Chained teacher-forced chunks against the JAX scan chained the same
    way.  Both feed zero into step 0 of a call, so the teacher's samples just
    before each chunk boundary are set to zero: the chained run is then the
    one-shot run, on both sides."""
    jmodel, jparams, wav = _golden_inputs("mol")
    L, chunk = 64, 32
    wav = wav.copy()
    wav[:, chunk - 1 : L : chunk] = 0.0
    mel = jstft.melspectrogram_np(wav)
    enc, _ = jmodel.deconv_stack(jparams, jnp.asarray(mel))
    off = (enc.shape[1] - wav.shape[1]) // 2
    jfg = JFastgen(jmodel)
    carry = jfg.init_carry(2, jax.random.PRNGKey(1))
    want = []
    for c0 in range(0, L, chunk):
        (_, outs), carry = jfg.generate(
            jparams, None, None, encoding=enc[:, off + c0 : off + c0 + chunk], carry_in=carry,
            return_carry=True, teacher_force=jnp.asarray(wav[:, c0 : c0 + chunk]),
            collect_out_params=True)
        want.append(np.asarray(outs))
    want = np.concatenate(want, 1)

    model, params = _port(jmodel, jparams)
    fg = Fastgen(model)
    tenc = model.deconv_stack(params, torch.from_numpy(mel))
    carry = fg.init_carry(2, torch.Generator().manual_seed(1), "cpu")
    got = []
    for c0 in range(0, L, chunk):
        (_, outs), carry = fg.generate(
            params, None, encoding=tenc[:, off + c0 : off + c0 + chunk], carry_in=carry,
            return_carry=True, teacher_force=torch.from_numpy(wav[:, c0 : c0 + chunk]),
            collect_out_params=True)
        got.append(outs.numpy())
    got = np.concatenate(got, 1)
    np.testing.assert_allclose(got, want, atol=1e-4 * max(np.abs(want).max(), 1.0), rtol=0)
    # and the chained run is the one-shot run
    _, one = fg.generate(params, torch.from_numpy(mel), torch.Generator().manual_seed(1), length=L,
                         teacher_force=torch.from_numpy(wav), cond_offset=off,
                         collect_out_params=True)
    assert torch.equal(torch.from_numpy(got), one)


def _golden_src(tmp_path, n):
    src = tmp_path / "src"
    src.mkdir()
    for i in (0, 1):
        wav, _ = wav_io.read_wav(os.path.join(GOLDEN, f"gen_golden_mol_{i}.wav"))
        wav_io.write_wav(str(src / f"utt_{i}.wav"), wav[:n])
    return src


def test_eval_path_w8a8_streamed_writes_finite_wavs(tmp_path):
    """The slice as a whole on the CPU: wavs -> calibration -> int8 packing ->
    chained plain W8A8 calls -> gen_*.wav."""
    src = _golden_src(tmp_path, 1000)
    d = golden_dir("mol")
    paths = generate_wavenet(str(src), os.path.join(d, "params.npz"), os.path.join(d, "meta.json"),
                             str(tmp_path / "gen"), device="cpu", sample_length=400, int8=True,
                             int8_static=True, streaming_chunk=250)
    assert [os.path.basename(p) for p in paths] == ["gen_utt_0.wav", "gen_utt_1.wav"]
    for p in paths:
        wav, sr = wav_io.read_wav(p)
        assert sr == 16000 and wav.shape == (600,)
        assert np.isfinite(wav).all() and np.abs(wav).max() > 0


def test_eval_path_refusals(tmp_path):
    src = _golden_src(tmp_path, 400)
    d = golden_dir("mol")
    args = (os.path.join(d, "params.npz"), os.path.join(d, "meta.json"), str(tmp_path / "gen"))
    with pytest.raises(ValueError, match="int8_static needs int8"):
        generate_wavenet(str(src), *args, device="cpu", int8_static=True)
    # int8 alone needs no calibration audio any more: it runs (per-row scales)
    paths = generate_wavenet(str(src), *args, device="cpu", int8=True, sample_length=200)
    assert len(paths) == 2 and all(np.isfinite(wav_io.read_wav(p)[0]).all() for p in paths)
    # static scales still need wavs to calibrate on
    mels = tmp_path / "mels"
    mels.mkdir()
    np.save(str(mels / "utt_0.npy"), np.zeros((3, 80), np.float32))
    with pytest.raises(ValueError, match="need .wav sources"):
        generate_wavenet(str(mels), *args, device="cpu", int8=True, int8_static=True)


def test_golden_freerun_w8a8_tracks_conditioning():
    """Sampled W8A8 free run of the plain version on the trained MoL golden,
    calibrated on the two golden wavs: it must follow its own mel more than
    the other utterance's, as the bf16 free run does."""
    n = 4000
    wavs = np.stack([wav_io.read_wav(os.path.join(GOLDEN, f"gen_golden_mol_{i}.wav"),
                                     expect_sr=16000)[0][:n] for i in (0, 1)])
    mels = tstft.melspectrogram_np(wavs)
    d = golden_dir("mol")
    model = Wavenet(tconfig.load_config(os.path.join(d, "meta.json")))
    params = weights.load_npz(os.path.join(d, "params.npz"), device="cpu")
    fg = Fastgen(model)
    amax = fg.calibrate_act_amax(params, torch.from_numpy(wavs), torch.from_numpy(mels))
    audio = fg.generate_cuda(params, torch.from_numpy(mels), seed=7, length=n, weight_dtype="int8",
                             act_amax=amax, gate_static=True).numpy()
    assert audio.shape == (2, n) and np.isfinite(audio).all() and np.abs(audio).max() <= 1.0
    matched, mismatched = _mel_corr(audio, mels, n)
    assert matched > mismatched + 0.05, (matched, mismatched)
