"""The port's calibration-free W8A8 modes against the JAX package, on the CPU.

Per-row log8 activation scales whose codes ride in the ring, per-row gate
scales, bf16 res/skip under an int8 ring (and int8 res/skip under a bf16
ring), and the bf16 combine: the quantiser and the packed arrays must equal
the JAX package's; the plain version of each mode
(fastgen_kernel.generate_plain) is held against the JAX Pallas kernel in
interpret mode with the same options, teacher-forced so that sampling cannot
diverge; chained chunks must equal one call bit for bit, exponent codes
included.
"""

import os

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
from nsynth_wavenet_tpu_torch.evaluation import discover_files, generate_wavenet, load_mel_batch
from nsynth_wavenet_tpu_torch.models.fastgen import Fastgen
from nsynth_wavenet_tpu_torch.models.wavenet import Wavenet
from nsynth_wavenet_tpu_torch.ops import fastgen_kernel as fk
from nsynth_wavenet_tpu_torch.ops import stft as tstft
from test_torch_fastgen import _golden_inputs, _mel_corr, _port, _small
from test_torch_fastgen_w8a8 import _chained, _golden_src, _np32, _strict
from tools.make_golden_ckpt import golden_dir

GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden")
JDT = {"int8": jnp.int8, "bf16": jnp.bfloat16, None: None}

# (weight_dtype, rs_dtype, static activation scales, gate_static, int8_combine) -> the port's Mode
MODES = {
    "row": ("int8", None, False, False, "f32"),
    "row_combine_bf16": ("int8", None, False, False, "bf16"),
    "row_gate_static": ("int8", None, False, True, "f32"),
    "row_rs_bf16": ("int8", "bf16", False, False, "f32"),
    "static_gate_row": ("int8", None, True, False, "f32"),
    "static_rs_bf16": ("int8", "bf16", True, False, "f32"),
    "bf16_rs_int8_row": ("bf16", "int8", False, False, "f32"),
    "bf16_rs_int8_static": ("bf16", "int8", False, True, "f32"),
}
WANT_MODE = {
    "row": ("row", "row"), "row_combine_bf16": ("row", "row"), "row_gate_static": ("row", "static"),
    "row_rs_bf16": ("row", "bf16"), "static_gate_row": ("static", "row"),
    "static_rs_bf16": ("static", "bf16"), "bf16_rs_int8_row": ("bf16", "row"),
    "bf16_rs_int8_static": ("bf16", "static"),
}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The step loops here are thousands of tiny ops: one thread runs them as
    fast as many, and it keeps this file's worker from fighting the other
    test workers' thread pools for the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _setup(jmodel, jparams, wav, name):
    """Packed weights of one mode on both sides (the JAX amax feeds both),
    the JAX make_generate_fn options, and the port's int8_combine."""
    wd, rsd, static, gate_static, combine = MODES[name]
    mel = jstft.melspectrogram_np(wav)
    amax = None
    if static:
        amax = JFastgen(jmodel).calibrate_act_amax(jparams, jnp.asarray(wav), jnp.asarray(mel))
    jkw = jfk.build_kernel_weights(jmodel.cfg, jparams, weight_dtype=JDT[wd], rs_dtype=JDT[rsd],
                                   act_amax=amax, gate_static=gate_static)
    jopts = dict(weight_dtype=JDT[wd], rs_dtype=JDT[rsd], act_scale="static" if static else "row",
                 gate_scale="static" if gate_static else "row", int8_combine=combine)
    model, params = _port(jmodel, jparams)
    kw = fk.build_kernel_weights(model.cfg, params, weight_dtype=wd, rs_dtype=rsd,
                                 act_amax=None if amax is None else np.array(amax),
                                 gate_static=gate_static)
    assert tuple(fk.kernel_mode(kw)) == WANT_MODE[name]
    return mel, jkw, jopts, model, params, kw, combine


def _log8_inputs():
    rng = np.random.RandomState(1)  # the three magnitudes of the JAX package's own round-trip test
    return np.concatenate([rng.randn(3, 256).astype(np.float32) * s for s in (1e-4, 1.0, 30.0)])


def test_quant_log8_equals_jax():
    x = _log8_inputs()
    want_q, want_e, want_r = (np.asarray(a) for a in jfk._quant_log8(jnp.asarray(x)))
    q, e, r = fk.quant_log8(torch.from_numpy(x))
    assert q.dtype == torch.int8 and e.dtype == torch.int8 and r.dtype == torch.float32
    assert e.shape == (9, 1) and r.shape == (9, 1)
    np.testing.assert_array_equal(e.numpy(), want_e)
    np.testing.assert_array_equal(q.numpy(), want_q)
    # r comes from the table (2^(e/8) rounded once from f64) and is exact at whole powers of two;
    # XLA's f32 exp2 on the CPU is up to 4 ulp off there (2^-15 comes back 4.8e-7 high), so the
    # limit is the JAX package's own for r, 1e-6
    np.testing.assert_allclose(r.numpy(), want_r, rtol=1e-6, atol=0)
    assert float(r[0]) == 2.0 ** -15
    # the quiet rows sit on the code's floor, where the scale no longer follows the row
    assert e[:3].tolist() == [[fk.LOG8_MIN]] * 3 and int(e.max()) < 0
    # a sweep over magnitudes: the code comes from a table search here and from
    # ceil(8 * log2(.)) there, so a row whose amax / 127 lies within a rounding of a
    # table entry may take the neighbouring code
    rng = np.random.RandomState(2)
    xs = (rng.randn(4096, 64) * np.exp2(rng.uniform(-14, 10, size=(4096, 1)))).astype(np.float32)
    xs[0] = 0.0  # the 1e-8 floor: code -120 on a zero payload
    jq, je, _ = (np.asarray(a) for a in jfk._quant_log8(jnp.asarray(xs)))
    tq, te, tr = fk.quant_log8(torch.from_numpy(xs))
    differ = te.numpy() != je
    print(f"quant_log8: {int(differ.sum())} of {len(xs)} codes differ from the JAX quantiser's")
    assert differ.mean() <= 1e-3 and np.abs(te.numpy().astype(int) - je.astype(int)).max() <= 1
    # where the codes agree the payloads do, but for a value on a rounding tie: the multiplier
    # 2^(-e/8) is the table's here and XLA's f32 exp2 there, a few ulp apart (4 of 262 144 differ)
    same = ~differ[:, 0]
    dq = np.abs(tq.numpy()[same].astype(int) - jq[same].astype(int))
    print(f"quant_log8: {int((dq > 0).sum())} of {dq.size} payload values differ, by {dq.max()} at most")
    assert dq.max() <= 1 and (dq > 0).mean() <= 1e-4
    assert int(te[0]) == fk.LOG8_MIN and not tq[0].any()
    # ceil keeps r >= amax / 127, so nothing is clipped, and the step is within 2^(1/8) of the exact one
    amax = np.abs(xs).max(-1, keepdims=True)
    loud = te.numpy() > fk.LOG8_MIN
    assert (tr.numpy() >= amax / np.float32(127)).all() and np.abs(tq.numpy()).max() <= 127
    assert (tr.numpy()[loud] <= amax[loud] / 127 * 2 ** 0.125 * 1.0001).all()
    assert (np.abs(xs - tq.numpy() * tr.numpy()) <= tr.numpy() / 2 * 1.001 + 1e-9).all()


def test_log8_tables():
    tab_r, tab_inv = fk.log8_tables("cpu")
    assert tab_r.shape == tab_inv.shape == (fk.LOG8_MAX - fk.LOG8_MIN + 1,)
    assert tab_r.dtype == tab_inv.dtype == torch.float32
    assert bool((tab_r[1:] > tab_r[:-1]).all())  # the code search needs it increasing
    e = np.arange(fk.LOG8_MIN, fk.LOG8_MAX + 1)
    np.testing.assert_allclose(tab_r.numpy(), np.exp2(e / 8.0), rtol=2.0 ** -24)
    np.testing.assert_allclose(tab_inv.numpy(), np.exp2(-e / 8.0), rtol=2.0 ** -24)
    assert tab_r[-fk.LOG8_MIN] == 1.0  # code 0, a fresh ring row's scale
    # the rule the CUDA kernels form the same values by: one of eight f32 entries times a whole
    # power of two, an exact product, equal to the correctly rounded 2^(e/8)
    frac = fk.log8_frac().numpy()
    assert frac.dtype == np.float32 and frac.shape == (8,) and frac[0] == 1.0
    np.testing.assert_array_equal(tab_r.numpy(), np.ldexp(frac[e & 7], e >> 3))
    np.testing.assert_array_equal(tab_inv.numpy(), np.ldexp(frac[-e & 7], -e >> 3))
    np.testing.assert_array_equal(tab_r.numpy(), np.exp2(e / 8.0).astype(np.float32))
    assert fk.log8_tables("cpu")[0] is tab_r  # built once


@pytest.mark.parametrize("name", ["row", "row_rs_bf16", "bf16_rs_int8_row", "bf16_rs_int8_static"])
def test_packing_equals_jax(name):
    jmodel, jparams, wav = _small("mol", False, False, B=2)
    _, jkw, _, model, _, kw, _ = _setup(jmodel, jparams, wav, name)
    act, rs = WANT_MODE[name]
    for key, int8 in (("w_comb", act != "bf16"), ("w_rs", rs != "bf16")):
        assert kw[key].dtype == (torch.int8 if int8 else torch.bfloat16)
        np.testing.assert_array_equal(kw[key].float().numpy(), _np32(jkw[key]), err_msg=key)
        scale = "s_" + key[2:]
        if int8:
            # un-folded when the gate scale is per row, divided by 127 when it is fixed
            np.testing.assert_array_equal(kw[scale].numpy(), _np32(jkw[scale]), err_msg=scale)
            k4 = kw[key + "_k4"]
            nl, k, n = kw[key].shape
            assert torch.equal(k4.permute(0, 1, 3, 2).reshape(nl, k, n), kw[key])
        else:
            assert scale not in kw and jkw[scale] is None and key + "_k4" not in kw
    assert "s_act_inv" not in kw and "s_main" not in kw and jkw["s_act_inv"] is None
    assert kw.get("gate_static", False) == (rs == "static")
    for key in ("b_comb", "b_rs"):
        np.testing.assert_array_equal(kw[key].numpy(), _np32(jkw[key]), err_msg=key)


def _parity(jmodel, jparams, wav, name, L=32):
    """generate_plain in one mode vs the JAX Pallas kernel in the same mode
    (interpret, compiled without XLA's excess precision so that the bf16
    roundings of the conditioning quantiser and of the bf16 combine happen),
    teacher-forced + greedy.  The integer products are exact on both sides;
    what remains is a quantiser LSB where the f32 values before it differ in
    their last bits.  The static mode held 1e-3 x scale; per-row scales add
    the last bits of 2^(e/8) and 2^(-e/8), which the port reads from its table
    and XLA computes with an f32 exp2 that is up to 4 ulp off, so about one
    ring payload in 1e5 moves by one and later layers carry it on (readings:
    6e-8 to 2.3e-4 x scale over 32 steps at 4 layers, 1.27e-3 over 64 steps
    on the golden): the limit is 2e-3 x scale."""
    cfg = jmodel.cfg
    B = wav.shape[0]
    mel, jkw, jopts, model, _, kw, combine = _setup(jmodel, jparams, wav, name)
    enc, _ = jmodel.deconv_stack(jparams, jnp.asarray(mel))
    off = (enc.shape[1] - wav.shape[1]) // 2
    enc_t = jnp.transpose(enc, (1, 0, 2))[off : off + L]
    tf = np.ascontiguousarray(wav[:, :L].T)
    jseg = jkw.pop("out_pad_seg")
    jkw.pop("out_pad")
    gen = jfk.make_generate_fn(cfg, B, L, teacher_forced=True, collect_out_params=True, greedy=True,
                               interpret=True, **jopts)
    _, want = (np.asarray(a) for a in _strict(gen, jkw, enc_t, 123, tf=jnp.asarray(tf)))
    if cfg.loss_type == "mol":
        want = np.concatenate([want[..., s * jseg : s * jseg + cfg.mol_mix] for s in range(3)], -1)
    else:
        want = want[..., : cfg.out_width]
    enc_bf = torch.from_numpy(np.array(enc_t.astype(jnp.float32))).to(torch.bfloat16)
    audio, outp = fk.generate(kw, enc_bf, 123, greedy=True, tf=torch.from_numpy(tf),
                              collect_out_params=True, int8_combine=combine)
    got = fk.unpack_head(model.cfg, outp).numpy()
    assert audio.shape == (B, L) and got.shape == want.shape
    scale = max(np.abs(want).max(), 1.0)
    print(f"{name} plain vs JAX kernel {cfg.loss_type}: max|d| {np.abs(got - want).max():.3e}, "
          f"scale {scale:.3f}")
    np.testing.assert_allclose(got, want, atol=2e-3 * scale, rtol=0)
    return got


@pytest.mark.parametrize("name", list(MODES))
def test_plain_mode_matches_jax_kernel(name):
    jmodel, jparams, wav = _small("mol", False, False)
    _parity(jmodel, jparams, wav, name)


@pytest.mark.parametrize("head,mu_law,double_gate", [("gauss", False, False), ("ce", True, True)])
def test_plain_row_mode_matches_jax_kernel_other_heads(head, mu_law, double_gate):
    jmodel, jparams, wav = _small(head, mu_law, double_gate)
    _parity(jmodel, jparams, wav, "row")


def test_plain_row_mode_matches_jax_kernel_on_golden_mol():
    jmodel, jparams, wav = _golden_inputs("mol")
    _parity(jmodel, jparams, wav, "row", L=64)


def test_row_modes_close_to_bf16():
    """The reference's own gates: W8A8 with per-row scales within 5 % of the
    bf16 output's scale, and bf16 res/skip no further from bf16 than 1.5 times
    the all-int8 distance."""
    jmodel, jparams, wav = _small("mol", False, False)
    L = 32
    model, params = _port(jmodel, jparams)
    mel = torch.from_numpy(tstft.melspectrogram_np(wav))
    enc = model.deconv_stack(params, mel)
    off = (enc.shape[1] - wav.shape[1]) // 2
    enc_t = enc.transpose(0, 1)[off : off + L].to(torch.bfloat16).contiguous()
    tf = torch.from_numpy(np.ascontiguousarray(wav[:, :L].T))
    outs = {}
    for name, opts in (("bf16", {}), ("row", dict(weight_dtype="int8")),
                       ("row_rs_bf16", dict(weight_dtype="int8", rs_dtype="bf16"))):
        kw = fk.build_kernel_weights(model.cfg, params, **opts)
        _, outp = fk.generate(kw, enc_t, 123, greedy=True, tf=tf, collect_out_params=True)
        outs[name] = fk.unpack_head(model.cfg, outp).numpy()
    scale = np.abs(outs["bf16"]).max()
    err_i8 = np.abs(outs["row"] - outs["bf16"]).max()
    err_rs = np.abs(outs["row_rs_bf16"] - outs["bf16"]).max()
    print(f"vs bf16: row {err_i8 / scale:.4f}, row with bf16 res/skip {err_rs / scale:.4f} of scale")
    assert err_i8 < 0.05 * scale and err_rs < 0.05 * scale
    assert err_rs <= err_i8 * 1.5 + 1e-6


@pytest.mark.parametrize("name", ["row", "row_rs_bf16", "static_gate_row"])
@pytest.mark.parametrize("greedy", [True, False])
def test_chained_chunks_equal_one_call(name, greedy):
    jmodel, jparams, wav = _small("mol", False, False, B=4)
    _, _, _, model, _, kw, _ = _setup(jmodel, jparams, wav, name)
    W = model.cfg.width
    enc = torch.rand((96, 4, 128), generator=torch.Generator().manual_seed(4)).to(torch.bfloat16)
    audio, outp, state = fk.generate(kw, enc, 9, greedy=greedy, collect_out_params=True,
                                     return_state=True)
    assert state[0].dtype == torch.int8 and state[1].shape == (3, 4) and state[2] == 96
    if WANT_MODE[name][0] == "row":
        # a ring row is W payload bytes, its exponent code in lane W, and zeros behind it
        assert state[0].shape[-1] == W + fk.ROW_LANES
        assert not state[0][..., W + 1 :].any() and state[0][..., W].any()
        assert int(state[0][..., W].min()) >= fk.LOG8_MIN
    else:
        assert state[0].shape[-1] == W
    if not greedy:
        assert audio.std() > 0
    # 32 of 96, and a ragged split with chunks shorter than the largest 2d (4 at 2 stages)
    for splits in ((32, 32, 32), (3, 50, 1, 42)):
        a, o, st = _chained(kw, enc, 9, splits, greedy=greedy)
        assert torch.equal(a, audio) and torch.equal(o, outp)
        assert torch.equal(st[0], state[0]) and torch.equal(st[1], state[1])


def test_fresh_state_is_zeros_in_every_mode():
    jmodel, _, _ = _small("mol", False, False, B=2)
    cfg = tconfig.wavenet_config_from_dict(dict(jmodel.cfg.__dict__))
    slots = sum(2 * d for d in fk.dilations(cfg))
    for act, dtype, lrow in (("bf16", torch.bfloat16, cfg.width), ("static", torch.int8, cfg.width),
                             ("row", torch.int8, cfg.width + fk.ROW_LANES)):
        lbuf, xh, t0 = fk.init_state(cfg, 3, "cpu", act)
        assert lbuf.shape == (slots, 3, lrow) and lbuf.dtype == dtype and not lbuf.any()
        assert xh.shape == (3, 3) and not xh.any() and t0 == 0


def test_streamed_plain_row_mode_tracks_jax_streaming_kernel():
    """The JAX kernel built with streaming=True in its default W8A8 mode (per-row
    scales) and chained over chunks of 32 against the port's chained calls,
    teacher-forced and greedy.  The carried ring is the same object on both
    sides: the JAX row repeats its exponent code over a 128-lane block behind
    the payload, the port's keeps it in lane W."""
    jmodel, jparams, wav = _small("mol", False, False)
    cfg, B, L, chunk = jmodel.cfg, wav.shape[0], 96, 32
    mel, jkw, jopts, model, _, kw, _ = _setup(jmodel, jparams, wav, "row")
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
    jl, jxh, jt0 = state
    assert int(jt0) == tstate[2] == L
    np.testing.assert_allclose(tstate[1].numpy(), np.asarray(jxh)[:3], atol=1e-6, rtol=0)
    W = cfg.width
    jl, tl = np.asarray(jl).astype(np.int32), tstate[0].numpy().astype(np.int32)
    assert (jl[..., W:] == jl[..., W : W + 1]).all()  # the JAX code block is one value
    codes = tl[..., W] != jl[..., W]
    ring = np.abs(tl[..., :W] - jl[..., :W])[~codes]
    print(f"streamed row mode vs JAX: {int(codes.sum())} of {codes.size} exponent codes differ; "
          f"payload max|d| {ring.max()} LSB, {(ring > 0).mean():.2e} of entries")
    assert codes.mean() < 0.01 and ring.max() <= 1 and (ring > 0).mean() < 0.01


def test_generate_cuda_row_mode_chunked_equals_one_shot():
    jmodel, jparams, wav = _small("mol", False, False, B=4)
    model, params = _port(jmodel, jparams)
    fg = Fastgen(model)
    mel = torch.from_numpy(tstft.melspectrogram_np(wav))
    for opts in (dict(weight_dtype="int8"), dict(weight_dtype="int8", rs_dtype="bf16"),
                 dict(weight_dtype="int8", int8_combine="bf16")):
        for greedy in (True, False):
            full = fg.generate_cuda(params, mel, 3, length=96, greedy=greedy, **opts)
            assert full.shape == (4, 96) and torch.isfinite(full).all()
            got = fg.generate_cuda(params, mel, 3, length=96, greedy=greedy, chunk=40, **opts)
            assert torch.equal(got, full)  # 40 does not divide 96: the last chunk runs at 16
    # the combine's type is part of the arithmetic: the two sampled runs differ
    assert not torch.equal(full, fg.generate_cuda(params, mel, 3, length=96, weight_dtype="int8"))
    with pytest.raises(ValueError, match="int8_combine"):
        fg.generate_cuda(params, mel, 3, length=8, weight_dtype="int8", int8_combine="f16")


def test_eval_path_row_mode_writes_finite_wavs_from_wav_and_mel_sources(tmp_path):
    """The slice as a whole on the CPU: sources -> int8 packing with nothing
    calibrated -> plain per-row W8A8 calls -> gen_*.wav; mel-only .npy sources
    serve as well as wavs, one-shot and streamed."""
    src = _golden_src(tmp_path, 1000)
    d = golden_dir("mol")
    args = (os.path.join(d, "params.npz"), os.path.join(d, "meta.json"))
    paths = generate_wavenet(str(src), *args, str(tmp_path / "gen"), device="cpu",
                             sample_length=400, int8=True, streaming_chunk=250)
    assert [os.path.basename(p) for p in paths] == ["gen_utt_0.wav", "gen_utt_1.wav"]
    # the mel files hold the rows of the very batch the wav-source run made: a
    # mel computed from a batch of another shape sums in another order, and
    # the per-row log8 step function turns its last-bit differences into
    # flips that cascade through the run
    mels = tmp_path / "mels"
    mels.mkdir()
    batch = load_mel_batch(discover_files(str(src)), 400)
    for i, row in enumerate(batch):
        np.save(str(mels / f"utt_{i}.npy"), row)
    mel_paths = generate_wavenet(str(mels), *args, str(tmp_path / "gen_mel"), device="cpu",
                                 int8=True)
    assert [os.path.basename(p) for p in mel_paths] == ["gen_utt_0.wav", "gen_utt_1.wav"]
    for p in paths + mel_paths:
        out, sr = wav_io.read_wav(p)
        assert sr == 16000 and out.shape == (600,)
        assert np.isfinite(out).all() and np.abs(out).max() > 0
    # the same conditioning and seed through the mel files: the one-shot call
    # equals the streamed one
    for streamed, one_shot in zip(paths, mel_paths):
        np.testing.assert_array_equal(wav_io.read_wav(streamed)[0], wav_io.read_wav(one_shot)[0])


def test_golden_freerun_row_mode_tracks_conditioning():
    """Sampled free run of the plain per-row W8A8 version on the trained MoL
    golden, nothing calibrated: it must follow its own mel more than the other
    utterance's, as the bf16 and the static free runs do."""
    n = 4000
    wavs = np.stack([wav_io.read_wav(os.path.join(GOLDEN, f"gen_golden_mol_{i}.wav"),
                                     expect_sr=16000)[0][:n] for i in (0, 1)])
    mels = tstft.melspectrogram_np(wavs)
    d = golden_dir("mol")
    model = Wavenet(tconfig.load_config(os.path.join(d, "meta.json")))
    params = weights.load_npz(os.path.join(d, "params.npz"), device="cpu")
    audio = Fastgen(model).generate_cuda(params, torch.from_numpy(mels), seed=7, length=n,
                                         weight_dtype="int8").numpy()
    assert audio.shape == (2, n) and np.isfinite(audio).all() and np.abs(audio).max() <= 1.0
    matched, mismatched = _mel_corr(audio, mels, n)
    assert matched > mismatched + 0.05, (matched, mismatched)
