"""The flow kernel's modes beyond the shipped one, on the CPU: the port's plain
version against the Pallas kernel in interpret mode (non-compact at several
widths, fuse_cond, the precomputed-conditioning stream, bf16 carries, the
unfused taps and the grid and layout options), and the student serving path
with layers_per_call and fuse_cond, and an f32 student streamed, against the
JAX package."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nsynth_wavenet_tpu.models import parallelgen as jparallelgen
from nsynth_wavenet_tpu.ops import flow_kernel as jfk
from nsynth_wavenet_tpu_torch.models import parallelgen
from nsynth_wavenet_tpu_torch.ops import flow_kernel as tfk
from test_torch_parallel_wavenet import assert_ff_close, mel_batch, student_pair

# the same roundings as the Pallas kernel in another summation order, as
# tests/test_torch_flow_kernel.py holds the shipped mode
REL_TOL = 5e-3
# non-compact: only the bf16 tap and res products round; the JAX package's own
# non-compact limit (tests/test_flow_kernel.py, enc mode against stream mode)
F32_ATOL = 1e-4
SW_KEYS = ("w_tap", "b", "w_cond", "b_cond", "w_res", "b_res")


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Layer loops of small products: one thread runs them as fast as many and
    keeps this file's worker off the other workers' cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _strict(fn, *args):
    """fn(*args) compiled without XLA's excess precision, so that every bf16
    rounding the Pallas kernel writes (the gate's, the taps') is made, as the
    port makes it (see tests/test_torch_fastgen_w8a8.py::_strict)."""
    return jax.jit(fn).lower(*args).compile(
        compiler_options={"xla_allow_excess_precision": False})(*args)


def _inputs(n_layers, L, B, W, DW, seed):
    """O(1) streams and N(0, 0.1)-scale weights, f32 numpy."""
    rng = np.random.RandomState(seed)
    f = lambda *shape, scale: (rng.randn(*shape) * scale).astype(np.float32)
    return {
        "x": f(L, B, W, scale=0.5), "enc": f(L, B, DW, scale=0.5),
        "cond": f(L, B, n_layers * W, scale=0.5),
        "w_tap": f(n_layers, 3, W, W, scale=0.3 / np.sqrt(W)), "b": f(n_layers, W, scale=0.05),
        "w_cond": f(n_layers, DW, W, scale=0.3 / np.sqrt(DW)), "b_cond": f(n_layers, W, scale=0.05),
        "w_res": f(n_layers, W // 2, W, scale=0.3 / np.sqrt(W)), "b_res": f(n_layers, W, scale=0.05),
    }


def _sw(d):
    return {k: torch.from_numpy(d[k]) for k in SW_KEYS}


def _jax_enc_fn(d, n_layers, num_stages, L, B, W, DW, tile, compact, **opts):
    """The Pallas kernel in enc mode, time-major, on d's inputs."""
    fn = jfk.make_flow_stack_fn(n_layers, num_stages, W, B, L, tile=tile, interpret=True,
                                compact=compact, cond_features=DW, time_major=True,
                                fuse_taps=opts.pop("fuse_taps", True), **opts)
    enc = jnp.asarray(d["enc"]).astype(jnp.bfloat16 if compact else jnp.float32)
    return lambda *extra: fn(jnp.asarray(d["x"]), enc, d["w_tap"], d["b"] + d["b_cond"],
                             d["w_res"], d["b_res"], d["w_cond"], *extra)


def _enc(d, compact):
    enc = torch.from_numpy(d["enc"])
    return enc.to(torch.bfloat16) if compact else enc


def _scale_close(got, want):
    want = np.asarray(want)
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, atol=REL_TOL * max(np.abs(want).max(), 1.0), rtol=0)


@pytest.mark.parametrize("W,num_stages,DW", [(8, 2, 16), (32, 3, 24), (128, 2, 40),
                                             (256, 2, 40)])
def test_noncompact_plain_matches_pallas(W, num_stages, DW):
    """f32 encoding and w_cond, the cond product in f32: the f32 student's mode."""
    n_layers, L, B = 3, 64, 2
    d = _inputs(n_layers, L, B, W, DW, seed=W)
    want = np.asarray(_strict(_jax_enc_fn(d, n_layers, num_stages, L, B, W, DW, 16, False)))
    got = tfk.flow_stack(torch.from_numpy(d["x"]), _enc(d, False), _sw(d), 0, n_layers,
                         num_stages, compact=False).numpy()
    assert np.isfinite(got).all() and np.abs(want).max() < 4.0
    print(f"non-compact W={W}: max|d| {np.abs(got - want).max():.3e}")
    np.testing.assert_allclose(got, want, atol=F32_ATOL, rtol=0)
    assert np.abs(want - d["x"]).max() > 0.1  # a match that is not trivial
    # the weights the card reads (w_tap, w_res bf16; w_cond f32) give the same numbers
    nw = tfk.noncompact_weights(_sw(d))
    assert nw["w_tap"].dtype == torch.bfloat16 and nw["w_cond"].dtype == torch.float32
    assert np.array_equal(tfk.flow_stack(torch.from_numpy(d["x"]), _enc(d, False), nw, 0,
                                         n_layers, num_stages, compact=False).numpy(), got)


@pytest.mark.parametrize("compact", [False, True])
def test_fuse_cond_plain_matches_pallas(compact):
    """One K = 3W + DW bf16 product: the encoding and w_cond rounded to bf16
    whatever compact is."""
    n_layers, num_stages, L, B, W, DW = 3, 2, 64, 3, 32, 48
    d = _inputs(n_layers, L, B, W, DW, seed=11)
    want = _strict(_jax_enc_fn(d, n_layers, num_stages, L, B, W, DW, 32, compact, fuse_cond=True))
    got = tfk.flow_stack(torch.from_numpy(d["x"]), _enc(d, compact), _sw(d), 0, n_layers,
                         num_stages, compact=compact, fuse_cond=True)
    _scale_close(got.numpy(), want)
    # a bf16 encoding gives the same numbers: fuse_cond rounds it anyway
    again = tfk.flow_stack(torch.from_numpy(d["x"]), _enc(d, True), _sw(d), 0, n_layers,
                           num_stages, compact=compact, fuse_cond=True)
    assert torch.equal(again, got)


@pytest.mark.parametrize("compact", [False, True])
@pytest.mark.parametrize("W", [64, 16])
def test_cond_stream_plain_matches_pallas(compact, W):
    """The precomputed-conditioning stream [L, B, n_layers * W] (the
    reference's cond_features=0), bias b alone: its b_cond is in the stream."""
    n_layers, num_stages, L, B = 3, 3, 48, 2
    d = _inputs(n_layers, L, B, W, 16, seed=W + compact)
    fn = jfk.make_flow_stack_fn(n_layers, num_stages, W, B, L, tile=16, interpret=True,
                                compact=compact)
    # the JAX wrapper's batch-major [B, L, NL*W] stream is the port's time-major one transposed
    want = np.asarray(_strict(lambda: fn(jnp.asarray(d["x"].transpose(1, 0, 2)),
                                         jnp.asarray(d["cond"].transpose(1, 0, 2)), d["w_tap"],
                                         d["b"], d["w_res"], d["b_res"])))
    cond = torch.from_numpy(d["cond"])
    got = tfk.flow_stack(torch.from_numpy(d["x"]), None, _sw(d), 0, n_layers, num_stages,
                         compact=compact, cond=cond.to(torch.bfloat16) if compact else cond)
    _scale_close(got.numpy().transpose(1, 0, 2), want)
    # the stream mode equals the enc mode fed the projection the enc mode computes
    enc = torch.from_numpy(d["enc"])
    sw = _sw(d)
    proj = torch.cat([enc @ sw["w_cond"][i] + sw["b_cond"][i] for i in range(n_layers)], -1)
    via_stream = tfk.flow_stack(torch.from_numpy(d["x"]), None, sw, 0, n_layers, num_stages,
                                compact=False, cond=proj)
    via_enc = tfk.flow_stack(torch.from_numpy(d["x"]), enc, sw, 0, n_layers, num_stages,
                             compact=False)
    np.testing.assert_allclose(via_stream.numpy(), via_enc.numpy(), atol=F32_ATOL, rtol=0)


@pytest.mark.parametrize("chunk", [16, 6])  # 6 is shorter than the largest 2d = 8
def test_bf16_carries_stream_like_pallas(chunk):
    """carry_dtype=bf16: chained chunks give the f32-carry output bit for bit
    (every tap is rounded to bf16 at its product), and the exported state is
    JAX's: the layer inputs' tails rounded to bf16, held in f32."""
    n_layers, num_stages, L, B, W, DW = 4, 3, 48, 2, 32, 16
    d = _inputs(n_layers, L, B, W, DW, seed=21)
    sw, x, enc = _sw(d), torch.from_numpy(d["x"]), _enc(d, False)
    rows = tfk.state_rows(0, n_layers, num_stages)
    want_out = tfk.flow_stack(x, enc, sw, 0, n_layers, num_stages, compact=False)
    fn = jfk.make_flow_stack_fn(n_layers, num_stages, W, B, chunk, tile=8 if chunk % 8 == 0 else chunk,
                                interpret=True, cond_features=DW, time_major=True, fuse_taps=True,
                                streaming=True, carry_dtype=jnp.bfloat16)
    call = lambda xc, ec, st: fn(xc, ec, d["w_tap"], d["b"] + d["b_cond"], d["w_res"], d["b_res"],
                                 d["w_cond"], st)
    state = torch.zeros((rows, B, W))
    jstate = jnp.zeros((rows, B, W), jnp.float32)
    jcall = jax.jit(call).lower(d["x"][:chunk], d["enc"][:chunk], jstate).compile(
        compiler_options={"xla_allow_excess_precision": False})  # see _strict
    outs = []
    for c0 in range(0, L, chunk):
        sl = slice(c0, c0 + chunk)
        o, state = tfk.flow_stack(x[sl], enc[sl], sw, 0, n_layers, num_stages, state,
                                  compact=False, carry_dtype=torch.bfloat16)
        outs.append(o)
        _, jstate = jcall(d["x"][sl], d["enc"][sl], jstate)
        jst = np.asarray(jstate)
        assert state.dtype == torch.float32 and torch.equal(state, state.to(torch.bfloat16).float())
        np.testing.assert_array_equal(state[:2].numpy(), jst[:2])  # layer 0: the input's tail
        _scale_close(state.numpy(), jst)
    assert torch.equal(torch.cat(outs, 0), want_out)
    # a bf16 state is read as bf16: the same output and state
    o16, s16 = tfk.flow_stack(x[:chunk], enc[:chunk], sw, 0, n_layers, num_stages,
                              state.to(torch.bfloat16), compact=False, carry_dtype=torch.bfloat16)
    o32, s32 = tfk.flow_stack(x[:chunk], enc[:chunk], sw, 0, n_layers, num_stages, state,
                              compact=False, carry_dtype=torch.bfloat16)
    assert torch.equal(o16, o32) and torch.equal(s16, s32)


@pytest.mark.parametrize("option", ["fuse_taps_false", "time_major_false", "b_tile"])
@pytest.mark.parametrize("compact", [False, True])
def test_grid_and_layout_options_compute_the_same_function(option, compact):
    """fuse_taps=False (three K = W products summed), time_major=False (a
    transpose around the call) and b_tile (a TPU grid parameter) need no
    kernel of their own: the port's fused time-major plain version matches."""
    n_layers, num_stages, L, B, W, DW = 3, 3, 64, 4, 32, 32
    d = _inputs(n_layers, L, B, W, DW, seed=31)
    enc_dt = jnp.bfloat16 if compact else jnp.float32
    opts = dict(tile=16, interpret=True, compact=compact, cond_features=DW)
    if option == "fuse_taps_false":
        fn = jfk.make_flow_stack_fn(n_layers, num_stages, W, B, L, time_major=True, **opts)
        args = (jnp.asarray(d["x"]), jnp.asarray(d["enc"]).astype(enc_dt))
    else:
        fn = jfk.make_flow_stack_fn(n_layers, num_stages, W, B, L, fuse_taps=True,
                                    b_tile=2 if option == "b_tile" else 0, **opts)
        args = (jnp.asarray(d["x"].transpose(1, 0, 2)),
                jnp.asarray(d["enc"].transpose(1, 0, 2)).astype(enc_dt))
    want = np.asarray(_strict(lambda: fn(*args, d["w_tap"], d["b"] + d["b_cond"], d["w_res"],
                                         d["b_res"], d["w_cond"])))
    if option != "fuse_taps_false":
        want = want.transpose(1, 0, 2)
    got = tfk.flow_stack(torch.from_numpy(d["x"]), _enc(d, compact), _sw(d), 0, n_layers,
                         num_stages, compact=compact)
    _scale_close(got.numpy(), want)


@pytest.mark.parametrize("compute_dtype,layers_per_call,fuse_cond", [
    ("float32", 4, False),
    ("float32", 0, True),
    ("float32", 4, True),
    ("bfloat16", 4, False),
    ("bfloat16", 0, True),
])
def test_feed_forward_cuda_options_match_pallas(compute_dtype, layers_per_call, fuse_cond):
    """feed_forward_cuda(layers_per_call=, fuse_cond=) against
    feed_forward_pallas with the same options (flows of 2 and 4 layers,
    num_stages 2, width 8); layers_per_call is the default's arithmetic in
    fewer calls, so it equals the default bit for bit."""
    jpwn, jparams, pwn, tparams = student_pair(compute_dtype=compute_dtype)
    mel = mel_batch()
    x = np.random.RandomState(2).randn(mel.shape[0], pwn.sample_length(mel.shape[1]))
    x = x.astype(np.float32)
    opts = dict(layers_per_call=layers_per_call, fuse_cond=fuse_cond)
    want = jparallelgen.feed_forward_pallas(jpwn, jparams, {"mel": mel, "base_x": x}, b_tile=2,
                                            interpret=True, **opts)
    inputs = {"mel": torch.from_numpy(mel), "base_x": torch.from_numpy(x)}
    got = parallelgen.feed_forward_cuda(pwn, tparams, inputs, **opts)
    assert_ff_close(got, want, 3e-4 if compute_dtype == "float32" else 2e-2)
    if layers_per_call:
        default = parallelgen.feed_forward_cuda(pwn, tparams, inputs, fuse_cond=fuse_cond)
        for k in got:
            assert torch.equal(got[k], default[k]), k


def test_layers_per_call_must_cover_whole_cycles():
    _, _, pwn, tparams = student_pair()
    with pytest.raises(ValueError, match="multiple of num_stages"):
        parallelgen.feed_forward_cuda(pwn, tparams, {"mel": torch.from_numpy(mel_batch())},
                                      torch.Generator().manual_seed(0), layers_per_call=3)


@pytest.mark.parametrize("chunk", [300, 1024])
def test_f32_streamer_chunks_equal_oneshot(chunk):
    """An f32 student streamed in chunks (the f32-conditioning mode with
    carried state) gives the one-shot audio on the same noise."""
    _, _, pwn, tparams = student_pair(compute_dtype="float32", use_share_deconv=False)
    mel = torch.from_numpy(mel_batch())
    L = pwn.sample_length(mel.shape[1])
    bx = torch.from_numpy(np.random.RandomState(4).randn(mel.shape[0], L).astype(np.float32))
    one = pwn._clip_quant_scale(
        parallelgen.feed_forward_cuda(pwn, tparams, {"mel": mel, "base_x": bx})["x"])
    got = parallelgen.StudentStreamer(pwn, chunk=chunk).synthesize(tparams, mel, base_x=bx)
    assert got.shape == one.shape and L % chunk != 0
    bins = ((got - one).abs() * pwn.cfg.quant_chann / 2).round()
    print(f"f32 streamer chunk {chunk}: max|d| {float((got - one).abs().max()):.3e}")
    assert float(bins.max()) <= 1  # at most one quantisation bin, where a value sits on an edge
    assert float((bins > 0).float().mean()) < 1e-3


def test_serving_paths_run_with_tf32_off(monkeypatch):
    """feed_forward_cuda and StudentStreamer turn TF32 off themselves (an f32
    model's deconv and heads are f32 for a direct caller too) and restore the
    caller's settings after."""
    _, _, pwn, tparams = student_pair(compute_dtype="float32")
    seen = []

    def recording(*args, **kw):
        seen.append((torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32))
        return tfk.flow_stack_plain(*args, **kw)

    monkeypatch.setattr(tfk, "flow_stack", recording)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    mel = torch.from_numpy(mel_batch())
    parallelgen.synthesize_cuda(pwn, tparams, mel, torch.Generator().manual_seed(0))
    parallelgen.StudentStreamer(pwn, chunk=512).synthesize(tparams, mel,
                                                           torch.Generator().manual_seed(0))
    assert seen and set(seen) == {(False, False)}
    assert torch.backends.cudnn.allow_tf32 and torch.backends.cuda.matmul.allow_tf32
