"""The port's perf probes against the JAX package's, on the CPU.

The AR kernel's probes (fastgen_kernel.generate(probe="cheap_gate" |
"no_ring_write")) are held against make_generate_fn(probe=...) in interpret
mode on the golden tiny_mol, teacher-forced and greedy, in the bf16, W8A8
static and W8A8 per-row modes, at the limits of the full modes' harnesses.
The flow kernel's no_gate (flow_stack(probe="no_gate")) is held against
make_flow_stack_fn(probe="no_gate"), one-shot and streaming.  The port's
no_slide has no twin of the same meaning in the reference (it drops the two
dilated tap loads and multiplies l(t) into all three tap bands): it is held
against the reference's FULL kernel with the taps folded, w_tap[:, 0] =
w_tap[:, 1] = 0 and w_tap[:, 2] = the sum of the three bands, which is the
same function.  Every probe must refuse to run without allow_wrong_output,
and must change the output.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nsynth_wavenet_tpu.ops import fastgen_kernel as jfk
from nsynth_wavenet_tpu.ops import flow_kernel as jflk
from nsynth_wavenet_tpu.ops import stft as jstft
from nsynth_wavenet_tpu_torch.ops import fastgen_kernel as fk
from nsynth_wavenet_tpu_torch.ops import flow_kernel as flk
from test_torch_fastgen import _golden_inputs, _port
from test_torch_fastgen_w8a8 import _strict, _w8a8_setup
from test_torch_fastgen_w8a8_row import _setup as _row_setup
from test_torch_flow_kernel import W, _close, _inputs, _torch_sw

# head outputs within this share of max(|JAX|, 1): the limits of the full
# modes' own harnesses (test_torch_fastgen.py, test_torch_fastgen_w8a8.py,
# test_torch_fastgen_w8a8_row.py), which the probes meet as they stand
AR_LIMITS = {"bf16": 5e-3, "static": 1e-3, "row": 2e-3}
AR_STEPS = 16


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The step loops are thousands of tiny ops: one thread runs them as fast
    as many, and leaves the cores to the other test workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# ---------------------------------------------------------------------------
# the AR kernel: cheap_gate, no_ring_write
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _ar_setup(mode):
    """The golden tiny_mol packed in ``mode`` on both sides: (JAX model,
    params, wav, JAX weights, make_generate_fn options, port weights, port
    model), made once a mode (copy the JAX weights before changing them)."""
    jmodel, jparams, wav = _golden_inputs("mol")
    if mode == "bf16":
        model, params = _port(jmodel, jparams)
        return (jmodel, jparams, wav, jfk.build_kernel_weights(jmodel.cfg, jparams), {},
                fk.build_kernel_weights(model.cfg, params), model)
    if mode == "static":
        _, jkw, model, _, kw = _w8a8_setup(jmodel, jparams, wav)
        return (jmodel, jparams, wav, jkw,
                dict(weight_dtype=jnp.int8, act_scale="static", gate_scale="static"), kw, model)
    _, jkw, jopts, model, _, kw, _ = _row_setup(jmodel, jparams, wav, "row")
    return jmodel, jparams, wav, jkw, jopts, kw, model


def _enc_tf(jmodel, jparams, wav, L):
    mel = jstft.melspectrogram_np(wav)
    enc, _ = jmodel.deconv_stack(jparams, jnp.asarray(mel))
    off = (enc.shape[1] - wav.shape[1]) // 2
    return jnp.transpose(enc, (1, 0, 2))[off : off + L], np.ascontiguousarray(wav[:, :L].T)


@pytest.mark.parametrize("probe", fk.PROBES)
@pytest.mark.parametrize("mode", list(AR_LIMITS))
def test_ar_probe_plain_matches_jax_probe(mode, probe):
    """generate_plain(probe=) against make_generate_fn(probe=) in interpret
    mode (compiled without XLA's excess precision, see _strict),
    teacher-forced + greedy, and the probe's output against the full call's."""
    jmodel, jparams, wav, jkw, jopts, kw, model = _ar_setup(mode)
    cfg, B, L = jmodel.cfg, wav.shape[0], AR_STEPS
    enc_t, tf = _enc_tf(jmodel, jparams, wav, L)
    jkw = dict(jkw)
    jseg = jkw.pop("out_pad_seg")
    jkw.pop("out_pad")
    gen = jfk.make_generate_fn(cfg, B, L, teacher_forced=True, collect_out_params=True, greedy=True,
                               interpret=True, probe=probe, **jopts)
    _, want = (np.asarray(a) for a in _strict(gen, jkw, enc_t, 123, tf=jnp.asarray(tf)))
    want = np.concatenate([want[..., s * jseg : s * jseg + cfg.mol_mix] for s in range(3)], -1)

    enc_bf = torch.from_numpy(np.array(enc_t.astype(jnp.float32))).to(torch.bfloat16)
    run = dict(greedy=True, tf=torch.from_numpy(tf), collect_out_params=True)
    audio, outp = fk.generate(kw, enc_bf, 123, probe=probe, allow_wrong_output=True, **run)
    got = fk.unpack_head(model.cfg, outp).numpy()
    assert audio.shape == (B, L) and got.shape == want.shape and np.isfinite(got).all()
    scale = max(np.abs(want).max(), 1.0)
    limit = AR_LIMITS[mode] * scale
    _, full = fk.generate(kw, enc_bf, 123, **run)
    moved = np.abs(fk.unpack_head(model.cfg, full).numpy() - got).max()
    print(f"{mode} {probe}: plain vs JAX max|d| {np.abs(got - want).max():.3e}, limit "
          f"{limit:.3e}; the full call parts from it by {moved:.3e}")
    np.testing.assert_allclose(got, want, atol=limit, rtol=0)
    assert moved > limit  # not a silent no-op: it parts from the full call beyond the limit


def _random_ring(cfg, B, act, seed):
    """A carried ring that is not zeros, in the mode's ring layout (per-row:
    payloads, then a log8 code in lane W and zeros behind it)."""
    shape, dtype = fk.ring_layout(cfg, B, act)
    g = torch.Generator().manual_seed(seed)
    if dtype == torch.bfloat16:
        return (0.3 * torch.randn(shape, generator=g)).to(dtype)
    ring = torch.randint(-127, 128, shape, generator=g, dtype=torch.int8)
    if act == "row":
        ring[..., cfg.width + 1 :] = 0
        ring[..., cfg.width] = torch.randint(-24, 4, shape[:2], generator=g, dtype=torch.int8)
    return ring


@pytest.mark.parametrize("mode", list(AR_LIMITS))
def test_no_ring_write_returns_the_ring_it_was_given(mode):
    """With a carried state, no_ring_write hands the ring back as it came in,
    bit for bit, while the taps and the step advance as in the full call,
    which does write the ring."""
    jmodel, jparams, wav, _, _, kw, model = _ar_setup(mode)
    cfg, B, L, t0 = model.cfg, wav.shape[0], 16, 40
    enc_t, tf = _enc_tf(jmodel, jparams, wav, L)
    enc_bf = torch.from_numpy(np.array(enc_t.astype(jnp.float32))).to(torch.bfloat16)
    tf = torch.from_numpy(tf)
    ring = _random_ring(cfg, B, fk.kernel_mode(kw).act, seed=3)
    xh = 0.1 * torch.randn((3, B), generator=torch.Generator().manual_seed(4))
    state = (ring.clone(), xh.clone(), t0)
    _, outp, (lbuf, xh1, t1) = fk.generate(kw, enc_bf, 5, greedy=True, tf=tf, collect_out_params=True,
                                           state=state, return_state=True, probe="no_ring_write",
                                           allow_wrong_output=True)
    assert lbuf is state[0] and torch.equal(lbuf, ring)
    assert t1 == t0 + L and torch.equal(xh1, tf[-3:])
    _, full, (lbuf_full, xh_full, _) = fk.generate(kw, enc_bf, 5, greedy=True, tf=tf,
                                                   collect_out_params=True,
                                                   state=(ring.clone(), xh.clone(), t0),
                                                   return_state=True)
    assert not torch.equal(lbuf_full, ring) and torch.equal(xh_full, xh1)
    assert (full - outp).abs().max() > 1e-2  # the carried ring is read: the taps differ


# ---------------------------------------------------------------------------
# the flow kernel: no_gate, no_slide
# ---------------------------------------------------------------------------


def _jax_flow(d, n_layers, num_stages, L, B, DW, tile, compact, state=None, probe=None):
    fn = jflk.make_flow_stack_fn(n_layers, num_stages, W, B, L, tile=tile, interpret=True,
                                 compact=compact, cond_features=DW, time_major=True,
                                 fuse_taps=True, streaming=state is not None, probe=probe,
                                 allow_wrong_output=probe is not None)
    enc = jnp.asarray(d["enc"]).astype(jnp.bfloat16 if compact else jnp.float32)
    extra = () if state is None else (state,)
    return fn(jnp.asarray(d["x"]), enc, d["w_tap"], d["b"] + d["b_cond"], d["w_res"], d["b_res"],
              d["w_cond"], *extra)


def _port_flow(d, n_layers, num_stages, compact, **kw):
    enc = torch.from_numpy(d["enc"])
    return flk.flow_stack(torch.from_numpy(d["x"]), enc.to(torch.bfloat16) if compact else enc,
                          _torch_sw(d), 0, n_layers, num_stages, compact=compact, **kw)


def _folded(d):
    """d with the three tap bands summed into the t band: the reference's
    full kernel then computes the port's no_slide."""
    w = d["w_tap"]
    fold = np.zeros_like(w)
    fold[:, 2] = w.sum(1)
    return dict(d, w_tap=fold)


def _exact_taps(d, seed):
    """d with every tap weight a multiple of 2^-8 of at most 40 of them, so
    that each band and the sum of the three bands are exact in bf16: the fold
    then rounds nothing."""
    rng = np.random.RandomState(seed)
    return dict(d, w_tap=(rng.randint(-40, 41, d["w_tap"].shape) / 256.0).astype(np.float32))


FLOW_CASE = (4, 2, 64, 256, 4, 64)  # n_layers, num_stages, tile, L, B, DW: dilations 1, 2, 1, 2


@pytest.mark.parametrize("compact", [False, True])
def test_no_gate_plain_matches_jax_probe(compact):
    n_layers, num_stages, tile, L, B, DW = FLOW_CASE
    d = _inputs(n_layers, L, B, DW, seed=0)
    want = _jax_flow(d, n_layers, num_stages, L, B, DW, tile, compact, probe="no_gate")
    got = _port_flow(d, n_layers, num_stages, compact, probe="no_gate", allow_wrong_output=True)
    full = _port_flow(d, n_layers, num_stages, compact)
    moved = float((got - full).abs().max())
    print(f"no_gate compact={compact}: plain vs JAX max|d| "
          f"{np.abs(got.numpy() - np.asarray(want)).max():.3e}; the full call parts by {moved:.3e}")
    _close(got.numpy(), want)
    assert moved > 0.1  # not a silent no-op


@pytest.mark.parametrize("fold", ["exact", "rounded"])
@pytest.mark.parametrize("compact", [False, True])
def test_no_slide_plain_matches_jax_full_kernel_with_folded_taps(compact, fold):
    """The port's no_slide against the reference's full kernel on folded taps.
    "exact": the tap weights are chosen so that the fold rounds nothing, and
    the two differ by their f32 summation order alone, which moves a bf16
    rounding of g or of the next layer's taps now and then (readings
    1.7e-4 and 7.6e-4 of scale, f32 and bf16 conditioning); "rounded":
    Gaussian weights, whose summed band the reference rounds to bf16 once
    more than the port's three bands (readings 2.8e-3 and 2.4e-3).  Both at
    the flow kernel's limit, 5e-3 of scale."""
    n_layers, num_stages, tile, L, B, DW = FLOW_CASE
    d = _inputs(n_layers, L, B, DW, seed=1)
    if fold == "exact":
        d = _exact_taps(d, seed=2)
    want = _jax_flow(_folded(d), n_layers, num_stages, L, B, DW, tile, compact)
    got = _port_flow(d, n_layers, num_stages, compact, probe="no_slide", allow_wrong_output=True)
    full = _port_flow(d, n_layers, num_stages, compact)
    moved = float((got - full).abs().max())
    err = np.abs(got.numpy() - np.asarray(want)).max() / max(np.abs(np.asarray(want)).max(), 1.0)
    print(f"no_slide compact={compact} fold {fold}: plain vs JAX folded {err:.3e} of scale; "
          f"the full call parts by {moved:.3e}")
    _close(got.numpy(), want)
    assert moved > 0.1  # not a silent no-op


@pytest.mark.parametrize("probe", flk.PROBES)
def test_flow_probe_streaming(probe):
    """Chained chunks with a state (chunks of 8 and 20 are shorter than
    2d = 32): equal to the one-shot probe call bit for bit, and every chunk's
    output and state against the reference's streaming kernel (no_gate: its
    probe; no_slide: its full kernel on folded taps).  The state a probe call
    returns is the full call's rule: the last 2d rows of each layer's input."""
    n_layers, num_stages, L, B, DW = 5, 5, 96, 3, 128
    d = _exact_taps(_inputs(n_layers, L, B, DW, seed=3), seed=4)
    ref = (d, "no_gate") if probe == "no_gate" else (_folded(d), None)
    sw, opts = _torch_sw(d), dict(probe=probe, allow_wrong_output=True)
    x, enc = torch.from_numpy(d["x"]), torch.from_numpy(d["enc"]).to(torch.bfloat16)
    oneshot = flk.flow_stack(x, enc, sw, 0, n_layers, num_stages, **opts)
    rows = flk.state_rows(0, n_layers, num_stages)
    for chunk in (32, 8, 20):
        state, jstate, outs = torch.zeros((rows, B, W)), jnp.zeros((rows, B, W), jnp.float32), []
        for c0 in range(0, L, chunk):
            sl = slice(c0, min(c0 + chunk, L))
            o, state = flk.flow_stack(x[sl], enc[sl], sw, 0, n_layers, num_stages, state=state,
                                      **opts)
            outs.append(o)
            if chunk == 32:
                dc = dict(ref[0], x=d["x"][sl], enc=d["enc"][sl])
                jo, jstate = _jax_flow(dc, n_layers, num_stages, chunk, B, DW, 16, True,
                                       state=jstate, probe=ref[1])
                _close(o.numpy(), jo)
                _close(state.numpy(), jstate)
        assert torch.equal(torch.cat(outs, 0), oneshot)
        assert torch.equal(state[:2], x[-2:])  # layer 0's history is the tail of its input


# ---------------------------------------------------------------------------
# the refusals
# ---------------------------------------------------------------------------


def test_probe_refusals():
    jmodel, jparams, wav, _, _, kw, _ = _ar_setup("bf16")
    enc = torch.zeros((4, 2, jmodel.cfg.deconv_width), dtype=torch.bfloat16)
    for fn in (fk.generate, fk.generate_plain):
        with pytest.raises(ValueError, match="unknown probe"):
            fn(kw, enc, 0, probe="no_gate", allow_wrong_output=True)
        for probe in fk.PROBES:
            with pytest.raises(ValueError, match="WRONG output"):
                fn(kw, enc, 0, probe=probe)
    # on a device the wrapper does not run, the guard still speaks first
    with pytest.raises(ValueError, match="WRONG output"):
        fk.generate(kw, enc.to("meta"), 0, probe="cheap_gate")
    d = _inputs(1, 8, 2, 64, seed=0)
    x, e, sw = torch.from_numpy(d["x"]), torch.from_numpy(d["enc"]).to(torch.bfloat16), _torch_sw(d)
    for fn in (flk.flow_stack, flk.flow_stack_plain):
        for probe in ("cheap_gate", ""):
            with pytest.raises(ValueError, match="unknown probe"):
                fn(x, e, sw, 0, 1, 1, probe=probe, allow_wrong_output=True)
        for probe in flk.PROBES:
            with pytest.raises(ValueError, match="WRONG output"):
                fn(x, e, sw, 0, 1, 1, probe=probe)
    with pytest.raises(ValueError, match="WRONG output"):
        flk.flow_stack(x.to("meta"), e.to("meta"), sw, 0, 1, 1, probe="no_slide")
    # a probe's counts stay apart from the serving ones, untouched by the CPU
    assert set(fk.generate.launches_by_probe) == set(fk.PROBES)
    assert set(flk.flow_stack.launches_by_probe) == set(flk.PROBES)
