"""The port's flow-stack kernel module against the JAX package on the CPU:
stack_flow_weights, flow_stack_plain against the Pallas kernel in interpret
mode (one-shot and streaming), and the wrapper's checks."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nsynth_wavenet_tpu.ops import flow_kernel as jfk
from nsynth_wavenet_tpu_torch import weights
from nsynth_wavenet_tpu_torch.ops import flow_kernel as tfk

W = 64
# same roundings as the Pallas kernel, another summation order; the JAX
# package's own kernel tests allow 2e-2 to 3e-2 absolute
REL_TOL = 5e-3


def _inputs(n_layers, L, B, DW, seed):
    rng = np.random.RandomState(seed)
    f = lambda *shape, scale: (rng.randn(*shape) * scale).astype(np.float32)
    return {
        "x": f(L, B, W, scale=0.3), "enc": f(L, B, DW, scale=0.2),
        "w_tap": f(n_layers, 3, W, W, scale=0.1), "b": f(n_layers, W, scale=0.05),
        "w_cond": f(n_layers, DW, W, scale=0.05), "b_cond": f(n_layers, W, scale=0.05),
        "w_res": f(n_layers, W // 2, W, scale=0.1), "b_res": f(n_layers, W, scale=0.05),
    }


def _torch_sw(d):
    return {k: torch.from_numpy(d[k]) for k in ("w_tap", "b", "w_cond", "b_cond", "w_res", "b_res")}


def _jax_call(d, n_layers, num_stages, L, B, DW, tile, compact, state=None):
    fn = jfk.make_flow_stack_fn(n_layers, num_stages, W, B, L, tile=tile, interpret=True,
                                compact=compact, cond_features=DW, time_major=True,
                                fuse_taps=True, streaming=state is not None)
    enc = jnp.asarray(d["enc"]).astype(jnp.bfloat16 if compact else jnp.float32)
    extra = () if state is None else (state,)
    return fn(jnp.asarray(d["x"]), enc, d["w_tap"], d["b"] + d["b_cond"], d["w_res"], d["b_res"],
              d["w_cond"], *extra)


def _close(got, want):
    want = np.asarray(want)
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, atol=REL_TOL * max(np.abs(want).max(), 1.0), rtol=0)


@pytest.mark.parametrize("weight_norm", [False, True])
def test_stack_flow_weights_equals_jax(weight_norm):
    from nsynth_wavenet_tpu import config as jconfig
    from nsynth_wavenet_tpu.models.parallel_wavenet import ParallelWavenet

    cfg = jconfig.ParallelWavenetConfig(num_iaf_layers=(3,), num_stages=2, width=16,
                                        deconv_width=32, use_weight_norm=weight_norm)
    jparams = ParallelWavenet(cfg).init_params(jax.random.PRNGKey(0))
    flow = jax.tree_util.tree_map(np.asarray, jparams["flows"][0])
    if weight_norm:  # move g off the norm of v, so that resolving the norm matters
        for lp in flow["layers"]:
            for p in lp.values():
                p["g"] = p["g"] * 1.5
    want = jfk.stack_flow_weights(flow)
    got = tfk.stack_flow_weights(weights.from_jax_params(flow, device="cpu"))
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == torch.float32 and tuple(got[k].shape) == want[k].shape
        if weight_norm:  # v / |v| * g rounds at other places in the two frameworks
            np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=1e-6, atol=0,
                                       err_msg=k)
        else:
            np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]), err_msg=k)


@pytest.mark.parametrize("compact", [False, True])
@pytest.mark.parametrize("n_layers,num_stages,tile,L,B,DW", [
    (4, 2, 64, 256, 4, 64),     # dilations 1, 2, 1, 2 over several tiles
    (5, 5, 16, 96, 2, 128),     # dilation 16: 2d > tile
    (6, 3, 100, 100, 3, 64),    # odd batch, a length that no power of two divides, 2 cycles
])
def test_flow_stack_plain_matches_pallas(n_layers, num_stages, tile, L, B, DW, compact):
    d = _inputs(n_layers, L, B, DW, seed=0)
    want = _jax_call(d, n_layers, num_stages, L, B, DW, tile, compact)
    enc = torch.from_numpy(d["enc"])
    got = tfk.flow_stack(torch.from_numpy(d["x"]), enc.to(torch.bfloat16) if compact else enc,
                         _torch_sw(d), 0, n_layers, num_stages, compact=compact)
    _close(got.numpy(), want)
    assert np.abs(np.asarray(want) - d["x"]).max() > 0.1  # a match that is not trivial


def test_flow_stack_layer_offset_and_compact_weights():
    """Layers s .. s+n of a longer flow use the dilations of their own
    indices, and bf16-stored weights give the same numbers as f32 ones."""
    n_total, num_stages, L, B, DW = 5, 3, 64, 2, 64
    d = _inputs(n_total, L, B, DW, seed=4)
    sw = _torch_sw(d)
    x, enc = torch.from_numpy(d["x"]), torch.from_numpy(d["enc"]).to(torch.bfloat16)
    s, n = 3, 2  # dilations 1, 2 (indices 3, 4 mod 3)
    sub = {k: v[s : s + n] for k, v in sw.items()}
    want = tfk.flow_stack_plain(x, enc, sub, 0, n, num_stages)
    got = tfk.flow_stack_plain(x, enc, sw, s, n, num_stages)
    assert torch.equal(got, want)
    cw = tfk.compact_weights(sw)
    assert cw["w_tap"].dtype == torch.bfloat16 and cw["b"].dtype == torch.float32
    assert torch.equal(tfk.flow_stack_plain(x, enc, cw, s, n, num_stages), want)
    assert tfk.state_rows(s, n, num_stages) == 2 * (1 + 2)


@pytest.mark.parametrize("chunk", [32, 8, 20])  # 8 and 20 are shorter than 2d = 32
def test_streaming_plain_chunks_equal_oneshot_and_jax_state(chunk):
    n_layers, num_stages, L, B, DW = 5, 5, 96, 3, 128
    d = _inputs(n_layers, L, B, DW, seed=3)
    sw = _torch_sw(d)
    x, enc = torch.from_numpy(d["x"]), torch.from_numpy(d["enc"]).to(torch.bfloat16)
    want = tfk.flow_stack_plain(x, enc, sw, 0, n_layers, num_stages)
    rows = tfk.state_rows(0, n_layers, num_stages)
    assert rows == 2 * (1 + 2 + 4 + 8 + 16)

    state = torch.zeros((rows, B, W))
    zero_out, _ = tfk.flow_stack(x, enc, sw, 0, n_layers, num_stages, state=state)
    assert torch.equal(zero_out, want)  # a zero state is the fresh causal history

    jstate = jnp.zeros((rows, B, W), jnp.float32)
    outs = []
    for c0 in range(0, L, chunk):
        sl = slice(c0, min(c0 + chunk, L))
        o, state = tfk.flow_stack(x[sl], enc[sl], sw, 0, n_layers, num_stages, state=state)
        outs.append(o)
        if L % chunk == 0:
            dc = dict(d, x=d["x"][sl], enc=d["enc"][sl])
            _, jstate = _jax_call(dc, n_layers, num_stages, chunk, B, DW, min(chunk, 16), True,
                                  state=jstate)
            _close(state.numpy(), jstate)
    assert torch.equal(torch.cat(outs, 0), want)
    # the final state is the tail of every layer's own input stream
    assert torch.equal(state[:2], x[-2:])


def test_wrapper_runs_the_plain_version_on_cpu_and_counts_nothing():
    d = _inputs(2, 16, 1, 64, seed=5)
    x, enc = torch.from_numpy(d["x"]), torch.from_numpy(d["enc"]).to(torch.bfloat16)
    before = tfk.flow_stack.launches
    got = tfk.flow_stack(x, enc, _torch_sw(d), 0, 2, 2)
    assert torch.equal(got, tfk.flow_stack_plain(x, enc, _torch_sw(d), 0, 2, 2))
    assert tfk.flow_stack.launches == before


@pytest.mark.parametrize("fault", ["width", "deconv_width", "f32_weights", "enc_dtype", "layers",
                                   "state_shape", "not_contiguous", "stream_and_enc",
                                   "f32cond_bf16_w_cond"])
def test_cuda_wrapper_rejects_what_the_kernel_does_not_take(fault):
    """The checks run before anything touches the card, so they can be held
    here: every fault raises ValueError and no launch is counted."""
    width = 48 if fault == "width" else W  # the kernel is compiled for 32, 64, 128 and 256
    DW = 100 if fault == "deconv_width" else 64  # not a multiple of 8
    rng = np.random.RandomState(6)
    t = lambda *shape: torch.from_numpy(rng.randn(*shape).astype(np.float32))
    x, enc = t(8, 2, width), t(8, 2, DW).to(torch.bfloat16)
    sw = {"w_tap": t(3, 3, width, width), "b": t(3, width), "w_cond": t(3, DW, width),
          "b_cond": t(3, width), "w_res": t(3, width // 2, width), "b_res": t(3, width)}
    if fault != "f32_weights":  # an f32 w_tap under compact=True
        sw = tfk.compact_weights(sw)
    state, s, n_layers, kw = None, 0, 2, {}
    if fault == "enc_dtype":  # an f32 encoding under compact=True
        enc = enc.float()
    elif fault == "layers":
        s = 2  # layers 2 and 3 of a flow of 3
    elif fault == "state_shape":
        state = torch.zeros((5, 2, width))
    elif fault == "not_contiguous":
        x = t(2, 8, width).transpose(0, 1)
    elif fault == "stream_and_enc":
        kw["cond"] = t(8, 2, n_layers * width).to(torch.bfloat16)
    elif fault == "f32cond_bf16_w_cond":
        kw["compact"], enc = False, enc.float()
    before = tfk.flow_stack.launches
    with pytest.raises(ValueError):
        tfk._flow_stack_cuda(x, enc, sw, s, n_layers, 2, state, **kw)
    assert tfk.flow_stack.launches == before
