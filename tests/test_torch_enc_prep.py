"""The int8 modes' conditioning pre-pass (quant_enc_kernel's plain version,
fastgen_kernel.enc_prepass_plain) against the JAX package, on the CPU.

The pre-pass reads an encoding window as the caller holds it (the deconv's
[B, T, DW] output, held channel by channel, seen time-major through
``transpose(0, 1)``; or a contiguous time-major tensor) and writes the
contiguous bf16 copy, the int8 rows and their scales that the generation
kernel reads.  Its q_enc and r_enc must equal JAX's ``_quant_rows_dyn``
applied per time step to the same bf16 encoding, as the Pallas kernel
applies it (nsynth_wavenet_tpu/ops/fastgen_kernel.py:451); ``generate`` fed
the strided window must equal the same call on a contiguous copy, bit for
bit; and the layouts the kernel does not take are refused on every device.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nsynth_wavenet_tpu.ops import fastgen_kernel as jfk
from nsynth_wavenet_tpu_torch import config as config_lib
from nsynth_wavenet_tpu_torch import weights
from nsynth_wavenet_tpu_torch.models.fastgen import Fastgen
from nsynth_wavenet_tpu_torch.models.wavenet import Wavenet
from nsynth_wavenet_tpu_torch.ops import fastgen_kernel as fk

GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Step loops of small products: one thread runs them as fast as many and
    keeps this file's worker off the other workers' cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _deconv_layout(B, T, DW, seed, dtype=torch.bfloat16):
    """An encoding [B, T, DW] held as the deconv stack leaves it: channel by
    channel (time contiguous), N(0, 1) values from numpy, one all-zero time
    step (its row's scale is the 1e-8 floor's)."""
    store = np.random.RandomState(seed).randn(B, DW, T).astype(np.float32)
    store[:, :, 3] = 0.0
    return torch.from_numpy(store).to(dtype).transpose(1, 2)


def _jax_rows(enc_bf):
    """JAX's per-step quantiser over a bf16 window [C, B, DW]: (q, r) stacked."""
    jenc = jnp.asarray(enc_bf.float().numpy()).astype(jnp.bfloat16)
    q, r = zip(*(jfk._quant_rows_dyn(jenc[t]) for t in range(jenc.shape[0])))
    return np.stack([np.asarray(v) for v in q]), np.stack([np.asarray(v)[:, 0] for v in r])


@pytest.mark.parametrize("B,T,DW,off,C,chunk", [
    (3, 40, 256, 5, 29, 12),    # cond_offset > 0, a ragged last chunk of 5
    (1, 24, 256, 2, 17, 17),    # one batch row, one chunk
    (896, 16, 256, 1, 9, 4),    # the shipped batch, a ragged last chunk of 1
    (2, 40, 128, 0, 40, 16),    # a narrower deconv width, the window from step 0
])
def test_plain_prepass_equals_jax_per_step(B, T, DW, off, C, chunk):
    enc = _deconv_layout(B, T, DW, seed=B + DW)
    enc_tm = enc.transpose(0, 1)
    for c0 in range(0, C, chunk):
        win = enc_tm[off + c0 : off + min(c0 + chunk, C)]
        assert fk.enc_layout(win) == "channels"
        enc_c, q, r = fk.enc_prepass(win)
        assert enc_c.is_contiguous() and enc_c.dtype == torch.bfloat16
        assert q.dtype == torch.int8 and r.dtype == torch.float32
        assert torch.equal(enc_c, win.contiguous())
        want_q, want_r = _jax_rows(win)
        np.testing.assert_array_equal(q.numpy(), want_q)
        np.testing.assert_array_equal(r.numpy(), want_r)
        # the rows layout (a contiguous time-major copy) gives the same bits
        assert fk.enc_layout(enc_c) == "rows"
        assert all(torch.equal(a, b) for a, b in zip(fk.enc_prepass(enc_c), (enc_c, q, r)))


def test_plain_prepass_rounds_an_f32_window_to_bf16_first():
    enc = _deconv_layout(4, 32, 64, seed=9, dtype=torch.float32)
    win = enc.transpose(0, 1)[3:20]
    enc_c, q, r = fk.enc_prepass(win)
    assert torch.equal(enc_c, win.to(torch.bfloat16).contiguous())
    want_q, want_r = _jax_rows(enc_c)
    np.testing.assert_array_equal(q.numpy(), want_q)
    np.testing.assert_array_equal(r.numpy(), want_r)


def _golden_teacher():
    d = os.path.join(GOLDEN, "tiny_mol")
    cfg = config_lib.load_config(os.path.join(d, "meta.json"))
    return Wavenet(cfg), weights.load_npz(os.path.join(d, "params.npz"), device="cpu")


@pytest.mark.parametrize("mode", ["bf16", "static", "row"])
def test_generate_from_the_strided_window_equals_a_contiguous_copy(mode):
    """Fastgen.generate_cuda on the CPU (the plain version), fed the encoding as
    the deconv leaves it, one-shot and chunked, equals fastgen_kernel.generate
    on the contiguous time-major copy of the same window, bit for bit."""
    model, params = _golden_teacher()
    cfg = model.cfg
    build = {"bf16": {}, "row": {"weight_dtype": "int8"},
             "static": {"weight_dtype": "int8", "act_amax": torch.full((cfg.num_layers,), 2.0)}}
    kw = fk.build_kernel_weights(cfg, params, **build[mode])
    B, T, off, L = 2, 40, 7, 21
    enc = _deconv_layout(B, T, cfg.deconv_width, seed=5)
    want = fk.generate(kw, enc.transpose(0, 1)[off : off + L].contiguous(), 11)
    fg = Fastgen(model)
    one = fg.generate_cuda(params, None, 11, L, cond_offset=off, kw=kw, encoding=enc)
    chunked = fg.generate_cuda(params, None, 11, L, cond_offset=off, kw=kw, encoding=enc, chunk=8)
    assert torch.equal(one, want) and torch.equal(chunked, want)


def _refused(enc):
    with pytest.raises(ValueError):
        fk.enc_layout(enc)
    with pytest.raises(ValueError):
        fk.enc_prepass(enc)


def test_layouts_the_kernel_does_not_take_are_refused():
    store = torch.zeros((4, 40, 256), dtype=torch.bfloat16)  # [B, T, DW] contiguous
    tm = store.transpose(0, 1)  # [T, B, DW], rows 16-byte aligned
    assert fk.enc_layout(tm) == "rows"
    _refused(tm[..., :252])          # DW not a multiple of 8
    _refused(tm[..., 1:249])         # rows past a 16-byte boundary
    _refused(tm.permute(0, 2, 1).contiguous().permute(0, 2, 1))  # batch contiguous
    _refused(tm.to(torch.float16))   # neither bf16 nor f32
    _refused(torch.zeros((4, 2, 520)))  # wider than ENC_MAX_WIDTH
    odd = torch.zeros((2, 3, 37), dtype=torch.bfloat16).transpose(1, 2)[:, :36]  # [B, T, 3]
    _refused(odd.transpose(0, 1))
    # a channel layout whose channels are not 16 bytes apart: T odd
    chan = torch.zeros((2, 64, 41), dtype=torch.bfloat16).transpose(1, 2).transpose(0, 1)
    _refused(chan)
    assert fk.enc_layout(torch.zeros((2, 64, 48), dtype=torch.bfloat16)
                         .transpose(1, 2).transpose(0, 1)[5:30]) == "channels"


def test_generate_refuses_such_a_window_in_the_int8_modes_only():
    model, params = _golden_teacher()
    cfg = model.cfg
    enc = torch.zeros((6, 2, cfg.deconv_width + 2), dtype=torch.bfloat16)[..., 1 : cfg.deconv_width + 1]
    kw8 = fk.build_kernel_weights(cfg, params, weight_dtype="int8")
    with pytest.raises(ValueError, match="16-byte"):
        fk.generate(kw8, enc, 0)
    # the bf16 mode copies the window with PyTorch, whatever its layout
    kw = fk.build_kernel_weights(cfg, params)
    assert fk.generate(kw, enc, 0).shape == (2, 6)
