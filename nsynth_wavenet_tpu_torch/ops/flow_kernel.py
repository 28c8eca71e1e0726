"""One IAF flow's dilated trunk through the hand-written CUDA kernel
``csrc/flow_kernel.cu`` (port of the Pallas TPU kernel
nsynth_wavenet_tpu/ops/flow_kernel.py make_flow_stack_fn with fused taps,
time-major, in every conditioning mode it takes).

One call runs layers s .. s + n_layers - 1 of a flow, any number of them;
layer i has dilation 2^(i % num_stages).  With l the f32 residual stream
[L, B, W]:

    a    = bf16([l[t-2d], l[t-d], l[t]])     rows before t = 0: zeros, or the state
    taps = a @ bf16(w_tap)                                           f32 sums
    pre  = taps + enc[t] @ w_cond + (b + b_cond)    with an encoding enc
    pre  = (taps + cond[t]) + b                     with a cond stream
    g    = sigmoid(pre[:, :W/2]) * tanh(pre[:, W/2:])
    l    = l + bf16(g) @ bf16(w_res) + b_res

The conditioning product's operands are bf16 when ``compact`` (a bf16 model)
or ``fuse_cond`` (the reference's one K = 3W + DW product), else f32 with an
f32 product (an f32 model).  A cond stream [L, B, n_layers * W] (the
reference's precomputed-conditioning mode, cond_features=0) already holds
the mel-cond projection and its bias b_cond; layer i of the call reads
columns i*W:(i+1)*W, bf16 when compact, else f32.

``state`` [sum(2d), B, W] carries, per layer, the last 2d rows of that
layer's own input stream across calls, so chained chunk calls equal one long
call; zeros are the fresh causal history.  With ``carry_dtype=torch.bfloat16``
the history is held in bf16: the output does not change (every tap is rounded
to bf16 at its product), the returned state is f32 holding bf16 values.

``flow_stack`` is the wrapper: on CUDA tensors it launches the kernel (and
raises if it cannot), on CPU tensors it runs ``flow_stack_plain``, the plain
PyTorch version with the same signature and the same roundings.

The reference's other options compute the same function: fuse_taps=False
sums the same bf16 products in another order, tile / b_tile are TPU grid
parameters, and time_major=False is a transpose around the call.
"""

import ctypes

import torch

from nsynth_wavenet_tpu_torch.ops.conv import effective_kernel

MATRICES = ("w_tap", "w_cond", "w_res")
WIDTHS = (32, 64, 128, 256)  # the widths csrc/flow_kernel.cu is compiled for
COND_MODES = ("bf16", "f32cond", "stream", "stream_f32")  # index = CondMode in the source


def stack_flow_weights(flow_params):
    """Stack one flow's per-layer conv params into the kernel's layout,
    resolving weight norm: w_tap [NL, 3, W, W], b [NL, W], w_cond [NL, DW, W],
    b_cond [NL, W], w_res [NL, W/2, W], b_res [NL, W], all f32."""
    layers = flow_params["layers"]
    return {
        "w_tap": torch.stack([effective_kernel(l["dilated"]) for l in layers]),
        "b": torch.stack([l["dilated"]["b"] for l in layers]),
        "w_cond": torch.stack([effective_kernel(l["mel_cond"])[0] for l in layers]),
        "b_cond": torch.stack([l["mel_cond"]["b"] for l in layers]),
        "w_res": torch.stack([effective_kernel(l["res"])[0] for l in layers]),
        "b_res": torch.stack([l["res"]["b"] for l in layers]),
    }


def _stored(sw, bf16_keys):
    return {k: v.to(torch.bfloat16 if k in bf16_keys else torch.float32).contiguous()
            for k, v in sw.items()}


def compact_weights(sw):
    """The stacked weights with the matrices stored in bf16, as the compact
    kernel reads them (the same numbers: every product rounds its weights to
    bf16 anyway).  Done once per flow, so that a call casts nothing."""
    return _stored(sw, MATRICES)


def noncompact_weights(sw):
    """The stacked weights as the f32-conditioning kernel reads them: w_tap and
    w_res in bf16 (they feed bf16 products in both modes), w_cond and the
    biases in f32."""
    return _stored(sw, ("w_tap", "w_res"))


def dilations(s: int, n_layers: int, num_stages: int):
    return [2 ** (i % num_stages) for i in range(s, s + n_layers)]


def state_rows(s: int, n_layers: int, num_stages: int) -> int:
    """Rows of the packed state of one call: layer i owns 2 * d_i of them."""
    return sum(2 * d for d in dilations(s, n_layers, num_stages))


def mode_key(mode: str, width: int) -> str:
    """Key of flow_stack.launches_by_mode: the conditioning mode (COND_MODES),
    with the width appended when it is not 64."""
    return mode if width == 64 else f"{mode}_w{width}"


def _bf(x):
    """Round to bf16 and hold as f32 (a product's operand)."""
    return x.to(torch.bfloat16).float()


def _carry_bf16(carry_dtype):
    if carry_dtype in (None, torch.float32):
        return False
    if carry_dtype == torch.bfloat16:
        return True
    raise ValueError(f"carry_dtype must be None, float32 or bfloat16, got {carry_dtype}")


@torch.no_grad()
def flow_stack_plain(x, enc, sw, s, n_layers, num_stages, state=None, compact=True, *,
                     fuse_cond=False, carry_dtype=None, cond=None):
    """Plain PyTorch version of the kernel (see ``flow_stack``)."""
    L, B, W = x.shape
    m = W // 2
    carry_bf16 = _carry_bf16(carry_dtype)
    l = x.float()
    bf_cond = compact or fuse_cond
    if cond is None:
        enc_op = _bf(enc) if bf_cond else enc.float()
    new_state, off = [], 0
    for i, (li, d) in enumerate(zip(range(s, s + n_layers), dilations(s, n_layers, num_stages))):
        hist = l.new_zeros((2 * d, B, W)) if state is None else state[off : off + 2 * d].float()
        if carry_bf16:
            hist = _bf(hist)
        off += 2 * d
        stream = torch.cat([hist, l], 0)  # [2d + L, B, W]: row j holds time j - 2d
        a = _bf(torch.cat([stream[:L], stream[d : d + L], l], -1))
        taps = a @ _bf(sw["w_tap"][li].reshape(3 * W, W))
        if cond is not None:
            c = cond[..., i * W : (i + 1) * W]
            pre = taps + (_bf(c) if compact else c.float()) + sw["b"][li].float()
        else:
            w_cond = sw["w_cond"][li].float()
            pre = (taps + enc_op @ (_bf(w_cond) if bf_cond else w_cond)
                   + (sw["b"][li] + sw["b_cond"][li]).float())
        g = torch.sigmoid(pre[..., :m]) * torch.tanh(pre[..., m:])
        new_state.append(_bf(stream[L:]) if carry_bf16 else stream[L:])
        l = l + _bf(g) @ _bf(sw["w_res"][li]) + sw["b_res"][li].float()
    if state is None:
        return l
    return l, torch.cat(new_state, 0)


# ---------------------------------------------------------------------------
# CUDA wrapper
# ---------------------------------------------------------------------------


class _FlowArgs(ctypes.Structure):
    """Mirror of struct FlowArgs in csrc/flow_kernel.cu."""

    _fields_ = [(name, ctypes.c_void_p) for name in (
        "x", "cond", "w_tap", "w_cond", "bias", "w_res", "b_res", "state", "new_state", "tmp",
        "out", "stream",
    )] + [(name, ctypes.c_int) for name in (
        "device", "L", "B", "W", "cond_cols", "n_layers", "first_layer", "num_stages",
        "cond_mode", "carry_bf16",
    )]


def _lib():
    from nsynth_wavenet_tpu_torch.kernels import build

    lib = build.load("flow_kernel")
    if not getattr(lib, "_argtypes_set", False):
        lib.flow_stack.argtypes = [ctypes.POINTER(_FlowArgs)]
        lib.flow_stack.restype = ctypes.c_int
        lib.flow_error_string.argtypes = [ctypes.c_int]
        lib.flow_error_string.restype = ctypes.c_char_p
        lib._argtypes_set = True
    return lib


def _expect(name, t, shape, dtype, device):
    if t.device != device or t.dtype != dtype or tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: want {dtype} {tuple(shape)} on {device}, "
                         f"got {t.dtype} {tuple(t.shape)} on {t.device}")
    if not t.is_contiguous() or t.data_ptr() % 16:
        raise ValueError(f"{name} must be contiguous and 16-byte aligned")


def _as_bf16(name, t):
    """fuse_cond's operand rounded to bf16, from bf16 or f32."""
    if t.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"{name}: want bf16 or f32 under fuse_cond, got {t.dtype}")
    return t.to(torch.bfloat16).contiguous()


def _conditioning(enc, cond, sw, sl, L, B, W, n_layers, compact, fuse_cond, dev):
    """(mode, conditioning tensor, w_cond slice or None, bias [n_layers, W])
    of a call, after the checks of what each mode takes."""
    bf, f32 = torch.bfloat16, torch.float32
    if cond is not None:
        if enc is not None:
            raise ValueError("pass the encoding enc or a cond stream, not both")
        if fuse_cond:
            raise ValueError("fuse_cond fuses the encoding's product: it takes enc, not a cond stream")
        _expect("cond", cond, (L, B, n_layers * W), bf if compact else f32, dev)
        return ("stream" if compact else "stream_f32"), cond, None, sw["b"][sl].contiguous()
    if enc is None:
        raise ValueError("flow_stack needs an encoding enc or a cond stream")
    DW = enc.shape[-1]
    if DW < 8 or DW % 8:
        raise ValueError(f"the CUDA flow kernel needs a deconv width that is a multiple of 8, "
                         f"got {DW}")
    nl = sw["w_tap"].shape[0]
    _expect("b_cond", sw["b_cond"], (nl, W), f32, dev)
    w_cond = sw["w_cond"]
    if fuse_cond:  # one bf16 product over [taps | enc]: both rounded, whatever compact is
        mode, enc, w_cond = "bf16", _as_bf16("enc", enc), _as_bf16("w_cond", w_cond)
    elif compact:
        mode = "bf16"
        if w_cond.dtype == f32:
            raise ValueError("w_cond must be bf16 in the compact mode: pass compact_weights(sw)")
    else:
        mode = "f32cond"
        if w_cond.dtype == bf:
            raise ValueError("the f32 conditioning product takes w_cond in f32: "
                             "pass noncompact_weights(sw)")
    dt = bf if mode == "bf16" else f32
    _expect("enc", enc, (L, B, DW), dt, dev)
    _expect("w_cond", w_cond, (nl, DW, W), dt, dev)
    return mode, enc, w_cond[sl], (sw["b"][sl] + sw["b_cond"][sl]).contiguous()


def _flow_stack_cuda(x, enc, sw, s, n_layers, num_stages, state=None, compact=True,
                     fuse_cond=False, carry_dtype=None, cond=None):
    L, B, W = x.shape
    dev = x.device
    bf, f32 = torch.bfloat16, torch.float32
    if W not in WIDTHS:
        raise ValueError(f"the CUDA flow kernel is compiled for widths {WIDTHS}, got {W}")
    if L < 1 or B < 1 or L * B >= 2**31 - 256:
        raise ValueError(f"unsupported stream of {L} x {B} rows")
    _expect("x", x, (L, B, W), f32, dev)
    nl = sw["w_tap"].shape[0]
    if n_layers < 1 or not 0 <= s <= nl - n_layers:
        raise ValueError(f"layers {s}:{s + n_layers} outside the flow's {nl}")
    carry_bf16 = _carry_bf16(carry_dtype)
    for name, shape in (("w_tap", (nl, 3, W, W)), ("w_res", (nl, W // 2, W))):
        if sw[name].dtype == f32:
            raise ValueError(f"{name} must be bf16 on the card: pass compact_weights(sw) or "
                             "noncompact_weights(sw)")
        _expect(name, sw[name], shape, bf, dev)
    for name in ("b", "b_res"):
        _expect(name, sw[name], (nl, W), f32, dev)
    sl = slice(s, s + n_layers)
    mode, cond_t, w_cond, bias = _conditioning(enc, cond, sw, sl, L, B, W, n_layers, compact,
                                               fuse_cond, dev)
    rows = state_rows(s, n_layers, num_stages)
    new_state = None
    if state is not None:
        if carry_bf16 and state.dtype == bf:  # a bf16 history is read as bf16
            state = state.float()
        _expect("state", state, (rows, B, W), f32, dev)
        new_state = torch.empty_like(state)

    out = torch.empty_like(x)
    tmp = torch.empty_like(x) if n_layers > 1 else None
    args = _FlowArgs(
        x=x.data_ptr(), cond=cond_t.data_ptr(), w_tap=sw["w_tap"][sl].data_ptr(),
        w_cond=None if w_cond is None else w_cond.data_ptr(), bias=bias.data_ptr(),
        w_res=sw["w_res"][sl].data_ptr(), b_res=sw["b_res"][sl].data_ptr(),
        state=None if state is None else state.data_ptr(),
        new_state=None if new_state is None else new_state.data_ptr(),
        tmp=None if tmp is None else tmp.data_ptr(), out=out.data_ptr(),
        stream=torch.cuda.current_stream(dev).cuda_stream,
        device=dev.index, L=L, B=B, W=W, cond_cols=cond_t.shape[-1], n_layers=n_layers,
        first_layer=s, num_stages=num_stages, cond_mode=COND_MODES.index(mode),
        carry_bf16=int(carry_bf16),
    )
    lib = _lib()
    rc = lib.flow_stack(ctypes.byref(args))
    if rc != 0:
        raise RuntimeError(f"CUDA flow kernel failed: {lib.flow_error_string(rc).decode()} "
                           f"(cudaError {rc})")
    flow_stack.launches += 1
    key = mode_key(mode, W)
    flow_stack.launches_by_mode[key] = flow_stack.launches_by_mode.get(key, 0) + 1
    # x, the conditioning, the weights and tmp stay referenced until the
    # launches are enqueued; the caching allocator reuses their memory in
    # stream order only
    return out if state is None else (out, new_state)


def flow_stack(x, enc, sw, s, n_layers, num_stages, state=None, compact=True, *,
               fuse_cond=False, carry_dtype=None, cond=None):
    """Layers s .. s + n_layers - 1 of one flow's trunk over a whole stream.

    x [L, B, W] f32 residual stream (time-major); enc [L, B, DW] the deconv
    encoding, bf16 when compact, f32 otherwise (either under fuse_cond), or
    None with a cond stream [L, B, n_layers * W] (bf16 when compact, else
    f32) whose columns already hold each layer's mel-cond projection and
    b_cond.  sw: stack_flow_weights output for the flow (through
    compact_weights or noncompact_weights for the card).  state
    [state_rows, B, W] f32 (or bf16 with bf16 carries) or None.  Returns l
    [L, B, W] f32, and with a state (l, new_state).  Any B >= 1, L >= 1 and
    n_layers >= 1.  CUDA tensors run the CUDA kernel (widths in WIDTHS, a
    deconv width that is a multiple of 8); CPU tensors run the plain version."""
    if x.device.type == "cuda":
        return _flow_stack_cuda(x, enc, sw, s, n_layers, num_stages, state, compact, fuse_cond,
                                carry_dtype, cond)
    if x.device.type == "cpu":
        return flow_stack_plain(x, enc, sw, s, n_layers, num_stages, state, compact,
                                fuse_cond=fuse_cond, carry_dtype=carry_dtype, cond=cond)
    raise ValueError(f"unsupported device {x.device}")


flow_stack.launches = 0
# by mode_key: the conditioning mode, "_w<width>" appended for widths other than 64
flow_stack.launches_by_mode = {mode_key(m, w): 0 for w in WIDTHS for m in COND_MODES}
