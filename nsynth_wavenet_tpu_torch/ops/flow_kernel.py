"""One IAF flow's dilated trunk through the hand-written CUDA kernel
``csrc/flow_kernel.cu`` (port of the Pallas TPU kernel
nsynth_wavenet_tpu/ops/flow_kernel.py make_flow_stack_fn in its shipped
configuration: fused taps, in-kernel mel conditioning from the raw deconv
encoding, time-major, compact).

One call runs ``n_layers <= num_stages`` layers starting at layer ``s`` of a
flow; layer i has dilation 2^(i % num_stages).  With l the f32 residual
stream [L, B, W]:

    a   = bf16([l[t-2d], l[t-d], l[t]])     rows before t = 0: zeros, or the state
    pre = a @ bf16(w_tap) + bf16(enc[t]) @ bf16(w_cond) + (b + b_cond)    f32 sums
    g   = sigmoid(pre[:, :W/2]) * tanh(pre[:, W/2:])
    l   = l + bf16(g) @ bf16(w_res) + b_res

``state`` [sum(2d), B, W] f32 carries, per layer, the last 2d rows of that
layer's own input stream across calls, so chained chunk calls equal one long
call; zeros are the fresh causal history.

``flow_stack`` is the wrapper: on CUDA tensors it launches the kernel (and
raises if it cannot), on CPU tensors it runs ``flow_stack_plain``, the plain
PyTorch version with the same signature and the same roundings.
"""

import ctypes

import torch

from nsynth_wavenet_tpu_torch.ops.conv import effective_kernel

MATRICES = ("w_tap", "w_cond", "w_res")


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


def compact_weights(sw):
    """The stacked weights with the matrices stored in bf16, as the compact
    kernel reads them (the same numbers: every product rounds its weights to
    bf16 anyway).  Done once per flow, so that a call casts nothing."""
    return {k: v.to(torch.bfloat16).contiguous() if k in MATRICES else v.float().contiguous()
            for k, v in sw.items()}


def dilations(s: int, n_layers: int, num_stages: int):
    return [2 ** (i % num_stages) for i in range(s, s + n_layers)]


def state_rows(s: int, n_layers: int, num_stages: int) -> int:
    """Rows of the packed state of one call: layer i owns 2 * d_i of them."""
    return sum(2 * d for d in dilations(s, n_layers, num_stages))


def _bf(x):
    """Round to bf16 and hold as f32 (a product's operand)."""
    return x.to(torch.bfloat16).float()


@torch.no_grad()
def flow_stack_plain(x, enc, sw, s, n_layers, num_stages, state=None, compact=True):
    """Plain PyTorch version of the kernel (see ``flow_stack``).  compact=False
    keeps the conditioning product in f32 (f32 enc and w_cond)."""
    L, B, W = x.shape
    m = W // 2
    l = x.float()
    enc_op = _bf(enc) if compact else enc.float()
    new_state, off = [], 0
    for li, d in zip(range(s, s + n_layers), dilations(s, n_layers, num_stages)):
        hist = l.new_zeros((2 * d, B, W)) if state is None else state[off : off + 2 * d].float()
        off += 2 * d
        stream = torch.cat([hist, l], 0)  # [2d + L, B, W]: row j holds time j - 2d
        a = _bf(torch.cat([stream[:L], stream[d : d + L], l], -1))
        w_cond = sw["w_cond"][li].float()
        pre = (a @ _bf(sw["w_tap"][li].reshape(3 * W, W))
               + enc_op @ (_bf(w_cond) if compact else w_cond)
               + (sw["b"][li] + sw["b_cond"][li]).float())
        g = torch.sigmoid(pre[..., :m]) * torch.tanh(pre[..., m:])
        new_state.append(stream[L:])
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
        "x", "enc", "w_tap", "w_cond", "b_eff", "w_res", "b_res", "state", "new_state", "tmp",
        "out", "stream",
    )] + [(name, ctypes.c_int) for name in (
        "device", "L", "B", "W", "DW", "n_layers", "first_layer", "num_stages",
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


def _flow_stack_cuda(x, enc, sw, s, n_layers, num_stages, state):
    L, B, W = x.shape
    DW = enc.shape[-1]
    dev = x.device
    bf, f32 = torch.bfloat16, torch.float32
    if W != 64:
        raise ValueError(f"the CUDA flow kernel is compiled for width 64, got {W}")
    if DW % 64:
        raise ValueError(f"the CUDA flow kernel needs deconv_width % 64 == 0, got {DW}")
    if L < 1 or B < 1 or L * B >= 2**31 - 128:
        raise ValueError(f"unsupported stream of {L} x {B} rows")
    _expect("x", x, (L, B, W), f32, dev)
    _expect("enc", enc, (L, B, DW), bf, dev)
    nl = sw["w_tap"].shape[0]
    if not 0 <= s < s + n_layers <= nl:
        raise ValueError(f"layers {s}:{s + n_layers} outside the flow's {nl}")
    if n_layers > num_stages:
        raise ValueError(f"one call takes at most num_stages = {num_stages} layers, got {n_layers}")
    want = {"w_tap": ((nl, 3, W, W), bf), "w_cond": ((nl, DW, W), bf), "w_res": ((nl, W // 2, W), bf),
            "b": ((nl, W), f32), "b_cond": ((nl, W), f32), "b_res": ((nl, W), f32)}
    for name, (shape, dtype) in want.items():
        if name in MATRICES and sw[name].dtype == f32:
            raise ValueError(f"{name} must be bf16 on the card: pass compact_weights(sw)")
        _expect(name, sw[name], shape, dtype, dev)
    rows = state_rows(s, n_layers, num_stages)
    new_state = None
    if state is not None:
        _expect("state", state, (rows, B, W), f32, dev)
        new_state = torch.empty_like(state)

    sl = slice(s, s + n_layers)
    b_eff = (sw["b"][sl] + sw["b_cond"][sl]).contiguous()
    out = torch.empty_like(x)
    tmp = torch.empty_like(x) if n_layers > 1 else None
    mats = {k: sw[k][sl] for k in ("w_tap", "w_cond", "w_res", "b_res")}
    args = _FlowArgs(
        x=x.data_ptr(), enc=enc.data_ptr(), b_eff=b_eff.data_ptr(),
        **{k: v.data_ptr() for k, v in mats.items()},
        state=None if state is None else state.data_ptr(),
        new_state=None if new_state is None else new_state.data_ptr(),
        tmp=None if tmp is None else tmp.data_ptr(), out=out.data_ptr(),
        stream=torch.cuda.current_stream(dev).cuda_stream,
        device=dev.index, L=L, B=B, W=W, DW=DW, n_layers=n_layers, first_layer=s,
        num_stages=num_stages,
    )
    lib = _lib()
    rc = lib.flow_stack(ctypes.byref(args))
    if rc != 0:
        raise RuntimeError(f"CUDA flow kernel failed: {lib.flow_error_string(rc).decode()} "
                           f"(cudaError {rc})")
    flow_stack.launches += 1
    # x, enc, the weights and tmp stay referenced until the launches are enqueued;
    # the caching allocator reuses their memory in stream order only
    return out if state is None else (out, new_state)


def flow_stack(x, enc, sw, s, n_layers, num_stages, state=None, compact=True):
    """Layers s .. s + n_layers - 1 of one flow's trunk over a whole stream.

    x [L, B, W] f32 residual stream (time-major), enc [L, B, DW] conditioning
    (bf16 when compact), sw: stack_flow_weights output for the flow (through
    compact_weights for the card), state [state_rows, B, W] f32 or None.
    Returns l [L, B, W] f32, and with a state (l, new_state).  Any B >= 1 and
    L >= 1.  CUDA tensors run the CUDA kernel, which implements the compact
    mode only; CPU tensors run the plain version."""
    if x.device.type == "cuda":
        if not compact:
            raise NotImplementedError("the CUDA flow kernel implements the compact mode only")
        return _flow_stack_cuda(x, enc, sw, s, n_layers, num_stages, state)
    if x.device.type == "cpu":
        return flow_stack_plain(x, enc, sw, s, n_layers, num_stages, state, compact)
    raise ValueError(f"unsupported device {x.device}")


flow_stack.launches = 0
