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
PyTorch version with the same signature and the same roundings.  The kernel
is picked by width alone: ``flow_persist_kernel`` at W 32 and 64 (persistent
blocks, weights resident in shared memory, an asynchronous ring of row
chunks, laid out by ``persist_plan``), ``flow_wide_kernel`` at W 128 and 256
(persistent blocks of two wgmma warpgroups sharing 128-row tiles, laid out by
``wide_plan``, reading the weights in the layout ``wide_weights`` makes).
With a state, each layer's new history is written by that layer's trunk
launch (the kernel's carry twin, flow_persist_carry_kernel or
flow_wide_carry_kernel in the source), so a call launches one kernel a layer
with a state or without.

The reference's perf probes (probe=, :132-138, with its guard :155-159) are
ported as ``flow_stack(probe=..., allow_wrong_output=True)``, in every width
and conditioning mode, one-shot or with a state: "no_gate" forms the gate
from two clips, clip(pre[:W/2], 0, 1) * clip(pre[W/2:], -1, 1), in place of
sigmoid * tanh (:303-306); "no_slide" reads l(t) alone and multiplies it
into all three tap bands of w_tap, a = bf16([l[t], l[t], l[t]]).  The
reference's no_slide (:323-328) skips the copies that slide its VMEM carry
window, so its taps go stale at tile edges while the work stays; the port
keeps no carry window (each tile's dilated taps come from the layer's input
stream through the copy engine), so its no_slide drops those two loads, the
work the name points at: it has no twin of the same meaning in the
reference.  With a state, the state returned follows the full call's rule,
the last 2d rows of each layer's own input.  Their
output is wrong by design; on the card each runs a variant of the kernels
compiled into a library of its own (kernels/build.py PROBES), counted apart
in ``flow_stack.launches_by_probe``.

The reference's other options compute the same function: fuse_taps=False
sums the same bf16 products in another order, tile / b_tile are TPU grid
parameters, and time_major=False is a transpose around the call.
"""

import ctypes
from dataclasses import dataclass

import torch

from nsynth_wavenet_tpu_torch.kernels import build
from nsynth_wavenet_tpu_torch.ops.conv import effective_kernel

MATRICES = ("w_tap", "w_cond", "w_res")
PROBES = build.PROBES["flow_kernel"]  # flow_stack(probe=): "no_gate", "no_slide"
WIDTHS = (32, 64, 128, 256)  # the widths csrc/flow_kernel.cu is compiled for
COND_MODES = ("bf16", "f32cond", "stream", "stream_f32")  # index = CondMode in the source
# flow_stack's launched[] in the source (KernelId), the keys of flow_stack.kernel_launches;
# a carry twin (a call with a state) counts as its trunk kernel
KERNEL_NAMES = ("flow_persist_kernel", "flow_wide_kernel")
PERSIST_WIDTHS = (32, 64)  # flow_persist_kernel's
WIDE_WIDTHS = (128, 256)  # flow_wide_kernel's

# The persistent kernel's constants, as kernels/build.py compiles them into
# the source (-D flags), so that persist_plan and the kernel share one set.
_DEFINES = build.DEFINES["flow_kernel"]
WARPS = _DEFINES["FLOW_WARPS"]  # consumer warps of a block (and one producer warp)
GROUPS = _DEFINES["FLOW_GROUPS"]  # consumer groups, taking alternate tiles of the block
TILE_ROWS = _DEFINES["FLOW_TILE_ROWS"]  # rows of a tile: one 16-row band a warp of a group
MAX_STAGES = 8  # ring slots at most
SMEM_LIMIT = 232448  # shared memory one block may use on the H100 (227 KB)
# the wide kernel's: rows of a tile (a 64-row wgmma band for each of the
# WARPS // 4 consumer warpgroups) and K columns of a chunk of a bf16 operand
WIDE_TILE_ROWS = _DEFINES["FLOW_WIDE_TILE_ROWS"]
WIDE_KC = _DEFINES["FLOW_WIDE_KC"]


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
    bf16 anyway), and at W 128 and 256 also in the wide kernel's layout
    (wide_weights).  Done once per flow, so that a call casts nothing."""
    return wide_weights(_stored(sw, MATRICES))


def noncompact_weights(sw):
    """The stacked weights as the f32-conditioning kernel reads them: w_tap and
    w_res in bf16 (they feed bf16 products in both modes), w_cond and the
    biases in f32; at W 128 and 256 also in the wide kernel's layout."""
    return wide_weights(_stored(sw, ("w_tap", "w_res")))


def wide_cond_order(width: int):
    """The column order of an f32 w_cond for flow_wide_kernel: position
    16 j + 4 t + q holds column 16 j + 8 (q // 2) + 2 t + q % 2, so that one
    16-byte load gives a thread (t = lane % 4) the four columns of two
    neighbouring n8 blocks that its wgmma accumulators hold."""
    p = torch.arange(width)
    j, t, q = p // 16, (p % 16) // 4, p % 4
    return 16 * j + 8 * (q // 2) + 2 * t + q % 2


def wide_weights(sw):
    """sw (compact_weights' or noncompact_weights' matrices) with, at W 128
    and 256, the wide kernel's layout added beside them: w_tap_t [NL, W, 3W]
    and w_res_t [NL, W, W/2] bf16 (each output column's K values contiguous,
    as wgmma reads its B operand), and w_cond_t [NL, W, DW] bf16 when w_cond
    is bf16, or w_cond_w [NL, DW, W] f32 in wide_cond_order when it is f32.
    Other widths come back as they are."""
    nl, _, _, W = sw["w_tap"].shape
    if W not in WIDE_WIDTHS:
        return sw
    out = dict(sw)
    out["w_tap_t"] = sw["w_tap"].reshape(nl, 3 * W, W).transpose(1, 2).contiguous()
    out["w_res_t"] = sw["w_res"].transpose(1, 2).contiguous()
    if sw["w_cond"].dtype == torch.bfloat16:
        out["w_cond_t"] = sw["w_cond"].transpose(1, 2).contiguous()
    else:
        out["w_cond_w"] = sw["w_cond"][..., wide_cond_order(W).to(sw["w_cond"].device)].contiguous()
    return out


def dilations(s: int, n_layers: int, num_stages: int):
    return [2 ** (i % num_stages) for i in range(s, s + n_layers)]


def state_rows(s: int, n_layers: int, num_stages: int) -> int:
    """Rows of the packed state of one call: layer i owns 2 * d_i of them."""
    return sum(2 * d for d in dilations(s, n_layers, num_stages))


def mode_key(mode: str, width: int) -> str:
    """Key of flow_stack.launches_by_mode: the conditioning mode (COND_MODES),
    with the width appended when it is not 64."""
    return mode if width == 64 else f"{mode}_w{width}"


def kernel_name(width: int) -> str:
    """The flow-trunk kernel that serves a width: the dispatch is by width alone."""
    return KERNEL_NAMES[0] if width in PERSIST_WIDTHS else KERNEL_NAMES[1]


def predicted_launches(width: int, n_layers: int, with_state: bool) -> dict:
    """flow_stack.kernel_launches added by one call: a trunk launch a layer,
    with a state or without (with_state: the layer's launch also writes its
    new history)."""
    out = dict.fromkeys(KERNEL_NAMES, 0)
    out[kernel_name(width)] = n_layers
    return out


def _up(n, k):
    return -(-n // k) * k


BOX = TILE_ROWS * 128  # bytes of one copy box: a tile's rows x 128 bytes


@dataclass(frozen=True)
class PersistPlan:
    """The shared-memory layout of flow_persist_kernel for one (width, mode,
    deconv width); byte offsets as the kernel reads them from FlowArgs.
    Shared memory holds w_tap [3W] rows, w_cond (bf16 [DW up to 16] rows,
    or f32 [DW][W]; absent when not resident), w_res [W/2] rows, bf16 rows
    of ld_w elements (W 64: 64, swizzled; W 32: padded to 40), the biases
    [2W] f32, the ring's barriers (a full and an empty mbarrier a slot),
    then, 1024-byte aligned, the ring: ``stages`` slots of ``slot_bytes``,
    stages / GROUPS of them for each consumer group.  A slot holds one chunk of a tile as boxes of
    TILE_ROWS x 128 B side by side (BOX bytes each, in the copy engine's
    128-byte swizzle): a tap (W / 32 boxes of f32), a cond-stream chunk, or
    ``enc_cols`` encoding columns followed, when w_cond is not resident, by
    the chunk's w_cond rows at ``off_wchunk``."""

    width: int
    mode: str
    deconv_width: int
    stages: int
    slot_bytes: int
    enc_cols: int
    wc_resident: bool
    ld_w: int
    off_w_cond: int
    off_w_res: int
    off_bias: int
    off_bars: int
    off_ring: int
    off_wchunk: int
    smem_bytes: int
    tile_rows: int = TILE_ROWS


def persist_plan(width: int, mode: str, deconv_width: int = 0) -> PersistPlan:
    """flow_persist_kernel's layout at ``width`` (32 or 64) in conditioning
    mode ``mode`` (COND_MODES) with a deconv width that is a multiple of 8
    (ignored for a cond stream).  A slot is one tap chunk; an encoding chunk
    fills it (W * 4 / element bytes columns, fewer when the deconv width is
    narrower).  w_cond stays resident when two slots still fit beside it,
    else each encoding chunk of one box brings its own w_cond rows; the ring
    gets as many slots as fit, up to MAX_STAGES."""
    if width not in PERSIST_WIDTHS or mode not in COND_MODES:
        raise ValueError(f"no persistent plan for width {width}, mode {mode}")
    W, DW = width, deconv_width
    stream, f32c = mode in ("stream", "stream_f32"), mode == "f32cond"
    if not stream and (DW < 8 or DW % 8):
        raise ValueError(f"deconv width {DW} is not a positive multiple of 8")
    ld_w = 64 if W == 64 else W + 8  # W 64: 128-byte rows swizzled, W 32: padded
    tap = TILE_ROWS * W * 4  # W / 32 boxes
    w_tap, w_res, bias = _up(3 * W * ld_w * 2, 128), _up(W // 2 * ld_w * 2, 128), _up(8 * W, 128)

    def layout(wc_bytes, enc_cols, off_wchunk, slot):
        off_w_res = w_tap + wc_bytes
        off_bars = off_w_res + w_res + bias
        off_ring = _up(off_bars + 16 * MAX_STAGES, 1024)
        # each consumer group has a ring of its own, of at least two slots
        stages = min(MAX_STAGES, (SMEM_LIMIT - off_ring) // slot) // GROUPS * GROUPS
        if stages < 2 * GROUPS:
            return None
        return PersistPlan(W, mode, 0 if stream else DW, stages, slot, enc_cols, off_wchunk == 0,
                           ld_w, w_tap, off_w_res, off_w_res + w_res, off_bars, off_ring,
                           off_wchunk, off_ring + stages * slot)

    if stream:
        return layout(0, 0, 0, tap)
    es = 4 if f32c else 2
    box_cols = 128 // es
    wc_rows = (lambda k: k * W * 4) if f32c else (lambda k: _up(k, 16) * ld_w * 2)
    enc_cols = min(tap // (TILE_ROWS * es), _up(DW, box_cols))
    plan = layout(_up(wc_rows(DW), 128), enc_cols, 0, tap)
    if plan is not None:
        return plan
    # w_cond too wide to stay: a chunk of one box and its w_cond rows share a slot
    return layout(0, box_cols, BOX, _up(max(tap, BOX + wc_rows(box_cols)), 1024))


def persist_args(plan: PersistPlan, n_rows: int, card_blocks: int) -> dict:
    """The launch fields of FlowArgs for one layer of flow_persist_kernel over
    n_rows rows with ``plan``: the grid (every block the card holds at once,
    ``card_blocks``, cut to the tiles there are) and n_tiles (tiles of
    TILE_ROWS rows, the last one ragged), which the kernel's blocks walk as
    block, block + grid, ..."""
    n_tiles = -(-n_rows // TILE_ROWS)
    return dict(
        grid=min(card_blocks, n_tiles), n_tiles=n_tiles, smem_bytes=plan.smem_bytes,
        stages=plan.stages, slot_bytes=plan.slot_bytes, enc_cols=plan.enc_cols,
        wc_resident=int(plan.wc_resident), off_w_cond=plan.off_w_cond, off_w_res=plan.off_w_res,
        off_bias=plan.off_bias, off_bars=plan.off_bars, off_ring=plan.off_ring,
        off_wchunk=plan.off_wchunk)


WIDE_BOX = WIDE_TILE_ROWS * 128  # bytes of one wide copy box: a tile's rows x 128 bytes


@dataclass(frozen=True)
class WidePlan:
    """The shared-memory layout of flow_wide_kernel for one (width, mode);
    byte offsets as the kernel reads them from FlowArgs.  Shared memory holds
    w_tap^T (W 128 only: 3W / 64 boxes of W rows x 64 K values, 128 B a row,
    in the copy engine's 128-byte swizzle), the biases [2W] f32, the ring's
    barriers (a full and an empty mbarrier a slot, then the resident
    weights' one), then, 1024-byte aligned, the ring: ``stages`` slots of
    ``slot_bytes``, one chunk of a tile each, which both consumer warpgroups
    read.  A tile's chunks: the taps, WIDE_KC f32 columns a chunk (two boxes
    of 32) with, at W 256, its w_tap^T box at 2 WIDE_BOX; the encoding's,
    one box of ``enc_cols`` columns (64 bf16 or 32 f32) with, at
    ``off_wchunk``, its w_cond^T box (bf16) or its enc_cols rows of w_cond
    (f32); then ``res_chunks`` w_res^T boxes, held through the epilogue's
    res product.  w_cond and w_res are never resident, so the layout does
    not depend on the deconv width; a cond stream is read by the epilogue
    from device memory."""

    width: int
    mode: str
    taps_resident: bool
    stages: int
    slot_bytes: int
    enc_cols: int
    res_chunks: int
    off_bias: int
    off_bars: int
    off_ring: int
    off_wchunk: int
    smem_bytes: int
    tile_rows: int = WIDE_TILE_ROWS


def wide_plan(width: int, mode: str, deconv_width: int = 0) -> WidePlan:
    """flow_wide_kernel's layout at ``width`` (128 or 256) in conditioning mode
    ``mode`` (COND_MODES); ``deconv_width``, a multiple of 8 (ignored for a
    cond stream), does not change it.  The ring gets as many slots as fit,
    up to MAX_STAGES."""
    if width not in WIDE_WIDTHS or mode not in COND_MODES:
        raise ValueError(f"no wide plan for width {width}, mode {mode}")
    stream, f32c = mode in ("stream", "stream_f32"), mode == "f32cond"
    if not stream and (deconv_width < 8 or deconv_width % 8):
        raise ValueError(f"deconv width {deconv_width} is not a positive multiple of 8")
    W = width
    rows = W * 128  # a weight box: W rows of 64 bf16 K values
    taps_resident = W == 128
    off_bias = 3 * W // WIDE_KC * rows if taps_resident else 0
    off_bars = off_bias + _up(8 * W, 128)
    off_ring = _up(off_bars + 16 * MAX_STAGES + 8, 1024)
    enc_cols = 32 if f32c else WIDE_KC
    slot = 2 * WIDE_BOX + (0 if taps_resident else rows)
    if not stream:
        slot = max(slot, WIDE_BOX + (enc_cols * W * 4 if f32c else rows))
    stages = min(MAX_STAGES, (SMEM_LIMIT - off_ring) // slot)
    res_chunks = W // 2 // WIDE_KC
    if stages < max(2, res_chunks + 1):
        raise ValueError(f"the wide ring does not fit at width {W}, mode {mode}")
    return WidePlan(W, mode, taps_resident, stages, slot, 0 if stream else enc_cols, res_chunks,
                    off_bias, off_bars, off_ring, WIDE_BOX, off_ring + stages * slot)


def wide_args(plan: WidePlan, n_rows: int, card_blocks: int) -> dict:
    """The launch fields of FlowArgs for one layer of flow_wide_kernel over
    n_rows rows: the grid (the blocks the card holds at once, cut to the
    tiles there are) and n_tiles of WIDE_TILE_ROWS rows, the last one
    ragged, which the blocks walk as block, block + grid, ..."""
    n_tiles = -(-n_rows // WIDE_TILE_ROWS)
    return dict(
        grid=min(card_blocks, n_tiles), n_tiles=n_tiles, smem_bytes=plan.smem_bytes,
        stages=plan.stages, slot_bytes=plan.slot_bytes, enc_cols=plan.enc_cols, wc_resident=0,
        off_w_cond=0, off_w_res=0, off_bias=plan.off_bias, off_bars=plan.off_bars,
        off_ring=plan.off_ring, off_wchunk=plan.off_wchunk)


def _bf(x):
    """Round to bf16 and hold as f32 (a product's operand)."""
    return x.to(torch.bfloat16).float()


def _carry_bf16(carry_dtype):
    if carry_dtype in (None, torch.float32):
        return False
    if carry_dtype == torch.bfloat16:
        return True
    raise ValueError(f"carry_dtype must be None, float32 or bfloat16, got {carry_dtype}")


def check_probe(probe, allow_wrong_output):
    """Refuse an unknown probe, and a probe without allow_wrong_output=True
    (the reference's guard, nsynth_wavenet_tpu/ops/flow_kernel.py:155-159)."""
    if probe is not None and probe not in PROBES:
        raise ValueError(f"unknown probe {probe!r}: want None or one of {PROBES}")
    if probe is not None and not allow_wrong_output:
        raise ValueError(f"probe {probe!r} produces WRONG output by design (perf attribution "
                         "only); pass allow_wrong_output=True to confirm this is not a serving call")


@torch.no_grad()
def flow_stack_plain(x, enc, sw, s, n_layers, num_stages, state=None, compact=True, *,
                     fuse_cond=False, carry_dtype=None, cond=None, probe=None,
                     allow_wrong_output=False):
    """Plain PyTorch version of the kernel (see ``flow_stack``)."""
    check_probe(probe, allow_wrong_output)
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
        taps = [l, l, l] if probe == "no_slide" else [stream[:L], stream[d : d + L], l]
        a = _bf(torch.cat(taps, -1))
        taps = a @ _bf(sw["w_tap"][li].reshape(3 * W, W))
        if cond is not None:
            c = cond[..., i * W : (i + 1) * W]
            pre = taps + (_bf(c) if compact else c.float()) + sw["b"][li].float()
        else:
            w_cond = sw["w_cond"][li].float()
            pre = (taps + enc_op @ (_bf(w_cond) if bf_cond else w_cond)
                   + (sw["b"][li] + sw["b_cond"][li]).float())
        if probe == "no_gate":
            g = torch.clamp(pre[..., :m], 0.0, 1.0) * torch.clamp(pre[..., m:], -1.0, 1.0)
        else:
            g = torch.sigmoid(pre[..., :m]) * torch.tanh(pre[..., m:])
        if state is not None:  # (a view of stream[L:] would keep every layer's stream alive)
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
        "cond_mode", "carry_bf16", "grid", "n_tiles", "smem_bytes", "stages", "slot_bytes", "enc_cols",
        "wc_resident", "off_w_cond", "off_w_res", "off_bias",
        "off_bars", "off_ring", "off_wchunk",
    )]


def _lib(probe=None):
    """The serving library, or with a probe the library of its variants."""
    lib = build.load(build.library_of("flow_kernel", probe))
    if not getattr(lib, "_argtypes_set", False):
        lib.flow_stack.argtypes = [ctypes.POINTER(_FlowArgs), ctypes.POINTER(ctypes.c_int)]
        lib.flow_stack.restype = ctypes.c_int
        lib.flow_persist_info.argtypes = [ctypes.c_int] * 5 + [ctypes.POINTER(ctypes.c_int)]
        lib.flow_persist_attrs.argtypes = [ctypes.c_int] * 4 + [ctypes.POINTER(ctypes.c_int)]
        lib.flow_persist_info.restype = lib.flow_persist_attrs.restype = ctypes.c_int
        lib.flow_error_string.argtypes = [ctypes.c_int]
        lib.flow_error_string.restype = ctypes.c_char_p
        lib._argtypes_set = True
    return lib


def _check(lib, rc):
    if rc != 0:
        raise RuntimeError(f"CUDA flow kernel failed: {lib.flow_error_string(rc).decode()} "
                           f"(cudaError {rc})")


_INFO = {}
_FACTS = ("blocks_per_sm", "sms", "registers", "spill_bytes", "static_smem", "smem_limit",
          "threads", "dynamic_smem")


def _card_facts(fn, width, mode, device, *smem_bytes, probe=None, carry=False):
    """fn(width, mode, carry, *smem_bytes, device, info) of the C side (of
    ``probe``'s library), as a dict."""
    device = torch.device(device)
    if device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    lib = _lib(probe)
    info = (ctypes.c_int * len(_FACTS))()
    _check(lib, getattr(lib, fn)(width, COND_MODES.index(mode), int(carry), *smem_bytes,
                                 device.index, info))
    facts = dict(zip(_FACTS, info))
    if facts["smem_limit"] < SMEM_LIMIT:
        raise RuntimeError(f"the card lets a block opt in to {facts['smem_limit']} bytes of shared "
                           f"memory; persist_plan and wide_plan lay out up to {SMEM_LIMIT}")
    return facts


def launch_info(width, mode, smem_bytes, device, probe=None, carry=False):
    """What the card makes of the trunk kernel of ``width`` (kernel_name) in ``mode``
    (in ``probe``'s variant; with ``carry``, its carry twin, which a call
    with a state launches) with ``smem_bytes`` of dynamic shared memory
    (opted in to here): {blocks_per_sm, sms, registers, spill_bytes (local
    memory a thread), static_smem, smem_limit (the card's opt-in limit a
    block), threads, dynamic_smem}, read from the occupancy API and
    cudaFuncGetAttributes."""
    key = (width, mode, smem_bytes, str(device), probe, carry)
    if key not in _INFO:
        info = _card_facts("flow_persist_info", width, mode, device, smem_bytes, probe=probe,
                           carry=carry)
        if info["blocks_per_sm"] < 1:
            raise RuntimeError(f"{kernel_name(width)} does not fit an SM with {smem_bytes} bytes "
                               "of shared memory")
        _INFO[key] = info
    return dict(_INFO[key])


def launched_facts(width, mode, device, probe=None, carry=False):
    """launch_info's facts of the trunk kernel of ``width`` in ``mode`` (in
    ``probe``'s variant; ``carry``: its carry twin) as the card holds them
    now, setting nothing:
    dynamic_smem is the opt-in its last launch set (cudaFuncGetAttributes'
    maxDynamicSharedSizeBytes), and blocks_per_sm the occupancy at that
    shared memory."""
    return _card_facts("flow_persist_attrs", width, mode, device, probe=probe, carry=carry)


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


def _wide_operands(sw, sl, mode, w_cond, fuse_cond, W):
    """(w_tap^T, w_res^T, the conditioning weights) of layers sl in the wide
    kernel's layout (wide_weights): w_cond^T in bf16, w_cond in the wide
    column order in f32, or None for a stream."""
    nl, bf = sw["w_tap"].shape[0], torch.bfloat16
    want = {"w_tap_t": (bf, (nl, W, 3 * W)), "w_res_t": (bf, (nl, W, W // 2))}
    if w_cond is not None and not fuse_cond:  # fuse_cond's w_cond is rounded at the call
        DW = w_cond.shape[1]
        want.update({"w_cond_t": (bf, (nl, W, DW))} if mode == "bf16" else
                    {"w_cond_w": (torch.float32, (nl, DW, W))})
    for name, (dt, shape) in want.items():
        if name not in sw:
            raise ValueError(f"{name}: the wide kernel (W {W}) reads the wide layout: pass "
                             "compact_weights(sw) or noncompact_weights(sw)")
        _expect(name, sw[name], shape, dt, sw["w_tap"].device)
    if w_cond is not None:
        w_cond = (w_cond.transpose(1, 2).contiguous() if fuse_cond
                  else sw["w_cond_t" if mode == "bf16" else "w_cond_w"][sl])
    return sw["w_tap_t"][sl], sw["w_res_t"][sl], w_cond


def _flow_stack_cuda(x, enc, sw, s, n_layers, num_stages, state=None, compact=True,
                     fuse_cond=False, carry_dtype=None, cond=None, probe=None):
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
    stream = mode in ("stream", "stream_f32")
    w_tap, w_res = sw["w_tap"][sl], sw["w_res"][sl]
    if W in PERSIST_WIDTHS:
        plan = persist_plan(W, mode, 0 if stream else cond_t.shape[-1])
        info = launch_info(W, mode, plan.smem_bytes, dev, probe, state is not None)
        plan_args = persist_args(plan, L * B, info["blocks_per_sm"] * info["sms"])
    else:
        w_tap, w_res, w_cond = _wide_operands(sw, sl, mode, w_cond, fuse_cond, W)
        plan = wide_plan(W, mode, 0 if stream else cond_t.shape[-1])
        info = launch_info(W, mode, plan.smem_bytes, dev, probe, state is not None)
        plan_args = wide_args(plan, L * B, info["blocks_per_sm"] * info["sms"])
    args = _FlowArgs(
        x=x.data_ptr(), cond=cond_t.data_ptr(), w_tap=w_tap.data_ptr(),
        w_cond=None if w_cond is None else w_cond.data_ptr(), bias=bias.data_ptr(),
        w_res=w_res.data_ptr(), b_res=sw["b_res"][sl].data_ptr(),
        state=None if state is None else state.data_ptr(),
        new_state=None if new_state is None else new_state.data_ptr(),
        tmp=None if tmp is None else tmp.data_ptr(), out=out.data_ptr(),
        stream=torch.cuda.current_stream(dev).cuda_stream,
        device=dev.index, L=L, B=B, W=W, cond_cols=cond_t.shape[-1], n_layers=n_layers,
        first_layer=s, num_stages=num_stages, cond_mode=COND_MODES.index(mode),
        carry_bf16=int(carry_bf16), **plan_args,
    )
    lib = _lib(probe) if probe else _lib()
    launched = (ctypes.c_int * len(KERNEL_NAMES))()
    rc = lib.flow_stack(ctypes.byref(args), launched)
    # a probe call's launches apart from the serving counts, which no probe call may meet
    counts = flow_stack.kernel_launches if probe is None else flow_stack.launches_by_probe[probe]
    for name, n in zip(KERNEL_NAMES, launched):
        counts[name] += n
    _check(lib, rc)
    flow_stack.last_launch = dict(kernel=kernel_name(W), width=W, mode=mode, probe=probe,
                                  carry=state is not None, tile_rows=plan.tile_rows, **plan_args)
    if probe is None:
        flow_stack.launches += 1
        key = mode_key(mode, W)
        flow_stack.launches_by_mode[key] = flow_stack.launches_by_mode.get(key, 0) + 1
    # x, the conditioning, the weights and tmp stay referenced until the
    # launches are enqueued; the caching allocator reuses their memory in
    # stream order only
    return out if state is None else (out, new_state)


def flow_stack(x, enc, sw, s, n_layers, num_stages, state=None, compact=True, *,
               fuse_cond=False, carry_dtype=None, cond=None, probe=None, allow_wrong_output=False):
    """Layers s .. s + n_layers - 1 of one flow's trunk over a whole stream.

    x [L, B, W] f32 residual stream (time-major); enc [L, B, DW] the deconv
    encoding, bf16 when compact, f32 otherwise (either under fuse_cond), or
    None with a cond stream [L, B, n_layers * W] (bf16 when compact, else
    f32) whose columns already hold each layer's mel-cond projection and
    b_cond.  sw: stack_flow_weights output for the flow (through
    compact_weights or noncompact_weights for the card).  state
    [state_rows, B, W] f32 (or bf16 with bf16 carries) or None.  Returns l
    [L, B, W] f32, and with a state (l, new_state).  Any B >= 1, L >= 1 and
    n_layers >= 1.  CUDA tensors run the CUDA kernels (widths in WIDTHS, a
    deconv width that is a multiple of 8), picked by width alone: every layer
    is one launch of flow_persist_kernel at W 32 and 64 and of
    flow_wide_kernel at W 128 and 256 (which read the wide layout that
    compact_weights / noncompact_weights add); with a state the same launch
    also writes the layer's new history (the kernel's carry twin, counted
    under its name); flow_stack.kernel_launches counts them by name where
    they are enqueued.  CPU tensors run the plain version.
    probe (PERF ATTRIBUTION ONLY, the output is wrong; see the module's
    docstring): "no_gate" or "no_slide", with allow_wrong_output=True on
    every device, as the reference demands."""
    check_probe(probe, allow_wrong_output)
    if x.device.type == "cuda":
        return _flow_stack_cuda(x, enc, sw, s, n_layers, num_stages, state, compact, fuse_cond,
                                carry_dtype, cond, probe)
    if x.device.type == "cpu":
        return flow_stack_plain(x, enc, sw, s, n_layers, num_stages, state, compact,
                                fuse_cond=fuse_cond, carry_dtype=carry_dtype, cond=cond,
                                probe=probe, allow_wrong_output=allow_wrong_output)
    raise ValueError(f"unsupported device {x.device}")


flow_stack.launches = 0
# CUDA launches by kernel name (KERNEL_NAMES), counted where the C entry point enqueues them
flow_stack.kernel_launches = dict.fromkeys(KERNEL_NAMES, 0)
# by mode_key: the conditioning mode, "_w<width>" appended for widths other than 64
flow_stack.launches_by_mode = {mode_key(m, w): 0 for w in WIDTHS for m in COND_MODES}
# a probe call's CUDA launches, by probe and kernel name; a probe call adds to no count above
flow_stack.launches_by_probe = {probe: dict.fromkeys(KERNEL_NAMES, 0) for probe in PROBES}
# FlowArgs' launch fields of the last call (persist_args or wide_args), with the
# kernel, width, mode, probe and tile rows, as flow_stack handed them to the C entry point
flow_stack.last_launch = None
