"""The host-side launch plan of the CUDA flow-stack kernels (ops/flow_kernel.py):
the persistent kernel's shared-memory layout at W 32 and 64 and the wide
kernel's at W 128 and 256 in every conditioning mode, the tiles they walk over
ragged streams, the wide kernel's weight layout, the dispatch by width, and
the launches a call enqueues.  CPU only, no card and no nvcc."""

import numpy as np
import pytest
import torch

from nsynth_wavenet_tpu_torch.kernels import build
from nsynth_wavenet_tpu_torch.ops import flow_kernel as flk

SMEM_227_KB = 227 * 1024


@pytest.mark.parametrize("deconv_width", [8, 136, 256, 1024, 4096])
@pytest.mark.parametrize("mode", flk.COND_MODES)
@pytest.mark.parametrize("width", flk.PERSIST_WIDTHS)
def test_persist_plan_fits_shared_memory(width, mode, deconv_width):
    p = flk.persist_plan(width, mode, deconv_width)
    assert p.smem_bytes <= SMEM_227_KB == flk.SMEM_LIMIT
    # each consumer group has a ring of its own, of at least two slots
    assert 2 * flk.GROUPS <= p.stages <= flk.MAX_STAGES and p.stages % flk.GROUPS == 0
    assert p.tile_rows == flk.TILE_ROWS == 16 * flk.WARPS // flk.GROUPS
    # regions in order, 128-byte aligned, the ring last and 1024-byte aligned
    # (the copy engine's 128-byte swizzle repeats every 8 rows of 128 B)
    offs = [0, p.off_w_cond, p.off_w_res, p.off_bias, p.off_bars, p.off_ring]
    assert offs == sorted(offs) and all(o % 128 == 0 for o in offs)
    assert p.off_ring % 1024 == 0 and p.slot_bytes % 1024 == 0 and flk.BOX % 1024 == 0
    assert p.smem_bytes == p.off_ring + p.stages * p.slot_bytes
    W = width
    assert p.off_w_cond >= 3 * W * p.ld_w * 2 and p.off_bias - p.off_w_res >= W // 2 * p.ld_w * 2
    assert p.off_bars - p.off_bias >= 2 * W * 4
    assert p.off_ring - p.off_bars >= 2 * 8 * p.stages  # a full and an empty mbarrier a slot
    # ldmatrix rows in distinct bank groups: 128-byte rows swizzled at W 64, padded rows at W 32
    assert p.ld_w == W if W == 64 else (p.ld_w > W and (p.ld_w * 2 // 16) % 2 == 1)
    # every chunk fits its slot: a tap (W / 32 boxes of f32) or a cond-stream chunk ...
    assert p.tile_rows * W * 4 == (W // 32) * flk.BOX <= p.slot_bytes
    if mode in ("stream", "stream_f32"):
        es = 4 if mode == "stream_f32" else 2
        assert -(-W * es // 128) * flk.BOX <= p.slot_bytes
        return
    # ... and an encoding chunk of whole boxes, with its w_cond rows when they are not resident
    f32 = mode == "f32cond"
    es = 4 if f32 else 2
    box_cols = 128 // es
    assert p.enc_cols >= box_cols and p.enc_cols % box_cols == 0
    enc_bytes = p.enc_cols // box_cols * flk.BOX
    wc_rows = (lambda k: k * W * 4) if f32 else (lambda k: -(-k // 16) * 16 * p.ld_w * 2)
    if p.wc_resident:
        assert p.off_wchunk == 0 and enc_bytes <= p.slot_bytes
        assert p.off_w_res - p.off_w_cond >= wc_rows(deconv_width)
        assert p.enc_cols <= max(box_cols, -(-deconv_width // box_cols) * box_cols)
    else:
        assert p.off_w_res == p.off_w_cond and enc_bytes <= p.off_wchunk
        assert p.off_wchunk + wc_rows(p.enc_cols) <= p.slot_bytes


@pytest.mark.parametrize("mode", flk.COND_MODES)
def test_persist_plan_keeps_the_main_path_weights_resident(mode):
    """At the student's own shapes (W 64, deconv width 256) every weight stays
    in shared memory and the ring has at least three slots."""
    p = flk.persist_plan(64, mode, 256)
    assert p.wc_resident and p.stages >= 4


@pytest.mark.parametrize("grid", [1, 132, 264])
@pytest.mark.parametrize("B", [1, 3, 32, 896])
@pytest.mark.parametrize("L", [1, 1000, 64000])
def test_tile_walk_covers_every_row_once(L, B, grid):
    """The grid and n_tiles that the wrapper hands the kernel (persist_args,
    with ``grid`` blocks on the card at once): tiles of TILE_ROWS rows, the
    last one ragged, cover rows [0, L * B) once, and every block of the grid
    has a tile to start its walk on."""
    n_rows = L * B
    args = flk.persist_args(flk.persist_plan(64, "bf16", 256), n_rows, grid)
    n_tiles, T = args["n_tiles"], flk.TILE_ROWS
    assert (n_tiles - 1) * T < n_rows <= n_tiles * T
    assert 1 <= args["grid"] == min(grid, n_tiles) <= n_tiles
    starts = np.arange(n_tiles) * T
    ends = np.minimum(starts + T, n_rows)
    assert np.all(ends > starts) and np.array_equal(starts[1:], ends[:-1])
    assert starts[0] == 0 and ends[-1] == n_rows and int((ends - starts).sum()) == n_rows


@pytest.mark.parametrize("deconv_width", [8, 136, 256, 1024, 4096])
@pytest.mark.parametrize("mode", flk.COND_MODES)
@pytest.mark.parametrize("width", flk.WIDE_WIDTHS)
def test_wide_plan_fits_shared_memory(width, mode, deconv_width):
    p = flk.wide_plan(width, mode, deconv_width)
    W, box, rows = width, flk.WIDE_BOX, width * 128  # rows: a weight box, W rows of 128 B
    assert p.smem_bytes <= SMEM_227_KB == flk.SMEM_LIMIT
    assert p.smem_bytes == p.off_ring + p.stages * p.slot_bytes
    assert 2 <= p.stages <= flk.MAX_STAGES
    # two 64-row wgmma bands, one a consumer warpgroup; a chunk's K is one 128-byte row of bf16
    assert p.tile_rows == flk.WIDE_TILE_ROWS == 64 * (flk.WARPS // 4) and flk.WIDE_KC == 64
    # resident w_tap^T (W 128 only), then biases, barriers, and the ring,
    # 1024-byte aligned as the copy engine's 128-byte swizzle needs
    assert p.taps_resident == (W == 128)
    assert p.off_bias == (3 * W // 64 * rows if p.taps_resident else 0)
    assert p.off_bars - p.off_bias >= 2 * W * 4
    assert p.off_ring - p.off_bars >= 16 * p.stages + 8  # full and empty a slot, the weights'
    assert all(o % 1024 == 0 for o in (p.off_bias, p.off_ring, p.slot_bytes, box, rows))
    # a tap chunk: two boxes of 32 f32 columns, and at W 256 its w_tap^T box;
    # a w_res^T chunk: one box; the epilogue holds the res_chunks of a tile
    # while the ring keeps a slot for the producer
    assert 2 * box + (0 if p.taps_resident else rows) <= p.slot_bytes
    assert p.res_chunks == W // 2 // 64 and rows <= p.slot_bytes
    assert p.stages >= p.res_chunks + 1
    if mode in ("stream", "stream_f32"):
        assert p.enc_cols == 0
        return
    # an encoding chunk: one box of enc_cols columns and, at off_wchunk, its
    # w_cond^T box (bf16) or its enc_cols rows of w_cond (f32)
    f32 = mode == "f32cond"
    assert p.enc_cols == (32 if f32 else 64) and p.enc_cols * (4 if f32 else 2) == 128
    assert p.off_wchunk == box
    assert p.off_wchunk + (p.enc_cols * W * 4 if f32 else rows) <= p.slot_bytes


@pytest.mark.parametrize("width", flk.WIDE_WIDTHS)
def test_wide_plan_does_not_depend_on_the_deconv_width(width):
    plans = {flk.wide_plan(width, "bf16", dw) for dw in (8, 136, 256, 4096)}
    assert len(plans) == 1
    assert flk.wide_plan(width, "stream", 0) == flk.wide_plan(width, "stream", 256)


@pytest.mark.parametrize("grid", [1, 132, 264])
@pytest.mark.parametrize("B", [1, 3, 32, 896])
@pytest.mark.parametrize("L", [1, 1000, 64000])
def test_wide_tile_walk_covers_every_row_once(L, B, grid):
    """wide_args' grid and n_tiles, walked as the wide kernel's blocks walk
    them (block b takes tiles b, b + grid, ...): every row once, every block
    of the grid has a tile, and the tiles of a block are in row order."""
    n_rows = L * B
    args = flk.wide_args(flk.wide_plan(256, "bf16", 256), n_rows, grid)
    n_tiles, T = args["n_tiles"], flk.WIDE_TILE_ROWS
    assert (n_tiles - 1) * T < n_rows <= n_tiles * T
    assert 1 <= args["grid"] == min(grid, n_tiles) <= n_tiles
    # (block, first row, rows) of every tile in the order the blocks walk them
    walk = [(b, t * T, min(T, n_rows - t * T)) for b in range(args["grid"])
            for t in range(b, n_tiles, args["grid"])]
    covered = np.zeros(n_rows, np.int32)
    for _, row0, rows in walk:
        assert 0 < rows <= T
        covered[row0 : row0 + rows] += 1
    assert np.all(covered == 1)
    assert {b for b, _, _ in walk} == set(range(args["grid"]))
    for b in range(args["grid"]):
        starts = [r for bb, r, _ in walk if bb == b]
        assert starts == sorted(starts) and starts[0] == b * T


def _stacked(nl, W, DW, seed):
    """Random weights in stack_flow_weights' layout, f32."""
    rng = np.random.RandomState(seed)
    return {k: torch.from_numpy(rng.randn(*shape).astype(np.float32)) for k, shape in (
        ("w_tap", (nl, 3, W, W)), ("b", (nl, W)), ("w_cond", (nl, DW, W)), ("b_cond", (nl, W)),
        ("w_res", (nl, W // 2, W)), ("b_res", (nl, W)))}


@pytest.mark.parametrize("width", flk.WIDE_WIDTHS)
def test_wide_weights_round_trip_to_the_stacked_layout(width):
    """The layout wide_weights adds (w_tap^T, w_res^T, w_cond^T in bf16 or
    w_cond in wide_cond_order in f32) carries exactly the numbers of
    stack_flow_weights' layout through compact_weights / noncompact_weights."""
    nl, W = 3, width
    sw = _stacked(nl, W, 136, seed=width)
    cw, nw = flk.compact_weights(sw), flk.noncompact_weights(sw)
    for wts in (cw, nw):
        assert wts["w_tap_t"].shape == (nl, W, 3 * W) and wts["w_tap_t"].is_contiguous()
        assert torch.equal(wts["w_tap_t"].transpose(1, 2).reshape(nl, 3, W, W), wts["w_tap"])
        assert wts["w_res_t"].shape == (nl, W, W // 2) and wts["w_res_t"].is_contiguous()
        assert torch.equal(wts["w_res_t"].transpose(1, 2), wts["w_res"])
        assert wts["w_tap_t"].dtype == wts["w_res_t"].dtype == torch.bfloat16
    assert "w_cond_w" not in cw and torch.equal(cw["w_cond_t"].transpose(1, 2), cw["w_cond"])
    assert "w_cond_t" not in nw and nw["w_cond_w"].dtype == torch.float32
    order = flk.wide_cond_order(W)
    assert sorted(order.tolist()) == list(range(W))
    back = torch.empty_like(nw["w_cond_w"])
    back[..., order] = nw["w_cond_w"]
    assert torch.equal(back, sw["w_cond"])
    # a thread (t = lane % 4) finds, at 16 j + 4 t, columns 8 (2j) + 2t, + 1 and 8 (2j + 1) + 2t, + 1
    for j in range(W // 16):
        for t in range(4):
            assert order[16 * j + 4 * t : 16 * j + 4 * t + 4].tolist() == [
                16 * j + 2 * t, 16 * j + 2 * t + 1, 16 * j + 8 + 2 * t, 16 * j + 9 + 2 * t]
    # the narrower widths keep the stacked layout alone
    assert set(flk.compact_weights(_stacked(nl, 32, 136, seed=1))) == set(sw)


@pytest.mark.parametrize("width", flk.WIDTHS)
def test_dispatch_is_by_width(width):
    want = "flow_persist_kernel" if width in (32, 64) else "flow_wide_kernel"
    assert flk.kernel_name(width) == want
    if width in flk.PERSIST_WIDTHS:
        assert flk.persist_plan(width, "bf16", 256).width == width
        with pytest.raises(ValueError):
            flk.wide_plan(width, "bf16", 256)
    else:
        assert flk.wide_plan(width, "bf16", 256).width == width
        with pytest.raises(ValueError):
            flk.persist_plan(width, "bf16", 256)


@pytest.mark.parametrize("with_state", [False, True])
@pytest.mark.parametrize("n_layers", [1, 10, 30])
@pytest.mark.parametrize("width", flk.WIDTHS)
def test_predicted_launches_a_call(width, n_layers, with_state):
    """One trunk launch a layer, with a state or without: the state copy is
    folded into the layer's trunk launch (its carry twin), so no kernel of
    its own is counted."""
    got = flk.predicted_launches(width, n_layers, with_state)
    assert set(got) == set(flk.KERNEL_NAMES) == set(flk.flow_stack.kernel_launches)
    assert got[flk.kernel_name(width)] == n_layers
    assert "flow_state_kernel" not in got
    assert sum(got.values()) == n_layers


def test_kernel_is_compiled_with_the_plan_constants():
    assert build.defines("flow_kernel") == [f"-DFLOW_WARPS={flk.WARPS}",
                                            f"-DFLOW_GROUPS={flk.GROUPS}",
                                            f"-DFLOW_TILE_ROWS={flk.TILE_ROWS}",
                                            f"-DFLOW_WIDE_TILE_ROWS={flk.WIDE_TILE_ROWS}",
                                            f"-DFLOW_WIDE_KC={flk.WIDE_KC}"]
    assert build.defines("fastgen_kernel") == []
    src = (build.CSRC / "flow_kernel.cu").read_text()
    assert all(n in src for n in ("FLOW_WARPS", "FLOW_GROUPS", "FLOW_TILE_ROWS",
                                  "FLOW_WIDE_TILE_ROWS", "FLOW_WIDE_KC"))
    # the launch fields of the plan are fields of the C struct, in the same order
    fields = [f for f, _ in flk._FlowArgs._fields_]
    assert fields.index("grid") + 1 == fields.index("n_tiles")
    assert set(flk.persist_args(flk.persist_plan(64, "bf16", 256), 1000, 132)) <= set(fields)
    assert set(flk.wide_args(flk.wide_plan(128, "bf16", 256), 1000, 132)) <= set(fields)


def test_plan_refuses_what_the_kernel_does_not_take():
    with pytest.raises(ValueError):
        flk.persist_plan(64, "bf16", 100)  # not a multiple of 8
    with pytest.raises(ValueError):
        flk.persist_plan(64, "nope", 256)
    with pytest.raises(ValueError):
        flk.wide_plan(128, "f32cond", 100)
    with pytest.raises(ValueError):
        flk.wide_plan(256, "nope", 256)


class _FakeLib:
    """The C entry point, recorded: flow_stack's FlowArgs, one trunk launch a layer."""

    def __init__(self):
        self.args = None

    def flow_stack(self, args, launched):
        self.args = args._obj
        launched[flk.KERNEL_NAMES.index("flow_wide_kernel")] += self.args.n_layers
        return 0


@pytest.mark.parametrize("mode", ["bf16", "f32cond", "fuse_cond", "stream", "stream_f32"])
@pytest.mark.parametrize("width", flk.WIDE_WIDTHS)
def test_wide_wrapper_hands_the_kernel_its_plan_and_layout(width, mode, monkeypatch):
    """The CUDA wrapper at W 128 / 256, the C library and the card replaced by
    a recorder (CPU tensors): FlowArgs carries wide_args' fields and the
    wide layout's pointers for the layers of the call, and a weight dict
    without the wide layout is refused."""
    nl, W, DW, L, B = 4, width, 136, 50, 3
    sw = _stacked(nl, W, DW, seed=W)
    wts = flk.compact_weights(sw) if mode in ("bf16", "stream") else flk.noncompact_weights(sw)
    kw = {"compact": mode in ("bf16", "stream"), "fuse_cond": mode == "fuse_cond"}
    rng = np.random.RandomState(0)
    x = torch.from_numpy(rng.randn(L, B, W).astype(np.float32))
    enc = torch.from_numpy(rng.randn(L, B, DW).astype(np.float32))
    if mode == "bf16":
        enc = enc.to(torch.bfloat16)
    cond = None
    if mode.startswith("stream"):
        cond, enc = torch.from_numpy(rng.randn(L, B, 2 * W).astype(np.float32)), None
        cond = cond.to(torch.bfloat16) if mode == "stream" else cond
    lib = _FakeLib()
    monkeypatch.setattr(flk, "_lib", lambda: lib)
    monkeypatch.setattr(flk, "launch_info", lambda *a: {"blocks_per_sm": 1, "sms": 132})
    monkeypatch.setattr(torch.cuda, "current_stream", lambda d: type("S", (), {"cuda_stream": 0}))
    args = flk._FlowArgs
    monkeypatch.setattr(flk, "_FlowArgs", lambda **f: args(**dict(f, device=0)))
    before = dict(flk.flow_stack.kernel_launches)
    flk._flow_stack_cuda(x, enc, wts, 1, 2, 10, cond=cond, **kw)
    a, kernel_mode = lib.args, "bf16" if mode == "fuse_cond" else mode
    plan = flk.wide_plan(W, kernel_mode, 0 if cond is not None else DW)
    for name, value in flk.wide_args(plan, L * B, 132).items():
        assert getattr(a, name) == value, name
    assert (a.W, a.n_layers, a.first_layer, a.cond_mode) == (W, 2, 1,
                                                             flk.COND_MODES.index(kernel_mode))
    assert a.w_tap == wts["w_tap_t"][1:3].data_ptr() and a.w_res == wts["w_res_t"][1:3].data_ptr()
    if mode == "bf16":
        assert a.w_cond == wts["w_cond_t"][1:3].data_ptr()
    elif mode == "f32cond":
        assert a.w_cond == wts["w_cond_w"][1:3].data_ptr()
    elif cond is not None:
        assert a.w_cond is None and a.cond_cols == 2 * W
    got = {k: n - before[k] for k, n in flk.flow_stack.kernel_launches.items()}
    assert got == flk.predicted_launches(W, 2, False)
    assert flk.flow_stack.last_launch["kernel"] == "flow_wide_kernel"
    with pytest.raises(ValueError, match="wide layout"):
        flk._flow_stack_cuda(x, enc, {k: v for k, v in wts.items() if not k.endswith("_t")}, 1,
                             2, 10, cond=cond, **kw)
