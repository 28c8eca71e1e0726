"""The host-side launch plan of the CUDA flow-stack kernels (ops/flow_kernel.py):
the persistent kernel's shared-memory layout at W 32 and 64 in every
conditioning mode, the tiles it walks over ragged streams, the dispatch by width,
and the launches a call enqueues.  CPU only, no card and no nvcc."""

import numpy as np
import pytest

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


@pytest.mark.parametrize("width", flk.WIDTHS)
def test_dispatch_is_by_width(width):
    want = "flow_persist_kernel" if width in (32, 64) else "flow_layer_kernel"
    assert flk.kernel_name(width) == want
    if width in flk.PERSIST_WIDTHS:
        assert flk.persist_plan(width, "bf16", 256).width == width
    else:
        with pytest.raises(ValueError):
            flk.persist_plan(width, "bf16", 256)


@pytest.mark.parametrize("with_state", [False, True])
@pytest.mark.parametrize("n_layers", [1, 10, 30])
@pytest.mark.parametrize("width", flk.WIDTHS)
def test_predicted_launches_a_call(width, n_layers, with_state):
    got = flk.predicted_launches(width, n_layers, with_state)
    assert set(got) == set(flk.KERNEL_NAMES) == set(flk.flow_stack.kernel_launches)
    assert got[flk.kernel_name(width)] == n_layers
    assert got["flow_state_kernel"] == (n_layers if with_state else 0)
    assert sum(got.values()) == n_layers * (2 if with_state else 1)


def test_kernel_is_compiled_with_the_plan_constants():
    assert build.defines("flow_kernel") == [f"-DFLOW_WARPS={flk.WARPS}",
                                            f"-DFLOW_GROUPS={flk.GROUPS}",
                                            f"-DFLOW_TILE_ROWS={flk.TILE_ROWS}"]
    assert build.defines("fastgen_kernel") == []
    src = (build.CSRC / "flow_kernel.cu").read_text()
    assert all(n in src for n in ("FLOW_WARPS", "FLOW_GROUPS", "FLOW_TILE_ROWS"))
    # the launch fields of the plan are fields of the C struct, in the same order
    fields = [f for f, _ in flk._FlowArgs._fields_]
    assert fields.index("grid") + 1 == fields.index("n_tiles")
    assert set(flk.persist_args(flk.persist_plan(64, "bf16", 256), 1000, 132)) <= set(fields)


def test_plan_refuses_what_the_kernel_does_not_take():
    with pytest.raises(ValueError):
        flk.persist_plan(64, "bf16", 100)  # not a multiple of 8
    with pytest.raises(ValueError):
        flk.persist_plan(64, "nope", 256)
