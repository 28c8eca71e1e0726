"""The persistent generation kernel's work table (ops/fastgen_kernel.py
schedule), checked on the host: every product of a step is covered exactly
once, no gate slice straddles two sums that dequantise apart, and a block's
shared memory fits the card.  No card and no JAX needed; each case runs in
milliseconds."""

import itertools
import os

import numpy as np
import pytest

from nsynth_wavenet_tpu_torch import config as tconfig
from nsynth_wavenet_tpu_torch.ops import fastgen_kernel as fk

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = [os.path.join("configs", f"wavenet_{h}.json") for h in ("mol", "ce", "gauss")]
CONFIGS += [os.path.join("tests", "golden", f"tiny_{h}", "meta.json") for h in ("mol", "ce", "gauss")]
BATCHES = (1, 3, 8, 64, 512, 896)
GRIDS = (None, 132, 264)  # one block an item; one or two blocks on each of an H100's 132 SMs
MODES = list(itertools.product(("bf16", "static", "row"), repeat=2))


def _decode(table):
    """The kernel's reading of the table: items per phase and the slices' segments."""
    counts = dict(zip(("gate", "nsplit", "skip0", "rs", "out1", "out2"), table[:6]))
    pos, items = fk.HDR, {}
    for ph in fk.PHASES:
        n = counts[ph]
        items[ph] = [tuple(table[pos + fk.ITEM * i : pos + fk.ITEM * (i + 1)]) for i in range(n)]
        pos += fk.ITEM * n
    assert table[6] == pos
    return items, table[pos : pos + counts["nsplit"]]


@pytest.mark.parametrize("path,mode", list(itertools.product(CONFIGS, MODES)))
def test_schedule_covers_every_product_once(path, mode):
    cfg = tconfig.load_config(os.path.join(REPO, path))
    W, GW, S, DW = cfg.width, cfg.gate_width, cfg.skip_width, cfg.deconv_width
    m, N, K = GW // 2, W + S, 3 * W + DW
    _, out_pad = fk.head_layout(cfg)
    act, rs = mode
    for B, grid in itertools.product(BATCHES, GRIDS):
        sc = fk.schedule(W, GW, S, DW, out_pad, B, act, rs, grid=grid)
        items, segs = _decode(sc.table)
        assert items == {ph: list(v) for ph, v in sc.items.items()} and segs == sc.slice_segment
        assert len(sc.table) <= fk.TABLE_WORDS
        n_rt = sc.row_tiles
        assert (n_rt - 1) * fk.TILE_ROWS < B <= n_rt * fk.TILE_ROWS

        # every (row tile, 64-deep K chunk, column item) of each product, counted
        # over the items that compute it; a gate column item is GATE_COLS
        # sigmoid columns and the tanh columns m apart
        gc = fk.GATE_COLS
        shapes = {"gate": (K, m, gc), "skip0": (W, S, fk.BN), "rs": (m, N, fk.RS_COLS),
                  "out1": (S + DW, S, fk.BN), "out2": (S, out_pad, fk.BN)}
        for ph, (k_all, n_all, width) in shapes.items():
            hits = np.zeros((n_rt, k_all // fk.KC, n_all // width), np.int32)
            for ct, k0, k1, z, r0, r1 in items[ph]:
                assert 0 <= k0 < k1 <= k_all and (k1 - k0) % fk.KC == 0, (ph, k0, k1)
                assert 0 <= r0 < r1 <= n_rt and 0 <= ct < n_all // width, (ph, ct, r0, r1)
                if ph == "skip0" or grid is None:  # every row: one block reads a weight byte
                    assert (r0, r1) == (0, n_rt)
                hits[r0:r1, k0 // fk.KC : k1 // fk.KC, ct] += 1
            assert (hits == 1).all(), f"{path} {mode} B={B}: {ph} covered {hits.min()}..{hits.max()} times"
            if grid is not None and ph != "skip0":  # rows cut only where blocks would idle
                per_group = len({it[:4] for it in items[ph]})
                assert len(items[ph]) <= max(grid, per_group)

        # gate slices: inside one segment, the one the table names; every
        # (column item, row group) has the same slices in the same order (the
        # reduction's), as consecutive items (the kernel's meeting needs that)
        bounds = fk.gate_segments(W, DW, act)
        assert bounds[0][0] == 0 and bounds[-1][1] == K
        assert len(bounds) == {"bf16": 1, "static": 2, "row": 4}[act]
        for ct, k0, k1, z, _, _ in items["gate"]:
            lo, hi = bounds[segs[z]]
            span = fk.gate_spans(W, DW, act)[segs[z]]
            assert lo <= k0 and k1 <= hi and k1 - k0 <= span, (k0, k1, bounds[segs[z]])
        per_tile = {}
        for ct, k0, k1, z, r0, r1 in items["gate"]:
            per_tile.setdefault((ct, r0, r1), []).append((z, k0, k1))
        assert len({tuple(v) for v in per_tile.values()}) == 1
        assert [z for z, _, _ in next(iter(per_tile.values()))] == list(range(len(segs)))
        keys = [(ct, r0, r1) for ct, _, _, _, r0, r1 in items["gate"]]
        assert all(keys[i] == keys[i - i % len(segs)] for i in range(len(keys)))

        # shared memory: each item's weight slice fits a stage, and the block fits the card
        def slice_bytes(ph, k0, k1):
            int8 = (ph == "gate" and act != "bf16") or (ph == "rs" and rs != "bf16")
            groups = {"gate": gc // 8, "rs": fk.RS_COLS // fk.BN}.get(ph, 1)
            rows = (k1 - k0) // 4 if int8 else k1 - k0
            return rows * (groups * fk.BN + 8) * (4 if int8 else 2) + (fk.GATE_CONST_BYTES if ph == "gate" else 0)

        biggest = max(slice_bytes(ph, it[1], it[2]) for ph in fk.PHASES for it in items[ph])
        assert biggest <= sc.stage_bytes and sc.stage_bytes % 128 == 0
        assert sc.slot_bytes >= fk.TILE_ROWS * (fk.KC * 2 + 16)  # 128 operand bytes a row
        assert sc.smem_bytes <= fk.SMEM_LIMIT, (path, mode, B, sc.smem_bytes)
        assert sc.counters == m // gc * n_rt
        assert sc.part_words == sc.counters * len(segs) * fk.TILE_ROWS * 2 * gc


@pytest.mark.parametrize("mode", MODES)
def test_launch_plan_checks_the_table_it_launches(mode, monkeypatch):
    """launch_plan sizes shared memory by the table cut for the grid it
    launches; the bf16 and static modes take any batch, each per-row scale
    costs two [B] f32 arrays of shared memory and so caps the batch."""
    cfg = tconfig.load_config(os.path.join(REPO, CONFIGS[0]))
    dims = (cfg.width, cfg.gate_width, cfg.skip_width, cfg.deconv_width, fk.head_layout(cfg)[1])
    asked = []

    def launch_info(m, smem_bytes, device):  # an H100: one block on each of 132 SMs
        asked.append(smem_bytes)
        return {"grid": 132, "blocks_per_sm": 1, "sms": 132}

    monkeypatch.setattr(fk, "launch_info", launch_info)
    act, rs = mode
    per_row = 2 * (act == "row") + 2 * (rs == "row")
    rest = set()  # beside the table and the row arrays, a block's shared memory does not grow with B
    for B in (1, 896, 1792, 4096, 16384):
        launched = fk.schedule(*dims, B, act, rs, grid=132)
        if B > fk.TILE_ROWS:
            rest.add(launched.smem_bytes - 4 * len(launched.table) - 4 * per_row * B)
        if launched.smem_bytes <= fk.SMEM_LIMIT:
            sched, info = fk.launch_plan(*dims, B, fk.Mode(act, rs), "cuda")
            assert sched == launched and info["grid"] == 132 and asked[-1] == launched.smem_bytes
        else:
            with pytest.raises(ValueError, match="shared memory"):
                fk.launch_plan(*dims, B, fk.Mode(act, rs), "cuda")
        # every batch without a per-row scale; with them twice the shipped 896, not 16384
        fits = launched.smem_bytes <= fk.SMEM_LIMIT
        if per_row == 0 or B <= 1792:
            assert fits, (mode, B, launched.smem_bytes)
        if per_row and B == 16384:
            assert not fits, (mode, B, launched.smem_bytes)
    assert len(rest) == 1
