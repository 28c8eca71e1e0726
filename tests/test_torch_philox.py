"""The port's Philox uniform generator (ops/fastgen_kernel.py philox_uniform,
csrc/fastgen_kernel.cu philox_uniform_kernel) on the CPU, no card and no nvcc.

The kernel cannot run here, so what it computes is held piece by piece: the
round keys the host hands it, its restructured arithmetic (rounds 1-3 split
into lane and row words, rounds 8-10 cut to what word 0 needs) as a torch
mirror against philox_bits, its walk over the output as its plan gives it,
the wrapper's arguments and refusals against a recorded library, the
uniform against the JAX package's, and the stream against the gates of the
TPU's PRNG check (benchmarks/tpu_kernel_parity.py check_prng).
"""

import re
import struct
from fractions import Fraction

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nsynth_wavenet_tpu.ops import fastgen_kernel as jfk
from nsynth_wavenet_tpu_torch.kernels import build
from nsynth_wavenet_tpu_torch.ops import fastgen_kernel as fk

M0, M1 = 0xD2511F53, 0xCD9E8D57
M32 = fk.M32
SEEDS = [0, 7, -1, 2**32 + 5, -(2**40)]


@pytest.fixture(autouse=True)
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _counters(seed):
    rng = np.random.RandomState(seed)
    return [torch.from_numpy(rng.randint(0, 2**32, size=512, dtype=np.uint64).astype(np.int64))
            for _ in range(4)]


@pytest.mark.parametrize("seed", SEEDS)
def test_round_keys_give_philox_bits(seed):
    """A Philox4x32-10 that takes its ten round keys from philox_round_keys
    equals philox_bits, which bumps the key as it goes, on random counters."""
    c0, c1, c2, c3 = _counters(1)
    want = fk.philox_bits(c0, c1, c2, c3, seed)
    keys = fk.philox_round_keys(seed)
    assert len(keys) == 10 and keys[0] == (seed & M32, (seed >> 32) & M32)
    for k0, k1 in keys:
        hi0, lo0 = fk._mulhilo(c0, M0)
        hi1, lo1 = fk._mulhilo(c2, M1)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    assert torch.equal(c0, want)


def _host_words(seed, t, draw):
    """The words the C entry philox_uniform folds for the kernel (PhiloxArgs)."""
    keys = fk.philox_round_keys(seed)
    p = M1 * t
    return keys, (p >> 32) ^ keys[0][0], (p & M32) ^ keys[1][0], draw ^ keys[0][1]


def _kernel_arithmetic(lane, row, seed, t, draw):
    """Word 0 as philox_uniform_kernel forms it, in torch integer ops: lane
    words L1-L4 (rounds 1-3 as far as the lane decides them), the row's
    round-2 product, rounds 4-7 in full, and rounds 8-10 cut to what word 0
    needs.  (From round 3 on the kernel takes each high half from the FP64
    pipe, hi_of, which test_high_half_from_the_fp64_pipe_is_exact holds.)"""
    keys, row_key, t_key, draw_key = _host_words(seed, t, draw)
    k0, k1 = [k[0] for k in keys], [k[1] for k in keys]
    mul = fk._mulhilo
    h, lo = mul(lane, M0)
    L1 = lo ^ k1[1]
    h2, l2 = mul(h ^ draw_key, M1)
    L2 = l2 ^ k0[2]
    h, lo = mul(h2 ^ t_key, M0)
    L3, L4 = h ^ k1[2], lo
    rh, rl = mul(row ^ row_key, M0)
    h, c1 = mul(rh ^ L1, M1)
    c0, c2, c3 = h ^ L2, L3 ^ rl, L4
    for r in range(3, 7):
        h0, l0 = mul(c0, M0)
        h1, l1 = mul(c2, M1)
        c0, c1, c2, c3 = h1 ^ c1 ^ k0[r], l1, h0 ^ c3 ^ k1[r], l0
    h0, l0 = mul(c0, M0)
    c0_8 = mul(c2, M1)[0] ^ c1 ^ k0[7]
    c2_8 = h0 ^ c3 ^ k1[7]
    c2_9 = mul(c0_8, M0)[0] ^ l0 ^ k1[8]
    c1_9 = mul(c2_8, M1)[1]
    return mul(c2_9, M1)[0] ^ c1_9 ^ k0[9]


@pytest.mark.parametrize("t,draw", [(0, 0), (11, 1), (2**31 - 1, 1)])
@pytest.mark.parametrize("seed", SEEDS)
def test_kernel_arithmetic_gives_philox_bits(seed, t, draw):
    rng = np.random.RandomState(2)
    rows = torch.from_numpy(np.r_[np.arange(7), rng.randint(7, 2**31 - 1, size=9)])[:, None]
    lanes = torch.from_numpy(np.r_[np.arange(8), rng.randint(8, 2**31 - 1, size=56)])[None, :]
    got = _kernel_arithmetic(lanes, rows, seed, t, draw)
    assert torch.equal(got, fk.philox_bits(lanes + 0 * rows, rows + 0 * lanes, t, draw, seed))


HI_WORD = 0x45300000  # csrc/fastgen_kernel.cu kPhiloxHiWord


def _double(hi, lo):
    return struct.unpack("<d", struct.pack("<Q", (hi << 32) | lo))[0]


@pytest.mark.parametrize("m", [M0, M1])
def test_high_half_from_the_fp64_pipe_is_exact(m):
    """hi_of in csrc/fastgen_kernel.cu: a word a carried as the double of low
    word a and high word 0x45300000 is 2^84 + a * 2^32; fma_rz of it with
    M * 2^-32 and 2^84 - M * 2^52 (both exact doubles) is 2^84 + a * M before
    its one rounding, inside [2^84, 2^85) where doubles lie 2^32 apart, so
    rounding toward zero leaves hi(a * M) as the low word and 0x45300000 as
    the high word.  Held in exact arithmetic on edge and random words."""
    src = (build.CSRC / "fastgen_kernel.cu").read_text()
    assert f"kPhiloxHiWord = {HI_WORD:#x};" in src
    assert "__fma_rz(a, m * 0x1p-32, 0x1p84 - m * 0x1p52)" in src
    scale, addend = m * 2.0**-32, 2.0**84 - m * 2.0**52
    assert Fraction(scale) == Fraction(m, 2**32) and Fraction(addend) == 2**84 - m * 2**52
    words = [0, 1, 0xFF, 0x7FFFFFFF, 0x80000000, M32]
    words += np.random.RandomState(4).randint(0, 2**32, size=2000, dtype=np.uint64).tolist()
    for a in words:
        carried = _double(HI_WORD, a)
        assert Fraction(carried) == 2**84 + a * 2**32
        exact = Fraction(carried) * Fraction(scale) + Fraction(addend)
        assert exact == 2**84 + a * m and 2**84 <= exact < 2**85
        rounded = (2**84 + a * m) >> 32 << 32  # toward zero onto the 2^32 grid
        assert Fraction(float(rounded)) == rounded  # a double: rounding is this floor
        bits = struct.unpack("<Q", struct.pack("<d", float(rounded)))[0]
        assert (bits >> 32, bits & M32) == (HI_WORD, (a * m) >> 32)


SMS, BLOCKS_PER_SM = 132, 4  # an H100's SMs; a few blocks an SM


def test_plan_and_kernel_share_the_block_size():
    src = (build.CSRC / "fastgen_kernel.cu").read_text()
    assert re.findall(r"constexpr int PHILOX_THREADS = (\d+);", src) == [str(fk.PHILOX_THREADS)]


@pytest.mark.parametrize("lanes", [1, 3, 4, 1000, 1024, 4097])
@pytest.mark.parametrize("rows", [1, 3, 7, 256, 65536])
def test_walk_covers_every_value_once(rows, lanes):
    """The kernel's walk as philox_plan sets it up: every thread starts at its
    unit u = tid with one division, then steps by the grid stride carrying
    the unit lane into the row, in 32 bits.  The carried (row, unit) must be
    divmod(u, groups) at every step, each unit's values lie inside its row,
    and the units' values add up to rows * lanes: every flat index is
    written once.  Small shapes also count every index directly."""
    plan = fk.philox_plan(rows, lanes, SMS, BLOCKS_PER_SM)
    groups, units, grid = plan["groups"], plan["units"], plan["grid"]
    assert groups == -(-lanes // 4) and units == rows * groups
    assert 1 <= grid <= SMS * BLOCKS_PER_SM and (grid - 1) * fk.PHILOX_THREADS < units
    step = grid * fk.PHILOX_THREADS
    assert plan["step_rows"] * groups + plan["step_groups"] == step
    assert units - 1 + step < 2**32  # u never wraps
    u = np.arange(min(step, units), dtype=np.int64)
    row, g = u // groups, u % groups
    n = rows * lanes
    seen = np.zeros(n, np.int32) if n <= 1 << 20 else None
    written = 0
    while len(u):
        assert np.array_equal(row, u // groups) and np.array_equal(g, u % groups)
        start = row * lanes + 4 * g
        count = np.minimum(4, lanes - 4 * g)
        assert np.all(count >= 1) and np.all(start + count <= n) and np.all(start + 4 <= 2**31)
        written += int(count.sum())
        if seen is not None:
            for j in range(4):
                np.add.at(seen, start[count > j] + j, 1)
        u, g, row = u + step, g + plan["step_groups"], row + plan["step_rows"]
        carry = g >= groups
        g, row = np.where(carry, g - groups, g), row + carry
        live = u < units
        u, g, row = u[live], g[live], row[live]
    assert written == n
    if seen is not None:
        assert np.all(seen == 1)


class _FakeLib:
    """The C entry points, recorded."""

    def __init__(self):
        self.calls = []

    def philox_uniform(self, out, plan, t, draw, keys, device, stream):
        self.calls.append({"out": out, "plan": list(plan), "t": t, "draw": draw,
                           "keys": list(keys), "device": device, "stream": stream})
        return 0


@pytest.fixture
def fake_lib(monkeypatch):
    lib = _FakeLib()
    monkeypatch.setattr(fk, "_lib", lambda probe="": lib)
    monkeypatch.setattr(fk, "philox_grid_of", lambda index: (SMS, BLOCKS_PER_SM))
    monkeypatch.setattr(torch.cuda, "current_stream", lambda d: type("S", (), {"cuda_stream": 77}))
    fk._philox_words.cache_clear()
    yield lib
    fk._philox_words.cache_clear()


@pytest.mark.parametrize("rows,lanes,seed,t,draw", [(256, 1024, 7, 11, 0), (65536, 1024, 7, 11, 0),
                                                     (7, 4097, -1, 2**31 - 1, 1)])
def test_wrapper_hands_the_kernel_its_plan_and_keys(fake_lib, rows, lanes, seed, t, draw):
    """_philox_launch (the CUDA branch of philox_uniform) with the library and
    the card replaced by a recorder: one launch, counted, with the plan in
    the C entry's order, the round keys as (k0, k1) pairs, t and draw."""
    out = torch.empty((rows, lanes), dtype=torch.float32)
    before = fk.philox_uniform.launches
    fk._philox_launch(out, seed, t, draw, 0)
    assert fk.philox_uniform.launches == before + 1
    (call,) = fake_lib.calls
    plan = fk.philox_plan(rows, lanes, SMS, BLOCKS_PER_SM)
    assert call["plan"] == [plan[k] for k in ("lanes", "groups", "units", "step_rows",
                                              "step_groups", "grid")]
    assert call["keys"] == [k for pair in fk.philox_round_keys(seed) for k in pair]
    assert (call["out"], call["t"], call["draw"], call["device"], call["stream"]) == (
        out.data_ptr(), t, draw, 0, 77)
    assert all(0 <= w < 2**32 for w in call["plan"] + call["keys"])  # the C entry's unsigned words


@pytest.mark.parametrize("device", ["cpu", "cuda"])
@pytest.mark.parametrize("rows,lanes,t,draw,msg", [
    (65536, 32768, 0, 0, r"rows 65536 x lanes 32768 = 2147483648"),
    (2**31, 1, 0, 0, r"rows 2147483648 x lanes 1 = 2147483648"),
    (1, 1, -1, 0, r"t = -1 is outside"),
    (1, 1, 2**31, 0, r"t = 2147483648 is outside"),
    (1, 1, 0, -1, r"draw = -1 is outside"),
])
def test_wrapper_refuses_what_the_kernel_cannot_take(fake_lib, device, rows, lanes, t, draw, msg):
    before = fk.philox_uniform.launches
    with pytest.raises(ValueError, match=msg):
        fk.philox_uniform(7, t, rows, lanes, draw, device=device)
    assert fk.philox_uniform.launches == before and not fake_lib.calls


def test_wrapper_on_the_cpu_is_the_plain_version(fake_lib):
    got = fk.philox_uniform(-(2**40), 2**31 - 1, 7, 4097, 1, device="cpu")
    assert torch.equal(got, fk.philox_uniform_plain(-(2**40), 2**31 - 1, 7, 4097, 1))
    assert not fake_lib.calls


EDGE_WORDS = [0, 0xFF, 0x100, 0x7FFFFFFF, 0x80000000, 0xFFFFFFFF]


@pytest.mark.parametrize("words", ["edges", "random"])
def test_uniform_from_bits_matches_jax(words):
    """The port's uniform_from_bits against the JAX package's
    _uniform_from_bits, which takes the TPU's signed int32 bits, bit for bit."""
    if words == "edges":
        w = np.array(EDGE_WORDS, dtype=np.uint32)
    else:
        w = np.random.RandomState(3).randint(0, 2**32, size=10**5, dtype=np.uint64).astype(np.uint32)
    got = fk.uniform_from_bits(torch.from_numpy(w.astype(np.int64))).numpy()
    want = np.asarray(jfk._uniform_from_bits(jnp.asarray(w.view(np.int32))))
    assert got.dtype == want.dtype == np.float32
    assert np.array_equal(got.view(np.uint32), want.view(np.uint32))
    if words == "edges":
        assert got[0] == got[1] == np.float32(1e-5) and got[-1] == np.float32(1 - 1e-5)


def test_plain_stream_passes_the_tpu_prng_gates():
    """philox_uniform_plain(7, 11, 256, 1024, 0) through check_prng's five
    gates (benchmarks/tpu_kernel_parity.py:146-152) as they stand."""
    u = fk.philox_uniform_plain(7, 11, 256, 1024, 0).numpy().ravel()
    checks = {
        "mean~0.5": abs(float(u.mean()) - 0.5) < 0.01,
        "p25~0.25": abs(float(np.quantile(u, 0.25)) - 0.25) < 0.01,
        "p75~0.75": abs(float(np.quantile(u, 0.75)) - 0.75) < 0.01,
        "max>0.99": float(u.max()) > 0.99,
        "no clip pileup": float((u <= 1e-5).mean()) < 1e-3,
    }
    assert all(checks.values()), checks
