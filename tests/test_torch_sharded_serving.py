"""Sharded serving on the port (counterpart of tests/test_sharded_serving.py):
models/fastgen.py generate_sharded / generate_cuda_sharded and
models/parallelgen.py synthesize_sharded / synthesize_seq_sharded, run in 2
and 4 gloo processes on the CPU (tests/torch_rank_worker.py), against one
process and against the JAX package's sharded functions on its 8 virtual
CPU devices.

Tolerances: the AR paths bit for bit against the port's own single runs
(generation never mixes batch rows, and the samplers draw for the whole
batch); the student to one quantisation bin (2 / quant_chann), as JAX's own
sharded serving is held.  The greedy kernel path against JAX's
jit_generate_pallas_sharded (interpret mode, XLA's excess precision off)
runs free: both sides upsample the mel their own way and their head
outputs part by roundoff (tests/test_torch_fastgen.py holds them
teacher-forced), so a mean that lands on a bin boundary of the 65 536
levels quantises one bin apart, and the run feeds that back.  Reading
(CPU): 89.8 % of the samples within one bin, every one within 9 bins (2.7e-4
of full scale).  Limits: GREEDY_ONE_BIN 85 % within one bin, every sample
within GREEDY_MAX_BINS 16."""

import dataclasses
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nsynth_wavenet_tpu import config as jconfig
from nsynth_wavenet_tpu.models import parallel_wavenet as jpwn_lib
from nsynth_wavenet_tpu.models import parallelgen as jparallelgen
from nsynth_wavenet_tpu.models.fastgen import Fastgen as JFastgen
from nsynth_wavenet_tpu.models.fastgen import jit_generate_pallas_sharded
from nsynth_wavenet_tpu.models.wavenet import Wavenet as JWavenet
from nsynth_wavenet_tpu.parallel import mesh as jmesh
from nsynth_wavenet_tpu_torch import config as tconfig
from nsynth_wavenet_tpu_torch import weights
from nsynth_wavenet_tpu_torch.models import parallelgen
from nsynth_wavenet_tpu_torch.models.fastgen import SHARD_SEED_STRIDE, Fastgen, shard_seed
from nsynth_wavenet_tpu_torch.models.parallel_wavenet import ParallelWavenet
from nsynth_wavenet_tpu_torch.models.wavenet import Wavenet
from test_sharded_serving import SMALL, _mel
from test_torch_multiprocess import REPO, run_job, run_ranks

GREEDY_ONE_BIN, GREEDY_MAX_BINS = 0.85, 16
WIDE = {**SMALL, "width": 128, "skip_width": 128, "deconv_width": 128}
STUDENT = {k: v for k, v in SMALL.items() if k not in ("skip_width", "double_gate_width",
                                                         "num_layers")}
STUDENT.update(loss_type="logistic", num_iaf_layers=(2, 2), num_samples=4)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _port_params(jparams):
    return weights.from_jax_params(jax.tree_util.tree_map(np.asarray, jparams), device="cpu")


def _teacher(cfg_kw, seed):
    jm = JWavenet(jconfig.WavenetConfig(loss_type="mol", **cfg_kw))
    jp = jm.init_params(jax.random.PRNGKey(seed))
    return jm, jp, tconfig.WavenetConfig(loss_type="mol", **cfg_kw), _port_params(jp)


class Served:
    """The inputs and every rank's outputs of one 2-rank and one 4-rank job."""

    def __init__(self, tmp):
        self.jm, self.jp, self.cfg, self.params = _teacher(SMALL, 0)
        self.jmw, self.jpw, self.cfgw, self.paramsw = _teacher(WIDE, 0)
        self.jst_cfg = jconfig.ParallelWavenetConfig(**STUDENT)
        self.jpwn = jpwn_lib.ParallelWavenet(self.jst_cfg)
        self.jst = self.jpwn.init_params(jax.random.PRNGKey(1))
        self.st_cfg = tconfig.ParallelWavenetConfig(**STUDENT)
        self.st_params = _port_params(self.jst)
        self.mel8 = torch.from_numpy(_mel())
        self.mel16 = torch.from_numpy(_mel(batch=16))
        self.mel_seq = torch.from_numpy(_mel(batch=2, length=1480))  # 8 frames
        student = {"cfg": self.st_cfg, "params": self.st_params, "seed": 9,
                   "seq": self.mel_seq}
        self.two = run_job("serving", {
            "plain": {"cfg": self.cfg, "params": self.params, "mel": self.mel8, "seed": 7,
                      "length": 64},
            "kernel": {"cfg": self.cfgw, "params": self.paramsw, "mel": self.mel16, "seed": 5,
                       "length": 24},
            "student": dict(student, data=self.mel8)}, 2, tmp / "two")
        self.four = run_job("serving", {"student": student}, 4, tmp / "four")


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield Served(tmp_path_factory.mktemp("served"))
    finally:
        torch.set_num_threads(threads)


def test_generate_sharded_equals_single_run(served):
    single = Fastgen(Wavenet(served.cfg)).generate(
        served.params, served.mel8, torch.Generator().manual_seed(7), length=64)
    assert single.shape == (8, 64) and single.std() > 0
    for r in served.two:
        assert torch.equal(r["plain"], single)


def test_shard_seed_equals_jax_int32_fold():
    for seed in (0, 5, 123456789, 2**31 - 1, -(2**31), -7):
        for shard in range(8):
            want = int(jnp.int32(seed) + jnp.int32(shard) * jnp.int32(SHARD_SEED_STRIDE))
            assert shard_seed(seed, shard) == want, (seed, shard)
    assert shard_seed(2**31 - 1, 1) < 0  # wraps as int32 does


def test_sampled_kernel_rows_equal_folded_seed_runs(served):
    """Rank r's rows of generate_cuda_sharded equal generate_cuda on those
    rows with shard_seed(seed, r)."""
    fg = Fastgen(Wavenet(served.cfgw))
    got = served.two[0]["kernel_greedyFalse"]
    assert torch.equal(got, served.two[1]["kernel_greedyFalse"])
    for r in range(2):
        rows = slice(8 * r, 8 * (r + 1))
        want = fg.generate_cuda(served.paramsw, served.mel16[rows], shard_seed(5, r), length=24)
        assert torch.equal(got[rows], want), r
    # the two shards draw other noise: the shards' rows are not a one-seed run
    one = fg.generate_cuda(served.paramsw, served.mel16, 5, length=24)
    assert not torch.equal(got[8:], one[8:])


def test_greedy_kernel_sharded_equals_jax_pallas_sharded(served):
    fg = Fastgen(Wavenet(served.cfgw))
    got = served.two[0]["kernel_greedyTrue"]
    # greedy draws nothing: bit for bit the one-process kernel path
    assert torch.equal(got, fg.generate_cuda(served.paramsw, served.mel16, 5, length=24,
                                             greedy=True))
    jfg = JFastgen(served.jmw)
    mesh = jmesh.make_mesh(n_data=2)
    gen = jit_generate_pallas_sharded(jfg, mesh, length=24, greedy=True, interpret=True,
                                      chunk=None, mel_bucket=None)
    mel = jnp.asarray(served.mel16.numpy())
    want = np.asarray(jax.jit(gen).lower(served.jpw, mel, 5).compile(
        compiler_options={"xla_allow_excess_precision": False})(served.jpw, mel, 5))
    assert want.shape == tuple(got.shape) == (16, 24)
    bins = np.abs(got.numpy() - want) * served.cfgw.quant_chann / 2
    print("greedy samples within one bin of JAX:", np.mean(bins <= 1), "most bins:", bins.max())
    assert np.mean(bins <= 1) >= GREEDY_ONE_BIN and bins.max() <= GREEDY_MAX_BINS


def _jax_synth(served, fn, mel, x, monkeypatch):
    """JAX's sharded student on the port's whole-batch base noise x."""
    monkeypatch.setattr(jpwn_lib.ParallelWavenet, "base_noise",
                        lambda self, rng, B, L: jnp.asarray(x))
    return np.asarray(fn(served.jst, jnp.asarray(mel.numpy()), jax.random.PRNGKey(0)))


def _noise(served, mel):
    pwn = ParallelWavenet(served.st_cfg)
    return pwn.base_noise(torch.Generator().manual_seed(9), mel.shape[0],
                          pwn.sample_length(mel.shape[1]), "cpu").numpy()


def test_synthesize_sharded_equals_jax_to_one_bin(served, monkeypatch):
    bin_ = 2.0 / served.st_cfg.quant_chann
    got = served.two[0]["synth"].numpy()
    assert torch.equal(served.two[0]["synth"], served.two[1]["synth"])
    single = parallelgen.synthesize(ParallelWavenet(served.st_cfg), served.st_params,
                                    served.mel8, torch.Generator().manual_seed(9)).numpy()
    np.testing.assert_allclose(got, single, atol=bin_, rtol=0)
    fn = jparallelgen.jit_synthesize_sharded(served.jpwn, jmesh.make_mesh(n_data=2))
    want = _jax_synth(served, fn, served.mel8, _noise(served, served.mel8), monkeypatch)
    assert want.shape == got.shape == (8, 1400)
    np.testing.assert_allclose(got, want, atol=bin_, rtol=0)


@pytest.mark.parametrize("n_seq", (2, 4))
def test_synthesize_seq_sharded_equals_jax_to_one_bin(served, monkeypatch, n_seq):
    bin_ = 2.0 / served.st_cfg.quant_chann
    ranks = served.two if n_seq == 2 else served.four
    got = ranks[0]["synth_seq"].numpy()
    for r in ranks[1:]:
        assert torch.equal(r["synth_seq"], ranks[0]["synth_seq"])
    single = parallelgen.synthesize(ParallelWavenet(served.st_cfg), served.st_params,
                                    served.mel_seq, torch.Generator().manual_seed(9)).numpy()
    np.testing.assert_allclose(got, single, atol=bin_, rtol=0)
    fn = jparallelgen.jit_synthesize_seq_sharded(served.jpwn, jmesh.make_mesh(n_data=1,
                                                                             n_seq=n_seq))
    want = _jax_synth(served, fn, served.mel_seq, _noise(served, served.mel_seq), monkeypatch)
    assert want.shape == got.shape == (2, 1600)
    np.testing.assert_allclose(got, want, atol=bin_, rtol=0)
    # a chunk's receptive field reaches into the one before it
    assert parallelgen.flow_receptive_field(ParallelWavenet(served.st_cfg), 0) > 1


def _sources(tmp_path, n=4):
    from nsynth_wavenet_tpu_torch.data import wav_io

    src = tmp_path / "src"
    src.mkdir()
    golden = os.path.join(REPO, "tests", "golden")
    for i in range(n):
        wav, _ = wav_io.read_wav(os.path.join(golden, f"gen_golden_mol_{i}.wav"))
        wav_io.write_wav(str(src / f"utt_{i}.wav"), wav[:1000])
    return src, golden


def test_eval_clis_split_each_batch_over_two_ranks(tmp_path):
    """eval_*_torch.py --multihost in 2 ranks: each batch of 4 split over
    them, rank 0 writing.  The teacher's wavs equal, byte for byte, one
    process's generate_cuda on each rank's rows with the rank's folded seed;
    the student's equal one process's to one quantisation bin (and the 16-bit
    PCM step it is written in)."""
    from nsynth_wavenet_tpu_torch.data import wav_io
    from nsynth_wavenet_tpu_torch.evaluation import (discover_files, generate_parallel_wavenet,
                                                     load_mel_batch)

    src, golden = _sources(tmp_path)
    common = ["--source_path", str(src), "--batch_size", "4", "--sample_length", "400",
              "--device", "cpu", "--multihost"]
    teacher = ["--params", os.path.join(golden, "tiny_mol", "params.npz"),
               "--config", os.path.join(golden, "tiny_mol", "meta.json")]
    student = ["--params", os.path.join(golden, "tiny_student", "params.npz"),
               "--config", os.path.join(golden, "tiny_student", "meta.json")]
    run_ranks([sys.executable, os.path.join(REPO, "eval_wavenet_torch.py"), *common, *teacher,
               "--save_path", str(tmp_path / "gen_t")], 2, tmp_path / "log_t")
    run_ranks([sys.executable, os.path.join(REPO, "eval_parallel_wavenet_torch.py"), *common,
               *student, "--save_path", str(tmp_path / "gen_s")], 2, tmp_path / "log_s")

    cfg = tconfig.load_config(os.path.join(golden, "tiny_mol", "meta.json"))
    params = weights.load_npz(os.path.join(golden, "tiny_mol", "params.npz"), device="cpu")
    fg = Fastgen(Wavenet(dataclasses.replace(cfg, use_as_teacher=True)))
    files = discover_files(str(src))
    mel = torch.from_numpy(load_mel_batch(files, 400))
    (tmp_path / "want").mkdir()
    for r in range(2):
        rows = slice(2 * r, 2 * r + 2)
        audio = fg.generate_cuda(params, mel[rows], shard_seed(0, r)).numpy()
        for f, wav in zip(files[rows], audio):
            name = "gen_" + os.path.basename(f)
            wav_io.write_wav(str(tmp_path / "want" / name), wav)
            assert (tmp_path / "want" / name).read_bytes() == \
                (tmp_path / "gen_t" / name).read_bytes(), name

    want = generate_parallel_wavenet(str(src), os.path.join(golden, "tiny_student", "params.npz"),
                                     os.path.join(golden, "tiny_student", "meta.json"),
                                     str(tmp_path / "one_s"), batch_size=4, device="cpu",
                                     sample_length=400)
    assert len(want) == 4
    for p in want:
        a = wav_io.read_wav(p)[0]
        b = wav_io.read_wav(str(tmp_path / "gen_s" / os.path.basename(p)))[0]
        assert np.abs(a - b).max() <= 2.0 / 32768.0, p
