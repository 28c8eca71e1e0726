"""Drive the PyTorch / CUDA port on one NVIDIA H100 and check it.

    python3 chip_smoke.py

Needs one CUDA card and the CUDA toolkit (nvcc); exits non-zero without
them.  Phases, each fatal on failure:
  1. device, nvidia-smi name and power limit, kernel build (timed);
  2. the CUDA generation kernel against its plain PyTorch version at the full
     width of configs/wavenet_mol.json (30 layers, width 512), random weights
     from a seed, B = 8, L = 256: teacher-forced greedy head outputs, and a
     sampled free run replayed through the plain sampler and the plain network;
  3. the same checks for the CE (mu-law, double gate) and Gauss heads at 4 layers,
     and for the trained tiny MoL golden;
  4. the kernel's Philox generator against the plain one, and its statistics;
  5. the main path end to end at full width, B = 64 and 512, L = 2000:
     numpy wavs -> mel -> deconv on the card -> Fastgen.generate_cuda, sampled;
     kernel launch counts; the phase 2 checks again at B = 64 and 512,
     L = 48; step time, and per-kernel timings against the plain version,
     cuBLAS and the card's bound; the persistent kernel's grid, blocks per SM,
     registers, spills, shared memory and one barrier's cost; the launches of
     a call, counted where the wrapper enqueues them and shown by a profile,
     must each be one persistent launch, and the grid barriers the kernel
     counted 2 * NL + 3 a step;
  6. evaluation.generate_wavenet over two wavs with the golden tiny_mol weights;
  7. a golden free run that must track its conditioning;
 32. (after phase 7) PyTorch's default TF32 settings: generate_wavenet's
     encoding of the f32 golden tiny_mol equal bit for bit to the deconv with
     TF32 off, under cudnn.deterministic;
  8. the CUDA flow-stack kernel (flow_persist_kernel at W 64) against its
     plain PyTorch version at the full width of configs/parallel_wavenet.json
     (10 layers, dilations 1..512, width 64, deconv width 256), random weights
     from a seed: one-shot at B = 8 x L = 8192, B = 32 x L = 4096 and
     B = 3 x L = 1000 (ragged last tile); chained chunks of 2048 and of 512
     (shorter than the largest 2d) equal to the one-shot call bit for bit, and
     their final state against the plain one.  Every flow check here and in
     phases 27-28 also requires the call's CUDA launches, counted by kernel
     name where flow_stack enqueues them, to be exactly one trunk launch a
     layer of its width's kernel (flow_persist_kernel at W 32 / 64,
     flow_layer_kernel at W 128 / 256) and, with a state, one
     flow_state_kernel a layer;
  9. the student path end to end at full width (60 layers in 4 flows), B = 32
     and 8, 4 s of audio: numpy wavs -> mel -> shared deconv on the card ->
     parallelgen.synthesize_cuda; wrapper calls, and CUDA launches by kernel
     name (10 flow_persist_kernel a call, nothing else); the fused
     feed-forward against the same path on the plain kernel; StudentStreamer
     (chunk 32768) against the one-shot path on the same noise; the stack call
     at the path's own B = 32 x L = 64000 against its plain version for every
     cycle offset, and timed against it, torch.mm on the same products and the
     card's bound; the timed call's last persistent launch: the grid, tiles,
     tile rows and ring stages it was handed, and what the card then holds
     for the kernel (registers, spills, static shared memory, the dynamic
     shared memory the launch opted in to, blocks an SM); device time per
     CUDA kernel;
 10. the trained golden tiny_student on the card: fused against plain audio,
     streamer against one-shot, and a free synthesis that tracks its mels;
 11. evaluation.generate_parallel_wavenet over two wavs, one-shot and streamed.
Phases 12 to 18 cover the teacher's W8A8 static mode (int8 weights, static
activation and gate scales) and chunked streaming; they run after phase 7,
while the teacher is on the card:
 12. Fastgen.calibrate_act_amax on 8 rows x 1 s, int8 packing, and the W8A8
     kernels against their plain version: single steps started from the plain
     version's state, and the checks of phase 2 over whole runs: full-width
     MoL at B = 8, L = 256 and at B = 64 and 512, L = 48 (there also cut to 4
     layers, where a tight limit holds); the CE and Gauss heads at 4 layers;
     the trained golden tiny_mol (whose K slices straddle 3W);
 13. W8A8 against bf16 on the card, teacher-forced, golden and full width:
     within 5 % of the bf16 output's scale;
 14. streaming, both modes, full width: chained chunks of 128 (shorter than the
     largest 2d, not a divisor of L = 300) equal to the one-shot call bit for
     bit, greedy and sampled, and the final state against the plain version's;
 15. the W8A8 main path: Fastgen.generate_cuda(weight_dtype="int8", act_amax=...,
     gate_static=True) at B = 64 and 512, L = 2000, sampled; a streamed run
     (chunk 500) at B = 64 equal to the one-shot run on the same encoding;
     launch counts by mode;
 16. W8A8 step time and per-kernel timings against the plain version,
     torch._int_mm on the same products and the card's int8 bound, at
     B = 64, 512 and the JAX package's shipped batch 896;
 17. a golden W8A8 free run that must track its conditioning;
 18. evaluation.generate_wavenet(int8, int8_static, streaming_chunk) over two wavs.
Phases 19 to 26 cover the calibration-free W8A8 modes (per-row log8
activation scales whose codes ride in the ring, per-row gate scales, bf16
res/skip under an int8 ring, the bf16 combine); they follow phase 18:
 19. int8 packing with nothing calibrated, and the per-row kernels against
     their plain version: single steps from the plain version's state at full
     width, B = 8, 64 and 512, judged per (step, row) pair, with the share of
     ring payloads and of exponent codes that differ; whole runs for MoL, CE
     and Gauss at 4 layers and for the golden tiny_mol; full depth under the
     gross-fault guard;
 20. the other combinations (row + fixed gate scale, row + bf16 res/skip,
     static + per-row gate scale, static + bf16 res/skip, the bf16 combine, and
     bf16 weights with an int8 res/skip product): single steps at full width,
     B = 64, and whole runs at 4 layers;
 21. the per-row mode against bf16 and against the static mode, teacher-forced,
     on the golden and at 4 layers: within 5 % of scale, bf16 res/skip no
     further from bf16 than 1.5 times the all-int8 distance; full depth printed;
 22. streaming in the per-row mode at full width: chained chunks of 128 equal to
     the one-shot call bit for bit, exponent codes included;
 23. the calibration-free main path: Fastgen.generate_cuda(weight_dtype="int8")
     at B = 64 and 512, L = 2000, sampled; a streamed run (chunk 500) at B = 64
     equal to the one-shot run on the same encoding; launch counts by mode;
 24. step time of the per-row mode with the bf16, the static and the other
     modes in the same call, against the plain version, torch._int_mm on the
     four segment products and the res/skip product, and the card's bound;
     per-kernel device time;
 25. a golden per-row free run that must track its conditioning;
 26. evaluation.generate_wavenet(int8=True) over two wavs and over one mel-only
     .npy, one-shot and streamed.
Phases 27 to 31 cover the flow kernel's other modes and the f32 student; they
follow phase 11:
 27. the flow kernel's modes against their plain versions at the full width of
     configs/parallel_wavenet.json (10 layers, dilations 1..512, W 64, DW 256),
     random weights from a seed, B = 8 x L = 8192 and B = 3 x L = 1000: the f32
     conditioning product (one-shot; chained chunks of 2048 and 512 bit for bit
     equal to one-shot, the final state against the plain one); fuse_cond on an
     f32 encoding; the cond stream in bf16 and f32 (the f32 one also against
     the f32-cond mode); bf16 carries (output bit for bit, state rounded); one
     30-layer call equal to three chained 10-layer calls; the f32 precision
     probe (w_tap = 0, x = 0, w_res = [I | 0]: the share of bf16(g) values that
     differ from the plain version with TF32 off, under 1 %);
 28. widths 32 (flow_persist_kernel), 128 and 256 (flow_layer_kernel) at
     B = 8 x L = 4096, DW 256, and deconv width 136 at W 64, both
     conditioning modes: one-shot and chained chunks of 512; at the edges of
     the persistent kernel's 128-byte copy boxes (random weights,
     B = 3 x L = 600): deconv widths 8 (narrower than a box) and 4096
     (w_cond streamed with its chunks) at W 32 and 64 in both conditioning
     modes, and one layer of a W 32 cond stream in bf16 and f32: one-shot
     and chained chunks of 128, with the exact launches;
 29. the f32 student end to end at full width, B = 32 and 8, 4 s:
     parallelgen.synthesize_cuda through the f32-cond kernel alone (launches by
     mode; CUDA launches by kernel name), the fused feed-forward against the
     same path on the plain kernel,
     layers_per_call=30 bit for bit equal to the default, fuse_cond within 5e-4
     of it on the mean and scale outputs, StudentStreamer (chunk 32768) against
     one-shot, device time per CUDA kernel; the 10-layer call at B = 32 x
     L = 64000 against its plain version, timed beside the bf16 call, both
     cond streams, one 30-layer call and a call with a carried state (f32 and
     bf16 carries), torch.mm (bf16, and f32 with TF32 off) and the card's
     bound; the f32-cond kernel's launch facts;
 30. the trained golden tiny_student loaded as f32: fused against plain audio,
     streamer against one-shot, a free synthesis that tracks its mels,
     evaluation.generate_parallel_wavenet on an f32 config, one-shot and
     streamed;
 31. a width-128 student (configs/parallel_wavenet.json with width 128) through
     synthesize_cuda at B = 8 x 1 s (flow_layer_kernel alone) against the same
     path on the plain kernel;
     one 10-layer call timed at widths 32, 64, 128 and 256.
Phases T1 to T5 train the teacher (training/); they follow phase 31:
 T1. one training step on the card against the same step on the CPU:
     configs/wavenet_mol.json cut to 4 layers, f32 compute, TF32 off, dropout
     off, B = 2 x 7680, the same params and batch: the loss, every gradient
     leaf, the params after Adam and the EMA;
 T2. runner.train_wavenet at full size (configs/wavenet_mol.json unchanged:
     30 layers, bf16, dropout on) on a speech-like corpus the port builds in
     a temporary directory, B = 4 x 7680, 40 steps, a checkpoint every 20:
     every loss finite, the checkpoints land; and 40 steps on one fixed batch
     whose last 5 losses average under the first 5;
 T3. resume by logdir bit for bit: a one-record dataset whose record is
     exactly wave_length (every crop the same), the full config cut to 4
     layers, cuDNN deterministic: 3 steps, then resumed to 6, equal to an
     uninterrupted 6-step run in every tensor of the state;
 T4. export_ema of T2's run, then evaluation.generate_wavenet(ckpt_dir=run)
     over two short wavs: one fastgen_persistent launch a call, audio finite
     and not silent;
 T5. step time, steps/s, utterances/s and peak memory at full size, B = 4,
     B = 16 and B = 16 with remat, against the step's FLOP bound.
Phases S1 to S5 distill the student (training/), with T2's run as the teacher:
 S1. one distillation step on the card against the same step on the CPU, f32,
     TF32 off: configs/parallel_wavenet.json cut to flows of 2 / 2 layers
     under configs/wavenet_mol.json cut to 4 layers (logistic KL,
     contrastive, power loss), and configs/parallel_wavenet_gauss.json under
     configs/wavenet_gauss.json likewise; B = 2 x 7680, the same params,
     batch and draws: every metric, every gradient leaf, the params after
     Adam and the EMA;
 S2. runner.train_parallel_wavenet at full size (configs/parallel_wavenet.json
     unchanged: 4 flows of 10 / 10 / 10 / 30 layers, W 64, bf16, 100 samples,
     contrastive 0.3, power 1.0, shared deconv), B = 4 x 7680, 20 steps, a
     checkpoint every 10: every loss finite, the checkpoints land; 30 steps on
     one fixed batch with fixed draws whose last 5 losses average under the
     first 5; 3 steps with use_teacher_deconv, whose stack stays bit-equal to
     the teacher's and holds no Adam moments;
 S3. resume by logdir bit for bit (students flows 2 / 2, T3's one-record
     dataset, cuDNN deterministic): 3 steps, resumed to 6, equal to 6
     uninterrupted steps in every tensor of the state;
 S4. export_ema of S2's run, then evaluation.generate_parallel_wavenet(
     ckpt_dir=run) over two short wavs: 6 flow_stack calls, 60
     flow_persist_kernel launches counted at the C entry point, audio finite
     and not silent;
 S5. step time, steps/s, utterances/s and peak memory at full size, B = 4,
     B = 8 and B = 8 with remat_teacher, against the step's FLOP bound, with
     a torch.profiler split of one step's device time (student, teacher
     forward and backward, MoL log-probs, STFTs, optimizer).
Phases 33 to 38 follow S5:
 33. the MoL teacher at the full width of configs/wavenet_mol.json with
     use_resize_conv (nearest-neighbour repeats, then a SAME convolution),
     random weights from a seed: its encoding on the card against the CPU at
     B = 2 x 1 s in f32 (TF32 off, cuDNN deterministic) and in bf16,
     Fastgen.precompute_conditioning on the card against the CPU, phase 2's
     kernel checks from that encoding at B = 8, L = 256, a sampled
     generate_cuda at B = 64, L = 2000 in one fastgen_persistent launch, and
     the resize upsampler timed against the transposed one on the same
     weights, beside its FLOP bound;
 34. the student at the full width of configs/parallel_wavenet.json with
     use_resize_conv, B = 8 x 4 s: synthesize_cuda's launches by kernel name
     (6 calls, 60 flow_persist_kernel), and the fused feed-forward against the
     same path on the plain kernel on the same noise;
 35. weight-normed resize-conv teachers cut to 4 layers and a resize-conv
     Gauss student of flows 2 / 2 under the Gauss one, f32: the
     data-dependent init on the card against the CPU's, then the gradients
     and one step from the CPU's init on both, with T1's and S1's limits
     (the MoL teacher's gradients a reading only), each teacher's gradients
     also against f64 on the CPU with the first upsampler's pre-activations
     that land across the leaky ReLU's kink from f64's, and one bf16 step of
     the Gauss teacher (cuDNN on bf16 operands) that must be finite;
 36. Fastgen.generate_from_wav at full width, B = 8, equal bit for bit to the
     card mel -> generate_cuda with the same seed and batch shape, in one
     fastgen_persistent launch; parallelgen.synthesize_from_wav equal bit for
     bit to the card mel -> synthesize_cuda, with 60 flow_persist_kernel
     launches; evaluation.generate_wavenet(npy_only=True) over a directory of
     .wav files and .npy mels serving the mels;
 37. the JAX package's golden gate (tests/test_golden_regression.py: matched
     corr > mismatched corr + 0.05 and > the recorded one - 0.2, or - 0.15
     for the student, and matched MCD < mismatched MCD; utils/quality.py) on
     the card: tiny_mol through fastgen_persistent in bf16, W8A8 static,
     per-row and per-row with bf16 res/skip, tiny_ce and tiny_gauss in bf16
     (one launch a call, after quant_enc_kernel in the int8 modes), and
     tiny_student through 10 flow_persist_kernel launches;
 38. the native crop sampler built by g++ into _build/ and loaded, its crops
     equal to the numpy gather, and the T2 and S2 runners' train.log naming
     it as their crop gather;
 M1. the device mesh over NCCL at world size 1 (torch.distributed, env://):
     a real process group (an all-reduce and an all-gather on the card),
     Fastgen.generate_cuda_sharded at the full width of
     configs/wavenet_mol.json, B = 64, bit-equal to generate_cuda with the
     same seed and encoding, counted as one fastgen_persistent launch; one
     data-parallel teacher step at B = 4 against the step without a mesh;
 M2. two ranks sharing the card over gloo (`chip_smoke.py --mesh-rank`,
     spawned as subprocesses with torch's env:// variables): greedy
     generate_cuda_sharded at full width, B = 16, bit-equal to the one-rank
     kernel; sampled, each rank's rows bit-equal to generate_cuda on them
     with its folded seed; parallelgen.synthesize_sharded at the full width
     of configs/parallel_wavenet.json, B = 8 x 1 s, each rank's rows within
     one quantisation bin of one rank's synthesize_cuda of those rows on the
     same noise, and against one rank's B = 8 call within
     MESH_SYNTH_BINS_BF16 bins (cuDNN's deconv at B = 4 and 8 parts by a bf16
     step, which the flows carry to the output) and the f32 student within
     MESH_SYNTH_BINS_F32; a data-parallel teacher step (Gauss,
     4 layers, f32) and a distillation step (the Gauss pair) at global B = 4
     against one rank's step on all 4 rows, within the tier-1 limits
     (MESH_METRIC_TOL, MESH_UPDATE_TOL); each rank's fastgen_persistent and
     flow_persist_kernel launches, counted around its sharded calls, equal
     to one a generate call and to predicted_launches a flow_stack call;
 M3. two ranks sharing the card over gloo at n_seq 2 (`chip_smoke.py
     --seq-rank`): a training step of the full MoL teacher
     (configs/wavenet_mol.json: dropout_inputs) at global B = 4 x 7680 and
     a distillation step of configs/parallel_wavenet.json under that
     teacher at B = 2, each rank running its half of every crop's time
     axis, each against the one-process step on the same batch and draws
     (the same dropout seed).  In bf16, as shipped: the metrics within
     MESH_METRIC_TOL; each rank's peak memory next to the one process's;
     the update's distance from one process's a reading, beside that of
     the same bf16 teacher step split over two data ranks (the control):
     any split of a bf16 step rounds each rank's partial gradients to
     bf16, and Adam's first step moves every element by about the learning
     rate whatever its size, so neither meets MESH_UPDATE_TOL
     (tools/seq_step_readings.py shows where the two steps part).  The
     same steps on f64 params, audio and draws (the f32 configs) within
     MESH_METRIC_TOL and MESH_UPDATE_TOL.  Every step's halo exchanges,
     counted where mesh.halo makes them, equal to
     train_lib.wavenet_halo_exchanges / pwn_halo_exchanges; step times are
     readings (gloo moves the halos through host memory).
Phases Q1 to Q4 drive the port's quality and ops tools
(nsynth_wavenet_tpu_torch/tools/) on the card after M3, their training cut
to Q_STEPS steps (the quality gates are then readings, printed, not
requirements):
 Q1. quality_smoke.teacher_smoke: the speech corpus, the CE head (width 128,
     10 layers, B = 8 x 3840), compare_cuda, held-out clips cut to
     Q_HELD_OUT samples: every training loss finite and the windowed loss
     falling, the plain free run finite, generate_cuda once in bf16,
     calibration-free W8A8 and W8A8 static, each one fastgen_persistent
     launch (after one quant_enc_kernel in the int8 modes), and the tool's
     metrics on each kernel's audio equal to utils/quality.py's;
 Q2. quality_smoke.student_smoke, the Gauss pair: finite windowed losses of
     the student log, a finite one-shot synthesis with std > 0;
 Q3. longform_check, 3 s x 8 utterances in chunks of 4000: Q1's teacher in
     bf16 and W8A8 static, one fastgen_persistent launch a chunk call (after
     one quant_enc_kernel in W8A8 static), ceil(L / chunk) calls; Q2's
     student through StudentStreamer, flow_persist_kernel and
     flow_state_kernel launches equal to predicted_launches a flow_stack
     call, every call of every chunk;
 Q4. make_golden_ckpt (CE, f32) whose params.npz loads through
     weights.load_npz and whose free run through fastgen_persistent prints
     utils/quality.golden_gate's reading; make_golden_wavs --cuda, four
     finite, non-silent wavs a committed golden, one launch a head;
     make_eval_model on T2's and S2's runs equal to the runs' EMA;
     gather_results over a root holding both, wavs written through one
     fastgen_persistent launch and 60 flow_persist_kernel launches;
     downsample of a 44.1 kHz wav equal to resample_poly.
Every teacher generate call is one cooperative launch of the persistent
kernel fastgen_persistent (after quant_enc_kernel in the int8 modes).
Phases other than 32 run with TF32 off.  The last line is {"ok": true,
"device": {...}}; the line before it holds the per-kernel JSON record.
"""

import contextlib
import dataclasses
import json
import os
import re
import subprocess
import sys
import tempfile
import time
from unittest import mock

import numpy as np
import torch

from nsynth_wavenet_tpu_torch import config as config_lib
from nsynth_wavenet_tpu_torch import weights
from nsynth_wavenet_tpu_torch.data import wav_io
from nsynth_wavenet_tpu_torch.evaluation import (
    generate_parallel_wavenet,
    generate_wavenet,
    load_eval_model,
)
from nsynth_wavenet_tpu_torch.kernels import build
from nsynth_wavenet_tpu_torch.models import parallelgen
from nsynth_wavenet_tpu_torch.models.fastgen import Fastgen, shard_seed
from nsynth_wavenet_tpu_torch.models.parallel_wavenet import (
    ParallelWavenet,
    transplant_teacher_deconv,
)
from nsynth_wavenet_tpu_torch.models.wavenet import Wavenet, no_tf32
from nsynth_wavenet_tpu_torch.ops import conv as conv_ops
from nsynth_wavenet_tpu_torch.ops import fastgen_kernel as fk
from nsynth_wavenet_tpu_torch.ops import flow_kernel as flk
from nsynth_wavenet_tpu_torch.ops import stft
from nsynth_wavenet_tpu_torch.parallel import mesh as mesh_lib
from nsynth_wavenet_tpu_torch.training import checkpoint as ckpt_lib
from nsynth_wavenet_tpu_torch.training import optimizer as opt_lib
from nsynth_wavenet_tpu_torch.training import runner
from nsynth_wavenet_tpu_torch.training import train_lib
from nsynth_wavenet_tpu_torch.utils import quality
from nsynth_wavenet_tpu_torch.utils import tree as tree_lib

REPO = os.path.dirname(os.path.abspath(__file__))
GOLDEN = os.path.join(REPO, "tests", "golden")
# published dense peaks of one H100 SXM at its 700 W limit
PEAK_BF16_FLOPS = 989e12
PEAK_F32_FLOPS = 67e12  # FMA on the CUDA cores, not the tensor cores' TF32
PEAK_INT8_OPS = 1979e12
PEAK_HBM_BYTES = 3.35e12
MAIN_BATCHES = (64, 512)
SHIPPED_BATCH = 896  # the JAX package's shipped W8A8 serving batch (BENCH_r05.json)
MAIN_LENGTH = 2000
TIMED_STEPS = 128
CHECK_STEPS = 48  # kernel-vs-plain length at the main path's batches
# kernel vs plain, head outputs within REL_TOL * max(|plain|, 1): the JAX
# kernel test's tolerance, held by the 4-layer heads and the trained golden.
REL_TOL = 5e-3
# At full width with random N(0, 0.05) weights the 30-layer network
# amplifies f32 summation-order and bf16 rounding differences: the plain
# version on the CPU and on the card part by 1.28e-2 to 1.48e-2 x scale over
# 256 steps, and the kernel from the plain version on the card by 4e-3 x
# scale in the first step alone and 1.35e-2 to 1.50e-2 x scale over 256
# steps (this script, three runs on an H100 80GB HBM3 at 700 W), so no
# implementation can meet REL_TOL there.  This fixed limit sits 1.7x above
# the largest of those readings; PERF.md gives them.
FULL_WIDTH_REL_TOL = 2.5e-2
# flow kernel vs plain, stream within FLOW_REL_TOL * max(|plain|, 1): the same
# roundings in another summation order over 10 layers.  PERF.md gives the
# readings it was set from and the plain version's own CPU-vs-card distance.
FLOW_REL_TOL = 5e-3
# the fused feed-forward on the kernel vs on the plain kernel, 60 layers in 4
# flows, every key of the ff dict within this share of max(|plain|, 1e-3)
STUDENT_REL_TOL = 2e-2
# fuse_cond against the default f32 student, mean and scale outputs: the JAX
# package's own limit (tests/test_flow_kernel.py::test_opt_in_kernel_variants_match_default)
FUSE_COND_ATOL = 5e-4
# W8A8 kernels vs their plain version.  The integer products are exact, so
# what parts the two is an int8 LSB where the f32 value before a quantiser
# differs in its last bits (expf, tanhf): about one quantised value in 1e7.
# A flipped LSB is 1/127 of a layer's abs-max, some 20 times a bf16 rounding,
# and with random N(0, 0.05) weights it sets off more flips in every later
# layer of its batch row and, through the int8 ring, in later steps.  Readings
# on an H100 80GB HBM3 at 700 W (PERF.md has them all):
# - single steps started from the plain version's state agree to 4e-7 x scale
#   at B = 8 and to 4e-3 x scale at B = 512, except the (step, row) pairs in
#   which a flip cascades through 30 layers (at most 1 of 768, up to
#   4e-2 x scale): all but W8A8_PAIR_SHARE of the pairs are held to REL_TOL,
#   every pair to W8A8_FULL_WIDTH_RUN_TOL, and the int8 ring entries written in
#   a step may differ in a share of W8A8_FLIP_SHARE (readings up to 2.0e-4);
# - whole runs at 4 layers part by up to 7.0e-3 x scale (CE, sampled replay;
#   6.8e-3 at B = 512), so they are held to W8A8_REL_TOL, the bf16 mode's
#   full-width limit; the trained golden holds REL_TOL;
# - whole runs at full depth part by up to 1.05e-1 x scale over 48 steps, and
#   the plain version on the CPU from itself on the card by 7.2e-2 x scale over
#   256, so no implementation can be held closely there: a fixed
#   W8A8_FULL_WIDTH_RUN_TOL, 4.8 times the largest reading, guards against
#   gross faults only (a wrong kernel parts by the scale itself, or is not finite).
W8A8_REL_TOL = 2.5e-2
W8A8_PAIR_SHARE = 1e-2
W8A8_FLIP_SHARE = 1e-2
W8A8_FULL_WIDTH_RUN_TOL = 5e-1
W8A8_STATE_SHARE = 0.25  # int8 ring entries that may differ from the plain ones after a whole run
# W8A8 against bf16, share of the bf16 output's scale: the reference's own gate
# (at 4 layers), held by the trained golden and by the full-width model cut to
# 4 layers.  At full depth the random-weight network amplifies the
# quantisation noise as it amplifies the flips above (12 to 15 % of scale over
# 256 steps), so there the reading is printed and held to the gross-fault guard.
W8A8_VS_BF16 = 0.05
# M1 / M2, ranks against one rank: tests/test_torch_distill_step.py's metric
# limit and the f32 update limit of tests/test_torch_train_step.py
MESH_METRIC_TOL = 1e-4
MESH_UPDATE_TOL = 1e-3
MESH_RANK_TIMEOUT = 420
# M3: the shipped bf16 steps (their updates a reading beside the
# data-parallel control: see the module docstring), and their f64 twins,
# held to MESH_UPDATE_TOL
M3_DTYPES = ("bfloat16", "float64")
# M2, synthesize_sharded at B = 8 against one rank's B = 8 call, in
# quantisation bins (2 / quant_chann): see PERF.md section 6 for the readings
MESH_SYNTH_BINS_BF16 = 128
MESH_SYNTH_BINS_F32 = 16
STREAM_STEPS, STREAM_CHUNK = 300, 128
STUDENT_BATCHES = (32, 8)
STUDENT_SAMPLES = 64000  # 4 s


T_START = time.time()


def log(msg):
    print(f"[chip_smoke {time.time() - T_START:6.1f}s] {msg}", flush=True)


def require(ok, msg):
    if not ok:
        raise RuntimeError(f"check failed: {msg}")


def cuda_ms(fn, reps=3):
    """Median milliseconds of fn() by CUDA events, after one warm-up call."""
    fn()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def full_model(path, seed=0, **overrides):
    cfg = config_lib.load_config(os.path.join(REPO, path), **overrides)
    model = Wavenet(cfg)
    params = model.init_params(seed, device="cuda")
    return model, params, fk.build_kernel_weights(cfg, params)


def conditioning(model, params, B, L, seed):
    """enc_t [L, B, DW] bf16 from a random mel through the deconv stack."""
    frames = 1 + -(-L // model.cfg.frame_shift)
    mel = torch.rand((B, frames, 80), generator=torch.Generator().manual_seed(seed)).cuda()
    enc = model.deconv_stack(params, mel)
    return enc.transpose(0, 1)[:L].to(torch.bfloat16).contiguous()


def on_cpu(kw):
    return {k: v.cpu() if isinstance(v, torch.Tensor) else v for k, v in kw.items()}


def check_kernel(label, cfg, kw, enc_t, seed, rel_tol, cpu_floor=False, **opts):
    """Kernel vs plain version on the same inputs; returns (largest
    teacher-forced head-output error, the plain version's CPU-vs-card
    disagreement or None).  Fails if an error exceeds rel_tol * max(|plain|, 1).

    Teacher-forced greedy head outputs are compared directly.  The sampled
    path is checked by replay: the plain sampler applied to the kernel's own
    head outputs with the same Philox draws must give the kernel's audio, and
    the plain network fed that audio must give the kernel's head outputs.
    Two independent free runs (kernel and plain each feeding back its own
    samples) are only logged: a head-output difference far below the
    tolerance still moves a sample by more than one of the 65536 bins, so
    they part within a few steps however right the kernel is.

    cpu_floor: also run the plain version on the CPU, where only the f32
    summation order differs from the plain version on the card, and log how
    far the two plain runs part: no implementation can be held closer to the
    plain version than that.  opts (int8_combine) go to both versions."""
    L, B, _ = enc_t.shape
    tf = forced_feedback(L, B)

    # teacher-forced, greedy: the network and head
    _, out_k = fk.generate(kw, enc_t, seed, greedy=True, tf=tf, collect_out_params=True, **opts)
    _, out_p = fk.generate_plain(kw, enc_t, seed, greedy=True, tf=tf, collect_out_params=True,
                                 **opts)
    out_k, out_p = fk.unpack_head(cfg, out_k), fk.unpack_head(cfg, out_p)
    require(bool(torch.isfinite(out_k).all()), f"{label}: non-finite kernel output")
    step_err = (out_k - out_p).abs().amax(dim=(0, 2))
    err = float(step_err.max())
    scale = max(float(out_p.abs().max()), 1.0)
    limit = rel_tol * scale
    growth = ", ".join(f"steps <{n} {float(step_err[:n].max()):.3e}" for n in (1, 16, 64) if n < L)
    floor = None
    if cpu_floor:
        _, out_c = fk.generate_plain(on_cpu(kw), enc_t.cpu(), seed, greedy=True, tf=tf.cpu(),
                                     collect_out_params=True, **opts)
        floor = float((fk.unpack_head(cfg, out_c) - out_p.cpu()).abs().max())
    log(f"{label} B={B} L={L}: teacher-forced head outputs max|d| kernel-plain {err:.3e} "
        f"({growth}), scale {scale:.3f}, limit {limit:.3e} ({rel_tol:g} x scale)"
        + ("" if floor is None else f"; plain CPU-plain card {floor:.3e}"))
    require(err <= limit, f"{label} B={B}: teacher-forced head outputs differ")

    # sampled free run: sampler exact on the kernel's own head outputs, and the
    # plain network fed the kernel's own audio reproduces those outputs
    audio_k, outs_k = fk.generate(kw, enc_t, seed, collect_out_params=True, **opts)
    require(bool(torch.isfinite(audio_k).all()) and float(audio_k.abs().max()) <= 1.0,
            f"{label} B={B}: free-run audio not finite in [-1, 1]")
    replay = fk.resample_plain(cfg, outs_k, seed)
    tol = 2.0 / cfg.quant_chann if cfg.loss_type != "ce" else 1e-5
    d = (replay - audio_k).abs()
    log(f"{label} B={B}: sampled replay max|d| {float(d.max()):.3e} (one bin {tol:.3e}), "
        f"{float((d <= tol).float().mean()):.4f} of samples within one bin")
    require(bool((d[:, :64] <= tol).all()), f"{label} B={B}: sampler replay differs in the first 64 steps")
    require(float((d <= tol).float().mean()) >= 0.999, f"{label} B={B}: sampler replay differs")
    _, outs_p = fk.generate_plain(kw, enc_t, seed, tf=audio_k.T, collect_out_params=True, **opts)
    outs_k, outs_p = fk.unpack_head(cfg, outs_k), fk.unpack_head(cfg, outs_p)
    ferr = float((outs_k - outs_p).abs().max())
    flimit = rel_tol * max(float(outs_p.abs().max()), 1.0)
    log(f"{label} B={B}: free-run head outputs vs plain fed the same audio max|d| {ferr:.3e} "
        f"(limit {flimit:.3e})")
    require(ferr <= flimit, f"{label} B={B}: free-run head outputs differ")
    direct = fk.generate_plain(kw, enc_t, seed, **opts)
    same = (direct - audio_k).abs() <= tol
    first = int(torch.nonzero(~same.all(0)).min()) if not bool(same.all()) else L
    log(f"{label} B={B}: independent free runs agree within one bin for {first} steps, "
        f"{float(same.float().mean()):.4f} of samples (logged only)")
    return err, floor


def step_counts(cfg, B, out_width, mode=fk.Mode("bf16", "bf16")):
    """(seconds of tensor-core work at the card's peak, operations, weight
    bytes, ring bytes) of one generated sample for the batch.  An int8 product
    (mode.act for w_comb, mode.rs for w_rs) counts 1 byte a weight, the int8
    peak and its f32 scales beside the biases; int8 ring rows are 1 byte a
    value, and in the per-row mode one more byte a row for the exponent code;
    the head stays bf16."""
    W, GW, S, DW, NL = cfg.width, cfg.gate_width, cfg.skip_width, cfg.deconv_width, cfg.num_layers
    m = GW // 2
    comb_macs, rs_macs = NL * (3 * W + DW) * GW, NL * m * (W + S)
    head_macs = W * S + (S + DW) * S + S * out_width
    t_ops = 2 * B * head_macs / PEAK_BF16_FLOPS
    weight_bytes = 2 * head_macs + 4 * (NL * (GW + W + S) + 4 * W + 2 * S + out_width)
    for macs, kind, scales in ((comb_macs, mode.act, GW + (GW + 1 if mode.act == "static" else 0)),
                               (rs_macs, mode.rs, W + S)):
        int8 = kind != "bf16"
        t_ops += 2 * B * macs / (PEAK_INT8_OPS if int8 else PEAK_BF16_FLOPS)
        weight_bytes += macs + 4 * NL * scales if int8 else 2 * macs
    row_bytes = {"bf16": 2 * W, "static": W, "row": W + 1}[mode.act]
    return t_ops, 2 * B * (comb_macs + rs_macs + head_macs), weight_bytes, NL * 3 * B * row_bytes


def replay_graph(step, reps):
    """fn() that replays ``reps`` times one CUDA graph of step(): a yardstick of
    the library's kernels, not of the host's launch rate."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        step()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        step()

    def run():
        for _ in range(reps):
            graph.replay()

    return run


def time_kernel(cfg, kw, enc_t, seed):
    """ms of the kernel, the plain version and the library on the same per-step
    matmuls (cuBLAS for a bf16 product, torch._int_mm for an int8 one: one
    call for the stacked operand, or in the per-row mode one for each of the
    four segments that dequantise apart), and the card's bound, for one call
    of TIMED_STEPS steps."""
    L, B, DW = enc_t.shape
    mode = fk.kernel_mode(kw)
    ms = cuda_ms(lambda: fk.generate(kw, enc_t, seed))
    plain_ms = cuda_ms(lambda: fk.generate_plain(kw, enc_t, seed), reps=1)
    W, GW = cfg.width, cfg.gate_width
    w_comb, w_rs = kw["w_comb"], kw["w_rs"]

    def operand(k, int8):
        if int8:
            return torch.randint(-127, 128, (B, k), device="cuda", dtype=torch.int8)
        return torch.randn((B, k), device="cuda").to(torch.bfloat16)

    # the K ranges of w_comb that are one product each
    cuts = [0, W, 2 * W, 3 * W, 3 * W + DW] if mode.act == "row" else [0, 3 * W + DW]
    a = [operand(k1 - k0, mode.act != "bf16") for k0, k1 in zip(cuts, cuts[1:])]
    g = operand(GW // 2, mode.rs != "bf16")
    d_out = torch.empty((B, GW), device="cuda", dtype=torch.bfloat16)
    rs_out = torch.empty((B, w_rs.shape[2]), device="cuda", dtype=torch.bfloat16)

    def step():
        for li in range(cfg.num_layers):
            for x, k0, k1 in zip(a, cuts, cuts[1:]):
                if mode.act == "bf16":
                    torch.mm(x, w_comb[li], out=d_out)
                else:
                    torch._int_mm(x, w_comb[li, k0:k1])
            if mode.rs == "bf16":
                torch.mm(g, w_rs[li], out=rs_out)
            else:
                torch._int_mm(g, w_rs[li])

    # one step's matmuls captured once, replayed per step
    library_ms = cuda_ms(replay_graph(step, L))
    t_ops, _, weight_bytes, ring_bytes = step_counts(cfg, B, cfg.out_width, mode)
    io_bytes = weight_bytes + L * B * (DW * 2 + 4)  # each input read once, audio written once
    t_ops, t_bytes = L * t_ops, io_bytes / PEAK_HBM_BYTES
    stream_bound_ms = 1e3 * L * (weight_bytes + ring_bytes) / PEAK_HBM_BYTES
    return {
        "ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
        "bound_ms": 1e3 * max(t_ops, t_bytes),
        "bound_by": "operations" if t_ops >= t_bytes else "bytes",
        "stream_bound_ms": max(1e3 * t_ops, stream_bound_ms),
    }


def kernel_breakdown(kw, enc_t, seed):
    """Device time per CUDA kernel over one generate call, by torch.profiler:
    {kernel name: (launches, mean µs)}, the call's wall time in µs, and the
    launches the wrapper counted at the C entry point in that call.  A call
    is one launch of fastgen_persistent, after one quant_enc_kernel in the
    int8 modes.  The profiler keeps only kernels that start and end inside
    its window, as it places them on the host's clock, and that placement
    has been seen to drift by milliseconds in a long process: the call
    therefore sits between two quarter seconds of idle inside the window."""
    from torch.profiler import ProfilerActivity, profile

    fk.generate(kw, enc_t, seed)
    torch.cuda.synchronize()
    fk.generate.kernel_launches = dict.fromkeys(fk.KERNEL_NAMES, 0)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        time.sleep(0.25)
        t0 = time.time()
        fk.generate(kw, enc_t, seed)
        torch.cuda.synchronize()
        wall_us = 1e6 * (time.time() - t0)
        time.sleep(0.25)
    counted = {k: n for k, n in fk.generate.kernel_launches.items() if n}
    out = {}
    names = "|".join(fk.KERNEL_NAMES)
    for evt in prof.key_averages():
        # a whole identifier, then its template arguments, its parameters or the end
        found = re.search(rf"\b({names})(?=[<(]|$)", evt.key)
        if found is not None:
            total = getattr(evt, "device_time_total", None) or evt.cuda_time_total
            out[found.group(1)] = (evt.count, total / max(evt.count, 1))
    return out, wall_us, counted


_BARRIER_US = {}


def barrier_us(grid):
    """Microseconds of one empty grid barrier on ``grid`` blocks: one
    cooperative launch of 2000 barriers, timed by CUDA events."""
    if grid not in _BARRIER_US:
        iters = 2000
        _BARRIER_US[grid] = 1e3 * cuda_ms(lambda: fk.barrier_probe(grid, iters)) / iters
    return _BARRIER_US[grid]


def log_launch(label, cfg, kw, B):
    """The persistent kernel's launch at batch B, as the wrapper plans it:
    grid, blocks per SM, registers and spills, shared memory, and one empty
    barrier's cost.  Returns the launch info."""
    mode = fk.kernel_mode(kw)
    _, out_pad = fk.head_layout(cfg)
    sched, info = fk.launch_plan(cfg.width, cfg.gate_width, cfg.skip_width, cfg.deconv_width, out_pad,
                                 B, mode, "cuda")
    info.update(barrier_us=barrier_us(info["grid"]), smem_bytes=sched.smem_bytes)
    log(f"launch {label} B={B}: grid {info['grid']} ({info['blocks_per_sm']} blocks/SM x "
        f"{info['sms']} SMs, {fk.THREADS} threads), {info['registers']} registers and "
        f"{info['spill_bytes']} B of local memory (spills) a thread, shared memory "
        f"{sched.smem_bytes} B dynamic ({sched.stage_bytes} B a weight stage, "
        f"{fk.OPERAND_SLOTS} x "
        f"{sched.slot_bytes} B operand slots) + {info['static_smem']} B static; items a step: "
        + ", ".join(f"{ph} {len(v)}" for ph, v in sched.items.items())
        + f"; one empty grid barrier {info['barrier_us']:.3f} us")
    return info


def log_timing(label, cfg, kw, enc, tm):
    """The launch line, the timing line and the profile line of one mode at
    one batch.  The profiled call must be one persistent launch after one
    pre-pass in the int8 modes, exactly, as counted where the C entry point
    enqueues them, and the profile may show no launch beyond those; the grid
    barriers the kernel counted must be 2 * NL + 3 a step.  The profile is
    not held to show every launch: in this long process torch.profiler has
    lost the int8 calls' kernels (the pre-pass, or all of them) in most runs,
    as it lost launches of the per-layer kernels' int8 calls before."""
    B = enc.shape[1]
    mode = fk.kernel_mode(kw)
    info = log_launch(label, cfg, kw, B)
    _, ops, weight_bytes, ring_bytes = step_counts(cfg, B, cfg.out_width, mode)
    library = " + ".join(dict.fromkeys("cuBLAS" if k == "bf16" else "torch._int_mm" for k in mode))
    log(f"timing {label} B={B} {TIMED_STEPS} steps: kernel {tm['ms']:.3f} ms "
        f"({1e3 * tm['ms'] / TIMED_STEPS:.1f} us/step), plain {tm['plain_ms']:.3f} ms, "
        f"{library} per-step matmuls {tm['library_ms']:.3f} ms, "
        f"bound {tm['bound_ms']:.4f} ms ({tm['bound_by']}), weight-streaming bound "
        f"{tm['stream_bound_ms']:.3f} ms; per step {ops / 1e9:.2f} G operations, "
        f"{weight_bytes / 1e6:.1f} MB weights, {ring_bytes / 1e6:.2f} MB ring")
    steps = 16
    want = {"fastgen_persistent": 1, **({} if mode.act == "bf16" else {"quant_enc_kernel": 1})}
    for attempt in range(3):  # a profile that lost a kernel is taken again, at most twice
        kernels, wall_us, counted = kernel_breakdown(kw, enc[:steps].contiguous(), seed=1)
        shown = {k: n for k, (n, _) in kernels.items()}
        if shown == want:
            break
        log(f"profile {label} B={B} attempt {attempt + 1} shows {shown}, want {want}")
    barriers = fk.barriers_counted()
    busy = sum(n * us for n, us in kernels.values())
    log(f"profile {label} B={B} one call of {steps} steps: " + ", ".join(
        f"{k} {n} x {us:.1f} us" for k, (n, us) in sorted(kernels.items()))
        + f"; device busy {busy / steps:.1f} us/step of {wall_us / steps:.1f} us/step wall; "
        f"launches counted by the wrapper {counted}; grid barriers counted by the kernel "
        f"{barriers:g} a step = {barriers * info['barrier_us']:.1f} us of empty barriers")
    require(counted == want, f"{label} B={B}: the wrapper launched {counted}, want {want}")
    require(all(n <= want.get(k, 0) for k, n in shown.items()),
            f"{label} B={B}: the profile shows {shown}, more than {want}")
    if shown != want:
        log(f"profile {label} B={B}: the profiler lost launches; the count at the C entry point "
            f"holds them")
    require(barriers == fk.barriers_per_step(cfg),
            f"{label} B={B}: {barriers} grid barriers a step, want {fk.barriers_per_step(cfg)}")
    info["barriers_per_step"] = barriers
    return info


def calibrated_w8a8(model, params, wavs):
    """W8A8 static packed weights calibrated on wavs [B, n] (numpy) and their
    mels, and the calibrated per-layer abs-max."""
    wav = torch.from_numpy(wavs).cuda()
    amax = Fastgen(model).calibrate_act_amax(params, wav, stft.melspectrogram(wav))
    require(bool(torch.isfinite(amax).all()) and float(amax.min()) > 0, "calibrated abs-max")
    kw = fk.build_kernel_weights(model.cfg, params, weight_dtype="int8", act_amax=amax,
                                 gate_static=True)
    return kw, amax


def forced_feedback(L, B):
    t = torch.arange(L, device="cuda")[:, None]
    return (0.6 * torch.sin(0.03 * t * (1 + torch.arange(B, device="cuda")[None]))).float()


def check_single_steps(label, cfg, kw, enc_t, seed, rel_tol, rel_tol_max,
                       flip_share_limit=W8A8_FLIP_SHARE, **opts):
    """Each step of the kernel started from the plain version's state of that
    step, against the plain version's step: teacher-forced greedy head outputs
    and the state that comes back.  Differences cannot pile up over steps, and
    batch rows are independent, so a flipped int8 LSB that cascades through the
    layers spoils one (step, row) pair and no other: all but W8A8_PAIR_SHARE of
    the pairs must hold rel_tol, every pair rel_tol_max, and the int8 ring
    entries written in a step may differ in a share of W8A8_FLIP_SHARE at most.
    In the per-row mode a ring row also holds its exponent code: the share of
    rows written whose code differs (the whole row's payload then moves) is
    counted apart and held to the same limit.  flip_share_limit: that limit (a
    mode with a bf16 product needs a wider one: its f32 sums come in another
    order, which moves a quantiser far more often than expf's last bit does).
    opts (int8_combine) go to both versions.  Returns (share of pairs over rel_tol, largest error, largest
    error of the pairs that hold rel_tol, share of codes that differ)."""
    L, B, _ = enc_t.shape
    W = cfg.width
    tf = forced_feedback(L, B)
    state = fk.init_state(cfg, B, "cuda", fk.kernel_mode(kw).act)
    errs, ring_diff, code_diff, scale = [], 0, 0, 1.0
    for t in range(L):
        mine = (state[0].clone(), state[1].clone(), state[2])
        step = dict(greedy=True, tf=tf[t : t + 1], collect_out_params=True, return_state=True, **opts)
        _, out_p, state = fk.generate_plain(kw, enc_t[t : t + 1], seed, state=state, **step)
        _, out_k, mine = fk.generate(kw, enc_t[t : t + 1], seed, state=mine, **step)
        out_k, out_p = fk.unpack_head(cfg, out_k), fk.unpack_head(cfg, out_p)
        errs.append((out_k - out_p).abs().amax(dim=(1, 2)))
        scale = max(scale, float(out_p.abs().max()))
        ring_diff += int((mine[0][..., :W] != state[0][..., :W]).sum())
        code_diff += int((mine[0][..., W:] != state[0][..., W:]).any(-1).sum())
        require(bool(torch.equal(mine[1], state[1])) and mine[2] == state[2] == t + 1,
                f"{label}: taps or step count differ after step {t}")
    errs = torch.stack(errs)  # [L, B]
    over = errs > rel_tol * scale
    pair_share, err = float(over.float().mean()), float(errs.max())
    held = float(errs[~over].max()) if not bool(over.all()) else float("nan")
    flip_share = ring_diff / (L * B * W * cfg.num_layers)
    code_share = code_diff / (L * B * cfg.num_layers)
    log(f"{label} B={B}: {L} single steps from the plain version's state, head outputs per (step, "
        f"row): {int(over.sum())} of {L * B} pairs over {rel_tol * scale:.3e} ({rel_tol:g} x scale "
        f"{scale:.3f}; limit {W8A8_PAIR_SHARE:g} of them), the others max|d| {held:.3e}, largest "
        f"{err:.3e} (limit {rel_tol_max * scale:.3e}); ring entries written that differ: "
        f"{ring_diff}, {flip_share:.2e} of them (limit {flip_share_limit:g})"
        + (f"; exponent codes written that differ: {code_diff}, {code_share:.2e} of the rows"
           if state[0].shape[-1] > W else ""))
    require(pair_share <= W8A8_PAIR_SHARE and err <= rel_tol_max * scale
            and flip_share <= flip_share_limit and code_share <= flip_share_limit,
            f"{label} B={B}: single steps differ from the plain version's")
    return pair_share, err, held, code_share


def check_w8a8_vs_bf16(label, cfg, kw_bf16, kw_w8a8, enc_t, seed, limit=W8A8_VS_BF16,
                       names=("W8A8", "bf16")):
    """Teacher-forced greedy head outputs of the two modes on the card; returns
    their distance as a share of the second one's (bf16's) output scale."""
    L, B, _ = enc_t.shape
    tf = forced_feedback(L, B)
    outs = [fk.unpack_head(cfg, fk.generate(kw, enc_t, seed, greedy=True, tf=tf,
                                            collect_out_params=True)[1])
            for kw in (kw_bf16, kw_w8a8)]
    err, scale = float((outs[1] - outs[0]).abs().max()), float(outs[0].abs().max())
    log(f"{label} B={B} L={L}: {names[0]} vs {names[1]} teacher-forced head outputs max|d| "
        f"{err:.3e}, {names[1]} scale {scale:.3f}, {err / scale:.4f} of scale (limit {limit:g})")
    require(err < limit * scale,
            f"{label}: {names[0]} parts from {names[1]} by more than {limit:g} of scale")
    return err / scale


def check_streaming(label, cfg, kw, enc_t, seed, rel_tol):
    """Chained chunks of STREAM_CHUNK against the one-shot call, bit for bit,
    greedy and sampled (audio and head outputs), and the chained run's final
    state against the plain version's (teacher-forced, so that both see the
    same feedback).  Returns the ring's largest distance from the plain one."""
    L, B, _ = enc_t.shape
    W = cfg.width
    int8_ring = fk.kernel_mode(kw).act != "bf16"

    def chained(**opts):
        state, audio, outs = None, [], []
        for c0 in range(0, L, STREAM_CHUNK):
            tf = opts.get("tf")
            a, o, state = fk.generate(kw, enc_t[c0 : c0 + STREAM_CHUNK], seed,
                                      greedy=opts.get("greedy", False),
                                      tf=None if tf is None else tf[c0 : c0 + STREAM_CHUNK],
                                      collect_out_params=True, state=state, return_state=True)
            audio.append(a)
            outs.append(o)
        return torch.cat(audio, 1), torch.cat(outs, 1), state

    for greedy in (True, False):
        audio, outs, state = fk.generate(kw, enc_t, seed, greedy=greedy, collect_out_params=True,
                                         return_state=True)
        c_audio, c_outs, c_state = chained(greedy=greedy)
        torch.cuda.synchronize()
        same = (bool(torch.equal(audio, c_audio)) and bool(torch.equal(outs, c_outs))
                and bool(torch.equal(state[0], c_state[0])) and bool(torch.equal(state[1], c_state[1]))
                and state[2] == c_state[2] == L)
        log(f"{label} streaming B={B} L={L} chunk {STREAM_CHUNK} {'greedy' if greedy else 'sampled'}: "
            f"chained == one-shot bit for bit (audio, head outputs, state): {same}")
        require(same, f"{label}: chained chunks differ from the one-shot call")
        if not greedy:
            require(float(audio.std()) > 0, f"{label}: sampled run is constant")
    tf = forced_feedback(L, B)
    _, _, c_state = chained(greedy=True, tf=tf)
    _, p_state = fk.generate_plain(kw, enc_t, seed, greedy=True, tf=tf, return_state=True)
    require(bool(torch.equal(c_state[1], p_state[1])) and c_state[2] == p_state[2],
            f"{label}: final taps or step differ from the plain version's")
    d = (c_state[0][..., :W].float() - p_state[0][..., :W].float()).abs()
    if int8_ring:
        share = float((d > 0).float().mean())
        clipped = float((c_state[0][..., :W].abs() == 127).float().mean())
        codes = (c_state[0][..., W:] != p_state[0][..., W:]).any(-1)  # per-row mode: lane W
        log(f"{label} streaming final state: int8 ring max|d| {float(d.max()):.0f} LSB, "
            f"{share:.2e} of entries differ; {clipped:.2e} of ring entries sit at +-127 (clipped)"
            + (f"; {float(codes.float().mean()):.2e} of the rows' exponent codes differ"
               if codes.numel() else ""))
        # a loose guard: over a run the flips pile up (see W8A8_REL_TOL); the close
        # comparison of the state is check_single_steps'
        require(share <= W8A8_STATE_SHARE, f"{label}: final ring differs from the plain one")
    else:
        # the rows are bf16(l): the f32 distance that rel_tol allows, and the one
        # bf16 step (2^-7 of the value) by which the rounding can then part
        scale = max(float(p_state[0].float().abs().max()), 1.0)
        limit = (rel_tol + 2.0 ** -7) * scale
        log(f"{label} streaming final state: bf16 ring max|d| {float(d.max()):.3e}, scale {scale:.3f} "
            f"(limit {limit:.3e})")
        require(float(d.max()) <= limit, f"{label}: final ring differs from the plain one")
    return float(d.max())


def w8a8_phases(model, params, kw_bf16, gmodel, gparams, gdir, mels):
    """Phases 12 to 18; returns the W8A8 static kernels' record, and the
    calibrated full-width weights and abs-max for the phases that compare with them."""
    cfg = model.cfg
    fg = Fastgen(model)
    # ---- 12. calibration, packing, kernel vs plain ----
    kw, amax = calibrated_w8a8(model, params, synthetic_wavs(8, 16000, 77))
    log(f"calibrated act_amax on 8 rows x 1 s: min {float(amax.min()):.3f} max {float(amax.max()):.3f}; "
        f"int8 layer weights {(kw['w_comb'].numel() + kw['w_rs'].numel()) / 1e6:.1f} MB")
    enc8 = conditioning(model, params, B=8, L=256, seed=1)
    pair_share, step_err, step_held, _ = check_single_steps(
        "w8a8 mol full width", cfg, kw, enc8[:96], seed=5, rel_tol=REL_TOL,
        rel_tol_max=W8A8_FULL_WIDTH_RUN_TOL)
    run_err, run_floor = check_kernel("w8a8 mol full width", cfg, kw, enc8, seed=5,
                                      rel_tol=W8A8_FULL_WIDTH_RUN_TOL, cpu_floor=True)
    # every batch tile: single steps at full depth, whole runs at full depth (loose) and at 4 layers
    m4, p4, kw4_bf16 = full_model("configs/wavenet_mol.json", num_layers=4)
    kw4, _ = calibrated_w8a8(m4, p4, synthetic_wavs(8, 16000, 77))
    shallow_err = 0.0
    vs_bf16 = check_w8a8_vs_bf16("mol 4 layers", m4.cfg, kw4_bf16, kw4, enc8, seed=5)
    for B in MAIN_BATCHES:
        enc = conditioning(model, params, B=B, L=CHECK_STEPS, seed=20 + B)
        share, err, held, _ = check_single_steps("w8a8 mol full width", cfg, kw, enc, seed=8,
                                              rel_tol=REL_TOL,
                                              rel_tol_max=W8A8_FULL_WIDTH_RUN_TOL)
        pair_share, step_err, step_held = max(pair_share, share), max(step_err, err), max(step_held, held)
        err, _ = check_kernel("w8a8 mol full width", cfg, kw, enc, seed=8,
                              rel_tol=W8A8_FULL_WIDTH_RUN_TOL)
        run_err = max(run_err, err)
        err, _ = check_kernel("w8a8 mol 4 layers", m4.cfg, kw4, enc, seed=8, rel_tol=W8A8_REL_TOL)
        shallow_err = max(shallow_err, err)
    del m4, p4, kw4, kw4_bf16
    for path in ("configs/wavenet_ce.json", "configs/wavenet_gauss.json"):
        m3, p3, _ = full_model(path, num_layers=4)
        kw3, _ = calibrated_w8a8(m3, p3, synthetic_wavs(4, 4000, 78))
        check_kernel(f"w8a8 {m3.cfg.loss_type} 4 layers", m3.cfg, kw3,
                     conditioning(m3, p3, B=8, L=256, seed=2), seed=6, rel_tol=W8A8_REL_TOL)
    gwavs = np.stack([wav_io.read_wav(os.path.join(GOLDEN, f"gen_golden_mol_{i}.wav"))[0][:8000]
                      for i in (0, 1)])
    gkw, gamax = calibrated_w8a8(gmodel, gparams, gwavs)
    genc = conditioning(gmodel, gparams, B=8, L=256, seed=3)
    check_single_steps("w8a8 golden tiny_mol", gmodel.cfg, gkw, genc[:48], seed=7, rel_tol=REL_TOL,
                       rel_tol_max=REL_TOL)
    check_kernel("w8a8 golden tiny_mol", gmodel.cfg, gkw, genc, seed=7, rel_tol=REL_TOL)

    # ---- 13. W8A8 against bf16 ----
    vs_bf16 = max(vs_bf16, check_w8a8_vs_bf16(
        "golden tiny_mol", gmodel.cfg, fk.build_kernel_weights(gmodel.cfg, gparams), gkw, genc, seed=7))
    vs_bf16_full = check_w8a8_vs_bf16("mol full width", cfg, kw_bf16, kw, enc8, seed=5,
                                      limit=W8A8_FULL_WIDTH_RUN_TOL)

    # ---- 14. streaming, both modes ----
    enc_s = conditioning(model, params, B=8, L=STREAM_STEPS, seed=4)
    check_streaming("bf16 mol full width", cfg, kw_bf16, enc_s, seed=9, rel_tol=FULL_WIDTH_REL_TOL)
    check_streaming("w8a8 mol full width", cfg, kw, enc_s, seed=9, rel_tol=FULL_WIDTH_REL_TOL)

    # ---- 15. the W8A8 main path ----
    fg.generate_cuda(params, mels[MAIN_BATCHES[0]], seed=0, length=16, kw=kw)  # warm-up
    torch.cuda.synchronize()
    fk.generate.launches = 0
    fk.generate.launches_by_mode = {"bf16": 0, "w8a8": 0}
    runs = {}
    for B in MAIN_BATCHES:
        t0 = time.time()
        audio = fg.generate_cuda(params, mels[B], seed=B, length=MAIN_LENGTH, weight_dtype="int8",
                                 act_amax=amax, gate_static=True, kw=kw)
        torch.cuda.synchronize()
        runs[B] = (audio, time.time() - t0)
    launches = fk.generate.launches
    by_mode = dict(fk.generate.launches_by_mode)
    for B, (audio, dt) in runs.items():
        require(tuple(audio.shape) == (B, MAIN_LENGTH), f"W8A8 main path shape {tuple(audio.shape)}")
        require(bool(torch.isfinite(audio).all()) and float(audio.abs().max()) <= 1.0,
                f"W8A8 main path B={B}: audio not finite in [-1, 1]")
        log(f"W8A8 main path B={B} L={MAIN_LENGTH}: {dt:.3f} s, {1e6 * dt / MAIN_LENGTH:.1f} us/step, "
            f"{B * MAIN_LENGTH / 16000 / dt:.2f} audio-sec/s, audio std {float(audio.std()):.4f}")
    log(f"W8A8 main path kernel launches: generate {launches}, by mode {by_mode} "
        f"(one persistent launch a call, after the conditioning pre-pass)")
    require(launches == len(MAIN_BATCHES) and by_mode == {"bf16": 0, "w8a8": launches},
            "the W8A8 main path did not go through the int8 kernels alone")
    # streamed against one-shot on one encoding: the kernels are deterministic, but cuDNN's
    # transposed convolution is not bit-stable between calls, so the mel is upsampled once
    B = MAIN_BATCHES[0]
    enc = model.deconv_stack(params, mels[B])
    again = model.deconv_stack(params, mels[B])
    log(f"deconv of the same mel twice: equal bit for bit: {bool(torch.equal(enc, again))}, max|d| "
        f"{float((enc.float() - again.float()).abs().max()):.3e}")
    timed = {}
    for chunk in (None, 500):
        t0 = time.time()
        audio = fg.generate_cuda(params, None, seed=B, length=MAIN_LENGTH, kw=kw, encoding=enc,
                                 chunk=chunk)
        torch.cuda.synchronize()
        timed[chunk] = (audio, time.time() - t0)
    same = bool(torch.equal(timed[500][0], timed[None][0]))
    log(f"W8A8 main path B={B} L={MAIN_LENGTH} from one encoding: one-shot {timed[None][1]:.3f} s, "
        f"streamed in chunks of 500 {timed[500][1]:.3f} s "
        f"({1e6 * timed[500][1] / MAIN_LENGTH:.1f} us/step); equal bit for bit: {same}")
    require(same, "the streamed W8A8 main-path run differs from its one-shot run")
    require(bool(torch.isfinite(timed[500][0]).all()) and float(timed[500][0].abs().max()) <= 1.0,
            "streamed W8A8 audio not finite in [-1, 1]")
    del runs, timed, enc, again

    # ---- 16. timing ----
    timings = {}
    for B in MAIN_BATCHES + (SHIPPED_BATCH,):  # and the JAX package's shipped serving batch
        enc = conditioning(model, params, B=B, L=TIMED_STEPS, seed=10 + B)
        timings[B] = time_kernel(cfg, kw, enc, seed=1)
        log_timing("w8a8", cfg, kw, enc, timings[B])

    # ---- 17. golden W8A8 free run tracks its conditioning ----
    n = gwavs.shape[1]
    gmels = stft.melspectrogram_np(gwavs)
    audio = Fastgen(gmodel).generate_cuda(gparams, torch.from_numpy(gmels).cuda(), seed=7, length=n,
                                          weight_dtype="int8", act_amax=gamax,
                                          gate_static=True).cpu().numpy()
    require(np.isfinite(audio).all() and np.abs(audio).max() <= 1.0, "golden W8A8 free-run audio")
    matched, mismatched = mel_corr(audio, gmels, n)
    log(f"golden W8A8 free run mel corr: matched {matched:.4f} mismatched {mismatched:.4f}")
    require(matched > mismatched + 0.05, "golden W8A8 free run does not track its conditioning")

    # ---- 18. eval path, W8A8 streamed ----
    with tempfile.TemporaryDirectory() as tmp:
        src, out = os.path.join(tmp, "src"), os.path.join(tmp, "gen")
        os.makedirs(src)
        for i in (0, 1):
            wav_io.write_wav(os.path.join(src, f"utt_{i}.wav"), gwavs[i])
        paths = generate_wavenet(src, os.path.join(gdir, "params.npz"),
                                 os.path.join(gdir, "meta.json"), out, batch_size=8, seed=0,
                                 device="cuda", sample_length=4000, int8=True, int8_static=True,
                                 streaming_chunk=1000)
        require(len(paths) == 2, f"W8A8 eval wrote {len(paths)} files")
        for p in paths:
            wav, sr = wav_io.read_wav(p)
            require(sr == 16000 and len(wav) >= 4000 and np.isfinite(wav).all()
                    and np.abs(wav).max() > 0, f"W8A8 eval output {p}")
        log(f"W8A8 eval path (streaming_chunk 1000) wrote {[os.path.basename(p) for p in paths]}")

    big = timings[MAIN_BATCHES[-1]]
    return kw, amax, {
        "name": "fastgen_generate_w8a8",
        "route": "cuda",
        "source": "nsynth_wavenet_tpu_torch/csrc/fastgen_kernel.cu",
        "replaces": "nsynth_wavenet_tpu/ops/fastgen_kernel.py:291",
        "launches": launches,
        "max_abs_err": shallow_err,
        "rel_tol": W8A8_REL_TOL,
        "step_pairs_over_share": pair_share,
        "step_max_abs_err_within": step_held,
        "step_max_abs_err": step_err,
        "run_max_abs_err": run_err,
        "run_rel_tol": W8A8_FULL_WIDTH_RUN_TOL,
        "run_plain_cpu_vs_card_err": run_floor,
        "vs_bf16_share_of_scale": vs_bf16,
        "vs_bf16_share_of_scale_full_depth": vs_bf16_full,
        "ms": big["ms"],
        "plain_ms": big["plain_ms"],
        "bound_ms": big["bound_ms"],
        "bound_by": big["bound_by"],
        "library_ms": big["library_ms"],
    }


# The calibration-free modes against their plain version: the limits of the
# static mode above hold for every all-int8 mode (readings in PERF.md: single
# steps at full width at most 17 of 24 576 pairs over REL_TOL x scale, ring
# payloads that differ up to 5.9e-4, exponent codes up to 8.7e-5 of the rows).
# A mode with a bf16 product (bf16 res/skip under an int8 ring, int8 res/skip
# under a bf16 ring) sums in f32 in another order than torch.matmul, which moves
# a quantiser far more often than expf's last bit: up to 1.1e-2 of the ring
# payloads and 1.2e-3 of the codes differ and some percent of the pairs pass
# REL_TOL, so their pairs are held to the bf16 mode's FULL_WIDTH_REL_TOL and
# their ring entries to BF16_PRODUCT_FLIP_SHARE (a bf16 ring holds roundings,
# not quantised values: no ring limit there).
BF16_PRODUCT_FLIP_SHARE = 5e-2
# (label, build_kernel_weights options beyond act_amax, generate options)
OTHER_MODES = (
    ("row + gate static", dict(weight_dtype="int8", gate_static=True), {}),
    ("row + bf16 rs", dict(weight_dtype="int8", rs_dtype="bf16"), {}),
    ("static + gate row", dict(weight_dtype="int8", static=True), {}),
    ("static + bf16 rs", dict(weight_dtype="int8", rs_dtype="bf16", static=True), {}),
    ("row, bf16 combine", dict(weight_dtype="int8"), dict(int8_combine="bf16")),
    ("bf16 + int8 rs, gate row", dict(weight_dtype="bf16", rs_dtype="int8"), {}),
    ("bf16 + int8 rs, gate static", dict(weight_dtype="bf16", rs_dtype="int8", gate_static=True), {}),
)


def pack(cfg, params, amax, static=False, **build):
    """build_kernel_weights with the calibrated abs-max where the mode wants one."""
    return fk.build_kernel_weights(cfg, params, act_amax=amax if static else None, **build)


def row_phases(model, params, kw_bf16, kw_static, amax, gmodel, gparams, gdir, mels):
    """Phases 19 to 26: W8A8 with per-row scales, nothing calibrated, and the
    other combinations of activation scale and res/skip type; returns the
    per-row kernels' record."""
    cfg = model.cfg
    fg = Fastgen(model)
    # ---- 19. packing without calibration; the row-mode kernels vs plain ----
    kw = fk.build_kernel_weights(cfg, params, weight_dtype="int8")
    require(tuple(fk.kernel_mode(kw)) == ("row", "row") and "s_act_inv" not in kw,
            "int8 weights without act_amax are not the per-row mode")
    enc8 = conditioning(model, params, B=8, L=256, seed=1)
    pair_share, step_err, step_held, code_share = check_single_steps(
        "w8a8 row mol full width", cfg, kw, enc8[:96], seed=5, rel_tol=REL_TOL,
        rel_tol_max=W8A8_FULL_WIDTH_RUN_TOL)
    run_err, _ = check_kernel("w8a8 row mol full width", cfg, kw, enc8, seed=5,
                              rel_tol=W8A8_FULL_WIDTH_RUN_TOL)
    m4, p4, kw4_bf16 = full_model("configs/wavenet_mol.json", num_layers=4)
    wav4 = torch.from_numpy(synthetic_wavs(8, 16000, 77)).cuda()
    amax4 = Fastgen(m4).calibrate_act_amax(p4, wav4, stft.melspectrogram(wav4))
    kw4 = fk.build_kernel_weights(m4.cfg, p4, weight_dtype="int8")
    shallow_err = 0.0
    for B in MAIN_BATCHES:
        enc = conditioning(model, params, B=B, L=CHECK_STEPS, seed=20 + B)
        share, err, held, codes = check_single_steps(
            "w8a8 row mol full width", cfg, kw, enc, seed=8, rel_tol=REL_TOL,
            rel_tol_max=W8A8_FULL_WIDTH_RUN_TOL)
        pair_share, step_err = max(pair_share, share), max(step_err, err)
        step_held, code_share = max(step_held, held), max(code_share, codes)
        err, _ = check_kernel("w8a8 row mol full width", cfg, kw, enc, seed=8,
                              rel_tol=W8A8_FULL_WIDTH_RUN_TOL)
        run_err = max(run_err, err)
        err, _ = check_kernel("w8a8 row mol 4 layers", m4.cfg, kw4, enc, seed=8, rel_tol=W8A8_REL_TOL)
        shallow_err = max(shallow_err, err)
    for path in ("configs/wavenet_ce.json", "configs/wavenet_gauss.json"):
        m3, p3, _ = full_model(path, num_layers=4)
        kw3 = fk.build_kernel_weights(m3.cfg, p3, weight_dtype="int8")
        err, _ = check_kernel(f"w8a8 row {m3.cfg.loss_type} 4 layers", m3.cfg, kw3,
                              conditioning(m3, p3, B=8, L=256, seed=2), seed=6, rel_tol=W8A8_REL_TOL)
        shallow_err = max(shallow_err, err)
    del m3, p3, kw3
    gkw = fk.build_kernel_weights(gmodel.cfg, gparams, weight_dtype="int8")
    genc = conditioning(gmodel, gparams, B=8, L=256, seed=3)
    check_single_steps("w8a8 row golden tiny_mol", gmodel.cfg, gkw, genc[:48], seed=7,
                       rel_tol=REL_TOL, rel_tol_max=REL_TOL)
    check_kernel("w8a8 row golden tiny_mol", gmodel.cfg, gkw, genc, seed=7, rel_tol=REL_TOL)

    # ---- 20. the other combinations, and the bf16 combine ----
    enc64 = conditioning(model, params, B=MAIN_BATCHES[0], L=CHECK_STEPS, seed=20 + MAIN_BATCHES[0])
    other_ms = {}
    for label, build, opts in OTHER_MODES:
        kw_o = pack(cfg, params, amax, **build)
        mode = fk.kernel_mode(kw_o)
        exact = "bf16" not in mode  # both products int8: only a quantiser's last bit parts the two
        check_single_steps(
            f"{label} full width", cfg, kw_o, enc64[:24], seed=8,
            rel_tol=REL_TOL if exact else FULL_WIDTH_REL_TOL, rel_tol_max=W8A8_FULL_WIDTH_RUN_TOL,
            flip_share_limit=(W8A8_FLIP_SHARE if exact else
                              1.0 if mode.act == "bf16" else BF16_PRODUCT_FLIP_SHARE), **opts)
        check_kernel(f"{label} 4 layers", m4.cfg, pack(m4.cfg, p4, amax4, **build), enc64, seed=8,
                     rel_tol=W8A8_REL_TOL, **opts)
        other_ms[label] = kw_o, opts
    del kw_o

    # ---- 21. row mode against bf16 and against the static mode ----
    gkw_bf16 = fk.build_kernel_weights(gmodel.cfg, gparams)
    gwavs = np.stack([wav_io.read_wav(os.path.join(GOLDEN, f"gen_golden_mol_{i}.wav"))[0][:8000]
                      for i in (0, 1)])
    gkw_static, _ = calibrated_w8a8(gmodel, gparams, gwavs)
    vs_bf16 = vs_static = 0.0
    for label, c, bf, st, row, row_rs in (
            ("golden tiny_mol", gmodel.cfg, gkw_bf16, gkw_static, gkw,
             fk.build_kernel_weights(gmodel.cfg, gparams, weight_dtype="int8", rs_dtype="bf16")),
            ("mol 4 layers", m4.cfg, kw4_bf16, pack(m4.cfg, p4, amax4, weight_dtype="int8",
                                                   static=True, gate_static=True), kw4,
             fk.build_kernel_weights(m4.cfg, p4, weight_dtype="int8", rs_dtype="bf16"))):
        enc = genc if c is gmodel.cfg else enc8
        seed = 7 if c is gmodel.cfg else 5
        d_row = check_w8a8_vs_bf16(label, c, bf, row, enc, seed, names=("W8A8 row", "bf16"))
        d_rs = check_w8a8_vs_bf16(label, c, bf, row_rs, enc, seed,
                                  names=("W8A8 row with bf16 res/skip", "bf16"))
        require(d_rs <= 1.5 * d_row + 1e-6,
                f"{label}: bf16 res/skip is further from bf16 than 1.5 x the all-int8 distance")
        vs_bf16 = max(vs_bf16, d_row)
        vs_static = max(vs_static, check_w8a8_vs_bf16(label, c, st, row, enc, seed,
                                                      names=("W8A8 row", "W8A8 static")))
    vs_bf16_full = check_w8a8_vs_bf16("mol full width", cfg, kw_bf16, kw, enc8, seed=5,
                                      limit=W8A8_FULL_WIDTH_RUN_TOL, names=("W8A8 row", "bf16"))
    check_w8a8_vs_bf16("mol full width", cfg, kw_static, kw, enc8, seed=5,
                       limit=W8A8_FULL_WIDTH_RUN_TOL, names=("W8A8 row", "W8A8 static"))
    del m4, p4, kw4, kw4_bf16, gkw_static, gkw_bf16

    # ---- 22. streaming in row mode ----
    enc_s = conditioning(model, params, B=8, L=STREAM_STEPS, seed=4)
    check_streaming("w8a8 row mol full width", cfg, kw, enc_s, seed=9, rel_tol=FULL_WIDTH_REL_TOL)

    # ---- 23. the slice's main path: calibration-free W8A8 ----
    fg.generate_cuda(params, mels[MAIN_BATCHES[0]], seed=0, length=16, weight_dtype="int8")  # warm-up
    torch.cuda.synchronize()
    fk.generate.launches = 0
    fk.generate.launches_by_mode = {"bf16": 0, "w8a8": 0, "w8a8_row": 0}
    runs = {}
    for B in MAIN_BATCHES:
        t0 = time.time()
        audio = fg.generate_cuda(params, mels[B], seed=B, length=MAIN_LENGTH, weight_dtype="int8")
        torch.cuda.synchronize()
        runs[B] = (audio, time.time() - t0)
    launches = fk.generate.launches
    by_mode = dict(fk.generate.launches_by_mode)
    for B, (audio, dt) in runs.items():
        require(tuple(audio.shape) == (B, MAIN_LENGTH), f"row main path shape {tuple(audio.shape)}")
        require(bool(torch.isfinite(audio).all()) and float(audio.abs().max()) <= 1.0,
                f"row main path B={B}: audio not finite in [-1, 1]")
        log(f"W8A8 row main path B={B} L={MAIN_LENGTH}: {dt:.3f} s (int8 packing included), "
            f"{1e6 * dt / MAIN_LENGTH:.1f} us/step, {B * MAIN_LENGTH / 16000 / dt:.2f} audio-sec/s, "
            f"audio std {float(audio.std()):.4f}")
    log(f"W8A8 row main path kernel launches: generate {launches}, by mode {by_mode} "
        f"(one persistent launch a call, after the conditioning pre-pass)")
    require(launches == len(MAIN_BATCHES)
            and by_mode == {"bf16": 0, "w8a8": 0, "w8a8_row": launches},
            "the calibration-free main path did not go through the per-row int8 kernels alone")
    B = MAIN_BATCHES[0]
    enc = model.deconv_stack(params, mels[B])
    timed = {}
    for chunk in (None, 500):
        t0 = time.time()
        audio = fg.generate_cuda(params, None, seed=B, length=MAIN_LENGTH, kw=kw, encoding=enc,
                                 chunk=chunk)
        torch.cuda.synchronize()
        timed[chunk] = (audio, time.time() - t0)
    same = bool(torch.equal(timed[500][0], timed[None][0]))
    log(f"W8A8 row main path B={B} L={MAIN_LENGTH} from one encoding: one-shot {timed[None][1]:.3f} s, "
        f"streamed in chunks of 500 {timed[500][1]:.3f} s "
        f"({1e6 * timed[500][1] / MAIN_LENGTH:.1f} us/step); equal bit for bit: {same}")
    require(same, "the streamed row-mode main-path run differs from its one-shot run")
    require(bool(torch.isfinite(timed[500][0]).all()) and float(timed[500][0].abs().max()) <= 1.0,
            "streamed row-mode audio not finite in [-1, 1]")
    del runs, timed, enc

    # ---- 24. timing, with the bf16 and the static mode in the same call ----
    timings = {}
    for B in MAIN_BATCHES:
        enc = conditioning(model, params, B=B, L=TIMED_STEPS, seed=10 + B)
        timings[B] = time_kernel(cfg, kw, enc, seed=1)
        log_timing("w8a8 row", cfg, kw, enc, timings[B])
        beside = {"bf16": (kw_bf16, {}), "w8a8 static": (kw_static, {}), **other_ms}
        log(f"timing B={B} {TIMED_STEPS} steps, same call: w8a8 row {timings[B]['ms']:.3f} ms; "
            + "; ".join(f"{name} {cuda_ms(lambda: fk.generate(k, enc, 1, **o)):.3f} ms"
                        for name, (k, o) in beside.items()))
    del other_ms, beside

    # ---- 25. golden row-mode free run tracks its conditioning ----
    n = gwavs.shape[1]
    gmels = stft.melspectrogram_np(gwavs)
    audio = Fastgen(gmodel).generate_cuda(gparams, torch.from_numpy(gmels).cuda(), seed=7, length=n,
                                          weight_dtype="int8").cpu().numpy()
    require(np.isfinite(audio).all() and np.abs(audio).max() <= 1.0, "golden row-mode free-run audio")
    matched, mismatched = mel_corr(audio, gmels, n)
    log(f"golden W8A8 row free run mel corr: matched {matched:.4f} mismatched {mismatched:.4f}")
    require(matched > mismatched + 0.05, "golden row-mode free run does not track its conditioning")

    # ---- 26. eval path, calibration-free: wavs, and a mel-only source ----
    with tempfile.TemporaryDirectory() as tmp:
        src, mel_src = os.path.join(tmp, "src"), os.path.join(tmp, "mels")
        os.makedirs(src)
        os.makedirs(mel_src)
        for i in (0, 1):
            wav_io.write_wav(os.path.join(src, f"utt_{i}.wav"), gwavs[i])
        np.save(os.path.join(mel_src, "utt_0.npy"), gmels[0, :16])
        for source, want, n_min in ((src, 2, 4000), (mel_src, 1, 16 * gmodel.cfg.frame_shift)):
            for chunk in (None, 1000):
                paths = generate_wavenet(source, os.path.join(gdir, "params.npz"),
                                         os.path.join(gdir, "meta.json"),
                                         os.path.join(tmp, f"gen_{want}_{chunk}"), batch_size=8,
                                         seed=0, device="cuda", sample_length=4000, int8=True,
                                         streaming_chunk=chunk)
                require(len(paths) == want, f"row-mode eval wrote {len(paths)} files")
                for p in paths:
                    wav, sr = wav_io.read_wav(p)
                    require(sr == 16000 and len(wav) >= n_min and np.isfinite(wav).all()
                            and np.abs(wav).max() > 0, f"row-mode eval output {p}")
                log(f"W8A8 row eval path ({'wav' if want == 2 else 'mel-only .npy'} sources, "
                    f"streaming_chunk {chunk}) wrote {[os.path.basename(p) for p in paths]}")

    big = timings[MAIN_BATCHES[-1]]
    return {
        "name": "fastgen_generate_w8a8_row",
        "route": "cuda",
        "source": "nsynth_wavenet_tpu_torch/csrc/fastgen_kernel.cu",
        "replaces": "nsynth_wavenet_tpu/ops/fastgen_kernel.py:291 (branches :229-241, :517-560, "
                    ":593-615, :627-629, :641)",
        "launches": launches,
        "max_abs_err": shallow_err,
        "rel_tol": W8A8_REL_TOL,
        "step_pairs_over_share": pair_share,
        "step_max_abs_err_within": step_held,
        "step_max_abs_err": step_err,
        "step_codes_differ_share": code_share,
        "run_max_abs_err": run_err,
        "run_rel_tol": W8A8_FULL_WIDTH_RUN_TOL,
        "vs_bf16_share_of_scale": vs_bf16,
        "vs_bf16_share_of_scale_full_depth": vs_bf16_full,
        "vs_static_share_of_scale": vs_static,
        "ms": big["ms"],
        "plain_ms": big["plain_ms"],
        "bound_ms": big["bound_ms"],
        "bound_by": big["bound_by"],
        "library_ms": big["library_ms"],
    }


def synthetic_wavs(B, n, seed):
    rng = np.random.RandomState(seed)
    t = np.arange(n) / 16000.0
    f0 = rng.uniform(100, 300, size=(B, 1))
    wav = 0.4 * np.sin(2 * np.pi * f0 * t[None]) + 0.02 * rng.randn(B, n)
    return np.clip(wav, -0.99, 0.99).astype(np.float32)


def mel_corr(audio, mels, n):
    matched, mismatched = [], []
    for i in range(len(audio)):
        gen = stft.melspectrogram_np(audio[i][:n])
        for j in range(len(mels)):
            c = np.corrcoef(gen.ravel(), mels[j, : gen.shape[0]].ravel())[0, 1]
            (matched if i == j else mismatched).append(c)
    return float(np.mean(matched)), float(np.mean(mismatched))


def tf32_phase(gdir):
    """Phase 32: PyTorch's default TF32 settings (cuDNN convolutions may use
    TF32, matmuls not) for the phase's duration, cuDNN deterministic.
    evaluation.generate_wavenet on the f32 golden tiny_mol must upsample its
    mels exactly as the deconv stack does with TF32 off, bit for bit; the
    same deconv with TF32 allowed is logged beside it."""
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32,
             torch.backends.cudnn.deterministic)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cudnn.deterministic = True
    seen, orig = [], Wavenet.deconv_stack

    def recording(self, params, mel):
        enc = orig(self, params, mel)
        seen.append((self, params, mel.clone(), enc.clone()))
        return enc

    try:
        Wavenet.deconv_stack = recording
        with tempfile.TemporaryDirectory() as tmp:
            src = os.path.join(tmp, "src")
            os.makedirs(src)
            for i in (0, 1):
                wav, _ = wav_io.read_wav(os.path.join(GOLDEN, f"gen_golden_mol_{i}.wav"))
                wav_io.write_wav(os.path.join(src, f"utt_{i}.wav"), wav)
            generate_wavenet(src, os.path.join(gdir, "params.npz"), os.path.join(gdir, "meta.json"),
                             os.path.join(tmp, "gen"), batch_size=8, seed=0, device="cuda",
                             sample_length=4000)
        Wavenet.deconv_stack = orig
        require(len(seen) == 1 and seen[0][0].cfg.compute_dtype == "float32",
                f"generate_wavenet upsampled {len(seen)} batches of an f32 golden")
        require((torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32) == (True, False),
                "generate_wavenet did not give the caller's TF32 settings back")
        model, params, mel, enc = seen[0]
        with no_tf32():
            want = model.deconv_stack(params, mel)
        tf32 = model.deconv_stack(params, mel)  # TF32 allowed, as the default lets cuDNN
        same = bool(torch.equal(enc, want))
        log(f"TF32 defaults: generate_wavenet's encoding of the f32 golden {tuple(enc.shape)} equal to the "
            f"TF32-off deconv bit for bit: {same} (max|d| {float((enc - want).abs().max()):.3e}); the "
            f"same deconv with TF32 allowed parts by {float((tf32 - want).abs().max()):.3e}")
        require(same, "the f32 teacher's eval path upsampled with TF32 on")
    finally:
        Wavenet.deconv_stack = orig
        (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32,
         torch.backends.cudnn.deterministic) = saved


def golden_model():
    d = os.path.join(GOLDEN, "tiny_mol")
    cfg = config_lib.load_config(os.path.join(d, "meta.json"))
    return Wavenet(cfg), weights.load_npz(os.path.join(d, "params.npz"), device="cuda"), d


def student_model(seed=0, **overrides):
    cfg = config_lib.load_config(os.path.join(REPO, "configs/parallel_wavenet.json"), **overrides)
    pwn = ParallelWavenet(cfg)
    return pwn, pwn.init_params(seed, device="cuda")


def flow_inputs(pwn, params, B, L, seed):
    """x [L, B, W] f32 and enc [L, B, DW] from a random mel through the
    student's shared deconv stack, in the model's compute dtype (bf16 or f32)."""
    frames = 1 + -(-L // pwn.cfg.frame_shift)
    g = torch.Generator().manual_seed(seed)
    mel = torch.rand((B, frames, 80), generator=g).cuda()
    enc = pwn._flow_deconv(params, 0, mel).transpose(0, 1)[:L]
    enc = enc.to(pwn.dtype or torch.float32).contiguous()
    x = (0.3 * torch.randn((L, B, pwn.cfg.width), generator=g)).cuda()
    return x, enc


def kernel_launches_of(fn):
    """(fn(), the flow kernels' CUDA launches by name that fn enqueued), from
    the counts the C entry point keeps (flow_stack.kernel_launches)."""
    flk.flow_stack.kernel_launches = dict.fromkeys(flk.KERNEL_NAMES, 0)
    out = fn()
    torch.cuda.synchronize()
    return out, dict(flk.flow_stack.kernel_launches)


def require_launches(label, got, want):
    require(got == want and sum(want.values()) > 0,
            f"{label}: the flow kernels' launches {got}, want {want}")


def check_flow(label, x, enc, sw, s, nl, num_stages, cpu_floor=False, **kw):
    """One-shot kernel vs plain version on the same inputs (kw: the mode's
    flow_stack options), and the call's launches by kernel name: exactly one
    trunk launch a layer, of the kernel of its width; returns (kernel output,
    largest error, the plain version's CPU-vs-card distance or None)."""
    out_k, launched = kernel_launches_of(lambda: flk.flow_stack(x, enc, sw, s, nl, num_stages, **kw))
    require_launches(label, launched, flk.predicted_launches(x.shape[-1], nl, False))
    out_p = flk.flow_stack_plain(x, enc, sw, s, nl, num_stages, **kw)
    require(bool(torch.isfinite(out_k).all()), f"{label}: non-finite kernel output")
    err = float((out_k - out_p).abs().max())
    scale = max(float(out_p.abs().max()), 1.0)
    floor = None
    if cpu_floor:
        cpu_sw = {k: v.cpu() for k, v in sw.items()}
        out_c = flk.flow_stack_plain(x.cpu(), enc.cpu(), cpu_sw, s, nl, num_stages, **kw)
        floor = float((out_c - out_p.cpu()).abs().max())
    L, B, _ = x.shape
    log(f"{label} B={B} L={L} layers {s}..{s + nl - 1}: max|d| kernel-plain {err:.3e}, scale "
        f"{scale:.3f}, limit {FLOW_REL_TOL * scale:.3e} ({FLOW_REL_TOL:g} x scale), moved "
        f"{float((out_p - x).abs().max()):.3f}"
        + ("" if floor is None else f"; plain CPU-plain card {floor:.3e}"))
    require(err <= FLOW_REL_TOL * scale, f"{label} B={B}: kernel and plain version differ")
    return out_k, err, floor


def check_flow_streaming(x, enc, sw, nl, num_stages, oneshot, chunk, label="flow", **kw):
    """Chained kernel chunks against the one-shot kernel call (bit for bit: the
    arithmetic of a row does not depend on the call it falls in) and the final
    state against the plain version's (kw: the mode's flow_stack options; a
    cond stream in kw is cut into the same chunks as x); returns (the state's error, the kernel's final state).  Every chunk's call
    launches one trunk kernel and one state copy a layer."""
    L, B, W = x.shape
    rows = flk.state_rows(0, nl, num_stages)
    state = torch.zeros((rows, B, W), device="cuda")
    state_p = state.clone()
    outs = []
    for c0 in range(0, L, chunk):
        e = None if enc is None else enc[c0 : c0 + chunk]
        ckw = kw if kw.get("cond") is None else dict(kw, cond=kw["cond"][c0 : c0 + chunk])
        (o, state), launched = kernel_launches_of(lambda: flk.flow_stack(
            x[c0 : c0 + chunk], e, sw, 0, nl, num_stages, state=state, **ckw))
        require_launches(f"{label} chunk at {c0}", launched, flk.predicted_launches(W, nl, True))
        _, state_p = flk.flow_stack_plain(x[c0 : c0 + chunk], e, sw, 0, nl, num_stages,
                                          state=state_p, **ckw)
        outs.append(o)
    torch.cuda.synchronize()
    same = bool(torch.equal(torch.cat(outs, 0), oneshot))
    err = float((state - state_p).abs().max())
    scale = max(float(state_p.abs().max()), 1.0)
    log(f"{label} streaming B={B} L={L} chunk {chunk} ({rows} state rows): chained == one-shot "
        f"bit for bit: {same}; final state max|d| kernel-plain {err:.3e} "
        f"(limit {FLOW_REL_TOL * scale:.3e})")
    require(same, f"chained chunks of {chunk} differ from the one-shot call")
    require(err <= FLOW_REL_TOL * scale, f"chunk {chunk}: final state differs from the plain one")
    require(bool(torch.equal(state[:2], x[-2:])), "layer 0's state is not the tail of its input")
    return err, state


def time_flow(x, enc, sw, nl, num_stages, **kw):
    """ms of one stack call for the kernel, the plain version and torch.mm on
    the same per-layer products, and the card's bound for the call.  kw: the
    mode's flow_stack options.  The yardstick runs the bf16 products (taps,
    with a bf16 encoding its cond product too, res) as bf16 torch.mm, an f32
    cond product as an f32 torch.mm (TF32 off), and adds a cond stream's
    columns."""
    L, B, W = x.shape
    rows = L * B
    cond = kw.get("cond")
    f32_cond = cond is None and not kw.get("compact", True) and not kw.get("fuse_cond", False)
    feed = enc if cond is None else cond
    DW = feed.shape[-1] if cond is None else 0
    k_bf = 3 * W + (0 if f32_cond else DW)
    ms = cuda_ms(lambda: flk.flow_stack(x, enc, sw, 0, nl, num_stages, **kw))
    plain_ms = cuda_ms(lambda: flk.flow_stack_plain(x, enc, sw, 0, nl, num_stages, **kw), reps=1)
    a = torch.randn((rows, k_bf), device="cuda", dtype=torch.bfloat16)
    g = torch.randn((rows, W // 2), device="cuda", dtype=torch.bfloat16)
    w_comb = sw["w_tap"][:nl].reshape(nl, 3 * W, W).to(torch.bfloat16)
    if DW and not f32_cond:
        w_comb = torch.cat([w_comb, sw["w_cond"][:nl].to(torch.bfloat16)], 1)
    w_comb = w_comb.contiguous()
    pre = torch.empty((rows, W), device="cuda", dtype=torch.bfloat16)
    res = torch.empty((rows, W), device="cuda", dtype=torch.bfloat16)
    pre32 = torch.empty((rows, W), device="cuda") if f32_cond or cond is not None else None
    feed2d = feed.reshape(rows, feed.shape[-1])

    def library():
        for li in range(nl):
            torch.mm(a, w_comb[li], out=pre)
            if f32_cond:
                torch.mm(feed2d, sw["w_cond"][li], out=pre32)
            elif cond is not None:
                torch.add(pre, feed2d[:, li * W : (li + 1) * W], out=pre32)
            torch.mm(g, sw["w_res"][li], out=res)

    library_ms = cuda_ms(library)
    del a, g, pre, res, pre32
    flops = 2 * rows * nl * (k_bf * W + (W // 2) * W)
    flops_f32 = 2 * rows * nl * DW * W if f32_cond else (rows * nl * W if cond is not None else 0)
    io_bytes = (rows * (4 * W + feed.element_size() * feed.shape[-1] + 4 * W)
                + nl * (2 * (3 * W * W + W // 2 * W) + sw["w_cond"].element_size() * DW * W + 8 * W))
    if kw.get("state") is not None:  # the old state read, the new one written
        io_bytes += 2 * 4 * kw["state"].numel()
    t_ops = flops / PEAK_BF16_FLOPS + flops_f32 / PEAK_F32_FLOPS
    t_bytes = io_bytes / PEAK_HBM_BYTES
    return {"ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
            "bound_ms": 1e3 * max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "ops_ms": 1e3 * t_ops, "bytes_ms": 1e3 * t_bytes, "flops": flops + flops_f32,
            "io_bytes": io_bytes}


def log_flow_timing(label, x, nl, tm):
    L, B, W = x.shape
    log(f"timing flow_stack {label} W={W} B={B} L={L}, {nl} layers: kernel {tm['ms']:.3f} ms, "
        f"plain {tm['plain_ms']:.3f} ms, torch.mm on the same products {tm['library_ms']:.3f} ms, "
        f"bound {tm['bound_ms']:.3f} ms ({tm['bound_by']}; operations {tm['ops_ms']:.3f} ms, "
        f"bytes {tm['bytes_ms']:.3f} ms); {tm['flops'] / 1e12:.3f} TFLOP, "
        f"{tm['io_bytes'] / 1e9:.3f} GB")


def student_breakdown(pwn, params, mel):
    """Device time per CUDA kernel over one synthesize_cuda call, by
    torch.profiler: [(kernel name, launches, total ms)] by falling time, and
    the call's wall time in ms."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.time()
        parallelgen.synthesize_cuda(pwn, params, mel, torch.Generator().manual_seed(0))
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.time() - t0)
    rows = []
    for evt in prof.key_averages():
        # kernels only: an operator's row repeats the time of the kernels it launched
        if str(getattr(evt, "device_type", "")).endswith("CUDA"):
            total = getattr(evt, "self_device_time_total", None)
            if total is None:
                total = evt.self_cuda_time_total
            rows.append((evt.key, evt.count, total / 1e3))
    require(rows, "torch.profiler recorded no CUDA kernel")
    return sorted(rows, key=lambda r: -r[2]), wall_ms


def with_plain_flow_kernel(fn):
    """fn() with the wrapper's kernel swapped for its plain version, so that a
    whole path can be held against the same path on the plain kernel."""
    kernel = flk.flow_stack
    flk.flow_stack = lambda x, enc, sw, s, nl, ns, state=None, compact=True, **kw: (
        flk.flow_stack_plain(x, enc, sw, s, nl, ns, state, compact, **kw))
    try:
        return fn()
    finally:
        flk.flow_stack = kernel


def golden_student(**overrides):
    d = os.path.join(GOLDEN, "tiny_student")
    cfg = config_lib.load_config(os.path.join(d, "meta.json"), **overrides)
    return ParallelWavenet(cfg), weights.load_npz(os.path.join(d, "params.npz"), device="cuda"), d


def student_phases():
    """Phases 8 to 11; returns the flow kernel's record."""
    # ---- 8. flow kernel vs plain, full width ----
    pwn, params = student_model()
    cfg = pwn.cfg
    ns = cfg.num_stages
    sw = flk.compact_weights(flk.stack_flow_weights(params["flows"][3]))
    x8, enc8 = flow_inputs(pwn, params, B=8, L=8192, seed=31)
    out8, flow_err, flow_floor = check_flow("flow full width", x8, enc8, sw, 0, ns, ns,
                                            cpu_floor=True)
    for B, L, s in ((32, 4096, 10), (3, 1000, 20)):
        xb, encb = flow_inputs(pwn, params, B=B, L=L, seed=32 + B)
        _, err, _ = check_flow("flow full width", xb, encb, sw, s, ns, ns)
        flow_err = max(flow_err, err)
    state_err = max(check_flow_streaming(x8, enc8, sw, ns, ns, out8, chunk)[0]
                    for chunk in (2048, 512))
    del x8, enc8, out8

    # ---- 9. the student path end to end ----
    mels = {B: stft.melspectrogram(torch.from_numpy(synthetic_wavs(B, STUDENT_SAMPLES, 40 + B)).cuda())
            for B in STUDENT_BATCHES}
    L = pwn.sample_length(mels[8].shape[1])
    parallelgen.synthesize_cuda(pwn, params, mels[8][:, :6], torch.Generator().manual_seed(0))
    torch.cuda.synchronize()  # warm-up
    flk.flow_stack.launches = 0
    flk.flow_stack.kernel_launches = dict.fromkeys(flk.KERNEL_NAMES, 0)
    runs = {}
    for B in STUDENT_BATCHES:
        torch.cuda.reset_peak_memory_stats()
        t0 = time.time()
        audio = parallelgen.synthesize_cuda(pwn, params, mels[B], torch.Generator().manual_seed(B))
        torch.cuda.synchronize()
        runs[B] = (audio, time.time() - t0, torch.cuda.max_memory_allocated())
    launches, kernel_launches = flk.flow_stack.launches, dict(flk.flow_stack.kernel_launches)
    for B, (audio, dt, peak) in runs.items():
        require(tuple(audio.shape) == (B, L), f"student path shape {tuple(audio.shape)}")
        require(bool(torch.isfinite(audio).all()) and float(audio.abs().max()) <= 1.0,
                f"student path B={B}: audio not finite in [-1, 1]")
        log(f"student path B={B} L={L}: {1e3 * dt:.1f} ms, {B * L / 16000 / dt:.1f} audio-sec/s, "
            f"audio std {float(audio.std()):.4f}, peak memory {peak / 2**30:.2f} GiB")
    cycles = sum(-(-n // ns) for n in cfg.num_iaf_layers)
    log(f"student path kernel launches: flow_stack {launches} ({cycles} per synthesis, "
        f"{ns} CUDA launches each)")
    require(launches == cycles * len(STUDENT_BATCHES),
            f"the student path launched the flow kernel {launches} times")
    log(f"student path CUDA launches by kernel (counted where flow_stack enqueues them): "
        f"{kernel_launches}")
    require_launches("the student path", kernel_launches,
                     {name: n * cycles * len(STUDENT_BATCHES) for name, n in
                      flk.predicted_launches(cfg.width, ns, False).items()})
    del runs

    # fused feed-forward: the kernel against the same path on the plain kernel
    inputs = {"mel": mels[8], "base_x": pwn.base_noise(torch.Generator().manual_seed(9), 8, L, "cuda")}
    ff_k = parallelgen.feed_forward_cuda(pwn, params, inputs)
    ff_p = with_plain_flow_kernel(lambda: parallelgen.feed_forward_cuda(pwn, params, inputs))
    for k in ("x", "mean_tot", "scale_tot", "log_scale_tot"):
        err = float((ff_k[k] - ff_p[k]).abs().max())
        scale = max(float(ff_p[k].abs().max()), 1e-3)
        log(f"student feed-forward B=8 {k}: max|d| kernel-plain {err:.3e}, scale {scale:.3e}, "
            f"limit {STUDENT_REL_TOL * scale:.3e}")
        require(err <= STUDENT_REL_TOL * scale, f"student feed-forward {k} differs")
    # the streamer entry point at full width: bucketless encoding, carried state
    # of all 6 cycles and the start conv's window, against the one-shot path
    one = pwn._clip_quant_scale(ff_k["x"])
    streamer = parallelgen.StudentStreamer(pwn, chunk=32768)
    streamer.synthesize(params, mels[8][:, :6], base_x=inputs["base_x"][:, :pwn.sample_length(6)])
    torch.cuda.synchronize()  # warm-up
    t0 = time.time()
    streamed = streamer.synthesize(params, mels[8], base_x=inputs["base_x"])
    torch.cuda.synchronize()
    dt = time.time() - t0
    sdiff = float((streamed - one).abs().max())
    log(f"student streamer B=8 L={L} chunk 32768: {1e3 * dt:.1f} ms, "
        f"{8 * L / 16000 / dt:.1f} audio-sec/s; vs one-shot on the same noise max|d| {sdiff:.3e} "
        f"(limit 5e-3)")
    require(tuple(streamed.shape) == (8, L) and sdiff <= 5e-3,
            "full-width streamer differs from the one-shot path")
    del ff_k, ff_p, inputs, one, streamed

    kernels, wall_ms = student_breakdown(pwn, params, mels[8])
    busy = sum(ms for _, _, ms in kernels)
    log(f"profile student B=8: device busy {busy:.1f} ms of {wall_ms:.1f} ms wall; " + ", ".join(
        f"{name[:48]} {n} x {1e3 * ms / n:.1f} us" for name, n, ms in kernels[:6]))

    B = STUDENT_BATCHES[0]
    enc = parallelgen._trim_to(pwn._flow_deconv(params, 0, mels[B]), L)
    enc = enc.transpose(0, 1).to(torch.bfloat16).contiguous()
    x = (0.3 * torch.randn((L, B, cfg.width), generator=torch.Generator().manual_seed(1))).cuda()
    # the kernel against its plain version at the main path's own shape, for
    # each offset of a cycle in the 30-layer flow
    for s in range(0, cfg.num_iaf_layers[3], ns):
        out_k, err, _ = check_flow("flow main-path shape", x, enc, sw, s, ns, ns)
        del out_k
        flow_err = max(flow_err, err)
    tm = time_flow(x, enc, sw, ns, ns)
    log(f"timing flow_stack B={B} L={L}, {ns} layers: kernel {tm['ms']:.3f} ms, plain "
        f"{tm['plain_ms']:.3f} ms, torch.mm on the same products {tm['library_ms']:.3f} ms, bound "
        f"{tm['bound_ms']:.3f} ms ({tm['bound_by']}; operations {tm['ops_ms']:.3f} ms, bytes "
        f"{tm['bytes_ms']:.3f} ms); {tm['flops'] / 1e12:.3f} TFLOP, {tm['io_bytes'] / 1e9:.3f} GB; "
        f"{cycles} calls per synthesis")
    facts = flow_launch_facts(cfg.width, "bf16")
    del x, enc

    # ---- 10. golden tiny_student on the card ----
    gpwn, gparams, gdir = golden_student()
    n = 12000
    wavs = [wav_io.read_wav(os.path.join(GOLDEN, f"gen_student_{i}.wav"))[0][:n] for i in range(4)]
    gmels_np = stft.melspectrogram_np(np.stack(wavs))
    gmels = torch.from_numpy(gmels_np).cuda()
    gL = gpwn.sample_length(gmels.shape[1])
    gin = {"mel": gmels,
           "base_x": gpwn.base_noise(torch.Generator().manual_seed(7), 4, gL, "cuda")}
    fused = gpwn._clip_quant_scale(parallelgen.feed_forward_cuda(gpwn, gparams, gin)["x"])
    plain = gpwn._clip_quant_scale(gpwn.feed_forward(gparams, gin)["x"])
    corr = float(np.corrcoef(fused.cpu().numpy().ravel(), plain.cpu().numpy().ravel())[0, 1])
    streamed = parallelgen.StudentStreamer(gpwn, chunk=1024).synthesize(
        gparams, gmels, base_x=gin["base_x"])
    sdiff = float((streamed - fused).abs().max())
    log(f"golden student: fused vs plain audio corr {corr:.6f}; streamer (chunk 1024) vs one-shot "
        f"max|d| {sdiff:.3e}")
    require(corr > 0.999, "golden student: fused and plain audio differ")
    require(sdiff <= 5e-3, "golden student: streamer differs from one-shot")
    audio = parallelgen.synthesize_cuda(gpwn, gparams, gmels,
                                        torch.Generator().manual_seed(7)).cpu().numpy()
    require(np.isfinite(audio).all() and np.abs(audio).max() <= 1.0, "golden student audio")
    matched, mismatched = mel_corr(audio, gmels_np, min(n, gL))
    log(f"golden student free synthesis mel corr: matched {matched:.4f} mismatched {mismatched:.4f}")
    require(matched > mismatched + 0.05, "golden student does not track its conditioning")

    # ---- 11. the student eval path on golden weights ----
    with tempfile.TemporaryDirectory() as tmp:
        src = os.path.join(tmp, "src")
        os.makedirs(src)
        for i in (0, 1):
            wav_io.write_wav(os.path.join(src, f"utt_{i}.wav"), wavs[i])
        for chunk in (None, 2000):
            paths = generate_parallel_wavenet(
                src, os.path.join(gdir, "params.npz"), os.path.join(gdir, "meta.json"),
                os.path.join(tmp, f"gen_{chunk}"), batch_size=4, seed=0, device="cuda",
                sample_length=8000, streaming_chunk=chunk)
            require(len(paths) == 2, f"student eval wrote {len(paths)} files")
            for p in paths:
                wav, sr = wav_io.read_wav(p)
                require(sr == 16000 and len(wav) >= 8000 and np.isfinite(wav).all()
                        and np.abs(wav).max() > 0, f"student eval output {p}")
            log(f"student eval path (streaming_chunk {chunk}) wrote "
                f"{[os.path.basename(p) for p in paths]}")

    log(f"timed flow call: B={B}, L={L}, {ns} layers, full width")
    return {
        "name": "flow_stack",
        "route": "cuda",
        "source": "nsynth_wavenet_tpu_torch/csrc/flow_kernel.cu",
        "replaces": "nsynth_wavenet_tpu/ops/flow_kernel.py:47",
        "launches": launches,
        "max_abs_err": flow_err,
        "rel_tol": FLOW_REL_TOL,
        "plain_cpu_vs_card_err": flow_floor,
        "state_max_abs_err": state_err,
        "ms": tm["ms"],
        "plain_ms": tm["plain_ms"],
        "bound_ms": tm["bound_ms"],
        "bound_by": tm["bound_by"],
        "library_ms": tm["library_ms"],
        "kernel_launches": kernel_launches,
        "launch": facts,
    }


def flow_launch_facts(width, mode):
    """The last launch of the persistent kernel: the launch fields that
    flow_stack handed the C entry point (flow_stack.last_launch: grid, tiles,
    tile rows, ring stages and slots), and what the card holds for that
    kernel after it (cudaFuncGetAttributes: registers, spills, static shared
    memory, and the dynamic shared memory the launch opted in to; the
    occupancy API: blocks an SM at that); logged."""
    last = flk.flow_stack.last_launch
    require(last is not None and (last["width"], last["mode"]) == (width, mode),
            f"the last flow_persist_kernel launch was {last}, want width {width}, mode {mode}")
    card = flk.launched_facts(width, mode, "cuda")
    facts = {"kernel": last["kernel"], "grid": last["grid"], "n_tiles": last["n_tiles"],
             "blocks_per_sm": card["blocks_per_sm"], "sms": card["sms"],
             "registers": card["registers"], "spill_bytes": card["spill_bytes"],
             "static_smem": card["static_smem"], "dynamic_smem": card["dynamic_smem"],
             "threads": card["threads"], "tile_rows": last["tile_rows"], "stages": last["stages"],
             "slot_bytes": last["slot_bytes"], "enc_cols": last["enc_cols"],
             "wc_resident": bool(last["wc_resident"])}
    log(f"launch flow_persist_kernel<{width}, {mode}>: " + ", ".join(
        f"{k} {v}" for k, v in facts.items() if k != "kernel"))
    require(facts["dynamic_smem"] == last["smem_bytes"],
            f"flow_persist_kernel<{width}, {mode}>: the card holds an opt-in of "
            f"{facts['dynamic_smem']} bytes, the launch asked for {last['smem_bytes']}")
    require(facts["registers"] > 0 and facts["blocks_per_sm"] >= 1
            and 1 <= facts["grid"] <= facts["blocks_per_sm"] * facts["sms"],
            f"flow_persist_kernel<{width}, {mode}>: launch facts {facts}")
    return facts


def reset_flow_counts():
    flk.flow_stack.launches = 0
    flk.flow_stack.launches_by_mode = dict.fromkeys(flk.flow_stack.launches_by_mode, 0)
    flk.flow_stack.kernel_launches = dict.fromkeys(flk.KERNEL_NAMES, 0)


def flow_counts():
    """The flow kernel's launches by mode since the last reset, modes with none left out."""
    return {k: v for k, v in flk.flow_stack.launches_by_mode.items() if v}


@contextlib.contextmanager
def deterministic_cudnn():
    """cuDNN's deterministic algorithms inside the block, so that two runs of a
    path share one encoding bit for bit (the default transposed convolution
    is not bit-stable between calls)."""
    saved = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        yield
    finally:
        torch.backends.cudnn.deterministic = saved


def edge_shape_checks(num_stages, B=3, L=600):
    """The persistent kernel at the edges of its copy boxes, random weights
    from a seed: at W 32 and 64, deconv width 8 (an encoding narrower than
    one 128-byte box) and 4096 (a w_cond that does not stay in shared memory,
    so each encoding chunk brings its rows), both conditioning modes, two
    layers; and one layer of a W 32 cond stream, bf16 (32 columns under a box
    of 64) and f32.  Each one-shot call against the plain version, and
    chained chunks of 128 bit for bit against it, with the exact launches;
    returns the largest one-shot error."""
    err_max = 0.0

    def weights(W, DW, seed):
        rng = np.random.RandomState(seed)
        t = lambda *shape, sc=1.0: torch.from_numpy((sc * rng.randn(*shape)).astype(np.float32)).cuda()
        nl = 2
        sw = {"w_tap": t(nl, 3, W, W, sc=0.3 / np.sqrt(3 * W)), "b": t(nl, W, sc=0.1),
              "w_cond": t(nl, DW, W, sc=0.5 / np.sqrt(DW)), "b_cond": t(nl, W, sc=0.1),
              "w_res": t(nl, W // 2, W, sc=1.0 / np.sqrt(W)), "b_res": t(nl, W, sc=0.05)}
        return sw, t(L, B, W, sc=0.3), t(L, B, DW)

    for W in flk.PERSIST_WIDTHS:
        for DW in (8, 4096):
            sw, x, enc = weights(W, DW, W + DW)
            for compact in (True, False):
                plan = flk.persist_plan(W, "bf16" if compact else "f32cond", DW)
                require(plan.wc_resident == (DW == 8),
                        f"deconv width {DW} at W {W}: w_cond resident {plan.wc_resident}")
                wts = (flk.compact_weights if compact else flk.noncompact_weights)(sw)
                e = enc.to(torch.bfloat16) if compact else enc
                name = (f"flow width {W} deconv {DW}, w_cond "
                        f"{'resident' if plan.wc_resident else 'streamed'} "
                        f"({'bf16' if compact else 'f32-cond'})")
                o, err, _ = check_flow(name, x, e, wts, 0, 2, num_stages, compact=compact)
                check_flow_streaming(x, e, wts, 2, num_stages, o, 128, label=name, compact=compact)
                err_max = max(err_max, err)
    sw, x, enc = weights(32, 256, 7)
    c32 = stream_of(enc, sw, 0, 1)
    for compact in (True, False):
        wts = (flk.compact_weights if compact else flk.noncompact_weights)(sw)
        c = c32.to(torch.bfloat16) if compact else c32
        name = f"flow width 32, one layer, cond stream ({'bf16' if compact else 'f32'})"
        o, err, _ = check_flow(name, x, None, wts, 0, 1, num_stages, cond=c, compact=compact)
        check_flow_streaming(x, None, wts, 1, num_stages, o, 128, label=name, cond=c,
                             compact=compact)
        err_max = max(err_max, err)
    return err_max


def stream_of(enc, sw, s, nl):
    """The precomputed-conditioning stream of layers s .. s + nl - 1 of a flow:
    [L, B, nl * W] f32, each layer's enc @ w_cond + b_cond in f32."""
    L, B, DW = enc.shape
    e = enc.float().reshape(L * B, DW)
    return torch.cat([e @ sw["w_cond"][li].float() + sw["b_cond"][li] for li in range(s, s + nl)],
                     -1).reshape(L, B, -1)


def flow_record(name, replaces, launches, err, tm, **extra):
    return {"name": name, "route": "cuda", "source": "nsynth_wavenet_tpu_torch/csrc/flow_kernel.cu",
            "replaces": replaces, "launches": launches, "max_abs_err": err,
            "rel_tol": FLOW_REL_TOL, "ms": tm["ms"], "plain_ms": tm["plain_ms"],
            "bound_ms": tm["bound_ms"], "bound_by": tm["bound_by"],
            "library_ms": tm["library_ms"], **extra}


def timing_summary(tm):
    return {k: tm[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")}


def flow_mode_phases():
    """Phases 27 to 31; returns the records of the f32-cond, cond-stream and
    width kernels."""
    bf = torch.bfloat16
    # ---- 27. the flow kernel's modes against their plain versions, full width ----
    pwn, params = student_model()
    pwn32 = ParallelWavenet(dataclasses.replace(pwn.cfg, compute_dtype="float32"))
    cfg, ns = pwn.cfg, pwn.cfg.num_stages
    W = cfg.width
    sw = flk.stack_flow_weights(params["flows"][3])  # the 30-layer flow
    nw, cw = flk.noncompact_weights(sw), flk.compact_weights(sw)
    f32 = {"compact": False}
    x8, enc8 = flow_inputs(pwn32, params, B=8, L=8192, seed=51)
    x3, enc3 = flow_inputs(pwn32, params, B=3, L=1000, seed=52)
    out8, f32_err, f32_floor = check_flow("flow f32-cond", x8, enc8, nw, 0, ns, ns, cpu_floor=True,
                                          **f32)
    f32_err = max(f32_err, check_flow("flow f32-cond", x3, enc3, nw, 20, ns, ns, **f32)[1])
    f32_state_err, state32 = 0.0, None
    for chunk in (2048, 512):
        err, state32 = check_flow_streaming(x8, enc8, nw, ns, ns, out8, chunk,
                                            label="flow f32-cond", **f32)
        f32_state_err = max(f32_state_err, err)
    _, fuse_err, _ = check_flow("flow fuse_cond (f32 enc)", x8, enc8, nw, 0, ns, ns, compact=False,
                                fuse_cond=True)
    # bf16 carries: the output bit for bit, the state rounded
    outs, st = [], torch.zeros_like(state32)
    for c0 in range(0, x8.shape[0], 512):
        o, st = flk.flow_stack(x8[c0 : c0 + 512], enc8[c0 : c0 + 512], nw, 0, ns, ns, st,
                               carry_dtype=bf, **f32)
        outs.append(o)
    torch.cuda.synchronize()
    same_out = bool(torch.equal(torch.cat(outs, 0), out8))
    same_state = bool(torch.equal(st, state32.to(bf).float()))
    log(f"flow bf16 carries, chunks of 512: output == f32 carries bit for bit: {same_out}; "
        f"state == bf16(f32 state): {same_state}")
    require(same_out and same_state, "bf16 carries changed the output or the state")
    # one 30-layer call of the 30-layer flow against three chained 10-layer calls
    one = flk.flow_stack(x8, enc8, nw, 0, cfg.num_iaf_layers[3], ns, **f32)
    chained = x8
    for s in range(0, cfg.num_iaf_layers[3], ns):
        chained = flk.flow_stack(chained, enc8, nw, s, ns, ns, **f32)
    torch.cuda.synchronize()
    same = bool(torch.equal(one, chained))
    log(f"flow f32-cond: one {cfg.num_iaf_layers[3]}-layer call == chained {ns}-layer calls "
        f"bit for bit: {same}")
    require(same, "a layers_per_call call differs from the chained calls")
    del one, chained, outs
    # the cond stream, bf16 and f32, driven with the counts reset
    reset_flow_counts()
    stream_err = 0.0
    for s, xs, es in ((0, x8, enc8), (20, x3, enc3)):
        cs = stream_of(es, sw, s, ns)
        for compact, c, wts in ((True, cs.to(bf), cw), (False, cs, nw)):
            out_s, err, _ = check_flow(f"flow cond stream ({'bf16' if compact else 'f32'})", xs,
                                       None, wts, s, ns, ns, cond=c, compact=compact)
            stream_err = max(stream_err, err)
        if s == 0:  # the f32 stream is the f32-cond function fed the projection
            d = float((out_s - out8).abs().max())
            log(f"flow f32 cond stream vs f32-cond enc mode: max|d| {d:.3e}")
            require(d <= FLOW_REL_TOL * max(float(out8.abs().max()), 1.0),
                    "the f32 cond stream and the f32-cond mode differ")
    stream_launches = flow_counts()
    log(f"cond-stream drive launches by mode: {stream_launches}")
    require(stream_launches == {"stream": 2, "stream_f32": 2}, "the stream drive's launches")
    # f32 precision probe: w_tap = 0, b = 0, x = 0, w_res = [I | 0] put bf16(g)
    # in the first W/2 output columns, g from the cond product alone
    m = W // 2
    probe = {"w_tap": torch.zeros((1, 3, W, W), device="cuda", dtype=bf),
             "b": torch.zeros((1, W), device="cuda"), "w_cond": nw["w_cond"][:1].contiguous(),
             "b_cond": torch.zeros((1, W), device="cuda"),
             "w_res": torch.cat([torch.eye(m), torch.zeros(m, m)], 1)[None].to("cuda", bf),
             "b_res": torch.zeros((1, W), device="cuda")}
    zx = torch.zeros_like(x8)
    g_k = flk.flow_stack(zx, enc8, probe, 0, 1, ns, **f32)[..., :m]
    g_p = flk.flow_stack_plain(zx, enc8, probe, 0, 1, ns, **f32)[..., :m]
    torch.backends.cuda.matmul.allow_tf32 = True
    g_t = flk.flow_stack_plain(zx, enc8, probe, 0, 1, ns, **f32)[..., :m]
    torch.backends.cuda.matmul.allow_tf32 = False
    probe_share = float((g_k != g_p).float().mean())
    tf32_share = float((g_t != g_p).float().mean())
    log(f"f32 precision probe: {probe_share:.3e} of {g_p.numel()} bf16(g) values differ between "
        f"kernel and plain version (TF32 off); the plain version with TF32 on differs in "
        f"{tf32_share:.3e}")
    require(probe_share < 0.01 and bool(torch.equal(g_p, g_p.to(bf).float())),
            "the f32 cond product is not f32")
    del x3, enc3, out8, state32, st, zx, g_k, g_p, g_t, cs, out_s

    # ---- 28. widths 32, 128 and 256, and a deconv width that is not a multiple of 64 ----
    width_err, width_sw = 0.0, {W: cw}
    for wd, over in ((32, {"width": 32}), (128, {"width": 128}), (256, {"width": 256}),
                     (W, {"deconv_width": 136})):
        pw, pp = student_model(seed=wd, **over)
        pw32 = ParallelWavenet(dataclasses.replace(pw.cfg, compute_dtype="float32"))
        sww = flk.stack_flow_weights(pp["flows"][0])
        xw, ew = flow_inputs(pw32, pp, B=8, L=4096, seed=60 + wd)
        label = f"flow width {wd} deconv {pw.cfg.deconv_width}"
        for compact in (True, False):
            wts = (flk.compact_weights if compact else flk.noncompact_weights)(sww)
            e = ew.to(bf) if compact else ew
            name = f"{label} ({'bf16' if compact else 'f32-cond'})"
            o, err, _ = check_flow(name, xw, e, wts, 0, ns, ns, compact=compact)
            check_flow_streaming(xw, e, wts, ns, ns, o, 512, label=name, compact=compact)
            width_err = max(width_err, err)
        if "width" in over:
            width_sw[wd] = flk.compact_weights(sww)
        del pp, xw, ew, o
    width_err = max(width_err, edge_shape_checks(ns))

    # ---- 29. the f32 student path end to end ----
    mels = {B: stft.melspectrogram(torch.from_numpy(synthetic_wavs(B, STUDENT_SAMPLES, 40 + B)).cuda())
            for B in STUDENT_BATCHES}
    L = pwn32.sample_length(mels[8].shape[1])
    parallelgen.synthesize_cuda(pwn32, params, mels[8][:, :6], torch.Generator().manual_seed(0))
    torch.cuda.synchronize()  # warm-up
    reset_flow_counts()
    runs = {}
    for B in STUDENT_BATCHES:
        torch.cuda.reset_peak_memory_stats()
        t0 = time.time()
        audio = parallelgen.synthesize_cuda(pwn32, params, mels[B], torch.Generator().manual_seed(B))
        torch.cuda.synchronize()
        runs[B] = (audio, time.time() - t0, torch.cuda.max_memory_allocated())
    f32_launches, f32_modes = flk.flow_stack.launches, flow_counts()
    f32_kernel_launches = dict(flk.flow_stack.kernel_launches)
    for B, (audio, dt, peak) in runs.items():
        require(tuple(audio.shape) == (B, L), f"f32 student path shape {tuple(audio.shape)}")
        require(bool(torch.isfinite(audio).all()) and float(audio.abs().max()) <= 1.0,
                f"f32 student path B={B}: audio not finite in [-1, 1]")
        log(f"f32 student path B={B} L={L}: {1e3 * dt:.1f} ms, {B * L / 16000 / dt:.1f} "
            f"audio-sec/s, audio std {float(audio.std()):.4f}, peak memory {peak / 2**30:.2f} GiB")
    cycles = sum(-(-n // ns) for n in cfg.num_iaf_layers)
    log(f"f32 student path kernel launches: flow_stack {f32_launches}, by mode {f32_modes}")
    require(f32_modes == {"f32cond": cycles * len(STUDENT_BATCHES)},
            "the f32 student path did not go through the f32-cond kernel alone")
    log(f"f32 student path CUDA launches by kernel: {f32_kernel_launches}")
    require_launches("the f32 student path", f32_kernel_launches,
                     {name: n * cycles * len(STUDENT_BATCHES) for name, n in
                      flk.predicted_launches(W, ns, False).items()})
    del runs

    inputs = {"mel": mels[8], "base_x": pwn32.base_noise(torch.Generator().manual_seed(9), 8, L,
                                                          "cuda")}
    with deterministic_cudnn():  # one encoding for every run below
        ff_k = parallelgen.feed_forward_cuda(pwn32, params, inputs)
        ff_p = with_plain_flow_kernel(lambda: parallelgen.feed_forward_cuda(pwn32, params, inputs))
        reset_flow_counts()
        ff_lpc = parallelgen.feed_forward_cuda(pwn32, params, inputs,
                                               layers_per_call=max(cfg.num_iaf_layers))
        lpc_modes = flow_counts()
        reset_flow_counts()
        ff_fc = parallelgen.feed_forward_cuda(pwn32, params, inputs, fuse_cond=True)
        fc_modes = flow_counts()
    log(f"f32 student launches by mode: layers_per_call={max(cfg.num_iaf_layers)} {lpc_modes}, "
        f"fuse_cond {fc_modes}")
    require(lpc_modes == {"f32cond": len(cfg.num_iaf_layers)} and fc_modes == {"bf16": cycles},
            "the opt-in variants' launches")
    for k in ("x", "mean_tot", "scale_tot", "log_scale_tot"):
        err = float((ff_k[k] - ff_p[k]).abs().max())
        scale = max(float(ff_p[k].abs().max()), 1e-3)
        fc = float((ff_fc[k] - ff_k[k]).abs().max())
        log(f"f32 student feed-forward B=8 {k}: max|d| kernel-plain {err:.3e}, scale {scale:.3e}, "
            f"limit {STUDENT_REL_TOL * scale:.3e}; fuse_cond vs default {fc:.3e}; "
            f"layers_per_call={max(cfg.num_iaf_layers)} == default: {torch.equal(ff_lpc[k], ff_k[k])}")
        require(err <= STUDENT_REL_TOL * scale, f"f32 student feed-forward {k} differs")
        require(bool(torch.equal(ff_lpc[k], ff_k[k])), f"layers_per_call changed {k}")
        if k in ("mean_tot", "scale_tot"):
            require(fc <= FUSE_COND_ATOL, f"fuse_cond moved {k} by {fc:.3e}")
    one = pwn32._clip_quant_scale(ff_k["x"])
    streamer = parallelgen.StudentStreamer(pwn32, chunk=32768)
    streamer.synthesize(params, mels[8][:, :6], base_x=inputs["base_x"][:, :pwn32.sample_length(6)])
    torch.cuda.synchronize()  # warm-up
    t0 = time.time()
    streamed = streamer.synthesize(params, mels[8], base_x=inputs["base_x"])
    torch.cuda.synchronize()
    dt = time.time() - t0
    sdiff = float((streamed - one).abs().max())
    log(f"f32 student streamer B=8 L={L} chunk 32768: {1e3 * dt:.1f} ms, "
        f"{8 * L / 16000 / dt:.1f} audio-sec/s; vs one-shot on the same noise max|d| {sdiff:.3e} "
        f"(limit 5e-3)")
    require(tuple(streamed.shape) == (8, L) and sdiff <= 5e-3,
            "f32 streamer differs from the one-shot path")
    del ff_k, ff_p, ff_lpc, ff_fc, inputs, one, streamed

    kernels, wall_ms = student_breakdown(pwn32, params, mels[8])
    busy = sum(ms for _, _, ms in kernels)
    log(f"profile f32 student B=8: device busy {busy:.1f} ms of {wall_ms:.1f} ms wall; " + ", ".join(
        f"{name[:48]} {n} x {1e3 * ms / n:.1f} us" for name, n, ms in kernels[:8]))

    B = STUDENT_BATCHES[0]
    with torch.no_grad():
        enc = parallelgen._trim_to(pwn32._flow_deconv(params, 0, mels[B]), L)
    enc = enc.transpose(0, 1).float().contiguous()
    x = (0.3 * torch.randn((L, B, W), generator=torch.Generator().manual_seed(1))).cuda()
    f32_err = max(f32_err, check_flow("flow f32-cond main-path shape", x, enc, nw, 0, ns, ns,
                                      **f32)[1])
    tm32 = time_flow(x, enc, nw, ns, ns, **f32)
    log_flow_timing("f32-cond", x, ns, tm32)
    f32_facts = flow_launch_facts(W, "f32cond")
    tm_bf = time_flow(x, enc.to(bf), cw, ns, ns)
    log_flow_timing("bf16 (same call)", x, ns, tm_bf)
    nl30 = cfg.num_iaf_layers[3]
    tm_lpc = time_flow(x, enc, nw, nl30, ns, **f32)
    log_flow_timing(f"f32-cond, one {nl30}-layer call (layers_per_call)", x, nl30, tm_lpc)
    st0 = torch.zeros((flk.state_rows(0, ns, ns), B, W), device="cuda")
    tm_carry32 = time_flow(x, enc, nw, ns, ns, state=st0, **f32)
    log_flow_timing("f32-cond with a carried state, f32 carries", x, ns, tm_carry32)
    tm_carry = time_flow(x, enc, nw, ns, ns, state=st0, carry_dtype=bf, **f32)
    log_flow_timing("f32-cond with a carried state, bf16 carries", x, ns, tm_carry)
    cs = stream_of(enc, sw, 0, ns)
    del enc
    tm_s32 = time_flow(x, None, nw, ns, ns, cond=cs, compact=False)
    log_flow_timing("cond stream f32", x, ns, tm_s32)
    cs = cs.to(bf)
    tm_s = time_flow(x, None, cw, ns, ns, cond=cs)
    log_flow_timing("cond stream bf16", x, ns, tm_s)
    del x, cs, mels

    # ---- 30. the trained golden tiny_student as f32 ----
    gpwn, gparams, gdir = golden_student(compute_dtype="float32")
    n = 12000
    wavs = [wav_io.read_wav(os.path.join(GOLDEN, f"gen_student_{i}.wav"))[0][:n] for i in range(4)]
    gmels_np = stft.melspectrogram_np(np.stack(wavs))
    gmels = torch.from_numpy(gmels_np).cuda()
    gL = gpwn.sample_length(gmels.shape[1])
    gin = {"mel": gmels,
           "base_x": gpwn.base_noise(torch.Generator().manual_seed(7), 4, gL, "cuda")}
    fused = gpwn._clip_quant_scale(parallelgen.feed_forward_cuda(gpwn, gparams, gin)["x"])
    plain = gpwn._clip_quant_scale(gpwn.feed_forward(gparams, gin)["x"])
    corr = float(np.corrcoef(fused.cpu().numpy().ravel(), plain.cpu().numpy().ravel())[0, 1])
    streamed = parallelgen.StudentStreamer(gpwn, chunk=1024).synthesize(
        gparams, gmels, base_x=gin["base_x"])
    sdiff = float((streamed - fused).abs().max())
    log(f"golden student f32: fused vs plain audio corr {corr:.6f}; streamer (chunk 1024) vs "
        f"one-shot max|d| {sdiff:.3e}")
    require(corr > 0.999, "f32 golden student: fused and plain audio differ")
    require(sdiff <= 5e-3, "f32 golden student: streamer differs from one-shot")
    audio = parallelgen.synthesize_cuda(gpwn, gparams, gmels,
                                        torch.Generator().manual_seed(7)).cpu().numpy()
    require(np.isfinite(audio).all() and np.abs(audio).max() <= 1.0, "f32 golden student audio")
    matched, mismatched = mel_corr(audio, gmels_np, min(n, gL))
    log(f"golden student f32 free synthesis mel corr: matched {matched:.4f} "
        f"mismatched {mismatched:.4f}")
    require(matched > mismatched + 0.05, "f32 golden student does not track its conditioning")
    with tempfile.TemporaryDirectory() as tmp:
        with open(os.path.join(gdir, "meta.json")) as f:
            meta = json.load(f)
        meta["config"]["compute_dtype"] = "float32"
        cfg_path = os.path.join(tmp, "meta.json")
        with open(cfg_path, "w") as f:
            json.dump(meta, f)
        src = os.path.join(tmp, "src")
        os.makedirs(src)
        for i in (0, 1):
            wav_io.write_wav(os.path.join(src, f"utt_{i}.wav"), wavs[i])
        for chunk in (None, 2000):
            reset_flow_counts()
            paths = generate_parallel_wavenet(
                src, os.path.join(gdir, "params.npz"), cfg_path, os.path.join(tmp, f"gen_{chunk}"),
                batch_size=4, seed=0, device="cuda", sample_length=8000, streaming_chunk=chunk)
            modes = flow_counts()
            require(len(paths) == 2 and list(modes) == ["f32cond"],
                    f"f32 student eval wrote {len(paths)} files, launches {modes}")
            for p in paths:
                wav, sr = wav_io.read_wav(p)
                require(sr == 16000 and len(wav) >= 8000 and np.isfinite(wav).all()
                        and np.abs(wav).max() > 0, f"f32 student eval output {p}")
            log(f"f32 student eval path (streaming_chunk {chunk}) wrote "
                f"{[os.path.basename(p) for p in paths]}, launches {modes}")
    del gparams, gmels

    # ---- 31. a width-128 student through the serving path ----
    pw, pp = student_model(seed=3, width=128)
    wmel = stft.melspectrogram(torch.from_numpy(synthetic_wavs(8, 16000, 71)).cuda())
    wL = pw.sample_length(wmel.shape[1])
    parallelgen.synthesize_cuda(pw, pp, wmel[:, :6], torch.Generator().manual_seed(0))
    torch.cuda.synchronize()  # warm-up
    reset_flow_counts()
    t0 = time.time()
    audio = parallelgen.synthesize_cuda(pw, pp, wmel, torch.Generator().manual_seed(8))
    torch.cuda.synchronize()
    dt = time.time() - t0
    w_launches, w_kernel_launches = flow_counts(), dict(flk.flow_stack.kernel_launches)
    require(tuple(audio.shape) == (8, wL) and bool(torch.isfinite(audio).all()),
            "width-128 student audio")
    log(f"width-128 student path B=8 L={wL}: {1e3 * dt:.1f} ms, {8 * wL / 16000 / dt:.1f} "
        f"audio-sec/s; launches by mode {w_launches}, CUDA launches by kernel {w_kernel_launches}")
    require(w_launches == {"bf16_w128": cycles}, "the width-128 path's launches")
    require_launches("the width-128 path", w_kernel_launches,
                     {name: n * cycles for name, n in flk.predicted_launches(128, ns, False).items()})
    winputs = {"mel": wmel, "base_x": pw.base_noise(torch.Generator().manual_seed(9), 8, wL, "cuda")}
    with deterministic_cudnn():
        ff_k = parallelgen.feed_forward_cuda(pw, pp, winputs)
        ff_p = with_plain_flow_kernel(lambda: parallelgen.feed_forward_cuda(pw, pp, winputs))
    for k in ("x", "mean_tot", "scale_tot", "log_scale_tot"):
        err = float((ff_k[k] - ff_p[k]).abs().max())
        scale = max(float(ff_p[k].abs().max()), 1e-3)
        log(f"width-128 student feed-forward B=8 {k}: max|d| kernel-plain {err:.3e}, scale "
            f"{scale:.3e}, limit {STUDENT_REL_TOL * scale:.3e}")
        require(err <= STUDENT_REL_TOL * scale, f"width-128 student feed-forward {k} differs")
    del pp, ff_k, ff_p
    by_width = {}
    for wd, sww in sorted(width_sw.items()):
        g = torch.Generator().manual_seed(wd)
        xw = (0.3 * torch.randn((wL, 8, wd), generator=g)).cuda()
        ew = (0.5 * torch.randn((wL, 8, cfg.deconv_width), generator=g)).to("cuda", bf)
        by_width[wd] = time_flow(xw, ew, sww, ns, ns)
        log_flow_timing("bf16", xw, ns, by_width[wd])
    return [
        flow_record("flow_stack_f32cond", "nsynth_wavenet_tpu/ops/flow_kernel.py:285", f32_launches,
                    f32_err, tm32, plain_cpu_vs_card_err=f32_floor,
                    state_max_abs_err=f32_state_err, fuse_cond_max_abs_err=fuse_err,
                    probe_share=probe_share, probe_share_tf32=tf32_share,
                    bf16_same_call=timing_summary(tm_bf),
                    layers_per_call_30=timing_summary(tm_lpc),
                    carried_state_f32_carries=timing_summary(tm_carry32),
                    carried_state_bf16_carries=timing_summary(tm_carry),
                    launches_by_mode={"default": f32_modes, "layers_per_call_30": lpc_modes,
                                      "fuse_cond": fc_modes},
                    kernel_launches=f32_kernel_launches, launch=f32_facts),
        flow_record("flow_stack_cond_stream", "nsynth_wavenet_tpu/ops/flow_kernel.py:297",
                    sum(stream_launches.values()), stream_err, tm_s,
                    launches_by_mode=stream_launches, f32=timing_summary(tm_s32)),
        flow_record("flow_stack_width", "nsynth_wavenet_tpu/ops/flow_kernel.py:168",
                    sum(w_launches.values()), width_err, by_width[128],
                    launches_by_mode=w_launches,
                    by_width={str(wd): timing_summary(t) for wd, t in by_width.items()}),
    ]


# ---- T1-T5: teacher training ---------------------------------------------------

# T1, card step against the CPU step (f32, TF32 off), as shares of each
# gradient leaf's own max |value|, and for the params and EMA after the
# update ||card - cpu|| / ||cpu - init|| over each leaf that has a gradient
# (Adam moves every element by about the learning rate whatever its
# gradient's size, so a per-element maximum would read roundoff as a full
# step).  The MoL head at quant_chann 65536 cancels 15 bits in its bin
# probability, so summation-order differences of 1e-7 in the head outputs
# come out as 1e-3 of a gradient leaf (tests/test_torch_train_step.py: JAX
# against the port on the CPU reads 1.5e-3 and 2.2e-2 at 4 layers, width 16).
TRAIN_LOSS_REL_TOL = 1e-5
TRAIN_GRAD_REL_TOL = 1e-2
TRAIN_UPDATE_REL_TOL = 1e-1
TRAIN_STEPS = 40  # T2, and the fixed-batch run
TIMED_TRAIN_STEPS = 10  # T5, after 2 warm-up steps


def leaf_err(want, got, floor=0.0):
    """Largest max |got - want| over the leaves of two trees, each as a share
    of the leaf's own max |want|, at least ``floor`` (0 where the leaf is all
    zero on both)."""
    errs = []
    for w, g in zip(tree_lib.leaves(want), tree_lib.leaves(got)):
        w, g = w.detach().cpu().float(), g.detach().cpu().float()
        scale = max(float(w.abs().max()), floor)
        errs.append(float((g - w).abs().max()) / scale if scale > 0 else float(g.abs().max()))
    return max(errs)


def update_err(init, want, got, grads):
    errs = []
    for i, w, g, gr in zip(*(tree_lib.leaves(t) for t in (init, want, got, grads))):
        if float(gr.abs().max()) == 0:
            continue
        i, w, g = (x.detach().cpu().float() for x in (i, w, g))
        errs.append(float(torch.linalg.vector_norm(g - w) / torch.linalg.vector_norm(w - i)))
    return max(errs)


def to_device(tree, device):
    return tree_lib.tree_map(lambda x: x.detach().to(device), tree)


def train_flops(cfg, B):
    """FLOPs of one training step, counted from the convolutions the step
    runs: every product's forward MACs x 2, times 3 for the forward and the
    two backward products (input and weight gradients).  The layers' and the
    head's conditioning products run over the whole encoding
    (mel frames x frame_shift samples), the rest over wave_length."""
    L = cfg.wave_length
    frames = 1 + L // stft.MEL_PARAMS.hop_length
    enc_len = frames * cfg.frame_shift
    m = cfg.gate_width // 2
    W, G, S, DW = cfg.width, cfg.gate_width, cfg.skip_width, cfg.deconv_width
    per_layer = L * (cfg.filter_length * W * G + m * W + m * S) + enc_len * DW * G
    macs = cfg.num_layers * per_layer
    macs += L * (cfg.filter_length * W + W * S + S * S + S * cfg.out_width) + enc_len * DW * S
    t, cin = frames, stft.MEL_PARAMS.num_mel
    for fl, stride in cfg.deconv_config:
        macs += t * fl * cin * DW
        t, cin = t * stride, DW
    return 6.0 * B * macs


def speechlike_dataset(path, n_utts=24, seed=0):
    from nsynth_wavenet_tpu_torch.data import dataset as data_lib
    from nsynth_wavenet_tpu_torch.data import synthetic

    waves, ids = synthetic.make_speechlike_corpus(n_utts=n_utts, duration=2.0, seed=seed)
    data_lib.build_dataset_from_arrays(waves, ids, path)
    return path


def recording_steps(losses, maker="make_wavenet_train_step"):
    """Context: train_lib.<maker> wrapped to record every step's loss, as the
    runner builds its step function."""
    make = getattr(train_lib, maker)

    def recording(*args, **kw):
        step_fn = make(*args, **kw)

        def fn(*a, **k):
            state, metrics = step_fn(*a, **k)
            losses.append(metrics["loss"])
            return state, metrics

        return fn

    @contextlib.contextmanager
    def patched():
        setattr(train_lib, maker, recording)
        try:
            yield
        finally:
            setattr(train_lib, maker, make)

    return patched()


def t1_card_vs_cpu():
    cfg = config_lib.load_config(os.path.join(REPO, "configs/wavenet_mol.json"), num_layers=4,
                                 compute_dtype="float32", dropout_inputs=False)
    model = Wavenet(cfg)
    params = model.init_params(0, device="cpu")
    wav = torch.from_numpy(synthetic_wavs(2, cfg.wave_length, 31))
    out = {}
    for device in ("cuda", "cpu"):
        w = wav.to(device)
        p = to_device(params, device)
        t0 = time.time()
        with no_tf32():
            loss, grads = train_lib.loss_and_grads(model, p, w, stft.melspectrogram(w))
        optimizer = opt_lib.make_optimizer(cfg.lr_schedule)
        state = train_lib.make_train_state(p, optimizer)
        state, metrics = train_lib.make_wavenet_train_step(model, optimizer)(state, w)
        if device == "cuda":
            torch.cuda.synchronize()
        out[device] = (float(loss), grads, state, float(metrics["loss"]), time.time() - t0)
    (l_g, g_g, s_g, sl_g, t_g), (l_c, g_c, s_c, sl_c, t_c) = out["cuda"], out["cpu"]
    loss_err = max(abs(l_g - l_c), abs(sl_g - sl_c)) / max(abs(l_c), 1.0)
    grad_err = leaf_err(g_c, g_g)
    p_err = update_err(params, s_c["params"], s_g["params"], g_c)
    e_err = update_err(params, s_c["ema"], s_g["ema"], g_c)
    log(f"T1 train step card vs CPU (mol, 4 layers, f32, B=2 x {cfg.wave_length}): loss "
        f"{l_g:.6f} / {l_c:.6f} (rel {loss_err:.2e}, limit {TRAIN_LOSS_REL_TOL:.0e}); gradient "
        f"leaves max {grad_err:.3e} of scale (limit {TRAIN_GRAD_REL_TOL:.0e}); params after Adam "
        f"{p_err:.3e}, EMA {e_err:.3e} (L2 of the update, limit {TRAIN_UPDATE_REL_TOL:.0e}); "
        f"card {t_g:.1f} s, CPU {t_c:.1f} s")
    require(loss_err <= TRAIN_LOSS_REL_TOL, "T1: loss card vs CPU")
    require(grad_err <= TRAIN_GRAD_REL_TOL, "T1: gradients card vs CPU")
    require(p_err <= TRAIN_UPDATE_REL_TOL and e_err <= TRAIN_UPDATE_REL_TOL,
            "T1: params / EMA after the update card vs CPU")
    require(s_g["step"] == s_c["step"] == 1, "T1: step count")
    return {"loss_rel": loss_err, "grad": grad_err, "params": p_err, "ema": e_err}


def t2_full_training(tmp):
    cfg_path = os.path.join(REPO, "configs/wavenet_mol.json")
    cfg = config_lib.load_config(cfg_path)
    ds = speechlike_dataset(os.path.join(tmp, "speech"))
    losses = []
    t0 = time.time()
    with recording_steps(losses):
        run_dir, state = runner.train_wavenet(
            ds, config_path=cfg_path, log_root=os.path.join(tmp, "runs"), total_batch_size=4,
            num_steps=TRAIN_STEPS, ckpt_every_steps=TRAIN_STEPS // 2, seed=0, device="cuda")
    torch.cuda.synchronize()
    dt = time.time() - t0
    losses = [float(x) for x in losses]
    steps = ckpt_lib.CheckpointManager(os.path.join(run_dir, "ckpt")).all_steps()
    log(f"T2 runner.train_wavenet full size ({cfg.num_layers} layers, W {cfg.width}, "
        f"{cfg.compute_dtype}, dropout_inputs {cfg.dropout_inputs}), B=4 x {cfg.wave_length}, "
        f"{TRAIN_STEPS} steps in {dt:.1f} s (checkpoints and start-up included): losses "
        f"{losses[0]:.4f} .. {losses[-1]:.4f}, checkpoints at {steps}")
    require(len(losses) == TRAIN_STEPS and all(np.isfinite(losses)), "T2: a loss is not finite")
    require(steps == [TRAIN_STEPS // 2, TRAIN_STEPS] and state["step"] == TRAIN_STEPS,
            "T2: checkpoints")
    # one fixed batch, TRAIN_STEPS steps: the loss falls
    model = Wavenet(cfg)
    optimizer = opt_lib.make_optimizer(cfg.lr_schedule, grad_clip=cfg.grad_clip)
    fstate = train_lib.make_train_state(model.init_params(1, device="cuda"), optimizer)
    step_fn = train_lib.make_wavenet_train_step(model, optimizer)
    from nsynth_wavenet_tpu_torch.data import dataset as data_lib

    batch = torch.from_numpy(data_lib.Dataset(ds).random_crop_batch(
        np.random.default_rng(3), 4, cfg.wave_length)).cuda()
    fixed = []
    for _ in range(TRAIN_STEPS):
        fstate, metrics = step_fn(fstate, batch, 2)
        fixed.append(metrics["loss"])
    fixed = [float(x) for x in fixed]
    first, last = float(np.mean(fixed[:5])), float(np.mean(fixed[-5:]))
    log(f"T2 one fixed batch, {TRAIN_STEPS} steps: mean loss of the first 5 {first:.4f}, of the "
        f"last 5 {last:.4f}")
    require(all(np.isfinite(fixed)) and last < first, "T2: the loss does not fall on a fixed batch")
    del fstate
    return run_dir, state, {"losses": losses, "fixed_first5": first, "fixed_last5": last,
                            "seconds": dt}


def t3_resume(tmp):
    from nsynth_wavenet_tpu_torch.data import dataset as data_lib

    cfg = config_lib.load_config(os.path.join(REPO, "configs/wavenet_mol.json"), num_layers=4)
    cfg_path = os.path.join(tmp, "mol_4_layers.json")
    with open(cfg_path, "wt") as f:
        f.write(config_lib.config_to_json(cfg))
    ds = os.path.join(tmp, "one")
    data_lib.build_dataset_from_arrays(synthetic_wavs(1, cfg.wave_length, 41), ["one"], ds)
    kw = dict(total_batch_size=4, ckpt_every_steps=3, seed=0, device="cuda")
    with deterministic_cudnn():
        _, full = runner.train_wavenet(ds, config_path=cfg_path,
                                       log_root=os.path.join(tmp, "full"), num_steps=6, **kw)
        part_dir, _ = runner.train_wavenet(ds, config_path=cfg_path,
                                           log_root=os.path.join(tmp, "part"), num_steps=3, **kw)
        _, resumed = runner.train_wavenet(ds, logdir=part_dir, num_steps=6, **kw)
    same = {name: all(torch.equal(a, b) for a, b in zip(tree_lib.leaves(full[name]),
                                                      tree_lib.leaves(resumed[name])))
            for name in ("params", "ema")}
    for name in ("mu", "nu"):
        same[name] = all(torch.equal(a, b) for a, b in zip(
            tree_lib.leaves(full["opt_state"][name]), tree_lib.leaves(resumed["opt_state"][name])))
    same["step"] = full["step"] == resumed["step"] == 6 and \
        full["opt_state"]["count"] == resumed["opt_state"]["count"] == 6
    log(f"T3 resume by logdir (4 layers, bf16, dropout on, cuDNN deterministic): 3 steps + "
        f"resumed to 6 == 6 steps bit for bit: {same}")
    require(all(same.values()), "T3: a resumed run differs from the uninterrupted one")
    return same


def t4_serve(run_dir, state, tmp):
    cfg = config_lib.load_config(runner.find_config_json(run_dir))
    ckpt_lib.export_ema(state, os.path.join(run_dir, "ema"), cfg)
    src, out = os.path.join(tmp, "src"), os.path.join(tmp, "gen")
    os.makedirs(src)
    for i, w in enumerate(synthetic_wavs(2, 4000, 51)):
        wav_io.write_wav(os.path.join(src, f"utt_{i}.wav"), w)
    fk.generate.launches = 0
    fk.generate.kernel_launches = dict.fromkeys(fk.KERNEL_NAMES, 0)
    t0 = time.time()
    paths = generate_wavenet(src, None, None, out, batch_size=8, seed=0, device="cuda",
                             ckpt_dir=run_dir)
    torch.cuda.synchronize()
    dt = time.time() - t0
    calls, counted = fk.generate.launches, {k: n for k, n in fk.generate.kernel_launches.items() if n}
    audio = np.stack([wav_io.read_wav(p)[0] for p in paths])
    log(f"T4 export_ema + generate_wavenet(ckpt_dir) over 2 wavs: {len(paths)} files, "
        f"{audio.shape[1]} samples each, {dt:.2f} s; generate calls {calls}, CUDA launches "
        f"{counted}; audio std {float(audio.std()):.4f}, max |x| {float(np.abs(audio).max()):.4f}")
    require(len(paths) == 2 and calls == 1 and counted == {"fastgen_persistent": 1},
            "T4: the trained weights were not served through one fastgen_persistent launch")
    require(np.isfinite(audio).all() and float(audio.std()) > 1e-3, "T4: audio not finite or silent")
    return {"calls": calls, "kernel_launches": counted, "audio_std": float(audio.std())}


KERNEL_CLASSES = (  # (class, substrings of a CUDA kernel's name), first match wins
    ("gemm", ("nvjet", "gemm", "xmma", "cutlass")),
    ("cudnn_conv", ("cudnn", "convolve", "wgrad", "dgrad")),
    ("concat", ("CatArray",)),
    ("reduce", ("reduce_kernel",)),
    ("fill", ("FillFunctor",)),
    ("optimizer", ("multi_tensor_apply",)),
    ("strided_elementwise", ("gpu_kernel_impl_nocast", "unrolled_elementwise")),
    ("elementwise", ("elementwise",)),
)


def train_breakdown(step_fn, state, batch):
    """Device time of one training step by kernel class (KERNEL_CLASSES), by
    torch.profiler: ({class: ms}, busy ms, wall ms)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.time()
        step_fn(state, batch, 2)
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.time() - t0)
    by_class = {}
    for evt in prof.key_averages():
        if str(getattr(evt, "device_type", "")).endswith("CUDA"):
            total = getattr(evt, "self_device_time_total", None)
            if total is None:
                total = evt.self_cuda_time_total
            cls = next((c for c, keys in KERNEL_CLASSES if any(k in evt.key for k in keys)),
                       "other")
            by_class[cls] = by_class.get(cls, 0.0) + total / 1e3
    require(by_class, "torch.profiler recorded no CUDA kernel in a training step")
    return by_class, sum(by_class.values()), wall_ms


def t5_timing(card):
    cfg0 = config_lib.load_config(os.path.join(REPO, "configs/wavenet_mol.json"))
    rows = {}
    for B, remat in ((4, False), (16, False), (16, True)):
        cfg = dataclasses.replace(cfg0, remat=remat)
        model = Wavenet(cfg)
        optimizer = opt_lib.make_optimizer(cfg.lr_schedule, grad_clip=cfg.grad_clip)
        state = train_lib.make_train_state(model.init_params(2, device="cuda"), optimizer)
        step_fn = train_lib.make_wavenet_train_step(model, optimizer)
        batch = torch.from_numpy(synthetic_wavs(B, cfg.wave_length, 61 + B)).cuda()
        for _ in range(2):
            state, _ = step_fn(state, batch, 2)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        t0 = time.time()
        start.record()
        for _ in range(TIMED_TRAIN_STEPS):
            state, metrics = step_fn(state, batch, 2)
        end.record()
        torch.cuda.synchronize()
        wall = (time.time() - t0) / TIMED_TRAIN_STEPS
        ms = start.elapsed_time(end) / TIMED_TRAIN_STEPS
        peak = torch.cuda.max_memory_allocated() / 2**30
        flops = train_flops(cfg, B)
        bound = 1e3 * flops / PEAK_BF16_FLOPS
        rows[f"B{B}{'_remat' if remat else ''}"] = row = {
            "ms": ms, "wall_ms": 1e3 * wall, "steps_per_s": 1e3 / ms, "utt_per_s": 1e3 * B / ms,
            "peak_gib": peak, "tflop": flops / 1e12, "bound_ms": bound,
            "loss": float(metrics["loss"])}
        log(f"T5 train step B={B} x {cfg.wave_length} remat={remat}: {ms:.2f} ms a step (events; "
            f"{row['wall_ms']:.2f} ms wall), {row['steps_per_s']:.2f} steps/s, "
            f"{row['utt_per_s']:.1f} utterances/s, peak memory {peak:.2f} GiB; "
            f"{flops / 1e12:.2f} TFLOP a step, bound {bound:.2f} ms at the bf16 peak "
            f"({bound / ms:.1%} of it); {card}")
        require(np.isfinite(row["loss"]), "T5: loss not finite")
        if not remat:
            by_class, busy, wall_ms = train_breakdown(step_fn, state, batch)
            row["profile_ms"] = by_class
            log(f"T5 profile of one step B={B}: device busy {busy:.1f} ms of {wall_ms:.1f} ms "
                f"wall; " + ", ".join(f"{k} {v:.2f} ms" for k, v in
                                      sorted(by_class.items(), key=lambda kv: -kv[1])))
        del state, step_fn, batch
        torch.cuda.empty_cache()
    return rows


def training_phases(card, tmp):
    """T1-T5, then S1-S5 with T2's run as the teacher, their runs under tmp
    (Q4 reads T2's and S2's); card: nvidia-smi's name and power limit,
    printed beside the timings.  Returns the phases' results and the flow
    kernel's launches on S4's path."""
    t0 = time.time()
    out = {"T1": t1_card_vs_cpu()}
    run_dir, state, out["T2"] = t2_full_training(tmp)
    out["T2"]["gather"] = runner_gather(run_dir)
    out["T2"]["run_dir"] = run_dir
    out["T4"] = t4_serve(run_dir, state, tmp)
    del state
    torch.cuda.empty_cache()
    out["T3"] = t3_resume(tmp)
    out["T5"] = t5_timing(card)
    log(f"training phases T1-T5: {time.time() - t0:.1f} s")
    t0 = time.time()
    out["S1"] = s1_card_vs_cpu()
    s_run, s_state, out["S2"] = s2_full_distillation(tmp, run_dir)
    out["S2"]["gather"] = runner_gather(s_run)
    out["S2"]["run_dir"] = s_run
    out["S4"] = s4_serve(s_run, s_state, tmp)
    del s_state
    torch.cuda.empty_cache()
    out["S3"] = s3_resume(tmp, run_dir)
    out["S5"] = s5_timing(card, run_dir)
    log(f"distillation phases S1-S5: {time.time() - t0:.1f} s")
    return out


# ---- S1-S5: student distillation ------------------------------------------------

# S1 holds the card's step to the CPU's with T1's limits: the student's KL
# scores the same MoL teacher head at 65 536 levels (its bin probabilities
# cancel 15 bits), averaged over num_samples x L draws.
DISTILL_STEPS = 20  # S2, a checkpoint every 10
FIXED_DISTILL_STEPS = 30  # S2's fixed batch
TIMED_DISTILL_STEPS = 10  # S5, after 2 warm-up steps
S_PAIRS = (("configs/parallel_wavenet.json", "configs/wavenet_mol.json"),
           ("configs/parallel_wavenet_gauss.json", "configs/wavenet_gauss.json"))


class GradTap:
    """An optimizer that keeps a copy of the gradients it is handed."""

    def __init__(self, optimizer):
        self.optimizer, self.lr_fn, self.grads = optimizer, optimizer.lr_fn, None

    def init(self, params):
        return self.optimizer.init(params)

    def update(self, grads, opt_state, params):
        self.grads = tree_lib.tree_map(torch.clone, grads)
        return self.optimizer.update(grads, opt_state, params)


def distill_student(cfg, teacher, te, seed, device="cuda"):
    """(ParallelWavenet of cfg taught by teacher, its params from a seed
    with the teacher's deconv weights te['deconv'] copied in)."""
    pwn = ParallelWavenet(cfg, teacher)
    return pwn, transplant_teacher_deconv(pwn.init_params(seed, device=device), te)


def s1_card_vs_cpu():
    out = {}
    for student_path, teacher_path in S_PAIRS:
        teacher = Wavenet(config_lib.load_config(
            os.path.join(REPO, teacher_path), num_layers=4, compute_dtype="float32",
            dropout_inputs=False, use_as_teacher=True))
        te_cpu = teacher.init_params(0, device="cpu")
        cfg = config_lib.load_config(os.path.join(REPO, student_path), num_iaf_layers=(2, 2),
                                     compute_dtype="float32")
        wav = torch.from_numpy(synthetic_wavs(2, cfg.wave_length, 71))
        wav_rand = torch.from_numpy(synthetic_wavs(2, cfg.wave_length, 72))
        res = {}
        for device in ("cuda", "cpu"):
            t0 = time.time()
            te = to_device(te_cpu, device)
            pwn, params = distill_student(cfg, teacher, te, 1, device)
            L = pwn.sample_length(stft.num_mel_frames(cfg.wave_length))
            draws = train_lib.student_draws(pwn, torch.Generator().manual_seed(5), 2, L, "cpu")
            tap = GradTap(train_lib.make_student_optimizer(cfg, params))
            state = train_lib.make_train_state(params, tap)
            init = tree_lib.tree_map(lambda t: t.detach().cpu().clone(), state["params"])
            state, metrics = train_lib.make_pwn_train_step(pwn, te, tap)(
                state, wav.to(device), wav_rand.to(device), None,
                draws={k: v.to(device) for k, v in draws.items()})
            if device == "cuda":
                torch.cuda.synchronize()
            res[device] = (metrics, tap.grads, state, time.time() - t0)
        (m_g, g_g, s_g, t_g), (m_c, g_c, s_c, t_c) = res["cuda"], res["cpu"]
        metric_err = max(abs(float(m_g[k]) - float(m_c[k])) / max(abs(float(m_c[k])), 1.0)
                         for k in m_c)
        grad_err = leaf_err(g_c, g_g)
        p_err = update_err(init, s_c["params"], s_g["params"], g_c)
        e_err = update_err(init, s_c["ema"], s_g["ema"], g_c)
        name = f"{cfg.loss_type}{' + contrastive' if cfg.contrastive_loss_factor else ''}"
        log(f"S1 distill step card vs CPU ({name} + power, teacher {teacher.cfg.loss_type} 4 "
            f"layers, student flows 2/2, f32, B=2 x {cfg.wave_length}): loss "
            f"{float(m_g['loss']):.6f} / {float(m_c['loss']):.6f}, metrics max rel {metric_err:.2e} "
            f"(limit {TRAIN_LOSS_REL_TOL:.0e}); gradient leaves max {grad_err:.3e} of scale "
            f"(limit {TRAIN_GRAD_REL_TOL:.0e}); params after Adam {p_err:.3e}, EMA {e_err:.3e} "
            f"(L2 of the update, limit {TRAIN_UPDATE_REL_TOL:.0e}); card {t_g:.1f} s, CPU "
            f"{t_c:.1f} s")
        require(metric_err <= TRAIN_LOSS_REL_TOL, f"S1 {name}: metrics card vs CPU")
        require(grad_err <= TRAIN_GRAD_REL_TOL, f"S1 {name}: gradients card vs CPU")
        require(p_err <= TRAIN_UPDATE_REL_TOL and e_err <= TRAIN_UPDATE_REL_TOL,
                f"S1 {name}: params / EMA after the update card vs CPU")
        require(s_g["step"] == s_c["step"] == 1, f"S1 {name}: step count")
        out[cfg.loss_type] = {"metrics_rel": metric_err, "grad": grad_err, "params": p_err,
                              "ema": e_err}
    return out


def write_config(path, cfg):
    with open(path, "wt") as f:
        f.write(config_lib.config_to_json(cfg))
    return path


def s2_full_distillation(tmp, teacher_dir):
    cfg_path = os.path.join(REPO, "configs/parallel_wavenet.json")
    cfg = config_lib.load_config(cfg_path)
    ds = os.path.join(tmp, "speech")
    losses = []
    t0 = time.time()
    with recording_steps(losses, "make_pwn_train_step"):
        run_dir, state = runner.train_parallel_wavenet(
            ds, teacher_dir, config_path=cfg_path, log_root=os.path.join(tmp, "pwn_runs"),
            total_batch_size=4, num_steps=DISTILL_STEPS, ckpt_every_steps=DISTILL_STEPS // 2,
            seed=0, device="cuda")
    torch.cuda.synchronize()
    dt = time.time() - t0
    losses = [float(x) for x in losses]
    steps = ckpt_lib.CheckpointManager(os.path.join(run_dir, "ckpt")).all_steps()
    log(f"S2 runner.train_parallel_wavenet full size (flows {cfg.num_iaf_layers}, W {cfg.width}, "
        f"{cfg.compute_dtype}, num_samples {cfg.num_samples}, contrastive "
        f"{cfg.contrastive_loss_factor}, power {cfg.power_loss_factor}; teacher: T2's run), "
        f"B=4 x {cfg.wave_length}, {DISTILL_STEPS} steps in {dt:.1f} s (teacher load, "
        f"checkpoints and start-up included): losses {losses[0]:.4f} .. {losses[-1]:.4f}, "
        f"checkpoints at {steps}")
    require(len(losses) == DISTILL_STEPS and all(np.isfinite(losses)), "S2: a loss is not finite")
    require(steps == [DISTILL_STEPS // 2, DISTILL_STEPS] and state["step"] == DISTILL_STEPS,
            "S2: checkpoints")

    # one fixed batch and fixed draws: the loss falls
    teacher, te = runner.load_teacher(teacher_dir, device="cuda")
    pwn, params = distill_student(cfg, teacher, te, 2)
    optimizer = train_lib.make_student_optimizer(pwn.cfg, params)
    fstate = train_lib.make_train_state(params, optimizer)
    step_fn = train_lib.make_pwn_train_step(pwn, te, optimizer)
    from nsynth_wavenet_tpu_torch.data import dataset as data_lib

    crops = data_lib.Dataset(ds).random_crop_batch(np.random.default_rng(4), 8, cfg.wave_length)
    wav, wav_rand = (torch.from_numpy(c).cuda() for c in (crops[:4], crops[4:]))
    draws = train_lib.student_draws(pwn, train_lib.dropout_generator(2, 0, "cuda"), 4,
                                    pwn.sample_length(stft.num_mel_frames(cfg.wave_length)), "cuda")
    fixed = []
    for _ in range(FIXED_DISTILL_STEPS):
        fstate, metrics = step_fn(fstate, wav, wav_rand, None, draws=draws)
        fixed.append(metrics["loss"])
    fixed = [float(x) for x in fixed]
    first, last = float(np.mean(fixed[:5])), float(np.mean(fixed[-5:]))
    log(f"S2 one fixed batch and draws, {FIXED_DISTILL_STEPS} steps: mean loss of the first 5 "
        f"{first:.4f}, of the last 5 {last:.4f}")
    require(all(np.isfinite(fixed)) and last < first,
            "S2: the loss does not fall on a fixed batch")
    del fstate, step_fn

    # the teacher's frozen deconv
    tea_cfg = dataclasses.replace(cfg, use_share_deconv=False, use_teacher_deconv=True)
    tea_path = write_config(os.path.join(tmp, "pwn_teacher_deconv.json"), tea_cfg)
    _, tstate = runner.train_parallel_wavenet(
        ds, teacher_dir, config_path=tea_path, log_root=os.path.join(tmp, "pwn_tea"),
        total_batch_size=4, num_steps=3, ckpt_every_steps=3, seed=0, device="cuda")
    frozen = all(torch.equal(a, b) for a, b in zip(tree_lib.leaves(tstate["params"]["deconv_share"]),
                                                   tree_lib.leaves(te["deconv"])))
    n_moments, n_leaves = len(tstate["opt_state"]["mu"]), len(tree_lib.leaves(tstate["params"]))
    log(f"S2 use_teacher_deconv, 3 steps: deconv_share bit-equal to the teacher's {frozen}, "
        f"Adam moments over {n_moments} of {n_leaves} leaves")
    require(frozen and n_moments == n_leaves - len(tree_lib.leaves(te["deconv"])),
            "S2: the teacher's deconv did not stay frozen")
    del tstate, te, teacher
    return run_dir, state, {"losses": losses, "fixed_first5": first, "fixed_last5": last,
                            "seconds": dt}


def s3_resume(tmp, teacher_dir):
    cfg = config_lib.load_config(os.path.join(REPO, "configs/parallel_wavenet.json"),
                                 num_iaf_layers=(2, 2))
    cfg_path = write_config(os.path.join(tmp, "pwn_2_2.json"), cfg)
    ds = os.path.join(tmp, "one")  # T3's one-record dataset, exactly wave_length long
    kw = dict(total_batch_size=4, ckpt_every_steps=3, seed=0, device="cuda")
    with deterministic_cudnn():
        _, full = runner.train_parallel_wavenet(ds, teacher_dir, config_path=cfg_path,
                                                log_root=os.path.join(tmp, "s3_full"),
                                                num_steps=6, **kw)
        part_dir, _ = runner.train_parallel_wavenet(ds, teacher_dir, config_path=cfg_path,
                                                    log_root=os.path.join(tmp, "s3_part"),
                                                    num_steps=3, **kw)
        _, resumed = runner.train_parallel_wavenet(ds, teacher_dir, logdir=part_dir,
                                                   num_steps=6, **kw)
    same = {name: all(torch.equal(a, b) for a, b in zip(tree_lib.leaves(full[name]),
                                                      tree_lib.leaves(resumed[name])))
            for name in ("params", "ema")}
    for name in ("mu", "nu"):
        same[name] = all(torch.equal(a, b) for a, b in zip(
            tree_lib.leaves(full["opt_state"][name]), tree_lib.leaves(resumed["opt_state"][name])))
    same["step"] = full["step"] == resumed["step"] == 6 and \
        full["opt_state"]["count"] == resumed["opt_state"]["count"] == 6
    log(f"S3 distillation resume by logdir (student flows 2/2, bf16, teacher T2's run, cuDNN "
        f"deterministic): 3 steps + resumed to 6 == 6 steps bit for bit: {same}")
    require(all(same.values()), "S3: a resumed run differs from the uninterrupted one")
    return same


def s4_serve(run_dir, state, tmp):
    """The student's EMA export served from its run directory: 6 flow calls
    a synthesis (4 flows of 10 / 10 / 10 / 30 layers, a call a dilation
    cycle), each 10 flow_persist_kernel launches."""
    cfg = config_lib.load_config(runner.find_config_json(run_dir))
    ckpt_lib.export_ema(state, os.path.join(run_dir, "ema"), cfg)
    src, out = os.path.join(tmp, "s4_src"), os.path.join(tmp, "s4_gen")
    os.makedirs(src)
    for i, w in enumerate(synthetic_wavs(2, 4000, 81)):
        wav_io.write_wav(os.path.join(src, f"utt_{i}.wav"), w)
    reset_flow_counts()
    t0 = time.time()
    paths = generate_parallel_wavenet(src, None, None, out, batch_size=4, seed=0, device="cuda",
                                      ckpt_dir=run_dir)
    torch.cuda.synchronize()
    dt = time.time() - t0
    calls, counted = flk.flow_stack.launches, {k: n for k, n in
                                               flk.flow_stack.kernel_launches.items() if n}
    audio = np.stack([wav_io.read_wav(p)[0] for p in paths])
    want_calls = sum(-(-n // cfg.num_stages) for n in cfg.num_iaf_layers)
    log(f"S4 export_ema + generate_parallel_wavenet(ckpt_dir) over 2 wavs: {len(paths)} files, "
        f"{audio.shape[1]} samples each, {dt:.2f} s; flow_stack calls {calls} (want "
        f"{want_calls}), CUDA launches {counted}; audio std {float(audio.std()):.4f}, max |x| "
        f"{float(np.abs(audio).max()):.4f}")
    require(len(paths) == 2 and calls == want_calls
            and counted == {"flow_persist_kernel": sum(cfg.num_iaf_layers)},
            "S4: the distilled weights were not served through flow_persist_kernel")
    require(np.isfinite(audio).all() and float(audio.std()) > 1e-3,
            "S4: audio not finite or silent")
    return {"calls": calls, "kernel_launches": counted, "audio_std": float(audio.std())}


def distill_flops(pcfg, tcfg, B):
    """FLOPs of one distillation step, counted from the products the step
    runs (MACs x 2): the teacher's scoring forward over the 2B batch (B
    with no contrastive term) and its backward to the sample alone (the
    input gradients of the trunk and head products; the conditioning
    products and the deconv get none), the student's forward and backward
    (x 3: input and weight gradients), every product over the sample length
    L (the port takes the encoding's centre before the 1x1 products)."""
    frames = stft.num_mel_frames(pcfg.wave_length)
    L = (frames * pcfg.frame_shift // pcfg.max_dilation) * pcfg.max_dilation

    def deconv_macs(cfg):
        macs, t, cin = 0, frames, stft.MEL_PARAMS.num_mel
        for fl, stride in cfg.deconv_config:
            macs += t * fl * cin * cfg.deconv_width
            t, cin = t * stride, cfg.deconv_width
        return macs

    W, G, S, DW, m = tcfg.width, tcfg.gate_width, tcfg.skip_width, tcfg.deconv_width, \
        tcfg.gate_width // 2
    trunk = tcfg.num_layers * (tcfg.filter_length * W * G + m * W + m * S)
    cond = tcfg.num_layers * DW * G + DW * S
    head = tcfg.filter_length * W + W * S + S * S + S * tcfg.out_width
    tb = 2 * B if pcfg.loss_type == "logistic" and pcfg.contrastive_loss_factor > 0 else B
    teacher = tb * (L * (2 * (trunk + head) + cond) + deconv_macs(tcfg))
    w = pcfg.width
    student = 0
    for n in pcfg.num_iaf_layers:
        student += pcfg.filter_length * w + n * (pcfg.filter_length * w * w + pcfg.deconv_width * w
                                                 + (w // 2) * w) \
            + w * w + pcfg.deconv_width * w + 2 * w
    n_deconv = 1 if (pcfg.use_share_deconv or pcfg.use_teacher_deconv) else len(pcfg.num_iaf_layers)
    student = 3 * B * (L * student + n_deconv * deconv_macs(pcfg))
    return 2.0 * (teacher + student), 2.0 * teacher, 2.0 * student


@contextlib.contextmanager
def distill_spans():
    """torch.profiler spans around the distillation step's parts, by
    wrapping the functions the step calls: the student's forward, the
    teacher's scoring forward, the MoL log-probs, the STFTs (the mels and
    the power loss) and the optimizer with the EMA."""
    from torch.profiler import record_function

    from nsynth_wavenet_tpu_torch.ops import distributions as dist_lib
    from nsynth_wavenet_tpu_torch.ops import stft as stft_lib

    def span(name, fn):
        def wrapped(*a, **k):
            with record_function(name):
                return fn(*a, **k)
        return wrapped

    targets = [(ParallelWavenet, "feed_forward_train", "student"),
               (ParallelWavenet, "_teacher_out_params", "teacher"),
               (dist_lib, "mol_log_probs", "mol_log_probs"),
               (stft_lib, "stft_pad_end", "stft"), (stft_lib, "stft_center", "stft"),
               (opt_lib.MultiTransform, "update", "optimizer"), (opt_lib, "ema_update", "optimizer")]
    saved = [(obj, attr, getattr(obj, attr)) for obj, attr, _ in targets]
    try:
        for (obj, attr, name), (_, _, fn) in zip(targets, saved):
            setattr(obj, attr, span(name, fn))
        yield {name for _, _, name in targets}
    finally:
        for obj, attr, fn in saved:
            setattr(obj, attr, fn)


def distill_breakdown(step_fn, state, wav, wav_rand):
    """Device time of one distillation step, by torch.profiler.  Each kernel
    counts once, for the op that launched it: a forward kernel for the span
    (distill_spans) around its op, a backward kernel for the span whose
    forward op made its autograd node (the sequence number links the two),
    the rest as 'other'.  The spans' own GPU annotations are not kernels.
    Returns ({part: ms}, {kernel class: ms}, the top kernels [(name, ms,
    launches)], busy ms, wall ms)."""
    from torch.profiler import ProfilerActivity, profile

    with distill_spans() as names:
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.time()
            step_fn(state, wav, wav_rand, 2)
            torch.cuda.synchronize()
            wall_ms = 1e3 * (time.time() - t0)
    events = list(prof.events())
    seq_part = {}
    for evt in events:  # forward ops under a span: their sequence numbers
        seq = getattr(evt, "sequence_nr", -1)
        if seq is None or seq < 0 or evt.name.startswith("autograd::"):
            continue
        parent = evt.cpu_parent
        while parent is not None and parent.name not in names:
            parent = parent.cpu_parent
        if parent is not None:
            seq_part.setdefault(seq, parent.name)

    def part_of(evt):
        while evt is not None:
            if evt.name in names:
                return evt.name
            if evt.name.startswith("autograd::engine::evaluate_function"):
                part = seq_part.get(getattr(evt, "sequence_nr", -1))
                return f"{part} backward" if part else "other backward"
            evt = evt.cpu_parent
        return "other"

    by_part = {}
    for evt in events:
        own = sum(k.duration for k in getattr(evt, "kernels", ()) if k.name not in names) / 1e3
        if own:
            part = part_of(evt)
            by_part[part] = by_part.get(part, 0.0) + own
    by_name = {}
    for evt in events:
        if (str(getattr(evt, "device_type", "")).endswith("CUDA") and evt.name not in names
                and not getattr(evt, "is_user_annotation", False)):
            ms, n = by_name.get(evt.name, (0.0, 0))
            by_name[evt.name] = (ms + (evt.time_range.end - evt.time_range.start) / 1e3, n + 1)
    busy = sum(ms for ms, _ in by_name.values())
    require(busy > 0, "torch.profiler recorded no CUDA kernel in a distillation step")
    by_class = {}
    for name, (ms, _) in by_name.items():
        cls = next((c for c, keys in KERNEL_CLASSES if any(k in name for k in keys)), "other")
        by_class[cls] = by_class.get(cls, 0.0) + ms
    top = sorted(((k, ms, n) for k, (ms, n) in by_name.items()), key=lambda t: -t[1])[:8]
    return by_part, by_class, top, busy, wall_ms


def s5_timing(card, teacher_dir):
    teacher, te = runner.load_teacher(teacher_dir, device="cuda")
    cfg0 = config_lib.load_config(os.path.join(REPO, "configs/parallel_wavenet.json"))
    rows = {}
    for B, remat in ((4, False), (8, False), (8, True)):
        cfg = dataclasses.replace(cfg0, remat_teacher=remat)
        pwn, params = distill_student(cfg, teacher, te, 3)
        optimizer = train_lib.make_student_optimizer(cfg, params)
        state = train_lib.make_train_state(params, optimizer)
        step_fn = train_lib.make_pwn_train_step(pwn, te, optimizer)
        wav = torch.from_numpy(synthetic_wavs(B, cfg.wave_length, 91 + B)).cuda()
        wav_rand = torch.from_numpy(synthetic_wavs(B, cfg.wave_length, 191 + B)).cuda()
        for _ in range(2):
            state, _ = step_fn(state, wav, wav_rand, 2)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        t0 = time.time()
        start.record()
        for _ in range(TIMED_DISTILL_STEPS):
            state, metrics = step_fn(state, wav, wav_rand, 2)
        end.record()
        torch.cuda.synchronize()
        wall = (time.time() - t0) / TIMED_DISTILL_STEPS
        ms = start.elapsed_time(end) / TIMED_DISTILL_STEPS
        peak = torch.cuda.max_memory_allocated() / 2**30
        flops, t_flops, s_flops = distill_flops(cfg, teacher.cfg, B)
        bound = 1e3 * flops / PEAK_BF16_FLOPS
        rows[f"B{B}{'_remat' if remat else ''}"] = row = {
            "ms": ms, "wall_ms": 1e3 * wall, "steps_per_s": 1e3 / ms, "utt_per_s": 1e3 * B / ms,
            "peak_gib": peak, "tflop": flops / 1e12, "teacher_tflop": t_flops / 1e12,
            "student_tflop": s_flops / 1e12, "bound_ms": bound, "loss": float(metrics["loss"])}
        log(f"S5 distill step B={B} x {cfg.wave_length} remat_teacher={remat}: {ms:.2f} ms a step "
            f"(events; {row['wall_ms']:.2f} ms wall), {row['steps_per_s']:.2f} steps/s, "
            f"{row['utt_per_s']:.1f} utterances/s, peak memory {peak:.2f} GiB; "
            f"{flops / 1e12:.2f} TFLOP a step (teacher {t_flops / 1e12:.2f}, student "
            f"{s_flops / 1e12:.2f}), bound {bound:.2f} ms at the bf16 peak ({bound / ms:.1%} of "
            f"it); {card}")
        require(np.isfinite(row["loss"]), "S5: loss not finite")
        if not remat:
            by_part, by_class, top, busy, wall_ms = distill_breakdown(step_fn, state, wav,
                                                                      wav_rand)
            row["profile_ms"], row["profile_class_ms"] = by_part, by_class
            log(f"S5 profile of one step B={B}: device busy {busy:.1f} ms of {wall_ms:.1f} ms "
                f"wall, {sum(by_part.values()):.1f} ms attributed; by part: " + ", ".join(
                    f"{k} {v:.2f} ms" for k, v in sorted(by_part.items(), key=lambda kv: -kv[1])))
            log(f"S5 profile B={B} by kernel class: " + ", ".join(
                f"{k} {v:.2f} ms" for k, v in sorted(by_class.items(), key=lambda kv: -kv[1])))
            log(f"S5 profile B={B} top kernels: " + "; ".join(
                f"{name[:70]} {ms:.2f} ms x{n}" for name, ms, n in top))
        del state, step_fn, wav, wav_rand, params, optimizer
        torch.cuda.empty_cache()
    return rows


# ---- 33-38: resize-conv upsampling, serving from wavs, the golden gate, the native sampler ----

# the f32 resize-conv encoding on the card against the CPU, as a share of
# max |CPU|: the same f32 FMAs in another summation order (up to 80 taps x
# 256 channels a sum) with TF32 off.  In bf16 each layer's output is rounded
# to bf16 on both sides, so a value may land one bf16 step (up to 2^-7 of the
# largest value) away, and a flip in the first layer moves the second by a
# little more: two steps.
RESIZE_F32_REL_TOL = 1e-4
RESIZE_BF16_REL_TOL = 2.0 ** -6
RESIZE_TEACHER_BATCH = 64  # and MAIN_LENGTH samples
RESIZE_STUDENT_BATCH = 8  # x STUDENT_SAMPLES: the resize conv is some 20x the transposed conv's work
# (head, label, generate_cuda options) of phase 37: every serving mode on tiny_mol
GATE_MODES = (("mol", "bf16", {}),
              ("mol", "w8a8_static", dict(weight_dtype="int8", gate_static=True)),
              ("mol", "w8a8_row", dict(weight_dtype="int8")),
              ("mol", "w8a8_row_rs_bf16", dict(weight_dtype="int8", rs_dtype="bf16")),
              ("ce", "bf16", {}), ("gauss", "bf16", {}))
GATE_SAMPLES = 8000  # tests/test_golden_regression.py's teacher free run


def upsampler_flops(cfg, frames, B, resize):
    """Multiply-adds x 2 of the deconv stack over B mels of ``frames`` frames:
    a transposed conv takes ceil(fl / stride) taps an output sample, a resize
    conv all fl taps on the repeated input."""
    flops, t, cin = 0.0, frames, stft.MEL_PARAMS.num_mel
    for fl, stride in cfg.deconv_config:
        t *= stride
        taps = fl if resize else -(-fl // stride)
        flops += 2.0 * B * t * taps * cin * cfg.deconv_width
        cin = cfg.deconv_width
    return flops


def require_ar_launches(label, calls, counted, want_calls, want_kernels):
    log(f"{label}: generate calls {calls}, CUDA launches {counted}")
    require(calls == want_calls and counted == want_kernels,
            f"{label}: launches {calls} / {counted}, want {want_calls} / {want_kernels}")


def reset_ar_counts():
    fk.generate.launches = 0
    fk.generate.kernel_launches = dict.fromkeys(fk.KERNEL_NAMES, 0)


def ar_counts():
    return fk.generate.launches, {k: n for k, n in fk.generate.kernel_launches.items() if n}


def enc_err(label, card, cpu, rel_tol):
    err = float((card.float().cpu() - cpu.float()).abs().max())
    scale = float(cpu.float().abs().max())
    log(f"{label}: max|d| card-CPU {err:.3e}, scale {scale:.3f}, limit {rel_tol * scale:.3e} "
        f"({rel_tol:g} x scale)")
    require(err <= rel_tol * scale, f"{label}: card and CPU differ")
    return err / scale


def resize_teacher_phase(card):
    """Phase 33: the MoL teacher at full width with resize-conv upsampling."""
    model, params, kw = full_model("configs/wavenet_mol.json", seed=3, use_resize_conv=True)
    cfg = model.cfg
    out = {}
    mel = stft.melspectrogram(torch.from_numpy(synthetic_wavs(2, 16000, 33)).cuda())
    m32 = Wavenet(dataclasses.replace(cfg, compute_dtype="float32"))
    cpu_params = to_device(params, "cpu")
    with deterministic_cudnn(), no_tf32():
        out["enc_f32"] = enc_err("33 resize encoding f32 B=2 x 1 s", m32.deconv_stack(params, mel),
                                 m32.deconv_stack(cpu_params, mel.cpu()), RESIZE_F32_REL_TOL)
        out["enc_bf16"] = enc_err("33 resize encoding bf16 B=2 x 1 s", model.deconv_stack(params, mel),
                                  model.deconv_stack(cpu_params, mel.cpu()), RESIZE_BF16_REL_TOL)
        # a quarter second of conditioning: [30, 2, 4 200, 512] f32 on the CPU
        conds = zip(("encoding", "cond", "cond_out1"),
                    Fastgen(m32).precompute_conditioning(params, mel[:, :21]),
                    Fastgen(m32).precompute_conditioning(cpu_params, mel[:, :21].cpu()))
        out["conditioning"] = max(enc_err(f"33 precompute_conditioning {name}", g, c,
                                          RESIZE_F32_REL_TOL) for name, g, c in conds)
    del cpu_params
    out["kernel_err"], _ = check_kernel("33 resize mol full width", cfg, kw,
                                        conditioning(model, params, B=8, L=256, seed=34), seed=5,
                                        rel_tol=FULL_WIDTH_REL_TOL)

    B = RESIZE_TEACHER_BATCH
    mel = stft.melspectrogram(torch.from_numpy(synthetic_wavs(B, MAIN_LENGTH, 35)).cuda())
    fg = Fastgen(model)
    fg.generate_cuda(params, mel, seed=0, length=16, kw=kw)  # warm-up
    torch.cuda.synchronize()
    reset_ar_counts()
    t0 = time.time()
    audio = fg.generate_cuda(params, mel, seed=1, length=MAIN_LENGTH, kw=kw)
    torch.cuda.synchronize()
    dt = time.time() - t0
    calls, counted = ar_counts()
    require_ar_launches(f"33 resize main path B={B} L={MAIN_LENGTH}", calls, counted, 1,
                        {"fastgen_persistent": 1})
    require(tuple(audio.shape) == (B, MAIN_LENGTH) and bool(torch.isfinite(audio).all())
            and float(audio.abs().max()) <= 1.0, "33 resize main path audio")
    log(f"33 resize main path B={B} L={MAIN_LENGTH}: {dt:.3f} s with the upsampler, audio std "
        f"{float(audio.std()):.4f}")
    out["launches"] = calls

    # the upsampler alone, resize against transposed on the same weights (the
    # kernels of both are [fl, in, out]), in the model's arithmetic: operands
    # rounded to bf16, f32 products with TF32 off
    trans = Wavenet(dataclasses.replace(cfg, use_resize_conv=False))
    frames = mel.shape[1]
    resize_ms = cuda_ms(lambda: model.deconv_stack(params, mel))
    trans_ms = cuda_ms(lambda: trans.deconv_stack(params, mel))
    fl_resize, fl_trans = (upsampler_flops(cfg, frames, B, r) for r in (True, False))
    bound_ms = 1e3 * fl_resize / PEAK_F32_FLOPS
    log(f"33 upsampler B={B} x {frames} frames ({frames * cfg.frame_shift} samples): resize "
        f"{resize_ms:.2f} ms ({fl_resize / 1e12:.2f} TFLOP, bound {bound_ms:.2f} ms at the f32 "
        f"peak, {1e3 * fl_resize / PEAK_BF16_FLOPS:.2f} ms at the bf16 peak; "
        f"{fl_resize / resize_ms / 1e9:.1f} TFLOP/s), transposed {trans_ms:.2f} ms "
        f"({fl_trans / 1e12:.3f} TFLOP, bound {1e3 * fl_trans / PEAK_F32_FLOPS:.2f} ms); "
        f"{card}")
    out.update(resize_ms=resize_ms, transposed_ms=trans_ms, bound_ms=bound_ms,
               tflop=fl_resize / 1e12)
    return out


def resize_student_phase():
    """Phase 34: the student at full width with resize-conv upsampling."""
    pwn, params = student_model(seed=4, use_resize_conv=True)
    cfg = pwn.cfg
    B = RESIZE_STUDENT_BATCH
    mel = stft.melspectrogram(torch.from_numpy(synthetic_wavs(B, STUDENT_SAMPLES, 36)).cuda())
    L = pwn.sample_length(mel.shape[1])
    cycles = sum(-(-n // cfg.num_stages) for n in cfg.num_iaf_layers)
    parallelgen.synthesize_cuda(pwn, params, mel[:, :6], torch.Generator().manual_seed(0))
    torch.cuda.synchronize()  # warm-up
    reset_flow_counts()
    t0 = time.time()
    audio = parallelgen.synthesize_cuda(pwn, params, mel, torch.Generator().manual_seed(1))
    torch.cuda.synchronize()
    dt = time.time() - t0
    calls, counted = flk.flow_stack.launches, dict(flk.flow_stack.kernel_launches)
    log(f"34 resize student B={B} L={L}: {1e3 * dt:.1f} ms, flow_stack calls {calls} (want "
        f"{cycles}), CUDA launches {counted}; audio std {float(audio.std()):.4f}")
    require(calls == cycles, "34: flow_stack calls")
    require_launches("34 resize student", counted,
                     {k: n * cycles for k, n in flk.predicted_launches(cfg.width, cfg.num_stages,
                                                                        False).items()})
    require(tuple(audio.shape) == (B, L) and bool(torch.isfinite(audio).all())
            and float(audio.abs().max()) <= 1.0, "34 resize student audio")
    inputs = {"mel": mel, "base_x": pwn.base_noise(torch.Generator().manual_seed(9), B, L, "cuda")}
    with deterministic_cudnn():  # one encoding for both runs
        ff_k = parallelgen.feed_forward_cuda(pwn, params, inputs)
        ff_p = with_plain_flow_kernel(lambda: parallelgen.feed_forward_cuda(pwn, params, inputs))
    worst = 0.0
    for k in ("x", "mean_tot", "scale_tot", "log_scale_tot"):
        err = float((ff_k[k] - ff_p[k]).abs().max())
        scale = max(float(ff_p[k].abs().max()), 1e-3)
        log(f"34 resize student feed-forward {k}: max|d| kernel-plain {err:.3e}, scale {scale:.3e}, "
            f"limit {STUDENT_REL_TOL * scale:.3e}")
        require(err <= STUDENT_REL_TOL * scale, f"34 resize student feed-forward {k} differs")
        worst = max(worst, err / scale)
    return {"launches": calls, "kernel_launches": counted["flow_persist_kernel"], "ff_err": worst,
            "ms": 1e3 * dt}


@contextlib.contextmanager
def first_upsampler_taps(store):
    """Inside the block, keep the first resize conv's output (its
    pre-activation, 'pre') and the gradient reaching its activation's output
    ('dx', at the second resize conv's input), as f64 on the CPU."""
    real = conv_ops.resize_conv1d

    def tap(params, x, **kw):
        y = real(params, x, **kw)
        if not store:
            store["pre"] = y.detach().double().cpu()
        elif "dx" not in store and x.requires_grad:
            x.register_hook(lambda g: store.__setitem__("dx", g.detach().double().cpu()))
        return y

    conv_ops.resize_conv1d = tap
    try:
        yield
    finally:
        conv_ops.resize_conv1d = real


@contextlib.contextmanager
def conv_kernels_of(device):
    """On the card, the names of the cuDNN convolution kernels (and any FFT
    kernel) that ran inside the block, filled in at its end, by
    torch.profiler; elsewhere an empty list."""
    names = []
    if device != "cuda":
        yield names
        return
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        yield names
        torch.cuda.synchronize()
    names += sorted({evt.key[:90] for evt in prof.key_averages()
                     if any(k in evt.key.lower() for k in ("conv", "grad", "fft", "winograd"))})


def kink_readings(taps, layer, slope):
    """Where the first upsampler's gain gradient parts from f64: the
    pre-activations that sit on the other side of 0 from the f64 run's (so
    that the leaky ReLU's derivative is 1 on one side and ``slope`` on the
    other), and the gain gradient rebuilt from each run's own tensors with
    its own derivative mask and with the f64 run's, each against f64.
    taps: {run: first_upsampler_taps' store}, 'f64' among them."""
    g = layer["g"].detach().double().cpu()
    b = layer["b"].detach().double().cpu()
    ref = taps["f64"]

    def gain_grad(t, mask_of):
        gy = t["dx"] * torch.where(mask_of["pre"] > 0, 1.0, slope)
        return (gy * (t["pre"] - b) / g).sum(dim=(0, 1))

    want = gain_grad(ref, ref)
    scale = float(want.abs().max())
    out = {}
    for run in ("card", "cpu"):
        t = taps[run]
        flipped = (t["pre"] > 0) != (ref["pre"] > 0)
        near = float(ref["pre"][flipped].abs().max()) if bool(flipped.any()) else 0.0
        out[run] = {"flipped": int(flipped.sum()),
                    "largest_flipped_pre": near / float(ref["pre"].abs().max()),
                    "own_mask": float((gain_grad(t, t) - want).abs().max()) / scale,
                    "f64_mask": float((gain_grad(t, ref) - want).abs().max()) / scale}
    return out


def resize_teacher_step(head, gated=True):
    """A weight-normed resize-conv teacher with the ``head`` loss, cut to 4
    layers, f32, TF32 off: the data-dependent init on the card and on the
    CPU, then the gradients from one point, the CPU's init, on the card, on
    the CPU and in f64 on the CPU, and (gated) one step on the card and on
    the CPU.  Returns (readings, model, the CPU's init, the card's loss): the
    distances card-CPU (DDI, loss, gradients, update), card-f64 and CPU-f64
    over all leaves and on the leaf where card and CPU part most, and
    kink_readings of the first upsampler.  ``gated``: hold the card to the
    CPU with T1's limits; else the distances are a reading only."""
    cfg = config_lib.load_config(os.path.join(REPO, f"configs/wavenet_{head}.json"), num_layers=4,
                                 compute_dtype="float32", dropout_inputs=False,
                                 use_resize_conv=True, use_weight_norm=True)
    model = Wavenet(cfg)
    params = model.init_params(0, device="cpu")
    wav = torch.from_numpy(synthetic_wavs(2, cfg.wave_length, 37))
    ddi = {}
    for device in ("cuda", "cpu") if gated else ("cpu",):
        w = wav.to(device)
        with no_tf32():
            _, ddi[device] = train_lib.run_data_dep_init(model, to_device(params, device), w,
                                                         stft.melspectrogram(w))
    p = ddi["cpu"]
    res, taps = {}, {}
    for run, device, dtype in (("card", "cuda", torch.float32), ("cpu", "cpu", torch.float32),
                               ("f64", "cpu", torch.float64)):
        w = wav.to(device, dtype)
        p_d = tree_lib.tree_map(lambda t: t.detach().to(device, dtype), p)
        taps[run] = {}
        with no_tf32():
            mel = stft.melspectrogram(w)
            with first_upsampler_taps(taps[run]), conv_kernels_of(device) as convs:
                loss, grads = train_lib.loss_and_grads(model, p_d, w, mel)
            tf32 = (torch.backends.cudnn.allow_tf32, getattr(
                getattr(torch.backends.cudnn, "conv", None), "fp32_precision", None))
        if device == "cuda":
            log(f"35 resize teacher ({head}) on the card under no_tf32: cudnn.allow_tf32 "
                f"{tf32[0]}, cudnn.conv.fp32_precision {tf32[1]}; the convolution kernels of "
                f"the step's forward and backward: {convs}")
        state = None
        if gated and dtype == torch.float32:
            optimizer = opt_lib.make_optimizer(cfg.lr_schedule)
            state, _ = train_lib.make_wavenet_train_step(model, optimizer)(
                train_lib.make_train_state(p_d, optimizer), w)
        res[run] = (float(loss), grads, state)
    (l_g, g_g, s_g), (l_c, g_c, s_c), (_, g_64, _) = res["card"], res["cpu"], res["f64"]
    fg, fc, f64 = (weights.flatten(t) for t in (g_g, g_c, g_64))
    worst = max(((leaf_err([fc[k]], [fg[k]]), k, leaf_err([f64[k]], [fg[k]]),
                  leaf_err([f64[k]], [fc[k]])) for k in fg), key=lambda r: r[0])
    out = {"loss_rel": abs(l_g - l_c) / max(abs(l_c), 1.0), "grad": leaf_err(g_c, g_g),
           "grad_card_f64": leaf_err(g_64, g_g), "grad_cpu_f64": leaf_err(g_64, g_c),
           "worst_leaf": worst[1], "worst_card_f64": worst[2], "worst_cpu_f64": worst[3],
           "kink": kink_readings(taps, p["deconv"]["up_1"], 0.4)}
    log(f"35 resize teacher ({head}, 4 layers, weight norm, f32) from the CPU's init, card vs "
        f"CPU: loss rel {out['loss_rel']:.2e}, gradients {out['grad']:.3e}; card-f64 "
        f"{out['grad_card_f64']:.3e}, CPU f32-f64 {out['grad_cpu_f64']:.3e}; the leaf furthest "
        f"card-CPU {worst[1]}: card-f64 {worst[2]:.3e}, CPU f32-f64 {worst[3]:.3e}")
    for run, k in out["kink"].items():
        log(f"35 resize teacher ({head}) first upsampler, {run}: {k['flipped']} pre-activations "
            f"across 0 from f64's (the largest {k['largest_flipped_pre']:.2e} of max |pre|); the "
            f"gain gradient rebuilt with its own leaky-ReLU mask {k['own_mask']:.3e} from f64, "
            f"with f64's mask {k['f64_mask']:.3e}")
    if not gated:
        return out, model, p, l_g
    out["ddi"] = leaf_err(ddi["cpu"], ddi["cuda"], floor=1e-2)  # b = -mean * scale: roundoff at mean 0
    out["params"] = update_err(p, s_c["params"], s_g["params"], g_c)
    out["ema"] = update_err(p, s_c["ema"], s_g["ema"], g_c)
    log(f"35 resize teacher ({head}) card vs CPU: DDI params max {out['ddi']:.3e} of a leaf's "
        f"scale (at least 1e-2), loss rel {out['loss_rel']:.2e}, gradients {out['grad']:.3e}, "
        f"params after Adam {out['params']:.3e}, EMA {out['ema']:.3e} (limits "
        f"{TRAIN_GRAD_REL_TOL:.0e}, {TRAIN_LOSS_REL_TOL:.0e}, {TRAIN_GRAD_REL_TOL:.0e}, "
        f"{TRAIN_UPDATE_REL_TOL:.0e})")
    require(out["ddi"] <= TRAIN_GRAD_REL_TOL and out["loss_rel"] <= TRAIN_LOSS_REL_TOL
            and out["grad"] <= TRAIN_GRAD_REL_TOL
            and max(out["params"], out["ema"]) <= TRAIN_UPDATE_REL_TOL,
            f"35: the resize-conv {head} teacher's init and step differ between card and CPU")
    return out, model, p, l_g


def resize_training_phase():
    """Phase 35, f32, TF32 off, card against CPU with T1's and S1's limits:
    weight-normed resize-conv teachers cut to 4 layers, MoL and Gauss (the
    data-dependent init, then one step from one point, as T1), a
    weight-normed resize-conv Gauss student of flows 2 / 2 under the Gauss
    teacher (the init), and the same student without weight norm (one step,
    as S1).  A weight-normed student's freshly rescaled leaves take
    roundoff-sized gradients, which Adam steps by the learning rate whatever
    their size, so its step is taken without weight norm."""
    out = {}
    out["teacher_mol"], *_ = resize_teacher_step("mol", gated=False)
    out["teacher"], model, p_c, l_g = resize_teacher_step("gauss")
    cfg = model.cfg
    wav = torch.from_numpy(synthetic_wavs(2, cfg.wave_length, 37))
    # the bf16 training forward hands cuDNN bf16 operands (conv1d native=True)
    bmodel = Wavenet(dataclasses.replace(cfg, compute_dtype="bfloat16"))
    optimizer = opt_lib.make_optimizer(cfg.lr_schedule)
    _, metrics = train_lib.make_wavenet_train_step(bmodel, optimizer)(
        train_lib.make_train_state(to_device(p_c, "cuda"), optimizer), wav.cuda())
    log(f"35 resize teacher bf16 step on the card: loss {float(metrics['loss']):.4f} (f32 {l_g:.4f})")
    require(bool(torch.isfinite(metrics["loss"])), "35: the bf16 resize-conv step is not finite")

    teacher = Wavenet(dataclasses.replace(cfg, use_weight_norm=False, use_as_teacher=True))
    te_cpu = teacher.init_params(0, device="cpu")
    wav_rand = torch.from_numpy(synthetic_wavs(2, cfg.wave_length, 38))
    res = {}
    for device in ("cuda", "cpu"):
        te = to_device(te_cpu, device)
        mel = stft.melspectrogram(wav.to(device))
        row = []
        for wn in (True, False):
            scfg = config_lib.load_config(os.path.join(REPO, "configs/parallel_wavenet_gauss.json"),
                                          num_iaf_layers=(2, 2), compute_dtype="float32",
                                          use_resize_conv=True, use_weight_norm=wn)
            pwn = ParallelWavenet(scfg, teacher)
            p = pwn.init_params(1, device=device)
            L = pwn.sample_length(mel.shape[1])
            draws = train_lib.student_draws(pwn, torch.Generator().manual_seed(5), 2, L, "cpu")
            draws = {k: v.to(device) for k, v in draws.items()}
            if wn:
                _, p = pwn.data_dep_init(p, mel, base_x=draws["base_x"])
                row.append(p)
                continue
            p = transplant_teacher_deconv(p, te)
            tap = GradTap(train_lib.make_student_optimizer(scfg, p))
            state, metrics = train_lib.make_pwn_train_step(pwn, te, tap)(
                train_lib.make_train_state(p, tap), wav.to(device), wav_rand.to(device), None,
                draws=draws)
            row += [p, metrics, tap.grads, state]
        res[device] = row
    (d_g, p_g, m_g, g_g, s_g), (d_c, p_c, m_c, g_c, s_c) = res["cuda"], res["cpu"]
    ddi_err, grad_err = leaf_err(d_c, d_g, floor=1e-2), leaf_err(g_c, g_g)
    metric_err = max(abs(float(m_g[k]) - float(m_c[k])) / max(abs(float(m_c[k])), 1.0) for k in m_c)
    p_err = update_err(p_c, s_c["params"], s_g["params"], g_c)
    e_err = update_err(p_c, s_c["ema"], s_g["ema"], g_c)
    log(f"35 resize student (gauss + power, flows 2/2, f32) card vs CPU: DDI params (weight "
        f"norm) max {ddi_err:.3e}; step: metrics max rel {metric_err:.2e}, gradients "
        f"{grad_err:.3e}, params after Adam {p_err:.3e}, EMA {e_err:.3e}")
    require(ddi_err <= TRAIN_GRAD_REL_TOL and metric_err <= TRAIN_LOSS_REL_TOL
            and grad_err <= TRAIN_GRAD_REL_TOL and max(p_err, e_err) <= TRAIN_UPDATE_REL_TOL,
            "35: the resize-conv student's init and step differ between card and CPU")
    out["student"] = {"ddi": ddi_err, "metrics_rel": metric_err, "grad": grad_err,
                      "params": p_err, "ema": e_err}
    return out


def from_wav_phase(tmp):
    """Phase 36: synthesis from raw wavs at full width, and npy_only."""
    out = {}
    model, params, kw = full_model("configs/wavenet_mol.json")
    fg = Fastgen(model)
    wav = torch.from_numpy(synthetic_wavs(8, 8000, 39)).cuda()
    with deterministic_cudnn():  # one encoding for both runs
        reset_ar_counts()
        got = fg.generate_from_wav(params, wav, 3, length=2000, kw=kw)
        torch.cuda.synchronize()
        calls, counted = ar_counts()
        want = fg.generate_cuda(params, stft.melspectrogram(wav), 3, length=2000, kw=kw)
    require_ar_launches("36 Fastgen.generate_from_wav B=8 L=2000", calls, counted, 1,
                        {"fastgen_persistent": 1})
    same = bool(torch.equal(got, want))
    log(f"36 generate_from_wav equal bit for bit to the card mel -> generate_cuda: {same}; audio "
        f"std {float(got.std()):.4f}")
    require(same and bool(torch.isfinite(got).all()), "36: generate_from_wav differs")
    out["teacher_launches"] = calls
    del model, params, kw, fg

    pwn, sparams = student_model(seed=5)
    cycles = sum(-(-n // pwn.cfg.num_stages) for n in pwn.cfg.num_iaf_layers)
    swav = torch.from_numpy(synthetic_wavs(8, 16000, 40)).cuda()
    with deterministic_cudnn():
        got, counted = kernel_launches_of(lambda: parallelgen.synthesize_from_wav(
            pwn, sparams, swav, torch.Generator().manual_seed(4)))
        want = parallelgen.synthesize_cuda(pwn, sparams, stft.melspectrogram(swav),
                                           torch.Generator().manual_seed(4))
    require_launches("36 parallelgen.synthesize_from_wav B=8 x 1 s", counted,
                     {k: n * cycles for k, n in flk.predicted_launches(
                         pwn.cfg.width, pwn.cfg.num_stages, False).items()})
    same = bool(torch.equal(got, want))
    log(f"36 synthesize_from_wav equal bit for bit to the card mel -> synthesize_cuda: {same}; "
        f"CUDA launches {counted}")
    require(same and bool(torch.isfinite(got).all()), "36: synthesize_from_wav differs")
    out["student_launches"] = counted["flow_persist_kernel"]
    del pwn, sparams

    gdir = os.path.join(GOLDEN, "tiny_mol")
    src = os.path.join(tmp, "npy_src")
    os.makedirs(src)
    wavs = synthetic_wavs(2, 1000, 41)
    for i, w in enumerate(wavs):
        wav_io.write_wav(os.path.join(src, f"utt_{i}.wav"), w)
    mels = stft.melspectrogram_np(wavs[:, :600])  # 4 frames
    np.save(os.path.join(src, "mel_a.npy"), mels[0])
    np.save(os.path.join(src, "mel_b.npy"), mels[1, :3])
    reset_ar_counts()
    paths = generate_wavenet(src, os.path.join(gdir, "params.npz"), os.path.join(gdir, "meta.json"),
                             os.path.join(tmp, "npy_gen"), device="cuda", npy_only=True)
    calls, counted = ar_counts()
    names = [os.path.basename(p) for p in paths]
    lengths = [len(wav_io.read_wav(p)[0]) for p in paths]
    log(f"36 generate_wavenet(npy_only=True) over 2 wavs and 2 .npy mels: wrote {names}, "
        f"{lengths} samples; generate calls {calls}, CUDA launches {counted}")
    require(names == ["gen_mel_a.wav", "gen_mel_b.wav"] and lengths == [800, 800]
            and calls == 1 and counted == {"fastgen_persistent": 1}, "36: npy_only")
    return out


def gate_phase(card):
    """Phase 37: the JAX package's golden gate (tests/test_golden_regression.py)
    on the card: every serving mode of the AR kernel on tiny_mol, bf16 on
    tiny_ce and tiny_gauss, and the golden student through the flow kernel."""
    readings = {}
    calls_total, launches_total = 0, {}
    for head, mode, kw in GATE_MODES:
        d = os.path.join(GOLDEN, f"tiny_{head}")
        with open(os.path.join(d, "meta.json")) as f:
            meta = json.load(f)
        model = Wavenet(config_lib.load_config(os.path.join(d, "meta.json")))
        params = weights.load_npz(os.path.join(d, "params.npz"), device="cuda")
        fg = Fastgen(model)
        mels, wavs = quality.eval_mels(meta["eval_seeds"][:2])
        mels = mels[:, : 1 + GATE_SAMPLES // model.cfg.frame_shift]
        if mode == "w8a8_static":
            kw = dict(kw, act_amax=fg.calibrate_act_amax(
                params, torch.from_numpy(wavs).cuda(),
                torch.from_numpy(stft.melspectrogram_np(wavs)).cuda()))
        reset_ar_counts()
        audio = fg.generate_cuda(params, torch.from_numpy(mels).cuda(), seed=7, **kw).cpu().numpy()
        calls, counted = ar_counts()
        want = {"fastgen_persistent": 1, **({"quant_enc_kernel": 1} if mode != "bf16" else {})}
        require_ar_launches(f"37 gate {head} {mode}", calls, counted, 1, want)
        calls_total += calls
        for k, n in counted.items():
            launches_total[k] = launches_total.get(k, 0) + n
        require(np.isfinite(audio).all() and np.abs(audio).max() <= 1.0, f"37 {head} {mode} audio")
        mt = quality.mel_track_metrics(audio, mels, GATE_SAMPLES)
        ok, reading = quality.golden_gate(mt, meta["matched_corr"], quality.TEACHER_MARGIN)
        log(f"37 gate tiny_{head} {mode}: {reading}; {card}")
        require(ok, f"37: tiny_{head} {mode} fails the golden gate")
        readings[f"{head}_{mode}"] = {"matched_corr": mt["corr"][0], "mismatched_corr": mt["corr"][1],
                                      "gate": meta["matched_corr"] - quality.TEACHER_MARGIN,
                                      "mcd": mt["mcd"], "generate_calls": calls,
                                      "kernel_launches": counted}
    readings["teacher_generate_calls"] = calls_total
    readings["teacher_kernel_launches"] = launches_total
    pwn, sparams, sdir = golden_student()
    cycles = sum(-(-n // pwn.cfg.num_stages) for n in pwn.cfg.num_iaf_layers)
    with open(os.path.join(sdir, "meta.json")) as f:
        meta = json.load(f)
    mels, _ = quality.eval_mels(meta["eval_seeds"])
    audio, counted = kernel_launches_of(lambda: parallelgen.synthesize_cuda(
        pwn, sparams, torch.from_numpy(mels).cuda(), torch.Generator().manual_seed(7)))
    audio = audio.cpu().numpy()
    require_launches("37 gate tiny_student", counted,
                     {k: n * cycles for k, n in flk.predicted_launches(
                         pwn.cfg.width, pwn.cfg.num_stages, False).items()})
    log(f"37 gate tiny_student: CUDA launches {counted}")
    require(np.isfinite(audio).all() and np.abs(audio).max() <= 1.0, "37 tiny_student audio")
    mt = quality.mel_track_metrics(audio, mels, meta["gen_samples"])
    ok, reading = quality.golden_gate(mt, meta["matched_corr"], quality.STUDENT_MARGIN)
    log(f"37 gate tiny_student: {reading}; {card}")
    require(ok, "37: tiny_student fails the golden gate")
    readings["student"] = {"matched_corr": mt["corr"][0], "mismatched_corr": mt["corr"][1],
                           "gate": meta["matched_corr"] - quality.STUDENT_MARGIN, "mcd": mt["mcd"],
                           "kernel_launches": counted}
    return readings


def runner_gather(run_dir):
    """The crop gather a runner names in its train.log."""
    with open(os.path.join(run_dir, "train.log")) as f:
        return re.findall(r"crop gather: (.*)", f.read())


def native_sampler_phase(tmp, trained):
    """Phase 38: the native crop sampler built by g++ into _build/, its crops
    equal to the numpy gather, and T2's and S2's runners gathering with it."""
    from nsynth_wavenet_tpu_torch.data import dataset as data_lib
    from nsynth_wavenet_tpu_torch.data.native import native as native_lib

    t0 = time.time()
    lib = native_lib.load()
    path = native_lib.library_path()
    log(f"38 native sampler: {'loaded' if lib is not None else 'NOT built'} "
        f"{os.path.relpath(path, REPO)} ({time.time() - t0:.2f} s)")
    require(lib is not None and path.parent == build.BUILD_DIR, "38: the native sampler did not build")
    ds = speechlike_dataset(os.path.join(tmp, "native_ds"), n_utts=8)
    a, b = data_lib.Dataset(ds), data_lib.Dataset(ds, use_native=False)
    require(a.native and not b.native, "38: Dataset did not take the native sampler")
    for seed, (B, n) in enumerate(((4, 7680), (64, 7680), (300, 16000))):
        require(np.array_equal(a.random_crop_batch(np.random.default_rng(seed), B, n),
                               b.random_crop_batch(np.random.default_rng(seed), B, n)),
                f"38: native crops B={B} x {n} differ from numpy's")
    for xa, xb in zip(a.sequential_batches(3, 40000), b.sequential_batches(3, 40000)):
        require(np.array_equal(xa, xb), "38: native sequential batches differ")
    out = {"crops_equal": True}
    for name in ("T2", "S2"):
        gather = trained[name]["gather"]
        log(f"38 {name} runner's train.log: crop gather {gather}")
        require(gather == ["the native C++ sampler"], f"38: the {name} runner did not gather natively")
        out[name] = gather[0]
    return out


def serving_leftover_phases(card, trained):
    """Phases 33 to 38, after the training phases."""
    t0 = time.time()
    out = {"33": resize_teacher_phase(card)}
    torch.cuda.empty_cache()
    out["34"] = resize_student_phase()
    torch.cuda.empty_cache()
    out["35"] = resize_training_phase()
    with tempfile.TemporaryDirectory() as tmp:
        out["36"] = from_wav_phase(tmp)
        out["37"] = gate_phase(card)
        out["38"] = native_sampler_phase(tmp, trained)
    log(f"phases 33-38: {time.time() - t0:.1f} s")
    return out


# ---- M1-M2: the device mesh ------------------------------------------------------


def _free_port():
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def mesh_teacher():
    cfg = config_lib.load_config(os.path.join(REPO, "configs/wavenet_gauss.json"), num_layers=4,
                                 compute_dtype="float32", dropout_inputs=False)
    model = Wavenet(cfg)
    return model, model.init_params(0, device="cuda")


def mesh_steps(mesh, wav, model, params):
    """One teacher step on this rank's rows of ``wav`` over ``mesh`` and one
    step without a mesh on all of them, from the same state: (their
    states, losses, grads of the whole batch) under cuDNN's deterministic
    algorithms."""
    rows = mesh_lib.rows(mesh, wav.shape[0])
    out = []
    with deterministic_cudnn():
        for m, w in ((mesh, wav[rows]), (None, wav)):
            opt = opt_lib.make_optimizer(model.cfg.lr_schedule, grad_clip=True)
            state = train_lib.make_train_state(params, opt)
            state, metrics = train_lib.make_wavenet_train_step(model, opt, mesh=m)(state, w)
            out.append((state, float(metrics["loss"])))
    with no_tf32():
        _, grads = train_lib.loss_and_grads(model, params, wav, stft.melspectrogram(wav))
    return out, grads


def mesh_step_errs(label, params, out, grads):
    (s_m, l_m), (s_1, l_1) = out
    loss_err = abs(l_m - l_1) / max(abs(l_1), 1.0)
    p_err = update_err(params, s_1["params"], s_m["params"], grads)
    e_err = update_err(params, s_1["ema"], s_m["ema"], grads)
    log(f"{label}: loss {l_m:.6f} / one rank {l_1:.6f} (rel {loss_err:.2e}, limit "
        f"{MESH_METRIC_TOL:.0e}); params after Adam {p_err:.3e}, EMA {e_err:.3e} (L2 of the "
        f"update, limit {MESH_UPDATE_TOL:.0e})")
    require(loss_err <= MESH_METRIC_TOL, f"{label}: loss")
    require(p_err <= MESH_UPDATE_TOL and e_err <= MESH_UPDATE_TOL, f"{label}: params / EMA")
    return {"loss_rel": loss_err, "params": p_err, "ema": e_err}


def m1_nccl_world_one():
    """M1: see the module docstring."""
    t0 = time.time()
    saved = {k: os.environ.get(k) for k in ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE",
                                            "LOCAL_RANK")}
    os.environ.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(_free_port()), RANK="0",
                      WORLD_SIZE="1", LOCAL_RANK="0")
    try:
        dev = mesh_lib.init_distributed("cuda")
        backend = mesh_lib.dist.get_backend()
        require(backend == "nccl" and dev == torch.device("cuda", 0),
                f"M1: backend {backend} on {dev}")
        x = torch.arange(4.0, device=dev)
        red = mesh_lib.all_reduce(x, mesh_lib.dist.group.WORLD)
        gathered = mesh_lib.all_gather(x, mesh_lib.dist.group.WORLD)
        require(torch.equal(red, x) and len(gathered) == 1 and torch.equal(gathered[0], x),
                "M1: NCCL all-reduce / all-gather")
        mesh = mesh_lib.make_mesh(n_data=1)
        model, params, kw = full_model("configs/wavenet_mol.json")
        fg = Fastgen(model)
        enc = conditioning(model, params, B=64, L=512, seed=40).transpose(0, 1)
        single = fg.generate_cuda(params, None, 11, encoding=enc, kw=kw)
        reset_ar_counts()
        sharded = fg.generate_cuda_sharded(params, None, 11, mesh, encoding=enc, kw=kw)
        torch.cuda.synchronize()
        calls, counted = ar_counts()
        log(f"M1 NCCL world 1: generate_cuda_sharded B=64 L=512 at full width, {calls} generate "
            f"call(s), CUDA launches {counted}; bit-equal to generate_cuda: "
            f"{bool(torch.equal(sharded, single))}")
        require(torch.equal(sharded, single), "M1: sharded generation differs from one rank")
        require_ar_launches("M1", calls, counted, 1, {"fastgen_persistent": 1})
        del model, params, kw, fg, enc
        tmodel, tparams = mesh_teacher()
        wav = torch.from_numpy(synthetic_wavs(4, tmodel.cfg.wave_length, 41)).cuda()
        out, grads = mesh_steps(mesh, wav, tmodel, tparams)
        step = mesh_step_errs("M1 DP teacher step over NCCL (gauss, 4 layers, f32, B=4)",
                              tparams, out, grads)
    finally:
        mesh_lib.shutdown()
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    log(f"M1: {time.time() - t0:.1f} s")
    return {"launches": counted, "step": step, "seconds": time.time() - t0}


def mesh_rank_main():
    """One rank of M2 (chip_smoke.py --mesh-rank): prints its result as a
    line 'MESH_RANK_RESULT <json>'."""
    dev = mesh_lib.init_distributed("cuda:0", backend="gloo")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rank, n = mesh_lib.process_index(), mesh_lib.process_count()
    mesh = mesh_lib.make_mesh(n_data=n)
    res = {"rank": rank}
    model, params, kw = full_model("configs/wavenet_mol.json")
    fg = Fastgen(model)
    B = 16
    # one encoding on every rank: cuDNN's transposed convolution need not
    # give two processes the same bits
    enc = mesh_lib.broadcast(conditioning(model, params, B=B, L=256, seed=50).transpose(0, 1))
    rows = mesh_lib.rows(mesh, B)
    # the one-rank references first, then the sharded calls with the counts reset
    greedy_one = fg.generate_cuda(params, None, 21, encoding=enc, kw=kw, greedy=True)
    sampled_rows = fg.generate_cuda(params, None, shard_seed(21, rank), encoding=enc[rows], kw=kw)
    pwn, sparams = student_model()
    pwn32 = ParallelWavenet(dataclasses.replace(pwn.cfg, compute_dtype="float32"))
    cycles = sum(-(-n // pwn.cfg.num_stages) for n in pwn.cfg.num_iaf_layers)
    mel = torch.rand((8, 81, 80), generator=torch.Generator().manual_seed(52)).cuda()
    with deterministic_cudnn():
        synth_one = parallelgen.synthesize_cuda(pwn, sparams, mel,
                                                torch.Generator().manual_seed(53))
        synth_rows = parallelgen.synthesize_cuda(
            pwn, sparams, mel[mesh_lib.rows(mesh, 8)],
            mesh_lib.RowDraws(torch.Generator().manual_seed(53), mesh_lib.rows(mesh, 8).start, 8))
        # the f32 student against one rank's B = 8 call (outside the counts)
        synth32_one = parallelgen.synthesize_cuda(pwn32, sparams, mel,
                                                  torch.Generator().manual_seed(53))
        synth32 = parallelgen.synthesize_sharded(pwn32, sparams, mel,
                                                 torch.Generator().manual_seed(53), mesh)
    torch.cuda.synchronize()
    reset_ar_counts()
    reset_flow_counts()
    greedy = fg.generate_cuda_sharded(params, None, 21, mesh, encoding=enc, kw=kw, greedy=True)
    sampled = fg.generate_cuda_sharded(params, None, 21, mesh, encoding=enc, kw=kw)
    with deterministic_cudnn():
        synth = parallelgen.synthesize_sharded(pwn, sparams, mel,
                                               torch.Generator().manual_seed(53), mesh)
    torch.cuda.synchronize()
    calls, counted = ar_counts()
    res["launches"] = {**counted, "flow_persist_kernel":
                       flk.flow_stack.kernel_launches["flow_persist_kernel"]}
    res["generate_calls"] = calls
    res["flow_calls"], res["flow_cycles"] = flk.flow_stack.launches, cycles
    res["flow_launches"] = dict(flk.flow_stack.kernel_launches)
    res["flow_want"] = {k: n * cycles for k, n in flk.predicted_launches(
        pwn.cfg.width, pwn.cfg.num_stages, False).items()}
    res["greedy_equal"] = bool(torch.equal(greedy, greedy_one))
    res["sampled_rows_equal"] = bool(torch.equal(sampled[rows], sampled_rows))
    res["sampled_shape"] = list(sampled.shape)
    bins = pwn.cfg.quant_chann / 2
    res["synth_bins"] = float((synth[mesh_lib.rows(mesh, 8)] - synth_rows).abs().max()) * bins
    res["synth_bins_whole_batch"] = float((synth - synth_one).abs().max()) * bins
    res["synth32_bins_whole_batch"] = float((synth32 - synth32_one).abs().max()) * bins
    res["synth_finite"] = bool(torch.isfinite(synth).all() and torch.isfinite(synth32).all())
    del model, params, kw, fg, pwn, pwn32, sparams
    torch.cuda.empty_cache()
    tmodel, tparams = mesh_teacher()
    wav = torch.from_numpy(synthetic_wavs(4, tmodel.cfg.wave_length, 54)).cuda()
    out, grads = mesh_steps(mesh, wav, tmodel, tparams)
    res["teacher_step"] = mesh_step_errs(f"M2 rank {rank} DP teacher step", tparams, out, grads)
    res["distill_step"] = m2_distill_step(mesh, rank)
    print("MESH_RANK_RESULT " + json.dumps(res), flush=True)
    mesh_lib.shutdown()
    return 0


def m2_distill_step(mesh, rank):
    """A distillation step of the Gauss pair (teacher 4 layers, student flows
    2 / 2, f32) on this rank's rows of a global B = 4 against one rank's
    step on all 4 rows, from the same state and draws."""
    student_path, teacher_path = S_PAIRS[1]
    teacher = Wavenet(config_lib.load_config(
        os.path.join(REPO, teacher_path), num_layers=4, compute_dtype="float32",
        dropout_inputs=False, use_as_teacher=True))
    te = teacher.init_params(0, device="cuda")
    cfg = config_lib.load_config(os.path.join(REPO, student_path), num_iaf_layers=(2, 2),
                                 compute_dtype="float32")
    pwn, params = distill_student(cfg, teacher, te, 1)
    wav = torch.from_numpy(synthetic_wavs(4, cfg.wave_length, 55)).cuda()
    wav_rand = torch.from_numpy(synthetic_wavs(4, cfg.wave_length, 56)).cuda()
    L = pwn.sample_length(stft.num_mel_frames(cfg.wave_length))
    draws = train_lib.student_draws(pwn, torch.Generator().manual_seed(57), 4, L, "cpu")
    draws = {k: v.cuda() for k, v in draws.items()}
    rows = mesh_lib.rows(mesh, 4)
    res = []
    with deterministic_cudnn():
        for m, w, wr in ((mesh, wav[rows], wav_rand[rows]), (None, wav, wav_rand)):
            opt = train_lib.make_student_optimizer(cfg, params)
            state = train_lib.make_train_state(params, opt)
            state, metrics = train_lib.make_pwn_train_step(pwn, te, opt, mesh=m)(
                state, w, wr, None, draws=draws)
            res.append((state, {k: float(v) for k, v in metrics.items()}))
    (s_m, m_m), (s_1, m_1) = res
    metric_err = max(abs(m_m[k] - m_1[k]) / max(abs(m_1[k]), 1.0) for k in m_1)
    # the leaves one rank's step moved (the frozen teacher deconv did not)
    moved = tree_lib.unflatten(params, [a - b for a, b in zip(tree_lib.leaves(s_1["params"]),
                                                              tree_lib.leaves(params))])
    p_err = update_err(params, s_1["params"], s_m["params"], moved)
    e_err = update_err(params, s_1["ema"], s_m["ema"], moved)
    log(f"M2 rank {rank} DP distillation step (gauss pair, B=4): metrics max rel {metric_err:.2e} "
        f"(limit {MESH_METRIC_TOL:.0e}); params after Adam {p_err:.3e}, EMA {e_err:.3e} (L2 of "
        f"the update, limit {MESH_UPDATE_TOL:.0e})")
    require(metric_err <= MESH_METRIC_TOL, f"M2 rank {rank}: distillation metrics")
    require(p_err <= MESH_UPDATE_TOL and e_err <= MESH_UPDATE_TOL,
            f"M2 rank {rank}: distillation params / EMA")
    return {"metrics_rel": metric_err, "params": p_err, "ema": e_err}


def spawn_ranks(flag, label, n=2, timeout=MESH_RANK_TIMEOUT, script=None):
    """n ranks of ``script`` (default this one) run as <script> <flag> (a
    string or a list of arguments) on the card, joined by torch's env:// variables: the result each prints on
    its line 'MESH_RANK_RESULT <json>', in rank order; its lines that name
    ``label`` are logged.  Fails when a rank fails or outlives ``timeout``."""
    port = _free_port()
    procs = []
    with tempfile.TemporaryDirectory() as tmp:
        for r in range(n):
            env = dict(os.environ, MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port), RANK=str(r),
                       WORLD_SIZE=str(n), LOCAL_RANK=str(r))
            out = open(os.path.join(tmp, f"rank{r}.log"), "w+")
            args = [flag] if isinstance(flag, str) else list(flag)
            procs.append((subprocess.Popen([sys.executable, script or os.path.abspath(__file__),
                                            *args],
                                           cwd=REPO, env=env, stdout=out,
                                           stderr=subprocess.STDOUT), out))
        deadline = time.time() + timeout
        try:
            for p, _ in procs:
                p.wait(timeout=max(1.0, deadline - time.time()))
        except subprocess.TimeoutExpired:
            pass
        finally:
            for p, _ in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        results = []
        for r, (p, out) in enumerate(procs):
            out.seek(0)
            text = out.read()
            out.close()
            for line in text.splitlines():
                if "MESH_RANK_RESULT" not in line and f"{label} rank" in line:
                    log(line.split("] ", 1)[-1])
            found = [line for line in text.splitlines() if line.startswith("MESH_RANK_RESULT ")]
            if p.returncode != 0 or not found:
                log(f"{label} rank {r} rc={p.returncode}, its output's end:\n{text[-4000:]}")
            require(p.returncode == 0 and found, f"{label}: rank {r} failed (rc {p.returncode})")
            results.append(json.loads(found[-1].split(" ", 1)[1]))
    return results


def m2_gloo_two_ranks():
    """M2: two ranks of this script on the one card over gloo."""
    t0 = time.time()
    results = spawn_ranks("--mesh-rank", "M2")
    for res in results:
        r = res["rank"]
        log(f"M2 rank {r}: greedy bit-equal to one rank {res['greedy_equal']}, sampled rows "
            f"bit-equal to generate_cuda with the folded seed {res['sampled_rows_equal']}, "
            f"synthesize_sharded vs one rank on its rows {res['synth_bins']:.2f} bins; vs one "
            f"rank's B=8 call {res['synth_bins_whole_batch']:.2f} bins bf16 (limit "
            f"{MESH_SYNTH_BINS_BF16}), {res['synth32_bins_whole_batch']:.2f} bins f32 (limit "
            f"{MESH_SYNTH_BINS_F32}); launches in its sharded calls {res['launches']} "
            f"({res['generate_calls']} generate calls), flow_stack calls {res['flow_calls']} "
            f"(want {res['flow_cycles']})")
        require(res["greedy_equal"], f"M2 rank {r}: greedy sharded generation differs")
        require(res["sampled_rows_equal"] and res["sampled_shape"] == [16, 256],
                f"M2 rank {r}: sampled rows differ from the folded-seed run")
        require(res["synth_finite"] and res["synth_bins"] <= 1.0,
                f"M2 rank {r}: synthesize_sharded beyond one bin")
        require(res["synth_bins_whole_batch"] <= MESH_SYNTH_BINS_BF16
                and res["synth32_bins_whole_batch"] <= MESH_SYNTH_BINS_F32,
                f"M2 rank {r}: synthesize_sharded against one rank's B=8 call")
        require(res["launches"].get("fastgen_persistent") == 2 and res["generate_calls"] == 2,
                f"M2 rank {r}: fastgen_persistent launches {res['launches']}")
        require(res["flow_calls"] == res["flow_cycles"]
                and res["flow_launches"] == res["flow_want"],
                f"M2 rank {r}: flow kernel launches {res['flow_launches']}, want "
                f"{res['flow_want']}")
    log(f"M2 two ranks over gloo on one card: {time.time() - t0:.1f} s")
    return {"ranks": results, "seconds": time.time() - t0}


# ---- M3: sequence-parallel training ------------------------------------------------


def peak_gib(fn):
    """(fn(), the peak of this process's allocated device memory while it
    ran, GiB)."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    out = fn()
    torch.cuda.synchronize()
    return out, torch.cuda.max_memory_allocated() / 2**30


def train_state(params, opt):
    """train_lib.make_train_state, which holds f32 master weights, or for
    f64 params the same state in f64."""
    if tree_lib.leaves(params)[0].dtype != torch.float64:
        return train_lib.make_train_state(params, opt)
    return {"params": tree_lib.tree_map(torch.clone, params), "opt_state": opt.init(params),
            "ema": tree_lib.tree_map(torch.clone, params), "step": 0}


def f64(tree):
    return tree_lib.tree_map(lambda t: t.double(), tree)


def step_pair(label, rank, params, make_step, run, other="seq"):
    """One process's step and this rank's step over the mesh ``other``
    names ('seq', or 'data' for the data-parallel control), from the same
    state (cuDNN's deterministic algorithms): the metrics' and the
    gradient's distance (each leaf's max as a share of its own max), the
    params' and EMA's (L2 of the update), each one's peak memory and step
    time, and the halo exchanges of the mesh step.  The states are kept on
    the host, so that one step's state does not count in the other's peak.
    make_step(name) -> (optimizer, fn(optimizer) -> step_fn); run(step_fn,
    state, name) -> (state, metrics)."""
    out = {}
    host = lambda tree: tree_lib.tree_map(lambda t: t.detach().cpu(), tree)  # noqa: E731
    with deterministic_cudnn():
        for name in ("one", other):
            opt, make = make_step(name)
            tap = GradTap(opt)
            state = train_state(params, tap)
            step_fn = make(tap)
            mesh_lib.reset_halo_counts()
            t0 = time.time()
            (state, metrics), peak = peak_gib(lambda: run(step_fn, state, name))
            out[name] = {"state": {"params": host(state["params"]), "ema": host(state["ema"])},
                         "grads": host(tap.grads), "peak": peak,
                         "seconds": time.time() - t0, "halos": dict(mesh_lib.halo_exchanges),
                         "metrics": {k: float(v) for k, v in metrics.items()
                                     if not isinstance(v, dict)}}
            del state, step_fn, tap, opt, metrics
            torch.cuda.empty_cache()
    one, got = out["one"], out[other]
    metric_err = max(abs(got["metrics"][k] - one["metrics"][k]) / max(abs(one["metrics"][k]), 1.0)
                     for k in one["metrics"])
    grad_err = leaf_err(one["grads"], got["grads"])
    p_err = update_err(params, one["state"]["params"], got["state"]["params"], one["grads"])
    e_err = update_err(params, one["state"]["ema"], got["state"]["ema"], one["grads"])
    log(f"M3 rank {rank} {label}: loss {got['metrics']['loss']:.6f} / one process "
        f"{one['metrics']['loss']:.6f}, metrics max rel {metric_err:.2e}; gradient leaves max "
        f"{grad_err:.3e} of scale; params after Adam {p_err:.3e}, EMA {e_err:.3e} (L2 of the "
        f"update); peak memory {got['peak']:.3f} GiB against one process's {one['peak']:.3f} GiB "
        f"({100 * got['peak'] / one['peak']:.1f} %); step {got['seconds']:.3f} s against "
        f"{one['seconds']:.3f} s (gloo through host memory: a reading); halo exchanges "
        f"{got['halos']}")
    require(one["halos"] == {"forward": 0, "backward": 0}, f"M3 {label}: one process exchanged")
    return {"metrics_rel": metric_err, "grad": grad_err, "params": p_err, "ema": e_err,
            "peak_gib": got["peak"], "one_peak_gib": one["peak"], "seconds": got["seconds"],
            "one_seconds": one["seconds"], "halos": got["halos"]}


def seq_teacher_steps(rank, meshes, dtype, data_control=False):
    """M3's teacher steps: configs/wavenet_mol.json (dropout_inputs) in
    ``dtype`` (bfloat16, or float64: the f32 config on f64 params and
    audio) at global B = 4 x 7680, over the seq mesh (and, with
    data_control, over the data mesh) against one process."""
    wide = dtype == "float64"
    model = Wavenet(config_lib.load_config(os.path.join(REPO, "configs/wavenet_mol.json"),
                                           compute_dtype="float32" if wide else dtype))
    params = model.init_params(0, device="cuda")
    wav = torch.from_numpy(synthetic_wavs(4, model.cfg.wave_length, 90)).cuda()
    if wide:
        params, wav = f64(params), wav.double()

    def make_step(name):
        opt = opt_lib.make_optimizer(model.cfg.lr_schedule, grad_clip=model.cfg.grad_clip)
        return opt, lambda tap: train_lib.make_wavenet_train_step(model, tap,
                                                                  mesh=meshes.get(name))

    def run(step_fn, state, name):
        w = wav[mesh_lib.rows(meshes["data"], 4)] if name == "data" else wav
        return step_fn(state, w, 2)

    label = (f"teacher step (mol, full width, {dtype}, dropout_inputs, B=4 x "
             f"{model.cfg.wave_length}")
    out = step_pair(f"{label}, n_seq 2)", rank, params, make_step, run)
    out["want_halos"] = train_lib.wavenet_halo_exchanges(model.cfg)
    if data_control:
        out["data_control"] = step_pair(f"{label}, n_data 2: the control)", rank, params,
                                        make_step, run, other="data")
    return out


def seq_student_step(rank, meshes, dtype):
    """M3's distillation step: configs/parallel_wavenet.json in ``dtype``
    under the full MoL teacher (frozen, the same dtype) at global B = 2,
    over the seq mesh against one process, on the same draws."""
    wide = dtype == "float64"
    compute = "float32" if wide else dtype
    teacher = Wavenet(config_lib.load_config(os.path.join(REPO, "configs/wavenet_mol.json"),
                                             compute_dtype=compute, use_as_teacher=True))
    te = teacher.init_params(1, device="cuda")
    cfg = config_lib.load_config(os.path.join(REPO, "configs/parallel_wavenet.json"),
                                 compute_dtype=compute)
    pwn, params = distill_student(cfg, teacher, te, 2)
    wav = torch.from_numpy(synthetic_wavs(2, cfg.wave_length, 91)).cuda()
    wav_rand = torch.from_numpy(synthetic_wavs(2, cfg.wave_length, 92)).cuda()
    L = pwn.sample_length(stft.num_mel_frames(cfg.wave_length))
    draws = train_lib.student_draws(pwn, torch.Generator().manual_seed(93), 2, L, "cpu")
    draws = {k: v.cuda() for k, v in draws.items()}
    if wide:
        te, params, wav, wav_rand = f64(te), f64(params), wav.double(), wav_rand.double()
        draws = f64(draws)

    def make_step(name):
        opt = train_lib.make_student_optimizer(cfg, params)
        return opt, lambda tap: train_lib.make_pwn_train_step(pwn, te, tap,
                                                              mesh=meshes.get(name))

    out = step_pair(f"distillation step (parallel_wavenet.json under the MoL teacher, {dtype}, "
                    f"B=2 x {cfg.wave_length}, n_seq 2)", rank, params, make_step,
                    lambda step_fn, state, name: step_fn(state, wav, wav_rand, None,
                                                         draws=draws))
    out["want_halos"] = train_lib.pwn_halo_exchanges(pwn)
    return out


def seq_rank_main():
    """One rank of M3 (chip_smoke.py --seq-rank): prints its result as a
    line 'MESH_RANK_RESULT <json>'."""
    mesh_lib.init_distributed("cuda:0", backend="gloo")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rank, n = mesh_lib.process_index(), mesh_lib.process_count()
    meshes = {"seq": mesh_lib.make_mesh(n_data=1, n_seq=n), "data": mesh_lib.make_mesh(n_data=n)}
    res = {"rank": rank}
    for dtype in M3_DTYPES:
        res[f"teacher_{dtype}"] = seq_teacher_steps(rank, meshes, dtype,
                                                    data_control=dtype == "bfloat16")
        torch.cuda.empty_cache()
        res[f"student_{dtype}"] = seq_student_step(rank, meshes, dtype)
        torch.cuda.empty_cache()
    print("MESH_RANK_RESULT " + json.dumps(res), flush=True)
    mesh_lib.shutdown()
    return 0


def m3_seq_two_ranks():
    """M3: sequence-parallel teacher and distillation steps in two ranks of
    this script on the card over gloo, each against one process's step."""
    t0 = time.time()
    results = spawn_ranks("--seq-rank", "M3")
    for res in results:
        r = res["rank"]
        for part in ("teacher", "student"):
            for dtype in M3_DTYPES:
                got = res[f"{part}_{dtype}"]
                require(got["metrics_rel"] <= MESH_METRIC_TOL,
                        f"M3 rank {r}: {part} {dtype} metrics")
                require(got["halos"] == got["want_halos"],
                        f"M3 rank {r}: {part} {dtype} halo exchanges {got['halos']}, want "
                        f"{got['want_halos']}")
            got = res[f"{part}_float64"]
            require(got["params"] <= MESH_UPDATE_TOL and got["ema"] <= MESH_UPDATE_TOL,
                    f"M3 rank {r}: {part} float64 params / EMA")
    log(f"M3 sequence-parallel training, two ranks over gloo on one card: "
        f"{time.time() - t0:.1f} s")
    return {"ranks": results, "seconds": time.time() - t0}


# ---- Q1-Q4: the quality and ops tools ---------------------------------------------

# The tools' own sizes, their training cut to Q_STEPS steps (a loss line
# every Q_LOG_EVERY) and the teacher's held-out clips to Q_HELD_OUT samples,
# so that Q1-Q4 fit in about two minutes.  At this step count the quality
# gates are readings, not requirements.
Q_STEPS = 300
Q_LOG_EVERY = 10
Q_HELD_OUT = 4000
Q_GOLDEN_SAMPLES = 2000
Q_LONGFORM_SECONDS = 3
Q_LONGFORM_CHUNK = 4000


def want_ar_launches(mode, calls=1):
    """fastgen_persistent a call, after one quant_enc_kernel in the int8 modes."""
    return {"fastgen_persistent": calls, **({"quant_enc_kernel": calls} if mode != "bf16" else {})}


def q1_quality_smoke(card, tmp):
    """Q1: quality_smoke.teacher_smoke on the card: the speech corpus, the CE
    head, compare_cuda."""
    from nsynth_wavenet_tpu_torch.tools import quality_smoke as qs

    t0 = time.time()
    reset_ar_counts()
    with mock.patch.multiple(runner, LOG_EVERY=Q_LOG_EVERY), \
            mock.patch.multiple(qs, HELD_OUT_SAMPLES=Q_HELD_OUT):
        res = qs.teacher_smoke(Q_STEPS, os.path.join(tmp, "q1"), corpus="speech", head="ce",
                               compare_cuda=True, device="cuda")
    torch.cuda.synchronize()
    calls, counted = ar_counts()
    dt = time.time() - t0
    losses = res["losses"]
    w = len(losses) // 4
    first, last = float(np.mean(losses[:w])), float(np.mean(losses[-w:]))
    log(f"Q1 quality_smoke speech CE, {Q_STEPS} steps (a loss line every {Q_LOG_EVERY}), held-out "
        f"clips {Q_HELD_OUT} samples, compare_cuda: {dt:.1f} s; {len(losses)} losses, mean of the "
        f"first {w} {first:.4f}, of the last {w} {last:.4f}")
    require(len(losses) == Q_STEPS // Q_LOG_EVERY and all(np.isfinite(losses)),
            "Q1: a training loss is not finite")
    require(last < first, "Q1: the windowed training loss does not fall")
    require(np.isfinite(res["audio"]).all() and np.abs(res["audio"]).max() <= 1.0,
            "Q1: the plain free run is not finite")
    log(f"Q1 readings: final loss {res['final_loss']:.4f}, held-out TF loss {res['tf_loss']:.4f}, "
        f"shuffled {res['tf_mis']:.4f}, cond gap {res['cond_gap']:.4f}; plain free run corr "
        f"{res['metrics']['corr']}, MCD {res['metrics']['mcd']}; gates {res['gates']}; "
        f"passed {res['passed']}; {card}")
    n = Q_HELD_OUT
    modes = {}
    for label, mode in (("cuda-bf16", "bf16"), ("cuda-int8", "w8a8_row"),
                        ("cuda-int8s", "w8a8_static")):
        r = res["cuda"][label]
        require(r["launches"] == want_ar_launches(mode),
                f"Q1 {label}: CUDA launches {r['launches']}, want {want_ar_launches(mode)}")
        require(np.isfinite(r["audio"]).all() and np.abs(r["audio"]).max() <= 1.0,
                f"Q1 {label}: audio not finite in [-1, 1]")
        mt = quality.mel_track_metrics(r["audio"], res["mel"], n)
        require(mt == r["metrics"], f"Q1 {label}: the tool's metrics differ from utils/quality's")
        log(f"Q1 {label}: launches {r['launches']}; corr {mt['corr']}, msd {mt['msd']}, MCD "
            f"{mt['mcd']}; gate {r['ok']}")
        modes[label] = {"launches": r["launches"], "corr": mt["corr"], "mcd": mt["mcd"],
                        "gate": r["ok"]}
    require(calls == 3 and counted == {"fastgen_persistent": 3, "quant_enc_kernel": 2},
            f"Q1: generate calls {calls}, CUDA launches {counted}")
    return {"run_dir": res["run_dir"], "seconds": dt, "steps": Q_STEPS, "calls": calls,
            "kernel_launches": counted, "loss_first": first, "loss_last": last,
            "tf_loss": res["tf_loss"], "cond_gap": res["cond_gap"],
            "plain_corr": res["metrics"]["corr"], "gates": res["gates"], "modes": modes}


def q2_student_smoke(card, tmp):
    """Q2: quality_smoke.student_smoke on the card: the Gauss pair, speech."""
    from nsynth_wavenet_tpu_torch.tools import quality_smoke as qs

    t0 = time.time()
    with mock.patch.multiple(runner, LOG_EVERY=Q_LOG_EVERY), \
            mock.patch.multiple(qs, HELD_OUT_SAMPLES=Q_HELD_OUT):
        res = qs.student_smoke(Q_STEPS, os.path.join(tmp, "q2"), "speech", "gauss",
                               device="cuda")
    dt = time.time() - t0
    head, tail = res["log_head"], res["log_tail"]
    log(f"Q2 quality_smoke student, Gauss pair, speech, {Q_STEPS} steps each: {dt:.1f} s; windows "
        f"(loss, kl, power) {head[:3]} -> {tail[:3]}; one-shot std {res['std']:.4f}, corr "
        f"{res['metrics']['corr']}, MCD {res['metrics']['mcd']}; gates {res['gates']}; passed "
        f"{res['passed']}; {card}")
    require(all(np.isfinite(head[:3])) and all(np.isfinite(tail[:3])),
            "Q2: a windowed student loss is not finite")
    require(np.isfinite(res["audio"]).all() and res["std"] > 0, "Q2: one-shot audio")
    return {"run_dir": res["run_dir"], "seconds": dt, "log_head": head[:3], "log_tail": tail[:3],
            "std": res["std"], "corr": res["metrics"]["corr"], "gates": res["gates"]}


def q3_longform(card, tmp, teacher_dir, student_dir):
    """Q3: longform_check on Q1's teacher (bf16, W8A8 static) and Q2's
    student, streamed in chunks."""
    from nsynth_wavenet_tpu_torch.tools import longform_check as lf

    out = {}
    for mode in ("bf16", "int8_static"):
        t0 = time.time()
        reset_ar_counts()
        res = lf.longform(teacher_dir, Q_LONGFORM_SECONDS, Q_LONGFORM_CHUNK, mode,
                          os.path.join(tmp, "q3"), device="cuda")
        torch.cuda.synchronize()
        calls, counted = ar_counts()
        chunks = -(-res["samples"] // Q_LONGFORM_CHUNK)
        want = want_ar_launches("bf16" if mode == "bf16" else "w8a8_static", chunks)
        log(f"Q3 longform_check teacher {mode}, {Q_LONGFORM_SECONDS} s x {lf.N_UTTS}, chunk "
            f"{Q_LONGFORM_CHUNK}: {time.time() - t0:.1f} s; per-window corr "
            f"{res['per_window_corr']}, MCD {res['per_window_mcd']}; passed {res['passed']}")
        require(calls == chunks and counted == want,
                f"Q3 {mode}: generate calls {calls}, CUDA launches {counted}, want {chunks} / {want}")
        require(np.isfinite(res["audio"]).all(), f"Q3 {mode}: audio not finite")
        out[mode] = {"calls": calls, "kernel_launches": counted, "passed": res["passed"],
                     "per_window_corr": res["per_window_corr"]}
    t0 = time.time()
    cfg = config_lib.load_config(runner.find_config_json(student_dir))
    res, counted = kernel_launches_of(lambda: lf.longform(
        student_dir, Q_LONGFORM_SECONDS, Q_LONGFORM_CHUNK, "bf16", os.path.join(tmp, "q3"),
        device="cuda"))
    chunks = -(-res["samples"] // res["chunk"])
    per_chunk = {}
    for n_layers in cfg.num_iaf_layers:
        for s in range(0, n_layers, cfg.num_stages):
            for k, v in flk.predicted_launches(
                    cfg.width, min(cfg.num_stages, n_layers - s), True).items():
                per_chunk[k] = per_chunk.get(k, 0) + v
    want = {k: v * chunks for k, v in per_chunk.items()}
    log(f"Q3 longform_check student, chunk {res['chunk']} ({chunks} chunks): "
        f"{time.time() - t0:.1f} s; CUDA launches {counted}; per-window corr "
        f"{res['per_window_corr']}, MCD {res['per_window_mcd']}; passed {res['passed']}; {card}")
    require_launches("Q3 student", counted, want)
    require(np.isfinite(res["audio"]).all(), "Q3 student: audio not finite")
    out["student"] = {"chunks": chunks, "kernel_launches": counted, "passed": res["passed"],
                      "per_window_corr": res["per_window_corr"]}
    return out


def q4_tools(card, tmp, trained):
    """Q4: make_golden_ckpt, make_golden_wavs, make_eval_model, gather_results
    and downsample, all writing under tmp."""
    from scipy.signal import resample_poly

    from nsynth_wavenet_tpu_torch.tools import downsample, gather_results, make_eval_model
    from nsynth_wavenet_tpu_torch.tools import make_golden_ckpt as mg
    from nsynth_wavenet_tpu_torch.tools import make_golden_wavs as mw

    out = {}
    t0 = time.time()
    with mock.patch.multiple(mg, GEN_SAMPLES=Q_GOLDEN_SAMPLES):
        rc = mg.main("ce", steps=Q_STEPS, batch=8, workdir=os.path.join(tmp, "q4_golden"),
                     out_dir=os.path.join(tmp, "q4_golden", "out"), device="cuda")
    gdir = os.path.join(tmp, "q4_golden", "out", "tiny_ce")
    with open(os.path.join(gdir, "meta.json")) as f:
        meta = json.load(f)
    model = Wavenet(config_lib.load_config(os.path.join(gdir, "meta.json")))
    params = weights.load_npz(os.path.join(gdir, "params.npz"), device="cuda")
    mels, _ = quality.eval_mels(meta["eval_seeds"][:2])
    mels = mels[:, : 1 + GATE_SAMPLES // model.cfg.frame_shift]
    reset_ar_counts()
    audio = Fastgen(model).generate_cuda(params, torch.from_numpy(mels).cuda(), seed=7).cpu().numpy()
    calls, counted = ar_counts()
    require_ar_launches("Q4 golden gate", calls, counted, 1, want_ar_launches("bf16"))
    mt = quality.mel_track_metrics(audio, mels, GATE_SAMPLES)
    ok, reading = quality.golden_gate(mt, meta["matched_corr"], quality.TEACHER_MARGIN)
    log(f"Q4 make_golden_ckpt CE, {Q_STEPS} steps (f32), free run {Q_GOLDEN_SAMPLES} samples: "
        f"rc {rc}, matched {meta['matched_corr']}, mismatched {meta['mismatched_corr']}, "
        f"{time.time() - t0:.1f} s; golden gate through fastgen_persistent (a reading): {ok}, "
        f"{reading}; {card}")
    require(meta["train_steps"] == Q_STEPS and np.isfinite(audio).all(), "Q4: golden")
    out["golden"] = {"rc": rc, "matched_corr": meta["matched_corr"], "gate": ok,
                     "kernel_launches": counted}

    t0 = time.time()
    reset_ar_counts()
    paths = mw.main(os.path.join(tmp, "q4_wavs"), cuda=True, device="cuda")
    calls, counted = ar_counts()
    heads = mw.available_heads()
    require_ar_launches("Q4 make_golden_wavs", calls, counted, len(heads),
                        want_ar_launches("bf16", len(heads)))
    for head in heads:
        wavs = [wav_io.read_wav(p)[0] for p in paths if f"gen_golden_{head}_" in p]
        require(len(wavs) == 4 and all(np.isfinite(w).all() and w.std() > 1e-3 for w in wavs),
                f"Q4 make_golden_wavs {head}: want four finite, non-silent wavs")
    log(f"Q4 make_golden_wavs --cuda: {len(paths)} wavs for {heads} in {time.time() - t0:.1f} s")
    out["golden_wavs"] = {"wavs": len(paths), "kernel_launches": counted}

    t0 = time.time()
    root = os.path.join(tmp, "q4_root")
    os.makedirs(root)
    for name in ("T2", "S2"):
        run = trained[name]["run_dir"]
        os.symlink(run, os.path.join(root, os.path.basename(run)))
        exp = make_eval_model.save_eval_model(run, os.path.join(tmp, f"q4_ema_{name}"))
        _, want = load_eval_model(run, device="cuda")
        got = ckpt_lib.load_params(exp, device="cuda")
        require(all(torch.equal(a, b) for a, b in zip(tree_lib.leaves(got), tree_lib.leaves(want))),
                f"Q4 make_eval_model {name}: the export differs from the run's EMA")
    src = os.path.join(tmp, "q4_src")
    os.makedirs(src)
    for i, w in enumerate(synthetic_wavs(2, 4000, 61)):
        wav_io.write_wav(os.path.join(src, f"utt_{i}.wav"), w)
    reset_ar_counts()
    reset_flow_counts()
    gathered = gather_results.gather(root, src, os.path.join(tmp, "q4_results"), device="cuda")
    torch.cuda.synchronize()
    ar_calls, ar_counted = ar_counts()
    flow_calls = flk.flow_stack.launches
    flow_counted = {k: n for k, n in flk.flow_stack.kernel_launches.items() if n}
    s_cfg = config_lib.load_config(runner.find_config_json(trained["S2"]["run_dir"]))
    want_flow = sum(-(-n // s_cfg.num_stages) for n in s_cfg.num_iaf_layers)
    log(f"Q4 make_eval_model on T2's and S2's runs; gather_results over both: "
        f"{ {k: len(v) for k, v in gathered.items()} } wavs, generate calls {ar_calls}, "
        f"{ar_counted}; flow_stack calls {flow_calls} (want {want_flow}), {flow_counted}; "
        f"{time.time() - t0:.1f} s")
    require(len(gathered) == 2 and all(len(v) == 2 for v in gathered.values()),
            "Q4 gather_results: want two wavs for each of two runs")
    for v in gathered.values():
        for p in v:
            w = wav_io.read_wav(p)[0]
            require(np.isfinite(w).all() and w.std() > 1e-3, f"Q4 gather_results: {p}")
    require(ar_calls == 1 and ar_counted == {"fastgen_persistent": 1},
            "Q4 gather_results: the teacher run was not served through one fastgen_persistent launch")
    require(flow_calls == want_flow
            and flow_counted == {"flow_persist_kernel": sum(s_cfg.num_iaf_layers)},
            "Q4 gather_results: the student run was not served through flow_persist_kernel")
    out["gather"] = {"ar_kernel_launches": ar_counted, "flow_calls": flow_calls,
                     "flow_kernel_launches": flow_counted}

    sr = 44100
    t = np.arange(sr) / sr
    wav = (0.5 * np.sin(2 * np.pi * 440 * t) + 0.3 * np.sin(2 * np.pi * 5000 * t)).astype(np.float32)
    src44, dst, ref = (os.path.join(tmp, f"q4_{n}.wav") for n in ("44k", "16k", "ref"))
    wav_io.write_wav(src44, wav, sr)
    downsample.downsample_file(src44, dst, 16000)
    x, _ = wav_io.read_wav(src44)
    wav_io.write_wav(ref, np.clip(resample_poly(x, 160, 441).astype(np.float32), -1.0, 1.0), 16000)
    with open(dst, "rb") as a, open(ref, "rb") as b:
        same = a.read() == b.read()
    log(f"Q4 downsample 44.1 -> 16 kHz equal to resample_poly: {same}")
    require(same, "Q4 downsample differs from resample_poly")
    out["downsample_equal"] = same
    return out


def quality_phases(card, trained):
    """Q1 to Q4, after M3; T2's and S2's runs serve Q4."""
    t0 = time.time()
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        out["Q1"] = q1_quality_smoke(card, tmp)
        torch.cuda.empty_cache()
        out["Q2"] = q2_student_smoke(card, tmp)
        out["Q3"] = q3_longform(card, tmp, out["Q1"]["run_dir"], out["Q2"]["run_dir"])
        out["Q4"] = q4_tools(card, tmp, trained)
    out["seconds"] = time.time() - t0
    log(f"phases Q1-Q4: {out['seconds']:.1f} s")
    return out


def main():
    if len(sys.argv) > 1 and sys.argv[1] == "--mesh-rank":
        return mesh_rank_main()
    if len(sys.argv) > 1 and sys.argv[1] == "--seq-rank":
        return seq_rank_main()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    # ---- 1. device and build ----
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    kind = torch.cuda.get_device_name(0)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} device {kind}")
    t0 = time.time()
    for name, (path, report) in build.build_all().items():
        log(f"built {name} -> {os.path.relpath(path, REPO)}")
        for line in report.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  {line.strip()}")
    log(f"kernel build {time.time() - t0:.1f} s")

    # ---- 2. full-width MoL kernel vs plain ----
    model, params, kw = full_model("configs/wavenet_mol.json")
    cfg = model.cfg
    enc_t = conditioning(model, params, B=8, L=256, seed=1)
    full_err, full_floor = check_kernel("mol full width", cfg, kw, enc_t, seed=5,
                                        rel_tol=FULL_WIDTH_REL_TOL, cpu_floor=True)

    # ---- 3. the other heads, and trained golden weights ----
    for path in ("configs/wavenet_ce.json", "configs/wavenet_gauss.json"):
        m3, p3, kw3 = full_model(path, num_layers=4)
        check_kernel(f"{m3.cfg.loss_type} 4 layers", m3.cfg, kw3,
                     conditioning(m3, p3, B=8, L=256, seed=2), seed=6, rel_tol=REL_TOL)
    gmodel, gparams, gdir = golden_model()
    check_kernel("golden tiny_mol", gmodel.cfg, fk.build_kernel_weights(gmodel.cfg, gparams),
                 conditioning(gmodel, gparams, B=8, L=256, seed=3), seed=7, rel_tol=REL_TOL)

    # ---- 4. Philox uniforms from the kernel's generator ----
    u = fk.philox_uniform(7, 11, 256, 1024, 0, device="cuda")
    require(bool(torch.equal(u, fk.philox_uniform_plain(7, 11, 256, 1024, 0, device="cuda"))),
            "kernel Philox differs from the plain version")
    un = u.cpu().numpy()
    log(f"philox [256,1024]: min {un.min():.3e} max {un.max():.6f} mean {un.mean():.5f} "
        f"var {un.var():.5f} floor share {(un <= 1e-5).mean():.2e}")
    require(un.min() >= 1e-5 and un.max() <= 1 - 1e-5 and (un <= 1e-5).mean() < 1e-2
            and un.max() > 0.99 and abs(un.mean() - 0.5) < 0.02 and abs(un.var() - 1 / 12) < 2e-3,
            "Philox uniform statistics")

    calls = 100  # per timed run, so that the events do not time one launch's latency
    philox_us = 1e3 / calls * cuda_ms(lambda: [fk.philox_uniform(7, 11, 256, 1024, 0, device="cuda")
                                               for _ in range(calls)])
    rand_us = 1e3 / calls * cuda_ms(lambda: [torch.rand((256, 1024), device="cuda")
                                             for _ in range(calls)])
    log(f"philox [256,1024]: {philox_us:.2f} us per call (wrapper, allocation and launch "
        f"included), torch.rand {rand_us:.2f} us, bound {1e6 * 256 * 1024 * 4 / PEAK_HBM_BYTES:.3f} us "
        f"(1 MiB written)")

    # ---- 5. main path end to end ----
    fg = Fastgen(model)
    mels = {}
    for B in MAIN_BATCHES:
        mels[B] = stft.melspectrogram(torch.from_numpy(synthetic_wavs(B, MAIN_LENGTH, B)).cuda())
    fg.generate_cuda(params, mels[MAIN_BATCHES[0]], seed=0, length=16, kw=kw)  # warm-up
    torch.cuda.synchronize()
    fk.generate.launches = 0
    fk.generate.launches_by_mode = {"bf16": 0, "w8a8": 0}
    main_runs = {}
    for B in MAIN_BATCHES:
        t0 = time.time()
        audio = fg.generate_cuda(params, mels[B], seed=B, length=MAIN_LENGTH, kw=kw)
        torch.cuda.synchronize()
        dt = time.time() - t0
        main_runs[B] = (audio, dt)
    launches = fk.generate.launches
    for B, (audio, dt) in main_runs.items():
        require(tuple(audio.shape) == (B, MAIN_LENGTH), f"main path shape {tuple(audio.shape)}")
        require(bool(torch.isfinite(audio).all()) and float(audio.abs().max()) <= 1.0,
                f"main path B={B}: audio not finite in [-1, 1]")
        log(f"main path B={B} L={MAIN_LENGTH}: {dt:.3f} s, {1e6 * dt / MAIN_LENGTH:.1f} us/step, "
            f"{B * MAIN_LENGTH / 16000 / dt:.2f} audio-sec/s, audio std {float(audio.std()):.4f}")
    log(f"main path kernel launches: generate {launches}, by mode {fk.generate.launches_by_mode} "
        f"(one persistent launch a call)")
    require(launches > 0 and fk.generate.launches_by_mode == {"bf16": launches, "w8a8": 0},
            "the main path did not launch the bf16 CUDA kernels")

    # the kernel against its plain version at the main path's batches: every
    # batch tile and head block of the full-width kernel meets the plain version
    for B in MAIN_BATCHES:
        err, _ = check_kernel("mol full width", cfg, kw,
                              conditioning(model, params, B=B, L=CHECK_STEPS, seed=20 + B),
                              seed=8, rel_tol=FULL_WIDTH_REL_TOL)
        full_err = max(full_err, err)

    timings, launch = {}, {}
    for B in MAIN_BATCHES:
        enc = conditioning(model, params, B=B, L=TIMED_STEPS, seed=10 + B)
        timings[B] = time_kernel(cfg, kw, enc, seed=1)
        launch[B] = log_timing("bf16", cfg, kw, enc, timings[B])

    # ---- 6. eval CLI path on golden weights ----
    with tempfile.TemporaryDirectory() as tmp:
        src, out = os.path.join(tmp, "src"), os.path.join(tmp, "gen")
        os.makedirs(src)
        for i in (0, 1):
            wav, _ = wav_io.read_wav(os.path.join(GOLDEN, f"gen_golden_mol_{i}.wav"))
            wav_io.write_wav(os.path.join(src, f"utt_{i}.wav"), wav)
        paths = generate_wavenet(src, os.path.join(gdir, "params.npz"),
                                 os.path.join(gdir, "meta.json"), out, batch_size=8, seed=0,
                                 device="cuda", sample_length=4000)
        require(len(paths) == 2, f"eval wrote {len(paths)} files")
        for p in paths:
            wav, sr = wav_io.read_wav(p)
            require(sr == 16000 and len(wav) >= 4000 and np.isfinite(wav).all(), f"eval output {p}")
        log(f"eval path wrote {[os.path.basename(p) for p in paths]}")

    # ---- 7. golden free run tracks its conditioning ----
    n = 8000
    wavs = [wav_io.read_wav(os.path.join(GOLDEN, f"gen_golden_mol_{i}.wav"))[0][:n] for i in (0, 1)]
    gmels = stft.melspectrogram_np(np.stack(wavs))
    audio = Fastgen(gmodel).generate_cuda(gparams, torch.from_numpy(gmels).cuda(), seed=7,
                                          length=n).cpu().numpy()
    require(np.isfinite(audio).all() and np.abs(audio).max() <= 1.0, "golden free-run audio")
    matched, mismatched = mel_corr(audio, gmels, n)
    log(f"golden free run mel corr: matched {matched:.4f} mismatched {mismatched:.4f}")
    require(matched > mismatched + 0.05, "golden free run does not track its conditioning")

    # ---- 32. the f32 teacher's eval path under PyTorch's default TF32 settings ----
    tf32_phase(gdir)

    del main_runs
    kw_static, amax, w8a8_record = w8a8_phases(model, params, kw, gmodel, gparams, gdir, mels)
    row_record = row_phases(model, params, kw, kw_static, amax, gmodel, gparams, gdir, mels)
    del kw_static, amax

    del model, params, kw, fg, mels, gmodel, gparams
    torch.cuda.empty_cache()
    flow_rec = student_phases()
    mode_records = flow_mode_phases()
    torch.cuda.empty_cache()
    train_tmp = tempfile.TemporaryDirectory()  # T2's and S2's runs, read again by Q4
    trained = training_phases(smi, train_tmp.name)
    flow_rec["launches_distill_serve"] = trained["S4"]["kernel_launches"]["flow_persist_kernel"]
    torch.cuda.empty_cache()
    leftover = serving_leftover_phases(smi, trained)
    flow_rec["launches_resize"] = leftover["34"]["kernel_launches"]
    flow_rec["launches_from_wav"] = leftover["36"]["student_launches"]
    flow_rec["launches_gate"] = leftover["37"]["student"]["kernel_launches"]["flow_persist_kernel"]
    torch.cuda.empty_cache()
    m1 = m1_nccl_world_one()
    m2 = m2_gloo_two_ranks()
    m3 = m3_seq_two_ranks()
    flow_rec["launches_sharded_gloo_per_rank"] = [
        r["launches"]["flow_persist_kernel"] for r in m2["ranks"]]
    torch.cuda.empty_cache()
    tools = quality_phases(smi, trained)
    train_tmp.cleanup()
    flow_rec["launches_longform_student"] = tools["Q3"]["student"]["kernel_launches"]
    flow_rec["launches_gather_results"] = tools["Q4"]["gather"]["flow_kernel_launches"]

    big = timings[MAIN_BATCHES[-1]]
    record = {"kernels": [{
        "name": "fastgen_generate",
        "route": "cuda",
        "source": "nsynth_wavenet_tpu_torch/csrc/fastgen_kernel.cu",
        "replaces": "nsynth_wavenet_tpu/ops/fastgen_kernel.py:291",
        "launches": launches,
        "max_abs_err": full_err,
        "rel_tol": FULL_WIDTH_REL_TOL,
        "plain_cpu_vs_card_err": full_floor,
        "ms": big["ms"],
        "plain_ms": big["plain_ms"],
        "bound_ms": big["bound_ms"],
        "bound_by": big["bound_by"],
        "library_ms": big["library_ms"],
        "grid": launch[MAIN_BATCHES[-1]]["grid"],
        "barriers_per_step": launch[MAIN_BATCHES[-1]]["barriers_per_step"],
        "barrier_us": launch[MAIN_BATCHES[-1]]["barrier_us"],
        "launches_resize": leftover["33"]["launches"],
        "launches_from_wav": leftover["36"]["teacher_launches"],
        "gate_generate_calls": leftover["37"]["teacher_generate_calls"],
        "launches_gate": leftover["37"]["teacher_kernel_launches"],
        "resize_upsampler": {k: leftover["33"][k] for k in ("resize_ms", "transposed_ms",
                                                             "bound_ms", "tflop")},
        "gate": leftover["37"],
        "launches_sharded_nccl": m1["launches"],
        "launches_sharded_gloo_per_rank": [r["launches"]["fastgen_persistent"]
                                           for r in m2["ranks"]],
        "mesh_seconds": {"M1": m1["seconds"], "M2": m2["seconds"], "M3": m3["seconds"]},
        "launches_quality_smoke": tools["Q1"]["kernel_launches"],
        "launches_longform": {m: tools["Q3"][m]["kernel_launches"] for m in ("bf16", "int8_static")},
        "launches_golden_tools": {"make_golden_ckpt_gate": tools["Q4"]["golden"]["kernel_launches"],
                                  "make_golden_wavs": tools["Q4"]["golden_wavs"]["kernel_launches"],
                                  "gather_results": tools["Q4"]["gather"]["ar_kernel_launches"]},
        "quality_seconds": tools["seconds"],
    }, flow_rec, w8a8_record, row_record, *mode_records]}
    log(f"timed call: B={MAIN_BATCHES[-1]}, {TIMED_STEPS} steps, full width; "
        f"total {time.time() - T_START:.1f} s")
    print(smi, flush=True)
    print(json.dumps(record), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                              "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
