#!/usr/bin/env python3
"""Smoke test of the desenet_tpu_torch port on one CUDA card.

    python3 chip_smoke.py

Phases, one output line each (any failure raises, so the exit code is
non-zero; without a CUDA device it exits non-zero before printing a result):

0. environment: torch/CUDA versions, the card, its power limit;
1. build: nvcc builds the kernels from desenet_tpu_torch/csrc, one process
   per source, all at once (ptxas lines; the tensor-core kernels of K4, K5
   and K6 and the served stem must not spill, and their SASS must hold HMMA
   (the served stem's: HGMMA, wgmma) instructions where
   cuobjdump is at hand), and beside them the host compiler builds the
   native host library from csrc/host (desenet_tpu_torch/native.py), with
   libjpeg where jpeglib.h is found;
2. each kernel against its plain PyTorch version on the card: the shared
   tensor-core tile alone (one bf16 1x1 stage, K 512, N 256) against
   torch.matmul in f32, K1 on testing.NMS_FUSED_CASES (a sparse decode, one
   above the candidate cap, all dead, fewer live than max_det, more kept
   than max_det, many tied scores, exact duplicate boxes, counts on and one
   over each cap, a dense decode, the TTA and ensemble decodes at max_det
   1000 with a class filter and agnostic) with the path each image took
   checked, K2
   on testing.SEG_TAIL_CASES (the span kernel and the pixel kernel each
   equal to plain, the one the wrapper picked checked: W no multiple of 16,
   other scales, align_corners off, B = 1, C = 19 and 256), K3 on unsorted sets (its argmax loop) and sorted ones (its ordered
   walk: ties, duplicates, all dead, fewer live than max_det, L on and off
   the round boundaries, dense) at both memory sizes with the path each
   image took checked, K4 in f32 and bf16, K5 at (4, 640, 640, 3) with CO
   32, 48 and 64 and on a map its tile does not divide, with and without
   SiLU, K6 at yolov5s_seg's eight C3 shapes at batch 2, K5 and K6 both in
   f32 (TF32 off, the CUDA-core kernels) and bf16 (which must take the
   tensor-core kernels);
3. the tiny model, the whole served program and the validation step (module
   and fused seg head) on the card against the CPU (float32, TF32 off);
   K4 in phase 2 also at m's and l's widths (c_hid 192 and 256, f32 and
   bf16), with the conv kernel each of its nine convs took;
4. the serving path: yolov5s_seg at full width, random weights from seed 0,
   served at 640 through BatchRunner (a single request, then a burst of 5;
   plus HTTP when cv2 imports), with K1's, K2's, the fused conv
   epilogue's and the served stem's launch counters reset before and read
   after;
4b. the validation path: the same model in bf16 through Validator.run over
   an in-memory loader of 2 batches of 32 images at 640 (made with numpy
   from a seed), once with the module seg head and once with the fused one,
   with K3/K4's launch counters reset before each run and read after;
4m. the Segment model's serving path: yolov5x_v7seg at full width, bf16,
   the benchmark's seeded weights (harness/weights_v7seg.py), one b128
   batch of 640x480 frames letterboxed to 640 through Predictor.run_batch
   with K1's, the epilogue's, the served stem's and the mask assembly's
   launch counters reset just before and each required (the kernels
   line's mask_assembly launches are this run's); the anchors held to the
   decode rows of the served boxes, scores and classes, and the masks to
   the plain assembly on the decode and prototypes that forward gave
   (testing.check_masks; its widest ratio is the kernels line's
   max_abs_err, with phase 5m's); then Proto's phase path (the folded
   2x2 conv and the phase pass, csrc/conv_epilogue.cu) held against the
   upsample and 3x3 conv on that forward's own P3 map (check_bf16), its
   launch required in the run, and the phase kernel timed on that map's
   folded conv output beside its plain version and its byte bound, and
   Proto both ways (the kernels line's conv_epilogue_phases);
5. numbers: the served program at batch 128 / 640 px, the validation step
   at batch 32 with either seg head, each kernel beside its plain version
   at the main path's shapes, beside the one PyTorch call that computes the
   same function where there is one (K2: interpolate + argmax; K4: the
   cuDNN module head; K5, K6 in phase 6: the cuDNN modules) and beside its
   bound (desenet_tpu_torch.tools.timing: bytes over 3.35 TB/s or
   operations over the card's peak rate, whichever is larger, from this
   run's shapes and counts), peak device memory. K1 is timed a second time
   on a dense decode (3000 candidates an image around 100 objects), K2's
   pixel kernel (the first version, kept for the shapes the span kernel does
   not take) beside the span kernel. K3 and K4 are first held against their plain versions
   on the validation forward's own tensors (K3 on its top-16384 candidate
   set, where bf16 scores tie often; K4 on its seg head's inputs, and
   against the module head); K3 is timed a second time on a dense sorted
   set of the same shape (7200 live around 150 clusters), where the whole
   prefix is walked;
5e. the fused conv epilogue (csrc/conv_epilogue.cu, which every conv
   whose BN runs in a served forward on the card launches): its calls in
   one served forward of s (b128/640) and of x6 (yolov5x6_seg, seed-0
   weights, b32/1280) recorded by (shape, SiLU, shortcut); at each, on
   seeded bf16 inputs, the kernel against its plain version to 1 ulp
   (testing.check_epilogue), then the kernel, the plain version and
   PyTorch's eval BN + SiLU (+ add) timed in turns beside the bound, one
   line a shape, and each summed over the forward's calls;
5s. the served stem (ops/stem_pallas.served_stem, the third kernel of
   csrc/stem_conv.cu: row 0 of a fuse()'d bf16 model on the uint8 batch)
   at the s, l and x6 stem shapes (b128/640 to 32 and 64, b32/1280 to 80)
   on a seeded FusedFocus: against its plain version (BF16_BAR) and
   against the parent's path on the same batch (infer's widen, cuDNN's
   conv, the conv_epilogue pass; BF16_MODULE_BAR), the device rows of
   either path by the profiler, both timed in turns beside the byte bound
   (uint8 in, bf16 out) with the kernel's share of it;
5m. the mask assembly of a Segment model (ops/mask_assembly.py,
   csrc/mask_assembly.cu) on testing.MASK_CASES in bf16 and f32 against
   its plain version (testing.check_masks: bits equal but where |c . P| is
   under 1e-3 of its median), then at the served cell's shape (b128 at
   640, about 100 boxes an image, bf16 NHWC prototypes) timed in turns
   beside the plain version on the card and its byte bound;
6. the K5/K6 slice: its two entry points (desenet_tpu_torch.tools
   probe_stem_pallas and proto_c3_kernel: parity in f32 and bf16, timing
   at b128/640 bf16) with K5/K6's
   launch counters reset before and read after; then, on the b128/640 bf16
   served forward, the input and output of the FusedFocus stem (its uint8
   batch, widened as infer widened it before) and of every
   C3 are hooked, K5 (on fold_focus's weights) and K6 (on fold_c3's) are
   held against their plain versions and against the modules' outputs, and
   the three are timed in turns, one line per layer;
7. the training slice: (a) the tiny model (64 px, batch 2, SGD) takes
   training steps on the card and on the CPU from one state and batch, with
   the fused and with the materialized seg loss, two in float64 and one in
   float32 (TF32 off), held to testing.TRAIN_LOSS_BAR / TRAIN_STATE_BAR; (b)
   yolov5s_seg at full width and depth, 640 px, batch 64 (the recipe's
   nominal batch, so every step is an optimizer step), bf16 compute:
   eight steps on one fixed batch, where the loss must be finite and fall,
   with the peak device memory of each seg loss, then the step timed by
   CUDA events over 10 warm steps on distinct batches, fused and
   materialized seg loss in turns; (c) the EMA weights in the eval model
   through Validator.run over one in-memory batch of 32, with K3's launch
   counter reset before and read after;
8. the training entry point, yolov5s_seg at full width, 640 px, bf16
   compute: (a) always: train.engine.fit on the card over numpy-made uint8
   batches already on the card (4 batches of 64 an epoch, 2 epochs) with
   the EMA validated on one in-memory batch of 32 at every epoch end, the
   checkpoints written and ``last`` reloaded bitwise equal to the live
   state (weights, BN statistics, EMA, optimizer buffers, counters), then a
   third epoch resumed from it with the counters going on, results.csv
   holding 3 rows of finite, falling losses and metrics in [0, 1], and
   K3's launch counter at least one a validation; per epoch the training
   loop's wall time and img/s, the device-idle share of the resumed epoch's
   steps (torch.profiler), peak allocated memory; (b) when PIL and cv2
   import: cli.train.main end to end on a fake dataset (32 train and 8 val
   images at 640, desenet_tpu_torch.tools.make_fake_dataset) at batch 16
   for 1 epoch with mosaic and autoanchor on, the device's step time at
   b16, then on those 640 px sources and on 32 oversized 1280 px ones: the
   native rasterizer's masks of a batch against PIL's and assemble_batch
   against np.stack, and the host's data time (the loader alone, one thread
   a batch; and the samples with every worker thread busy) with the PIL
   decode, --fast-decode (or, without libjpeg in the library, the error it
   raises), --cache-images ram and --cache-images disk, each beside the
   step; without PIL and cv2 one line says that (b) did not run and why;
9. the model family: (a) yolov5m_seg and yolov5l_seg at full width and
   depth, random weights from seed 0, served at b128/640 bf16 through
   Predictor (FusedFocus stem) with K1's, K2's and the fused conv
   epilogue's launch counters reset before and read after, img/s and
   peak memory, and the f32 served program (TF32 off) on two images at
   320 on the card against the CPU; (b) each one's
   validation step through Validator.run on an in-memory batch of 32 at
   640, with the module and the fused seg head, K3/K4's launch counters
   reset before each run and read after, the step timed with either head,
   and K4 on that forward's seg-head inputs held against its plain version
   and the cuDNN module head and timed beside both and its bound; (c) the
   SegMaskPSP, Lab, Base and BiSe heads on the tiny graph, yolov5s (no seg
   head) and testing.EXOTIC_CFG (every other DSL row) at 64 px on the card
   against the CPU (f32, TF32 off), K2 on each head's 1/8 logits equal to
   plain; (d) the yolov5s_seg served program with the FusedFocus and with
   the Focus stem in turns at b128/640 bf16, and the two stems alone;
10. inference and validation, the rest, yolov5s_seg at full width, seed-0
   weights (seed 1 for an ensemble's second member), bf16, 640 px, every
   launch counter reset before each path and read after: (a) port
   checkpoint directories of those weights served through
   api.load_predictor (4 frames), the detect program of cli.detect at b16
   plain (equal to Predictor.infer's at max_det 1000), with TTA (55,755
   anchors; the seg map the plain forward's) and on the two-member
   ensemble (50,400 anchors), each timed per image; K1 at (16, 55755) and
   (16, 50400), max_det 1000, classes (0, 2, 4), on a sparse and a dense
   decode (the TTA dense one above 4096 candidates: the argmax loop) equal
   to plain with last_paths printed; K2 on the ensemble's f32 seg mean
   equal to plain; (b) where cv2 imports, cli.detect.main on 16 JPEGs at
   640 with --save-txt --save-conf --save-crop, then with --augment, the
   files written counted; then the TTA val step at b32/640 (timed,
   Validator.run once), K3 on its own top-16384 set with keep-sets
   identical to plain, and with the fused seg head K4 launched once a
   variant and held on the 544 and 448 px variants' neck maps against
   plain (check_psp2);
11. multi-process data-parallel training, yolov5s_seg at full width, 640 px,
   on a fake dataset (32 train and 8 val images at 640): (a) cli.train
   through the DESENET_* environment launch as one process over NCCL, 1
   epoch at b16 bf16 with the EMA validated on process 0 (K3's launch
   counter reset before and read after); (b) two ranks of the one card
   over gloo with CUDA tensors (NCCL refuses two ranks of one card):
   two float64 SGD steps of a global batch of 16 (8 a rank) held to
   testing's float64 bars against one process on the whole batch, then
   cli.train in the two ranks for 1 epoch at b16 bf16, where only rank 0
   writes its run directory and launches K3 (its counter reset in the rank
   before and sent back after);
12. quantized inference, yolov5s_seg at full width, seed-0 weights: (0) the
   tiny int8 model (boosted weights, per-channel and per-tensor scales) on
   the card against the CPU, where every conv is the plain version; (a)
   the int8 Predictor (calibrated on 2 images, bf16 compute) serves one
   b32/640 batch with every launch of the int8 conv kernel
   (csrc/int8_conv.cu) captured: at each distinct shape the kernel's int32
   sums bit-equal to the plain version's, its outputs at
   testing.check_int8's bar (int8 within 1 LSB, equal on 99.9%), and the
   kernel, the plain version and the im2col + torch._int_mm yardstick
   timed in turns beside the shape's bound, then summed over the forward's
   launches; (b) that Predictor serves b128/640 beside the bf16 Predictor
   on the same weights, in turns (ms, img/s, peak memory, K1 and the int8
   kernel counted); (c) where PIL and cv2 import, cli.val on a fake
   dataset at 640 (16 train, 128 val images) with --int8 (2 calibration
   batches), --act-store fp8 and neither (K3 and the int8 kernel
   counted), then the three programs' b32 val steps in turns;
13. the training and deployment tooling, yolov5s_seg at full width, 640
   px, W&B runs under a temporary WANDB_DIR (PIL and cv2 imported
   outright): (a) cli.log_dataset on a fake dataset (32 train, 8 val),
   then cli.train.main at b16 bf16 for 2 epochs with --wandb
   --upload-dataset --bbox-interval 1 --remat on the wandb-artifact://
   splits of its *_wandb.yaml (--artifact-alias latest): the offline run's
   history (a row an epoch, finite losses, metrics in [0, 1]), the model
   artifact (a version an epoch, aliases latest, last, epoch N, best) and
   the dataset artifacts checked; a third epoch resumed from
   wandb-artifact://run_<id>_model:latest in the same run directory, the
   counters going on; K3 at least once a validation; seconds an epoch;
   (b) --remat at b64/640 bf16 from one state and batches: peak
   allocated memory and the step by CUDA events over 10 warm steps, with
   and without, in turns; in f32 (TF32 off) at b8/320 one step with and
   without from one state and batch: the loss, gradients and BN
   statistics held to testing's bars (moved once, not twice); (c) 13(a)'s
   `last` exported (tools/export_model.py, torch.export) at b1/640 in f32
   and bf16, the export seconds and MB; the consumer
   (tools/consume_exported_model.py, torch and numpy only) in a fresh
   process on the card equal to the live program (f32: boxes within 1e-4,
   seg map equal), and the served Predictor (K1, K2 counted) on the same
   image matched against the f32 export; (d) profiling.model_info of
   yolov5s_seg at 640 (the JAX variables' 7,594,130 params; 7,594,268
   with the two BNs that never run), profile_fn of the first C3 at
   b128/640 bf16 forward and backward, a trace of one served b32 batch
   (kernels in it), and ARM, ASPPs, RFB1, DAPPM, ConvBNReLU, Classify, Sum
   (plain and weighted) in training mode on the card against the CPU
   (f32, TF32 off), outputs and gradients.
14. the parallel layer, yolov5s_seg at full width, seed-0 weights, 640 px:
   (a) Predictor(n_devices=count + 1) refused; two replicas on the one
   card (Predictor._place_replicas) against n_devices=1: in f32 (TF32
   off) at b16 and b15 (padded) and in bf16 at b128 and b127 counts
   equal, boxes within 1e-3, seg maps on 99.9%, K1 and K2 launched 6
   times each in bf16, run_batch timed in turns; n_devices=2 on two
   cards where the machine has them; (b) two gloo ranks of the card as a
   dp1 x sp2 mesh: the f32 eval forward at b4 (decode and 1/8 seg logits,
   and the seg head as K4 on the gathered maps) within SPATIAL_F32_BAR of
   one process's; (c) in those ranks one f32
   training step at b8 (TF32 off) within testing's f32 bars of one
   process's, then bf16 steps timed with each rank's peak allocated
   memory beside one process's; cli.train --spatial 2 in two ranks for 1
   epoch at b8 (only rank 0 writes, K3 in its EMA validation); (d)
   tools.dryrun_multichip --nproc 4 (dp over 4 ranks, then dp2 x sp2 at
   128 px against dp).
15. the JAX package's last modules: (a) yolov5s_seg at full width with
   the phase-layout stem (Predictor(stem_s2d=True), the batch packed by
   native.assemble_batch_s2d4): in f32 (TF32 off) at b16/640 on boosted
   weights its stem output, decode and seg logits against the FusedFocus
   Predictor's (S2D_STEM_BAR, S2D_F32_BAR of their largest magnitude), K1
   on its decode at conf 0.001 and K2 on both stems' logits equal to
   their plain versions, the seg maps equal on 99.9%; in bf16 at b128/640
   on the seed-0 weights both Predictors' run_batch in turns (S2D_TURNS
   each, medians and spread; K1 and K2 counted), rows 0 and 1 of each by
   the profiler, the 2x2 conv's crop against F.pad, and the host's s2d
   packing against np.stack and assemble_batch; (b) fp8 storage over
   every row: testing.EXOTIC_CFG and tiny_psp2 with the BiSe, Lab and
   Base heads at 64 px, float64 on the card against the CPU (rtol and
   atol 1e-5 of the largest magnitude), the rows' storage dtypes, bf16
   against bf16 without storage; cli.val --act-store fp8 on yolov5s_seg
   with a C3Ghost row (K3 counted); (c) the grouped int8 conv at
   testing.INT8_GROUPED_CASES against plain (int32 sums bit-equal), timed
   beside its bound, and testing.GROUPED_CFG's int8 model on the card
   against the CPU (its launches counted).
16. the reference-checkpoint route, yolov5s_seg at full width on boosted
   weights (testing.boosted_state): (a) a port checkpoint of them exported
   by tools/export_torch_sd to the reference's state dict, loaded into a
   port DeSeNet in half and pickled as the reference's train.py saves a
   checkpoint; (b) that .pt imported by tools/import_torch_ckpt and served
   by api.load_predictor on the card; (c) its decode and seg logits held
   against a Predictor built directly from the half-rounded weights (f32
   at b8 with TF32 off, bf16 at b128, IMPORT_F32_BAR and IMPORT_BF16_BAR
   of the largest magnitude), K1 and K2 on its b128 decode and logits
   equal to plain, then b128/640 uint8 batches through run_batch with K1's
   and K2's counters reset before and read after; (d) the export's and
   import's seconds, the artifacts' MB and the served ms a batch.

Inputs of the kernel checks come from desenet_tpu_torch.testing, shared with
tests/test_torch_kernels_cuda.py.

Every timing line carries the card's name and power limit. The last three
lines are the kernels' JSON record (name, route, source, replaces,
launches, max_abs_err, ms, plain_ms, bound_ms, bound_by, library_ms; the
epilogue's at s's b128/640 forward, with x6's forward in its x6_* keys), the
card's name and power limit as nvidia-smi gives them, and {"ok": true,
"device": {...}}.
"""

from __future__ import annotations

import csv
import dataclasses
import itertools
import json
import os
import shutil
import subprocess
import sys
import time

import numpy as np
import torch

from desenet_tpu_torch.testing import (BF16_MODULE_BAR, check_bf16,
                                       check_close, no_tf32, tiny_cfg)
from desenet_tpu_torch.tools import timing as tm
from desenet_tpu_torch.tools.timing import card_line, cuda_ms, in_turns

B_SERVE = 128
B_VAL = 32
B_TRAIN = 64
TRAIN_FIXED_STEPS = 8
TRAIN_TIMED_STEPS = 10
N_VAL_BATCHES = 2
IMGSZ = 640
CSRC = "desenet_tpu_torch/csrc"
V7SEG_CONF = "benchmark/configs/yolov5x_v7seg.json"  # phase 4m's model
V7SEG_SEED = 2147483693


# the tensor-core kernels: the bf16 variants of K6, of K4's conv and of K5,
# and the served stem
MMA_KERNELS = ("c3_mma_kernel", "conv_gemm_mma_kernel", "stem_mma_kernel",
               "stem_u8_kernel")
# the served stem's shapes: (cell, batch, side, CO)
SERVED_STEMS = (("s", 128, 640, 32), ("l", 128, 640, 64),
                ("x6", 32, 1280, 80))


def log(phase, msg: str) -> None:
    print(f"[phase {phase}] {msg}", flush=True)


def val_batches(seed: int, n: int, b: int, imgsz: int, nc: int, se_nc: int,
                max_targets: int = 16):
    """In-memory loader: ``n`` batches with the keys of
    desenet_tpu_torch.data.dataset.collate, made with numpy from ``seed``."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        n_t = rng.integers(1, max_targets + 1, b)
        tg = np.zeros((b, max_targets, 5), np.float32)
        tg[..., 0] = rng.integers(0, nc, (b, max_targets))
        tg[..., 1:3] = rng.uniform(0.15, 0.85, (b, max_targets, 2))
        tg[..., 3:5] = rng.uniform(0.05, 0.3, (b, max_targets, 2))
        mask = np.arange(max_targets)[None] < n_t[:, None]
        tg[~mask] = 0
        coarse = rng.integers(0, se_nc, (b, imgsz // 32, imgsz // 32))
        out.append({
            "image": rng.integers(0, 256, (b, imgsz, imgsz, 3),
                                  dtype=np.uint8),
            "det_targets": tg,
            "det_mask": mask,
            "seg_labels": np.repeat(np.repeat(coarse, 32, 1), 32, 2).astype(
                np.uint8),
            "shapes": [None] * b,
        })
    return out


def phase0():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; "
                         "this smoke runs only on a CUDA card")
    mods = []
    for m in ("cv2", "PIL", "yaml"):
        try:
            __import__(m)
            mods.append(f"{m}=yes")
        except ImportError:
            mods.append(f"{m}=no")
    log(0, f"python {sys.version.split()[0]} torch {torch.__version__} "
        f"cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)!r} "
        f"count {torch.cuda.device_count()} card '{card_line()}' "
        + " ".join(mods))


def phase1():
    import threading

    from desenet_tpu_torch import native
    from desenet_tpu_torch.ops import _ext

    # the host library (the host compiler) builds beside the kernels (nvcc)
    host = {}

    def build_host():
        t0 = time.perf_counter()
        try:
            host["so"] = native.build()
        except Exception as e:  # noqa: BLE001 - raised in the main thread
            host["error"] = e
        host["s"] = time.perf_counter() - t0

    host_build = threading.Thread(target=build_host)
    t = time.perf_counter()
    host_build.start()
    _ext.load()
    dt = time.perf_counter() - t
    host_build.join()
    if "error" in host:
        raise host["error"]
    cxx = native._cxx()
    log(1, f"kernels ready in {dt:.3f} s ({_ext.build_dir()}); host "
        f"library {host['so']} in {host['s']:.3f} s by {cxx} "
        f"{' '.join(native.build_flags(cxx)[0])}: OpenMP "
        + ("yes" if native.has_openmp(cxx) else "no (batch loops on the "
           "calling thread)") + ", libjpeg "
        + ("yes" if native.jpeg_available() else
           "no (jpeglib.h absent at build: --fast-decode raises)"))
    logf = os.path.join(_ext.build_dir(), "build.log")
    entry, spills = None, {}
    with open(logf) as fh:
        for line in fh:
            if "ptxas info" in line and ("Used" in line or "Compiling" in line):
                log(1, line.strip())
            if "Compiling entry function" in line:
                entry = line.split("'")[1]
            elif "bytes spill stores" in line and entry is not None:
                spills[entry] = line.strip()
    for kernel in MMA_KERNELS:
        lines = [v for k, v in spills.items() if kernel in k]
        if not lines or any(" 0 bytes spill stores, 0 bytes spill loads"
                            not in " " + line for line in lines):
            raise AssertionError(f"{kernel}: ptxas reports {lines}")
        log(1, f"{kernel}: {len(lines)} instance(s), each {lines[0]}")
    cuobjdump = shutil.which("cuobjdump") or os.path.join(
        os.path.dirname(_ext._nvcc()), "cuobjdump")
    if not os.path.exists(cuobjdump):
        log(1, "cuobjdump not found: SASS not inspected")
        return
    # only the tensor-core kernels: the whole library takes several times as
    # long to disassemble
    entries = [k for k in spills if any(m in k for m in MMA_KERNELS)]
    sass = subprocess.run(
        [cuobjdump, "-sass", "-fun", ",".join(entries),
         os.path.join(_ext.build_dir(), _ext.LIB_NAME)],
        capture_output=True, text=True, check=True, timeout=300).stdout
    hmma, fn = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            fn = line.split("Function :")[1].strip()
        elif ("HMMA." in line or "HGMMA." in line) and fn is not None:
            hmma.setdefault(fn, []).append(" ".join(line.split()[1:6]))
    for kernel in MMA_KERNELS:
        found = [(k, v) for k, v in hmma.items() if kernel in k]
        n_inst = sum(kernel in k for k in spills)
        if not found or len(found) != n_inst:
            raise AssertionError(f"{kernel}: HMMA in {len(found)} of its "
                                 f"{n_inst} instances ({sorted(hmma)})")
        log(1, f"{kernel} SASS: {len(found[0][1])} HMMA instructions in "
            f"each of {len(found)} instance(s), the first: {found[0][1][0]}")


def phase2(errs: dict):
    from desenet_tpu_torch.ops import (c3_fused, nms_fused, nms_pallas,
                                       seg_head_pallas, seg_pallas,
                                       stem_pallas)
    from desenet_tpu_torch.testing import (BF16_BAR, C3_SERVED,
                                           NMS_FUSED_CASES, SEG_TAIL_CASES,
                                           check_psp2,
                                           dense_sorted_candidates,
                                           greedy_candidates, nms_fused_case,
                                           psp2_inputs, random_c3_params,
                                           random_psp2_head,
                                           seg_tail_infinite_input,
                                           seg_tail_input,
                                           sorted_candidates, stem_inputs)

    rng = np.random.default_rng(0)
    dev = torch.device("cuda")
    # the shared tensor-core tile alone: one bf16 1x1 stage against matmul.
    # Both sum exact bf16 products in f32, in another order: the 2^-6 bar
    # is far above the 1e-5 or so that leaves
    a = torch.from_numpy(rng.normal(size=(1000, 512)).astype(np.float32)).to(
        dev, torch.bfloat16)
    w = torch.from_numpy((rng.normal(size=(512, 256)) / 512 ** 0.5).astype(
        np.float32)).to(dev, torch.bfloat16)
    before = dict(seg_head_pallas.conv_variants)
    got = seg_head_pallas.conv1x1_f32(a, w)
    ref = torch.matmul(a.float(), w.float())
    torch.cuda.synchronize()
    if seg_head_pallas.conv_variants["mma"] != before["mma"] + 1:
        raise AssertionError("the 1x1 stage did not take the tensor-core "
                             "kernel")
    err = float((got - ref).abs().max())
    bound = BF16_BAR * float(ref.abs().max())
    if not err <= bound:
        raise AssertionError(f"shared tile (1000 x 512) @ (512 x 256): max "
                             f"abs err {err} above {bound}")
    log(2, f"shared tensor-core tile, bf16 (1000, 512) @ (512, 256) as one "
        f"1x1 stage: max abs err {err:.6g} against torch.matmul in f32 "
        f"(|ref| max {float(ref.abs().max()):.6g}, bar 2^-6 of it)")

    # K1: rows equal to plain on every case, the path every image took as
    # the counts say (0 the ordered walk, 1 the argmax loop)
    ran = {0: 0, 1: 0}
    for case in NMS_FUSED_CASES:
        name, _, _, max_det, path = case
        planes = [p.to(dev) for p in nms_fused_case(case)]
        b, n_anchor = planes[4].shape
        n_cand = (planes[4] > 0).sum(1)
        got = nms_fused.greedy_select(*planes, max_det, 0.45)
        ref = nms_fused.greedy_select_plain(*planes, max_det, 0.45)
        torch.cuda.synchronize()
        if not torch.equal(got, ref):
            raise AssertionError(
                f"K1 {name}: kernel rows differ from plain in "
                f"{int((got != ref).any(-1).sum())} of {b * max_det} (max "
                f"abs err {float((got - ref).abs().max())})")
        paths = nms_fused.last_paths.tolist()
        if paths != [path] * b:
            raise AssertionError(f"K1 {name}: paths {paths}, expected {path}")
        ran[path] += b
        err = float((got - ref).abs().max())
        errs["nms_fused"] = max(errs.get("nms_fused", 0.0), err)
        log(2, f"K1 nms_fused {name} ({b}, {n_anchor}), {int(n_cand.min())} "
            f"to {int(n_cand.max())} candidates an image, max_det {max_det}, "
            f"IoU 0.45: {'ordered walk' if path == 0 else 'argmax loop'}, "
            f"{int((got[..., 4] > 0).sum())} picks, identical to plain (max "
            f"abs err {err})")
    if min(ran.values()) < 1:
        raise AssertionError(f"K1: images by path {ran}")
    log(2, f"K1 paths over these cases: {ran[0]} images on the ordered walk, "
        f"{ran[1]} on the argmax loop")

    # K2: the kernel the wrapper picks from the shape, and both kernels
    # equal to plain on every case
    took = {"span": 0, "pixel": 0}
    for case in SEG_TAIL_CASES:
        b, h, w, c, dt, scale, align, variant = case
        x = seg_tail_input(case).to(dev)
        taps = (*seg_pallas.seg_taps(h, h * scale, align, dev),
                *seg_pallas.seg_taps(w, w * scale, align, dev))
        got = seg_pallas.upsample_argmax(x, scale, align)
        picked = seg_pallas.last_variant
        ref = seg_pallas.upsample_argmax_plain(x, *taps)
        pixel = seg_pallas.upsample_argmax_with(x, "pixel", scale, align)
        torch.cuda.synchronize()
        if picked != variant:
            raise AssertionError(f"K2 {case}: took the {picked} kernel")
        if not torch.equal(got, ref) or not torch.equal(pixel, ref):
            raise AssertionError(
                f"K2 {case}: {int((got != ref).sum())} pixels of the "
                f"{picked} kernel and {int((pixel != ref).sum())} of the "
                f"pixel kernel differ from plain")
        took[picked] += 1
        err = float((got.int() - ref.int()).abs().max())
        errs["seg_tail"] = max(errs.get("seg_tail", 0.0), err)
        log(2, f"K2 seg_tail ({b},{h},{w},{c}) {str(dt)[6:]} x{scale}, "
            f"align_corners {align}: kernel {picked} (longest run "
            f"{seg_pallas.tap_runs(w, w * scale, align)[1]} pixels), it and "
            f"the pixel kernel equal to plain on all {got.numel()} pixels")
    if min(took.values()) < 1:
        raise AssertionError(f"K2: cases by kernel {took}")
    # infinite logits beside the one-tap pixels: neither kernel reads them
    x = seg_tail_infinite_input().to(dev)
    ref = seg_pallas.upsample_argmax_plain(
        x, *seg_pallas.seg_taps(80, 640, True, dev) * 2)
    for variant in ("span", "pixel"):
        got = seg_pallas.upsample_argmax_with(x, variant)
        if not torch.equal(got, ref):
            raise AssertionError(
                f"K2 {variant} kernel with infinite neighbours: "
                f"{int((got != ref).sum())} pixels differ from plain")
    log(2, "K2 seg_tail (2,80,80,3) f32 with infinite logits beside the "
        "one-tap pixels: both kernels equal to plain")

    # K3: unsorted sets take the kernel's argmax loop, sorted ones (the
    # validation path's order) its ordered walk; each on the shared-memory
    # and the global-scratch size, identical to plain, the path checked
    big = nms_pallas.SMEM_CAP + 5000
    k3_cases = [
        ("unsorted", greedy_candidates(rng, 4, 2048), 300, 1),
        ("unsorted", greedy_candidates(rng, 2, big), 300, 1),
        ("sorted", sorted_candidates(rng, 3, 2048, 1500), 300, 0),
        ("sorted, ties", sorted_candidates(rng, 3, 2048, 1500, levels=5),
         300, 0),
        ("sorted, duplicate boxes",
         sorted_candidates(rng, 3, 2048, 1500, dup=0.5), 2000, 0),
        ("sorted, all dead", sorted_candidates(rng, 2, 2048, 0), 300, 0),
        ("sorted, fewer live than max_det",
         sorted_candidates(rng, 2, 2048, 100), 300, 0),
        ("sorted, L on a round boundary",
         sorted_candidates(rng, 2, 2048, 1024), 2000, 0),
        ("sorted, L one past a round boundary",
         sorted_candidates(rng, 2, 2048, 1025), 2000, 0),
        ("sorted, L on the survivor boundary",
         sorted_candidates(rng, 2, 2048, 512), 2000, 0),
        ("sorted, crowded",
         sorted_candidates(rng, 2, 4096, 3000, spread=500.0), 300, 0),
        ("sorted, dense clusters",
         dense_sorted_candidates(rng, 2, 16384, 7200, 150), 300, 0),
        ("sorted", sorted_candidates(rng, 2, big, 9000, spread=4000.0), 300,
         0),
        ("sorted, max_det above the walk's cap",
         sorted_candidates(rng, 1, 2048, 1500), nms_pallas.KEPT_CAP + 1, 1),
    ]
    ran = {0: 0, 1: 0}
    for name, (boxes, scores), max_det, path in k3_cases:
        boxes, scores = boxes.to(dev), scores.to(dev)
        b, k = scores.shape
        idx, sc = nms_pallas.greedy_nms_pallas(boxes, scores, 0.6, max_det)
        ridx, rsc = nms_pallas.greedy_nms_plain(boxes, scores, 0.6, max_det)
        torch.cuda.synchronize()
        if not torch.equal(idx, ridx) or not torch.equal(sc, rsc):
            raise AssertionError(
                f"K3 {name} ({b}, {k}): kernel keep-set differs from plain "
                f"in {int((idx != ridx).sum())} of {idx.numel()} rows")
        paths = nms_pallas.last_paths.tolist()
        if paths != [path] * b:
            raise AssertionError(f"K3 {name} ({b}, {k}): paths {paths}, "
                                 f"expected {path}")
        ran[path] += b
        err = float((sc - rsc).abs().max())
        errs["nms_greedy"] = max(errs.get("nms_greedy", 0.0), err)
        mem = ("shared-memory" if k <= nms_pallas.SMEM_CAP
               else "global-scratch")
        log(2, f"K3 nms_greedy {name} ({b}, {k}), {mem} size, "
            f"{int((scores > 0).sum(1).max())} live, max_det {max_det}, IoU "
            f"0.6: {'ordered walk' if path == 0 else 'argmax loop'}, "
            f"{int((sc > 0).sum())} picks, identical to plain (max abs err "
            f"{err})")
    if min(ran.values()) < 1:
        raise AssertionError(f"K3: images by path {ran}")
    log(2, f"K3 paths over these sets: {ran[0]} images on the ordered walk, "
        f"{ran[1]} on the argmax loop")

    with no_tf32():
        # yolov5s_seg's widths (inputs 256/256/512, c_hid 128), then m's
        # (c_hid 192) and l's (c_hid 256)
        for c_hid, dt, b in ((128, torch.float32, 4),
                             (128, torch.bfloat16, 4),
                             (192, torch.float32, 2),
                             (192, torch.bfloat16, 2),
                             (256, torch.float32, 2),
                             (256, torch.bfloat16, 2)):
            chans = (2 * c_hid, 2 * c_hid, 4 * c_hid)
            head = random_psp2_head(chans, c_hid).to(dev)
            xs = [x.to(dev, dt) for x in psp2_inputs(b, 80, 80, chans)]
            before = dict(seg_head_pallas.conv_variants)
            got = seg_head_pallas.fused_psp2_eval(xs, head, 3)
            took = {k: v - before[k]
                    for k, v in seg_head_pallas.conv_variants.items()}
            # of the nine convs the class conv (3 outputs) takes the narrow
            # kernel, and so does context_red where its c_hid // 6 outputs
            # are at most 32; in bf16 the stem, ConvLinear and FFM convs
            # take the tensor cores, and the four ACSP convs too where
            # their c_hid // 2 outputs are a multiple of 64 (not at m's
            # 96); the CUDA-core tile takes what is left
            narrow = 1 + (c_hid // 6 <= 32)
            mma = (3 + 4 * ((c_hid // 2) % 64 == 0)
                   if dt == torch.bfloat16 else 0)
            if took != {"mma": mma, "narrow": narrow,
                        "fma": 9 - mma - narrow}:
                raise AssertionError(f"K4 c_hid {c_hid} {dt}: conv launches "
                                     f"by kernel {took}")
            ref = seg_head_pallas.fused_psp2_eval_plain(xs, head, 3)
            torch.cuda.synchronize()
            err, agree = check_psp2(got, ref, dt)
            errs["seg_head_psp2"] = max(errs.get("seg_head_psp2", 0.0), err)
            bar = ("within rtol/atol 1e-4 of plain" if dt == torch.float32
                   else "within 1e-2 of |plain| max, argmax agreement >= 0.99")
            log(2, f"K4 seg_head_psp2 ({b}, 80, 80) c_hid {c_hid} "
                f"{str(dt)[6:]}: {bar} (max abs err {err:.6g}, |plain| max "
                f"{float(ref.abs().max()):.6g}, argmax agreement {agree:.6f}; "
                f"conv launches by kernel {took})")

        # K5: float32 on the CUDA cores, bfloat16 on the tensor cores, at
        # the three stem widths, on a map the 16 x 32 tile does not divide,
        # with and without the SiLU
        for hw, co, silu in (((IMGSZ, IMGSZ), 32, True),
                             ((IMGSZ, IMGSZ), 48, True),
                             ((IMGSZ, IMGSZ), 64, True),
                             ((IMGSZ, IMGSZ), 32, False),
                             ((200, 328), 32, True),
                             ((100, 70), 64, False)):  # W no multiple of 8
            x, w6, bias = stem_inputs(4, *hw, co)
            for dt in (torch.float32, torch.bfloat16):
                xd = x.to(dev, dt)
                wm = stem_pallas.stem_weight_matrix(w6, dt).to(dev)
                bd = torch.from_numpy(bias).to(dev)
                got = stem_pallas.stem_conv(xd, wm, bd, silu=silu)
                ref = stem_pallas.stem_conv_plain(xd, wm, bd, silu)
                torch.cuda.synchronize()
                want = "mma" if dt == torch.bfloat16 else "fma"
                if stem_pallas.last_variant != want:
                    raise AssertionError(
                        f"K5 {dt} took the {stem_pallas.last_variant} kernel")
                err = check_close(got, ref, f"K5 CO {co}", 1e-5)
                errs["stem_conv"] = max(errs.get("stem_conv", 0.0), err)
                log(2, f"K5 stem_conv (4, {hw[0]}, {hw[1]}, 3) -> CO {co} "
                    f"{str(dt)[6:]}, SiLU {silu}, kernel {want}: max abs err "
                    f"{err:.6g} against plain (|plain| max "
                    f"{float(ref.float().abs().max()):.6g})")

        for row, c, c2, c_, n, sc, side in C3_SERVED:
            raw = random_c3_params(np.random.default_rng(row), c, c_, c2, n)
            x = torch.from_numpy(rng.normal(size=(2, side, side, c)).astype(
                np.float32))
            for dt in (torch.float32, torch.bfloat16):
                params = c3_fused.c3_params(raw, dev, dt)
                xd = x.to(dev, dt)
                got = c3_fused.c3_fused(xd, params, n, sc)
                ref = c3_fused.c3_plain(xd, params, n, sc)
                torch.cuda.synchronize()
                err = check_close(got, ref, f"K6 row {row}", 1e-4)
                errs["c3_fused"] = max(errs.get("c3_fused", 0.0), err)
                bf = dt == torch.bfloat16
                if c3_fused.last_variant != ("mma" if bf else "fma"):
                    raise AssertionError(
                        f"K6 row {row} {dt} took the "
                        f"{c3_fused.last_variant} kernel")
                tile = (c3_fused.pick_tile(side, side, c, c_, c2, n) if bf
                        else c3_fused.pick_square_tile(c_, n, 4))
                log(2, f"K6 c3_fused row {row} (2, {side}, {side}, {c}) -> "
                    f"{c2}, c_ {c_}, n {n}, shortcut {sc}, {str(dt)[6:]}: "
                    f"max abs err {err:.6g} against plain (|plain| max "
                    f"{float(ref.float().abs().max()):.6g}, kernel "
                    f"{c3_fused.last_variant}, tile {tile})")


def match_boxes(got, want) -> float:
    """Largest distance from a box of one set to its nearest box in the
    other (picks whose scores differ by rounding may swap order)."""
    if len(got) == 0 and len(want) == 0:
        return 0.0
    dist = (got[:, None] - want[None]).abs().amax(-1)
    return float(max(dist.amin(1).max(), dist.amin(0).max()))


def phase3():
    from desenet_tpu_torch.api import Predictor
    from desenet_tpu_torch.eval import Validator
    from desenet_tpu_torch.models import build_model, init_weights
    from desenet_tpu_torch.utils.convert import load_state_dict

    with no_tf32():
        cfg = tiny_cfg()
        model, _ = build_model(cfg)
        init_weights(model, torch.Generator().manual_seed(1))
        x = torch.from_numpy(np.random.default_rng(1).uniform(
            0, 1, (2, 3, 64, 64)).astype(np.float32))
        with torch.inference_mode():
            (d0, f0), s0 = model(x)
            gpu = model.to("cuda", memory_format=torch.channels_last)
            (d1, f1), s1 = gpu(x.to("cuda").contiguous(
                memory_format=torch.channels_last))
        errs = [float((a.cpu() - b).abs().max())
                for a, b in [(d1, d0), (s1, s0)] + list(zip(f1, f0))]
        if max(errs) > 1e-4:
            raise AssertionError(f"tiny forward CUDA vs CPU: max errs {errs}")
        log(3, f"tiny f32 forward CUDA vs CPU: max abs err {max(errs):.3g} "
            f"(atol 1e-4)")

        sd = init_weights(build_model(cfg)[0],
                          torch.Generator().manual_seed(2)).state_dict()
        imgs = torch.from_numpy(np.random.default_rng(2).integers(
            0, 256, (4, 64, 64, 3), dtype=np.uint8))
        outs = {}
        for dev in ("cpu", "cuda"):
            p = Predictor(cfg, sd, imgsz=64, conf_thres=1e-3, max_det=50,
                          half=False, device=dev)
            nms, seg = p.infer(imgs.to(dev))
            outs[dev] = (nms.num.cpu(), nms.boxes.cpu(), seg.cpu())
        (nc, bc, sc), (ng, bg, sg) = outs["cpu"], outs["cuda"]
        if not torch.equal(nc, ng) or int(nc.min()) < 1:
            raise AssertionError(f"served program: num CPU {nc} vs CUDA {ng}")
        box_err = float((bc - bg).abs().max())
        seg_eq = float((sc == sg).float().mean())
        if box_err > 1e-3 or seg_eq < 0.999:
            raise AssertionError(f"served program CUDA vs CPU: box err "
                                 f"{box_err}, seg agreement {seg_eq}")
        log(3, f"tiny served program CUDA vs CPU: num {ng.tolist()} equal, "
            f"box max abs err {box_err:.3g} (atol 1e-3), seg maps "
            f"{seg_eq:.6f} equal (>= 0.999)")

        batch = val_batches(3, 1, 4, 64, 3, 2)[0]
        for fused in (False, True):
            outs = {}
            for dev in ("cpu", "cuda"):
                m, _ = build_model(cfg, decode_cat=False,
                                   seg_head_fused=fused)
                load_state_dict(m, sd)
                m = m.to(dev, memory_format=torch.channels_last
                         if dev == "cuda" else torch.contiguous_format)
                nms, seg = Validator(m, nc=3, se_nc=2).eval_step(
                    torch.from_numpy(batch["image"]).to(dev),
                    torch.from_numpy(batch["det_targets"]).to(dev),
                    torch.from_numpy(batch["det_mask"]).to(dev))
                outs[dev] = (nms.num.cpu(), nms.boxes.cpu(), seg.cpu())
            (nc, bc, sc), (ng, bg, sg) = outs["cpu"], outs["cuda"]
            if not torch.equal(nc, ng) or int(nc.min()) < 1:
                raise AssertionError(f"val step (fused head {fused}): num "
                                     f"CPU {nc} vs CUDA {ng}")
            box_err = max(match_boxes(bg[i, :n], bc[i, :n])
                          for i, n in enumerate(nc.tolist()))
            seg_eq = float((sc == sg).float().mean())
            if box_err > 1e-3 or seg_eq < 0.999:
                raise AssertionError(
                    f"val step (fused head {fused}) CUDA vs CPU: box err "
                    f"{box_err}, seg agreement {seg_eq}")
            log(3, f"tiny val step (multi-label NMS, fused seg head {fused}) "
                f"CUDA vs CPU: num {ng.tolist()} equal, boxes within "
                f"{box_err:.3g} (atol 1e-3), seg maps {seg_eq:.6f} equal "
                f"(>= 0.999)")


def check_response(res: dict, what: str) -> None:
    dets = res["detections"]
    if not isinstance(dets, list) or res["num"] != len(dets) or len(dets) > 300:
        raise AssertionError(f"{what}: malformed response {res}")
    for d in dets:
        vals = [d["xmin"], d["ymin"], d["xmax"], d["ymax"], d["confidence"]]
        if not all(np.isfinite(vals)) or not 0 < d["confidence"] <= 1 or \
                not 0 <= d["xmin"] <= d["xmax"] <= IMGSZ or \
                not 0 <= d["ymin"] <= d["ymax"] <= IMGSZ:
            raise AssertionError(f"{what}: bad detection {d}")


def phase4():
    from desenet_tpu_torch.api import Predictor
    from desenet_tpu_torch.models import build_model, config_path, init_weights
    from desenet_tpu_torch.ops import (conv_epilogue, nms_fused, seg_pallas,
                                       stem_pallas)
    from desenet_tpu_torch.serve import BatchRunner, InferenceServer, _Pending

    model, spec = build_model(config_path("yolov5s_seg"))
    n_params = sum(p.numel() for p in model.parameters())
    sd = init_weights(model, torch.Generator().manual_seed(0)).state_dict()
    pred = Predictor("yolov5s_seg", sd, imgsz=IMGSZ, half=True, device="cuda")
    rng = np.random.default_rng(0)
    imgs = [rng.integers(0, 256, (IMGSZ, IMGSZ, 3), dtype=np.uint8)
            for _ in range(7)]

    nms_fused.launches = 0
    seg_pallas.launches = 0
    conv_epilogue.launches = 0
    stem_pallas.served_launches = 0
    runner = BatchRunner(pred, max_batch=16, max_wait_ms=20.0)
    runner.start()
    try:
        t = time.perf_counter()
        single = _Pending(imgs[0], want_mask=False)
        if not runner.submit(single) or not single.done.wait(600):
            raise AssertionError("single request was not served")
        t_single = time.perf_counter() - t
        burst = [_Pending(im, want_mask=False) for im in imgs[1:6]]
        t = time.perf_counter()
        for p in burst:
            if not runner.submit(p):
                raise AssertionError("burst request was shed")
        for p in burst:
            if not p.done.wait(600):
                raise AssertionError("burst request was not served")
        t_burst = time.perf_counter() - t
    finally:
        runner.stop()
        runner.join(10)
    if runner.is_alive():
        raise AssertionError("the runner did not stop")
    for i, p in enumerate([single] + burst):
        if p.error is not None or p.result is None:
            raise AssertionError(f"request {i}: error {p.error!r}")
        check_response(p.result, f"request {i}")
    stats = dict(runner.stats)
    if stats["batches"] < 2 or stats["max_batch_seen"] < 2:
        raise AssertionError(f"expected two batch sizes, stats {stats}")
    log(4, f"yolov5s_seg ({n_params} params, de_nc {spec.de_nc}, se_nc "
        f"{spec.se_nc}) bf16 at {IMGSZ}: single request "
        f"{single.result['num']} dets in {t_single:.3f} s (first call), "
        f"burst of 5 in {t_burst:.3f} s, runner stats {stats}")

    try:
        import cv2
    except ImportError:
        cv2 = None
    if cv2 is not None:
        import urllib.request

        srv = InferenceServer(pred, port=0, max_batch=16)
        srv.start()
        try:
            base = f"http://127.0.0.1:{srv.port}"
            with urllib.request.urlopen(base + "/healthz", timeout=60) as r:
                health = json.loads(r.read())
            ok, png = cv2.imencode(".png", imgs[6])
            req = urllib.request.Request(base + "/predict", data=png.tobytes(),
                                         method="POST")
            with urllib.request.urlopen(req, timeout=600) as r:
                res = json.loads(r.read())
        finally:
            srv.stop()
        if health != {"ok": True}:
            raise AssertionError(f"/healthz answered {health}")
        check_response(res, "HTTP request")
        log(4, f"HTTP /healthz {health}, /predict num {res['num']}")
    else:
        log(4, "cv2 not importable: HTTP front end skipped")

    launches = {"nms_fused": nms_fused.launches,
                "seg_tail": seg_pallas.launches,
                "conv_epilogue": conv_epilogue.launches}
    served = stem_pallas.served_launches
    if min(launches.values()) < 1 or served < 1:
        raise AssertionError(f"main path did not launch every kernel: "
                             f"{launches}, the served stem {served}")
    log(4, f"kernel launches on the serving path: {launches}")
    return pred, launches, sd


def phase4b(sd):
    from desenet_tpu_torch.eval import Validator
    from desenet_tpu_torch.models import build_model, config_path
    from desenet_tpu_torch.ops import nms_pallas, seg_head_pallas
    from desenet_tpu_torch.utils.convert import load_state_dict

    model, spec = build_model(config_path("yolov5s_seg"))
    load_state_dict(model, sd)
    model = model.to("cuda", torch.bfloat16, memory_format=torch.channels_last)
    t = time.perf_counter()
    batches = val_batches(0, N_VAL_BATCHES, B_VAL, IMGSZ, spec.de_nc,
                          spec.se_nc)
    log("4b", f"in-memory loader: {N_VAL_BATCHES} batches of {B_VAL} "
        f"images at {IMGSZ} made in {time.perf_counter() - t:.3f} s")
    validator = Validator(model, nc=spec.de_nc, se_nc=spec.se_nc)
    launches = {"nms_greedy": 0, "seg_head_psp2": 0}
    results = {}
    for fused in (False, True):
        model.seg_head_fused = fused
        nms_pallas.launches = 0
        seg_head_pallas.launches = 0
        t = time.perf_counter()
        res = validator.run(batches)
        wall = time.perf_counter() - t
        k3, k4 = nms_pallas.launches, seg_head_pallas.launches
        if k3 < N_VAL_BATCHES or (k4 < N_VAL_BATCHES if fused else k4 != 0):
            raise AssertionError(f"val run (fused head {fused}): K3 launched "
                                 f"{k3}, K4 {k4} times over {N_VAL_BATCHES} "
                                 "batches")
        launches["nms_greedy"] += k3
        launches["seg_head_psp2"] += k4
        summary = {k: v for k, v in res.items() if k != "per_class"}
        vals = [summary[k] for k in ("mp", "mr", "map50", "map", "miou",
                                     "pix_acc")]
        if summary["seen"] != N_VAL_BATCHES * B_VAL or not all(
                np.isfinite(v) and 0 <= v <= 1 for v in vals):
            raise AssertionError(f"val run (fused head {fused}): {summary}")
        results[fused] = summary
        log("4b", f"yolov5s_seg bf16 val at {IMGSZ}, fused seg head {fused}: "
            f"{json.dumps(summary)}; {wall:.3f} s wall; launches K3 {k3}, "
            f"K4 {k4}")
    d = abs(results[True]["miou"] - results[False]["miou"])
    if d > 0.05:
        raise AssertionError(f"fused and module seg heads disagree: mIoU "
                             f"{results[True]['miou']} vs "
                             f"{results[False]['miou']}")
    log("4b", f"mIoU fused vs module head differ by {d:.3g} (bf16, <= 0.05)")
    model.seg_head_fused = False
    return model, spec, validator, batches[0], launches


def phase5(pred, card: str, extras: dict) -> dict:
    from desenet_tpu_torch.ops import nms_fused, seg_pallas
    from desenet_tpu_torch.testing import dense_decode, synthetic_decode

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    warm = torch.randint(0, 256, (B_SERVE, IMGSZ, IMGSZ, 3), dtype=torch.uint8,
                         device=dev, generator=g)
    x = torch.randint(0, 256, (B_SERVE, IMGSZ, IMGSZ, 3), dtype=torch.uint8,
                      device=dev, generator=g)
    torch.cuda.reset_peak_memory_stats()
    for _ in range(2):
        pred.infer(warm)
    ms = cuda_ms(lambda: pred.infer(x), 10)
    peak = torch.cuda.max_memory_allocated()
    log(5, f"device program b{B_SERVE}/{IMGSZ} (uint8 in, forward + K1 + K2, "
        f"bf16): {ms:.3f} ms/batch = {B_SERVE / ms * 1e3:.1f} img/s; peak "
        f"allocated {peak / 2**30:.3f} GiB [{card}] (it runs neither K5 "
        f"nor K6)")

    timing = {}
    rng = np.random.default_rng(1)
    pred_np = synthetic_decode(rng, B_SERVE, 25200, 6, 0.01)
    planes = nms_fused.nms_planes(torch.from_numpy(pred_np).to(dev), 0.25)
    n_cand = float((planes[4] > 0).sum(1).float().mean())
    got = nms_fused.greedy_select(*planes, 300, 0.45)
    if not torch.equal(got, nms_fused.greedy_select_plain(*planes, 300, 0.45)):
        raise AssertionError(f"K1 on the sparse decode ({B_SERVE}, 25200) "
                             f"differs from plain")
    picks = float((got[..., 4] > 0).sum(1).float().mean())
    p, k = in_turns(
        (lambda: nms_fused.greedy_select_plain(*planes, 300, 0.45), 2),
        (lambda: nms_fused.greedy_select(*planes, 300, 0.45), 20))
    bound = tm.nms_fused_bound(B_SERVE, 25200, 300, n_cand, picks)
    timing["nms_fused"] = (k, p, bound, None)
    if nms_fused.last_paths.tolist() != [nms_fused.PATH_ORDERED] * B_SERVE:
        raise AssertionError("K1 on the sparse decode left the ordered walk")
    log(5, f"K1 nms_fused ({B_SERVE}, 25200) planes, {n_cand:.0f} "
        f"candidates and {picks:.0f} picks per image, max_det 300: kernel "
        f"{k:.3f} ms, plain {p:.3f} ms, bound {bound[0]:.4f} ms ({bound[1]}), "
        f"no single PyTorch call; identical to plain, every image on the "
        f"ordered walk [{card}]")

    # random weights and the sparse decode give K1 few, scattered
    # candidates; a trained model's crowd around its objects
    dplanes = nms_fused.nms_planes(torch.from_numpy(dense_decode(
        np.random.default_rng(2), B_SERVE, 25200, 6, 3000, 100)).to(dev), 0.25)
    got = nms_fused.greedy_select(*dplanes, 300, 0.45)
    ref = nms_fused.greedy_select_plain(*dplanes, 300, 0.45)
    torch.cuda.synchronize()
    if not torch.equal(got, ref) or \
            nms_fused.last_paths.tolist() != [nms_fused.PATH_ORDERED] * B_SERVE:
        raise AssertionError(f"K1 on the dense decode ({B_SERVE}, 25200) "
                             f"differs from plain or left the ordered walk")
    dcand = float((dplanes[4] > 0).sum(1).float().mean())
    dpicks = float((got[..., 4] > 0).sum(1).float().mean())
    dp, dk = in_turns(
        (lambda: nms_fused.greedy_select_plain(*dplanes, 300, 0.45), 1),
        (lambda: nms_fused.greedy_select(*dplanes, 300, 0.45), 20))
    dbound = tm.nms_fused_bound(B_SERVE, 25200, 300, dcand, dpicks)
    extras["nms_fused"] = {"dense_ms": dk, "dense_plain_ms": dp,
                           "dense_bound_ms": dbound[0],
                           "dense_candidates": dcand, "dense_picks": dpicks}
    log(5, f"K1 nms_fused ({B_SERVE}, 25200) dense decode, {dcand:.0f} "
        f"candidates around 100 objects and {dpicks:.0f} picks per image, "
        f"max_det 300: identical to plain; kernel {dk:.3f} ms, plain "
        f"{dp:.3f} ms, bound {dbound[0]:.4f} ms ({dbound[1]}) [{card}]")

    logits = torch.from_numpy(rng.normal(0, 1, (B_SERVE, 80, 80, 3)).astype(
        np.float32)).to(dev, torch.bfloat16)
    taps = (*seg_pallas.seg_taps(80, 640, True, dev),
            *seg_pallas.seg_taps(80, 640, True, dev))
    nchw = logits.permute(0, 3, 1, 2)

    def library():
        return torch.nn.functional.interpolate(
            nchw, scale_factor=8, mode="bilinear",
            align_corners=True).argmax(1)

    got = seg_pallas.upsample_argmax(logits, 8, True)
    if seg_pallas.last_variant != "span":
        raise AssertionError("K2 at the served shape did not take the span "
                             "kernel")
    if not torch.equal(got, seg_pallas.upsample_argmax_plain(logits, *taps)):
        raise AssertionError(f"K2 at the served shape ({B_SERVE}, 80, 80, 3) "
                             f"bf16 differs from plain")
    p, k, px, lib = in_turns(
        (lambda: seg_pallas.upsample_argmax_plain(logits, *taps), 3),
        (lambda: seg_pallas.upsample_argmax(logits, 8, True), 20),
        (lambda: seg_pallas.upsample_argmax_with(logits, "pixel", 8, True), 20),
        (library, 10))
    bound = tm.seg_tail_bound(B_SERVE, 80, 80, 3, 8)
    timing["seg_tail"] = (k, p, bound, lib)
    extras["seg_tail"] = {"pixel_ms": px}
    out_bytes = B_SERVE * IMGSZ * IMGSZ
    log(5, f"K2 seg_tail ({B_SERVE}, 80, 80, 3) bf16 -> ({B_SERVE}, 640, 640) "
        f"uint8: identical to plain; span kernel {k:.3f} ms ({out_bytes / k / 1e9:.3f} TB/s of "
        f"stores), pixel kernel {px:.3f} ms, plain {p:.3f} ms, interpolate + "
        f"argmax {lib:.3f} ms, bound {bound[0]:.4f} ms ({bound[1]}) [{card}]")
    return timing


def phase5_val(model, spec, validator, batch, card: str, timing: dict,
               errs: dict, extras: dict):
    from desenet_tpu_torch.eval.validator import _to_input
    from desenet_tpu_torch.ops import nms_pallas
    from desenet_tpu_torch.ops.nms import MAX_WH, PRE_TOPK_VAL, _prep_candidates
    from desenet_tpu_torch.testing import dense_sorted_candidates

    dev = torch.device("cuda")
    img = torch.from_numpy(batch["image"]).to(dev)
    tgts = torch.from_numpy(batch["det_targets"]).to(dev)
    tmask = torch.from_numpy(batch["det_mask"]).to(dev)

    def step(fused: bool):
        model.seg_head_fused = fused
        return validator.eval_step(img, tgts, tmask)

    off, on = in_turns((lambda: step(False), 5), (lambda: step(True), 5))
    model.seg_head_fused = False
    log(5, f"val device step b{B_VAL}/{IMGSZ} bf16 (uint8 in, forward, "
        f"multi-label top-{PRE_TOPK_VAL} + K3 NMS, seg argmax): module seg "
        f"head {off:.3f} ms/batch, fused head (K4) {on:.3f} ms/batch "
        f"[{card}]")

    head = model.model[spec.seg_layer]
    seen = []
    hook = head.register_forward_pre_hook(lambda m, args: seen.append(args[0]))
    try:
        with torch.inference_mode():
            (dec, _), _ = model(_to_input(img, torch.bfloat16, dev))
    finally:
        hook.remove()
    with torch.inference_mode():
        boxes, scores, cls = _prep_candidates(dec.float(), 0.001,
                                              PRE_TOPK_VAL, True)
        boxes = (boxes + cls[..., None] * float(MAX_WH)).contiguous()
        scores = scores.contiguous()
    live = float((scores > 0).sum(1).float().mean())
    # the top set is sorted, so equal scores sit side by side
    ties = int(((scores[:, 1:] == scores[:, :-1]) & (scores[:, 1:] > 0)).sum())
    idx, sc = nms_pallas.greedy_nms_pallas(boxes, scores, 0.6, 300)
    ridx, rsc = nms_pallas.greedy_nms_plain(boxes, scores, 0.6, 300)
    torch.cuda.synchronize()
    if not torch.equal(idx, ridx) or not torch.equal(sc, rsc):
        raise AssertionError(
            f"K3 on the val decode ({B_VAL}, {boxes.shape[1]}): kernel "
            f"keep-set differs from plain in {int((idx != ridx).sum())} of "
            f"{idx.numel()} rows")
    err = float((sc - rsc).abs().max())
    errs["nms_greedy"] = max(errs.get("nms_greedy", 0.0), err)
    picks = float((sc > 0).sum(1).float().mean())
    paths = nms_pallas.last_paths.tolist()
    if paths != [nms_pallas.PATH_ORDERED] * B_VAL:
        raise AssertionError(f"K3 on the val decode: paths {paths}; the "
                             f"top-k's order should give the ordered walk")
    p, k = in_turns(
        (lambda: nms_pallas.greedy_nms_plain(boxes, scores, 0.6, 300), 1),
        (lambda: nms_pallas.greedy_nms_pallas(boxes, scores, 0.6, 300), 10))
    bound = tm.nms_greedy_bound(B_VAL, boxes.shape[1], 300, live, picks)
    timing["nms_greedy"] = (k, p, bound, None)
    log(5, f"K3 nms_greedy ({B_VAL}, {boxes.shape[1]}) from the val decode, "
        f"{live:.0f} live candidates ({ties} equal to their neighbour in "
        f"the batch) and {picks:.0f} picks per image, max_det 300, IoU 0.6: "
        f"identical to plain (max abs err {err}); kernel {k:.3f} ms, plain "
        f"{p:.3f} ms, bound {bound[0]:.4f} ms ({bound[1]}; the picks of an "
        f"image are a chain of dependent steps), no single PyTorch call; "
        f"every image on the ordered walk [{card}]")

    # random weights make the val decode an easy set (few overlaps: the walk
    # ends early); a trained model's is dense: the whole prefix is walked
    k_top = boxes.shape[1]
    dboxes, dscores = (t.to(dev) for t in dense_sorted_candidates(
        np.random.default_rng(5), B_VAL, k_top, 7200, 150))
    idx, sc = nms_pallas.greedy_nms_pallas(dboxes, dscores, 0.6, 300)
    ridx, rsc = nms_pallas.greedy_nms_plain(dboxes, dscores, 0.6, 300)
    torch.cuda.synchronize()
    if not torch.equal(idx, ridx) or not torch.equal(sc, rsc) or \
            nms_pallas.last_paths.tolist() != [nms_pallas.PATH_ORDERED] * B_VAL:
        raise AssertionError(f"K3 on the dense sorted set ({B_VAL}, {k_top}) "
                             f"differs from plain or left the ordered walk")
    dpicks = float((sc > 0).sum(1).float().mean())
    dp, dk = in_turns(
        (lambda: nms_pallas.greedy_nms_plain(dboxes, dscores, 0.6, 300), 1),
        (lambda: nms_pallas.greedy_nms_pallas(dboxes, dscores, 0.6, 300), 10))
    dbound = tm.nms_greedy_bound(B_VAL, k_top, 300, 7200, dpicks)
    extras["nms_greedy"] = {"dense_ms": dk, "dense_plain_ms": dp,
                            "dense_bound_ms": dbound[0],
                            "dense_picks": dpicks}
    log(5, f"K3 nms_greedy ({B_VAL}, {k_top}) dense sorted set, 7200 live "
        f"around 150 clusters, {dpicks:.0f} picks per image, max_det 300, "
        f"IoU 0.6: identical to plain; kernel {dk:.3f} ms, plain {dp:.3f} "
        f"ms, bound {dbound[0]:.4f} ms ({dbound[1]}) [{card}]")

    # K4 on the seg head's inputs of that forward (channels_last NCHW)
    timing["seg_head_psp2"] = k4_on_inputs(head, seen[0], spec.se_nc, card,
                                           errs, 5, "yolov5s_seg")


def epilogue_calls(pred, x) -> dict:
    """The fused epilogue's calls in one forward of the fused Predictor
    ``pred`` on the uint8 batch ``x``, by (shape, act, residual)."""
    from desenet_tpu_torch.ops import conv_epilogue as CE

    calls = {}
    run = CE.conv_epilogue

    def record(y, scale, shift, act, residual=None):
        key = (tuple(y.shape), bool(act), residual is not None)
        calls[key] = calls.get(key, 0) + 1
        return run(y, scale, shift, act, residual)

    CE.conv_epilogue = record  # ConvBnAct calls it through the module
    try:
        pred.infer(x)
        torch.cuda.synchronize()
    finally:
        CE.conv_epilogue = run
    return calls


def phase5_epilogue(pred, card: str, errs: dict, timing: dict,
                    extras: dict) -> None:
    """The fused conv epilogue (csrc/conv_epilogue.cu) at every shape the
    served forwards of s (``pred``, b128/640) and x6 (b32/1280) hand it,
    bf16, with and without the SiLU and the shortcut as served: against
    its plain version to 1 ulp (testing.check_epilogue), then timed in
    turns beside the plain version, PyTorch's eval BN + SiLU (+ add) and
    the bound, summed over the forward's calls."""
    import torch.nn.functional as F

    from desenet_tpu_torch.api import Predictor
    from desenet_tpu_torch.models import build_model, config_path, init_weights
    from desenet_tpu_torch.ops import conv_epilogue as CE
    from desenet_tpu_torch.testing import check_epilogue

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(4)
    served = {"s": epilogue_calls(pred, torch.randint(
        0, 256, (B_SERVE, IMGSZ, IMGSZ, 3), dtype=torch.uint8, device=dev,
        generator=g))}
    model, _ = build_model(config_path("yolov5x6_seg"))
    sd = init_weights(model, torch.Generator().manual_seed(0)).state_dict()
    del model
    x6 = Predictor("yolov5x6_seg", sd, imgsz=1280, half=True, device="cuda")
    served["x6"] = epilogue_calls(x6, torch.randint(
        0, 256, (32, 1280, 1280, 3), dtype=torch.uint8, device=dev,
        generator=g))
    del x6, sd
    torch.cuda.empty_cache()
    totals = {}
    for what, calls in served.items():
        k_sum = p_sum = l_sum = b_sum = 0.0
        for (shape, act, res), n in sorted(calls.items(), key=lambda kv: (
                -np.prod(kv[0][0]), kv[0][1:])):
            c = shape[1]
            gg = torch.Generator(device=dev).manual_seed(5)
            y = (torch.randn(shape, device=dev, generator=gg) * 2).to(
                torch.bfloat16).contiguous(memory_format=torch.channels_last)
            r = torch.randn(shape, device=dev, generator=gg).to(
                torch.bfloat16).contiguous(
                    memory_format=torch.channels_last) if res else None
            scale = torch.rand(c, device=dev, generator=gg) + 0.5
            shift = torch.randn(c, device=dev, generator=gg) * 0.3
            zero, one = torch.zeros(c, device=dev), torch.ones(c, device=dev)
            with torch.inference_mode():
                before = CE.launches
                got = CE.conv_epilogue(y.clone(), scale, shift, act, r)
                torch.cuda.synchronize()
                if CE.launches != before + 1:
                    raise AssertionError(f"epilogue {what} {shape}: no "
                                         "launch")
                err = check_epilogue(got, y, scale, shift, act, r,
                                     f"conv_epilogue {what} {shape}")
                errs["conv_epilogue"] = max(errs.get("conv_epilogue", 0.0),
                                            err)
                del got
                yy = y.clone()

                def library():  # eval BN (about y * scale + shift),
                    # SiLU (+ add): the ops the epilogue replaces
                    t = F.batch_norm(y, zero, one, scale, shift, False, 0.0,
                                     1e-3)
                    t = F.silu(t, inplace=True) if act else t
                    return t.add_(r) if res else t

                pms, kms, lms = in_turns(
                    (lambda: CE.conv_epilogue_plain(y, scale, shift, act, r),
                     2),
                    (lambda: CE.conv_epilogue(yy, scale, shift, act, r), 10),
                    (library, 5))
            bound = tm.epilogue_bound(y.numel(), c, act, res)
            del y, yy, r
            torch.cuda.empty_cache()
            k_sum += n * kms
            p_sum += n * pms
            l_sum += n * lms
            b_sum += n * bound[0]
            log("5e", f"epilogue {what} {shape} bf16, act {act}, shortcut "
                f"{res}, {n} calls a forward: 1 ulp of plain (max abs err "
                f"{err:.6g}); kernel {kms:.4f} ms, plain {pms:.4f} ms, eval "
                f"BN + SiLU{' + add' if res else ''} {lms:.4f} ms, bound "
                f"{bound[0]:.4f} ms ({bound[1]}), "
                f"{100 * bound[0] / kms:.1f}% of it [{card}]")
        totals[what] = (k_sum, p_sum, l_sum, b_sum, sum(calls.values()))
        log("5e", f"epilogue over one {what} forward ({sum(calls.values())} "
            f"calls, {len(calls)} shapes): kernel {k_sum:.3f} ms, plain "
            f"{p_sum:.3f} ms, eval BN + SiLU (+ add) {l_sum:.3f} ms, bound "
            f"{b_sum:.3f} ms, {100 * b_sum / k_sum:.1f}% of it [{card}]")
    k, p, lib, bound, _ = totals["s"]
    timing["conv_epilogue"] = (k, p, (bound, "bytes"), lib)
    k6, p6, lib6, b6, n6 = totals["x6"]
    extras["conv_epilogue"] = {"x6_ms": k6, "x6_plain_ms": p6,
                               "x6_library_ms": lib6, "x6_bound_ms": b6,
                               "x6_calls": n6, "s_calls": totals["s"][4]}


def phase5s(card: str, extras: dict) -> None:
    """The served stem at ``SERVED_STEMS``' shapes (module docstring, 5s):
    a seeded bf16 FusedFocus after ``fuse_epilogue``, on a seeded uint8
    batch, as row 0 runs in the served program and as it ran before."""
    from desenet_tpu_torch.models.layers import FusedFocus
    from desenet_tpu_torch.ops import stem_pallas as S
    from desenet_tpu_torch.testing import BF16_BAR, randomize_bn
    from desenet_tpu_torch.tools.timing import kernel_table

    dev = torch.device("cuda")
    served = {}
    for name, b, side, co in SERVED_STEMS:
        torch.manual_seed(co)
        m = randomize_bn(FusedFocus(3, co), seed=co).to(
            dev, torch.bfloat16, memory_format=torch.channels_last).eval()
        m.fuse_epilogue()
        g = torch.Generator(device=dev).manual_seed(side + co)
        x = torch.randint(0, 256, (b, side, side, 3), dtype=torch.uint8,
                          device=dev, generator=g)
        xv = x.permute(0, 3, 1, 2)

        def parent():  # infer's widen, then row 0 on the widened batch
            return m(xv.to(torch.bfloat16).contiguous(
                memory_format=torch.channels_last) / 255)

        def stem():
            return m(xv)

        with torch.inference_mode():
            before = S.served_launches
            got = stem()
            torch.cuda.synchronize()
            if S.served_launches != before + 1:
                raise AssertionError(f"served stem {name}: no launch")
            scale, shift = m._derived["epilogue"]
            err = check_bf16(got.permute(0, 2, 3, 1), S.served_stem_plain(
                x, m._derived["stem"], scale, shift), f"served stem {name} "
                "vs plain", BF16_BAR)
            perr = check_bf16(got, parent(), f"served stem {name} vs the "
                              "parent's path", BF16_MODULE_BAR)
            del got
            rows = {k: kernel_table(fn, dev)
                    for k, fn in (("parent", parent), ("served", stem))}
            pms, sms = in_turns((parent, 5), (stem, 10))
        bound, by = tm.served_stem_bound(b, side, side, co)
        served[name] = {"ms": sms, "parent_ms": pms, "bound_ms": bound,
                        "bound_pct": 100 * bound / sms, "max_abs_err": err}
        for k, r in rows.items():
            log("5s", f"{name} {k} path's device rows a call: " + "; ".join(
                f"{n[:72]} {ms:.3f} ms x{calls:g}" for n, ms, calls in r))
        log("5s", f"served stem {name} ({b}, {side}, {side}, 3) uint8 -> "
            f"{co} bf16: max abs err vs plain {err:.6g}, vs the parent's "
            f"path {perr:.6g}; kernel {sms:.4f} ms, the parent's path "
            f"{pms:.4f} ms, bound {bound:.4f} ms ({by}), "
            f"{100 * bound / sms:.1f}% of it [{card}]")
        del m, x, xv
        torch.cuda.empty_cache()
    extras.setdefault("stem_conv", {})["served"] = served


def phase4m(card: str, errs: dict, timing: dict, extras: dict) -> dict:
    """The Segment model on its served path (module docstring, 4m):
    yolov5x_v7seg in a bf16 card Predictor on one b128 batch of the
    benchmark's cell, the launch counters reset just before ``run_batch``
    and each required; that run's masks against the plain assembly on the
    decode and prototypes its forward gave (a forward hook), and its
    anchors against the decode rows of the boxes it served; then Proto's
    phase path against the upsample and 3x3 conv on that forward's P3 map
    (a forward pre-hook), the phase kernel and Proto timed."""
    import torch.nn.functional as F

    from benchmark.harness.frames import letterbox_rgb, make_frames
    from benchmark.harness.weights_v7seg import seeded_weights
    from desenet_tpu_torch.api import Predictor
    from desenet_tpu_torch.models.heads import Proto
    from desenet_tpu_torch.ops import (conv_epilogue, mask_assembly, nms_fused,
                                       stem_pallas)
    from desenet_tpu_torch.ops.boxes import xywh2xyxy
    from desenet_tpu_torch.testing import check_masks

    dev = torch.device("cuda")
    with open(V7SEG_CONF) as fh:
        conf = json.load(fh)
    size = conf["imgsz"]
    sd = seeded_weights(conf, V7SEG_SEED, dev)
    pred = Predictor(conf["model"], sd, imgsz=size, half=True, device="cuda")
    nc = pred.spec.de_nc
    batch = letterbox_rgb(make_frames(B_SERVE, size * 3 // 4, size,
                                      V7SEG_SEED + 2, dev).cpu().numpy(),
                          size)
    seen, p3 = [], []
    model = pred._replicas[0][1]
    m = next(mod for mod in model.modules() if isinstance(mod, Proto))
    hooks = (model.register_forward_hook(
        lambda mod, i, o: seen.append((o[0][0], o[1]))),
        m.register_forward_pre_hook(lambda mod, i: p3.append(i[0])))
    nms_fused.launches = 0
    conv_epilogue.launches = 0
    conv_epilogue.phase_launches = 0
    stem_pallas.served_launches = 0
    mask_assembly.launches = 0
    try:
        t = time.perf_counter()
        boxes, scores, classes, num, bits, anchors = pred.run_batch(batch)
        first_s = time.perf_counter() - t
    finally:
        for h in hooks:
            h.remove()
    launched = {"nms_fused": nms_fused.launches,
                "conv_epilogue": conv_epilogue.launches,
                "conv_epilogue_phases": conv_epilogue.phase_launches,
                "served_stem": stem_pallas.served_launches,
                "mask_assembly": mask_assembly.launches}
    if min(launched.values()) < 1:
        raise AssertionError(f"the Segment model's main path did not launch "
                             f"every kernel: {launched}")
    (dec, proto), = seen
    idx, bx, n = (torch.from_numpy(a).to(dev) for a in (anchors, boxes, num))
    valid = torch.arange(bx.shape[1], device=dev)[None] < n[:, None]
    rows = dec.gather(1, idx.long().clamp(min=0)[..., None].expand(
        -1, -1, dec.shape[2]))
    best, cls = (rows[..., 5:5 + nc] * rows[..., 4:5]).max(-1)
    box_err = float((xywh2xyxy(rows[..., :4]) - bx).abs().amax(-1)[valid]
                    .max())
    score_err = float((best - torch.from_numpy(scores).to(dev)).abs()[valid]
                      .max())
    if (box_err > 0.05 or score_err > 1e-6 or not bool(
            (cls.float() == torch.from_numpy(classes).to(dev))[valid].all())):
        raise AssertionError(f"the served anchors are not the rows of the "
                             f"served boxes: box {box_err}, score "
                             f"{score_err}")
    with torch.inference_mode():
        want = mask_assembly.assemble_masks_plain(dec, idx, bx, n, proto, nc,
                                                  (size, size))
    flips, worst = check_masks(torch.from_numpy(bits), want, dec, idx, n,
                               proto, nc)
    errs["mask_assembly"] = max(errs.get("mask_assembly", 0.0), worst)
    log("4m", f"yolov5x_v7seg bf16 b{B_SERVE} at {size} (the cell's seed "
        f"{V7SEG_SEED} weights and frames): run_batch {first_s:.2f} s (first "
        f"call), {float(n.float().mean()):.1f} boxes an image, launches "
        f"{launched}; anchors are the served rows (box {box_err:.3g} px, "
        f"score {score_err:.3g}); masks equal to the plain assembly on the "
        f"run's own decode and prototypes but {flips} of {want.numel() * 8} "
        f"bits (the widest at {worst:.3g} of |c.P|'s median) [{card}]")
    del seen, dec, proto, rows, want
    torch.cuda.empty_cache()

    x, = p3
    k = m.cv2._derived["phases"]
    with torch.inference_mode():
        got = m(x)
        want = m.cv3(m.cv2(F.interpolate(m.cv1(x), scale_factor=2,
                                         mode="nearest")))
        err = check_bf16(got, want, "the phased Proto on the served P3 map")
        errs["conv_epilogue_phases"] = err
        del got, want
        y = F.conv2d(m.cv1(x), k, padding=1)
        scale, shift = m.cv2._derived["epilogue"]
        ms, plain = in_turns(
            (lambda: conv_epilogue.conv_epilogue_phases(y, scale, shift), 20),
            (lambda: conv_epilogue.conv_epilogue_phases_plain(y, scale,
                                                              shift), 2))

        def unphased():
            m.cv2._derived.pop("phases", None)
            return m(x)

        def phased():
            m.cv2._derived["phases"] = k
            return m(x)

        new_ms, old_ms = in_turns((phased, 5), (unphased, 5))
        m.cv2._derived["phases"] = k
    b, c_, h, w = x.shape[0], m.cv2.conv.out_channels, x.shape[2], x.shape[3]
    bound = tm.epilogue_phases_bound(b, h, w, c_)
    timing["conv_epilogue_phases"] = (ms, plain, bound, None)
    extras["conv_epilogue_phases"] = {"source": f"{CSRC}/conv_epilogue.cu",
                                      "proto_ms": new_ms,
                                      "proto_unphased_ms": old_ms}
    log("4m", f"Proto's phase path on the run's own P3 map {tuple(x.shape)}: "
        f"against the upsample and 3x3 conv max abs err {err:.4g} "
        f"(check_bf16); the phase kernel on {tuple(y.shape)} {ms:.4f} ms, "
        f"plain {plain:.3f} ms, bound {bound[0]:.4f} ms ({bound[1]}), "
        f"{100 * bound[0] / ms:.1f}% of it; Proto {new_ms:.3f} ms, with the "
        f"upsample and 3x3 conv {old_ms:.3f} ms [{card}]")
    del pred, model, m, x, y, p3
    torch.cuda.empty_cache()
    return launched


def phase5m(card: str, errs: dict, timing: dict) -> None:
    """The mask assembly (csrc/mask_assembly.cu) on ``testing.MASK_CASES``
    in bf16 and f32 against its plain version (bits equal but where |c . P|
    is under 1e-3 of its median, ``testing.check_masks``), then timed at
    the served cell's shape (b128 at 640, about 100 boxes an image, bf16
    NHWC prototypes) beside the plain version on the card and its bound."""
    from desenet_tpu_torch.ops import mask_assembly as M
    from desenet_tpu_torch.testing import (MASK_CASES, check_masks,
                                           mask_assembly_case)

    dev = torch.device("cuda")
    for case in MASK_CASES:
        for dtype in (torch.bfloat16, torch.float32):
            dec, idx, boxes, num, proto, nc, hw = mask_assembly_case(
                case, dtype=dtype)
            want = M.assemble_masks_plain(dec, idx, boxes, num, proto, nc, hw)
            args = [t.to(dev) for t in (dec, idx, boxes, num)]
            pc = proto.to(dev).contiguous(memory_format=torch.channels_last)
            got = M.assemble_masks(*args, pc, nc, hw)
            flips, worst = check_masks(got, want, dec, idx, num, proto, nc)
            errs["mask_assembly"] = max(errs.get("mask_assembly", 0.0),
                                        worst)
            log("5m", f"mask assembly {case} {dtype}: bits equal to plain "
                f"but {flips} of {want.numel() * 8} (the widest at "
                f"{worst:.3g} of |c.P|'s median, under 1e-3)")
    b, _, _, img, max_det = MASK_CASES[-1]
    crop_px = 0
    for i in range(b):
        n = int(num[i])
        box = boxes[i, :n] / 4
        w = (box[:, 2].ceil().clamp(0, img // 4)
             - box[:, 0].ceil().clamp(0, img // 4)).clamp(min=0)
        h = (box[:, 3].ceil().clamp(0, img // 4)
             - box[:, 1].ceil().clamp(0, img // 4)).clamp(min=0)
        crop_px += float((w * h).sum())
    kept = float(num.sum())
    # the same boxes in bf16 (the case draws them before the cast)
    dec, idx, boxes, num, proto, nc, hw = mask_assembly_case(MASK_CASES[-1])
    args = [t.to(dev) for t in (dec, idx, boxes, num)]
    pc = proto.to(dev).contiguous(memory_format=torch.channels_last)
    with torch.inference_mode():
        ms, plain = in_turns(
            (lambda: M.assemble_masks(*args, pc, nc, hw), 20),
            (lambda: M.assemble_masks_plain(*args, pc, nc, hw), 2))
    bound = tm.mask_assembly_bound(b, img // 4, img // 4, 32, max_det, kept,
                                   crop_px)
    timing["mask_assembly"] = (ms, plain, bound, None)
    log("5m", f"mask assembly b{b} at {img} bf16, {kept / b:.1f} boxes an "
        f"image, {crop_px / b:.0f} crop pixels an image: kernel {ms:.4f} ms, "
        f"plain (torch ops on the card) {plain:.3f} ms, bound "
        f"{bound[0]:.4f} ms ({bound[1]}), {100 * bound[0] / ms:.1f}% of it "
        f"[{card}]")
    del dec, args, pc, proto
    torch.cuda.empty_cache()


def k4_on_inputs(head, nchw, n: int, card: str, errs: dict, phase,
                 what: str) -> tuple:
    """K4 on a SegMaskPSP2 head's inputs ``nchw`` (a bf16 forward's),
    held against its plain version (``check_psp2``) and the cuDNN module
    head (the JAX package's bf16 bar, tests/test_seg_head_pallas.py), then
    timed beside both; returns (ms, plain ms, bound, module ms)."""
    from desenet_tpu_torch.ops import seg_head_pallas
    from desenet_tpu_torch.testing import check_psp2

    xs = [x.permute(0, 2, 3, 1).contiguous() for x in nchw]
    b, h8, w8, _ = xs[0].shape
    head.upsample = False
    try:
        with torch.inference_mode(), no_tf32():
            got = seg_head_pallas.fused_psp2_eval(xs, head, n)
            ref = seg_head_pallas.fused_psp2_eval_plain(xs, head, n)
            mod = head(nchw).permute(0, 2, 3, 1).float()
        torch.cuda.synchronize()
        err, agree = check_psp2(got, ref, torch.bfloat16)
        errs["seg_head_psp2"] = max(errs.get("seg_head_psp2", 0.0), err)
        torch.testing.assert_close(got, mod, rtol=0.1, atol=0.15)
        mod_err = float((got - mod).abs().max())
        mod_agree = float((got.argmax(-1) == mod.argmax(-1)).float().mean())
        if mod_agree <= 0.99:
            raise AssertionError(f"K4 vs the module head ({what}): argmax "
                                 f"agreement {mod_agree}")
        log(phase, f"K4 seg_head_psp2 {what} ({b}, {h8}, {w8}) bf16 on the "
            f"val forward's features: against plain max abs err {err:.6g} "
            f"(|plain| max {float(ref.abs().max()):.6g}, bound 1e-2 of it), "
            f"argmax agreement {agree:.6f}; against the cuDNN module head "
            f"max abs err {mod_err:.6g} (rtol 0.1, atol 0.15), argmax "
            f"agreement {mod_agree:.6f} (> 0.99)")
        with torch.inference_mode():
            p, k = in_turns(
                (lambda: seg_head_pallas.fused_psp2_eval_plain(xs, head, n),
                 3),
                (lambda: seg_head_pallas.fused_psp2_eval(xs, head, n), 10))
            cudnn, k2 = in_turns(
                (lambda: head(nchw), 10),
                (lambda: seg_head_pallas.fused_psp2_eval(xs, head, n), 10))
    finally:
        head.upsample = True
    c_hid = xs[0].shape[3] // 2
    bound = tm.psp2_bound(b, h8, w8, [x.shape[3] for x in xs], c_hid, n)
    log(phase, f"K4 seg_head_psp2 {what} ({b}, {h8}, {w8}) bf16, inputs "
        f"{[x.shape[3] for x in xs]}, c_hid {c_hid}: kernel {k:.3f} ms, "
        f"plain {p:.3f} ms; against the cuDNN module head in one call: "
        f"kernel {k2:.3f} ms, module {cudnn:.3f} ms; bound {bound[0]:.4f} "
        f"ms ({bound[1]}) [{card}]")
    return k, p, bound, cudnn


def kernel_entry(name, replaces, launches, errs, timing, extras=None):
    ms, plain_ms, (bound, bound_by), library_ms = timing[name]
    return {"name": name, "route": "cuda", "source": f"{CSRC}/{name}.cu",
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": errs[name], "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound, "bound_by": bound_by,
            "library_ms": library_ms, **(extras or {}).get(name, {})}


def phase6(pred, card: str, timing: dict, errs: dict) -> dict:
    from desenet_tpu_torch.models.layers import C3, FusedFocus
    from desenet_tpu_torch.ops import c3_fused, stem_pallas
    from desenet_tpu_torch.testing import BF16_MODULE_BAR, C3_SERVED
    from desenet_tpu_torch.tools import probe_stem_pallas, proto_c3_kernel
    from desenet_tpu_torch.utils.fold import fold_c3, fold_focus

    # the slice's main path: its two entry points, as a user runs them
    stem_pallas.launches = 0
    c3_fused.launches = 0
    t = time.perf_counter()
    dev = pred.device
    argv = ["--device", dev.type, "--batch", str(B_SERVE), "--imgsz",
            str(IMGSZ)]
    for tool in (probe_stem_pallas, proto_c3_kernel):
        if tool.main(argv) != 0:
            raise AssertionError(f"{tool.__name__} failed")
    launches = {"stem_conv": stem_pallas.launches,
                "c3_fused": c3_fused.launches}
    if min(launches.values()) < 1:
        raise AssertionError(f"the entry points did not launch K5 and K6: "
                             f"{launches}")
    log(6, f"entry points probe_stem_pallas and proto_c3_kernel (f32 and "
        f"bf16 parity, b{B_SERVE}/{IMGSZ} bf16 timing) passed in {time.perf_counter() - t:.3f} s; kernel "
        f"launches {launches}")

    # K5 and K6 on the served forward's own tensors, beside the modules
    net = pred.model.model
    rows = [i for i, m in enumerate(net) if isinstance(m, (FusedFocus, C3))]
    seen = {}
    hooks = [net[i].register_forward_hook(
        lambda m, args, out, i=i: seen.__setitem__(i, (args[0], out)))
        for i in rows]
    g = torch.Generator(device=dev).manual_seed(3)
    try:
        pred.infer(torch.randint(0, 256, (B_SERVE, IMGSZ, IMGSZ, 3),
                                 dtype=torch.uint8, device=dev, generator=g))
    finally:
        for h in hooks:
            h.remove()
    shapes = [(i, m.cv1.conv.in_channels, m.cv3.conv.out_channels,
               m.cv1.conv.out_channels, len(m.m), m.m[0].add,
               seen[i][0].shape[2]) for i, m in enumerate(net) if i in rows[1:]]
    if rows[0] != 0 or not isinstance(net[0], FusedFocus) or \
            tuple(shapes) != C3_SERVED:
        raise AssertionError(f"served C3 rows {shapes} differ from "
                             f"testing.C3_SERVED")
    # kernel, plain, module, bound: summed over the layers
    total = {"stem_conv": [0.0] * 4, "c3_fused": [0.0] * 4}
    bound_by = {}
    for i in rows:
        inp, out = seen[i]
        if inp.dtype == torch.uint8:  # the served stem's batch, widened
            inp = inp.to(torch.bfloat16).contiguous(
                memory_format=torch.channels_last) / 255
        x = inp.permute(0, 2, 3, 1)  # NHWC view of the channels_last input
        hw = tuple(inp.shape[2:])
        m = net[i]
        if i == 0:
            name = "stem_conv"
            w6, bias = fold_focus(m, hw)
            bound = tm.stem_bound(x.shape[0], *hw, out.shape[1])
            wm = stem_pallas.stem_weight_matrix(w6, x.dtype).to(dev)
            bd = torch.from_numpy(bias).to(dev)
            kern = lambda: stem_pallas.stem_conv(x, wm, bd)  # noqa: E731
            plain = lambda: stem_pallas.stem_conv_plain(x, wm, bd)  # noqa
        else:
            name = "c3_fused"
            p = c3_fused.c3_params(fold_c3(m, hw), dev, x.dtype)
            n, sc = len(m.m), m.m[0].add
            bound = tm.c3_bound(x.shape[0], *hw, x.shape[3],
                                m.cv1.conv.out_channels, out.shape[1], n)
            kern = lambda: c3_fused.c3_fused(x, p, n, sc)  # noqa: E731
            plain = lambda: c3_fused.c3_plain(x, p, n, sc)  # noqa: E731
        with torch.inference_mode():
            got, ref = kern(), plain()
            torch.cuda.synchronize()
            took = c3_fused.last_variant if i else stem_pallas.last_variant
            if took != "mma":
                raise AssertionError(f"served row {i} took the {took} "
                                     "kernel, not the tensor-core one")
            err = check_bf16(got, ref, f"{name} row {i} vs plain")
            mod_err = check_bf16(got, out.permute(0, 2, 3, 1),
                                 f"{name} row {i} vs the module",
                                 BF16_MODULE_BAR)
            del got, ref
            errs[name] = max(errs.get(name, 0.0), err)
            pms, kms, mms = in_turns((plain, 1), (kern, 5),
                                           (lambda: m(inp), 5))
        for j, v in enumerate((kms, pms, mms, bound[0])):
            total[name][j] += v
        bound_by.setdefault(name, []).append(bound[1])
        log(6, f"row {i} {type(m).__name__} {tuple(x.shape)} -> "
            f"{out.shape[1]} bf16 on the served forward: max abs err "
            f"vs plain {err:.6g}, vs the module {mod_err:.6g} (|module| max "
            f"{float(out.float().abs().max()):.6g}); kernel {kms:.3f} ms, "
            f"plain {pms:.3f} ms, module (cuDNN) {mms:.3f} ms, bound "
            f"{bound[0]:.4f} ms ({bound[1]}) [{card}]")
    for name, (k, p, mod, bound) in total.items():
        # the summed bound is bound by what binds most of its layers
        by = max(set(bound_by[name]), key=bound_by[name].count)
        timing[name] = (k, p, (bound, by), mod)
    (k5, p5, m5, b5), (k6, p6, m6, b6) = total["stem_conv"], total["c3_fused"]
    log(6, f"served forward b{B_SERVE}/{IMGSZ} bf16: at the stem K5 {k5:.3f} "
        f"ms, plain {p5:.3f} ms, module FusedFocus {m5:.3f} ms, bound {b5:.4f} "
        f"ms; over the {len(rows) - 1} C3 blocks K6 {k6:.3f} ms, plain "
        f"{p6:.3f} ms, modules {m6:.3f} ms, bound {b6:.4f} ms (per layer, "
        f"summed) [{card}]")
    return launches


def phase7(card: str) -> int:
    """The training slice; returns K3's launches in the validation of the
    EMA weights."""
    from desenet_tpu_torch.eval import Validator
    from desenet_tpu_torch.models import build_model, config_path
    from desenet_tpu_torch.ops import nms_pallas
    from desenet_tpu_torch.testing import (TRAIN_PARITY_STEPS,
                                           check_train_parity, train_parity)
    from desenet_tpu_torch.tools.profile_train_step import (device_batches,
                                                            trainer)
    from desenet_tpu_torch.utils.convert import load_state_dict

    dev = torch.device("cuda")
    # (a) the card against the CPU on the tiny model
    for dtype in (torch.float64, torch.float32):
        for fused in (True, False):
            with no_tf32():
                res = train_parity(dev, fused, dtype)
            what = (f"tiny model 64 px b2, {TRAIN_PARITY_STEPS[dtype]} SGD "
                    f"step(s), {dtype}, "
                    f"{'fused' if fused else 'materialized'} seg loss")
            check_train_parity(res, dtype, what)
            worst = {g: f"{e[0]:.3g} ({e[1]})" for g, e in res[-1].items()
                     if g != "loss"}
            loss_errs = ", ".join(f"{r['loss']:.3g}" for r in res)
            log("7a", f"{what}: CUDA against the CPU, loss rel err by step "
                f"{loss_errs}; after the last step {worst}")

    # (b) full width and depth, bf16, batch 64 at 640
    t = time.perf_counter()
    runs = {f: trainer(f, dev, B_TRAIN, IMGSZ, torch.bfloat16)
            for f in (True, False)}
    spec = runs[True][2]
    batches = device_batches(TRAIN_TIMED_STEPS, B_TRAIN, IMGSZ, spec.de_nc,
                             dev)
    log("7b", f"two yolov5s_seg trainers (seed-0 weights) and "
        f"{TRAIN_TIMED_STEPS} batches of {B_TRAIN} at {IMGSZ} (numpy, "
        f"uint8) made in {time.perf_counter() - t:.3f} s")
    peaks = {}
    for fused, (state, step, _) in runs.items():
        name = "fused" if fused else "materialized"
        resident = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        losses = []
        for _ in range(TRAIN_FIXED_STEPS):
            state, m = step(state, batches[0])
            losses.append(float(m["loss"]))
        peaks[fused] = torch.cuda.max_memory_allocated()
        if not (np.isfinite(losses).all() and losses[-1] < losses[0]
                and np.mean(losses[-3:]) < np.mean(losses[:3])):
            raise AssertionError(f"{name} seg loss: the loss did not fall "
                                 f"over {TRAIN_FIXED_STEPS} steps on one "
                                 f"batch: {losses}")
        log("7b", f"yolov5s_seg b{B_TRAIN}/{IMGSZ} bf16, {name} seg loss, "
            f"{TRAIN_FIXED_STEPS} steps on one batch: loss "
            f"{[round(v, 4) for v in losses]}; peak allocated "
            f"{peaks[fused] / 2**30:.3f} GiB ({resident / 2**30:.3f} GiB "
            f"resident before) [{card}]")

    def stepper(fused):
        state, step, _ = runs[fused]
        cycle = itertools.cycle(batches)

        def run():
            nonlocal state
            state, _ = step(state, next(cycle))
        return run

    fused_ms, mat_ms = in_turns((stepper(True), TRAIN_TIMED_STEPS),
                                (stepper(False), TRAIN_TIMED_STEPS))
    log("7b", f"train step yolov5s_seg b{B_TRAIN}/{IMGSZ} bf16 (uint8 in; "
        f"forward, losses, one backward, SGD, EMA), CUDA events over "
        f"{TRAIN_TIMED_STEPS} warm steps on distinct batches, in turns: "
        f"fused seg loss {fused_ms:.3f} ms = "
        f"{B_TRAIN / fused_ms * 1e3:.1f} img/s, peak "
        f"{peaks[True] / 2**30:.3f} GiB; materialized {mat_ms:.3f} ms = "
        f"{B_TRAIN / mat_ms * 1e3:.1f} img/s, peak "
        f"{peaks[False] / 2**30:.3f} GiB [{card}]")

    # (c) the EMA weights through the validator
    state = runs[True][0]
    del runs, batches
    model, _ = build_model(config_path("yolov5s_seg"))
    load_state_dict(model, state.ema)
    model = model.to(dev, torch.bfloat16, memory_format=torch.channels_last)
    nms_pallas.launches = 0
    t = time.perf_counter()
    res = Validator(model, nc=spec.de_nc, se_nc=spec.se_nc).run(
        val_batches(7, 1, B_VAL, IMGSZ, spec.de_nc, spec.se_nc))
    k3 = nms_pallas.launches
    summary = {k: v for k, v in res.items() if k != "per_class"}
    vals = [summary[k] for k in ("mp", "mr", "map50", "map", "miou",
                                 "pix_acc")]
    if k3 < 1 or summary["seen"] != B_VAL or not all(
            np.isfinite(v) and 0 <= v <= 1 for v in vals):
        raise AssertionError(f"validation of the EMA weights: K3 launched "
                             f"{k3} times; {summary}")
    log("7c", f"the EMA after {state.ema_updates} optimizer steps, "
        f"validated in bf16 at {IMGSZ} over one batch of {B_VAL}: "
        f"{json.dumps(summary)}; {time.perf_counter() - t:.3f} s wall; "
        f"K3 launched {k3} times")
    return k3


B_FIT_VAL = 32
FIT_BATCHES = 4
B_CLI = 16


def _state_equal(state, payload) -> list:
    """The groups where a reloaded checkpoint's payload differs bitwise from
    the live training state."""
    from desenet_tpu_torch.train.state import bn_stats

    live = {"params": state.params, "batch_stats": bn_stats(state.model),
            "ema": state.ema, "mu": state.opt_state["mu"],
            "accum_grads": {k: p.grad for k, p in state.params.items()
                            if p.grad is not None}}
    saved = {**payload, "mu": payload["opt_state"]["mu"]}
    bad = [g for g, d in live.items()
           if set(d) != set(saved[g]) or not all(
               torch.equal(v.detach().cpu(), saved[g][k])
               for k, v in d.items())]
    counters = {"ema_updates": state.ema_updates, "step": state.step,
                "last_opt_step": state.last_opt_step}
    if any(payload["counters"][k] != v for k, v in counters.items()):
        bad.append("counters")
    return bad


class EpochClock:
    """Callbacks that time each epoch's training loop (the card
    synchronized at both ends), its validation and its checkpoint saves,
    and can profile one training loop."""

    def __init__(self):
        self.loops = []  # seconds of each epoch's training loop
        self.vals = []  # seconds of each validation of the EMA
        self.saves = []  # seconds of each epoch's checkpoint writes
        self.profile_next = False
        self.busy_ms = None  # device kernel time of the profiled loop
        self._prof = None

    def on_val_start(self):
        self._v = time.perf_counter()

    def on_val_end(self):
        self.vals.append(time.perf_counter() - self._v)

    def on_fit_epoch_end(self, row):
        self._s = time.perf_counter()

    def on_model_save(self):
        self.saves.append(time.perf_counter() - self._s)

    def on_train_epoch_start(self):
        torch.cuda.synchronize()
        if self.profile_next:
            from torch.profiler import ProfilerActivity, profile

            self._prof = profile(activities=[ProfilerActivity.CPU,
                                             ProfilerActivity.CUDA])
            self._prof.start()
        self._t = time.perf_counter()

    def on_train_epoch_end(self):
        torch.cuda.synchronize()
        self.loops.append(time.perf_counter() - self._t)
        if self._prof is not None:
            from torch.autograd import DeviceType

            self._prof.stop()
            self.busy_ms = sum(
                e.self_device_time_total for e in
                self._prof.key_averages()
                if e.device_type == DeviceType.CUDA) / 1e3
            self._prof = self.profile_next = None


def phase8(card: str) -> int:
    """The training entry point; returns K3's launches in it."""
    import tempfile

    from desenet_tpu_torch.ops import nms_pallas
    from desenet_tpu_torch.tools.profile_train_step import device_batches
    from desenet_tpu_torch.train import engine
    from desenet_tpu_torch.utils import checkpoint as ckpt
    from desenet_tpu_torch.utils.callbacks import Callbacks
    from desenet_tpu_torch.utils.loggers import Loggers

    dev = torch.device("cuda")
    t = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_train_") as tmp:
        # (a) fit over batches on the card; the recipe's hyperparameters
        # and nominal batch (every step an optimizer step at b64), warmup
        # floor 0: max(round(3 epochs x 4 batches), 0) = 12 steps
        cfg = engine.TrainConfig(
            data="(in-memory batches)", epochs=2, batch_size=B_TRAIN,
            nbs=B_TRAIN, imgsz=IMGSZ, project=tmp, name="fit", use_tb=False,
            noautoanchor=True, warmup_floor=0, device="cuda")
        hyp = engine.load_hyp()
        save_dir = engine.make_run_dir(cfg, hyp)
        de_nc, se_nc = 6, 3  # yolov5s_seg.json's
        meta = {"cfg": cfg.cfg, "imgsz": IMGSZ, "de_nc": de_nc,
                "se_nc": se_nc, "de_names": [str(i) for i in range(de_nc)],
                "se_names": [str(i) for i in range(se_nc)], "hyp": hyp}
        batches = device_batches(FIT_BATCHES, B_TRAIN, IMGSZ, de_nc, dev)
        val = val_batches(11, 1, B_FIT_VAL, IMGSZ, de_nc, se_nc)
        clock = EpochClock()
        callbacks = Callbacks()
        callbacks.auto_register(Loggers(save_dir, use_tb=False))
        callbacks.auto_register(clock)

        def run(cfg, resumed=None):
            loop = engine.build_loop(cfg, hyp, de_nc, se_nc, FIT_BATCHES,
                                     IMGSZ, dev, meta, save_dir,
                                     resumed=resumed)
            res = engine.fit(cfg, loop, batches, val, save_dir, callbacks)
            return loop.state, res

        nms_pallas.launches = 0
        torch.cuda.reset_peak_memory_stats()
        state, _ = run(cfg)
        peak = torch.cuda.max_memory_allocated()
        payload = ckpt.load_checkpoint(os.path.join(save_dir, "last"))
        bad = _state_equal(state, payload)
        if bad or payload["counters"]["epoch"] != 1:
            raise AssertionError(f"checkpoint 'last' reloads unequal to the "
                                 f"live state in {bad}")
        for name in ("best", "best_stripped"):
            if not os.path.isfile(os.path.join(save_dir, name, ckpt.WEIGHTS)):
                raise AssertionError(f"no '{name}' checkpoint")
        counters = (state.step, state.ema_updates)
        del state
        clock.profile_next = True
        state, res = run(dataclasses.replace(cfg, epochs=3), payload)
        k3 = nms_pallas.launches
        with open(os.path.join(save_dir, "results.csv")) as fh:
            rows = list(csv.DictReader(fh))
        losses = [sum(float(r[f"train/{k}_loss"]) for k in
                      ("box", "obj", "cls", "seg")) for r in rows]
        metrics = [float(r[k]) for r in rows for k in r
                   if k.startswith("metrics/")]
        want = 3 * FIT_BATCHES
        if (len(rows) != 3 or [int(r["epoch"]) for r in rows] != [0, 1, 2]
                or counters != (2 * FIT_BATCHES, 2 * FIT_BATCHES)
                or (state.step, state.ema_updates) != (want, want)
                or not np.isfinite(losses).all() or not losses[2] < losses[0]
                or not all(0 <= v <= 1 for v in metrics) or k3 < 3):
            raise AssertionError(
                f"fit: rows {rows}, counters after 2 epochs {counters}, "
                f"after the resumed one {(state.step, state.ema_updates)}, "
                f"K3 launched {k3} times")
        imgs = FIT_BATCHES * B_TRAIN
        loops = ", ".join(f"{s_:.3f} s = {imgs / s_:.1f} img/s"
                          for s_ in clock.loops)
        idle = 1 - clock.busy_ms / 1e3 / clock.loops[-1]
        spans = "; ".join(f"{what} {', '.join(f'{v:.3f}' for v in vs)} s"
                          for what, vs in (("validations", clock.vals),
                                           ("checkpoint writes",
                                            clock.saves)))
        log("8a", f"engine.fit yolov5s_seg b{B_TRAIN}/{IMGSZ} bf16, "
            f"{FIT_BATCHES} batches an epoch on the card, 2 epochs, then "
            f"'last' reloaded bitwise equal and a third epoch resumed "
            f"(step and EMA updates {counters} -> "
            f"{(state.step, state.ema_updates)}): summed train losses by "
            f"epoch {[round(v, 4) for v in losses]}, fitness "
            f"{[round(float(r['val/fitness']), 4) for r in rows]}; the "
            f"training loop by epoch {loops} (epoch 2 under torch.profiler: "
            f"kernels {clock.busy_ms:.3f} ms of {clock.loops[-1] * 1e3:.3f}"
            f" ms, device idle {idle:.1%}); peak allocated "
            f"{peak / 2**30:.3f} GiB over the first two epochs; K3 launched "
            f"{k3} times in 3 validations of b{B_FIT_VAL}; by epoch "
            f"{spans}; {time.perf_counter() - t:.3f} s wall [{card}]")
        del state, batches

        # (b) the CLI end to end on a fake dataset, where PIL and cv2 are
        missing = []
        for mod in ("PIL", "cv2"):
            try:
                __import__(mod)
            except ImportError:
                missing.append(mod)
        if missing:
            log("8b", f"not run: {' and '.join(missing)} do not import on "
                "this machine (the fake dataset is written with cv2, "
                "decoded with PIL); 8(a) ran the device path")
            return k3
        k3 += phase8b(card, tmp)
    return k3


def phase8b(card: str, tmp: str) -> int:
    from desenet_tpu_torch.cli import train as cli_train
    from desenet_tpu_torch.ops import nms_pallas
    from desenet_tpu_torch.tools.make_fake_dataset import generate
    from desenet_tpu_torch.tools.profile_train_step import (device_batches,
                                                            trainer)
    from desenet_tpu_torch.utils.callbacks import Callbacks

    dev = torch.device("cuda")
    t = time.perf_counter()
    root = os.path.join(tmp, "fakeds")
    data = generate(root, n_train=32, n_val=8, size=IMGSZ, seed=0)
    made = time.perf_counter() - t
    clock = EpochClock()
    callbacks = Callbacks()
    callbacks.auto_register(clock)
    nms_pallas.launches = 0
    t = time.perf_counter()
    res = cli_train.main(
        ["--data", data, "--cfg", "yolov5s_seg", "--epochs", "1",
         "--batch-size", str(B_CLI), "--img-size", str(IMGSZ), "--project",
         os.path.join(tmp, "cli"), "--no-tb", "--device", "cuda"],
        callbacks)
    wall = time.perf_counter() - t
    k3 = nms_pallas.launches
    sd = res["save_dir"]
    with open(os.path.join(sd, "results.csv")) as fh:
        lines = fh.read().strip().splitlines()
    if (len(lines) != 2 or k3 < 1 or not os.path.isfile(
            os.path.join(sd, "best_stripped", "state.pt"))):
        raise AssertionError(f"cli.train: results.csv {lines}, K3 launched "
                             f"{k3} times")
    nb = 32 // B_CLI
    state, step, spec = trainer(True, dev, B_CLI, IMGSZ, torch.bfloat16)
    cycle = itertools.cycle(device_batches(2, B_CLI, IMGSZ, spec.de_nc, dev))

    def one():
        nonlocal state
        state, _ = step(state, next(cycle))

    step_ms = cuda_ms(one, 5)
    del state, step, cycle
    log("8b", f"cli.train.main yolov5s_seg b{B_CLI}/{IMGSZ} bf16 on a fake "
        f"dataset (32 train, 8 val at {IMGSZ}, written in {made:.3f} s), "
        f"mosaic and autoanchor on, 1 epoch: {wall:.3f} s wall in all, the "
        f"training loop {clock.loops[0]:.3f} s for {nb} batches; last line "
        f"of results.csv {lines[-1]}; K3 launched {k3} times; the device "
        f"step {step_ms:.3f} ms (CUDA events, 5 warm steps) [{card}]")
    # the host's data time on 640 px sources and on oversized 1280 px ones
    big = os.path.join(tmp, "fakeds1280")
    generate(big, n_train=32, n_val=1, size=2 * IMGSZ, seed=1)
    for src in (root, big):
        host_readings(card, os.path.join(src, "Images", "train"), step_ms)
    return k3


# the host data path's options, each timed by phase 8(b)
HOST_PATHS = (("PIL decode", {}), ("--fast-decode", {"fast_decode": True}),
              ("--cache-images ram", {"cache_images": "ram"}),
              ("--cache-images disk", {"cache_images": "disk"}))


def host_readings(card: str, split: str, step_ms: float) -> None:
    """The training loader's host time on ``split`` (mosaic, b16) with each
    of ``HOST_PATHS``, against the device step: the loader alone (one
    thread a batch, staged to the card) and the epoch's samples with every
    worker thread busy. First the native rasterizer's masks against PIL's
    and the native assembler against np.stack on a batch."""
    from concurrent.futures import ThreadPoolExecutor

    from desenet_tpu_torch import native
    from desenet_tpu_torch.data import create_mixed_dataloader, to_device
    from desenet_tpu_torch.train.engine import DEFAULT_HYP

    dev = torch.device("cuda")
    kw = dict(img_size=IMGSZ, batch_size=B_CLI, augment=True, hyp=DEFAULT_HYP)
    loader, ds = create_mixed_dataloader(split, **kw)
    pos = [int(p) for p in loader._epoch_positions()[:B_CLI]]
    got = [ds.get_sample(p) for p in pos]
    os.environ["DESENET_NATIVE_RASTER"] = "0"  # the PIL path
    try:
        want = [ds.get_sample(p) for p in pos]
    finally:
        del os.environ["DESENET_NATIVE_RASTER"]
    for g, w in zip(got, want):
        if not (np.array_equal(g[2], w[2]) and np.array_equal(g[0], w[0])):
            raise AssertionError(f"{split}: the native rasterizer's mask "
                                 "differs from PIL's")
    imgs = [g[0] for g in got]
    if not np.array_equal(native.assemble_batch(imgs), np.stack(imgs)):
        raise AssertionError("assemble_batch differs from np.stack")
    src = ds.shapes[0].astype(int).tolist()
    log("8b", f"{split} ({src[0]}x{src[1]} sources): a batch's {B_CLI} "
        f"masks (mosaics, warped polygons) from the native rasterizer equal "
        f"PIL's; assemble_batch equals np.stack")
    for name, opt in HOST_PATHS:
        if opt.get("fast_decode") and not native.jpeg_available():
            try:
                create_mixed_dataloader(split, **kw, **opt)
            except RuntimeError as e:
                log("8b", f"{name}: libjpeg was absent when the host library "
                    f"was built, and the option raised as it should ({e})")
                continue
            raise AssertionError("--fast-decode without libjpeg did not "
                                 "raise")
        t = time.perf_counter()
        loader, ds = create_mixed_dataloader(split, stage=to_device(dev),
                                             **kw, **opt)
        setup = time.perf_counter() - t
        t = time.perf_counter()
        n = sum(1 for _ in loader)
        torch.cuda.synchronize()
        data_ms = (time.perf_counter() - t) / n * 1e3
        t = time.perf_counter()
        with ThreadPoolExecutor(loader.workers) as pool:
            list(pool.map(ds.get_sample, range(len(ds))))
        rate_ms = (time.perf_counter() - t) / len(ds) * B_CLI * 1e3
        log("8b", f"host, {src[0]} px sources, {name}: set-up "
            f"{setup:.3f} s, {data_ms:.3f} ms a batch of {B_CLI} (the "
            f"loader alone, one thread a batch, staged to the card), "
            f"{rate_ms:.3f} ms per {B_CLI} samples with all "
            f"{loader.workers} worker threads busy, against the device step "
            f"{step_ms:.3f} ms: host / step {rate_ms / step_ms:.2f} [{card}]")



def phase9(card: str, errs: dict, extras: dict) -> dict:
    """The model family: m and l served and validated at full width, every
    other head, yolov5s and the exotic rows against the CPU, and the two
    stems of the s served program; returns the kernels' launches on the m
    and l main paths."""
    from desenet_tpu_torch.api import Predictor
    from desenet_tpu_torch.eval import Validator
    from desenet_tpu_torch.models import build_model, config_path, init_weights
    from desenet_tpu_torch.ops import (conv_epilogue, nms_fused, nms_pallas,
                                       seg_head_pallas, seg_pallas)
    from desenet_tpu_torch.utils.convert import load_state_dict

    dev = torch.device("cuda")
    launches = {"nms_fused": 0, "seg_tail": 0, "nms_greedy": 0,
                "seg_head_psp2": 0, "conv_epilogue": 0}
    for name in ("yolov5m_seg", "yolov5l_seg"):
        model, spec = build_model(config_path(name))
        n_params = sum(p.numel() for p in model.parameters())
        sd = init_weights(model, torch.Generator().manual_seed(0)).state_dict()
        del model
        # (a) served at b128/640 bf16, the FusedFocus stem
        pred = Predictor(name, sd, imgsz=IMGSZ, half=True, device="cuda")
        g = torch.Generator(device=dev).manual_seed(9)
        warm, x = (torch.randint(0, 256, (B_SERVE, IMGSZ, IMGSZ, 3),
                                 dtype=torch.uint8, device=dev, generator=g)
                   for _ in range(2))
        torch.cuda.reset_peak_memory_stats()
        nms_fused.launches = 0
        seg_pallas.launches = 0
        conv_epilogue.launches = 0
        for _ in range(2):
            pred.infer(warm)
        nms, seg = pred.infer(x)
        torch.cuda.synchronize()
        k1, k2 = nms_fused.launches, seg_pallas.launches
        ke = conv_epilogue.launches
        if min(k1, k2, ke) < 1:
            raise AssertionError(f"{name} served: K1 launched {k1}, K2 {k2}, "
                                 f"the epilogue {ke} times")
        launches["nms_fused"] += k1
        launches["seg_tail"] += k2
        launches["conv_epilogue"] += ke
        if seg.shape != (B_SERVE, IMGSZ, IMGSZ) or seg.dtype != torch.uint8 \
                or int(seg.max()) >= spec.se_nc or \
                not torch.isfinite(nms.boxes).all():
            raise AssertionError(f"{name} served: seg {seg.shape} "
                                 f"{seg.dtype} max {int(seg.max())}")
        ms = cuda_ms(lambda: pred.infer(x), 5)
        peak = torch.cuda.max_memory_allocated()
        log(9, f"{name} ({n_params} params) served b{B_SERVE}/{IMGSZ} bf16 "
            f"(uint8 in, FusedFocus stem, forward + K1 + K2): {ms:.3f} "
            f"ms/batch = {B_SERVE / ms * 1e3:.1f} img/s; peak allocated "
            f"{peak / 2**30:.3f} GiB; launches K1 {k1}, K2 {k2}, the "
            f"epilogue {ke} [{card}]")
        # the served program in f32 (TF32 off) on the card against the CPU,
        # two images at 320 (the CPU's time), full width and depth
        small = torch.from_numpy(np.random.default_rng(9).integers(
            0, 256, (2, 320, 320, 3), dtype=np.uint8))
        outs = {}
        with no_tf32():
            for d in ("cpu", "cuda"):
                p32 = Predictor(name, sd, imgsz=320, conf_thres=1e-3,
                                half=False, device=d)
                n32, s32 = p32.infer(small.to(d))
                outs[d] = (n32.num.cpu(), n32.boxes.cpu(), s32.cpu())
                del p32
        (nc, bc, sc), (ng, bg, sg) = outs["cpu"], outs["cuda"]
        box_err = max([match_boxes(bg[i, :n], bc[i, :n])
                       for i, n in enumerate(nc.tolist())] + [0.0])
        seg_eq = float((sc == sg).float().mean())
        if not torch.equal(nc, ng) or box_err > 1e-3 or seg_eq < 0.999:
            raise AssertionError(f"{name} f32 served CUDA vs CPU: num "
                                 f"{nc} vs {ng}, box err {box_err}, seg "
                                 f"agreement {seg_eq}")
        log(9, f"{name} f32 served program at 320 CUDA vs CPU: num "
            f"{ng.tolist()} equal, boxes within {box_err:.3g} (atol 1e-3), "
            f"seg maps {seg_eq:.6f} equal (>= 0.999)")
        del pred
        torch.cuda.empty_cache()

        # (b) the validation step at b32/640 bf16, module and fused head
        vmodel, _ = build_model(config_path(name), fuse_focus=True)
        load_state_dict(vmodel, sd)
        vmodel = vmodel.to(dev, torch.bfloat16,
                           memory_format=torch.channels_last)
        batches = val_batches(9, 1, B_VAL, IMGSZ, spec.de_nc, spec.se_nc)
        validator = Validator(vmodel, nc=spec.de_nc, se_nc=spec.se_nc)
        res = {}
        for fused in (False, True):
            vmodel.seg_head_fused = fused
            nms_pallas.launches = 0
            seg_head_pallas.launches = 0
            t = time.perf_counter()
            out = validator.run(batches)
            wall = time.perf_counter() - t
            k3, k4 = nms_pallas.launches, seg_head_pallas.launches
            if k3 < 1 or (k4 < 1 if fused else k4 != 0):
                raise AssertionError(f"{name} val (fused head {fused}): K3 "
                                     f"launched {k3}, K4 {k4} times")
            launches["nms_greedy"] += k3
            launches["seg_head_psp2"] += k4
            summary = {k: v for k, v in out.items() if k != "per_class"}
            vals = [summary[k] for k in ("mp", "mr", "map50", "map", "miou",
                                         "pix_acc")]
            if summary["seen"] != B_VAL or not all(
                    np.isfinite(v) and 0 <= v <= 1 for v in vals):
                raise AssertionError(f"{name} val (fused {fused}): {summary}")
            res[fused] = summary
            log(9, f"{name} bf16 val at {IMGSZ}, fused seg head {fused}: "
                f"{json.dumps(summary)}; {wall:.3f} s wall; launches K3 "
                f"{k3}, K4 {k4}")
        d = abs(res[True]["miou"] - res[False]["miou"])
        if d > 0.05:
            raise AssertionError(f"{name}: fused and module heads disagree, "
                                 f"mIoU {res[True]['miou']} vs "
                                 f"{res[False]['miou']}")
        img = torch.from_numpy(batches[0]["image"]).to(dev)
        tgts = torch.from_numpy(batches[0]["det_targets"]).to(dev)
        tmask = torch.from_numpy(batches[0]["det_mask"]).to(dev)

        def step(fused: bool):
            vmodel.seg_head_fused = fused
            return validator.eval_step(img, tgts, tmask)

        off, on = in_turns((lambda: step(False), 5), (lambda: step(True), 5))
        vmodel.seg_head_fused = False
        log(9, f"{name} val device step b{B_VAL}/{IMGSZ} bf16: module seg "
            f"head {off:.3f} ms/batch, fused head (K4) {on:.3f} ms/batch "
            f"[{card}]")
        head = vmodel.model[spec.seg_layer]
        seen = []
        hook = head.register_forward_pre_hook(
            lambda m, args: seen.append(args[0]))
        try:
            with torch.inference_mode():
                vmodel(img.permute(0, 3, 1, 2).to(torch.bfloat16).contiguous(
                    memory_format=torch.channels_last) / 255)
        finally:
            hook.remove()
        k, p, bound, cudnn = k4_on_inputs(head, seen[0], spec.se_nc, card,
                                          errs, 9, name)
        extras.setdefault("seg_head_psp2", {}).update(
            {f"{name}_ms": k, f"{name}_module_ms": cudnn,
             f"{name}_bound_ms": bound[0]})
        del vmodel, validator, head, seen
        torch.cuda.empty_cache()

    # (c) every other seg head, yolov5s and the exotic rows at tiny size on
    # the card against the CPU (f32, TF32 off); K2 on each head's 1/8 logits
    from desenet_tpu_torch.testing import (EXOTIC_CFG, TINY_HEAD_ROWS,
                                           tiny_head_cfg)
    cases = [(h, tiny_head_cfg(h)) for h in TINY_HEAD_ROWS]
    cases += [("yolov5s", config_path("yolov5s")), ("exotic", EXOTIC_CFG)]
    x = torch.from_numpy(np.random.default_rng(10).uniform(
        0, 1, (2, 3, 64, 64)).astype(np.float32))
    with no_tf32(), torch.no_grad():
        for what, cfg in cases:
            outs = {}
            for d in ("cpu", "cuda"):
                m, spec = build_model(cfg, seg_upsample=False, fuse_focus=True)
                init_weights(m, torch.Generator().manual_seed(11))
                (dec, feats), seg8 = m.to(d)(x.to(d))
                outs[d] = [dec, *feats] + ([seg8] if seg8 is not None else [])
            err = max(float((a.cpu() - b).abs().max())
                      for a, b in zip(outs["cuda"], outs["cpu"]))
            if err > 1e-4:
                raise AssertionError(f"{what} f32 forward CUDA vs CPU: max "
                                     f"abs err {err}")
            msg = f"{what} f32 forward CUDA vs CPU: max abs err {err:.3g}"
            if spec.seg_layer >= 0:
                logits = outs["cuda"][-1].permute(0, 2, 3, 1).contiguous()
                h8, w8 = logits.shape[1:3]
                got = seg_pallas.upsample_argmax(logits, 8, True)
                ref = seg_pallas.upsample_argmax_plain(
                    logits, *seg_pallas.seg_taps(h8, h8 * 8, True, dev),
                    *seg_pallas.seg_taps(w8, w8 * 8, True, dev))
                torch.cuda.synchronize()
                if not torch.equal(got, ref):
                    raise AssertionError(f"K2 on {what}'s 1/8 logits: "
                                         f"{int((got != ref).sum())} pixels "
                                         "differ from plain")
                msg += (f"; K2 ({seg_pallas.last_variant} kernel) on its "
                        f"(2, {h8}, {w8}, {logits.shape[3]}) 1/8 logits "
                        f"equal to plain")
            log(9, msg + " (atol 1e-4)")

    # (d) the s served program with either stem, in turns, and the stems
    model, _ = build_model(config_path("yolov5s_seg"))
    sd = init_weights(model, torch.Generator().manual_seed(0)).state_dict()
    preds = [Predictor("yolov5s_seg", sd, imgsz=IMGSZ, half=True,
                       device="cuda", fuse_focus=f) for f in (True, False)]
    g = torch.Generator(device=dev).manual_seed(12)
    x = torch.randint(0, 256, (B_SERVE, IMGSZ, IMGSZ, 3), dtype=torch.uint8,
                      device=dev, generator=g)
    fused_ms, focus_ms = in_turns((lambda: preds[0].infer(x), 10),
                                  (lambda: preds[1].infer(x), 10))
    xin = x.permute(0, 3, 1, 2).to(torch.bfloat16).contiguous(
        memory_format=torch.channels_last) / 255
    stems = [p.model.model[0] for p in preds]
    with torch.inference_mode():
        a, b = stems[0](xin), stems[1](xin)
        check_bf16(a.float(), b.float(), "FusedFocus vs Focus stem",
                   BF16_MODULE_BAR)
        sf, sn = in_turns((lambda: stems[0](xin), 10),
                          (lambda: stems[1](xin), 10))
    log(9, f"yolov5s_seg served b{B_SERVE}/{IMGSZ} bf16 in turns: FusedFocus "
        f"stem {fused_ms:.3f} ms/batch ({B_SERVE / fused_ms * 1e3:.1f} "
        f"img/s), Focus stem {focus_ms:.3f} ms/batch "
        f"({B_SERVE / focus_ms * 1e3:.1f} img/s); the stems alone on that "
        f"batch: FusedFocus (one 6x6/s2 conv, BN, SiLU) {sf:.3f} ms, Focus "
        f"(four slices, concat, 3x3 conv, BN, SiLU) {sn:.3f} ms [{card}]")
    return launches


B_DET = 16
DET_MAX = 1000


def phase10(card: str, sd: dict, errs: dict, extras: dict) -> dict:
    """Inference and validation, the rest: checkpoints served through
    load_predictor, the detect program plain, with TTA and on a two-member
    ensemble, K1 at the TTA and ensemble anchor counts with max_det 1000
    and a class filter, K2 on the ensemble's f32 seg mean, the TTA val
    step with K3 on its own top set and K4 at the 544 and 448 px variants,
    then cli.detect end to end where cv2 imports; returns the kernels'
    launches on these paths."""
    import tempfile

    from desenet_tpu_torch.api import load_predictor
    from desenet_tpu_torch.cli.detect import detect_program, load_detector
    from desenet_tpu_torch.eval import Validator
    from desenet_tpu_torch.eval.tta import forward_augment, forward_augment_joint
    from desenet_tpu_torch.eval.validator import _to_input
    from desenet_tpu_torch.models import build_model, config_path, init_weights
    from desenet_tpu_torch.ops import (nms_fused, nms_pallas, seg_head_pallas,
                                       seg_pallas)
    from desenet_tpu_torch.ops.nms import MAX_WH, PRE_TOPK_VAL, _prep_candidates
    from desenet_tpu_torch.testing import (check_psp2, dense_decode,
                                           synthetic_decode)
    from desenet_tpu_torch.utils import checkpoint as ckpt
    from desenet_tpu_torch.utils.convert import load_state_dict

    dev = torch.device("cuda")
    counters = (nms_fused, seg_pallas, nms_pallas, seg_head_pallas)
    names = ("nms_fused", "seg_tail", "nms_greedy", "seg_head_psp2")
    launches = dict.fromkeys(names, 0)

    def drive(fn, *args):
        """Run ``fn`` as a main path: every launch counter at 0 before,
        read into ``launches`` after."""
        for c in counters:
            c.launches = 0
        out = fn(*args)
        torch.cuda.synchronize()
        for n, c in zip(names, counters):
            launches[n] += c.launches
        return out, {n: c.launches for n, c in zip(names, counters)}

    model, spec = build_model(config_path("yolov5s_seg"))
    sd1 = init_weights(model, torch.Generator().manual_seed(1)).state_dict()
    del model
    meta = {"cfg": "yolov5s_seg", "imgsz": IMGSZ, "de_nc": spec.de_nc,
            "se_nc": spec.se_nc,
            "de_names": [f"d{i}" for i in range(spec.de_nc)],
            "se_names": [f"s{i}" for i in range(spec.se_nc)]}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_detect_") as tmp:
        dirs = []
        for k, w in enumerate((sd, sd1)):
            params, stats = ckpt.split_stats(w)
            dirs.append(os.path.join(tmp, f"s{k}"))
            ckpt._write(dirs[-1], {"params": params, "batch_stats": stats},
                        meta)

        # (a) a checkpoint served through load_predictor
        rng = np.random.default_rng(10)
        frames = [rng.integers(0, 256, (IMGSZ, IMGSZ, 3), dtype=np.uint8)
                  for _ in range(4)]
        pred = load_predictor(dirs[0], imgsz=IMGSZ, max_det=DET_MAX,
                              device="cuda")
        res, k = drive(pred, frames)
        if (len(res) != 4 or k["nms_fused"] < 1 or k["seg_tail"] < 1
                or pred.names != meta["de_names"]
                or any(m.shape != (IMGSZ, IMGSZ) or int(m.max()) >= spec.se_nc
                       for m in res.masks)
                or any(d.shape[1] != 6 or not np.isfinite(d).all()
                       for d in res.xyxy)):
            raise AssertionError(f"load_predictor served {res!r}, launches {k}")
        log(10, f"load_predictor on a checkpoint directory of the seed-0 "
            f"weights: 4 frames at {IMGSZ}, dets per frame "
            f"{[len(d) for d in res.xyxy]}, launches {k}")

        # the detect program at b16: plain, TTA, a two-member ensemble
        det, _, _ = load_detector(dirs[:1], True, "cuda")
        ens, _, _ = load_detector(dirs, True, "cuda")
        g = torch.Generator(device=dev).manual_seed(10)
        u8 = torch.randint(0, 256, (B_DET, IMGSZ, IMGSZ, 3), dtype=torch.uint8,
                           device=dev, generator=g)
        x = _to_input(u8, torch.bfloat16, dev)
        with torch.inference_mode():
            anchors = (forward_augment(det, x).shape[1],
                       ens(x)[0][0].shape[1])
        if anchors != (55755, 50400):
            raise AssertionError(f"TTA / ensemble decodes of {anchors} "
                                 "anchors, expected 55755 / 50400")
        runs = {"plain": (det, False), "TTA": (det, True),
                "ensemble": (ens, False)}
        outs = {}
        for what, (m, aug) in runs.items():
            (nms, seg), k = drive(detect_program, m, u8, 0.25, 0.45, DET_MAX,
                                  None, False, aug)
            if (k["nms_fused"] != 1 or k["seg_tail"] != 1
                    or tuple(nms.boxes.shape) != (B_DET, DET_MAX, 4)
                    or tuple(seg.shape) != (B_DET, IMGSZ, IMGSZ)
                    or int(seg.max()) >= spec.se_nc
                    or not bool(torch.isfinite(nms.boxes).all())):
                raise AssertionError(f"detect program ({what}): launches {k}")
            outs[what] = (nms, seg)
        # the plain program is Predictor.infer's at max_det 1000; with TTA
        # the seg map stays the plain forward's
        want = pred.infer(u8)
        if not (torch.equal(outs["plain"][1], want[1])
                and torch.equal(outs["TTA"][1], want[1])
                and torch.equal(outs["plain"][0].num, want[0].num)):
            raise AssertionError("the detect program differs from "
                                 "Predictor.infer")
        ms = {what: cuda_ms(lambda m=m, aug=aug: detect_program(
            m, u8, 0.25, 0.45, DET_MAX, None, False, aug), 5)
            for what, (m, aug) in runs.items()}
        log(10, f"detect program b{B_DET}/{IMGSZ} bf16 (uint8 in, forward, "
            f"K1 at max_det {DET_MAX}, K2): plain {ms['plain'] / B_DET:.4f} "
            f"ms an image, TTA {ms['TTA'] / B_DET:.4f} (55755 anchors), "
            f"ensemble of two {ms['ensemble'] / B_DET:.4f} (50400 anchors); "
            f"the plain program equal to Predictor.infer's, TTA's seg map "
            f"the plain forward's [{card}]")

        # K1 at the TTA and ensemble anchor counts, max_det 1000, a class
        # filter; the dense decodes cross 4096 candidates with the TTA count
        for what, a, gen, kw in (
                ("TTA sparse", 55755, "synthetic", dict(frac=0.01)),
                ("TTA dense", 55755, "dense", dict(live=9000, objects=100)),
                ("ensemble sparse", 50400, "synthetic", dict(frac=0.01)),
                ("ensemble dense", 50400, "dense",
                 dict(live=6000, objects=100))):
            r = np.random.default_rng(11)
            dec = (synthetic_decode(r, B_DET, a, 6, kw["frac"])
                   if gen == "synthetic" else
                   dense_decode(r, B_DET, a, 6, kw["live"], kw["objects"]))
            planes = nms_fused.nms_planes(torch.from_numpy(dec).to(dev), 0.25,
                                          classes=(0, 2, 4))
            got = nms_fused.greedy_select(*planes, DET_MAX, 0.45)
            paths = nms_fused.last_paths.tolist()
            ref = nms_fused.greedy_select_plain(*planes, DET_MAX, 0.45)
            torch.cuda.synchronize()
            if not torch.equal(got, ref):
                raise AssertionError(f"K1 {what} ({B_DET}, {a}) differs from "
                                     "plain")
            n_cand = float((planes[4] > 0).sum(1).float().mean())
            picks = float((got[..., 4] > 0).sum(1).float().mean())
            p, kk = in_turns(
                (lambda: nms_fused.greedy_select_plain(*planes, DET_MAX, 0.45),
                 1),
                (lambda: nms_fused.greedy_select(*planes, DET_MAX, 0.45), 10))
            bound = tm.nms_fused_bound(B_DET, a, DET_MAX, n_cand, picks)
            on = ("argmax loop" if set(paths) == {nms_fused.PATH_ARGMAX}
                  else "ordered walk" if set(paths) == {nms_fused.PATH_ORDERED}
                  else f"paths {paths}")
            extras.setdefault("nms_fused", {})[
                f"{what.replace(' ', '_')}_ms"] = kk
            log(10, f"K1 nms_fused {what} ({B_DET}, {a}), classes (0, 2, 4), "
                f"{n_cand:.0f} candidates and {picks:.0f} picks an image, "
                f"max_det {DET_MAX}: identical to plain, {on} "
                f"(last_paths {paths}); kernel {kk:.3f} ms, plain {p:.3f} ms, "
                f"bound {bound[0]:.4f} ms ({bound[1]}) [{card}]")

        # K2 on the ensemble's f32 mean of 1/8 logits
        with torch.inference_mode():
            mean = ens(x)[1].permute(0, 2, 3, 1).contiguous()
        if mean.dtype != torch.float32:
            raise AssertionError(f"ensemble seg mean in {mean.dtype}")
        h8, w8 = mean.shape[1:3]
        taps = (*seg_pallas.seg_taps(h8, h8 * 8, True, dev),
                *seg_pallas.seg_taps(w8, w8 * 8, True, dev))
        got = seg_pallas.upsample_argmax(mean, 8, True)
        variant = seg_pallas.last_variant
        if not torch.equal(got, seg_pallas.upsample_argmax_plain(mean, *taps)):
            raise AssertionError("K2 on the ensemble's f32 seg mean differs "
                                 "from plain")
        nchw = mean.permute(0, 3, 1, 2)
        p, kk, lib = in_turns(
            (lambda: seg_pallas.upsample_argmax_plain(mean, *taps), 3),
            (lambda: seg_pallas.upsample_argmax(mean, 8, True), 20),
            (lambda: torch.nn.functional.interpolate(
                nchw, scale_factor=8, mode="bilinear",
                align_corners=True).argmax(1), 10))
        bound = tm.seg_tail_bound(B_DET, h8, w8, spec.se_nc, 8, itemsize=4)
        extras.setdefault("seg_tail", {})["ensemble_f32_ms"] = kk
        log(10, f"K2 seg_tail on the ensemble's f32 mean ({B_DET}, {h8}, "
            f"{w8}, {spec.se_nc}): identical to plain, {variant} kernel "
            f"{kk:.3f} ms, plain {p:.3f} ms, interpolate + argmax {lib:.3f} "
            f"ms, bound {bound[0]:.4f} ms ({bound[1]}) [{card}]")

        # (b) the CLI end to end, where cv2 imports
        try:
            import cv2
        except ImportError:
            cv2 = None
        if cv2 is None:
            log(10, "(b) cv2 not importable: cli.detect not run")
        else:
            from desenet_tpu_torch.cli import detect as cli_detect

            src = os.path.join(tmp, "src")
            os.makedirs(src)
            for i in range(16):
                cv2.imwrite(os.path.join(src, f"f{i:02d}.jpg"),
                            rng.integers(0, 256, (IMGSZ, IMGSZ, 3), np.uint8))
            for extra in ([], ["--augment"]):
                t = time.perf_counter()
                out, k = drive(cli_detect.main, [
                    "--weights", dirs[0], "--source", src, "--img-size",
                    str(IMGSZ), "--conf-thres", "0.001", "--max-det", "30",
                    "--save-txt", "--save-conf", "--save-crop", "--project",
                    os.path.join(tmp, "det"), "--device", "cuda"] + extra)
                wall = time.perf_counter() - t
                files = sum(len(fs) for _, _, fs in os.walk(out))
                labels = len(os.listdir(os.path.join(out, "labels")))
                if (k["nms_fused"] != 16 or k["seg_tail"] != 16
                        or files < 32 + labels):
                    raise AssertionError(f"cli.detect {extra}: {files} files,"
                                         f" launches {k}")
                log(10, f"(b) cli.detect {' '.join(extra) or 'plain'} on 16 "
                    f"JPEGs at {IMGSZ}: {files} files written ({labels} "
                    f"label files), {wall:.3f} s wall, launches {k}")

    # the TTA validation step at b32/640, K3 on its own top set, K4 at the
    # 544 and 448 px variants
    model, _ = build_model(config_path("yolov5s_seg"))
    load_state_dict(model, sd)
    model = model.to(dev, torch.bfloat16, memory_format=torch.channels_last)
    batch = val_batches(12, 1, B_VAL, IMGSZ, spec.de_nc, spec.se_nc)[0]
    img, tg, tmask = (torch.from_numpy(np.asarray(batch[k])).to(dev) for k in (
        "image", "det_targets", "det_mask"))
    validator = Validator(model, nc=spec.de_nc, se_nc=spec.se_nc,
                          augment=True)
    (nms, seg), k = drive(validator.eval_step, img, tg, tmask)
    if k["nms_greedy"] != 1 or tuple(seg.shape) != (B_VAL, IMGSZ, IMGSZ):
        raise AssertionError(f"TTA val step: launches {k}")
    step_ms = cuda_ms(lambda: validator.eval_step(img, tg, tmask), 3)
    res, k = drive(validator.run, [batch])
    vals = [res[n] for n in ("mp", "mr", "map50", "map", "miou", "pix_acc")]
    if res["seen"] != B_VAL or not all(0 <= v <= 1 for v in vals):
        raise AssertionError(f"TTA Validator.run: {res}")
    log(10, f"TTA val step b{B_VAL}/{IMGSZ} bf16 (forward at 640, 544 and "
        f"448, 55755 anchors x {spec.de_nc} classes into the top "
        f"{PRE_TOPK_VAL}, K3, the f32 seg mean): {step_ms:.3f} ms a batch = "
        f"{step_ms / B_VAL:.4f} ms an image; Validator.run mIoU "
        f"{res['miou']:.4f}, launches {k} [{card}]")

    head = model.model[spec.seg_layer]
    seen = []
    hook = head.register_forward_pre_hook(lambda m, a: seen.append(a[0]))
    try:
        with torch.inference_mode():
            x = _to_input(img, torch.bfloat16, dev)
            dec, _ = forward_augment_joint(model, x)
            boxes, scores, cls = _prep_candidates(dec.float(), 0.001,
                                                  PRE_TOPK_VAL, True)
    finally:
        hook.remove()
    boxes = (boxes + cls[..., None] * float(MAX_WH)).contiguous()
    scores = scores.contiguous()
    idx, sc = nms_pallas.greedy_nms_pallas(boxes, scores, 0.6, 300)
    paths = nms_pallas.last_paths.tolist()
    ridx, rsc = nms_pallas.greedy_nms_plain(boxes, scores, 0.6, 300)
    torch.cuda.synchronize()
    if not torch.equal(idx, ridx) or not torch.equal(sc, rsc):
        raise AssertionError("K3 on the TTA top set: keep-sets differ from "
                             "plain")
    live = float((scores > 0).sum(1).float().mean())
    picks = float((sc > 0).sum(1).float().mean())
    p, kk = in_turns(
        (lambda: nms_pallas.greedy_nms_plain(boxes, scores, 0.6, 300), 1),
        (lambda: nms_pallas.greedy_nms_pallas(boxes, scores, 0.6, 300), 10))
    bound = tm.nms_greedy_bound(B_VAL, boxes.shape[1], 300, live, picks)
    extras.setdefault("nms_greedy", {})["tta_ms"] = kk
    log(10, f"K3 nms_greedy on the TTA step's top set ({B_VAL}, "
        f"{boxes.shape[1]}) of {dec.shape[1]} anchors x {spec.de_nc} classes,"
        f" {live:.0f} live and {picks:.0f} picks an image: keep-sets "
        f"identical to plain, paths {sorted(set(paths))}; kernel {kk:.3f} "
        f"ms, plain {p:.3f} ms, bound {bound[0]:.4f} ms ({bound[1]}) [{card}]")

    # K4: opted in with TTA, one launch a variant; each scaled variant's own
    # neck maps against plain
    model.seg_head_fused = True
    _, k = drive(validator.eval_step, img, tg, tmask)
    model.seg_head_fused = False
    if k["seg_head_psp2"] != 3:
        raise AssertionError(f"TTA val step with the fused head: K4 launched "
                             f"{k['seg_head_psp2']} times, expected 3")
    for xs in seen[1:]:
        nhwc = [t.permute(0, 2, 3, 1).contiguous() for t in xs]
        b, h8, w8, _ = nhwc[0].shape
        with torch.inference_mode(), no_tf32():
            got = seg_head_pallas.fused_psp2_eval(nhwc, head, spec.se_nc)
            ref = seg_head_pallas.fused_psp2_eval_plain(nhwc, head,
                                                        spec.se_nc)
        err, agree = check_psp2(got, ref, torch.bfloat16)
        errs["seg_head_psp2"] = max(errs.get("seg_head_psp2", 0.0), err)
        with torch.inference_mode():
            p, kk = in_turns(
                (lambda: seg_head_pallas.fused_psp2_eval_plain(
                    nhwc, head, spec.se_nc), 2),
                (lambda: seg_head_pallas.fused_psp2_eval(
                    nhwc, head, spec.se_nc), 5))
        c_hid = nhwc[0].shape[3] // 2
        bound = tm.psp2_bound(b, h8, w8, [t.shape[3] for t in nhwc], c_hid,
                              spec.se_nc)
        extras.setdefault("seg_head_psp2", {})[f"tta_{h8 * 8}_ms"] = kk
        log(10, f"K4 seg_head_psp2 on the TTA variant's neck maps ({b}, {h8},"
            f" {w8}) bf16: within check_psp2's bars (max abs err {err:.6g}, "
            f"argmax agreement {agree:.6f}); kernel {kk:.3f} ms, plain "
            f"{p:.3f} ms, bound {bound[0]:.4f} ms ({bound[1]}) [{card}]")
    log(10, f"launches on this phase's paths: {launches}")
    return launches


B_DP = 16  # phase 11's global batch
DP_STEPS = 2


def _rank_train(rank: int, n: int, coordinator: str, argv) -> tuple:
    """Phase 11(b): one of two processes of one card over gloo, through
    cli.train; returns (its results, K3's launches in it)."""
    from desenet_tpu_torch.cli import train as cli_train
    from desenet_tpu_torch.ops import nms_pallas
    from desenet_tpu_torch.parallel import multihost

    multihost.init_multihost(coordinator, n, rank, device=argv.device,
                             backend="gloo")
    try:
        nms_pallas.launches = 0
        res = cli_train.main(argv(rank))
        return res, nms_pallas.launches
    finally:
        multihost.shutdown()


@dataclasses.dataclass
class _Argv:
    """cli.train's argv for a rank (a picklable callable)."""
    data: str
    project: str
    device: str = "cuda:0"
    cfg: str = "yolov5s_seg"
    imgsz: int = IMGSZ
    extra: tuple = ()  # later flags win (phase 14: --spatial, --batch-size)

    def __call__(self, rank: int) -> list:
        return ["--data", self.data, "--cfg", self.cfg, "--epochs", "1",
                "--batch-size", str(B_DP), "--img-size", str(self.imgsz),
                "--project", os.path.join(self.project, f"rank{rank}"),
                "--name", "dp", "--no-tb", "--device", self.device,
                *self.extra]


def phase11(card: str) -> int:
    """Multi-process data-parallel training; returns K3's launches."""
    import tempfile

    import torch.distributed as dist

    from desenet_tpu_torch.cli import train as cli_train
    from desenet_tpu_torch.models import config_path
    from desenet_tpu_torch.ops import nms_pallas
    from desenet_tpu_torch.parallel.multihost import free_port, spawn
    from desenet_tpu_torch.testing import (TRAIN_PARITY_STEPS,
                                           check_train_parity, parity_errors,
                                           train_steps)
    from desenet_tpu_torch.tools import dryrun_multichip
    from desenet_tpu_torch.tools.make_fake_dataset import generate

    with tempfile.TemporaryDirectory(prefix="chip_smoke_dp_") as tmp:
        data = generate(os.path.join(tmp, "fakeds"), n_train=32, n_val=8,
                        size=IMGSZ, seed=0)
        # (a) one process through the environment launch, over NCCL
        env = {"DESENET_COORDINATOR": f"localhost:{free_port()}",
               "DESENET_NUM_PROCESSES": "1", "DESENET_PROCESS_ID": "0"}
        os.environ.update(env)
        nms_pallas.launches = 0
        t = time.perf_counter()
        try:
            res = cli_train.main(_Argv(data, os.path.join(tmp, "one"),
                                       "cuda")(0))
        finally:
            for k in env:
                del os.environ[k]
        k3 = nms_pallas.launches
        wall = time.perf_counter() - t
        with open(os.path.join(res["save_dir"], "results.csv")) as fh:
            rows = list(csv.DictReader(fh))
        if (k3 < 1 or len(rows) != 1 or dist.is_initialized()
                or not np.isfinite(float(rows[0]["train/seg_loss"]))):
            raise AssertionError(f"11(a): K3 launched {k3} times, results "
                                 f"{rows}, a group left {dist.is_initialized()}")
        log("11a", f"cli.train through DESENET_COORDINATOR (1 process, "
            f"NCCL) yolov5s_seg b{B_DP}/{IMGSZ} bf16, 1 epoch of "
            f"{32 // B_DP} batches on the fake dataset, EMA validated on "
            f"process 0: K3 launched {k3} times, seg loss "
            f"{float(rows[0]['train/seg_loss']):.4f}, fitness "
            f"{res['best_fitness']:.4f}; {wall:.3f} s wall [{card}]")

        # (b) two ranks on the one card over gloo (NCCL refuses two ranks
        # of one card): training steps of the global batch against one
        # process, then cli.train end to end
        with open(config_path("yolov5s_seg")) as fh:
            cfg = json.load(fh)
        dtype = torch.float64
        kw = dict(cfg=cfg, imgsz=IMGSZ, b=B_DP, fused=True, dtype=dtype,
                  steps=DP_STEPS, seed=0)
        t = time.perf_counter()
        got = dryrun_multichip.run(2, "cuda:0", "gloo", **kw)
        two = time.perf_counter() - t
        want = train_steps("cuda:0", **kw)
        errs = parity_errors(got, want)
        check_train_parity(errs, dtype, "11(b) two ranks")
        log("11b", f"two ranks of one card (gloo, CUDA tensors), yolov5s_seg "
            f"at full width, {IMGSZ} px, float64, {DP_STEPS} SGD steps of a "
            f"global batch of {B_DP} (8 a rank) against one process on the "
            f"whole batch, held to testing's float64 bars (f32 parity holds "
            f"{TRAIN_PARITY_STEPS[torch.float32]} step): losses "
            f"{[round(g[0], 6) for g in got]} against "
            f"{[round(w[0], 6) for w in want]}; worst errors by step "
            + "; ".join(", ".join(
                f"{g} {e:.2e}" if g == "loss" else f"{g} {e[0]:.2e}"
                for g, e in step.items()) for step in errs)
            + f"; {two:.3f} s for the two ranks [{card}]")
        nms_pallas.launches = 0
        t = time.perf_counter()
        res, k3_rank0 = spawn(_rank_train, 2, _Argv(data, tmp))
        wall = time.perf_counter() - t
        k3 += k3_rank0 + nms_pallas.launches
        sd0 = os.path.join(tmp, "rank0", "dp")
        missing = [f for f in ("results.csv", "opt.yaml", "last/meta.json",
                               "best_stripped/state.pt")
                   if not os.path.exists(os.path.join(sd0, f))]
        if (missing or os.path.exists(os.path.join(tmp, "rank1"))
                or k3_rank0 < 1 or nms_pallas.launches):
            raise AssertionError(
                f"11(b): rank 0 lacks {missing}, rank 1 wrote "
                f"{os.path.exists(os.path.join(tmp, 'rank1'))}, K3 launched "
                f"{k3_rank0} times on rank 0")
        with open(os.path.join(sd0, "results.csv")) as fh:
            row = list(csv.DictReader(fh))[-1]
        log("11b", f"cli.train in two ranks of one card (gloo), yolov5s_seg "
            f"b{B_DP} ({B_DP // 2} a rank)/{IMGSZ} bf16, 1 epoch: only rank 0 "
            f"wrote its run directory (results.csv, opt.yaml, last, "
            f"best_stripped), K3 launched {k3_rank0} times by rank 0's EMA "
            f"validation, seg loss {float(row['train/seg_loss']):.4f} "
            f"(one process, 11(a): {float(rows[0]['train/seg_loss']):.4f}); "
            f"{wall:.3f} s wall with the two processes' start [{card}]")
    return k3


B_INT8_VAL = 32  # the int8 program whose conv shapes 12(a) takes
N_CALIB = 2      # calibration images of the int8 Predictor


def _im2col(x: torch.Tensor, kh: int, kw: int, stride: int, pad, dil: int):
    """(B*Ho*Wo, KH*KW*C) int8 rows of an NCHW (channels_last) int8 map,
    zero padded: the copy an im2col GEMM reads."""
    xn = x.permute(0, 2, 3, 1)
    if pad[0] or pad[1]:
        xn = torch.nn.functional.pad(xn, (0, 0, pad[1], pad[1], pad[0],
                                          pad[0]))
    b, hp, wp, c = xn.shape
    ho = (hp - dil * (kh - 1) - 1) // stride + 1
    wo = (wp - dil * (kw - 1) - 1) // stride + 1
    sb, sh, sw, sc = xn.stride()
    cols = xn.as_strided((b, ho, wo, kh, kw, c), (
        sb, stride * sh, stride * sw, dil * sh, dil * sw, sc))
    return cols.reshape(b * ho * wo, kh * kw * c), (b, ho, wo)


def int8_conv_library(parts, p, weights, residual=None, res_scale=None,
                      out_scale=None, act=False, out_mode=0):
    """The int8 conv block as PyTorch calls compute it: an im2col copy and
    ``torch._int_mm`` (cuBLASLt) a part, the epilogue in torch ops on the
    (M, O) rows. ``weights``: each part's (O8, K8) int8 matrix, zero padded
    to multiples of 8 (``_int_mm``'s rule), made once outside the timing."""
    from desenet_tpu_torch.ops import int8_conv

    kh, kw = p.qw.shape[2:]
    o = p.qw.shape[0]
    acc = None
    for data, g, wm in zip(parts, p.g, weights):
        a, (b, ho, wo) = _im2col(data, kh, kw, p.stride, p.padding,
                                 p.dilation)
        if a.shape[1] != wm.shape[1]:
            a = torch.nn.functional.pad(a, (0, wm.shape[1] - a.shape[1]))
        y = torch._int_mm(a, wm.t())[:, :o].float() * g
        acc = y if acc is None else acc + y
    for v in (p.bn_b, p.bias):
        if v is not None:
            acc = acc + v
    if p.corr is not None:
        acc = acc - p.corr
    if act:
        acc = acc * torch.sigmoid(acc)
    if residual is not None:
        acc = acc + residual.permute(0, 2, 3, 1).reshape(-1, o).float() \
            * res_scale.reshape(-1)
    if out_mode == int8_conv.OUT_F32:
        y = acc
    elif out_mode == int8_conv.OUT_BF16:
        y = acc.to(torch.bfloat16)
    else:
        y = torch.clamp(torch.round(acc / out_scale.reshape(-1)), -127.0,
                        127.0).to(torch.int8)
    return y.view(b, ho, wo, o).permute(0, 3, 1, 2)


def _library_weights(p):
    kh, kw = p.qw.shape[2:]
    o = p.qw.shape[0]
    out, off = [], 0
    for c in p.channels:
        w = p.qw[:, off:off + c].permute(0, 2, 3, 1).reshape(o, kh * kw * c)
        off += c
        k8, o8 = -(-w.shape[1] // 8) * 8, -(-o // 8) * 8
        out.append(torch.nn.functional.pad(
            w, (0, k8 - w.shape[1], 0, o8 - o)).contiguous())
    return out


def capture_int8_convs(fn):
    """Every int8 conv launch of ``fn()``: {shape key: [calls, the first
    call's arguments]}."""
    from desenet_tpu_torch.ops import int8_conv

    seen, run = {}, int8_conv.run

    def spy(parts, p, residual=None, res_scale=None, out_scale=None,
            act=False, out_mode=int8_conv.OUT_INT8):
        key = (tuple(tuple(t.shape) for t in parts), tuple(p.qw.shape),
               p.stride, p.padding, p.dilation, residual is not None,
               out_mode)
        if key not in seen:
            seen[key] = [0, dict(parts=list(parts), p=p, residual=residual,
                                 res_scale=res_scale, out_scale=out_scale,
                                 act=act, out_mode=out_mode)]
        seen[key][0] += 1
        return run(parts, p, residual, res_scale, out_scale, act, out_mode)

    int8_conv.run = spy
    try:
        fn()
    finally:
        int8_conv.run = run
    return seen


def int8_tiny_check(card: str) -> None:
    """12(0): the tiny int8 model (boosted weights, calibrated on the CPU)
    on the card against the CPU, where every conv is the plain version."""
    from desenet_tpu_torch import quant as Q
    from desenet_tpu_torch.models import build_model
    from desenet_tpu_torch.testing import boosted_state
    from desenet_tpu_torch.utils.convert import load_state_dict

    cfg = tiny_cfg()
    sd = boosted_state(build_model(cfg)[0], seed=0)
    x = torch.rand((2, 3, 64, 64), generator=torch.Generator().manual_seed(1))
    for pc in (True, False):
        cm, _ = build_model(cfg, fuse_focus=True, quant=Q.QuantCfg(
            mode="calib", per_channel_act=pc))
        load_state_dict(cm, sd)
        scales, means = Q.calibrate_stats(cm.eval(), [x])
        qcfg = Q.QuantCfg(mode="int8", scales=scales, in_means=means,
                          bias_correct=True, per_channel_act=pc)
        outs = []
        for dev in ("cpu", "cuda"):
            m, _ = build_model(cfg, fuse_focus=True, quant=qcfg)
            load_state_dict(m, sd)
            mf = (torch.channels_last if dev == "cuda"
                  else torch.contiguous_format)
            m = m.to(dev, memory_format=mf).eval()
            with torch.no_grad(), no_tf32():
                (dec, _), seg = m(x.to(dev).contiguous(memory_format=mf))
            outs.append((dec.float().cpu(), seg.float().cpu()))
        (d0, s0), (d1, s1) = outs
        derr = float((d1 - d0).abs().max() / d0.abs().max())
        serr = float((s1 - s0).abs().max() / s0.abs().max())
        agree = float((s1.argmax(1) == s0.argmax(1)).float().mean())
        if derr > 0.02 or serr > 0.02 or agree < 0.99:
            raise AssertionError(f"tiny int8 model on CUDA vs CPU: decode "
                                 f"{derr}, seg {serr}, class map {agree}")
        log(12, f"tiny int8 model ({'per-channel' if pc else 'per-tensor'} "
            f"scales) on CUDA against the CPU's plain convs: decode within "
            f"{derr:.2e} and seg logits within {serr:.2e} of their largest "
            f"magnitude, class map equal on {agree:.6f} [{card}]")


def phase12(card: str, sd: dict, errs: dict, timing: dict,
            extras: dict) -> dict:
    """Quantized inference: the int8 conv kernel at the b32/640 program's
    shapes, the int8 Predictor at b128/640 beside the bf16 one, cli.val
    with --int8 and --act-store fp8; returns the launches on those paths."""
    import tempfile

    from desenet_tpu_torch.api import Predictor
    from desenet_tpu_torch.ops import int8_conv, nms_fused, nms_pallas
    from desenet_tpu_torch.testing import check_int8

    int8_tiny_check(card)
    dev = torch.device("cuda")
    rng = np.random.default_rng(12)
    calib = [rng.integers(0, 256, (IMGSZ, IMGSZ, 3), dtype=np.uint8)
             for _ in range(N_CALIB)]
    launches = {"int8_conv": 0, "nms_fused": 0, "nms_greedy": 0}
    t = time.perf_counter()
    pq = Predictor("yolov5s_seg", sd, imgsz=IMGSZ, half=True, device="cuda",
                   int8=True, calib=calib)
    t_cal = time.perf_counter() - t
    pb = Predictor("yolov5s_seg", sd, imgsz=IMGSZ, half=True, device="cuda")

    # (a) the kernel at every distinct conv shape of the b32 program
    g = torch.Generator(device=dev).manual_seed(12)
    x32 = torch.randint(0, 256, (B_INT8_VAL, IMGSZ, IMGSZ, 3),
                        dtype=torch.uint8, device=dev, generator=g)
    seen = capture_int8_convs(lambda: pq.infer(x32))
    tot = {"ms": 0.0, "plain": 0.0, "lib": 0.0, "bytes": 0.0,
           "operations": 0.0}
    err, n_calls = 0.0, 0
    for key, (count, a) in seen.items():
        parts, p = a["parts"], a["p"]
        args = {k: a[k] for k in ("residual", "res_scale", "out_scale", "act",
                                  "out_mode")}
        raw = int8_conv.run(parts, p, out_mode=int8_conv.OUT_I32)
        if not torch.equal(raw, int8_conv.int8_conv_plain(
                parts, p, out_mode=int8_conv.OUT_I32)):
            raise AssertionError(f"int8 conv {key}: int32 sums differ from "
                                 f"plain")
        want = int8_conv.int8_conv_plain(parts, p, **args)
        e = check_int8(int8_conv.run(parts, p, **args), want, str(key))
        wl = _library_weights(p)
        lib_out = int8_conv_library(parts, p, wl, **args)
        check_int8(lib_out, want, f"library {key}")
        err = max(err, e)
        pl, k, lib = in_turns(
            (lambda: int8_conv.int8_conv_plain(parts, p, **args), 2),
            (lambda: int8_conv.run(parts, p, **args), 10),
            (lambda: int8_conv_library(parts, p, wl, **args), 5))
        b, _, h, w = parts[0].shape
        o, _, kh, kw = p.qw.shape
        ho, wo = want.shape[2:]
        cin = sum(t.shape[1] for t in parts)
        itemsize = {int8_conv.OUT_INT8: 1, int8_conv.OUT_F32: 4,
                    int8_conv.OUT_BF16: 2}[args["out_mode"]]
        bound = tm.int8_conv_bound(b, h, w, cin, ho, wo, o, kh, kw, itemsize,
                                   args["residual"] is not None)
        macs = tm.int8_conv_macs(b, ho, wo, cin, o, kh, kw)
        tot["ms"] += count * k
        tot["plain"] += count * pl
        tot["lib"] += count * lib
        tot[bound[1]] += count * bound[0]
        n_calls += count
        log(12, f"int8_conv x{count} parts {[t.shape[1] for t in parts]} "
            f"({b}, {h}, {w}) -> ({o}, {ho}, {wo}) k{kh} s{p.stride} "
            f"d{p.dilation}{' +res' if args['residual'] is not None else ''}"
            f" out {args['out_mode']}: kernel {k:.4f} ms "
            f"({2 * macs / k / 1e9:.1f} TOP/s), plain {pl:.3f} ms, im2col + "
            f"_int_mm {lib:.4f} ms, bound {bound[0]:.4f} ms ({bound[1]}); "
            f"max |diff| {e} [{card}]")
    bound_ms = tot["bytes"] + tot["operations"]
    by = "bytes" if tot["bytes"] >= tot["operations"] else "operations"
    timing["int8_conv"] = (tot["ms"], tot["plain"], (bound_ms, by),
                           tot["lib"])
    errs["int8_conv"] = err
    extras["int8_conv"] = {"shapes": len(seen), "calls_per_forward": n_calls,
                           "batch": B_INT8_VAL}
    log(12, f"int8_conv over one b{B_INT8_VAL}/{IMGSZ} int8 forward: "
        f"{n_calls} launches at {len(seen)} shapes, kernel {tot['ms']:.3f} "
        f"ms, plain {tot['plain']:.3f} ms, im2col + _int_mm "
        f"{tot['lib']:.3f} ms, bound {bound_ms:.4f} ms (sum of the calls' "
        f"bounds, mostly {by}) [{card}]")

    # (b) serving: the int8 Predictor beside the bf16 one, b128/640
    int8_conv.launches = nms_fused.launches = 0
    res = pq(calib)
    if len(res) != N_CALIB or any(m.shape != (IMGSZ, IMGSZ)
                                  for m in res.masks):
        raise AssertionError(f"int8 Predictor served {res!r}")
    x = torch.randint(0, 256, (B_SERVE, IMGSZ, IMGSZ, 3), dtype=torch.uint8,
                      device=dev, generator=g)
    peak = {}
    for name, pr in (("bf16", pb), ("int8", pq)):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        nms, seg = pr.infer(x)
        torch.cuda.synchronize()
        peak[name] = torch.cuda.max_memory_allocated() / 2**30
        if not torch.isfinite(nms.scores).all() or seg.shape != (
                B_SERVE, IMGSZ, IMGSZ):
            raise AssertionError(f"{name} served program: bad outputs")
    mb, mq = in_turns((lambda: pb.infer(x), 5), (lambda: pq.infer(x), 5))
    k = {"int8_conv": int8_conv.launches, "nms_fused": nms_fused.launches}
    if min(k.values()) < 1:
        raise AssertionError(f"int8 serving launches {k}")
    for n, v in k.items():
        launches[n] += v
    agree = float((pq.infer(x)[1] == pb.infer(x)[1]).float().mean())
    log(12, f"int8 Predictor (calibrated on {N_CALIB} images in "
        f"{t_cal:.3f} s) b{B_SERVE}/{IMGSZ}: {mq:.3f} ms/batch = "
        f"{B_SERVE / mq * 1e3:.1f} img/s, peak {peak['int8']:.3f} GiB; bf16 "
        f"Predictor {mb:.3f} ms/batch = {B_SERVE / mb * 1e3:.1f} img/s, peak "
        f"{peak['bf16']:.3f} GiB (in turns); seg maps equal on {agree:.4f} "
        f"(random weights); launches {k} [{card}]")

    # (c) cli.val with --int8 and --act-store fp8 on a fake dataset; the
    # data path needs cv2 and PIL, and a missing one fails the phase
    import cv2  # noqa: F401
    import PIL  # noqa: F401

    from desenet_tpu_torch.cli import val as cli_val
    from desenet_tpu_torch.eval import Validator
    from desenet_tpu_torch.tools.make_fake_dataset import generate
    from desenet_tpu_torch.utils.general import check_dataset

    with tempfile.TemporaryDirectory(prefix="chip_smoke_int8_") as tmp:
        t = time.perf_counter()
        data = generate(os.path.join(tmp, "ds"), n_train=8 * N_CALIB,
                        n_val=4 * B_VAL, size=IMGSZ, seed=12)
        made = time.perf_counter() - t
        npz = os.path.join(tmp, "sd.npz")
        np.savez(npz, **{k: v.cpu().numpy() for k, v in sd.items()})
        ds = check_dataset(data)
        nc, se_nc = int(ds["de"]["nc"]), int(ds["se"]["nc"])
        for mode, extra in (("int8", ["--int8"]),
                            ("fp8", ["--act-store", "fp8"]), ("bf16", [])):
            int8_conv.launches = nms_pallas.launches = 0
            t = time.perf_counter()
            r = cli_val.main(["--data", data, "--cfg", "yolov5s_seg",
                              "--weights", npz, "--batch-size", str(B_VAL),
                              "--img-size", str(IMGSZ), "--device", "cuda",
                              "--workers", "4", "--save-dir",
                              os.path.join(tmp, mode)] + extra)
            wall = time.perf_counter() - t
            k = {"nms_greedy": nms_pallas.launches,
                 "int8_conv": int8_conv.launches}
            if r["seen"] != 4 * B_VAL or k["nms_greedy"] < 1 or (
                    mode == "int8" and k["int8_conv"] < 1) or not all(
                    0.0 <= r[m] <= 1.0 for m in ("miou", "pix_acc", "map50")):
                raise AssertionError(f"cli.val {mode}: {r}, launches {k}")
            for n, v in k.items():
                launches[n] += v
            log(12, f"cli.val {' '.join(extra) or '(bf16)'} yolov5s_seg "
                f"b{B_VAL}/{IMGSZ}, {r['seen']} fake images (written in "
                f"{made:.3f} s): mIoU {r['miou']:.4f}, pixAcc "
                f"{r['pix_acc']:.4f}, mAP50 {r['map50']:.4f}; {wall:.3f} s "
                f"wall; launches {k} [{card}]")
        # the val step of the three programs in turns
        models = {
            "int8": cli_val.calibrate_int8(ds, npz, "yolov5s_seg", nc, se_nc,
                                           IMGSZ, B_VAL, True, dev)[0],
            "fp8": cli_val.load_model("yolov5s_seg", npz, nc, se_nc, True,
                                      dev, act_store="fp8")[0],
            "bf16": cli_val.load_model("yolov5s_seg", npz, nc, se_nc, True,
                                       dev)[0]}
    batch = val_batches(12, 1, B_VAL, IMGSZ, nc, se_nc)[0]
    img = torch.from_numpy(batch["image"]).to(dev)
    tg = torch.from_numpy(batch["det_targets"]).to(dev)
    tmask = torch.from_numpy(batch["det_mask"]).to(dev)
    steps, peak = {}, {}
    for name, m in models.items():
        v = Validator(m, nc=nc, se_nc=se_nc)
        steps[name] = lambda v=v: v.eval_step(img, tg, tmask)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        steps[name]()
        torch.cuda.synchronize()
        peak[name] = torch.cuda.max_memory_allocated() / 2**30
    ms = dict(zip(steps, in_turns(*[(f, 5) for f in steps.values()])))
    log(12, "val step b%d/%d (forward, NMS top set with K3, seg argmax): "
        % (B_VAL, IMGSZ) + ", ".join(
            f"{n} {ms[n]:.3f} ms ({B_VAL / ms[n] * 1e3:.1f} img/s, peak "
            f"{peak[n]:.3f} GiB)" for n in steps) + f" (in turns) [{card}]")
    extras["int8_conv"].update(
        served_b128_ms={"int8": mq, "bf16": mb},
        val_step_b32_ms=ms)
    return launches


B_REMAT = 64
REMAT_STEPS = 10
B_REMAT_F32, S_REMAT_F32 = 8, 320


def _offline_run(save_dir: str) -> str:
    """The one offline W&B run directory under ``save_dir``."""
    runs = [d for d in os.listdir(save_dir) if d.startswith("offline-run-")]
    if len(runs) != 1:
        raise AssertionError(f"{save_dir}: offline W&B runs {runs}")
    return os.path.join(save_dir, runs[0])


def _manifests(run_dir: str, name: str) -> list:
    base = os.path.join(run_dir, "artifacts", name)
    out = []
    for f in sorted(os.listdir(base)):
        if f.endswith(".manifest.json"):
            with open(os.path.join(base, f)) as fh:
                out.append(json.load(fh))
    return sorted(out, key=lambda m: m["version"])


def phase13a(card: str, tmp: str) -> tuple:
    """The training path with the W&B sink; returns (K3 launches, the
    run's ``last`` checkpoint, the fake dataset's root)."""
    import PIL  # noqa: F401 - decoded with PIL
    import cv2  # noqa: F401 - the fake dataset is written with cv2

    from desenet_tpu_torch.cli import log_dataset
    from desenet_tpu_torch.cli import train as cli_train
    from desenet_tpu_torch.ops import nms_pallas
    from desenet_tpu_torch.tools.make_fake_dataset import generate
    from desenet_tpu_torch.utils.callbacks import Callbacks
    from desenet_tpu_torch.utils.wandb_logger import WANDB_ARTIFACT_PREFIX

    root = os.path.join(tmp, "fakeds")
    data = generate(root, n_train=32, n_val=8, size=IMGSZ, seed=0)
    wb_yaml = str(log_dataset.create_dataset_artifact(data))
    with open(wb_yaml) as fh:
        splits = json.load(fh)
    if not all(splits[k].startswith(WANDB_ARTIFACT_PREFIX)
               for k in ("train", "val")):
        raise AssertionError(f"log_dataset wrote {splits}")
    project = os.path.join(tmp, "runs")
    argv = ["--data", wb_yaml, "--cfg", "yolov5s_seg", "--batch-size",
            str(B_CLI), "--img-size", str(IMGSZ), "--project", project,
            "--name", "wb", "--no-tb", "--device", "cuda", "--wandb",
            "--bbox-interval", "1", "--remat", "--artifact-alias", "latest"]
    clock = EpochClock()

    def clocked():  # a run's own hooks (its loggers register on them)
        callbacks = Callbacks()
        callbacks.auto_register(clock)
        return callbacks

    nms_pallas.launches = 0
    t = time.perf_counter()
    res = cli_train.main(argv + ["--epochs", "2", "--upload-dataset"],
                         clocked())
    first = time.perf_counter() - t
    save_dir = res["save_dir"]
    run_dir = _offline_run(save_dir)
    run_id = os.path.basename(run_dir)[len("offline-run-"):]
    with open(os.path.join(run_dir, "history.jsonl")) as fh:
        hist = [json.loads(ln) for ln in fh]
    rows = [h for h in hist if "train/box_loss" in h]
    metrics = [h[k] for h in rows for k in h if k.startswith("metrics/")]
    losses = [h[f"train/{k}_loss"] for h in rows
              for k in ("box", "obj", "cls", "seg")]
    if ([h["epoch"] for h in rows] != [0, 1]
            or not np.isfinite(losses).all()
            or not all(0 <= v <= 1 for v in metrics)):
        raise AssertionError(f"W&B history rows {rows}")
    model_art = f"run_{run_id}_model"
    mans = _manifests(run_dir, model_art)
    for epoch, man in enumerate(mans):
        want = {"latest", "last", f"epoch {epoch}"}
        if not want <= set(man["aliases"]):
            raise AssertionError(f"{model_art} v{epoch}: {man['aliases']}")
    if (len(mans) != 2 or not any("best" in m["aliases"] for m in mans)
            or not all(os.path.isfile(os.path.join(
                run_dir, "artifacts", model_art, f"v{m['version']}",
                "state.pt")) for m in mans)):
        raise AssertionError(f"{model_art}: {mans}")
    for split in ("train", "val"):  # --upload-dataset's and log_dataset's
        if not _manifests(run_dir, f"{split}_dataset"):
            raise AssertionError(f"no {split}_dataset artifact in the run")
    logged = _offline_run(os.environ["WANDB_DIR"])
    if not all(_manifests(logged, f"{s}_dataset") for s in ("train", "val")):
        raise AssertionError("log_dataset logged no dataset artifacts")

    # a third epoch resumed from the model artifact, in the same run dir
    t = time.perf_counter()
    res = cli_train.main(argv + ["--epochs", "3", "--exist-ok", "--resume",
                                 f"{WANDB_ARTIFACT_PREFIX}{model_art}:latest"],
                         clocked())
    resumed = time.perf_counter() - t
    k3 = nms_pallas.launches
    with open(os.path.join(save_dir, "results.csv")) as fh:
        epochs = [int(r["epoch"]) for r in csv.DictReader(fh)]
    from desenet_tpu_torch.utils import checkpoint as ckpt

    counters = ckpt.load_checkpoint(os.path.join(save_dir, "last"))[
        "counters"]
    if (epochs != [0, 1, 2] or int(counters["epoch"]) != 2
            or int(counters["step"]) != 3 * (32 // B_CLI) or k3 < 3):
        raise AssertionError(f"resume: results.csv epochs {epochs}, "
                             f"counters {counters}, K3 launched {k3} times")
    log("13a", f"log_dataset on a fake dataset (32 train, 8 val at "
        f"{IMGSZ}), then cli.train yolov5s_seg b{B_CLI}/{IMGSZ} bf16 "
        f"--wandb --upload-dataset --bbox-interval 1 --remat on its "
        f"wandb-artifact:// splits, 2 epochs in {first:.3f} s wall, then a "
        f"third resumed from {model_art}:latest in {resumed:.3f} s: history "
        f"{len(rows)} rows of finite losses and metrics in [0, 1], "
        f"{len(mans)} model artifact versions with aliases "
        f"{[m['aliases'] for m in mans]}, dataset artifacts in the run and "
        f"under WANDB_DIR; training loop by epoch "
        f"{', '.join(f'{v:.3f}' for v in clock.loops)} s, validations "
        f"{', '.join(f'{v:.3f}' for v in clock.vals)} s; K3 launched {k3} "
        f"times in 3 validations [{card}]")
    return k3, os.path.join(save_dir, "last"), root


def phase13b(card: str) -> None:
    """--remat at the training step's shape, and its equality in f32."""
    from desenet_tpu_torch.testing import (TRAIN_LOSS_BAR, TRAIN_STATE_BAR,
                                           no_tf32)
    from desenet_tpu_torch.tools.profile_train_step import (device_batches,
                                                            trainer)
    from desenet_tpu_torch.train.state import bn_stats

    dev = torch.device("cuda")
    state, step, spec = trainer(True, dev, B_REMAT, IMGSZ, torch.bfloat16)
    batches = itertools.cycle(device_batches(2, B_REMAT, IMGSZ, spec.de_nc,
                                             dev))
    peaks = {}

    def run(remat):
        def one():
            nonlocal state
            state.model.remat = remat
            state, _ = step(state, next(batches))
        return one

    for remat in (False, True):
        torch.cuda.reset_peak_memory_stats()
        run(remat)()
        torch.cuda.synchronize()
        peaks[remat] = torch.cuda.max_memory_allocated()
    plain_ms, remat_ms = in_turns((run(False), REMAT_STEPS),
                                  (run(True), REMAT_STEPS))
    del state, step, batches

    # f32, TF32 off: one step from one state and batch with and without
    # remat, no optimizer step (the gradients stay in .grad)
    got = {}
    with no_tf32():
        batch = device_batches(1, B_REMAT_F32, S_REMAT_F32, spec.de_nc, dev,
                               seed=5)[0]
        for remat in (False, True):
            st, stp, _ = trainer(True, dev, B_REMAT_F32, S_REMAT_F32,
                                 torch.float32)
            st.model.remat = remat
            st.last_opt_step = 0  # accumulate: keep the gradients
            before = {k: v.clone() for k, v in bn_stats(st.model).items()}
            st, m = stp(st, batch)
            got[remat] = (float(m["loss"]),
                          {k: p.grad.clone() for k, p in st.params.items()
                           if p.grad is not None},
                          {k: v.clone() for k, v in bn_stats(st.model).items()},
                          before)
            del st, stp
    (l0, g0, s0, b0), (l1, g1, s1, _) = got[False], got[True]

    def rel(a, b):
        return max(float((a[k] - b[k]).abs().max())
                   / max(float(b[k].abs().max()), 1e-30) for k in b)

    loss_err = abs(l1 - l0) / abs(l0)
    grad_err, stat_err = rel(g1, g0), rel(s1, s0)
    # how far one forward moved the statistics (largest change)
    moved = max(float((s0[k] - b0[k]).abs().max()) for k in b0)
    bar = TRAIN_STATE_BAR[torch.float32][0]
    if (set(g1) != set(g0) or not g0 or loss_err > TRAIN_LOSS_BAR[
            torch.float32] or grad_err > bar or stat_err > bar
            or not moved > 0):
        raise AssertionError(
            f"--remat f32: loss rel err {loss_err}, gradients {grad_err}, "
            f"BN statistics {stat_err} (one forward moves them {moved})")
    log("13b", f"--remat yolov5s_seg b{B_REMAT}/{IMGSZ} bf16 train step "
        f"(CUDA events, {REMAT_STEPS} warm steps, in turns): without "
        f"{plain_ms:.3f} ms, peak allocated {peaks[False] / 2**30:.3f} GiB; "
        f"with {remat_ms:.3f} ms ({remat_ms / plain_ms:.3f}x), peak "
        f"{peaks[True] / 2**30:.3f} GiB ({peaks[True] / peaks[False]:.3f}x)"
        f"; f32 b{B_REMAT_F32}/{S_REMAT_F32} (TF32 off) with against "
        f"without: loss rel err {loss_err:.2e}, gradients {grad_err:.2e}, "
        f"BN statistics {stat_err:.2e} after one step (which moves them "
        f"{moved:.2e}: once, not twice) [{card}]")


N_EXPORT_CAND = 256  # candidates above the export check's conf_thres


def phase13c(card: str, last: str, root: str, tmp: str) -> None:
    """The serving export of 13(a)'s checkpoint, its consumer on the card,
    the live program and the served Predictor (K1, K2), on a val image of
    13(a)'s fake dataset (``root``)."""
    import contextlib
    import io

    from PIL import Image

    from desenet_tpu_torch.api import load_predictor
    from desenet_tpu_torch.ops import (nms_fused, non_max_suppression,
                                       seg_pallas)
    from desenet_tpu_torch.testing import no_tf32
    from desenet_tpu_torch.tools import export_model

    sys.path.insert(0, os.path.join("desenet_tpu_torch", "tools"))
    try:
        import consume_exported_model as consumer
    finally:
        sys.path.pop(0)
    val_dir = os.path.join(root, "Images", "val")
    img = np.asarray(Image.open(os.path.join(
        val_dir, sorted(os.listdir(val_dir))[0])).convert("RGB"))
    img_path = os.path.join(tmp, "img.npy")
    np.save(img_path, img)
    batch = torch.from_numpy(consumer.letterbox_u8(img, IMGSZ)[0][None])
    lines = []
    with no_tf32():
        # a 3-epoch model scores every anchor near its prior: put conf_thres
        # midway between the scores ranked N and N + 1 (in each dtype)
        # (under pre_topk 1024, where the export's selection and K1's
        # agree), so that there are candidates and detections to compare
        live, confs = {}, {}
        for fp32 in (True, False):
            dtype = torch.float32 if fp32 else torch.bfloat16
            live[fp32], _ = export_model.load_program(last, dtype, "cuda")
            with torch.no_grad():
                x = batch.cuda().permute(0, 3, 1, 2).to(dtype) / 255.0
                dec = live[fp32].model(x)[0][0].float()
            score = dec[0, :, 4] * dec[0, :, 5:].max(-1).values
            top = torch.sort(score, descending=True).values
            confs[fp32] = float((top[N_EXPORT_CAND - 1]
                                 + top[N_EXPORT_CAND]) / 2)
            if fp32:
                dec_live, score_live = dec, score
        conf = confs[True]
        outs = {}
        for fp32 in (True, False):
            tag = "f32" if fp32 else "bf16"
            out = os.path.join(tmp, f"model_{tag}.pt2")
            made = export_model.main(
                [last, out, "--img-size", str(IMGSZ), "--device", "cuda",
                 "--conf-thres", repr(confs[fp32])]
                + (["--fp32"] if fp32 else []))
            npz = out + ".npz"
            t = time.perf_counter()
            if fp32:  # a fresh process: nothing of the port imported
                proc = subprocess.run(
                    [sys.executable, consumer.__file__, out, img_path, npz],
                    capture_output=True, text=True, timeout=300,
                    env=dict(os.environ, PYTHONPATH=""))
                if proc.returncode != 0:
                    raise AssertionError(f"consumer: {proc.stderr[-3000:]}")
                where = "a fresh process"
            else:
                with contextlib.redirect_stdout(io.StringIO()):
                    if consumer.main([out, img_path, npz]) != 0:
                        raise AssertionError("consumer failed")
                where = "this process"
            consumed = time.perf_counter() - t
            got = outs[fp32] = dict(np.load(npz))
            prog = live[fp32]
            prog.conf_thres = confs[fp32]
            with torch.no_grad():
                want = [v.cpu().numpy() for v in prog(batch.cuda())]
            n = int(want[3][0])
            box_err = float(np.abs(got["boxes"][0, :n]
                                   - want[0][0, :n]).max()) if n else 0.0
            seg_eq = float((got["seg"] == want[4]).mean())
            if (not np.array_equal(got["num"], want[3])
                    or not np.array_equal(got["classes"][0, :n],
                                          want[2][0, :n])
                    or (fp32 and (n < 1 or box_err > 1e-4 or seg_eq < 1.0))
                    or seg_eq < 0.999):
                raise AssertionError(
                    f"export {tag}: {n} live detections, consumer "
                    f"{int(got['num'][0])}, box err {box_err}, seg equal on "
                    f"{seg_eq}")
            lines.append(f"{tag}: exported in {made['seconds']:.3f} s, "
                         f"{made['bytes'] / 1e6:.3f} MB, consumed in {where}"
                         f" in {consumed:.3f} s, {n} detections, boxes "
                         f"within {box_err:.2e} of the live program, seg "
                         f"equal on {seg_eq:.6f}")
        del live, prog
        # the served Predictor (K1, K2) on the same letterboxed image. Its
        # f32 forward rounds otherwise than the graph's (channels_last, its
        # own kernels), and the model gives hundreds of anchors scores a
        # few ulps apart, whose order, and so the boxes greedy NMS keeps,
        # follow that rounding: its decode is held against the graph's, K1
        # against the graph's NMS on the Predictor's decode, and the seg
        # map against the export's
        pred = load_predictor(last, imgsz=IMGSZ, half=False, device="cuda",
                              conf_thres=conf)
        with torch.no_grad():
            x = batch.cuda().permute(0, 3, 1, 2).float().contiguous(
                memory_format=pred._mf) / 255
            dec = pred.model(x)[0][0].float()
            ref = non_max_suppression(
                dec, conf_thres=conf, iou_thres=pred.iou_thres,
                max_det=pred.max_det, pre_topk=1024, backend="xla")
        score = dec[0, :, 4] * dec[0, :, 5:].max(-1).values
        score_err = float((score - score_live).abs().max())
        dec_err = float((dec[..., :4] - dec_live[..., :4]).abs().max())
        cand = torch.sort(score_live[score_live > conf],
                          descending=True).values
        near = int((cand[:-1] - cand[1:] <= 2 * score_err).sum())
        if score_err > 1e-6 or dec_err > 1e-3:
            raise AssertionError(f"Predictor's decode against the f32 "
                                 f"program's: scores {score_err}, boxes "
                                 f"{dec_err}")
        nms_fused.launches = seg_pallas.launches = 0
        with torch.no_grad():
            nms, seg = pred.infer(batch.cuda())
        launched = (nms_fused.launches, seg_pallas.launches)
        n, n_ref = int(nms.num[0]), int(ref.num[0])
        box_err = float((nms.boxes[0, :n] - ref.boxes[0, :n]).abs().max()
                        ) if n else 0.0
        # K1 returns its boxes less the class offset (cls * 4096): within
        # half an ulp there, under 1e-3 px for 6 classes
        if (n != n_ref or n < 1 or box_err > 1e-3
                or not torch.equal(nms.classes[0, :n], ref.classes[0, :n])
                or launched[0] < 1 or launched[1] < 1):
            raise AssertionError(f"Predictor: {n} detections against the "
                                 f"graph's NMS's {n_ref} on its decode, box "
                                 f"err {box_err}; K1, K2 launched "
                                 f"{launched}")
        f32_out = outs[True]
        seg_eq = float((seg.cpu().numpy() == f32_out["seg"]).mean())
        if seg_eq < 0.999:
            raise AssertionError(f"Predictor against the f32 export: seg "
                                 f"equal on {seg_eq}")
    log("13c", f"export of 13(a)'s 'last' at b1/{IMGSZ} (torch.export, NMS "
        f"backend='xla', pre_topk 1024, conf_thres {conf:.6g} in f32 and "
        f"{confs[False]:.6g} in bf16 midway between the scores ranked "
        f"{N_EXPORT_CAND} and {N_EXPORT_CAND + 1}, on a fake val image): "
        f"{'; '.join(lines)}; the served Predictor f32 (K1 {launched[0]}, "
        f"K2 {launched[1]} launches) on the same image: decode within "
        f"{score_err:.3g} (scores) and {dec_err:.3g} (boxes) of the f32 "
        f"program's, where {near} of the {len(cand)} candidates lie within "
        f"twice that of the next; {n} detections, as the graph's NMS on its "
        f"decode (boxes within {box_err:.2e}; the export kept "
        f"{int(f32_out['num'][0])}), seg equal to the export's on "
        f"{seg_eq:.6f} [{card}]")


def phase13d(card: str, sd: dict, tmp: str) -> None:
    """profiling: model_info, profile_fn of a C3, a trace of one served
    batch (phase 4's weights ``sd``); the blocks the DSL cannot name on the
    card against the CPU."""
    from desenet_tpu_torch.api import Predictor
    from desenet_tpu_torch.models import build_model, config_path, init_weights
    from desenet_tpu_torch.models import layers as L
    from desenet_tpu_torch.testing import TRAIN_STATE_BAR, no_tf32
    from desenet_tpu_torch.utils import profiling

    model, spec = build_model(config_path("yolov5s_seg"))
    init_weights(model, torch.Generator().manual_seed(0))
    model.cuda()
    info = profiling.model_info(model, IMGSZ)
    total = sum(p.numel() for p in model.parameters())
    if info["params"] != 7_594_130 or total != 7_594_268:
        raise AssertionError(f"model_info params {info['params']} (the JAX "
                             f"variables' 7,594,130), all {total}")
    c3 = next(m for m in model.model if isinstance(m, L.C3)).eval()
    c3_in = c3.cv1.conv.in_channels
    x = torch.randn(B_SERVE, c3_in, IMGSZ // 4, IMGSZ // 4, device="cuda")

    def c3_bf16(v):
        with torch.autocast("cuda", dtype=torch.bfloat16):
            return c3(v)

    prof = profiling.profile_fn(c3_bf16, x, iters=5, with_grad=True)
    del x, model, c3
    trace_dir = os.path.join(tmp, "trace")
    pred = Predictor("yolov5s_seg", sd, imgsz=IMGSZ, half=True,
                     device="cuda")
    imgs = torch.randint(0, 256, (B_VAL, IMGSZ, IMGSZ, 3), dtype=torch.uint8,
                         device="cuda")
    pred.infer(imgs)
    with profiling.trace(trace_dir):
        pred.infer(imgs)
        torch.cuda.synchronize()
    trace_file = os.path.join(trace_dir, "trace.json")
    with open(trace_file) as fh:
        events = json.load(fh).get("traceEvents", [])
    kernels = sum(1 for e in events if e.get("cat") == "kernel")
    if not events or not kernels:
        raise AssertionError(f"trace: {len(events)} events, {kernels} "
                             "kernels")
    del pred, imgs

    # the blocks the DSL cannot name, f32 (TF32 off): forward and gradient
    blocks = {"ARM": (L.ARM(64, 64), 64), "ASPPs": (L.ASPPs(128, 64), 128),
              "RFB1": (L.RFB1(128, 96, has_global=True), 128),
              "DAPPM": (L.DAPPM(128, 32, 64), 128),
              "ConvBNReLU": (L.ConvBNReLU(64, 64), 64),
              "Classify": (L.Classify(128, 10), 128),
              "Sum": (L.Sum(3), 64), "Sum(weighted)": (L.Sum(3, True), 64)}
    errs = {True: [], False: []}  # output and input gradients; parameters'
    with no_tf32():
        for name, (blk, c) in blocks.items():
            torch.manual_seed(0)
            for p in blk.parameters():  # away from the identity init
                p.data.uniform_(-0.5, 0.5)
            xs = [torch.randn(4, c, 40, 40) for _ in range(
                3 if name.startswith("Sum") else 1)]
            outs = []
            for dev in ("cpu", "cuda"):
                b = blk.to(dev).train()
                b.zero_grad()
                xi = [v.detach().to(dev).requires_grad_(True) for v in xs]
                y = b(xi if name.startswith("Sum") else xi[0])
                (y * y).sum().backward()
                # copies: moving the block moves its gradients in place
                outs.append([t.detach().cpu().clone() for t in
                             [y] + [v.grad for v in xi]
                             + [p.grad for p in b.parameters()
                                if p.grad is not None]])
            # the output and the inputs' gradients at 1e-4 of their largest
            # magnitude; the parameters' gradients (sums over the batch and
            # map, some near zero ahead of a training BN) at testing's f32
            # state bar
            n_io = 1 + len(xs)
            for i, (g, w) in enumerate(zip(outs[1], outs[0])):
                e = float((g - w).abs().max()) / max(float(w.abs().max()),
                                                     1e-30)
                bar = 1e-4 if i < n_io else TRAIN_STATE_BAR[torch.float32][0]
                if e > bar:
                    raise AssertionError(f"{name} tensor {i}: rel err {e} "
                                         f"above {bar}")
                errs[i < n_io].append(e)
    log("13d", f"profiling: model_info yolov5s_seg at {IMGSZ}: "
        f"{info['params']:,} params (the JAX variables'; {total:,} with the "
        f"2 BNs that never run), {info['gflops']:.3f} GFLOPs (FlopCounter"
        f"Mode, 2 a multiply-add); profile_fn of its first C3 at "
        f"b{B_SERVE} ({c3_in} channels, {IMGSZ // 4}x{IMGSZ // 4}) bf16: "
        f"forward {prof['forward_ms']:.3f} ms, forward and backward "
        f"{prof['backward_ms']:.3f} ms, {prof['gflops']:.3f} GFLOPs; trace "
        f"of one served b{B_VAL} batch: {len(events)} events, {kernels} "
        f"kernels; ARM, ASPPs, RFB1, DAPPM, ConvBNReLU, Classify, Sum "
        f"(plain and weighted) in training mode on the card against the "
        f"CPU (f32, TF32 off): outputs and input gradients within "
        f"{max(errs[True]):.2e}, parameter gradients within "
        f"{max(errs[False]):.2e} of their largest magnitude [{card}]")


def phase13(card: str, sd: dict) -> int:
    """Training and deployment tooling; returns K3's launches."""
    import tempfile

    old = os.environ.get("WANDB_DIR")
    with tempfile.TemporaryDirectory(prefix="chip_smoke_tools_") as tmp:
        os.environ["WANDB_DIR"] = os.path.join(tmp, "wandb")
        try:
            k3, last, root = phase13a(card, tmp)
            phase13b(card)
            phase13c(card, last, root, tmp)
            phase13d(card, sd, tmp)
        finally:
            if old is None:
                os.environ.pop("WANDB_DIR", None)
            else:
                os.environ["WANDB_DIR"] = old
    return k3


B_SP = 8          # 14(c)'s batch
B_SP_FWD = 4      # 14(b)'s batch
SP_TIMED_STEPS = 5
SPATIAL_F32_BAR = 1e-5  # of the largest |output|: bands against one process


def phase14a(card: str, sd: dict) -> dict:
    """Multi-device Predictor; returns K1's and K2's launches."""
    from desenet_tpu_torch.api import Predictor
    from desenet_tpu_torch.ops import nms_fused, seg_pallas

    n_cards = torch.cuda.device_count()
    try:
        Predictor("yolov5s_seg", sd, n_devices=n_cards + 1)
    except ValueError as e:
        if "devices" not in str(e):
            raise
        refused = str(e)
    else:
        raise AssertionError(f"14(a): n_devices={n_cards + 1} was accepted")
    cuda0 = torch.device("cuda", 0)

    def compare(one, two, imgs, what):
        a, b = one.run_batch(imgs), two.run_batch(imgs)
        if not all(len(v) == len(imgs) for v in a + b):
            raise AssertionError(f"{what}: not {len(imgs)} rows")
        nums = bool((a[3] == b[3]).all())
        box = max([match_boxes(torch.from_numpy(b[0][i, :n]),
                               torch.from_numpy(a[0][i, :n]))
                   for i, n in enumerate(a[3].tolist()) if n == b[3][i]]
                  + [0.0])
        seg = float((a[4] == b[4]).mean())
        if not nums or box > 1e-3 or seg < 0.999:
            raise AssertionError(f"{what}: num equal {nums}, box err {box}, "
                                 f"seg agreement {seg}")
        return nums, box, seg

    # f32 (TF32 off): two replicas on the one card against one, on a batch
    # that splits evenly and one that pads
    rng = np.random.default_rng(14)
    imgs = rng.integers(0, 256, (B_SERVE, IMGSZ, IMGSZ, 3), dtype=np.uint8)
    with no_tf32():
        one = Predictor("yolov5s_seg", sd, half=False, conf_thres=1e-3)
        two = Predictor("yolov5s_seg", sd, half=False, conf_thres=1e-3)
        two._place_replicas([cuda0, cuda0])
        f32 = [compare(one, two, imgs[:n], f"14(a) f32 b{n}")
               for n in (16, 15)]
        del one, two
    log("14a", f"n_devices={n_cards + 1} refused ({refused!r}); f32 (TF32 "
        f"off) two replicas on the one card against n_devices=1, "
        f"yolov5s_seg {IMGSZ} px: b16 and b15 (padded to 16) num equal "
        f"{[r[0] for r in f32]}, boxes within "
        f"{max(r[1] for r in f32):.3g} (atol 1e-3), seg maps "
        f"{min(r[2] for r in f32):.6f} equal (>= 0.999)")

    # bf16 at b128 and b127: the served shape, timed in turns
    one = Predictor("yolov5s_seg", sd, conf_thres=1e-3)
    two = Predictor("yolov5s_seg", sd, conf_thres=1e-3)
    two._place_replicas([cuda0, cuda0])
    nms_fused.launches = seg_pallas.launches = 0
    bf16 = [compare(one, two, imgs[:n], f"14(a) bf16 b{n}")
            for n in (B_SERVE, B_SERVE - 1)]
    k1, k2 = nms_fused.launches, seg_pallas.launches
    if k1 != 6 or k2 != 6:  # one + two replicas, two batches
        raise AssertionError(f"14(a): K1 launched {k1}, K2 {k2} times "
                             "(6 each expected)")
    ms_one, ms_two = in_turns((lambda: one.run_batch(imgs), 3),
                              (lambda: two.run_batch(imgs), 3))
    log("14a", f"bf16 yolov5s_seg b{B_SERVE}/{IMGSZ}, run_batch (letterboxed "
        f"uint8 in, numpy out): n_devices=1 {ms_one:.3f} ms, two replicas "
        f"on the one card {ms_two:.3f} ms ({ms_two / ms_one:.3f}x); "
        f"against one replica at b{B_SERVE} and b{B_SERVE - 1}: num equal "
        f"{[r[0] for r in bf16]}, boxes within "
        f"{max(r[1] for r in bf16):.3g} (atol 1e-3), seg maps "
        f"{[round(r[2], 6) for r in bf16]} equal (>= 0.999); K1 {k1}, K2 "
        f"{k2} launches [{card}]")
    del one, two
    launches = {"nms_fused": k1, "seg_tail": k2}
    if n_cards >= 2:
        one = Predictor("yolov5s_seg", sd, conf_thres=1e-3)
        multi = Predictor("yolov5s_seg", sd, conf_thres=1e-3, n_devices=2)
        nms_fused.launches = seg_pallas.launches = 0
        r = compare(one, multi, imgs, "14(a) two cards")
        launches["nms_fused"] += nms_fused.launches
        launches["seg_tail"] += seg_pallas.launches
        ms_one, ms_two = in_turns((lambda: one.run_batch(imgs), 3),
                                  (lambda: multi.run_batch(imgs), 3))
        log("14a", f"n_devices=2 on two cards: {ms_two:.3f} ms against "
            f"{ms_one:.3f} on one; num equal {r[0]}, seg {r[2]:.6f} equal "
            f"[{card}]")
        del one, multi
    torch.cuda.empty_cache()
    return launches


def _s_model(train: bool):
    """yolov5s_seg at full width, seed-0 weights, 1/8 seg logits, on the
    card (channels_last)."""
    from desenet_tpu_torch.models import build_model, config_path, init_weights

    model, spec = build_model(config_path("yolov5s_seg"), seg_upsample=False,
                              train=train)
    init_weights(model, torch.Generator().manual_seed(0))
    return model.to("cuda:0", memory_format=torch.channels_last), spec


def _sp_forward(mesh=None):
    """14(b): the f32 eval forward of B_SP_FWD seeded images (this rank's
    bands under ``mesh``); (decode, 1/8 seg logits, the 1/8 seg logits of
    the seg head as kernel K4, which takes the gathered maps under
    ``mesh``) on the CPU."""
    import contextlib

    from desenet_tpu_torch.parallel import spatial
    from desenet_tpu_torch.parallel.mesh import spatial_band

    model, _ = _s_model(False)
    model.eval()
    x = torch.from_numpy(np.random.default_rng(15).integers(
        0, 256, (B_SP_FWD, IMGSZ, IMGSZ, 3), dtype=np.uint8))
    if mesh is not None:
        x = spatial_band({"image": x}, mesh)["image"]
    x = x.to("cuda:0").permute(0, 3, 1, 2).float().div(255).contiguous(
        memory_format=torch.channels_last)
    band = (spatial.scope(mesh, IMGSZ) if mesh is not None
            else contextlib.nullcontext())
    with torch.no_grad(), band:
        (dec, _), seg = model(x)
        model.seg_head_fused = True
        seg_k4 = model(x)[1]
    return dec.cpu(), seg.float().cpu(), seg_k4.float().cpu()


def _sp_bf16_steps(mesh=None) -> tuple:
    """14(c): yolov5s_seg training steps at b{B_SP}/640 in bf16 (this
    rank's bands under ``mesh``): (ms a step over SP_TIMED_STEPS after two
    warm ones, peak allocated GiB over them)."""
    from desenet_tpu_torch.testing import train_batch
    from desenet_tpu_torch.train import create_train_state, make_train_step
    from desenet_tpu_torch.train.engine import load_hyp, loss_and_schedule

    model, spec = _s_model(True)
    det_loss, opt_cfg, lf = loss_and_schedule(load_hyp(), spec, IMGSZ, 10)
    state = create_train_state(model, opt_cfg)
    step = make_train_step(model, det_loss, opt_cfg, lf, nb=4,
                           warmup_iters=2, nominal_bs=B_SP, batch_size=B_SP,
                           fused_seg=True, dtype=torch.bfloat16, mesh=mesh)
    batch = {k: torch.from_numpy(v).to("cuda:0") for k, v in train_batch(
        np.random.default_rng(16), B_SP, IMGSZ, spec.de_nc, 16).items()}
    for _ in range(2):
        state, m = step(state, batch)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    for _ in range(SP_TIMED_STEPS):
        state, m = step(state, batch)
    loss = float(m["loss"])
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t) / SP_TIMED_STEPS * 1e3
    if not np.isfinite(loss):
        raise AssertionError(f"14(c): bf16 loss {loss}")
    return ms, torch.cuda.max_memory_allocated() / 2 ** 30


def _sp_rank(rank: int, n: int, coordinator: str, step_kw: dict) -> dict:
    """14(b) and (c) in one of two ranks of the one card (gloo): the band
    forward, the f32 step, the bf16 steps; every rank's bf16 numbers."""
    import torch.distributed as dist

    from desenet_tpu_torch.parallel import multihost
    from desenet_tpu_torch.parallel.mesh import make_mesh
    from desenet_tpu_torch.testing import train_steps

    multihost.init_multihost(coordinator, n, rank, device="cuda:0",
                             backend="gloo")
    try:
        mesh = make_mesh(n, spatial=n)
        with no_tf32():
            fwd = _sp_forward(mesh)
            steps = train_steps("cuda:0", spatial=n, **step_kw)
        bf16 = [None] * n
        dist.all_gather_object(bf16, _sp_bf16_steps(mesh))
        return {"fwd": fwd, "steps": steps, "bf16": bf16}
    finally:
        multihost.shutdown()


def phase14(card: str, sd: dict) -> dict:
    """The parallel layer: (a) the multi-device Predictor, (b) and (c) the
    spatial forward and step of two ranks of the one card against one
    process, (c) cli.train --spatial 2, (d) the dp2 x sp2 dry run; returns
    K1's, K2's and K3's launches."""
    import tempfile

    from desenet_tpu_torch.models import config_path
    from desenet_tpu_torch.ops import nms_pallas
    from desenet_tpu_torch.parallel.multihost import spawn
    from desenet_tpu_torch.testing import (check_train_parity, parity_errors,
                                           train_steps)
    from desenet_tpu_torch.tools.make_fake_dataset import generate

    launches = phase14a(card, sd)

    with open(config_path("yolov5s_seg")) as fh:
        cfg = json.load(fh)
    step_kw = dict(cfg=cfg, imgsz=IMGSZ, b=B_SP, fused=True,
                   dtype=torch.float32, steps=1, seed=0)
    t = time.perf_counter()
    got = spawn(_sp_rank, 2, step_kw)
    wall = time.perf_counter() - t
    with no_tf32():
        want_fwd = _sp_forward()
        want_steps = train_steps("cuda:0", **step_kw)
    errs = []
    for g, w, what in zip(got["fwd"], want_fwd,
                          ("decode", "1/8 seg logits", "K4's 1/8 seg logits")):
        if g.shape != w.shape or not bool(torch.isfinite(g).all()):
            raise AssertionError(f"14(b) {what}: {tuple(g.shape)} vs "
                                 f"{tuple(w.shape)}")
        rel = float((g - w).abs().max()) / float(w.abs().max())
        if rel > SPATIAL_F32_BAR:
            raise AssertionError(f"14(b) {what}: {rel} of the largest "
                                 f"|output| above {SPATIAL_F32_BAR}")
        errs.append(rel)
    log("14b", f"spatial eval forward, yolov5s_seg b{B_SP_FWD}/{IMGSZ} f32 "
        f"(TF32 off), dp1 x sp2 in two ranks of the one card (gloo) against "
        f"one process: decode {errs[0]:.3g}, 1/8 seg logits {errs[1]:.3g}, "
        f"K4 on the gathered maps {errs[2]:.3g} of the largest |output| "
        f"(bar {SPATIAL_F32_BAR:g})")
    perrs = parity_errors(got["steps"], want_steps)
    check_train_parity(perrs, torch.float32, "14(c) dp1 x sp2 f32 step")
    (ms_sp, peak_sp), (ms_sp1, peak_sp1) = got["bf16"]
    ms_one, peak_one = _sp_bf16_steps()
    log("14c", f"spatial training step, yolov5s_seg b{B_SP}/{IMGSZ}, dp1 x "
        f"sp2 in two ranks of the one card against one process: f32 (TF32 "
        f"off) one step loss {got['steps'][0][0]:.6f} against "
        f"{want_steps[0][0]:.6f}, errors "
        + ", ".join(f"{g} {e:.2e}" if g == "loss" else f"{g} {e[0]:.2e}"
                    for g, e in perrs[0].items())
        + f" (testing's f32 bars); bf16 step {ms_sp:.3f} / {ms_sp1:.3f} ms "
        f"(ranks 0 / 1, gloo through the host) against {ms_one:.3f} ms in one "
        f"process; peak allocated {peak_sp:.3f} / {peak_sp1:.3f} GiB a rank "
        f"against {peak_one:.3f} GiB ({peak_sp / peak_one:.3f}x); "
        f"{wall:.3f} s for the two ranks with their start [{card}]")

    # cli.train --spatial 2 in the two ranks, the EMA validated on rank 0
    with tempfile.TemporaryDirectory(prefix="chip_smoke_sp_") as tmp:
        data = generate(os.path.join(tmp, "fakeds"), n_train=16, n_val=8,
                        size=IMGSZ, seed=0)
        nms_pallas.launches = 0
        t = time.perf_counter()
        res, k3 = spawn(_rank_train, 2, _Argv(data, tmp, extra=(
            "--spatial", "2", "--batch-size", str(B_SP))))
        wall = time.perf_counter() - t
        sd0 = os.path.join(tmp, "rank0", "dp")
        with open(os.path.join(sd0, "results.csv")) as fh:
            row = list(csv.DictReader(fh))[-1]
        if (k3 < 1 or nms_pallas.launches
                or os.path.exists(os.path.join(tmp, "rank1"))
                or not np.isfinite(float(row["train/seg_loss"]))):
            raise AssertionError(f"14(c): K3 launched {k3} times on rank 0, "
                                 f"rank 1 wrote "
                                 f"{os.path.exists(os.path.join(tmp, 'rank1'))}"
                                 f", row {row}")
    log("14c", f"cli.train --spatial 2 in two ranks of the one card (gloo), "
        f"yolov5s_seg b{B_SP}/{IMGSZ} bf16, 1 epoch on a fake dataset of 16: "
        f"seg loss {float(row['train/seg_loss']):.4f}, the EMA validated on "
        f"rank 0's card unsharded, K3 launched {k3} times; {wall:.3f} s "
        f"wall with the processes' start [{card}]")
    launches["nms_greedy"] = k3

    # (d) the dry run: dp2 on 4 gloo ranks of the card, then dp2 x sp2
    t = time.perf_counter()
    out = subprocess.run([sys.executable, "-m",
                          "desenet_tpu_torch.tools.dryrun_multichip",
                          "--nproc", "4"], capture_output=True, text=True,
                         timeout=600)
    lines = [ln for ln in out.stdout.splitlines()
             if ln.startswith("dryrun_multichip(4): ok")]
    if out.returncode or len(lines) != 2:
        raise AssertionError(f"14(d): rc {out.returncode}, "
                             f"{out.stdout[-2000:]} {out.stderr[-3000:]}")
    for ln in lines:
        log("14d", f"{ln} [{time.perf_counter() - t:.1f} s; {card}]")
    return launches


B_S2D_F32 = 16   # the f32 stem_s2d check (TF32 off)
S2D_TURNS = 5    # run_batch timings of each stem at b128, in turns
S2D_STEM_BAR = 1e-5  # the stem's output, of its largest magnitude
S2D_F32_BAR = 1e-3   # decode / seg logits, of the largest magnitude
F8_CFGS = ("exotic", "BiSe", "Lab", "Base")


def _served_forward(pred, x_u8: torch.Tensor):
    """The Predictor's model on its device batch, as ``infer`` feeds it:
    (decode, 1/8 seg logits NCHW)."""
    x = x_u8.permute(0, 3, 1, 2).to(pred.dtype)
    x = x.contiguous(memory_format=torch.channels_last) / 255
    with torch.inference_mode():
        (dec, _), seg = pred.model(x)
    return dec, seg


def _stem_device_ms(model, x: torch.Tensor) -> tuple:
    """(device ms a call, kernel rows) of rows 0 and 1 of ``model`` on
    ``x`` by the profiler (tools/timing.kernel_table)."""
    from desenet_tpu_torch.tools.timing import kernel_table

    def stem():
        with torch.inference_mode():
            return model.model[1](model.model[0](x))

    rows = kernel_table(stem, x.device)
    return sum(ms for _, ms, _ in rows), rows


def phase15a(card: str, sd: dict) -> dict:
    """(a) the phase-layout stem at full width: f32 against the FusedFocus
    stem on boosted weights (testing.boosted_state: activations that do
    not fade through the depth), K1 and K2 on its outputs against their
    plain versions, then the bf16 served program of both stems at b128/640
    on ``sd`` in turns, the stems' kernels by the profiler and the host's
    s2d packing."""
    from desenet_tpu_torch import native
    from desenet_tpu_torch.api import Predictor
    from desenet_tpu_torch.models import build_model, config_path
    from desenet_tpu_torch.models import layers as L
    from desenet_tpu_torch.ops import nms_fused, seg_pallas
    from desenet_tpu_torch.testing import boosted_state

    dev = torch.device("cuda")
    boosted = boosted_state(build_model(config_path("yolov5s_seg"))[0])
    rng = np.random.default_rng(15)
    imgs = [rng.integers(0, 256, (IMGSZ, IMGSZ, 3), dtype=np.uint8)
            for _ in range(B_SERVE)]
    # f32, TF32 off: the two stems on one b16 batch
    std = Predictor("yolov5s_seg", boosted, imgsz=IMGSZ, half=False,
                    device="cuda")
    s2d = Predictor("yolov5s_seg", boosted, imgsz=IMGSZ, half=False,
                    device="cuda", stem_s2d=True)
    if s2d.stem_s2d is not True or std.stem_s2d is not False or not all(
            isinstance(s2d.model.model[i], c)
            for i, c in ((0, L.PhaseStemA), (1, L.PhaseStemB))):
        raise AssertionError("Predictor(stem_s2d=True) built no phase stem")
    few = imgs[:B_S2D_F32]
    xb = torch.from_numpy(np.stack(few)).to(dev)
    xs = torch.from_numpy(native.assemble_batch_s2d4(few)).to(dev)
    with no_tf32():
        dec_b, seg_b = _served_forward(std, xb)
        dec_s, seg_s = _served_forward(s2d, xs)
        with torch.inference_mode():
            stem_b = std.model.model[1](std.model.model[0](
                xb.permute(0, 3, 1, 2).float().contiguous(
                    memory_format=torch.channels_last) / 255))
            stem_s = s2d.model.model[1](s2d.model.model[0](
                xs.permute(0, 3, 1, 2).float().contiguous(
                    memory_format=torch.channels_last) / 255))
    torch.cuda.synchronize()
    errs = {n: float((a - b).abs().max() / b.abs().max()) for n, a, b in (
        ("stem", stem_s, stem_b), ("decode", dec_s, dec_b),
        ("seg logits", seg_s, seg_b))}
    if errs["stem"] > S2D_STEM_BAR or max(errs.values()) > S2D_F32_BAR \
            or not torch.isfinite(dec_s).all():
        raise AssertionError(f"stem_s2d f32 against the FusedFocus stem: "
                             f"{errs} (bars {S2D_STEM_BAR}, {S2D_F32_BAR})")
    # K1 on the phase stem's decode (conf 0.001: thousands of candidates)
    planes = nms_fused.nms_planes(dec_s, 0.001)
    got = nms_fused.greedy_select(*planes, 300, 0.45)
    if not torch.equal(got, nms_fused.greedy_select_plain(*planes, 300,
                                                          0.45)):
        raise AssertionError("K1 on the stem_s2d decode differs from plain")
    n_cand = int((planes[4] > 0).sum())
    # K2 on both stems' seg logits: each equal to plain, the maps agreeing
    maps = []
    for seg in (seg_s, seg_b):
        nhwc = seg.permute(0, 2, 3, 1).contiguous()
        h, w = nhwc.shape[1:3]
        k2 = seg_pallas.upsample_argmax(nhwc)
        plain = seg_pallas.upsample_argmax_plain(
            nhwc, *seg_pallas.seg_taps(h, 8 * h, True, dev),
            *seg_pallas.seg_taps(w, 8 * w, True, dev))
        if not torch.equal(k2, plain):
            raise AssertionError("K2 on the stem_s2d seg logits differs "
                                 "from plain")
        maps.append(k2)
    agree = float((maps[0] == maps[1]).float().mean())
    if agree < 0.999:
        raise AssertionError(f"stem_s2d seg map equal on {agree} only")
    log("15a", f"yolov5s_seg f32 b{B_S2D_F32}/{IMGSZ} (TF32 off), phase "
        f"stem against FusedFocus: stem output, decode and seg logits "
        f"within {errs['stem']:.2e}, {errs['decode']:.2e}, "
        f"{errs['seg logits']:.2e} of their largest magnitude (bars "
        f"{S2D_STEM_BAR}, {S2D_F32_BAR}, boosted weights); K1 on its "
        f"decode ({n_cand} candidates at conf 0.001) equal to plain, K2 on both stems' logits equal to plain, "
        f"seg maps equal on {agree:.6f} [{card}]")
    del std, s2d

    # bf16 b128/640: the served program of both stems in turns
    std = Predictor("yolov5s_seg", sd, imgsz=IMGSZ, half=True, device="cuda")
    s2d = Predictor("yolov5s_seg", sd, imgsz=IMGSZ, half=True, device="cuda",
                    stem_s2d=True)
    host = {"np.stack": [], "assemble_batch": [], "assemble_batch_s2d4": []}
    for _ in range(S2D_TURNS):
        for name, fn in (("np.stack", np.stack),
                         ("assemble_batch", native.assemble_batch),
                         ("assemble_batch_s2d4", native.assemble_batch_s2d4)):
            t = time.perf_counter()
            fn(imgs)
            host[name].append((time.perf_counter() - t) * 1e3)
    bb = np.stack(imgs)
    bs = native.assemble_batch_s2d4(imgs)
    for pr, b in ((std, bb), (s2d, bs)):
        pr.run_batch(b)  # warm
    nms_fused.launches = seg_pallas.launches = 0
    ms = {"FusedFocus": [], "phase": []}
    order = [("FusedFocus", std, bb), ("phase", s2d, bs)]
    for i in range(S2D_TURNS):
        for name, pr, b in (order if i % 2 == 0 else order[::-1]):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = pr.run_batch(b)
            ms[name].append((time.perf_counter() - t) * 1e3)
    k = {"nms_fused": nms_fused.launches, "seg_tail": seg_pallas.launches}
    if k != {"nms_fused": 2 * S2D_TURNS, "seg_tail": 2 * S2D_TURNS}:
        raise AssertionError(f"served program launches {k}")
    if out[4].shape != (B_SERVE, IMGSZ, IMGSZ) or not np.isfinite(
            out[1]).all():
        raise AssertionError("stem_s2d served program: bad outputs")
    # the stems alone: profiler kernel time, and l1's two paddings
    x16 = {}
    for name, pr, b in order:
        x16[name] = torch.from_numpy(b).to(dev).permute(0, 3, 1, 2).to(
            torch.bfloat16).contiguous(memory_format=torch.channels_last) / 255
    stem_ms = {name: _stem_device_ms(pr.model, x16[name])
               for name, pr, _ in order}
    with torch.inference_mode():
        y0 = s2d.model.model[0](x16["phase"])
        w2 = L.phase_stem_kernel_b(s2d.model.model[1].conv.weight).to(
            y0.dtype)
        pad_crop, pad_copy = in_turns(
            (lambda: torch.nn.functional.conv2d(y0, w2, None, 1, 1)
             [:, :, :-1, :-1].contiguous(
                 memory_format=torch.channels_last), 10),
            (lambda: torch.nn.functional.conv2d(
                torch.nn.functional.pad(y0, (1, 0, 1, 0)), w2), 10))
    med = {n: float(np.median(v)) for n, v in ms.items()}
    spread = {n: (min(v), max(v)) for n, v in ms.items()}
    hmed = {n: float(np.median(v)) for n, v in host.items()}
    log("15a", f"yolov5s_seg bf16 b{B_SERVE}/{IMGSZ} run_batch in turns "
        f"({S2D_TURNS} each): FusedFocus median {med['FusedFocus']:.3f} ms "
        f"(min {spread['FusedFocus'][0]:.3f}, max "
        f"{spread['FusedFocus'][1]:.3f}), phase stem median "
        f"{med['phase']:.3f} ms (min {spread['phase'][0]:.3f}, max "
        f"{spread['phase'][1]:.3f}); launches {k} [{card}]")
    for name, (tot, rows) in stem_ms.items():
        log("15a", f"{name} stem (rows 0 and 1) bf16 b{B_SERVE}/{IMGSZ}: "
            f"{tot:.3f} ms of kernels a call by the profiler, "
            + "; ".join(f"{r[0][:60]} {r[1]:.3f} ms x{r[2]:.0f}"
                        for r in rows[:6]) + f" [{card}]")
    log("15a", f"l1' 2x2 conv bf16 b{B_SERVE}: pad 1 and drop the last row "
        f"and column {pad_crop:.3f} ms, F.pad (1, 0) then conv "
        f"{pad_copy:.3f} ms (in turns) [{card}]")
    log("15a", f"host packing of {B_SERVE} images at {IMGSZ} (median of "
        f"{S2D_TURNS}): " + ", ".join(f"{n} {v:.3f} ms"
                                      for n, v in hmed.items())
        + f" [{card}]")
    return k


def _f8_cfg(name: str) -> dict:
    """The exotic config, or tiny_psp2 with the BiSe, Lab or Base head."""
    import copy

    from desenet_tpu_torch.testing import EXOTIC_CFG

    if name == "exotic":
        return copy.deepcopy(EXOTIC_CFG)
    cfg = tiny_cfg()
    cfg["head"][-2] = [[16, 19, 22], 1, f"SegMask{name}", ["se_nc", 1, 256]]
    return cfg


def _f8_state(model) -> dict:
    """Seeded weights with O(1) activations: init_weights, BN biases
    offset by 0.05 cos(i) (the JAX package's tests/test_fp8_store.py
    fixture)."""
    from desenet_tpu_torch.models import init_weights

    sd = init_weights(model, torch.Generator().manual_seed(15)).state_dict()
    for k, v in sd.items():
        if k.endswith("bias") and v.is_floating_point():
            sd[k] = v + 0.05 * torch.cos(torch.arange(v.numel(),
                                                      dtype=v.dtype))
    return sd


def phase15b(card: str) -> int:
    """(b) fp8 storage over every row: the exotic config and the BiSe, Lab
    and Base heads at 64 px, then cli.val --act-store fp8 on a config with
    a Ghost row; returns K3's launches."""
    import tempfile

    from desenet_tpu_torch.models import build_model, config_path
    from desenet_tpu_torch.models.build import det_fp_layers
    from desenet_tpu_torch.ops import nms_pallas
    from desenet_tpu_torch.utils.convert import load_state_dict

    dev = torch.device("cuda")
    x = torch.rand((2, 3, 64, 64), generator=torch.Generator().manual_seed(15))
    for name in F8_CFGS:
        cfg = _f8_cfg(name)
        sd = _f8_state(build_model(cfg)[0])
        outs = {}
        for key, store, dt, d in (("cpu64", "fp8", torch.float64, "cpu"),
                                  ("cuda64", "fp8", torch.float64, "cuda"),
                                  ("cuda16", "fp8", torch.bfloat16, "cuda"),
                                  ("cuda16_plain", None, torch.bfloat16,
                                   "cuda")):
            m, spec = build_model(cfg, fuse_focus=True, act_store=store)
            load_state_dict(m, sd)
            m = m.to(d, dt).eval()
            rows, run = {}, m._row

            def record(ls, mod, inp, cd, qmode, rows=rows, run=run):
                rows[ls.i] = out = run(ls, mod, inp, cd, qmode)
                return out

            m._row = record
            with torch.inference_mode(), no_tf32():
                (dec, feats), seg = m(x.to(d, dt))
            outs[key] = ([f.double().cpu() for f in feats]
                         + ([] if seg is None else [seg.double().cpu()]),
                         rows, spec, dec.double().cpu())
        got, rows, spec, _ = outs["cuda64"]
        # test_torch_act_store.py's bars: rtol 1e-5, atol 1e-5 of the
        # largest magnitude (float64 on both devices: no f32 sum moves a
        # value across an e4m3 rounding boundary)
        for a, b in zip(got, outs["cpu64"][0]):
            if not torch.isfinite(a).all() or not bool(
                    ((a - b).abs() <= 1e-5 * b.abs()
                     + 1e-5 * b.abs().max()).all()):
                raise AssertionError(f"fp8 {name} float64 CUDA vs CPU: "
                                     f"{float((a - b).abs().max())}")
        fp_rows = det_fp_layers(spec, 1)
        f8_rows = [ls.i for ls in spec.layers
                   if isinstance(rows[ls.i], torch.Tensor)
                   and rows[ls.i].dtype == torch.float8_e4m3fn]
        _, rows16, _, dec16 = outs["cuda16"]
        bad = [ls.i for ls in spec.layers if ls.i in fp_rows and isinstance(
            rows16[ls.i], torch.Tensor) and rows16[ls.i].dtype
            == torch.float8_e4m3fn]
        if not f8_rows or bad:
            raise AssertionError(f"fp8 {name}: float8 rows {f8_rows}, "
                                 f"det rows stored float8 {bad}")
        # bf16 against the bf16 model without storage: the decode at the
        # JAX package's bars (tests/test_fp8_store.py: rtol 0.35, atol 5%
        # of its largest magnitude); the seg logits of the deeper heads
        # carry e4m3's rounding through more stores than that test's PSP2
        # head (Base's reach 9% of their largest magnitude on the CPU), so
        # they are held to a cosine of at least 0.995 with the bf16 logits
        # and to 25% of their largest magnitude
        dec0 = outs["cuda16_plain"][3]
        if not torch.isfinite(dec16).all() or not bool(
                ((dec16 - dec0).abs() <= 0.35 * dec0.abs()
                 + 0.05 * dec0.abs().max()).all()):
            raise AssertionError(f"fp8 {name} bf16 decode against bf16: "
                                 f"{float((dec16 - dec0).abs().max())}")
        errs = [float((dec16 - dec0).abs().max() / dec0.abs().max())]
        cos = None
        if spec.seg_layer >= 0:
            a, b = outs["cuda16"][0][-1], outs["cuda16_plain"][0][-1]
            cos = float((a * b).sum() / (a.norm() * b.norm()))
            errs.append(float((a - b).abs().max() / b.abs().max()))
            if not torch.isfinite(a).all() or cos < 0.995 or errs[-1] > 0.25:
                raise AssertionError(f"fp8 {name} bf16 seg logits against "
                                     f"bf16: cosine {cos}, {errs[-1]}")
        log("15b", f"fp8 storage, {name} at 64 px b2: float64 on CUDA "
            f"equal to the CPU's within 1e-5 of the largest magnitude, "
            f"float8 rows {f8_rows} (rows feeding Detect {sorted(fp_rows)} "
            f"in the compute dtype); bf16 decode and seg logits finite, "
            f"within {errs} of the bf16 model's largest magnitudes, seg "
            f"cosine {cos} [{card}]")

    # cli.val --act-store fp8 on yolov5s_seg with a C3Ghost row
    import cv2  # noqa: F401
    import PIL  # noqa: F401

    from desenet_tpu_torch.cli import val as cli_val
    from desenet_tpu_torch.models import init_weights
    from desenet_tpu_torch.tools.make_fake_dataset import generate

    with open(config_path("yolov5s_seg")) as fh:
        cfg = json.load(fh)
    cfg["backbone"][4] = [-1, 3, "C3Ghost", [256]]
    launches = 0
    with tempfile.TemporaryDirectory(prefix="chip_smoke_fp8_") as tmp:
        data = generate(os.path.join(tmp, "ds"), n_train=4, n_val=16,
                        size=320, seed=15)
        cfg_path = os.path.join(tmp, "ghost.json")
        with open(cfg_path, "w") as fh:
            json.dump(cfg, fh)
        from desenet_tpu_torch.utils.general import check_dataset

        ds = check_dataset(data)
        m, _ = build_model(cfg, nc=int(ds["de"]["nc"]),
                           se_nc=int(ds["se"]["nc"]))
        npz = os.path.join(tmp, "sd.npz")
        np.savez(npz, **{k: v.numpy() for k, v in init_weights(
            m, torch.Generator().manual_seed(15)).state_dict().items()})
        nms_pallas.launches = 0
        t = time.perf_counter()
        r = cli_val.main(["--data", data, "--cfg", cfg_path, "--weights",
                          npz, "--batch-size", "16", "--img-size", "320",
                          "--device", "cuda", "--workers", "2",
                          "--act-store", "fp8", "--save-dir",
                          os.path.join(tmp, "val")])
        wall = time.perf_counter() - t
        launches = nms_pallas.launches
    if r["seen"] != 16 or launches < 1 or not all(
            0.0 <= r[k] <= 1.0 for k in ("miou", "pix_acc", "map50")):
        raise AssertionError(f"cli.val --act-store fp8 (C3Ghost): {r}, K3 "
                             f"launches {launches}")
    log("15b", f"cli.val --act-store fp8, yolov5s_seg with a C3Ghost row, "
        f"one b16/320 batch of fake images: mIoU {r['miou']:.4f}, mAP50 "
        f"{r['map50']:.4f}, {wall:.3f} s wall, K3 launches {launches} "
        f"[{card}]")
    return launches


def phase15c(card: str, errs: dict, extras: dict) -> int:
    """(c) the grouped int8 conv: the kernel against its plain version at
    testing.INT8_GROUPED_CASES, timed beside its bound, then the int8
    model of testing.GROUPED_CFG on the card against the CPU; returns the
    kernel's launches on that forward."""
    from desenet_tpu_torch import quant as Q
    from desenet_tpu_torch.models import build_model
    from desenet_tpu_torch.ops import int8_conv
    from desenet_tpu_torch.testing import (GROUPED_CFG, INT8_GROUPED_CASES,
                                           boosted_state, check_int8,
                                           int8_conv_case)
    from desenet_tpu_torch.utils.convert import load_state_dict

    rows, err = [], 0.0
    for case in INT8_GROUPED_CASES:
        c = int8_conv_case(case, "cuda")
        parts, p = c["parts"], c["prep"]
        args = {k: c[k] for k in ("residual", "res_scale", "out_scale", "act",
                                  "out_mode")}
        raw = int8_conv.run(parts, p, out_mode=int8_conv.OUT_I32)
        if not torch.equal(raw, int8_conv.int8_conv_plain(
                parts, p, out_mode=int8_conv.OUT_I32)):
            raise AssertionError(f"grouped int8 conv {case[0]}: int32 sums "
                                 f"differ from plain")
        want = int8_conv.int8_conv_plain(parts, p, **args)
        e = check_int8(int8_conv.run(parts, p, **args), want, case[0])
        err = max(err, e)
        pl, k = in_turns(
            (lambda: int8_conv.int8_conv_plain(parts, p, **args), 2),
            (lambda: int8_conv.run(parts, p, **args), 20))
        b, cin, h, w = parts[0].shape
        o, _, kh, kw = p.qw.shape
        ho, wo = want.shape[2:]
        bound, by = tm.int8_conv_bound(b, h, w, cin, ho, wo, o, kh, kw, 1,
                                       args["residual"] is not None,
                                       p.groups)
        macs = tm.int8_conv_macs(b, ho, wo, cin, o, kh, kw, p.groups)
        rows.append({"case": case[0], "groups": p.groups, "ms": k,
                     "plain_ms": pl, "bound_ms": bound, "bound_by": by,
                     "library_ms": None})
        log("15c", f"grouped int8_conv {case[0]} ({b}, {h}, {w}, {cin}) -> "
            f"({o}, {ho}, {wo}) k{kh} s{p.stride} g{p.groups}: kernel "
            f"{k:.4f} ms ({2 * macs / k / 1e9:.1f} TOP/s), plain {pl:.3f} ms,"
            f" bound {bound:.4f} ms ({by}); int32 sums equal, max |diff| "
            f"after the epilogue {e} [{card}]")
    errs["int8_conv"] = max(errs.get("int8_conv", 0.0), err)
    extras.setdefault("int8_conv", {})["grouped"] = rows

    cfg = GROUPED_CFG
    sd = boosted_state(build_model(cfg)[0], seed=0)
    x = torch.rand((2, 3, 64, 64), generator=torch.Generator().manual_seed(1))
    cm, _ = build_model(cfg, fuse_focus=True,
                        quant=Q.QuantCfg(mode="calib"))
    load_state_dict(cm, sd)
    scales, means = Q.calibrate_stats(cm.eval(), [x])
    qcfg = Q.QuantCfg(mode="int8", scales=scales, in_means=means)
    outs, launches = [], 0
    for dev in ("cpu", "cuda"):
        m, _ = build_model(cfg, fuse_focus=True, quant=qcfg)
        load_state_dict(m, sd)
        mf = (torch.channels_last if dev == "cuda"
              else torch.contiguous_format)
        m = m.to(dev, memory_format=mf).eval()
        int8_conv.launches = 0
        with torch.no_grad(), no_tf32():
            (_, feats), _ = m(x.to(dev).contiguous(memory_format=mf))
        if dev == "cuda":
            torch.cuda.synchronize()
            launches = int8_conv.launches
        outs.append([f.float().cpu() for f in feats])
    n_grouped = sum(1 for mod in m.modules()
                    if getattr(getattr(mod, "conv", None), "groups", 1) > 1
                    and getattr(mod, "quant", None) is not None)
    fe = max(float((a - b).abs().max() / b.abs().max())
             for a, b in zip(outs[1], outs[0]))
    if fe > 0.02 or launches < n_grouped or n_grouped < 5:
        raise AssertionError(f"grouped int8 model on CUDA vs CPU: {fe}, "
                             f"launches {launches}, grouped convs "
                             f"{n_grouped}")
    log("15c", f"testing.GROUPED_CFG int8 on CUDA against the CPU's plain "
        f"convs: det features within {fe:.2e} of their largest magnitude "
        f"(bar 0.02); {launches} int8_conv launches, {n_grouped} of them "
        f"grouped convs [{card}]")
    return launches


def phase15(card: str, sd: dict, errs: dict, extras: dict) -> dict:
    """The last unported modules: (a) the phase-layout stem, (b) fp8
    storage over every row, (c) the grouped int8 conv."""
    k = dict(phase15a(card, sd), nms_greedy=phase15b(card))
    k["int8_conv"] = phase15c(card, errs, extras)
    return k


B_IMPORT_F32 = 8        # the f32 check of the imported checkpoint (TF32 off)
IMPORT_TURNS = 5        # timed b128 run_batch calls of the imported one
IMPORT_F32_BAR = 1e-6   # decode / seg logits against the direct Predictor,
IMPORT_BF16_BAR = 1e-3  # of their largest magnitude (the same weights)


def _mb(path: str) -> float:
    """MB of a file, or of the files under a directory."""
    if os.path.isfile(path):
        return os.path.getsize(path) / 1e6
    return sum(os.path.getsize(os.path.join(d, f))
               for d, _, fs in os.walk(path) for f in fs) / 1e6


def _held(pairs, bar: float, what: str) -> dict:
    """Max |a - b| of each (name, a, b) over b's largest magnitude, each
    finite and within ``bar``."""
    errs = {}
    for name, a, b in pairs:
        if not torch.isfinite(a).all():
            raise AssertionError(f"{what}: {name} is not finite")
        errs[name] = float((a.float() - b.float()).abs().max()
                           / b.float().abs().max())
    if max(errs.values()) > bar:
        raise AssertionError(f"{what}: {errs} (bar {bar})")
    return errs


def phase16(card: str, extras: dict) -> dict:
    """The reference-checkpoint route: (a) full-width yolov5s_seg on
    boosted weights (testing.boosted_state: K1 gets candidates) written as
    a port checkpoint, exported by tools/export_torch_sd, loaded into a
    port DeSeNet in half and pickled as the reference's train.py saves
    one; (b) imported by tools/import_torch_ckpt and served through
    load_predictor; (c) its decode and seg logits against a Predictor of
    the half-rounded weights built directly (f32 at b8 with TF32 off, bf16
    at b128), K1 and K2 on its b128 decode and logits against their plain
    versions (K1 timed there beside plain and its bound), then b128/640
    uint8 batches through run_batch with K1's and K2's counters reset
    before and read after; (d) the export's and import's seconds, the
    artifacts' MB and the served ms a batch."""
    import tempfile

    from desenet_tpu_torch.api import Predictor, load_predictor
    from desenet_tpu_torch.models import build_model, config_path
    from desenet_tpu_torch.ops import nms_fused, seg_pallas
    from desenet_tpu_torch.testing import boosted_state
    from desenet_tpu_torch.tools import export_torch_sd, import_torch_ckpt
    from desenet_tpu_torch.train.state import bn_stats, trainable
    from desenet_tpu_torch.utils.checkpoint import _write
    from desenet_tpu_torch.utils.convert import (load_npz_state_dict,
                                                 load_state_dict)

    dev = torch.device("cuda")
    model, spec = build_model(config_path("yolov5s_seg"))
    sd = boosted_state(model)
    load_state_dict(model, sd)
    rounded = {k: v.half().float() if v.is_floating_point() else v
               for k, v in sd.items()}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_import_") as tmp:
        src, npz = os.path.join(tmp, "src"), os.path.join(tmp, "sd.npz")
        pt, out = os.path.join(tmp, "best.pt"), os.path.join(tmp, "imported")
        _write(src, {"params": {k: v.detach().clone()
                                for k, v in trainable(model).items()},
                     "batch_stats": {k: v.clone()
                                     for k, v in bn_stats(model).items()}},
               {"cfg": "yolov5s_seg", "de_nc": spec.de_nc,
                "se_nc": spec.se_nc})
        t = time.perf_counter()
        export_torch_sd.main([src, npz])
        export_s = time.perf_counter() - t
        ref, _ = build_model(config_path("yolov5s_seg"))
        load_state_dict(ref, load_npz_state_dict(npz))
        ref = ref.half().eval()
        torch.save({"epoch": -1, "best_fitness": None, "model": ref,
                    "ema": ref, "updates": 0, "optimizer": None}, pt)
        t = time.perf_counter()
        import_torch_ckpt.main([pt, out, "--cfg", "yolov5s_seg"])
        import_s = time.perf_counter() - t
        mb = {"checkpoint": _mb(src), "npz": _mb(npz), "pt": _mb(pt),
              "imported": _mb(out)}

        rng = np.random.default_rng(16)
        imgs = rng.integers(0, 256, (B_SERVE, IMGSZ, IMGSZ, 3),
                            dtype=np.uint8)
        # f32, TF32 off: the imported checkpoint against the weights
        # themselves
        imp = load_predictor(out, imgsz=IMGSZ, half=False, device="cuda")
        direct = Predictor("yolov5s_seg", rounded, imgsz=IMGSZ, half=False,
                           device="cuda")
        x = torch.from_numpy(imgs[:B_IMPORT_F32]).to(dev)
        with no_tf32():
            dec_i, seg_i = _served_forward(imp, x)
            dec_d, seg_d = _served_forward(direct, x)
        f32 = _held((("decode", dec_i, dec_d), ("seg logits", seg_i, seg_d)),
                    IMPORT_F32_BAR, "imported checkpoint f32")
        del imp, direct, dec_i, seg_i, dec_d, seg_d
        # bf16 b128: the same, then K1 and K2 on its decode and logits
        imp = load_predictor(out, imgsz=IMGSZ, device="cuda")
        direct = Predictor("yolov5s_seg", rounded, imgsz=IMGSZ,
                           device="cuda")
        xb = torch.from_numpy(imgs).to(dev)
        dec_i, seg_i = _served_forward(imp, xb)
        dec_d, seg_d = _served_forward(direct, xb)
        bf16 = _held((("decode", dec_i, dec_d), ("seg logits", seg_i, seg_d)),
                     IMPORT_BF16_BAR, "imported checkpoint bf16")
        del direct, dec_d, seg_d
    planes = nms_fused.nms_planes(dec_i, imp.conf_thres)
    got = nms_fused.greedy_select(*planes, imp.max_det, imp.iou_thres)
    if not torch.equal(got, nms_fused.greedy_select_plain(
            *planes, imp.max_det, imp.iou_thres)):
        raise AssertionError("K1 on the imported checkpoint's decode "
                             "differs from plain")
    n_cand = float((planes[4] > 0).sum(1).float().mean())
    picks = float((got[..., 4] > 0).sum(1).float().mean())
    paths = sorted(set(nms_fused.last_paths.tolist()))
    k1_plain, k1 = in_turns(
        (lambda: nms_fused.greedy_select_plain(*planes, imp.max_det,
                                               imp.iou_thres), 1),
        (lambda: nms_fused.greedy_select(*planes, imp.max_det,
                                         imp.iou_thres), 20))
    k1_bound = tm.nms_fused_bound(B_SERVE, planes[4].shape[1], imp.max_det,
                                  n_cand, picks)
    extras.setdefault("nms_fused", {}).update(
        imported_ms=k1, imported_plain_ms=k1_plain,
        imported_bound_ms=k1_bound[0], imported_candidates=n_cand,
        imported_picks=picks)
    nhwc = seg_i.permute(0, 2, 3, 1).contiguous()
    h, w = nhwc.shape[1:3]
    if not torch.equal(seg_pallas.upsample_argmax(nhwc),
                       seg_pallas.upsample_argmax_plain(
                           nhwc, *seg_pallas.seg_taps(h, 8 * h, True, dev),
                           *seg_pallas.seg_taps(w, 8 * w, True, dev))):
        raise AssertionError("K2 on the imported checkpoint's seg logits "
                             "differs from plain")
    del dec_i, seg_i, nhwc, planes
    imp.run_batch(imgs)  # warm
    nms_fused.launches = seg_pallas.launches = 0
    ms = []
    for _ in range(IMPORT_TURNS):
        t = time.perf_counter()
        res = imp.run_batch(imgs)
        ms.append((time.perf_counter() - t) * 1e3)
    k = {"nms_fused": nms_fused.launches, "seg_tail": seg_pallas.launches}
    if k != {"nms_fused": IMPORT_TURNS, "seg_tail": IMPORT_TURNS}:
        raise AssertionError(f"imported checkpoint served launches {k}")
    boxes, scores, _, nums, seg_cls = res
    if seg_cls.shape != (B_SERVE, IMGSZ, IMGSZ) or not (
            np.isfinite(boxes).all() and np.isfinite(scores).all()) \
            or int(nums.sum()) == 0:
        raise AssertionError(f"imported checkpoint served program: seg "
                             f"{seg_cls.shape}, {int(nums.sum())} boxes")
    log("16", f"yolov5s_seg boosted weights: port checkpoint -> "
        f"export_torch_sd {export_s:.3f} s ({mb['checkpoint']:.3f} MB -> npz "
        f"{mb['npz']:.3f} MB), reference-style .pt in half "
        f"{mb['pt']:.3f} MB -> import_torch_ckpt {import_s:.3f} s "
        f"(checkpoint {mb['imported']:.3f} MB) [{card}]")
    log("16", f"imported against a Predictor of the half-rounded weights: "
        f"f32 b{B_IMPORT_F32}/{IMGSZ} (TF32 off) decode and seg logits "
        f"within {f32['decode']:.2e}, {f32['seg logits']:.2e} of their "
        f"largest magnitude (bar {IMPORT_F32_BAR}); bf16 b{B_SERVE} within "
        f"{bf16['decode']:.2e}, {bf16['seg logits']:.2e} (bar "
        f"{IMPORT_BF16_BAR}); K1 on its decode and K2 on its logits equal "
        f"to plain [{card}]")
    log("16", f"K1 nms_fused on the imported checkpoint's b{B_SERVE} decode, "
        f"{n_cand:.0f} candidates and {picks:.0f} picks an image at conf "
        f"{imp.conf_thres}, paths {paths}: kernel {k1:.3f} ms, plain "
        f"{k1_plain:.3f} ms, bound {k1_bound[0]:.4f} ms ({k1_bound[1]}) "
        f"[{card}]")
    log("16", f"imported checkpoint served bf16 b{B_SERVE}/{IMGSZ} uint8 "
        f"through run_batch: median {float(np.median(ms)):.3f} ms a batch "
        f"(min {min(ms):.3f}, max {max(ms):.3f}, {IMPORT_TURNS} batches), "
        f"{int(nums.sum())} boxes in the last; launches {k} [{card}]")
    return k


def main() -> None:
    took = {}

    def timed(name, fn, *args):
        t = time.perf_counter()
        out = fn(*args)
        took[name] = time.perf_counter() - t
        return out

    timed("0", phase0)
    card = card_line()
    errs = {}
    timed("1", phase1)
    timed("2", phase2, errs)
    timed("3", phase3)
    pred, launches, sd = timed("4", phase4)
    model, spec, validator, batch, val_launches = timed("4b", phase4b, sd)
    launches.update(val_launches)
    extras, proto_timing = {}, {}
    for k, v in timed("4m", phase4m, card, errs, proto_timing,
                      extras).items():
        launches[k] = launches.get(k, 0) + v
    timing = timed("5", phase5, pred, card, extras)
    timing.update(proto_timing)
    timed("5 val", phase5_val, model, spec, validator, batch, card, timing,
          errs, extras)
    del model, validator
    timed("5e", phase5_epilogue, pred, card, errs, timing, extras)
    timed("5s", phase5s, card, extras)
    timed("5m", phase5m, card, errs, timing)
    launches.update(timed("6", phase6, pred, card, timing, errs))
    del pred
    launches["nms_greedy"] += timed("7", phase7, card)
    launches["nms_greedy"] += timed("8", phase8, card)
    for k, v in timed("9", phase9, card, errs, extras).items():
        launches[k] += v
    for k, v in timed("10", phase10, card, sd, errs, extras).items():
        launches[k] += v
    launches["nms_greedy"] += timed("11", phase11, card)
    launches.update(int8_conv=0)
    for k, v in timed("12", phase12, card, sd, errs, timing, extras).items():
        launches[k] += v
    launches["nms_greedy"] += timed("13", phase13, card, sd)
    for k, v in timed("14", phase14, card, sd).items():
        launches[k] += v
    for k, v in timed("15", phase15, card, sd, errs, extras).items():
        launches[k] += v
    for k, v in timed("16", phase16, card, extras).items():
        launches[k] += v
    log("times", "seconds by phase: " + ", ".join(
        f"{k} {v:.1f}" for k, v in took.items())
        + f"; {sum(took.values()):.1f} in all")
    record = {"kernels": [
        kernel_entry("nms_fused", "desenet_tpu/ops/nms_fused.py:46",
                     launches, errs, timing, extras),
        kernel_entry("seg_tail", "desenet_tpu/ops/seg_pallas.py:35",
                     launches, errs, timing, extras),
        kernel_entry("nms_greedy", "desenet_tpu/ops/nms_pallas.py:30",
                     launches, errs, timing, extras),
        kernel_entry("seg_head_psp2", "desenet_tpu/ops/seg_head_pallas.py:239",
                     launches, errs, timing, extras),
        kernel_entry("stem_conv", "desenet_tpu/ops/stem_pallas.py:77",
                     launches, errs, timing, extras),
        kernel_entry("c3_fused", "tools/proto_c3_kernel.py:35",
                     launches, errs, timing),
        kernel_entry("int8_conv", "desenet_tpu/quant.py:276",
                     launches, errs, timing, extras),
        kernel_entry("conv_epilogue", "none: XLA's conv output fusion (eval "
                     "BN, SiLU, shortcut)", launches, errs, timing, extras),
        kernel_entry("mask_assembly", "none: YOLOv5 v7.0's process_mask "
                     "(upsample=False) in PyTorch ops", launches, errs,
                     timing),
        kernel_entry("conv_epilogue_phases", "none: XLA's fusion of Proto's "
                     "nearest 2x upsample into its 3x3 conv", launches, errs,
                     timing, extras),
    ]}
    print(json.dumps(record), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
