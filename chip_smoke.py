#!/usr/bin/env python3
"""Drive the PyTorch port's serving and training paths on one NVIDIA GPU.

  python3 chip_smoke.py [--phases device,flash,...]

Phases, each under a watchdog that ends the run with a stack trace
instead of hanging, each printing one line (or a few) when it ends:

1. device: the card's name and power limit, and the nvcc build of the
   kernels in plankassembly_tpu_torch/csrc (build seconds, registers and
   spills of each kernel); the tensor-core sentinel: the HMMA
   instructions of each bf16 attention kernel in `cuobjdump --dump-sass`
   of the built library, which must not be 0, and of the fused decode
   layer's bf16 tensor-core GEMM, with the asynchronous copies (LDGSTS,
   UBLKCP, UTMALDG) of the redesigned decode kernels, none of them 0;
2. flash_attention (CUDA) against its plain version at encoder shapes:
   B=64, H=8, L=1280, ragged lengths with a row of length 0 and one of
   length 1, causal and not, bf16 (tensor cores) and f32 (SIMT); and at
   the main path's own shape (the 32-program request: grouped-query K/V,
   the fixture's lengths, bucket width); kernel, plain and
   scaled_dot_product_attention times (the last a yardstick only), and
   the f32 kernel's time;
3. the decode kernels against their plain version on the flagship
   checkpoint and the fixture's encoder memory (the 32-program request),
   in bf16: token agreement, F1 of each, num_steps, time per step; again
   without early exit (all S steps) and on a ragged mask (a row with no
   real key, one with only key 0, a masked key inside a row; those three
   rows held on their own: their tokens against the unaltered rows', their
   attach, their hidden states); the time of the call's cross K/V
   preparation alone, the graph's kernels a step, its capture and
   instantiate ms and its replays' ms, the device idle share over the call,
   one step's kernels by device time; at B=32 and B=64
   the route route_of takes, its ms a step, nodes a step and plan, and its
   tokens and steps against the plain version's;
4. the main path: load checkpoints/gqa_complete_ep221.npz, pack the 64
   fixture drawings, serve them through make_live_backend + BatchingServer
   as requests of 8, 24 and 32 programs, and score P/R/F1 against the
   fixture's ground truth, in bf16 (the serving setting) and f32, beside
   the JAX reference's golden F1; launches of each kernel on that path;
5. decode_options: persistent against mxu (int8 cross K/V, as
   make_live_backend decodes) at B = 1, 8, 32, 128, 512 (the fixture's
   drawings tiled, bf16, bucket 1152): the table that sets "auto"'s batch
   band (decode.PERSISTENT_BATCHES), which must take the faster path at
   every B; kernel 2's step route against its chain at STEP_BAND's buckets
   and batches, the table behind persistent_decode.route_of's one-wave
   rule (the route taken must be the faster, the two must agree);
   weight_quant (mxu, int8 weights and cross K/V) on the 64
   drawings in bf16 and f32 against the JAX golden
   (fixtures/serve64_wq_jax_golden.npz); greedy_decode_nocache against
   the cached xla decode in f32 on the first 8 drawings (identical
   samples, attach and num_steps), ms a step of both;
6. beam: beam_decode(num_beams=4) of the 64 drawings in bf16 and f32
   against the JAX golden (fixtures/serve64_beam4_jax_golden.npz), and
   num_beams=1 against the xla greedy decode up to END in f32;
7. http: make_http_server over a BucketRouter of three live "auto"
   backends (buckets 512 / 768 / 1152, batch 16) on 127.0.0.1, the 64
   drawings POSTed from 16 client threads: each answer names the smallest
   bucket that fits its drawing and equals the decode of the batch its
   server ran, repeated one call at a time; bf16 F1, /healthz's row
   count, 400 for an over-long request, 404 for an unknown route,
   programs/s;
8. train_kernel: fused_attention_train's CUDA forward and backward
   against their plain version at the flagship's three training shapes
   (B=64, bf16 and f32, the training fixture's real lengths: encoder
   self-attention 8 heads over 2 kv heads at 1199 tokens, decoder causal
   self-attention at 127, cross-attention 127 x 1199) and at the encoder
   shape with MHA heads (8 over 8, B=8), at dropout 0 and 0.2, and each
   again on 8 rows of which two have lengths 0 and 1; kernel, plain and
   scaled_dot_product_attention times (the last at rate 0 only, a
   yardstick) beside the bound, and the f32 kernels' times at the
   encoder shape;
9. train_step: one full-width training step of ep221 on the first 8
   drawings of the training fixture, kernels on, dropout 0, f32 and bf16,
   against the JAX reference's golden loss, accuracy and per-leaf gradient
   norms and probes (plankassembly_tpu_torch/fixtures/
   train_step_jax_golden.npz); launches per step;
10. fit: the port's CLI `fit` on configs/train_synthetic_gqa.yaml as it
   stands (B=64, dropout 0.2, AUG_RATIO 0.1, decode_impl auto) from init,
   20 epochs of one step on the training fixture, validation on the
   serving fixture through "auto" (the full-precision mxu decode, the
   encoder's flash_attention), then the `last` checkpoint reloaded and
   compared; losses, ms per step, val P/R/F1, launches of every kernel on
   that path;
11. mha_kernels: the MHA decode kernels against their plain versions at
   the main request's shapes (the last 32 fixture programs through
   checkpoints/mha_complete_ep59.npz's encoder, bucket 1152, bf16 and
   f32): cross_attn_decode on int8 and on compute-dtype K/V, and
   fused_decoder_layer / fused_ffn at a mid-decode step whose caches come
   from a real run, each also on ragged rows (no real key, one, a masked
   key inside a row); kernel, plain and bound times (and
   scaled_dot_product_attention beside the compute-dtype cross_attn_decode,
   a yardstick only), cross_attn_decode's device time with every key
   real, and the device time of each kernel of one layer; then
   fused_decoder_layer along the plain version's own decode, every layer
   at TRAJ_STEPS, kernel and plain version on the same inputs: the
   (point, row) pairs over FUSED_ROW_TOL (at most TRAJ_ROW_SHARE of
   them), the planted fault's (more than TRAJ_PLANTED_SHARE), and the
   new K/V's int8 flips, counted apart;
12. mha_serve: ep59 serves the 64 fixture drawings through make_live_backend
   + BatchingServer with cross_impl "kernel" and "fused", as requests of
   8, 24 and 32, in bf16 and f32, scored against the JAX reference's
   golden (plankassembly_tpu_torch/fixtures/serve64_mha_jax_golden.npz);
   then the last 32 programs through each path's kernels and its plain
   versions on the same memory; launches of every kernel on each path;
13. sideface_serve: checkpoints/gqa_sideface_ep119.npz serves the 64
   fixture drawings as sideface requests (their `svgs` the two-point
   linestrings of their lines; side faces extracted, no line-type stream)
   through make_live_backend(with_type=False) + BatchingServer, as
   requests of 8, 24 and 32 at the golden's buckets, bf16 and f32, scored
   against the JAX reference's golden
   (plankassembly_tpu_torch/fixtures/serve64_sideface_jax_golden.npz):
   F1, identical programs, token agreement, zero-face drawings, ms per
   request, launches of flash_attention and persistent_greedy_decode;
   both kernels against their plain versions at the sideface shape with
   a drawing of no side face (one real key) in the largest request; then
   the requests and that drawing POSTed through make_http_server over a
   BucketRouter of sideface backends, each answered by the smallest
   bucket that fits its packed face tokens;
14. data_fit: the port's sideface CLI (`trainer_sideface fit`) on
   configs/train_synthetic_sideface_gqa.yaml as it stands (B=64, dropout
   0.2, AUG_RATIO 0.1) from init on the training fixture with
   `trainer.sample_cache` and `trainer.device_data`, validated on the
   sideface requests: losses, ms per step, val P/R/F1, kernel 3's
   launches; then the complete-modality fit on
   configs/train_synthetic_gqa.yaml, the training fixture tiled 4 times
   (4 steps an epoch), 3 epochs each through the plain DataLoader,
   `sample_cache` and `device_data`: host-clock ms per step of each, and
   the device idle share of two device_data steps;
15. export: ep221 exported as serving artifacts of the port
   (`export.export_serving`, batch 16, bf16) at buckets 512 / 768 / 1152,
   plus a weight_quant and a beam (K=4) artifact at 1152: each file's
   size (the weight_quant one must be smaller), each artifact loaded and
   serving the drawings that fit its bucket as requests of 16, every
   program equal to the live decode with the same options on the same
   requests, F1 beside the JAX goldens (serve64_jax_golden.npz,
   serve64_wq_jax_golden.npz, serve64_beam4_jax_golden.npz), ms per step
   (the mxu host loop, beam search); then `serve --artifact` over the
   ladder on 127.0.0.1 with the HTTP checks of phase 7 (each answer from
   the smallest bucket that fits, equal to the direct decode of its
   batch);
16. raster: checkpoints/raster512_complete_ep99.npz (MHA, 512^2 images in
   64^2 patches, 192 encoder tokens): the 64 drawings (their `svgs` from
   their lines) packed as segments and drawn on the card by
   `rasterize_device`, pixel for pixel against the host rasterizer;
   `greedy_decode_raster` of them as two requests of 32 in bf16 and f32
   against the JAX golden (plankassembly_tpu_torch/fixtures/
   serve64_raster_jax_golden.npz): f32 every program, or a first
   differing step that is a near-tie of the sampler; bf16 token agreement
   >= 0.99; F1 within 0.01; flash_attention on the encoder's own q/k/v
   and at its shape against its plain version; then `trainer_raster fit`
   on configs/train_synthetic_raster512.yaml as it stands (B=32, dropout
   0.2, AUG_RATIO 0.1) from init, 10 one-step epochs on 32 drawings of
   the training fixture, validated on the 64 serving drawings: losses, ms
   per step, launches of kernels 1 and 3.

17. parallel: the parallel layer (`plankassembly_tpu_torch/parallel/`) on
   the one card. NCCL refuses two ranks on one device, so a world of
   several ranks is a gloo group of worker processes (`chip_smoke.py
   --worker`) that all hold cuda:0; one one-rank NCCL world runs the same
   trainer code. ep221's training step (the train_step phase's, kernels
   on) on dp=2, on tp=2 (kernel 3 at 4 query heads over 1 kv head a rank)
   and on the NCCL rank, f32 and bf16 at dropout 0, against the JAX
   golden within STEP_TOL; the dp=2 and tp=2 steps at dropout 0.2 against
   this process's one-process step with the same seed (f32 STEP_TOL: the
   masks must be the global ones); configs/train_complete.yaml as
   published (MHA, devices 4, BATCH_SIZE 16, dropout 0.2) on 4 gloo ranks
   for 3 steps of 64 training drawings, its losses against the one NCCL
   rank's B=64 run (bf16 STEP_TOL), ms a step of each, the gradient
   all-reduce's ms; validation and test of its checkpoint across the 4
   ranks (64 prediction JSONs, none twice) against one rank's of the same
   checkpoint (every program identical, F1 equal); ep221's encoder with
   its length axis over 2 ranks (1199 tokens padded to 1216: 608 query
   rows a rank against 1216 keys) against one process's (FLASH_TOL f32,
   the element bound in bf16); the verify recipe's overfit drive under
   dp=2 (loss down more than 5x, F1 1.0, every program and its attach
   pointers reproduced); kernel 3 at the tp=2 shape and kernel 1 at the
   seq shape against their plain versions, timed; export_serving(
   data_parallel=2) refused for want of visible devices. Gloo times on one
   card are no multi-GPU figure.
18. factory: the offline data factory and the dataset, checkpoint and
   evaluation tools, each through `python -m plankassembly_tpu_torch.
   tools.<name>` (the sweep through its `main`, so that its launches are
   counted): the serving fixture's seeds regenerated (complete, visible,
   noise_05, noise_10; every drawing in the test split) and the training
   fixture's, every row field for field against serve64.json.gz and
   train64.json.gz and every file at the digest the JAX tools wrote
   (fixtures/factory_jax_golden.json); the host ms per drawing of
   generate, render (native library and numpy path) and prepare, and
   node_classify / dedupe_covers against the numpy path when the library
   loads; the robustness sweep of ep221 over complete, noise_05 and
   noise_10 through `Trainer.test` with the persistent decode and int8
   cross K/V, bf16 and f32, each F1 against the JAX golden's
   (SWEEP_F1_TOL), ms a step, launches of kernels 1 and 2, and the clean
   set again through the config's `auto` decode; evaluate,
   build_pred_mesh, build_gt_mesh and build_html on the clean run; ep59
   written in the reference's Lightning layout, converted back by
   convert_reference_checkpoint and served through `kernel` against ep59
   (every program identical); ep221 as a training checkpoint of the port
   exported to npz (bit-equal to the release) and imported back (every
   program identical); and a short fit on the regenerated training set
   whose tfevents scalars must equal its metrics.jsonl.
19. finetune: ep221 fine-tuned through `python -m plankassembly_tpu_torch.
   cli fit --ckpt_path checkpoints/gqa_complete_ep221.npz` with the
   protocol of fixtures/finetune_jax_golden.npz (B=8, dropout 0, LR 1e-4,
   3 epochs of the 64 training drawings with AUG_RATIO 0.1, validation on
   the 64 serving drawings after each epoch through the persistent decode
   with int8 cross K/V), in f32 and in bf16, against JAX's fit on the CPU
   (FT_TOL): every step's loss, every validation's F1, the best and last
   checkpoints' meta, the f32 run's last-validation programs and final
   parameters' norms and probes, and 'last' reloaded bit for bit; the
   launches of kernels 1, 2 and 3 against their counts; one bf16 step
   traced (`trace_context`) and read by `tools.trace_summary`, the
   training attention among its top kernels; then the same protocol in
   f32 through `python -m plankassembly_tpu_torch.tools.fit_chunked`, 3
   processes of 1 epoch: chunk 0 against the monolithic run's first
   epoch, the steps continuing from chunk to chunk, each later chunk's
   first loss rerun here from its predecessor's 'last', each chunk's
   host_rss_mb, the final 'last' loaded; and `python -m
   plankassembly_tpu_torch.tools.leak_probe` on the card, its four
   stages' RSS slopes.
20. visible: the serving seeds rendered as visible lines by the port's
   factory tools (every file at the JAX tools' digest), tested with the
   released visible checkpoint (gqa_visible_ep79, MAX_INPUT_LENGTH 560)
   through `python -m plankassembly_tpu_torch.trainer_visible test`, the
   persistent decode with int8 cross K/V, f32 and bf16, against
   fixtures/serve64_visible_jax_golden.npz (F1 at SERVE_F1_TOL; f32 every
   program identical or its first difference a near-tie of the plain
   decode; bf16 token agreement >= 0.99); kernels 1 and 2 against their
   plain versions at the test batch's shape (B=64, bucket 512) and at the
   model's whole input length (560), timed, with bounds.

The flash phase also holds flash_attention at the raster encoder's shape
(B=32, 8 heads over 8 kv heads, 192 keys, every one real), and the
train_kernel phase the training attention at the raster fit's three
shapes (B=32, MHA: encoder 192^2, decoder causal 127^2, cross 127 x 192).

Before its closing lines the script prints one summary line per phase
with that phase's headline numbers, so that they stand in the last lines
of its output. With --phases, only the named phases run, and no result
line is printed. It then prints the kernels' JSON line, the card's name
and power limit, and, last, {"ok": true, "device": {...}}. Any failed
check exits non-zero before that line. Without CUDA it exits non-zero and
prints no result.
"""
import contextlib
import faulthandler
import glob
import gzip
import json
import math
import os
import re
import shutil
import subprocess
import sys
import threading
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
CKPT = os.path.join(ROOT, "checkpoints", "gqa_complete_ep221.npz")
MHA_CKPT = os.path.join(ROOT, "checkpoints", "mha_complete_ep59.npz")
SF_CKPT = os.path.join(ROOT, "checkpoints", "gqa_sideface_ep119.npz")
RASTER_CKPT = os.path.join(ROOT, "checkpoints", "raster512_complete_ep99.npz")
FIXTURES = os.path.join(ROOT, "plankassembly_tpu_torch", "fixtures")
DEVICE = "cuda"

# H100 SXM published peaks (NVIDIA data sheet), for the kernels' bounds
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}

# watchdog budget of each phase, seconds
BUDGET = {"device": 240, "flash": 180, "decode": 240, "serve": 300,
          "decode_options": 300, "beam": 300, "http": 300,
          "train_kernel": 300, "train_step": 240, "fit": 420,
          "mha_kernels": 240, "mha_serve": 420, "sideface_serve": 300,
          "data_fit": 420, "export": 300, "raster": 300, "parallel": 420,
          "factory": 300, "visible": 240, "finetune": 420}
PHASES = tuple(BUDGET)

# tolerances (the plain versions accumulate in f32 like the kernels; the
# kernels' exp and summation order differ)
FLASH_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
DECODE_F1_TOL = 0.005          # kernel vs plain, bf16, same memory
# decode on a ragged mask: the rows `ragged_mask` changes (no real key,
# only key 0, a masked key inside) against the plain version, their hidden
# states within this factor of the error of rows it leaves (bf16 products
# rounded in another order, ~3e-2 there); a row whose cross-attention
# read the wrong keys is off by O(1)
RAGGED_ROWS = 3
RAGGED_HIDDEN_FACTOR = 2.0
SERVE_F1_TOL = {"bf16": 0.01, "f32": 0.002}  # port vs the JAX golden
REQUESTS = (8, 24, 32)         # programs per request on the main path
# fused_attention_train through its autograd wrapper against the plain
# version run in f32 on the same (upcast) inputs, element by element:
# |got - ref| <= rel * |ref| + row * (max |ref| along the head dim of that
# row) + 1e-5 * max |ref| over the output. f32: the same arithmetic in
# another order (~1e-6 of the row); the last term takes the f32 rounding
# of sums whose exact value is 0 (dq of causal row 0: ds = da - D there,
# which the plain version cancels exactly and the kernel does not).
# bf16: the kernel rounds its f32 result once, at most half a bf16 ulp,
# <= 2^-8 |ref|; one ulp, 2^-7, leaves room for f32 order near a rounding
# tie. One keep bit that differed moves a whole row of o, dq, dk and dv
# by a weight of order 1/Lk times O(1) values (~1e-3 at these shapes),
# well above either bound: the check below flips one typical bit in the
# plain version and requires every output to fail.
TRAIN_KERNEL_TOL = {torch.float32: (1e-5, 1e-4),
                    torch.bfloat16: (2.0 ** -7, 1e-4)}
TRAIN_RATES = (0.0, 0.2)
TRAIN_SEED = 1234567
# the full-width step against the JAX CPU golden (dropout 0): loss and
# accuracy, per-leaf gradient L2 norm (relative) and probe dot (its error
# over the leaf's gradient norm, which is the relative gradient error
# along a random direction). f32: another order of float32 sums through
# 12 layers (~1e-5 relative); bf16: the frameworks round to bf16 at other
# points — the JAX golden's own bf16 step differs from its f32 step by up
# to 2.2% in a norm and 8.6% in a probe, so 5% and 25%. The key biases
# (`*/bk`) have an exact gradient of 0 (softmax shift invariance) and are
# held to a small norm instead.
STEP_TOL = {"f32": {"loss": 1e-4, "acc": 2e-3, "norm": 1e-3, "probe": 1e-2,
                    "bk": 1e-6},
            "bf16": {"loss": 2e-2, "acc": 1e-2, "norm": 5e-2, "probe": 0.25,
                     "bk": 5e-3}}
FIT_EPOCHS = 20
PEAK_INT8_OPS = 1979e12
# cross_attn_decode against its plain version: both compute in f32 from
# the same inputs, in another order (~1e-6 of the output's scale)
CROSS_TOL = 1e-4
# fused_decoder_layer against its plain version at a mid-decode step:
# every integer sum is exact and the new K/V rows must be equal; the float
# work around the sums is in another order. Each row of x_out is held to
# FUSED_ROW_TOL of that row's largest value: sound kernels stay below
# 4e-5 of it (f32) and the plain version with one weight scale for all
# the cross chunks of a row (a planted fault, which the check must catch)
# differs by more
FUSED_ROW_TOL = 1e-4
FFN_TOL = 1e-4                 # fused_ffn: f32 sums in another order
MID_STEP, MID_LAYER = 48, 3    # where the fused layer is checked
# fused_decoder_layer along the plain version's own decode: every layer at
# these steps, the kernel and the plain version on the same inputs. A sum
# in another order can put a bf16 or int8 rounding on the other side of a
# tie and move that row past FUSED_ROW_TOL; such flips are rare and touch
# single rows, a fault touches most of them. So the kernel may put at most
# TRAJ_ROW_SHARE of the (point, row) pairs over FUSED_ROW_TOL, and the
# planted fault must put more than TRAJ_PLANTED_SHARE of them over it
TRAJ_STEPS = tuple(range(8, 72, 8))
TRAJ_ROW_SHARE = 0.02
TRAJ_PLANTED_SHARE = 0.2
MHA_F1_TOL = {"bf16": 0.01, "f32": 0.002}   # kernel path vs the JAX golden
# decode_options: the batches at which persistent and mxu are timed for
# "auto"'s band (auto's pick may be at most AUTO_SLACK x the other's time),
# and the drawings the no-cache decode runs
AUTO_BATCHES = (1, 8, 32, 128, 512)
AUTO_SLACK = 1.1
# the port's bf16 bar (ROADMAP.md): token agreement of kernel 2's routes
# with the plain version and with each other
DECODE_AGREEMENT = 0.99
# decode_options: the (bucket, batch) pairs at which kernel 2's two routes
# are timed against each other for persistent_decode.route_of (bf16 must
# take the faster within AUTO_SLACK): ep221's bucket over the batches, then
# the side-face (256) and visible (512, 560) buckets
STEP_BAND = tuple((1152, b) for b in (1, 8, 16, 32, 48, 64, 96, 128, 160,
                                       192, 256, 512)) + (
    (256, 24), (256, 32), (256, 64), (512, 64), (560, 64))
NOCACHE_ROWS = 8
BEAMS = 4
# http: the bucket ladder of live backends, their batch, the client threads
# and the served F1 of the JAX golden (serve64_jax_golden.npz, bf16)
HTTP_BUCKETS = (512, 768, 1152)
HTTP_BATCH = 16
HTTP_CLIENTS = 16
HTTP_F1 = 0.980625
FUSED_PLAIN_F1_TOL = 0.005     # fused kernels vs their plain versions
# sideface_serve: bf16 token agreement with the JAX golden (the repo's bar
# for kernel variants; f32 must give every golden program), the HTTP
# ladder of sideface backends, and a drawing with no side face (one
# dangling line: it packs to END and PAD only)
SF_AGREEMENT = 0.99
SF_HTTP_BUCKETS = (128, 256)
NO_FACE = {"name": "no_face", "views": [0], "types": [0],
           "svgs": ['{"type":"LineString","coordinates":[[0.0,0.0],'
                    '[0.3,0.0]]}'],
           "lines": [[0.0, 0.0, 0.3, 0.0]], "coords": [[0.0] * 6],
           "attach": [[-1] * 6]}
# data_fit: sideface steps (one an epoch), and the complete fit's timing
# runs: the fixture tiled TIMING_TILE times, TIMING_EPOCHS epochs
SF_FIT_EPOCHS = 10
TIMING_TILE, TIMING_EPOCHS = 4, 3
# export: ep221's artifacts (batch 16) at the HTTP ladder's buckets, and a
# weight_quant and a beam artifact at the widest
EXPORT_BATCH = 16
# raster: the raster checkpoint's encoder shape (3 views of (512/64)^2
# patches, every key real), its serving requests, bf16 token agreement
# with the JAX golden (f32 must give every golden program, or differ only
# after a near-tie: the two best candidates of the sampler within NEAR_TIE
# of the best's value), and its fit's one-step epochs on RASTER_FIT_ROWS
# training drawings (B=32)
RASTER_TOKENS = 192
RASTER_REQUESTS = (32, 32)
RASTER_AGREEMENT = 0.99
RASTER_F1_TOL = 0.01
NEAR_TIE = 1e-4
RASTER_FIT_EPOCHS = 10
RASTER_FIT_ROWS = 32


class CheckFailed(Exception):
    pass


def check(ok, what):
    if not ok:
        raise CheckFailed(what)


def log(*parts):
    print(*parts, flush=True)


SUMMARY: dict = {}   # phase -> its headline numbers, printed at the end


def note(phase, text):
    SUMMARY.setdefault(phase, []).append(text)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() else \
        f"nvidia-smi failed: {out.stderr.strip()}"


def cuda_ms(fn, reps=10, warmup=2):
    """Mean device time of fn() in ms (CUDA events around `reps` calls)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _profile_kernels(fn, reps, warmup):
    """{kernel name: (device us, launches)} of `reps` fn() calls under
    torch.profiler, after `warmup` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    # a profiling session now and then records no device activity at all
    # (seen on the H100 after the training phases); such a session is
    # taken again, up to twice
    for attempt in range(3):
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        kernels = {}
        for e in prof.key_averages():
            if e.device_type == torch.autograd.DeviceType.CUDA:
                us = float(getattr(e, "self_device_time_total",
                                   getattr(e, "self_cuda_time_total", 0.0)))
                kernels[e.key] = (us, int(e.count))
        if sum(us for us, _ in kernels.values()) > 0:
            break
        log(f"  the profiler saw no device time (session {attempt + 1})")
    check(sum(us for us, _ in kernels.values()) > 0,
          "the profiler saw no device time")
    return kernels


def kernel_ms(fn, reps=10, warmup=2):
    """Device time of one fn() call in ms: the CUDA kernels it launches,
    summed over `reps` calls under torch.profiler, over reps. Unlike
    cuda_ms it leaves out the gaps while the host prepares the next launch,
    which for a wrapper whose host work outlasts its kernels (the decode
    kernels at serving batch) are most of the events' span."""
    kernels = _profile_kernels(fn, reps, warmup)
    return sum(us for us, _ in kernels.values()) / 1e3 / reps


def _short_kernel_name(name):
    """A kernel's name without `void`, its argument list and namespaces."""
    name = re.sub(r"^void ", "", name)
    depth, cut = 0, len(name)
    for i, ch in enumerate(name):  # the argument list: the last top-level (
        if ch == "<":
            depth += 1
        elif ch == ">":
            depth -= 1
        elif ch == "(" and depth == 0:
            cut = i
    name = name[:cut]
    return re.sub(r"\bplank::(gemm::|attn::)?", "", name).replace(
        "__nv_bfloat16", "bf16")


def kernel_breakdown(fn, reps=20, warmup=3):
    """Each kernel that one fn() call launches: [(short name, launches per
    call, device us per call)], the longest first (torch.profiler). A
    session that recorded only some of the calls (a launch count that is
    not a multiple of reps, seen on the H100 after many sessions) is taken
    again, up to twice; a fractional count in the result marks one that
    stayed partial."""
    for attempt in range(3):
        kernels = _profile_kernels(fn, reps, warmup)
        if all(n % reps == 0 for _, n in kernels.values()):
            break
        log(f"  the profiler recorded part of the calls (session "
            f"{attempt + 1})")
    rows = [(_short_kernel_name(k), n / reps, us / reps)
            for k, (us, n) in kernels.items()]
    return sorted(rows, key=lambda r: -r[2])


def breakdown_line(rows):
    total = sum(us for _, _, us in rows)
    return "; ".join(f"{name} x{n:g} {us:.2f} us ({us / total:.1%})"
                     for name, n, us in rows) + f"; total {total:.2f} us"


def ptxas_summary(build_log):
    """(entry function, registers, spill store bytes, spill load bytes)
    of each kernel, from the build's `-Xptxas -v` output."""
    rows, fn, spill = [], None, (0, 0)
    for line in build_log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            fn, spill = m.group(1), (0, 0)
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            spill = (int(m.group(1)), int(m.group(2)))
            continue
        m = re.search(r"Used (\d+) registers", line)
        if m and fn:
            rows.append((fn, int(m.group(1)), *spill))
            fn = None
    return rows


# the bf16 (tensor-core) kernels of each redesigned TPU kernel, by the name
# of their __global__ function
MMA_KERNELS = {"flash_attention": ("flash_mma_kernel",),
               "fused_attention_train_fwd": ("train_fwd_mma_kernel",),
               "fused_attention_train_bwd": ("train_dq_mma_kernel",
                                             "train_dkdv_mma_kernel")}
# each kernel's route by dtype: the tensor cores take f32 only as TF32, so
# the f32 form stays on the SIMT kernels
ROUTES = {"bf16": "cuda-mma", "f32": "cuda-simt"}
# the fused layer's products by dtype (csrc/fused_decode.cu says why)
FUSED_ROUTES = {"bf16": "cuda-mma (woc, w1, w2), cuda-simt-order (qkv, wo, "
                        "cross-q)", "f32": "cuda-simt-order"}
# the decode kernels redesigned around asynchronous copies, and those of
# them that run on the tensor cores: the bf16 GEMM of the fused layer, a
# template with one function per route, prologue and epilogue, whose
# tensor-core instances mangle as cluster_gemm_kernel<true, ...>
ASYNC_KERNELS = {"persistent_greedy_decode": ("cross_attn_kernel",
                                              "step_kernel"),
                 "cross_attn_decode": ("cross_attn_cluster_kernel",),
                 "fused_decoder_layer": ("fused_cross_split_kernel",
                                         "cluster_gemm_kernel")}
DECODE_MMA_KERNELS = {"fused_decoder_layer": ("cluster_gemm_kernelILb1E",),
                      "persistent_greedy_decode": ("step_kernel",)}
ASYNC_COPY = re.compile(r"\b(LDGSTS|UBLKCP|UTMALDG)\b")


def sass_counts(lib_path):
    """Per function of the built library's SASS: (HMMA instructions,
    asynchronous copy instructions: LDGSTS, UBLKCP or UTMALDG)."""
    from plankassembly_tpu_torch.ops import _build
    tool = shutil.which("cuobjdump") or os.path.join(
        os.path.dirname(_build._nvcc()), "cuobjdump")
    out = subprocess.run([tool, "--dump-sass", lib_path],
                         capture_output=True, text=True, timeout=300)
    check(out.returncode == 0, f"cuobjdump failed: {out.stderr[-2000:]}")
    per_fn, fn = {}, None
    for line in out.stdout.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            fn = m.group(1)
            per_fn.setdefault(fn, [0, 0])
        elif fn is not None:
            per_fn[fn][0] += bool(re.search(r"\bHMMA\b", line))
            per_fn[fn][1] += bool(ASYNC_COPY.search(line))
    return per_fn


def hmma_counts(per_fn):
    """HMMA instructions of each function of MMA_KERNELS."""
    counts = {}
    for kernels in MMA_KERNELS.values():
        for k in kernels:
            hits = [n for n in per_fn if k in n]
            check(len(hits) == 1, f"{k}: {len(hits)} functions in the SASS")
            counts[k] = per_fn[hits[0]][0]
    return counts


def least_counts(per_fn, kernels, which):
    """For each named kernel, the fewest instructions of kind `which` (0:
    HMMA, 1: asynchronous copies) over its functions (one per template
    instance)."""
    counts = {}
    for names in kernels.values():
        for k in names:
            hits = [n for n in per_fn if k in n]
            check(len(hits) >= 1, f"{k}: no function in the SASS")
            counts[k] = min(per_fn[n][which] for n in hits)
    return counts


class Phase:
    def __init__(self, name):
        self.name = name

    def __enter__(self):
        self.t0 = time.perf_counter()
        faulthandler.dump_traceback_later(BUDGET[self.name], exit=True)
        return self

    def __exit__(self, *exc):
        faulthandler.cancel_dump_traceback_later()
        if exc[0] is None:
            log(f"[{self.name}] done in {time.perf_counter() - self.t0:.1f} s")
        return False


# ---------------------------------------------------------------- phase 2
def _sdpa(q, k, v, mask):
    """One PyTorch call for the same attention (a yardstick only; the port
    never calls it)."""
    sdpa = torch.nn.functional.scaled_dot_product_attention
    return lambda: sdpa(q, k, v, attn_mask=mask,
                        enable_gqa=k.shape[1] != q.shape[1])


def flash_case(B, H, Hkv, L, lengths, causal, dtype, seed, timing=False):
    """Kernel against plain version (bf16 also element by element against
    the plain version in f32, `elem`); with timing, the kernel's, plain
    version's and SDPA's times and the bound (timing="kernel": the
    kernel's time only)."""
    from plankassembly_tpu_torch.ops import attention as A
    g = torch.Generator(device=DEVICE).manual_seed(seed)
    q = torch.randn((B, H, L, 64), generator=g, device=DEVICE).to(dtype)
    k = torch.randn((B, Hkv, L, 64), generator=g, device=DEVICE).to(dtype)
    v = torch.randn((B, Hkv, L, 64), generator=g, device=DEVICE).to(dtype)
    lens = torch.as_tensor(lengths, dtype=torch.int32, device=DEVICE)
    got = A.flash_attention(q, k, v, lens, causal=causal)
    ref = A.flash_attention_reference(q, k, v, lens, causal=causal)
    torch.cuda.synchronize()
    err = (got.float() - ref.float()).abs().max().item()
    check(torch.isfinite(got.float()).all().item(), "flash output not finite")
    res = {"err": err}
    if dtype == torch.bfloat16:
        # the bf16 kernel rounds its f32 result once, as the training
        # kernels do: TRAIN_KERNEL_TOL's bf16 bound holds it element by
        # element, where FLASH_TOL (absolute, over the output) would not
        # see P multiplied as its bf16 high half alone
        ref = A.flash_attention_reference(q.float(), k.float(), v.float(),
                                          lens, causal=causal)
        res["elem"] = _train_err(got, ref, dtype)
        del ref
    if timing:
        res["ms"] = cuda_ms(lambda: A.flash_attention(q, k, v, lens,
                                                      causal=causal))
    if timing is True:
        res["plain_ms"] = cuda_ms(lambda: A.flash_attention_reference(
            q, k, v, lens, causal=causal), reps=3, warmup=1)
        col = torch.arange(L, device=DEVICE)
        mask = (col[None, :] < lens[:, None])[:, None, None, :]
        if causal:
            mask = mask & (col[None, :] <= col[:, None])[None, None]
        res["library_ms"] = cuda_ms(_sdpa(q, k, v, mask))
        # bound: q, k, v and lengths read once, out written once; the
        # products the lengths (and the causal triangle) leave
        nbytes = (q.numel() + k.numel() + v.numel() + q.numel()) * \
            q.element_size() + lens.numel() * 4
        keys = torch.clamp(lens.double(), max=L)[:, None].expand(B, L)
        if causal:
            keys = torch.minimum(keys, torch.arange(1, L + 1, device=DEVICE,
                                                    dtype=torch.float64))
        flops = 4.0 * 64 * H * keys.sum().item()
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = flops / PEAK_FLOPS[dtype] * 1e3
        res["bound_ms"] = max(t_bytes, t_ops)
        res["bound_by"] = "bytes" if t_bytes >= t_ops else "operations"
    return res


def phase_flash(main_lengths, bucket):
    rng = np.random.default_rng(0)
    # a row with no real key (averaged over Lk, as the plain version) and
    # a row with one
    lengths64 = np.concatenate([[1280, 1, 0, 640],
                                rng.integers(1, 1281, 60)]).astype(np.int32)
    for dtype in (torch.bfloat16, torch.float32):
        for causal in (False, True):
            r = flash_case(64, 8, 8, 1280, lengths64, causal, dtype,
                           seed=1 + causal)
            tag = f"flash B=64 H=8 L=1280 ragged {str(dtype)[6:]} " \
                  f"causal={causal}"
            log(f"{tag}: max_abs_err {r['err']:.3e} "
                f"(tol {FLASH_TOL[dtype]:g})" + (
                    f"; err over the TRAIN_KERNEL_TOL bound {r['elem']:.3f}"
                    if "elem" in r else ""))
            check(r["err"] <= FLASH_TOL[dtype], f"{tag} disagrees")
            check(r.get("elem", 0.0) <= 1.0, f"{tag} disagrees element by "
                  f"element")
    # the main path's shape: the 32-program request at the serving bucket,
    # grouped-query K/V (2 kv heads), the fixture's real lengths
    r = flash_case(len(main_lengths), 8, 2, bucket, main_lengths,
                   False, torch.bfloat16, seed=3, timing=True)
    log(f"flash main-path shape B={len(main_lengths)} H=8 Hkv=2 L={bucket} "
        f"bf16: max_abs_err {r['err']:.3e}, err over the TRAIN_KERNEL_TOL "
        f"bound {r['elem']:.3f}; kernel {r['ms']:.3f} ms, plain "
        f"{r['plain_ms']:.3f} ms, sdpa {r['library_ms']:.3f} ms, bound "
        f"{r['bound_ms']:.4f} ms ({r['bound_by']})")
    check(r["err"] <= FLASH_TOL[torch.bfloat16], "flash main shape disagrees")
    check(r["elem"] <= 1.0, "flash main shape disagrees element by element")
    r32 = flash_case(len(main_lengths), 8, 2, bucket, main_lengths, False,
                     torch.float32, seed=3, timing="kernel")
    log(f"flash main-path shape f32 (SIMT): max_abs_err {r32['err']:.3e}; "
        f"kernel {r32['ms']:.3f} ms")
    check(r32["err"] <= FLASH_TOL[torch.float32], "flash main shape f32 "
          "disagrees")
    r["ms_f32"] = r32["ms"]
    r["raster"] = raster_flash_cases("flash")
    return r


def raster_flash_cases(phase):
    """flash_attention at the raster encoder's shape (B=32, 8 heads over 8
    kv heads, RASTER_TOKENS keys every row real: a last key tile of the
    tensor-core kernel only part full), bf16 (timed) and f32."""
    out = {}
    for dtype in (torch.bfloat16, torch.float32):
        B = RASTER_REQUESTS[0]
        r = flash_case(B, 8, 8, RASTER_TOKENS, [RASTER_TOKENS] * B, False,
                       dtype, seed=5, timing=True if dtype == torch.bfloat16
                       else "kernel")
        tag = (f"{phase}: flash raster shape B={B} H=8 Hkv=8 "
               f"L={RASTER_TOKENS} {str(dtype)[6:]}")
        log(f"{tag}: max_abs_err {r['err']:.3e} (tol {FLASH_TOL[dtype]:g})" + (
            f", err over the TRAIN_KERNEL_TOL bound {r['elem']:.3f}; kernel "
            f"{r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, sdpa "
            f"{r['library_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms "
            f"({r['bound_by']})" if "elem" in r else
            f"; kernel {r['ms']:.4f} ms"))
        check(r["err"] <= FLASH_TOL[dtype], f"{tag} disagrees")
        check(r.get("elem", 0.0) <= 1.0,
              f"{tag} disagrees element by element")
        out[str(dtype)[6:]] = r
    return out


# ---------------------------------------------------------------- phase 3
def decode_bound(dims, memory, mask, steps):
    """Least time for a bf16 persistent_greedy_decode of `steps` steps on
    these inputs, and what sets it ("bytes" or "operations"): the
    benchmark's `bench_port/metrics/_bounds.decode_ms`, which counts the
    real memory rows, the parameters at the dtypes the kernels read and
    the outputs once, and the operations these inputs need. Its bytes do
    not grow with the steps and its operations do, so the bound is the
    bytes' where the steps leave it as it is at no step."""
    from bench_port.metrics._bounds import decode_ms

    d = {"D": dims.num_model, "Dkv": dims.kv_heads * dims.head_dim,
         "F": dims.num_feedforward, "V": dims.vocab_size,
         "S": dims.max_output_length, "Ld": dims.num_decoder_layers,
         "dof": dims.num_output_dof}
    rows, width = mask.shape
    real = int((~mask.bool()).sum().item())       # real memory rows, all rows
    ms = decode_ms(d, rows, width, real, steps)
    return ms, ("bytes" if ms == decode_ms(d, rows, width, real, 0)
                else "operations")


# the redesigned decode loop's kernels (csrc/decode.cu, decode_step.cu),
# for the breakdown
DECODE_KERNELS = ("cluster_gemm_kernel", "self_attn_kernel",
                  "cross_attn_kernel", "final_norm_kernel", "pointer_kernel",
                  "sample_kernel", "step_kernel")


def decode_idle_share(fn):
    """(device idle share of one fn() call's wall time, busy ms, wall ms)
    under torch.profiler: 1 - (the union of its kernels' and copies'
    device intervals, the benchmark's `_intervals.busy`) / (host clock from
    the call to its synchronise). The union, not the sum: with programmatic
    dependent launch a kernel starts before the previous one ends."""
    from bench_port.metrics._intervals import busy as union

    torch.cuda.synchronize()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    busy = union((e.time_range.start, e.time_range.end)
                 for e in prof.events()
                 if e.device_type == torch.autograd.DeviceType.CUDA) / 1e3
    check(busy > 0, "decode: the profiler saw no device time")
    return 1 - busy / wall, busy, wall


def step_route(params, dims, batch, bucket, reps=3):
    """The bf16 decode's route at this batch: its ms a step (the call, and
    the graph's replays by CUDA events inside it), nodes a step, route and
    plan, over `reps` calls after a warm-up; its tokens and steps against
    the plain version's."""
    from plankassembly_tpu_torch.decode import _pad_or_crop
    from plankassembly_tpu_torch.models.model import encode
    from plankassembly_tpu_torch.ops import persistent_decode as PD

    inputs = _pad_or_crop(dict(batch), bucket, dims)
    with torch.no_grad():
        memory = encode(params, inputs, dims, compute_dtype=torch.bfloat16,
                        flash=True)
    mask = inputs["input_mask"]

    def kern():
        return PD.persistent_greedy_decode(params, memory, mask, dims,
                                           compute_dtype=torch.bfloat16)

    kern()
    torch.cuda.synchronize()
    ms, replay, steps = [], [], 0
    for _ in range(reps):
        t0 = time.perf_counter()
        out = kern()
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        steps = out["num_steps"]
        replay.append(PD.last_graph["replay_ms"])
    g = dict(PD.last_graph)
    plain = PD.greedy_decode_reference(params, memory, mask, dims,
                                       compute_dtype=torch.bfloat16)
    agree = (out["samples"] == plain["samples"]).float().mean().item()
    row = {"B": memory.shape[0], "route": g["route"],
           "nodes_per_step": g["nodes_per_step"],
           "rows_per_cluster": g["rows_per_cluster"],
           "cluster_size": g["cluster_size"], "clusters": g["clusters"],
           "steps": steps, "ms": ms, "ms_per_step": [m / steps for m in ms],
           "replay_ms_per_step": [r / steps for r in replay],
           "agreement": agree, "plain_steps": plain["num_steps"]}
    log(f"  route at B={row['B']}: {row['route']}, "
        f"{row['nodes_per_step']:g} nodes a step, "
        f"{row['rows_per_cluster']} rows a cluster of "
        f"{row['cluster_size']} blocks, {row['clusters']} clusters; "
        f"{steps} steps, ms a step (call) "
        + ", ".join(f"{v:.4f}" for v in row["ms_per_step"])
        + "; replays' ms a step "
        + ", ".join(f"{v:.4f}" for v in row["replay_ms_per_step"])
        + f"; token agreement with the plain version {agree:.4f}, steps "
        f"{steps} / plain {plain['num_steps']}")
    want = PD.route_of(torch.bfloat16,
                       PD.step_plan(row["B"], memory.shape[1], dims))
    check(row["route"] == want
          and row["nodes_per_step"] <= (2 if want == "step" else 52),
          f"decode at B={row['B']}: bf16 took {row['route']} with "
          f"{row['nodes_per_step']} nodes a step (want {want})")
    check(steps == plain["num_steps"] and agree >= DECODE_AGREEMENT,
          f"decode at B={row['B']} ({row['route']}): agreement {agree} "
          f"with the plain version, steps {steps} / {plain['num_steps']}")
    return row


def step_band_table(params, dims, packed):
    """Kernel 2's two routes against each other at STEP_BAND: the
    fixture's drawings tiled to B rows at the bucket, bf16, the step and
    the chain forced (route_of patched), each persistent_greedy_decode call's
    host-clock ms (least of 2 after a warm-up) and its replays' device ms,
    over its steps. Checks that route_of takes the faster (within
    AUTO_SLACK) and that the two routes agree on the tokens."""
    from plankassembly_tpu_torch.decode import _pad_or_crop
    from plankassembly_tpu_torch.models.model import encode
    from plankassembly_tpu_torch.ops import persistent_decode as PD

    rows = []
    for bucket, B in STEP_BAND:
        batch = _pad_or_crop(_stack(packed, [i % len(packed)
                                             for i in range(B)]),
                             bucket, dims)
        with torch.no_grad():
            memory = encode(params, batch, dims,
                            compute_dtype=torch.bfloat16, flash=True)
        ms, replay, outs = {}, {}, {}
        plan = PD.step_plan(B, bucket, dims)
        for route in ("step", "chain"):
            with _patched(PD, route_of=lambda cd, plan, route=route: route):
                def run(route=route):
                    outs[route] = PD.persistent_greedy_decode(
                        params, memory, batch["input_mask"], dims,
                        compute_dtype=torch.bfloat16)
                    replay[route] = PD.last_graph["replay_ms"]
                ms[route] = host_ms(run)
                check(PD.last_graph["route"] == route,
                      f"step band: {route} forced, {PD.last_graph['route']} "
                      f"ran")
        steps = {r: o["num_steps"] for r, o in outs.items()}
        agree = (outs["step"]["samples"] == outs["chain"]["samples"]) \
            .float().mean().item()
        pick = PD.route_of(torch.bfloat16, plan)
        other = "chain" if pick == "step" else "step"
        row = {"bucket": bucket, "B": B, "pick": pick, "steps": steps,
               "plan": plan,
               "agreement": agree,
               "ms_per_step": {r: ms[r] / steps[r] for r in ms},
               "replay_ms_per_step": {r: replay[r] / steps[r]
                                      for r in replay}}
        rows.append(row)
        log(f"decode_options step band: bucket {bucket} B={B}, "
            f"{steps['step']}/{steps['chain']} steps: ms a step (call) step "
            f"{row['ms_per_step']['step']:.4f} chain "
            f"{row['ms_per_step']['chain']:.4f}, replays step "
            f"{row['replay_ms_per_step']['step']:.4f} chain "
            f"{row['replay_ms_per_step']['chain']:.4f}; agreement "
            f"{agree:.4f}; the step's plan {plan}: route_of takes {pick}")
        check(ms[pick] / steps[pick]
              <= AUTO_SLACK * ms[other] / steps[other],
              f"step band: route_of takes {pick} at bucket {bucket} B={B}, "
              f"{ms[pick] / steps[pick]:.4f} ms a step against {other}'s "
              f"{ms[other] / steps[other]:.4f}: the one-wave rule "
              f"disagrees with the card")
        check(agree >= DECODE_AGREEMENT,
              f"step band: the routes agree on {agree} of the tokens at "
              f"bucket {bucket} B={B}")
        del memory
    return rows


def phase_decode(params, dims, batch, gt, bucket, full=None):
    from plankassembly_tpu_torch.decode import _pad_or_crop
    from plankassembly_tpu_torch.metrics import batch_scores
    from plankassembly_tpu_torch.models.model import encode
    from plankassembly_tpu_torch.ops import persistent_decode as PD

    cd = torch.bfloat16
    S = dims.max_output_length
    inputs = _pad_or_crop({k: v for k, v in batch.items()}, bucket, dims)
    with torch.no_grad():
        memory = encode(params, inputs, dims, compute_dtype=cd, flash=True)
    mask = inputs["input_mask"]
    B, Li = memory.shape[:2]

    def kern(early_exit=True, m=mask):
        return PD.persistent_greedy_decode(params, memory, m, dims,
                                           compute_dtype=cd,
                                           early_exit=early_exit)

    def plain(early_exit=True, m=mask):
        return PD.greedy_decode_reference(params, memory, m, dims,
                                          compute_dtype=cd,
                                          early_exit=early_exit)

    # the shape's first call builds its launch state (a miss): its graph's
    # capture and instantiate ms; the later calls of the shape find it
    PD._launch_states.clear()
    hits0 = PD.graph_cache["hits"]
    k_out, p_out = kern(), plain()
    built = dict(PD.last_graph)
    check(not built["cached"], "decode: the shape's first call found a "
          "launch state")
    torch.cuda.synchronize()
    ks, ps = k_out["samples"].cpu(), p_out["samples"].cpu()
    agree = (ks == ps).float().mean().item()
    same = (ks == ps).all(dim=1)
    steps = min(k_out["num_steps"], p_out["num_steps"])
    check(bool(same.any()), "decode: no row identical to the plain version")
    sel = same.to(DEVICE)
    attach_same = bool((k_out["attach"][sel] == p_out["attach"][sel]).all())
    hid_err = (k_out["hidden"][sel, :steps]
               - p_out["hidden"][sel, :steps]).abs().max().item()
    hid_tail_zero = not k_out["hidden"][:, k_out["num_steps"]:].any().item()
    f1_k = batch_scores(ks, gt)[2].mean().item()
    f1_p = batch_scores(ps, gt)[2].mean().item()
    # every step (no early exit): the kernel against the plain version
    # run the same way
    k_all, p_all = kern(False), plain(False)
    agree_all = (k_all["samples"] == p_all["samples"]).float().mean().item()
    # any mask: a row with no real key, one with only key 0, a masked key
    # inside a row (csrc/decode.cu's cross kernel skips spans by the mask)
    rag = ragged_mask(mask)
    k_rag, p_rag = kern(False, rag), plain(False, rag)
    rag_same = (k_rag["samples"] == p_rag["samples"]).cpu()
    agree_rag = rag_same.float().mean().item()
    # the three changed rows held on their own against the unaltered rows
    # of the same run: their token agreement, and on those of them with
    # identical tokens, attach and the hidden states of all S steps
    changed = torch.arange(B) < RAGGED_ROWS
    agree_rag_rows = rag_same[changed].float().mean().item()
    agree_rag_rest = rag_same[~changed].float().mean().item()
    ident = rag_same.all(dim=1)

    def rag_hidden_err(rows):
        rows = rows.to(DEVICE)
        if not rows.any():
            return 0.0
        return (k_rag["hidden"][rows] - p_rag["hidden"][rows]).abs().max() \
            .item()

    rag_hid_rows = rag_hidden_err(ident & changed)
    rag_hid_rest = rag_hidden_err(ident & ~changed)
    rows_dev = (ident & changed).to(DEVICE)
    rag_attach_same = bool((k_rag["attach"][rows_dev]
                            == p_rag["attach"][rows_dev]).all())

    def timed(fn, reps):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            out = fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / reps * 1e3, out["num_steps"]

    def prepare():
        return PD._prepare(params, memory, mask, dims, cd, True)

    k_ms, k_steps = timed(kern, 3)
    graph = dict(PD.last_graph)  # of a call after the first: its replays'
    # ms are CUDA events around them
    check(graph["cached"], "decode: a later call of the shape built its "
          "launch state again")
    hits = PD.graph_cache["hits"] - hits0
    prep_ms, _ = timed(lambda: {"num_steps": len(prepare())}, 3)
    p_ms, p_steps = timed(plain, 2)
    bound_ms, bound_by = decode_bound(dims, memory, mask, k_steps)
    idle, busy_ms, wall_ms = decode_idle_share(kern)
    # one step's kernels: a decode of every step, its loop kernels' device
    # time over S (the cross K/V preparation's kernels apart); each kernel
    # starts while the one before it ends (programmatic dependent launch),
    # so a kernel's time holds some of its wait, and the times overlap
    rows = kernel_breakdown(lambda: kern(False), reps=3, warmup=1)
    step_rows = [(n, c / S, us / S) for n, c, us in rows
                 if any(k in n for k in DECODE_KERNELS)]
    prep_us = sum(us for n, _, us in rows
                  if not any(k in n for k in DECODE_KERNELS))
    log(f"decode B={B} Li={Li} bf16: token agreement {agree:.4f}, identical "
        f"rows {same.float().mean().item():.3f}, hidden max_abs_err on "
        f"identical rows {hid_err:.3e}, attach equal on identical rows "
        f"{attach_same}, num_steps kernel {k_out['num_steps']} plain "
        f"{p_out['num_steps']}, hidden zero after num_steps {hid_tail_zero}; "
        f"F1 kernel {f1_k:.6f} plain {f1_p:.6f}; every step (no early "
        f"exit): steps kernel {k_all['num_steps']} plain "
        f"{p_all['num_steps']}, token agreement {agree_all:.4f}; ragged "
        f"mask, every step: agreement {agree_rag:.4f}, on the {RAGGED_ROWS} "
        f"changed rows {agree_rag_rows:.4f} (the others {agree_rag_rest:.4f}), "
        f"their attach equal {rag_attach_same}, their hidden max_abs_err "
        f"{rag_hid_rows:.3e} (the others {rag_hid_rest:.3e}); kernel "
        f"{k_ms:.2f} ms ({k_steps} steps, {k_ms / k_steps:.3f} ms/step, its "
        f"graph's replays {graph['replay_ms']:.2f} ms, the call's "
        f"cross K/V preparation alone {prep_ms:.2f} ms), plain {p_ms:.2f} ms "
        f"({p_steps} steps, {p_ms / p_steps:.3f} ms/step); bound "
        f"{bound_ms:.4f} ms ({bound_by})")
    log(f"  graph: {graph['nodes_per_step']:g} kernels a step, "
        f"{PD.CHECK_EVERY} steps a graph, {graph['replays']} replays, "
        f"capture {built['capture_ms']:.2f} ms, instantiate "
        f"{built['instantiate_ms']:.2f} ms in the shape's first call, "
        f"{hits} calls after it found their shape's launch state "
        f"(graph_cache hits); "
        f"device idle share over the call "
        f"{idle:.3f} (busy {busy_ms:.2f} of {wall_ms:.2f} ms, profiled)")
    log(f"  one step's kernels (device time over {S} steps; they overlap "
        f"under programmatic dependent launch, so the sum passes the "
        f"step's time; the call's other kernels {prep_us / 1e3:.3f} ms): "
        + breakdown_line(step_rows))
    check(abs(f1_k - f1_p) <= DECODE_F1_TOL,
          f"decode F1 kernel {f1_k} vs plain {f1_p}")
    check(agree >= 0.9, f"decode token agreement {agree}")
    check(attach_same, "decode: attach differs from the plain version on "
          "rows with identical tokens")
    check(k_out["num_steps"] == p_out["num_steps"],
          f"decode num_steps {k_out['num_steps']} vs plain "
          f"{p_out['num_steps']}")
    check(hid_tail_zero, "decode: hidden columns after num_steps not zero")
    check(k_all["num_steps"] == S and p_all["num_steps"] == S,
          f"decode without early exit ran {k_all['num_steps']} steps")
    check(agree_all >= 0.9, f"decode token agreement, every step {agree_all}")
    check(agree_rag >= 0.9, f"decode token agreement, ragged mask "
          f"{agree_rag}")
    check(agree_rag_rows >= agree_rag_rest,
          f"decode on the ragged mask: the changed rows agree "
          f"{agree_rag_rows}, the others {agree_rag_rest}")
    check(rag_attach_same, "decode on the ragged mask: attach differs on "
          "changed rows with identical tokens")
    hid_ref = max(hid_err, rag_hid_rest)
    check(rag_hid_rows <= RAGGED_HIDDEN_FACTOR * hid_ref,
          f"decode on the ragged mask: hidden error of the changed rows "
          f"{rag_hid_rows} against {hid_ref} elsewhere")
    check(k_rag["num_steps"] == S, "decode on the ragged mask: steps")
    routes = [step_route(params, dims, batch, bucket)]
    if full is not None:
        routes.append(step_route(params, dims, full, bucket))
    return {"routes": routes, "err": hid_err, "ms": k_ms, "plain_ms": p_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "steps": k_steps,
            "ms_per_step": k_ms / k_steps, "prepare_ms": prep_ms,
            "replay_ms": graph["replay_ms"],
            "token_agreement": agree, "token_agreement_all_steps": agree_all,
            "token_agreement_ragged": agree_rag,
            "token_agreement_ragged_changed_rows": agree_rag_rows,
            "hidden_err_ragged_changed_rows": rag_hid_rows,
            "kernels_per_step": graph["nodes_per_step"],
            "capture_ms": built["capture_ms"],
            "instantiate_ms": built["instantiate_ms"],
            "graph_cache_hits": hits,
            "idle_share": idle,
            "kernel_breakdown": [{"kernel": n, "launches": c, "us": us}
                                 for n, c, us in step_rows]}


# ---------------------------------------------------------------- phase 4
def serve(params, cfg, packed, bucket, cd, cross_impl="persistent",
          with_type=True, buckets=None):
    """All fixture drawings through BatchingServer as requests of
    REQUESTS programs (each request's programs submitted concurrently),
    at `bucket`, or request r at `buckets[r]` (a backend and server for
    each). Returns (samples, attach (N, S) numpy, backend stats, wall
    seconds)."""
    from plankassembly_tpu_torch.serving import (
        BatchingServer, make_live_backend,
    )

    stats = {"seconds": 0.0, "steps": 0, "calls": 0, "steps_per_call": [],
             "ms_per_call": []}
    servers = {}

    def server_at(b):
        if b not in servers:
            backend, meta = make_live_backend(
                params, cfg, batch=max(REQUESTS), bucket=b, compute_dtype=cd,
                device=DEVICE, cross_impl=cross_impl, with_type=with_type)

            def timed_backend(request, backend=backend):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = backend(request)
                torch.cuda.synchronize()
                stats["seconds"] += time.perf_counter() - t0
                stats["steps"] += int(out["num_steps"])
                stats["steps_per_call"].append(int(out["num_steps"]))
                stats["ms_per_call"].append(
                    round((time.perf_counter() - t0) * 1e3, 1))
                stats["calls"] += 1
                return out
            servers[b] = BatchingServer(timed_backend, meta, max_wait_ms=200)
        return servers[b]

    rows = [None] * len(packed)
    t0 = time.perf_counter()
    try:
        first = 0
        for r, n in enumerate(REQUESTS):
            server = server_at(bucket if buckets is None else buckets[r])

            def ask(i, server=server):
                rows[i] = server.submit(
                    {k: v for k, v in packed[i].items()}, timeout=120)
            threads = [threading.Thread(target=ask, args=(i,))
                       for i in range(first, first + n)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=150)
            check(not any(t.is_alive() for t in threads),
                  "a request did not come back")
            first += n
    finally:
        for server in servers.values():
            server.close()
    wall = time.perf_counter() - t0
    check(all(r is not None for r in rows), "a request failed")
    samples = np.stack([r["samples"] for r in rows])
    attach = np.stack([r["attach"] for r in rows])
    return samples, attach, stats, wall


def phase_serve(params, cfg, dims, packed, gt, golden, bucket):
    from plankassembly_tpu_torch.metrics import batch_scores
    from plankassembly_tpu_torch.ops import attention as A
    from plankassembly_tpu_torch.ops import persistent_decode as PD

    results = {}
    for name, cd in (("bf16", torch.bfloat16), ("f32", torch.float32)):
        A.launches = 0
        PD.launches = 0
        samples, attach, stats, wall = serve(params, cfg, packed, bucket, cd)
        counts = {"flash_attention": A.launches,
                  "persistent_greedy_decode": PD.launches}
        check(samples.shape == (len(packed), dims.max_output_length),
              f"samples shape {samples.shape}")
        prec, rec, f1 = batch_scores(torch.from_numpy(samples), gt)
        gold = golden[f"samples_{name}"]
        same = [np.array_equal(_upto_end(a, dims.end), _upto_end(b, dims.end))
                for a, b in zip(samples, gold)]
        identical = float(np.mean(same))
        # pointers of identical programs, over the program's tokens
        gold_attach = golden[f"attach_{name}"]
        attach_bad = []
        for i in np.flatnonzero(same):
            n = len(_upto_end(samples[i], dims.end))
            if not np.array_equal(attach[i, :n], gold_attach[i, :n]):
                attach_bad.append(int(i))
        f1m, gold_f1 = f1.mean().item(), float(golden[f"f1_{name}"].mean())
        log(f"serve {name}: {len(packed)} programs in {stats['calls']} "
            f"batches ({'/'.join(map(str, REQUESTS))}): P {prec.mean():.6f} "
            f"R {rec.mean():.6f} F1 {f1m:.6f} vs JAX golden F1 {gold_f1:.6f} "
            f"(tol {SERVE_F1_TOL[name]}); identical programs {identical:.4f}, "
            f"their attach equal to the golden {not attach_bad}; "
            f"{len(packed) / wall:.2f} programs/s wall (with the server's "
            f"batching waits), {len(packed) / stats['seconds']:.2f} "
            f"programs/s in the backend; backend {stats['seconds'] * 1e3:.1f} "
            f"ms over {stats['steps']} steps = "
            f"{stats['seconds'] * 1e3 / stats['steps']:.3f} ms/step; "
            f"launches {counts}")
        note("serve", f"{name} F1 {f1m:.6f} (golden {gold_f1:.6f}) identical "
             f"{sum(same)}/{len(same)} "
             f"{stats['seconds'] * 1e3 / stats['steps']:.3f} ms/step")
        check(abs(f1m - gold_f1) <= SERVE_F1_TOL[name],
              f"serve {name} F1 {f1m} vs golden {gold_f1}")
        check(not attach_bad, f"serve {name}: attach differs from the JAX "
              f"golden on identical programs {attach_bad}")
        check(all(c > 0 for c in counts.values()),
              f"a kernel did not run on the main path: {counts}")
        results[name] = counts
    return results


def _upto_end(row, end):
    hits = np.flatnonzero(row == end)
    return row[: hits[0] + 1] if hits.size else row


# ---------------------------------------------------------------- phase 5
# ------------------------------------------------------------ phases 5-7
def host_ms(fn, reps=2, warmup=1):
    """Least host-clock ms of fn() over `reps` calls, each ended by a
    synchronize (whole decodes, whose loops read flags on the host)."""
    for _ in range(warmup):
        fn()
    best = float("inf")
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        best = min(best, time.perf_counter() - t0)
    return best * 1e3


def _stack(packed, rows):
    """The input streams of packed[rows] as one batch on the card."""
    return {k: torch.from_numpy(np.stack([packed[i][k] for i in rows]))
            .to(DEVICE) for k in packed[0]}


def _scores(samples, gt):
    from plankassembly_tpu_torch.metrics import batch_scores
    prec, rec, f1 = batch_scores(torch.as_tensor(np.asarray(samples)), gt)
    return prec.mean().item(), rec.mean().item(), f1.mean().item()


def _identical(samples, gold, end):
    return float(np.mean([np.array_equal(_upto_end(a, end), _upto_end(b, end))
                          for a, b in zip(np.asarray(samples), gold)]))


def auto_band_table(params, dims, packed, bucket):
    """persistent against mxu (kv_quant=True, as `make_live_backend`
    decodes) at AUTO_BATCHES: the fixture's drawings tiled to B rows,
    bf16, one encoder memory per B, decode_from_memory's host-clock ms
    (least of 2 after a warm-up). Checks that "auto" takes the faster
    of the two at every B (within AUTO_SLACK)."""
    from plankassembly_tpu_torch import decode as D
    from plankassembly_tpu_torch.decode import _pad_or_crop
    from plankassembly_tpu_torch.models.model import encode

    rows = []
    for B in AUTO_BATCHES:
        batch = _pad_or_crop(_stack(packed, [i % len(packed)
                                             for i in range(B)]),
                             bucket, dims)
        memory = encode(params, batch, dims, compute_dtype=torch.bfloat16,
                        flash=True)
        ms, steps = {}, {}
        for impl in ("persistent", "mxu"):
            def run(impl=impl):
                out = D.decode_from_memory(
                    params, memory, batch["input_mask"], dims,
                    compute_dtype=torch.bfloat16, kv_quant=True,
                    cross_impl=impl)
                steps[impl] = out["num_steps"]
            ms[impl] = host_ms(run)
        pick = D._pick_auto_impl("cuda", dims, B, kv_quant=True,
                                 self_quant=False, weight_quant=False,
                                 prequantized=False)
        other = "mxu" if pick == "persistent" else "persistent"
        rows.append({"B": B, "persistent_ms": ms["persistent"],
                     "mxu_ms": ms["mxu"], "steps": steps["persistent"],
                     "persistent_ms_per_step":
                         ms["persistent"] / steps["persistent"],
                     "mxu_ms_per_step": ms["mxu"] / steps["mxu"],
                     "auto": pick})
        log(f"decode_options auto band: B={B} bucket {bucket} bf16, "
            f"{steps['persistent']} steps: persistent {ms['persistent']:.2f} "
            f"ms ({ms['persistent'] / steps['persistent']:.3f} a step), mxu "
            f"{ms['mxu']:.2f} ms ({ms['mxu'] / steps['mxu']:.3f} a step); "
            f"auto takes {pick}")
        check(ms[pick] <= AUTO_SLACK * ms[other],
              f"auto takes {pick} at B={B}, {ms[pick]:.2f} ms against "
              f"{other}'s {ms[other]:.2f}: PERSISTENT_BATCHES "
              f"{D.PERSISTENT_BATCHES} disagrees with the card")
        del memory
    return rows


def phase_decode_options(params, dims, packed, gt, bucket):
    """The auto band table; weight_quant (mxu) on the 64 drawings against
    the JAX golden, bf16 and f32; the no-cache decode against the cached
    full-precision decode on the first NOCACHE_ROWS drawings in f32."""
    from plankassembly_tpu_torch.decode import (
        greedy_decode, greedy_decode_nocache,
    )

    res = {"band": auto_band_table(params, dims, packed, bucket),
           "step_band": step_band_table(params, dims, packed)}
    golden = np.load(os.path.join(FIXTURES, "serve64_wq_jax_golden.npz"))
    check(int(golden["bucket"]) == bucket, "weight_quant golden bucket")
    batch = _stack(packed, range(len(packed)))
    for name, cd in (("bf16", torch.bfloat16), ("f32", torch.float32)):
        _reset_counts()
        out = {}

        def run():
            out.update(greedy_decode(
                params, batch, dims, compute_dtype=cd, kv_bucket=bucket,
                kv_quant=True, self_quant=False, cross_impl="mxu",
                weight_quant=True))
        ms = host_ms(run, reps=1, warmup=0)
        counts = _launch_counts()
        samples = out["samples"].cpu().numpy()
        p, r, f1 = _scores(samples, gt)
        gold_f1 = float(golden[f"f1_{name}"].mean())
        same = _identical(samples, golden[f"samples_{name}"], dims.end)
        log(f"decode_options weight_quant {name} (mxu, int8 cross K/V and "
            f"weights): P {p:.6f} R {r:.6f} F1 {f1:.6f} vs JAX golden F1 "
            f"{gold_f1:.6f} (tol {SERVE_F1_TOL[name]}), identical programs "
            f"{same:.4f}, {out['num_steps']} steps in {ms:.1f} ms; launches "
            f"{counts}")
        check(abs(f1 - gold_f1) <= SERVE_F1_TOL[name],
              f"weight_quant {name} F1 {f1} vs golden {gold_f1}")
        check(counts["flash_attention"] > 0,
              "the weight_quant path ran no flash_attention")
        res[f"wq_{name}"] = {"f1": f1, "golden_f1": gold_f1,
                             "identical": same, "ms": ms}

    few = _stack(packed, range(NOCACHE_ROWS))
    outs, ms = {}, {}
    for impl, fn in (("nocache", greedy_decode_nocache),
                     ("cached", lambda *a, **k: greedy_decode(
                         *a, cross_impl="xla", **k))):
        def run(fn=fn, impl=impl):
            outs[impl] = fn(params, few, dims, compute_dtype=torch.float32)
        _reset_counts()
        ms[impl] = host_ms(run, reps=1, warmup=0)
        check(_launch_counts()["flash_attention"] > 0,
              f"the {impl} decode ran no flash_attention")
    a, b = outs["nocache"], outs["cached"]
    same = (torch.equal(a["samples"], b["samples"])
            and torch.equal(a["attach"], b["attach"])
            and a["num_steps"] == b["num_steps"])
    steps = a["num_steps"]
    log(f"decode_options no-cache f32, the first {NOCACHE_ROWS} drawings at "
        f"width {few['input_mask'].shape[1]}: samples, attach and num_steps "
        f"identical to the cached xla decode {same}; {steps} steps, no-cache "
        f"{ms['nocache']:.1f} ms ({ms['nocache'] / steps:.3f} a step), cached "
        f"{ms['cached']:.1f} ms ({ms['cached'] / steps:.3f} a step), on "
        f"{card_line()}")
    check(same, "no-cache decode differs from the cached decode")
    res["nocache"] = {"steps": steps, "nocache_ms": ms["nocache"],
                      "cached_ms": ms["cached"]}
    return res


def phase_beam(params, dims, packed, gt, bucket):
    """beam_decode(num_beams=4) of the 64 drawings against the JAX golden,
    bf16 and f32; num_beams=1 against the xla greedy decode up to END."""
    from plankassembly_tpu_torch.beam import beam_decode
    from plankassembly_tpu_torch.decode import greedy_decode

    golden = np.load(os.path.join(FIXTURES, "serve64_beam4_jax_golden.npz"))
    check(int(golden["bucket"]) == bucket, "beam golden bucket")
    batch = _stack(packed, range(len(packed)))
    res = {}
    for name, cd in (("bf16", torch.bfloat16), ("f32", torch.float32)):
        _reset_counts()
        out = {}

        def run():
            out.update(beam_decode(params, batch, dims, num_beams=BEAMS,
                                   compute_dtype=cd, kv_bucket=bucket))
        ms = host_ms(run, reps=1, warmup=0)
        counts = _launch_counts()
        samples = out["samples"].cpu().numpy()
        p, r, f1 = _scores(samples, gt)
        gold_f1 = float(golden[f"f1_{name}"].mean())
        same = _identical(samples, golden[f"samples_{name}"], dims.end)
        score_err = float(np.abs(out["beam_scores"].cpu().numpy()
                                 - golden[f"beam_scores_{name}"]).max())
        log(f"beam K={BEAMS} {name}: P {p:.6f} R {r:.6f} F1 {f1:.6f} vs JAX "
            f"golden F1 {gold_f1:.6f} (tol {SERVE_F1_TOL[name]}), identical "
            f"programs {same:.4f}, max |beam score - golden| {score_err:.3e},"
            f" {out['num_steps']} steps (golden "
            f"{int(golden[f'num_steps_{name}'])}) in {ms:.1f} ms "
            f"({ms / out['num_steps']:.3f} a step); launches {counts}")
        check(abs(f1 - gold_f1) <= SERVE_F1_TOL[name],
              f"beam {name} F1 {f1} vs golden {gold_f1}")
        check(counts["flash_attention"] > 0, "the beam path ran no "
              "flash_attention")
        res[name] = {"f1": f1, "golden_f1": gold_f1, "identical": same,
                     "ms": ms, "steps": out["num_steps"]}

    b = beam_decode(params, batch, dims, num_beams=1,
                    compute_dtype=torch.float32, kv_bucket=bucket)
    g = greedy_decode(params, batch, dims, compute_dtype=torch.float32,
                      kv_bucket=bucket, cross_impl="xla")
    bs, gs = b["samples"].cpu().numpy(), g["samples"].cpu().numpy()
    ba, ga = b["attach"].cpu().numpy(), g["attach"].cpu().numpy()
    bad = [i for i in range(len(gs)) if not (
        np.array_equal(bs[i, :len(_upto_end(gs[i], dims.end))],
                       _upto_end(gs[i], dims.end))
        and np.array_equal(ba[i, :len(_upto_end(gs[i], dims.end))],
                           ga[i, :len(_upto_end(gs[i], dims.end))]))]
    log(f"beam K=1 f32 against the xla greedy decode up to END: "
        f"{len(gs) - len(bad)} of {len(gs)} programs equal, tokens and "
        f"attach")
    check(not bad, f"beam K=1 differs from greedy on programs {bad}")
    return res


def _overlong_info(cfg, n_lines=290):
    """A request of 4 * n_lines + 1 tokens: within the model's input
    length, beyond the ladder's largest bucket."""
    rng = np.random.default_rng(5)
    lo = rng.uniform(-0.9, 0.5, (n_lines, 2))
    lines = np.concatenate([lo, lo + rng.uniform(0.05, 0.4, (n_lines, 2))], 1)
    check(4 * n_lines + 1 <= cfg.DATA.MAX_INPUT_LENGTH - 1,
          "the over-long request does not fit the model")
    return {"name": "overlong", "lines": lines.round(3).tolist(),
            "views": (np.arange(n_lines) % 3).tolist(),
            "types": (np.arange(n_lines) % 2).tolist()}


def http_ladder(httpd, router, cfg, dims, infos, packed, gt, direct):
    """All drawings POSTed from HTTP_CLIENTS threads to `httpd`, an HTTP
    server over `router` (a BucketRouter) on 127.0.0.1, then /healthz, an
    over-long request and an unknown route. Each answer is held to
    direct(bucket, inputs), the decode of the batch its server ran,
    repeated one call at a time at that bucket, and must come from the
    smallest bucket that fits its drawing. Returns the run's numbers."""
    import urllib.error
    import urllib.request

    from plankassembly_tpu_torch.serving import postprocess_prediction

    calls = []   # (bucket, request, answer) of every backend call, in order
    for server in router.servers:
        def recorded(request, backend=server.backend,
                     bucket=server.meta["bucket"]):
            out = backend(request)
            calls.append((bucket, request, out))
            return out
        server.backend = recorded
    buckets = [s.meta["bucket"] for s in router.servers]
    serving_thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    serving_thread.start()
    base = f"http://127.0.0.1:{httpd.server_address[1]}"

    def request(method, path, body=None):
        data = None if body is None else json.dumps(body).encode()
        req = urllib.request.Request(base + path, data=data, method=method)
        try:
            with urllib.request.urlopen(req, timeout=120) as r:
                return r.status, json.loads(r.read().decode())
        except urllib.error.HTTPError as e:
            return e.code, json.loads(e.read().decode())

    answers = [None] * len(infos)
    try:
        _reset_counts()
        t0 = time.perf_counter()

        def client(k):
            for i in range(k, len(infos), HTTP_CLIENTS):
                answers[i] = request("POST", "/v1/reconstruct", infos[i])
        threads = [threading.Thread(target=client, args=(k,))
                   for k in range(HTTP_CLIENTS)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=240)
        wall = time.perf_counter() - t0
        counts = _launch_counts()
        check(not any(t.is_alive() for t in threads),
              "an HTTP client did not come back")
        health = request("GET", "/healthz")
        meta = request("GET", "/meta")
        over = request("POST", "/v1/reconstruct", _overlong_info(cfg))
        missing = request("GET", "/v1/nothing")
    finally:
        httpd.shutdown()
        httpd.server_close()
        router.close()
        serving_thread.join(timeout=30)
    check(all(a is not None and a[0] == 200 for a in answers),
          f"an HTTP request failed: {[a for a in answers if a and a[0] != 200][:2]}")
    lengths = [int((~p["input_mask"]).sum()) for p in packed]
    want_bucket = [min(b for b in buckets if b >= n) for n in lengths]
    got_bucket = [a[1]["bucket"] for a in answers]
    check(got_bucket == want_bucket, "an answer names another bucket than "
          "the smallest that fits its drawing")

    # each batch a server ran, decoded again one call at a time
    served, ref = {}, {}
    for bucket, req, out in calls:
        d = direct(bucket, {k: torch.from_numpy(v).to(DEVICE)
                            for k, v in req.items()})
        rs, ra = d["samples"].cpu().numpy(), d["attach"].cpu().numpy()
        for j, key in enumerate(req["input_value"]):
            served[(bucket, key.tobytes())] = (out["samples"][j],
                                               out["attach"][j])
            ref[(bucket, key.tobytes())] = (rs[j], ra[j])
    bad, samples = [], []
    for i, (ans, p) in enumerate(zip(answers, packed)):
        key = (want_bucket[i], np.asarray(p["input_value"]).tobytes())
        (s, a), (ds, da) = served[key], ref[key]
        n = len(_upto_end(ds, dims.end))
        pred, attach = postprocess_prediction(s, a, dims)
        if not (np.array_equal(s[:n], ds[:n]) and np.array_equal(a[:n], da[:n])
                and ans[1]["prediction"] == pred.tolist()
                and ans[1]["attach"] == attach):
            bad.append(i)
        samples.append(s)
    p_, r_, f1 = _scores(np.stack(samples), gt)
    check(not bad, f"answers differ from the one-at-a-time decode: {bad}")
    check(health[0] == 200 and health[1]["rows_served"] == len(infos),
          f"healthz {health}")
    check(meta[0] == 200 and meta[1]["buckets"] == buckets, f"meta {meta}")
    check(over[0] == 400, f"over-long request answered {over[0]}")
    check(missing[0] == 404, f"unknown route answered {missing[0]}")
    rate = len(infos) / wall
    line = (f"{len(infos)} drawings from {HTTP_CLIENTS} client threads "
            f"through a ladder of {tuple(buckets)} in {wall:.2f} s = "
            f"{rate:.2f} programs/s on {card_line()}; {len(calls)} backend "
            f"calls, rows per call "
            f"{sorted(int(len(c[1]['input_value'])) for c in calls)}, each "
            f"bucket's answers "
            f"{dict(zip(buckets, map(got_bucket.count, buckets)))}; answers "
            f"equal to the one-at-a-time decode of their batch up to END "
            f"{len(infos) - len(bad)} of {len(infos)}; F1 {f1:.6f} (P "
            f"{p_:.6f} R {r_:.6f}); healthz {health[1]}; over-long request "
            f"{over[0]} ({over[1].get('error', '')[:60]}); unknown route "
            f"{missing[0]}; launches {counts}")
    return {"programs_per_s": rate, "launches": counts, "f1": f1,
            "line": line, "meta": meta[1]}


def phase_http(params, cfg, dims, infos, packed, gt):
    """A BucketRouter of three live "auto" backends behind
    make_http_server (`http_ladder`)."""
    from plankassembly_tpu_torch.decode import greedy_decode
    from plankassembly_tpu_torch.serving import (
        BatchingServer, BucketRouter, make_http_server, make_live_backend,
    )

    servers = []
    for bucket in HTTP_BUCKETS:
        backend, meta = make_live_backend(params, cfg, batch=HTTP_BATCH,
                                          bucket=bucket, device=DEVICE)
        servers.append(BatchingServer(backend, meta, max_wait_ms=20))
    router = BucketRouter(servers)
    httpd = make_http_server(router, cfg, dims, port=0)
    res = http_ladder(httpd, router, cfg, dims, infos, packed, gt,
                      lambda bucket, inputs: greedy_decode(
                          params, inputs, dims, kv_bucket=bucket,
                          kv_quant=True))
    counts, f1 = res["launches"], res["f1"]
    log(f"http (live backends, batch {HTTP_BATCH}, auto, bf16): "
        f"{res['line']}; F1 vs {HTTP_F1} (tol {SERVE_F1_TOL['bf16']})")
    check(abs(f1 - HTTP_F1) <= SERVE_F1_TOL["bf16"], f"http F1 {f1}")
    check(counts["flash_attention"] > 0
          and counts["persistent_greedy_decode"] > 0,
          f"a kernel did not run on the HTTP path: {counts}")
    return res


def _train_shapes(train_packed):
    """The flagship's three training attention shapes with the training
    fixture's real lengths: (name, H, Hkv, Lq, Lk, causal, lengths)."""
    in_len = np.array([(~p["input_mask"]).sum() for p in train_packed])
    S = train_packed[0]["output_mask"].shape[0] - 1
    out_len = np.array([(~p["output_mask"][:S]).sum() for p in train_packed])
    Li = train_packed[0]["input_mask"].shape[0]
    return [("encoder self", 8, 2, Li, Li, False, in_len),
            ("decoder self", 8, 2, S, S, True, out_len),
            ("cross", 8, 2, S, Li, False, in_len),
            # the reference's MHA layout (G = 1), checked only
            ("encoder self MHA", 8, 8, Li, Li, False, in_len[:8]),
            # the raster fit's (MHA, B=32, every patch token real)
            ("raster encoder self", 8, 8, RASTER_TOKENS, RASTER_TOKENS, False,
             np.full(RASTER_FIT_ROWS, RASTER_TOKENS)),
            ("raster decoder self", 8, 8, S, S, True,
             out_len[:RASTER_FIT_ROWS]),
            ("raster cross", 8, 8, S, RASTER_TOKENS, False,
             np.full(RASTER_FIT_ROWS, RASTER_TOKENS))]


def _keys(lengths, Lq, Lk, causal):
    """Keys each query row attends to, summed over the batch."""
    lens = np.minimum(np.asarray(lengths, np.float64), Lk)
    if not causal:
        return float(lens.sum() * Lq)
    rows = np.arange(1, Lq + 1, dtype=np.float64)
    return float(np.minimum(lens[:, None], rows[None, :]).sum())


def _train_err(got, ref, dtype):
    """Worst |got - ref| over its TRAIN_KERNEL_TOL bound; <= 1 passes."""
    rel, row = TRAIN_KERNEL_TOL[dtype]
    ref = ref.float()
    d = (got.float() - ref).abs()
    mag = ref.abs()
    bound = (rel * mag + row * mag.amax(dim=-1, keepdim=True)
             + 1e-5 * mag.max())
    return torch.where(d == 0, 0.0, d / bound).max().item()


def _flip_one_keep_bit(q, k, v, do, lengths, causal, sm_scale):
    """(b, h, i, j) of one typical keep bit: query head 1 at the middle
    row (qi > 0 at Lq=1199), and among its real keys the one of median
    a_ij |do_i . v_j|, the size of a flip's change to the row's ds."""
    h, i = 1, q.shape[2] // 2
    n = int(min(lengths[0], k.shape[2]))
    if causal:
        n = min(n, i + 1)
    g = h // (q.shape[1] // k.shape[1])
    a = torch.softmax(k[0, g, :n].float() @ q[0, h, i].float() * sm_scale,
                      dim=0)
    effect = a * (v[0, g, :n].float() @ do[0, h, i].float()).abs()
    return 0, h, i, int(torch.argsort(effect)[n // 2])


def _edge_rows(lengths):
    """The first 8 lengths with rows 1 and 2 set to 0 (no real key: averaged
    over Lk padded to 128, as the TPU kernel does) and 1."""
    out = np.array(lengths[:8], dtype=np.int64)
    out[1:3] = (0, 1)
    return out


def _train_outputs(FT, q, k, v, do, lens, seed, rate, causal, name):
    """(o, dq, dk, dv) of the training path's wrapper on leaf tensors,
    through autograd."""
    leaves = [x.detach().clone().requires_grad_() for x in (q, k, v)]
    o = FT.fused_attention_train(*leaves, lens, seed, rate, causal)
    grads = torch.autograd.grad(o, leaves, do)
    torch.cuda.synchronize()
    outs = (o.detach(), *grads)
    check(all(x.dtype == q.dtype for x in outs),
          f"train_kernel {name}: output dtypes")
    for out, x in zip(("o", "dq", "dk", "dv"), outs):
        check(bool(torch.isfinite(x.float()).all()),
              f"train_kernel {name}: {out} not finite")
    return outs


def train_kernel_case(name, H, Hkv, Lq, Lk, causal, lengths, dtype, rate,
                      timing=False):
    """The kernels through the autograd wrapper against the plain version
    in f32, on the lengths given (`errs`) and on a batch of 8 whose rows 1
    and 2 have lengths 0 and 1 (`edge_errs`, `_edge_rows`; apart, since the
    long sums of a length-1 row set the outputs' largest values, and with
    them the bound's last term); with timing, the kernels', plain
    version's and SDPA's times and the bounds (timing="kernel": the
    kernels' times only)."""
    from plankassembly_tpu_torch.ops import flash_train as FT
    B = len(lengths)
    g = torch.Generator(device=DEVICE).manual_seed(Lq * 7 + Lk)
    q = torch.randn((B, H, Lq, 64), generator=g, device=DEVICE).to(dtype)
    k = torch.randn((B, Hkv, Lk, 64), generator=g, device=DEVICE).to(dtype)
    v = torch.randn((B, Hkv, Lk, 64), generator=g, device=DEVICE).to(dtype)
    do = torch.randn((B, H, Lq, 64), generator=g, device=DEVICE).to(dtype)
    seed = torch.tensor([TRAIN_SEED], dtype=torch.int32, device=DEVICE)
    lens = torch.as_tensor(lengths, dtype=torch.int32, device=DEVICE)
    args = (q, k, v, lens, seed)

    def plain(q, k, v, do, lens):
        f32 = (q.float(), k.float(), v.float(), lens, seed)
        return (FT.fused_attention_train_reference(*f32, rate, causal),
                *FT.fused_attention_train_reference_bwd(
                    *f32, do.float(), rate, causal))

    got = _train_outputs(FT, q, k, v, do, lens, seed, rate, causal, name)
    refs = plain(q, k, v, do, lens)
    errs, abs_errs = {}, {}
    for out, x, ref in zip(("o", "dq", "dk", "dv"), got, refs):
        abs_errs[out] = (x.float() - ref).abs().max().item()
        errs[out] = _train_err(x, ref, dtype)
    res = {"errs": errs, "abs_errs": abs_errs}
    del refs
    if rate > 0:
        # the tolerance sees the mask: the plain version with one keep bit
        # flipped must fail it in every output
        b, h, i, j = _flip_one_keep_bit(q, k, v, do, lengths, causal,
                                        1.0 / math.sqrt(64))
        keep_mask = FT.keep_mask

        def flipped(*a, **kw):
            m = keep_mask(*a, **kw)
            m[b, h, i, j] = ~m[b, h, i, j]
            return m

        FT.keep_mask = flipped
        try:
            refs = plain(q, k, v, do, lens)
        finally:
            FT.keep_mask = keep_mask
        res["flip"] = (b, h, i, j)
        res["flip_errs"] = {out: _train_err(x, ref, dtype) for out, x,
                            ref in zip(("o", "dq", "dk", "dv"), got, refs)}
        del refs
    del got
    edge = [x[:8].contiguous() for x in (q, k, v, do)]
    edge_lens = torch.as_tensor(_edge_rows(lengths), dtype=torch.int32,
                                device=DEVICE)
    got = _train_outputs(FT, *edge, edge_lens, seed, rate, causal, name)
    res["edge_errs"] = {out: _train_err(x, ref, dtype) for out, x, ref in
                        zip(("o", "dq", "dk", "dv"), got,
                            plain(*edge, edge_lens))}
    del got, edge
    if timing:
        res["ms"] = cuda_ms(lambda: FT.kernel_forward(
            *args, rate, causal, None), reps=5, warmup=1)
        _, stats = FT.kernel_forward(*args, rate, causal, None)
        res["bwd_ms"] = cuda_ms(lambda: FT.kernel_backward(
            *args, do, stats, rate, causal, None), reps=3, warmup=1)
    if timing is True:
        res["plain_ms"] = cuda_ms(lambda: FT.fused_attention_train_reference(
            *args, rate, causal), reps=2, warmup=1)
        res["plain_bwd_ms"] = cuda_ms(
            lambda: FT.fused_attention_train_reference_bwd(
                *args, do, rate, causal), reps=2, warmup=1)
        if rate == 0.0:
            res.update(_sdpa_train_ms(q, k, v, do, lens, causal))
        keys = _keys(lengths, Lq, Lk, causal) * H
        el = q.element_size()
        n_q, n_kv = q.numel(), k.numel()
        for tag, nbytes, flops in (
                ("", (2 * n_q + 2 * n_kv) * el + B * 4, 4.0 * 64 * keys),
                ("bwd_", (4 * n_q + 4 * n_kv) * el + B * 4,
                 10.0 * 64 * keys)):
            t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
            t_ops = flops / PEAK_FLOPS[dtype] * 1e3
            res[f"{tag}bound_ms"] = max(t_bytes, t_ops)
            res[f"{tag}bound_by"] = "bytes" if t_bytes >= t_ops \
                else "operations"
    return res


def _sdpa_train_ms(q, k, v, do, lens, causal):
    """scaled_dot_product_attention forward, and its backward, with the
    same length (and causal) mask at rate 0: a yardstick only."""
    Lq, Lk = q.shape[2], k.shape[2]
    col = torch.arange(Lk, device=DEVICE)
    mask = (col[None, :] < lens[:, None])[:, None, None, :]
    if causal:
        row = torch.arange(Lq, device=DEVICE)
        mask = mask & (col[None, :] <= row[:, None])[None, None]
    qg, kg, vg = (x.detach().clone().requires_grad_() for x in (q, k, v))
    fwd = _sdpa(qg, kg, vg, mask)
    out = fwd()
    ms = cuda_ms(fwd, reps=5, warmup=1)
    bwd_ms = cuda_ms(lambda: torch.autograd.grad(out, (qg, kg, vg), do,
                                                 retain_graph=True),
                     reps=5, warmup=1)
    return {"library_ms": ms, "library_bwd_ms": bwd_ms}


def phase_train_kernel(train_packed):
    results = {}
    worst = {"fwd": 0.0, "bwd": 0.0}
    for name, H, Hkv, Lq, Lk, causal, lengths in _train_shapes(train_packed):
        for dtype in (torch.bfloat16, torch.float32):
            for rate in TRAIN_RATES:
                # bf16 timed in full at the flagship's shapes; the f32
                # (SIMT) kernels' own times at the encoder shape
                timing = (Hkv != H or name.startswith("raster")) and (
                    dtype == torch.bfloat16 or (
                        "kernel" if name == "encoder self" else False))
                r = train_kernel_case(name, H, Hkv, Lq, Lk, causal, lengths,
                                      dtype, rate, timing=timing)
                rel, row = TRAIN_KERNEL_TOL[dtype]
                errs = " ".join(f"{k} {v:.2e}" for k, v in r["errs"].items())
                tag = (f"train_kernel {name} B={len(lengths)} H={H} "
                       f"Hkv={Hkv} Lq={Lq} Lk={Lk} causal={causal} "
                       f"{str(dtype)[6:]} rate={rate}")
                log(f"{tag}: err over its bound (rel {rel:g}, row {row:g}) "
                    f"{errs}; max abs err " + " ".join(
                        f"{k} {v:.2e}" for k, v in r["abs_errs"].items()))
                check(max(r["errs"].values()) <= 1.0, f"{tag} disagrees")
                edge = " ".join(f"{k} {v:.2e}"
                                for k, v in r["edge_errs"].items())
                log(f"  B=8 with rows of length 0 and 1: err over its bound "
                    f"{edge}")
                check(max(r["edge_errs"].values()) <= 1.0,
                      f"{tag}: the batch with rows of length 0 and 1 "
                      f"disagrees")
                if "flip" in r:
                    flips = " ".join(f"{k} {v:.2e}"
                                     for k, v in r["flip_errs"].items())
                    log(f"  against the plain version with keep bit "
                        f"{r['flip']} flipped: err over its bound {flips} "
                        f"(each must exceed 1)")
                    check(min(r["flip_errs"].values()) > 1.0,
                          f"{tag}: the tolerance does not see one flipped "
                          f"keep bit")
                if timing == "kernel":
                    log(f"  fwd kernel {r['ms']:.3f} ms; bwd kernel "
                        f"{r['bwd_ms']:.3f} ms")
                    results[(name, rate, "f32")] = r
                elif timing:  # max |kernel - plain| in the path's dtype
                    a = r["abs_errs"]
                    worst["fwd"] = max(worst["fwd"], a["o"])
                    worst["bwd"] = max(worst["bwd"], a["dq"], a["dk"],
                                       a["dv"])
                    lib = (f"; sdpa fwd {r['library_ms']:.3f} ms, bwd "
                           f"{r['library_bwd_ms']:.3f} ms"
                           if "library_ms" in r else
                           "; no library call computes it at this rate")
                    log(f"  fwd kernel {r['ms']:.3f} ms, plain "
                        f"{r['plain_ms']:.3f} ms, bound {r['bound_ms']:.4f} "
                        f"ms ({r['bound_by']}); bwd kernel {r['bwd_ms']:.3f} "
                        f"ms, plain {r['plain_bwd_ms']:.3f} ms, bound "
                        f"{r['bwd_bound_ms']:.4f} ms ({r['bwd_bound_by']})"
                        f"{lib}")
                    results[(name, rate)] = r
                torch.cuda.empty_cache()
    return results, worst


# ---------------------------------------------------------------- phase 6
def _unpack_infos(infos, root):
    names = []
    for info in infos:
        with open(os.path.join(root, f"{info['name']}.json"), "w") as f:
            json.dump(info, f)
        names.append(f"{info['name']}.json")
    return names


def phase_train_step(params, cfg, train_infos, tmp):
    import dataclasses
    from plankassembly_tpu_torch.config import ModelDims
    from plankassembly_tpu_torch.data.line_data import LineDataset
    from plankassembly_tpu_torch.data.loader import collate
    from plankassembly_tpu_torch.models.model import train_step_loss
    from plankassembly_tpu_torch.ops import flash_train as FT
    from plankassembly_tpu_torch.train.state import tree_leaves

    golden = np.load(os.path.join(FIXTURES, "train_step_jax_golden.npz"))
    root = os.path.join(tmp, "train_step")
    os.makedirs(root)
    n = len(golden["names"])
    names = _unpack_infos(train_infos[:n], root)
    ds = LineDataset(root, names, cfg)
    batch = collate([ds[i] for i in range(n)])
    check(list(batch["name"]) == list(golden["names"]),
          "train_step: not the golden's drawings")
    batch = {k: torch.from_numpy(v).to(DEVICE) for k, v in batch.items()
             if isinstance(v, np.ndarray)}
    dims = dataclasses.replace(ModelDims.from_config(cfg), dropout=0.0)
    leaves = [(("/".join(p)), t.detach().clone().requires_grad_())
              for p, t in tree_leaves(params)]
    check([p for p, _ in leaves] == list(golden["leaf_names"]),
          "train_step: parameter leaves differ from the golden's")
    tree = {}
    for path, t in leaves:
        node = tree
        for part in path.split("/")[:-1]:
            node = node.setdefault(part, {})
        node[path.split("/")[-1]] = t
    probes = [torch.from_numpy(np.random.default_rng(i).standard_normal(
        tuple(t.shape)).astype(np.float32)).to(DEVICE, torch.float64)
        for i, (_, t) in enumerate(leaves)]
    valid = int((batch["output_label"] != dims.pad).sum().item())
    launches = {}
    for tag, cd in (("f32", torch.float32), ("bf16", torch.bfloat16)):
        for _, t in leaves:
            t.grad = None
        FT.fwd_launches = FT.bwd_launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss, mets = train_step_loss(
            tree, batch, dims, rng=torch.Generator(DEVICE).manual_seed(0),
            deterministic=False, compute_dtype=cd, flash=True)
        loss.backward()
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        launches[tag] = (FT.fwd_launches, FT.bwd_launches)
        tol = STEP_TOL[tag]
        g_loss, g_acc = float(golden[f"loss_{tag}"]), float(
            golden[f"accuracy_{tag}"])
        d_loss = abs(loss.item() - g_loss) / g_loss
        d_acc = abs(float(mets["accuracy"]) - g_acc)
        worst_norm = worst_probe = worst_bk = 0.0
        for i, (path, t) in enumerate(leaves):
            gd = t.grad.double()
            norm = gd.norm().item()
            if path.endswith("/bk"):
                worst_bk = max(worst_bk, norm / float(
                    golden[f"grad_norm_{tag}"].max()))
                continue
            ref_norm = float(golden[f"grad_norm_{tag}"][i])
            worst_norm = max(worst_norm, abs(norm - ref_norm) / ref_norm)
            dot = (gd * probes[i]).sum().item()
            worst_probe = max(worst_probe, abs(
                dot - float(golden[f"grad_probe_{tag}"][i])) / ref_norm)
        log(f"train_step {tag} B={n} (ep221, dropout 0, kernels on): loss "
            f"{loss.item():.6f} vs JAX {g_loss:.6f} (rel {d_loss:.2e}, tol "
            f"{tol['loss']:g}); accuracy {float(mets['accuracy']):.6f} vs "
            f"{g_acc:.6f} (tol {tol['acc']:g}, {valid} tokens); gradients "
            f"of {len(leaves)} leaves: worst norm rel {worst_norm:.2e} (tol "
            f"{tol['norm']:g}), worst probe err/norm {worst_probe:.2e} (tol "
            f"{tol['probe']:g}), key-bias norm/max {worst_bk:.2e} (tol "
            f"{tol['bk']:g}); {ms:.1f} ms (first call of the dtype); "
            f"launches fwd/bwd {launches[tag]}")
        note("train_step", f"{tag} loss rel {d_loss:.2e} acc {d_acc:.2e} "
             f"norm {worst_norm:.2e} probe {worst_probe:.2e}")
        check(d_loss <= tol["loss"], f"train_step {tag}: loss")
        check(d_acc <= tol["acc"], f"train_step {tag}: accuracy")
        check(worst_norm <= tol["norm"], f"train_step {tag}: gradient norm")
        check(worst_probe <= tol["probe"], f"train_step {tag}: probe")
        check(worst_bk <= tol["bk"], f"train_step {tag}: key-bias gradient")
        L = dims.num_encoder_layers + 2 * dims.num_decoder_layers
        check(launches[tag] == (L, L),
              f"train_step {tag}: launches {launches[tag]}, expected {L}")
    return launches["bf16"]


# ---------------------------------------------------------------- phase 7
def phase_fit(train_infos, serve_infos, tmp):
    from plankassembly_tpu_torch import cli
    from plankassembly_tpu_torch.ops import attention as A
    from plankassembly_tpu_torch.ops import flash_train as FT
    from plankassembly_tpu_torch.ops import persistent_decode as PD
    from plankassembly_tpu_torch.train.state import tree_leaves

    root = os.path.join(tmp, "fit_data")
    os.makedirs(root)
    splits = {}
    for split, infos in (("train", train_infos), ("valid", serve_infos)):
        splits[split] = os.path.join(tmp, f"{split}.txt")
        with open(splits[split], "w") as f:
            f.write("".join(n + "\n" for n in _unpack_infos(infos, root)))
    argv = ["fit", "--config", os.path.join(ROOT, "configs",
                                            "train_synthetic_gqa.yaml"),
            "--device", DEVICE,
            "--model.hparams.ROOT", root,
            "--model.hparams.DATASETS_TRAIN", splits["train"],
            "--model.hparams.DATASETS_VALID", splits["valid"],
            "--model.hparams.DATASETS_TEST", splits["valid"],
            "--trainer.max_epochs", str(FIT_EPOCHS),
            "--trainer.check_val_every_n_epoch", str(FIT_EPOCHS),
            "--trainer.log_every_n_steps", "1",
            "--trainer.default_root_dir", os.path.join(tmp, "runs")]
    log("fit: python -m plankassembly_tpu_torch.cli " + " ".join(argv[:4])
        + " ... (B=64, dropout 0.2, AUG_RATIO 0.1, seed 2022, "
        f"{FIT_EPOCHS} epochs of 1 step)")
    A.launches = PD.launches = FT.fwd_launches = FT.bwd_launches = 0
    t0 = time.perf_counter()
    trainer, state = cli.main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    # validation decodes by the config's decode_impl "auto" without
    # kv_quant: the full-precision mxu path, no persistent decode
    counts = {"fused_attention_train_fwd": FT.fwd_launches,
              "fused_attention_train_bwd": FT.bwd_launches,
              "flash_attention": A.launches}
    cfg = trainer.cfg
    check((cfg.BATCH_SIZE, cfg.MODEL.DROPOUT, cfg.DATA.AUG_RATIO,
           cfg.seed_everything, cfg.trainer.fused_attention,
           cfg.trainer.decode_impl, cfg.trainer.kv_quant) ==
          (64, 0.2, 0.1, 2022, True, "auto", False),
          "fit: not the flagship's settings")
    check(PD.launches == 0, "fit: validation took the persistent decode")
    with open(os.path.join(trainer.log_dir, "metrics.jsonl")) as f:
        recs = [json.loads(line) for line in f]
    steps = [r for r in recs if "train/loss" in r]
    losses = [r["train/loss"] for r in steps]
    val = [r for r in recs if "val/fmeasure" in r][-1]
    check(len(losses) == FIT_EPOCHS == state.step,
          f"fit: {len(losses)} logged steps, state at {state.step}")
    check(all(np.isfinite(losses)), "fit: a loss is not finite")
    first5, last5 = float(np.mean(losses[:5])), float(np.mean(losses[-5:]))
    # each step's log reads its loss, which waits for the device: the gap
    # between two logs is one whole step
    times = [r["time"] for r in steps]
    ms_step = (times[-1] - times[4]) / (len(times) - 5) * 1e3
    restored = trainer.load_checkpoint(os.path.join(
        trainer.log_dir, "checkpoints", "last"))
    same = all(torch.equal(a.detach(), b.detach()) for (_, a), (_, b) in
               zip(tree_leaves(state.params), tree_leaves(restored.params)))
    log(f"fit {FIT_EPOCHS} steps B={cfg.BATCH_SIZE} on {card_line()}: "
        f"losses {' '.join(f'{x:.4f}' for x in losses)}; mean of the first 5 "
        f"{first5:.4f}, of the last 5 {last5:.4f}; {ms_step:.1f} ms per step "
        f"({1e3 / ms_step:.3f} steps/s, steps 6-{FIT_EPOCHS}, host clock); "
        f"train/steps_per_sec {steps[-1].get('train/steps_per_sec')}; val on "
        f"{len(serve_infos)} drawings P {val['val/precision']:.4f} R "
        f"{val['val/recall']:.4f} F1 {val['val/fmeasure']:.4f}; reloaded "
        f"'last' equal {same}, step {restored.step}; wall {wall:.1f} s; "
        f"launches {counts}; device idle share not measured here "
        f"(tools/profile_torch_train.py)")
    note("fit", f"loss {first5:.4f} -> {last5:.4f} (means of 5), "
         f"{ms_step:.1f} ms/step, val F1 {val['val/fmeasure']:.4f}")
    check(last5 < first5, "fit: the loss did not fall")
    check(same and restored.step == state.step,
          "fit: the reloaded checkpoint differs")
    check(0.0 <= val["val/fmeasure"] <= 1.0, "fit: validation F1")
    check(all(c > 0 for c in counts.values()),
          f"fit: a kernel did not run on the training path: {counts}")
    return {"launches": counts, "ms_per_step": ms_step}


# ------------------------------------------------------------ phases 8-9
def _bound(nbytes, ops):
    """(bound ms, what sets it) from bytes moved and (operations, peak
    rate) pairs."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = sum(n / peak for n, peak in ops) * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


class _plain:
    """Within the block, the decode paths call the kernels' plain versions
    (on the card) in place of the kernels."""

    def __enter__(self):
        from plankassembly_tpu_torch.ops import cross_decode as CD
        from plankassembly_tpu_torch.ops import fused_decode as FD
        self.saved = (CD.cross_attn_decode, FD.fused_decoder_layer)
        CD.cross_attn_decode = CD.cross_attn_decode_reference
        FD.fused_decoder_layer = FD.fused_decoder_layer_reference
        return self

    def __exit__(self, *exc):
        from plankassembly_tpu_torch.ops import cross_decode as CD
        from plankassembly_tpu_torch.ops import fused_decode as FD
        CD.cross_attn_decode, FD.fused_decoder_layer = self.saved
        return False


def cross_case(q, k, v, bias, ks, vs, real, H, timing):
    """cross_attn_decode against its plain version on one set of inputs;
    with timing, kernel / plain / bound ms (and SDPA's where it computes
    the same function: compute-dtype K/V, no scales): `ms` keys by CUDA
    events around the calls, `device_ms` keys the kernels' own time."""
    from plankassembly_tpu_torch.ops import cross_decode as CD
    BH, Dh = q.shape
    Li = k.shape[1]
    sm = 1.0 / math.sqrt(Dh)
    got = CD.cross_attn_decode(q, k, v, bias, ks, vs, sm_scale=sm)
    ref = CD.cross_attn_decode_reference(q, k, v, bias, ks, vs, sm_scale=sm)
    torch.cuda.synchronize()
    check(bool(torch.isfinite(got).all()), "cross_attn_decode not finite")
    res = {"err": (got - ref).abs().max().item(),
           "scale": ref.abs().max().item(),
           "shape": (f"B*H={BH} Li={Li} Dh={Dh}, q {_dtype_name(q)}, K/V "
                     f"{_dtype_name(k)}")}
    if timing:
        def kernel():
            return CD.cross_attn_decode(q, k, v, bias, ks, vs, sm_scale=sm)

        def plain():
            return CD.cross_attn_decode_reference(q, k, v, bias, ks, vs,
                                                  sm_scale=sm)
        _time(res, "", kernel)
        _time(res, "plain_", plain, reps=5, warmup=1)
        res["library_ms"] = res["library_device_ms"] = None
        if ks is None:
            B = BH // H
            sdpa = torch.nn.functional.scaled_dot_product_attention
            args = (q.reshape(B, H, 1, Dh), k.reshape(B, H, Li, Dh),
                    v.reshape(B, H, Li, Dh))
            mask = bias.reshape(B, H, 1, Li).to(q.dtype)
            _time(res, "library_", lambda: sdpa(*args, attn_mask=mask,
                                                scale=sm))
        # q read, out written, the scales, and K, V and bias of each
        # (row, real key) once: masked keys weigh exactly 0
        nbytes = (q.numel() * q.element_size() + BH * Dh * 4
                  + (2 * BH * 4 if ks is not None else 0)
                  + H * real * (2 * Dh * k.element_size() + 4))
        res["bound_ms"], res["bound_by"] = _bound(
            nbytes, [(4.0 * Dh * H * real, PEAK_FLOPS[q.dtype])])
        # what skipping the spans with no real key saves: the kernel's
        # device time with every key of the bucket real, beside its time on
        # the real mask
        every = torch.zeros_like(bias)
        res["every_key_device_ms"] = kernel_ms(
            lambda: CD.cross_attn_decode(q, k, v, every, ks, vs,
                                         sm_scale=sm), reps=20, warmup=3)
    return res


def ragged_mask(mask):
    """The main request's mask (True: padded key) with three rows changed:
    row 0 has no real key, row 1 only key 0, and row 2 its middle real key
    masked (a masked key inside the row's extent)."""
    rag = mask.clone()
    rag[0] = True
    rag[1] = True
    rag[1, 0] = False
    real2 = torch.nonzero(~mask[2]).flatten()
    check(real2.numel() >= 3, "row 2 of the main request is too short")
    rag[2, real2[real2.numel() // 2]] = True
    return rag


def _dtype_name(x):
    return str(x.dtype).replace("torch.", "").replace("bfloat16", "bf16") \
        .replace("float32", "f32")


@contextlib.contextmanager
def _patched(module, **attrs):
    """Set module attributes for the duration of the block."""
    saved = {name: getattr(module, name) for name in attrs}
    for name, value in attrs.items():
        setattr(module, name, value)
    try:
        yield
    finally:
        for name, value in saved.items():
            setattr(module, name, value)


def _time(res, prefix, fn, reps=20, warmup=3):
    """res[prefix + "ms"]: CUDA events around the calls, as every kernel's
    `ms`; res[prefix + "device_ms"]: the device time of its kernels."""
    res[f"{prefix}ms"] = cuda_ms(fn, reps=reps, warmup=warmup)
    res[f"{prefix}device_ms"] = kernel_ms(fn, reps=reps, warmup=warmup)


def fused_bound(dims, cd, B, t, real, ffn_only=False):
    """Least time of fused_decoder_layer (with its fused_ffn) or of
    fused_ffn alone at step t: weights, biases and norms once, x in and
    out, the new K/V rows; the self cache's t keys and the cross K/V of
    each row's real keys with their scales, the cross bias (shared by the
    heads) once per real key; the products in the compute dtype, the
    integer attention sums at the int8 rate."""
    D, F, H, Dh = (dims.num_model, dims.num_feedforward, dims.num_head,
                   dims.head_dim)
    el = torch.tensor([], dtype=cd).element_size()
    ffn_w = 2 * D * F * el + (F + D + 2 * D) * 4
    ffn_ops = 2.0 * B * 2 * D * F
    if ffn_only:
        return _bound(ffn_w + 2 * B * D * 4, [(ffn_ops, PEAK_FLOPS[cd])])
    att_w = 6 * D * D * el + (3 * D + 3 * D + 4 * D) * 4
    nbytes = (att_w + ffn_w + 2 * B * D * 4 + 2 * B * D + 2 * B * H * 4
              + B * H * t * (2 * Dh + 2 * 4)
              + H * real * 2 * Dh + real * 4 + 2 * B * H * 4)
    mm = 2.0 * B * 6 * D * D + ffn_ops
    att = 4.0 * Dh * H * (B * t + real)
    return _bound(nbytes, [(mm, PEAK_FLOPS[cd]), (att, PEAK_INT8_OPS)])


def fused_trajectory(params, memory, mask, dims, cd, steps=TRAJ_STEPS):
    """fused_decoder_layer against its plain version at every layer of
    `steps`, on the plain version's own decode (the `fused` loop with the
    plain layer, on the card), both fed the same inputs at each point.
    Returns one dict per point: each row's error over its largest value
    (`row_errs`), the same for the planted fault (one cross weight scale
    per row), and the new K/V's int8 values that differ (`nk_flips`,
    `nv_flips`): an int8 flip counted apart from the rows it moves."""
    from plankassembly_tpu_torch.decode import FusedDecode
    from plankassembly_tpu_torch.ops import fused_decode as FD
    kernel = FD.fused_decoder_layer
    kw = dict(H=dims.num_head, Dh=dims.head_dim,
              sm_scale=1.0 / math.sqrt(dims.head_dim), cd=cd)

    def rows(a, b):
        return ((a - b).abs().amax(dim=1) / b.abs().amax(dim=1)).tolist()

    points = []
    with torch.no_grad(), _plain():
        dec = FusedDecode(params, memory, mask, dims, cd)
        for t in range(max(steps) + 1):
            if t in steps:
                x = dec.embed(t)
                for layer in range(dims.num_decoder_layers):
                    largs = (x, t, *dec.layer_args(layer))
                    got = kernel(*largs, **kw)
                    ref = FD.fused_decoder_layer_reference(*largs, **kw)
                    with _patched(FD, chunk_width=lambda Li: Li):
                        bad = FD.fused_decoder_layer_reference(*largs,
                                                               **kw)[0]
                    points.append({
                        "t": t, "layer": layer,
                        "row_errs": rows(got[0], ref[0]),
                        "planted_row_errs": rows(bad, ref[0]),
                        "nk_flips": int((got[1] != ref[1]).sum().item()),
                        "nv_flips": int((got[2] != ref[2]).sum().item())})
                    x = ref[0]
            dec.step(t)
    return points


def trajectory_summary(points):
    """Counts over fused_trajectory's points: pairs over FUSED_ROW_TOL for
    the kernel and the planted fault, points with any, int8 flips, the
    worst points."""
    pairs = sum(len(p["row_errs"]) for p in points)
    over = sum(e > FUSED_ROW_TOL for p in points for e in p["row_errs"])
    bad = sum(e > FUSED_ROW_TOL for p in points
              for e in p["planted_row_errs"])
    errs = sorted(e for p in points for e in p["row_errs"])
    worst = sorted(points, key=lambda p: -max(p["row_errs"]))[:4]
    return {"points": len(points), "pairs": pairs, "rows_over": over,
            "points_over": sum(max(p["row_errs"]) > FUSED_ROW_TOL
                               for p in points),
            "median_row_err": errs[len(errs) // 2],
            "max_row_err": errs[-1],
            "planted_rows_over": bad,
            "nk_flips": sum(p["nk_flips"] for p in points),
            "nv_flips": sum(p["nv_flips"] for p in points),
            "points_with_flips": sum(bool(p["nk_flips"] or p["nv_flips"])
                                     for p in points),
            "worst": [f"t{p['t']} l{p['layer']} {max(p['row_errs']):.3e} "
                      f"(flips {p['nk_flips']}+{p['nv_flips']})"
                      for p in worst]}


def trajectory_line(tag, sm):
    return (f"{tag} along the plain version's decode, every layer at steps "
            f"{','.join(map(str, TRAJ_STEPS))} ({sm['points']} points, "
            f"{sm['pairs']} (point, row) pairs): rows over FUSED_ROW_TOL "
            f"{sm['rows_over']} (limit {TRAJ_ROW_SHARE:g} of the pairs), at "
            f"{sm['points_over']} points; row err median "
            f"{sm['median_row_err']:.3e}, max {sm['max_row_err']:.3e}; "
            f"planted fault rows over {sm['planted_rows_over']} (must pass "
            f"{TRAJ_PLANTED_SHARE:g} of the pairs); int8 flips nk "
            f"{sm['nk_flips']}, nv {sm['nv_flips']}, at "
            f"{sm['points_with_flips']} points; worst points: "
            f"{'; '.join(sm['worst'])}")


def phase_mha_kernels(params, dims, req, bucket):
    from plankassembly_tpu_torch.decode import (
        FusedDecode, _pad_or_crop, precompute_cross_kv,
    )
    from plankassembly_tpu_torch.models.model import encode
    from plankassembly_tpu_torch.ops import cross_decode as CD
    from plankassembly_tpu_torch.ops import fused_decode as FD

    H, Dh = dims.num_head, dims.head_dim
    out = {}
    for name, cd in (("bf16", torch.bfloat16), ("f32", torch.float32)):
        timing = name == "bf16"
        inputs = _pad_or_crop(dict(req), bucket, dims)
        mask = inputs["input_mask"]
        with torch.no_grad():
            memory = encode(params, inputs, dims, compute_dtype=cd,
                            flash=True)
            B, Li = memory.shape[:2]
            real = int((~mask).sum().item())
            # cross_attn_decode on layer MID_LAYER's real K/V, a seeded q
            ck, cv = precompute_cross_kv(params, memory, dims, cd)
            k = ck[MID_LAYER].permute(0, 2, 1, 3).reshape(B * H, Li, Dh)
            v = cv[MID_LAYER].permute(0, 2, 1, 3).reshape(B * H, Li, Dh)
            del ck, cv
            k, v = k.contiguous(), v.contiguous()
            bias = torch.where(mask, -1e9, 0.0)[:, None, :].expand(
                B, H, Li).reshape(B * H, Li).contiguous()
            g = torch.Generator(device=DEVICE).manual_seed(6)
            q = torch.randn((B * H, Dh), generator=g, device=DEVICE).to(cd)
            kq, ks = CD.quantize_rows(k, (1, 2))
            vq, vs = CD.quantize_rows(v, (1, 2))
            for form, args in (("int8", (kq, vq, ks, vs)),
                               (name, (k, v, None, None))):
                r = cross_case(q, args[0], args[1], bias, args[2], args[3],
                               real, H, timing)
                tag = (f"cross_attn_decode {r['shape']} ({real} real "
                       f"(row, key) pairs per head)")
                line = (f"{tag}: max_abs_err {r['err']:.3e} (scale "
                        f"{r['scale']:.3e}, tol {CROSS_TOL:g} of it)")
                if timing:
                    lib = ("null (no one call takes int8 K/V with scales)"
                           if r["library_ms"] is None else
                           f"{r['library_ms']:.4f} ms (sdpa; device "
                           f"{r['library_device_ms']:.4f} ms)")
                    line += (f"; events: kernel {r['ms']:.4f} ms, plain "
                             f"{r['plain_ms']:.4f} ms, library {lib}; "
                             f"device: kernel {r['device_ms']:.4f} ms, plain "
                             f"{r['plain_device_ms']:.4f} ms; bound "
                             f"{r['bound_ms']:.4f} ms ({r['bound_by']})")
                if timing:
                    line += (f"; device time with every key of the bucket "
                             f"real {r['every_key_device_ms']:.4f} ms (on the "
                             f"real mask {r['device_ms']:.4f} ms)")
                log(line)
                check(r["err"] <= CROSS_TOL * max(r["scale"], 1e-6),
                      f"{tag} disagrees")
                out[("cross", name, form)] = r
                # ragged rows: no real key, one, a masked key inside
                rag = torch.where(ragged_mask(mask), -1e9, 0.0)[:, None, :] \
                    .expand(B, H, Li).reshape(B * H, Li).contiguous()
                rr = cross_case(q, args[0], args[1], rag, args[2], args[3],
                                real, H, False)
                log(f"cross_attn_decode ragged rows (0 real keys, 1, a masked "
                    f"key inside the extent) {rr['shape']}: max_abs_err "
                    f"{rr['err']:.3e} (scale {rr['scale']:.3e}, tol "
                    f"{CROSS_TOL:g} of it)")
                check(rr["err"] <= CROSS_TOL * max(rr["scale"], 1e-6),
                      f"cross_attn_decode ragged {rr['shape']} disagrees")
                r["ragged_err"] = rr["err"]
            del k, v, kq, vq
            # fused_decoder_layer at step MID_STEP, layer MID_LAYER, with
            # caches from a real run of the fused path
            dec = FusedDecode(params, memory, mask, dims, cd)
            for t in range(MID_STEP):
                dec.step(t)
            x = dec.embed(MID_STEP)
            for l in range(MID_LAYER):
                x = dec.layer(l, x, MID_STEP)
            largs = (x, MID_STEP, *dec.layer_args(MID_LAYER))
            kw = dict(H=H, Dh=Dh, sm_scale=1.0 / math.sqrt(Dh), cd=cd)
            got = FD.fused_decoder_layer(*largs, **kw)
            ref = FD.fused_decoder_layer_reference(*largs, **kw)
            torch.cuda.synchronize()
            check(all(bool(torch.isfinite(a.float()).all()) for a in got),
                  "fused_decoder_layer output not finite")
            x_err = (got[0] - ref[0]).abs().max().item()
            x_scale = ref[0].abs().max().item()
            row_err = ((got[0] - ref[0]).abs().amax(dim=1)
                       / ref[0].abs().amax(dim=1)).max().item()
            # the planted fault: one weight scale for all of a row's cross
            # chunks (chunk width Li) in the plain version
            with _patched(FD, chunk_width=lambda Li: Li):
                bad = FD.fused_decoder_layer_reference(*largs, **kw)[0]
            bad_err = ((got[0] - bad).abs().amax(dim=1)
                       / bad.abs().amax(dim=1)).max().item()
            nk_diff = int((got[1] != ref[1]).sum().item())
            nv_diff = int((got[2] != ref[2]).sum().item())
            nk_step = int((got[1].int() - ref[1].int()).abs().max().item())
            nv_step = int((got[2].int() - ref[2].int()).abs().max().item())
            s_err = max(((got[i] - ref[i]).abs() / ref[i].abs()).max().item()
                        for i in (3, 4))
            w1, b1, w2, b2, ln = (largs[2 + i] for i in (8, 9, 10, 11, 12))
            fx = got[0]  # the FFN on a realistic residual stream
            f_got = FD.fused_ffn(fx, w1, b1, w2, b2, ln[4:6], cd=cd)
            f_ref = FD.fused_ffn_reference(fx, w1, b1, w2, b2, ln[4:6], cd=cd)
            torch.cuda.synchronize()
            f_err = (f_got - f_ref).abs().max().item()
            f_scale = f_ref.abs().max().item()
            shape = (f"B={B} Li={Li} t={MID_STEP} layer {MID_LAYER} "
                     f"{name}")
            tag = f"fused_decoder_layer {shape}"
            line = (f"{tag}: x_out max_abs_err {x_err:.3e} (scale "
                    f"{x_scale:.3e}); worst row err / row max {row_err:.3e} "
                    f"(tol {FUSED_ROW_TOL:g}), against the plain version with "
                    f"one cross weight scale per row (planted fault) "
                    f"{bad_err:.3e} (must exceed the tol); nk "
                    f"differs in {nk_diff} of {got[1].numel()} (max step "
                    f"{nk_step}), nv in {nv_diff} (max step {nv_step}); "
                    f"nks/nvs rel err {s_err:.3e}; fused_ffn max_abs_err "
                    f"{f_err:.3e} (scale {f_scale:.3e}, tol {FFN_TOL:g})")
            res = {"err": x_err, "ffn_err": f_err, "nk_diff": nk_diff,
                   "nv_diff": nv_diff, "row_err": row_err,
                   "planted_row_err": bad_err, "shape": shape,
                   "ffn_shape": f"B={B} D={dims.num_model} "
                                f"F={dims.num_feedforward} {name}"}
            if timing:
                _time(res, "", lambda: FD.fused_decoder_layer(*largs, **kw))
                _time(res, "plain_",
                      lambda: FD.fused_decoder_layer_reference(*largs, **kw),
                      reps=5, warmup=1)
                _time(res, "ffn_", lambda: FD.fused_ffn(
                    fx, w1, b1, w2, b2, ln[4:6], cd=cd))
                _time(res, "plain_ffn_", lambda: FD.fused_ffn_reference(
                    fx, w1, b1, w2, b2, ln[4:6], cd=cd), reps=5, warmup=1)
                res["bound_ms"], res["bound_by"] = fused_bound(
                    dims, cd, B, MID_STEP, real)
                res["ffn_bound_ms"], res["ffn_bound_by"] = fused_bound(
                    dims, cd, B, MID_STEP, real, ffn_only=True)
                line += (f"; layer (with its ffn): events {res['ms']:.4f} "
                         f"ms, plain {res['plain_ms']:.4f} ms; device "
                         f"{res['device_ms']:.4f} ms, plain "
                         f"{res['plain_device_ms']:.4f} ms; bound "
                         f"{res['bound_ms']:.4f} ms ({res['bound_by']}); "
                         f"ffn: events {res['ffn_ms']:.4f} ms, plain "
                         f"{res['plain_ffn_ms']:.4f} ms; device "
                         f"{res['ffn_device_ms']:.4f} ms, plain "
                         f"{res['plain_ffn_device_ms']:.4f} ms; bound "
                         f"{res['ffn_bound_ms']:.4f} ms "
                         f"({res['ffn_bound_by']}); library null")
            log(line)
            check(row_err <= FUSED_ROW_TOL, f"{tag}: x_out disagrees")
            check(bad_err > FUSED_ROW_TOL,
                  f"{tag}: the check does not catch the planted fault")
            check(f_err <= FFN_TOL * max(f_scale, 1.0),
                  f"{tag}: fused_ffn disagrees")
            check(s_err <= 1e-5, f"{tag}: nks/nvs disagree")
            check(nk_diff == 0 and nv_diff == 0, f"{tag}: nk/nv differ")
            # ragged cross rows: no real key, one, a masked key inside
            rag = largs[:-1] + (torch.where(ragged_mask(mask), -1e9, 0.0)
                                .float(),)
            rg = FD.fused_decoder_layer(*rag, **kw)
            rf = FD.fused_decoder_layer_reference(*rag, **kw)
            torch.cuda.synchronize()
            rag_err = ((rg[0] - rf[0]).abs().amax(dim=1)
                       / rf[0].abs().amax(dim=1)).max().item()
            rag_diff = int((rg[1] != rf[1]).sum().item()
                           + (rg[2] != rf[2]).sum().item())
            log(f"{tag} ragged cross rows (0 real keys, 1, a masked key "
                f"inside the extent): worst row err / row max {rag_err:.3e} "
                f"(tol {FUSED_ROW_TOL:g}); nk/nv differ in {rag_diff}")
            check(rag_err <= FUSED_ROW_TOL, f"{tag} ragged: x_out disagrees")
            check(rag_diff == 0, f"{tag} ragged: nk/nv differ")
            res["ragged_row_err"] = rag_err
            # where the layer's device time goes, kernel by kernel
            bd = kernel_breakdown(lambda: FD.fused_decoder_layer(*largs, **kw))
            log(f"{tag}: kernels of one layer with its fused_ffn, device "
                f"time per call: {breakdown_line(bd)}")
            res["breakdown"] = [{"kernel": n, "launches": c, "us": us}
                                for n, c, us in bd]
            # many points, on the plain version's own trajectory
            sm = trajectory_summary(fused_trajectory(params, memory, mask,
                                                     dims, cd))
            log(trajectory_line(tag.split(" t=")[0], sm))
            check(sm["rows_over"] <= TRAJ_ROW_SHARE * sm["pairs"],
                  f"{tag}: the kernel moves too many rows along the plain "
                  f"decode")
            check(sm["planted_rows_over"] > TRAJ_PLANTED_SHARE * sm["pairs"],
                  f"{tag}: the trajectory check does not catch the planted "
                  f"fault")
            res["trajectory"] = {k: v for k, v in sm.items() if k != "worst"}
            out[("fused", name)] = res
            del dec, memory
        torch.cuda.empty_cache()
    return out


def _agreement(samples, gold, end):
    """Share of equal tokens over each golden program up to and including
    its END (trailing tokens past a batch's exit depend on the batch)."""
    same = total = 0
    for a, b in zip(samples, gold):
        n = len(_upto_end(b, end))
        same += int((np.asarray(a)[:n] == b[:n]).sum())
        total += n
    return same / total


# each kernel's launch counter: (module, attribute)
COUNTERS = {"flash_attention": ("attention", "launches"),
            "cross_attn_decode": ("cross_decode", "launches"),
            "fused_decoder_layer": ("fused_decode", "layer_launches"),
            "fused_ffn": ("fused_decode", "ffn_launches"),
            "persistent_greedy_decode": ("persistent_decode", "launches")}


def _counter_module(name):
    import importlib
    return importlib.import_module(
        f"plankassembly_tpu_torch.ops.{COUNTERS[name][0]}")


def _launch_counts():
    return {n: getattr(_counter_module(n), COUNTERS[n][1]) for n in COUNTERS}


def _reset_counts():
    for n in COUNTERS:
        setattr(_counter_module(n), COUNTERS[n][1], 0)


# the kernels each path must launch
PATH_KERNELS = {"kernel": ("flash_attention", "cross_attn_decode"),
                "fused": ("flash_attention", "fused_decoder_layer",
                          "fused_ffn")}


def phase_mha_serve(params, cfg, dims, packed, golden, bucket, req):
    from plankassembly_tpu_torch.decode import _pad_or_crop, decode_from_memory
    from plankassembly_tpu_torch.metrics import batch_scores
    from plankassembly_tpu_torch.models.model import encode

    gt = torch.from_numpy(golden["gt_samples"])
    end = dims.end
    counts = {}
    for name, cd in (("bf16", torch.bfloat16), ("f32", torch.float32)):
        for impl in ("kernel", "fused"):
            ref = "xla" if impl == "kernel" else "mxu"
            _reset_counts()
            samples, attach, stats, wall = serve(params, cfg, packed, bucket,
                                                 cd, cross_impl=impl)
            c = _launch_counts()
            check(samples.shape == (len(packed), dims.max_output_length),
                  f"samples shape {samples.shape}")
            prec, rec, f1 = batch_scores(torch.from_numpy(samples), gt)
            gold = golden[f"{ref}_{name}_samples"]
            agree = _agreement(samples, gold, end)
            same = np.mean([np.array_equal(_upto_end(a, end),
                                           _upto_end(b, end))
                            for a, b in zip(samples, gold)])
            f1m = f1.mean().item()
            gold_f1 = float(golden[f"{ref}_{name}_f1"].mean())
            line = (f"mha_serve {impl} {name}: {len(packed)} programs in "
                    f"{stats['calls']} batches: P {prec.mean():.6f} R "
                    f"{rec.mean():.6f} F1 {f1m:.6f} vs JAX {ref}-int8 golden "
                    f"F1 {gold_f1:.6f} (gap {f1m - gold_f1:+.6f}); token "
                    f"agreement with it {agree:.4f}, identical programs "
                    f"{same:.4f}; {len(packed) / stats['seconds']:.2f} "
                    f"programs/s in the backend, "
                    f"{stats['seconds'] * 1e3 / stats['steps']:.3f} ms/step "
                    f"over {stats['steps']} steps; launches {c}")
            if impl == "fused" and name == "f32":
                sub = golden["fused_f32_samples"]
                sub_same = [np.array_equal(_upto_end(a, end),
                                           _upto_end(b, end))
                            for a, b in zip(samples, sub)]
                sub_attach = all(np.array_equal(
                    attach[i, :len(_upto_end(sub[i], end))],
                    golden["fused_f32_attach"][i, :len(_upto_end(sub[i], end))])
                    for i in range(len(sub)))
                line += (f"; first {len(sub)} programs against JAX "
                         f"fused-interpret: identical {sub_same}, attach "
                         f"equal {sub_attach}")
            log(line)
            note("mha_serve", f"{impl} {name} F1 {f1m:.6f} (golden "
                 f"{gold_f1:.6f}) agreement {agree:.4f} identical {same:.4f} "
                 f"{stats['seconds'] * 1e3 / stats['steps']:.3f} ms/step")
            if impl == "kernel":
                check(abs(f1m - gold_f1) <= MHA_F1_TOL[name],
                      f"mha_serve kernel {name}: F1 {f1m} vs golden {gold_f1}")
            else:
                check(agree >= 0.8, f"mha_serve fused {name}: token agreement "
                      f"with the mxu golden {agree}")
            if impl == "fused" and name == "f32":
                check(all(sub_same) and sub_attach, "mha_serve fused f32: "
                      "not the JAX fused-interpret programs")
            check(all(c[k] > 0 for k in PATH_KERNELS[impl]),
                  f"mha_serve {impl} {name}: a kernel of the path did not "
                  f"run: {c}")
            check(c["persistent_greedy_decode"] == 0,
                  f"mha_serve {impl} {name}: the persistent decode ran")
            counts[(impl, name)] = c

        # the last 32 programs through each path's kernels and its plain
        # versions, on the same memory
        inputs = _pad_or_crop(dict(req), bucket, dims)
        with torch.no_grad():
            memory = encode(params, inputs, dims, compute_dtype=cd,
                            flash=True)
        gt_last = gt[-memory.shape[0]:]
        for impl in ("kernel", "fused"):
            def run():
                out = decode_from_memory(params, memory,
                                         inputs["input_mask"], dims,
                                         compute_dtype=cd, kv_quant=True,
                                         cross_impl=impl)
                torch.cuda.synchronize()
                return out
            t0 = time.perf_counter()
            k_out = run()
            k_s = time.perf_counter() - t0
            with _plain():
                t0 = time.perf_counter()
                p_out = run()
                p_s = time.perf_counter() - t0
            ks_, ps_ = k_out["samples"].cpu(), p_out["samples"].cpu()
            agree = _agreement(ks_.numpy(), ps_.numpy(), end)
            f1_k = batch_scores(ks_, gt_last)[2].mean().item()
            f1_p = batch_scores(ps_, gt_last)[2].mean().item()
            log(f"mha {impl} {name} B={memory.shape[0]} kernels vs plain "
                f"versions on the same memory: token agreement {agree:.4f}, "
                f"F1 {f1_k:.6f} vs {f1_p:.6f}; {k_s * 1e3:.1f} ms "
                f"({k_out['num_steps']} steps) vs {p_s * 1e3:.1f} ms "
                f"({p_out['num_steps']} steps), host clock")
            check(abs(f1_k - f1_p) <= FUSED_PLAIN_F1_TOL,
                  f"mha {impl} {name}: F1 {f1_k} vs plain {f1_p}")
            check(agree >= 0.9, f"mha {impl} {name}: token agreement with "
                  f"the plain versions {agree}")
        del memory
        torch.cuda.empty_cache()
    return counts


# ------------------------------------------------------------ phases 13-14
def sideface_requests(infos):
    """The drawings as sideface requests: their `svgs` the two-point
    linestrings of their lines."""
    return [{**info, "svgs": [json.dumps(
        {"type": "LineString", "coordinates": [[a, b], [c, d]]},
        separators=(",", ":")) for a, b, c, d in info["lines"]]}
        for info in infos]


def _prefix_hidden_err(k_out, p_out, row):
    """max |hidden| difference of one row over the steps before its first
    differing token (inputs equal there), and that step count."""
    ks, ps = k_out["samples"][row].cpu(), p_out["samples"][row].cpu()
    diff = torch.nonzero(ks != ps)
    n = int(diff[0]) if diff.numel() else ks.numel()
    if n == 0:
        return 0.0, 0
    return (k_out["hidden"][row, :n].float()
            - p_out["hidden"][row, :n].float()).abs().max().item(), n


def sideface_kernel_checks(params, dims, cfg, packed, bucket):
    """flash_attention and persistent_greedy_decode against their plain
    versions at the sideface shape: the largest request with a drawing of
    no side face (one real key: END) as its last row."""
    from plankassembly_tpu_torch.decode import _pad_or_crop
    from plankassembly_tpu_torch.models.model import encode
    from plankassembly_tpu_torch.ops import persistent_decode as PD
    from plankassembly_tpu_torch.serving import pack_info_dict

    rows = packed[-max(REQUESTS):-1] + [
        pack_info_dict(NO_FACE, cfg, with_type=False)]
    lengths = np.array([int((~p["input_mask"]).sum()) for p in rows])
    check(lengths[-1] == 1, "the zero-face drawing has more than one key")
    B, Hkv = len(rows), dims.kv_heads
    out = {}
    for dtype in (torch.bfloat16, torch.float32):
        r = flash_case(B, dims.num_head, Hkv, bucket, lengths, False, dtype,
                       seed=11, timing=True if dtype == torch.bfloat16
                       else "kernel")
        tag = f"sideface flash B={B} L={bucket} {str(dtype)[6:]}"
        log(f"{tag} (a row with one key): max_abs_err {r['err']:.3e} (tol "
            f"{FLASH_TOL[dtype]:g})" + (
                f", err over the TRAIN_KERNEL_TOL bound {r['elem']:.3f}; "
                f"kernel {r['ms']:.3f} ms, plain {r['plain_ms']:.3f} ms, "
                f"sdpa {r['library_ms']:.3f} ms, bound {r['bound_ms']:.4f} "
                f"ms ({r['bound_by']})" if "elem" in r else
                f"; kernel {r['ms']:.3f} ms"))
        check(r["err"] <= FLASH_TOL[dtype], f"{tag} disagrees")
        check(r.get("elem", 0.0) <= 1.0, f"{tag} disagrees element by "
              f"element")
        out[("flash", str(dtype)[6:])] = r
    batch = _pad_or_crop(_stack(rows, range(B)), bucket, dims)
    mask = batch["input_mask"]
    for name, cd in (("bf16", torch.bfloat16), ("f32", torch.float32)):
        with torch.no_grad():
            memory = encode(params, batch, dims, compute_dtype=cd, flash=True)
        k_out = PD.persistent_greedy_decode(params, memory, mask, dims,
                                            compute_dtype=cd)
        p_out = PD.greedy_decode_reference(params, memory, mask, dims,
                                           compute_dtype=cd)
        agree = _agreement(k_out["samples"].cpu().numpy(),
                           p_out["samples"].cpu().numpy(), dims.end)
        errs = [_prefix_hidden_err(k_out, p_out, i) for i in range(B)]
        zero_err, zero_n = errs[-1]
        rest = max(e for e, _ in errs[:-1])
        zero_same = torch.equal(k_out["samples"][-1], p_out["samples"][-1])
        log(f"sideface decode {name} B={B} Li={bucket}: token agreement "
            f"with the plain version {agree:.4f}; the zero-face row: tokens "
            f"identical {zero_same}, hidden max_abs_err {zero_err:.3e} over "
            f"its first {zero_n} steps (the other rows' worst {rest:.3e}); "
            f"num_steps kernel {k_out['num_steps']} plain "
            f"{p_out['num_steps']}")
        check(agree >= (0.99 if name == "f32" else 0.9),
              f"sideface decode {name}: token agreement {agree}")
        check(zero_err <= RAGGED_HIDDEN_FACTOR * max(rest, 1e-6),
              f"sideface decode {name}: the zero-face row's hidden error "
              f"{zero_err} against {rest} elsewhere")
        if name == "f32":
            check(zero_same, "sideface decode f32: the zero-face row's "
                  "tokens differ from the plain version")
        out[("decode", name)] = {"agreement": agree, "zero_err": zero_err,
                                 "zero_same": zero_same}
        del memory
    return out


def sideface_http(params, cfg, dims, infos):
    """A BucketRouter of sideface backends (SF_HTTP_BUCKETS, batch
    HTTP_BATCH, "auto", bf16) behind make_http_server; every request and
    the zero-face drawing POSTed from HTTP_CLIENTS threads: each answered
    by the smallest bucket that fits its packed face tokens, equal to the
    decode of the batch its server ran, repeated one call at a time."""
    import urllib.error
    import urllib.request

    from plankassembly_tpu_torch.decode import greedy_decode
    from plankassembly_tpu_torch.serving import (
        BatchingServer, BucketRouter, make_http_server, make_live_backend,
        pack_info_dict, postprocess_prediction,
    )

    infos = list(infos) + [NO_FACE]
    calls, servers = [], []
    for bucket in SF_HTTP_BUCKETS:
        backend, meta = make_live_backend(params, cfg, batch=HTTP_BATCH,
                                          bucket=bucket, device=DEVICE,
                                          with_type=False)

        def recorded(request, backend=backend, bucket=bucket):
            out = backend(request)
            calls.append((bucket, request, out))
            return out
        servers.append(BatchingServer(recorded, meta, max_wait_ms=20))
    router = BucketRouter(servers)
    httpd = make_http_server(router, cfg, dims, port=0)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    base = f"http://127.0.0.1:{httpd.server_address[1]}"

    def post(body):
        req = urllib.request.Request(base + "/v1/reconstruct",
                                     data=json.dumps(body).encode())
        try:
            with urllib.request.urlopen(req, timeout=120) as r:
                return r.status, json.loads(r.read().decode())
        except urllib.error.HTTPError as e:
            return e.code, json.loads(e.read().decode())

    answers = [None] * len(infos)
    try:
        t0 = time.perf_counter()

        def client(k):
            for i in range(k, len(infos), HTTP_CLIENTS):
                answers[i] = post(infos[i])
        threads = [threading.Thread(target=client, args=(k,))
                   for k in range(HTTP_CLIENTS)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=240)
        wall = time.perf_counter() - t0
        check(not any(t.is_alive() for t in threads),
              "sideface http: a client did not come back")
        no_svgs = post({k: v for k, v in infos[0].items() if k != "svgs"})
    finally:
        httpd.shutdown()
        httpd.server_close()
        router.close()
    check(all(a is not None and a[0] == 200 for a in answers),
          f"sideface http: a request failed: "
          f"{[a for a in answers if a and a[0] != 200][:2]}")
    packed = [pack_info_dict(i, cfg, with_type=False) for i in infos]
    tokens = [int((~p["input_mask"]).sum()) for p in packed]
    want = [min(b for b in SF_HTTP_BUCKETS if b >= n) for n in tokens]
    got = [a[1]["bucket"] for a in answers]
    # what a router by line count would need: 4 tokens a line and END
    beyond = sum(4 * len(i["lines"]) + 1 > max(SF_HTTP_BUCKETS)
                 for i in infos)
    served, direct = {}, {}
    for bucket, req, out in calls:
        ref = greedy_decode(params, {k: torch.from_numpy(v).to(DEVICE)
                                     for k, v in req.items()}, dims,
                            kv_bucket=bucket, kv_quant=True)
        rs, ra = ref["samples"].cpu().numpy(), ref["attach"].cpu().numpy()
        for j, key in enumerate(req["input_value"]):
            served[(bucket, key.tobytes())] = (out["samples"][j],
                                               out["attach"][j])
            direct[(bucket, key.tobytes())] = (rs[j], ra[j])
    bad = []
    for i, (ans, p) in enumerate(zip(answers, packed)):
        key = (want[i], p["input_value"].tobytes())
        (s, a), (ds, da) = served[key], direct[key]
        n = len(_upto_end(ds, dims.end))
        pred, attach = postprocess_prediction(s, a, dims)
        if not (np.array_equal(s[:n], ds[:n]) and np.array_equal(a[:n], da[:n])
                and ans[1]["prediction"] == pred.tolist()
                and ans[1]["attach"] == attach):
            bad.append(i)
    rate = len(infos) / wall
    log(f"sideface http: {len(infos)} requests (one with no side face) "
        f"from {HTTP_CLIENTS} client threads through a ladder of "
        f"{SF_HTTP_BUCKETS} (batch {HTTP_BATCH}, auto, bf16) in {wall:.2f} s "
        f"= {rate:.2f} programs/s on {card_line()}; each bucket's answers "
        f"{dict(zip(SF_HTTP_BUCKETS, map(got.count, SF_HTTP_BUCKETS)))}, "
        f"chosen by packed face tokens ({min(tokens)}..{max(tokens)}); "
        f"{beyond} requests have more line tokens than the largest bucket; "
        f"answers equal to the one-at-a-time decode of their batch "
        f"{len(infos) - len(bad)} of {len(infos)}; a request without svgs "
        f"answered {no_svgs[0]}")
    check(got == want, "sideface http: an answer names another bucket than "
          "the smallest that fits its face tokens")
    check(not bad, f"sideface http: answers differ from the one-at-a-time "
          f"decode: {bad}")
    check(no_svgs[0] == 400, f"sideface http: a request without svgs "
          f"answered {no_svgs[0]}")
    return {"programs_per_s": rate, "beyond": beyond}


def phase_sideface_serve(params, cfg, dims, infos, golden):
    from plankassembly_tpu_torch.metrics import batch_scores
    from plankassembly_tpu_torch.serving import (
        make_live_backend, pack_info_dict,
    )

    end = dims.end
    packed = [pack_info_dict(i, cfg, with_type=False) for i in infos]
    check("input_type" not in packed[0], "sideface: a type stream packed")
    faces = np.array([(int((~p["input_mask"]).sum()) - 1) // 4
                      for p in packed])
    check(tuple(golden["requests"]) == REQUESTS, "sideface golden requests")
    check(np.array_equal(faces, golden["face_counts"]),
          "sideface: face counts differ from the JAX golden's")
    buckets = [int(b) for b in golden["buckets"]]
    gt = torch.from_numpy(golden["gt_samples"])
    res = {"zero_face": int((faces == 0).sum()), "buckets": buckets}
    for name, cd in (("bf16", torch.bfloat16), ("f32", torch.float32)):
        # one untimed call of the largest request first: the checkpoint's
        # first decode at this dtype and width (weights packed, graph set
        # up) stays out of the served times
        backend, _ = make_live_backend(params, cfg, batch=max(REQUESTS),
                                       bucket=buckets[-1], compute_dtype=cd,
                                       device=DEVICE, with_type=False)
        backend({k: np.stack([p[k] for p in packed[-max(REQUESTS):]])
                 for k in packed[0]})
        torch.cuda.synchronize()
        _reset_counts()
        samples, attach, stats, wall = serve(params, cfg, packed, None, cd,
                                             cross_impl="auto",
                                             with_type=False, buckets=buckets)
        counts = _launch_counts()
        check(samples.shape == (len(packed), dims.max_output_length),
              f"sideface samples shape {samples.shape}")
        prec, rec, f1 = batch_scores(torch.from_numpy(samples), gt)
        gold = golden[f"samples_{name}"]
        same = [np.array_equal(_upto_end(a, end), _upto_end(b, end))
                for a, b in zip(samples, gold)]
        agree = _agreement(samples, gold, end)
        attach_bad = [int(i) for i in np.flatnonzero(same) if not
                      np.array_equal(attach[i, :len(_upto_end(gold[i], end))],
                                     golden[f"attach_{name}"][i, :len(
                                         _upto_end(gold[i], end))])]
        f1m, gold_f1 = f1.mean().item(), float(golden[f"f1_{name}"].mean())
        ms_req = stats["seconds"] * 1e3 / stats["calls"]
        ms_step = stats["seconds"] * 1e3 / stats["steps"]
        log(f"sideface_serve {name}: {len(packed)} programs ({faces.min()}.."
            f"{faces.max()} faces, {res['zero_face']} with none) in "
            f"{stats['calls']} batches ({'/'.join(map(str, REQUESTS))}) at "
            f"buckets {buckets}: P {prec.mean():.6f} R {rec.mean():.6f} F1 "
            f"{f1m:.6f} vs JAX golden F1 {gold_f1:.6f} (tol "
            f"{SERVE_F1_TOL[name]}); identical programs {sum(same)} of "
            f"{len(same)}, token agreement {agree:.4f}, attach equal on "
            f"identical programs {not attach_bad}; steps per call "
            f"{stats['steps_per_call']} (golden "
            f"{golden[f'num_steps_{name}'].tolist()}); {ms_req:.1f} ms per "
            f"request in the backend (calls {stats['ms_per_call']} ms, after "
            f"a warm-up call), {ms_step:.3f} ms/step; launches {counts}")
        check(abs(f1m - gold_f1) <= SERVE_F1_TOL[name],
              f"sideface_serve {name} F1 {f1m} vs golden {gold_f1}")
        if name == "f32":
            check(all(same), f"sideface_serve f32: programs differ from the "
                  f"golden: {[i for i, x in enumerate(same) if not x]}")
        check(agree >= SF_AGREEMENT, f"sideface_serve {name}: token "
              f"agreement with the golden {agree}")
        check(not attach_bad, f"sideface_serve {name}: attach differs from "
              f"the golden on identical programs {attach_bad}")
        check(counts["flash_attention"] > 0
              and counts["persistent_greedy_decode"] > 0,
              f"sideface_serve {name}: a kernel did not run: {counts}")
        res[name] = {"f1": f1m, "golden_f1": gold_f1,
                     "identical": int(sum(same)), "agreement": agree,
                     "ms_per_request": ms_req, "ms_per_step": ms_step,
                     "launches": counts}
        note("sideface_serve", f"{name} F1 {f1m:.6f} (golden {gold_f1:.6f}) "
             f"identical {sum(same)}/{len(same)} agreement {agree:.4f} "
             f"{ms_req:.1f} ms/request {ms_step:.3f} ms/step launches "
             f"flash {counts['flash_attention']} persistent "
             f"{counts['persistent_greedy_decode']}")
    res["kernels"] = sideface_kernel_checks(params, dims, cfg, packed,
                                            buckets[-1])
    res["http"] = sideface_http(params, cfg, dims, infos)
    dec = res["kernels"]
    note("sideface_serve", f"zero-face drawings {res['zero_face']}, buckets "
         f"{buckets}; with a zero-face row: decode agreement bf16 "
         f"{dec[('decode', 'bf16')]['agreement']:.4f} f32 "
         f"{dec[('decode', 'f32')]['agreement']:.4f}, flash err bf16 "
         f"{dec[('flash', 'bfloat16')]['err']:.2e}; http "
         f"{res['http']['programs_per_s']:.2f} programs/s, buckets by face "
         f"tokens")
    return res


def _fit_ms(log_dir):
    """(losses, host-clock ms per step over steps 6..n, val record or
    None) from a run's metrics: each step's log reads its loss, which
    waits for the device, so the gap between two logs is one step."""
    with open(os.path.join(log_dir, "metrics.jsonl")) as f:
        recs = [json.loads(line) for line in f]
    steps = [r for r in recs if "train/loss" in r]
    times = [r["time"] for r in steps]
    vals = [r for r in recs if "val/fmeasure" in r]
    return ([r["train/loss"] for r in steps],
            (times[-1] - times[4]) / (len(times) - 5) * 1e3,
            vals[-1] if vals else None)


class _Epochs:
    """A loader's batches over as many epochs as asked for."""

    def __init__(self, loader):
        self.loader = loader
        self.fields = loader.fields

    def __iter__(self):
        while True:
            yield from self.loader


def device_steps_idle(trainer, state, loader):
    """(device idle share, device busy ms a step) over two training steps
    on device-resident data after one more, under the profiler."""
    it = iter(loader)

    def step():
        batch = next(it)
        trainer.device_step_fn(state, loader.fields, batch["idx"],
                               batch["aug"], batch["pos"], trainer._rng)
    step()
    idle, busy, _ = decode_idle_share(lambda: (step(), step()))
    it.close()
    return idle, busy / 2


def pack_ms(dataset, augment, rows=16):
    """Host ms to pack one sample from its JSON (with noise and, for the
    sideface dataset, the side-face extraction of the noisy lines, if
    `augment`), over the first `rows` samples."""
    rng = np.random.RandomState(0)
    t0 = time.perf_counter()
    for i in range(rows):
        dataset._pack(i, augment, rng)
    return (time.perf_counter() - t0) / rows * 1e3


def step_copies_ms(loader, reps=10):
    """(host ms, count) of one step's host-to-device copies on
    device-resident data (indices, positions, a batch's augmented rows as
    AUG_RATIO draws them), each pinned and sent as the loader sends it."""
    idx = np.arange(loader.batch_size)
    pos, aug = loader._aug_rows(idx)
    arrays = [idx, pos, *aug.values()]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        for a in arrays:
            loader._to_device(a)
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / reps * 1e3, len(arrays)


def phase_data_fit(train_infos, sf_infos, tmp):
    from plankassembly_tpu_torch import cli
    from plankassembly_tpu_torch.config import load_config
    from plankassembly_tpu_torch.data.device_loader import DeviceDataLoader
    from plankassembly_tpu_torch.data.loader import DataLoader
    from plankassembly_tpu_torch.ops import attention as A
    from plankassembly_tpu_torch.ops import flash_train as FT
    from plankassembly_tpu_torch.train.loop import SidefaceTrainer, Trainer

    card = card_line()
    root = os.path.join(tmp, "data_fit")
    os.makedirs(root)
    splits = {}
    for split, infos in (("train", train_infos), ("valid", sf_infos),
                         ("tiled", [dict(i, name=f"{i['name']}_{k}")
                                    for k in range(TIMING_TILE)
                                    for i in train_infos])):
        splits[split] = os.path.join(tmp, f"data_fit_{split}.txt")
        with open(splits[split], "w") as f:
            f.write("".join(n + "\n" for n in _unpack_infos(infos, root)))
    data = {"--model.hparams.ROOT": root,
            "--model.hparams.DATASETS_VALID": splits["valid"],
            "--model.hparams.DATASETS_TEST": splits["valid"],
            "--trainer.log_every_n_steps": "1"}

    # the sideface fit through the port's CLI, device-resident data
    argv = ["fit", "--config", os.path.join(
        ROOT, "configs", "train_synthetic_sideface_gqa.yaml"),
        "--device", DEVICE, "--model.hparams.DATASETS_TRAIN", splits["train"],
        "--trainer.max_epochs", str(SF_FIT_EPOCHS),
        "--trainer.check_val_every_n_epoch", str(SF_FIT_EPOCHS),
        "--trainer.default_root_dir", os.path.join(tmp, "sf_runs"),
        "--trainer.sample_cache", "true", "--trainer.device_data", "true"]
    for k, v in data.items():
        argv += [k, v]
    log("data_fit: python -m plankassembly_tpu_torch.trainer_sideface "
        + " ".join(argv[:3]) + " ... --trainer.sample_cache true "
        f"--trainer.device_data true (B=64, dropout 0.2, AUG_RATIO 0.1, "
        f"{SF_FIT_EPOCHS} epochs of 1 step)")
    _reset_counts()
    FT.fwd_launches = FT.bwd_launches = 0
    t0 = time.perf_counter()
    trainer, state = cli.main_sideface(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = {"fused_attention_train_fwd": FT.fwd_launches,
              "fused_attention_train_bwd": FT.bwd_launches,
              "flash_attention": A.launches}
    cfg = trainer.cfg
    check(type(trainer) is SidefaceTrainer, "data_fit: not the sideface "
          "trainer")
    check((cfg.BATCH_SIZE, cfg.MODEL.DROPOUT, cfg.DATA.AUG_RATIO,
           cfg.trainer.fused_attention, cfg.trainer.sample_cache,
           cfg.trainer.device_data) == (64, 0.2, 0.1, True, True, True),
          "data_fit: not the sideface config's settings")
    loader = trainer.train_dataloader()
    check(isinstance(loader, DeviceDataLoader),
          f"data_fit: the trainer took {type(loader).__name__}")
    check(os.path.isdir(os.path.join(cfg.trainer.default_root_dir,
                                     ".sample_cache")),
          "data_fit: no packed-sample cache")
    losses, ms_step, val = _fit_ms(trainer.log_dir)
    check(len(losses) == SF_FIT_EPOCHS == state.step,
          f"data_fit: {len(losses)} logged steps, state at {state.step}")
    check(all(np.isfinite(losses)), "data_fit: a loss is not finite")
    check(val is not None and 0.0 <= val["val/fmeasure"] <= 1.0,
          "data_fit: validation F1")
    L = cfg.MODEL.NUM_ENCODER_LAYERS + 2 * cfg.MODEL.NUM_DECODER_LAYERS
    check(counts["fused_attention_train_fwd"] == L * SF_FIT_EPOCHS
          and counts["fused_attention_train_bwd"] == L * SF_FIT_EPOCHS
          and counts["flash_attention"] > 0,
          f"data_fit: kernel launches {counts}")
    # after the checks of the fit: these steps move the state on
    sf_idle, sf_busy = device_steps_idle(trainer, state, _Epochs(loader))
    sf_aug_ms = pack_ms(loader.dataset, True)
    log(f"data_fit sideface {SF_FIT_EPOCHS} steps B=64 device_data on {card}: "
        f"losses {' '.join(f'{x:.4f}' for x in losses)}; {ms_step:.1f} ms "
        f"per step (steps 6-{SF_FIT_EPOCHS}, host clock); val on "
        f"{len(sf_infos)} sideface requests P {val['val/precision']:.4f} R "
        f"{val['val/recall']:.4f} F1 {val['val/fmeasure']:.4f}; wall "
        f"{wall:.1f} s; launches {counts}; two more steps under the "
        f"profiler: device busy {sf_busy:.1f} ms a step, idle share "
        f"{sf_idle:.3f}; an augmented row (noise and side-face extraction) "
        f"packs in {sf_aug_ms:.2f} ms on the host")
    res = {"sideface": {"losses": losses, "ms_per_step": ms_step,
                        "val_f1": val["val/fmeasure"], "launches": counts,
                        "busy_ms_per_step": sf_busy, "idle_share": sf_idle,
                        "aug_pack_ms": sf_aug_ms}}
    note("data_fit", f"sideface device_data: loss {losses[0]:.4f} -> "
         f"{losses[-1]:.4f}, {ms_step:.1f} ms/step (device busy "
         f"{sf_busy:.1f}, idle share {sf_idle:.3f}, augmented row packs in "
         f"{sf_aug_ms:.2f} ms), val F1 "
         f"{val['val/fmeasure']:.4f}, kernel 3 launches fwd "
         f"{counts['fused_attention_train_fwd']} bwd "
         f"{counts['fused_attention_train_bwd']} ({card})")
    trainer.close()
    del trainer, state, loader
    torch.cuda.empty_cache()

    # the complete fit three ways, on the same steps
    path = os.path.join(ROOT, "configs", "train_synthetic_gqa.yaml")
    base = {k[2:]: v for k, v in data.items()}
    base.update({"model.hparams.DATASETS_TRAIN": splits["tiled"],
                 "trainer.max_epochs": str(TIMING_EPOCHS),
                 "trainer.check_val_every_n_epoch": "1000",
                 "trainer.save_last": "false"})
    timing = {}
    for mode, flags, kind in (
            ("DataLoader", {}, DataLoader),
            ("sample_cache", {"trainer.sample_cache": "true"}, DataLoader),
            ("device_data", {"trainer.device_data": "true"},
             DeviceDataLoader)):
        cfg = load_config(path, {**base, **flags,
                                 "trainer.default_root_dir":
                                     os.path.join(tmp, f"t_{mode}")})
        trainer = Trainer(cfg, device=DEVICE)
        state = trainer.fit(trainer.init_state())
        torch.cuda.synchronize()
        losses, ms, _ = _fit_ms(trainer.log_dir)
        loader = trainer.train_dataloader()
        check(type(loader) is kind and (loader.dataset._cache is not None)
              == bool(flags), f"data_fit {mode}: the trainer took "
              f"{type(loader).__name__}")
        steps = TIMING_TILE * len(train_infos) // cfg.BATCH_SIZE \
            * TIMING_EPOCHS
        check(state.step == steps == len(losses)
              and all(np.isfinite(losses)), f"data_fit {mode}: steps")
        timing[mode] = ms
        if mode == "device_data":
            idle, busy = device_steps_idle(trainer, state, loader)
            timing["device_data_idle_share"] = idle
            timing["device_data_busy_ms_per_step"] = busy
            timing["copies_ms"], timing["copies"] = step_copies_ms(loader)
            timing["pack_ms"] = pack_ms(loader.dataset, False)
            timing["aug_pack_ms"] = pack_ms(loader.dataset, True)
        loader.close()
        trainer.close()
        del trainer, state, loader
        torch.cuda.empty_cache()
    log(f"data_fit complete fit, B={cfg.BATCH_SIZE}, {steps} steps "
        f"({steps // TIMING_EPOCHS} an epoch) on {card}: host-clock ms per "
        f"step (steps 6-{steps}): DataLoader {timing['DataLoader']:.1f}, "
        f"sample_cache {timing['sample_cache']:.1f}, device_data "
        f"{timing['device_data']:.1f}; two device_data steps under the "
        f"profiler: device busy {timing['device_data_busy_ms_per_step']:.1f} "
        f"ms a step, idle share {timing['device_data_idle_share']:.3f}; a "
        f"step's {timing['copies']} host-to-device copies (indices, "
        f"positions, augmented rows) {timing['copies_ms']:.3f} ms; a sample "
        f"packs from its JSON in {timing['pack_ms']:.2f} ms on the host, "
        f"{timing['aug_pack_ms']:.2f} ms augmented")
    note("data_fit", f"complete ms/step DataLoader {timing['DataLoader']:.1f} "
         f"sample_cache {timing['sample_cache']:.1f} device_data "
         f"{timing['device_data']:.1f}; device_data busy "
         f"{timing['device_data_busy_ms_per_step']:.1f} ms/step idle share "
         f"{timing['device_data_idle_share']:.3f}, copies "
         f"{timing['copies_ms']:.3f} ms; a sample packs in "
         f"{timing['pack_ms']:.2f} ms, augmented {timing['aug_pack_ms']:.2f} "
         f"({card})")
    res["complete"] = timing
    return res


# ------------------------------------------------------------------- main
# ------------------------------------------------------------ phases 15-16
def phase_export(params, cfg, dims, infos, packed, gt, tmp):
    """ep221 exported as artifacts of the port (batch EXPORT_BATCH, bf16):
    the HTTP ladder's buckets, a weight_quant and a beam artifact at the
    widest. Each loaded and served the drawings that fit its bucket, as
    requests of EXPORT_BATCH, against the live decode with the same
    options on the same requests (bit for bit) and the JAX goldens' F1;
    then `serve --artifact` over the ladder (`http_ladder`)."""
    from plankassembly_tpu_torch import serve as serve_cli
    from plankassembly_tpu_torch.beam import beam_decode
    from plankassembly_tpu_torch.decode import (
        greedy_decode, quantize_decoder_weights,
    )
    from plankassembly_tpu_torch.export import (
        export_serving, load_artifact, save_artifact,
    )

    root = os.path.join(tmp, "artifacts")
    os.makedirs(root)
    widest = HTTP_BUCKETS[-1]
    kinds = [(f"k{b}", {"bucket": b}) for b in HTTP_BUCKETS] + [
        ("weight_quant", {"bucket": widest, "weight_quant": True}),
        (f"beam{BEAMS}", {"bucket": widest, "beam": BEAMS})]
    paths, export_s = {}, {}
    for tag, kw in kinds:
        t0 = time.perf_counter()
        blob, meta = export_serving(params, cfg, batch=EXPORT_BATCH,
                                    compute_dtype=torch.bfloat16, **kw)
        paths[tag] = os.path.join(root, f"gqa_complete_ep221.{tag}.ptrv")
        save_artifact(paths[tag], blob, meta)
        export_s[tag] = time.perf_counter() - t0
    sizes = {tag: os.path.getsize(p) for tag, p in paths.items()}
    log(f"export: {len(paths)} artifacts of ep221 (batch {EXPORT_BATCH}, "
        f"bf16): sizes MB " + ", ".join(f"{t} {n / 1e6:.2f}" for t, n in
                                         sizes.items())
        + f"; checkpoint {os.path.getsize(CKPT) / 1e6:.2f} MB; export s "
        + ", ".join(f"{t} {x:.2f}" for t, x in export_s.items()))
    check(sizes["weight_quant"] < sizes[f"k{widest}"],
          f"export: the weight_quant artifact is not smaller: {sizes}")

    goldens = {f"k{widest}": "serve64_jax_golden.npz",
               "weight_quant": "serve64_wq_jax_golden.npz",
               f"beam{BEAMS}": "serve64_beam4_jax_golden.npz"}
    lengths = [int((~p["input_mask"]).sum()) for p in packed]
    qparams = quantize_decoder_weights(params)
    res = {"sizes": sizes}
    for tag, path in paths.items():
        prog = load_artifact(path, device=DEVICE)
        meta = prog.meta
        bucket, beam = meta["bucket"], meta["beam"]
        live = qparams if meta["weight_quant"] else params
        rows = [i for i, n in enumerate(lengths) if n <= bucket]
        check(rows, f"export {tag}: no drawing fits bucket {bucket}")
        samples = np.zeros((len(packed), dims.max_output_length), np.int32)
        differ, steps, secs = [], 0, 0.0
        counts = dict.fromkeys(COUNTERS, 0)  # the artifact's calls only
        for lo in range(0, len(rows), EXPORT_BATCH):
            idx = rows[lo:lo + EXPORT_BATCH]
            req = {k: np.stack([packed[i][k] for i in idx])
                   for k in meta["input_keys"]}
            torch.cuda.synchronize()
            _reset_counts()
            t0 = time.perf_counter()
            got = prog(req)
            torch.cuda.synchronize()
            secs += time.perf_counter() - t0
            counts = {k: n + _launch_counts()[k] for k, n in counts.items()}
            steps += int(got["num_steps"])
            inputs = {k: torch.from_numpy(v[:, :bucket]).to(DEVICE)
                      for k, v in req.items()}
            if beam >= 2:
                want = beam_decode(live, inputs, dims, num_beams=beam,
                                   compute_dtype=torch.bfloat16)
            else:
                want = greedy_decode(live, inputs, dims,
                                     compute_dtype=torch.bfloat16,
                                     kv_bucket=bucket, kv_quant=True,
                                     cross_impl="mxu")
            for j, i in enumerate(idx):
                samples[i] = got["samples"][j]
                if not (np.array_equal(got["samples"][j],
                                       want["samples"][j].cpu().numpy())
                        and np.array_equal(got["attach"][j],
                                           want["attach"][j].cpu().numpy())):
                    differ.append(i)
        ms_step = secs * 1e3 / steps
        line = (f"export {tag}: {len(rows)} of {len(packed)} drawings fit "
                f"bucket {bucket}, in requests of {EXPORT_BATCH}: programs "
                f"equal to the live decode with the same options "
                f"{len(rows) - len(differ)} of {len(rows)}; {steps} steps in "
                f"{secs * 1e3:.1f} ms = {ms_step:.3f} ms/step (host clock, "
                f"{'beam search' if beam >= 2 else 'the mxu host loop'}); "
                f"launches {counts}")
        r = {"rows": len(rows), "ms_per_step": ms_step, "launches": counts}
        if tag in goldens:
            gold = np.load(os.path.join(FIXTURES, goldens[tag]))
            _, _, f1 = _scores(samples, gt)
            gold_f1 = float(gold["f1_bf16"].mean())
            same = _identical(samples, gold["samples_bf16"], dims.end)
            line += (f"; F1 {f1:.6f} vs JAX golden {gold_f1:.6f} (tol "
                     f"{SERVE_F1_TOL['bf16']}), identical to it {same:.4f}")
            check(abs(f1 - gold_f1) <= SERVE_F1_TOL["bf16"],
                  f"export {tag}: F1 {f1} vs golden {gold_f1}")
            r.update(f1=f1, golden_f1=gold_f1, identical=same)
        log(line)
        check(not differ, f"export {tag}: programs differ from the live "
              f"decode: {differ}")
        check(counts["flash_attention"] > 0 and sum(counts.values()) ==
              counts["flash_attention"], f"export {tag}: launches {counts}")
        res[tag] = r
        del prog
    ladder = [paths[f"k{b}"] for b in HTTP_BUCKETS]
    hp = os.path.splitext(CKPT)[0] + ".hparams.yaml"
    httpd, router = serve_cli.make_server(
        ["--artifact", *ladder, "--hparams", hp, "--port", "0",
         "--max_wait_ms", "20"])
    http = http_ladder(httpd, router, cfg, dims, infos, packed, gt,
                       lambda bucket, inputs: greedy_decode(
                           params, inputs, dims,
                           compute_dtype=torch.bfloat16, kv_bucket=bucket,
                           kv_quant=True, cross_impl="mxu"))
    log(f"export: serve --artifact {' '.join(map(os.path.basename, ladder))}"
        f": {http['line']}")
    check(abs(http["f1"] - HTTP_F1) <= SERVE_F1_TOL["bf16"],
          f"export http F1 {http['f1']}")
    check(http["meta"]["format"] == "PTRV1", "export http: /meta")
    res["http"] = http
    wide = res[f"k{widest}"]
    note("export", f"sizes MB {sizes[f'k{widest}'] / 1e6:.2f} (weight_quant "
         f"{sizes['weight_quant'] / 1e6:.2f}); bucket {widest} F1 "
         f"{wide['f1']:.6f} {wide['ms_per_step']:.3f} ms/step, weight_quant "
         f"{res['weight_quant']['ms_per_step']:.3f}, beam{BEAMS} "
         f"{res[f'beam{BEAMS}']['ms_per_step']:.3f}; every program equal to "
         f"the live decode; http {http['programs_per_s']:.2f} programs/s")
    return res


def raster_requests(infos, cfg):
    """The drawings' segments packed as the raster dataset packs them
    (their `svgs`, `pack_lines`), and the host rasterizer's images."""
    from plankassembly_tpu_torch.data import geometry as geo
    from plankassembly_tpu_torch.data.raster import pack_lines, rasterize_views

    max_lines = cfg.DATA.MAX_INPUT_LENGTH // cfg.DATA.NUM_INPUT_DOF
    packed, host = [], []
    for info in infos:
        lines = [geo.from_geojson(s) for s in info["svgs"]]
        packed.append(pack_lines(lines, info["views"], info["types"],
                                 max_lines))
        host.append(rasterize_views(lines, info["views"], info["types"],
                                    cfg.DATA.IMAGE_SIZE))
    return packed, host


def _sampler_scores(heads, dims, struct, pos, h_t, h_cache, t):
    """The candidates' values the greedy sampler takes the argmax of at
    step t (`decode._mixed_sample`): the vocab logits for the first
    plank's coordinates, the mixed vocab || pointer probabilities after."""
    from plankassembly_tpu_torch.decode import EPS, NEG_INF, _head_mm
    vocab_logits = _head_mm(heads["vocab"], h_t)
    if t + 1 < dims.num_output_dof:
        return vocab_logits
    feature = _head_mm(heads["pointer"], h_t)
    pointer = torch.einsum("bd,bsd->bs", feature,
                           h_cache.to(feature.dtype)) / dims.num_model
    prob = torch.sigmoid(h_t @ heads["switch"]["w"] + heads["switch"]["b"])
    pointer = torch.softmax(pointer + torch.where(pos >= t, NEG_INF, 0.0)
                            [None, :], dim=-1) * prob
    pointer = torch.where(struct[t][None, :] == 0, EPS, pointer)
    pointer = torch.where(pos[None, :] > t, -1.0, pointer)
    return torch.cat([torch.softmax(vocab_logits, dim=-1) * (1 - prob),
                      pointer], dim=-1)


def near_tie_gaps(decode_fn, first_diff):
    """Run decode_fn() with the sampler watched: for each row r of
    first_diff {r: t}, the gap between the two best candidates at step t
    over the best's value."""
    from plankassembly_tpu_torch import decode as D
    sample = D._mixed_sample
    gaps = {}

    def watched(heads, dims, struct, pos, h_t, h_cache, output, attach,
                done, t):
        rows = [r for r, s in first_diff.items() if s == t]
        if rows:
            top = torch.topk(_sampler_scores(heads, dims, struct, pos, h_t,
                                             h_cache, t).float(), 2).values
            for r in rows:
                gaps[r] = ((top[r, 0] - top[r, 1]) /
                           top[r, 0].abs().clamp(min=1e-30)).item()
        return sample(heads, dims, struct, pos, h_t, h_cache, output,
                      attach, done, t)

    with _patched(D, _mixed_sample=watched):
        decode_fn()
    return gaps


def phase_raster(sf_infos, train_infos, tmp):
    """The raster/ViT modality on raster512_complete_ep99: the device
    rasterizer against the host one on the 64 drawings, greedy_decode_raster
    of them as two requests of 32 in bf16 and f32 against the JAX golden,
    kernel 1 against its plain version on the encoder's real q/k/v and at
    its shape, then `trainer_raster fit` from init."""
    from plankassembly_tpu_torch import cli
    from plankassembly_tpu_torch.checkpoint import load_checkpoint
    from plankassembly_tpu_torch.config import ModelDims
    from plankassembly_tpu_torch.data.raster import rasterize_device
    from plankassembly_tpu_torch.models import model as M
    from plankassembly_tpu_torch.models import vit as V
    from plankassembly_tpu_torch.ops import attention as A
    from plankassembly_tpu_torch.ops import flash_train as FT

    params, cfg = load_checkpoint(RASTER_CKPT, device=DEVICE)
    dims = ModelDims.from_config(cfg)
    vit = V.VitDims(cfg.DATA.IMAGE_SIZE, cfg.DATA.PATCH_SIZE)
    check(vit.num_tokens == RASTER_TOKENS and dims.kv_heads == dims.num_head,
          f"raster: not the MHA 192-token model: {vit}, {dims}")
    golden = np.load(os.path.join(FIXTURES, "serve64_raster_jax_golden.npz"))
    check(tuple(golden["requests"]) == RASTER_REQUESTS, "raster golden")
    packed, host = raster_requests(sf_infos, cfg)
    segments = np.array([int((p["input_line_inten"] > 0).sum())
                         for p in packed])
    check(np.array_equal(segments, golden["segments"]),
          "raster: segment counts differ from the JAX golden's")
    starts = np.cumsum((0,) + RASTER_REQUESTS[:-1])
    reqs = [_stack(packed, range(a, a + n))
            for a, n in zip(starts, RASTER_REQUESTS)]
    res = {}

    # the device rasterizer against the host one, every drawing
    bad = []
    for a, req in zip(starts, reqs):
        img = V.batch_images(req, vit).cpu().numpy()
        bad += [int(a + j) for j in range(len(img))
                if not np.array_equal(img[j], host[a + j])]
    args = [reqs[0][k] for k in ("input_lines", "input_line_view",
                                 "input_line_inten")]
    raster_ms = cuda_ms(lambda: rasterize_device(*args, vit.image_size))
    log(f"raster: device rasterizer ({len(packed)} drawings, "
        f"{segments.min()}..{segments.max()} segments, {vit.image_size}^2) "
        f"pixel-equal to the host rasterizer on {len(packed) - len(bad)} of "
        f"{len(packed)}; {raster_ms:.3f} ms a request of "
        f"{RASTER_REQUESTS[0]} (CUDA events)")
    check(not bad, f"raster: device pixels differ from the host's: {bad}")
    res["rasterize_ms"] = raster_ms

    gt = torch.from_numpy(golden["gt_samples"])
    for name, cd in (("bf16", torch.bfloat16), ("f32", torch.float32)):
        V.greedy_decode_raster(params, reqs[0], dims, vit, compute_dtype=cd)
        samples, attach, steps, ms = [], [], [], []
        _reset_counts()
        for req in reqs:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = V.greedy_decode_raster(params, req, dims, vit,
                                         compute_dtype=cd)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
            samples.append(out["samples"].cpu().numpy())
            attach.append(out["attach"].cpu().numpy())
            steps.append(int(out["num_steps"]))
        counts = _launch_counts()
        samples = np.concatenate(samples)
        gold = golden[f"samples_{name}"]
        same = [np.array_equal(_upto_end(a, dims.end), _upto_end(b, dims.end))
                for a, b in zip(samples, gold)]
        agree = _agreement(samples, gold, dims.end)
        p_, r_, f1 = _scores(samples, gt)
        gold_f1 = float(golden[f"f1_{name}"].mean())
        ms_step = sum(ms) / sum(steps)
        log(f"raster decode {name}: {len(samples)} programs as requests of "
            f"{'/'.join(map(str, RASTER_REQUESTS))}: P {p_:.6f} R {r_:.6f} "
            f"F1 {f1:.6f} vs JAX golden {gold_f1:.6f} (tol {RASTER_F1_TOL}); "
            f"identical programs {sum(same)} of {len(same)}, token agreement "
            f"{agree:.4f}; steps {steps} (golden "
            f"{golden[f'num_steps_{name}'].tolist()}); ms per request "
            f"{[round(x, 1) for x in ms]} = {ms_step:.3f} ms/step (host "
            f"clock, encoder included, after a warm-up call); launches "
            f"{counts}")
        if name == "f32" and not all(same):
            diff = {}
            for i in np.flatnonzero(~np.array(same)):
                d = np.flatnonzero(samples[i] != gold[i])
                diff[int(i)] = int(d[0])
            gaps = {}
            for a, n, req in zip(starts, RASTER_REQUESTS, reqs):
                rows = {i - a: t for i, t in diff.items() if a <= i < a + n}
                if rows:
                    g = near_tie_gaps(lambda req=req: V.greedy_decode_raster(
                        params, req, dims, vit, compute_dtype=cd), rows)
                    gaps.update({a + r: v for r, v in g.items()})
            pairs = ", ".join(f"{i}: ({diff[i]}, {gaps[i]:.2e})"
                              for i in diff)
            log(f"  f32 programs that differ from the golden, (first "
                f"differing step, relative top-2 gap of the port's sampler "
                f"there): {{{pairs}}}")
            check(all(gaps[i] < NEAR_TIE for i in diff),
                  f"raster f32: a program differs from the golden past a "
                  f"near-tie: {gaps}")
        if name == "bf16":
            check(agree >= RASTER_AGREEMENT,
                  f"raster bf16: token agreement {agree}")
        check(abs(f1 - gold_f1) <= RASTER_F1_TOL,
              f"raster {name}: F1 {f1} vs golden {gold_f1}")
        check(counts["flash_attention"] == 6 * len(reqs)
              and sum(counts.values()) == counts["flash_attention"],
              f"raster {name}: launches {counts}")
        res[name] = {"f1": f1, "golden_f1": gold_f1, "identical": sum(same),
                     "agreement": agree, "ms_per_step": ms_step,
                     "steps": steps, "launches": counts}

    # kernel 1 on the encoder's own q/k/v (its first layer, bf16), and at
    # the encoder's shape on random inputs
    seen = []

    def first_call(q, k, v, lengths, **kw):
        if not seen:
            seen.append((q, k, v, lengths, kw))
        return flash(q, k, v, lengths, **kw)

    flash = M.flash_attention
    with _patched(M, flash_attention=first_call):
        V.encode_raster(params, V.batch_images(reqs[0], vit), dims, vit,
                        compute_dtype=torch.bfloat16, flash=True)
    # held element by element (the TRAIN_KERNEL_TOL bf16 bound) to the
    # plain version in f32: the activations' scale is not randn's
    q, k, v, lengths, kw = seen[0]
    got = A.flash_attention(q, k, v, lengths, **kw)
    ref = A.flash_attention_reference(q.float(), k.float(), v.float(),
                                      lengths, **kw)
    err = (got.float() - ref).abs().max().item()
    elem = _train_err(got, ref, torch.bfloat16)
    log(f"raster: flash_attention on the encoder's first-layer q/k/v "
        f"{tuple(q.shape)}, lengths all {int(lengths.min())}, bf16: "
        f"max_abs_err {err:.3e} against its plain version in f32 (outputs "
        f"up to {ref.abs().max().item():.2f}), err over the "
        f"TRAIN_KERNEL_TOL bound {elem:.3f}")
    check(elem <= 1.0, "raster: flash on the encoder's q/k/v disagrees "
          "element by element")
    res["flash_real_err"] = err
    res["flash"] = raster_flash_cases("raster")
    del params
    torch.cuda.empty_cache()

    # the fit: the config as it stands, from init, one step an epoch
    root = os.path.join(tmp, "raster_fit")
    os.makedirs(root)
    splits = {}
    for split, rows in (("train", train_infos[:RASTER_FIT_ROWS]),
                        ("valid", sf_infos)):
        splits[split] = os.path.join(root, f"{split}.txt")
        with open(splits[split], "w") as f:
            f.write("".join(n + "\n" for n in _unpack_infos(rows, root)))
    argv = ["fit", "--config", os.path.join(
        ROOT, "configs", "train_synthetic_raster512.yaml"),
        "--device", DEVICE, "--model.hparams.ROOT", root,
        "--model.hparams.DATASETS_TRAIN", splits["train"],
        "--model.hparams.DATASETS_VALID", splits["valid"],
        "--model.hparams.DATASETS_TEST", splits["valid"],
        "--trainer.max_epochs", str(RASTER_FIT_EPOCHS),
        "--trainer.check_val_every_n_epoch", str(RASTER_FIT_EPOCHS),
        "--trainer.log_every_n_steps", "1",
        "--trainer.default_root_dir", os.path.join(root, "runs")]
    _reset_counts()
    FT.fwd_launches = FT.bwd_launches = 0
    t0 = time.perf_counter()
    trainer, state = cli.main_raster(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = {"fused_attention_train_fwd": FT.fwd_launches,
              "fused_attention_train_bwd": FT.bwd_launches,
              **_launch_counts()}
    fcfg = trainer.cfg
    check((fcfg.BATCH_SIZE, fcfg.MODEL.DROPOUT, fcfg.DATA.AUG_RATIO,
           fcfg.DATA.IMAGE_SIZE, fcfg.DATA.PATCH_SIZE,
           fcfg.trainer.fused_attention) == (32, 0.2, 0.1, 512, 64, True),
          "raster fit: not the config's settings")
    losses, ms_step, val = _fit_ms(trainer.log_dir)
    check(len(losses) == RASTER_FIT_EPOCHS == state.step,
          f"raster fit: {len(losses)} logged steps, state at {state.step}")
    check(all(np.isfinite(losses)), "raster fit: a loss is not finite")
    check(val is not None and 0.0 <= val["val/fmeasure"] <= 1.0,
          "raster fit: validation F1")
    check(counts["fused_attention_train_fwd"] == 18 * RASTER_FIT_EPOCHS
          and counts["fused_attention_train_bwd"] == 18 * RASTER_FIT_EPOCHS
          and counts["flash_attention"] > 0,
          f"raster fit: launches {counts}")
    log(f"raster fit {RASTER_FIT_EPOCHS} steps B={fcfg.BATCH_SIZE} "
        f"(train_synthetic_raster512.yaml, dropout 0.2, AUG_RATIO 0.1, from "
        f"init) on {card_line()}: losses "
        f"{' '.join(f'{x:.4f}' for x in losses)}; {ms_step:.1f} ms per step "
        f"(host clock, steps 6-{RASTER_FIT_EPOCHS}); val on "
        f"{len(sf_infos)} drawings P {val['val/precision']:.4f} R "
        f"{val['val/recall']:.4f} F1 {val['val/fmeasure']:.4f}; wall "
        f"{wall:.1f} s; launches {counts}")
    res["fit"] = {"losses": losses, "ms_per_step": ms_step,
                  "launches": counts}
    note("raster", f"pixels equal {len(packed)}/{len(packed)}; F1 bf16 "
         f"{res['bf16']['f1']:.6f} f32 {res['f32']['f1']:.6f} (golden "
         f"{res['f32']['golden_f1']:.6f}), identical bf16 "
         f"{res['bf16']['identical']} f32 {res['f32']['identical']}, "
         f"{res['bf16']['ms_per_step']:.3f} ms/step bf16; fit "
         f"{losses[0]:.4f} -> {losses[-1]:.4f}, {ms_step:.1f} ms/step")
    return res


# -------------------------------------------------------- phase parallel
# The parallel layer (`parallel/`) on one card. NCCL refuses two ranks on
# one device, so a world of several ranks is a gloo group of processes
# that all hold cuda:0: the tensors stay on the card and gloo stages the
# collectives through the host (its times are no multi-GPU figure). One
# one-rank NCCL world runs the same trainer code.
PARALLEL_WORLD_TIMEOUT = 300    # s: each group's timeout, and a world's wait
SEQ_LEN = 1216                  # the encoder's 1199 tokens padded for 2 ranks
REF_STEPS = 3                   # train_complete.yaml steps of 64 rows
# the overfit drive of the verify recipe (.claude/skills/verify): its tiny
# model with 64-wide heads (the CUDA kernels take Dh = 64 only)
OVERFIT_ROWS, OVERFIT_STEPS, OVERFIT_DROP = 8, 300, 5.0
OVERFIT_MODEL = {"NUM_MODEL": 128, "NUM_HEAD": 2, "NUM_KV_HEAD": 0,
                 "NUM_FEEDFORWARD": 256, "NUM_ENCODER_LAYERS": 1,
                 "NUM_DECODER_LAYERS": 1, "DROPOUT": 0.0}


def _start_world(tag, jobs, tmp, backend="gloo"):
    """Start one worker process per job (`chip_smoke.py --worker`), ranks
    0..n-1 of one process group; returns (tag, [(Popen, log path)])."""
    spec = os.path.join(tmp, f"world_{tag}.json")
    with open(spec, "w") as f:
        json.dump({"init": f"file://{tmp}/rdv_{tag}", "backend": backend,
                   "jobs": jobs}, f)
    procs = []
    for i in range(len(jobs)):
        path = os.path.join(tmp, f"world_{tag}.{i}.log")
        with open(path, "w") as out:
            procs.append((subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), "--worker", spec,
                 str(i)], stdout=out, stderr=subprocess.STDOUT), path))
    return tag, procs


def _wait_world(world):
    """Wait for every rank; when one fails or the world outlasts
    PARALLEL_WORLD_TIMEOUT, stop them all and fail with their last
    lines."""
    tag, procs = world
    deadline = time.monotonic() + PARALLEL_WORLD_TIMEOUT
    failed = False
    for p, _ in procs:
        try:
            failed = p.wait(timeout=max(1.0, deadline - time.monotonic()))
        except subprocess.TimeoutExpired:
            failed = True
        if failed:
            break
    if failed:
        for p, _ in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for i, (p, path) in enumerate(procs):
            with open(path) as f:
                log(f"--- {tag} rank {i} (exit {p.returncode}):\n"
                    + "".join(f.readlines()[-30:]))
        check(False, f"parallel: world {tag} failed")


def _run_world(tag, jobs, tmp, backend="gloo"):
    """Run one world to its end; returns its wall seconds."""
    t0 = time.perf_counter()
    _wait_world(_start_world(tag, jobs, tmp, backend))
    return time.perf_counter() - t0


def _result(job):
    with open(job["out"]) as f:
        return json.load(f)


def worker_main(spec_path, index):
    """One rank of a world that `_start_world` started: join its group on
    cuda:0, run its job, write the job's result."""
    import datetime
    import torch.distributed as dist

    sys.path.insert(0, ROOT)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_num_threads(1)
    with open(spec_path) as f:
        spec = json.load(f)
    torch.cuda.set_device(0)
    dist.init_process_group(
        spec["backend"], init_method=spec["init"],
        world_size=len(spec["jobs"]), rank=index,
        timeout=datetime.timedelta(seconds=PARALLEL_WORLD_TIMEOUT))
    try:
        job = spec["jobs"][index]
        res = globals()[f"job_{job['fn']}"](**job["args"])
        with open(job["out"], "w") as f:
            json.dump(res, f)
    finally:
        dist.destroy_process_group()
    return 0


def _lengths(cfg, root, names):
    from plankassembly_tpu_torch.data.line_data import LineDataset
    ds = LineDataset(root, names, cfg)
    return np.array([int((~ds[i]["input_mask"]).sum())
                     for i in range(len(ds))])


def _golden_batch(cfg, root, names):
    from plankassembly_tpu_torch.data.line_data import LineDataset
    from plankassembly_tpu_torch.data.loader import collate
    ds = LineDataset(root, names, cfg)
    batch = collate([ds[i] for i in range(len(names))])
    return {k: torch.from_numpy(v).to(DEVICE) for k, v in batch.items()
            if isinstance(v, np.ndarray)}


def job_step(root, names, runs, num_data=1, num_model=1):
    """The ep221 step of `phase_train_step` (kernels on) on a (num_data,
    num_model) mesh, or in one process outside a group: for each run
    (tag, dtype, dropout, seed), the global loss and accuracy, the norm
    and probe of each whole leaf's gradient, kernel 3's launches on this
    rank and this rank's `encoder/self_attn/wq` shard shape."""
    import dataclasses
    from plankassembly_tpu_torch.checkpoint import load_checkpoint
    from plankassembly_tpu_torch.config import ModelDims
    from plankassembly_tpu_torch.models.model import train_step_loss
    from plankassembly_tpu_torch.ops import flash_train as FT
    from plankassembly_tpu_torch.parallel.mesh import (
        check_tensor_parallel, gather_leaf, make_mesh, shard_params,
        spec_for_path,
    )
    from plankassembly_tpu_torch.parallel.multihost import owned_row_range
    from plankassembly_tpu_torch.train.state import (
        reduce_gradients, tree_leaves,
    )

    params, cfg = load_checkpoint(CKPT, device=DEVICE)
    check_tensor_parallel(ModelDims.from_config(cfg), num_model)
    mesh = make_mesh(num_data, num_model)
    mesh = mesh if mesh.data_group is not None else None
    lo, hi = owned_row_range(len(names), mesh)
    rows = {k: v[lo:hi] for k, v in _golden_batch(cfg, root, names).items()}
    local = shard_params(params, mesh) if mesh else params
    tp = mesh is not None and mesh.tensor_parallel
    out = {}
    for tag, dtype, dropout, seed in runs:
        dims = dataclasses.replace(ModelDims.from_config(cfg),
                                   dropout=dropout)
        leaves = [("/".join(p), t.detach().clone().requires_grad_())
                  for p, t in tree_leaves(local)]
        tree = {}
        for path, t in leaves:
            node = tree
            for part in path.split("/")[:-1]:
                node = node.setdefault(part, {})
            node[path.split("/")[-1]] = t
        FT.fwd_launches = FT.bwd_launches = 0
        loss, mets = train_step_loss(
            tree, rows, dims, rng=torch.Generator(DEVICE).manual_seed(seed),
            deterministic=False, compute_dtype=getattr(torch, dtype),
            flash=True, mesh=mesh)
        loss.backward()
        reduce_gradients(tree, mesh)
        launches = [FT.fwd_launches, FT.bwd_launches]
        norms, probes = [], []
        for i, (path, t) in enumerate(leaves):
            g = t.grad if mesh is None else gather_leaf(
                t.grad, spec_for_path(path, tp), mesh)
            g = g.double()
            probe = torch.from_numpy(np.random.default_rng(i).standard_normal(
                tuple(g.shape))).to(DEVICE)
            norms.append(g.norm().item())
            probes.append((g * probe).sum().item())
        out[tag] = {"loss": mets["loss"].item(),
                    "accuracy": float(mets["accuracy"]), "norms": norms,
                    "probes": probes, "launches": launches,
                    "names": [p for p, _ in leaves],
                    "wq_local": list(dict(leaves)[
                        "encoder/self_attn/wq"].shape)}
    return out


def _golden_errors(run, golden, tag):
    """(loss rel, accuracy abs, worst norm rel, worst probe err/norm,
    key-bias norm/max) of a `job_step` run against the JAX golden, as
    `phase_train_step` reckons them."""
    g_loss, g_acc = float(golden[f"loss_{tag}"]), float(
        golden[f"accuracy_{tag}"])
    worst_norm = worst_probe = worst_bk = 0.0
    for i, path in enumerate(run["names"]):
        norm = run["norms"][i]
        if path.endswith("/bk"):
            worst_bk = max(worst_bk, norm / float(
                golden[f"grad_norm_{tag}"].max()))
            continue
        ref = float(golden[f"grad_norm_{tag}"][i])
        worst_norm = max(worst_norm, abs(norm - ref) / ref)
        worst_probe = max(worst_probe, abs(
            run["probes"][i] - float(golden[f"grad_probe_{tag}"][i])) / ref)
    return (abs(run["loss"] - g_loss) / g_loss,
            abs(run["accuracy"] - g_acc), worst_norm, worst_probe, worst_bk)


def _check_golden(tag, run, golden):
    for dt in ("f32", "bf16"):
        errs = _golden_errors(run[dt], golden, dt)
        log(f"parallel {tag} {dt} ep221 B={len(golden['names'])} dropout 0 "
            f"vs the JAX golden: loss rel {errs[0]:.2e}, acc {errs[1]:.2e}, "
            f"norm {errs[2]:.2e}, probe {errs[3]:.2e}, bk {errs[4]:.2e}; "
            f"kernel 3 launches fwd/bwd {run[dt]['launches']} a rank")
        for e, key in zip(errs, ("loss", "acc", "norm", "probe", "bk")):
            check(e <= STEP_TOL[dt][key], f"parallel {tag} {dt}: {key} {e}")


def _against(run, ref):
    """(loss rel, worst norm rel, worst probe err/norm) of run vs ref."""
    worst_norm = worst_probe = 0.0
    for i, path in enumerate(ref["names"]):
        r = ref["norms"][i]
        if path.endswith("/bk"):
            continue
        worst_norm = max(worst_norm, abs(run["norms"][i] - r) / r)
        worst_probe = max(worst_probe,
                          abs(run["probes"][i] - ref["probes"][i]) / r)
    return (abs(run["loss"] - ref["loss"]) / ref["loss"], worst_norm,
            worst_probe)


def job_seq_encoder(root, names, out_dir, num_seq=1):
    """ep221's encoder on the golden batch with its length axis split over
    a (1, num_seq) seq mesh (outside a group: the whole stack), f32 and
    bf16; rank 0 saves the memory. Returns flash_attention's launches."""
    import torch.distributed as dist
    from plankassembly_tpu_torch.checkpoint import load_checkpoint
    from plankassembly_tpu_torch.config import ModelDims
    from plankassembly_tpu_torch.models.model import encode
    from plankassembly_tpu_torch.ops import attention as A
    from plankassembly_tpu_torch.parallel.mesh import make_seq_mesh

    params, cfg = load_checkpoint(CKPT, device=DEVICE)
    dims = ModelDims.from_config(cfg)
    mesh = make_seq_mesh(1, num_seq) if dist.is_initialized() else None
    batch = _golden_batch(cfg, root, names)
    inputs = {k: v for k, v in batch.items() if k.startswith("input")}
    out = {}
    for dtype in ("float32", "bfloat16"):
        A.launches = 0
        with torch.no_grad():
            memory = encode(params, inputs, dims,
                            compute_dtype=getattr(torch, dtype), flash=True,
                            seq_mesh=mesh)
        torch.cuda.synchronize()
        out[dtype] = A.launches
        if mesh is None or mesh.seq_rank == 0:
            torch.save(memory.float().cpu(), os.path.join(
                out_dir, f"memory_{dtype}_{num_seq}.pt"))
    return out


def _trainer_run(root, splits, log_root, overrides, reload=None,
                 evaluate=True):
    """configs/train_complete.yaml as published through the port's
    Trainer, its data on the unpacked fixtures and `overrides` on top:
    REF_STEPS steps from init (none with `reload`, a checkpoint to load),
    the data group's all-reduce of one step's gradients timed, then
    validation and test on the serving drawings."""
    from plankassembly_tpu_torch.config import load_config
    from plankassembly_tpu_torch.ops import flash_train as FT
    from plankassembly_tpu_torch.train import loop
    from plankassembly_tpu_torch.train.state import (
        reduce_gradients, tree_leaves,
    )

    over = {"model.hparams.ROOT": root,
            "model.hparams.DATASETS_TRAIN": splits["train"],
            "model.hparams.DATASETS_VALID": splits["serve"],
            "model.hparams.DATASETS_TEST": splits["serve"],
            "trainer.max_epochs": str(REF_STEPS),
            "trainer.check_val_every_n_epoch": "1000",
            "trainer.log_every_n_steps": "1",
            "trainer.default_root_dir": log_root, **overrides}
    cfg = load_config(os.path.join(ROOT, "configs", "train_complete.yaml"),
                      over)
    trainer = loop.Trainer(cfg, device=DEVICE)
    res = {"log_dir": trainer.log_dir, "global_batch": trainer.global_batch,
           "mesh": [trainer.mesh.num_data, trainer.mesh.num_model]}
    written = []
    dump = loop._dump

    def recording_dump(pred_dir, name, payload):
        if pred_dir is not None:
            written.append(name)
        dump(pred_dir, name, payload)

    loop._dump = recording_dump
    try:
        if reload is None:
            FT.fwd_launches = FT.bwd_launches = 0
            state = trainer.fit(trainer.init_state())
            torch.cuda.synchronize()
            res["launches"] = [FT.fwd_launches, FT.bwd_launches]
            res["grad_bytes"] = sum(t.numel() * 4 for _, t in
                                    tree_leaves(state.params))
            mesh = trainer._step_mesh
            res["allreduce_ms"] = host_ms(
                lambda: (reduce_gradients(state.params, mesh),
                         torch.cuda.synchronize()), reps=3)
            res["ckpt"] = os.path.join(trainer.log_dir, "checkpoints",
                                       "last")
        else:
            state = trainer.load_checkpoint(reload)
        if evaluate:
            res["val"] = list(trainer.validate(state))
            res["test"] = list(trainer.test(state))
            res["written"] = written
    finally:
        trainer.close()
        loop._dump = dump
    return res


def job_reference(root, splits, log_root, overrides=None, evaluate=True):
    """train_complete.yaml on this world: as published on 4 ranks (16 rows
    each), with `overrides` (its batch) on fewer."""
    return _trainer_run(root, splits, log_root, overrides or {},
                        evaluate=evaluate)


def job_one_rank(root, splits, log_root, reload, step):
    """The one-rank NCCL world: train_complete.yaml at B=64 from init, the
    4-rank run's checkpoint `reload` validated and tested, and the golden
    step (`job_step` arguments `step`)."""
    b64 = {"model.hparams.BATCH_SIZE": "64"}
    fit = _trainer_run(root, splits, os.path.join(log_root, "fit"), b64,
                       evaluate=False)
    ev = _trainer_run(root, splits, os.path.join(log_root, "reload"), b64,
                      reload=reload)
    return {"fit": fit, "reload": ev, "step": job_step(**step)}


def job_overfit(root, split, log_root):
    """The overfit drive of the verify recipe under dp=2: the tiny model
    (OVERFIT_MODEL) on the 8 shortest training drawings, 4 a rank, LR
    1e-3, OVERFIT_STEPS steps, dropout 0, no augmentation; then the
    validation F1 and each row's greedy program, attach pointers
    included, against its ground truth."""
    import dataclasses
    from plankassembly_tpu_torch.config import Config
    from plankassembly_tpu_torch.parallel import multihost
    from plankassembly_tpu_torch.train import loop

    cfg = Config()
    cfg = dataclasses.replace(
        cfg, ROOT=root, DATASETS_TRAIN=split, DATASETS_VALID=split,
        DATASETS_TEST=split, BATCH_SIZE=OVERFIT_ROWS // 2, LR=1e-3,
        NUM_WORKERS=0,
        DATA=dataclasses.replace(cfg.DATA, AUG_RATIO=0.0),
        MODEL=dataclasses.replace(cfg.MODEL, **OVERFIT_MODEL),
        trainer=dataclasses.replace(
            cfg.trainer, devices=2, max_epochs=OVERFIT_STEPS,
            check_val_every_n_epoch=OVERFIT_STEPS, log_every_n_steps=1,
            default_root_dir=log_root))
    trainer = loop.Trainer(cfg, device=DEVICE)
    try:
        t0 = time.perf_counter()
        state = trainer.fit(trainer.init_state())
        torch.cuda.synchronize()
        fit_s = time.perf_counter() - t0
        f1 = trainer.validate(state)[2]
        same = rows = 0
        loader = trainer.val_dataloader()
        try:
            for batch in loader:
                _, out = trainer._decode_batch(state, batch)
                samples = out["samples"].cpu().numpy()
                attach = out["attach"].cpu().numpy()
                for i in np.flatnonzero(batch["sample_valid"]):
                    value = batch["output_value"][i]
                    label = batch["output_label"][i]
                    n = int(np.flatnonzero(value == cfg.TOKEN.END)[0]) + 1
                    want = np.where(label >= cfg.DATA.VOCAB_SIZE,
                                    label - cfg.DATA.VOCAB_SIZE, -1)
                    same += bool((samples[i, :n] == value[:n]).all()
                                 and (attach[i, :n] == want[:n]).all())
                    rows += 1
        finally:
            loader.close()
        same, rows = multihost.host_allsum([same, rows],
                                           trainer.mesh.host_data_group)
        return {"f1": f1, "identical": int(same), "rows": int(rows),
                "fit_s": fit_s, "log_dir": trainer.log_dir}
    finally:
        trainer.close()


def _seq_kernel(lengths, dtype):
    """flash_attention at the seq-parallel shape (8 heads over 2, Lq =
    SEQ_LEN/2 queries against SEQ_LEN keys, the drawings' lengths) against
    its plain version in f32 element by element, timed, with its bound."""
    from plankassembly_tpu_torch.ops import attention as A
    B, Lq, L = len(lengths), SEQ_LEN // 2, SEQ_LEN
    g = torch.Generator(device=DEVICE).manual_seed(L)
    q = torch.randn((B, 8, Lq, 64), generator=g, device=DEVICE).to(dtype)
    k = torch.randn((B, 2, L, 64), generator=g, device=DEVICE).to(dtype)
    v = torch.randn((B, 2, L, 64), generator=g, device=DEVICE).to(dtype)
    lens = torch.as_tensor(lengths, dtype=torch.int32, device=DEVICE)
    got = A.flash_attention(q, k, v, lens)
    ref = A.flash_attention_reference(q.float(), k.float(), v.float(), lens)
    torch.cuda.synchronize()
    res = {"err": (got.float() - ref).abs().max().item(),
           "elem": _train_err(got, ref, dtype)}
    del ref
    res["ms"] = cuda_ms(lambda: A.flash_attention(q, k, v, lens))
    res["plain_ms"] = cuda_ms(lambda: A.flash_attention_reference(
        q, k, v, lens), reps=3, warmup=1)
    col = torch.arange(L, device=DEVICE)
    mask = (col[None, :] < lens[:, None])[:, None, None, :]
    res["library_ms"] = cuda_ms(_sdpa(q, k, v, mask))
    nbytes = (2 * q.numel() + k.numel() + v.numel()) * q.element_size() \
        + B * 4
    flops = 4.0 * 64 * 8 * Lq * float(np.minimum(lengths, L).sum())
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    res["bound_ms"] = max(t_bytes, t_ops)
    res["bound_by"] = "bytes" if t_bytes >= t_ops else "operations"
    return res


def _steps_ms(log_dir):
    """(losses, host-clock ms per step over steps 2..n) of a short run."""
    with open(os.path.join(log_dir, "metrics.jsonl")) as f:
        recs = [json.loads(line) for line in f]
    steps = [r for r in recs if "train/loss" in r]
    times = [r["time"] for r in steps]
    return ([r["train/loss"] for r in steps],
            (times[-1] - times[0]) / max(1, len(times) - 1) * 1e3)


def _programs(log_dir):
    """{name: [prediction, attach]} of a test run's JSONs."""
    pred_dir = os.path.join(log_dir, "pred_jsons")
    out = {}
    for fn in sorted(os.listdir(pred_dir)):
        with open(os.path.join(pred_dir, fn)) as f:
            d = json.load(f)
        out[fn] = [d["prediction"], d["attach"]]
    return out


def phase_parallel(params, cfg, train_infos, serve_infos, tmp):
    from plankassembly_tpu_torch.export import export_serving

    card = card_line()
    golden = np.load(os.path.join(FIXTURES, "train_step_jax_golden.npz"))
    n = len(golden["names"])
    root = os.path.join(tmp, "parallel_data")
    os.makedirs(root)
    splits = {}
    for split, infos in (("train", train_infos), ("serve", serve_infos),
                         ("overfit", sorted(train_infos, key=lambda i: len(
                             i["lines"]))[:OVERFIT_ROWS])):
        splits[split] = os.path.join(tmp, f"parallel_{split}.txt")
        with open(splits[split], "w") as f:
            f.write("".join(x + "\n" for x in _unpack_infos(infos, root)))
    names = [f"{i['name']}.json" for i in train_infos[:n]]
    check([x[:-5] for x in names] == list(golden["names"]),
          "parallel: not the golden's drawings")
    out_dir = os.path.join(tmp, "parallel_out")
    os.makedirs(out_dir)
    torch.cuda.empty_cache()

    def jobs(fn, count, tag, **args):
        return [{"fn": fn, "args": args,
                 "out": os.path.join(out_dir, f"{tag}.{r}.json")}
                for r in range(count)]

    step = dict(root=root, names=names,
                runs=[("f32", "float32", 0.0, 0), ("bf16", "bfloat16", 0.0, 0),
                      ("d02", "float32", 0.2, TRAIN_SEED)])
    worlds = {"dp2": jobs("step", 2, "dp2", num_data=2, **step),
              "tp2": jobs("step", 2, "tp2", num_model=2, **step),
              "seq2": jobs("seq_encoder", 2, "seq2", root=root, names=names,
                           out_dir=out_dir, num_seq=2),
              "overfit": jobs("overfit", 2, "overfit", root=root,
                              split=splits["overfit"],
                              log_root=os.path.join(tmp, "overfit_runs"))}
    # the worlds that check values run side by side, beside this process's
    # one-process references; the timed worlds run alone
    t0 = time.perf_counter()
    started = [_start_world(tag, js, tmp) for tag, js in worlds.items()]
    one = job_step(**step)
    one_seq = job_seq_encoder(root, names, out_dir)
    for w in started:
        _wait_world(w)
    side_s = time.perf_counter() - t0
    res = {}

    # the step against the JAX golden, and at dropout 0.2 against one
    # process with the same seed
    for tag in ("dp2", "tp2"):
        ranks = [_result(j) for j in worlds[tag]]
        check(all(r["f32"]["loss"] == ranks[0]["f32"]["loss"]
                  for r in ranks), f"parallel {tag}: the ranks' losses")
        run = ranks[0]
        _check_golden(tag, run, golden)
        d = _against(run["d02"], one["d02"])
        log(f"parallel {tag} f32 dropout 0.2 vs one process, seed "
            f"{TRAIN_SEED}: loss rel {d[0]:.2e}, norm {d[1]:.2e}, probe "
            f"{d[2]:.2e} (tol {STEP_TOL['f32']['loss']:g}, "
            f"{STEP_TOL['f32']['norm']:g}, {STEP_TOL['f32']['probe']:g})")
        tol = STEP_TOL["f32"]
        check(d[0] <= tol["loss"] and d[1] <= tol["norm"]
              and d[2] <= tol["probe"],
              f"parallel {tag}: dropout 0.2 differs from one process")
        res[tag] = {"launches": run["bf16"]["launches"],
                    "wq_local": run["f32"]["wq_local"], "d02": d}
    layers = 6 + 2 * 6
    check(res["tp2"]["launches"] == [layers, layers]
          and res["tp2"]["wq_local"] == [6, 512, 256],
          f"parallel tp2: launches and shard {res['tp2']}")

    # the seq-parallel encoder against one process's
    seq = [_result(j) for j in worlds["seq2"]]
    worst = {}
    for dtype in ("float32", "bfloat16"):
        got = torch.load(os.path.join(out_dir, f"memory_{dtype}_2.pt"))
        ref = torch.load(os.path.join(out_dir, f"memory_{dtype}_1.pt"))
        check(got.shape == ref.shape, "parallel seq2: memory shape")
        if dtype == "float32":
            worst[dtype] = (got - ref).abs().max().item()
            ok = worst[dtype] <= FLASH_TOL[torch.float32]
        else:
            worst[dtype] = _train_err(got, ref, torch.bfloat16)
            ok = worst[dtype] <= 1.0
        check(ok, f"parallel seq2 {dtype}: memory differs ({worst[dtype]})")
    seq_launches = seq[0]["bfloat16"]
    check(seq_launches == one_seq["bfloat16"] == 6,
          f"parallel seq2: flash_attention launches {seq_launches}")
    log(f"parallel seq2 ep221 encoder B={n}, {SEQ_LEN // 2} query rows a "
        f"rank against {SEQ_LEN} keys: f32 max abs diff "
        f"{worst['float32']:.2e} (tol {FLASH_TOL[torch.float32]:g}), bf16 "
        f"err over the element bound {worst['bfloat16']:.2e}; "
        f"flash_attention launches {seq_launches} a rank")

    # the overfit drive under dp=2
    ov = _result(worlds["overfit"][0])
    with open(os.path.join(ov["log_dir"], "metrics.jsonl")) as f:
        losses = [r["train/loss"] for r in map(json.loads, f)
                  if "train/loss" in r]
    drop = losses[0] / losses[-1]
    log(f"parallel overfit dp=2 (verify recipe, {OVERFIT_MODEL}, "
        f"{OVERFIT_ROWS} drawings, {len(losses)} steps): loss "
        f"{losses[0]:.4f} -> {losses[-1]:.4f} ({drop:.1f}x), F1 "
        f"{ov['f1']:.4f}, programs with attach identical {ov['identical']}/"
        f"{ov['rows']}; fit {ov['fit_s']:.1f} s beside the other worlds; "
        f"side-by-side worlds {side_s:.1f} s")
    check(drop > OVERFIT_DROP, f"parallel overfit: loss fell {drop:.1f}x")
    check(ov["f1"] == 1.0 and ov["identical"] == ov["rows"] == OVERFIT_ROWS,
          "parallel overfit: the programs are not reproduced")
    res["overfit"] = {"drop": drop, "f1": ov["f1"], "fit_s": ov["fit_s"]}

    # the reference config on 4 gloo ranks, then one NCCL rank
    ref_jobs = jobs("reference", 4, "ref4", root=root, splits=splits,
                    log_root=os.path.join(tmp, "ref4_runs"))
    ref4_s = _run_world("ref4", ref_jobs, tmp)
    ref4 = [_result(j) for j in ref_jobs]
    ref2_jobs = jobs("reference", 2, "ref2", root=root, splits=splits,
                     log_root=os.path.join(tmp, "ref2_runs"),
                     overrides={"model.hparams.BATCH_SIZE": "32"},
                     evaluate=False)
    _run_world("ref2", ref2_jobs, tmp)
    ref2 = _result(ref2_jobs[0])
    r0 = ref4[0]
    check(r0["global_batch"] == 64 and r0["mesh"] == [4, 1],
          f"parallel ref4: global batch {r0['global_batch']}, mesh "
          f"{r0['mesh']}")
    one_jobs = jobs("one_rank", 1, "nccl1", root=root, splits=splits,
                    log_root=os.path.join(tmp, "nccl1_runs"),
                    reload=r0["ckpt"], step=step)
    nccl_s = _run_world("nccl1", one_jobs, tmp, backend="nccl")
    nccl = _result(one_jobs[0])
    _check_golden("nccl1", nccl["step"], golden)
    ref1, reload1 = nccl["fit"], nccl["reload"]
    l4, ms4 = _steps_ms(r0["log_dir"])
    l2, ms2 = _steps_ms(ref2["log_dir"])
    l1, ms1 = _steps_ms(ref1["log_dir"])
    rel = max(abs(a - b) / b for a, b in zip(l4 + l2, l1 + l1))
    log(f"parallel ref4 configs/train_complete.yaml (MHA, devices 4, "
        f"BATCH_SIZE 16, dropout 0.2, AUG_RATIO 0.1) on 4 gloo ranks of one "
        f"card: losses {' '.join(f'{x:.5f}' for x in l4)}; 2 gloo ranks of "
        f"32: {' '.join(f'{x:.5f}' for x in l2)}; one NCCL rank B=64: "
        f"{' '.join(f'{x:.5f}' for x in l1)}; worst rel {rel:.2e} (bf16 tol "
        f"{STEP_TOL['bf16']['loss']:g}); ms a step (steps 2-{REF_STEPS}, "
        f"host clock) 4 ranks {ms4:.1f}, 2 ranks {ms2:.1f}, 1 rank "
        f"{ms1:.1f}; the gradient all-reduce ({r0['grad_bytes'] / 1e6:.1f} "
        f"MB) 4 gloo ranks {r0['allreduce_ms']:.1f} ms, 2 gloo ranks "
        f"{ref2['allreduce_ms']:.1f} ms, 1 NCCL rank "
        f"{ref1['allreduce_ms']:.2f} ms; kernel 3 launches fwd/bwd on rank 0"
        f" {r0['launches']}, one rank {ref1['launches']}; world wall 4 ranks"
        f" {ref4_s:.1f} s, 1 rank {nccl_s:.1f} s; {card}")
    check(len(l4) == len(l2) == len(l1) == REF_STEPS, "parallel ref: steps")
    check(rel <= STEP_TOL["bf16"]["loss"], f"parallel ref: losses {rel}")
    check(min(r0["launches"] + ref1["launches"]) > 0,
          "parallel ref: kernel 3 did not run")
    written = [set(r["written"]) for r in ref4]
    check(sum(len(w) for w in written) == len(set().union(*written))
          == len(serve_infos),
          f"parallel ref4: prediction JSONs {[len(w) for w in written]}")
    p4, p1 = _programs(r0["log_dir"]), _programs(reload1["log_dir"])
    same = sum(p4.get(k) == p for k, p in p1.items())
    log(f"parallel ref4 validation on the {len(serve_infos)} serving "
        f"drawings: P/R/F1 {r0['val']} (4 ranks) vs {reload1['val']} (one "
        f"rank, the same checkpoint); test JSONs a rank "
        f"{[len(w) for w in written]}, programs identical {same}/{len(p1)}")
    check(same == len(p1) == len(serve_infos), "parallel ref4: programs")
    check(abs(r0["val"][2] - reload1["val"][2]) <= 1e-9
          and abs(r0["test"][2] - reload1["test"][2]) <= 1e-9,
          "parallel ref4: F1 differs from one rank's")
    res["ref"] = {"ms4": ms4, "ms2": ms2, "ms1": ms1,
                  "allreduce_ms": r0["allreduce_ms"],
                  "allreduce_ms2": ref2["allreduce_ms"],
                  "allreduce_ms_nccl1": ref1["allreduce_ms"],
                  "loss_rel": rel, "launches4": r0["launches"],
                  "launches1": ref1["launches"]}

    # kernels 3 and 1 at their new shapes, the card to themselves
    lens = _lengths(cfg, root, [f"{i['name']}.json" for i in train_infos])
    tp = train_kernel_case("encoder self tp=2", 4, 1, 1199, 1199, False,
                           lens, torch.bfloat16, 0.2, timing=True)
    check(max(tp["errs"].values()) <= 1.0
          and max(tp["edge_errs"].values()) <= 1.0
          and min(tp["flip_errs"].values()) > 1.0,
          "parallel: kernel 3 at the tp=2 shape")
    log(f"parallel kernel 3 at the tp=2 shape B=64 H=4 Hkv=1 L=1199 bf16 "
        f"rate 0.2: fwd {tp['ms']:.3f} ms (plain {tp['plain_ms']:.3f}, bound "
        f"{tp['bound_ms']:.4f} {tp['bound_by']}), bwd {tp['bwd_ms']:.3f} ms "
        f"(plain {tp['plain_bwd_ms']:.3f}, bound {tp['bwd_bound_ms']:.4f}); "
        f"err over its bound {max(tp['errs'].values()):.2e}, max abs "
        f"{max(tp['abs_errs'].values()):.2e}")
    sk = _seq_kernel(lens[:n], torch.bfloat16)
    check(sk["elem"] <= 1.0, f"parallel: kernel 1 at the seq shape {sk}")
    log(f"parallel kernel 1 at the seq shape B={n} H=8 Hkv=2 Lq="
        f"{SEQ_LEN // 2} Lk={SEQ_LEN} bf16: {sk['ms']:.4f} ms (plain "
        f"{sk['plain_ms']:.3f}, sdpa {sk['library_ms']:.4f}, bound "
        f"{sk['bound_ms']:.4f} {sk['bound_by']}); err over its bound "
        f"{sk['elem']:.2e}, max abs {sk['err']:.2e}")
    res.update(tp_kernel=tp, seq_kernel=sk, seq_launches=seq_launches)

    # the global-shape dropout draws: a dp=4 rank of the reference fit
    # draws 64 rows where its share is 16, at each encoder site (2
    # residuals of width 512 and the FFN hidden of 1024 a layer)
    gen = torch.Generator(DEVICE).manual_seed(0)
    draw = {(rows, width): cuda_ms(lambda: torch.rand(
        (rows, 1199, width), generator=gen, device=DEVICE))
        for rows in (16, 64) for width in (512, 1024)}
    extra = sum(k * (draw[(64, w)] - draw[(16, w)])
                for k, w in ((12, 512), (6, 1024)))
    log("parallel dropout draws, ms (rows, width): " + ", ".join(
        f"{k} {v:.4f}" for k, v in draw.items())
        + f"; a dp=4 rank's extra over its own share {extra:.3f} ms a step "
        f"(the 18 encoder sites)")
    res["dropout_draw"] = {"ms": {f"{r}x{w}": v for (r, w), v in
                                  draw.items()}, "extra_ms": extra}

    # a data-parallel artifact needs its devices
    try:
        export_serving(params, cfg, batch=EXPORT_BATCH, bucket=512,
                       data_parallel=2)
        refused = ""
    except ValueError as e:
        refused = str(e)
    log(f"parallel export_serving(data_parallel=2) on one card: "
        f"{refused!r}")
    check("visible devices" in refused, "parallel: export did not refuse")
    note("parallel", f"dp2/tp2/nccl1 within STEP_TOL of the JAX golden; "
         f"dropout 0.2 loss rel dp2 {res['dp2']['d02'][0]:.1e} tp2 "
         f"{res['tp2']['d02'][0]:.1e}; train_complete 4 ranks vs 1 loss rel "
         f"{rel:.1e}, ms/step 4/2/1 ranks {ms4:.0f}/{ms2:.0f}/{ms1:.0f}, "
         f"all-reduce 4/2 ranks {r0['allreduce_ms']:.0f}/"
         f"{ref2['allreduce_ms']:.0f} ms; draw extra "
         f"{res['dropout_draw']['extra_ms']:.2f} ms; seq2 f32 "
         f"{worst['float32']:.1e}; "
         f"overfit {drop:.0f}x F1 {ov['f1']:.2f}; kernel 3 tp fwd/bwd "
         f"{tp['ms']:.2f}/{tp['bwd_ms']:.2f} ms; kernel 1 seq "
         f"{sk['ms']:.3f} ms")
    return res


# ---------------------------------------------------------------- phase 18
# the offline data factory: the serving fixture's seeds (all in the test
# split, the robustness sweep's) and the training fixture's seeds, the
# process fan-out of the render and prepare tools, the sweep's variants
FACTORY_SERVE_SEED, FACTORY_TRAIN_SEED, FACTORY_COUNT = 900000, 910000, 64
FACTORY_WORKERS = 4
FACTORY_VARIANTS = ("complete", "visible", "noise_05", "noise_10")
SWEEP_VARIANTS = ("complete", "noise_05", "noise_10")
SWEEP_F1_TOL = SERVE_F1_TOL    # the serving bars against the JAX golden
TB_FIT_BATCH = 16              # the short fit whose TensorBoard stream is read


def _tool(name, *args, module="plankassembly_tpu_torch.tools"):
    """`python -m <module>.<name> args` from the checkout, as a user runs
    it; host seconds. A tool that exits non-zero, or a render that reports
    a failed sample, fails the phase."""
    t0 = time.perf_counter()
    out = subprocess.run([sys.executable, "-m", f"{module}.{name}", *args],
                         cwd=ROOT, capture_output=True, text=True,
                         timeout=300)
    check(out.returncode == 0 and "failed, due to" not in out.stdout,
          f"{name} {' '.join(args)}: rc {out.returncode}\n"
          f"{out.stdout[-2000:]}\n{out.stderr[-3000:]}")
    return time.perf_counter() - t0


def _dataset(root, seed, variants, split_flags):
    """The dataset of FACTORY_COUNT seeds from `seed` through the port's
    three tools; {tool: host seconds}."""
    secs = {"generate_models": _tool(
        "generate_models", "--root", root, "--count", str(FACTORY_COUNT),
        "--seed", str(seed), *split_flags)}
    for variant in variants:
        for name, flag in (("render_svgs", "--root"),
                           ("prepare_info", "--data_path")):
            secs[f"{name}:{variant}"] = _tool(
                name, flag, root, "--data_type", variant, "--max_workers",
                str(FACTORY_WORKERS))
    return secs


def _digests(root):
    import hashlib
    out = {}
    for dirpath, _, names in os.walk(root):
        for name in names:
            path = os.path.join(dirpath, name)
            with open(path, "rb") as f:
                out[os.path.relpath(path, root)] = \
                    hashlib.sha256(f.read()).hexdigest()
    return out


def _fixture_rows(root, rows):
    """The rows of a fixture whose info JSON under `root` differs from
    them in any of the fixture's fields."""
    bad = []
    for row in rows:
        with open(os.path.join(root, "data", "complete", "infos",
                               f"{row['name']}.json")) as f:
            info = json.load(f)
        if {k: info.get(k) for k in row} != row:
            bad.append(row["name"])
    return bad


def factory_host_ms(root, scratch):
    """Host ms per drawing of each step of the factory, in this process on
    the serving dataset's drawings, one at a time: generate (the program,
    its check, its JSON), render (the three views of the complete variant)
    with the native library and with the numpy path, prepare (the info
    JSON). The two paths' SVGs must be the same bytes."""
    import argparse
    from plankassembly_tpu_torch.factory import native
    from plankassembly_tpu_torch.factory.synthetic import (
        generate_cabinet, validate_program,
    )
    from plankassembly_tpu_torch.tools import prepare_info, render_svgs

    seeds = range(FACTORY_SERVE_SEED, FACTORY_SERVE_SEED + FACTORY_COUNT)
    t0 = time.perf_counter()
    for seed in seeds:
        planks, attach = generate_cabinet(seed)
        validate_program(planks, attach)
        json.dumps({"planks": planks.tolist(), "attach": attach.tolist()})
    ms = {"generate": (time.perf_counter() - t0) * 1e3 / len(seeds)}
    names = [f"syn{s:06d}" for s in seeds]
    svgs = {}
    for path in (("native", "numpy") if native.available() else ("numpy",)):
        out = os.path.join(scratch, path)
        os.makedirs(os.path.join(out, "data", "complete", "svgs"))
        os.symlink(os.path.join(root, "model"), os.path.join(out, "model"))
        args = argparse.Namespace(root=out, data_type="complete",
                                  noise_ratio=None, noise_length=0.02,
                                  line_width=0.5, decimals=3)
        absent = {"_LIB": None, "_TRIED": True} if path == "numpy" else {}
        with _patched(native, **absent):
            t0 = time.perf_counter()
            for i, name in enumerate(names):
                render_svgs.render_three_views((i, name, args))
            ms[f"render_{path}"] = \
                (time.perf_counter() - t0) * 1e3 / len(names)
        svgs[path] = {k: v for k, v in _digests(out).items()
                      if k.endswith(".svg")}
        check(len(svgs[path]) == 3 * len(names),
              f"factory: the {path} render wrote {len(svgs[path])} SVGs")
    if "native" in svgs:
        check(svgs["native"] == svgs["numpy"],
              "factory: the native library's SVGs differ from the numpy "
              "path's")
    args = argparse.Namespace(data_path=os.path.join(scratch, "numpy"),
                              data_type="complete", scale=1280.0, decimals=3)
    os.makedirs(os.path.join(args.data_path, "data", "complete", "infos"))
    t0 = time.perf_counter()
    for name in names:
        prepare_info.prepare_annotation(name, args)
    ms["prepare"] = (time.perf_counter() - t0) * 1e3 / len(names)
    return ms


def native_against_numpy(root):
    """node_classify and dedupe_covers of the native library against the
    numpy path on the serving dataset's drawings, every view: (views
    compared, views that differ)."""
    from plankassembly_tpu_torch.factory import projection as proj
    from plankassembly_tpu_torch.factory import native

    n = bad = 0
    for name in sorted(os.listdir(os.path.join(root, "model"))):
        with open(os.path.join(root, "model", name)) as f:
            boxes = np.array(json.load(f)["planks"])[1:] / 1280.0
        for view in proj.VIEWS:
            segs, depths, _ = proj.box_view_segments(boxes, view)
            rects, near = proj._silhouettes(boxes, view)
            atomic, hidden = native.node_classify(segs, depths, rects, near)
            lines, types = proj.project_boxes(boxes, view, use_native=False)
            flat = np.stack([np.asarray(l).reshape(4) for l in lines])
            keep = native.dedupe_covers(flat, np.asarray(types))
            kept = proj.remove_overlapping_lines(lines, types,
                                                 use_native=False)
            order = np.lexsort((-np.linalg.norm(flat[:, 2:] - flat[:, :2],
                                                axis=1), np.asarray(types)))
            want = [i for i in order if keep[i]]
            same = (np.array_equal(atomic, flat)
                    and np.array_equal(hidden.astype(int), types)
                    and len(want) == len(kept[0])
                    and all(np.array_equal(flat[i], np.asarray(l).reshape(4))
                            for i, l in zip(want, kept[0])))
            n += 1
            bad += not same
    return n, bad


def phase_factory(serve_infos, train_infos, tmp):
    from plankassembly_tpu_torch import cli
    from plankassembly_tpu_torch.checkpoint import load_checkpoint, tree_map
    from plankassembly_tpu_torch.config import load_config
    from plankassembly_tpu_torch.factory import native
    from plankassembly_tpu_torch.serving import pack_info_dict
    from plankassembly_tpu_torch.tools import (
        convert_reference_checkpoint, robustness_sweep,
    )
    from plankassembly_tpu_torch.train import loop
    from plankassembly_tpu_torch.train.state import tree_leaves
    from plankassembly_tpu_torch.utils.tb_writer import read_tfevents

    with open(os.path.join(FIXTURES, "factory_jax_golden.json")) as f:
        golden = json.load(f)
    base = os.path.join(tmp, "factory")
    serve_root = os.path.join(base, "serve")
    train_root = os.path.join(base, "train")
    res = {"native": native.available()}

    # the datasets through the tools, against the fixtures and the golden
    secs = _dataset(serve_root, FACTORY_SERVE_SEED, FACTORY_VARIANTS,
                    golden["generate_flags"][4:])
    secs.update({f"train {k}": v for k, v in _dataset(
        train_root, FACTORY_TRAIN_SEED, ("complete",), []).items()})
    res["tool_seconds"] = secs
    check(golden["generate_flags"][:4] == [
        "--seed", str(FACTORY_SERVE_SEED), "--count", str(FACTORY_COUNT)],
        "factory: the golden's seeds are not the serving fixture's")
    serve_bad = _fixture_rows(serve_root, serve_infos)
    train_bad = _fixture_rows(train_root, train_infos)
    digests = _digests(serve_root)
    splits = {os.path.basename(k): k for k in digests if k.startswith(
        "splits")}
    split_bad = [name for name, text in golden["splits"].items()
                 if open(os.path.join(serve_root, "splits", name)).read()
                 != text]
    files = {k: v for k, v in digests.items() if not k.startswith("splits")}
    digest_bad = sorted(k for k in set(files) | set(golden["sha256"])
                        if files.get(k) != golden["sha256"].get(k))
    per_variant = {v: sum(k.startswith(f"data/{v}/") for k in digest_bad)
                   for v in FACTORY_VARIANTS}
    log(f"factory datasets: native library "
        f"{'loaded' if res['native'] else 'absent (numpy path)'}; serve64 "
        f"{len(serve_infos) - len(serve_bad)}/{len(serve_infos)} rows equal, "
        f"train64 {len(train_infos) - len(train_bad)}/{len(train_infos)} "
        f"(svgs too); {len(files) - len(digest_bad)}/{len(golden['sha256'])} "
        f"files at the JAX golden's digest (differing by variant "
        f"{per_variant}), splits {sorted(splits)} equal "
        f"{not split_bad}; tool seconds "
        + ", ".join(f"{k} {v:.2f}" for k, v in secs.items()))
    check(not serve_bad, f"factory: serve64 rows differ: {serve_bad[:5]}")
    check(not train_bad, f"factory: train64 rows differ: {train_bad[:5]}")
    check(not split_bad, f"factory: split files differ: {split_bad}")
    check(not digest_bad and len(files) == len(golden["sha256"]),
          f"factory: {len(digest_bad)} files differ from the JAX golden: "
          f"{digest_bad[:5]}")

    # host ms per drawing, and the native library against the numpy path
    ms = res["host_ms"] = factory_host_ms(serve_root,
                                          os.path.join(base, "timing"))
    if res["native"]:
        n, bad = native_against_numpy(serve_root)
        res["native_views"] = n
        check(bad == 0, f"factory: node_classify/dedupe_covers differ from "
              f"the numpy path on {bad}/{n} views")
    log(f"factory host ms per drawing ({card_line()}; one host thread): "
        + ", ".join(f"{k} {v:.3f}" for k, v in ms.items())
        + (f"; node_classify and dedupe_covers equal to the numpy path on "
           f"{res['native_views']} views" if res["native"] else
           "; native library absent, numpy path only"))

    # the robustness sweep of ep221, persistent decode, int8 cross K/V
    steps = []
    real_decode = loop.greedy_decode

    def timed_decode(*a, **k):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = real_decode(*a, **k)
        torch.cuda.synchronize()
        steps.append((int(out["num_steps"]), time.perf_counter() - t0))
        return out

    split = os.path.join(serve_root, "splits", "test.txt")
    sweeps = {}
    for precision, decode_impl, kv_quant in (("bf16", "persistent", "true"),
                                             ("f32", "persistent", "true"),
                                             ("bf16", "auto", "false")):
        tag = f"{precision} {decode_impl}"
        out_dir = os.path.join(base, f"sweep_{precision}_{decode_impl}")
        variants = SWEEP_VARIANTS if decode_impl == "persistent" else \
            ("complete",)
        argv = ["--config", os.path.join(ROOT, "configs",
                                         "train_synthetic_gqa.yaml"),
                "--ckpt_path", CKPT, "--data_root", serve_root,
                "--variants", *variants, "--precision", precision,
                "--device", DEVICE, "--out_dir", out_dir,
                "--model.hparams.DATASETS_TEST", split,
                "--trainer.decode_impl", decode_impl,
                "--trainer.kv_quant", kv_quant]
        steps.clear()
        _reset_counts()
        t0 = time.perf_counter()
        with _patched(loop, greedy_decode=timed_decode):
            scores = robustness_sweep.main(argv)
        wall = time.perf_counter() - t0
        launches = {k: v for k, v in _launch_counts().items() if v}
        n_steps = sum(n for n, _ in steps)
        run = {"scores": scores, "launches": launches, "wall_s": wall,
               "steps": n_steps, "calls": len(steps),
               "ms_per_step": sum(t for _, t in steps) * 1e3 / n_steps}
        sweeps[tag] = run
        for variant in variants:
            pred = os.path.join(out_dir, f"sweep_{variant}", "pred_jsons")
            check(len(os.listdir(pred)) == FACTORY_COUNT,
                  f"factory: sweep {tag} {variant}: "
                  f"{len(os.listdir(pred))} prediction JSONs")
        gold = golden["sweep"]["scores"]
        log(f"factory sweep {tag} (ep221, kv_quant {kv_quant}): "
            + "; ".join(
                f"{v} P {scores[v]['precision']:.6f} R "
                f"{scores[v]['recall']:.6f} F1 {scores[v]['fmeasure']:.6f} "
                f"(JAX golden {gold[v][precision]['fmeasure']:.6f}, dF1 "
                f"{scores[v]['fmeasure'] - gold[v][precision]['fmeasure']:+.6f})"
                for v in variants)
            + f"; {run['calls']} decode calls (ms, steps: "
            + ", ".join(f"{t * 1e3:.1f}/{n}" for n, t in steps)
            + f"), {run['ms_per_step']:.3f} ms a step (a call's wall, the "
            f"encoder included, over its steps); wall {wall:.1f} s; "
            f"launches {launches}")
        check(launches.get("flash_attention", 0) > 0,
              f"factory: sweep {tag} did not launch flash_attention")
        if decode_impl == "persistent":
            check(launches.get("persistent_greedy_decode", 0) > 0,
                  f"factory: sweep {tag} did not launch the persistent "
                  f"decode")
            for v in variants:
                d = abs(scores[v]["fmeasure"] - gold[v][precision]["fmeasure"])
                check(d <= SWEEP_F1_TOL[precision],
                      f"factory: sweep {tag} {v} F1 {scores[v]['fmeasure']} "
                      f"against the JAX golden's "
                      f"{gold[v][precision]['fmeasure']}")
        else:
            check(0.0 < scores["complete"]["fmeasure"] <= 1.0,
                  f"factory: sweep {tag} F1")
    res["sweep"] = sweeps

    # meshes and the gallery of the bf16 sweep's clean test run
    run_dir = os.path.join(base, "sweep_bf16_persistent", "sweep_complete")
    _tool("evaluate", "--data_path", os.path.join(serve_root, "data",
                                                  "complete"),
          "--exp_path", run_dir, module="plankassembly_tpu_torch")
    _tool("build_pred_mesh", "--exp_path", run_dir)
    _tool("build_gt_mesh", "--data_path", serve_root)
    _tool("build_html", "--data_path", serve_root, "--exp_path", run_dir)
    pred_meshes = len([n for n in os.listdir(os.path.join(
        run_dir, "pred_meshes")) if n.endswith(".stl")])
    gt_meshes = len([n for n in os.listdir(os.path.join(serve_root, "mesh"))
                     if n.endswith(".stl")])
    with open(os.path.join(run_dir, "index.html")) as f:
        page = f.read()
    named = sum(f"<td>{r['name']}</td>" in page for r in serve_infos)
    glbs = {d: len(os.listdir(os.path.join(run_dir, d)))
            for d in ("pred_mesh", "gt_mesh")}
    log(f"factory meshes: {pred_meshes} predicted STL, {gt_meshes} "
        f"ground-truth STL, GLB {glbs}; gallery names {named}/"
        f"{len(serve_infos)} drawings")
    check(pred_meshes == gt_meshes == FACTORY_COUNT,
          f"factory: {pred_meshes} / {gt_meshes} meshes")
    check(named == len(serve_infos) and all(
        n == FACTORY_COUNT for n in glbs.values()),
        f"factory: the gallery names {named} drawings, GLB {glbs}")

    # the reference's Lightning layout: ep59 written out and converted back
    mha_params, mha_cfg = load_checkpoint(MHA_CKPT, device="cpu")
    ref_ckpt = os.path.join(base, "reference", "ep59.ckpt")
    os.makedirs(os.path.dirname(ref_ckpt))
    torch.save({"epoch": 59, "state_dict":
                convert_reference_checkpoint.reference_state_dict(
                    mha_params)}, ref_ckpt)
    converted = os.path.join(base, "reference", "run", "checkpoints",
                             "ep59.pt")
    _tool("convert_reference_checkpoint", "--ckpt", ref_ckpt, "--out",
          converted, "--hparams", os.path.splitext(MHA_CKPT)[0]
          + ".hparams.yaml", "--encoder_layers",
          str(mha_cfg.MODEL.NUM_ENCODER_LAYERS), "--decoder_layers",
          str(mha_cfg.MODEL.NUM_DECODER_LAYERS))
    conv_params, conv_cfg = load_checkpoint(converted, device=DEVICE)
    check(conv_cfg == mha_cfg, "factory: the converted config differs")
    exact = all(torch.equal(a.cpu(), b) for (_, a), (_, b) in zip(
        tree_leaves(conv_params), tree_leaves(mha_params)))
    mha_packed = [pack_info_dict(info, mha_cfg) for info in serve_infos]
    mha_bucket = int(np.load(os.path.join(
        FIXTURES, "serve64_mha_jax_golden.npz"))["bucket"])
    _reset_counts()
    got, got_att, _, _ = serve(conv_params, conv_cfg, mha_packed, mha_bucket,
                               torch.bfloat16, cross_impl="kernel")
    conv_launches = {k: v for k, v in _launch_counts().items() if v}
    want, want_att, _, _ = serve(
        tree_map(lambda t: t.to(DEVICE), mha_params), mha_cfg, mha_packed,
        mha_bucket, torch.bfloat16, cross_impl="kernel")
    same = int(sum(np.array_equal(a, b) and np.array_equal(c, d)
                   for a, b, c, d in zip(got, want, got_att, want_att)))
    res["converted"] = {"identical": same, "launches": conv_launches}
    log(f"factory converter: ep59 in the reference's Lightning layout "
        f"({len(convert_reference_checkpoint.reference_state_dict(mha_params))}"
        f" tensors) converted back, parameters bit-equal {exact}; served "
        f"through cross_impl kernel bf16: {same}/{len(got)} programs and "
        f"attach identical to ep59 loaded directly; launches "
        f"{conv_launches}")
    check(exact, "factory: the converted parameters differ from ep59's")
    check(same == len(serve_infos),
          f"factory: {len(serve_infos) - same} converted programs differ")
    check(conv_launches.get("cross_attn_decode", 0) > 0 and
          conv_launches.get("flash_attention", 0) > 0,
          f"factory: the converted checkpoint's serve skipped a kernel: "
          f"{conv_launches}")
    del mha_params, conv_params

    # export_checkpoint: a training checkpoint of ep221 -> npz -> back
    cfg = load_config(os.path.join(ROOT, "configs",
                                   "train_synthetic_gqa.yaml"))
    trainer = loop.Trainer(cfg, log_dir=os.path.join(base, "ckpt_run"),
                           device=DEVICE)
    state = trainer.load_checkpoint(CKPT)
    pt = trainer.save_checkpoint(state, "ep221")
    trainer.close()
    del state
    npz = os.path.join(base, "release", "ep221.npz")
    _tool("export_checkpoint", "export", "--ckpt", pt, "--out", npz)
    back = os.path.join(base, "reimport", "checkpoints", "ep221.pt")
    _tool("export_checkpoint", "import", "--npz", npz, "--out", back)
    with np.load(npz) as a, np.load(CKPT) as b:
        npz_equal = sorted(a.files) == sorted(b.files) and all(
            a[k].tobytes() == b[k].tobytes() and a[k].dtype == b[k].dtype
            for k in b.files if k != "__step__")
    rt_params, rt_cfg = load_checkpoint(back, device=DEVICE)
    params, _ = load_checkpoint(CKPT, device=DEVICE)
    packed = [pack_info_dict(info, rt_cfg) for info in serve_infos]
    bucket = int(np.load(os.path.join(FIXTURES, "serve64_jax_golden.npz"))
                 ["bucket"])
    got, got_att, _, _ = serve(rt_params, rt_cfg, packed, bucket,
                               torch.bfloat16)
    want, want_att, _, _ = serve(params, rt_cfg, packed, bucket,
                                 torch.bfloat16)
    rt_same = int(sum(np.array_equal(a, b) and np.array_equal(c, d)
                      for a, b, c, d in zip(got, want, got_att, want_att)))
    res["round_trip"] = {"npz_equal": npz_equal, "identical": rt_same}
    log(f"factory export_checkpoint: ep221 as a training checkpoint -> npz "
        f"(arrays bit-equal to the release {npz_equal}) -> training "
        f"checkpoint: {rt_same}/{len(got)} programs and attach identical "
        f"(persistent, bf16)")
    check(npz_equal, "factory: the exported npz differs from the release")
    check(rt_same == len(serve_infos),
          f"factory: {len(serve_infos) - rt_same} round-trip programs differ")
    del rt_params, params

    # the TensorBoard stream of a short fit on the regenerated training set
    split_all = os.path.join(base, "train_all.txt")
    with open(split_all, "w") as f:
        f.write("".join(f"{r['name']}.json\n" for r in train_infos))
    trainer, state = cli.main([
        "fit", "--config", os.path.join(ROOT, "configs",
                                        "train_synthetic_gqa.yaml"),
        "--device", DEVICE,
        "--model.hparams.ROOT", os.path.join(train_root, "data", "complete",
                                             "infos"),
        "--model.hparams.DATASETS_TRAIN", split_all,
        "--model.hparams.BATCH_SIZE", str(TB_FIT_BATCH),
        "--trainer.max_epochs", "1", "--trainer.check_val_every_n_epoch",
        "100", "--trainer.log_every_n_steps", "1",
        "--trainer.default_root_dir", os.path.join(base, "runs")])
    trainer.close()
    with open(os.path.join(trainer.log_dir, "metrics.jsonl")) as f:
        recs = [json.loads(line) for line in f]
    jsonl = {(r["step"], k): v for r in recs for k, v in r.items()
             if k not in ("step", "time", "epoch")}
    events = [e for p in sorted(os.listdir(trainer.log_dir))
              if p.startswith("events.out.tfevents.")
              for e in read_tfevents(os.path.join(trainer.log_dir, p))]
    tb = {(e["step"], k): v for e in events
          for k, v in e.get("scalars", {}).items()}
    tb_same = sorted(tb) == sorted(jsonl) and all(
        tb[k] == float(np.float32(v)) for k, v in jsonl.items())
    res["tensorboard"] = {"scalars": len(tb), "equal": tb_same,
                          "steps": state.step}
    log(f"factory TensorBoard: a {state.step}-step fit (B={TB_FIT_BATCH}) on "
        f"the regenerated training set; {len(tb)} tfevents scalars against "
        f"{len(jsonl)} metrics.jsonl values, equal {tb_same}")
    check(state.step == FACTORY_COUNT // TB_FIT_BATCH and len(tb) > 0,
          f"factory: the fit took {state.step} steps, {len(tb)} scalars")
    check(tb_same, "factory: the tfevents scalars differ from metrics.jsonl")

    sw = sweeps["bf16 persistent"]
    res["launches"] = {k: sum(r["launches"].get(k, 0) for r in sweeps.values())
                       for k in ("flash_attention",
                                 "persistent_greedy_decode")}
    res["launches"]["cross_attn_decode"] = conv_launches.get(
        "cross_attn_decode", 0)
    note("factory", f"fixtures regenerated, {len(files)} files at the JAX "
         f"digests; native {res['native']}; host ms/drawing "
         + ", ".join(f"{k} {v:.2f}" for k, v in ms.items())
         + "; sweep bf16 F1 " + " ".join(
             f"{v} {sw['scores'][v]['fmeasure']:.6f}" for v in SWEEP_VARIANTS)
         + f", f32 " + " ".join(
             f"{v} {sweeps['f32 persistent']['scores'][v]['fmeasure']:.6f}"
             for v in SWEEP_VARIANTS)
         + f", {sw['ms_per_step']:.3f} ms/step; converter {same}/64, "
         f"round trip {rt_same}/64, tfevents {tb_same}")
    return res


# ------------------------------------------------------------ phases 19-20
FT_CONFIG = os.path.join(ROOT, "configs", "train_synthetic_gqa.yaml")
VIS_CKPT = os.path.join(ROOT, "checkpoints", "gqa_visible_ep79.npz")
VIS_CONFIG = os.path.join(ROOT, "configs", "train_synthetic_visible_gqa.yaml")
# The fine-tune of ep221 (`tests/make_torch_finetune_golden.py`: B=8,
# dropout 0, LR 1e-4, 3 epochs of the 64 training drawings, AUG_RATIO 0.1,
# validation on the 64 serving drawings after each epoch) against JAX's on
# the CPU. f32: step 1 is the train_step phase's bar (STEP_TOL, another
# order of float32 sums; 1.2e-6 measured). Later steps: Adam turns
# rounding-sized gradient differences into whole steps of the learning
# rate, and this trajectory amplifies them ~1e3-fold by step 24: the port
# started from ep221 with every weight one float32 ulp up departs from
# itself by up to 5.7e-4 and 8.9e-4 relative (step 23), and three runs
# of the port against JAX reached 1.6e-3 to 2.4e-3 there (NVIDIA H100
# 80GB HBM3, 700 W; 1e-7 to 9e-7 at a tiny width,
# `tests/test_torch_finetune.py`), so a bar below ~3e-3 fails on rounding
# alone: 5e-3. The phase measures the one-ulp run every time. F1 at the serving bar, the last
# validation's programs, the final parameters' L2 norms (relative) and
# their dot with a seeded probe (its error over the leaf's norm times the
# probe's norm: the relative weight error along a random direction).
# bf16 against the f32 golden: step 1 at STEP_TOL's bf16 loss bar; later,
# bf16 rounding alone moves this trajectory by far more than 2e-2: JAX's
# own bf16 run of the protocol departs from its f32 golden by 1.6e-3 at
# step 1 and up to 1.95 relative by step 24 (its losses fall to 1e-4),
# so each step is held to twice that departure's running maximum (the
# golden's `loss_bf16`), or 2e-2 where that is larger; every validation
# F1 at the bf16 serving bar.
FT_TOL = {"f32": {"loss_first": 1e-4, "loss": 5e-3, "f1": 0.002,
                  "programs": 0.98, "norm": 1e-3, "probe": 1e-3},
          "bf16": {"loss_first": 2e-2, "loss": 2e-2, "envelope": 2.0,
                   "f1": 0.01}}
FT_RESUME_TOL = 1e-6           # a resumed chunk's first loss, rerun here
LEAK_ITERS = 20                # leak_probe iterations a stage
VIS_AGREEMENT = 0.99
VIS_WIDTH = 560                # the visible model's MAX_INPUT_LENGTH


def _golden_flags(golden, *keys, drop=()):
    """The `--key value` flags of the golden's stored overrides."""
    flags = []
    for key in keys:
        for item in golden[key]:
            k, v = str(item).split("=", 1)
            if k not in drop:
                flags += [f"--{k}", v]
    return flags


def _records(log_dir):
    with open(os.path.join(log_dir, "metrics.jsonl")) as f:
        recs = [json.loads(line) for line in f]
    return ([r for r in recs if "train/loss" in r],
            [r for r in recs if "val/fmeasure" in r])


def _meta(log_dir, tag):
    with open(os.path.join(log_dir, "checkpoints", f"{tag}.meta.json")) as f:
        return json.load(f)


def _epoch_ms(steps):
    """Host ms a step: the gaps between logged steps of one epoch (a log
    reads the loss, which waits for the step), validation left out."""
    gaps = [(b["time"] - a["time"]) * 1e3 for a, b in zip(steps, steps[1:])
            if a["epoch"] == b["epoch"]]
    return float(np.mean(gaps[1:])) if len(gaps) > 1 else float("nan")


def _decoded_programs(trainer, state, loader):
    """{name: samples} of a decode of every batch of `loader`, as the
    trainer's validation decodes them."""
    out = {}
    try:
        for batch in loader:
            _, dec = trainer._decode_batch(state, batch)
            samples = dec["samples"].cpu().numpy()
            for i, name in enumerate(batch["name"]):
                if batch["sample_valid"][i]:
                    out[name] = samples[i]
    finally:
        loader.close()
    return out


def _same_programs(ours, names, gold, end):
    return [np.array_equal(_upto_end(ours[n], end), _upto_end(g, end))
            for n, g in zip(names, gold)]


def _leaf_errors(params, golden):
    """Worst relative L2-norm error and worst probe error of the leaves
    against the golden's (the probes of `tests/make_torch_train_golden.py`)."""
    from plankassembly_tpu_torch.train.state import tree_leaves
    leaves = list(tree_leaves(params))
    check(["/".join(p) for p, _ in leaves] == list(golden["leaf_names"]),
          "finetune: parameter leaves differ from the golden's")
    worst_norm = worst_probe = 0.0
    for i, (_, t) in enumerate(leaves):
        w = t.detach().double().cpu()
        probe = torch.from_numpy(np.random.default_rng(i).standard_normal(
            tuple(w.shape)).astype(np.float32)).double()
        norm, ref = w.norm().item(), float(golden["leaf_norm"][i])
        worst_norm = max(worst_norm, abs(norm - ref) / ref)
        worst_probe = max(worst_probe, abs((w * probe).sum().item() - float(
            golden["leaf_probe"][i])) / (ref * probe.norm().item()))
    return worst_norm, worst_probe


def _state_equal(a, b):
    """Parameters, Adam moments and step of two TrainStates bit for bit."""
    from plankassembly_tpu_torch.train.state import tree_leaves
    pa = [t for _, t in tree_leaves(a.params)]
    pb = [t for _, t in tree_leaves(b.params)]
    oa = a.optimizer.state_dict()["state"]
    ob = b.optimizer.state_dict()["state"]
    same = a.step == b.step and len(pa) == len(pb) == len(oa) == len(ob)
    same = same and all(torch.equal(x.detach(), y.detach())
                        for x, y in zip(pa, pb))
    for i in oa:
        same = same and all(torch.equal(torch.as_tensor(oa[i][k]).cpu(),
                                        torch.as_tensor(ob[i][k]).cpu())
                            for k in ("step", "exp_avg", "exp_avg_sq"))
    return same


def _nudged_checkpoint(tmp):
    """ep221 with every weight moved up by one float32 ulp, at its step:
    the start of the port's own run that shows how far a rounding-sized
    difference carries over the fine-tune."""
    from plankassembly_tpu_torch.checkpoint import load_training_params
    from plankassembly_tpu_torch.train.state import tree_leaves
    params, _, step = load_training_params(CKPT)
    path = os.path.join(tmp, "ep221_plus_one_ulp.npz")
    np.savez(path, __step__=np.asarray(step), **{
        "/".join(p): np.nextafter(t.numpy(), np.float32(np.inf))
        for p, t in tree_leaves(params)})
    return path


def _traced_step(trainer, state, tmp):
    """One fine-tune step under `trace_context`, read back by the port's
    trace reader: (the top kernels under the step's annotation, busy
    share over the union of intervals)."""
    from plankassembly_tpu_torch.tools import trace_summary
    from plankassembly_tpu_torch.train.loop import _to_device
    from plankassembly_tpu_torch.utils.profiling import (
        annotate, trace_context,
    )
    loader = trainer.train_dataloader()
    try:
        batch = _to_device(next(iter(loader)), trainer.device)
    finally:
        loader.close()
    trainer.train_step_fn(state, batch, trainer._rng)   # warm
    torch.cuda.synchronize()
    trace_dir = os.path.join(tmp, "finetune_trace")
    with trace_context(trace_dir):
        with annotate("finetune_step"):
            trainer.train_step_fn(state, batch, trainer._rng)
            torch.cuda.synchronize()
    return trace_summary.main([trace_dir, "--filter", "finetune_step",
                               "--top", "12", "--gaps"])


def phase_finetune(train_infos, serve_infos, tmp):
    from plankassembly_tpu_torch import cli
    from plankassembly_tpu_torch.ops import attention as A
    from plankassembly_tpu_torch.ops import flash_train as FT
    from plankassembly_tpu_torch.ops import persistent_decode as PD

    golden = np.load(os.path.join(FIXTURES, "finetune_jax_golden.npz"))
    root = os.path.join(tmp, "finetune_data")
    os.makedirs(root)
    data = ["--model.hparams.ROOT", root]
    for split, infos in (("TRAIN", train_infos), ("VALID", serve_infos),
                         ("TEST", serve_infos)):
        path = os.path.join(tmp, f"finetune_{split.lower()}.txt")
        with open(path, "w") as f:
            f.write("".join(n + "\n" for n in _unpack_infos(infos, root)))
        data += [f"--model.hparams.DATASETS_{split}", path]
    protocol = _golden_flags(golden, "overrides", "port_decode")
    argv = ["fit", "--config", FT_CONFIG, "--ckpt_path", CKPT, "--device",
            DEVICE] + data + protocol
    log("finetune: python -m plankassembly_tpu_torch.cli fit --config "
        "configs/train_synthetic_gqa.yaml --ckpt_path "
        "checkpoints/gqa_complete_ep221.npz " + " ".join(protocol))
    g_loss, g_f1 = golden["loss"], golden["val_fmeasure"]
    res = {"golden_f1": g_f1.tolist()}
    # the trajectory bars are checked at the phase's end, so that a run
    # past one still reports every other measurement of the phase
    bars = []
    for tag in ("f32", "bf16"):
        A.launches = PD.launches = FT.fwd_launches = FT.bwd_launches = 0
        t0 = time.perf_counter()
        trainer, state = cli.main(argv + [
            "--precision", tag, "--trainer.default_root_dir",
            os.path.join(tmp, f"finetune_{tag}")])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = {"fused_attention_train_fwd": FT.fwd_launches,
                  "fused_attention_train_bwd": FT.bwd_launches,
                  "flash_attention": A.launches,
                  "persistent_greedy_decode": PD.launches}
        steps, vals = _records(trainer.log_dir)
        loss = np.array([r["train/loss"] for r in steps])
        f1 = np.array([r["val/fmeasure"] for r in vals])
        check([r["step"] for r in steps] == golden["step"].tolist()
              and [r["epoch"] for r in steps] == golden["epoch"].tolist(),
              f"finetune {tag}: steps {[r['step'] for r in steps]}")
        check([r["step"] for r in vals] == golden["val_step"].tolist(),
              f"finetune {tag}: validations at {[r['step'] for r in vals]}")
        rel = np.abs(loss - g_loss) / g_loss
        df1 = np.abs(f1 - g_f1)
        meta = {t: _meta(trainer.log_dir, t) for t in ("best", "last")}
        meta_ok = all((meta[t]["epoch"], meta[t]["step"]) == (
            int(golden[f"{t}_epoch"]), int(golden[f"{t}_step"]))
            for t in meta)
        rss = [r["host_rss_mb"] for r in steps]
        L = trainer.dims.num_encoder_layers + \
            2 * trainer.dims.num_decoder_layers
        n_val_batches = -(-len(serve_infos) // trainer.global_batch)
        want = {"fused_attention_train_fwd": L * len(g_loss),
                "fused_attention_train_bwd": L * len(g_loss),
                "flash_attention": trainer.dims.num_encoder_layers
                * n_val_batches * len(g_f1),
                "persistent_greedy_decode": n_val_batches * len(g_f1)}
        ms_step = _epoch_ms(steps)
        log(f"finetune {tag} ({len(g_loss)} steps of B="
            f"{trainer.cfg.BATCH_SIZE} from step {int(golden['import_step'])}"
            f", {len(g_f1)} validations): loss relative to the JAX golden "
            f"by step " + " ".join(f"{x:.1e}" for x in rel)
            + f"; val F1 {' '.join(f'{x:.6f}' for x in f1)} vs JAX "
            f"{' '.join(f'{x:.6f}' for x in g_f1)}; best/last meta "
            f"{[(meta[t]['epoch'], meta[t]['step']) for t in meta]} equal "
            f"{meta_ok}; {ms_step:.1f} ms/step (host clock, within an epoch)"
            f", wall {wall:.1f} s; host_rss_mb {min(rss)}..{max(rss)}; "
            f"launches {counts} (expected {want})")
        tol = FT_TOL[tag]
        out = {"loss_rel": rel.tolist(), "f1": f1.tolist(),
               "ms_per_step": ms_step, "wall_s": wall, "launches": counts,
               "rss_mb": [min(rss), max(rss)]}
        # each step's bar: f32 a constant, bf16 the envelope of JAX's own
        # bf16 departure from its f32 run
        bar = np.full(len(rel), tol["loss"])
        if tag == "bf16":
            own = np.maximum.accumulate(
                np.abs(golden["loss_bf16"] - g_loss) / g_loss)
            bar = np.maximum(bar, tol["envelope"] * own)
        bar[0] = tol["loss_first"]
        if tag == "bf16":
            log("  bf16: JAX's own bf16 run against its f32 golden, loss "
                "relative by step " + " ".join(f"{x:.1e}" for x in np.abs(
                    golden["loss_bf16"] - g_loss) / g_loss)
                + "; JAX's bf16 val F1 " + " ".join(
                    f"{x:.6f}" for x in golden["val_fmeasure_bf16"]))
        over = np.flatnonzero(rel > bar)
        bars.append((not over.size, f"finetune {tag}: loss rel "
                     f"{rel[over].tolist()} at steps {(over + 1).tolist()} "
                     f"over their bars {bar[over].tolist()}"))
        bars.append((df1.max() <= tol["f1"], f"finetune {tag}: val F1 {f1} "
                     f"vs {g_f1}"))
        if tag == "f32":
            names = list(golden["names"])
            progs = _decoded_programs(trainer, state,
                                      trainer.val_dataloader())
            same = _same_programs(progs, names, golden["programs"],
                                  trainer.dims.end)
            worst_norm, worst_probe = _leaf_errors(state.params, golden)
            restored = trainer.load_checkpoint(os.path.join(
                trainer.log_dir, "checkpoints", "last"))
            bitwise = _state_equal(state, restored)
            log(f"  f32 last validation's programs identical to the JAX "
                f"golden's {sum(same)}/{len(same)}; final leaves: worst norm "
                f"rel {worst_norm:.2e} (tol {tol['norm']:g}), worst probe "
                f"err {worst_probe:.2e} (tol {tol['probe']:g}); 'last' "
                f"reloaded bit for bit (parameters, Adam moments, step) "
                f"{bitwise}")
            check(np.mean(same) >= tol["programs"],
                  f"finetune f32: {sum(same)}/{len(same)} programs identical")
            check(worst_norm <= tol["norm"], "finetune f32: leaf norms")
            check(worst_probe <= tol["probe"], "finetune f32: leaf probes")
            check(bitwise, "finetune f32: 'last' does not reload bit for bit")
            out.update(identical=int(sum(same)), norm_rel=worst_norm,
                       probe_err=worst_probe)
            f32_loss = loss
            del restored
            # the port against itself: the same fit from ep221 with every
            # weight one float32 ulp up (no validation, no checkpoint)
            nudged, _ = cli.main(
                [a if a != CKPT else _nudged_checkpoint(tmp) for a in argv]
                + ["--precision", "f32", "--trainer.default_root_dir",
                   os.path.join(tmp, "finetune_nudged"),
                   "--trainer.check_val_every_n_epoch", str(len(g_f1) + 1),
                   "--trainer.save_last", "false"])
            nudged.close()
            n_loss = np.array([r["train/loss"] for r in
                               _records(nudged.log_dir)[0]])
            self_rel = np.abs(n_loss - loss) / loss
            log("  f32 from ep221 with every weight one ulp up, against the "
                "f32 run: loss relative by step "
                + " ".join(f"{x:.1e}" for x in self_rel))
            out["self_rel"] = self_rel.tolist()
            del nudged
        check(meta_ok, f"finetune {tag}: checkpoint meta {meta}")
        check(counts == want, f"finetune {tag}: launches {counts}, "
              f"expected {want}")
        note("finetune", f"{tag} loss rel max {rel.max():.1e} (step 1 "
             f"{rel[0]:.1e}), val F1 {' '.join(f'{x:.6f}' for x in f1)} "
             f"(JAX {' '.join(f'{x:.6f}' for x in g_f1)}), {ms_step:.1f} "
             f"ms/step; launches fwd {counts['fused_attention_train_fwd']} "
             f"bwd {counts['fused_attention_train_bwd']} flash "
             f"{counts['flash_attention']} persistent "
             f"{counts['persistent_greedy_decode']}")
        res[tag] = out
        if tag == "bf16":
            # one step of the bf16 fine-tune traced, read by the port's
            # trace reader (after the counted run)
            tr = _traced_step(trainer, state, tmp)
            top = [(n, c) for n, _, c, _ in tr["top"]]
            log("finetune trace of one bf16 step (trace_summary --filter "
                f"finetune_step --gaps): busy share {tr['busy_share']:.3f} "
                f"(union of intervals), top kernels "
                + "; ".join(f"{n[:48]} x{c} {us / 1e3:.3f} ms {100 * sh:.1f}%"
                            for n, us, c, sh in tr["top"][:8]))
            check(tr["kind"] == "device", "finetune trace: no device event")
            check(any("train_" in n for n, _ in top),
                  f"finetune trace: the training attention is not among "
                  f"the top kernels: {top}")
            res["trace"] = {"busy_share": tr["busy_share"],
                            "top": [(n, us, c) for n, us, c, _ in tr["top"]]}
        trainer.close()
        del trainer, state
        torch.cuda.empty_cache()

    # the same protocol as 3 bounded-lifetime processes of 1 epoch each
    chunk_root = os.path.join(tmp, "finetune_chunked")
    cmd = [sys.executable, "-m", "plankassembly_tpu_torch.tools.fit_chunked",
           "--trainer", "complete", "--config", FT_CONFIG,
           "--total-epochs", str(len(g_f1)), "--epochs-per-chunk", "1",
           "--root-dir", chunk_root, "--ckpt_path", CKPT, "--",
           "--device", DEVICE, "--precision", "f32"] + data + \
        _golden_flags(golden, "overrides", "port_decode",
                      drop=("trainer.max_epochs",))
    t0 = time.perf_counter()
    out = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True,
                         timeout=420)
    chunk_wall = time.perf_counter() - t0
    check(out.returncode == 0, f"fit_chunked: rc {out.returncode}\n"
          f"{out.stdout[-2000:]}\n{out.stderr[-3000:]}")
    done = [line for line in out.stdout.splitlines()
            if line.startswith("[fit_chunked] chunk") and " done " in line]
    runs = sorted(glob.glob(os.path.join(chunk_root, "version_*")))
    check(len(runs) == len(g_f1) == len(done),
          f"fit_chunked: {len(runs)} runs, {len(done)} chunks done")
    per = len(g_loss) // len(g_f1)
    first = int(golden["import_step"])
    chunk_steps, chunk_rss, resumed_rel = [], [], []
    from plankassembly_tpu_torch.config import load_config
    from plankassembly_tpu_torch.train.loop import Trainer, _to_device
    cfg = load_config(FT_CONFIG, dict(zip(
        [a[2:] for a in (data + protocol)[::2]], (data + protocol)[1::2])))
    for k, run in enumerate(runs):
        steps, _ = _records(run)
        chunk_steps.append([r["step"] for r in steps])
        chunk_rss.append(max(r["host_rss_mb"] for r in steps))
        check(chunk_steps[-1] == list(range(first + per * k + 1,
                                            first + per * (k + 1) + 1)),
              f"fit_chunked: chunk {k} steps {chunk_steps[-1]}")
        check(_meta(run, "last")["step"] == first + per * (k + 1),
              f"fit_chunked: chunk {k}'s last meta")
        loss = np.array([r["train/loss"] for r in steps])
        if k == 0:
            chunk0_rel = np.abs(loss - f32_loss[:per]) / f32_loss[:per]
        else:
            # the previous chunk's `last` restored here and one step of the
            # chunk's first batch (the loader seeded anew): its loss is the
            # chunk's first, if the process resumed from the same state
            tr = Trainer(cfg, log_dir=os.path.join(tmp, f"resume{k}"),
                         compute_dtype=torch.float32, device=DEVICE)
            st = tr.load_checkpoint(os.path.join(runs[k - 1], "checkpoints",
                                                 "last"))
            loader = tr.train_dataloader()
            try:
                batch = _to_device(next(iter(loader)), tr.device)
            finally:
                loader.close()
            mets = tr.train_step_fn(st, batch, tr._rng)
            resumed_rel.append(abs(float(mets["loss"]) - loss[0]) / loss[0])
            tr.close()
            del tr, st
    final = Trainer(cfg, log_dir=os.path.join(tmp, "resume_final"),
                    compute_dtype=torch.float32, device=DEVICE)
    final_step = final.load_checkpoint(os.path.join(
        runs[-1], "checkpoints", "last")).step
    final.close()
    log(f"finetune fit_chunked (python -m plankassembly_tpu_torch.tools."
        f"fit_chunked, {len(runs)} processes of 1 epoch, f32): steps "
        + " -> ".join(f"{s[0]}..{s[-1]}" for s in chunk_steps)
        + f"; chunk 0's losses against the monolithic run's first {per}: "
        f"worst rel {chunk0_rel.max():.1e}; each later chunk's first loss "
        f"rerun here from the previous 'last': rel "
        + " ".join(f"{x:.1e}" for x in resumed_rel)
        + f"; final 'last' at step {final_step}; host_rss_mb per chunk "
        f"{chunk_rss}; {chunk_wall:.1f} s")
    for line in done:
        log("  " + line)
    check(chunk0_rel.max() <= FT_TOL["f32"]["loss"],
          f"fit_chunked: chunk 0 against the monolithic run {chunk0_rel}")
    check(max(resumed_rel) <= FT_RESUME_TOL,
          f"fit_chunked: a chunk did not resume its predecessor's state: "
          f"{resumed_rel}")
    check(final_step == first + len(g_loss),
          f"fit_chunked: the final 'last' is at step {final_step}")
    res["chunked"] = {"wall_s": chunk_wall, "rss_mb": chunk_rss,
                      "chunk0_rel": float(chunk0_rel.max()),
                      "resumed_rel": resumed_rel}
    # the raster training path's host memory, stage by stage, through the
    # leak probe as a user runs it (a process of its own, the default
    # model at 256^2 in 32^2 patches, B=16)
    t0 = time.perf_counter()
    out = subprocess.run([sys.executable, "-m",
                          "plankassembly_tpu_torch.tools.leak_probe",
                          "--iters", str(LEAK_ITERS), "--device", DEVICE],
                         cwd=ROOT, capture_output=True, text=True,
                         timeout=300)
    check(out.returncode == 0, f"leak_probe: rc {out.returncode}\n"
          f"{out.stdout[-2000:]}\n{out.stderr[-3000:]}")
    leak = [json.loads(line) for line in out.stdout.splitlines()
            if line.startswith("{")]
    log(f"finetune leak_probe ({LEAK_ITERS} iterations a stage, "
        f"{time.perf_counter() - t0:.1f} s): " + "; ".join(
            f"{r['stage']} {r['kb_per_iter']} KiB/iter, RSS {r['rss_mb']} MB"
            for r in leak))
    check([r["stage"] for r in leak] == ["dataset", "put", "step", "full"]
          and all(r["device"].startswith("cuda") for r in leak),
          f"leak_probe: {leak}")
    res["leak_probe"] = leak
    for ok, what in bars:
        check(ok, what)
    note("finetune", f"fit_chunked steps {first + 1}..{final_step} over "
         f"{len(runs)} processes, chunk 0 rel {chunk0_rel.max():.1e}, "
         f"resumed first-loss rel {max(resumed_rel):.1e}, host_rss_mb "
         f"{chunk_rss}, {chunk_wall:.1f} s; trace busy share "
         f"{res['trace']['busy_share']:.3f}; leak_probe KiB/iter "
         + ", ".join(f"{r['stage']} {r['kb_per_iter']}" for r in leak))
    return res


def visible_kernel_checks(params, dims, batch, bucket):
    """Kernels 1 and 2 against their plain versions at the visible model's
    shape: B=64 at the test batch's kv bucket (`bucket`), the drawings'
    own lengths, with times and bounds."""
    from plankassembly_tpu_torch.decode import _pad_or_crop
    from plankassembly_tpu_torch.models.model import encode
    from plankassembly_tpu_torch.ops import persistent_decode as PD

    inputs = _pad_or_crop(batch, bucket, dims)
    mask = inputs["input_mask"]
    lengths = (~mask).sum(dim=1).cpu().numpy()
    B = mask.shape[0]
    out = {}
    for dtype in (torch.bfloat16, torch.float32):
        r = flash_case(B, dims.num_head, dims.kv_heads, bucket, lengths,
                       False, dtype, seed=13,
                       timing=True if dtype == torch.bfloat16 else "kernel")
        tag = f"visible flash B={B} L={bucket} {str(dtype)[6:]}"
        log(f"{tag}: max_abs_err {r['err']:.3e} (tol {FLASH_TOL[dtype]:g})"
            + (f", err over the TRAIN_KERNEL_TOL bound {r['elem']:.3f}; "
               f"kernel {r['ms']:.4f} ms, plain {r['plain_ms']:.4f}, sdpa "
               f"{r['library_ms']:.4f}, bound {r['bound_ms']:.4f} "
               f"({r['bound_by']})" if "elem" in r
               else f"; kernel {r['ms']:.4f} ms"))
        check(r["err"] <= FLASH_TOL[dtype], f"{tag} disagrees")
        check(r.get("elem", 0.0) <= 1.0, f"{tag} disagrees element by "
              "element")
        out[("flash", str(dtype)[6:])] = r
    cd = torch.bfloat16
    with torch.no_grad():
        memory = encode(params, inputs, dims, compute_dtype=cd, flash=True)

    def kern():
        return PD.persistent_greedy_decode(params, memory, mask, dims,
                                           compute_dtype=cd)

    def plain():
        return PD.greedy_decode_reference(params, memory, mask, dims,
                                          compute_dtype=cd)

    k_out, p_out = kern(), plain()
    torch.cuda.synchronize()
    same = (k_out["samples"] == p_out["samples"]).all(dim=1)
    agree = (k_out["samples"] == p_out["samples"]).float().mean().item()
    steps = min(k_out["num_steps"], p_out["num_steps"])
    sel = same.to(DEVICE)
    err = (k_out["hidden"][sel, :steps] - p_out["hidden"][sel, :steps]) \
        .abs().max().item() if bool(same.any()) else float("nan")
    ms = cuda_ms(kern, reps=3, warmup=1)
    plain_ms = cuda_ms(plain, reps=2, warmup=0)
    bound_ms, bound_by = decode_bound(dims, memory, mask, k_out["num_steps"])
    log(f"visible decode bf16 B={B} Li={bucket}: token agreement with the "
        f"plain version {agree:.4f}, identical rows {same.float().mean():.3f}"
        f", hidden max_abs_err on identical rows {err:.3e}; num_steps kernel "
        f"{k_out['num_steps']} plain {p_out['num_steps']}; kernel {ms:.2f} "
        f"ms ({ms / k_out['num_steps']:.3f} ms/step, the call's encoder "
        f"outside), plain {plain_ms:.2f} ms, bound {bound_ms:.4f} ms "
        f"({bound_by})")
    check(agree >= 0.9, f"visible decode: token agreement {agree}")
    check(k_out["num_steps"] == p_out["num_steps"], "visible decode: steps")
    out["decode"] = {"err": err, "ms": ms, "plain_ms": plain_ms,
                     "bound_ms": bound_ms, "bound_by": bound_by,
                     "steps": int(k_out["num_steps"]), "agreement": agree}
    return out


def phase_visible(tmp):
    import types
    from plankassembly_tpu_torch import cli
    from plankassembly_tpu_torch.checkpoint import load_checkpoint
    from plankassembly_tpu_torch.decode import pick_kv_bucket
    from plankassembly_tpu_torch.ops import persistent_decode as PD
    from plankassembly_tpu_torch.train.loop import VisibleTrainer, _to_device

    golden = np.load(os.path.join(FIXTURES,
                                  "serve64_visible_jax_golden.npz"))
    with open(os.path.join(FIXTURES, "factory_jax_golden.json")) as f:
        factory = json.load(f)
    root = os.path.join(tmp, "visible")
    secs = _dataset(root, FACTORY_SERVE_SEED, ("visible",),
                    factory["generate_flags"][4:])
    files = {k: v for k, v in _digests(root).items()
             if not k.startswith("splits")}
    bad = sorted(k for k, v in files.items()
                 if factory["sha256"].get(k) != v)
    check(not bad, f"visible: {len(bad)} files differ from the JAX "
          f"golden: {bad[:5]}")
    infos = os.path.join(root, "data", "visible", "infos")
    split = os.path.join(root, "splits", "test.txt")
    names = list(golden["names"])
    res = {"tool_seconds": secs}
    # the release's parameters as the trainer's decode takes them
    params, _ = load_checkpoint(VIS_CKPT, device=DEVICE)
    state = types.SimpleNamespace(params=params)
    for tag in ("f32", "bf16"):
        _reset_counts()
        t0 = time.perf_counter()
        trainer, scores = cli.main(
            ["test", "--config", VIS_CONFIG, "--ckpt_path", VIS_CKPT,
             "--device", DEVICE, "--precision", tag,
             "--model.hparams.ROOT", infos,
             "--model.hparams.DATASETS_TEST", split,
             "--trainer.decode_impl", "persistent",
             "--trainer.kv_quant", "true",
             "--trainer.default_root_dir", os.path.join(tmp, "visible_runs")],
            trainer_cls=VisibleTrainer)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = _launch_counts()
        dims = trainer.dims
        end = dims.end
        loader = trainer.test_dataloader()
        batches = list(loader)
        loader.close()
        buckets = [pick_kv_bucket(b["input_mask"],
                                  quantum=trainer.cfg.trainer.kv_quantum)
                   for b in batches]
        progs = _decoded_programs(trainer, state, trainer.test_dataloader())
        gold = golden[f"programs_{tag}"]
        same = _same_programs(progs, names, gold, end)
        agree = _agreement([progs[n] for n in names], gold, end)
        g = [float(golden[f"{k}_{tag}"]) for k in ("precision", "recall",
                                                   "fmeasure")]
        log(f"visible {tag} (python -m plankassembly_tpu_torch."
            f"trainer_visible test, gqa_visible_ep79, MAX_INPUT_LENGTH "
            f"{trainer.cfg.DATA.MAX_INPUT_LENGTH}, persistent + kv_quant): "
            f"P {scores[0]:.6f} R {scores[1]:.6f} F1 {scores[2]:.6f} vs JAX "
            f"{g[0]:.6f} {g[1]:.6f} {g[2]:.6f} (tol {SERVE_F1_TOL[tag]}); "
            f"identical programs {sum(same)}/{len(same)}, token agreement "
            f"{agree:.4f}; buckets {buckets} (golden "
            f"{golden['buckets'].tolist()}), input lengths "
            f"{int(golden['input_lengths'].min())}.."
            f"{int(golden['input_lengths'].max())}; {wall:.1f} s; launches "
            f"{counts}")
        check(buckets == golden["buckets"].tolist(),
              f"visible {tag}: buckets {buckets}")
        check(abs(scores[2] - g[2]) <= SERVE_F1_TOL[tag],
              f"visible {tag}: F1 {scores[2]} vs golden {g[2]}")
        if tag == "f32" and not all(same):
            # a program that differs must do so past a near-tie of the
            # plain decode, which runs JAX's arithmetic
            diff = {i: int(np.flatnonzero(progs[names[i]] != gold[i])[0])
                    for i in np.flatnonzero(~np.array(same))}
            rows = {n: i for i, n in enumerate(batches[0]["name"])}
            arrays = _to_device(batches[0], trainer.device)
            inputs = {k: v for k, v in arrays.items()
                      if k.startswith("input")}
            from plankassembly_tpu_torch.decode import _pad_or_crop
            from plankassembly_tpu_torch.models.model import encode
            inputs = _pad_or_crop(inputs, buckets[0], dims)
            with torch.no_grad():
                memory = encode(state.params, inputs, dims,
                                compute_dtype=torch.float32, flash=True)
            gaps = near_tie_gaps(lambda: PD.greedy_decode_reference(
                state.params, memory, inputs["input_mask"], dims,
                compute_dtype=torch.float32),
                {rows[names[i]]: t for i, t in diff.items()})
            log("  f32 programs that differ from the golden, (first "
                "differing step, relative top-2 gap of the plain decode "
                "there): {" + ", ".join(
                    f"{names[i]}: ({t}, {gaps[rows[names[i]]]:.2e})"
                    for i, t in diff.items()) + "}")
            check(all(gaps[rows[names[i]]] < NEAR_TIE for i in diff),
                  f"visible f32: a program differs from the golden past a "
                  f"near-tie: {gaps}")
        if tag == "bf16":
            check(agree >= VIS_AGREEMENT,
                  f"visible bf16: token agreement {agree}")
        check(counts["flash_attention"] == dims.num_encoder_layers
              * len(batches) and counts["persistent_greedy_decode"]
              == len(batches), f"visible {tag}: launches {counts}")
        res[tag] = {"f1": scores[2], "golden_f1": g[2],
                    "identical": int(sum(same)), "agreement": agree,
                    "launches": counts, "buckets": buckets, "wall_s": wall}
        note("visible", f"{tag} F1 {scores[2]:.6f} (JAX {g[2]:.6f}) "
             f"identical {sum(same)}/{len(same)} agreement {agree:.4f} at "
             f"bucket {buckets}; launches flash {counts['flash_attention']} "
             f"persistent {counts['persistent_greedy_decode']}")
        if tag == "bf16":
            # at the served bucket, and at the model's whole input length
            # (MAX_INPUT_LENGTH 560: the packed width padded to it), the
            # width of a request whose drawing fills it
            batch = {k: v for k, v in _to_device(
                batches[0], trainer.device).items() if k.startswith("input")}
            res["kernels"] = visible_kernel_checks(params, dims, batch,
                                                   buckets[0])
            check(trainer.cfg.DATA.MAX_INPUT_LENGTH == VIS_WIDTH,
                  "visible: not the released model's input length")
            res["kernels_full"] = visible_kernel_checks(params, dims, batch,
                                                        VIS_WIDTH)
        trainer.close()
        del trainer
        torch.cuda.empty_cache()
    for key, width in (("kernels", res["bf16"]["buckets"][0]),
                       ("kernels_full", VIS_WIDTH)):
        k = res[key]
        note("visible", f"L={width}: flash bf16 "
             f"{k[('flash', 'bfloat16')]['ms']:.4f} ms (plain "
             f"{k[('flash', 'bfloat16')]['plain_ms']:.4f}, sdpa "
             f"{k[('flash', 'bfloat16')]['library_ms']:.4f}, bound "
             f"{k[('flash', 'bfloat16')]['bound_ms']:.4f}); persistent "
             f"decode {k['decode']['ms']:.2f} ms for {k['decode']['steps']} "
             f"steps (plain {k['decode']['plain_ms']:.2f}, bound "
             f"{k['decode']['bound_ms']:.4f})")
    return res


def summarize(res):
    """One line per phase that ran with its headline numbers, kept short:
    they stand in the last lines of the output."""
    if "flash" in res:
        r = res["flash"]
        note("flash", f"main shape err {r['err']:.2e}, kernel {r['ms']:.3f} "
             f"ms, plain {r['plain_ms']:.3f}, sdpa {r['library_ms']:.3f}, "
             f"bound {r['bound_ms']:.4f}, f32 kernel {r['ms_f32']:.3f} ms")
    if "decode" in res:
        d = res["decode"]
        note("decode", f"agreement {d['token_agreement']:.4f}, {d['ms']:.2f} "
             f"ms for {d['steps']} steps ({d['ms_per_step']:.3f} ms/step), "
             f"idle share {d['idle_share']:.3f}; " + ", ".join(
                 f"B={r['B']} {r['route']} {r['nodes_per_step']:g} nodes "
                 f"{min(r['replay_ms_per_step']):.4f} ms/step (replays)"
                 for r in d["routes"]))
    if "decode_options" in res:
        d = res["decode_options"]
        note("decode_options", "ms/step persistent/mxu " + ", ".join(
            f"B={r['B']} {r['persistent_ms_per_step']:.3f}/"
            f"{r['mxu_ms_per_step']:.3f}" for r in d["band"]))
        note("decode_options", "ms/step step/chain (replays) " + ", ".join(
            f"{r['bucket']}xB={r['B']} "
            f"{r['replay_ms_per_step']['step']:.3f}/"
            f"{r['replay_ms_per_step']['chain']:.3f} {r['pick']}"
            for r in d["step_band"]))
        note("decode_options", "weight_quant " + ", ".join(
            f"{n} F1 {d['wq_' + n]['f1']:.6f} (golden "
            f"{d['wq_' + n]['golden_f1']:.6f}) identical "
            f"{d['wq_' + n]['identical']:.4f}" for n in ("bf16", "f32")))
    if "beam" in res:
        note("beam", ", ".join(
            f"{n} F1 {b['f1']:.6f} (golden {b['golden_f1']:.6f}) identical "
            f"{b['identical']:.4f} {b['ms'] / b['steps']:.3f} ms/step"
            for n, b in res["beam"].items()))
    if "http" in res:
        note("http", f"{res['http']['programs_per_s']:.2f} programs/s, F1 "
             f"{res['http']['f1']:.6f}")
    if "train_kernel" in res:
        kres, worst = res["train_kernel"]
        enc = kres[("encoder self", 0.2)]
        note("train_kernel", f"worst err fwd {worst['fwd']:.2e} bwd "
             f"{worst['bwd']:.2e}; encoder self rate 0.2 fwd {enc['ms']:.3f} "
             f"ms, bwd {enc['bwd_ms']:.3f} ms")
    if "flash" in res:
        r = res["flash"]["raster"]["bfloat16"]
        note("flash", f"raster shape err {r['err']:.2e}, kernel "
             f"{r['ms']:.4f} ms, plain {r['plain_ms']:.4f}, sdpa "
             f"{r['library_ms']:.4f}, bound {r['bound_ms']:.4f}")
    if "train_kernel" in res:
        kres, _ = res["train_kernel"]
        note("train_kernel", "raster rate 0.2 fwd/bwd ms " + ", ".join(
            f"{n[7:]} {kres[(n, 0.2)]['ms']:.3f}/"
            f"{kres[(n, 0.2)]['bwd_ms']:.3f}" for n in (
                "raster encoder self", "raster decoder self",
                "raster cross")))
    if "mha_kernels" in res:
        mk = res["mha_kernels"]
        c, f = mk[("cross", "bf16", "int8")], mk[("fused", "bf16")]
        note("mha_kernels", f"cross_attn_decode int8 {c['ms']:.4f} ms (err "
             f"{c['err']:.2e}), fused layer {f['ms']:.4f} ms (err "
             f"{f['err']:.2e})")
    for phase in PHASES:
        if phase in SUMMARY:
            log(f"summary {phase}: " + "; ".join(SUMMARY[phase]))


def _entry(name, source, replaces, launches, err, r, prefix="",
           library_key=None):
    return {"name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches, "max_abs_err": err,
            "ms": r[f"{prefix}ms"], "plain_ms": r[f"plain_{prefix}ms"],
            "bound_ms": r[f"{prefix}bound_ms"],
            "bound_by": r[f"{prefix}bound_by"],
            "library_ms": r.get(library_key) if library_key else None}


def main() -> int:
    import argparse
    import tempfile

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--phases", default=",".join(PHASES),
                    help="comma-separated subset of " + ",".join(PHASES))
    if sys.argv[1:2] == ["--worker"]:     # a rank of the parallel phase
        return worker_main(sys.argv[2], int(sys.argv[3]))
    args = ap.parse_args()
    phases = args.phases.split(",")
    unknown = sorted(set(phases) - set(PHASES))
    if unknown:
        ap.error(f"unknown phases {unknown}")
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; nothing was run",
              file=sys.stderr)
        return 2
    t_start = time.perf_counter()
    sys.path.insert(0, ROOT)
    from plankassembly_tpu_torch.checkpoint import load_checkpoint
    from plankassembly_tpu_torch.config import ModelDims
    from plankassembly_tpu_torch.data.line_data import LineDataset
    from plankassembly_tpu_torch.ops import _build
    from plankassembly_tpu_torch.serving import pack_info_dict

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    res = {}
    with Phase("device"):
        card = card_line()
        log(f"card: {card}; torch {torch.__version__} cuda "
            f"{torch.version.cuda}; device {torch.cuda.get_device_name(0)} "
            f"x{torch.cuda.device_count()}")
        _build.library()
        built = ("found already built" if _build.build_seconds is None
                 else f"built in {_build.build_seconds:.1f} s")
        log(f"kernels {built} (nvcc {' '.join(_build.NVCC_FLAGS)}, one "
            f"process per source)")
        for fn, regs, st, ld in ptxas_summary(_build.build_log):
            log(f"  ptxas: {fn}: {regs} registers, spill stores {st} B, "
                f"spill loads {ld} B")
        per_fn = sass_counts(_build.build())
        hmma = res["hmma"] = hmma_counts(per_fn)
        log("tensor-core sentinel, HMMA instructions in the SASS of each "
            "bf16 kernel: " + ", ".join(f"{k} {n}" for k, n in hmma.items()))
        check(all(n > 0 for n in hmma.values()),
              f"a bf16 attention kernel runs no tensor-core instruction: "
              f"{hmma}")
        dmma = res["decode_hmma"] = least_counts(per_fn, DECODE_MMA_KERNELS,
                                                 0)
        acp = res["async_copies"] = least_counts(per_fn, ASYNC_KERNELS, 1)
        log("decode kernels' sentinel, fewest over each kernel's template "
            "instances: HMMA " + ", ".join(f"{k} {n}" for k, n in
                                           dmma.items())
            + "; asynchronous copies (LDGSTS/UBLKCP/UTMALDG) "
            + ", ".join(f"{k} {n}" for k, n in acp.items()))
        check(all(n > 0 for n in dmma.values()),
              f"the bf16 decode GEMM runs no tensor-core instruction: {dmma}")
        check(all(n > 0 for n in acp.values()),
              f"a redesigned decode kernel has no asynchronous copy: {acp}")
        note("device", f"{card}; kernels {built}; fewest HMMA "
             f"{min(hmma.values())}, async copies {min(acp.values())}")

    params, cfg = load_checkpoint(CKPT, device=DEVICE)
    dims = ModelDims.from_config(cfg)
    with gzip.open(os.path.join(FIXTURES, "serve64.json.gz"), "rt") as f:
        infos = json.load(f)
    with gzip.open(os.path.join(FIXTURES, "train64.json.gz"), "rt") as f:
        train_infos = json.load(f)
    golden = np.load(os.path.join(FIXTURES, "serve64_jax_golden.npz"))
    bucket = int(golden["bucket"])
    gt = torch.from_numpy(golden["gt_samples"])
    packed = [{k: v for k, v in pack_info_dict(info, cfg).items()}
              for info in infos]
    # the main path's largest request: the last 32 programs
    last = slice(len(packed) - max(REQUESTS), len(packed))
    req = {k: torch.from_numpy(np.stack([p[k] for p in packed[last]]))
           .to(DEVICE) for k in packed[0]}
    main_lengths = (~req["input_mask"]).sum(dim=1).cpu().numpy()

    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        if "flash" in phases:
            with Phase("flash"):
                res["flash"] = phase_flash(main_lengths, bucket)
        if "decode" in phases:
            with Phase("decode"):
                full = {k: torch.from_numpy(np.stack([p[k] for p in packed]))
                        .to(DEVICE) for k in packed[0]}
                res["decode"] = phase_decode(params, dims, req, gt[last],
                                             bucket, full=full)
        if "serve" in phases:
            with Phase("serve"):
                res["serve"] = phase_serve(params, cfg, dims, packed, gt,
                                           golden, bucket)
        if "decode_options" in phases:
            with Phase("decode_options"):
                res["decode_options"] = phase_decode_options(
                    params, dims, packed, gt, bucket)
        if "beam" in phases:
            with Phase("beam"):
                res["beam"] = phase_beam(params, dims, packed, gt, bucket)
        if "http" in phases:
            with Phase("http"):
                res["http"] = phase_http(params, cfg, dims, infos, packed, gt)
        if "train_kernel" in phases:
            with Phase("train_kernel"):
                train_root = os.path.join(tmp, "train_kernel")
                os.makedirs(train_root)
                names = _unpack_infos(train_infos, train_root)
                ds = LineDataset(train_root, names, cfg)
                res["train_kernel"] = phase_train_kernel(
                    [ds[i] for i in range(len(names))])
        if "train_step" in phases:
            with Phase("train_step"):
                res["train_step"] = phase_train_step(params, cfg,
                                                     train_infos, tmp)
        if "fit" in phases:
            with Phase("fit"):
                res["fit"] = phase_fit(train_infos, infos, tmp)
        if {"mha_kernels", "mha_serve"} & set(phases):
            mha_params, mha_cfg = load_checkpoint(MHA_CKPT, device=DEVICE)
            mha_dims = ModelDims.from_config(mha_cfg)
            mha_golden = np.load(os.path.join(FIXTURES,
                                              "serve64_mha_jax_golden.npz"))
            mha_bucket = int(mha_golden["bucket"])
            mha_packed = [pack_info_dict(info, mha_cfg) for info in infos]
            mha_req = {k: torch.from_numpy(np.stack(
                [p[k] for p in mha_packed[last]])).to(DEVICE)
                for k in mha_packed[0]}
        if "mha_kernels" in phases:
            with Phase("mha_kernels"):
                res["mha_kernels"] = phase_mha_kernels(mha_params, mha_dims,
                                                       mha_req, mha_bucket)
        if "mha_serve" in phases:
            with Phase("mha_serve"):
                res["mha_serve"] = phase_mha_serve(
                    mha_params, mha_cfg, mha_dims, mha_packed, mha_golden,
                    mha_bucket, mha_req)
        if {"mha_kernels", "mha_serve"} & set(phases):
            del mha_params, mha_req
            torch.cuda.empty_cache()
        sf_infos = sideface_requests(infos)
        if "sideface_serve" in phases:
            with Phase("sideface_serve"):
                sf_params, sf_cfg = load_checkpoint(SF_CKPT, device=DEVICE)
                res["sideface_serve"] = phase_sideface_serve(
                    sf_params, sf_cfg, ModelDims.from_config(sf_cfg),
                    sf_infos, np.load(os.path.join(
                        FIXTURES, "serve64_sideface_jax_golden.npz")))
                del sf_params
                torch.cuda.empty_cache()
        if "data_fit" in phases:
            with Phase("data_fit"):
                res["data_fit"] = phase_data_fit(train_infos, sf_infos, tmp)
        if "export" in phases:
            with Phase("export"):
                res["export"] = phase_export(params, cfg, dims, infos,
                                             packed, gt, tmp)
        if "raster" in phases:
            with Phase("raster"):
                res["raster"] = phase_raster(sf_infos, train_infos, tmp)
        if "parallel" in phases:
            with Phase("parallel"):
                res["parallel"] = phase_parallel(params, cfg, train_infos,
                                                 infos, tmp)
        if "factory" in phases:
            with Phase("factory"):
                res["factory"] = phase_factory(infos, train_infos, tmp)
        if "visible" in phases:
            with Phase("visible"):
                res["visible"] = phase_visible(tmp)
        if "finetune" in phases:
            with Phase("finetune"):
                res["finetune"] = phase_finetune(train_infos, infos, tmp)
    log(f"total {time.perf_counter() - t_start:.1f} s")
    summarize(res)
    if set(phases) != set(PHASES):
        log(f"ran phases {phases} only; no result line")
        return 0

    flash, decode, serve = res["flash"], res["decode"], res["serve"]
    (kres, worst), fit = res["train_kernel"], res["fit"]
    enc = kres[("encoder self", 0.2)]
    enc0 = kres[("encoder self", 0.0)]
    src = "plankassembly_tpu_torch/csrc/flash_train.cu"
    fwd = _entry("fused_attention_train_fwd", src,
                 "plankassembly_tpu/ops/flash_train.py:198",
                 fit["launches"]["fused_attention_train_fwd"], worst["fwd"],
                 enc)
    bwd = _entry("fused_attention_train_bwd", src,
                 "plankassembly_tpu/ops/flash_train.py:230",
                 fit["launches"]["fused_attention_train_bwd"], worst["bwd"],
                 enc, prefix="bwd_")
    # numbers at the encoder self-attention shape, rate 0.2 (the training
    # path's); no library call computes that dropout, so library_ms is
    # null there and SDPA's rate-0 time sits beside the kernel's own
    # the f32 (SIMT) route's own times at the same shape and rate
    enc32 = kres[("encoder self", 0.2, "f32")]
    fwd.update(shape="encoder self B=64 H=8 Hkv=2 L=1199 bf16", rate=0.2,
               ms_rate0=enc0["ms"], library_ms_rate0=enc0["library_ms"],
               ms_f32=enc32["ms"])
    bwd.update(shape=fwd["shape"], rate=0.2, ms_rate0=enc0["bwd_ms"],
               library_ms_rate0=enc0["library_bwd_ms"],
               ms_f32=enc32["bwd_ms"])
    flash_entry = {
        "name": "flash_attention", "route": "cuda",
        "source": "plankassembly_tpu_torch/csrc/attention.cu",
        "replaces": "plankassembly_tpu/ops/attention.py:95",
        "launches": serve["bf16"]["flash_attention"],
        "max_abs_err": flash["err"], "ms": flash["ms"],
        "plain_ms": flash["plain_ms"], "bound_ms": flash["bound_ms"],
        "bound_by": flash["bound_by"], "library_ms": flash["library_ms"],
        "ms_f32": flash["ms_f32"]}
    # the redesigned kernels: route by dtype (`ms` is the bf16 route's),
    # and the sentinel's HMMA count of each bf16 kernel
    for entry in (flash_entry, fwd, bwd):
        entry["routes"] = dict(ROUTES)
        entry["hmma"] = {k: res["hmma"][k] for k in MMA_KERNELS[entry["name"]]}
    decode_entry = {
        "name": "persistent_greedy_decode", "route": "cuda",
        "source": "plankassembly_tpu_torch/csrc/decode.cu, decode_step.cu",
        "replaces": "plankassembly_tpu/ops/persistent_decode.py:632",
        "launches": serve["bf16"]["persistent_greedy_decode"],
        "max_abs_err": decode["err"], "ms": decode["ms"],
        "plain_ms": decode["plain_ms"], "bound_ms": decode["bound_ms"],
        "bound_by": decode["bound_by"], "library_ms": None}
    # the graph loop: steps, ms a step, the cross K/V preparation apart,
    # kernels (graph nodes) a step, capture and instantiate ms, idle share,
    # one step's kernels, the agreements
    decode_entry.update({k: v for k, v in decode.items() if k not in (
        "err", "ms", "plain_ms", "bound_ms", "bound_by")})
    decode_entry["shape"] = "B=32 Li=1152 bf16, ep221"
    decode_entry["routes"] = {"bf16": "cuda-mma", "f32": "cuda-simt-order"}
    decode_entry["async_copies"] = {
        k: res["async_copies"][k]
        for k in ASYNC_KERNELS["persistent_greedy_decode"]}
    # launches on the sideface paths: serving (bf16) and the device-data fit
    sf = res["sideface_serve"]["bf16"]["launches"]
    flash_entry["launches_sideface_serve"] = sf["flash_attention"]
    decode_entry["launches_sideface_serve"] = sf["persistent_greedy_decode"]
    df = res["data_fit"]["sideface"]["launches"]
    fwd["launches_data_fit"] = df["fused_attention_train_fwd"]
    bwd["launches_data_fit"] = df["fused_attention_train_bwd"]
    # launches on the artifact's serving path (bucket 1152, bf16) and the
    # raster paths (serving bf16, the fit); the kernels at the raster shapes
    ex, ra = res["export"], res["raster"]
    flash_entry["launches_export"] = \
        ex[f"k{HTTP_BUCKETS[-1]}"]["launches"]["flash_attention"]
    flash_entry["launches_raster_serve"] = \
        ra["bf16"]["launches"]["flash_attention"]
    fl = flash["raster"]["bfloat16"]
    flash_entry["raster_shape"] = {
        "shape": f"B=32 H=8 Hkv=8 L={RASTER_TOKENS} bf16",
        **{k: fl[k] for k in ("err", "ms", "plain_ms", "library_ms",
                              "bound_ms", "bound_by")},
        "ms_f32": flash["raster"]["float32"]["ms"]}
    fwd["launches_raster_fit"] = \
        ra["fit"]["launches"]["fused_attention_train_fwd"]
    bwd["launches_raster_fit"] = \
        ra["fit"]["launches"]["fused_attention_train_bwd"]
    renc = kres[("raster encoder self", 0.2)]
    for entry, prefix in ((fwd, ""), (bwd, "bwd_")):
        entry["raster_shape"] = {
            "shape": f"raster encoder self B={RASTER_FIT_ROWS} H=8 Hkv=8 "
                     f"L={RASTER_TOKENS} bf16 rate 0.2",
            "ms": renc[f"{prefix}ms"], "plain_ms": renc[f"plain_{prefix}ms"],
            "bound_ms": renc[f"{prefix}bound_ms"],
            "bound_by": renc[f"{prefix}bound_by"]}
    # the parallel phase: kernel 3 at the tp=2 head shape (its launches a
    # rank in the tp=2 step, and rank 0's in the 4-rank reference fit),
    # kernel 1 at the seq-parallel shape (its launches a rank)
    par = res["parallel"]
    for i, (entry, prefix) in enumerate(((fwd, ""), (bwd, "bwd_"))):
        tk = par["tp_kernel"]
        entry["launches_parallel_tp2"] = par["tp2"]["launches"][i]
        entry["launches_parallel_reference"] = par["ref"]["launches4"][i]
        entry["tp_shape"] = {
            "shape": "encoder self tp=2 B=64 H=4 Hkv=1 L=1199 bf16 rate 0.2",
            "ms": tk[f"{prefix}ms"], "plain_ms": tk[f"plain_{prefix}ms"],
            "bound_ms": tk[f"{prefix}bound_ms"],
            "bound_by": tk[f"{prefix}bound_by"], "library_ms": None}
    sk = par["seq_kernel"]
    flash_entry["launches_parallel_seq2"] = par["seq_launches"]
    flash_entry["seq_shape"] = {
        "shape": f"seq-parallel B=8 H=8 Hkv=2 Lq={SEQ_LEN // 2} "
                 f"Lk={SEQ_LEN} bf16",
        **{k: sk[k] for k in ("err", "ms", "plain_ms", "library_ms",
                              "bound_ms", "bound_by")}}
    # launches on the factory phase's paths: kernels 1 and 2 in its three
    # robustness sweeps, kernel 4 in the converted reference checkpoint's
    # serve
    fa = res["factory"]["launches"]
    flash_entry["launches_factory"] = fa["flash_attention"]
    decode_entry["launches_factory"] = fa["persistent_greedy_decode"]
    # the fine-tune of ep221 (each precision's fit: kernel 3 in every step,
    # kernels 1 and 2 in every validation) and the visible model's test,
    # with kernels 1 and 2 at its shape (560 tokens)
    ft = res["finetune"]["f32"]["launches"]
    fwd["launches_finetune"] = ft["fused_attention_train_fwd"]
    bwd["launches_finetune"] = ft["fused_attention_train_bwd"]
    flash_entry["launches_finetune"] = ft["flash_attention"]
    decode_entry["launches_finetune"] = ft["persistent_greedy_decode"]
    vis = res["visible"]
    flash_entry["launches_visible"] = vis["bf16"]["launches"][
        "flash_attention"]
    decode_entry["launches_visible"] = vis["bf16"]["launches"][
        "persistent_greedy_decode"]
    vb, vk = vis["bf16"]["buckets"][0], vis["kernels"]
    fl = vk[("flash", "bfloat16")]
    flash_entry["visible_shape"] = {
        "shape": f"B=64 H=8 Hkv=2 L={vb} bf16, gqa_visible_ep79",
        **{k: fl[k] for k in ("err", "ms", "plain_ms", "library_ms",
                              "bound_ms", "bound_by")},
        "ms_f32": vk[("flash", "float32")]["ms"]}
    decode_entry["visible_shape"] = {
        "shape": f"B=64 Li={vb} bf16, gqa_visible_ep79",
        **{k: vk["decode"][k] for k in ("err", "ms", "plain_ms", "bound_ms",
                                        "bound_by", "steps", "agreement")},
        "library_ms": None}
    vf = vis["kernels_full"]
    fl = vf[("flash", "bfloat16")]
    flash_entry["visible_full_shape"] = {
        "shape": f"B=64 H=8 Hkv=2 L={VIS_WIDTH} bf16, gqa_visible_ep79",
        **{k: fl[k] for k in ("err", "ms", "plain_ms", "library_ms",
                              "bound_ms", "bound_by")},
        "ms_f32": vf[("flash", "float32")]["ms"]}
    decode_entry["visible_full_shape"] = {
        "shape": f"B=64 Li={VIS_WIDTH} bf16, gqa_visible_ep79",
        **{k: vf["decode"][k] for k in ("err", "ms", "plain_ms", "bound_ms",
                                        "bound_by", "steps", "agreement")},
        "library_ms": None}
    kernels = [
        flash_entry,
        decode_entry,
        fwd, bwd,
    ]
    mk, ms = res["mha_kernels"], res["mha_serve"]
    cross, cross_lib = mk[("cross", "bf16", "int8")], \
        mk[("cross", "bf16", "bf16")]
    fused = mk[("fused", "bf16")]
    entry = _entry("cross_attn_decode",
                   "plankassembly_tpu_torch/csrc/cross_decode.cu",
                   "plankassembly_tpu/ops/cross_decode.py:76",
                   ms[("kernel", "bf16")]["cross_attn_decode"], cross["err"],
                   cross)
    # the main path's form (int8 K/V, bf16 q); the same kernel on bf16 K/V,
    # where scaled_dot_product_attention computes the same function. `ms`
    # keys are CUDA events around the calls, as in the entries above;
    # `device_ms` keys the kernels' own device time (torch.profiler)
    device_keys = ("device_ms", "plain_device_ms")
    # skipping spans with no real key: the device time with every key
    # real; the ragged rows' error; the sentinel's asynchronous copies
    skip_keys = ("every_key_device_ms", "ragged_err")
    entry.update({k: cross[k] for k in ("shape",) + device_keys + skip_keys})
    entry["bf16_kv"] = {k: cross_lib[k] for k in (
        "shape", "err", "ms", "plain_ms", "library_ms", "bound_ms",
        "bound_by") + device_keys + ("library_device_ms",) + skip_keys}
    entry["async_copies"] = {k: res["async_copies"][k]
                             for k in ASYNC_KERNELS["cross_attn_decode"]}
    entry["launches_factory"] = fa["cross_attn_decode"]
    kernels.append(entry)
    src = "plankassembly_tpu_torch/csrc/fused_decode.cu"
    layer = _entry("fused_decoder_layer", src,
                   "plankassembly_tpu/ops/fused_decode.py:445",
                   ms[("fused", "bf16")]["fused_decoder_layer"],
                   fused["err"], fused)
    layer.update({k: fused[k] for k in device_keys})
    layer["shape"] = f"{fused['shape']}, with its fused_ffn"
    # the products' routes, each kernel's device time in one layer, the
    # ragged rows' error, the check along the plain version's decode
    layer["routes"] = dict(FUSED_ROUTES)
    layer["hmma"] = dict(res["decode_hmma"])
    layer["async_copies"] = {k: res["async_copies"][k]
                             for k in ASYNC_KERNELS["fused_decoder_layer"]}
    layer["breakdown"] = fused["breakdown"]
    layer["breakdown_f32"] = mk[("fused", "f32")]["breakdown"]
    layer["ragged_row_err"] = fused["ragged_row_err"]
    layer["trajectory"] = {name: mk[("fused", name)]["trajectory"]
                           for name in ("bf16", "f32")}
    ffn = _entry("fused_ffn", src, "plankassembly_tpu/ops/fused_decode.py:336",
                 ms[("fused", "bf16")]["fused_ffn"], fused["ffn_err"], fused,
                 prefix="ffn_")
    ffn.update(shape=fused["ffn_shape"], device_ms=fused["ffn_device_ms"],
               plain_device_ms=fused["plain_ffn_device_ms"],
               routes=dict(FUSED_ROUTES), hmma=dict(res["decode_hmma"]))
    kernels += [layer, ffn]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
