#!/usr/bin/env python3
"""Drive the PyTorch port (`ucf_vit_tpu_torch`) on one CUDA card.

    python3 chip_smoke.py        # from the root of a checkout; needs one card
    python3 chip_smoke.py --compare CHECKOUT
    python3 chip_smoke.py --only adaptive   # the device, build and adaptive phases alone
    python3 chip_smoke.py --only unetr      # the device, build and UNETR phases alone
    python3 chip_smoke.py --only sap        # the device, build and SAP phases alone
    python3 chip_smoke.py --only parallel   # the device, build and parallel phases alone
    python3 chip_smoke.py --only sp         # the device, build and sequence-parallel phases alone
    python3 chip_smoke.py --only moe        # the device, build and MoE phases alone

With `--compare` it runs only the device phase and times the bf16 flash
forward, the split backward route's kernels (dkv and dq, f32 and bf16),
`fused_mlp` (bf16 and f32) and `int8_matmul` of this checkout's package and
of the one in CHECKOUT (another tree of the repo unpacked by `git archive`,
say the parent) in one process: see `compare_forward`.

Phases, each fatal on failure (the script then exits non-zero and prints no
result):

1. device:  the card's name and power limit (nvidia-smi); the f32 policy as
            the CLIs set it (`inference.resolve_device`: TF32 off for
            matmuls and cuDNN), failing unless both flags read False.
2. build:   nvcc builds every kernel from csrc/ (flash_fwd_tf32,
            flash_bwd_tf32: f32 on the tensor cores by the 3xTF32 split on
            mma.sync; flash_fwd_sm90, flash_bwd_sm90: bf16 on the tensor
            cores by wgmma; each backward source with its fused, dkv and dq
            kernels; fused_mlp_sm90: the bf16
            fused MLP on the tensor cores by wgmma and TMA; fused_mlp_tf32: the
            f32 fused MLP on the tensor cores by the 3xTF32 split on mma.sync,
            clusters of blocks sharing a 64-row tile; int8_gemm: the W8A8 product on the
            int8 tensor cores by wgmma s32.s8.s8 and TMA, after a pass that
            quantizes x and turns the weights K-major), one nvcc each,
            started together; cuobjdump then shows every entry of the three
            sm90 libraries holding HGMMA (wgmma) code and every GEMM entry of
            int8_gemm holding IGMMA (the integer wgmma), every entry of
            flash_fwd_sm90, fused_mlp_sm90 and int8_gemm holding UTMALDG
            (their TMA loads; fused_mlp_sm90's partial-sum reduction,
            mlp_reduce_kernel, and int8_gemm's first pass, int8_prepare, are
            the entries exempt: they multiply nothing and load by ordinary
            loads), and every entry of the three tf32 libraries holding HMMA
            instructions on TF32 operands (fused_mlp_tf32's sum of its S
            partials, mlp_reduce_tf32_kernel, exempt); no DH = 64 instance of
            the forwards (sm90, tf32), of the tf32 backward or of the bf16
            dq kernel, not the D = 768 instances of
            fused_mlp_sm90 (`<2, 192>`) and fused_mlp_tf32 (`<3, 2>`) and no
            int8_gemm_kernel may spill.
3. kernels: each kernel against its plain PyTorch version on the card, at
            the shapes the serving and training paths give it and at the
            other shapes the kernels must take: the forward, both backward
            routes (fused; dkv + dq), and the dropout hash inside both;
            device times (the profiler's, per launch) of the kernels, the
            plain versions and one library call (a yardstick only: the port
            never calls it), with the host's time per call beside them, the
            least time the card could take, and both backward routes timed
            at every shape in turns (fused, split, split, fused: device ms of
            every kernel a call launches, with the spread of the two windows,
            and host ms a call), beside the route `bwd_route` takes there.
            The bf16 forward is also held and
            timed at mae_long's encoder shape [2, 12, 8192^2, 64] (against
            its plain version one head at a time; with 4096 keys or more
            bf16 o is held to LONG_FLASH_TOL), must take its TMA route
            (`flash_attention.by_layout`) at the ViT-B, ViT-L and long
            shapes, packed or not, and is held and timed on both routes at
            sap_bf16's decoder shape (SAP_DECODER_SHAPE).
            At mae_long's shapes (MAE_SHAPES, packed views): the bf16 forward
            at the decoder's [2, 6, 32768^2, 96] (dh 96 in the DH = 128
            instance) and both backward routes at the encoder's [2, 12,
            8192^2, 64] and the decoder's, held a head at a time against the
            plain versions (the forward to MAE_DEC_FWD_TOL, the backward to
            LONG_BWD_TOL); the forward, the fused kernel, dkv and dq timed
            beside their plain versions and scaled_dot_product_attention
            (forward and backward); both routes timed in turns there and at
            ROUTE_SHAPES (the decoder's at batch 1, contiguous, and at half
            its length).
            Then the two ops that no model is wired to, in either package:
            `fused_mlp` at the ViT-B and ViT-L MLP shapes and a ragged one
            (bf16 and f32, tanh and erf GELU; bf16 through fused_mlp_sm90.cu
            by its plan, printed: route, blocks of a cluster, output
            warpgroups, S; f32 through fused_mlp_tf32.cu by its plan, printed
            (blocks of a cluster, columns a block, ring stages, shared memory,
            S) and held against the C entry's blocks, columns and shared
            memory; a call timed as the device
            time of all of its kernels, the partial sums' reduction included,
            in both types at both model shapes), and `int8_matmul` at the
            ViT-B projections (bit-equal to its plain version, and its
            quantization to `quantize_rows_plain`; within the JAX test's
            error bands of the exact product; a call timed as the device time
            of both of its kernels, printed apart, beside the bf16
            `torch.matmul` of the same product and `torch._int_mm` on the
            pre-quantized operands); then both through their public API
            (fused_mlp in bf16 and in f32) with the launch counts set to 0
            before.
4. train:   `ucf_vit_tpu_torch.train` on the same config (ViT-B/16 at full
            width and depth, seeded init, synthetic batches of 16): 10 steps
            with attention FLASH (the kernels) against 10 with EINSUM (plain
            autograd) from one init and batch stream; a timed and a traced
            window of 20 steps; the same config with attn_drop_rate 0.1,
            3 steps FLASH against EINSUM (the hash mask is the same on both
            sides); and `train()` itself for two epochs, with every launch
            count set to 0 before it and read after, each epoch saved to its
            even/odd checkpoint slot under build/ (the save timed, both slots
            written, `_latest` resolving to the newer).
5. serve:   `make_server` on configs/catsdogs/classification/base_config.yaml
            (ViT-B/16 at full width) with `--checkpoint` on the train phase's
            directory answers sequential HTTP requests, then sustained load
            from a client in its own process (closed-loop clients, one
            untraced window and one under the profiler); every answer must
            equal the direct forward of its sample with attention forced to
            EINSUM on the checkpoint's weights; the flash kernel must have run
            once per block per batch. Then `/v1/reload` to the other slot: the
            next answers must be that slot's. Then a server with seeded
            weights under the same load, for its requests/s.
6. bf16:    the same ViT-B/16 config with `trainer.data_type: bfloat16` set
            in memory, 10 steps FLASH against EINSUM; then
            configs/imagenet/classification_vit_l/base_config.yaml (ViT-L/16
            at full width and depth, bf16 compute on f32 parameters, remat,
            4 microbatches of 8) through the trainer's CLI entry with
            `--single-device`, the launch counts set to 0 before it and read
            after (every bf16 forward on the TMA route); a timed and a traced
            window of 6 steps; and a short window with remat off, for what
            remat costs and saves.
            It runs after serving: on an H100 host a server started after it
            in the same process answered 233 requests/s, against 260-300 for
            one started before it.
7. mae:     configs/basic_ct/mae_long/base_config.yaml (MAE at full width and
            depth: a 32768-patch 128^3 tile, an 8192-token encoder, a
            32768-token decoder; bf16, remat, batch 2, maskMSE) through the
            trainer's CLI entry with `--single-device`, the launch counts set
            to 0 before it and read after (every bf16 forward on the TMA
            route; each block's backward on the route `bwd_route` gives its
            shape: the encoder's fused, the decoder's split); a timed and a
            traced window; the loss falling on one fixed batch; FLASH against
            EINSUM on a copy of depth 1 with a 64^3 tile
            (per-step losses, and the first step's gradients leaf by leaf).
8. disk:    mae_long from NIfTI files: seeded CT-like int16 volumes of 512 x
            512 x 128 written under build/, and a copy of the shipped config
            that names them (only data.dict_root_dirs, trainer.checkpoint_path
            and trainer.max_epochs change): the loader alone (host ms a
            batch); the CLI entry with `--single-device` for two epochs, the
            launch counts exactly the synthetic run's a step, both checkpoint
            slots written and each save timed; a timed and a traced window
            on the live loader (ms/step, time waiting for data, busy share,
            peak memory); then, on two volumes of one tile, 2 epochs and a
            run resumed to 3 against 3 uninterrupted epochs, to limits set
            from the spread of two uninterrupted runs. Where PIL and cv2 import,
            catsdogs from JPEG files: 128 photos of 500 x 375, the loader
            alone and one epoch of the shipped config through the CLI entry;
            where either does not, that is printed (the JPEG path is then held
            against the JAX package on the CPU only).
9. diffusion: configs/imagenet/diffusion and configs/basic_ct/diffusion
            (DiffusionVIT at full width and depth: ViT-B/16's encoder on 256
            tokens with no class token, a decoder of 8 blocks 512 wide with 4
            heads of 128, or 576 wide with 6 heads of 96; f32, 2 microbatches
            of 16, loss scaling) through the trainer's CLI entry with
            `--single-device`, the launch counts set to 0 before it and read
            after, by kernel and by head-dim instance (40 forwards and 40 fused
            backwards a step, 16 of each at the decoder's DH = 128 or DH = 96
            instance); a timed and a traced window; FLASH against EINSUM, the
            steps, the noise and the time embedding's dropout drawn from one
            seeded generator on both runs. Before it, in the kernel phases
            (`phase_diffusion_kernels`), the f32 forward and fused backward at
            the decoders' attention shapes (DIFF_SHAPES) against their plain
            versions, timed beside them, their bound and SDPA; the build phase
            prints those instances' registers and spills.
10. generate: imagenet's DiffusionVIT (seeded weights) generating 8 images by
            the whole 1,000-step DDPM reverse chain on the card
            (`generate_diffusion`) for seeds 0 and 1 (other images), each
            with exactly 20 forwards a step and no backward; device time a
            denoising step in a traced window; then `make_server` with
            `--num-generate` 8: its warm-up (one denoising step), one `POST
            /v1/generate` for seed 0 (latency, shape, launches, and the same
            images as the direct chain's for seed 0) and `/v1/predict`
            answering 400.
11. adaptive (`phase_adaptive`): adaptive patching in 2-D, the three configs
            as shipped (f32, 196 quadtree patches, batch 32). The f32 forward
            and both backward routes at their attention shapes
            (ADAPTIVE_SHAPES: 49 kept tokens, one partial tile on both axes;
            197; 196 at dh 128 and 96) against their plain versions, timed
            beside SDPA; the patchify's host cost (the native tree against its
            numpy build); imagenet/classification from 96 seeded JPEGs through
            the CLI entry and the DataModule (the loader alone, FLASH against
            EINSUM on its batches, windows on the live loader in line as
            shipped and with a spawn pool of 4, one traced); imagenet/mae and
            basic_ct/mae through the CLI entry, FLASH against EINSUM, a timed
            and a traced window; imagenet/classification served with
            `--preprocess-workers 4` under load (each answer against the
            in-process forward of its patchified sample, the pool's trees byte
            for byte the in-line ones) and basic_ct/mae's `/v1/predict`
            against `inference.reconstruct`. Every launch at the instance
            its shape gives, under the tf32 sources.
12. trainer parity (`phase_trainer_parity`): catsdogs ViT-B/16 at full width
            from phase 8's JPEG files through the trainer's CLI entry with
            validation on the held-out tenth: twice uninterrupted (the first
            with `profile_dir`, whose trace must name the f32 flash kernels) and
            once stopped by `preempt_after_steps` mid-epoch and resumed, the
            resumed run's records and losses against the uninterrupted one's;
            SIGTERM to the CLI in a process of its own (exit code 0, a
            checkpoint that a resumed run continues); the inference CLI on that
            checkpoint under FLASH and EINSUM (the same top-1) and on imagenet's
            DiffusionVIT; MAE `/v1/predict` at mae_long's full width from phase
            8's checkpoint (requests/s, a lone request's latency, the busy share,
            launches by instance, answers against `inference.reconstruct`).

13. unetr (`phase_unetr`): configs/basic_ct/unetr as shipped (ViT-B over 729
            octree tokens reassembled into a 36^3 image, the conv decoder, f32,
            remat, batch 8, 64^3 tiles), --single-device. (a) the f32 forward
            and fused backward at [96, 729, 64] against their plain versions,
            timed beside SDPA, and both backward routes timed; (b) synthetic
            training through the CLI entry (24 forwards and 12 fused
            backwards a step), a timed and a traced window (device time by
            kind: GEMMs, convolutions, instance norm and element-wise, flash),
            FLASH against EINSUM over 3 steps; (c) from 4 seeded labelled
            NIfTI volumes of 128^3, in line and with a spawn pool of 4 (the
            loader's host time, a step's wait, Patchify3D's parts); (d) the
            warm start from an MAE checkpoint (mae_long's: the encoder equal
            tensor for tensor, pos_embed resampled, the decoder its own); (e)
            the inference CLI's Dice under FLASH and EINSUM and `--volume`'s
            27 windows of a 128^3 volume (seconds, the host's share, the
            stitched probabilities and class maps against EINSUM's); (f)
            serving with `--preprocess-workers 4`, max_batch 8, 16 clients:
            requests/s, latency, the busy share, every class map against the
            in-process forward.
14. sap (`phase_sap`): configs/basic_ct/sap (f32, batch 2) and sap_bf16 (bf16,
            batch 16) as shipped (ViT-B over 512 octree tokens reassembled into
            a 32^3 image, a ConvTranspose3d neck of 256 channels and a 1x1
            head, 4 classes), --single-device. (a) the f32 kernels at [24, 512,
            64] and the bf16 ones at [192, 512, 64] against their plain
            versions, timed beside SDPA, both backward routes timed; (b), (c)
            each config synthetic through the CLI entry (12 forwards and 12
            fused backwards a step of its dtype's source), a timed and a traced
            window (device time by kind; the neck's and head's convolutions
            one at a time), FLASH against EINSUM over 5 steps (f32 1e-4 a step
            and first-step gradients; bf16 5e-3 a step); (d) basic_ct/sap from
            the labelled volumes, warm-started from mae_long's checkpoint (the
            transfer held tensor for tensor), in line and with a spawn pool of
            4; (e) the inference CLI's Dice under FLASH and EINSUM, the
            deserialized maps of `--png-dir`, `--volume` refused; (f) serving
            with `--preprocess-workers 4` at the config's batch, 16 clients,
            every class map against the in-process forward; (g)
            imagenet/classification with `use_varemb: True` through the CLI
            entry, FLASH against EINSUM, ms a step beside it without varemb and
            the merge's share of the device time.
15. parallel (`phase_parallel`): data and tensor parallelism, two ranks
            sharing the card over gloo (NCCL refuses two ranks on one
            device; NCCL stays the CLI's backend on CUDA), spawned once in
            one gloo group: the gloo probe's six collectives on CUDA tensors,
            printed, failing if a mode needs one that is missing;
            catsdogs/classification (ViT-B/16, f32) in tp 2 and
            imagenet/classification_vit_l (bf16, remat, accum 4) in ddp 2
            and fsdp 2 with the sync check every step, each through the CLI
            entry for 2 steps (fsdp 2 too), the launch counts set to 0 before it and read
            after on each rank (12 f32 forwards and 12 fused backwards a step
            at a rank's [96, 257, 64]; ViT-L's under the sm90 sources, every
            bf16 forward on the TMA route), the per-step losses against one
            device at the same global batch (1e-4; 5e-3); SIGTERM to rank 0
            alone of a ddp-2 run (both exit 0, one checkpoint); each rank's
            ms a step beside one device's (no scaling number: the ranks share
            the card); then, on the same two ranks, sharded evaluation,
            generation and serving: the inference CLI's top-1 in tp 2 on the
            tp-2 run's checkpoint (top-1 equal, logits within FLASH_TOL of one
            device's evaluation), imagenet/diffusion's reverse chain (cut to
            PARALLEL_CHAIN_STEPS steps) in ddp 2 (within 1e-4 of the largest
            entry of one device's chain), a tp-2 server (rank 0 answers HTTP,
            rank 1 follows; lone, padded and coalesced requests and a
            `/v1/reload` within SERVE_TOL of the in-process forward; SIGTERM
            to rank 0, both exit 0), each sub-step timed and its f32 forwards
            counted per rank; the f32 kernels at tp 2's and the chain's
            per-rank shapes against their plain versions, timed beside SDPA.
16. sp (`phase_sp`): sequence parallelism, two ranks sharing the card over
            gloo as in 15: the ring's hop (`all_to_all_single` to the next
            rank) timed at the ring's chunk sizes; `ring`, `ulysses` and
            `gather` as ops at mae_long's full-width per-rank shapes (bf16,
            forward and backward) against the single-device kernel on the
            whole sequence and the plain version on a head; `ring` and
            `gather` with dropout in f32 against the single-device kernel at
            the same seed; basic_ct/mae_long at sp 2 `ring` through the CLI
            entry against one device (the launches a step exact, each rank's
            ms a step, peak memory and gloo's bytes); `reconstruct` on the
            sp-2 eval mesh against one device; the kernels at the modes'
            chunk shapes timed beside SDPA, both backward routes in turns.
17. moe (`phase_moe`): imagenet/classification_moe (adaptive ViT-B/16,
            bf16, batch 32, 8 experts top-2 in every second block). The
            `MoeMlp` layer at full width on the card against the CPU (f32,
            TF32 off: the routing, the output and the five leaves'
            gradients) and its bf16 time; the config through the CLI entry
            with --single-device and --synthetic (full width and depth:
            each step's ms, the peak memory, 12 sm90 forwards and 12 fused
            backwards a step at [384, 197, 64], the aux loss), FLASH
            against EINSUM on FLASH's routing decisions (5e-3 a step; the
            choices that differ on EINSUM's own routing and its losses
            logged beside), a timed and a traced window, a server's
            answers against the in-process forward; the config at
            (ddp 1, ep 2) on two ranks sharing the card over gloo as in 15,
            replaying one device's routing decisions, against one device's
            losses (5e-3 a step), with each rank's ms
            a step, peak memory and gloo's bytes by kind; the bf16 kernels
            at [384, 197, 64] against their plain versions, timed beside
            SDPA. It runs while flash_bwd_tf32.cu builds (bf16 alone).

Every phase prints its wall seconds on a `[time]` line, and the run all of
them and the script's on one line before the record.

The last three lines are the kernels' JSON record, the card's name and power
limit, and {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import contextlib
import copy
import http.client
import io
import json
import math
import multiprocessing
import os
import re
import shutil
import subprocess
import sys
import tempfile
import threading
import time

REPO = os.path.dirname(os.path.abspath(__file__))
# checkpoints and data files that phases write: under the checkout's build/ (which
# git ignores), each phase's in a directory of its own, all deleted before exit
WORK = os.path.join(REPO, "build", "chip_smoke_work")
CONFIG = os.path.join(REPO, "configs", "catsdogs", "classification", "base_config.yaml")
VIT_L_CONFIG = os.path.join(REPO, "configs", "imagenet", "classification_vit_l",
                            "base_config.yaml")
MAE_CONFIG = os.path.join(REPO, "configs", "basic_ct", "mae_long", "base_config.yaml")
MAX_BATCH = 16
SEQUENTIAL_REQUESTS = 8
LOAD_CLIENTS = 32  # closed-loop clients: two full batches in flight
# (the load window 6 s and the traced one 3 s until the SAP phase came; the load window 3 s
# until the sharded evaluation came)
LOAD_WINDOWS_S = {"warm-up": 0.5, "load": 2.0, "traced": 1.0}  # 1, 2, 2 s before phase_sp
SERVE_TOL = 1e-4  # f32 on both sides, TF32 off: only the order of sums differs
FLASH_TOL = {"float32": 5e-5, "bfloat16": 2e-2}  # o, against the f32 plain result
# bf16 o with LONG_KEYS keys or more: randn inputs give entries of about sqrt(e / Nkv)
# (0.015 at 8192 keys), under FLASH_TOL's 2e-2, so a wrong tile would pass it; 2e-3 is
# about four times the error measured at LONG_FWD_SHAPE on an H100 (4.7e-4)
LONG_FLASH_TOL, LONG_KEYS = 2e-3, 4096
LSE_TOL = 5e-5  # lse is f32 from the same (bf16-exact) inputs in both versions
# dq, dk, dv: max |kernel - plain| over max |plain|. f32: other orders of sums,
# and dq's atomics in a run-dependent order; bf16: against the f32 plain result
# from the same bf16 inputs, the kernel's outputs rounded to bf16
BWD_TOL = {"float32": 1e-4, "bfloat16": 2e-2}
TRAIN_BATCH = 16
TRAIN_STEPS = 10  # FLASH against EINSUM
TRAIN_LOSS_TOL = 1e-4  # per-step loss, f32 and TF32 off on both sides
TRAIN_GRAD_TOL = 1e-4  # first-step gradient, relative to the largest entry
TIMED_STEPS, WARMUP_STEPS = 20, 3
DROPOUT_STEPS = 3
MAIN_PATH_STEPS = 6  # train() itself: two epochs of 3, each saved to its even/odd slot
# fused_mlp against its plain version, max |y - plain|. bf16: the JAX tests' atol (one
# bf16 ulp of an output below 4 is 1.6e-2, where the two round to neighbouring values);
# f32: sums in another order over up to 4096 terms
MLP_TOL = {"float32": 1e-4, "bfloat16": 2e-2}
# bf16 training, FLASH against EINSUM, per-step loss: FLASH keeps f32 scores from the
# bf16 q and k, EINSUM rounds them to bf16 first; the learning rate is still in its
# warm-up (below 1e-6), so the parameters stay together and only the forward's
# rounding shows
BF16_TRAIN_LOSS_TOL = 2e-2
VIT_L_MAIN_STEPS = 3  # the CLI entry itself
VIT_L_TIMED_STEPS, VIT_L_WARMUP_STEPS, VIT_L_NO_REMAT_STEPS = 4, 3, 3
MAE_MAIN_STEPS = 3  # mae_long through the CLI entry
MAE_WARMUP_STEPS, MAE_TIMED_STEPS = 2, 3  # and the timed and traced windows
MAE_FALL_STEPS = 5  # on one fixed batch
MAE_CHECK_STEPS, MAE_CHECK_TILE = 3, 64  # FLASH against EINSUM on the depth-1 copy
# that check's limits, set from its readings on an H100: the per-step loss, a loss near
# 1.25 that hardly depends on attention (1.9e-6, so 2e-5), and, leaf by leaf, the first
# step's gradients as max |g_flash - g_einsum| / max |g_einsum| (3.4e-3 to 3.8e-3 on the
# attention leaves, 5.8e-3 the largest of all 37 leaves, so 2e-2)
MAE_CHECK_LOSS_TOL = 2e-5
MAE_CHECK_GRAD_TOL = 2e-2
# the leaves whose gradients pass through attention first: the kernels' dq, dk, dv
MAE_ATTN_LEAVES = ("blocks.0.attn.qkv.weight", "blocks.0.attn.proj.weight",
                   "decoder_blocks.0.attn.qkv.weight", "decoder_blocks.0.attn.proj.weight")
PROFILE_TRIES = 3  # profiler windows per device time, if one records nothing
# A profiler window's first launches can go unrecorded (H100, torch 2.11 + CUDA 12.8):
# in a fresh process after 20 s idle, a window's first call came back up to 6 ms late
# and its kernels were missing; late in this script's run, windows of 20 calls, or
# their first halves, recorded nothing, and with 20 lead-in calls first, up to 35 of
# 40 launches went unrecorded. So each window opens with lead-in calls, back to back
# in chunks of 1, 2, 4, ... each waited for, until PROFILE_LEAD_IN_S seconds have
# passed, and then makes the timed calls; a kernel's mean is over every launch
# recorded. PROFILE_LOSS counts the
# windows that recorded fewer launches of the named kernel than they made (each is
# logged), and those that lost timed calls too.
PROFILE_LEAD_IN_S = 0.02
PROFILE_LOSS = {"windows": 0, "short": 0, "timed_lost": 0, "most_lost": 0}
# mae_long from disk: a CT-like volume of 512 x 512 x 128 (16 tiles of 128^3, so 8
# batches of 2 an epoch; 2 volumes until the SAP phase came, cut to make room for it),
# 2 epochs (both checkpoint slots), then windows on the loader
DISK_VOLUMES, DISK_SHAPE, DISK_EPOCHS = 1, (256, 512, 128), 2  # (512, 512, 128) before phase_sp
DISK_SMALL_SHAPE = (128, 128, 128)  # the resume check's 2 volumes: one tile each
DISK_WARMUP_STEPS, DISK_TIMED_STEPS, DISK_TRACED_STEPS = 2, 3, 3
# resumed against uninterrupted after 3 epochs (`_rel_diff`, `_adam_rel`): the
# parameters relative to the last epoch's update, AdamW's moments relative to their size,
# and the last epoch's loss. The fused backward adds dq by f32 atomics in a run-dependent
# order, so two uninterrupted runs already differ: after 2 epochs by 7.8e-3, 3.7e-4 and
# 2.3e-6 on an H100 (a resumed run 1.1e-2, 3.7e-4, 2.1e-6); resuming without AdamW's
# state moved the first two to 0.27 and 0.67 in a CPU rehearsal
RESUME_PARAM_TOL, RESUME_ADAM_TOL, RESUME_LOSS_TOL = 5e-2, 5e-3, 3e-5
# catsdogs from JPEG files (where PIL and cv2 import): 128 files of 500 x 375, the size
# of the dataset's photos, so 8 steps of 16 in one epoch of the shipped config
JPEG_FILES, JPEG_SHAPE = 128, (375, 500)
# DiffusionVIT + DDPM as shipped (f32, 256 tokens, no class token; 2 microbatches of 16):
# imagenet's decoder 512 wide with 4 heads of 128, basic_ct's 576 wide with 6 of 96
DIFF_CONFIGS = {
    "imagenet": os.path.join(REPO, "configs", "imagenet", "diffusion", "base_config.yaml"),
    "basic_ct": os.path.join(REPO, "configs", "basic_ct", "diffusion", "base_config.yaml"),
}
# their decoders' attention in a training microbatch of 16, as packed qkv views: the f32
# kernels' DH = 128 and DH = 96 instances (phase_diffusion_kernels)
DIFF_SHAPES = {"imagenet": (16, 4, 256, 256, 128, True), "basic_ct": (16, 6, 256, 256, 96, True)}
DIFF_MAIN_STEPS = 3  # each config through the CLI entry
DIFF_WARMUP_STEPS, DIFF_TIMED_STEPS, DIFF_TRACED_STEPS = 3, 5, 3
DIFF_CHECK_STEPS = 5  # FLASH against EINSUM, to TRAIN_LOSS_TOL a step
GEN_SAMPLES = 8  # a generate call's batch (serve's --num-generate)
GEN_TRACED_STEPS = 20  # denoising steps in the traced window
GEN_SEED_STEPS = 50  # seeds 0 and 1 give other images: the chain cut to this many steps
# trainer parity (phase_trainer_parity): the catsdogs ViT-B/16 as shipped (f32, full
# width and depth) on phase_train_disk's 128 JPEGs, trained on the first 0.9 of the split
# (115 photos) and validated on the rest (13). A batch of 8, not the shipped 16, so that
# the held-out tenth holds a batch: 14 steps an epoch, 2 epochs, validation after each
# over 2 batches; the drill stops a run after step 7, in the middle of epoch 0
PARITY_BATCH, PARITY_EPOCHS, PARITY_VAL_BATCHES, PARITY_PREEMPT = 8, 2, 2, 7
# resumed against uninterrupted, each per-step and validation loss. f32, TF32 off: two
# uninterrupted runs differ only where the fused backward adds dq by f32 atomics in a
# run-dependent order (a few ulps; mae_long's losses after 3 epochs by 2.3e-6 on an H100), and
# the shipped warm-up keeps the learning rate under 3e-6, so a skipped or repeated batch
# shows as a loss difference of 1e-2 or more
PARITY_LOSS_TOL = 1e-4
SIGTERM_AFTER, SIGTERM_DEADLINE_S = 3, 300  # the signal follows step 3's log line
# MAE /v1/predict at mae_long's full width (bf16, 128^3 volumes), max_batch 2, under
# closed-loop clients; a served answer against `reconstruct` of its sample alone, to the
# bf16 FLASH-against-EINSUM limit in force (2e-2 of the largest entry): a batch of 2 and
# a batch of 1 may take other GEMM kernels
MAE_SERVE_BATCH, MAE_SERVE_CLIENTS = 2, 4
MAE_SERVE_WINDOWS_S = {"warm-up": 0.5, "load": 2.0, "traced": 1.0}  # 1, 2, 2 s before phase_sp
MAE_SERVE_TOL = 2e-2

# adaptive patching (phase_adaptive): the three 2-D adaptive configs as shipped (f32, 196
# quadtree patches; batch 32), on one device. imagenet/classification from 96 JPEGs of
# 500 x 375 in 4 class folders (3 batches an epoch), decoded, resized to 256^2 and
# patchified by the DataModule; imagenet/mae and basic_ct/mae on the synthetic stream
ADAPTIVE_CLS_CONFIG = os.path.join(REPO, "configs", "imagenet", "classification",
                                   "base_config.yaml")
ADAPTIVE_MAE_CONFIGS = {
    "imagenet/mae": os.path.join(REPO, "configs", "imagenet", "mae", "base_config.yaml"),
    "basic_ct/mae": os.path.join(REPO, "configs", "basic_ct", "mae", "base_config.yaml"),
}
ADAPTIVE_JPEGS, ADAPTIVE_CLASSES = 96, 4
# classification from files (10 timed steps until the SAP phase came)
ADAPTIVE_WARMUP, ADAPTIVE_TIMED, ADAPTIVE_TRACED = 3, 6, 3
ADAPTIVE_MAE_WARMUP, ADAPTIVE_MAE_TIMED = 3, 5  # each MAE, synthetic; 3 traced steps after
ADAPTIVE_MAIN_STEPS = 3  # each config through the CLI entry
# data.num_workers of a second loader window: a spawn pool of 4 patchifies (the shipped
# 1 patchifies in line, in the prefetch thread)
ADAPTIVE_POOL = 5
ADAPTIVE_SERVE_WORKERS = 4  # serve's --preprocess-workers
ADAPTIVE_SERVE_WINDOWS_S = {"warm-up": 0.5, "load": 2.0, "traced": 1.0}
# the f32 kernels' shapes on these paths at batch 32, packed qkv views: basic_ct/mae's
# encoder on its 49 kept tokens (one partial tile on both axes), imagenet/classification's
# 196 patches and the class token, the MAE decoders on all 196 (dh 128: the DH = 128
# instance; dh 96). imagenet/mae's encoder packs two samples' 49 tokens into one sequence
# (seq_pack 2) and attends by segments through EINSUM, as the JAX package does
ADAPTIVE_SHAPES = {
    "basic_ct/mae encoder": (32, 12, 49, 49, 64, True),
    "imagenet/classification": (32, 12, 197, 197, 64, True),
    "imagenet/mae decoder": (32, 4, 196, 196, 128, True),
    "basic_ct/mae decoder": (32, 6, 196, 196, 96, True),
}
ADAPTIVE_KERNEL_ITERS = 20

# phase_unetr: configs/basic_ct/unetr as shipped (ViT-B over 729 octree tokens reassembled
# into a 36^3 image, the skip-connection conv decoder of feature size 16, 4 classes, f32,
# remat, batch 8, 64^3 tiles), with --single-device
UNETR_CONFIG = os.path.join(REPO, "configs", "basic_ct", "unetr", "base_config.yaml")
# its attention: batch 8 x 12 heads over 729 tokens, dh 64, packed qkv views
UNETR_SHAPE = (8, 12, 729, 729, 64, True)
UNETR_MAIN_STEPS = 3  # through the CLI entry, synthetic
# (10 timed steps, 5 checked and 6 from files until the SAP phase came)
UNETR_WARMUP, UNETR_TIMED, UNETR_TRACED = 3, 3, 2
UNETR_CHECK_STEPS = 3  # FLASH against EINSUM
# from files: 4 seeded int16 CT-like volumes of 128^3 with label volumes 1-4 (32 tiles of
# 64^3, 4 batches an epoch); in line as shipped (num_workers 1), then a spawn pool of 4
UNETR_VOLUMES, UNETR_SIDE, UNETR_POOL = 4, 128, 5
UNETR_FILE_STEPS = 3
UNETR_EVAL_SAMPLES = 4
UNETR_SW_OVERLAP, UNETR_SW_BATCH = 0.5, 4  # 27 windows of a 128^3 volume
UNETR_MARGIN = 1e-3  # a class map is held where the reference's top-two margin passes it
UNETR_DICE_TOL = 1e-4
UNETR_SERVE_WORKERS, UNETR_MAX_BATCH, UNETR_CLIENTS = 4, 8, 16
UNETR_SEQUENTIAL = 4  # lone requests before the load windows
UNETR_SERVE_WINDOWS_S = {"warm-up": 0.5, "load": 2.0, "traced": 1.0}

# phase_sap: configs/basic_ct/sap (f32, batch 2) and sap_bf16 (bf16, batch 16) as shipped
# (ViT-B over 512 octree tokens of 4^3 reassembled into a 32^3 image, the neck of 256
# channels and the 1x1 head, 4 classes, 64^3 tiles), with --single-device
SAP_CONFIGS = {name: os.path.join(REPO, "configs", "basic_ct", name, "base_config.yaml")
               for name in ("sap", "sap_bf16")}
# their attention: 12 heads over the 512 tokens at batch 2 (f32) and 16 (bf16), dh 64
SAP_SHAPES = {"float32": (2, 12, 512, 512, 64, True), "bfloat16": (16, 12, 512, 512, 64, True)}
SAP_MAIN_STEPS = 3  # through the CLI entry
SAP_WARMUP, SAP_TIMED, SAP_TRACED = 3, 10, 2
SAP_CHECK_STEPS = 5  # FLASH against EINSUM
SAP_BF16_LOSS_TOL = 5e-3  # per-step loss, bf16
SAP_POOL = 5  # num_workers: a spawn pool of 4
SAP_FILE_STEPS = 6
SAP_EVAL_SAMPLES = 4
SAP_SERVE_WORKERS, SAP_CLIENTS, SAP_SEQUENTIAL = 4, 16, 4
SAP_SERVE_WINDOWS_S = {"warm-up": 0.5, "load": 2.0, "traced": 1.0}
# (g): imagenet/classification with use_varemb: True (red, green, blue), synthetic
VAREMB_CONFIG = os.path.join(REPO, "configs", "imagenet", "classification", "base_config.yaml")
VAREMB_MAIN_STEPS, VAREMB_CHECK_STEPS, VAREMB_TIMED = 3, 5, 5

# Published dense peaks of the H100 SXM part at 700 W (NVIDIA data sheet): TF32, bf16
# and int8 on the tensor cores, and the memory rate. The card is named so; any other
# card has no peaks here until it is measured.
CARD = "NVIDIA H100 80GB HBM3"
PEAKS = {"tf32": 495e12, "bfloat16": 989e12, "int8": 1979e12, "bytes": 3.35e12}
# The least time of f32-accurate work on this card: three TF32 products for each f32
# one (the 3xTF32 split) at the TF32 rate, 165 TFLOP/s, above the CUDA cores' f32 FMA
# rate (67 TFLOP/s). Every f32 row's bound uses it, whatever implements the kernel, so
# that no kernel can beat its bound.
F32_PASSES = 3


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def log(msg: str) -> None:
    print(msg, flush=True)


def time_ms(fn, iters: int = 50, warmup: int = 5) -> float:
    """Mean time of `fn` over `iters` back-to-back calls, between CUDA events
    recorded around the loop: for calls shorter than their host work, the
    host's time per call."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(fn, kernel: str | None = None, iters: int = 50, warmup: int = 5,
              detail: dict | None = None):
    """(device ms, host ms) per call of `fn` over `iters` back-to-back calls.
    Device: the profiler's self device time; with `kernel`, of the kernels
    whose name holds it over their count; without, every kernel of the window,
    each by its mean time and its launches per call (what a library call, or a
    call of an op that launches more than one kernel, launches). `detail`, if
    given, receives that per-call time of each kernel by name. Host: wall time
    per call of the timed calls, the loop ending in a synchronize.
    Each window opens with lead-in calls (PROFILE_LEAD_IN_S), recorded with
    the timed ones. A window in which the profiler recorded no device
    activity at all is profiled again, up to PROFILE_TRIES windows in all."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    for attempt in range(1, PROFILE_TRIES + 1):
        prof = torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA])
        prof.start()
        t_lead, calls, chunk = time.perf_counter(), 0, 1
        while calls == 0 or time.perf_counter() - t_lead < PROFILE_LEAD_IN_S:
            for _ in range(chunk):
                fn()
            torch.cuda.synchronize()
            calls += chunk
            chunk *= 2
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
        host_ms = (time.perf_counter() - t0) * 1e3 / iters
        prof.stop()
        calls += iters
        events = [e for e in prof.key_averages() if e.self_device_time_total > 0]
        if events:
            break
        log(f"[profiler] window {attempt} of {PROFILE_TRIES} recorded no device activity"
            + (f" (looking for {kernel!r})" if kernel else ""))
    if kernel is not None:
        events = [e for e in events if kernel in e.key]
        count = sum(e.count for e in events)
        if count == 0:
            fail(f"the profiler saw no kernel named {kernel!r}")
        PROFILE_LOSS["windows"] += 1
        if count < calls:  # a named kernel launches once a call
            PROFILE_LOSS["short"] += 1
            PROFILE_LOSS["timed_lost"] += count < iters
            PROFILE_LOSS["most_lost"] = max(PROFILE_LOSS["most_lost"], calls - count)
            log(f"[profiler] a window of {calls} calls ({calls - iters} lead-in) recorded "
                f"{count} launches of {kernel!r}")
        return sum(e.self_device_time_total for e in events) / 1e3 / count, host_ms
    if not events:
        fail("the profiler saw no work on the card")
    per_call = {e.key: e.self_device_time_total / e.count * max(1, round(e.count / calls)) / 1e3
                for e in events}
    if detail is not None:
        detail.update(per_call)
    return sum(per_call.values()), host_ms


# ---------------------------------------------------------------- phases


def phase_device():
    import torch

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    if smi.returncode != 0:
        fail(f"nvidia-smi: {smi.stderr.strip()}")
    card = smi.stdout.strip().splitlines()[0]
    from ucf_vit_tpu_torch.inference import resolve_device

    resolve_device()  # the f32 policy, as every entry point sets it
    log(f"[device] {card}; torch {torch.__version__} cuda {torch.version.cuda}; "
        f"cuda.matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32} "
        f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32}")
    if torch.backends.cuda.matmul.allow_tf32 or torch.backends.cudnn.allow_tf32:
        fail("resolve_device() left TF32 on: the f32 policy is TF32 off for matmuls and cuDNN")
    log(f"[device] bounds: f32 work as {F32_PASSES} x its operations at the TF32 rate "
        f"({PEAKS['tf32'] / 1e12:g} TFLOP/s, so {PEAKS['tf32'] / F32_PASSES / 1e12:g} TFLOP/s "
        f"f32-accurate), bf16 at {PEAKS['bfloat16'] / 1e12:g}, int8 at "
        f"{PEAKS['int8'] / 1e12:g} TOP/s, bytes at {PEAKS['bytes'] / 1e12:g} TB/s")
    return card


# bf16 on the tensor cores (wgmma)
SM90_SOURCES = ("flash_fwd_sm90", "flash_bwd_sm90", "fused_mlp_sm90")
# f32 on the tensor cores (3xTF32 on mma.sync)
TF32_SOURCES = ("flash_fwd_tf32", "flash_bwd_tf32", "fused_mlp_tf32")
# the SASS instructions that show each kind of source on the tensor cores
TENSOR_CORE_SASS = {**{s: "HGMMA" for s in SM90_SOURCES},
                    **{s: r"HMMA\.\S*TF32" for s in TF32_SOURCES}}
TENSOR_CORE_SASS["int8_gemm"] = "IGMMA"  # the integer wgmma (s32.s8.s8)
# the TMA tensor load
TMA_SASS = {"flash_fwd_sm90": "UTMALDG", "fused_mlp_sm90": "UTMALDG", "int8_gemm": "UTMALDG"}
# entries exempt from those checks: the fused MLPs' sums of their S partials and int8_gemm's
# first pass, quantizing x and turning the weights K-major (ordinary loads, no product)
SASS_EXEMPT = {"fused_mlp_sm90": "mlp_reduce_kernel", "fused_mlp_tf32": "mlp_reduce_tf32_kernel",
               "int8_gemm": "int8_prepare"}
# sources whose DH = 64 instances (the main paths') must not spill, and the instances of
# other sources that must not: the bf16 dq kernel's at DH = 64, the fused MLPs' at D = 768
# (fused_mlp_sm90's WN = 192, two output warpgroups; fused_mlp_tf32's three 128-column
# groups in clusters of two) and every instance of the int8 GEMM
NO_SPILL_AT_64 = ("flash_fwd_tf32", "flash_bwd_tf32", "flash_fwd_sm90")
NO_SPILL = {"flash_bwd_sm90": "flash_bwd_dq_sm90_kernel<Li64E",
            "fused_mlp_sm90": "fused_mlp_sm90_kernel<Li2ELi192E>",
            "fused_mlp_tf32": "fused_mlp_tf32_kernel<Li3ELi2E>", "int8_gemm": "int8_gemm_kernel"}
KERNEL_NAME = re.compile(r"(flash_(?:bwd_dq_sm90|bwd_dq_tf32|fwd_sm90|bwd_sm90|fwd_tf32|"
                         r"bwd_tf32)_kernel|"
                         r"fused_mlp(?:_sm90|_tf32)?_kernel|mlp_reduce(?:_tf32)?_kernel|"
                         r"int8_gemm_kernel|int8_prepare)(?:I(\w+?)EEv)?")


def _sass(path) -> str:
    """cuobjdump's SASS of a built library."""
    import shutil

    from ucf_vit_tpu_torch.ops import build

    tool = os.path.join(os.path.dirname(build.nvcc_path()), "cuobjdump")
    if not os.path.isfile(tool):
        tool = shutil.which("cuobjdump") or fail("cuobjdump not found beside nvcc or on PATH")
    sass = subprocess.run([tool, "-sass", str(path)], capture_output=True, text=True, timeout=300)
    if sass.returncode != 0:
        fail(f"cuobjdump -sass {path.name}: {sass.stderr.strip()[:500]}")
    return sass.stdout


def _sass_counts(sass: str, pattern: str) -> dict:
    """Instructions matching `pattern` per entry function of a library's SASS."""
    counts, fn = {}, None
    for line in sass.splitlines():
        if m := re.search(r"Function : (\S+)", line):
            fn = m.group(1)
            counts[fn] = 0
        elif fn is not None and re.search(pattern, line):
            counts[fn] += 1
    return counts


# the source nvcc takes longest over (24 instances: minutes, where the others take
# seconds); it goes on building while the phases that need none of it run
SLOW_SOURCE = "flash_bwd_tf32"
_SLOW_BUILD: dict = {}


def phase_build():
    """Every kernel source built by nvcc, one process each, started together,
    and each build's report and SASS checked (`_check_build`). SLOW_SOURCE
    goes on building in the background: until `phase_build_rest` has joined
    it, `build.build` of that source waits for it (it starts no second
    nvcc), and the phases run before that launch none of its kernels."""
    from concurrent.futures import ThreadPoolExecutor

    from ucf_vit_tpu_torch.ops import build

    def one(name):
        t0 = time.perf_counter()
        path = made(name)
        seconds = time.perf_counter() - t0
        return name, path, seconds, _sass(path)  # each library's SASS read in its thread too

    def waiting(name):
        if name == SLOW_SOURCE:
            _SLOW_BUILD["future"].result()
        return made(name)

    made = build.build
    t0 = time.perf_counter()
    sources = (*TF32_SOURCES, *SM90_SOURCES, "int8_gemm")
    pool = ThreadPoolExecutor(len(sources))  # one nvcc per source, started together
    futures = {name: pool.submit(one, name) for name in sources}
    pool.shutdown(wait=False)
    _SLOW_BUILD.update(future=futures[SLOW_SOURCE], t0=t0, made=made)
    build.build = waiting
    for name in sources:
        if name != SLOW_SOURCE:
            _check_build(*futures[name].result())
    log(f"[build] {len(sources) - 1} sources built and their SASS read in "
        f"{time.perf_counter() - t0:.2f} s; {SLOW_SOURCE} goes on building")


def phase_build_rest():
    """Wait for SLOW_SOURCE's build and check it (`_check_build`)."""
    from ucf_vit_tpu_torch.ops import build

    built = _SLOW_BUILD["future"].result()
    build.build = _SLOW_BUILD["made"]
    log(f"[build] {SLOW_SOURCE} ready {time.perf_counter() - _SLOW_BUILD['t0']:.2f} s after "
        "the builds started")
    _check_build(*built)


def _check_build(name: str, path, seconds: float, sass: str) -> None:
    """A library's ptxas report (registers, spills) and SASS held to the gates."""
    # ptxas reports each template instance: summarise registers and spills
    entry, regs, spills, by_entry = "", [], [], []
    for line in path.with_suffix(".log").read_text().splitlines():
        m = KERNEL_NAME.search(line)
        if "Compiling entry function" in line and m:
            entry = f"{m.group(1)}<{m.group(2)}>" if m.group(2) else m.group(1)
        if m := re.search(r"Used (\d+) registers", line):
            regs.append(int(m.group(1)))
            by_entry.append(f"{entry} {m.group(1)}")
        if (m := re.search(r"(\d+) bytes spill stores", line)) and int(m.group(1)):
            spills.append(f"{entry} ({m.group(1)} bytes)")
    log(f"[build] {name} in {seconds:.2f} s: {len(regs)} kernel instances, "
        f"{min(regs)}-{max(regs)} registers; spills in {len(spills)}"
        + (f": {', '.join(spills)}" if spills else ""))
    log(f"[build] {name} registers: {', '.join(by_entry)}")
    if name in ("flash_fwd_tf32", "flash_bwd_tf32"):
        # the diffusion decoders' instances: printed, not held
        wide = ("<Li96E", "<Li128E")
        log(f"[build] {name} at DH = 96 and 128 (the diffusion decoders'): registers "
            f"{', '.join(e for e in by_entry if any(w in e for w in wide))}; spills "
            f"{', '.join(sp for sp in spills if any(w in sp for w in wide)) or 'none'}")
    if name in NO_SPILL_AT_64 and any("<Li64E" in sp for sp in spills):
        fail(f"{name}: a DH = 64 instance (the main path's) spills: {spills}")
    if name in NO_SPILL and any(NO_SPILL[name] in sp for sp in spills):
        fail(f"{name}: {NO_SPILL[name]} spills: {spills}")
    # every instance must run on the tensor cores (and the TMA forward load by TMA)
    for pattern in (TENSOR_CORE_SASS.get(name), TMA_SASS.get(name)):
        if pattern is None:
            continue
        counts = _sass_counts(sass, pattern)
        for fn, n in sorted(counts.items()):
            m = KERNEL_NAME.search(fn)
            instance = fn if m is None else (
                f"{m.group(1)}<{m.group(2)}>" if m.group(2) else m.group(1))
            log(f"[build] {name}: {n:4d} {pattern} in {instance}")
        if len(counts) != len(regs):
            fail(f"{name}: {len(counts)} entry functions in the SASS for {len(regs)} compiled")
        held = {fn: n for fn, n in counts.items()
                if name not in SASS_EXEMPT or SASS_EXEMPT[name] not in fn}
        if not held or not all(held.values()):
            fail(f"{name}: every entry (but {SASS_EXEMPT.get(name)}) must hold {pattern}: "
                 f"{counts}")


def _bound(flops: float, nbytes: float, dtype_name: str):
    """The least time the card could take: the larger of the operations over
    the type's peak rate and the bytes over the memory rate (ms), and which.
    f32 operations count three times at the TF32 rate (F32_PASSES)."""
    if dtype_name == "float32":
        flops, dtype_name = F32_PASSES * flops, "tf32"
    t_ops = flops / PEAKS[dtype_name] * 1e3
    t_bytes = nbytes / PEAKS["bytes"] * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def _fwd_tol(dtype_name: str, n_kv: int) -> float:
    """The limit of max |o - plain| for the forward over n_kv keys."""
    if n_kv >= LONG_KEYS:
        return min(FLASH_TOL[dtype_name], LONG_FLASH_TOL)
    return FLASH_TOL[dtype_name]


def _flash_inputs(b, h, n_q, n_kv, dh, dtype, packed, gen):
    """q, k, v as [B, H, N, dh]; `packed` takes them as strided views of one
    [B, N, 3, H, dh] tensor, as the model's qkv projection gives them."""
    import torch

    if packed:
        qkv = torch.randn(b, n_q, 3, h, dh, device="cuda", generator=gen).to(dtype)
        return tuple(t.transpose(1, 2) for t in qkv.unbind(2))
    return tuple(torch.randn(b, h, n, dh, device="cuda", generator=gen).to(dtype)
                 for n in (n_q, n_kv, n_kv))


# (b, h, n_q, n_kv, dh, packed): the first is the serving and training shape
# (ViT-B/16 at batch 16), the second ViT-L/16's microbatch of 8 (both are
# timed: TIMED_SHAPES), then the head dims the configs ship, Nq = 1 (the
# variable-aggregation attention), a trailing partial key tile with Nq >> Nkv,
# and the long sequences of the MAE decoder and mae_long
SHAPES = [
    (16, 12, 257, 257, 64, True),
    (8, 16, 257, 257, 64, True),
    (16, 16, 197, 197, 36, False),
    (8, 8, 197, 197, 96, False),
    (8, 4, 197, 197, 128, False),
    (16, 12, 1, 257, 64, False),
    (1, 6, 8448, 640, 96, False),
    (1, 6, 4096, 4096, 96, False),
]
LONG_SHAPE = (1, 6, 32768, 32768, 96, False)  # backward phase only, held one head at a time
# mae_long's encoder attention on one device (8192 visible tokens, 12 heads of 64, batch
# 2): the bf16 forward alone, held one head at a time
LONG_FWD_SHAPE = (2, 12, 8192, 8192, 64, True)
# timed shapes -> prefix of their key in the phases' results ("" + dtype, "vit_l_" + dtype,
# "long_bfloat16")
TIMED_SHAPES = {SHAPES[0][:5]: "", SHAPES[1][:5]: "vit_l_", LONG_FWD_SHAPE[:5]: "long_"}
# the bf16 forward must take its TMA route at these shapes, packed or not
TMA_SHAPES = (SHAPES[0][:5], SHAPES[1][:5], LONG_FWD_SHAPE[:5])
# sap_bf16's decoder attention on one device (batch 16, 512 tokens at its fixed_length,
# 16 heads of 36): its packed views' heads lie 72 bytes apart, no stride a tensor map
# takes, so the maps merge the heads into their first dim ("tma"); contiguous copies
# (72-byte rows) go by a padded copy ("padded"). Both are held and timed.
SAP_DECODER_SHAPE = (16, 16, 512, 512, 36)
# mae_long's decoder attention on one device (batch 2, all 32768 tokens, 6 heads of 96):
# packed views with a 192-byte head stride, so the DH = 128 instance takes columns 96-127
# from TMA's zero fill past the map's first dim, never from the next head
MAE_DEC_SHAPE = (2, 6, 32768, 32768, 96, True)
MAE_SHAPES = {"encoder": LONG_FWD_SHAPE, "decoder": MAE_DEC_SHAPE}  # phase_mae_kernels
# bf16 shapes timed for the backward's route alone (phase_mae_kernels): the decoder's at
# batch 1 as packed views and at batch 2 as contiguous tensors (LONG_SHAPE is batch 1,
# contiguous), and half its length in the decoder's and the encoder's widths
ROUTE_SHAPES = [(1, 6, 32768, 32768, 96, True), (2, 6, 32768, 32768, 96, False),
                (2, 6, 16384, 16384, 96, True), (2, 12, 16384, 16384, 64, True)]
# the bf16 fused backward at MAE_SHAPES, max |d - plain| over max |plain|: the readings
# on an H100 were 2.5e-3 to 3.6e-3, about what rounding the outputs to bf16 alone gives
# (2-3e-3 of the largest entry); 1e-2 is about three times the largest (BWD_TOL's 2e-2
# was set at 257 keys)
LONG_BWD_TOL = 1e-2
# the bf16 forward at MAE_DEC_SHAPE, max |o - plain| over max |plain|: 32768 keys give o
# entries of about sqrt(e / 32768) = 0.009, so an absolute limit set at 8192 keys is loose
# here. The reading on an H100 was 2.6e-3; leaving one 64-key tile of the 512 out of the
# plain version moves its o by 1.4e-1 to 1.9e-1 of max |o| (phase_mae_kernels logs it
# for tile 100 and fails if the limit would not catch it), so 1e-2 sits between the two
MAE_DEC_FWD_TOL = 1e-2
# the profiler's kernel names: f32 by 3xTF32 and bf16 by wgmma on the tensor cores
FWD_KERNEL = {"float32": "flash_fwd_tf32_kernel", "bfloat16": "flash_fwd_sm90_kernel"}


def _bwd_kernel(dtype_name: str, kind: str) -> str:
    """The profiler's name of a backward kernel: the fused and the dkv kernel are
    instances of one template (flash_bwd_<sm90|tf32>_kernel), dq has its own."""
    src = "sm90" if dtype_name == "bfloat16" else "tf32"
    return f"flash_bwd_dq_{src}_kernel" if kind == "dq" else f"flash_bwd_{src}_kernel"


def phase_kernels():
    import torch
    import torch.nn.functional as F

    from ucf_vit_tpu_torch.ops.flash_attention import flash_attention, flash_attention_plain

    gen = torch.Generator(device="cuda").manual_seed(0)
    timed = {}
    for dtype_name in ("float32", "bfloat16"):
        dtype = getattr(torch, dtype_name)
        for b, h, n_q, n_kv, dh, packed in SHAPES + (
                [LONG_FWD_SHAPE] if dtype_name == "bfloat16" else []):
            q, k, v = _flash_inputs(b, h, n_q, n_kv, dh, dtype, packed, gen)
            layouts = dict(flash_attention.by_layout)
            out, lse = flash_attention(q, k, v, return_lse=True)
            torch.cuda.synchronize()
            if out.dtype != dtype or out.shape != (b, h, n_q, dh) or lse.shape != (b * h, n_q):
                fail(f"flash_fwd returned {out.dtype} {tuple(out.shape)}, lse {tuple(lse.shape)}")
            # past 5e7 scores (LONG_FWD_SHAPE) a head at a time, as the backward phase holds
            # LONG_SHAPE
            heads = [slice(i, i + 1) for i in range(h)] if n_q * n_kv > 5e7 else [slice(None)]
            err = lse_err = 0.0
            for hs in heads:
                ref, ref_lse = flash_attention_plain(q[:, hs].float(), k[:, hs].float(),
                                                     v[:, hs].float(), dh**-0.5)
                err = max(err, (out[:, hs].float() - ref).abs().max().item())
                lse_err = max(lse_err, (lse.view(b, h, n_q)[:, hs].reshape(-1, n_q)
                                        - ref_lse).abs().max().item())
                del ref, ref_lse
            shape = f"[{b},{h},{n_q}x{n_kv},{dh}] {dtype_name}{' qkv-views' if packed else ''}"
            tol = _fwd_tol(dtype_name, n_kv)
            log(f"[kernel] flash_fwd {shape}: max|o-plain| {err:.3e} "
                f"(tol {tol:g}), max|lse-plain| {lse_err:.3e} (tol {LSE_TOL:g})")
            if not (err <= tol and lse_err <= LSE_TOL):
                fail(f"flash_fwd disagrees with its plain version at {shape}")
            if dtype_name == "bfloat16" and (b, h, n_q, n_kv, dh) in TMA_SHAPES:
                # packed, then as contiguous copies: both on the TMA route, the same o
                views = [(q, k, v), tuple(t.contiguous() for t in (q, k, v))]
                outs = [out, flash_attention(*views[1])]
                routes = {r: n - layouts[r] for r, n in flash_attention.by_layout.items()}
                same = torch.equal(outs[0], outs[1])
                log(f"[kernel] flash_fwd {shape}: routes of the packed and the contiguous "
                    f"inputs {routes}; the same o from both: {same}")
                if routes != {"tma": 2, "padded": 0} or not same:
                    fail(f"the bf16 forward left its TMA route at {shape}: {routes}, "
                         f"same o {same}")
                del views, outs
            if (b, h, n_q, n_kv, dh) not in TIMED_SHAPES:
                continue
            sm = dh**-0.5
            ms, host = device_ms(lambda: flash_attention(q, k, v, sm_scale=sm),
                                 FWD_KERNEL[dtype_name])
            plain_ms, plain_host = device_ms(lambda: flash_attention_plain(q, k, v, sm))
            library_ms, library_host = device_ms(
                lambda: F.scaled_dot_product_attention(q, k, v, scale=sm))
            flops = 4.0 * b * h * n_q * n_kv * dh
            nbytes = q.element_size() * b * h * dh * (2 * n_q + 2 * n_kv) + 4 * b * h * n_q
            bound_ms, bound_by = _bound(flops, nbytes, dtype_name)
            timed[TIMED_SHAPES[(b, h, n_q, n_kv, dh)] + dtype_name] = {
                "ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
                "bound_ms": bound_ms, "bound_by": bound_by, "max_abs_err": err,
            }
            log(f"[kernel] flash_fwd {shape} ({FWD_KERNEL[dtype_name]}), device ms per call "
                f"(host ms per call): kernel {ms:.4f} ({host:.4f}), plain {plain_ms:.4f} "
                f"({plain_host:.4f}), "
                f"scaled_dot_product_attention {library_ms:.4f} ({library_host:.4f}); bound "
                f"{bound_ms:.4f} ms ({bound_by}; {flops / 1e9:.3f} GFLOP, {nbytes / 1e6:.2f} MB)")
            del q, k, v, out, lse
    _fwd_routes_at_sap_decoder(gen)
    return timed


def _fwd_routes_at_sap_decoder(gen):
    """The bf16 forward at SAP_DECODER_SHAPE by both routes: packed views (the
    merged-heads tensor maps) and contiguous copies (the padded copy), each
    held against the plain version and timed: device ms of every kernel the
    call launches (the copies too), host ms per call."""
    import torch
    import torch.nn.functional as F

    from ucf_vit_tpu_torch.ops.flash_attention import flash_attention, flash_attention_plain

    b, h, n, _, dh = SAP_DECODER_SHAPE
    packed = _flash_inputs(b, h, n, n, dh, torch.bfloat16, True, gen)
    sm = dh**-0.5
    ref, ref_lse = flash_attention_plain(*(t.float() for t in packed), sm)
    shape = f"[{b},{h},{n}x{n},{dh}] bfloat16"
    for route, inputs, (q, k, v) in (("tma", "packed", packed),
                                     ("padded", "contiguous", [t.contiguous() for t in packed])):
        before = dict(flash_attention.by_layout)
        out, lse = flash_attention(q, k, v, return_lse=True)
        torch.cuda.synchronize()
        routes = {r: c - before[r] for r, c in flash_attention.by_layout.items()}
        err = (out.float() - ref).abs().max().item()
        lse_err = (lse - ref_lse.reshape(lse.shape)).abs().max().item()
        ms, host = device_ms(lambda: flash_attention(q, k, v, sm_scale=sm))
        log(f"[kernel] flash_fwd {shape} (sap_bf16's decoder), {inputs} inputs: routes "
            f"{routes}; max|o-plain| {err:.3e} (tol {FLASH_TOL['bfloat16']:g}), max|lse-plain| "
            f"{lse_err:.3e}; device ms per call, every kernel it launches, {ms:.4f} (host "
            f"{host:.4f})")
        if routes[route] != 1 or err > FLASH_TOL["bfloat16"] or lse_err > LSE_TOL:
            fail(f"the bf16 forward at {shape} ({route}): routes {routes}, o error {err:.3e}, "
                 f"lse error {lse_err:.3e}")
    library_ms, _ = device_ms(lambda: F.scaled_dot_product_attention(*packed, scale=sm))
    log(f"[kernel] flash_fwd {shape}: scaled_dot_product_attention {library_ms:.4f} ms")


def _bwd_work(kind, b, h, n_q, n_kv, dh, esize):
    """(operations, bytes) of one backward kernel: its products of 2 * Nq *
    Nkv * dh each, and each input read once (q, k, v, do; lse and di in f32)
    and each output written once."""
    bh = b * h
    q_el, kv_el = bh * n_q * dh, bh * n_kv * dh
    products = {"fused": 5, "dkv": 4, "dq": 3}[kind]
    outputs = {"fused": q_el + 2 * kv_el, "dkv": 2 * kv_el, "dq": q_el}[kind]
    nbytes = esize * (2 * q_el + 2 * kv_el + outputs) + 2 * 4 * bh * n_q
    return 2.0 * products * bh * n_q * n_kv * dh, nbytes


def _bwd_case(q, k, v, dh, rate, seed, row0, col0, gen, per_head=False):
    """Run the forward kernel and both backward routes on one input, and hold
    dq, dk, dv of each route against the plain backward from the same
    (o, lse). Returns (o, lse, do, {route: grads}, {route: [rel err x3]},
    max |ref| x3, {route: [max |err| x3]}), each triple in the order dq, dk, dv."""
    import torch

    from ucf_vit_tpu_torch.ops.flash_attention import (
        BWD_ROUTES,
        flash_attention,
        flash_attention_bwd,
        flash_attention_bwd_plain,
    )

    b, h, n_q, _ = q.shape
    sm = dh**-0.5
    # the output gradient in the layout autograd hands the backward: [B, N, H, dh]
    do = torch.randn(b, n_q, h, dh, device="cuda", generator=gen).to(q.dtype).transpose(1, 2)
    o, lse = flash_attention(q, k, v, return_lse=True, dropout_rate=rate, dropout_seed=seed,
                             dropout_offset=(row0, col0))
    got = {r: flash_attention_bwd(q, k, v, o, lse, do, sm, rate, seed, row0, col0, route=r)
           for r in BWD_ROUTES}
    torch.cuda.synchronize()
    errs = {r: [0.0] * 3 for r in BWD_ROUTES}
    ref_max = [0.0] * 3
    lse4 = lse.view(b, h, n_q)
    # a head's slice numbers its batch-heads from 0: per-head checks run at rate 0
    assert not (per_head and rate > 0.0)
    heads = [slice(i, i + 1) for i in range(h)] if per_head else [slice(None)]
    for hs in heads:
        ref = flash_attention_bwd_plain(
            q[:, hs].float(), k[:, hs].float(), v[:, hs].float(), o[:, hs].float(),
            lse4[:, hs].reshape(-1, n_q), do[:, hs].float(), sm, rate, seed, row0, col0)
        for i, want in enumerate(ref):
            ref_max[i] = max(ref_max[i], want.abs().max().item())
            for r in BWD_ROUTES:
                errs[r][i] = max(errs[r][i], (got[r][i][:, hs].float() - want).abs().max().item())
        del ref
    rel = {r: [e / m for e, m in zip(errs[r], ref_max)] for r in BWD_ROUTES}
    return o, lse, do, got, rel, ref_max, errs


def _route_ms(shape: str, dtype, q, k, v, o, lse, do, iters: int) -> None:
    """Both backward routes of `flash_attention_bwd` on these inputs, timed in
    turns (fused, split, split, fused), logged as the `[route]` line: per
    route its device ms a call (every kernel the call launches, `device_ms`)
    and its host ms a call (`time_ms`), each the mean of its two windows, the
    spread of the device ms (the difference of the two windows), the faster
    by device time and whether its lead exceeds both spreads, and the route
    `bwd_route` takes at this shape."""
    from ucf_vit_tpu_torch.ops.flash_attention import BWD_ROUTES, bwd_route, flash_attention_bwd

    sm = q.shape[-1] ** -0.5
    dev, host = {r: [] for r in BWD_ROUTES}, {r: [] for r in BWD_ROUTES}
    for r in ("fused", "split", "split", "fused"):
        def call(r=r):
            return flash_attention_bwd(q, k, v, o, lse, do, sm, route=r)
        dev[r].append(device_ms(call, iters=iters, warmup=1)[0])
        host[r].append(time_ms(call, iters=iters, warmup=1))
    out = {r: {"device_ms": sum(dev[r]) / 2, "host_ms": sum(host[r]) / 2,
               "spread_ms": abs(dev[r][0] - dev[r][1])} for r in BWD_ROUTES}
    faster, slower = sorted(BWD_ROUTES, key=lambda r: out[r]["device_ms"])
    lead = out[slower]["device_ms"] - out[faster]["device_ms"]
    clear = lead > max(out[r]["spread_ms"] for r in BWD_ROUTES)
    _, _, n_q, dh = q.shape
    taken = bwd_route(dtype, n_q, k.shape[2], dh)
    log(f"[route] {shape}: device ms a call (spread) fused {out['fused']['device_ms']:.4f} "
        f"({out['fused']['spread_ms']:.4f}), split (dkv + dq) {out['split']['device_ms']:.4f} "
        f"({out['split']['spread_ms']:.4f}); host ms a call fused "
        f"{out['fused']['host_ms']:.4f}, split {out['split']['host_ms']:.4f}; faster {faster}"
        f"{'' if clear else ' (within the spread)'}; bwd_route takes {taken}")


def phase_bwd_kernels():
    """Both backward routes at every shape against the plain backward, both
    routes timed at every shape (the route threshold), and the three kernels
    timed at the training shape beside their bound, the plain backward and
    scaled_dot_product_attention's backward."""
    import torch
    import torch.nn.functional as F

    from ucf_vit_tpu_torch.ops.flash_attention import (
        BWD_ROUTES,
        _bwd_launch,
        _dq_workspace,
        _dropout_args,
        flash_attention_bwd_plain,
        flash_attention_dkv_plain,
        flash_attention_dq_plain,
        flash_attention_plain,
    )

    gen = torch.Generator(device="cuda").manual_seed(1)
    timed = {}
    for dtype_name in ("float32", "bfloat16"):
        dtype = getattr(torch, dtype_name)
        for b, h, n_q, n_kv, dh, packed in SHAPES + [LONG_SHAPE]:
            shape = f"[{b},{h},{n_q}x{n_kv},{dh}] {dtype_name}{' qkv-views' if packed else ''}"
            q, k, v = _flash_inputs(b, h, n_q, n_kv, dh, dtype, packed, gen)
            o, lse, do, got, rel, ref_max, abs_err = _bwd_case(
                q, k, v, dh, 0.0, 0, 0, 0, gen, per_head=(n_q * n_kv > 1e8))
            if n_q * n_kv > 1e8:  # the forward that made o and lse, one head at a time
                fwd_err = max(
                    (o[:, i:i + 1].float() - flash_attention_plain(
                        q[:, i:i + 1].float(), k[:, i:i + 1].float(), v[:, i:i + 1].float(),
                        dh**-0.5)[0]).abs().max().item() for i in range(h))
                log(f"[kernel] flash_fwd {shape}: max|o-plain| {fwd_err:.3e} "
                    f"(tol {_fwd_tol(dtype_name, n_kv):g})")
                if fwd_err > _fwd_tol(dtype_name, n_kv):
                    fail(f"flash_fwd disagrees with its plain version at {shape}")
            for r in BWD_ROUTES:
                log(f"[kernel] flash_bwd {r:5s} {shape}: max|d-plain|/max|plain| dq "
                    f"{rel[r][0]:.3e} dk {rel[r][1]:.3e} dv {rel[r][2]:.3e} "
                    f"(tol {BWD_TOL[dtype_name]:g})")
                if max(rel[r]) > BWD_TOL[dtype_name] or not all(m > 0 for m in ref_max):
                    fail(f"flash_bwd route {r} disagrees with its plain version at {shape}")
                if any(g.dtype != dtype or g.shape != t.shape for g, t in zip(got[r], (q, k, v))):
                    fail(f"flash_bwd route {r} returned the wrong dtype or shape at {shape}")
            sm = dh**-0.5
            _route_ms(shape, dtype, q, k, v, o, lse, do, iters=3 if n_q * n_kv > 1e8 else 20)
            if (b, h, n_q, n_kv, dh) not in TIMED_SHAPES:
                continue
            key = TIMED_SHAPES[(b, h, n_q, n_kv, dh)] + dtype_name
            # a training shape: each kernel alone, from buffers made beforehand
            di = (o.float() * do.float()).sum(-1).reshape(b * h, n_q)
            ws = _dq_workspace(b, n_q, h, dh, q.device)
            dq, dk, dv = (torch.empty(b, n, h, dh, device="cuda", dtype=dtype).transpose(1, 2)
                          for n in (n_q, n_kv, n_kv))
            drop = _dropout_args(0.0, 0, 0, 0)
            launches = {
                "fused": lambda: _bwd_launch("fused", q, k, v, do, lse, di, ws, dk, dv, sm, drop),
                "dkv": lambda: _bwd_launch("dkv", q, k, v, do, lse, di, dq, dk, dv, sm, drop),
                "dq": lambda: _bwd_launch("dq", q, k, v, do, lse, di, dq, dk, dv, sm, drop),
            }
            kernel_ms = {kind: device_ms(fn, _bwd_kernel(dtype_name, kind))
                         for kind, fn in launches.items()}
            # each kernel's own outputs in plain PyTorch: the whole backward for
            # the fused kernel, (dk, dv) for dkv, dq for dq
            plains = {
                "fused": lambda: flash_attention_bwd_plain(q, k, v, o, lse, do, sm),
                "dkv": lambda: flash_attention_dkv_plain(q, k, v, o, lse, do, sm),
                "dq": lambda: flash_attention_dq_plain(q, k, v, o, lse, do, sm),
            }
            whole = plains["fused"]()
            parts = (*plains["dkv"](), plains["dq"]())
            part_err = max((a.float() - w.float()).abs().max().item() / w.float().abs().max().item()
                           for a, w in zip(parts, whole[1:] + whole[:1]))
            if part_err > BWD_TOL[dtype_name]:
                fail(f"the plain dkv / dq parts disagree with the plain backward ({part_err:.3e})")
            del whole, parts
            plain_ms = {kind: device_ms(fn) for kind, fn in plains.items()}
            # the library's backward alone: the graph of one forward, its backward 50 times
            qg, kg, vg = (t.detach().requires_grad_() for t in (q, k, v))
            out = F.scaled_dot_product_attention(qg, kg, vg, scale=sm)
            sdpa_bwd_ms, sdpa_bwd_host = device_ms(
                lambda: torch.autograd.grad(out, (qg, kg, vg), do, retain_graph=True))
            del out
            log(f"[kernel] flash_bwd {shape}: scaled_dot_product_attention backward (the "
                f"kernels its backward launches) {sdpa_bwd_ms:.4f} ms device, "
                f"{sdpa_bwd_host:.4f} ms host per call")
            # each kernel's own error: the fused route's dq, dk, dv; the split
            # route's dk, dv for dkv and its dq for dq
            kernel_err = {"fused": max(abs_err["fused"]), "dkv": max(abs_err["split"][1:]),
                          "dq": abs_err["split"][0]}
            timed[key] = {}
            for kind, (ms, host) in kernel_ms.items():
                flops, nbytes = _bwd_work(kind, b, h, n_q, n_kv, dh, q.element_size())
                bound_ms, bound_by = _bound(flops, nbytes, dtype_name)
                timed[key][kind] = {
                    "ms": ms, "plain_ms": plain_ms[kind][0], "bound_ms": bound_ms,
                    "bound_by": bound_by,
                    # one library call computes what the fused kernel does; none
                    # computes dk, dv alone or dq alone
                    "library_ms": sdpa_bwd_ms if kind == "fused" else None,
                    "max_abs_err": kernel_err[kind],
                }
                log(f"[kernel] flash_bwd_{kind} {shape} ({_bwd_kernel(dtype_name, kind)}), "
                    f"device ms per call (host ms per call): kernel {ms:.4f} ({host:.4f}), plain "
                    f"{plain_ms[kind][0]:.4f} ({plain_ms[kind][1]:.4f}); bound {bound_ms:.4f} ms "
                    f"({bound_by}; {flops / 1e9:.3f} GFLOP, {nbytes / 1e6:.2f} MB), "
                    f"max|d-plain| {kernel_err[kind]:.3e}")
    return timed


def _by_head(fn, *tensors):
    """`fn` on one head's slice of each `[B, H, N, dh]` tensor at a time (lse
    as `[B*H, Nq]` is sliced alike): the plain versions at shapes whose whole
    score matrix does not fit on the card. Returns the per-head results."""
    b, h, n_q = tensors[0].shape[:3]
    out = []
    for i in range(h):
        out.append(fn(*(t.view(b, h, n_q)[:, i].reshape(-1, n_q) if t.dim() == 2
                        else t[:, i:i + 1] for t in tensors)))
    return out


def phase_mae_kernels():
    """The bf16 kernels at mae_long's attention shapes (MAE_SHAPES, packed qkv
    views, as its model gives them). The forward at the decoder's (the
    encoder's is in phase_kernels): held a head at a time to MAE_DEC_FWD_TOL,
    on the TMA route packed and as contiguous copies with the same o, timed
    beside its plain version (a head at a time) and scaled_dot_product_attention.
    Both backward routes at both: dq, dk, dv held a head at a time against the
    plain backward to LONG_BWD_TOL, both routes timed in turns (`_route_ms`),
    each kernel (fused, dkv, dq) timed beside its plain version (a head at a
    time), the fused one beside SDPA's backward too; then both routes timed
    alone at ROUTE_SHAPES. Returns {shape name: {"fwd"?, "bwd": {kind:
    numbers}}}."""
    import torch
    import torch.nn.functional as F

    from ucf_vit_tpu_torch.ops.flash_attention import (
        BWD_ROUTES,
        _bwd_launch,
        _dq_workspace,
        _dropout_args,
        flash_attention,
        flash_attention_bwd,
        flash_attention_bwd_plain,
        flash_attention_dkv_plain,
        flash_attention_dq_plain,
        flash_attention_plain,
    )

    gen = torch.Generator(device="cuda").manual_seed(6)
    timed = {}
    for name, (b, h, n, _, dh, packed) in MAE_SHAPES.items():
        shape = f"[{b},{h},{n}x{n},{dh}] bfloat16 qkv-views (mae_long's {name})"
        q, k, v = _flash_inputs(b, h, n, n, dh, torch.bfloat16, packed, gen)
        sm = dh**-0.5
        before = dict(flash_attention.by_layout)
        o, lse = flash_attention(q, k, v, return_lse=True)
        torch.cuda.synchronize()
        routes = {r: c - before[r] for r, c in flash_attention.by_layout.items()}
        timed[name] = {}
        if name == "decoder":
            err = lse_err = ref_max = 0.0
            for (ref, ref_lse), hs in zip(
                    _by_head(lambda q, k, v: flash_attention_plain(q.float(), k.float(),
                                                                   v.float(), sm), q, k, v),
                    [slice(i, i + 1) for i in range(h)]):
                err = max(err, (o[:, hs].float() - ref).abs().max().item())
                ref_max = max(ref_max, ref.abs().max().item())
                lse_err = max(lse_err, (lse.view(b, h, n)[:, hs].reshape(-1, n)
                                        - ref_lse).abs().max().item())
                del ref, ref_lse
            # what the limit must catch: the plain version with one 64-key tile of 512 left
            # out, on the first head
            q0, k0, v0 = (t[:1, :1].float() for t in (q, k, v))
            keep = torch.ones(n, dtype=torch.bool, device="cuda")
            keep[64 * 100:64 * 101] = False
            ref0 = flash_attention_plain(q0, k0, v0, sm)[0]
            miss = ((flash_attention_plain(q0, k0[:, :, keep], v0[:, :, keep], sm)[0] - ref0)
                    .abs().max() / ref0.abs().max()).item()
            del q0, k0, v0, ref0
            same = torch.equal(o, flash_attention(*(t.contiguous() for t in (q, k, v))))
            routes = {r: c - before[r] for r, c in flash_attention.by_layout.items()}
            rel = err / ref_max
            log(f"[mae] flash_fwd {shape}: max|o-plain|/max|plain| {rel:.3e} (tol "
                f"{MAE_DEC_FWD_TOL:g}; max|o-plain| {err:.3e}, max|plain| {ref_max:.3e}), "
                f"max|lse-plain| {lse_err:.3e} (tol {LSE_TOL:g}), a head at a time; routes of "
                f"the packed and the contiguous inputs {routes}; the same o from both: {same}; "
                f"the plain version without key tile 100 moves by {miss:.3e} of max|plain|")
            if not (rel <= MAE_DEC_FWD_TOL and lse_err <= LSE_TOL):
                fail(f"flash_fwd disagrees with its plain version at {shape}")
            if not miss > MAE_DEC_FWD_TOL:
                fail("MAE_DEC_FWD_TOL would pass a forward that left one key tile out")
            if routes != {"tma": 2, "padded": 0} or not same:
                fail(f"the bf16 forward left its TMA route at {shape}: {routes}, same o {same}")
            ms, host = device_ms(lambda: flash_attention(q, k, v, sm_scale=sm),
                                 FWD_KERNEL["bfloat16"], iters=10, warmup=2)
            plain_ms, _ = device_ms(lambda: _by_head(
                lambda q, k, v: flash_attention_plain(q, k, v, sm), q, k, v), iters=2, warmup=1)
            library_ms, _ = device_ms(lambda: F.scaled_dot_product_attention(q, k, v, scale=sm),
                                      iters=10, warmup=2)
            flops = 4.0 * b * h * n * n * dh
            nbytes = q.element_size() * b * h * dh * 4 * n + 4 * b * h * n
            bound_ms, bound_by = _bound(flops, nbytes, "bfloat16")
            timed[name]["fwd"] = {"ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
                                  "bound_ms": bound_ms, "bound_by": bound_by, "max_abs_err": err}
            log(f"[mae] flash_fwd {shape} ({FWD_KERNEL['bfloat16']}), device ms per call (host "
                f"ms): kernel {ms:.4f} ({host:.4f}), plain a head at a time {plain_ms:.4f}, "
                f"scaled_dot_product_attention {library_ms:.4f}; bound {bound_ms:.4f} ms "
                f"({bound_by}; {flops / 1e9:.1f} GFLOP at dh {dh}, computed at DH = "
                f"{-(-dh // 64) * 64} by the kernel)")
        elif routes != {"tma": 1, "padded": 0}:
            fail(f"the bf16 forward left its TMA route at {shape}: {routes}")

        # both backward routes, from the layout autograd hands them
        do = torch.randn(b, n, h, dh, device="cuda", generator=gen).to(torch.bfloat16)
        do = do.transpose(1, 2)
        got = {r: flash_attention_bwd(q, k, v, o, lse, do, sm, route=r) for r in BWD_ROUTES}
        torch.cuda.synchronize()
        errs = {r: [0.0] * 3 for r in BWD_ROUTES}
        ref_max = [0.0] * 3
        for ref, hs in zip(_by_head(lambda *t: flash_attention_bwd_plain(
                *(x.float() for x in t[:4]), t[4], t[5].float(), sm), q, k, v, o, lse, do),
                [slice(i, i + 1) for i in range(h)]):
            for i, want in enumerate(ref):
                ref_max[i] = max(ref_max[i], want.abs().max().item())
                for r in BWD_ROUTES:
                    errs[r][i] = max(errs[r][i],
                                     (got[r][i][:, hs].float() - want).abs().max().item())
            del ref
        for r in BWD_ROUTES:
            rel = [e / m for e, m in zip(errs[r], ref_max)]
            log(f"[mae] flash_bwd {r:5s} {shape}: max|d-plain|/max|plain| dq {rel[0]:.3e} dk "
                f"{rel[1]:.3e} dv {rel[2]:.3e} (tol {LONG_BWD_TOL:g}), a head at a time; "
                f"max|plain| {ref_max[0]:.3e} {ref_max[1]:.3e} {ref_max[2]:.3e}")
            if max(rel) > LONG_BWD_TOL or not all(m > 0 for m in ref_max):
                fail(f"the {r} backward disagrees with its plain version at {shape}")
        del got
        _route_ms(shape, torch.bfloat16, q, k, v, o, lse, do, iters=3)
        # each kernel alone, from buffers made beforehand: device ms beside its plain
        # version (a head at a time), and for the fused kernel SDPA's backward
        di = (o.float() * do.float()).sum(-1).reshape(b * h, n)
        ws = _dq_workspace(b, n, h, dh, q.device)
        dq, dk, dv = (torch.empty(b, n, h, dh, device="cuda", dtype=q.dtype).transpose(1, 2)
                      for _ in "qkv")
        drop = _dropout_args(0.0, 0, 0, 0)
        plains = {"fused": flash_attention_bwd_plain, "dkv": flash_attention_dkv_plain,
                  "dq": flash_attention_dq_plain}
        qg, kg, vg = (t.detach().requires_grad_() for t in (q, k, v))
        out = F.scaled_dot_product_attention(qg, kg, vg, scale=sm)
        library_ms, _ = device_ms(
            lambda: torch.autograd.grad(out, (qg, kg, vg), do, retain_graph=True),
            iters=10, warmup=2)
        del out, qg, kg, vg
        # each kernel's own error: the fused route's dq, dk, dv; the split route's dk, dv
        # for dkv and its dq for dq
        kernel_err = {"fused": max(errs["fused"]), "dkv": max(errs["split"][1:]),
                      "dq": errs["split"][0]}
        timed[name]["bwd"] = {}
        for kind, plain in plains.items():
            ms, host = device_ms(lambda: _bwd_launch(kind, q, k, v, do, lse, di,
                                                     ws if kind == "fused" else dq, dk, dv, sm,
                                                     drop),
                                 _bwd_kernel("bfloat16", kind), iters=10, warmup=2)
            plain_ms, _ = device_ms(lambda: _by_head(
                lambda *t: plain(*t, sm), q, k, v, o, lse, do), iters=2, warmup=1)
            flops, nbytes = _bwd_work(kind, b, h, n, n, dh, q.element_size())
            bound_ms, bound_by = _bound(flops, nbytes, "bfloat16")
            timed[name]["bwd"][kind] = {
                "ms": ms, "plain_ms": plain_ms,
                "library_ms": library_ms if kind == "fused" else None,
                "bound_ms": bound_ms, "bound_by": bound_by, "max_abs_err": kernel_err[kind]}
            log(f"[mae] flash_bwd_{kind} {shape} ({_bwd_kernel('bfloat16', kind)}), device ms "
                f"per call (host ms): kernel {ms:.4f} ({host:.4f}), plain a head at a time "
                f"{plain_ms:.4f}" + (f", scaled_dot_product_attention backward {library_ms:.4f}"
                                     if kind == "fused" else "")
                + f"; bound {bound_ms:.4f} ms ({bound_by}; {flops / 1e9:.1f} GFLOP at dh {dh})")
        del q, k, v, o, lse, do, di, ws, dq, dk, dv
        torch.cuda.empty_cache()
    for b, h, n, _, dh, packed in ROUTE_SHAPES:
        q, k, v = _flash_inputs(b, h, n, n, dh, torch.bfloat16, packed, gen)
        o, lse = flash_attention(q, k, v, return_lse=True)
        do = torch.randn(b, n, h, dh, device="cuda", generator=gen).to(torch.bfloat16)
        shape = f"[{b},{h},{n}x{n},{dh}] bfloat16{' qkv-views' if packed else ''}"
        _route_ms(shape, torch.bfloat16, q, k, v, o, lse, do.transpose(1, 2), iters=3)
        del q, k, v, o, lse, do
    return timed


def phase_dropout(fwd_timed, bwd_timed):
    """The dropout hash inside the forward and both backward routes at the
    training shape with a fixed seed and a nonzero (row0, col0), against the
    plain versions built on `dense_keep_mask`; the times with the hash."""
    import torch
    import torch.nn.functional as F

    from ucf_vit_tpu_torch.ops.flash_attention import (
        BWD_ROUTES,
        _bwd_launch,
        _dq_workspace,
        _dropout_args,
        flash_attention,
        flash_attention_plain,
    )

    rate, seed, row0, col0 = 0.1, 1234, 3, 5
    gen = torch.Generator(device="cuda").manual_seed(2)
    b, h, n_q, n_kv, dh, packed = SHAPES[0]
    sm = dh**-0.5
    record = None
    for dtype_name in ("float32", "bfloat16"):
        dtype = getattr(torch, dtype_name)
        shape = f"[{b},{h},{n_q}x{n_kv},{dh}] {dtype_name} rate {rate} seed {seed} " \
                f"offset ({row0},{col0})"
        q, k, v = _flash_inputs(b, h, n_q, n_kv, dh, dtype, packed, gen)
        o, lse, do, got, rel, _, _ = _bwd_case(q, k, v, dh, rate, seed, row0, col0, gen)
        ref_o, ref_lse = flash_attention_plain(q.float(), k.float(), v.float(), sm, rate, seed,
                                               row0, col0)
        err = (o.float() - ref_o).abs().max().item()
        lse_err = (lse - ref_lse).abs().max().item()
        dropped = (o.float() - flash_attention_plain(q.float(), k.float(), v.float(), sm)[0])
        log(f"[dropout] flash_fwd {shape}: max|o-plain| {err:.3e} (tol "
            f"{FLASH_TOL[dtype_name]:g}), max|lse-plain| {lse_err:.3e}; max|o - o(rate 0)| "
            f"{dropped.abs().max().item():.3e}")
        if not (err <= FLASH_TOL[dtype_name] and lse_err <= LSE_TOL):
            fail(f"flash_fwd with dropout disagrees with its plain version at {shape}")
        if dropped.abs().max().item() < 1e-2:
            fail("the dropout forward dropped nothing")
        for r in BWD_ROUTES:
            log(f"[dropout] flash_bwd {r:5s} {shape}: rel err dq {rel[r][0]:.3e} dk "
                f"{rel[r][1]:.3e} dv {rel[r][2]:.3e} (tol {BWD_TOL[dtype_name]:g})")
            if max(rel[r]) > BWD_TOL[dtype_name]:
                fail(f"flash_bwd route {r} with dropout disagrees with its plain version")
        if dtype_name != "float32":
            continue
        ms, _ = device_ms(lambda: flash_attention(q, k, v, dropout_rate=rate, dropout_seed=seed,
                                                  dropout_offset=(row0, col0)),
                          FWD_KERNEL[dtype_name])
        plain_ms, _ = device_ms(lambda: flash_attention_plain(q, k, v, sm, rate, seed, row0, col0))
        library_ms, _ = device_ms(lambda: F.scaled_dot_product_attention(q, k, v, dropout_p=rate,
                                                                         scale=sm))
        di = (o.float() * do.float()).sum(-1).reshape(b * h, n_q)
        ws = _dq_workspace(b, n_q, h, dh, q.device)
        dk, dv = (torch.empty(b, n_kv, h, dh, device="cuda").transpose(1, 2) for _ in "kv")
        drop = _dropout_args(rate, seed, row0, col0)
        fused_ms, _ = device_ms(lambda: _bwd_launch("fused", q, k, v, do, lse, di, ws, dk, dv,
                                                    sm, drop), _bwd_kernel(dtype_name, "fused"))
        log(f"[dropout] f32 device times with the hash: flash_fwd {ms:.4f} ms (without "
            f"{fwd_timed['float32']['ms']:.4f}), plain {plain_ms:.4f} ms, "
            f"scaled_dot_product_attention(dropout_p={rate}) {library_ms:.4f} ms; "
            f"flash_bwd_fused {fused_ms:.4f} ms (without "
            f"{bwd_timed['float32']['fused']['ms']:.4f})")
        record = {"ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
                  "bound_ms": fwd_timed["float32"]["bound_ms"],
                  "bound_by": fwd_timed["float32"]["bound_by"], "max_abs_err": err}
    return record


# fused_mlp: (rows, D, H). ViT-B's MLP at batch 16 (the shape the JAX package's
# study times), ViT-L's at its microbatch of 8, and a shape ragged in M, D and H
MLP_SHAPES = [(16 * 257, 768, 3072), (8 * 257, 1024, 4096), (300, 200, 300)]
# int8_matmul: (M, K, N), the qkv, fc1 and fc2 projections of ViT-B at batch 16
INT8_SHAPES = [(16 * 257, 768, 2304), (16 * 257, 768, 3072), (16 * 257, 3072, 768)]
RECORD_MLP, RECORD_INT8 = MLP_SHAPES[0], INT8_SHAPES[1]  # the kernels record's rows


def _mlp_inputs(m, d, h, dtype, gen):
    """x ~ N(0, 1) as a LayerNorm gives it, weights at the init's std 0.02."""
    import torch

    def randn(*shape, std=1.0):
        return (std * torch.randn(*shape, device="cuda", generator=gen)).to(dtype)

    return (randn(m, d), randn(d, h, std=0.02), randn(h, std=0.01),
            randn(h, d, std=0.02), randn(d, std=0.01))


# what a call of fused_mlp launches, by dtype, and of int8_matmul: the kernels a timed
# call sums
MLP_KERNELS = {"float32": ("fused_mlp_tf32_kernel", "mlp_reduce_tf32_kernel"),
               "bfloat16": ("fused_mlp_sm90_kernel", "mlp_reduce_kernel")}
INT8_KERNELS = ("int8_prepare", "int8_gemm_kernel")


def _call_ms(fn, kernels, what: str):
    """(device ms of one call, summed over every kernel it launches; host ms per
    call; those kernels by name), failing if the call launched anything but
    `kernels` (names, each no part of another)."""
    by_name = {}
    ms, host = device_ms(fn, iters=20, warmup=2, detail=by_name)
    other = [k for k in by_name if not any(n in k for n in kernels)]
    if other:
        fail(f"{what} launched other kernels too: {other}")
    return ms, host, by_name


def phase_mlp_kernels():
    """`fused_mlp` against `fused_mlp_plain` at every shape, both types and both
    GELU forms; timed at the two model shapes beside its bound, the plain
    version and the unfused composition F.linear, F.gelu, F.linear (three
    library calls: no single call computes the function). A call's time is the
    device time of all of its kernels (the main kernel and, at S > 1, the
    reduction of its partials); the plan is printed beside it (bf16: route,
    blocks of a cluster, output warpgroups, S; f32: blocks of a cluster,
    columns a block, ring stages, shared memory, S, the blocks, columns and
    shared memory held against what the C entry computes for the same D)."""
    import ctypes

    import torch
    import torch.nn.functional as F

    from ucf_vit_tpu_torch.ops import build
    from ucf_vit_tpu_torch.ops.fused_mlp import (
        fused_mlp,
        fused_mlp_plain,
        mlp_plan,
        mlp_plan_f32,
    )

    gen = torch.Generator(device="cuda").manual_seed(3)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    timed = {}
    for dtype_name in ("float32", "bfloat16"):
        dtype = getattr(torch, dtype_name)
        for m, d, h in MLP_SHAPES:
            args = _mlp_inputs(m, d, h, dtype, gen)
            shape = f"[{m},{d}]->{h} {dtype_name}"
            if dtype_name == "bfloat16":
                plan = mlp_plan(m, d, h, sms)
                log(f"[kernel] fused_mlp {shape}: plan route {plan.route}, {plan.groups} "
                    f"block(s) a cluster, {plan.warpgroups} output warpgroup(s) a block, S = "
                    f"{plan.splits}, {plan.blocks} blocks")
            else:
                plan = mlp_plan_f32(m, d, h, sms)
                c_shape = [ctypes.c_int() for _ in range(3)]
                if build.load("fused_mlp_tf32").ucf_fused_mlp_tf32_shape(
                        d, *(ctypes.byref(v) for v in c_shape)) != 0:
                    fail(f"the f32 kernel's C entry refuses D = {d}")
                c_shape = tuple(v.value for v in c_shape)
                log(f"[kernel] fused_mlp {shape}: plan {plan.groups} block(s) a cluster, "
                    f"{plan.group_cols} columns a block, {plan.stages} ring stages, "
                    f"{plan.smem} bytes of shared memory a block, S = {plan.splits}, "
                    f"{plan.blocks} blocks; the C entry's (blocks, columns, bytes) {c_shape}")
                if c_shape != (plan.groups, plan.group_cols, plan.smem):
                    fail(f"mlp_plan_f32 and the C entry differ at D = {d}")
            errs = {}
            for approx in (True, False):
                got = fused_mlp(*args, approx=approx)
                torch.cuda.synchronize()
                want = fused_mlp_plain(*args, approx=approx)
                if got.dtype != dtype or got.shape != (m, d):
                    fail(f"fused_mlp returned {got.dtype} {tuple(got.shape)} at {shape}")
                errs[approx] = (got.float() - want.float()).abs().max().item()
            log(f"[kernel] fused_mlp {shape}: max|y-plain| tanh {errs[True]:.3e} erf "
                f"{errs[False]:.3e} (tol {MLP_TOL[dtype_name]:g}); max|plain| "
                f"{want.float().abs().max().item():.3f}")
            if not max(errs.values()) <= MLP_TOL[dtype_name]:
                fail(f"fused_mlp disagrees with its plain version at {shape}")
            if d < 768:
                continue
            x, w1, b1, w2, b2 = args
            w1t, w2t = w1.t().contiguous(), w2.t().contiguous()  # nn.Linear's layout
            ms, host, kernels = _call_ms(lambda: fused_mlp(*args), MLP_KERNELS[dtype_name],
                                         f"a {dtype_name} fused_mlp call")
            plain_ms, _ = device_ms(lambda: fused_mlp_plain(*args), iters=20, warmup=2)
            unfused_ms, _ = device_ms(
                lambda: F.linear(F.gelu(F.linear(x, w1t, b1), approximate="tanh"), w2t, b2),
                iters=20, warmup=2)
            flops = 4.0 * m * d * h
            nbytes = x.element_size() * (2 * m * d + 2 * d * h + d + h)
            bound_ms, bound_by = _bound(flops, nbytes, dtype_name)
            timed[(m, d, h), dtype_name] = {
                "ms": ms, "plain_ms": plain_ms, "library_ms": None, "bound_ms": bound_ms,
                "bound_by": bound_by, "max_abs_err": errs[True], "unfused_ms": unfused_ms,
            }
            by_kernel = ", ".join(f"{m.group(0) if (m := KERNEL_NAME.search(k)) else k} {v:.4f}"
                                  for k, v in kernels.items())
            log(f"[kernel] fused_mlp {shape}, device ms: a call {ms:.4f} ({by_kernel}; host "
                f"{host:.4f} per call), plain {plain_ms:.4f} ms, "
                f"unfused F.linear + F.gelu + F.linear (three library calls) {unfused_ms:.4f} "
                f"ms, bound {bound_ms:.4f} ms ({bound_by}; {flops / 1e9:.3f} GFLOP, "
                f"{nbytes / 1e6:.2f} MB)")
    return timed


def _int8_error_bands(y_q, y_exact):
    """The JAX test's measure (tests/test_int8_gemm.py:44-55): |error| over the
    mean |exact|; its median must stay below 0.02 and its mean below 0.05."""
    rel = (y_q - y_exact).abs() / (y_exact.abs().mean() + 1e-6)
    return rel.median().item(), rel.mean().item()


def phase_int8_kernels():
    """`int8_matmul` against `int8_matmul_plain` (bit for bit: the integer sums
    are exact and every float step is one IEEE operation in both), its
    quantization (`quantize_rows`) against `quantize_rows_plain` (bit for
    bit), and the product against the exact one (the JAX test's bands); a call
    timed as the device time of both of its kernels (`INT8_KERNELS`, each
    printed apart) beside its bound, the plain version, the bf16
    `torch.matmul` of the same product (the yardstick the JAX package's study
    compares with) and `torch._int_mm` on the pre-quantized operands (the
    library's int8 product alone): yardsticks only, the port calls neither."""
    import torch

    from ucf_vit_tpu_torch.ops.int8_gemm import (int8_matmul, int8_matmul_plain, int8_plan,
                                                 quantize_rows, quantize_rows_plain,
                                                 quantize_weight)

    gen = torch.Generator(device="cuda").manual_seed(4)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    timed = {}
    for m, k, n in INT8_SHAPES:
        w = 0.02 * torch.randn(k, n, device="cuda", generator=gen)
        w_i8, ws = quantize_weight(w)
        plan = int8_plan(m, k, n, sms)
        log(f"[kernel] int8_matmul [{m},{k}]x[{k},{n}]: plan Kp {plan.kp}, {plan.m_tiles} x "
            f"{plan.n_tiles} tiles of 128 x 256 on {plan.grid} persistent blocks, bf16 y "
            f"stored by route {plan.route}")
        for dtype_name in ("float32", "bfloat16"):
            dtype = getattr(torch, dtype_name)
            x = torch.randn(m, k, device="cuda", generator=gen).to(dtype)
            shape = f"[{m},{k}]x[{k},{n}] x {dtype_name}"
            xq, scale = quantize_rows(x)
            torch.cuda.synchronize()
            want_q, want_scale = quantize_rows_plain(x)
            if not (torch.equal(xq[:, :k], want_q) and torch.equal(scale, want_scale)
                    and not xq[:, k:].any()):
                fail(f"int8_prepare's xq or scale differs from quantize_rows_plain at {shape}")
            for out_dtype in (torch.float32, torch.bfloat16):
                got = int8_matmul(x, w_i8, ws, out_dtype=out_dtype)
                torch.cuda.synchronize()
                want = int8_matmul_plain(x, w_i8, ws, out_dtype)
                if got.dtype != out_dtype or got.shape != (m, n):
                    fail(f"int8_matmul returned {got.dtype} {tuple(got.shape)} at {shape}")
                if not torch.equal(got, want):
                    diff = (got.float() - want.float()).abs().max().item()
                    fail(f"int8_matmul differs from its plain version at {shape} -> "
                         f"{out_dtype}: max |diff| {diff:.3e} (expected bit-equal)")
            y_q = int8_matmul(x, w_i8, ws, out_dtype=torch.float32)
            median, mean = _int8_error_bands(y_q, x.float() @ w)
            log(f"[kernel] int8_matmul {shape}: bit-equal to plain (f32 and bf16 out), the "
                f"quantization to quantize_rows_plain; against the exact product: median "
                f"rel err {median:.4f} (< 0.02), mean {mean:.4f} (< 0.05)")
            if not (median < 0.02 and mean < 0.05):
                fail(f"int8_matmul is outside the quantization error bands at {shape}")
            if dtype_name != "bfloat16":
                continue
            w_bf16 = w.to(torch.bfloat16)
            ms, host, by_kernel = _call_ms(lambda: int8_matmul(x, w_i8, ws), INT8_KERNELS,
                                           "an int8_matmul call")
            split = {name: sum(v for key, v in by_kernel.items() if name in key)
                     for name in INT8_KERNELS}
            if not all(split.values()):
                fail(f"an int8_matmul call launched {by_kernel}, not both of {INT8_KERNELS}")
            plain_ms, _ = device_ms(lambda: int8_matmul_plain(x, w_i8, ws), iters=20, warmup=2)
            matmul_ms, _ = device_ms(lambda: torch.matmul(x, w_bf16), iters=20, warmup=2)
            try:
                int_mm_ms, _ = device_ms(lambda: torch._int_mm(want_q, w_i8), iters=20, warmup=2)
                int_mm = f"{int_mm_ms:.4f} ms"
            except RuntimeError as e:  # printed, not hidden: the yardstick is then missing
                int_mm_ms, int_mm = None, f"refused by this torch build ({e})"
            ops = 2.0 * m * k * n
            nbytes = x.element_size() * (m * k + m * n) + k * n + 4 * n
            bound_ms, bound_by = _bound(ops, nbytes, "int8")
            timed[(m, k, n)] = {
                "ms": ms, "plain_ms": plain_ms, "library_ms": None, "bound_ms": bound_ms,
                "bound_by": bound_by, "max_abs_err": 0.0, "bf16_matmul_ms": matmul_ms,
                "int_mm_ms": int_mm_ms, "prepare_ms": split["int8_prepare"],
                "gemm_ms": split["int8_gemm_kernel"],
            }
            log(f"[kernel] int8_matmul {shape} -> bf16, device ms: a call {ms:.4f} "
                f"(int8_prepare {split['int8_prepare']:.4f} + int8_gemm_kernel "
                f"{split['int8_gemm_kernel']:.4f}; host {host:.4f} per call), plain "
                f"{plain_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}; {ops / 1e9:.3f} GOP, "
                f"{nbytes / 1e6:.2f} MB); yardsticks: bf16 torch.matmul of the same product "
                f"{matmul_ms:.4f} ms (another function: no quantization), torch._int_mm on the "
                f"pre-quantized operands {int_mm} (the integer product alone)")
    return timed


def phase_ops_path():
    """The two ops through their public API, as a user of the package calls
    them (no model or server of either package is wired to them): one
    ViT-B block's projections quantized once and multiplied in int8, and
    its MLP fused, on a batch of 16 x 257 tokens in bf16, then the same MLP
    fused in f32. The launch counts are set to 0 before and read after."""
    import torch
    import torch.nn.functional as F

    from ucf_vit_tpu_torch.ops.fused_mlp import fused_mlp
    from ucf_vit_tpu_torch.ops.int8_gemm import int8_matmul, int8_matmul_plain, quantize_weight

    from ucf_vit_tpu_torch.ops.fused_mlp import reset_launch_counts

    gen = torch.Generator(device="cuda").manual_seed(5)
    m, d, h = RECORD_MLP
    x, w1, b1, w2, b2 = _mlp_inputs(m, d, h, torch.bfloat16, gen)
    projections = {"qkv": (d, 3 * d), "proj": (d, d), "fc1": (d, h), "fc2": (h, d)}
    weights = {name: 0.02 * torch.randn(*shape, device="cuda", generator=gen)
               for name, shape in projections.items()}
    hidden = torch.randn(m, h, device="cuda", generator=gen).to(torch.bfloat16)
    f32_args = _mlp_inputs(m, d, h, torch.float32, gen)

    reset_launch_counts()
    int8_matmul.launches = 0
    y = fused_mlp(x, w1, b1, w2, b2)
    quantized = {name: quantize_weight(w) for name, w in weights.items()}  # once, offline
    outs = {name: int8_matmul(hidden if name == "fc2" else x, *quantized[name])
            for name in projections}
    torch.cuda.synchronize()
    counts = {"fused_mlp": fused_mlp.launches, "int8_matmul": int8_matmul.launches}
    mlp_by = (dict(fused_mlp.by_source), dict(fused_mlp.by_layout))
    y32 = fused_mlp(*f32_args)
    torch.cuda.synchronize()
    counts["fused_mlp_f32"] = fused_mlp.launches - counts["fused_mlp"]
    f32_by = {s: n - mlp_by[0][s] for s, n in fused_mlp.by_source.items()}

    want = F.linear(F.gelu(F.linear(x, w1.t(), b1), approximate="tanh"), w2.t(), b2)
    mlp_err = (y.float() - want.float()).abs().max().item()
    x32, w1_32, b1_32, w2_32, b2_32 = f32_args
    want32 = F.linear(F.gelu(F.linear(x32, w1_32.t(), b1_32), approximate="tanh"), w2_32.t(),
                      b2_32)
    f32_err = (y32 - want32).abs().max().item()
    ok = y.shape == (m, d) and y.dtype == torch.bfloat16 and bool(torch.isfinite(y).all())
    ok = ok and y32.shape == (m, d) and y32.dtype == torch.float32 \
        and bool(torch.isfinite(y32).all())
    worst, unequal = 0.0, []
    for name, out in outs.items():
        inp = hidden if name == "fc2" else x
        median, mean = _int8_error_bands(out.float(), inp.float() @ weights[name])
        worst = max(worst, median)
        ok = ok and out.shape == (m, projections[name][1]) and out.dtype == torch.bfloat16 \
            and bool(torch.isfinite(out).all()) and median < 0.02 and mean < 0.05
        # the kernels are bit-equal to their plain version by design, at every shape
        if not torch.equal(out, int8_matmul_plain(inp, *quantized[name])):
            unequal.append(name)
    log(f"[ops] public API on [{m}, {d}] bf16 tokens (the ops are on no model path, in either "
        f"package): fused_mlp against the unfused bf16 modules max |diff| {mlp_err:.3e} (tol "
        f"3e-2: the modules round the pre-activation to bf16, the op keeps it f32); in f32 "
        f"against the unfused f32 modules (TF32 off) {f32_err:.3e} (tol "
        f"{MLP_TOL['float32']:g}); int8_matmul on qkv, proj, fc1, fc2: worst median rel err "
        f"{worst:.4f}, bit-equal to int8_matmul_plain but on {unequal or 'none'}; launches "
        f"{counts}; fused_mlp by source {mlp_by[0]} (bf16), {f32_by} (f32), by route "
        f"{mlp_by[1]}")
    if not ok or mlp_err > 3e-2 or not f32_err <= MLP_TOL["float32"]:
        fail("the ops' public API gave a wrong result")
    if unequal:
        fail(f"int8_matmul differs from int8_matmul_plain on {unequal} (expected bit-equal)")
    if counts != {"fused_mlp": 1, "int8_matmul": len(projections), "fused_mlp_f32": 1}:
        fail(f"launch counts {counts}, expected 1 fused_mlp in each type and "
             f"{len(projections)} int8_matmul")
    if mlp_by != ({"fused_mlp_sm90": 1, "fused_mlp_tf32": 0}, {"tma": 1, "padded": 0}):
        fail(f"bf16 fused_mlp at {RECORD_MLP} went by {mlp_by}, expected fused_mlp_sm90 on "
             f"the tma route")
    if f32_by != {"fused_mlp_sm90": 0, "fused_mlp_tf32": 1}:
        fail(f"f32 fused_mlp at {RECORD_MLP} went by {f32_by}, expected fused_mlp_tf32")
    return counts


def _launch_counts() -> dict:
    from ucf_vit_tpu_torch.ops.attn_dropout import keep_mask
    from ucf_vit_tpu_torch.ops.flash_attention import flash_attention, flash_attention_bwd

    counts = {"flash_fwd": flash_attention.launches, "keep_mask": keep_mask.launches}
    counts.update({f"flash_bwd_{k}": n for k, n in flash_attention_bwd.by_kernel.items()})
    # and by source: the tf32 sources (f32) or the sm90 ones (bf16)
    counts.update({f"src:{s}": n for s, n in flash_attention.by_source.items()})
    counts.update({f"src:{s}": n for s, n in flash_attention_bwd.by_source.items()})
    # the bf16 forward's route: "tma" (q, k, v loaded as they are) or "padded" (copied first)
    counts.update({f"route:{r}": n for r, n in flash_attention.by_layout.items()})
    return counts


def _train_cfg(cfg, impl: str, **init_args):
    """The config with attention forced to `impl` (and init_args overridden)."""
    from ucf_vit_tpu_torch.config import Config

    raw = copy.deepcopy(cfg.raw)
    raw["trainer"]["attn_impl"] = impl
    raw["model"]["net"]["init_args"].update(init_args)
    return Config(raw=raw, task=cfg.task)


def _run_steps(cfg, batches, var_ids=None):
    """One train step per batch on the card from the seeded init (seed 0):
    (state, step, per-step losses, first-step gradients by name, the launch
    counts of these steps). `var_ids`: the batches' variables (`use_varemb`)."""
    import torch

    from ucf_vit_tpu_torch.ops.flash_attention import reset_launch_counts
    from ucf_vit_tpu_torch.train import init_train, to_device

    state, step = init_train(cfg, "cuda")
    reset_launch_counts()
    losses, grads = [], None
    for i, batch in enumerate(batches):
        state, loss, _ = step(state, to_device(batch, torch.device("cuda")), var_ids)
        losses.append(loss.item())
        if i == 0:
            # (an adaptive model's position table has no gradient where its MLP replaces it)
            grads = {n: p.grad.detach().clone() for n, p in state.model.named_parameters()
                     if p.grad is not None}
    return state, step, losses, grads, _launch_counts()


# (Nq, Nkv, dh) of the attention of ViT-B/16 and ViT-L/16 as shipped: 256 patches of a
# 256 x 256 image and the cls token, dh 64
VIT_ATTN = (257, 257, 64)


def _attn_shapes(model) -> list:
    """(Nq, Nkv, dh) of each attention block's flash call in `model` (a VIT;
    an MAE: its encoder on the kept tokens, then its decoder on all; a
    DiffusionVIT: its encoder, then its decoder, both on every token)."""
    from ucf_vit_tpu_torch.models import MAE, DiffusionVIT

    def shapes(blocks, n):
        return [(n, n, blk.attn.head_dim) for blk in blocks]

    if isinstance(model, MAE):
        return (shapes(model.blocks, model.len_keep)
                + shapes(model.decoder_blocks, model.num_patches))
    if isinstance(model, DiffusionVIT):
        return (shapes(model.blocks, model.num_patches)
                + shapes(model.decoder_blocks or [], model.num_patches))
    return shapes(model.blocks, model.num_patches + model.num_prefix_tokens)


def _expected_counts(shapes: list, steps: int, dropout: bool, bf16: bool = False,
                     forwards_per_step: int = 1) -> dict:
    """The launch counts of `steps` train steps of a model whose attention
    blocks take these (Nq, Nkv, dh): `forwards_per_step` flash forwards (2
    under remat) and one backward per block, on the route `bwd_route` gives
    its shape (the fused kernel, or dkv and dq), each counted under the source
    of its dtype: f32 under the tf32 sources, bf16 under the sm90 ones, every
    bf16 forward on the sm90 forward's TMA route."""
    import torch

    from ucf_vit_tpu_torch.ops.flash_attention import bwd_route

    dtype = torch.bfloat16 if bf16 else torch.float32
    bwd = {"fused": 0, "dkv": 0, "dq": 0}
    for shape in shapes:
        for kind in ("fused",) if bwd_route(dtype, *shape) == "fused" else ("dkv", "dq"):
            bwd[kind] += steps
    counts = {"flash_fwd": forwards_per_step * len(shapes) * steps,
              **{f"flash_bwd_{k}": c for k, c in bwd.items()}}
    counts["keep_mask"] = counts["flash_fwd"] + sum(bwd.values()) if dropout else 0
    counts.update({
        "src:flash_fwd_tf32": 0 if bf16 else counts["flash_fwd"],
        "src:flash_fwd_sm90": counts["flash_fwd"] if bf16 else 0,
        "src:flash_bwd_tf32": 0 if bf16 else sum(bwd.values()),
        "src:flash_bwd_sm90": sum(bwd.values()) if bf16 else 0,
        # every bf16 forward of a model path on the TMA route, none copied
        "route:tma": counts["flash_fwd"] if bf16 else 0, "route:padded": 0,
    })
    return counts


def _window(state, step, batches, var_ids=None) -> float:
    """Wall seconds of one train step per batch, with the host->device copy of
    each batch and the trainer's one-step-lagged loss read inside."""
    import torch

    from ucf_vit_tpu_torch.train import to_device

    dev = torch.device("cuda")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    pending = None
    for b in batches:
        state, loss, _ = step(state, to_device(b, dev), var_ids)
        if pending is not None:
            pending.item()  # the trainer's one-step-lagged loss read
        pending = loss
    pending.item()
    torch.cuda.synchronize()
    return time.perf_counter() - t0


def _measure_steps(tag, label, state, step, warmup, timed, traced=None, top=12,
                   var_ids=None) -> dict:
    """A warm-up, an untraced window (ms/step, images/s, peak memory) and, with
    `traced`, a window traced on the card (device activity only): the busy
    share and the device time by kernel. Each argument is a list of batches."""
    import torch

    _window(state, step, warmup, var_ids)
    torch.cuda.reset_peak_memory_stats()
    wall = _window(state, step, timed, var_ids)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    n, batch = len(timed), len(timed[0]["x"])
    out = {"ms_step": 1e3 * wall / n, "images_s": batch * n / wall, "peak_gb": peak_gb}
    log(f"[{tag}] {label}: {n} steps in {wall:.4f} s = {out['ms_step']:.3f} ms/step, "
        f"{out['images_s']:.2f} images/s; peak memory {peak_gb:.2f} GB")
    if traced is None:
        return out
    prof = torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA])
    prof.start()
    traced_s = _window(state, step, traced, var_ids)
    prof.stop()
    kernels = sorted(((e.self_device_time_total, e.count, e.key) for e in prof.key_averages()
                      if e.self_device_time_total > 0), reverse=True)
    busy_ms = sum(k[0] for k in kernels) / 1e3
    if busy_ms <= 0:
        fail(f"the traced {label} window saw no work on the card")
    out.update(busy_share=busy_ms / (1e3 * traced_s), kernels=kernels, busy_ms=busy_ms,
               traced_steps=len(traced))
    log(f"[{tag}] traced window: {len(traced)} steps in {traced_s:.4f} s, device busy "
        f"{busy_ms:.3f} ms = {100 * out['busy_share']:.2f}%")
    for t_us, count, key in kernels[:top]:
        log(f"[{tag}]   {t_us / 1e3:9.3f} ms {100 * t_us / 1e3 / busy_ms:6.2f}% "
            f"x{count:<5d} {key[:90]}")
    return out


def phase_train():
    import numpy as np

    from ucf_vit_tpu_torch.config import Config, load_config
    from ucf_vit_tpu_torch.ops.flash_attention import reset_launch_counts
    from ucf_vit_tpu_torch.train import synthetic_batches, train

    cfg = load_config(CONFIG)
    depth = int(cfg.init_args["depth"])
    stream = synthetic_batches(cfg, TRAIN_BATCH, seed=0)
    batches = [next(stream) for _ in range(WARMUP_STEPS + 2 * TIMED_STEPS)]

    # FLASH (the kernels) against EINSUM (plain autograd), one init and batch stream
    runs = {}
    for impl in ("FLASH", "EINSUM"):
        t0 = time.perf_counter()
        state, step, losses, grads, counts = _run_steps(_train_cfg(cfg, impl),
                                                        batches[:TRAIN_STEPS])
        runs[impl] = (losses, grads, counts)
        log(f"[train] {impl}: {TRAIN_STEPS} steps in {time.perf_counter() - t0:.2f} s "
            f"(init included); losses {' '.join(f'{x:.6f}' for x in losses)}; launches {counts}")
        if impl == "FLASH":
            flash_state, flash_step = state, step
        del state, step
    (lf, gf, cf), (le, ge, ce) = runs["FLASH"], runs["EINSUM"]
    loss_diff = max(abs(a - b) for a, b in zip(lf, le))
    gmax = max(g.abs().max().item() for g in ge.values())
    gdiff = max((gf[n] - ge[n]).abs().max().item() for n in ge)
    log(f"[train] FLASH vs EINSUM: max per-step |loss diff| {loss_diff:.3e} (tol "
        f"{TRAIN_LOSS_TOL:g}); first-step gradients max |diff| {gdiff:.3e} = "
        f"{gdiff / gmax:.3e} of the largest entry {gmax:.3e} (tol {TRAIN_GRAD_TOL:g})")
    if not all(np.isfinite(lf)) or loss_diff > TRAIN_LOSS_TOL:
        fail("FLASH training losses disagree with EINSUM's")
    if gdiff > TRAIN_GRAD_TOL * gmax:
        fail("FLASH first-step gradients disagree with EINSUM's")
    for i in range(depth):
        g = gf.get(f"blocks.{i}.attn.qkv.weight")
        if g is None or g.abs().max().item() == 0:
            fail(f"blocks.{i}.attn.qkv.weight has no gradient under FLASH")
    want = _expected_counts([VIT_ATTN] * depth, TRAIN_STEPS, dropout=False)
    if cf != want or any(ce.values()):
        fail(f"launches {cf} under FLASH (expected {want}), {ce} under EINSUM (expected none)")

    # the step's time: a warm-up, an untraced window and a window traced on the card
    ms_step = _measure_steps(
        "train", f"ViT-B/16 f32 batch {TRAIN_BATCH}, FLASH", flash_state, flash_step,
        batches[:WARMUP_STEPS], batches[WARMUP_STEPS:WARMUP_STEPS + TIMED_STEPS],
        batches[WARMUP_STEPS + TIMED_STEPS:])["ms_step"]
    del flash_state, flash_step

    # the dropout path: attn_drop_rate 0.1, the same hash mask on both sides
    drop = {}
    for impl in ("FLASH", "EINSUM"):
        _, _, losses, _, counts = _run_steps(_train_cfg(cfg, impl, attn_drop_rate=0.1),
                                             batches[:DROPOUT_STEPS])
        drop[impl] = (losses, counts)
    (dlf, dcf), (dle, _) = drop["FLASH"], drop["EINSUM"]
    drop_diff = max(abs(a - b) for a, b in zip(dlf, dle))
    log(f"[train] attn_drop_rate 0.1, full depth, {DROPOUT_STEPS} steps: FLASH losses "
        f"{' '.join(f'{x:.6f}' for x in dlf)}, EINSUM {' '.join(f'{x:.6f}' for x in dle)}; "
        f"max |diff| {drop_diff:.3e} (tol {TRAIN_LOSS_TOL:g}); without dropout the first "
        f"loss was {lf[0]:.6f}; launches {dcf}")
    if not all(np.isfinite(dlf)) or drop_diff > TRAIN_LOSS_TOL:
        fail("FLASH training losses with dropout disagree with EINSUM's")
    if abs(dlf[0] - lf[0]) < 1e-5:
        fail("attention dropout changed nothing")
    want = _expected_counts([VIT_ATTN] * depth, DROPOUT_STEPS, dropout=True)
    if dcf != want:
        fail(f"launches {dcf} on the dropout path, expected {want}")

    # the main path: train() as the CLI runs it, two epochs, each saved at its end to its
    # even/odd slot under a temporary directory, which phase_serve serves. In memory: the
    # epoch's length, and the warm-up cut to 0 so that the two slots' weights differ
    # enough for the served answers to tell them apart
    ckpt_dir = tempfile.mkdtemp(prefix="vit_b_", dir=WORK)
    raw = copy.deepcopy(cfg.raw)
    raw["trainer"].update(checkpoint_path=ckpt_dir, max_epochs=2)
    raw["model"]["warmup_steps"] = 0
    raw["load_balancing"] = {"batches_per_rank_epoch": {"catsdogs": MAIN_PATH_STEPS // 2}}
    reset_launch_counts()
    t0 = time.perf_counter()
    with _Tee() as tee:
        out = train(Config(raw=raw, task=cfg.task), max_steps=MAIN_PATH_STEPS, synthetic=True,
                    device="cuda")
    main_counts = _launch_counts()
    log(f"[train] train() {MAIN_PATH_STEPS} steps in {time.perf_counter() - t0:.2f} s (init "
        f"and saves included): epoch losses {out['loss_list']}; launches {main_counts}")
    want = _expected_counts([VIT_ATTN] * depth, MAIN_PATH_STEPS, dropout=False)
    if main_counts != want or not all(np.isfinite(out["loss_list"])):
        fail(f"train() launched {main_counts} (expected {want}), losses {out['loss_list']}")
    saves = _saves(tee.text(), ckpt_dir, ("multi_last_even.ckpt", "multi_last_odd.ckpt"))
    log(f"[train] checkpoint saves: {', '.join(f'epoch {e} {secs:.3f} s' for e, secs in saves)}"
        f" ({os.path.getsize(os.path.join(ckpt_dir, 'multi_last_odd.ckpt')) / 1e6:.1f} MB)")
    del out
    return {"main": main_counts, "dropout": dcf, "ms_step": ms_step, "ckpt_dir": ckpt_dir}


class _Tee:
    """Within `with _Tee() as tee:`, what is printed goes on to standard output
    and is kept (`tee.text()`), so that the trainer's log lines can be read."""

    def __enter__(self):
        self._kept, self._out = io.StringIO(), sys.stdout
        self._redirect = contextlib.redirect_stdout(self)
        self._redirect.__enter__()
        return self

    def __exit__(self, *exc):
        return self._redirect.__exit__(*exc)

    def write(self, s):
        self._kept.write(s)
        return self._out.write(s)

    def flush(self):
        self._out.flush()

    def text(self) -> str:
        return self._kept.getvalue()


def _saves(text: str, ckpt_dir: str, slots) -> list:
    """(epoch, seconds) of each checkpoint save the trainer logged; fails unless
    exactly `slots` were written under `ckpt_dir` and `_latest` picks the newest."""
    from ucf_vit_tpu_torch.checkpoint import resolve_slot, stored_epoch

    saves = [(int(e), float(secs)) for e, _, secs in
             re.findall(r"epoch (\d+): saved (\S+) in ([\d.]+) s", text)]
    if tuple(sorted(os.listdir(ckpt_dir))) != tuple(slots) or not saves:
        fail(f"checkpoints {sorted(os.listdir(ckpt_dir))} under {ckpt_dir} (expected {slots}),"
             f" saves logged {saves}")
    latest = resolve_slot(ckpt_dir, "multi_last_latest")
    if stored_epoch(latest) != saves[-1][0] or not latest.endswith(
            ("_even.ckpt", "_odd.ckpt")[saves[-1][0] % 2]):
        fail(f"_latest resolved to {latest} (epoch {stored_epoch(latest)}), the last save "
             f"was epoch {saves[-1][0]}")
    return saves


def _kernel_groups(kernels, busy_ms: float) -> str:
    """Device time of a traced window by kind of kernel, from the kernels' names."""
    groups = {"GEMMs (cuBLAS/CUTLASS)": 0.0, "flash_fwd_sm90_kernel": 0.0,
              "flash_bwd_sm90_kernel": 0.0, "flash_bwd_dq_sm90_kernel": 0.0,
              "flash_fwd_tf32_kernel": 0.0, "flash_bwd_tf32_kernel": 0.0,
              "flash_bwd_dq_tf32_kernel": 0.0, "AdamW (multi-tensor)": 0.0,
              "other (LayerNorm, GELU, casts, adds, copies)": 0.0}
    for t_us, _, key in kernels:
        name = key.lower()
        flash = [g for g in groups if g.startswith("flash") and g in name]
        if flash:
            group = flash[0]
        elif any(w in name for w in ("gemm", "cutlass", "xmma", "nvjet", "cublas", "wgmma")):
            group = "GEMMs (cuBLAS/CUTLASS)"
        elif "multi_tensor" in name or "adam" in name:
            group = "AdamW (multi-tensor)"
        else:
            group = "other (LayerNorm, GELU, casts, adds, copies)"
        groups[group] += t_us / 1e3
    return "; ".join(f"{g} {ms:.3f} ms = {100 * ms / busy_ms:.2f}%" for g, ms in groups.items())


def phase_train_bf16():
    """The bf16 compute policy on the card: ViT-B/16 FLASH against EINSUM, then
    ViT-L/16 with remat through the trainer's CLI entry, timed and traced,
    and a window with remat off."""
    import numpy as np
    import torch

    from ucf_vit_tpu_torch.config import Config, load_config
    from ucf_vit_tpu_torch.ops.flash_attention import reset_launch_counts
    from ucf_vit_tpu_torch.train import init_train, main as train_main, synthetic_batches

    # (a) ViT-B/16, bf16 set in memory, FLASH against EINSUM from one init and batch stream
    raw = copy.deepcopy(load_config(CONFIG).raw)
    raw["trainer"]["data_type"] = "bfloat16"
    cfg = Config(raw=raw, task="classification")
    depth = int(cfg.init_args["depth"])
    stream = synthetic_batches(cfg, TRAIN_BATCH, seed=0)
    batches = [next(stream) for _ in range(TRAIN_STEPS)]
    runs = {}
    for impl in ("FLASH", "EINSUM"):
        state, _, losses, grads, counts = _run_steps(_train_cfg(cfg, impl), batches)
        if state.model.dtype != torch.bfloat16 or \
                any(p.dtype != torch.float32 for p in state.model.parameters()) or \
                any(g.dtype != torch.float32 for g in grads.values()):
            fail("the bf16 policy must keep f32 parameters and f32 gradients")
        runs[impl] = (losses, counts)
        log(f"[bf16] ViT-B/16 {impl}: losses {' '.join(f'{x:.6f}' for x in losses)}; "
            f"launches {counts}")
        del state, grads
    (lf, cf), (le, ce) = runs["FLASH"], runs["EINSUM"]
    loss_diff = max(abs(a - b) for a, b in zip(lf, le))
    log(f"[bf16] ViT-B/16 FLASH vs EINSUM: max per-step |loss diff| {loss_diff:.3e} (tol "
        f"{BF16_TRAIN_LOSS_TOL:g})")
    if not all(np.isfinite(lf)) or loss_diff > BF16_TRAIN_LOSS_TOL:
        fail("bf16 FLASH training losses disagree with EINSUM's")
    want = _expected_counts([VIT_ATTN] * depth, TRAIN_STEPS, dropout=False, bf16=True)
    if cf != want or any(ce.values()):
        fail(f"bf16 launches {cf} under FLASH (expected {want}), {ce} under EINSUM")

    # (b) ViT-L/16 as shipped (bf16, remat, scan_layers, accum_steps 4, batch 32) on one
    # device: the CLI's entry, with every launch count set to 0 before it and read after
    # (a copy that saves nothing: its 1.2 GB checkpoint took 8.5 s and nothing read it)
    argv = [_parallel_config("vit_l_main", VIT_L_CONFIG, {}), "--synthetic", "--single-device",
            "--max-steps", str(VIT_L_MAIN_STEPS)]
    reset_launch_counts()
    t0 = time.perf_counter()
    out = train_main(argv)
    main_counts = _launch_counts()
    model = out["state"].model
    depth_l, accum = len(model.blocks), 4
    log(f"[bf16] ViT-L/16 python -m ucf_vit_tpu_torch.train {' '.join(argv[1:])}: "
        f"{time.perf_counter() - t0:.2f} s (init included); epoch losses {out['loss_list']}; "
        f"launches {main_counts}")
    # under remat each block's forward runs twice per microbatch; every launch is bf16, so
    # every one goes to the tensor-core kernels
    want = _expected_counts(_attn_shapes(model), accum * VIT_L_MAIN_STEPS, dropout=False,
                            bf16=True, forwards_per_step=2)
    if main_counts != want or not all(np.isfinite(out["loss_list"])):
        fail(f"ViT-L train launched {main_counts} (expected {want}), losses {out['loss_list']}")
    per_step = {k: n // VIT_L_MAIN_STEPS for k, n in main_counts.items() if n}
    log(f"[bf16] ViT-L/16 launches a step: {per_step}")
    if not (model.remat and model.dtype == torch.bfloat16 and model.embed_dim == 1024
            and depth_l == 24 and all(p.dtype == torch.float32 for p in model.parameters())):
        fail("the ViT-L run was not ViT-L/16 in bf16 with remat on f32 parameters")
    del out, model

    cfg_l = _single_device(VIT_L_CONFIG)
    batch = cfg_l.batch_size
    stream = synthetic_batches(cfg_l, batch, seed=0)
    batches = [next(stream) for _ in range(VIT_L_WARMUP_STEPS + 2 * VIT_L_TIMED_STEPS)]
    state, step = init_train(cfg_l, "cuda")
    w, t = VIT_L_WARMUP_STEPS, VIT_L_TIMED_STEPS
    remat = _measure_steps("bf16", f"ViT-L/16 bf16 batch {batch} (4 x 8), remat", state, step,
                           batches[:w], batches[w:w + t], batches[w + t:], top=14)
    log(f"[bf16] device time by kind: {_kernel_groups(remat['kernels'], remat['busy_ms'])}")
    del state, step

    # (c) the same with remat off, for what remat costs in time and saves in memory
    raw = copy.deepcopy(cfg_l.raw)
    raw["trainer"]["remat"] = False
    state, step = init_train(Config(raw=raw, task=cfg_l.task), "cuda")
    reset_launch_counts()
    plain = _measure_steps("bf16", f"ViT-L/16 bf16 batch {batch} (4 x 8), remat off", state,
                           step, batches[:w], batches[w:w + VIT_L_NO_REMAT_STEPS])
    counts = _launch_counts()
    want = _expected_counts([VIT_ATTN] * depth_l, accum * (w + VIT_L_NO_REMAT_STEPS),
                            dropout=False, bf16=True)
    if counts != want:
        fail(f"remat off launched {counts}, expected {want}")
    del state, step
    log(f"[bf16] remat on ViT-L/16: {remat['ms_step']:.3f} ms/step against "
        f"{plain['ms_step']:.3f} without ({remat['ms_step'] / plain['ms_step']:.3f}x); peak "
        f"memory {remat['peak_gb']:.2f} GB against {plain['peak_gb']:.2f} GB")
    return {"main": main_counts, "ms_step": remat["ms_step"]}


def _flash_per_step(kernels, steps: int) -> str:
    """Device ms a step of each flash kernel instance in a traced window."""
    lines = []
    for t_us, count, key in kernels:
        if m := re.search(r"(flash_\w+_kernel)<(\d+)", key):
            lines.append(f"{m.group(1)}<DH={m.group(2)}> {t_us / 1e3 / steps:.3f} ms "
                         f"({count // steps} launches)")
    return "; ".join(lines)


def phase_train_mae():
    """MAE pretraining at configs/basic_ct/mae_long (embed 768, depth 12, 12
    heads; decoder 576 wide, depth 8, 6 heads; a 128^3 tile at patch 4, so
    32768 patches, 8192 kept; bf16 compute on f32 parameters, remat, batch
    2, maskMSE) on one device: the trainer's CLI entry with `--single-device`,
    the launch counts set to 0 before it and read after (every bf16 forward
    on the TMA route); a timed and a traced window; the loss falling on one
    fixed batch; and FLASH against EINSUM on a copy of depth 1 (decoder depth
    1) with a 64^3 tile, every width as shipped: EINSUM's score matrix at
    32768 tokens (52 GB in f32 for one decoder block) does not fit."""
    import numpy as np
    import torch

    from ucf_vit_tpu_torch.config import Config
    from ucf_vit_tpu_torch.models import MAE
    from ucf_vit_tpu_torch.ops.flash_attention import reset_launch_counts
    from ucf_vit_tpu_torch.train import init_train, main as train_main, synthetic_batches

    torch.cuda.empty_cache()
    # (a) the main path: the CLI entry as a user runs it
    argv = [MAE_CONFIG, "--synthetic", "--single-device", "--max-steps", str(MAE_MAIN_STEPS)]
    reset_launch_counts()
    t0 = time.perf_counter()
    out = train_main(argv)
    main_counts = _launch_counts()
    model = out["state"].model
    enc, dec = len(model.blocks), len(model.decoder_blocks)
    log(f"[mae] python -m ucf_vit_tpu_torch.train {' '.join(argv[1:])}: "
        f"{time.perf_counter() - t0:.2f} s (init included); epoch losses {out['loss_list']}; "
        f"launches {main_counts}")
    if not (isinstance(model, MAE) and model.embed_dim == 768 and enc == 12
            and model.decoder_embed_dim == 576 and dec == 8
            and model.blocks[0].attn.num_heads == 12
            and model.decoder_blocks[0].attn.num_heads == 6 and model.num_patches == 32768
            and model.len_keep == 8192 and model.remat and model.dtype == torch.bfloat16
            and all(p.dtype == torch.float32 for p in model.parameters())):
        fail("the MAE run was not mae_long at full width and depth, bf16 with remat on f32 "
             "parameters")
    # under remat each block's forward runs twice a step, the decoder's as the encoder's
    want = _expected_counts(_attn_shapes(model), MAE_MAIN_STEPS, dropout=False, bf16=True,
                            forwards_per_step=2)
    if main_counts != want or not all(np.isfinite(out["loss_list"])):
        fail(f"mae_long train launched {main_counts} (expected {want}), losses "
             f"{out['loss_list']}")
    log(f"[mae] launches a step: "
        f"{ {k: n // MAE_MAIN_STEPS for k, n in main_counts.items() if n} }")
    del out, model

    # (b) the step's time: a warm-up, an untraced window and a traced one
    cfg = _single_device(MAE_CONFIG)
    batch = cfg.batch_size
    stream = synthetic_batches(cfg, batch, seed=0)
    w, t = MAE_WARMUP_STEPS, MAE_TIMED_STEPS
    batches = [next(stream) for _ in range(w + 2 * t)]
    state, step = init_train(cfg, "cuda")
    res = _measure_steps("mae", f"mae_long bf16 batch {batch}, remat", state, step,
                         batches[:w], batches[w:w + t], batches[w + t:], top=14)
    device_step = res["busy_ms"] / res["traced_steps"]
    log(f"[mae] device time a step {device_step:.3f} ms; by kind: "
        f"{_kernel_groups(res['kernels'], res['busy_ms'])}")
    log(f"[mae] flash kernels a step: {_flash_per_step(res['kernels'], res['traced_steps'])}")
    del state, step

    # (c) the loss falls on one fixed batch (a smooth volume with a mean, which the
    # model can learn) with the warm-up cut to 0 in memory, the masks still drawn afresh
    raw = copy.deepcopy(cfg.raw)
    raw["model"]["warmup_steps"] = 0
    state, step = init_train(Config(raw=raw, task=cfg.task), "cuda")
    h, w, d = (torch.arange(n, device="cuda", dtype=torch.float32) * (2 * np.pi / 64)
               for n in cfg.tile_size[:3])
    x = 1.0 + 0.5 * (torch.sin(h)[:, None, None] * torch.cos(w)[None, :, None]
                     + torch.sin(d)[None, None, :])
    fixed = {"x": x.expand(batch, 1, -1, -1, -1).contiguous()}
    losses = []
    for _ in range(MAE_FALL_STEPS):
        state, loss, _ = step(state, fixed)
        losses.append(loss.item())
    log(f"[mae] one fixed batch, warm-up 0: losses {' '.join(f'{x:.6f}' for x in losses)}")
    if not all(np.isfinite(losses)) or not losses[-1] < 0.9 * losses[0]:
        fail(f"the mae_long loss did not fall on a fixed batch: {losses}")
    del state, step, fixed

    # (d) FLASH (the kernels) against EINSUM (plain autograd) from one init, one batch
    # stream and one mask stream, on the depth-1 copy at a 64^3 tile (4096 patches: a
    # 1024-token encoder at dh 64 and a 4096-token decoder at dh 96)
    small = {"depth": 1, "decoder_depth": 1, "tile_size": [MAE_CHECK_TILE] * 3}
    stream = synthetic_batches(_train_cfg(cfg, "FLASH", **small), batch, seed=0)
    check = [next(stream) for _ in range(MAE_CHECK_STEPS)]
    runs = {}
    for impl in ("FLASH", "EINSUM"):
        st, _, losses, grads, counts = _run_steps(_train_cfg(cfg, impl, **small), check)
        runs[impl] = (losses, grads, counts)
        log(f"[mae] depth 1, tile {MAE_CHECK_TILE}^3, {impl}: losses "
            f"{' '.join(f'{x:.6f}' for x in losses)}; launches {counts}")
        shapes = _attn_shapes(st.model)
        del st
    (lf, gf, cf), (le, ge, ce) = runs["FLASH"], runs["EINSUM"]
    diff = max(abs(a - b) for a, b in zip(lf, le))
    rel = {n: ((gf[n] - g).abs().max() / g.abs().max()).item() for n, g in ge.items()}
    worst = max(rel, key=rel.get)
    log(f"[mae] FLASH vs EINSUM: max per-step |loss diff| {diff:.3e} (tol "
        f"{MAE_CHECK_LOSS_TOL:g}); first-step gradients, max|g_flash-g_einsum|/max|g_einsum|: "
        f"{'; '.join(f'{n} {rel[n]:.3e}' for n in MAE_ATTN_LEAVES)}; the largest of "
        f"{len(rel)} leaves {rel[worst]:.3e} ({worst}) (tol {MAE_CHECK_GRAD_TOL:g})")
    if not all(np.isfinite(lf)) or diff > MAE_CHECK_LOSS_TOL:
        fail("mae_long FLASH training losses disagree with EINSUM's")
    if not all(ge[n].abs().max() > 0 for n in MAE_ATTN_LEAVES) \
            or not rel[worst] <= MAE_CHECK_GRAD_TOL:
        fail("mae_long FLASH first-step gradients disagree with EINSUM's")
    want = _expected_counts(shapes, MAE_CHECK_STEPS, dropout=False, bf16=True,
                            forwards_per_step=2)
    if cf != want or any(ce.values()):
        fail(f"MAE launches {cf} under FLASH (expected {want}), {ce} under EINSUM")
    return {"main": main_counts, "ms_step": res["ms_step"], "device_step_ms": device_step,
            "peak_gb": res["peak_gb"]}


def _ct_volume(rng, shape) -> "np.ndarray":
    """A smooth CT-like int16 volume in Hounsfield units: air (-1000) around an
    elliptic body of soft tissue with a slow texture, plus noise."""
    import numpy as np

    x, y, z = (np.linspace(-1, 1, n, dtype=np.float32) for n in shape)
    x, y, z = x[:, None, None], y[None, :, None], z[None, None, :]
    a, b = rng.uniform(0.6, 0.9, 2)
    f, ph = rng.uniform(2, 6, 3).astype(np.float32), rng.uniform(0, 6.28, 3).astype(np.float32)
    tissue = (40 + 60 * np.sin(f[0] * x + ph[0]) * np.cos(f[1] * y + ph[1])
              + 30 * np.sin(f[2] * z + ph[2]))
    vol = np.where((x / a) ** 2 + (y / b) ** 2 < 1, tissue, np.float32(-1000))
    vol += rng.normal(0, 10, size=shape).astype(np.float32)
    return vol.astype(np.int16)


def _write_volumes(root: str, n: int, shape, seed: int) -> float:
    """`n` volumes as <root>/imagesTr/image{i}.nii; returns the seconds taken."""
    import numpy as np

    from ucf_vit_tpu_torch.data import nifti

    t0 = time.perf_counter()
    os.makedirs(os.path.join(root, "imagesTr"))
    rng = np.random.default_rng(seed)
    for i in range(n):
        nifti.save(os.path.join(root, "imagesTr", f"image{i}.nii"), _ct_volume(rng, shape))
    return time.perf_counter() - t0


def _disk_config(work: str, name: str, ct_root: str, epochs: int, model=None,
                 **trainer) -> str:
    """A copy of configs/basic_ct/mae_long/base_config.yaml in which only
    data.dict_root_dirs, trainer.checkpoint_path and trainer.max_epochs change (and
    the `model` and `trainer` keys given here); returns its path."""
    import yaml

    raw = yaml.safe_load(open(MAE_CONFIG))
    raw["data"]["dict_root_dirs"] = {"ct1": ct_root}
    raw["trainer"].update({"checkpoint_path": os.path.join(work, f"ck_{name}"),
                           "max_epochs": epochs, **trainer})
    raw["model"].update(model or {})
    path = os.path.join(work, f"{name}.yaml")
    with open(path, "w") as f:
        yaml.safe_dump(raw, f)
    return path


def _disk_window(state, step, it, n: int):
    """(wall seconds, seconds spent waiting for batches) of `n` train steps on
    batches pulled from the loader `it` inside the window, with the trainer's
    host->device copy and one-step-lagged loss read."""
    import torch

    from ucf_vit_tpu_torch.train import to_device

    dev = next(state.model.parameters()).device
    torch.cuda.synchronize()
    t0, waited, pending = time.perf_counter(), 0.0, None
    for _ in range(n):
        t1 = time.perf_counter()
        batch = next(it)
        waited += time.perf_counter() - t1
        state, loss, _ = step(state, to_device(batch, dev))
        if pending is not None:
            pending.item()
        pending = loss
    pending.item()
    torch.cuda.synchronize()
    return time.perf_counter() - t0, waited


def _rel_diff(a: dict, b: dict, base: dict) -> float:
    """||a - b|| / ||a - base|| over every parameter of two checkpoint payloads:
    how far apart a and b are, relative to the step from `base` to `a`."""
    def norm(x, y):
        sx, sy = x["model_state_dict"], y["model_state_dict"]
        return sum(float((sx[k].double() - sy[k].double()).pow(2).sum()) for k in sx) ** 0.5

    return norm(a, b) / norm(a, base)


def _adam_rel(a: dict, b: dict) -> float:
    """The larger over AdamW's two moments of ||m_a - m_b|| / ||m_a||."""
    sa, sb = a["optimizer_state_dict"]["state"], b["optimizer_state_dict"]["state"]
    out = 0.0
    for k in ("exp_avg", "exp_avg_sq"):
        num = sum(float((sa[i][k].double() - sb[i][k].double()).pow(2).sum()) for i in sa)
        den = sum(float(sa[i][k].double().pow(2).sum()) for i in sa)
        out = max(out, (num / den) ** 0.5)
    return out


def _jpeg_path(work: str, vit_ms_step: float):
    """catsdogs from JPEG files, where PIL and cv2 both import: JPEG_FILES photos of
    JPEG_SHAPE written under `work`, the shipped catsdogs config pointed at them;
    the loader alone (in line, as the map-style loader runs) and one epoch of the
    CLI entry, with its launch counts. Returns None where either does not import."""
    try:
        import cv2
        import PIL
        from PIL import Image
    except ImportError as e:
        log(f"[jpeg] {e.name} does not import on this machine: the JPEG path (catsdogs, "
            f"imagenet) is held against the JAX package on the CPU only")
        return None
    import numpy as np
    import yaml

    from ucf_vit_tpu_torch.config import load_config
    from ucf_vit_tpu_torch.ops.flash_attention import reset_launch_counts
    from ucf_vit_tpu_torch.train import build_dataloader, main as train_main

    log(f"[jpeg] cv2 {cv2.__version__} and PIL {PIL.__version__} import on this machine")
    root = os.path.join(work, "catsdogs")
    os.makedirs(root)
    rng = np.random.default_rng(2)
    h, w = JPEG_SHAPE
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    t0 = time.perf_counter()
    for i in range(JPEG_FILES):
        f = rng.uniform(0.005, 0.03, size=(3, 2))
        img = np.stack([128 + 90 * np.sin(f[c, 0] * yy) * np.cos(f[c, 1] * xx)
                        for c in range(3)], axis=-1)
        img += rng.normal(0, 12, size=img.shape)
        Image.fromarray(np.clip(img, 0, 255).astype(np.uint8)).save(
            os.path.join(root, f"{('cat', 'dog')[i % 2]}.{i}.jpg"), quality=90)
    nbytes = sum(os.path.getsize(os.path.join(root, f)) for f in os.listdir(root))
    log(f"[jpeg] wrote {JPEG_FILES} JPEGs of {w} x {h} ({nbytes / 1e6:.1f} MB) in "
        f"{time.perf_counter() - t0:.2f} s")
    raw = yaml.safe_load(open(CONFIG))
    raw["data"]["dict_root_dirs"] = {"catsdogs": root}
    raw["trainer"].update(checkpoint_path=os.path.join(work, "ck_catsdogs"), max_epochs=1)
    path = os.path.join(work, "catsdogs.yaml")
    with open(path, "w") as fh:
        yaml.safe_dump(raw, fh)
    cfg = load_config(path)
    dm, _, bpre = build_dataloader(cfg, cfg.batch_size, False)
    steps = bpre["catsdogs"]
    times, t0 = [], time.perf_counter()
    for b in dm.train_dataloader():
        times.append(time.perf_counter() - t0)
        t0 = time.perf_counter()
    if len(times) != steps or b["x"].shape != (cfg.batch_size, 3, *cfg.tile_size):
        fail(f"the catsdogs loader gave {len(times)} batches (expected {steps}), x "
             f"{b['x'].shape}")
    loader_ms = 1e3 * sum(times) / steps
    log(f"[jpeg] the loader alone, in line: {steps} batches of {cfg.batch_size} = "
        f"{loader_ms:.1f} ms a batch ({1e3 * min(times):.1f}-{1e3 * max(times):.1f})")
    reset_launch_counts()
    with _Tee() as tee:
        out = train_main([path])
    counts = _launch_counts()
    want = _expected_counts([VIT_ATTN] * int(cfg.init_args["depth"]), steps, dropout=False)
    ms_it = [float(m) for m in re.findall(r"epoch \d+ it \d+ loss \S+ ([\d.]+) ms/it",
                                          tee.text())]
    if counts != want or len(ms_it) != steps or not all(np.isfinite(out["loss_list"])):
        fail(f"catsdogs from JPEG files launched {counts} (expected {want}), {len(ms_it)} "
             f"steps logged, losses {out['loss_list']}")
    steady = sorted(ms_it[1:])
    log(f"[jpeg] python -m ucf_vit_tpu_torch.train <catsdogs copy>: {steps} steps, ms/step "
        f"mean {sum(ms_it) / steps:.1f} (the first {ms_it[0]:.1f}), median of the rest "
        f"{steady[len(steady) // 2]:.1f}; synthetic {vit_ms_step:.3f} ms/step in phase "
        f"train; launches {counts}")
    shutil.rmtree(raw["trainer"]["checkpoint_path"])
    return {"loader_ms": loader_ms, "ms_step": steady[len(steady) // 2], "root": root}


def phase_train_disk(synthetic: dict, vit_ms_step: float):
    """mae_long from NIfTI files on disk: seeded CT-like int16 volumes of 512 x 512 x
    128, written to a temporary imagesTr/, and a copy of the shipped config pointed at
    them (`_disk_config`: the model, the 128^3 tile, batch 2, num_workers, the
    16-tile shuffle buffer and auto_load_balancing as shipped). (a) The loader alone:
    its host time per batch. (b) The main path: `python -m ucf_vit_tpu_torch.train
    <copy> --single-device` through `train.main`, DISK_EPOCHS epochs, the launch
    counts set to 0 before it and read after (they must equal the synthetic run's a
    step), both checkpoint slots written, each save timed. (c) A timed and a traced
    window pulling batches from the live loader: ms/step, the time spent waiting for
    data, the busy share, peak memory. (d) Resume on a smaller set of files: 2
    epochs, then a run resumed to 3, against 3 uninterrupted epochs, to limits set
    from the spread of two uninterrupted runs."""
    import numpy as np
    import torch

    from ucf_vit_tpu_torch.checkpoint import restore_checkpoint
    from ucf_vit_tpu_torch.config import load_config
    from ucf_vit_tpu_torch.ops.flash_attention import reset_launch_counts
    from ucf_vit_tpu_torch.parallel.train_step import make_train_step
    from ucf_vit_tpu_torch.tasks import task_loss
    from ucf_vit_tpu_torch.train import build_dataloader, main as train_main

    torch.cuda.empty_cache()
    work = tempfile.mkdtemp(prefix="mae_disk_", dir=WORK)
    try:
        ct = os.path.join(work, "ct")
        secs = _write_volumes(ct, DISK_VOLUMES, DISK_SHAPE, seed=0)
        nbytes = sum(os.path.getsize(os.path.join(ct, "imagesTr", f))
                     for f in os.listdir(os.path.join(ct, "imagesTr")))
        log(f"[disk] wrote {DISK_VOLUMES} int16 NIfTI volumes of {DISK_SHAPE} "
            f"({nbytes / 1e6:.1f} MB) in {secs:.2f} s")
        path = _disk_config(work, "main", ct, DISK_EPOCHS)
        cfg = load_config(path)
        cfg.raw["parallelism"] = {"fsdp_size": 1, "simple_ddp_size": 1, "tensor_par_size": 1,
                                  "seq_par_size": 1}  # what --single-device sets
        batch = cfg.batch_size

        # (a) the loader alone, in line (no prefetch thread): its host time per batch
        dm, _, bpre = build_dataloader(cfg, batch, False)
        per_epoch = max(bpre.values())
        tiles = int(np.prod([s // t for s, t in zip(DISK_SHAPE, cfg.tile_size)]))
        if per_epoch != DISK_VOLUMES * tiles // batch:
            fail(f"auto_load_balancing gave {bpre}, expected {DISK_VOLUMES * tiles // batch} "
                 f"batches an epoch ({tiles} tiles of 128^3 a volume)")
        dm.prefetch = 0
        it = dm.train_dataloader(loop=True)
        times = []
        for _ in range(per_epoch):
            t0 = time.perf_counter()
            b = next(it)
            times.append(time.perf_counter() - t0)
        it.close()
        if b["x"].shape != (batch, 1, *cfg.tile_size) or b["x"].dtype != np.float32:
            fail(f"a batch from disk has x {b['x'].shape} {b['x'].dtype}")
        loader_ms = 1e3 * sum(times) / len(times)
        log(f"[disk] the loader alone: {per_epoch} batches of {batch} in {sum(times):.3f} s = "
            f"{loader_ms:.1f} ms a batch (the first {1e3 * times[0]:.1f} ms, the slowest "
            f"{1e3 * max(times):.1f}); x {b['x'].shape}, in [{b['x'].min():.3f}, "
            f"{b['x'].max():.3f}]")
        del dm, it, b

        # (b) the main path: the CLI entry as a user runs it, on the files
        reset_launch_counts()
        t0 = time.perf_counter()
        with _Tee() as tee:
            out = train_main([path, "--single-device"])
        counts = _launch_counts()
        wall = time.perf_counter() - t0
        model = out["state"].model
        enc, dec = len(model.blocks), len(model.decoder_blocks)
        steps = DISK_EPOCHS * per_epoch
        want = _expected_counts(_attn_shapes(model), steps, dropout=False, bf16=True,
                                forwards_per_step=2)
        per_step = {k: n // steps for k, n in counts.items()}
        synth_per_step = {k: n // MAE_MAIN_STEPS for k, n in synthetic["main"].items()}
        ms_it = [float(m) for m in re.findall(r"epoch \d+ it \d+ loss \S+ ([\d.]+) ms/it",
                                              tee.text())]
        log(f"[disk] python -m ucf_vit_tpu_torch.train <mae_long copy> --single-device: "
            f"{DISK_EPOCHS} epochs of {per_epoch} steps in {wall:.2f} s (init and saves "
            f"included); epoch losses {out['loss_list']}; launches {counts}")
        if counts != want or per_step != synth_per_step or len(ms_it) != steps \
                or not all(np.isfinite(out["loss_list"])):
            fail(f"mae_long from disk launched {counts} (expected {want}; a step {per_step}, "
                 f"the synthetic run's {synth_per_step}), {len(ms_it)} steps logged, losses "
                 f"{out['loss_list']}")
        steady = sorted(ms_it[i] for i in range(steps) if i % per_epoch >= 2)
        saves = _saves(tee.text(), cfg.trainer["checkpoint_path"],
                       ("multi_last_even.ckpt", "multi_last_odd.ckpt"))
        size = os.path.getsize(os.path.join(cfg.trainer["checkpoint_path"],
                                            "multi_last_odd.ckpt"))
        log(f"[disk] ms/step from disk: mean {sum(ms_it) / steps:.1f} over all {steps} steps "
            f"(first of each epoch {', '.join(f'{ms_it[i]:.1f}' for i in range(0, steps, per_epoch))}),"
            f" median of the steady steps {steady[len(steady) // 2]:.1f}; synthetic "
            f"{synthetic['ms_step']:.3f} ms/step in phase mae; checkpoint saves "
            f"{', '.join(f'epoch {e} {t:.3f} s' for e, t in saves)} ({size / 1e9:.3f} GB each)")
        # the newer slot outlives this phase: phase_trainer_parity serves it
        mae_ckpt = os.path.join(WORK, "mae_long_disk.ckpt")
        shutil.move(os.path.join(cfg.trainer["checkpoint_path"], "multi_last_odd.ckpt"), mae_ckpt)
        shutil.rmtree(cfg.trainer["checkpoint_path"])

        # (c) windows on the live loader (its prefetch thread running beside the steps)
        state = out["state"]
        step = make_train_step(task_loss(cfg), state.optimizer)
        dm, _, _ = build_dataloader(cfg, batch, False)
        it = dm.train_dataloader(loop=True)
        warm_s, warm_wait = _disk_window(state, step, it, DISK_WARMUP_STEPS)
        log(f"[disk] warm-up window on a fresh loader: {DISK_WARMUP_STEPS} steps in "
            f"{warm_s:.4f} s, of it waiting for batches {warm_wait:.4f} s (the first batch "
            f"reads the epoch's first volumes)")
        torch.cuda.reset_peak_memory_stats()
        wall_s, waited_s = _disk_window(state, step, it, DISK_TIMED_STEPS)
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        prof = torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA])
        prof.start()
        traced_s, traced_wait = _disk_window(state, step, it, DISK_TRACED_STEPS)
        prof.stop()
        it.close()
        busy_ms = sum(e.self_device_time_total for e in prof.key_averages()) / 1e3
        if busy_ms <= 0:
            fail("the traced window from disk saw no work on the card")
        ms_step = 1e3 * wall_s / DISK_TIMED_STEPS
        busy = busy_ms / (1e3 * traced_s)
        log(f"[disk] window on the live loader: {DISK_TIMED_STEPS} steps in {wall_s:.4f} s = "
            f"{ms_step:.3f} ms/step, of it waiting for batches {1e3 * waited_s / DISK_TIMED_STEPS:.3f}"
            f" ms/step; peak memory {peak_gb:.2f} GB; traced {DISK_TRACED_STEPS} steps in "
            f"{traced_s:.4f} s (waiting {1e3 * traced_wait:.1f} ms): device busy {busy_ms:.3f} ms "
            f"= {100 * busy:.2f}%, {busy_ms / DISK_TRACED_STEPS:.3f} ms a step")
        del out, model, state, step, dm, it
        torch.cuda.empty_cache()

        # (d) resume equals uninterrupted, on 2 volumes of one 128^3 tile each (one batch
        # an epoch), with the warm-up cut to 0 in memory so that every step moves the
        # parameters. Differences are relative to one epoch's update (parameters) or to
        # the moments' size: a gradient element near 0 whose sign the atomics flip moves
        # its parameter by 2 lr under AdamW, so a largest difference says nothing. The
        # spread of two uninterrupted runs comes first.
        small = os.path.join(work, "ct_small")
        _write_volumes(small, 2, DISK_SMALL_SHAPE, seed=1)
        ck = {n: os.path.join(work, f"ck_{n}") for n in ("whole", "part")}
        runs, spread = {}, None
        for name, epochs, resume in (("whole", 3, False), ("part", 2, False),
                                     ("part", 3, True)):
            p = _disk_config(work, f"{name}_{epochs}", small, epochs, {"warmup_steps": 0},
                             checkpoint_path=ck[name], resume_from_checkpoint=resume)
            with _Tee() as tee:
                res = train_main([p, "--single-device"])
            runs[name, resume] = (res["loss_list"], tee.text())
            del res
            torch.cuda.empty_cache()
            if name == "part" and not resume:  # two uninterrupted runs after 2 epochs
                w1, p1, p0 = (restore_checkpoint(ck[n], f"multi_last_{slot}")
                              for n, slot in (("whole", "odd"), ("part", "odd"),
                                              ("part", "even")))
                spread = (_rel_diff(w1, p1, p0), _adam_rel(w1, p1))
        w2, r2, w1 = (restore_checkpoint(ck[n], f"multi_last_{slot}")
                      for n, slot in (("whole", "even"), ("part", "even"), ("whole", "odd")))
        diff = (_rel_diff(w2, r2, w1), _adam_rel(w2, r2))
        load = [float(x) for x in re.findall(r"checkpoint read in ([\d.]+) s",
                                             runs["part", True][1])]
        lw, lp, lr = runs["whole", False][0], runs["part", False][0], runs["part", True][0]
        loss_spread = max(abs(a - b) for a, b in zip(lw[:2], lp))
        loss_diff = abs(lw[2] - lr[2])
        log(f"[disk] resume: 3 epochs {lw}; 2 epochs {lp}; resumed to 3 {lr} (checkpoint "
            f"read in {load} s). Two uninterrupted runs after 2 epochs: params "
            f"{spread[0]:.3e} of an epoch's update, AdamW moments {spread[1]:.3e}, losses "
            f"{loss_spread:.3e}. Resumed against uninterrupted after 3: params {diff[0]:.3e}, "
            f"moments {diff[1]:.3e}, loss {loss_diff:.3e} (limits {RESUME_PARAM_TOL:g}, "
            f"{RESUME_ADAM_TOL:g}, {RESUME_LOSS_TOL:g})")
        if lr[:2] != lp or len(lr) != 3 or not load:
            fail(f"the resumed run's loss list {lr} does not continue {lp}")
        if diff[0] > RESUME_PARAM_TOL or diff[1] > RESUME_ADAM_TOL or loss_diff > RESUME_LOSS_TOL:
            fail("the resumed run differs from the uninterrupted one beyond the limits")
        # the JPEG files outlive this phase too: phase_trainer_parity trains on them
        jpeg = _jpeg_path(WORK, vit_ms_step)
        return {"main": counts, "ms_step": ms_step, "loader_ms": loader_ms,
                "save_s": [t for _, t in saves], "load_s": load, "busy": busy, "jpeg": jpeg,
                "mae_ckpt": mae_ckpt}
    finally:
        shutil.rmtree(work, ignore_errors=True)


def _request(port: int, method: str, path: str, body: bytes | None = None) -> bytes:
    """One HTTP request on a connection of its own: the server speaks
    HTTP/1.0 and closes the connection after each answer."""
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=300)
    try:
        conn.request(method, path, body, {"Content-Type": "application/x-npy"} if body else {})
        r = conn.getresponse()
        data = r.read()
    finally:
        conn.close()
    if r.status != 200:
        raise RuntimeError(f"{method} {path}: HTTP {r.status} {data[:200]!r}")
    return data


def _get_json(port: int, path: str) -> dict:
    return json.loads(_request(port, "GET", path))


def _load_client(port: int, bodies: list, pipe, first_only: bool = False) -> None:
    """Closed-loop load generator, run in a process of its own so that it
    shares no interpreter with the server. One thread per body posts that
    body, waits for the answer and posts it again. Each window length read
    from `pipe` runs one window: the threads start together, start no request
    once the length has passed, and the window closes with the last answer.
    It sends back the window's wall time, (body index, latency s, answer) per
    request and any error; with `first_only` the answer of each body's first
    request of a window only (the others None: an MAE answer is 8 MB). None
    ends the process."""
    import numpy as np

    n = len(bodies)
    go, done = threading.Barrier(n + 1), threading.Barrier(n + 1)
    state: dict = {"stop": False}

    def worker(i):
        while True:
            go.wait()
            if state["stop"]:
                return
            try:
                first = True
                while time.perf_counter() < state["end"]:
                    t0 = time.perf_counter()
                    answer = _request(port, "POST", "/v1/predict", bodies[i])
                    state["requests"].append((i, time.perf_counter() - t0,
                                              answer if first or not first_only else None))
                    first = False
            except Exception as e:  # reported to the parent, which fails
                state["errors"].append(repr(e))
            done.wait()

    threads = [threading.Thread(target=worker, args=(i,)) for i in range(n)]
    for t in threads:
        t.start()
    while (window := pipe.recv()) is not None:
        state.update(requests=[], errors=[])
        t0 = time.perf_counter()
        state["end"] = t0 + window
        go.wait()
        done.wait()
        wall = time.perf_counter() - t0
        pipe.send({"wall_s": wall, "errors": state["errors"], "requests": [
            (i, lat, None if a is None else np.load(io.BytesIO(a)))
            for i, lat, a in state["requests"]]})
    state["stop"] = True
    go.wait()
    for t in threads:
        t.join()


def _window_line(name: str, res: dict, before: dict, after: dict) -> str:
    import numpy as np

    n = len(res["requests"])
    lat = np.array([r[1] for r in res["requests"]]) * 1e3
    batches = after["batches"] - before["batches"]
    fill = (after["batch_fill_sum"] - before["batch_fill_sum"]) / max(batches, 1)
    in_batcher = (after["latency_sum_s"] - before["latency_sum_s"]) / max(n, 1) * 1e3
    return (f"[serve] {name} window: {n} requests from {LOAD_CLIENTS} closed-loop clients "
            f"in {res['wall_s']:.4f} s = {n / res['wall_s']:.2f} requests/s; {batches} "
            f"batches, mean fill {fill:.2f}; client latency p50 {np.percentile(lat, 50):.2f} "
            f"p90 {np.percentile(lat, 90):.2f} p99 {np.percentile(lat, 99):.2f} max "
            f"{lat.max():.2f} ms; in the batcher (queue + batch) mean {in_batcher:.2f} ms")


def phase_serve(ckpt_dir: str):
    import numpy as np
    import torch

    from ucf_vit_tpu_torch.config import Config, load_config
    from ucf_vit_tpu_torch.inference import init_eval_model, load_weights
    from ucf_vit_tpu_torch.ops.flash_attention import flash_attention, reset_launch_counts
    from ucf_vit_tpu_torch.serve import make_server
    from ucf_vit_tpu_torch.train import synthetic_batches

    cfg = load_config(CONFIG)
    depth = int(cfg.init_args["depth"])
    samples = next(synthetic_batches(cfg, LOAD_CLIENTS + SEQUENTIAL_REQUESTS, seed=1))["x"]
    bodies = []
    for x in samples:
        buf = io.BytesIO()
        np.save(buf, x)
        bodies.append(buf.getvalue())
    answers = []  # (sample index, answer)

    reset_launch_counts()  # the main path starts here (warm-up included)
    t0 = time.perf_counter()
    # --checkpoint on phase_train's directory: the config's slot, multi_last_odd (epoch 1)
    server = make_server(cfg, ckpt_dir, host="127.0.0.1", port=0, max_batch=MAX_BATCH,
                         device="cuda")
    startup_s = time.perf_counter() - t0
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    port = server.server_address[1]
    ctx = multiprocessing.get_context("spawn")
    pipe, child_pipe = ctx.Pipe()
    client = ctx.Process(target=_load_client, args=(port, bodies[:LOAD_CLIENTS], child_pipe),
                         daemon=True)
    client.start()
    windows = {}
    # the traced window: how busy the card is under load, and which kernels
    # take its time. Device activity only: recording the host's ops too cost
    # a third of the requests/s on the H100.
    prof = torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA])
    try:
        health = _get_json(port, "/healthz")
        if health.get("status") != "ok":
            fail(f"/healthz answered {health}")
        seq_lat = []
        for i in range(LOAD_CLIENTS, LOAD_CLIENTS + SEQUENTIAL_REQUESTS):
            t1 = time.perf_counter()
            answer = _request(port, "POST", "/v1/predict", bodies[i])
            seq_lat.append(time.perf_counter() - t1)
            answers.append((i, np.load(io.BytesIO(answer))))
        for name, seconds in LOAD_WINDOWS_S.items():
            before = _get_json(port, "/v1/stats")
            if name == "traced":
                prof.start()
            pipe.send(seconds)
            if not pipe.poll(seconds + 300):
                fail(f"the load client gave no result for the {name} window")
            res = pipe.recv()
            if name == "traced":
                prof.stop()
            if res["errors"] or not res["requests"]:
                fail(f"load client, {name} window: {len(res['requests'])} answers, "
                     f"errors {res['errors'][:3]}")
            windows[name] = (res, before, _get_json(port, "/v1/stats"))
            answers += [(i, a) for i, _, a in res["requests"]]
        pipe.send(None)
        client.join(timeout=30)
        stats = _get_json(port, "/v1/stats")
        launches = flash_attention.launches  # the main path ends here
        tf32_launches = flash_attention.by_source["flash_fwd_tf32"]
        # /v1/reload to the other slot while serving: the next answers are that slot's
        even = os.path.join(ckpt_dir, "multi_last_even.ckpt")
        t1 = time.perf_counter()
        reloaded = json.loads(_request(port, "POST", "/v1/reload",
                                       json.dumps({"checkpoint": even}).encode()))
        reload_s = time.perf_counter() - t1
        even_answers = [(i, np.load(io.BytesIO(_request(port, "POST", "/v1/predict", bodies[i]))))
                        for i in range(LOAD_CLIENTS, LOAD_CLIENTS + SEQUENTIAL_REQUESTS)]
        epoch_after = _get_json(port, "/v1/stats")["checkpoint_epoch"]
    finally:
        if client.is_alive():
            client.terminate()
            client.join()
        server.shutdown()
        server.server_close()
        server.RequestHandlerClass.batcher.close()
        thread.join(timeout=30)

    log(f"[serve] ViT-B/16 {cfg.tile_size} depth {depth} from the checkpoint of epoch "
        f"{stats['checkpoint_epoch']} ({ckpt_dir}): startup {startup_s:.2f} s; "
        f"sequential latency mean {1e3 * sum(seq_lat) / len(seq_lat):.2f} ms, "
        f"max {1e3 * max(seq_lat):.2f} ms")
    for name, (res, before, after) in windows.items():
        log(_window_line(name, res, before, after))
    traced_s = windows["traced"][0]["wall_s"]
    kernels = sorted(((e.self_device_time_total, e.count, e.key) for e in prof.key_averages()
                      if e.self_device_time_total > 0), reverse=True)
    busy_ms = sum(k[0] for k in kernels) / 1e3
    if busy_ms <= 0:
        fail("the traced window saw no work on the card")
    log(f"[serve] traced window: device busy {busy_ms:.3f} ms of {1e3 * traced_s:.3f} ms = "
        f"{100 * busy_ms / (1e3 * traced_s):.2f}%")
    for t_us, count, key in kernels[:8]:
        log(f"[serve]   {t_us / 1e3:9.3f} ms {100 * t_us / 1e3 / busy_ms:6.2f}% "
            f"x{count:<5d} {key[:90]}")
    log(f"[serve] stats {json.dumps(stats, sort_keys=True)}")
    log(f"[serve] flash_fwd launches {launches} over {stats['batches']} batches, "
        f"{tf32_launches} of them under flash_fwd_tf32")
    if stats["errors"] or stats["requests"] != len(answers) + 1:
        fail(f"server stats {stats}; expected {len(answers) + 1} requests (warm-up "
             f"included), no errors")
    if launches != depth * stats["batches"] or launches == 0 or tf32_launches != launches:
        fail(f"flash_fwd ran {launches} times over {stats['batches']} batches, "
             f"{tf32_launches} under flash_fwd_tf32; expected {depth} per batch, all f32")

    model = server.RequestHandlerClass.weights_holder["model"]
    x16 = torch.from_numpy(samples[:MAX_BATCH]).cuda()
    with torch.inference_mode():
        fwd_ms = time_ms(lambda: model(x16), iters=10, warmup=2)
    log(f"[serve] forward of one batch of {MAX_BATCH} on the card: {fwd_ms:.3f} ms")

    # the oracle: attention forced to EINSUM, the checkpoint's weights loaded beside it
    raw = copy.deepcopy(cfg.raw)
    raw["trainer"]["attn_impl"] = "EINSUM"
    oracle = init_eval_model(Config(raw=raw, task=cfg.task), seed=0, device="cuda")

    def oracle_answers(path):
        epoch = load_weights(oracle, cfg, path)
        with torch.inference_mode():
            return epoch, torch.cat([oracle(torch.from_numpy(samples[i:i + MAX_BATCH]).cuda())
                                     for i in range(0, len(samples), MAX_BATCH)]).cpu().numpy()

    def worst_diff(got_answers, want):
        worst = 0.0
        for i, got in got_answers:
            if got.shape != want[i].shape or not np.all(np.isfinite(got)):
                fail(f"answer of shape {got.shape} (finite: {np.all(np.isfinite(got))}), "
                     f"expected {want[i].shape}")
            worst = max(worst, float(np.abs(got - want[i]).max()))
        return worst

    epoch_odd, want = oracle_answers(ckpt_dir)
    worst = worst_diff(answers, want)
    log(f"[serve] {len(answers)} answers vs the direct EINSUM forward on the checkpoint's "
        f"weights (epoch {epoch_odd}): max abs diff {worst:.3e} (tol {SERVE_TOL:g})")
    if stats["checkpoint_epoch"] != epoch_odd or worst > SERVE_TOL:
        fail(f"served answers disagree with the direct forward (server's epoch "
             f"{stats['checkpoint_epoch']}, the slot's {epoch_odd})")
    epoch_even, want_even = oracle_answers(even)
    worst_even = worst_diff(even_answers, want_even)
    gap = float(np.abs(want_even - want).max())
    log(f"[serve] /v1/reload to {os.path.basename(even)} in {reload_s:.3f} s: {reloaded}; "
        f"{len(even_answers)} answers after it vs the EINSUM forward on that slot: max abs "
        f"diff {worst_even:.3e} (tol {SERVE_TOL:g}); the two slots' answers differ by up to "
        f"{gap:.3e}")
    if reloaded != {"status": "reloaded", "epoch": epoch_even} or epoch_after != epoch_even:
        fail(f"/v1/reload answered {reloaded}, stats then said epoch {epoch_after}")
    if worst_even > SERVE_TOL or gap < 10 * SERVE_TOL:
        fail("after /v1/reload the answers are not the other slot's")
    del oracle
    seeded_rps = _seeded_load(cfg, bodies[:LOAD_CLIENTS])
    load_res = windows["load"][0]
    ckpt_rps = len(load_res["requests"]) / load_res["wall_s"]
    log(f"[serve] requests/s under load: {ckpt_rps:.2f} from the checkpoint, {seeded_rps:.2f} "
        f"from seeded weights (a server of its own, after)")
    return {"launches": launches}


def _seeded_load(cfg, bodies) -> float:
    """Requests/s of a server with seeded weights under the same closed-loop load
    (a warm-up window, then the load window)."""
    from ucf_vit_tpu_torch.serve import make_server

    server = make_server(cfg, host="127.0.0.1", port=0, max_batch=MAX_BATCH, device="cuda")
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    ctx = multiprocessing.get_context("spawn")
    pipe, child_pipe = ctx.Pipe()
    client = ctx.Process(target=_load_client, args=(server.server_address[1], bodies,
                                                     child_pipe), daemon=True)
    client.start()
    try:
        for name in ("warm-up", "load"):
            seconds = LOAD_WINDOWS_S[name]
            pipe.send(seconds)
            if not pipe.poll(seconds + 300):
                fail(f"the load client gave no result for the seeded {name} window")
            res = pipe.recv()
            if res["errors"] or not res["requests"]:
                fail(f"seeded server, {name} window: errors {res['errors'][:3]}")
        pipe.send(None)
        client.join(timeout=30)
    finally:
        if client.is_alive():
            client.terminate()
            client.join()
        server.shutdown()
        server.server_close()
        server.RequestHandlerClass.batcher.close()
        thread.join(timeout=30)
    return len(res["requests"]) / res["wall_s"]


# ---------------------------------------------------------------- diffusion


def _attention_case(tag: str, label: str, shape: tuple, gen, iters: int = 50,
                    dtype_name: str = "float32") -> dict:
    """The forward and both backward routes of `dtype_name` (f32 by the tf32
    sources, bf16 by the sm90 ones) at `shape` (b, h, n, n, dh, packed) against
    their plain versions on the same inputs in f32: o and lse to FLASH_TOL and
    LSE_TOL, dq, dk, dv of each route to BWD_TOL; both backward routes timed in
    turns (`_route_ms`, 20 calls a window: which one `bwd_route` should take
    here); then the forward and the fused kernel timed (`iters` calls) beside
    their plain versions on the same inputs, their bound and
    scaled_dot_product_attention (forward; backward alone). Returns {"fwd":
    numbers, "bwd": numbers}."""
    import torch
    import torch.nn.functional as F

    from ucf_vit_tpu_torch.ops.flash_attention import (
        _bwd_launch,
        _dq_workspace,
        _dropout_args,
        flash_attention,
        flash_attention_bwd_plain,
        flash_attention_plain,
        kernel_instance,
    )

    b, h, n, _, dh, packed = shape
    dtype = getattr(torch, dtype_name)
    src = "tf32" if dtype_name == "float32" else "sm90"
    shape_s = f"[{b},{h},{n}x{n},{dh}] {dtype_name}{' qkv-views' if packed else ''} ({label})"
    q, k, v = _flash_inputs(b, h, n, n, dh, dtype, packed, gen)
    sm = dh**-0.5
    o, lse, do, _, rel, ref_max, abs_err = _bwd_case(q, k, v, dh, 0.0, 0, 0, 0, gen)
    ref, ref_lse = flash_attention_plain(q.float(), k.float(), v.float(), sm)
    err = (o.float() - ref).abs().max().item()
    lse_err = (lse - ref_lse).abs().max().item()
    instances = (kernel_instance(f"flash_fwd_{src}", dh), kernel_instance(f"flash_bwd_{src}", dh))
    fwd_tol, bwd_tol = _fwd_tol(dtype_name, n), BWD_TOL[dtype_name]
    log(f"[{tag}] flash_fwd {shape_s} ({instances[0]}): max|o-plain| {err:.3e} (tol "
        f"{fwd_tol:g}), max|lse-plain| {lse_err:.3e} (tol {LSE_TOL:g})")
    if not (err <= fwd_tol and lse_err <= LSE_TOL):
        fail(f"flash_fwd disagrees with its plain version at {shape_s}")
    for r in rel:
        log(f"[{tag}] flash_bwd {r:5s} {shape_s} ({instances[1]}): max|d-plain|/max|plain| "
            f"dq {rel[r][0]:.3e} dk {rel[r][1]:.3e} dv {rel[r][2]:.3e} (tol {bwd_tol:g})")
        if max(rel[r]) > bwd_tol or not all(m > 0 for m in ref_max):
            fail(f"flash_bwd route {r} disagrees with its plain version at {shape_s}")
    del ref, ref_lse
    _route_ms(shape_s, dtype, q, k, v, o, lse, do, iters=20)
    # the forward: kernel, plain version, SDPA
    ms, host = device_ms(lambda: flash_attention(q, k, v, sm_scale=sm), FWD_KERNEL[dtype_name],
                         iters=iters)
    plain_ms, _ = device_ms(lambda: flash_attention_plain(q, k, v, sm), iters=iters)
    library_ms, _ = device_ms(lambda: F.scaled_dot_product_attention(q, k, v, scale=sm),
                              iters=iters)
    flops = 4.0 * b * h * n * n * dh
    nbytes = q.element_size() * b * h * dh * 4 * n + 4 * b * h * n
    bound_ms, bound_by = _bound(flops, nbytes, dtype_name)
    out = {"fwd": {"ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
                   "bound_ms": bound_ms, "bound_by": bound_by, "max_abs_err": err}}
    log(f"[{tag}] flash_fwd {shape_s} ({instances[0]}), device ms per call (host ms): "
        f"kernel {ms:.4f} ({host:.4f}), plain {plain_ms:.4f}, scaled_dot_product_attention "
        f"{library_ms:.4f}; bound {bound_ms:.4f} ms ({bound_by}; {flops / 1e9:.3f} GFLOP)")
    # the fused backward alone, from buffers made beforehand
    di = (o.float() * do.float()).sum(-1).reshape(b * h, n)
    ws = _dq_workspace(b, n, h, dh, q.device)
    dk, dv = (torch.empty(b, n, h, dh, device="cuda", dtype=dtype).transpose(1, 2)
              for _ in "kv")
    drop = _dropout_args(0.0, 0, 0, 0)
    ms, host = device_ms(lambda: _bwd_launch("fused", q, k, v, do, lse, di, ws, dk, dv, sm,
                                             drop), _bwd_kernel(dtype_name, "fused"), iters=iters)
    plain_ms, _ = device_ms(lambda: flash_attention_bwd_plain(q, k, v, o, lse, do, sm),
                            iters=iters)
    qg, kg, vg = (t.detach().requires_grad_() for t in (q, k, v))
    sdpa = F.scaled_dot_product_attention(qg, kg, vg, scale=sm)
    library_ms, _ = device_ms(
        lambda: torch.autograd.grad(sdpa, (qg, kg, vg), do, retain_graph=True), iters=iters)
    del sdpa, qg, kg, vg
    flops, nbytes = _bwd_work("fused", b, h, n, n, dh, q.element_size())
    bound_ms, bound_by = _bound(flops, nbytes, dtype_name)
    out["bwd"] = {"ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
                  "bound_ms": bound_ms, "bound_by": bound_by,
                  "max_abs_err": max(abs_err["fused"])}
    log(f"[{tag}] flash_bwd_fused {shape_s} ({instances[1]}), device ms per call (host "
        f"ms): kernel {ms:.4f} ({host:.4f}), plain {plain_ms:.4f}, "
        f"scaled_dot_product_attention backward {library_ms:.4f}; bound {bound_ms:.4f} ms "
        f"({bound_by}; {flops / 1e9:.3f} GFLOP)")
    return out


def phase_diffusion_kernels():
    """The f32 forward and fused backward at the diffusion decoders' attention
    (DIFF_SHAPES, packed qkv views): the DH = 128 instance at imagenet's dh 128,
    the DH = 96 one at basic_ct's dh 96. o and lse against the plain forward to
    FLASH_TOL and LSE_TOL, dq, dk, dv of both routes against the plain backward
    to BWD_TOL (the path takes the fused one: 256 queries); the forward and the
    fused kernel timed beside their plain versions, their bound and
    scaled_dot_product_attention (forward; backward alone). Returns {config:
    {"fwd": numbers, "bwd": numbers}}."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(7)
    return {name: _attention_case("diffusion", f"{name} diffusion decoder", shape, gen)
            for name, shape in DIFF_SHAPES.items()}


def _instance_counts() -> dict:
    """The flash kernels' launches by head-dim instance, forward and backward."""
    from ucf_vit_tpu_torch.ops.flash_attention import flash_attention, flash_attention_bwd

    return {**{f"fwd:{k}": n for k, n in flash_attention.by_instance.items()},
            **{f"bwd:{k}": n for k, n in flash_attention_bwd.by_instance.items()}}


def _expected_instances(shapes: list, steps: int, backward: bool = True) -> dict:
    """`_instance_counts` of `steps` f32 train steps (or, without `backward`,
    forwards) of a model whose attention blocks take these (Nq, Nkv, dh), each
    backward on the route `bwd_route` gives its shape."""
    import torch

    from ucf_vit_tpu_torch.ops.flash_attention import bwd_route, kernel_instance

    counts = {k: 0 for k in _instance_counts()}
    for n_q, n_kv, dh in shapes:
        counts["fwd:" + kernel_instance("flash_fwd_tf32", dh)] += steps
        if backward:
            kernels = 1 if bwd_route(torch.float32, n_q, n_kv, dh) == "fused" else 2
            counts["bwd:" + kernel_instance("flash_bwd_tf32", dh)] += kernels * steps
    return counts


def _single_device(path: str):
    """The config at `path` as `--single-device` sets it."""
    from ucf_vit_tpu_torch.config import load_config

    cfg = load_config(path)
    cfg.raw["parallelism"] = {"fsdp_size": 1, "simple_ddp_size": 1, "tensor_par_size": 1,
                              "seq_par_size": 1}
    return cfg


def phase_train_diffusion():
    """Both diffusion configs at full width and depth on one device: the
    trainer's CLI entry with `--single-device`, the launch counts set to 0
    before it and read after (by kernel, source and head-dim instance: 40 f32
    forwards and 40 fused backwards a step, 16 of each at the decoder's
    instance, no dkv or dq); a timed and a traced window; FLASH against EINSUM
    from one init and one batch stream, the steps t, the noise e and the time
    embedding's dropout drawn from one seeded generator on both runs."""
    import numpy as np
    import torch

    from ucf_vit_tpu_torch.models import DiffusionVIT
    from ucf_vit_tpu_torch.ops.flash_attention import reset_launch_counts
    from ucf_vit_tpu_torch.train import init_train, main as train_main, synthetic_batches

    results = {}
    for name, path in DIFF_CONFIGS.items():
        torch.cuda.empty_cache()
        cfg = _single_device(path)
        ia, accum = cfg.init_args, int(cfg.trainer["accum_steps"])
        # (a) the main path: the CLI entry as a user runs it
        argv = [path, "--synthetic", "--single-device", "--max-steps", str(DIFF_MAIN_STEPS)]
        reset_launch_counts()
        t0 = time.perf_counter()
        out = train_main(argv)
        counts, instances = _launch_counts(), _instance_counts()
        model = out["state"].model
        log(f"[diffusion] {name}: python -m ucf_vit_tpu_torch.train {' '.join(argv[1:])}: "
            f"{time.perf_counter() - t0:.2f} s (init included); epoch losses "
            f"{out['loss_list']}; launches {counts}")
        if not (isinstance(model, DiffusionVIT) and model.embed_dim == 768
                and len(model.blocks) == 12 and model.blocks[0].attn.num_heads == 12
                and model.decoder_embed_dim == int(ia["decoder_embed_dim"])
                and len(model.decoder_blocks) == 8
                and model.decoder_blocks[0].attn.num_heads == int(ia["decoder_num_heads"])
                and model.num_patches == 256 and model.time_steps == 1000
                and model.dtype is None and not model.remat
                and all(p.dtype == torch.float32 for p in model.parameters())):
            fail(f"the {name} diffusion run was not the shipped model in f32")
        shapes = _attn_shapes(model)
        steps = accum * DIFF_MAIN_STEPS
        want = _expected_counts(shapes, steps, dropout=False)
        want_instances = _expected_instances(shapes, steps)
        per_step = {k: n // DIFF_MAIN_STEPS for k, n in instances.items() if n}
        dec = f"flash_fwd_tf32<{128 if model.decoder_blocks[0].attn.head_dim > 96 else 96}>"
        log(f"[diffusion] {name}: launches a step by instance {per_step}")
        if counts != want or instances != want_instances or not all(np.isfinite(out["loss_list"])):
            fail(f"{name} train launched {counts}, {instances} (expected {want}, "
                 f"{want_instances}); losses {out['loss_list']}")
        if (counts["flash_fwd"], counts["flash_bwd_fused"], counts["flash_bwd_dkv"],
                counts["flash_bwd_dq"], instances["fwd:" + dec]) != (
                40 * DIFF_MAIN_STEPS, 40 * DIFF_MAIN_STEPS, 0, 0, 16 * DIFF_MAIN_STEPS):
            fail(f"{name}: expected 40 forwards, 40 fused backwards (16 of each at {dec}) and "
                 f"no dkv or dq a step: {counts}, {instances}")
        del out, model

        # (b) the step's time: a warm-up, an untraced window and a traced one
        batch = cfg.batch_size
        stream = synthetic_batches(cfg, batch, seed=0)
        w, t = DIFF_WARMUP_STEPS, DIFF_TIMED_STEPS
        batches = [next(stream) for _ in range(w + t + DIFF_TRACED_STEPS)]
        state, step = init_train(cfg, "cuda")
        res = _measure_steps("diffusion", f"{name} f32 batch {batch} ({accum} x "
                             f"{batch // accum})", state, step, batches[:w],
                             batches[w:w + t], batches[w + t:], top=14)
        res["device_step_ms"] = res["busy_ms"] / res["traced_steps"]
        log(f"[diffusion] {name}: device time a step {res['device_step_ms']:.3f} ms; by kind: "
            f"{_kernel_groups(res['kernels'], res['busy_ms'])}")
        log(f"[diffusion] {name}: flash kernels a step: "
            f"{_flash_per_step(res['kernels'], res['traced_steps'])}")
        del state, step

        # (c) FLASH (the kernels) against EINSUM (plain autograd)
        runs = {}
        for impl in ("FLASH", "EINSUM"):
            st, _, losses, grads, c = _run_steps(_train_cfg(cfg, impl),
                                                 batches[:DIFF_CHECK_STEPS])
            runs[impl] = (losses, grads, c)
            del st
        (lf, gf, cf), (le, ge, ce) = runs["FLASH"], runs["EINSUM"]
        diff = max(abs(a - b) for a, b in zip(lf, le))
        gmax = max(g.abs().max().item() for g in ge.values())
        gdiff = max((gf[n] - ge[n]).abs().max().item() for n in ge)
        log(f"[diffusion] {name} FLASH vs EINSUM, {DIFF_CHECK_STEPS} steps: losses FLASH "
            f"{' '.join(f'{x:.6f}' for x in lf)}, EINSUM {' '.join(f'{x:.6f}' for x in le)}; "
            f"max |diff| {diff:.3e} (tol {TRAIN_LOSS_TOL:g}); first-step gradients max |diff| "
            f"{gdiff / gmax:.3e} of the largest entry (tol {TRAIN_GRAD_TOL:g})")
        if not all(np.isfinite(lf)) or diff > TRAIN_LOSS_TOL or gdiff > TRAIN_GRAD_TOL * gmax:
            fail(f"{name}: FLASH training disagrees with EINSUM's")
        if cf != _expected_counts(shapes, accum * DIFF_CHECK_STEPS, dropout=False) or \
                any(ce.values()):
            fail(f"{name}: launches {cf} under FLASH, {ce} under EINSUM")
        results[name] = {"main": counts, "instances": instances, **res}
        del runs, gf, ge
    return results


def phase_generate():
    """DDPM generation with imagenet's DiffusionVIT (seeded weights, a batch of
    GEN_SAMPLES, 256 x 256 x 3): `generate_diffusion` runs the whole 1,000-step
    reverse chain on the card for seed 0, and the chain cut to GEN_SEED_STEPS
    steps for seeds 0 and 1 (other images), each with the launch counts set to
    0 before it and read after (20 forwards a step, no backward); the server
    below serves the cut chain; a traced window of denoising steps (device ms a step, busy
    share); then `make_server` with `--num-generate` GEN_SAMPLES: its warm-up
    (one denoising step), one `/v1/generate` request for seed 0 (its latency,
    its shape, its launches, and the same images as the direct chain's for
    seed 0: one seed, one answer) and `/v1/predict` answering 400."""
    import numpy as np
    import torch

    from ucf_vit_tpu_torch.config import load_config
    from ucf_vit_tpu_torch.inference import diffusion_sampler, generate_diffusion, init_eval_model
    from ucf_vit_tpu_torch.ops.flash_attention import reset_launch_counts
    from ucf_vit_tpu_torch.serve import make_server
    from ucf_vit_tpu_torch.tasks import time_steps

    torch.cuda.empty_cache()
    cfg = _single_device(DIFF_CONFIGS["imagenet"])
    steps = time_steps(cfg)
    model = init_eval_model(cfg, device="cuda")
    shapes = _attn_shapes(model)
    # a chain: one forward a block a step, no backward
    want = _expected_counts(shapes, 0, dropout=False)
    want["flash_fwd"] = want["src:flash_fwd_tf32"] = len(shapes) * steps
    want_instances = _expected_instances(shapes, steps, backward=False)
    img_shape = (GEN_SAMPLES, cfg.max_channels, *cfg.tile_size[:2])
    chains = []
    # seed 0 runs the whole chain; seed 1 (other images) the chain cut to GEN_SEED_STEPS
    # steps, beside seed 0 cut alike
    short = load_config(_parallel_config("gen_short", DIFF_CONFIGS["imagenet"], {},
                                         init_args={"num_time_steps": GEN_SEED_STEPS}))
    for seed, run_cfg in ((0, cfg), (0, short), (1, short)):
        n = time_steps(run_cfg)
        reset_launch_counts()
        t0 = time.perf_counter()
        sps, imgs = generate_diffusion(run_cfg, num_samples=GEN_SAMPLES, return_images=True,
                                       device="cuda", seed=seed)
        wall = time.perf_counter() - t0
        counts, instances = _launch_counts(), _instance_counts()
        log(f"[generate] generate_diffusion seed {seed}, {n} steps: {sps:.4f} samples/s "
            f"({wall:.2f} s with the init); images {imgs.shape}, mean {imgs.mean():.4f}, std "
            f"{imgs.std():.4f}; launches {counts}")
        if imgs.shape != img_shape or not np.all(np.isfinite(imgs)):
            fail(f"generate_diffusion gave {imgs.shape} (expected {img_shape}), finite "
                 f"{np.all(np.isfinite(imgs))}")
        want_n = {**want, "flash_fwd": len(shapes) * n, "src:flash_fwd_tf32": len(shapes) * n}
        if counts != want_n or instances != _expected_instances(shapes, n, backward=False):
            fail(f"a generate call launched {counts}, {instances}; expected {want_n}")
        chains.append((sps, imgs, instances))
    if np.array_equal(chains[1][1], chains[2][1]):
        fail("generate_diffusion gave seeds 0 and 1 the same images")

    # device time a denoising step at the chain's batch, in a traced window
    sample = diffusion_sampler(cfg, model, GEN_SAMPLES)
    x = torch.randn(sample.shape, device="cuda", generator=torch.Generator("cuda").manual_seed(0))
    tb = torch.full((GEN_SAMPLES,), steps // 2, dtype=torch.long, device="cuda")
    with torch.inference_mode():
        for _ in range(3):
            sample.denoise(x, tb)
        torch.cuda.synchronize()
        prof = torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA])
        prof.start()
        t0 = time.perf_counter()
        for _ in range(GEN_TRACED_STEPS):
            sample.denoise(x, tb)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
        prof.stop()
    kernels = sorted(((e.self_device_time_total, e.count, e.key) for e in prof.key_averages()
                      if e.self_device_time_total > 0), reverse=True)
    busy_ms = sum(k[0] for k in kernels) / 1e3
    if busy_ms <= 0:
        fail("the traced denoising window saw no work on the card")
    denoise = {"device_ms": busy_ms / GEN_TRACED_STEPS, "host_ms": wall_ms / GEN_TRACED_STEPS,
               "busy": busy_ms / wall_ms, "kernels_a_step": sum(k[1] for k in kernels)
               / GEN_TRACED_STEPS}
    log(f"[generate] a denoising step at batch {GEN_SAMPLES}: {denoise['device_ms']:.3f} ms of "
        f"device time in {denoise['host_ms']:.3f} ms ({100 * denoise['busy']:.2f}% busy, "
        f"{denoise['kernels_a_step']:.0f} kernels a step); by kind: "
        f"{_kernel_groups(kernels, busy_ms)}")
    log(f"[generate] flash kernels a step: {_flash_per_step(kernels, GEN_TRACED_STEPS)}")
    for t_us, count, key in kernels[:8]:
        log(f"[generate]   {t_us / 1e3:9.3f} ms {100 * t_us / 1e3 / busy_ms:6.2f}% "
            f"x{count:<5d} {key[:90]}")
    del model, sample, x

    # the served path, on the chain cut to GEN_SEED_STEPS steps: make_server's warm-up, then
    # one /v1/generate request
    n_short = time_steps(short)
    want = {**want, "flash_fwd": len(shapes) * n_short, "src:flash_fwd_tf32": len(shapes) * n_short}
    want_instances = _expected_instances(shapes, n_short, backward=False)
    reset_launch_counts()
    t0 = time.perf_counter()
    server = make_server(short, host="127.0.0.1", port=0, device="cuda",
                         num_generate=GEN_SAMPLES)
    startup_s = time.perf_counter() - t0
    warm = _launch_counts()
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    port = server.server_address[1]
    try:
        health = _get_json(port, "/healthz")
        reset_launch_counts()
        t0 = time.perf_counter()
        body = _request(port, "POST", "/v1/generate",
                        json.dumps({"seed": 0, "num": GEN_SAMPLES}).encode())
        latency_s = time.perf_counter() - t0
        served_counts, served_instances = _launch_counts(), _instance_counts()
        served = np.load(io.BytesIO(body))
        try:
            _request(port, "POST", "/v1/predict", b"not an image")
            predict = "200"
        except RuntimeError as e:
            predict = str(e)
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=30)
    same = served.shape == img_shape and np.array_equal(served, chains[1][1])
    log(f"[generate] make_server --num-generate {GEN_SAMPLES} ({n_short} steps): startup "
        f"{startup_s:.2f} s (its "
        f"warm-up launched {warm['flash_fwd']} forwards); /healthz {health}; POST /v1/generate "
        f"seed 0: {latency_s:.3f} s, {served.shape} {served.dtype}, launches {served_counts}; "
        f"the same images as generate_diffusion's for seed 0: {same}; /v1/predict: "
        f"{predict[:120]}")
    if health != {"status": "ok", "task": "diffusion"} or warm["flash_fwd"] != len(shapes) \
            or any(v for k, v in warm.items() if k.startswith("flash_bwd")):
        fail(f"the diffusion server's start: /healthz {health}, warm-up launches {warm}")
    if served_counts != want or served_instances != want_instances or not same:
        fail(f"/v1/generate launched {served_counts} (expected {want}) and answered "
             f"{served.shape}, the direct chain's images for its seed: {same}")
    if "HTTP 400" not in predict:
        fail(f"/v1/predict on a diffusion deployment answered {predict}")
    return {"instances": chains[0][2], "served_instances": served_instances,
            "samples_s": [chains[0][0]], "denoise": denoise, "latency_s": latency_s}


def _parity_config(work: str, jpeg_root: str, name: str, **trainer) -> str:
    """A copy of configs/catsdogs/classification/base_config.yaml on the JPEG files at
    `jpeg_root`: the split's first 0.9 to train on and the rest held out, a batch of
    PARITY_BATCH, PARITY_EPOCHS epochs with validation after each, checkpoints and
    metrics of `name` under `work` (and the `trainer` keys given here); its path."""
    import yaml

    raw = yaml.safe_load(open(CONFIG))
    raw["data"].update(dict_root_dirs={"catsdogs": jpeg_root}, batch_size=PARITY_BATCH,
                       dict_end_idx={"catsdogs": 0.9}, val_dict_start_idx={"catsdogs": 0.9},
                       val_dict_end_idx={"catsdogs": 1.0})
    raw["trainer"].update({"checkpoint_path": os.path.join(work, f"ck_{name}"),
                           "checkpoint_filename_for_loading": "multi_last_latest",
                           "metrics_path": os.path.join(work, f"{name}.jsonl"),
                           "max_epochs": PARITY_EPOCHS, "val_every": 1,
                           "val_batches": PARITY_VAL_BATCHES, **trainer})
    path = os.path.join(work, f"{name}.yaml")
    with open(path, "w") as f:
        yaml.safe_dump(raw, f)
    return path


def _records(work: str, name: str) -> list:
    return [json.loads(line) for line in open(os.path.join(work, f"{name}.jsonl"))]


def _sigterm_run(path: str) -> tuple:
    """The trainer's CLI on `path` in a process of its own; SIGTERM right after the
    log line of step SIGTERM_AFTER. Returns (exit code, its output, seconds from the
    signal to the exit). The process is killed, and the phase fails, if the line or
    the exit does not come within SIGTERM_DEADLINE_S."""
    import queue
    import signal

    proc = subprocess.Popen([sys.executable, "-m", "ucf_vit_tpu_torch.train", path], cwd=REPO,
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    lines: queue.Queue = queue.Queue()

    def read():
        for line in proc.stdout:
            lines.put(line)
        lines.put(None)

    reader = threading.Thread(target=read, daemon=True)
    reader.start()
    seen, deadline, signalled = [], time.monotonic() + SIGTERM_DEADLINE_S, None
    try:
        while signalled is None:
            try:
                line = lines.get(timeout=max(deadline - time.monotonic(), 0.01))
            except queue.Empty:
                fail(f"the trainer logged no step {SIGTERM_AFTER} within {SIGTERM_DEADLINE_S} s:"
                     f"\n{''.join(seen)[-2000:]}")
            if line is None:
                fail(f"the trainer exited before step {SIGTERM_AFTER}:\n{''.join(seen)[-2000:]}")
            seen.append(line)
            if line.startswith(f"epoch 0 it {SIGTERM_AFTER} "):
                proc.send_signal(signal.SIGTERM)
                signalled = time.perf_counter()
        try:
            proc.wait(timeout=max(deadline - time.monotonic(), 1.0))
        except subprocess.TimeoutExpired:
            fail(f"the trainer did not exit within {SIGTERM_DEADLINE_S} s of its start")
        exit_s = time.perf_counter() - signalled
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    reader.join(timeout=30)
    while not lines.empty():
        line = lines.get()
        if line is not None:
            seen.append(line)
    return proc.returncode, "".join(seen), exit_s


def phase_trainer_parity(jpeg_root: str, mae_ckpt: str) -> dict:
    """The trainer's and inference's entry points beside training itself.
    (a) catsdogs ViT-B/16 at full width from JPEG files (`_parity_config`): through the
    CLI entry twice uninterrupted (the spread of two runs; the first with
    `profile_dir`, whose trace must name the tf32 flash kernels), and once stopped by
    `preempt_after_steps` in the middle of epoch 0 and resumed; the resumed run's
    (epoch, it) records, per-step and validation losses against the uninterrupted
    one's to PARITY_LOSS_TOL; the launch counts of each run exact, validation's
    forwards included. (b) SIGTERM to the CLI in a process of its own: exit code 0,
    the `preempted in epoch` line, a checkpoint at `data_it` that a resumed run
    continues from the next step. (c) The inference CLI (`--checkpoint`) on (a)'s
    checkpoint: top-1 under FLASH equal to EINSUM's, logits within FLASH_TOL; the
    diffusion branch, `--num-samples 2` on imagenet's DiffusionVIT, its chain cut
    to PARALLEL_CHAIN_STEPS steps (PNGs where matplotlib imports). (d) MAE `/v1/predict` at mae_long's full width from
    phase_train_disk's checkpoint, max_batch 2: a lone request's latency, requests/s
    under MAE_SERVE_CLIENTS closed-loop clients, the busy share of a traced window,
    launches by kernel instance (exact a batch), and each answer against
    `inference.reconstruct` of its sample alone."""
    import numpy as np
    import torch

    from ucf_vit_tpu_torch.checkpoint import restore_checkpoint
    from ucf_vit_tpu_torch.config import load_config
    from ucf_vit_tpu_torch.inference import init_eval_model, load_weights, main as infer_main
    from ucf_vit_tpu_torch.inference import reconstruct
    from ucf_vit_tpu_torch.ops.flash_attention import kernel_instance, reset_launch_counts
    from ucf_vit_tpu_torch.serve import make_server
    from ucf_vit_tpu_torch.tasks import time_steps
    from ucf_vit_tpu_torch.train import build_dataloader, main as train_main, synthetic_batches

    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    work = tempfile.mkdtemp(prefix="parity_", dir=WORK)
    try:
        # (a) uninterrupted twice, then preempted by the drill and resumed
        cfg = load_config(_parity_config(work, jpeg_root, "probe"))
        depth = int(cfg.init_args["depth"])
        per_epoch = build_dataloader(cfg, PARITY_BATCH, False)[2]["catsdogs"]
        val_per_epoch = build_dataloader(cfg, PARITY_BATCH, False, val_split=True)[2]["catsdogs"]
        if per_epoch < PARITY_PREEMPT + 2 or val_per_epoch < 1:
            fail(f"the split holds {per_epoch} batches to train on and {val_per_epoch} held out")

        def want(steps, val_passes):
            counts = _expected_counts([VIT_ATTN] * depth, steps, dropout=False)
            extra = depth * PARITY_VAL_BATCHES * val_passes  # forwards only
            counts["flash_fwd"] += extra
            counts["src:flash_fwd_tf32"] += extra
            return counts

        prof_dir = os.path.join(work, "prof")
        plan = (("whole", {"profile_dir": prof_dir}, PARITY_EPOCHS * per_epoch, PARITY_EPOCHS),
                ("again", {}, PARITY_EPOCHS * per_epoch, PARITY_EPOCHS),
                ("part", {"preempt_after_steps": PARITY_PREEMPT}, PARITY_PREEMPT, 0),
                ("part", {"resume_from_checkpoint": True},
                 PARITY_EPOCHS * per_epoch - PARITY_PREEMPT, PARITY_EPOCHS))
        runs = []
        for name, extra, steps, passes in plan:
            path = _parity_config(work, jpeg_root, name, **extra)
            reset_launch_counts()
            t0 = time.perf_counter()
            with _Tee() as tee:
                train_main([path])
            wall = time.perf_counter() - t0
            counts = _launch_counts()
            runs.append((name, wall, tee.text(), counts))
            if counts != want(steps, passes):
                fail(f"trainer run {name} {extra} launched {counts}, expected "
                     f"{want(steps, passes)}")
        texts = {i: r[2] for i, r in enumerate(runs)}
        whole, again, part = (_records(work, n) for n in ("whole", "again", "part"))

        def steps_of(recs):
            return [(r["epoch"], r["it"]) for r in recs if "loss" in r]

        def losses_of(recs, key):
            return np.array([r[key] for r in recs if key in r])

        sequence = [(e, i) for e in range(PARITY_EPOCHS) for i in range(1, per_epoch + 1)]
        spread, diff = {}, {}
        for key in ("loss", "val_loss"):
            w, a, p = (losses_of(r, key) for r in (whole, again, part))
            if not (len(w) == len(a) == len(p)) or not np.all(np.isfinite(p)):
                fail(f"{key}: {len(w)}, {len(a)} and {len(p)} records (uninterrupted twice, "
                     f"resumed), finite {np.all(np.isfinite(p))}")
            spread[key], diff[key] = float(np.abs(w - a).max()), float(np.abs(w - p).max())
        stops = re.findall(r"preempted in epoch 0 after (\d+) its: saved", texts[2])
        resumed = f"resumed mid-epoch: epoch 0, fast-forwarding {PARITY_PREEMPT} batches" in texts[3]
        read_s = [float(x) for x in re.findall(r"checkpoint read in ([\d.]+) s", texts[3])]
        val_ms = [1e3 * float(t) / int(n) for n, t in
                  re.findall(r"val loss \S+ \((\d+) batches in ([\d.]+) s\)", texts[0])]
        ms_it = [float(m) for m in re.findall(r"epoch \d+ it \d+ loss \S+ ([\d.]+) ms/it",
                                              texts[0])]
        log(f"[parity] catsdogs ViT-B/16 f32 from {per_epoch * PARITY_BATCH} JPEGs (batch "
            f"{PARITY_BATCH}, {per_epoch} steps an epoch, {val_per_epoch} held-out batch(es) a "
            f"pass): runs {', '.join(f'{r[0]} {r[1]:.2f} s' for r in runs)}; "
            f"ms/step median {sorted(ms_it)[len(ms_it) // 2]:.1f}; validation "
            f"{', '.join(f'{v:.1f}' for v in val_ms)} ms a batch; val losses "
            f"{losses_of(whole, 'val_loss').tolist()}")
        log(f"[parity] two uninterrupted runs differ by {spread['loss']:.3e} a step and "
            f"{spread['val_loss']:.3e} a validation; preempted after {stops} its and resumed "
            f"(checkpoint read in {read_s} s, the resumed run {runs[3][1]:.2f} s): "
            f"{diff['loss']:.3e} and {diff['val_loss']:.3e} from the first (limit "
            f"{PARITY_LOSS_TOL:g})")
        if steps_of(whole) != sequence or steps_of(again) != sequence \
                or steps_of(part) != sequence:
            fail(f"(epoch, it) records: {steps_of(part)} resumed, {steps_of(whole)} "
                 f"uninterrupted, expected {sequence}")
        if stops != [str(PARITY_PREEMPT)] or not resumed or not read_s:
            fail(f"the drill stopped after {stops} its; the resume fast-forwarded: {resumed}")
        if max(spread.values()) > PARITY_LOSS_TOL or max(diff.values()) > PARITY_LOSS_TOL:
            fail("the resumed run differs from the uninterrupted one beyond PARITY_LOSS_TOL")
        traces = os.listdir(prof_dir) if os.path.isdir(prof_dir) else []
        trace = open(os.path.join(prof_dir, traces[0])).read() if len(traces) == 1 else ""
        named = {k: trace.count(k) for k in ("flash_fwd_tf32_kernel", "flash_bwd_tf32_kernel")}
        log(f"[parity] profile_dir: {traces} ({len(trace) / 1e6:.1f} MB), kernel names {named}")
        if not all(named.values()):
            fail(f"the profile_dir trace names the flash kernels {named}")

        # (b) SIGTERM to the CLI in its own process, then a resumed run in this one
        path = _parity_config(work, jpeg_root, "sigterm", max_epochs=1, val_every=0)
        rc, text, exit_s = _sigterm_run(path)
        stop = re.search(r"preempted in epoch 0 after (\d+) its: saved (\S+)", text)
        n = int(stop.group(1)) if stop else -1
        payload = restore_checkpoint(os.path.join(work, "ck_sigterm"), "multi_last_latest") \
            if stop else {}
        log(f"[parity] SIGTERM after step {SIGTERM_AFTER}'s line: exit code {rc} "
            f"{exit_s:.2f} s after the signal; {stop.group(0) if stop else 'no preemption line'}"
            f"; checkpoint epoch {payload.get('epoch')}, data_it {payload.get('data_it')}")
        if rc != 0 or not stop or not SIGTERM_AFTER <= n < per_epoch \
                or (payload["epoch"], payload["data_it"], payload["total_steps"]) != (0, n, n):
            fail(f"SIGTERM: exit code {rc}, output ends {text[-1500:]}")
        path = _parity_config(work, jpeg_root, "sigterm", max_epochs=1, val_every=0,
                              resume_from_checkpoint=True)
        with _Tee() as tee:
            train_main([path])
        recs = _records(work, "sigterm")
        start = max(i for i, r in enumerate(recs) if r.get("run_start"))
        cont = [(r["epoch"], r["it"]) for r in recs[start + 1:] if "loss" in r]
        if recs[start]["resume_it"] != n or cont != [(0, i) for i in range(n + 1, per_epoch + 1)] \
                or f"fast-forwarding {n} batches" not in tee.text():
            fail(f"the run resumed after SIGTERM logged {recs[start]} then {cont}")
        log(f"[parity] resumed after SIGTERM: epoch 0 from step {n + 1} to {per_epoch}")

        # (c) the inference CLI on (a)'s checkpoint, FLASH and EINSUM; then diffusion
        ck = os.path.join(work, "ck_whole")
        n_eval = per_epoch * PARITY_BATCH
        top1, evals, logits = {}, {}, {}
        for impl in ("FLASH", "EINSUM"):
            path = _parity_config(work, jpeg_root, f"eval_{impl}", attn_impl=impl)
            reset_launch_counts()
            t0 = time.perf_counter()
            with _Tee() as tee:
                top1[impl] = infer_main([path, "--checkpoint", ck, "--num-samples", str(n_eval)])
            evals[impl] = (time.perf_counter() - t0, _launch_counts()["flash_fwd"])
            ecfg = load_config(path)
            model = init_eval_model(ecfg, device="cuda")
            load_weights(model, ecfg, ck)
            x = next(iter(build_dataloader(ecfg, PARITY_BATCH, False)[0].train_dataloader()))["x"]
            with torch.inference_mode():
                logits[impl] = model(torch.from_numpy(x).cuda()).cpu().numpy()
            del model
        logit_diff = float(np.abs(logits["FLASH"] - logits["EINSUM"]).max())
        log(f"[parity] python -m ucf_vit_tpu_torch.inference --checkpoint <(a)'s> --num-samples "
            f"{n_eval}: top-1 {top1['FLASH']:.4f} (FLASH, {evals['FLASH'][0]:.2f} s, "
            f"{evals['FLASH'][1]} forwards), {top1['EINSUM']:.4f} (EINSUM, "
            f"{evals['EINSUM'][0]:.2f} s); logits of a batch differ by {logit_diff:.3e} (limit "
            f"{FLASH_TOL['float32']:g}); the shipped config has no EMA, so no --ema")
        if top1["FLASH"] != top1["EINSUM"] or logit_diff > FLASH_TOL["float32"] \
                or evals["FLASH"][1] != depth * (n_eval // PARITY_BATCH) or evals["EINSUM"][1]:
            fail("the inference CLI's evaluation under FLASH disagrees with EINSUM's")
        try:
            import matplotlib  # noqa: F401

            png_dir = os.path.join(work, "png")
        except ImportError:
            png_dir = None
            log("[parity] matplotlib does not import here: the diffusion evaluation writes "
                "no PNGs")
        # imagenet/diffusion's chain cut to PARALLEL_CHAIN_STEPS steps (the whole chain runs
        # in phase_generate)
        dpath = _parallel_config("parity_chain", DIFF_CONFIGS["imagenet"], {},
                                 init_args={"num_time_steps": PARALLEL_CHAIN_STEPS})
        dcfg = load_config(dpath)
        reset_launch_counts()
        t0 = time.perf_counter()
        sps = infer_main([dpath, "--num-samples", "2"]
                         + (["--png-dir", png_dir] if png_dir else []))
        gen_s, gen_instances = time.perf_counter() - t0, _instance_counts()
        gen_want = _expected_instances(_attn_shapes(init_eval_model(dcfg, device="cuda")),
                                       time_steps(dcfg), backward=False)
        pngs = sorted(os.listdir(png_dir)) if png_dir else []
        log(f"[parity] python -m ucf_vit_tpu_torch.inference <imagenet/diffusion, "
            f"{PARALLEL_CHAIN_STEPS} steps> --num-samples 2: {sps:.4f} samples/s ({gen_s:.2f} s "
            f"with the init); PNGs {pngs}")
        if gen_instances != gen_want or (png_dir and pngs != ["generated_0.png",
                                                              "generated_1.png"]):
            fail(f"the diffusion evaluation launched {gen_instances} (expected {gen_want}), "
                 f"wrote {pngs}")
        shutil.rmtree(work)  # the ViT-B checkpoints; the MAE server needs the room

        # (d) MAE /v1/predict at mae_long's full width from phase_train_disk's checkpoint
        mcfg = _single_device(MAE_CONFIG)
        samples = next(synthetic_batches(mcfg, MAE_SERVE_CLIENTS, seed=1))["x"]
        bodies = []
        for x in samples:
            buf = io.BytesIO()
            np.save(buf, x)
            bodies.append(buf.getvalue())
        t0 = time.perf_counter()
        server = make_server(mcfg, mae_ckpt, host="127.0.0.1", port=0,
                             max_batch=MAE_SERVE_BATCH, device="cuda")
        startup_s = time.perf_counter() - t0
        thread = threading.Thread(target=server.serve_forever, daemon=True)
        thread.start()
        port = server.server_address[1]
        ctx = multiprocessing.get_context("spawn")
        pipe, child_pipe = ctx.Pipe()
        client = ctx.Process(target=_load_client, args=(port, bodies, child_pipe, True),
                             daemon=True)
        client.start()
        prof = torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA])
        windows, answers = {}, {}
        try:
            lone = []
            for _ in range(3):
                t1 = time.perf_counter()
                answers.setdefault(0, []).append(np.load(io.BytesIO(
                    _request(port, "POST", "/v1/predict", bodies[0]))))
                lone.append(time.perf_counter() - t1)
            reset_launch_counts()
            before_all = _get_json(port, "/v1/stats")
            for name, seconds in MAE_SERVE_WINDOWS_S.items():
                before = _get_json(port, "/v1/stats")
                if name == "traced":
                    prof.start()
                pipe.send(seconds)
                if not pipe.poll(seconds + 300):
                    fail(f"the MAE load client gave no result for the {name} window")
                res = pipe.recv()
                if name == "traced":
                    prof.stop()
                if res["errors"] or not res["requests"]:
                    fail(f"MAE load client, {name} window: {len(res['requests'])} answers, "
                         f"errors {res['errors'][:3]}")
                windows[name] = (res, before, _get_json(port, "/v1/stats"))
                for i, _, a in res["requests"]:
                    if a is not None:
                        answers.setdefault(i, []).append(a)
            instances, counts = _instance_counts(), _launch_counts()
            after_all = _get_json(port, "/v1/stats")
            pipe.send(None)
            client.join(timeout=30)
            model = server.RequestHandlerClass.weights_holder["model"]
            worst = 0.0
            for i, got in answers.items():
                want_i = reconstruct(model, torch.from_numpy(samples[i:i + 1]).cuda(),
                                     seed=0)[0].float().cpu().numpy()
                scale = float(np.abs(want_i).max())
                for a in got:
                    if a.shape != want_i.shape or not np.all(np.isfinite(a)):
                        fail(f"an MAE answer of shape {a.shape}, expected {want_i.shape}")
                    worst = max(worst, float(np.abs(a - want_i).max()) / scale)
        finally:
            if client.is_alive():
                client.terminate()
                client.join()
            server.shutdown()
            server.server_close()
            server.RequestHandlerClass.batcher.close()
            thread.join(timeout=30)
        batches = after_all["batches"] - before_all["batches"]
        per_batch = {}
        for n_q, n_kv, dh in _attn_shapes(model):
            key = "fwd:" + kernel_instance("flash_fwd_sm90", dh)
            per_batch[key] = per_batch.get(key, 0) + 1
        got_instances = {k: v for k, v in instances.items() if v}
        want_instances = {k: v * batches for k, v in per_batch.items()}
        kernels = sorted(((e.self_device_time_total, e.count, e.key) for e in prof.key_averages()
                          if e.self_device_time_total > 0), reverse=True)
        busy_ms = sum(k[0] for k in kernels) / 1e3
        res, before, after = windows["load"]
        lat = np.array([r[1] for r in res["requests"]]) * 1e3
        rps = len(res["requests"]) / res["wall_s"]
        traced_s = windows["traced"][0]["wall_s"]
        fill = ((after["batch_fill_sum"] - before["batch_fill_sum"])
                / max(after["batches"] - before["batches"], 1))
        log(f"[parity] MAE /v1/predict (mae_long, bf16, {samples.shape[1:]} volumes, max_batch "
            f"{MAE_SERVE_BATCH}) from {os.path.basename(mae_ckpt)}: startup {startup_s:.2f} s; a "
            f"lone request {', '.join(f'{1e3 * t:.1f}' for t in lone)} ms; "
            f"{MAE_SERVE_CLIENTS} closed-loop clients: {len(res['requests'])} requests in "
            f"{res['wall_s']:.3f} s = {rps:.3f} requests/s (mean fill {fill:.2f}); latency p50 "
            f"{np.percentile(lat, 50):.1f} p90 {np.percentile(lat, 90):.1f} max {lat.max():.1f} "
            f"ms; traced window busy {busy_ms:.3f} of {1e3 * traced_s:.3f} ms = "
            f"{100 * busy_ms / (1e3 * traced_s):.2f}%")
        for t_us, count, key in kernels[:6]:
            log(f"[parity]   {t_us / 1e3:9.3f} ms {100 * t_us / 1e3 / busy_ms:6.2f}% "
                f"x{count:<5d} {key[:90]}")
        log(f"[parity] MAE predict launches by instance over {batches} batches: {got_instances} "
            f"(expected {want_instances}); {sum(len(v) for v in answers.values())} answers "
            f"against reconstruct of the sample alone: {worst:.3e} of the largest entry (limit "
            f"{MAE_SERVE_TOL:g})")
        if busy_ms <= 0 or got_instances != want_instances or worst > MAE_SERVE_TOL \
                or after_all["errors"]:
            fail("MAE /v1/predict: launches, answers or the traced window are off")
        log(f"[parity] phase_trainer_parity took {time.perf_counter() - t_phase:.1f} s")
        return {"f32": runs[0][3], "predict": counts, "generate": gen_instances,
                "val_ms": val_ms, "read_s": read_s, "rps": rps, "lone_ms":
                1e3 * min(lone), "busy": busy_ms / (1e3 * traced_s)}
    finally:
        shutil.rmtree(work, ignore_errors=True)


# ---------------------------------------------------------------- two checkouts

COMPARE_CALLS, COMPARE_WINDOWS = 2000, 9


def _adaptive_attn_shapes(model) -> list:
    """(Nq, Nkv, dh) of each flash call of an adaptive model: `_attn_shapes`,
    without an MAE encoder that packs samples (seq_pack > 1 attends by segments
    through EINSUM, no kernel)."""
    shapes = _attn_shapes(model)
    if getattr(model, "seq_pack", 1) > 1:
        shapes = shapes[len(model.blocks):]
    return shapes


def _adaptive_config(path: str, name: str, **data) -> str:
    """A copy of the shipped config under WORK, single-device, its checkpoints
    under WORK, `data` keys set; returns its path."""
    import yaml

    with open(path) as fh:
        raw = yaml.safe_load(fh)
    raw["parallelism"] = {"fsdp_size": 1, "simple_ddp_size": 1, "tensor_par_size": 1,
                          "seq_par_size": 1}
    raw["trainer"]["checkpoint_path"] = os.path.join(WORK, f"ck_{name}")
    raw["data"].update(data)
    out = os.path.join(WORK, f"{name}.yaml")
    with open(out, "w") as fh:
        yaml.safe_dump(raw, fh)
    return out


def _adaptive_cli(tag: str, argv: list, steps: int, check_model) -> dict:
    """The trainer's CLI entry with the launch counts set to 0 before it: the
    model must be the shipped one (`check_model`), every launch under the
    tf32 sources at the instances its attention shapes give. Returns the
    counts by instance."""
    import numpy as np

    from ucf_vit_tpu_torch.ops.flash_attention import reset_launch_counts
    from ucf_vit_tpu_torch.train import main as train_main

    reset_launch_counts()
    t0 = time.perf_counter()
    out = train_main(argv)
    counts, instances = _launch_counts(), _instance_counts()
    model = out["state"].model
    check_model(model)
    shapes = _adaptive_attn_shapes(model)
    want = _expected_instances(shapes, steps)
    log(f"[adaptive] {tag}: python -m ucf_vit_tpu_torch.train {' '.join(argv[1:])}: "
        f"{time.perf_counter() - t0:.2f} s (init and save included); epoch losses "
        f"{out['loss_list']}; launches {counts}; by instance a step "
        f"{ {k: n // steps for k, n in instances.items() if n} }")
    if (instances != want or counts["src:flash_fwd_sm90"] or counts["src:flash_bwd_sm90"]
            or counts["flash_bwd_dkv"] or counts["flash_bwd_dq"]
            or not all(np.isfinite(out["loss_list"]))):
        fail(f"{tag} through the CLI launched {instances} (expected {want}), {counts}; "
             f"losses {out['loss_list']}")
    del out, model
    return instances


def _flash_against_einsum(tag: str, cfg, batches) -> tuple:
    """`_run_steps` under FLASH and under EINSUM from one init on `batches`: the
    per-step losses within TRAIN_LOSS_TOL, the first step's gradients within
    TRAIN_GRAD_TOL of the largest entry, FLASH's launches at the instances the
    model's shapes give and none under EINSUM. Returns FLASH's (state, step)."""
    import numpy as np

    runs = {}
    for impl in ("FLASH", "EINSUM"):
        st, sp, losses, grads, counts = _run_steps(_train_cfg(cfg, impl), batches)
        runs[impl] = (st, sp, losses, grads, counts, _instance_counts())
    (st, sp, lf, gf, cf, inf), (ste, _, le, ge, ce, _) = runs["FLASH"], runs["EINSUM"]
    del ste
    diff = max(abs(a - b) for a, b in zip(lf, le))
    gmax = max(g.abs().max().item() for g in ge.values())
    gdiff = max((gf[n] - ge[n]).abs().max().item() for n in ge)
    want = _expected_instances(_adaptive_attn_shapes(st.model), len(batches))
    log(f"[adaptive] {tag} FLASH vs EINSUM, {len(batches)} steps: losses FLASH "
        f"{' '.join(f'{x:.6f}' for x in lf)}, EINSUM {' '.join(f'{x:.6f}' for x in le)}; max "
        f"|diff| {diff:.3e} (tol {TRAIN_LOSS_TOL:g}); first-step gradients max |diff| "
        f"{gdiff / gmax:.3e} of the largest entry (tol {TRAIN_GRAD_TOL:g})")
    if not all(np.isfinite(lf)) or diff > TRAIN_LOSS_TOL or gdiff > TRAIN_GRAD_TOL * gmax:
        fail(f"{tag}: FLASH training disagrees with EINSUM's")
    if inf != want or any(ce.values()):
        fail(f"{tag}: launches {inf} under FLASH (expected {want}), {ce} under EINSUM")
    return st, sp


def _patchify_costs(images) -> dict:
    """Host ms a sample of the quadtree patchify (`Patchify`, edge map, native
    tree and serialization) on `images` [N, H, W, 3] uint8, and of the tree's
    native and numpy builds on their Canny edge maps."""
    import cv2
    import numpy as np

    from ucf_vit_tpu_torch import native
    from ucf_vit_tpu_torch.data.quadtree import quadtree_boxes_plain
    from ucf_vit_tpu_torch.data.transform import Patchify

    pf = Patchify(fixed_length=196, patch_size=16, num_channels=3, dataset="imagenet",
                  rng=np.random.default_rng(0))
    pf(images[0])
    t0 = time.perf_counter()
    for img in images:
        pf(img)
    patchify_ms = 1e3 * (time.perf_counter() - t0) / len(images)
    edges = [cv2.Canny(cv2.GaussianBlur(img, (3, 3), 0), 75, 125) for img in images]
    times = {}
    for name, build in (("native", native.quadtree_boxes), ("numpy", quadtree_boxes_plain)):
        t0 = time.perf_counter()
        trees = [build(e, 196) for e in edges]
        times[name] = 1e3 * (time.perf_counter() - t0) / len(edges)
        if name == "native":
            native_trees = trees
    for (b1, v1), (b2, v2) in zip(native_trees, trees):
        if not (np.array_equal(b1, b2) and np.array_equal(v1, v2)):
            fail("the native quadtree differs from its numpy build")
    log(f"[adaptive] quadtree patchify of a 256 x 256 x 3 image (edge map, native tree, 196 "
        f"bicubic patches of 16^2): {patchify_ms:.3f} ms a sample on the host; the tree "
        f"alone {times['native']:.4f} ms native, {times['numpy']:.4f} ms numpy (the same "
        f"boxes and values on {len(edges)} Canny maps)")
    return {"patchify_ms": patchify_ms, "tree_native_ms": times["native"],
            "tree_numpy_ms": times["numpy"]}


def _loader_alone(it, n: int) -> tuple:
    """(batches, host ms a batch) of `n` batches pulled back to back."""
    batches, t0 = [], time.perf_counter()
    for _ in range(n):
        batches.append(next(it))
    return batches, 1e3 * (time.perf_counter() - t0) / n


def _adaptive_from_files() -> dict:
    """(a) imagenet/classification from seeded JPEGs through the DataModule."""
    import numpy as np
    import torch
    from PIL import Image

    from ucf_vit_tpu_torch.config import load_config
    from ucf_vit_tpu_torch.data.pipeline import read_imagenet_file
    from ucf_vit_tpu_torch.models import VIT
    from ucf_vit_tpu_torch.models.blocks import LinearTokenEmbed
    from ucf_vit_tpu_torch.train import build_dataloader

    root = os.path.join(WORK, "imagenet_jpegs")
    rng = np.random.default_rng(5)
    h, w = JPEG_SHAPE
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    t0 = time.perf_counter()
    for i in range(ADAPTIVE_JPEGS):
        cls_dir = os.path.join(root, f"n{i % ADAPTIVE_CLASSES:08d}")
        os.makedirs(cls_dir, exist_ok=True)
        f = rng.uniform(0.005, 0.05, size=(3, 2))
        img = np.stack([128 + 90 * np.sin(f[c, 0] * yy) * np.cos(f[c, 1] * xx)
                        for c in range(3)], axis=-1)
        img += rng.normal(0, 12, size=img.shape)
        Image.fromarray(np.clip(img, 0, 255).astype(np.uint8)).save(
            os.path.join(cls_dir, f"img_{i}.JPEG"), quality=90)
    log(f"[adaptive] wrote {ADAPTIVE_JPEGS} JPEGs of {w} x {h} in {ADAPTIVE_CLASSES} class "
        f"folders in {time.perf_counter() - t0:.2f} s")
    files = sorted(os.path.join(d, f) for d, _, fs in os.walk(root) for f in fs)
    images = [np.moveaxis(read_imagenet_file(p), 0, -1) for p in files[:32]]
    costs = _patchify_costs(np.stack(images))

    path = _adaptive_config(ADAPTIVE_CLS_CONFIG, "imagenet_classification",
                            dict_root_dirs={"imagenet": root})
    cfg = load_config(path)
    batch = cfg.batch_size

    def check_model(model):
        if not (isinstance(model, VIT) and isinstance(model.token_embeds, LinearTokenEmbed)
                and model.adaptive_pos_dep_emb is not None and model.num_patches == 196
                and model.embed_dim == 768 and len(model.blocks) == 12
                and model.head.out_features == 1000 and model.dtype is None):
            fail("the imagenet/classification run was not the shipped adaptive ViT-B/16")

    instances = _adaptive_cli("imagenet/classification from JPEG files",
                              [path, "--single-device", "--max-steps",
                               str(ADAPTIVE_MAIN_STEPS)], ADAPTIVE_MAIN_STEPS, check_model)

    # the loader alone, as shipped (num_workers 1: in line, in the prefetch thread)
    n = ADAPTIVE_WARMUP + ADAPTIVE_TIMED
    dm, _, bpre = build_dataloader(cfg, batch, False)
    it = dm.train_dataloader(loop=True)
    batches, loader_ms = _loader_alone(it, n)
    it.close()
    b0 = batches[0]
    if (b0["seq"].shape != (batch, 3, 196, 256) or b0["seq_size"].shape != (batch, 1, 196)
            or b0["seq_pos"].shape != (batch, 1, 196, 2) or bpre != {"imagenet": 3}):
        fail(f"the adaptive loader gave seq {b0['seq'].shape}, seq_size "
             f"{b0['seq_size'].shape}, seq_pos {b0['seq_pos'].shape}; {bpre} batches an epoch")
    log(f"[adaptive] the loader alone (num_workers 1, in line): {n} batches of {batch} = "
        f"{loader_ms:.1f} ms a batch ({loader_ms / batch:.2f} ms a sample: JPEG decode, resize, "
        f"patchify)")

    # FLASH against EINSUM on those batches, then windows on the live loader
    state, step = _flash_against_einsum("imagenet/classification", cfg, batches)
    res = {"loader_ms": loader_ms, **costs, "instances": instances}
    for workers in (1, ADAPTIVE_POOL):
        wcfg = load_config(_adaptive_config(ADAPTIVE_CLS_CONFIG, f"cls_w{workers}",
                                            dict_root_dirs={"imagenet": root},
                                            num_workers=workers))
        dm, _, _ = build_dataloader(wcfg, batch, False)
        it = dm.train_dataloader(loop=True)
        try:
            if workers > 1:  # the pool's start-up (spawning its processes) left out
                _loader_alone(it, 1)
                _, res["pool_loader_ms"] = _loader_alone(it, ADAPTIVE_TIMED)
            _disk_window(state, step, it, ADAPTIVE_WARMUP)
            torch.cuda.reset_peak_memory_stats()
            wall, waited = _disk_window(state, step, it, ADAPTIVE_TIMED)
            key = "inline" if workers == 1 else "pool"
            res[key] = {"ms_step": 1e3 * wall / ADAPTIVE_TIMED,
                        "images_s": batch * ADAPTIVE_TIMED / wall,
                        "wait_ms": 1e3 * waited / ADAPTIVE_TIMED,
                        "peak_gb": torch.cuda.max_memory_allocated() / 1e9}
            log(f"[adaptive] imagenet/classification batch {batch} from files, num_workers "
                f"{workers}{' (a spawn pool of ' + str(workers - 1) + ')' if workers > 1 else ''}"
                f": {ADAPTIVE_TIMED} steps in {wall:.4f} s = {res[key]['ms_step']:.3f} ms/step, "
                f"{res[key]['images_s']:.2f} images/s; waiting for batches "
                f"{res[key]['wait_ms']:.2f} ms a step; peak {res[key]['peak_gb']:.2f} GB")
            if workers > 1:
                prof = torch.profiler.profile(
                    activities=[torch.profiler.ProfilerActivity.CUDA])
                prof.start()
                traced_s, _ = _disk_window(state, step, it, ADAPTIVE_TRACED)
                prof.stop()
                kernels = sorted(((e.self_device_time_total, e.count, e.key)
                                  for e in prof.key_averages() if e.self_device_time_total > 0),
                                 reverse=True)
                busy_ms = sum(k[0] for k in kernels) / 1e3
                if busy_ms <= 0:
                    fail("the traced adaptive window saw no work on the card")
                res.update(busy=busy_ms / (1e3 * traced_s),
                           device_step_ms=busy_ms / ADAPTIVE_TRACED)
                log(f"[adaptive] traced window ({ADAPTIVE_TRACED} steps on the pooled "
                    f"loader): device busy {busy_ms:.3f} ms of {1e3 * traced_s:.3f} ms = "
                    f"{100 * res['busy']:.2f}%, {res['device_step_ms']:.3f} ms of device time "
                    f"a step; by kind: {_kernel_groups(kernels, busy_ms)}; flash a step: "
                    f"{_flash_per_step(kernels, ADAPTIVE_TRACED)}")
        finally:
            it.close()
    log(f"[adaptive] the pooled loader alone: {res['pool_loader_ms']:.1f} ms a batch")
    del state, step
    res.update(root=root, path=path)
    return res


def _adaptive_mae(name: str, path: str) -> dict:
    """(b) an adaptive MAE as shipped on the synthetic stream."""
    import torch

    from ucf_vit_tpu_torch.config import load_config
    from ucf_vit_tpu_torch.models import MAE
    from ucf_vit_tpu_torch.train import synthetic_batches

    torch.cuda.empty_cache()
    tag = name.replace("/", "_")
    path = _adaptive_config(path, tag)
    cfg = load_config(path)
    ia = cfg.init_args

    def check_model(model):
        if not (isinstance(model, MAE) and model.adaptive_patching and model.num_patches == 196
                and model.decoder_adaptive_pos_dep_emb is not None and model.embed_dim == 768
                and len(model.blocks) == 12 and len(model.decoder_blocks) == 8
                and model.decoder_blocks[0].attn.num_heads == int(ia["decoder_num_heads"])
                and model.seq_pack == int(ia.get("seq_pack", 1)) and model.dtype is None):
            fail(f"the {name} run was not the shipped adaptive MAE")

    instances = _adaptive_cli(name, [path, "--synthetic", "--single-device", "--max-steps",
                                     str(ADAPTIVE_MAIN_STEPS)], ADAPTIVE_MAIN_STEPS,
                              check_model)
    stream = synthetic_batches(cfg, cfg.batch_size, seed=0)
    w, t = ADAPTIVE_MAE_WARMUP, ADAPTIVE_MAE_TIMED
    batches = [next(stream) for _ in range(w + t + ADAPTIVE_TRACED)]
    state, step = _flash_against_einsum(name, cfg, batches[:w + t])
    res = _measure_steps("adaptive", f"{name} f32 batch {cfg.batch_size}, FLASH", state, step,
                         batches[:w], batches[w:w + t], batches[w + t:], top=8)
    res["device_step_ms"] = res["busy_ms"] / res["traced_steps"]
    log(f"[adaptive] {name}: device time a step {res['device_step_ms']:.3f} ms; by kind: "
        f"{_kernel_groups(res['kernels'], res['busy_ms'])}; flash a step: "
        f"{_flash_per_step(res['kernels'], res['traced_steps'])}")
    del state, step
    return {"instances": instances, **res}


def _adaptive_serve(cls_path: str, jpeg_root: str) -> dict:
    """(c) imagenet/classification served with a preprocessing pool under load,
    and an adaptive MAE's /v1/predict against `reconstruct`."""
    import numpy as np
    import torch

    from ucf_vit_tpu_torch.config import load_config
    from ucf_vit_tpu_torch.data.pipeline import read_imagenet_file
    from ucf_vit_tpu_torch.inference import reconstruct
    from ucf_vit_tpu_torch.ops.flash_attention import flash_attention, reset_launch_counts
    from ucf_vit_tpu_torch.serve import make_preprocessor, make_server
    from ucf_vit_tpu_torch.tasks import seq_ps

    cfg = load_config(cls_path)
    files = sorted(os.path.join(d, f) for d, _, fs in os.walk(jpeg_root) for f in fs)
    samples = [read_imagenet_file(p).astype(np.float32)
               for p in files[:LOAD_CLIENTS + SEQUENTIAL_REQUESTS]]
    bodies = []
    for x in samples:
        buf = io.BytesIO()
        np.save(buf, x)
        bodies.append(buf.getvalue())
    answers = []
    reset_launch_counts()
    t0 = time.perf_counter()
    server = make_server(cfg, host="127.0.0.1", port=0, max_batch=MAX_BATCH, device="cuda",
                         preprocess_workers=ADAPTIVE_SERVE_WORKERS)
    startup_s = time.perf_counter() - t0
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    port = server.server_address[1]
    ctx = multiprocessing.get_context("spawn")
    pipe, child_pipe = ctx.Pipe()
    client = ctx.Process(target=_load_client, args=(port, bodies[:LOAD_CLIENTS], child_pipe),
                         daemon=True)
    client.start()
    windows = {}
    prof = torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA])
    pre = make_preprocessor(cfg)  # in line: the pool's trees must equal these
    try:
        seq_lat = []
        for i in range(LOAD_CLIENTS, LOAD_CLIENTS + SEQUENTIAL_REQUESTS):
            t1 = time.perf_counter()
            answer = _request(port, "POST", "/v1/predict", bodies[i])
            seq_lat.append(time.perf_counter() - t1)
            answers.append((i, np.load(io.BytesIO(answer))))
        for wname, seconds in ADAPTIVE_SERVE_WINDOWS_S.items():
            before = _get_json(port, "/v1/stats")
            if wname == "traced":
                prof.start()
            pipe.send(seconds)
            if not pipe.poll(seconds + 300):
                fail(f"the load client gave no result for the adaptive {wname} window")
            res = pipe.recv()
            if wname == "traced":
                prof.stop()
            if res["errors"] or not res["requests"]:
                fail(f"adaptive load client, {wname} window: {len(res['requests'])} answers, "
                     f"errors {res['errors'][:3]}")
            windows[wname] = (res, before, _get_json(port, "/v1/stats"))
            answers += [(i, a) for i, _, a in res["requests"]]
        pipe.send(None)
        client.join(timeout=30)
        stats = _get_json(port, "/v1/stats")
        launches = dict(flash_attention.by_instance)
        pooled = server.RequestHandlerClass.preprocess
        same_trees = all(
            all(a[k].tobytes() == b[k].tobytes() == c[k].tobytes() for k in a)
            for a, b, c in ((pooled(samples[i]), pooled(samples[i].copy()), pre(samples[i]))
                            for i in range(4)))
    finally:
        if client.is_alive():
            client.terminate()
            client.join()
        server.shutdown()
        server.server_close()
        server.RequestHandlerClass.batcher.close()
        thread.join(timeout=30)
    for wname, (res, before, after) in windows.items():
        log(_window_line(wname, res, before, after).replace("[serve]", "[adaptive serve]"))
    traced_s = windows["traced"][0]["wall_s"]
    busy_ms = sum(e.self_device_time_total for e in prof.key_averages()) / 1e3
    busy = busy_ms / (1e3 * traced_s)
    load_res = windows["load"][0]
    rps = len(load_res["requests"]) / load_res["wall_s"]
    lat = np.array([r[1] for r in load_res["requests"]]) * 1e3
    log(f"[adaptive serve] imagenet/classification, max_batch {MAX_BATCH}, "
        f"--preprocess-workers {ADAPTIVE_SERVE_WORKERS}: startup {startup_s:.2f} s; a lone "
        f"request {1e3 * min(seq_lat):.1f}-{1e3 * max(seq_lat):.1f} ms; {rps:.2f} requests/s, "
        f"p50 {np.percentile(lat, 50):.1f} p99 {np.percentile(lat, 99):.1f} ms; device busy "
        f"{100 * busy:.2f}% of the traced window; launches by instance "
        f"{ {k: v for k, v in launches.items() if v} } over {stats['batches']} batches")
    if stats["errors"] or stats["requests"] != len(answers) + 1:
        fail(f"adaptive server stats {stats}; expected {len(answers) + 1} requests, no errors")
    if launches["flash_fwd_tf32<64>"] != 12 * stats["batches"] or \
            sum(launches.values()) != launches["flash_fwd_tf32<64>"]:
        fail(f"the adaptive server launched {launches} over {stats['batches']} batches; "
             f"expected 12 flash_fwd_tf32<64> a batch and nothing else")
    if not same_trees:
        fail("the pool's preprocessing differs from the in-line one, or from itself")
    # each served answer against the in-process forward of the same patchified sample
    model = server.RequestHandlerClass.weights_holder["model"]
    want = {}
    for i0 in range(0, len(samples), MAX_BATCH):
        b = [pre(x) for x in samples[i0:i0 + MAX_BATCH]]
        b = {k: torch.from_numpy(np.stack([s[k] for s in b])).cuda() for k in b[0]}
        with torch.inference_mode():
            logits = model(b["seq"], seq_ps=seq_ps(b)).cpu().numpy()
        want.update({i0 + j: logits[j] for j in range(len(logits))})
    worst = max(float(np.abs(a - want[i]).max()) for i, a in answers)
    log(f"[adaptive serve] {len(answers)} answers against the in-process forward of their "
        f"patchified samples: max abs diff {worst:.3e} (tol {SERVE_TOL:g}); the pool's trees "
        f"byte for byte the in-line ones, twice")
    if worst > SERVE_TOL:
        fail("served adaptive answers disagree with the in-process forward")
    del model

    # an adaptive MAE's /v1/predict (basic_ct/mae: one sample a batch of 2) against
    # `reconstruct` of the sample alone under the server's seed
    mcfg = load_config(_adaptive_config(ADAPTIVE_MAE_CONFIGS["basic_ct/mae"], "mae_serve"))
    reset_launch_counts()
    mserver = make_server(mcfg, host="127.0.0.1", port=0, max_batch=2, device="cuda", seed=1)
    mthread = threading.Thread(target=mserver.serve_forever, daemon=True)
    mthread.start()
    x = np.random.default_rng(3).random((1, 64, 64)).astype(np.float32)
    buf = io.BytesIO()
    np.save(buf, x)
    try:
        t1 = time.perf_counter()
        got = np.load(io.BytesIO(_request(mserver.server_address[1], "POST", "/v1/predict",
                                          buf.getvalue())))
        mae_ms = 1e3 * (time.perf_counter() - t1)
        minst = {k: v for k, v in flash_attention.by_instance.items() if v}
        mmodel = mserver.RequestHandlerClass.weights_holder["model"]
    finally:
        mserver.shutdown()
        mserver.server_close()
        mserver.RequestHandlerClass.batcher.close()
        mthread.join(timeout=30)
    b = {k: torch.from_numpy(v[None]).cuda() for k, v in make_preprocessor(mcfg)(x).items()}
    alone = reconstruct(mmodel, b["seq"], seed=1, seq_ps=seq_ps(b))[0].cpu().numpy()
    mae_diff = float(np.abs(got - alone).max())
    log(f"[adaptive serve] basic_ct/mae /v1/predict: tokens {got.shape} in {mae_ms:.1f} ms; "
        f"against reconstruct of the sample alone max abs diff {mae_diff:.3e} (tol "
        f"{SERVE_TOL:g}); launches {minst} over 2 batches (warm-up included)")
    if got.shape != (196, 16) or mae_diff > SERVE_TOL or not np.all(np.isfinite(got)):
        fail("the adaptive MAE's /v1/predict disagrees with reconstruct")
    if minst != {"flash_fwd_tf32<64>": 24, "flash_fwd_tf32<96>": 16}:
        fail(f"the adaptive MAE server launched {minst}; expected 12 <64> and 8 <96> a batch")
    return {"rps": rps, "p50": float(np.percentile(lat, 50)),
            "p99": float(np.percentile(lat, 99)), "lone_ms": 1e3 * min(seq_lat), "busy": busy,
            "fwd64": launches["flash_fwd_tf32<64>"] + minst.get("flash_fwd_tf32<64>", 0),
            "fwd96": minst.get("flash_fwd_tf32<96>", 0)}


def phase_adaptive() -> dict:
    """Adaptive patching in 2-D: the quadtree's tokens through LinearTokenEmbed and
    AdaptivePosMLP into the f32 ViT paths. (d) first: the f32 kernels at the
    paths' shapes (ADAPTIVE_SHAPES) against their plain versions, timed beside
    SDPA. (a) imagenet/classification from JPEG files through the DataModule:
    the patchify's host cost, the CLI entry, the loader alone, FLASH against
    EINSUM on its batches, windows on the live loader in line (as shipped) and
    with a spawn pool. (b) imagenet/mae and basic_ct/mae, synthetic: the CLI
    entry, FLASH against EINSUM, a timed and a traced window. (c) serving with
    a preprocessing pool under load, and an adaptive MAE's /v1/predict.
    Returns the launches the records count and the numbers PERF.md keeps."""
    import torch

    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(11)
    kernels = {name: _attention_case("adaptive", name, shape, gen,
                                         iters=ADAPTIVE_KERNEL_ITERS)
               for name, shape in ADAPTIVE_SHAPES.items()}
    torch.cuda.empty_cache()
    files = _adaptive_from_files()
    maes = {name: _adaptive_mae(name, path) for name, path in ADAPTIVE_MAE_CONFIGS.items()}
    served = _adaptive_serve(files["path"], files["root"])
    cls, ct, im = files["instances"], maes["basic_ct/mae"]["instances"], \
        maes["imagenet/mae"]["instances"]
    launches = {
        "flash_fwd": cls["fwd:flash_fwd_tf32<64>"] + ct["fwd:flash_fwd_tf32<64>"]
        + served["fwd64"],
        "flash_bwd_fused": cls["bwd:flash_bwd_tf32<64>"] + ct["bwd:flash_bwd_tf32<64>"],
        "flash_fwd_dh128": im["fwd:flash_fwd_tf32<128>"],
        "flash_bwd_fused_dh128": im["bwd:flash_bwd_tf32<128>"],
        "flash_fwd_dh96": ct["fwd:flash_fwd_tf32<96>"] + served["fwd96"],
        "flash_bwd_fused_dh96": ct["bwd:flash_bwd_tf32<96>"],
    }
    log(f"[record] adaptive: imagenet/classification from files {files['inline']['ms_step']:.3f} "
        f"ms/step in line, {files['pool']['ms_step']:.3f} with a pool of {ADAPTIVE_POOL - 1} "
        f"({files['pool']['images_s']:.2f} images/s, busy {100 * files['busy']:.2f}%, "
        f"{files['device_step_ms']:.3f} ms device a step), the loader {files['loader_ms']:.1f} "
        f"ms a batch in line, {files['pool_loader_ms']:.1f} pooled, waits "
        f"{files['inline']['wait_ms']:.2f} / {files['pool']['wait_ms']:.2f} ms a step; patchify "
        f"{files['patchify_ms']:.3f} ms a sample; "
        + "; ".join(f"{n} {r['ms_step']:.3f} ms/step, {r['images_s']:.2f} images/s, busy "
                    f"{100 * r['busy_share']:.2f}%, {r['device_step_ms']:.3f} ms device a step"
                    for n, r in maes.items())
        + f"; served {served['rps']:.2f} requests/s, p50 {served['p50']:.1f} p99 "
        f"{served['p99']:.1f} ms, a lone request {served['lone_ms']:.1f} ms, busy "
        f"{100 * served['busy']:.2f}%; launches {launches}")
    log(f"[adaptive] phase_adaptive took {time.perf_counter() - t0:.1f} s")
    return {"kernels": kernels, "launches": launches}


def _unetr_groups(kernels, busy_ms: float) -> str:
    """Device time of a traced UNETR window by kind of kernel, from their names:
    convolutions (cuDNN's forward, data- and weight-gradient kernels, transposed
    ones included), GEMMs, the flash kernels, instance norm, AdamW, and the
    element-wise rest."""
    groups = {"convolutions (cuDNN)": 0.0, "GEMMs (cuBLAS/CUTLASS)": 0.0,
              "flash_fwd_tf32_kernel": 0.0, "flash_bwd_tf32_kernel": 0.0,
              "instance norm": 0.0, "AdamW (multi-tensor)": 0.0,
              "element-wise and other (LeakyReLU, GELU, LayerNorm, softmax, copies)": 0.0}
    for t_us, _, key in kernels:
        name = key.lower()
        flash = [g for g in groups if g.startswith("flash") and g in name]
        if flash:
            group = flash[0]
        elif any(w in name for w in ("conv", "fprop", "dgrad", "wgrad", "implicit",
                                     "winograd", "cudnn", "fft")):
            group = "convolutions (cuDNN)"
        elif any(w in name for w in ("gemm", "cutlass", "xmma", "nvjet", "cublas", "wgmma")):
            group = "GEMMs (cuBLAS/CUTLASS)"
        elif any(w in name for w in ("batch_norm", "instance_norm", "welford")):
            group = "instance norm"
        elif "multi_tensor" in name or "adam" in name:
            group = "AdamW (multi-tensor)"
        else:
            group = "element-wise and other (LeakyReLU, GELU, LayerNorm, softmax, copies)"
        groups[group] += t_us / 1e3
    return "; ".join(f"{g} {ms:.3f} ms = {100 * ms / busy_ms:.2f}%" for g, ms in groups.items())


def _check_unetr(model) -> None:
    from ucf_vit_tpu_torch.models import UNETR

    if not (isinstance(model, UNETR) and model.adaptive_patching and model.num_patches == 729
            and model.feat_size == (9, 9, 9) and model.resize and model.embed_dim == 768
            and len(model.blocks) == 12 and model.blocks[0].attn.num_heads == 12
            and model.remat and model.dtype is None and model.skip_indices == [3, 6, 9]
            and model.decoder2.conv_block.conv1.out_channels == 16
            and model.out.conv.out_channels == 4
            and model.adaptive_pos_dep_emb is not None):
        fail("the run was not the shipped basic_ct/unetr")


def _unetr_instances(steps: int, backward: bool = True) -> dict:
    """The launches by instance of `steps` UNETR train steps (or forwards): under
    remat each of the 12 blocks runs the `<64>` forward twice a step and the
    fused backward once (bwd_route's route at 729 f32 queries)."""
    import torch

    from ucf_vit_tpu_torch.ops.flash_attention import bwd_route

    if bwd_route(torch.float32, 729, 729, 64) != "fused":
        fail("bwd_route no longer takes the fused route at UNETR's 729 f32 queries")
    want = {k: 0 for k in _instance_counts()}
    want["fwd:flash_fwd_tf32<64>"] = (24 if backward else 12) * steps
    if backward:
        want["bwd:flash_bwd_tf32<64>"] = 12 * steps
    return want


def _unetr_cli(tag: str, argv: list, steps: int) -> dict:
    """The trainer's CLI entry with the launch counts set to 0 before it; the
    model must be the shipped UNETR and every launch the `<64>` tf32
    instances, 24 forwards and 12 fused backwards a step. Returns the launch
    counts by instance."""
    import numpy as np

    from ucf_vit_tpu_torch.ops.flash_attention import reset_launch_counts
    from ucf_vit_tpu_torch.train import main as train_main

    reset_launch_counts()
    t0 = time.perf_counter()
    out = train_main(argv)
    counts, instances = _launch_counts(), _instance_counts()
    _check_unetr(out["state"].model)
    want = _unetr_instances(steps)
    log(f"[unetr] {tag}: python -m ucf_vit_tpu_torch.train {' '.join(argv[1:])}: "
        f"{time.perf_counter() - t0:.2f} s (init and save included); epoch losses "
        f"{out['loss_list']}; launches by instance a step "
        f"{ {k: n // steps for k, n in instances.items() if n} }")
    if (instances != want or counts["src:flash_fwd_sm90"] or counts["src:flash_bwd_sm90"]
            or counts["flash_bwd_dkv"] or counts["flash_bwd_dq"]
            or not all(np.isfinite(out["loss_list"]))):
        fail(f"{tag} through the CLI launched {instances} (expected {want}), {counts}; "
             f"losses {out['loss_list']}")
    del out
    return instances


def _labelled_volumes(root: str, n: int, side: int, seed: int) -> float:
    """`n` CT-like int16 volumes of `side`^3 as <root>/imagesTr/image{i}.nii and
    label volumes 1-4 as <root>/labelsTr/label{i}.nii, from seeded thresholds of
    a smoothed copy (so the labels have edges the octree sees); the seconds
    taken."""
    import numpy as np
    from scipy.ndimage import gaussian_filter

    from ucf_vit_tpu_torch.data import nifti

    t0 = time.perf_counter()
    for d in ("imagesTr", "labelsTr"):
        os.makedirs(os.path.join(root, d))
    rng = np.random.default_rng(seed)
    for i in range(n):
        vol = _ct_volume(rng, (side,) * 3)
        smooth = gaussian_filter(vol.astype(np.float32), 3.0)
        cuts = np.quantile(smooth, np.sort(rng.uniform([0.35, 0.6, 0.85], [0.45, 0.7, 0.95])))
        lab = (1 + np.digitize(smooth, cuts)).astype(np.int16)
        nifti.save(os.path.join(root, "imagesTr", f"image{i}.nii"), vol)
        nifti.save(os.path.join(root, "labelsTr", f"label{i}.nii"), lab)
    return time.perf_counter() - t0


def _patchify3d_costs(tiles) -> dict:
    """Host ms a sample of `Patchify3D` on `tiles` [N, 64, 64, 64, 1] f32, split
    into the Gaussian, the slices' Sobel and Canny, the octree and the
    serialization; and the octree's native build against its numpy build."""
    import numpy as np

    from ucf_vit_tpu_torch import native
    from ucf_vit_tpu_torch.data.octree import FixedOctTree, octree_boxes_plain
    from ucf_vit_tpu_torch.data.transform import Patchify3D

    pf = Patchify3D(fixed_length=729, patch_size=4, num_channels=1,
                    rng=np.random.default_rng(0))
    pf(tiles[0])
    t0 = time.perf_counter()
    for t in tiles:
        pf(t)
    total = 1e3 * (time.perf_counter() - t0) / len(tiles)
    # its parts, one after another as __call__ runs them, at smoothing 3 and threshold 75
    parts = dict.fromkeys(("gaussian", "slices", "tree", "serialize"), 0.0)
    for t in tiles:
        t1 = time.perf_counter()
        grey = pf.smooth(t, 3)
        t2 = time.perf_counter()
        edges, norm = pf.edge_volume(grey, 75)
        t3 = time.perf_counter()
        tree = FixedOctTree(edges, 729, norm)
        t4 = time.perf_counter()
        pf.serialize(tree, t)
        t5 = time.perf_counter()
        for k, (a, b) in zip(parts, ((t1, t2), (t2, t3), (t3, t4), (t4, t5))):
            parts[k] += 1e3 * (b - a) / len(tiles)
    t0 = time.perf_counter()
    nb = native.octree_boxes(edges, 729, norm)
    tree_native = 1e3 * (time.perf_counter() - t0)
    t0 = time.perf_counter()
    pb = octree_boxes_plain(edges, 729, norm)
    tree_numpy = 1e3 * (time.perf_counter() - t0)
    if not (np.array_equal(nb[0], pb[0]) and np.array_equal(nb[1], pb[1])):
        fail("the native octree differs from its numpy build")
    log(f"[unetr] Patchify3D of a 64^3 tile (729 leaves of 4^3): {total:.3f} ms a sample on "
        f"the host (its draws); its parts at smoothing 3: "
        + ", ".join(f"{k} {v:.3f}" for k, v in parts.items())
        + f" ms; the tree alone {tree_native:.3f} ms native, {tree_numpy:.3f} ms numpy (the "
        f"same boxes and values)")
    return {"patchify_ms": total, **{f"{k}_ms": v for k, v in parts.items()}}


def _unetr_flash_against_einsum(cfg, batches) -> tuple:
    """`_run_steps` under FLASH and under EINSUM from one init on `batches`: the
    per-step losses within TRAIN_LOSS_TOL, FLASH's launches as `_unetr_instances`
    gives them and none under EINSUM. Returns FLASH's (state, step)."""
    import numpy as np

    runs = {}
    for impl in ("FLASH", "EINSUM"):
        st, sp, losses, _, counts = _run_steps(_train_cfg(cfg, impl), batches)
        runs[impl] = (st, sp, losses, counts, _instance_counts())
        if impl == "EINSUM":
            del st, sp
    (st, sp, lf, _, inf), (_, _, le, ce, _) = runs["FLASH"], runs["EINSUM"]
    del runs
    diff = max(abs(a - b) for a, b in zip(lf, le))
    log(f"[unetr] FLASH vs EINSUM, {len(batches)} steps: losses FLASH "
        f"{' '.join(f'{x:.6f}' for x in lf)}, EINSUM {' '.join(f'{x:.6f}' for x in le)}; max "
        f"|diff| {diff:.3e} (tol {TRAIN_LOSS_TOL:g})")
    if not all(np.isfinite(lf)) or diff > TRAIN_LOSS_TOL:
        fail("basic_ct/unetr: FLASH training disagrees with EINSUM's")
    if inf != _unetr_instances(len(batches)) or any(ce.values()):
        fail(f"basic_ct/unetr: launches {inf} under FLASH, {ce} under EINSUM")
    return st, sp


def _unetr_from_files(root: str, path: str) -> dict:
    """(c) training from the labelled files, in line and with a spawn pool."""
    import numpy as np
    import torch

    from ucf_vit_tpu_torch.config import load_config
    from ucf_vit_tpu_torch.train import build_dataloader, init_train

    cfg = load_config(path)
    batch = cfg.batch_size
    instances = _unetr_cli("basic_ct/unetr from NIfTI files",
                           [path, "--single-device", "--max-steps", str(UNETR_MAIN_STEPS)],
                           UNETR_MAIN_STEPS)
    state, step = init_train(cfg, "cuda")
    res = {"instances": instances}
    for workers in (1, UNETR_POOL):
        wcfg = load_config(_adaptive_config(path, f"unetr_w{workers}", num_workers=workers))
        dm, _, bpre = build_dataloader(wcfg, batch, False)
        it = dm.train_dataloader(loop=True)
        try:
            b0, loader_ms = _loader_alone(it, 1 if workers > 1 else 4)
            b0 = b0[0]
            if workers > 1:  # the pool's start-up left out
                _, loader_ms = _loader_alone(it, 4)
            if (b0["seq"].shape != (batch, 1, 729, 64) or b0["seq_pos"].shape != (batch, 1, 729, 3)
                    or b0["label"].shape != (batch, 1, 64, 64, 64)
                    or b0["seq_label"].shape != (batch, 729, 4, 4, 4)
                    or bpre != {"ct1": UNETR_VOLUMES * 8 // batch}
                    or not set(np.unique(b0["label"])) <= {0, 1, 2, 3}):
                fail(f"the UNETR loader gave seq {b0['seq'].shape}, seq_pos "
                     f"{b0['seq_pos'].shape}, label {b0['label'].shape} "
                     f"{np.unique(b0['label'])}, seq_label {b0['seq_label'].shape}; "
                     f"{bpre} batches an epoch")
            _disk_window(state, step, it, 2)
            torch.cuda.reset_peak_memory_stats()
            wall, waited = _disk_window(state, step, it, UNETR_FILE_STEPS)
        finally:
            it.close()
        key = "inline" if workers == 1 else "pool"
        res[key] = {"ms_step": 1e3 * wall / UNETR_FILE_STEPS,
                    "volumes_s": batch * UNETR_FILE_STEPS / wall,
                    "wait_ms": 1e3 * waited / UNETR_FILE_STEPS, "loader_ms": loader_ms,
                    "peak_gb": torch.cuda.max_memory_allocated() / 1e9}
        log(f"[unetr] from files, num_workers {workers}"
            f"{' (a spawn pool of ' + str(workers - 1) + ')' if workers > 1 else ' (in line)'}:"
            f" the loader alone {loader_ms:.1f} ms a batch of {batch}; {UNETR_FILE_STEPS} steps "
            f"= {res[key]['ms_step']:.3f} ms/step, {res[key]['volumes_s']:.2f} volumes/s, "
            f"waiting for batches {res[key]['wait_ms']:.2f} ms a step; peak "
            f"{res[key]['peak_gb']:.2f} GB")
    del state, step
    return res


def _unetr_warm_start(path: str, mae_ckpt: str | None) -> None:
    """(d) `trainer.pretrained_mae_checkpoint` from mae_long's checkpoint (saved
    here from a seeded init where no earlier phase wrote one)."""
    import numpy as np
    import torch
    import yaml

    from ucf_vit_tpu_torch.checkpoint import restore_checkpoint
    from ucf_vit_tpu_torch.config import load_config
    from ucf_vit_tpu_torch.ops.pos_embed import interpolate_pos_embed_1d
    from ucf_vit_tpu_torch.train import init_train, transfer_pretrained_mae

    mae_ckpt = _mae_checkpoint(mae_ckpt)
    mae_sd = restore_checkpoint(mae_ckpt, "")["model_state_dict"]
    cfg = load_config(path)
    state, _ = init_train(cfg, "cuda")
    before = {k: v.detach().clone() for k, v in state.model.state_dict().items()}
    t0 = time.perf_counter()
    transfer_pretrained_mae(cfg, state.model, mae_ckpt)
    took = time.perf_counter() - t0
    got = state.model.state_dict()
    from_mae = [k for k in got if k.startswith(("blocks.", "token_embeds.", "norm."))]
    own = [k for k in got if k.startswith(("encoder", "decoder", "out.", "adaptive_pos"))]
    same = all(torch.equal(got[k].cpu(), mae_sd[k]) for k in from_mae)
    kept = all(torch.equal(got[k], before[k]) for k in own)
    want_pos = interpolate_pos_embed_1d(mae_sd["pos_embed"].numpy(), 729)
    pos_ok = np.array_equal(got["pos_embed"].cpu().numpy(), want_pos)
    log(f"[unetr] warm start from {os.path.basename(mae_ckpt)} ({tuple(mae_sd['pos_embed'].shape)}"
        f" position table) in {took:.2f} s: {len(from_mae)} encoder tensors equal the MAE's: "
        f"{same}; pos_embed the MAE's resampled to 729 rows: {pos_ok}; {len(own)} decoder "
        f"tensors kept their init: {kept}")
    if not (same and kept and pos_ok and len(from_mae) == 12 * 12 + 4):
        fail("the MAE-encoder transfer did not give the UNETR the MAE's encoder")
    del state
    # and through the trainer's CLI, one step
    raw = yaml.safe_load(open(path))
    raw["trainer"]["pretrained_mae_checkpoint"] = mae_ckpt
    wpath = os.path.join(WORK, "unetr_warm.yaml")
    with open(wpath, "w") as fh:
        yaml.safe_dump(raw, fh)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        _unetr_cli("basic_ct/unetr warm-started", [wpath, "--synthetic", "--single-device",
                                                   "--max-steps", "1"], 1)
    if "initialized encoder from MAE checkpoint" not in buf.getvalue():
        fail("the trainer's CLI did not warm-start from pretrained_mae_checkpoint")
    log(buf.getvalue().strip().splitlines()[-1])


def _margin_mask(probs_or_logits) -> "np.ndarray":
    """Where the top-two gap over the class axis (1) passes UNETR_MARGIN."""
    import numpy as np

    top2 = np.sort(probs_or_logits, axis=1)[:, -2:]
    return (top2[:, 1] - top2[:, 0]) > UNETR_MARGIN


def _unetr_evaluate(path: str, ckpt: str, vol_path: str) -> dict:
    """(e) the inference CLI's Dice under FLASH and EINSUM, and `--volume`."""
    import numpy as np
    import torch
    import yaml

    from ucf_vit_tpu_torch.config import load_config
    from ucf_vit_tpu_torch.inference import VolumePredictor
    from ucf_vit_tpu_torch.inference import main as inference_main
    from ucf_vit_tpu_torch.ops.flash_attention import reset_launch_counts

    paths, dice = {}, {}
    for impl in ("FLASH", "EINSUM"):
        raw = yaml.safe_load(open(path))
        raw["trainer"]["attn_impl"] = impl
        paths[impl] = os.path.join(WORK, f"unetr_{impl}.yaml")
        with open(paths[impl], "w") as fh:
            yaml.safe_dump(raw, fh)
        reset_launch_counts()
        buf = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            mean = inference_main([paths[impl], "--checkpoint", ckpt, "--num-samples",
                                   str(UNETR_EVAL_SAMPLES), "--device", "cuda"])
        per = [float(d) for d in re.findall(r"sample \d+: dice ([0-9.]+)", buf.getvalue())]
        dice[impl] = (mean, per, _instance_counts(), time.perf_counter() - t0)
    (fm, fp, finst, fs), (em, ep, einst, _) = dice["FLASH"], dice["EINSUM"]
    log(f"[unetr] python -m ucf_vit_tpu_torch.inference --checkpoint (from files, "
        f"{UNETR_EVAL_SAMPLES} samples) in {fs:.2f} s: Dice FLASH {fp} mean {fm:.6f}; "
        f"EINSUM {ep} mean {em:.6f}")
    if (len(fp) != UNETR_EVAL_SAMPLES or abs(fm - em) > UNETR_DICE_TOL
            or finst != _unetr_instances(UNETR_EVAL_SAMPLES, backward=False)
            or any(einst.values())):
        fail(f"the inference CLI's Dice differs under FLASH and EINSUM, or launched {finst} / "
             f"{einst}")

    # --volume: 27 windows of a 128^3 volume
    vol = np.load(vol_path)
    maps, probs = {}, {}
    for impl in ("FLASH", "EINSUM"):
        predictor = VolumePredictor(load_config(paths[impl]), ckpt, sw_batch=UNETR_SW_BATCH,
                                    device="cuda")
        predictor(vol[:, :64, :64, :64], overlap=UNETR_SW_OVERLAP)  # warm-up: one window
        reset_launch_counts()
        maps[impl] = predictor(vol, overlap=UNETR_SW_OVERLAP)
        probs[impl] = predictor.last_probs
        if impl == "FLASH":
            stats, vinst = dict(predictor.last_stats), _instance_counts()
        del predictor
    chunks = -(-stats["windows"] // UNETR_SW_BATCH)
    perr = float(np.abs(probs["FLASH"] - probs["EINSUM"]).max())
    keep = _margin_mask(probs["EINSUM"][None])[0]
    differ = int(((maps["FLASH"] != maps["EINSUM"]) & keep).sum())
    log(f"[unetr] --volume {tuple(vol.shape[1:])} at overlap {UNETR_SW_OVERLAP}, sw_batch "
        f"{UNETR_SW_BATCH}: {stats['windows']} windows in {stats['seconds']:.3f} s a volume, "
        f"{stats['preprocess_s']:.3f} s of it the host's preprocessing "
        f"({100 * stats['preprocess_s'] / stats['seconds']:.1f}%); stitched probabilities "
        f"FLASH vs EINSUM max |diff| {perr:.3e} (tol {FLASH_TOL['float32']:g}); class maps "
        f"differ at {differ} voxels where EINSUM's top-two margin passes {UNETR_MARGIN:g} "
        f"({int((~keep).sum())} voxels under it left out); classes "
        f"{np.unique(maps['FLASH'], return_counts=True)[1].tolist()}")
    if (stats["windows"] != 27 or perr > FLASH_TOL["float32"] or differ
            or vinst["fwd:flash_fwd_tf32<64>"] != 12 * chunks):
        fail(f"--volume disagrees with EINSUM's, or launched {vinst}")
    # the CLI itself on the same volume gives the same map
    out = os.path.join(WORK, "unetr_pred.npy")
    with contextlib.redirect_stdout(io.StringIO()):
        inference_main([paths["FLASH"], "--checkpoint", ckpt, "--volume", vol_path,
                        "--volume-out", out, "--sw-batch", str(UNETR_SW_BATCH), "--device",
                        "cuda"])
    if not np.array_equal(np.load(out), maps["FLASH"]):
        fail("the inference CLI's --volume map differs from VolumePredictor's")
    return {"dice": fm, "dice_per": fp, "volume_s": stats["seconds"],
            "volume_pre_share": stats["preprocess_s"] / stats["seconds"],
            "eval_fwd": finst["fwd:flash_fwd_tf32<64>"] + vinst["fwd:flash_fwd_tf32<64>"]}


def _unetr_serve(path: str, ckpt: str, tiles) -> dict:
    """(f) serving class maps with a preprocessing pool under load."""
    import numpy as np
    import torch

    from ucf_vit_tpu_torch.config import load_config
    from ucf_vit_tpu_torch.ops.flash_attention import flash_attention, reset_launch_counts
    from ucf_vit_tpu_torch.serve import make_preprocessor, make_server
    from ucf_vit_tpu_torch.tasks import unetr_inputs

    cfg = load_config(path)
    bodies = []
    for x in tiles:
        buf = io.BytesIO()
        np.save(buf, x)
        bodies.append(buf.getvalue())
    reset_launch_counts()
    t0 = time.perf_counter()
    server = make_server(cfg, ckpt, host="127.0.0.1", port=0, max_batch=UNETR_MAX_BATCH,
                         device="cuda", preprocess_workers=UNETR_SERVE_WORKERS)
    startup_s = time.perf_counter() - t0
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    port = server.server_address[1]
    ctx = multiprocessing.get_context("spawn")
    pipe, child_pipe = ctx.Pipe()
    client = ctx.Process(target=_load_client, args=(port, bodies[:UNETR_CLIENTS], child_pipe),
                         daemon=True)
    client.start()
    windows, answers = {}, []
    prof = torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA])
    pre = make_preprocessor(cfg)
    try:
        seq_lat = []
        for i in range(UNETR_CLIENTS, len(bodies)):
            t1 = time.perf_counter()
            answers.append((i, np.load(io.BytesIO(_request(port, "POST", "/v1/predict",
                                                           bodies[i])))))
            seq_lat.append(time.perf_counter() - t1)
        for wname, seconds in UNETR_SERVE_WINDOWS_S.items():
            before = _get_json(port, "/v1/stats")
            if wname == "traced":
                prof.start()
            pipe.send(seconds)
            if not pipe.poll(seconds + 300):
                fail(f"the load client gave no result for the UNETR {wname} window")
            res = pipe.recv()
            if wname == "traced":
                prof.stop()
            if res["errors"] or not res["requests"]:
                fail(f"UNETR load client, {wname} window: {len(res['requests'])} answers, "
                     f"errors {res['errors'][:3]}")
            windows[wname] = (res, before, _get_json(port, "/v1/stats"))
            answers += [(i, a) for i, _, a in res["requests"]]
        pipe.send(None)
        client.join(timeout=30)
        stats = _get_json(port, "/v1/stats")
        launches = dict(flash_attention.by_instance)
        pooled = server.RequestHandlerClass.preprocess
        same = all(all(a[k].tobytes() == b[k].tobytes() for k in a)
                   for a, b in ((pooled(tiles[i]), pre(tiles[i])) for i in range(2)))
    finally:
        if client.is_alive():
            client.terminate()
            client.join()
        server.shutdown()
        server.server_close()
        server.RequestHandlerClass.batcher.close()
        thread.join(timeout=30)
    for wname, (res, before, after) in windows.items():
        log(_window_line(wname, res, before, after).replace("[serve]", "[unetr serve]")
            .replace(f"from {LOAD_CLIENTS} closed-loop", f"from {UNETR_CLIENTS} closed-loop"))
    traced_s = windows["traced"][0]["wall_s"]
    busy = sum(e.self_device_time_total for e in prof.key_averages()) / 1e3 / (1e3 * traced_s)
    load_res = windows["load"][0]
    rps = len(load_res["requests"]) / load_res["wall_s"]
    lat = np.array([r[1] for r in load_res["requests"]]) * 1e3
    if stats["errors"] or stats["requests"] != len(answers) + 1 or not same:
        fail(f"UNETR server stats {stats} for {len(answers) + 1} requests; the pool's "
             f"preprocessing the in-line one's: {same}")
    if launches["flash_fwd_tf32<64>"] != 12 * stats["batches"] or \
            sum(launches.values()) != launches["flash_fwd_tf32<64>"]:
        fail(f"the UNETR server launched {launches} over {stats['batches']} batches")
    # every answer against the in-process forward of its preprocessed sample
    model = server.RequestHandlerClass.weights_holder["model"]
    want, masks = {}, {}
    for i0 in range(0, len(tiles), UNETR_MAX_BATCH):
        b = [pre(x) for x in tiles[i0:i0 + UNETR_MAX_BATCH]]
        b = {k: torch.from_numpy(np.stack([s[k] for s in b])).cuda() for k in b[0]}
        x, ps, x_seq = unetr_inputs(cfg, b)
        with torch.inference_mode():
            logits = model(x, seq_ps=ps, x_seq=x_seq).float().cpu().numpy()
        for j in range(len(logits)):
            want[i0 + j], masks[i0 + j] = logits[j].argmax(0), _margin_mask(logits[j:j + 1])[0]
    differ = sum(int(((a != want[i]) & masks[i]).sum()) for i, a in answers)
    left_out = sum(int((~masks[i]).sum()) for i, _ in answers)
    log(f"[unetr serve] max_batch {UNETR_MAX_BATCH}, --preprocess-workers "
        f"{UNETR_SERVE_WORKERS}: startup {startup_s:.2f} s; a lone request "
        f"{1e3 * min(seq_lat):.1f}-{1e3 * max(seq_lat):.1f} ms; {rps:.2f} requests/s, p50 "
        f"{np.percentile(lat, 50):.1f} p90 {np.percentile(lat, 90):.1f} p99 "
        f"{np.percentile(lat, 99):.1f} ms; device busy {100 * busy:.2f}% of the traced "
        f"window; {len(answers)} class maps against the in-process forward: {differ} voxels "
        f"differ where its top-two margin passes {UNETR_MARGIN:g} ({left_out} voxels under "
        f"it left out, of {len(answers) * 64 ** 3})")
    if differ or any(a.shape != (64, 64, 64) or a.dtype != np.int32 for _, a in answers):
        fail("served UNETR class maps disagree with the in-process forward")
    return {"rps": rps, "p50": float(np.percentile(lat, 50)),
            "p90": float(np.percentile(lat, 90)), "p99": float(np.percentile(lat, 99)),
            "lone_ms": 1e3 * min(seq_lat), "busy": busy,
            "fwd64": launches["flash_fwd_tf32<64>"]}


def phase_unetr(mae_ckpt: str | None = None) -> dict:
    """configs/basic_ct/unetr as shipped, --single-device: (a) the f32 kernels at
    [96, 729, 64]; (b) synthetic training through the CLI entry, timed and traced
    windows, FLASH against EINSUM; (c) from labelled NIfTI files in line and with
    a spawn pool; (d) the warm start from an MAE checkpoint (`mae_ckpt`, or one
    saved here from a seeded mae_long init); (e) the inference CLI's Dice and
    `--volume`; (f) serving under load. Returns the kernels' numbers and the
    launches the record counts."""
    import numpy as np
    import torch

    from ucf_vit_tpu_torch.config import load_config
    from ucf_vit_tpu_torch.data.pipeline import read_nifti_file
    from ucf_vit_tpu_torch.train import synthetic_batches

    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(13)
    kernels = _attention_case("unetr", "basic_ct/unetr", UNETR_SHAPE, gen,
                                  iters=ADAPTIVE_KERNEL_ITERS)
    torch.cuda.empty_cache()

    # (b) synthetic
    path = _adaptive_config(UNETR_CONFIG, "unetr")
    cfg = load_config(path)
    main_inst = _unetr_cli("basic_ct/unetr synthetic", [path, "--synthetic", "--single-device",
                                                       "--max-steps", str(UNETR_MAIN_STEPS)],
                           UNETR_MAIN_STEPS)
    stream = synthetic_batches(cfg, cfg.batch_size, seed=0)
    w, t, tr = UNETR_WARMUP, UNETR_TIMED, UNETR_TRACED
    batches = [next(stream) for _ in range(max(w + t + tr, UNETR_CHECK_STEPS))]
    state, step = _unetr_flash_against_einsum(cfg, batches[:UNETR_CHECK_STEPS])
    synth = _measure_steps("unetr", f"basic_ct/unetr f32 batch {cfg.batch_size}, remat, FLASH",
                           state, step, batches[:w], batches[w:w + t], batches[w + t:w + t + tr],
                           top=10)
    synth["device_step_ms"] = synth["busy_ms"] / synth["traced_steps"]
    log(f"[unetr] device time a step {synth['device_step_ms']:.3f} ms; by kind: "
        f"{_unetr_groups(synth['kernels'], synth['busy_ms'])}; flash a step: "
        f"{_flash_per_step(synth['kernels'], synth['traced_steps'])}")
    del state, step, batches
    torch.cuda.empty_cache()

    # (c) from files
    root = os.path.join(WORK, "unetr_ct")
    secs = _labelled_volumes(root, UNETR_VOLUMES, UNETR_SIDE, seed=17)
    log(f"[unetr] wrote {UNETR_VOLUMES} int16 volumes of {UNETR_SIDE}^3 and their label "
        f"volumes in {secs:.2f} s")
    vol = read_nifti_file(os.path.join(root, "imagesTr", "image0.nii"))  # [1, 128^3] in [0, 1]
    vol_path = os.path.join(WORK, "unetr_volume.npy")
    np.save(vol_path, vol)
    tiles = [np.ascontiguousarray(read_nifti_file(os.path.join(root, "imagesTr",
                                                               f"image{i}.nii"))
                                  [:, a:a + 64, b:b + 64, c:c + 64])
             for i in range(3) for a in (0, 64) for b in (0, 64) for c in (0, 64)]
    tiles = tiles[:UNETR_CLIENTS + UNETR_SEQUENTIAL]  # the clients' and the lone requests
    costs = _patchify3d_costs([np.moveaxis(x, 0, -1) for x in tiles[:8]])
    fpath = _adaptive_config(UNETR_CONFIG, "unetr_files", dict_root_dirs={"ct1": root})
    files = _unetr_from_files(root, fpath)
    ckpt = os.path.join(load_config(fpath).trainer["checkpoint_path"], "multi_last_even.ckpt")
    if not os.path.isfile(ckpt):
        fail(f"the UNETR run from files saved no {ckpt}")
    torch.cuda.empty_cache()

    # (d), (e), (f)
    _unetr_warm_start(path, mae_ckpt)
    torch.cuda.empty_cache()
    evaluated = _unetr_evaluate(fpath, ckpt, vol_path)
    torch.cuda.empty_cache()
    served = _unetr_serve(fpath, ckpt, tiles)
    launches = {
        "flash_fwd_unetr": main_inst["fwd:flash_fwd_tf32<64>"]
        + files["instances"]["fwd:flash_fwd_tf32<64>"] + evaluated["eval_fwd"] + served["fwd64"],
        "flash_bwd_fused_unetr": main_inst["bwd:flash_bwd_tf32<64>"]
        + files["instances"]["bwd:flash_bwd_tf32<64>"],
    }
    log(f"[record] unetr: synthetic {synth['ms_step']:.3f} ms/step, {synth['images_s']:.2f} "
        f"volumes/s, busy {100 * synth['busy_share']:.2f}%, {synth['device_step_ms']:.3f} ms "
        f"device a step, peak {synth['peak_gb']:.2f} GB; from files "
        f"{files['inline']['ms_step']:.3f} ms/step in line ({files['inline']['volumes_s']:.2f} "
        f"volumes/s, the loader {files['inline']['loader_ms']:.1f} ms a batch, waits "
        f"{files['inline']['wait_ms']:.2f} ms a step), {files['pool']['ms_step']:.3f} with a "
        f"pool of {UNETR_POOL - 1} ({files['pool']['volumes_s']:.2f} volumes/s, the loader "
        f"{files['pool']['loader_ms']:.1f} ms a batch, waits {files['pool']['wait_ms']:.2f} "
        f"ms a step); Patchify3D {costs['patchify_ms']:.3f} ms a sample; Dice "
        f"{evaluated['dice']:.6f}; a volume {evaluated['volume_s']:.3f} s "
        f"({100 * evaluated['volume_pre_share']:.1f}% preprocessing); served "
        f"{served['rps']:.2f} requests/s, p50 {served['p50']:.1f} p90 {served['p90']:.1f} p99 "
        f"{served['p99']:.1f} ms, a lone request {served['lone_ms']:.1f} ms, busy "
        f"{100 * served['busy']:.2f}%; launches {launches}")
    log(f"[unetr] phase_unetr took {time.perf_counter() - t0:.1f} s")
    return {"kernels": kernels, "launches": launches}


# ---------------------------------------------------------------- SAP and varemb


def _sap_groups(kernels, busy_ms: float, steps: int) -> str:
    """Device ms a step of a traced SAP window by kind of kernel, from their names,
    and each kind's share of the window:
    the convolutions (cuDNN's: the patch embed, the neck's ConvTranspose3d and
    the 1x1 head, forward, data and weight gradients), GEMMs, the flash
    kernels, AdamW and the element-wise rest."""
    groups = {"convolutions (cuDNN: patch embed, neck, head)": 0.0,
              "GEMMs (cuBLAS/CUTLASS)": 0.0, "flash forward": 0.0, "flash backward": 0.0,
              "AdamW (multi-tensor)": 0.0,
              "element-wise and other (GELU, LayerNorm, sigmoid, losses, copies)": 0.0}
    for t_us, _, key in kernels:
        name = key.lower()
        if "flash_fwd" in name:
            group = "flash forward"
        elif "flash_bwd" in name:
            group = "flash backward"
        elif any(w in name for w in ("conv", "fprop", "dgrad", "wgrad", "implicit",
                                     "winograd", "cudnn", "fft")):
            group = "convolutions (cuDNN: patch embed, neck, head)"
        elif any(w in name for w in ("gemm", "cutlass", "xmma", "nvjet", "cublas", "wgmma")):
            group = "GEMMs (cuBLAS/CUTLASS)"
        elif "multi_tensor" in name or "adam" in name:
            group = "AdamW (multi-tensor)"
        else:
            group = "element-wise and other (GELU, LayerNorm, sigmoid, losses, copies)"
        groups[group] += t_us / 1e3
    return "; ".join(f"{g} {ms / steps:.3f} ms = {100 * ms / busy_ms:.2f}%"
                     for g, ms in groups.items())


def _sap_conv_parts(model, batch: int) -> dict:
    """Device ms of each convolution of SAP's neck and head at a step's shapes,
    one at a time: the neck's ConvTranspose3d (768 -> 256, kernel = stride =
    4) forward, data gradient and weight gradient, and the same three of the
    1x1 head, in f32 as the path runs them; with the weight gradient's
    operations (one [B*512, 768] x [B*512, 256*64] product)."""
    import torch
    import torch.nn.functional as F

    neck, head = model.neck[0], model.mask_header[0]
    g = torch.Generator(device="cuda").manual_seed(19)
    grid = model.token_grid
    x = torch.randn(batch, model.embed_dim, *grid, device="cuda", generator=g)
    y = neck(x).detach()
    gy = torch.randn(y.shape, device="cuda", generator=g)
    gz = torch.randn((batch, head.out_channels) + tuple(y.shape[2:]), device="cuda",
                     generator=g)
    p, nd = neck.stride, len(grid)
    bwd = torch.ops.aten.convolution_backward
    zeros, ones = [0] * nd, [1] * nd
    parts = {
        "neck forward": lambda: F.conv_transpose3d(x, neck.weight, None, stride=p),
        "neck data gradient": lambda: bwd(gy, x, neck.weight, None, list(p), zeros, ones, True,
                                          zeros, 1, [True, False, False]),
        "neck weight gradient": lambda: bwd(gy, x, neck.weight, None, list(p), zeros, ones,
                                            True, zeros, 1, [False, True, False]),
        "head forward": lambda: F.conv3d(y, head.weight, head.bias),
        "head data gradient": lambda: bwd(gz, y, head.weight, None, ones, zeros, ones, False,
                                          zeros, 1, [True, False, False]),
        "head weight gradient": lambda: bwd(gz, y, head.weight, [head.out_channels], ones, zeros,
                                            ones, False, zeros, 1, [False, True, True]),
    }
    out = {name: device_ms(fn, iters=10, warmup=2)[0] for name, fn in parts.items()}
    flops = 2.0 * batch * math.prod(grid) * model.embed_dim * neck.out_channels * math.prod(p)
    log(f"[sap] batch {batch}: the neck and head one at a time, device ms: "
        + ", ".join(f"{k} {v:.3f}" for k, v in out.items())
        + f"; together {sum(out.values()):.3f} ms; the neck's weight gradient "
        f"{flops / 1e9:.1f} GFLOP = {flops / out['neck weight gradient'] / 1e9:.1f} TFLOP/s "
        "(f32, TF32 off)")
    return out


def _check_sap(model, bf16: bool) -> None:
    import torch

    from ucf_vit_tpu_torch.models import SAP

    if not (isinstance(model, SAP) and model.adaptive_patching and model.num_patches == 512
            and model.token_grid == (8, 8, 8) and model.embed_dim == 768
            and len(model.blocks) == 12 and model.blocks[0].attn.num_heads == 12
            and not model.remat and model.dtype == (torch.bfloat16 if bf16 else None)
            and model.neck[0].out_channels == 256 and model.neck[0].stride == (4, 4, 4)
            and model.mask_header[0].out_channels == 4
            and model.adaptive_pos_dep_emb is not None):
        fail(f"the run was not the shipped basic_ct/{'sap_bf16' if bf16 else 'sap'}")


def _sap_instances(steps: int, bf16: bool, backward: bool = True) -> dict:
    """The launches by instance of `steps` SAP train steps (or forwards): each of
    the 12 blocks runs the `<64>` forward and the fused backward of its dtype's
    source once a step (bwd_route's route at 512 queries)."""
    import torch

    from ucf_vit_tpu_torch.ops.flash_attention import bwd_route

    dtype = torch.bfloat16 if bf16 else torch.float32
    if bwd_route(dtype, 512, 512, 64) != "fused":
        fail(f"bwd_route no longer takes the fused route at SAP's 512 {dtype} queries")
    src = "sm90" if bf16 else "tf32"
    want = {k: 0 for k in _instance_counts()}
    want[f"fwd:flash_fwd_{src}<64>"] = 12 * steps
    if backward:
        want[f"bwd:flash_bwd_{src}<64>"] = 12 * steps
    return want


def _sap_cli(tag: str, argv: list, steps: int, bf16: bool) -> dict:
    """The trainer's CLI entry with the launch counts set to 0 before it; the
    model must be the shipped SAP and every launch the `<64>` instances of its
    dtype's source (12 forwards and 12 fused backwards a step, every bf16
    forward on the TMA route). Returns the launch counts by instance."""
    import numpy as np

    from ucf_vit_tpu_torch.ops.flash_attention import reset_launch_counts
    from ucf_vit_tpu_torch.train import main as train_main

    reset_launch_counts()
    t0 = time.perf_counter()
    out = train_main(argv)
    counts, instances = _launch_counts(), _instance_counts()
    _check_sap(out["state"].model, bf16)
    want = _sap_instances(steps, bf16)
    log(f"[sap] {tag}: python -m ucf_vit_tpu_torch.train {' '.join(argv[1:])}: "
        f"{time.perf_counter() - t0:.2f} s (init and save included); epoch losses "
        f"{out['loss_list']}; launches by instance a step "
        f"{ {k: n // steps for k, n in instances.items() if n} }")
    if (instances != want or counts["flash_bwd_dkv"] or counts["flash_bwd_dq"]
            or counts["route:padded"] or counts["route:tma"] != (12 * steps if bf16 else 0)
            or not all(np.isfinite(out["loss_list"]))):
        fail(f"{tag} through the CLI launched {instances} (expected {want}), {counts}; "
             f"losses {out['loss_list']}")
    del out
    return instances


def _sap_flash_against_einsum(name: str, cfg, batches, bf16: bool) -> tuple:
    """`_run_steps` under FLASH and under EINSUM from one init on `batches`: the
    per-step losses within TRAIN_LOSS_TOL (f32; bf16: SAP_BF16_LOSS_TOL), in f32
    the first step's gradients within TRAIN_GRAD_TOL of the largest entry;
    FLASH's launches as `_sap_instances` gives them, none under EINSUM. Returns
    FLASH's (state, step)."""
    import numpy as np

    runs = {}
    for impl in ("FLASH", "EINSUM"):
        st, sp, losses, grads, counts = _run_steps(_train_cfg(cfg, impl), batches)
        runs[impl] = (st, sp, losses, grads, counts, _instance_counts())
        if impl == "EINSUM":
            del st, sp
    (st, sp, lf, gf, _, inf), (_, _, le, ge, ce, _) = runs["FLASH"], runs["EINSUM"]
    del runs
    tol = SAP_BF16_LOSS_TOL if bf16 else TRAIN_LOSS_TOL
    diff = max(abs(a - b) for a, b in zip(lf, le))
    gmax = max(g.abs().max().item() for g in ge.values())
    gdiff = max((gf[n] - ge[n]).abs().max().item() for n in ge)
    log(f"[sap] {name} FLASH vs EINSUM, {len(batches)} steps: losses FLASH "
        f"{' '.join(f'{x:.6f}' for x in lf)}, EINSUM {' '.join(f'{x:.6f}' for x in le)}; max "
        f"|diff| {diff:.3e} (tol {tol:g}); first-step gradients max |diff| {gdiff / gmax:.3e} "
        f"of the largest entry" + ("" if bf16 else f" (tol {TRAIN_GRAD_TOL:g})"))
    if not all(np.isfinite(lf)) or diff > tol or (not bf16 and gdiff > TRAIN_GRAD_TOL * gmax):
        fail(f"{name}: FLASH training disagrees with EINSUM's")
    if inf != _sap_instances(len(batches), bf16) or any(ce.values()):
        fail(f"{name}: launches {inf} under FLASH, {ce} under EINSUM")
    del gf, ge
    return st, sp


def _sap_synthetic(name: str, bf16: bool) -> dict:
    """(b), (c): the CLI entry, a timed and a traced window (device time by kind,
    the neck's and head's convolutions one at a time), FLASH against EINSUM."""
    import torch

    from ucf_vit_tpu_torch.config import load_config
    from ucf_vit_tpu_torch.train import synthetic_batches

    path = _adaptive_config(SAP_CONFIGS[name], name)
    cfg = load_config(path)
    inst = _sap_cli(f"basic_ct/{name} synthetic", [path, "--synthetic", "--single-device",
                                                   "--max-steps", str(SAP_MAIN_STEPS)],
                    SAP_MAIN_STEPS, bf16)
    stream = synthetic_batches(cfg, cfg.batch_size, seed=0)
    w, t, tr = SAP_WARMUP, SAP_TIMED, SAP_TRACED
    batches = [next(stream) for _ in range(w + t + tr)]
    state, step = _sap_flash_against_einsum(name, cfg, batches[:SAP_CHECK_STEPS], bf16)
    res = _measure_steps("sap", f"basic_ct/{name} batch {cfg.batch_size}, FLASH", state, step,
                         batches[:w], batches[w:w + t], batches[w + t:], top=10)
    res["device_step_ms"] = res["busy_ms"] / res["traced_steps"]
    log(f"[sap] {name}: device time a step {res['device_step_ms']:.3f} ms; by kind: "
        f"{_sap_groups(res['kernels'], res['busy_ms'], res['traced_steps'])}; flash a step: "
        f"{_flash_per_step(res['kernels'], res['traced_steps'])}")
    parts = _sap_conv_parts(state.model, cfg.batch_size)
    res["neck_head_ms"] = sum(parts.values())
    res["neck_head_share"] = res["neck_head_ms"] / res["device_step_ms"]
    log(f"[sap] {name}: the f32 neck and head take {res['neck_head_ms']:.3f} ms a step, "
        f"{100 * res['neck_head_share']:.2f}% of the device time a step")
    res.update(instances=inst, parts=parts)
    del state, step, batches
    torch.cuda.empty_cache()
    return res


def _mae_checkpoint(mae_ckpt: str | None) -> str:
    """`mae_ckpt` (phase_train_disk's mae_long checkpoint), or where no earlier
    phase wrote one, a seeded mae_long init saved under WORK."""
    import torch

    from ucf_vit_tpu_torch.config import load_config
    from ucf_vit_tpu_torch.tasks import build_task

    if mae_ckpt is not None:
        return mae_ckpt
    path = os.path.join(WORK, "mae_long_seeded.ckpt")
    if not os.path.isfile(path):
        mcfg = load_config(MAE_CONFIG)
        mae = build_task(mcfg).init_weights(torch.Generator().manual_seed(3))
        torch.save({"epoch": 0, "model_state_dict": mae.state_dict(), "loss_list": [],
                    "head_meta": [int(mcfg.init_args["num_heads"]),
                                  int(mcfg.init_args["decoder_num_heads"])]}, path)
        del mae
    return path


def _sap_from_files(root: str, mae_ckpt: str) -> dict:
    """(d) basic_ct/sap from labelled NIfTI volumes: the MAE-encoder transfer
    held tensor for tensor, the CLI entry warm-started from `mae_ckpt` (its
    checkpoint serves (e) and (f)), then windows on the live loader in line (as
    shipped) and with a spawn pool of 4."""
    import numpy as np
    import torch

    from ucf_vit_tpu_torch.checkpoint import restore_checkpoint
    from ucf_vit_tpu_torch.config import load_config
    from ucf_vit_tpu_torch.ops.pos_embed import interpolate_pos_embed_1d
    from ucf_vit_tpu_torch.train import build_dataloader, init_train, transfer_pretrained_mae

    path = _adaptive_config(SAP_CONFIGS["sap"], "sap_files", dict_root_dirs={"ct1": root})
    cfg = load_config(path)
    # the transfer itself, held before the CLI runs it
    mae_sd = restore_checkpoint(mae_ckpt, "")["model_state_dict"]
    state, _ = init_train(cfg, "cuda")
    before = {k: v.detach().clone() for k, v in state.model.state_dict().items()}
    transfer_pretrained_mae(cfg, state.model, mae_ckpt)
    got = state.model.state_dict()
    from_mae = [k for k in got if k.startswith(("blocks.", "token_embeds.", "norm."))]
    own = [k for k in got if k.startswith(("neck.", "mask_header.", "adaptive_pos"))]
    same = all(torch.equal(got[k].cpu(), mae_sd[k]) for k in from_mae)
    kept = all(torch.equal(got[k], before[k]) for k in own)
    pos_ok = np.array_equal(got["pos_embed"].cpu().numpy(),
                            interpolate_pos_embed_1d(mae_sd["pos_embed"].numpy(), 512))
    log(f"[sap] warm start from {os.path.basename(mae_ckpt)}: {len(from_mae)} encoder tensors "
        f"equal the MAE's: {same}; pos_embed the MAE's {tuple(mae_sd['pos_embed'].shape)} "
        f"resampled to 512 rows: {pos_ok}; {len(own)} tensors of SAP's own (the position "
        f"MLP, the neck and the head) kept their init: {kept}")
    if not (same and kept and pos_ok and len(from_mae) == 12 * 12 + 4):
        fail("the MAE-encoder transfer did not give SAP the MAE's encoder")
    del state, before, got, mae_sd
    # the CLI entry from the files, warm-started
    import yaml

    raw = yaml.safe_load(open(path))
    raw["trainer"]["pretrained_mae_checkpoint"] = mae_ckpt
    with open(path, "w") as fh:
        yaml.safe_dump(raw, fh)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        inst = _sap_cli("basic_ct/sap from NIfTI files, warm-started",
                        [path, "--single-device", "--max-steps", str(SAP_MAIN_STEPS)],
                        SAP_MAIN_STEPS, False)
    if "initialized encoder from MAE checkpoint" not in buf.getvalue():
        fail("the trainer's CLI did not warm-start SAP from pretrained_mae_checkpoint")
    log("\n".join(line for line in buf.getvalue().splitlines() if line.startswith("[sap]")))
    ckpt = os.path.join(cfg.trainer["checkpoint_path"], "multi_last_even.ckpt")
    if not os.path.isfile(ckpt):
        fail(f"the SAP run from files saved no {ckpt}")
    # windows on the live loader
    batch = cfg.batch_size
    state, step = init_train(cfg, "cuda")
    res = {"instances": inst, "ckpt": ckpt, "path": path}
    for workers in (1, SAP_POOL):
        wcfg = load_config(_adaptive_config(path, f"sap_w{workers}", num_workers=workers))
        dm, _, bpre = build_dataloader(wcfg, batch, False)
        it = dm.train_dataloader(loop=True)
        try:
            b0, loader_ms = _loader_alone(it, 1 if workers > 1 else 4)
            b0 = b0[0]
            if workers > 1:  # the pool's start-up left out
                _, loader_ms = _loader_alone(it, 4)
            if (b0["seq"].shape != (batch, 1, 512, 64) or b0["seq_label"].shape
                    != (batch, 512, 4, 4, 4) or bpre != {"ct1": UNETR_VOLUMES * 8 // batch}
                    or not set(np.unique(b0["seq_label"])) <= {0, 1, 2, 3}):
                fail(f"the SAP loader gave seq {b0['seq'].shape}, seq_label "
                     f"{b0['seq_label'].shape} {np.unique(b0['seq_label'])}; {bpre} batches "
                     "an epoch")
            _disk_window(state, step, it, 2)
            wall, waited = _disk_window(state, step, it, SAP_FILE_STEPS)
        finally:
            it.close()
        key = "inline" if workers == 1 else "pool"
        res[key] = {"ms_step": 1e3 * wall / SAP_FILE_STEPS,
                    "volumes_s": batch * SAP_FILE_STEPS / wall,
                    "wait_ms": 1e3 * waited / SAP_FILE_STEPS, "loader_ms": loader_ms}
        log(f"[sap] from files, num_workers {workers}"
            f"{' (a spawn pool of ' + str(workers - 1) + ')' if workers > 1 else ' (in line)'}:"
            f" the loader alone {loader_ms:.1f} ms a batch of {batch}; {SAP_FILE_STEPS} steps "
            f"= {res[key]['ms_step']:.3f} ms/step, {res[key]['volumes_s']:.2f} volumes/s, "
            f"waiting for batches {res[key]['wait_ms']:.2f} ms a step")
    del state, step
    torch.cuda.empty_cache()
    return res


def _sap_evaluate(path: str, ckpt: str, vol_path: str) -> dict:
    """(e) the inference CLI's Dice under FLASH and EINSUM from the files, the
    PNG path's deserialized class maps, and `--volume` refused."""
    import numpy as np
    import yaml

    from ucf_vit_tpu_torch import inference
    from ucf_vit_tpu_torch.config import load_config
    from ucf_vit_tpu_torch.ops.flash_attention import reset_launch_counts

    paths, dice = {}, {}
    for impl in ("FLASH", "EINSUM"):
        raw = yaml.safe_load(open(path))
        raw["trainer"]["attn_impl"] = impl
        paths[impl] = os.path.join(WORK, f"sap_{impl}.yaml")
        with open(paths[impl], "w") as fh:
            yaml.safe_dump(raw, fh)
        reset_launch_counts()
        buf = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            mean = inference.main([paths[impl], "--checkpoint", ckpt, "--num-samples",
                                   str(SAP_EVAL_SAMPLES), "--device", "cuda"])
        per = [float(d) for d in re.findall(r"sample \d+: dice ([0-9.]+)", buf.getvalue())]
        dice[impl] = (mean, per, _instance_counts(), time.perf_counter() - t0)
    (fm, fp, finst, fs), (em, ep, einst, _) = dice["FLASH"], dice["EINSUM"]
    log(f"[sap] python -m ucf_vit_tpu_torch.inference --checkpoint (from files, "
        f"{SAP_EVAL_SAMPLES} samples) in {fs:.2f} s: Dice FLASH {fp} mean {fm:.6f}; EINSUM "
        f"{ep} mean {em:.6f}")
    if (len(fp) != SAP_EVAL_SAMPLES or abs(fm - em) > UNETR_DICE_TOL
            or finst != _sap_instances(SAP_EVAL_SAMPLES, False, backward=False)
            or any(einst.values())):
        fail(f"the inference CLI's SAP Dice differs under FLASH and EINSUM, or launched {finst} "
             f"/ {einst}")
    # --png-dir: matplotlib may not import here, so the arrays the PNGs would draw are
    # taken where the writer is called: the prediction deserialized to image space
    drawn, real = [], (inference._pyplot, inference._dump_png)
    inference._pyplot = lambda: None
    inference._dump_png = lambda d, i, pred, label: drawn.append((pred, label))
    try:
        with contextlib.redirect_stdout(io.StringIO()):
            inference.evaluate(load_config(paths["FLASH"]), ckpt, None, False, 2,
                               png_dir=os.path.join(WORK, "sap_png"), device="cuda")
    finally:
        inference._pyplot, inference._dump_png = real
    shapes = [(p.shape, p.dtype.name, lab.shape) for p, lab in drawn]
    log(f"[sap] --png-dir: {len(drawn)} panels drawn from the deserialized predictions "
        f"(prediction, label): {shapes}; classes {np.unique(drawn[0][0]).tolist()}")
    if len(drawn) != 2 or any(s != ((64, 64, 64), "int64", (64, 64, 64)) for s in shapes):
        fail(f"SAP's PNG panels are not image-space class maps: {shapes}")
    try:
        with contextlib.redirect_stdout(io.StringIO()):
            inference.main([paths["FLASH"], "--volume", vol_path, "--device", "cuda"])
    except AssertionError as e:
        log(f"[sap] --volume on basic_ct/sap: AssertionError: {e}")
        if "SAP predicts in the sqrt-len pseudo-image space" not in str(e):
            fail(f"--volume on SAP raised another message: {e}")
    else:
        fail("--volume on a SAP config did not raise")
    return {"dice": fm, "dice_per": fp, "eval_fwd": finst["fwd:flash_fwd_tf32<64>"]}


def _sap_serve(path: str, ckpt: str, tiles) -> dict:
    """(f) serving class maps with a preprocessing pool of 4 under load, at the
    config's batch."""
    import numpy as np
    import torch

    from ucf_vit_tpu_torch.config import load_config
    from ucf_vit_tpu_torch.ops.flash_attention import flash_attention, reset_launch_counts
    from ucf_vit_tpu_torch.serve import make_preprocessor, make_server
    from ucf_vit_tpu_torch.tasks import sap_inputs

    cfg = load_config(path)
    bodies = []
    for x in tiles:
        buf = io.BytesIO()
        np.save(buf, x)
        bodies.append(buf.getvalue())
    reset_launch_counts()
    t0 = time.perf_counter()
    server = make_server(cfg, ckpt, host="127.0.0.1", port=0, device="cuda",
                         preprocess_workers=SAP_SERVE_WORKERS)
    startup_s = time.perf_counter() - t0
    mb = server.RequestHandlerClass.batcher.max_batch
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    port = server.server_address[1]
    ctx = multiprocessing.get_context("spawn")
    pipe, child_pipe = ctx.Pipe()
    client = ctx.Process(target=_load_client, args=(port, bodies[:SAP_CLIENTS], child_pipe),
                         daemon=True)
    client.start()
    windows, answers = {}, []
    prof = torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA])
    pre = make_preprocessor(cfg)
    try:
        seq_lat = []
        for i in range(SAP_CLIENTS, len(bodies)):
            t1 = time.perf_counter()
            answers.append((i, np.load(io.BytesIO(_request(port, "POST", "/v1/predict",
                                                           bodies[i])))))
            seq_lat.append(time.perf_counter() - t1)
        for wname, seconds in SAP_SERVE_WINDOWS_S.items():
            before = _get_json(port, "/v1/stats")
            if wname == "traced":
                prof.start()
            pipe.send(seconds)
            if not pipe.poll(seconds + 300):
                fail(f"the load client gave no result for the SAP {wname} window")
            res = pipe.recv()
            if wname == "traced":
                prof.stop()
            if res["errors"] or not res["requests"]:
                fail(f"SAP load client, {wname} window: {len(res['requests'])} answers, "
                     f"errors {res['errors'][:3]}")
            windows[wname] = (res, before, _get_json(port, "/v1/stats"))
            answers += [(i, a) for i, _, a in res["requests"]]
        pipe.send(None)
        client.join(timeout=30)
        stats = _get_json(port, "/v1/stats")
        launches = dict(flash_attention.by_instance)
    finally:
        if client.is_alive():
            client.terminate()
            client.join()
        server.shutdown()
        server.server_close()
        server.RequestHandlerClass.batcher.close()
        thread.join(timeout=30)
    for wname, (res, before, after) in windows.items():
        log(_window_line(wname, res, before, after).replace("[serve]", "[sap serve]")
            .replace(f"from {LOAD_CLIENTS} closed-loop", f"from {SAP_CLIENTS} closed-loop"))
    traced_s = windows["traced"][0]["wall_s"]
    busy = sum(e.self_device_time_total for e in prof.key_averages()) / 1e3 / (1e3 * traced_s)
    load_res = windows["load"][0]
    rps = len(load_res["requests"]) / load_res["wall_s"]
    lat = np.array([r[1] for r in load_res["requests"]]) * 1e3
    if stats["errors"] or stats["requests"] != len(answers) + 1 or mb != cfg.batch_size:
        fail(f"SAP server stats {stats} for {len(answers) + 1} requests, max_batch {mb}")
    if launches["flash_fwd_tf32<64>"] != 12 * stats["batches"] or \
            sum(launches.values()) != launches["flash_fwd_tf32<64>"]:
        fail(f"the SAP server launched {launches} over {stats['batches']} batches")
    # every answer against the in-process forward of its preprocessed sample
    model = server.RequestHandlerClass.weights_holder["model"]
    want, masks = {}, {}
    for i0 in range(0, len(tiles), mb):
        b = [pre(x) for x in tiles[i0:i0 + mb]]
        b = {k: torch.from_numpy(np.stack([s[k] for s in b])).cuda() for k in b[0]}
        with torch.inference_mode():
            logits = model(*sap_inputs(cfg, b)).float().cpu().numpy()
        for j in range(len(logits)):
            want[i0 + j], masks[i0 + j] = logits[j].argmax(0), _margin_mask(logits[j:j + 1])[0]
    differ = sum(int(((a != want[i]) & masks[i]).sum()) for i, a in answers)
    left_out = sum(int((~masks[i]).sum()) for i, _ in answers)
    log(f"[sap serve] max_batch {mb} (the config's), --preprocess-workers {SAP_SERVE_WORKERS}: "
        f"startup {startup_s:.2f} s; a lone request {1e3 * min(seq_lat):.1f}-"
        f"{1e3 * max(seq_lat):.1f} ms; {rps:.2f} requests/s, p50 {np.percentile(lat, 50):.1f} "
        f"p90 {np.percentile(lat, 90):.1f} p99 {np.percentile(lat, 99):.1f} ms; device busy "
        f"{100 * busy:.2f}% of the traced window; {len(answers)} class maps against the "
        f"in-process forward: {differ} voxels differ where its top-two margin passes "
        f"{UNETR_MARGIN:g} ({left_out} voxels under it left out, of {len(answers) * 32 ** 3})")
    if differ or any(a.shape != (32, 32, 32) or a.dtype != np.int32 for _, a in answers):
        fail("served SAP class maps disagree with the in-process forward")
    return {"rps": rps, "p50": float(np.percentile(lat, 50)),
            "p90": float(np.percentile(lat, 90)), "p99": float(np.percentile(lat, 99)),
            "lone_ms": 1e3 * min(seq_lat), "busy": busy, "left_out": left_out,
            "fwd64": launches["flash_fwd_tf32<64>"]}


def _varemb_phase() -> dict:
    """(g) imagenet/classification with `use_varemb: True` (three variables, red,
    green and blue, each by its own LinearTokenEmbed, merged token by token by
    the variable attention), synthetic: the CLI entry (12 forwards and 12 fused
    backwards a step, the merge none), FLASH against EINSUM, ms a step beside the
    same config without varemb, and the merge's share of the device time."""
    import numpy as np
    import torch
    import yaml

    from ucf_vit_tpu_torch.config import load_config
    from ucf_vit_tpu_torch.ops.flash_attention import reset_launch_counts
    from ucf_vit_tpu_torch.train import init_train, synthetic_batches
    from ucf_vit_tpu_torch.train import main as train_main

    paths = {}
    for name, on in (("varemb", True), ("plain", False)):
        path = _adaptive_config(VAREMB_CONFIG, f"imagenet_{name}")
        raw = yaml.safe_load(open(path))
        raw["model"]["net"]["init_args"]["use_varemb"] = on
        with open(path, "w") as fh:
            yaml.safe_dump(raw, fh)
        paths[name] = path
    cfg = load_config(paths["varemb"])
    reset_launch_counts()
    t0 = time.perf_counter()
    out = train_main([paths["varemb"], "--synthetic", "--single-device", "--max-steps",
                      str(VAREMB_MAIN_STEPS)])
    instances, model = _instance_counts(), out["state"].model
    want = _expected_instances([(197, 197, 64)] * 12, VAREMB_MAIN_STEPS)
    log(f"[varemb] imagenet/classification use_varemb: python -m ucf_vit_tpu_torch.train "
        f"{paths['varemb']} --synthetic --single-device --max-steps {VAREMB_MAIN_STEPS}: "
        f"{time.perf_counter() - t0:.2f} s; epoch losses {out['loss_list']}; launches by "
        f"instance a step { {k: n // VAREMB_MAIN_STEPS for k, n in instances.items() if n} }")
    if (instances != want or model.var_agg is None or len(model.token_embeds) != 3
            or model.embed_dim != 768 or model.num_patches != 196
            or not all(np.isfinite(out["loss_list"]))):
        fail(f"imagenet/classification with varemb launched {instances} (expected {want}); "
             f"losses {out['loss_list']}")
    del out, model
    var_ids = (0, 1, 2)
    stream = synthetic_batches(cfg, cfg.batch_size, seed=0)
    batches = [next(stream) for _ in range(VAREMB_CHECK_STEPS)]
    runs = {}
    for impl in ("FLASH", "EINSUM"):
        st, _, losses, _, counts = _run_steps(_train_cfg(cfg, impl), batches, var_ids)
        runs[impl] = (losses, counts)
        del st
    (lf, cf), (le, ce) = runs["FLASH"], runs["EINSUM"]
    diff = max(abs(a - b) for a, b in zip(lf, le))
    log(f"[varemb] FLASH vs EINSUM, {len(batches)} steps: losses FLASH "
        f"{' '.join(f'{x:.6f}' for x in lf)}, EINSUM {' '.join(f'{x:.6f}' for x in le)}; max "
        f"|diff| {diff:.3e} (tol {TRAIN_LOSS_TOL:g})")
    if not all(np.isfinite(lf)) or diff > TRAIN_LOSS_TOL or cf["flash_fwd"] != 12 * len(batches) \
            or ce["flash_fwd"]:
        fail("imagenet/classification with varemb: FLASH training disagrees with EINSUM's")
    # ms a step with and without varemb, on the same batches; the merge alone
    res = {}
    for name in ("varemb", "plain"):
        state, step = init_train(load_config(paths[name]), "cuda")
        res[name] = _measure_steps("varemb", f"imagenet/classification f32 batch "
                                   f"{cfg.batch_size}, {name}", state, step, batches[:2],
                                   batches[:VAREMB_TIMED], batches[:2], top=4,
                                   var_ids=var_ids if name == "varemb" else None)
        res[name]["device_step_ms"] = res[name]["busy_ms"] / res[name]["traced_steps"]
        if name == "varemb":
            model = state.model
            x = torch.randn(cfg.batch_size, 3, model.num_patches, model.embed_dim,
                            device="cuda", requires_grad=True,
                            generator=torch.Generator(device="cuda").manual_seed(23))

            def merge():
                y = model.aggregate_variables(x)
                y.backward(torch.ones_like(y))

            res["agg_ms"] = device_ms(merge, iters=10, warmup=2)[0]
        del state, step
        torch.cuda.empty_cache()
    share = res["agg_ms"] / res["varemb"]["device_step_ms"]
    log(f"[varemb] ms a step with varemb {res['varemb']['ms_step']:.3f} "
        f"({res['varemb']['device_step_ms']:.3f} device), without {res['plain']['ms_step']:.3f} "
        f"({res['plain']['device_step_ms']:.3f} device); the merge (EINSUM over "
        f"{cfg.batch_size * 196} rows of 3 keys, forward and backward, its projections "
        f"included) {res['agg_ms']:.3f} ms = {100 * share:.2f}% of the device time a step")
    return {"ms_step": res["varemb"]["ms_step"], "plain_ms_step": res["plain"]["ms_step"],
            "agg_share": share, "fwd": instances["fwd:flash_fwd_tf32<64>"],
            "bwd": instances["bwd:flash_bwd_tf32<64>"]}


def phase_sap(mae_ckpt: str | None = None) -> dict:
    """configs/basic_ct/sap (f32, batch 2) and sap_bf16 (bf16, batch 16) as shipped,
    --single-device, and the variable embedding: (a) the f32 kernels at [24, 512,
    64] and the bf16 ones at [192, 512, 64] against their plain versions, timed
    beside SDPA and their bound, both backward routes in turns; (b) basic_ct/sap
    synthetic through the CLI entry, timed and traced windows (device time by
    kind, the neck's and head's convolutions one at a time), FLASH against EINSUM
    over 5 steps; (c) sap_bf16 the same; (d) from the labelled NIfTI volumes
    (phase_unetr's, or written here) in line and with a spawn pool of 4,
    warm-started from an MAE checkpoint (`mae_ckpt`, or a seeded mae_long); (e)
    the inference CLI's Dice under FLASH and EINSUM, the PNG path's deserialized
    maps and `--volume` refused; (f) serving with `--preprocess-workers 4` and 16
    clients; (g) imagenet/classification with `use_varemb: True`. Returns the
    kernels' numbers and the launches the record counts."""
    import numpy as np
    import torch

    from ucf_vit_tpu_torch.data.pipeline import read_nifti_file

    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(29)
    kernels = {dt: _attention_case("sap", f"basic_ct/{name}", SAP_SHAPES[dt], gen,
                                   iters=ADAPTIVE_KERNEL_ITERS, dtype_name=dt)
               for dt, name in (("float32", "sap"), ("bfloat16", "sap_bf16"))}
    torch.cuda.empty_cache()
    synth = {name: _sap_synthetic(name, name == "sap_bf16") for name in SAP_CONFIGS}

    root = os.path.join(WORK, "unetr_ct")  # phase_unetr's volumes, where it ran
    if not os.path.isdir(root):
        secs = _labelled_volumes(root, UNETR_VOLUMES, UNETR_SIDE, seed=17)
        log(f"[sap] wrote {UNETR_VOLUMES} int16 volumes of {UNETR_SIDE}^3 and their label "
            f"volumes in {secs:.2f} s")
    files = _sap_from_files(root, _mae_checkpoint(mae_ckpt))
    vol_path = os.path.join(WORK, "sap_volume.npy")
    np.save(vol_path, read_nifti_file(os.path.join(root, "imagesTr", "image0.nii")))
    evaluated = _sap_evaluate(files["path"], files["ckpt"], vol_path)
    torch.cuda.empty_cache()
    tiles = [np.ascontiguousarray(read_nifti_file(os.path.join(root, "imagesTr",
                                                               f"image{i}.nii"))
                                  [:, a:a + 64, b:b + 64, c:c + 64])
             for i in range(3) for a in (0, 64) for b in (0, 64) for c in (0, 64)]
    served = _sap_serve(files["path"], files["ckpt"], tiles[:SAP_CLIENTS + SAP_SEQUENTIAL])
    torch.cuda.empty_cache()
    varemb = _varemb_phase()
    f32, bf16 = synth["sap"], synth["sap_bf16"]
    launches = {
        "flash_fwd_sap": f32["instances"]["fwd:flash_fwd_tf32<64>"]
        + files["instances"]["fwd:flash_fwd_tf32<64>"] + evaluated["eval_fwd"] + served["fwd64"],
        "flash_bwd_fused_sap": f32["instances"]["bwd:flash_bwd_tf32<64>"]
        + files["instances"]["bwd:flash_bwd_tf32<64>"],
        "flash_fwd_bf16_sap": bf16["instances"]["fwd:flash_fwd_sm90<64>"],
        "flash_bwd_fused_bf16_sap": bf16["instances"]["bwd:flash_bwd_sm90<64>"],
    }
    log(f"[record] sap: " + "; ".join(
        f"{n} synthetic {r['ms_step']:.3f} ms/step, {r['images_s']:.2f} volumes/s, busy "
        f"{100 * r['busy_share']:.2f}%, {r['device_step_ms']:.3f} ms device a step, the f32 "
        f"neck and head {100 * r['neck_head_share']:.2f}% of it, peak {r['peak_gb']:.2f} GB"
        for n, r in synth.items())
        + f"; from files {files['inline']['ms_step']:.3f} ms/step in line (the loader "
        f"{files['inline']['loader_ms']:.1f} ms a batch, waits {files['inline']['wait_ms']:.2f} "
        f"ms a step), {files['pool']['ms_step']:.3f} with a pool of {SAP_POOL - 1} (the loader "
        f"{files['pool']['loader_ms']:.1f} ms a batch, waits {files['pool']['wait_ms']:.2f} ms a "
        f"step); Dice {evaluated['dice']:.6f}; served {served['rps']:.2f} requests/s, p50 "
        f"{served['p50']:.1f} p90 {served['p90']:.1f} p99 {served['p99']:.1f} ms, a lone "
        f"request {served['lone_ms']:.1f} ms, busy {100 * served['busy']:.2f}%, "
        f"{served['left_out']} voxels under the margin left out; varemb {varemb['ms_step']:.3f} "
        f"ms/step against {varemb['plain_ms_step']:.3f} without, the merge "
        f"{100 * varemb['agg_share']:.2f}% of the device time; launches {launches}")
    log(f"[sap] phase_sap took {time.perf_counter() - t0:.1f} s")
    numbers = {"flash_fwd_sap": kernels["float32"]["fwd"],
               "flash_bwd_fused_sap": kernels["float32"]["bwd"],
               "flash_fwd_bf16_sap": kernels["bfloat16"]["fwd"],
               "flash_bwd_fused_bf16_sap": kernels["bfloat16"]["bwd"]}
    return {"numbers": numbers, "launches": launches, "varemb": varemb}


def _use(modules: dict) -> None:
    """Make `modules` the process's `ucf_vit_tpu_torch`: the package imports
    some of its modules when called, and must find its own."""
    for name in [m for m in sys.modules if m.split(".")[0] == "ucf_vit_tpu_torch"]:
        del sys.modules[name]
    sys.modules.update(modules)


def _load_forward(checkout: str):
    """(`flash_attention` of the package in `checkout`, imported afresh, and
    that package's modules, `fused_mlp` and `int8_gemm` among them)."""
    _use({})
    sys.path.insert(0, checkout)
    try:
        from ucf_vit_tpu_torch.ops import build  # noqa: F401  (imported when called)
        from ucf_vit_tpu_torch.ops import fused_mlp  # noqa: F401
        from ucf_vit_tpu_torch.ops import int8_gemm  # noqa: F401
        from ucf_vit_tpu_torch.ops.flash_attention import flash_attention
    finally:
        sys.path.remove(checkout)
    return flash_attention, {m: mod for m, mod in sys.modules.items()
                             if m.split(".")[0] == "ucf_vit_tpu_torch"}


def _compare_op(checkouts, forwards, module: str, name: str, args, label: str) -> None:
    """`name` of `module` in each checkout on the same `args`: the device time of a
    call (all of its kernels, `device_ms`) in the order this checkout, the other,
    the other, this one, so that a drift of the card falls on both alike; each
    checkout's results against the first's."""
    fns = [getattr(modules[module], name) for _, modules in forwards]
    outs, times = [], [[] for _ in checkouts]
    for fn, (_, modules) in zip(fns, forwards):
        _use(modules)
        outs.append(fn(*args).float())
    for i in (0, 1, 1, 0):
        _use(forwards[i][1])
        times[i].append(device_ms(lambda: fns[i](*args), iters=20, warmup=2)[0])
    for i, c in enumerate(checkouts):
        diff = (outs[i] - outs[0]).abs().max().item()
        log(f"[compare] {c} {label}: a call {', '.join(f'{t:.4f}' for t in times[i])} ms "
            f"(device, all kernels); max |y - this checkout's| {diff:.3e}")


def compare_mlp(checkouts, forwards) -> None:
    """`fused_mlp` at RECORD_MLP in bf16 and in f32, and `int8_matmul` (bf16 in
    and out) at RECORD_INT8 of each checkout (`_compare_op`)."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(3)
    m, d, h = RECORD_MLP
    for dtype in (torch.bfloat16, torch.float32):
        _compare_op(checkouts, forwards, "ucf_vit_tpu_torch.ops.fused_mlp", "fused_mlp",
                    _mlp_inputs(m, d, h, dtype, gen),
                    f"fused_mlp [{m},{d}]->{h} {str(dtype).split('.')[-1]}")
    m, k, n = RECORD_INT8
    x = torch.randn(m, k, device="cuda", generator=gen).to(torch.bfloat16)
    quantize_weight = forwards[0][1]["ucf_vit_tpu_torch.ops.int8_gemm"].quantize_weight
    _compare_op(checkouts, forwards, "ucf_vit_tpu_torch.ops.int8_gemm", "int8_matmul",
                (x, *quantize_weight(0.02 * torch.randn(k, n, device="cuda", generator=gen))),
                f"int8_matmul [{m},{k}]x[{k},{n}] bf16")


def compare_split_bwd(checkouts, forwards) -> None:
    """The split route's kernels of each checkout at ViT-B/16's training shape
    (SHAPES[0], packed views): dkv and dq in f32 and in bf16, each launched
    alone on the same inputs into buffers made beforehand (`_bwd_launch`),
    its device time a call (every kernel of the call) in the order this
    checkout, the other, the other, this one; each checkout's outputs against
    the first's."""
    import torch

    b, h, n, _, dh, packed = SHAPES[0]
    gen = torch.Generator(device="cuda").manual_seed(4)
    sm = dh**-0.5
    launch = [m["ucf_vit_tpu_torch.ops.flash_attention"]._bwd_launch for _, m in forwards]
    no_dropout = (0, 0, 0, 0, 0, 1.0)  # `_dropout_args` at rate 0
    for dtype in (torch.float32, torch.bfloat16):
        q, k, v = _flash_inputs(b, h, n, n, dh, dtype, packed, gen)
        do = torch.randn(b, n, h, dh, device="cuda", generator=gen).to(dtype).transpose(1, 2)
        _use(forwards[0][1])
        o, lse = forwards[0][0](q, k, v, return_lse=True)
        di = (o.float() * do.float()).sum(-1).reshape(b * h, n)
        for kind in ("dkv", "dq"):
            outs = [tuple(torch.zeros(b, n, h, dh, device="cuda", dtype=dtype).transpose(1, 2)
                          for _ in "qkv") for _ in checkouts]

            def call(i):
                launch[i](kind, q, k, v, do, lse, di, *outs[i], sm, no_dropout)

            times = [[] for _ in checkouts]
            for i in (0, 1, 1, 0):
                _use(forwards[i][1])
                times[i].append(device_ms(lambda: call(i), iters=20, warmup=2)[0])
            wrote = slice(0, 1) if kind == "dq" else slice(1, 3)
            label = f"flash_bwd {kind} [{b},{h},{n},{dh}] {str(dtype).split('.')[-1]}"
            for i, c in enumerate(checkouts):
                diff = max((x.float() - y.float()).abs().max().item()
                           for x, y in zip(outs[i][wrote], outs[0][wrote]))
                log(f"[compare] {c} {label}: a call {', '.join(f'{t:.4f}' for t in times[i])} "
                    f"ms (device, all kernels); max |d - this checkout's| {diff:.3e}")
    _use({})


# ---------------------------------------------------------------- data and tensor parallel

PARALLEL_STEPS = 2  # each mode through the CLI entry, and its single-device run (5, then 3
# before phase_sp)
# ViT-L in fsdp 2 takes about 14 s a step here, gloo moving 9.7 GB of parameters through
# host memory a step: 2 steps of it (3 until the sharded evaluation came), against the
# single-device run's first 2
PARALLEL_FSDP_STEPS = 2
PARALLEL_TP_LOSS_TOL = 1e-4  # ViT-B f32, tp 2 against one device: each step's loss
PARALLEL_DDP_LOSS_TOL = 5e-3  # ViT-L bf16, ddp 2 against one device at the same global batch
PARALLEL_SIGTERM_AFTER = 1  # rank 0 of the preemption run is signalled after this step
PARALLEL_DEADLINE_S = 300  # for every job of the two ranks together
PARALLEL_KERNEL_ITERS = 20  # timed calls of each kernel at tp 2's per-rank shape
# sharded evaluation, generation and serving on the same two ranks
PARALLEL_EVAL_SAMPLES = 32  # (d): two global batches of catsdogs' 16, synthetic
PARALLEL_CHAIN_STEPS = 50  # (e): imagenet/diffusion's 1,000-step chain cut to this many
PARALLEL_CHAIN_SAMPLES = 4  # (e): two rows a rank
PARALLEL_CHAIN_TOL = 1e-4  # (e): images against one device's, times its largest entry
PARALLEL_SERVE_LONE, PARALLEL_SERVE_COALESCED = 6, 6  # (f): requests before the reload
PARALLEL_SERVE_AFTER = 2  # (f): lone requests after it
# What `python -m ucf_vit_tpu_torch.tools.gloo_probe` found gloo carries on CUDA tensors
# in the card's torch (2.11.0+cu128; PERF.md): all six collectives it tries, and
# the port's ddp 2, tp 2 and fsdp 2 steps; its bare `fully_shard` step with
# `DTensor.full_tensor` hung, so the port's checkpoint joins FSDP's shards with
# `all_gather_into_tensor` itself. The modes below are fixed by that run; the phase
# repeats the probe's six collectives and fails if one a mode needs is missing. NCCL
# refuses two ranks on one device, so two ranks share the card over gloo here; NCCL stays
# the CLI's backend on CUDA (`parallel.mesh.init_distributed`).
GLOO_PROBED = ("all_reduce", "broadcast", "all_gather", "all_gather_into_tensor",
               "reduce_scatter_tensor", "all_to_all_single")
PARALLEL_MODES = {  # name: (config, parallelism, the collectives it needs)
    "vit_b_tp2": (CONFIG, {"tensor_par_size": 2}, ("all_reduce",)),
    "vit_l_ddp2": (VIT_L_CONFIG, {"simple_ddp_size": 2}, ("all_reduce",)),
    "vit_l_fsdp2": (VIT_L_CONFIG, {"fsdp_size": 2},
                    ("all_reduce", "all_gather_into_tensor", "reduce_scatter_tensor")),
}


def _parallel_config(name: str, path: str, par: dict, batch: int | None = None,
                     init_args: dict | None = None, **trainer) -> str:
    """A copy of the shipped config at `path` under WORK/parallel with `par` as its
    parallelism (empty: one device), its per-step metrics in <name>.jsonl."""
    import yaml

    raw = yaml.safe_load(open(path))
    raw["parallelism"] = {"fsdp_size": 1, "simple_ddp_size": 1, "tensor_par_size": 1,
                          "seq_par_size": 1, **par}
    if batch is not None:
        raw["data"]["batch_size"] = batch
    raw["model"]["net"]["init_args"].update(init_args or {})
    root = os.path.join(WORK, "parallel")
    os.makedirs(root, exist_ok=True)
    raw["trainer"].pop("checkpoint_path", None)  # no save but where `trainer` asks
    raw["trainer"].update(metrics_path=os.path.join(root, f"{name}.jsonl"),
                          resume_from_checkpoint=False, **trainer)
    out = os.path.join(root, f"{name}.yaml")
    with open(out, "w") as f:
        yaml.safe_dump(raw, f)
    return out


def _jsonl(path: str) -> list:
    with open(path) as f:
        return [json.loads(line) for line in f]


def _logged_step(path: str) -> int:
    """The last step rank 0 has written to the metrics file at `path` (0 before
    any; a line still being written does not count)."""
    if not os.path.exists(path):
        return 0
    with open(path) as f:
        lines = f.read().split("\n")[:-1]  # complete lines only
    return max((json.loads(line).get("step", 0) for line in lines), default=0)


def _step_losses(path: str) -> list:
    return [r["loss"] for r in _jsonl(path) if "loss" in r and "step" in r]


TALLY_KEYS = ("bytes", "steps", "kind_steps")


@contextlib.contextmanager
def _timed_steps(times: list, tally: dict | None = None):
    """The trainer's train step timed a call at a time (the card synchronised
    around it) while the block runs: `train.make_train_step` wrapped. With
    `tally` (`_counting_collectives`'), each step's bytes are appended to
    `tally["steps"]`, and by kind to `tally["kind_steps"]` where it has that
    list."""
    import torch

    from ucf_vit_tpu_torch import train

    made = train.make_train_step

    def make(*args, **kwargs):
        step = made(*args, **kwargs)

        def timed(*a, **k):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            before = tally["bytes"] if tally is not None else 0
            kinds = dict(tally) if tally is not None else {}
            out = step(*a, **k)
            torch.cuda.synchronize()
            times.append(1e3 * (time.perf_counter() - t0))
            if tally is not None:
                tally["steps"].append(tally["bytes"] - before)
                if "kind_steps" in tally:  # and by kind (`_counting_collectives`' `kind`)
                    tally["kind_steps"].append({k: v - kinds.get(k, 0) for k, v in tally.items()
                                                if k not in TALLY_KEYS})
            return out
        return timed

    train.make_train_step = make
    try:
        yield
    finally:
        train.make_train_step = made


def _parallel_rank(rank: int, store: str, jobs: list, results) -> None:
    """One of two ranks on the card: a gloo group through a FileStore, then each
    job in turn: the gloo probe, the trainer's CLI entry on a sharded config, or
    a step of sharded evaluation (`_SHARDED_EVAL`), with the launch counts set
    to 0 before it and read after. Puts each job's counts and its results
    (local shapes and step times; top-1, images, seconds) on `results`."""
    import torch
    import torch.distributed as dist

    sys.path.insert(0, REPO)
    torch.cuda.set_device(0)
    dist.init_process_group("gloo", store=dist.FileStore(store, 2), rank=rank, world_size=2)
    from ucf_vit_tpu_torch.ops.flash_attention import reset_launch_counts
    from ucf_vit_tpu_torch.tools.gloo_probe import _collectives
    from ucf_vit_tpu_torch.train import main as train_main

    try:
        for job in jobs:
            if job["kind"] == "probe":
                results.put((rank, job["name"],
                             {"collectives": _collectives(rank, 2, only=GLOO_PROBED)}))
                continue
            if job["kind"] in _SHARDED_EVAL:
                reset_launch_counts()
                t0 = time.perf_counter()
                out = _SHARDED_EVAL[job["kind"]](job)
                torch.cuda.synchronize()
                results.put((rank, job["name"], {
                    **out, "s": time.perf_counter() - t0, "counts": _launch_counts(),
                    "instances": _instance_counts()}))
                torch.cuda.empty_cache()
                continue
            times: list = []
            reset_launch_counts()
            with _timed_steps(times):
                out = train_main(job["argv"])
            counts = _launch_counts()
            model = out["state"].model
            attn = model.blocks[0].attn
            results.put((rank, job["name"], {
                "counts": counts, "ms": times, "steps": out["state"].step,
                "shapes": _attn_shapes(model), "depth": len(model.blocks),
                "heads": attn.qkv.weight.shape[0] // (3 * attn.head_dim),
                "embed": model.embed_dim, "remat": model.remat,
                "dtype": str(model.dtype), "tp": sorted(model.tp_layout)[:2]}))
            del out, model, attn
            torch.cuda.empty_cache()
    except BaseException:
        import traceback

        results.put((rank, "error", traceback.format_exc()))
        raise
    finally:
        dist.destroy_process_group()


@contextlib.contextmanager
def _logits_of(into: list):
    """The outputs of every model that `inference.init_eval_model` builds while
    the block runs (a classifier's logits), appended to `into` on the CPU."""
    from ucf_vit_tpu_torch import inference

    made = inference.init_eval_model

    def init(*args, **kwargs):
        model = made(*args, **kwargs)
        model.register_forward_hook(lambda m, i, out: into.append(out.detach().float().cpu()))
        return model

    inference.init_eval_model = init
    try:
        yield
    finally:
        inference.init_eval_model = made


def _eval_top1(job: dict) -> dict:
    """(d) The inference CLI on this rank: top-1 and the logits of every batch."""
    from ucf_vit_tpu_torch.inference import main as inference_main

    logits: list = []
    with _logits_of(logits):
        top1 = inference_main(job["argv"])
    return {"top1": top1, "logits": logits}


def _eval_chain(job: dict) -> dict:
    """(e) `generate_diffusion` on this rank: the images every rank returns."""
    from ucf_vit_tpu_torch.config import load_config
    from ucf_vit_tpu_torch.inference import generate_diffusion

    sps, imgs = generate_diffusion(load_config(job["config"]), None, job["num_samples"], None,
                                   False, True)
    return {"images": imgs, "samples_s": sps}


def _eval_serve(job: dict) -> dict:
    """(f) `python -m ucf_vit_tpu_torch.serve` on this rank: rank 0 serves HTTP
    until SIGTERM, rank 1 follows; both return."""
    from ucf_vit_tpu_torch.serve import main as serve_main

    serve_main(job["argv"])
    return {"returned": True}


_SHARDED_EVAL = {"eval": _eval_top1, "chain": _eval_chain, "serve": _eval_serve}


def _serve_client(port: int, bodies: list, ckpt: str, out: dict, stop) -> None:
    """(f)'s HTTP client, in a thread of the parent: PARALLEL_SERVE_LONE lone
    requests, PARALLEL_SERVE_COALESCED at once (one batch, padded), a
    `/v1/reload` of `ckpt`, PARALLEL_SERVE_AFTER lone requests; then `stop()`
    (SIGTERM to rank 0). Answers by body index in `out["answers"]`."""
    import numpy as np

    try:
        deadline = time.perf_counter() + PARALLEL_DEADLINE_S
        while True:
            try:
                _get_json(port, "/healthz")
                break
            except OSError:
                if time.perf_counter() > deadline:
                    raise
                time.sleep(0.2)
        answers, t0 = {}, time.perf_counter()

        def ask(i):
            answers[i] = np.load(io.BytesIO(_request(port, "POST", "/v1/predict",
                                                     _npy(bodies[i]))))

        n = PARALLEL_SERVE_LONE
        for i in range(n):
            ask(i)
        threads = [threading.Thread(target=ask, args=(i,))
                   for i in range(n, n + PARALLEL_SERVE_COALESCED)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=PARALLEL_DEADLINE_S)
        out["before_reload_s"] = time.perf_counter() - t0
        t1 = time.perf_counter()
        out["reload"] = json.loads(_request(port, "POST", "/v1/reload",
                                            json.dumps({"checkpoint": ckpt}).encode()))
        out["reload_s"] = time.perf_counter() - t1
        for i in range(n + PARALLEL_SERVE_COALESCED, len(bodies)):
            ask(i)
        out["stats"] = _get_json(port, "/v1/stats")
        out["answers"] = answers
    except BaseException as e:
        out["error"] = repr(e)
    finally:
        stop()


def _npy(arr) -> bytes:
    import numpy as np

    buf = io.BytesIO()
    np.save(buf, arr)
    return buf.getvalue()


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _single_run(name: str, path: str, steps: int = PARALLEL_STEPS) -> dict:
    """`path` through the CLI entry on this process's device for `steps` steps:
    per-step losses and ms."""
    import torch

    from ucf_vit_tpu_torch.train import main as train_main

    times: list = []
    with _timed_steps(times):
        train_main([path, "--synthetic", "--max-steps", str(steps)])
    torch.cuda.empty_cache()
    return {"losses": _step_losses(os.path.join(WORK, "parallel", f"{name}.jsonl")), "ms": times}


def _config_batch(path: str) -> int:
    """The shipped config's `data.batch_size` (a data rank's batch)."""
    import yaml

    return int(yaml.safe_load(open(path))["data"]["batch_size"])


def _config_tile(path: str) -> tuple:
    """The shipped config's 2-D `tile_size`."""
    import yaml

    return tuple(yaml.safe_load(open(path))["model"]["net"]["init_args"]["tile_size"][:2])


def _median(xs: list) -> float:
    xs = sorted(xs)
    return xs[len(xs) // 2] if xs else float("nan")


def phase_parallel() -> dict:
    """Data and tensor parallelism with two ranks on the one card over gloo (NCCL
    refuses two ranks on one device; NCCL stays the CLI's backend on CUDA).
    Two spawned ranks in one gloo group run, in turn: (a) the gloo probe
    (`tools/gloo_probe.py`: which collectives gloo carries on CUDA tensors),
    printed, failing if a mode of PARALLEL_MODES needs one it lacks; (b)
    catsdogs/classification (ViT-B/16, f32, full width and depth) in tp 2
    through the trainer's CLI entry for PARALLEL_STEPS steps: per rank and step
    12 f32 forwards at [16·6, 257, 64] and 12 fused backwards under the tf32
    sources, the per-step losses within PARALLEL_TP_LOSS_TOL of the same
    config on one device; (c) imagenet/classification_vit_l (bf16, remat,
    accum 4) in ddp 2 and, for PARALLEL_FSDP_STEPS steps, in fsdp 2 (ZeRO-3
    by `fully_shard`), each with the sync check every step: every launch
    under the sm90 sources and every bf16 forward on the TMA route, the
    losses within PARALLEL_DDP_LOSS_TOL of one device at the same global
    batch (2 x 32); SIGTERM to rank 0 alone of a ddp-2 ViT-B run after step
    PARALLEL_SIGTERM_AFTER: both ranks exit 0 and one checkpoint is written.
    Each rank's ms a step (the card synchronised around it) beside the
    single-device step: two ranks share one card, so it is no scaling number.
    Then sharded evaluation, generation and serving (`_parallel_eval_checks`):
    (d) the inference CLI in tp 2 on the checkpoint (b) saved; (e)
    imagenet/diffusion's reverse chain in ddp 2, cut to PARALLEL_CHAIN_STEPS;
    (f) a tp-2 server, this process its HTTP client. Returns {"numbers":
    record rows at tp 2's and the chain's per-rank shapes, "launches": theirs
    and the ViT-L runs' bf16 launches}."""
    import queue
    import signal

    import numpy as np
    import torch

    ck_dir = os.path.join(WORK, "parallel", "ck_tp2")
    ck_tp2 = os.path.join(ck_dir, "tp2_even.ckpt")  # epoch 0, which its steps end
    vit_b = _parallel_config("vit_b_tp2", CONFIG, PARALLEL_MODES["vit_b_tp2"][1],
                             checkpoint_path=ck_dir, checkpoint_filename="tp2")
    vit_b_one = _parallel_config("vit_b_one", CONFIG, {})
    cut = {"num_time_steps": PARALLEL_CHAIN_STEPS}
    chain = _parallel_config("chain_ddp2", DIFF_CONFIGS["imagenet"], {"simple_ddp_size": 2},
                             init_args=cut)
    chain_one = _parallel_config("chain_one", DIFF_CONFIGS["imagenet"], {}, init_args=cut)
    port = _free_port()
    vit_l = {name: _parallel_config(name, VIT_L_CONFIG, PARALLEL_MODES[name][1],
                                    sync_check_every=1)
             for name in ("vit_l_ddp2", "vit_l_fsdp2")}
    vit_l_one = _parallel_config("vit_l_one", VIT_L_CONFIG, {},
                                 batch=2 * _config_batch(VIT_L_CONFIG))
    ck = os.path.join(WORK, "parallel", "ck")
    sigterm = _parallel_config("sigterm", CONFIG, {"simple_ddp_size": 2},
                               checkpoint_path=ck, checkpoint_filename="sig",
                               preempt_sync_every=1, max_epochs=1)
    n_steps = {"vit_b_tp2": PARALLEL_STEPS, "vit_l_ddp2": PARALLEL_STEPS,
               "vit_l_fsdp2": PARALLEL_FSDP_STEPS}
    steps = {name: ["--synthetic", "--max-steps", str(n)] for name, n in n_steps.items()}
    jobs = [{"kind": "probe", "name": "probe"},
            {"kind": "cli", "name": "vit_b_tp2", "argv": [vit_b, *steps["vit_b_tp2"]]},
            {"kind": "cli", "name": "vit_l_ddp2",
             "argv": [vit_l["vit_l_ddp2"], *steps["vit_l_ddp2"]]},
            {"kind": "cli", "name": "vit_l_fsdp2",
             "argv": [vit_l["vit_l_fsdp2"], *steps["vit_l_fsdp2"]]},
            {"kind": "cli", "name": "sigterm", "argv": [sigterm, "--synthetic"]},
            # (d)-(f): sharded evaluation, generation and serving
            {"kind": "eval", "name": "eval_tp2",
             "argv": [vit_b, "--checkpoint", ck_tp2, "--synthetic", "--num-samples",
                      str(PARALLEL_EVAL_SAMPLES)]},
            {"kind": "chain", "name": "chain_ddp2", "config": chain,
             "num_samples": PARALLEL_CHAIN_SAMPLES},
            {"kind": "serve", "name": "serve_tp2",
             "argv": [vit_b, "--port", str(port), "--host", "127.0.0.1", "--max-batch",
                      str(_config_batch(CONFIG)), "--max-wait-ms", "50"]}]
    rng = np.random.default_rng(11)
    bodies = [rng.random((3,) + _config_tile(CONFIG)).astype(np.float32) for _ in range(
        PARALLEL_SERVE_LONE + PARALLEL_SERVE_COALESCED + PARALLEL_SERVE_AFTER)]
    client, served = None, {}
    log("[parallel] two ranks on one card over gloo: NCCL refuses two ranks on one "
        "device; NCCL stays the CLI's backend on CUDA")
    torch.cuda.empty_cache()
    ctx = multiprocessing.get_context("spawn")
    results = ctx.Queue()
    store = os.path.join(WORK, "parallel", "store")
    procs = [ctx.Process(target=_parallel_rank, args=(r, store, jobs, results), daemon=True)
             for r in range(2)]
    t0 = time.perf_counter()
    for p in procs:
        p.start()
    got: dict = {}
    sig_metrics = os.path.join(WORK, "parallel", "sigterm.jsonl")
    signalled = None
    try:
        while len(got) < 2 * len(jobs):
            if time.perf_counter() - t0 > PARALLEL_DEADLINE_S:
                fail(f"the two ranks did not finish within {PARALLEL_DEADLINE_S} s: {sorted(got)}")
            if signalled is None and _logged_step(sig_metrics) >= PARALLEL_SIGTERM_AFTER:
                os.kill(procs[0].pid, signal.SIGTERM)
                signalled = time.perf_counter()
            if client is None and all((r, "chain_ddp2") in got for r in range(2)):
                # (f): the ranks are building the server; the client waits for it
                client = threading.Thread(target=_serve_client, args=(
                    port, bodies, ck_tp2, served,
                    lambda: os.kill(procs[0].pid, signal.SIGTERM)), daemon=True)
                client.start()
            try:
                rank, name, out = results.get(timeout=0.2)
            except queue.Empty:
                if any(p.exitcode not in (None, 0) for p in procs):
                    fail(f"a rank died: exit codes {[p.exitcode for p in procs]}")
                continue
            if name == "error":
                fail(f"rank {rank} failed:\n{out[-3000:]}")
            got[rank, name] = out
            if name == "probe" and rank == 0:
                carried = [k for k, v in out["collectives"].items() if v == "ok"]
                log(f"[parallel] gloo probe on CUDA tensors (torch {torch.__version__}): "
                    + ", ".join(f"{k} {v}" for k, v in out["collectives"].items()))
                log(f"[parallel] gloo carries on CUDA tensors: {', '.join(carried)}")
                for mode, (_, _, needs) in PARALLEL_MODES.items():
                    if any(c not in carried for c in needs):
                        fail(f"{mode} needs {needs}; gloo carries {carried}")
        for p in procs:
            p.join(timeout=60)
        if client is not None:
            client.join(timeout=60)
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
    if [p.exitcode for p in procs] != [0, 0]:
        fail(f"the ranks exited {[p.exitcode for p in procs]}")
    log(f"[parallel] two ranks: {time.perf_counter() - t0:.1f} s for every job")
    # preemption: one checkpoint, both ranks at the same step
    files = sorted(os.listdir(ck)) if os.path.isdir(ck) else []
    sig = [got[r, "sigterm"] for r in range(2)]
    if signalled is None or files != ["sig_even.ckpt"] or sig[0]["steps"] != sig[1]["steps"]:
        fail(f"SIGTERM to rank 0: files {files}, steps {[s['steps'] for s in sig]}")
    payload = torch.load(os.path.join(ck, files[0]), map_location="cpu", weights_only=True,
                         mmap=True)
    log(f"[parallel] SIGTERM to rank 0 after step {PARALLEL_SIGTERM_AFTER}: both ranks "
        f"stopped after step {sig[0]['steps']} and exited 0; one checkpoint {files} "
        f"(num_procs {payload['num_procs']}, data_it {payload['data_it']})")
    del payload

    # (b), (c): the single-device runs at the same global batch, then the checks
    one = {"vit_b_tp2": _single_run("vit_b_one", vit_b_one),
           "vit_l_ddp2": _single_run("vit_l_one", vit_l_one)}
    one["vit_l_fsdp2"] = one["vit_l_ddp2"]  # the same global batch, 2 x 32
    tols = {"vit_b_tp2": PARALLEL_TP_LOSS_TOL, "vit_l_ddp2": PARALLEL_DDP_LOSS_TOL,
            "vit_l_fsdp2": PARALLEL_DDP_LOSS_TOL}
    for name in ("vit_b_tp2", "vit_l_ddp2", "vit_l_fsdp2"):
        ranks = [got[r, name] for r in range(2)]
        losses = _step_losses(os.path.join(WORK, "parallel", f"{name}.jsonl"))
        diff = max(abs(a - b) for a, b in zip(losses, one[name]["losses"]))
        log(f"[parallel] {name}: losses {' '.join(f'{x:.6f}' for x in losses)}; one device "
            f"{' '.join(f'{x:.6f}' for x in one[name]['losses'])}; max |diff| {diff:.3e} "
            f"(tol {tols[name]:g})")
        if len(losses) != n_steps[name] or not np.all(np.isfinite(losses)) or diff > tols[name]:
            fail(f"{name}'s losses disagree with one device's")
        for r, res in enumerate(ranks):
            log(f"[parallel] {name} rank {r}: {_median(res['ms'][1:] or res['ms']):.3f} ms a "
                f"step ({'median of steps 2-' if n_steps[name] > 1 else 'step '}"
                f"{n_steps[name]}; one device {_median(one[name]['ms'][1:]):.3f}; two ranks "
                f"share one card: no scaling "
                f"number); heads a rank {res['heads']}, launches {res['counts']}")
    tp = [got[r, "vit_b_tp2"] for r in range(2)]
    want = _expected_counts(tp[0]["shapes"], PARALLEL_STEPS, dropout=False)
    for r, res in enumerate(tp):
        if res["counts"] != want or res["heads"] != 6 or res["embed"] != 768 or \
                res["depth"] != 12 or res["dtype"] != "None" or not res["tp"]:
            fail(f"vit_b_tp2 rank {r}: launches {res['counts']} (expected {want}), "
                 f"{res['heads']} heads, embed {res['embed']}, depth {res['depth']}, "
                 f"dtype {res['dtype']}, tp split {res['tp']}")
    ddp = [got[r, name] for name in ("vit_l_ddp2", "vit_l_fsdp2") for r in range(2)]
    for name in ("vit_l_ddp2", "vit_l_fsdp2"):
        want_l = _expected_counts(got[0, name]["shapes"], 4 * n_steps[name], dropout=False,
                                  bf16=True, forwards_per_step=2)
        for r in range(2):
            res = got[r, name]
            if res["counts"] != want_l or res["embed"] != 1024 or res["depth"] != 24 or \
                    not res["remat"] or res["dtype"] != "torch.bfloat16":
                fail(f"{name} rank {r}: launches {res['counts']} (expected {want_l}), embed "
                     f"{res['embed']}, depth {res['depth']}, remat {res['remat']}")
        checks = [r for r in _jsonl(os.path.join(WORK, "parallel", f"{name}.jsonl"))
                  if "sync_check" in r]
        if len(checks) != n_steps[name] or not all("OK" in r["sync_check"] for r in checks):
            fail(f"{name}'s sync checks: {checks}")
        log(f"[parallel] {name} sync check every step: {checks[-1]['sync_check']}")

    # the kernels at tp 2's per-rank shape: [16, 6, 257, 257, 64], qkv views
    gen = torch.Generator(device="cuda").manual_seed(7)
    b = _config_batch(CONFIG)
    case = _attention_case("parallel", "ViT-B/16 tp 2, a rank's heads", (b, 6) + VIT_ATTN[:2]
                           + (VIT_ATTN[2], True), gen, iters=PARALLEL_KERNEL_ITERS)
    evals = _parallel_eval_checks(got, vit_b_one, ck_tp2, chain_one, bodies, served, gen)
    launches = {"flash_fwd_tp2": sum(res["counts"]["src:flash_fwd_tf32"] for res in tp)
                + evals["launches"]["tp2"],
                "flash_bwd_fused_tp2": sum(res["counts"]["flash_bwd_fused"] for res in tp),
                "flash_fwd_bf16": sum(res["counts"]["src:flash_fwd_sm90"] for res in ddp),
                "flash_bwd_fused_bf16": sum(res["counts"]["flash_bwd_fused"] for res in ddp),
                "flash_fwd_chain_enc_ddp2": evals["launches"]["enc"],
                "flash_fwd_chain_dec_ddp2": evals["launches"]["dec"]}
    return {"numbers": {"flash_fwd_tp2": case["fwd"], "flash_bwd_fused_tp2": case["bwd"],
                        **evals["numbers"]},
            "launches": launches}


def _parallel_eval_checks(got: dict, vit_b_one: str, ck_tp2: str, chain_one: str, bodies: list,
                          served: dict, gen) -> dict:
    """(d)-(f) of `phase_parallel` against one device on this process's card:
    the sharded top-1 and logits, the sharded chain's images and the sharded
    server's answers; each sub-step's seconds and each rank's f32 forwards
    printed; the f32 kernels at the chain's per-rank shapes against their plain
    versions. Returns {"numbers": record rows, "launches": {"tp2": (d)'s and
    (f)'s forwards, "enc"/"dec": the chain's <64> and <128> forwards}}."""
    import numpy as np

    from ucf_vit_tpu_torch.config import load_config
    from ucf_vit_tpu_torch.serve import build_predictor

    ranks = {name: [got[r, name] for r in range(2)]
             for name in ("eval_tp2", "chain_ddp2", "serve_tp2")}
    for name, res in ranks.items():
        for r, out in enumerate(res):
            bad = {k: n for k, n in out["counts"].items()
                   if n and k not in ("flash_fwd", "src:flash_fwd_tf32")}
            log(f"[parallel] {name} rank {r}: {out['s']:.1f} s; f32 forwards "
                f"{out['counts']['src:flash_fwd_tf32']} ({', '.join(f'{k} {n}' for k, n in out['instances'].items() if n)})")
            if out["counts"]["src:flash_fwd_tf32"] <= 0 or bad:
                fail(f"{name} rank {r}: every launch must be an f32 forward (tf32 sources): "
                     f"{out['counts']}")
    # (d) the inference CLI in tp 2 against one device on the same checkpoint and samples
    t0 = time.perf_counter()
    one = _eval_top1({"argv": [vit_b_one, "--checkpoint", ck_tp2, "--synthetic",
                               "--num-samples", str(PARALLEL_EVAL_SAMPLES)]})
    sharded = ranks["eval_tp2"][0]
    diff = max((a - b).abs().max().item() for a, b in zip(sharded["logits"], one["logits"]))
    batches = PARALLEL_EVAL_SAMPLES // _config_batch(CONFIG)
    log(f"[parallel] (d) inference CLI, ViT-B/16 tp 2 on the tp-2 run's checkpoint: top-1 "
        f"{sharded['top1']:.4f} over {PARALLEL_EVAL_SAMPLES} samples, one device "
        f"{one['top1']:.4f}; max |logits - one device's| {diff:.3e} (tol {FLASH_TOL['float32']:g}); "
        f"{max(r['s'] for r in ranks['eval_tp2']):.1f} s on two ranks, one device "
        f"{time.perf_counter() - t0:.1f} s")
    if sharded["top1"] != one["top1"] or len(sharded["logits"]) != batches or \
            len(one["logits"]) != batches or diff > FLASH_TOL["float32"]:
        fail("(d) the sharded evaluation disagrees with one device's")
    if any(r["counts"]["src:flash_fwd_tf32"] != 12 * batches for r in ranks["eval_tp2"]):
        fail(f"(d) expected {12 * batches} f32 forwards a rank")
    # (e) the reverse chain in ddp 2 against one device's at the same seed
    from ucf_vit_tpu_torch.inference import generate_diffusion

    one_sps, want = generate_diffusion(load_config(chain_one), None, PARALLEL_CHAIN_SAMPLES,
                                       None, False, True)
    scale = float(np.abs(want).max())
    for r, out in enumerate(ranks["chain_ddp2"]):
        d = float(np.abs(out["images"] - want).max())
        log(f"[parallel] (e) imagenet/diffusion ddp 2, {PARALLEL_CHAIN_STEPS} of 1,000 steps, "
            f"{PARALLEL_CHAIN_SAMPLES} samples: rank {r} max |images - one device's| {d:.3e} "
            f"(tol {PARALLEL_CHAIN_TOL:g} x {scale:.3f}); the chain {out['samples_s']:.3f} "
            f"samples/s on two ranks sharing the card, one device {one_sps:.3f}")
        if out["images"].shape != want.shape or not np.isfinite(out["images"]).all() or \
                d > PARALLEL_CHAIN_TOL * scale:
            fail("(e) the sharded chain disagrees with one device's")
        inst = out["instances"]
        if inst.get("fwd:flash_fwd_tf32<64>") != 12 * PARALLEL_CHAIN_STEPS or \
                inst.get("fwd:flash_fwd_tf32<128>") != 8 * PARALLEL_CHAIN_STEPS:
            fail(f"(e) rank {r}: expected 12 <64> and 8 <128> forwards a step, got {inst}")
    # (f) the tp-2 server's answers against the in-process forward
    if "error" in served or len(served.get("answers", {})) != len(bodies):
        fail(f"(f) the sharded server: {served.get('error')}, "
             f"{len(served.get('answers', {}))} of {len(bodies)} answers")
    run_batch, _, mb, (_, _, reload) = build_predictor(load_config(vit_b_one), device="cuda")
    before = PARALLEL_SERVE_LONE + PARALLEL_SERVE_COALESCED
    worst = 0.0
    for i, body in enumerate(bodies):
        if i == before:
            reload(ck_tp2)
        want_i = run_batch({"x": np.repeat(body[None], mb, 0)}).cpu().numpy()[0]
        worst = max(worst, float(np.abs(served["answers"][i] - want_i).max()))
    stats = served["stats"]
    log(f"[parallel] (f) ViT-B/16 tp 2 served by rank 0, rank 1 following: {len(bodies)} "
        f"requests ({PARALLEL_SERVE_LONE} lone, {PARALLEL_SERVE_COALESCED} at once, "
        f"{PARALLEL_SERVE_AFTER} after /v1/reload {served['reload']}) in {stats['batches']} "
        f"batches (the warm-up's among them), max |answer - in-process forward| {worst:.3e} "
        f"(tol {SERVE_TOL:g}); {served['before_reload_s']:.2f} s before the reload, the reload "
        f"{served['reload_s']:.2f} s; the server on two ranks "
        f"{max(r['s'] for r in ranks['serve_tp2']):.1f} s from start to exit")
    if worst > SERVE_TOL or stats["errors"] or stats["batches"] >= stats["requests"] or \
            served["reload"].get("status") != "reloaded":
        fail("(f) the sharded server's answers disagree with the in-process forward")
    if any(r["counts"]["src:flash_fwd_tf32"] != 12 * stats["batches"]
           for r in ranks["serve_tp2"]):
        fail(f"(f) expected 12 f32 forwards a batch a rank over {stats['batches']} batches")
    del run_batch, reload
    # the kernels at the chain's per-rank shapes: the encoder's and the decoder's
    rows = PARALLEL_CHAIN_SAMPLES // 2
    numbers = {
        "flash_fwd_chain_enc_ddp2": _attention_case(
            "parallel", "imagenet/diffusion encoder, ddp 2, a rank's rows",
            (rows, 12, 256, 256, 64, True), gen, iters=PARALLEL_KERNEL_ITERS)["fwd"],
        "flash_fwd_chain_dec_ddp2": _attention_case(
            "parallel", "imagenet/diffusion decoder, ddp 2, a rank's rows",
            (rows,) + DIFF_SHAPES["imagenet"][1:], gen, iters=PARALLEL_KERNEL_ITERS)["fwd"]}
    return {"numbers": numbers, "launches": {
        "tp2": sum(r["counts"]["src:flash_fwd_tf32"] for n in ("eval_tp2", "serve_tp2")
                   for r in ranks[n]),
        "enc": sum(r["instances"]["fwd:flash_fwd_tf32<64>"] for r in ranks["chain_ddp2"]),
        "dec": sum(r["instances"]["fwd:flash_fwd_tf32<128>"] for r in ranks["chain_ddp2"])}}


# ---------------------------------------------------------------- sequence parallelism

# Sequence parallelism with two ranks on the card over gloo (`phase_sp`). mae_long's
# attention at its full width: the encoder's [2, 12, 8192, 64] and the decoder's
# [2, 6, 32768, 96] (global; a rank holds half the tokens), bf16
SP_SHAPES = {"encoder": (2, 12, 8192, 64), "decoder": (2, 6, 32768, 96)}
SP_MODES_RUN = ("ring", "ulysses", "gather")
SP_OP_TOL = 1e-2  # bf16: each rank's o, dq, dk, dv, times the reference's largest entry
SP_OP_ITERS = 1  # timed calls of each mode (forward and backward) a shape, and profiled
SP_DROP_SHAPE = (2, 12, 256, 64)  # (c): ViT-B's heads, 128 tokens a rank, f32
SP_DROP_RATE = 0.1
SP_STEPS = 2  # (d): mae_long at sp 2 through the CLI entry, and one device
SP_LOSS_TOL = 5e-3  # (d): each step's loss against one device's (bf16)
SP_RECON_TOL = 1e-2  # (e): reconstruct against one device's, times its largest entry
SP_RECON_INPUTS = ((29, 3), (31, 5), (37, 7))  # (e): each input's numpy seed and mask seed
SP_DEADLINE_S = 420  # every job of the two ranks together
# The ring's hop is one `all_to_all_single` that sends the chunk to the next rank: gloo
# on CUDA tensors does not carry `send`/`recv` or `batch_isend_irecv` (PERF.md, the
# probe of `python -m ucf_vit_tpu_torch.tools.gloo_probe`); (a) times the hop.
SP_CHUNK_ROWS = {  # the kernels' shapes inside each mode: (b, h, n_q, n_kv, dh)
    "ring": lambda b, h, n, dh: (b, h, n // 2, n // 2, dh),
    "ulysses": lambda b, h, n, dh: (b, h // 2, n, n, dh),
    "gather": lambda b, h, n, dh: (b, h, n // 2, n, dh),
}
# the (part, mode) pairs timed by `_sp_kernel_rows`: the ring's chunks on mae_long's path,
# and the decoder's (most of the attention's time) in the other two modes
SP_ROWS = (("encoder", "ring"), ("decoder", "ring"), ("decoder", "ulysses"),
           ("decoder", "gather"))
SP_ROW_ITERS = 3
# (f)-(h): basic_ct/unetr_sp, UNETR's spatial partition, at sp 2 on the two ranks
UNETR_SP_CONFIG = os.path.join(REPO, "configs", "basic_ct", "unetr_sp", "base_config.yaml")
SPU_BATCH = 2  # (g): the shipped global batch of 8 over its 4 data ranks
SPU_STEPS = 2  # (g): through the CLI entry, and one device
SPU_LOSS_TOL = 1e-4  # (g): each step's loss against one device's (f32, TF32 off)
# (f): split against whole, times the largest entry, in f64. In f32 (TF32 off) cuDNN's
# 3-D convolutions pick algorithms by shape: at decoder3's block the input gradient of a
# rank's slab and of the whole map sat 5.0e-2 apart, each 1.15e-1 from f64 (this phase's
# f32 lines on an H100 80GB HBM3 at 700.00 W), so f32 is logged beside f64, the gate
SPU_BLOCK_TOL = 1e-5
SPU_DICE_TOL = 1e-4  # (h): the mean Dice on the sp-2 eval mesh against one device's
SPU_EVAL_SAMPLES = 4  # (h): synthetic
SPU_SHAPE = (2, 12, 729, 729, 64, True)  # (g): the f32 kernels at a rank's [24, 729, 64]
SPU_KERNEL_ITERS = 20
SPU_SIDES = (72, 64)  # (f): decoder3's and decoder2's maps, the resize between them


def _sp_counts() -> dict:
    from ucf_vit_tpu_torch.ops.ring_attention import ring_attention

    return {**_launch_counts(), **_instance_counts(), "ring_hops": ring_attention.hops}


def _sp_reset() -> None:
    from ucf_vit_tpu_torch.ops.flash_attention import reset_launch_counts
    from ucf_vit_tpu_torch.ops.ring_attention import reset_launch_counts as reset_ring

    reset_launch_counts()
    reset_ring()


def _rel(got, want) -> float:
    return ((got.float() - want.float()).abs().max() / want.float().abs().max()).item()


def _sp_ops(rank: int, mesh) -> dict:
    """(b): each mode on this rank's half of mae_long's encoder and decoder
    attention, forward and backward, against the single-device kernel on the
    whole sequence and against the plain version on its first head; each
    mode's launches (one call) and its ms a call (host clock, the card
    synchronised) and device ms a call (the profiler, every kernel)."""
    import torch

    from ucf_vit_tpu_torch.ops.attention import multi_head_attention
    from ucf_vit_tpu_torch.ops.flash_attention import (flash_attention,
                                                       flash_attention_bwd_plain,
                                                       flash_attention_plain)
    from ucf_vit_tpu_torch.parallel.mesh import mesh_context, seq_shard_of, sequence_context

    out = {}
    for name, (b, h, n, dh) in SP_SHAPES.items():
        gen = torch.Generator(device="cuda").manual_seed(17)
        q, k, v, do = (torch.randn(b, h, n, dh, device="cuda", generator=gen).to(torch.bfloat16)
                       for _ in range(4))
        sm = dh**-0.5
        qr, kr, vr = (t.clone().requires_grad_() for t in (q, k, v))
        o_ref = flash_attention(qr, kr, vr, sm_scale=sm)
        ref = [o_ref.detach()] + list(torch.autograd.grad(o_ref, (qr, kr, vr), do))
        del o_ref, qr, kr, vr
        # the plain version on head (0, 0) over the whole sequence, in f32
        h0 = [t[:1, :1].float() for t in (q, k, v)]
        o_p, lse_p = flash_attention_plain(*h0, sm)
        plain = [o_p] + list(flash_attention_bwd_plain(*h0, o_p, lse_p, do[:1, :1].float(), sm))
        del o_p, lse_p, h0
        torch.cuda.empty_cache()
        half = slice(rank * n // 2, (rank + 1) * n // 2)
        for mode in SP_MODES_RUN:
            ql, kl, vl = (t[:, :, half].clone().requires_grad_() for t in (q, k, v))
            dol = do[:, :, half]

            def call():
                with mesh_context(mesh), sequence_context(seq_shard_of(mesh)):
                    o = multi_head_attention(ql, kl, vl, impl="FLASH", sm_scale=sm, sp_mode=mode)
                return [o.detach()] + list(torch.autograd.grad(o, (ql, kl, vl), dol))

            _sp_reset()
            got = call()
            torch.cuda.synchronize()
            counts = _sp_counts()
            err = max(_rel(g, r[:, :, half]) for g, r in zip(got, ref))
            err_abs = max((g.float() - r[:, :, half].float()).abs().max().item()
                          for g, r in zip(got, ref))
            err_plain = max(_rel(g[:1, :1], p[:, :, half]) for g, p in zip(got, plain))
            del got
            times = []
            for _ in range(SP_OP_ITERS):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                call()
                torch.cuda.synchronize()
                times.append(1e3 * (time.perf_counter() - t0))
            prof = torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA])
            with prof:
                for _ in range(SP_OP_ITERS):
                    call()
                torch.cuda.synchronize()
            dev = sum(e.self_device_time_total for e in prof.key_averages()) / 1e3 / SP_OP_ITERS
            out[name, mode] = {"err": err, "err_abs": err_abs, "err_plain": err_plain,
                               "counts": counts, "ms": _median(times), "device_ms": dev}
            del ql, kl, vl
            torch.cuda.empty_cache()
        del q, k, v, do, ref, plain
        torch.cuda.empty_cache()
    return out


def _sp_dropout(rank: int, mesh) -> dict:
    """(c): ring and gather in f32 with dropout at ViT-B's heads, each rank on
    its 128 tokens, against the single-device kernel on the whole 256 with
    the seed the mesh folds (one global draw): o's max |diff| and the
    gradients' relative max |diff|."""
    import torch

    from ucf_vit_tpu_torch.ops.attention import multi_head_attention, sharded_seed
    from ucf_vit_tpu_torch.ops.flash_attention import flash_attention
    from ucf_vit_tpu_torch.parallel.mesh import mesh_context, seq_shard_of, sequence_context

    b, h, n, dh = SP_DROP_SHAPE
    gen = torch.Generator(device="cuda").manual_seed(19)
    q, k, v, do = (torch.randn(b, h, n, dh, device="cuda", generator=gen) for _ in range(4))
    seed = 12345
    with mesh_context(mesh):
        folded = sharded_seed(seed)
    qr, kr, vr = (t.clone().requires_grad_() for t in (q, k, v))
    o = flash_attention(qr, kr, vr, dropout_rate=SP_DROP_RATE, dropout_seed=folded)
    ref = [o.detach()] + list(torch.autograd.grad(o, (qr, kr, vr), do))
    half = slice(rank * n // 2, (rank + 1) * n // 2)
    out = {}
    for mode in ("ring", "gather"):
        ql, kl, vl = (t[:, :, half].clone().requires_grad_() for t in (q, k, v))
        _sp_reset()
        with mesh_context(mesh), sequence_context(seq_shard_of(mesh)):
            o = multi_head_attention(ql, kl, vl, impl="FLASH", dropout_rate=SP_DROP_RATE,
                                     dropout_seed=seed, sp_mode=mode)
        got = [o.detach()] + list(torch.autograd.grad(o, (ql, kl, vl), do[:, :, half]))
        out[mode] = {"o": (got[0] - ref[0][:, :, half]).abs().max().item(),
                     "grads": max(_rel(g, r[:, :, half]) for g, r in zip(got[1:], ref[1:])),
                     "keep_mask": _sp_counts()["keep_mask"]}
    return out


def _counting_collectives(tally: dict, kind=None) -> dict:
    """Wrap torch.distributed's collectives so that each call adds the bytes of
    the tensor it hands gloo to `tally["bytes"]`, and with `kind(name, tensor)`
    to `tally[kind(...)]` too; returns the originals."""
    import torch.distributed as dist

    made = {}
    for name, arg in (("all_reduce", 0), ("all_gather", 1), ("all_gather_into_tensor", 1),
                      ("reduce_scatter_tensor", 1), ("all_to_all_single", 1), ("broadcast", 0)):
        fn = made[name] = getattr(dist, name)

        def counted(*args, fn=fn, arg=arg, name=name, **kwargs):
            t = args[arg]
            n = t.numel() * t.element_size()
            tally["bytes"] += n
            if kind is not None:
                key = kind(name, t)
                tally[key] = tally.get(key, 0) + n
            return fn(*args, **kwargs)
        setattr(dist, name, counted)
    return made


def _spu_kind(name: str, t) -> str:
    """What a collective of UNETR's spatial partition carries: the halos
    (all_to_all_single), the instance norms' statistics (an all-reduce of a
    map whose spatial dims are 1), the gradient sum over sp (the flat
    buckets), and the gather of a split map (the logits) with its backward
    (the all-reduce of that map's gradient)."""
    if name == "all_to_all_single":
        return "halo"
    if name == "all_reduce" and t.ndim == 1:
        return "grad_sum"
    if name == "all_reduce" and t.ndim >= 4 and all(d == 1 for d in t.shape[2:]):
        return "norm"
    return "gather" if name in ("all_gather", "all_reduce") else name


def _spu_blocks(rank: int, mesh) -> dict:
    """(f): unetr_sp's decoder blocks at full width and batch 2 on the two ranks
    as sp, dim 2 split (a rank's 36 or 32 rows): decoder3's UnetResBlock (64 ->
    32 channels on the 72^3 map), decoder2's (32 -> 16 on 64^3), the 72^3 ->
    64^3 resize and an instance norm on the 72^3 x 32 map, forward and the
    backward of `sum(y * w) / 2` (the train step's `loss / sp`), the output
    gathered whole and the gradients summed over the ranks, in f64 and in f32
    (TF32 off). Rank 0 then runs each whole and returns the largest
    differences, the output's and the input gradient's times their largest
    entry, the parameters' times the largest entry of the module's parameter
    gradients (the biases ahead of a norm have none in exact arithmetic): the
    split f64 run against the whole f64 run (the gate), and the split and the
    whole f32 runs against that f64 run (cuDNN's f32 algorithms differ with
    the map's shape). Also the f32 call's ms and the bytes gloo moves a call
    by kind (`_spu_kind`)."""
    import torch
    import torch.distributed as dist

    from ucf_vit_tpu_torch.inference import resolve_device
    from ucf_vit_tpu_torch.models import unet_blocks as ub
    from ucf_vit_tpu_torch.parallel.mesh import (seq_shard_of, spatial, spatial_context,
                                                 spatial_gather)

    resolve_device("cuda")  # TF32 off for cuBLAS and cuDNN (F4)
    shard = seq_shard_of(mesh)
    a, b = SPU_SIDES
    cases = {f"res_block {a}^3 64->32": (lambda: ub.UnetResBlock(64, 32, ndim=3),
                                         (2, 64, a, a, a), None),
             f"res_block {b}^3 32->16": (lambda: ub.UnetResBlock(32, 16, ndim=3),
                                         (2, 32, b, b, b), None),
             f"resize {a}^3->{b}^3 x32": (None, (2, 32, a, a, a), (b, b, b)),
             f"instance_norm {a}^3 x32": (ub.InstanceNorm, (2, 32, a, a, a), None)}
    out = {}
    for name, (make, shape, target) in cases.items():
        x = torch.randn(shape, device="cuda", generator=torch.Generator("cuda").manual_seed(7))
        torch.manual_seed(3)
        mod = make().cuda() if make is not None else None
        side = shape[2] if target is None else target[0]

        def run(shard, dtype, tally):
            m = None if mod is None else mod.to(dtype)
            params = [] if m is None else list(m.parameters())
            for p in params:
                p.grad = None
            leaf = x.to(dtype, copy=True).requires_grad_(True)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            made = _counting_collectives(tally, _spu_kind)
            try:
                xs, split = spatial(leaf, False, shard)
                with spatial_context(shard):
                    y = (ub.resize_linear_align_corners(xs, target, split=split) if m is None
                         else m(xs, split=split))
                y = spatial_gather(y, shard is not None and side % shard.size == 0, shard)
                w = torch.randn(y.shape, device="cuda",
                                generator=torch.Generator("cuda").manual_seed(11)).to(dtype)
                ((y * w).sum() / (1 if shard is None else shard.size)).backward()
                torch.cuda.synchronize()
            finally:
                for n, fn in made.items():
                    setattr(dist, n, fn)
            ms = 1e3 * (time.perf_counter() - t0)
            grads = [leaf.grad] + [p.grad for p in params]
            if shard is not None:
                for g in grads:
                    dist.all_reduce(g, group=shard.group)
            return [y.detach().double()] + [g.double() for g in grads], ms

        def diffs(got, want):
            pmax = max([g.abs().max().item() for g in want[2:]], default=0.0)
            rel = [((g - w).abs().max() / w.abs().max()).item() for g, w in zip(got[:2], want)]
            return rel + [max([(g - w).abs().max().item() / pmax
                               for g, w in zip(got[2:], want[2:])], default=0.0)]

        tally = {"bytes": 0}
        split32, ms = run(shard, torch.float32, tally)
        split64, _ = run(shard, torch.float64, {"bytes": 0})
        res = {"ms": ms, "bytes": {k: v for k, v in tally.items() if k != "bytes"}}
        if rank == 0:
            whole64, _ = run(None, torch.float64, {"bytes": 0})
            whole32, ms1 = run(None, torch.float32, {"bytes": 0})
            res.update(whole_ms=ms1, f64=diffs(split64, whole64), split32=diffs(split32, whole64),
                       whole32=diffs(whole32, whole64))
            del whole64, whole32
        out[name] = res
        del x, mod, split32, split64
        torch.cuda.empty_cache()
    return out


def _sp_rank(rank: int, store: str, jobs: list, results) -> None:
    """One of two ranks on the card in a gloo group through a FileStore: the
    jobs of `phase_sp` in turn, each result put on `results`."""
    import torch
    import torch.distributed as dist

    sys.path.insert(0, REPO)
    torch.cuda.set_device(0)
    dist.init_process_group("gloo", store=dist.FileStore(store, 2), rank=rank, world_size=2)
    from ucf_vit_tpu_torch.parallel.mesh import make_mesh
    from ucf_vit_tpu_torch.tools.gloo_probe import _p2p

    try:
        mesh = make_mesh(seq_par_size=2, device_type="cuda")
        for job in jobs:
            t0 = time.perf_counter()
            if job["kind"] == "hop":
                out = {"a2a_hop": _p2p("a2a_hop", rank, 2)}
            elif job["kind"] == "ops":
                out = _sp_ops(rank, mesh)
            elif job["kind"] == "dropout":
                out = _sp_dropout(rank, mesh)
            elif job["kind"] == "spatial_blocks":
                out = _spu_blocks(rank, mesh)
            elif job["kind"] == "unetr_train":
                from ucf_vit_tpu_torch.train import main as train_main

                times, tally = [], {"bytes": 0, "steps": [], "kind_steps": []}
                made = _counting_collectives(tally, _spu_kind)
                _sp_reset()
                torch.cuda.reset_peak_memory_stats()
                try:
                    with _timed_steps(times, tally):
                        res = train_main(job["argv"])
                finally:
                    for n, fn in made.items():
                        setattr(dist, n, fn)
                model = res["state"].model
                _check_unetr(model)
                out = {"ms": times, "counts": _sp_counts(), "instances": _instance_counts(),
                       "steps": res["state"].step, "losses": res["loss_list"],
                       "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
                       "gloo_bytes": tally["steps"], "by_kind": tally["kind_steps"],
                       "sp": model.mesh.size("sp")}
                del res, model
            elif job["kind"] == "unetr_dice":
                from ucf_vit_tpu_torch.inference import main as inference_main

                _sp_reset()
                buf = io.StringIO()
                with contextlib.redirect_stdout(buf):
                    mean = inference_main([job["config"], "--checkpoint", job["ckpt"],
                                           "--synthetic", "--num-samples",
                                           str(SPU_EVAL_SAMPLES), "--device", "cuda"])
                out = {"dice": mean, "instances": _instance_counts(), "per": [
                    float(d) for d in re.findall(r"sample \d+: dice ([0-9.]+)", buf.getvalue())]}
            elif job["kind"] == "train":
                from ucf_vit_tpu_torch.train import main as train_main

                times, tally = [], {"bytes": 0, "steps": []}
                made = _counting_collectives(tally)
                _sp_reset()
                torch.cuda.reset_peak_memory_stats()
                try:
                    with _timed_steps(times, tally):
                        res = train_main(job["argv"])
                finally:
                    for n, fn in made.items():
                        setattr(dist, n, fn)
                model = res["state"].model
                out = {"ms": times, "counts": _sp_counts(), "steps": res["state"].step,
                       "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
                       "gloo_bytes": tally["steps"], "depth": len(model.blocks),
                       "decoder_depth": len(model.decoder_blocks), "embed": model.embed_dim,
                       "remat": model.remat, "dtype": str(model.dtype),
                       "sp_mode": model.blocks[0].attn.sp_mode}
                del res, model
            else:  # reconstruct on the eval mesh from (d)'s checkpoint
                from ucf_vit_tpu_torch.config import load_config
                from ucf_vit_tpu_torch.inference import init_eval_model, load_weights, reconstruct
                from ucf_vit_tpu_torch.parallel.mesh import eval_mesh

                cfg = load_config(job["config"])
                emesh = eval_mesh(cfg)
                model = init_eval_model(cfg, seed=0, mesh=emesh)
                load_weights(model, cfg, job["ckpt"])
                _sp_reset()
                out = {"recon": [reconstruct(model, torch.from_numpy(x).cuda(), seed=seed)
                                 .cpu().numpy() for x, seed in job["xs"]],
                       "counts": _sp_counts(), "mesh_sp": emesh.size("sp")}
                del model
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            results.put((rank, job["name"], {**out, "s": time.perf_counter() - t0}))
    except BaseException:
        import traceback

        results.put((rank, "error", traceback.format_exc()))
        raise
    finally:
        dist.destroy_process_group()


def _sp_kernel_rows() -> dict:
    """The kernels at the shapes the modes give them (SP_ROWS, SP_CHUNK_ROWS),
    one process: the forward and the backward on the route `bwd_route`
    takes, their device ms a call, their bound, and SDPA's forward and
    backward at the same shape; both backward routes timed in turns at the
    decoder's (`_route_ms`). At the ring's chunks, which mae_long's path
    runs, also the record's rows: the forward as the ring calls it (o in f32,
    `f32_o`) and the fused backward, each held a head at a time against its
    plain version (o to SP_OP_TOL, dq, dk, dv to LONG_BWD_TOL of the plain
    version's largest entry) and timed alone beside it (a head at a time)
    and SDPA. Returns {"log": {(part, mode): numbers}, "record": {row name:
    record numbers}}."""
    import torch
    import torch.nn.functional as F

    from ucf_vit_tpu_torch.ops.flash_attention import (
        _bwd_launch,
        _dq_workspace,
        _dropout_args,
        bwd_route,
        flash_attention,
        flash_attention_bwd,
        flash_attention_bwd_plain,
        flash_attention_plain,
    )

    rows, record = {}, {}
    gen = torch.Generator(device="cuda").manual_seed(23)
    for part, mode in SP_ROWS:
        b, h, nq, nk, dh = SP_CHUNK_ROWS[mode](*SP_SHAPES[part])
        q = torch.randn(b, h, nq, dh, device="cuda", generator=gen).to(torch.bfloat16)
        k, v = (torch.randn(b, h, nk, dh, device="cuda", generator=gen).to(torch.bfloat16)
                for _ in "kv")
        sm = dh**-0.5
        o, lse = flash_attention(q, k, v, sm_scale=sm, return_lse=True)
        do = torch.randn_like(o)
        route = bwd_route(torch.bfloat16, nq, nk, dh)
        it = dict(iters=SP_ROW_ITERS, warmup=1)
        f32_o = mode == "ring"
        fwd_ms, _ = device_ms(lambda: flash_attention(q, k, v, sm_scale=sm, f32_o=f32_o),
                              "flash_fwd_sm90", **it)
        bwd_ms, _ = device_ms(lambda: flash_attention_bwd(q, k, v, o, lse, do, sm), **it)
        lib_fwd, _ = device_ms(lambda: F.scaled_dot_product_attention(q, k, v, scale=sm), **it)
        qg, kg, vg = (t.detach().requires_grad_() for t in (q, k, v))
        sdpa = F.scaled_dot_product_attention(qg, kg, vg, scale=sm)
        lib_bwd, _ = device_ms(lambda: torch.autograd.grad(sdpa, (qg, kg, vg), do,
                                                           retain_graph=True), **it)
        del sdpa, qg, kg, vg
        fwd_bound = _bound(4.0 * b * h * nq * nk * dh,
                           2 * b * h * dh * (2 * nq + 2 * nk) + 4 * b * h * nq, "bfloat16")
        works = [_bwd_work(kind, b, h, nq, nk, dh, 2)
                 for kind in (("fused",) if route == "fused" else ("dkv", "dq"))]
        bwd_bound = _bound(sum(w[0] for w in works), sum(w[1] for w in works), "bfloat16")
        shape_s = f"[{b},{h},{nq}x{nk},{dh}]"
        rows[part, mode] = {"shape": shape_s, "route": route, "fwd_ms": fwd_ms,
                            "bwd_ms": bwd_ms, "sdpa_fwd_ms": lib_fwd, "sdpa_bwd_ms": lib_bwd,
                            "fwd_bound": fwd_bound, "bwd_bound": bwd_bound}
        log(f"[sp] kernels at mae_long's {part}, {mode}'s chunk {shape_s} bf16: forward "
            f"{fwd_ms:.4f} ms{' (o in f32)' if f32_o else ''} (bound {fwd_bound[0]:.4f}, "
            f"{fwd_bound[1]}; SDPA {lib_fwd:.4f}), backward on route {route} {bwd_ms:.4f} ms "
            f"(bound {bwd_bound[0]:.4f}, {bwd_bound[1]}; SDPA backward {lib_bwd:.4f})")
        if part == "decoder":
            _route_ms(f"{shape_s} bf16 (mae_long decoder, {mode} at sp 2)", torch.bfloat16,
                      q, k, v, o, lse, do, iters=2)
        if mode == "ring":
            if route != "fused":
                fail(f"the ring's chunk {shape_s} left the fused route: {route}")
            heads = [slice(i, i + 1) for i in range(h)]
            # the forward as the ring calls it, o in f32, against the plain version
            o32 = flash_attention(q, k, v, sm_scale=sm, f32_o=True)
            err = ref_max = 0.0
            for ref, hs in zip(_by_head(lambda *t: flash_attention_plain(
                    *(x.float() for x in t), sm)[0], q, k, v), heads):
                err = max(err, (o32[:, hs] - ref).abs().max().item())
                ref_max = max(ref_max, ref.abs().max().item())
            del o32
            # the fused backward against the plain backward
            dq32, dk, dv = flash_attention_bwd(q, k, v, o, lse, do, sm, route="fused",
                                               f32_dq=True)
            errs, bmax = [0.0] * 3, [0.0] * 3
            for ref, hs in zip(_by_head(lambda *t: flash_attention_bwd_plain(
                    *(x.float() for x in t[:4]), t[4], t[5].float(), sm), q, k, v, o, lse, do),
                    heads):
                for i, (g, want) in enumerate(zip((dq32, dk, dv), ref)):
                    bmax[i] = max(bmax[i], want.abs().max().item())
                    errs[i] = max(errs[i], (g[:, hs].float() - want).abs().max().item())
            del dq32, dk, dv
            rel = [e / m for e, m in zip(errs, bmax)]
            # each kernel alone, from buffers made beforehand, and its plain version
            di = (o.float() * do.float()).sum(-1).reshape(b * h, nq)
            ws = _dq_workspace(b, nq, h, dh, q.device)
            dk, dv = (torch.empty(b, nk, h, dh, device="cuda", dtype=q.dtype).transpose(1, 2)
                      for _ in "kv")
            drop = _dropout_args(0.0, 0, 0, 0)
            fused_ms, _ = device_ms(lambda: _bwd_launch("fused", q, k, v, do, lse, di, ws, dk,
                                                        dv, sm, drop),
                                    _bwd_kernel("bfloat16", "fused"), **it)
            plain_fwd, _ = device_ms(lambda: _by_head(
                lambda *t: flash_attention_plain(*t, sm, f32_o=True), q, k, v), iters=1,
                warmup=1)
            plain_bwd, _ = device_ms(lambda: _by_head(
                lambda *t: flash_attention_bwd_plain(*t, sm), q, k, v, o, lse, do), iters=1,
                warmup=1)
            fused_bound = _bound(*_bwd_work("fused", b, h, nq, nk, dh, 2), "bfloat16")
            del di, ws, dk, dv
            log(f"[sp] ring's chunk {shape_s} bf16 against the plain versions, a head at a "
                f"time: forward (o in f32) max|o-plain|/max|plain| {err / ref_max:.3e} (tol "
                f"{SP_OP_TOL:g}; max|o-plain| {err:.3e}), device {fwd_ms:.4f} ms, plain "
                f"{plain_fwd:.4f}; fused backward max|d-plain|/max|plain| dq {rel[0]:.3e} dk "
                f"{rel[1]:.3e} dv {rel[2]:.3e} (tol {LONG_BWD_TOL:g}), the kernel alone "
                f"{fused_ms:.4f} ms (bound {fused_bound[0]:.4f}, {fused_bound[1]}), plain "
                f"{plain_bwd:.4f}, SDPA backward {lib_bwd:.4f}")
            if err > SP_OP_TOL * ref_max or max(rel) > LONG_BWD_TOL or min(bmax) <= 0:
                fail(f"the ring's chunk kernels disagree with their plain versions at {shape_s}")
            tag = {"encoder": "enc", "decoder": "dec"}[part]
            record[f"flash_fwd_bf16_ring_{tag}"] = {
                "ms": fwd_ms, "plain_ms": plain_fwd, "library_ms": lib_fwd,
                "bound_ms": fwd_bound[0], "bound_by": fwd_bound[1], "max_abs_err": err}
            record[f"flash_bwd_fused_bf16_ring_{tag}"] = {
                "ms": fused_ms, "plain_ms": plain_bwd, "library_ms": lib_bwd,
                "bound_ms": fused_bound[0], "bound_by": fused_bound[1], "max_abs_err": max(errs)}
        del q, k, v, o, lse, do
        torch.cuda.empty_cache()
    return {"log": rows, "record": record}


def phase_sp() -> dict:
    """Sequence parallelism with two ranks on the one card over gloo (NCCL
    refuses two ranks on one device). Two spawned ranks in one gloo group run,
    in turn: (a) the ring's hop (`all_to_all_single` to the next rank) at the
    ring's chunk sizes, checked and timed; (b) `ring`, `ulysses` and `gather`
    as ops at mae_long's full-width per-rank shapes in bf16 (SP_SHAPES),
    forward and backward, each rank's o, dq, dk and dv within SP_OP_TOL of the
    single-device kernel on the whole sequence and of the plain version on
    the first head, each mode's launches, ms and device ms a call; (c) `ring`
    and `gather` in f32 with dropout at ViT-B's heads against the
    single-device kernel on the whole sequence with the same seed, to
    FLASH_TOL and BWD_TOL; (d) basic_ct/mae_long through the CLI entry at
    `seq_par_size: 2`, `sp_mode: ring`, `fsdp_size: 1` (cut from the shipped
    fsdp 2 x sp 4: 8 ranks), full width and depth, bf16, remat, batch 2,
    synthetic, SP_STEPS steps: every launch as a ring of two chunks a block
    (two sm90 forwards a block a run, remat's recompute among them, two fused
    backwards a block), the losses within SP_LOSS_TOL of one device at the
    same batch, each rank's ms a step, peak memory beside one device's, the
    bytes gloo moves a step; (e) `inference.reconstruct` on the sp-2 eval
    mesh from (d)'s checkpoint against one device within SP_RECON_TOL, on
    each of SP_RECON_INPUTS; (f) unetr_sp's decoder blocks at full width with
    dim 2 split over the two ranks against the same blocks whole, and the
    halo bytes a call; (g) basic_ct/unetr_sp through the CLI entry at (ddp 1,
    sp 2), cut from the shipped (ddp 4, sp 2), full width and depth, f32,
    remat, batch 2, synthetic, SPU_STEPS steps, against one device, with each
    rank's launches of the f32 forward and fused backward; (h) the inference
    CLI's Dice on the sp-2 eval mesh from (g)'s checkpoint against one device
    (`_spu_checks`, which also holds those two kernels at a rank's shape).
    Then the kernels at the modes' chunk shapes (`_sp_kernel_rows`). Returns
    {"numbers": the record's rows at the ring's chunks and unetr_sp's,
    "launches": (d)'s and (e)'s launches of the ring's rows, (g)'s and (h)'s
    of unetr_sp's}."""
    import queue

    import numpy as np
    import torch

    from ucf_vit_tpu_torch.ops.flash_attention import bwd_route

    root = os.path.join(WORK, "sp")
    os.makedirs(root, exist_ok=True)
    ck_dir = os.path.join(root, "ck")
    sp2 = _parallel_config("mae_sp2", MAE_CONFIG, {"seq_par_size": 2, "sp_mode": "ring"},
                           checkpoint_path=ck_dir, checkpoint_filename="sp2")
    one_path = _parallel_config("mae_one", MAE_CONFIG, {})
    ck = os.path.join(ck_dir, "sp2_even.ckpt")
    import yaml

    tile = yaml.safe_load(open(MAE_CONFIG))["model"]["net"]["init_args"]["tile_size"]
    # (e)'s inputs, each with its mask seed
    xs = [(np.random.default_rng(s).normal(size=(1, 1, *tile)).astype(np.float32), seed)
          for s, seed in SP_RECON_INPUTS]
    jobs = [{"kind": "hop", "name": "hop"}, {"kind": "ops", "name": "ops"},
            {"kind": "dropout", "name": "dropout"},
            {"kind": "train", "name": "train",
             "argv": [sp2, "--synthetic", "--max-steps", str(SP_STEPS)]},
            {"kind": "reconstruct", "name": "reconstruct", "config": sp2, "ckpt": ck,
             "xs": xs}]
    # (f)-(h): basic_ct/unetr_sp cut from (ddp 4, sp 2) = 8 ranks to (ddp 1, sp 2), batch 2
    usp2 = _parallel_config("unetr_sp2", UNETR_SP_CONFIG, {"seq_par_size": 2}, batch=SPU_BATCH,
                            checkpoint_path=ck_dir, checkpoint_filename="usp2")
    uone = _parallel_config("unetr_one", UNETR_SP_CONFIG, {}, batch=SPU_BATCH)
    uck = os.path.join(ck_dir, "usp2_even.ckpt")
    jobs += [{"kind": "spatial_blocks", "name": "spatial_blocks"},
             {"kind": "unetr_train", "name": "unetr_train",
              "argv": [usp2, "--synthetic", "--max-steps", str(SPU_STEPS)]},
             {"kind": "unetr_dice", "name": "unetr_dice", "config": usp2, "ckpt": uck}]
    log("[sp] two ranks on one card over gloo: NCCL refuses two ranks on one device")
    torch.cuda.empty_cache()
    ctx = multiprocessing.get_context("spawn")
    results = ctx.Queue()
    store = os.path.join(root, "store")
    procs = [ctx.Process(target=_sp_rank, args=(r, store, jobs, results), daemon=True)
             for r in range(2)]
    t0 = time.perf_counter()
    for p in procs:
        p.start()
    got: dict = {}
    try:
        while len(got) < 2 * len(jobs):
            if time.perf_counter() - t0 > SP_DEADLINE_S:
                fail(f"the two ranks did not finish within {SP_DEADLINE_S} s: {sorted(got)}")
            try:
                rank, name, out = results.get(timeout=0.2)
            except queue.Empty:
                if any(p.exitcode not in (None, 0) for p in procs):
                    fail(f"a rank died: exit codes {[p.exitcode for p in procs]}")
                continue
            if name == "error":
                fail(f"rank {rank} failed:\n{out[-3000:]}")
            got[rank, name] = out
            log(f"[sp] rank {rank}: {name} done in {out['s']:.1f} s")
        for p in procs:
            p.join(timeout=60)
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
    if [p.exitcode for p in procs] != [0, 0]:
        fail(f"the ranks exited {[p.exitcode for p in procs]}")
    log(f"[sp] two ranks: {time.perf_counter() - t0:.1f} s for every job")
    # (a) the hop
    for r in range(2):
        hop = got[r, "hop"]["a2a_hop"]
        log(f"[sp] (a) rank {r}: the ring's hop (all_to_all_single to rank + 1) on CUDA tensors "
            f"over gloo: {hop}")
        if not hop.startswith("ok"):
            fail("(a) gloo does not carry the ring's hop")
    # (b) the three modes as ops
    for part in SP_SHAPES:
        for mode, r in ((m, r) for m in SP_MODES_RUN for r in range(2)):
            res = got[r, "ops"][part, mode]
            c = res["counts"]
            log(f"[sp] (b) {part} {SP_SHAPES[part]} {mode} rank {r}: max rel |diff| against one "
                f"device {res['err']:.3e} (abs {res['err_abs']:.3e}), against the plain head "
                f"{res['err_plain']:.3e} (tol {SP_OP_TOL:g}); {res['ms']:.1f} ms a call, device "
                f"{res['device_ms']:.3f} ms; launches fwd {c['flash_fwd']} (tma "
                f"{c['route:tma']}), bwd fused {c['flash_bwd_fused']} dkv {c['flash_bwd_dkv']} "
                f"dq {c['flash_bwd_dq']}, sm90 {c['src:flash_fwd_sm90']}+{c['src:flash_bwd_sm90']}"
                f", instances {', '.join(f'{k} {n}' for k, n in c.items() if ':flash' in k and '<' in k and n)}, "
                f"ring hops {c['ring_hops']}")
            # a ring call runs the kernels on two chunks, the other modes on one, and each
            # backward on the route bwd_route gives the chunk's shape
            n_fwd = 2 if mode == "ring" else 1
            _, _, nq, nk, dh = SP_CHUNK_ROWS[mode](*SP_SHAPES[part])
            fused = bwd_route(torch.bfloat16, nq, nk, dh) == "fused"
            want_bwd = {"flash_bwd_fused": n_fwd if fused else 0,
                        "flash_bwd_dkv": 0 if fused else n_fwd,
                        "flash_bwd_dq": 0 if fused else n_fwd,
                        "src:flash_bwd_sm90": n_fwd if fused else 2 * n_fwd}
            if res["err"] > SP_OP_TOL or res["err_plain"] > SP_OP_TOL or \
                    c["flash_fwd"] != n_fwd or c["src:flash_fwd_sm90"] != n_fwd or \
                    {key: c[key] for key in want_bwd} != want_bwd or \
                    c["ring_hops"] != (3 if mode == "ring" else 0):
                fail(f"(b) {part} {mode} rank {r} disagrees or launched the wrong kernels "
                     f"(backward: {want_bwd} expected)")
    # (c) dropout at global coordinates
    for r in range(2):
        for mode in ("ring", "gather"):
            res = got[r, "dropout"][mode]
            log(f"[sp] (c) {mode} f32 dropout {SP_DROP_RATE} at {SP_DROP_SHAPE} (rank {r}'s half) "
                f"against one device: max |o diff| {res['o']:.3e} (tol "
                f"{FLASH_TOL['float32']:g}), gradients' rel {res['grads']:.3e} (tol "
                f"{BWD_TOL['float32']:g}); keep_mask launches {res['keep_mask']}")
            if res["o"] > FLASH_TOL["float32"] or res["grads"] > BWD_TOL["float32"] or \
                    res["keep_mask"] <= 0:
                fail(f"(c) {mode} with dropout disagrees with one device's")
    # (d) mae_long at sp 2 against one device at the same batch
    t1 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    one = _single_run("mae_one", one_path, SP_STEPS)
    one_peak = torch.cuda.max_memory_allocated() / 1e9
    losses = _step_losses(os.path.join(WORK, "parallel", "mae_sp2.jsonl"))
    diff = max(abs(a - b) for a, b in zip(losses, one["losses"]))
    log(f"[sp] (d) basic_ct/mae_long sp 2 ring (cut from fsdp 2 x sp 4): losses "
        f"{' '.join(f'{v:.6f}' for v in losses)}; one device "
        f"{' '.join(f'{v:.6f}' for v in one['losses'])}; max |diff| {diff:.3e} (tol "
        f"{SP_LOSS_TOL:g})")
    if len(losses) != SP_STEPS or not np.all(np.isfinite(losses)) or diff > SP_LOSS_TOL:
        fail("(d) mae_long at sp 2 disagrees with one device")
    # a step: the encoder's 12 blocks (<64>) and the decoder's 8 (<96>, the <128> instance)
    # each a ring of two chunks, their forwards twice (remat's recompute)
    per_step = {"flash_fwd": 80, "src:flash_fwd_sm90": 80, "route:tma": 80,
                "flash_bwd_fused": 40, "flash_bwd_dkv": 0, "flash_bwd_dq": 0,
                "src:flash_bwd_sm90": 40, "ring_hops": 80, "fwd:flash_fwd_sm90<64>": 48,
                "fwd:flash_fwd_sm90<128>": 32, "bwd:flash_bwd_sm90<64>": 24,
                "bwd:flash_bwd_sm90<128>": 16}
    for r in range(2):
        res = got[r, "train"]
        c = res["counts"]
        log(f"[sp] (d) rank {r}: {_median(res['ms'][1:]):.3f} ms a step (median of steps "
            f"2-{SP_STEPS}; one device {_median(one['ms'][1:]):.3f}; two ranks share one card), "
            f"peak {res['peak_gb']:.2f} GB (one device {one_peak:.2f}), gloo moves "
            f"{_median(res['gloo_bytes']) / 1e9:.3f} GB a step from this rank; a step: "
            + ", ".join(f"{k} {c[k] / SP_STEPS:g}" for k in per_step))
        want = {k: n * SP_STEPS for k, n in per_step.items()}
        if {k: c[k] for k in want} != want or res["depth"] != 12 or \
                res["decoder_depth"] != 8 or res["embed"] != 768 or not res["remat"] or \
                res["dtype"] != "torch.bfloat16" or res["sp_mode"] != "ring":
            fail(f"(d) rank {r}: launches {c} (expected {want} over {SP_STEPS} steps), "
                 f"depth {res['depth']}+{res['decoder_depth']}, embed {res['embed']}")
    log(f"[sp] (d) one device's run {time.perf_counter() - t1:.1f} s")
    # (e) reconstruct on the sp-2 eval mesh against one device; both beside the same
    # checkpoint's model in f32 (what bf16 costs either way)
    from ucf_vit_tpu_torch.config import load_config
    from ucf_vit_tpu_torch.inference import init_eval_model, load_weights, reconstruct

    t1 = time.perf_counter()
    outs = {}
    for dtype in ("bfloat16", "float32"):
        cfg = load_config(one_path)
        cfg.raw["trainer"]["data_type"] = dtype
        model = init_eval_model(cfg, seed=0)
        load_weights(model, cfg, ck)
        outs[dtype] = [reconstruct(model, torch.from_numpy(x).cuda(), seed=seed).cpu().numpy()
                       for x, seed in xs]
        del model
    wants, f32s = outs["bfloat16"], outs["float32"]
    log(f"[sp] (e) one device's reconstructs, bf16 and f32: {time.perf_counter() - t1:.1f} s")
    n_fwd = 40 * len(xs)  # a ring of two chunks in each of the 20 blocks, an input
    for r in range(2):
        res = got[r, "reconstruct"]
        for (_, seed), got_r, want_r, f32_r in zip(xs, res["recon"], wants, f32s):
            scale = float(np.abs(want_r).max())
            d = float(np.abs(got_r - want_r).max())
            log(f"[sp] (e) reconstruct on the sp-2 eval mesh (rank {r}, mesh sp "
                f"{res['mesh_sp']}, mask seed {seed}): max |diff| against one device {d:.3e} "
                f"(tol {SP_RECON_TOL:g} x {scale:.3f} = {SP_RECON_TOL * scale:.4f}, "
                f"{d / (SP_RECON_TOL * scale):.0%} of it); against the model in f32: sp 2 "
                f"{float(np.abs(got_r - f32_r).max()):.3e}, one device "
                f"{float(np.abs(want_r - f32_r).max()):.3e}")
            if got_r.shape != want_r.shape or not np.isfinite(got_r).all() or \
                    d > SP_RECON_TOL * scale:
                fail("(e) reconstruct on the sp mesh disagrees with one device's")
        log(f"[sp] (e) rank {r}: {res['s']:.1f} s for {len(xs)} inputs; sm90 forwards "
            f"{res['counts']['src:flash_fwd_sm90']}, ring hops {res['counts']['ring_hops']}")
        if res["counts"]["src:flash_fwd_sm90"] != n_fwd or res["mesh_sp"] != 2:
            fail(f"(e) rank {r}: expected {n_fwd} sm90 forwards on a mesh of sp 2")
    unetr = _spu_checks(got, uone, uck)
    t1 = time.perf_counter()
    rows = _sp_kernel_rows()
    torch.cuda.empty_cache()
    log(f"[sp] the kernels at the chunk shapes: {time.perf_counter() - t1:.1f} s")
    # the ring's chunks on mae_long's path: (d)'s and (e)'s launches by head-dim instance
    runs = [got[r, n]["counts"] for r in range(2) for n in ("train", "reconstruct")]
    return {"numbers": {**rows["record"], **unetr["numbers"]}, "launches": {
        "flash_fwd_bf16_ring_enc": sum(c["fwd:flash_fwd_sm90<64>"] for c in runs),
        "flash_fwd_bf16_ring_dec": sum(c["fwd:flash_fwd_sm90<128>"] for c in runs),
        "flash_bwd_fused_bf16_ring_enc": sum(c["bwd:flash_bwd_sm90<64>"] for c in runs),
        "flash_bwd_fused_bf16_ring_dec": sum(c["bwd:flash_bwd_sm90<128>"] for c in runs),
        **unetr["launches"]}}


def _spu_checks(got: dict, uone: str, uck: str) -> dict:
    """phase_sp's (f)-(h) from the two ranks' results `got`, against one device
    here: (f) the blocks split against whole to SPU_BLOCK_TOL; (g) unetr_sp's
    losses against one device's at the same batch to SPU_LOSS_TOL, each rank's
    ms a step, peak memory and gloo bytes a step by kind, and its launches of
    the f32 forward and fused backward (24 and 12 a step under remat); (h) the
    inference CLI's mean Dice on the sp-2 eval mesh against one device's to
    SPU_DICE_TOL. Then the two kernels at a rank's shape (SPU_SHAPE) against
    their plain versions and timed. Returns {"numbers": the record's two rows,
    "launches": theirs on (g) and (h)}."""
    import numpy as np
    import torch

    from ucf_vit_tpu_torch.inference import main as inference_main

    # (f)
    for name, res in got[0, "spatial_blocks"].items():
        if name == "s":  # the job's seconds
            continue
        other = got[1, "spatial_blocks"][name]
        kb = {k: f"{v / 1e6:.3f}" for k, v in sorted(res["bytes"].items())}
        e = {k: " / ".join(f"{v:.3e}" for v in res[k]) for k in ("f64", "split32", "whole32")}
        log(f"[sp] (f) {name}, batch 2, dim 2 split over the two ranks: max |diff| / max "
            f"|whole f64| of the output / input gradient / parameter gradients (of the "
            f"module's largest): split f64 {e['f64']} (tol {SPU_BLOCK_TOL:g}); f32, TF32 off: "
            f"split {e['split32']}, whole {e['whole32']}; f32 forward and backward "
            f"{res['ms']:.1f} / {other['ms']:.1f} ms on ranks 0 / 1, whole {res['whole_ms']:.1f}"
            f" ms; gloo MB a call by kind from rank 0 {kb}")
        if max(res["f64"]) > SPU_BLOCK_TOL:
            fail(f"(f) {name} split over sp disagrees with the block whole")
        if name.startswith("res_block") and not res["bytes"].get("halo"):
            fail(f"(f) {name} moved no halo")
    # (g)
    t1 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    one = _single_run("unetr_one", uone, SPU_STEPS)
    one_peak = torch.cuda.max_memory_allocated() / 1e9
    losses = _step_losses(os.path.join(WORK, "parallel", "unetr_sp2.jsonl"))
    diff = max(abs(a - b) for a, b in zip(losses, one["losses"]))
    log(f"[sp] (g) basic_ct/unetr_sp through the CLI entry at (ddp 1, sp 2), cut from the "
        f"shipped (ddp 4, sp 2) = 8 ranks, batch {SPU_BATCH} (the shipped 8 over 4 data "
        f"ranks), f32, remat, synthetic: losses {' '.join(f'{v:.6f}' for v in losses)}; one "
        f"device {' '.join(f'{v:.6f}' for v in one['losses'])}; max |diff| {diff:.3e} (tol "
        f"{SPU_LOSS_TOL:g})")
    if len(losses) != SPU_STEPS or not np.all(np.isfinite(losses)) or diff > SPU_LOSS_TOL:
        fail("(g) unetr_sp at sp 2 disagrees with one device")
    want = _unetr_instances(SPU_STEPS)
    for r in range(2):
        res = got[r, "unetr_train"]
        kinds = res["by_kind"][-1] if res["by_kind"] else {}
        log(f"[sp] (g) rank {r}: {_median(res['ms'][1:]):.3f} ms a step (median of steps "
            f"2-{SPU_STEPS}; one device {_median(one['ms'][1:]):.3f}; two ranks share one "
            f"card), peak {res['peak_gb']:.2f} GB (one device {one_peak:.2f}), gloo moves "
            f"{_median(res['gloo_bytes']) / 1e9:.4f} GB a step from this rank, the last step "
            f"by kind (MB) {({k: round(v / 1e6, 3) for k, v in sorted(kinds.items())})}; "
            f"launches a step "
            f"{ {k: n // SPU_STEPS for k, n in res['instances'].items() if n} }")
        if res["instances"] != want or res["sp"] != 2 or res["steps"] != SPU_STEPS or \
                not kinds.get("halo") or not kinds.get("norm") or not kinds.get("grad_sum"):
            fail(f"(g) rank {r}: launches {res['instances']} (expected {want}), sp "
                 f"{res['sp']}, steps {res['steps']}, gloo by kind {kinds}")
    log(f"[sp] (g) one device's run {time.perf_counter() - t1:.1f} s")
    # (h)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        one_dice = inference_main([uone, "--checkpoint", uck, "--synthetic", "--num-samples",
                                   str(SPU_EVAL_SAMPLES), "--device", "cuda"])
    want_eval = _unetr_instances(SPU_EVAL_SAMPLES, backward=False)
    for r in range(2):
        res = got[r, "unetr_dice"]
        d = abs(res["dice"] - one_dice)
        log(f"[sp] (h) the inference CLI's Dice on the sp-2 eval mesh from (g)'s checkpoint "
            f"(rank {r}, {SPU_EVAL_SAMPLES} synthetic samples; rank 0 prints each): {res['per']} mean "
            f"{res['dice']:.6f}; one device {one_dice:.6f}; |diff| {d:.3e} (tol "
            f"{SPU_DICE_TOL:g})")
        if d > SPU_DICE_TOL or (r == 0 and len(res["per"]) != SPU_EVAL_SAMPLES) or \
                res["instances"] != want_eval:
            fail(f"(h) rank {r}: the Dice on sp 2 disagrees with one device's, or launched "
                 f"{res['instances']} (expected {want_eval})")
    # the kernels at a rank's shape
    gen = torch.Generator(device="cuda").manual_seed(29)
    k = _attention_case("sp", "unetr_sp's rank at sp 2", SPU_SHAPE, gen, iters=SPU_KERNEL_ITERS)
    torch.cuda.empty_cache()
    runs = [got[r, n]["instances"] for r in range(2) for n in ("unetr_train", "unetr_dice")]
    return {"numbers": {"flash_fwd_unetr_sp": k["fwd"], "flash_bwd_fused_unetr_sp": k["bwd"]},
            "launches": {
                "flash_fwd_unetr_sp": sum(c["fwd:flash_fwd_tf32<64>"] for c in runs),
                "flash_bwd_fused_unetr_sp": sum(c["bwd:flash_bwd_tf32<64>"] for c in runs)}}


MOE_CONFIG = os.path.join(REPO, "configs", "imagenet", "classification_moe", "base_config.yaml")
MOE_LAYER = (32, 197, 768, 3072, 8, 2)  # (a): batch, tokens, D, H, experts, k: the config's
MOE_LAYER_TOL = 1e-5  # (a): card against CPU, f32 and TF32 off, times each one's largest entry
MOE_MARGIN = 1e-6  # (a): routing compared where the k-th and (k+1)-th probabilities differ by more
MOE_LAYER_ITERS = 10  # (a): bf16 forward + backward calls timed
MOE_STEPS = 3  # (b): through the CLI entry (--single-device)
MOE_CHECK_STEPS = 2  # (b): FLASH against EINSUM, the same batches
MOE_LOSS_TOL = 5e-3  # (b), (c): each step's loss (bf16)
MOE_SERVE_REQUESTS = 6  # (b): four lone, then two at once
MOE_SERVE_TOL = 2e-2  # (b): served logits against the in-process forward, of its largest entry
MOE_EP_STEPS = 2  # (c): at (ddp 1, ep 2) through the CLI entry, against (b)'s first steps
MOE_EP_FIRST_TOL = 1e-4  # (c): the first step's loss on free routing (the weights still equal)
MOE_DEADLINE_S = 300  # (c): both ranks' jobs
MOE_SHAPE = (32, 12, 197, 197, 64, True)  # the bf16 kernels at [384, 197, 64]
MOE_KERNEL_ITERS = 20


def _moe_layer() -> dict:
    """(a) `MoeMlp` at classification_moe's width (MOE_LAYER, capacity factor 1.25: C =
    62), weights and input from a CPU generator, on the card and on the CPU in f32 (TF32
    off): the routing (expert, slot, kept) equal in every sample whose tokens' k-th and
    (k+1)-th probabilities differ by more than MOE_MARGIN on both devices; the output and
    the gradients of `sum(y * w) + 0.3 * aux` for the five leaves within MOE_LAYER_TOL of
    their largest entries; then the bf16 layer's forward and backward timed."""
    import torch

    from ucf_vit_tpu_torch.models.moe import MoeMlp, expert_capacity
    from ucf_vit_tpu_torch.models.vit import _TRUNC_STD_CORRECTION

    b, n, d, h, e, k = MOE_LAYER
    gen = torch.Generator().manual_seed(31)
    layer = MoeMlp(d, h, e, top_k=k, capacity_factor=1.25)
    layer.init_weights(gen, 0.02 / _TRUNC_STD_CORRECTION)
    x = torch.randn(b, n, d, generator=gen)  # a LayerNorm's output
    w = torch.randn(b, n, d, generator=gen)
    leaves = ("router_kernel", "wi", "bi", "wo", "bo")

    def run(dev):
        m = copy.deepcopy(layer).to(dev)
        xx = x.to(dev)
        y = m(xx)
        ((y * w.to(dev)).sum() + 0.3 * m.aux_loss).backward()
        with torch.no_grad():
            probs, _, idx, slots, kept = m.route(xx)
        top = probs.sort(-1, descending=True).values
        return {"y": y.detach().cpu(), "aux": m.aux_loss.item(),
                "gap": (top[..., k - 1] - top[..., k]).cpu(), "idx": idx.cpu(),
                "slots": slots.cpu(), "kept": kept.cpu(),
                **{f"g:{leaf}": getattr(m, leaf).grad.cpu() for leaf in leaves}}

    t0 = time.perf_counter()
    cpu = run("cpu")
    cpu_s = time.perf_counter() - t0
    card = run("cuda")
    clear = ((cpu["gap"] > MOE_MARGIN) & (card["gap"] > MOE_MARGIN)).all(1)  # [B]
    same = all(torch.equal(card[key][clear], cpu[key][clear]) for key in ("idx", "slots", "kept"))
    errs = {key: ((card[key] - cpu[key]).abs().max() / cpu[key].abs().max()).item()
            for key in ("y", *(f"g:{leaf}" for leaf in leaves))}
    kept = cpu["kept"].float().mean().item()
    log(f"[moe] (a) MoeMlp [{b}, {n}, {d}] H {h}, {e} experts, top-{k}, C "
        f"{expert_capacity(n, e, k, 1.25)}, f32 (TF32 off), card against CPU ({cpu_s:.1f} s): "
        f"routing equal {same} in {int(clear.sum())} of {b} samples (the smallest k-th gap "
        f"{min(cpu['gap'].min().item(), card['gap'].min().item()):.3e}, margin {MOE_MARGIN:g}); "
        f"{100 * kept:.2f}% of the choices kept; aux {card['aux']:.6f} / {cpu['aux']:.6f}; max "
        f"|diff| / max |CPU|: " + ", ".join(f"{key} {v:.3e}" for key, v in errs.items())
        + f" (tol {MOE_LAYER_TOL:g})")
    if not same or not clear.any() or max(errs.values()) > MOE_LAYER_TOL or \
            abs(card["aux"] - cpu["aux"]) > MOE_LAYER_TOL:
        fail("(a) MoeMlp on the card disagrees with the CPU")
    # the bf16 layer's forward and backward, as the model runs it (a bf16 input)
    mb = copy.deepcopy(layer).cuda()
    mb.dtype = torch.bfloat16
    xb = x.cuda().bfloat16().requires_grad_()
    wb = w.cuda()

    def fwd_bwd():
        ((mb(xb).float() * wb).sum() + 0.3 * mb.aux_loss).backward()

    dev, host = device_ms(fwd_bwd, iters=MOE_LAYER_ITERS, warmup=2)
    with torch.no_grad():
        fwd_dev, fwd_host = device_ms(lambda: mb(xb), iters=MOE_LAYER_ITERS, warmup=2)
    c = expert_capacity(n, e, k, 1.25)
    flops = 2 * 2 * e * b * c * d * h  # the experts' two GEMMs on every slot
    log(f"[moe] (a) the bf16 layer: forward {fwd_dev:.3f} ms device ({fwd_host:.3f} host); "
        f"forward + backward {dev:.3f} ms device ({host:.3f} host); the experts' forward "
        f"{flops / 1e9:.1f} GFLOP on {e} x {b * c} slots (a dense MLP's x "
        f"{flops / (4 * b * n * d * h):.2f})")
    del mb, xb
    torch.cuda.empty_cache()
    return {"fwd_ms": fwd_dev, "fwd_bwd_ms": dev, "host_ms": host}


@contextlib.contextmanager
def _routing(record: list, replay: list | None = None):
    """`MoeMlp.route` wrapped while the block runs: each call's decisions
    (experts, slots, kept) appended to `record`; with `replay`, each call's
    decisions replaced by the next of those (its gates this call's
    probabilities at those experts, renormalised as the layer does), a call
    whose entry is None left to route freely."""
    from ucf_vit_tpu_torch.models.moe import MoeMlp

    made = MoeMlp.route

    def route(self, x):
        probs, gates, idx, slots, kept = made(self, x)
        taken = replay.pop(0) if replay is not None else None
        if taken is not None:
            idx, slots, kept = taken
            gates = probs.gather(-1, idx)
            if self.top_k > 1:
                gates = gates / gates.sum(-1, keepdim=True).clamp_min(1e-9)
        record.append((idx, slots, kept))
        return probs, gates, idx, slots, kept

    MoeMlp.route = route
    try:
        yield
    finally:
        MoeMlp.route = made


def _moe_kind(name: str, t) -> str:
    """What a collective of the ep-2 step carries: the experts' dispatch and
    return (all_to_all_single, forward and backward), the dense gradients'
    mean over the data group (the flat buckets), and small ones (the aux's
    means, the loss, the clip's norm, the overflow flag)."""
    if name == "all_to_all_single":
        return "dispatch_return"
    if name == "all_reduce" and t.ndim == 1 and t.numel() > 4096:
        return "grad_mean"
    return "small"


def _moe_rank(rank: int, store: str, jobs: list, results) -> None:
    """(c) One of two ranks on the card in a gloo group through a FileStore: the
    trainer's CLI entry on the ep-2 config with gloo's bytes counted by kind,
    each step timed, the launch counts set to 0 before it, the routing
    decisions of this rank's rows replayed from `job["replay"]` (one device's,
    `_routing`; a None entry, or a None list, routes freely)."""
    import torch
    import torch.distributed as dist

    sys.path.insert(0, REPO)
    torch.cuda.set_device(0)
    dist.init_process_group("gloo", store=dist.FileStore(store, 2), rank=rank, world_size=2)
    from ucf_vit_tpu_torch.ops.flash_attention import reset_launch_counts
    from ucf_vit_tpu_torch.train import main as train_main

    try:
        for job in jobs:
            t0 = time.perf_counter()
            times, tally = [], {"bytes": 0, "steps": [], "kind_steps": []}
            rows = slice(rank * 16, (rank + 1) * 16)  # this data rank's of the global 32
            replay = None if job["replay"] is None else [
                None if call is None else tuple(torch.from_numpy(a[rows]).cuda() for a in call)
                for call in job["replay"]]
            made = _counting_collectives(tally, _moe_kind)
            reset_launch_counts()
            torch.cuda.reset_peak_memory_stats()
            try:
                with _timed_steps(times, tally), _routing([], replay):
                    res = train_main(job["argv"])
            finally:
                for name, fn in made.items():
                    setattr(dist, name, fn)
            model = res["state"].model
            wi = model.blocks[1].moe_mlp.wi
            out = {"ms": times, "instances": _instance_counts(), "steps": res["state"].step,
                   "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
                   "gloo_bytes": tally["steps"], "by_kind": tally["kind_steps"],
                   "ep": model.mesh.size("ep"), "experts": int(wi.shape[0]),
                   "expert_leaves": len(model.ep_layout)}
            del res, model, wi
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            results.put((rank, job["name"], {**out, "s": time.perf_counter() - t0}))
    except BaseException:
        import traceback

        results.put((rank, "error", traceback.format_exc()))
        raise
    finally:
        dist.destroy_process_group()


def _moe_ranks(jobs: list) -> dict:
    """Run `jobs` on two spawned ranks (`_moe_rank`): {(rank, name): result}."""
    import queue

    root = os.path.join(WORK, "moe")
    os.makedirs(root, exist_ok=True)
    ctx = multiprocessing.get_context("spawn")
    results = ctx.Queue()
    procs = [ctx.Process(target=_moe_rank, args=(r, os.path.join(root, "store"), jobs, results),
                         daemon=True) for r in range(2)]
    t0 = time.perf_counter()
    for p in procs:
        p.start()
    got: dict = {}
    try:
        while len(got) < 2 * len(jobs):
            if time.perf_counter() - t0 > MOE_DEADLINE_S:
                fail(f"the two ranks did not finish within {MOE_DEADLINE_S} s: {sorted(got)}")
            try:
                rank, name, out = results.get(timeout=0.2)
            except queue.Empty:
                if any(p.exitcode not in (None, 0) for p in procs):
                    fail(f"a rank died: exit codes {[p.exitcode for p in procs]}")
                continue
            if name == "error":
                fail(f"rank {rank} failed:\n{out[-3000:]}")
            got[rank, name] = out
        for p in procs:
            p.join(timeout=60)
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
    if [p.exitcode for p in procs] != [0, 0]:
        fail(f"the ranks exited {[p.exitcode for p in procs]}")
    log(f"[moe] (c) two ranks: {time.perf_counter() - t0:.1f} s for every job")
    return got


def _moe_serve(path: str) -> dict:
    """(b)'s server: `serve.make_server` of the config on the card, MOE_SERVE_REQUESTS
    seeded 256 x 256 images through `/v1/predict` (four alone, two at once), each answer
    against the in-process forward of its patchified sample."""
    import numpy as np
    import torch

    from ucf_vit_tpu_torch.ops.flash_attention import reset_launch_counts
    from ucf_vit_tpu_torch.serve import make_preprocessor, make_server
    from ucf_vit_tpu_torch.tasks import seq_ps

    cfg = _single_device(path)
    rng = np.random.default_rng(17)
    samples = [rng.uniform(0, 255, size=(3, 256, 256)).astype(np.float32)
               for _ in range(MOE_SERVE_REQUESTS)]
    reset_launch_counts()
    t0 = time.perf_counter()
    server = make_server(cfg, host="127.0.0.1", port=0, max_batch=4, device="cuda")
    startup_s = time.perf_counter() - t0
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    port, answers, lat = server.server_address[1], {}, []

    def ask(i):
        t1 = time.perf_counter()
        answers[i] = np.load(io.BytesIO(_request(port, "POST", "/v1/predict", _npy(samples[i]))))
        lat.append(time.perf_counter() - t1)

    try:
        for i in range(4):
            ask(i)
        threads = [threading.Thread(target=ask, args=(i,)) for i in range(4, MOE_SERVE_REQUESTS)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        stats = _get_json(port, "/v1/stats")
        instances = {key: v for key, v in _instance_counts().items() if v}
        model = server.RequestHandlerClass.weights_holder["model"]
    finally:
        server.shutdown()
        server.server_close()
        server.RequestHandlerClass.batcher.close()
        thread.join(timeout=30)
    pre = make_preprocessor(cfg)
    batch = [pre(x) for x in samples]
    batch = {key: torch.from_numpy(np.stack([s[key] for s in batch])).cuda() for key in batch[0]}
    with torch.inference_mode():
        want = model(batch["seq"], seq_ps=seq_ps(batch)).float().cpu().numpy()
    del model
    scale = float(np.abs(want).max())
    worst = max(float(np.abs(answers[i] - want[i]).max()) for i in range(MOE_SERVE_REQUESTS))
    log(f"[moe] (b) served (max_batch 4): startup {startup_s:.1f} s, lone requests "
        f"{1e3 * min(lat):.1f}-{1e3 * max(lat):.1f} ms; {stats['requests']} requests in "
        f"{stats['batches']} batches, launches {instances}; {len(answers)} answers against the "
        f"in-process forward: max |diff| {worst:.3e} (tol {MOE_SERVE_TOL:g} x {scale:.3f})")
    if len(answers) != MOE_SERVE_REQUESTS or stats["errors"] or worst > MOE_SERVE_TOL * scale:
        fail("(b) the served MoE answers disagree with the in-process forward")
    return {"instances": instances, "lone_ms": 1e3 * min(lat)}


def phase_moe() -> dict:
    """imagenet/classification_moe (adaptive ViT-B/16 over 196 quadtree tokens and the
    class token, bf16, batch 32; every second block's MLP 8 experts, top-2, capacity
    1.25). (a) `_moe_layer`: the layer at full width on the card against the CPU, and
    its bf16 time; (b) the config through the CLI entry with --single-device,
    --synthetic, MOE_STEPS steps (full width and depth): each step's ms, the peak
    memory, the launches by instance (12 sm90 forwards and 12 fused backwards a step at
    [384, 197, 64]), the aux loss the trainer logs; FLASH against EINSUM over
    MOE_CHECK_STEPS steps, EINSUM's routing decisions replaced by FLASH's (`_routing`:
    the routing is discrete, and bf16's rounding of the two attentions flips some
    tokens' experts), within MOE_LOSS_TOL a step, EINSUM on its own routing and the
    choices that differ logged beside; a timed and a traced window (the busy share, the
    device time by kernel); a server's answers (`_moe_serve`); (c) the config
    at (ddp 1, ep 2), cut from the shipped (ddp 2, ep 4), the same global batch of 32,
    on two ranks sharing the card over gloo through the CLI entry: the first step on
    free routing, its loss within MOE_EP_FIRST_TOL of (b)'s (the weights are still
    equal), then each rank replaying its rows of (b)'s routing decisions (the two
    layouts' bf16 gradients round differently, and a flipped choice moved a step's loss
    by 8.2e-3), each step's loss within MOE_LOSS_TOL of (b)'s; a run on free routing
    throughout logged beside; each rank's ms a step and peak memory, gloo's
    bytes a step by kind, each rank holding 4 of the 8 experts. Then the bf16 kernels
    at [384, 197, 64] against their plain versions, timed beside SDPA. Returns {"numbers":
    the record's two rows, "launches": theirs on (b)'s CLI run}."""
    import numpy as np
    import torch

    from ucf_vit_tpu_torch.ops.flash_attention import reset_launch_counts
    from ucf_vit_tpu_torch.train import main as train_main
    from ucf_vit_tpu_torch.train import synthetic_batches

    layer = _moe_layer()
    # (b) through the CLI entry, the shipped parallelism overridden by --single-device
    one = _parallel_config("moe_one", MOE_CONFIG, {"simple_ddp_size": 2, "expert_par_size": 4})
    times, cli_routes = [], []
    reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with _timed_steps(times), _routing(cli_routes):
        out = train_main([one, "--single-device", "--synthetic", "--max-steps", str(MOE_STEPS)])
    cli_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 1e9
    instances = {key: v for key, v in _instance_counts().items() if v}
    counts = _launch_counts()
    model = out["state"].model
    shape = (sum(b.is_moe for b in model.blocks), len(model.blocks), model.embed_dim,
             str(model.dtype), model.blocks[1].moe_mlp.num_experts, model.mesh)
    n_params = sum(p.numel() for p in model.parameters())
    del out, model
    torch.cuda.empty_cache()
    recs = [r for r in _jsonl(os.path.join(WORK, "parallel", "moe_one.jsonl"))
            if "loss" in r and "step" in r]
    losses = [r["loss"] for r in recs]
    auxes = [r.get("moe_aux") for r in recs]
    want = {"fwd:flash_fwd_sm90<64>": 12 * MOE_STEPS, "bwd:flash_bwd_sm90<64>": 12 * MOE_STEPS}
    log(f"[moe] (b) python -m ucf_vit_tpu_torch.train classification_moe --single-device "
        f"--synthetic --max-steps {MOE_STEPS}: {cli_s:.1f} s (init included); {n_params / 1e6:.1f}M "
        f"parameters, {shape[0]} of {shape[1]} blocks MoE, width {shape[2]}, {shape[3]}; ms a "
        f"step {' '.join(f'{t:.1f}' for t in times)}; peak {peak:.2f} GB; losses "
        f"{' '.join(f'{v:.6f}' for v in losses)}; moe_aux {auxes}; launches {instances}, "
        f"bwd fused {counts['flash_bwd_fused']} dkv {counts['flash_bwd_dkv']} dq "
        f"{counts['flash_bwd_dq']}")
    if shape != (6, 12, 768, "torch.bfloat16", 8, None) or len(losses) != MOE_STEPS or \
            not np.all(np.isfinite(losses)) or instances != want or \
            not all(a is not None and np.isfinite(a) and a > 0 for a in auxes):
        fail(f"(b) classification_moe through the CLI: model {shape}, launches {instances} "
             f"(expected {want}), losses {losses}, aux {auxes}")
    # FLASH against EINSUM: the routing is discrete, so bf16's rounding of the two
    # attentions flips some tokens' experts; EINSUM is run twice, on its own routing and
    # on FLASH's decisions (the gate), then a timed and a traced window of FLASH's state
    cfg = _single_device(one)
    batches = [b for _, b in zip(range(MOE_CHECK_STEPS), synthetic_batches(cfg, 32))]
    runs, routes = {}, {}
    for impl, replay in (("FLASH", None), ("EINSUM", None), ("EINSUM_routed", "FLASH")):
        routes[impl] = []
        with _routing(routes[impl], None if replay is None else list(routes[replay])):
            st, sp, runs[impl], _, _ = _run_steps(
                _train_cfg(cfg, impl.split("_")[0]), batches)
        if impl != "FLASH":
            del st, sp
            torch.cuda.empty_cache()
        else:
            keep = (st, sp)
    st, sp = keep
    del keep
    flips = [(a[0] != b[0]).float().mean().item()
             for a, b in zip(routes["FLASH"], routes["EINSUM"])]
    diff = max(abs(a - b) for a, b in zip(runs["FLASH"], runs["EINSUM_routed"]))
    free = max(abs(a - b) for a, b in zip(runs["FLASH"], runs["EINSUM"]))
    log(f"[moe] (b) FLASH against EINSUM, {MOE_CHECK_STEPS} steps: FLASH "
        f"{' '.join(f'{v:.6f}' for v in runs['FLASH'])}; EINSUM on FLASH's routing "
        f"{' '.join(f'{v:.6f}' for v in runs['EINSUM_routed'])}: max |diff| {diff:.3e} (tol "
        f"{MOE_LOSS_TOL:g}); EINSUM on its own routing "
        f"{' '.join(f'{v:.6f}' for v in runs['EINSUM'])}: max |diff| {free:.3e}, the "
        f"choices that differ from FLASH's, a layer of the first step: "
        f"{' '.join(f'{100 * f:.2f}%' for f in flips[:6])}; FLASH against the CLI's first "
        f"steps {max(abs(a - b) for a, b in zip(runs['FLASH'], losses)):.3e}")
    if diff > MOE_LOSS_TOL or len(routes["EINSUM_routed"]) != len(routes["FLASH"]):
        fail("(b) classification_moe under FLASH disagrees with EINSUM on the same routing")
    meas = _measure_steps("moe", "classification_moe bf16, batch 32", st, sp, [batches[0]],
                          batches, traced=batches)
    del st, sp
    torch.cuda.empty_cache()
    served = _moe_serve(one)
    # (c) ep 2 on two ranks, the same global batch: the first step on free routing (the
    # weights still equal one device's), then one device's decisions replayed on each
    # rank's rows; beside it a run on free routing throughout, logged
    moe_layers = shape[0]  # MoE blocks: routing calls a step
    ep2 = _parallel_config("moe_ep2", MOE_CONFIG, {"expert_par_size": 2}, batch=16)
    ep2_free = _parallel_config("moe_ep2_free", MOE_CONFIG, {"expert_par_size": 2}, batch=16)
    replay = [None if i < moe_layers else tuple(t.cpu().numpy() for t in call)
              for i, call in enumerate(cli_routes[:moe_layers * MOE_EP_STEPS])]
    argv = ["--synthetic", "--max-steps", str(MOE_EP_STEPS)]
    got = _moe_ranks([{"name": "train", "replay": replay, "argv": [ep2, *argv]},
                      {"name": "free", "replay": None, "argv": [ep2_free, *argv]}])
    ep_losses = _step_losses(os.path.join(WORK, "parallel", "moe_ep2.jsonl"))
    free_losses = _step_losses(os.path.join(WORK, "parallel", "moe_ep2_free.jsonl"))
    diffs = [abs(a - b) for a, b in zip(ep_losses, losses)]
    free_diffs = [abs(a - b) for a, b in zip(free_losses, losses)]
    log(f"[moe] (c) classification_moe at (ddp 1, ep 2), cut from the shipped (ddp 2, ep 4) "
        f"= 8 ranks, batch 16 a rank (the global 32), step 1 on free routing, then each rank "
        f"replaying its rows of (b)'s routing decisions: losses "
        f"{' '.join(f'{v:.6f}' for v in ep_losses)}; one device "
        f"{' '.join(f'{v:.6f}' for v in losses[:MOE_EP_STEPS])}; |diff| "
        f"{' '.join(f'{v:.3e}' for v in diffs)} (tol {MOE_EP_FIRST_TOL:g} at step 1, "
        f"{MOE_LOSS_TOL:g} after); free routing throughout "
        f"{' '.join(f'{v:.6f}' for v in free_losses)}: |diff| "
        f"{' '.join(f'{v:.3e}' for v in free_diffs)}")
    if len(ep_losses) != MOE_EP_STEPS or not np.all(np.isfinite(ep_losses)) or \
            len(free_losses) != MOE_EP_STEPS or not np.all(np.isfinite(free_losses)) or \
            diffs[0] > MOE_EP_FIRST_TOL or max(diffs) > MOE_LOSS_TOL:
        fail("(c) classification_moe at ep 2 disagrees with one device")
    for r in range(2):
        res = got[r, "train"]
        kinds = res["by_kind"][-1] if res["by_kind"] else {}
        log(f"[moe] (c) rank {r}: {' '.join(f'{t:.1f}' for t in res['ms'])} ms a step (two "
            f"ranks share one card; one device {_median(times[1:]):.1f}), peak "
            f"{res['peak_gb']:.2f} GB (one device {peak:.2f}), gloo moves "
            f"{_median(res['gloo_bytes']) / 1e9:.4f} GB a step from this rank, the last step by "
            f"kind (MB) {({k: round(v / 1e6, 3) for k, v in sorted(kinds.items())})}; "
            f"{res['experts']} experts a leaf here ({res['expert_leaves']} expert leaves); "
            f"launches {({k: v for k, v in res['instances'].items() if v})}")
        if res["ep"] != 2 or res["experts"] != 4 or res["expert_leaves"] != 24 or \
                not kinds.get("dispatch_return") or not kinds.get("grad_mean") or \
                res["instances"]["fwd:flash_fwd_sm90<64>"] != 12 * MOE_EP_STEPS:
            fail(f"(c) rank {r}: ep {res['ep']}, {res['experts']} experts, gloo by kind "
                 f"{kinds}, launches {res['instances']}")
    # the bf16 kernels at the config's attention
    gen = torch.Generator(device="cuda").manual_seed(37)
    k = _attention_case("moe", "classification_moe's attention", MOE_SHAPE, gen,
                        iters=MOE_KERNEL_ITERS, dtype_name="bfloat16")
    torch.cuda.empty_cache()
    log(f"[moe] record: layer {layer}; step {meas['ms_step']:.3f} ms, busy "
        f"{100 * meas['busy_share']:.2f}%, peak {peak:.2f} GB; served lone "
        f"{served['lone_ms']:.1f} ms")
    return {"numbers": {"flash_fwd_bf16_moe": k["fwd"], "flash_bwd_fused_bf16_moe": k["bwd"]},
            "launches": {"flash_fwd_bf16_moe": instances["fwd:flash_fwd_sm90<64>"],
                         "flash_bwd_fused_bf16_moe": instances["bwd:flash_bwd_sm90<64>"]}}


def compare_forward(other: str) -> None:
    """`fused_mlp` and `int8_matmul` (`compare_mlp`), the split route's
    backward kernels (`compare_split_bwd`), then the bf16 flash
    forward of this checkout and of `other`, in one process, on the packed qkv
    views of ViT-B/16's and ViT-L/16's shapes and mae_long's encoder
    (`TIMED_SHAPES`): device ms per call of `flash_fwd_sm90_kernel`
    (`device_ms`) beside scaled_dot_product_attention's; and at the ViT
    shapes, where the kernel is shorter than the host's work for a call, the
    host's us per call: COMPARE_CALLS back-to-back calls ending in a
    synchronize, in COMPARE_WINDOWS windows a checkout taken in turns, so
    that the host's drift falls on both alike (between processes one tree's
    host time spreads by 10-20 us on an H100 host); the median per checkout
    and the median of the per-round differences."""
    import statistics

    import torch
    import torch.nn.functional as F

    checkouts = [REPO, other]
    forwards = [_load_forward(c) for c in checkouts]
    compare_mlp(checkouts, forwards)
    compare_split_bwd(checkouts, forwards)
    gen = torch.Generator(device="cuda").manual_seed(0)
    for b, h, n, _, dh in TIMED_SHAPES:
        q, k, v = _flash_inputs(b, h, n, n, dh, torch.bfloat16, True, gen)
        sm = dh**-0.5
        calls = [lambda f=f: f(q, k, v, sm_scale=sm) for f, _ in forwards]
        device = []
        for call, (_, modules) in zip(calls, forwards):
            _use(modules)
            device.append(device_ms(call, FWD_KERNEL["bfloat16"])[0])
        sdpa_ms, _ = device_ms(lambda: F.scaled_dot_product_attention(q, k, v, scale=sm))
        host = [[] for _ in range(COMPARE_WINDOWS)] if n * n < 5e7 else []
        for r in range(-1, len(host)):  # round -1 warms up
            for call, (_, modules) in zip(calls, forwards):
                _use(modules)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for _ in range(COMPARE_CALLS):
                    call()
                torch.cuda.synchronize()
                if r >= 0:
                    host[r].append((time.perf_counter() - t0) / COMPARE_CALLS * 1e6)
        for i, c in enumerate(checkouts):
            line = f"[compare] {c} [{b},{h},{n},{dh}] bf16 qkv-views: kernel {device[i]:.4f} ms"
            if host:
                line += f", host {statistics.median(r[i] for r in host):.2f} us per call"
            if host and i:
                diff = statistics.median(r[i] - r[0] for r in host)
                line += f" ({diff:+.2f} us against this checkout, median of rounds)"
            log(line)
        log(f"[compare] [{b},{h},{n},{dh}] scaled_dot_product_attention {sdpa_ms:.4f} ms")
    _use({})


# each phase's wall seconds, in the order they ran (`_timed`)
PHASE_SECONDS: dict = {}


def _timed(name: str, fn, *args):
    """`fn(*args)`, its wall seconds kept under `name` and printed as a `[time]`
    line."""
    t0 = time.perf_counter()
    out = fn(*args)
    PHASE_SECONDS[name] = time.perf_counter() - t0
    log(f"[time] {name} {PHASE_SECONDS[name]:.1f} s")
    return out


def main() -> int:
    t_start = time.perf_counter()
    args = sys.argv[1:]
    only = ("adaptive", "unetr", "sap", "parallel", "sp", "moe")
    if args and (len(args) != 2 or args[0] not in ("--compare", "--only")
                 or (args[0] == "--only" and args[1] not in only)):
        fail("usage: chip_smoke.py [--compare CHECKOUT | --only adaptive | --only unetr | "
             "--only sap | --only parallel | --only sp | --only moe]")
    if args and args[0] == "--compare" and \
            not os.path.isdir(os.path.join(args[1], "ucf_vit_tpu_torch")):
        fail(f"{args[1]} holds no ucf_vit_tpu_torch/")
    if not os.path.isdir(os.path.join(REPO, "ucf_vit_tpu_torch")) or not os.path.isfile(CONFIG):
        fail(f"{REPO} is not a checkout of the repository (no ucf_vit_tpu_torch/ or config)")
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this script needs a CUDA card")
    sys.path.insert(0, REPO)

    card = phase_device()
    if torch.cuda.get_device_name(0) != CARD:
        fail(f"no published peaks for {torch.cuda.get_device_name(0)!r}; this script "
             f"knows the {CARD}")
    if args and args[0] == "--compare":
        compare_forward(os.path.abspath(args[1]))
        print(card, flush=True)
        return 0
    if args:  # --only adaptive|unetr|sap|parallel|sp|moe: the build and that phase alone, no record
        _timed("phase_build", phase_build)
        _timed("phase_build_rest", phase_build_rest)
        os.makedirs(WORK, exist_ok=True)
        try:
            phase = {"adaptive": phase_adaptive, "unetr": phase_unetr, "sap": phase_sap,
                     "parallel": phase_parallel, "sp": phase_sp, "moe": phase_moe}
            _timed(f"phase_{args[1]}", phase[args[1]])
        finally:
            shutil.rmtree(WORK, ignore_errors=True)
        log(f"[time] the script {time.perf_counter() - t_start:.1f} s")
        print(card, flush=True)
        return 0
    _timed("phase_build", phase_build)
    os.makedirs(WORK, exist_ok=True)
    try:
        # while SLOW_SOURCE builds: the phases that launch none of its kernels (the f32
        # forward, the bf16 sources, fused_mlp and int8_gemm, bf16 MoE)
        fwd = _timed("phase_kernels", phase_kernels)
        mae = _timed("phase_mae_kernels", phase_mae_kernels)
        mlp = _timed("phase_mlp_kernels", phase_mlp_kernels)
        int8 = _timed("phase_int8_kernels", phase_int8_kernels)
        trained_bf16 = _timed("phase_train_bf16", phase_train_bf16)
        trained_mae = _timed("phase_train_mae", phase_train_mae)
        moe = _timed("phase_moe", phase_moe)  # bf16 alone: no tf32 kernel
        _timed("phase_build_rest", phase_build_rest)
        bwd = _timed("phase_bwd_kernels", phase_bwd_kernels)
        diffusion_kernels = _timed("phase_diffusion_kernels", phase_diffusion_kernels)
        dropout = _timed("phase_dropout", phase_dropout, fwd, bwd)
        ops = _timed("phase_ops_path", phase_ops_path)
        trained = _timed("phase_train", phase_train)
        served = _timed("phase_serve", phase_serve, trained["ckpt_dir"])
        disk = _timed("phase_train_disk", phase_train_disk, trained_mae, trained["ms_step"])
        diffusion = _timed("phase_train_diffusion", phase_train_diffusion)
        generated = _timed("phase_generate", phase_generate)
        if disk["jpeg"] is None:
            fail("phase_trainer_parity trains from JPEG files: PIL and cv2 must import")
        parity = _timed("phase_trainer_parity", phase_trainer_parity, disk["jpeg"]["root"],
                        disk["mae_ckpt"])
        adaptive = _timed("phase_adaptive", phase_adaptive)
        unetr = _timed("phase_unetr", phase_unetr, disk["mae_ckpt"])
        sap = _timed("phase_sap", phase_sap, disk["mae_ckpt"])
        parallel = _timed("phase_parallel", phase_parallel)
        sp = _timed("phase_sp", phase_sp)
    finally:
        shutil.rmtree(WORK, ignore_errors=True)
    log("[time] " + ", ".join(f"{k} {v:.1f}" for k, v in PHASE_SECONDS.items())
        + f" s; the phases {sum(PHASE_SECONDS.values()):.1f} s, the script "
        f"{time.perf_counter() - t_start:.1f} s")
    log(f"[profiler] {PROFILE_LOSS['windows']} windows timed a named kernel: "
        f"{PROFILE_LOSS['short']} recorded fewer launches than they made (at most "
        f"{PROFILE_LOSS['most_lost']} fewer), {PROFILE_LOSS['timed_lost']} of them fewer "
        "than the timed calls")

    # Each flash kernel has two rows: the f32 instance (*_tf32.cu) at the
    # ViT-B/16 shape that serving and f32 training give it, with the launches of those
    # paths, and the bf16 instance (*_sm90.cu) at ViT-L/16's microbatch shape, with the
    # launches of the ViT-L training through the CLI entry. The bf16 instances have a
    # second row on mae_long's path: their numbers at the decoder's shape (MAE_DEC_SHAPE,
    # most of that path's attention time), their launches those of the mae_long training
    # through the CLI entry (the forward's: the encoder's 8192-token calls and the
    # decoder's together, PERF.md splitting them by the traced window; the fused
    # backward's: the encoder's, since the decoder's backward takes the split route). The
    # split route's kernels have an f32 row each at ViT-B/16's shape (flash_bwd_tf32.cu; on
    # no f32 path: 0 launches), a bf16 dq row there (flash_bwd_sm90.cu; bf16 dkv is the
    # fused kernel's template) and a row each at the decoder's shape with the decoder's
    # launches on mae_long's path, which must not be 0. The hash counts
    # the training with attention dropout; fused_mlp and int8_matmul, on no model path in
    # either package, the ops' public API (at the ViT-B MLP shape: fused_mlp and
    # int8_matmul in bf16, fused_mlp_f32 the f32 call of fused_mlp). phase_trainer_parity's
    # main paths add theirs: the catsdogs run through the CLI entry with validation (f32
    # forwards and fused backwards), MAE /v1/predict under load (the sm90 forwards at
    # mae_long's encoder and decoder) and the inference CLI's diffusion branch (DH = 128).
    sources = {
        "flash_fwd": ("ucf_vit_tpu_torch/csrc/flash_fwd_tf32.cu",
                      "ucf_vit_tpu/ops/flash_attention.py:68"),
        "flash_fwd_bf16": ("ucf_vit_tpu_torch/csrc/flash_fwd_sm90.cu",
                           "ucf_vit_tpu/ops/flash_attention.py:68"),
        "flash_bwd_fused": ("ucf_vit_tpu_torch/csrc/flash_bwd_tf32.cu",
                            "ucf_vit_tpu/ops/flash_attention.py:249"),
        "flash_bwd_fused_bf16": ("ucf_vit_tpu_torch/csrc/flash_bwd_sm90.cu",
                                 "ucf_vit_tpu/ops/flash_attention.py:249"),
        "flash_fwd_bf16_mae_long": ("ucf_vit_tpu_torch/csrc/flash_fwd_sm90.cu",
                                    "ucf_vit_tpu/ops/flash_attention.py:68"),
        "flash_bwd_fused_bf16_mae_long": ("ucf_vit_tpu_torch/csrc/flash_bwd_sm90.cu",
                                          "ucf_vit_tpu/ops/flash_attention.py:249"),
        "flash_bwd_dkv": ("ucf_vit_tpu_torch/csrc/flash_bwd_tf32.cu",
                          "ucf_vit_tpu/ops/flash_attention.py:162"),
        "flash_bwd_dq": ("ucf_vit_tpu_torch/csrc/flash_bwd_tf32.cu",
                         "ucf_vit_tpu/ops/flash_attention.py:362"),
        "flash_bwd_dq_bf16": ("ucf_vit_tpu_torch/csrc/flash_bwd_sm90.cu",
                              "ucf_vit_tpu/ops/flash_attention.py:362"),
        "flash_bwd_dkv_bf16_mae_long": ("ucf_vit_tpu_torch/csrc/flash_bwd_sm90.cu",
                                        "ucf_vit_tpu/ops/flash_attention.py:162"),
        "flash_bwd_dq_bf16_mae_long": ("ucf_vit_tpu_torch/csrc/flash_bwd_sm90.cu",
                                       "ucf_vit_tpu/ops/flash_attention.py:362"),
        "keep_mask": ("ucf_vit_tpu_torch/csrc/attn_dropout.cuh",
                      "ucf_vit_tpu/ops/attn_dropout.py:70"),
        "fused_mlp": ("ucf_vit_tpu_torch/csrc/fused_mlp_sm90.cu",
                      "ucf_vit_tpu/ops/fused_mlp.py:55"),
        "fused_mlp_f32": ("ucf_vit_tpu_torch/csrc/fused_mlp_tf32.cu",
                          "ucf_vit_tpu/ops/fused_mlp.py:55"),
        "int8_matmul": ("ucf_vit_tpu_torch/csrc/int8_gemm.cu", "ucf_vit_tpu/ops/int8_gemm.py:61"),
        "flash_fwd_dh128": ("ucf_vit_tpu_torch/csrc/flash_fwd_tf32.cu",
                            "ucf_vit_tpu/ops/flash_attention.py:68"),
        "flash_bwd_fused_dh128": ("ucf_vit_tpu_torch/csrc/flash_bwd_tf32.cu",
                                  "ucf_vit_tpu/ops/flash_attention.py:249"),
        "flash_fwd_dh96": ("ucf_vit_tpu_torch/csrc/flash_fwd_tf32.cu",
                           "ucf_vit_tpu/ops/flash_attention.py:68"),
        "flash_bwd_fused_dh96": ("ucf_vit_tpu_torch/csrc/flash_bwd_tf32.cu",
                                 "ucf_vit_tpu/ops/flash_attention.py:249"),
        "flash_fwd_unetr": ("ucf_vit_tpu_torch/csrc/flash_fwd_tf32.cu",
                            "ucf_vit_tpu/ops/flash_attention.py:68"),
        "flash_bwd_fused_unetr": ("ucf_vit_tpu_torch/csrc/flash_bwd_tf32.cu",
                                  "ucf_vit_tpu/ops/flash_attention.py:249"),
        "flash_fwd_sap": ("ucf_vit_tpu_torch/csrc/flash_fwd_tf32.cu",
                          "ucf_vit_tpu/ops/flash_attention.py:68"),
        "flash_bwd_fused_sap": ("ucf_vit_tpu_torch/csrc/flash_bwd_tf32.cu",
                                "ucf_vit_tpu/ops/flash_attention.py:249"),
        "flash_fwd_bf16_sap": ("ucf_vit_tpu_torch/csrc/flash_fwd_sm90.cu",
                               "ucf_vit_tpu/ops/flash_attention.py:68"),
        "flash_bwd_fused_bf16_sap": ("ucf_vit_tpu_torch/csrc/flash_bwd_sm90.cu",
                                     "ucf_vit_tpu/ops/flash_attention.py:249"),
        "flash_fwd_tp2": ("ucf_vit_tpu_torch/csrc/flash_fwd_tf32.cu",
                          "ucf_vit_tpu/ops/flash_attention.py:68"),
        "flash_bwd_fused_tp2": ("ucf_vit_tpu_torch/csrc/flash_bwd_tf32.cu",
                                "ucf_vit_tpu/ops/flash_attention.py:249"),
        "flash_fwd_chain_enc_ddp2": ("ucf_vit_tpu_torch/csrc/flash_fwd_tf32.cu",
                                     "ucf_vit_tpu/ops/flash_attention.py:68"),
        "flash_fwd_chain_dec_ddp2": ("ucf_vit_tpu_torch/csrc/flash_fwd_tf32.cu",
                                     "ucf_vit_tpu/ops/flash_attention.py:68"),
        "flash_fwd_bf16_ring_enc": ("ucf_vit_tpu_torch/csrc/flash_fwd_sm90.cu",
                                    "ucf_vit_tpu/ops/flash_attention.py:68"),
        "flash_bwd_fused_bf16_ring_enc": ("ucf_vit_tpu_torch/csrc/flash_bwd_sm90.cu",
                                          "ucf_vit_tpu/ops/flash_attention.py:249"),
        "flash_fwd_bf16_ring_dec": ("ucf_vit_tpu_torch/csrc/flash_fwd_sm90.cu",
                                    "ucf_vit_tpu/ops/flash_attention.py:68"),
        "flash_bwd_fused_bf16_ring_dec": ("ucf_vit_tpu_torch/csrc/flash_bwd_sm90.cu",
                                          "ucf_vit_tpu/ops/flash_attention.py:249"),
        "flash_fwd_unetr_sp": ("ucf_vit_tpu_torch/csrc/flash_fwd_tf32.cu",
                               "ucf_vit_tpu/ops/flash_attention.py:68"),
        "flash_bwd_fused_unetr_sp": ("ucf_vit_tpu_torch/csrc/flash_bwd_tf32.cu",
                                     "ucf_vit_tpu/ops/flash_attention.py:249"),
        "flash_fwd_bf16_moe": ("ucf_vit_tpu_torch/csrc/flash_fwd_sm90.cu",
                               "ucf_vit_tpu/ops/flash_attention.py:68"),
        "flash_bwd_fused_bf16_moe": ("ucf_vit_tpu_torch/csrc/flash_bwd_sm90.cu",
                                     "ucf_vit_tpu/ops/flash_attention.py:249"),
    }
    numbers = {"flash_fwd": fwd["float32"], "flash_fwd_bf16": fwd["vit_l_bfloat16"],
               "keep_mask": dropout, **{f"flash_bwd_{k}": v for k, v in bwd["float32"].items()},
               "flash_bwd_fused_bf16": bwd["vit_l_bfloat16"]["fused"],
               "flash_fwd_bf16_mae_long": mae["decoder"]["fwd"],
               "flash_bwd_fused_bf16_mae_long": mae["decoder"]["bwd"]["fused"],
               "flash_bwd_dq_bf16": bwd["bfloat16"]["dq"],
               "flash_bwd_dkv_bf16_mae_long": mae["decoder"]["bwd"]["dkv"],
               "flash_bwd_dq_bf16_mae_long": mae["decoder"]["bwd"]["dq"],
               "fused_mlp": mlp[RECORD_MLP, "bfloat16"],
               "fused_mlp_f32": mlp[RECORD_MLP, "float32"], "int8_matmul": int8[RECORD_INT8],
               "flash_fwd_dh128": diffusion_kernels["imagenet"]["fwd"],
               "flash_bwd_fused_dh128": diffusion_kernels["imagenet"]["bwd"],
               "flash_fwd_dh96": diffusion_kernels["basic_ct"]["fwd"],
               "flash_bwd_fused_dh96": diffusion_kernels["basic_ct"]["bwd"],
               "flash_fwd_unetr": unetr["kernels"]["fwd"],
               "flash_bwd_fused_unetr": unetr["kernels"]["bwd"], **sap["numbers"],
               **parallel["numbers"], **sp["numbers"], **moe["numbers"]}
    f32, vit_l, mae_long = trained["main"], trained_bf16["main"], trained_mae["main"]
    launches = {
        "flash_fwd": served["launches"] + f32["src:flash_fwd_tf32"]
        + parity["f32"]["src:flash_fwd_tf32"],
        "flash_fwd_bf16": vit_l["src:flash_fwd_sm90"],
        "flash_bwd_fused": f32["src:flash_bwd_tf32"] + parity["f32"]["src:flash_bwd_tf32"],
        "flash_bwd_fused_bf16": vit_l["flash_bwd_fused"],
        "flash_fwd_bf16_mae_long": mae_long["src:flash_fwd_sm90"]
        + parity["predict"]["src:flash_fwd_sm90"],
        "flash_bwd_fused_bf16_mae_long": mae_long["flash_bwd_fused"],
        "flash_bwd_dkv": f32["flash_bwd_dkv"],
        "flash_bwd_dq": f32["flash_bwd_dq"],
        "flash_bwd_dq_bf16": vit_l["flash_bwd_dq"],
        "flash_bwd_dkv_bf16_mae_long": mae_long["flash_bwd_dkv"],
        "flash_bwd_dq_bf16_mae_long": mae_long["flash_bwd_dq"],
        "keep_mask": trained["dropout"]["keep_mask"], **ops,
        # the diffusion paths: imagenet's training through the CLI entry, its first
        # generate call and its served request (DH = 128); basic_ct's training (DH = 96)
        "flash_fwd_dh128": sum(c["fwd:flash_fwd_tf32<128>"] for c in (
            diffusion["imagenet"]["instances"], generated["instances"],
            generated["served_instances"], parity["generate"])),
        "flash_bwd_fused_dh128": diffusion["imagenet"]["instances"]["bwd:flash_bwd_tf32<128>"],
        "flash_fwd_dh96": diffusion["basic_ct"]["instances"]["fwd:flash_fwd_tf32<96>"],
        "flash_bwd_fused_dh96": diffusion["basic_ct"]["instances"]["bwd:flash_bwd_tf32<96>"],
    }
    # the adaptive paths (phase_adaptive): imagenet/classification through the CLI entry from
    # JPEG files and its server, basic_ct/mae's encoder (<64>) and decoder (<96>) and
    # imagenet/mae's decoder (<128>) through the CLI entry, basic_ct/mae's /v1/predict
    for name, n in adaptive["launches"].items():
        launches[name] += n
    # basic_ct/unetr's paths (phase_unetr): training through the CLI entry (synthetic and
    # from files), the inference CLI's Dice and --volume, the server; the f32 <64>
    # instances at [96, 729, 64], a row of their own
    launches.update(unetr["launches"])
    # SAP's paths (phase_sap): basic_ct/sap through the CLI entry (synthetic and from
    # files), the inference CLI's Dice and its server (f32 <64> at [24, 512, 64]);
    # sap_bf16 through the CLI entry (sm90 <64> at [192, 512, 64]): rows of their own
    launches.update(sap["launches"])
    # the sharded paths (phase_parallel): ViT-B/16 f32 in tp 2, a row of its own at a rank's
    # [96, 257, 64] (training, the inference CLI and the server); ViT-L/16 bf16 in ddp 2 at
    # the single-device row's [128, 257, 64]; imagenet/diffusion's chain in ddp 2, a row for
    # its encoder's <64> at a rank's [24, 256, 64] and one for its decoder's <128> at [8,
    # 256, 128]
    for name, n in parallel["launches"].items():
        launches[name] = launches.get(name, 0) + n
    # the sequence-parallel paths (phase_sp): mae_long at sp 2 (ring) through the CLI entry and
    # reconstruct on the sp-2 eval mesh: the sm90 forward (o in f32) and fused backward on the
    # ring's chunks, rows of their own at the training's [2, 12, 4096 x 4096, 64] (the encoder's
    # <64>) and [2, 6, 16384 x 16384, 96] (the decoder's <128>); reconstruct's calls are at
    # batch 1; basic_ct/unetr_sp at sp 2 through the CLI entry and the inference CLI's Dice on
    # the sp-2 eval mesh: the f32 <64> instances at a rank's [24, 729, 64], rows of their own
    launches.update(sp["launches"])
    # classification_moe's path (phase_moe): its CLI run at --single-device, the sm90
    # forward and fused backward at [384, 197, 64], rows of their own
    launches.update(moe["launches"])
    log(f"[record] launches: serve {served['launches']} flash_fwd; f32 train() {f32}; bf16 "
        f"ViT-L train {vit_l}; mae_long train {mae_long}; mae_long from disk {disk['main']}; "
        f"train with attention dropout {trained['dropout']}; the ops' public API {ops}")
    log(f"[record] mae_long from disk: {disk['ms_step']:.3f} ms/step (synthetic "
        f"{trained_mae['ms_step']:.3f}), the loader alone {disk['loader_ms']:.1f} ms a batch, "
        f"busy {100 * disk['busy']:.2f}%, checkpoint saves {disk['save_s']} s, load "
        f"{disk['load_s']} s; catsdogs from JPEG files {disk['jpeg']}")
    log(f"[record] diffusion: " + "; ".join(
        f"{n} {r['ms_step']:.3f} ms/step, {r['images_s']:.2f} images/s, busy "
        f"{100 * r['busy_share']:.2f}%, {r['device_step_ms']:.3f} ms device a step, peak "
        f"{r['peak_gb']:.2f} GB" for n, r in diffusion.items())
        + f"; generate {', '.join(f'{x:.4f}' for x in generated['samples_s'])} samples/s, "
        f"{generated['denoise']['device_ms']:.3f} ms device a denoising step "
        f"({100 * generated['denoise']['busy']:.2f}% busy), a served {GEN_SEED_STEPS}-step request "
        f"{generated['latency_s']:.3f} s")
    log(f"[record] trainer parity: validation {parity['val_ms']} ms a batch, a resume's "
        f"checkpoint read {parity['read_s']} s; MAE /v1/predict {parity['rps']:.3f} requests/s "
        f"under {MAE_SERVE_CLIENTS} clients, a lone request {parity['lone_ms']:.1f} ms, busy "
        f"{100 * parity['busy']:.2f}%")
    for name in ("flash_fwd", "flash_fwd_bf16", "flash_bwd_fused", "flash_bwd_fused_bf16",
                 "flash_fwd_bf16_mae_long", "flash_bwd_fused_bf16_mae_long",
                 "flash_bwd_dkv_bf16_mae_long", "flash_bwd_dq_bf16_mae_long", "fused_mlp",
                 "fused_mlp_f32", "int8_matmul", "flash_fwd_dh128", "flash_bwd_fused_dh128",
                 "flash_fwd_dh96", "flash_bwd_fused_dh96", "flash_fwd_unetr",
                 "flash_bwd_fused_unetr", *sap["launches"], "flash_fwd_tp2",
                 "flash_bwd_fused_tp2", "flash_fwd_chain_enc_ddp2", "flash_fwd_chain_dec_ddp2",
                 *sp["launches"], *moe["launches"]):
        if launches[name] <= 0:
            fail(f"{name} was launched no time on its main path")
    keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    record = {"kernels": [
        {"name": name, "route": "cuda", "source": src, "replaces": rep,
         "launches": launches[name], **{k: numbers[name][k] for k in keys}}
        for name, (src, rep) in sources.items()
    ]}
    print(json.dumps(record), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
