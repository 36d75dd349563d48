#!/usr/bin/env python3
"""GPU smoke run of the PyTorch/CUDA port (mmde_tpu_torch).

    python3 chip_smoke.py                 # everything, one card
    python3 chip_smoke.py --only kernels  # build + compare the kernels only
    python3 chip_smoke.py --only loop     # the training / evaluation entry
                                          # points only (loop, eval_ckpt,
                                          # deterministic)
    python3 chip_smoke.py --only models   # the other encoders and families
                                          # (and K3 over MapRows) only
    python3 chip_smoke.py --only data     # the data path: codec, VOID /
                                          # KITTI / NYU readers, training
                                          # on a VOID tree, the infer CLI
    python3 chip_smoke.py --only modules  # pretrained loading, the remat
                                          # policies, tools.profile_step
    python3 chip_smoke.py --profile p.json  # also: device time by kernel
                                            # of a request and a train step,
                                            # flagship (p.json), swin_large
                                            # (p_large.json), the flagship's
                                            # slab path (p_slab.json), the
                                            # fp32 flagship (p_fp32.json),
                                            # its slab path (p_slab_fp32.json)

What it does, each phase printing one JSON object on a line of its own:

  env           card name and power limit (nvidia-smi), torch / CUDA / nvcc
                versions, seconds spent building the kernels from csrc/,
                registers and spills by kernel (ptxas), the slab kernels'
                occupancy (blocks an SM holds, by type and mask).
  kernel_cases  the window-attention kernel against its plain PyTorch
                version at the four flagship stage shapes, float32 and
                bfloat16 (every packed, head-split and slab launch, bf16 or
                fp32, runs the tensor-core kernels, fp32 operands in three
                bf16 pieces, everywhere in this script; the FMA bodies only
                as A/B partners), with and without mask: max abs / rel-L2
                error, kernel ms (fp32: in turns with the FMA body, fma_ms)
                and plain ms (CUDA events, warm, median), and the roofline
                bound with its bytes and flops.
  kernel_cases_backward
                the backward kernel (both ways it can sum dbias) at the
                same stage shapes for 2 and 1 frame pairs, float32 and
                bfloat16, one head at the ln(100) clamp and one hot head:
                dqkv, dbias, dlogit_scale against the plain backward and
                against float64 autograd of the plain forward; ms, plain
                ms, bound; each checks which kernels its launches ran
                ("split": the tensor-core K3 behind the tensor-core passes,
                either type; `k3`: its dbias against K3's plain version and
                float64, MXU_APART times nearer than the "bf16" mode's,
                bitwise over two launches; timed alone on the dq pass's
                delta in turns with its FMA body, k3_ms / k3_fma_ms, beside
                k3_plain_ms, its bound, FMA bound and tensor-core bound);
                fp32 also the FMA body's forward and backward in turns
                (fma_ms). Each case also holds the output of the forward
                that recorded the graph (the forward kernel's training entry
                point, which writes the log-sum-exp as well) against the
                plain forward, and times it. Both phases also cover the
                packed stages 2-4 of swin_large_v2.
  f3_packed     F3 on both packed bodies at W = 1 (fp32, every head at
                scale 60, flagship stage 1 trained): the tensor-core K1 / K2
                and the FMA bodies through the autograd Function, each
                dlogit_scale within TOL_F3 of float64; each body's K3
                ("split", on its own statistic) dbias within TOL_BWD's fp32
                limit of float64.
  kernel_cases_headsplit
                the head-split forward (K6') and backward (K7') against
                their plain versions, the backward also against float64
                autograd, at every head-split stage shape of the real swin
                variants at 480x640 (swin_tiny 1-2, swin_large 1, swin_huge
                1-2) and at swin_large's train shape, float32 and bfloat16
                (both the tensor-core kernels, fp32 in three bf16 pieces;
                MXU_APART times nearer the "fp32" plain version than the
                "bf16"-mode one: bf16 the output and dqkv, fp32 the output
                and every gradient), masked and unmasked, one clamped and
                one hot head; q, k, v are the model's strided views of one
                qkv tensor; each case checks which kernels its launches
                ran. ms, plain ms, bound of the serving forward, the forward
                with statistics and the backward; the FMA body in the same
                call (in turns), the SDPA yardstick in q's type and the
                products the design needs (tc_units, tc_flops; tc_bound_ms
                in the kernels line). Then F3 (`f3`): fp32 at swin_large's
                train shape with every head at scale 60, both bodies
                through the autograd Function, dlogit_scale within TOL_F3
                of float64. Masked swin_large and swin_tiny stage 1 also
                under MMDE_ATTN_GRID=split (`split`): the tensor-core
                passes, then the head-split tensor-core K3, gradients at
                TOL_BWD, K3 bitwise over two launches and timed alone.
  serve         the flagship model (swin_base_v2 + decoder_v2, bfloat16,
                two 480x640 frames) built at full width from a seed,
                answering requests through mmde_tpu_torch.tools.infer.predict
                with the kernel launch counters read around them.
  train         the flagship trainer (mmde_tpu_torch.tools.train_steps):
                steps of make_train_step at 2 frame pairs, bfloat16, train
                mode, with the launch counters of every kernel read around
                every step; per-step loss and ms, images/s, peak memory;
                then a short deterministic run whose loss must fall.
  serve_large, train_large
                the same for swin_large_v2 + decoder_v2 (the flagship's
                windows, depths and decoder): stage 1 (C 192, 6 heads) runs
                the head-split tensor-core kernels, stages 2-4 the packed
                ones.
  serve_large_fp32, train_large_fp32
                swin_large_v2 in float32 (the JAX package's default type):
                one request, and 3 train steps at 2 frame pairs with peak
                memory; every head-split and packed launch a tensor-core
                kernel of dtype float32 (stage 1 K6' / K7', stages 2-4
                K1 / K2), none of the FMA bodies.
  parity        the whole model, attn_impl "cuda" against "torch", same
                weights and frames, float32 and bfloat16; every parity
                phase runs the model with stage 3 cut to 10 blocks
                (PARITY_DEPTHS), to keep the script inside its time.
  train_parity  one deterministic float32 train step, kernel path against
                plain path: loss and gradients of a named set of parameters.
  parity_large  both for swin_large_v2: the forward in float32 and
                bfloat16 (TOL_MODEL), the train step in float32 (gradients
                of stage-1 parameters among others, which only the
                head-split backward reaches) and in bfloat16 (the stage-1
                gradients, TOL_TRAIN_PARITY_BF16), both types through the
                head-split tensor-core kernels; every train-parity step on
                "cuda" launches tensor-core kernels only. Then
                (`block0_k7_dlogit_scale`) block 0's attention inputs of
                the bf16 step's kernel path, captured, and on them K7' and
                the plain bf16 path against float64: the dlogit_scale of K7'
                within twice the plain path's distance (or TOL_BWD's bf16
                limit).
  kernel_cases_slab
                the slab kernels (K8' forward, K9' backward: the windows
                read straight off the (B, Hp, Wp, 3C) map) against their
                plain versions, the backward also against float64
                autograd: the flagship's four stage maps served (1 frame
                pair, forward) and trained (2 pairs), swin_large's stages
                2-4 trained; bfloat16 and float32 (both the tensor-core
                kernels, the `_tc` slab entries, fp32 in three bf16 pieces
                with a hi + lo log-sum-exp; MXU_APART times nearer the fp32
                plain version than the "bf16"-mode one for the output and
                every gradient), float32 bias and mask, masked where the
                stage shifts, one clamped and one hot head. Each case
                checks which kernels its launches ran. ms, plain ms, bound,
                the SDPA yardstick in the map's type, the FMA body in the
                same call (in turns) and the products the design needs
                (tc_units; tc_bound_ms in the kernels line). Then F3
                (`f3`): fp32 at the flagship's stage-1 train shape with
                every unclamped head at scale 60, both bodies (forwards
                against the plain forward, the backward through the
                autograd Function against the plain backward and float64
                at TOL_BWD), dlogit_scale within TOL_F3 of float64.
  serve_slab, train_slab
                the flagship with attn_impl "cuda_slab" (the JAX package's
                "pallas_slab"): every block's attention on the map, 24
                tensor-core K8' launches a forward and 24 K8' (+lse) + 24
                K9' a step, none of the FMA slab, packed or head-split
                kernels.
  serve_slab_fp32, train_slab_fp32
                the same in float32 (the JAX package's default type): one
                request, and 3 train steps at 2 frame pairs with peak
                memory; every launch a tensor-core slab kernel of dtype
                float32 (24 K8' a request, 24 K8'+lse + 24 K9' a step).
  parity_slab   parity (float32 and bfloat16, both on the tensor-core slab
                kernels, every launch checked) and train_parity for
                "cuda_slab" against "torch".
  kernel_cases_resident
                K4, the single-pass backward MMDE_ATTN_GRID=bias_resident
                selects, at the flagship's four train shapes (bf16 and
                fp32 on the tensor-core K4, csrc/window_attention_bwd_
                resident_tc.cu; fp32 also with every head at scale 60,
                dlogit_scale within TOL_F3 of float64: F3), through the autograd
                Function under that grid (the forward before it: K1 without
                the log-sum-exp), against the plain backward and float64
                autograd; dbias bitwise equal over two launches; ms beside
                the FMA body's (bf16, in turns) and K2's in the same call,
                bound, the products' bound on the tensor cores (tc_units
                10), the SDPA backward yardstick.
  kernel_cases_w
                K5, W windows per block, at every (shape, W) the JAX rule
                gives the flagship's served and trained stages under
                MMDE_ATTN_W=auto (blocks with and without their mask) and
                at W = 2 on stage 1: bf16 on the tensor cores (the `_tc_w`
                entries; served in modes fold, fp32 and bf16, trained in
                fold), fp32 on the tensor-core K5 too (and an F3 case at
                stage 1, every head at scale 60, modes fp32 and fold, the
                backward at the rule's W and at 8: dlogit_scale within
                TOL_F3 of float64): forward against
                the plain forward of its mode, backward against the plain
                backward and float64 autograd (TOL_*, TOL_MXU_BF16), bf16
                MXU_APART times nearer its own mode's plain version than
                the other's; ms beside the FMA body's (bf16, in turns) and
                K1 / K2 at W = 1 in the same call, tc_units, SDPA; every
                backward also under "split" (the tensor-core K3 at one
                window after K5's passes).
  train_resident
                the trainer entry point (`tools.train_steps.main`, 4 steps)
                in a process of its own under MMDE_ATTN_GRID=bias_resident:
                step ms, peak bytes, and its launches, 24 K1 without lse
                and 24 tensor-core K4 a step, no K2.
  serve_w, train_w
                the flagship under MMDE_ATTN_W=auto (this script in a
                process of its own): 2 requests, 4 steps, every packed
                launch at the rule's W (the tensor-core K5 where W > 1),
                launches by kernel and W.
  train_parity_resident
                one fp32 step (TF32 off) under bias_resident (computed in
                train_resident's process, after its steps) against the
                default grid's: loss and gradients.
  probes        the layout probes (T1): `tools.probe_layouts.main()`, the six
                probes of the JAX package's tools/probe_mosaic.py on the
                card (csrc/probes.cu), each against its plain version; all
                must PASS. Launches counted around that run; then each
                kernel timed beside its plain version and a PyTorch call.
  variants      the attention-body variants (T2) at the tool's four stages:
                v0 / v1 / v3 are the production K1 launched with mxu =
                fp32 / fold / bf16 and must be bitwise equal to it; every
                variant within K1's bf16 tolerance of its plain version; ms.
  roofline      the unit-rate micro-kernels (T3, csrc/roofline.cu): each
                against its plain version, then `tools.roofline.microbench`
                (launches counted around it): rates by differencing two
                iteration counts, none above 105 % of its published peak;
                the port's K1 / K2 work at the flagship's train shapes as
                FMA-, MUFU- and bytes-bound times at those rates, beside the
                kernels' measured ms; the fixed buckets.
  kernel_cases_mxu
                K1 with the log-sum-exp, K2 and K5 under mxu = "fold" and
                "bf16" at flagship stages 1 and 4, train shape, float32 and
                bfloat16: forward against the plain forward of the same
                mode, backward against the plain backward and float64
                autograd of the plain forward in that mode; ms beside the
                "fp32" mode's in the same call.
  kernel_cases_tc
                the tensor-core K1 / K2 (csrc/window_attention_{fwd,bwd}
                _tc.cu) at the flagship's four stages, served (forward) and
                trained (forward with log-sum-exp, backward), bf16 and fp32
                (three bf16 pieces an operand), masked where the model
                masks, in modes fold, fp32 and bf16 (each type): against
                the plain version of the mode and float64 autograd (TOL_*,
                TOL_MXU_BF16), and MXU_APART times nearer the own mode's
                plain version than the other's (fold / fp32 against "bf16"):
                a kernel that quietly rounds operands fails. ms beside the
                FMA body's in the same call (in turns), plain ms, the SDPA
                yardstick, the bound and the products the design needs
                (tc_units, tc_flops); the backward also without dbias, and
                the tensor-core K3 of the mode (`k3`, as in
                kernel_cases_backward, at the mode's limits). The
                kernels line adds the tensor-core bound (tc_bound_ms): those
                products at the bf16 mma.sync rate the roofline phase
                measured in the same run.
  serve_fp32, train_fp32
                the flagship in float32 (the JAX package's default type):
                one request through tools.infer.predict, and 6 train steps
                at 2 frame pairs with peak memory; every attention launch
                the tensor-core K1 (+lse) / K2 with dtype float32 (2/2/18/2
                a forward and a backward), no FMA K1 / K2.
  train_parity_tiny
                one deterministic fp32 step of configs/
                convergence_gate_swin.yaml's model (swin_tiny_v2 +
                decoder_v2, windows 6/6/6/3, 96x128, 2 frame pairs), kernel
                path against plain path at TOL_TRAIN_PARITY: stages 3-4
                packed at N = 36 and N = 9 (below one 64-row tile) and
                stages 1-2 head-split, all on the tensor cores.
  serve_mxu, train_mxu
                the flagship under MMDE_ATTN_MXU=bf16 (this script in a
                process of its own): one request and 3 train steps, every
                packed launch in the bf16 mode. The processes of
                train_resident, serve_w / train_w and these run side by
                side: their request and step times share the card
                (`shared_card`).
  train_split   after those three: the bf16 flagship trainer at full width
                (2 frame pairs, 1 warm and 2 timed steps) in a process of
                its own under MMDE_ATTN_GRID=split: step ms, peak bytes,
                launches (tensor-core K1+lse, K2 and K3 only: 72 a step),
                one step's device ms by kernel group with K3's own sum, and
                one more step with every attention backward launched twice
                on the same inputs: dbias (and dqkv, dlogit_scale) bitwise
                equal, block by block; then the same trainer on the slab
                path (`slab`): one step (K8'+lse, K9' without atomics and
                K3 over MapRows, 24 each), one with every slab backward
                launched twice, all three gradients bitwise, block by block.
  loop          python -m mmde_tpu_torch.tools.train (in this process) on
                configs/flagship_synth.yaml's model (bf16, 480x640, full
                depth), in a temporary directory removed at the end: 2
                frame pairs a step, 2 epochs of 3 steps, a checkpoint and
                validation on the 8 synthetic held-out samples every epoch;
                the saved epoch 2 restored into a fresh trainer and held
                bitwise to the state the run ended with (model, optimizer
                moments and count, generator); the CLI again in the same
                log directory to 3 epochs (RESUME_FROM "auto"): it must
                resume at epoch 3 with the optimizer's count at 6. Launches
                read around each run (K1+lse / K2 once a block a step, K1
                once a block a held-out sample, tensor-core kernels only);
                images/s from the loop's own log lines, peak bytes, the
                train and validation scalars, checkpoint bytes, save and
                restore seconds, free disk before and after.
  eval_ckpt     python -m mmde_tpu_torch.tools.eval --ckpt <loop's ckpt/>
                --flip-tta --shift-window-tta: the best checkpoint (not the
                latest) must be the one restored; the metric table; the
                TTA's K1 launches (2 crops of 480x480 a sample, flipped:
                48 a sample); then one request served as tools.infer --ckpt
                serves it (infer.build, ckpt.io.restore_eval, predict);
                then (`save`) tools.eval on 2 samples with --save-pngs and
                --save-viz: the 16-bit PNGs against that model's eval step
                (depth x 1000 truncated, <= 1 count), the panels' shape.
  deterministic under torch.use_deterministic_algorithms(True,
                warn_only=True): the stage-1 attention backward of the
                flagship (packed) and of swin_large (head-split), bf16, 2
                frame pairs, unmasked and masked, twice on the same inputs:
                dqkv, dlogit_scale and dbias bitwise equal, K3 launched, no
                atomics asked of the passes; in strict mode the slab
                backward on flagship stage 1's map, bf16 and fp32, the same
                checks through K3 over MapRows.
  kernel_cases_models
                the attention kernels at the new paths' own shapes, float32:
                K1 served at the single-frame GLPDepth's (one 480x640
                image) against its plain version; K1+lse and K2 at
                void_downscale16_completion's (4 pairs at 480x480, stages
                1-3) against the plain forward / backward and float64.
  serve_cnn, train_cnn
                configs/void.yaml's model at full width (cnn_transformer_
                multi_scale, resnet50, hidden 512, 8 heads, ff 4096, 6
                layers; decoder_v1, float32) from seed 7: requests of a
                480x480 pair (ms, peak bytes) and the card's fp32 forward,
                TF32 off, cuDNN on, against the same weights on the CPU
                (depth atol 1e-3, pose 1e-4; beside it cuDNN off and the
                CPU's own witnesses, also for the drawn weights before
                `condition_cnn`); train steps at 4 pairs (ms, images/s,
                peak bytes). Its attention is global, plain PyTorch: no
                window-attention launch.
  train_completion
                configs/void_downscale16_completion.yaml's model at full
                width (glpdepth_scale16 over swin_base_v2 stages 1-3, sparse
                depth fused: 5 input channels, float32) on 4 pairs of
                480x480 frames with sparse depth: train steps (K1+lse / K2
                on the tensor cores, 22 each a step), one deterministic step
                against the plain path (TOL_TRAIN_PARITY), then
                tools.train --synthetic (3 steps, validation, a checkpoint)
                and tools.eval --flip-tta of it (sparse depth mirrored).
  serve_glpdepth
                the single-frame GLPDepth over swin_base_v2 (float32, full
                depth): requests of one 480x640 frame (pred_d; K1 24 a
                request) and a flip-averaged one, then two steps of
                train.single_frame.make_single_train_step on 4 frames.
  codec         the data path's host library (csrc/preprocess.cpp, built
                with g++ in the background during env): the committed
                JPEGs of tests/fixtures/jpeg against cv2's decodes saved
                beside them, at the CPU tests' limits (<= 2 for 4:4:4 and
                grey, <= 3 subsampled), and the two 480x640 frames; PNG
                write then read, bitwise, grey / RGB / RGBA at 8 and 16 bits
                under every row filter; the two frames' decodes against
                cv2's at every 13th pixel (frames_cv2_stride13.npz);
                VOID's undistortion maps at 640x480
                against the closed form in float64 (1e-4 px) and inside the
                source image (0.05 px); decode / encode ms of VOID-sized files, the
                host's CPU count.
  data_void     mmde_tpu_torch.testing.write_void_release at 640x480 (6
                scenes x 48 frames, IMU at 200 Hz, the test scene's IMU in
                raw.bag only) in a temporary data root; VoidV3 train (crop
                480x480) and test samples: keys, shapes, dtypes, poses
                against the generating poses, IMU counts against the
                generating stamps; the reader's pairs/s through the
                DataLoader (4-pair batches, start-up outside the window)
                with 1 thread (10 batches) and with void.yaml's 8 workers
                (the rest of an epoch, 208 pairs).
  train_void    python -m mmde_tpu_torch.tools.train --config
                configs/void.yaml (pointed at the tree; cnn model, 480x480
                crop, batch 4, 8 workers), one epoch (53 steps),
                validation on the test list, a checkpoint: step ms between
                batches, the loop's wait for the loader and its share of
                the steps after WARMUP_STEPS, the pairs/s the median step
                needs; then
                tools.eval of the checkpoint on the test list. No
                window-attention launch.
  train_void_flagship
                flagship_synth.yaml's model (bf16, 480x640) with
                DATASET_NAME void, 2 pairs, 3 steps through tools.train: its
                launches the tensor-core K1+lse / K2 once a block a step.
  data_mixed    a KITTI tree at 375x1242 through KITTIEigen (KB crop to
                352x1216), an NYU tree of the committed 480x640 JPEGs
                through NYUDepthV2Pairs, build_datasets of
                configs/mixed_bf16_dp.yaml over NYU + KITTI + VOID: a batch
                of each source at 480x640.
  infer_cli     python -m mmde_tpu_torch.tools.infer (in this process,
                flagship_synth.yaml's model, --weights of seed-7 drawn
                weights, --colormap) on a folder of a 487x651 PNG and a
                480x640 JPEG frame: each 16-bit depth PNG read back and held
                to tools.infer.predict on the frame read another way, within
                INFER_MM; each _color.png to utils.viz.colorize_depth of
                that depth (COLOR_MISMATCH); K1 launched.
  pretrained    a SimMIM-style swin_base_v2 checkpoint (module.encoder.
                prefixes, the static buffers, mask_token, a window-12
                discrete table) through ckpt.pretrained.load_pretrained into
                nyu_swin_decoder_v1.yaml's model (bitwise, the report) and,
                for the table, into a stage-1 encoder with rpe_table_type
                "none" at window 30 (bitwise the float64 geo resampling);
                then 2 steps through tools.train with that config on an NYU
                tree, PRETRAINED_SWIN the file: "full" remat, K1+lse twice
                a block a step, K2 once.
  remat         the bf16 flagship trainer (2 pairs, deterministic) under
                each remat policy (none, full, mlp_only, attn_out,
                attn_qkv) from the same weights and batch: the first
                step's loss and gradients (under deterministic algorithms:
                K3 for dbias) against "none"'s, its K1+lse / K2 / K3
                launches (the replays), then peak bytes and median step ms
                of 3 steps as a user runs them.
  profile_step  python -m mmde_tpu_torch.tools.profile_step on the flagship
                (2 pairs, 2 steps): device ms a step by kernel group.
  kernels       per kernel and shape of each served path (forward) and
                each trained path (forward with statistics, backward):
                launches on that path (the packed stages of the bf16 models
                and of the fp32 flagship (serve_fp32 / train_fp32, dtype
                float32, kernel_cases_tc's fp32 numbers, tc_units 12 / 30),
                fp32 swin_large's (serve_large_fp32 / train_large_fp32,
                dtype float32: kernel_cases_headsplit's and kernel_cases[_
                backward]'s fp32 numbers), the fp32 flagship's slab path
                (serve_slab_fp32 / train_slab_fp32, dtype float32:
                kernel_cases_slab's fp32 numbers):
                window_attention_fwd_tc[+lse] / window_attention_bwd_tc, the
                head-split stages window_attention_headsplit_fwd_tc[+lse] /
                window_attention_headsplit_bwd_tc, the slab path's
                window_attention_slab_fwd_tc[+lse] /
                window_attention_slab_bwd_tc, and none of the FMA
                bodies), error, ms, plain ms, bound, and the
                nearest library call's time (in qkv's type:
                F.scaled_dot_product_attention on the normalised, scaled q
                and k with bias + mask as its attn_mask; the normalisation
                and the SDPA backend beside it; for a backward, that call's
                backward under autograd). K4's and K5's entries carry the
                launches of train_resident, serve_w and train_w; the
                tensor-core K3's (window_attention_dbias_tc) those of
                train_split, its numbers kernel_cases_backward's; K3 over
                MapRows (window_attention_slab_dbias_tc) those of
                train_split's slab step, its numbers kernel_cases_slab's
                `k3`; the new paths' K1 / K1+lse / K2 (a "path" key) those
                of serve_glpdepth and train_completion, their numbers
                kernel_cases_models' (the GLPDepth step's shapes:
                kernel_cases_backward's fp32 1-pair cases); T1-T3's
                the launches of the tool runs above, K1 / K2 in the bf16
                mode those of train_mxu; the entries with a "path" key
                carry the loop phase's launches (its first run: 6 steps,
                16 held-out forwards).
  profile_resident, profile_w
                (--profile only) Path A and Path B, a served request and a
                train step each, device time by kernel group, on the
                flagship profile's model and trainer with the module
                settings their variables give (PROFILED_PATHS).
  profile_fp32, profile_large_fp32, profile_slab_fp32
                (--profile only) the fp32 flagship's, fp32 swin_large's and
                the fp32 flagship slab path's request and train step,
                device time by kernel group.

then the `nvidia-smi --query-gpu=name,power.limit` line and a last line
{"ok": true, "device": {...}}. Any failing phase raises: the script exits
non-zero and prints no last line. It needs a CUDA card and imports nothing of
JAX or the JAX package.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

# published H100 SXM peaks used for the roofline bound (fp32: FMA outside
# the tensor cores; bf16: dense tensor-core rate), and CUDA-event timing
from mmde_tpu_torch.tools.card import HBM_BYTES_PER_S, PEAK_FLOPS, time_ms

KERNEL_SOURCE = "mmde_tpu_torch/csrc/window_attention_fwd.cu"
# K1 and K2 on the tensor cores: every packed launch (bf16 and fp32) at one
# window per block
KERNEL_TC_SOURCE = "mmde_tpu_torch/csrc/window_attention_fwd_tc.cu"
KERNEL_TC_BWD_SOURCE = "mmde_tpu_torch/csrc/window_attention_bwd_tc.cu"
KERNEL_REPLACES = ("mmde_tpu/ops/window_attention_packed.py:283 "
                   "(_fwd_body; pallas_call :454)")
KERNEL_BWD_SOURCE = "mmde_tpu_torch/csrc/window_attention_bwd.cu"
KERNEL_BWD_REPLACES = ("mmde_tpu/ops/window_attention_packed.py:473 "
                       "(_bwd_body; pallas_call :1103)")
# the head-split entry points live in the same sources (bf16: the
# tensor-core ones, KERNEL_TC_SOURCE / KERNEL_TC_BWD_SOURCE)
KERNEL_HS_REPLACES = ("mmde_tpu/ops/window_attention_pallas.py:62 "
                      "(_kernel; pallas_call :132)")
KERNEL_HS_BWD_REPLACES = ("mmde_tpu/ops/window_attention_pallas.py:146 "
                          "(_bwd_kernel; pallas_call :310)")
# K5, W windows per block, has kernels of its own in the same two sources
KERNEL_W_REPLACES = ("mmde_tpu/ops/window_attention_packed.py:283 "
                     "(_fwd_body with w > 1, W from _choose_w :191; "
                     "pallas_call :454)")
KERNEL_W_BWD_REPLACES = ("mmde_tpu/ops/window_attention_packed.py:473 "
                         "(_bwd_body with w > 1, W from _choose_w :191; "
                         "pallas_call :1103)")
# K4, the single-pass backward, has a source of its own (the bf16 path's,
# on the tensor cores)
KERNEL_RESIDENT_TC_SOURCE = ("mmde_tpu_torch/csrc/"
                             "window_attention_bwd_resident_tc.cu")
# N x N x 32 products the tensor-core K4 needs: S and dP in each of its two
# sweeps, dq, dk and dv each on a split operand
K4_TC_UNITS = 10.0
# fp32 qkv: seven products of two operands in three bf16 pieces, six piece
# products each (window_attention_tc.cuh)
K4_FP32_TC_UNITS = 42.0
KERNEL_RESIDENT_REPLACES = ("mmde_tpu/ops/window_attention_packed.py:636 "
                            "(_bwd_body_v4; pallas_call :800)")
# the two grid modes of K2 (K4 is "bias_resident", compared on its own)
WINDOW_GRID_MODES = ("window_resident", "split")
# and so do the slab entry points
# K3 (MMDE_ATTN_GRID=split) on the tensor cores, in the backward TC source
KERNEL_K3_REPLACES = ("mmde_tpu/ops/window_attention_packed.py:842 "
                      "(_dbias_body; _pallas_dbias :912; pallas_call :989)")
KERNEL_SLAB_REPLACES = ("mmde_tpu/ops/window_attention_slab.py:109 "
                        "(_fwd_body; pallas_call :264)")
KERNEL_SLAB_BWD_REPLACES = ("mmde_tpu/ops/window_attention_slab.py:140 "
                            "(_bwd_body; pallas_call :317)")

# kernel-vs-plain tolerances on the card
TOL_FP32_MAX_ABS = 5e-5     # fp32 sums in another order + expf vs exp
TOL_BF16_REL_L2 = 4e-3      # both round one fp32 result to bf16 (2^-9 ulp)

# backward kernel vs the plain backward AND vs float64 autograd of the plain
# forward, rel-L2 per output (max abs is printed beside it).
# fp32: the kernel, the plain backward and float64 differ by the order of
# fp32 sums (and expf vs exp), and the kernel rebuilds p from the saved
# log-sum-exp: for a head at scale 100 that number is ~1e2, and half an fp32
# ulp of it (4e-6) is a relative error of every p of its row (measured:
# dqkv 8e-6 where the plain backward has 3e-6). dlogit_scale is a sum of
# B_*N*N signed terms that cancel, so its rounding shows at up to 5e-5 of
# its value.
# bf16: dqkv and dbias leave in bf16 (one rounding, 2^-9 relative, rel-L2
# ~1.1e-3 against float64 on its own) after fp32 accumulation with __expf;
# dlogit_scale is fp32 but built from bf16-rounded g, q, k, v.
TOL_BWD = {
    "float32": {"dqkv": 2e-5, "dbias": 2e-5, "dlogit_scale": 2e-4},
    "bfloat16": {"dqkv": 4e-3, "dbias": 4e-3, "dlogit_scale": 1e-2},
}

# whole-model tolerances, kernel path vs plain path (see phase_parity)
TOL_MODEL = {
    # fp32: the two paths differ only in the order of the attention sums;
    # 24 blocks amplify ~1e-6 per block
    # (measured: depth 4e-6, pose 7e-7)
    "float32": {"depth": 2e-4, "pose": 2e-5},
    # bf16: the plain path rounds the probabilities to bf16 before the
    # second product, the kernel keeps them in fp32; the difference is one
    # bf16 rounding per block carried through 24 blocks and the decoder
    # (measured at depth std 1.1: depth max 0.16, pose 0.006)
    "bfloat16": {"depth": 0.5, "depth_mean": 0.05, "pose": 0.03},
}


# seconds from one emitted line to the next, by tag: each phase's time
PHASE_SECONDS: dict = {}
_LAST_EMIT = [time.time()]


def emit(tag: str, obj: dict) -> None:
    print(json.dumps({tag: obj}), flush=True)
    now = time.time()
    PHASE_SECONDS[tag] = round(now - _LAST_EMIT[0], 1)
    _LAST_EMIT[0] = now


def stage_shapes(backbone: str = "swin_base_v2", h: int = 480, w: int = 640,
                 batch: int = 1, attn_impl: str = "cuda"):
    """(B_, N, C, nH, nW, blocks, layout) the attention kernels see per stage
    for `batch` frame pairs at h x w, re-derived from the flagship config
    with `backbone`'s widths; layout = the kernel the stage takes under
    `attn_impl` ("packed" / "headsplit" / "slab", as the model chooses);
    "images", "padded" and "ws" give the slab kernels' map."""
    from mmde_tpu_torch.models.two_frame import SWIN_VARIANTS
    from mmde_tpu_torch.ops.window_attention_packed import packed_layout_ok
    from mmde_tpu_torch.ops.window_attention_slab import slab_plan
    embed, heads = SWIN_VARIANTS[backbone.split("_")[1]]
    windows, shift = (30, 30, 30, 15), (True, True, False, False)
    depths = (2, 2, 18, 2)
    out = []
    mh, mw = h // 4, w // 4
    for i in range(4):
        ws = windows[i]
        hp, wp = -(-mh // ws) * ws, -(-mw // ws) * ws
        nw = (hp // ws) * (wp // ws)
        C = embed * 2 ** i
        dh = C // heads[i]
        if (attn_impl == "cuda_slab"
                and slab_plan(ws, wp, heads[i], dh, C) is not None):
            layout = "slab"
        elif packed_layout_ok(ws * ws, heads[i], dh, C):
            layout = "packed"
        else:
            layout = "headsplit"
        out.append({"model": backbone, "stage": i + 1, "map": [mh, mw],
                    "padded": [hp, wp], "images": 2 * batch, "ws": ws,
                    "B_": 2 * batch * nw, "N": ws * ws, "C": C,
                    "nH": heads[i],
                    "nW": nw if (shift[i] and depths[i] > 1) else 0,
                    "blocks": depths[i], "layout": layout})
        mh, mw = (mh + 1) // 2, (mw + 1) // 2
    return out


def kernel_bound(B_, N, C, nH, nW, dtype: torch.dtype, bias_dtype,
                 stats: bool = False) -> dict:
    """Roofline bound of the forward; `stats` adds the log-sum-exp output the
    training entry point writes."""
    esz = torch.empty((), dtype=dtype).element_size()
    bsz = torch.empty((), dtype=bias_dtype).element_size()
    nbytes = (B_ * N * 3 * C * esz          # qkv read once
              + B_ * N * C * esz            # out written once
              + nH * N * N * bsz            # bias read once
              + nW * N * N * bsz            # mask read once
              + nH * 4                      # logit_scale
              + (B_ * nH * N * 4 if stats else 0))  # log-sum-exp written once
    flops = 4 * B_ * nH * N * N * (C // nH)     # two products, 2 flops/MAC
    exps = B_ * nH * N * N
    name = str(dtype).replace("torch.", "")
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[name] * 1e3
    return {"bytes": nbytes, "flops": flops, "exps": exps,
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def make_kernel_inputs(shape: dict, dtype, with_mask: bool, gen,
                       sigmoid_bias: bool = True):
    dev = "cuda"
    B_, N, C, nH = shape["B_"], shape["N"], shape["C"], shape["nH"]
    nW = max(shape["nW"], 2 if B_ % 2 == 0 else 1) if with_mask else 0
    qkv = torch.randn((B_, N, 3 * C), device=dev, generator=gen).to(dtype)
    ls = (torch.randn((nH, 1, 1), device=dev, generator=gen) * 0.5 + 2.0)
    ls[0] = 5.0                                    # above the ln(100) clamp
    raw = torch.randn((nH, N, N), device=dev, generator=gen)
    bias = (16.0 * torch.sigmoid(raw)) if sigmoid_bias else raw * 2.0
    bias = bias.to(dtype)                 # bf16 models stream bias in bf16
    mask = None
    if with_mask:
        m = torch.rand((nW, N, N), device=dev, generator=gen) < 0.3
        eye = torch.eye(N, device=dev, dtype=torch.bool)
        mask = torch.where(m & ~eye, -100.0, 0.0).to(dtype).contiguous()
    return qkv, ls, bias, mask


def compare_kernel(shape, dtype, with_mask, gen, *, maxfree=True,
                   timed=True) -> dict:
    from mmde_tpu_torch.ops import window_attention_packed as wap
    qkv, ls, bias, mask = make_kernel_inputs(shape, dtype, with_mask, gen,
                                             sigmoid_bias=maxfree)
    nH = shape["nH"]
    with torch.no_grad():
        got = wap.cosine_window_attention_packed(qkv, ls, bias, mask,
                                                 num_heads=nH,
                                                 maxfree=maxfree)
        torch.cuda.synchronize()
        want = wap.cosine_window_attention_packed_plain(qkv, ls, bias, mask,
                                                        num_heads=nH)
        torch.cuda.synchronize()
        g, w = got.float(), want.float()
        if not bool(torch.isfinite(g).all()):
            raise RuntimeError(f"kernel output not finite at {shape} {dtype}")
        max_abs = float((g - w).abs().max())
        rel_l2 = float((g - w).norm() / w.norm())
        rec = {"model": shape["model"], "stage": shape["stage"],
               "B_": shape["B_"], "N": shape["N"], "C": shape["C"], "nH": nH,
               "nW": mask.shape[0] if mask is not None else 0,
               "dtype": str(dtype).replace("torch.", ""),
               "softmax": "maxfree" if maxfree else "rowmax",
               "max_abs_err": max_abs, "rel_l2_err": rel_l2}
        if dtype == torch.float32:
            ok = max_abs <= TOL_FP32_MAX_ABS
            rec["tolerance"] = {"max_abs": TOL_FP32_MAX_ABS}
        else:
            ok = rel_l2 <= TOL_BF16_REL_L2
            rec["tolerance"] = {"rel_l2": TOL_BF16_REL_L2}
        if not ok:
            raise RuntimeError(f"kernel disagrees with its plain version: "
                               f"{json.dumps(rec)}")
        if timed:
            rec["ms"] = time_ms(lambda: wap.cosine_window_attention_packed(
                qkv, ls, bias, mask, num_heads=nH, maxfree=maxfree))
            if dtype == torch.float32:
                # the tensor-core kernel and the fp32-FMA body in turns
                def fwd(fma):
                    return lambda: wap._launch_forward(
                        qkv, ls, bias, mask, nH, maxfree, False, _fma=fma)
                turns = [time_ms(fwd(False)), time_ms(fwd(True)),
                         time_ms(fwd(True)), time_ms(fwd(False))]
                rec.update({"ms_launch": (turns[0] + turns[3]) / 2,
                            "fma_ms": (turns[1] + turns[2]) / 2,
                            "ms_turns": turns})
            rec["plain_ms"] = time_ms(
                lambda: wap.cosine_window_attention_packed_plain(
                    qkv, ls, bias, mask, num_heads=nH), reps=5, warm=1)
            rec.update(kernel_bound(shape["B_"], shape["N"], shape["C"], nH,
                                    rec["nW"], dtype, bias.dtype))
            # the yardstick in qkv's type
            rec.update(library_yardstick(*wap._split_heads(qkv, 3, nH), ls,
                                         bias, mask))
    return rec


def backward_bound(B_, N, C, nH, nW, dtype: torch.dtype, bias_dtype,
                   lse: bool = True) -> dict:
    """Roofline bound of the backward as a function: every input read once,
    every output written once in the type it leaves in (dbias in the bias's
    type); `lse`: the saved log-sum-exp is an input (K2, K5; K4 takes none).
    What the design moves besides is not in the bound: the fp32 (nH, N, N)
    buffer dbias is summed in before its cast, the scratch the dq pass hands
    to the dk/dv pass (delta, 4 bytes per row, and the per-block partial
    sums of dlogit_scale), K4's fp32 dk/dv scratch and dbias partials."""
    esz = torch.empty((), dtype=dtype).element_size()
    bsz = torch.empty((), dtype=bias_dtype).element_size()
    nbytes = (B_ * N * 3 * C * esz          # qkv read once
              + B_ * N * C * esz            # g read once
              + B_ * N * 3 * C * esz        # dqkv written once
              + nH * N * N * bsz            # bias read once
              + nW * N * N * bsz            # mask read once
              + (B_ * nH * N * 4 if lse else 0)   # saved log-sum-exp
              + nH * N * N * bsz            # dbias written once
              + 2 * nH * 4)                 # logit_scale, dlogit_scale
    # five N x N x Dh products: q^k^T, g v^T, p^T g, ds k^, ds^T q^
    flops = 10 * B_ * nH * N * N * (C // nH)
    name = str(dtype).replace("torch.", "")
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[name] * 1e3
    return {"bytes": nbytes, "flops": flops,
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def dbias_bound(B_, N, C, nH, nW, dtype: torch.dtype, bias_dtype) -> dict:
    """Roofline bound of K3's function, dbias alone: qkv, g, the saved
    log-sum-exp and delta read once, bias and mask read once, dbias written
    once in the bias's type; two N x N x Dh products (q^k^T, g v^T)."""
    esz = torch.empty((), dtype=dtype).element_size()
    bsz = torch.empty((), dtype=bias_dtype).element_size()
    nbytes = (B_ * N * 4 * C * esz + 2 * B_ * nH * N * 4
              + (2 * nH + nW) * N * N * bsz)
    flops = 4 * B_ * nH * N * N * (C // nH)
    name = str(dtype).replace("torch.", "")
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[name] * 1e3
    return {"bytes": nbytes, "flops": flops,
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def check_forward(got: torch.Tensor, want: torch.Tensor, dtype,
                  where: dict) -> dict:
    """The forward kernel's output against the plain forward's, at the
    tolerances of compare_kernel; raises when they disagree."""
    g, w = got.float(), want.float()
    rec = {"max_abs_err": float((g - w).abs().max()),
           "rel_l2_err": float((g - w).norm() / w.norm())}
    if dtype == torch.float32:
        ok = rec["max_abs_err"] <= TOL_FP32_MAX_ABS
        rec["tolerance"] = {"max_abs": TOL_FP32_MAX_ABS}
    else:
        ok = rec["rel_l2_err"] <= TOL_BF16_REL_L2
        rec["tolerance"] = {"rel_l2": TOL_BF16_REL_L2}
    if not (ok and bool(torch.isfinite(g).all())):
        raise RuntimeError(f"forward kernel (training entry point) disagrees "
                           f"with its plain version: {json.dumps(rec)} at "
                           f"{json.dumps(where)}")
    return rec


def _errs(got: torch.Tensor, want: torch.Tensor) -> dict:
    g, w = got.double(), want.double()
    return {"max_abs": float((g - w).abs().max()),
            "rel_l2": float((g - w).norm() / w.norm().clamp_min(1e-300))}


def library_yardstick(q, k, v, ls, bias, mask, g=None) -> dict:
    """The nearest PyTorch call, timed beside a kernel and used nowhere in
    the port: F.scaled_dot_product_attention on q^ * scale_h, k^ and v with
    bias + mask as attn_mask (in v's type), q^ / k^ the L2-normalised q / k
    and scale_h the head's clamped temperature. q, k, v: (B_, nH, N, 32)
    views as the kernel reads them. The normalisation is timed apart
    (`library_norm_ms`); the additive mask is built once, outside the
    timing. With g (B_, nH, N, 32), also its backward under autograd
    (dq^, dk^, dv; no dbias, no normalisation VJP). Returns the times, the
    SDPA backend PyTorch chose for these inputs, and the call's rel-L2
    against the plain forward in float32 (it rounds bias + mask to v's
    type)."""
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend
    from mmde_tpu_torch.ops.window_attention import MAX_LOGIT_SCALE
    from mmde_tpu_torch.ops.window_attention_headsplit import (
        cosine_window_attention_headsplit_plain)
    B_, nH, N, _ = q.shape
    dt = v.dtype

    def normalise():
        scale = torch.exp(torch.clamp(ls.reshape(1, nH, 1, 1),
                                      max=MAX_LOGIT_SCALE))
        qf, kf = q.float(), k.float()
        qn = qf * torch.rsqrt((qf * qf).sum(-1, keepdim=True) + 1e-12)
        kn = kf * torch.rsqrt((kf * kf).sum(-1, keepdim=True) + 1e-12)
        return (qn * scale).to(dt), kn.to(dt)

    with torch.no_grad():
        qn, kn = normalise()
        vv = v.contiguous()
        if mask is None:
            am = bias.to(dt)[None].expand(B_, nH, N, N)
        else:
            nW = mask.shape[0]
            am = (bias[None] + mask[:, None]).to(dt)
            am = am[None].expand(B_ // nW, nW, nH, N, N).reshape(B_, nH, N, N)

        def call():
            return F.scaled_dot_product_attention(qn, kn, vv, attn_mask=am,
                                                  scale=1.0)
        want = cosine_window_attention_headsplit_plain(q, k, v, ls, bias,
                                                       mask)
        got = call()
        rec = {"library_call": "F.scaled_dot_product_attention(q^ * scale_h,"
                               " k^, v, attn_mask=bias + mask, scale=1)",
               "library_backend": SDPBackend(torch._fused_sdp_choice(
                   qn, kn, vv, am, 0.0, False, scale=1.0)).name,
               "library_rel_l2_vs_plain": float(
                   (got.float() - want.float()).norm() / want.float().norm()),
               "library_ms": time_ms(call),
               "library_norm_ms": time_ms(normalise)}
        del want, got
    if g is not None:
        leaves = [t.detach().clone().requires_grad_() for t in (qn, kn, vv)]
        out = F.scaled_dot_product_attention(*leaves, attn_mask=am, scale=1.0)
        gc = g.contiguous()
        rec["library_bwd_ms"] = time_ms(lambda: torch.autograd.grad(
            out, leaves, gc, retain_graph=True), reps=8, warm=2)
        del out, leaves
    return rec


def _float64_grads(qkv, ls, bias, mask, g, nH, mxu=None):
    """Autograd of the plain forward in float64: the independent truth (in
    precision mode `mxu`: its bf16 roundings are in the forward, and
    autograd passes gradients through them unchanged)."""
    from mmde_tpu_torch.ops import window_attention_packed as wap
    leaves64 = [t.detach().double().requires_grad_() for t in (qkv, ls, bias)]
    out64 = wap.cosine_window_attention_packed_plain(
        leaves64[0], leaves64[1], leaves64[2],
        None if mask is None else mask.double(), num_heads=nH,
        compute_dtype=torch.float64, mxu=mxu)
    truth = torch.autograd.grad(out64, leaves64, g.double())
    del out64, leaves64
    return truth


def _check_grads(got, plain, truth, name: str, what: str,
                 clamped: bool = True) -> dict:
    """dqkv, dlogit_scale, dbias of a backward kernel against the plain
    backward and float64 autograd at TOL_BWD[name] (see _check_against)."""
    return _check_against(got, {"vs_plain": (plain, TOL_BWD[name]),
                                "vs_float64": (truth, TOL_BWD[name])}, what,
                          clamped)


def _case_head(shape, dtype, mask) -> dict:
    return {"model": shape["model"], "stage": shape["stage"],
            "B_": shape["B_"], "N": shape["N"], "C": shape["C"],
            "nH": shape["nH"],
            "nW": mask.shape[0] if mask is not None else 0,
            "dtype": str(dtype).replace("torch.", "")}


def check_k3(got, again, own, other, truth, tol_plain, tol_truth,
             mxu: str, what: str) -> dict:
    """The tensor-core K3's fp32 dbias `got` against K3's plain version in
    its own mode (`own`, fp32) at `tol_plain` and float64 autograd
    (`truth`) at `tol_truth` (rel-L2), MXU_APART times nearer `own` than
    the other mode's plain version (`other`; _nearer), and bitwise equal to
    a second launch on the same inputs (`again`); raises on a miss or a
    value that is not finite."""
    rec = {"mxu": mxu, "vs_plain": _errs(got, own),
           "vs_float64": _errs(got, truth),
           "tolerance_rel_l2": {"vs_plain": tol_plain,
                                "vs_float64": tol_truth},
           "bitwise_equal_over_two_launches": bool(torch.equal(got, again))}
    _nearer(rec, "dbias", got, own, other)
    if not (bool(torch.isfinite(got).all())
            and rec["bitwise_equal_over_two_launches"]
            and rec["vs_plain"]["rel_l2"] <= tol_plain
            and rec["vs_float64"]["rel_l2"] <= tol_truth):
        raise RuntimeError(f"tensor-core K3 at {what}: {json.dumps(rec)}")
    return rec


def k3_turns(tc, fma) -> dict:
    """K3 alone, the tensor-core kernel and its FMA body in turns (kernel,
    FMA, FMA, kernel), each launched straight on its own dq pass's delta."""
    t = [time_ms(f, reps=8, warm=2) for f in (tc, fma, fma, tc)]
    return {"k3_ms": (t[0] + t[3]) / 2, "k3_fma_ms": (t[1] + t[2]) / 2,
            "k3_ms_turns": t}


def compare_backward(shape, dtype, gen, *, timed=True) -> dict:
    """K2 (both dbias grid modes) against the plain backward and against
    float64 autograd of the plain forward, at one stage shape; and the
    output of the forward that recorded the graph (K1 through its training
    entry point, which also writes the log-sum-exp) against the plain
    forward, under rec["forward"]. Under "split" the tensor-core passes run
    without dbias and the tensor-core K3 after them (`k3`: its fp32 dbias
    against K3's plain version and float64 at TOL_BWD, MXU_APART times
    nearer than the "bf16"-mode plain version, bitwise over two launches;
    timed alone on the dq pass's delta in turns with its FMA body, beside
    its plain version, its bound and its products' bound). Head 0 sits
    above the ln(100) clamp (its dlogit_scale must be exactly 0), head 1 is
    hot (scale e^4 = 54.6 > 30: the forward's row-maximum softmax form)."""
    from mmde_tpu_torch.ops import window_attention_packed as wap
    with_mask = shape["nW"] > 0
    qkv, ls, bias, mask = make_kernel_inputs(shape, dtype, with_mask, gen)
    ls[1] = 4.0
    nH = shape["nH"]
    g = torch.randn((shape["B_"], shape["N"], shape["C"]), device="cuda",
                    generator=gen).to(dtype)
    name = str(dtype).replace("torch.", "")
    rec = _case_head(shape, dtype, mask)
    rec["tolerance_rel_l2"] = TOL_BWD[name]

    def kernel_grads(grid_mode):
        leaves = [t.detach().clone().requires_grad_() for t in (qkv, ls, bias)]
        before = dict(wap.LAUNCHES_BY_KERNEL)
        out = wap.cosine_window_attention_packed(
            leaves[0], leaves[1], leaves[2], mask, num_heads=nH,
            grid_mode=grid_mode)
        out.backward(g)
        torch.cuda.synchronize()
        # both types on the tensor cores; "split": the tensor-core K3 after
        # the passes
        _tc_launched(before, dict(
            {"window_attention_fwd_tc+lse": 1, "window_attention_bwd_tc": 1},
            **({"window_attention_dbias_tc": 1} if grid_mode == "split"
               else {})), f"K2 ({grid_mode}) at {json.dumps(rec)}")
        return [t.grad for t in leaves], out.detach()

    with torch.no_grad():
        plain = wap.cosine_window_attention_packed_backward_plain(
            qkv, ls, bias, mask, g, num_heads=nH)
        want_out = wap.cosine_window_attention_packed_plain(
            qkv, ls, bias, mask, num_heads=nH)
    truth = _float64_grads(qkv, ls, bias, mask, g, nH)
    # the plain backward itself must agree with autograd, or it is no oracle
    names = ("dqkv", "dlogit_scale", "dbias")
    rec["plain_vs_float64"] = {n: _errs(p, t)
                               for n, p, t in zip(names, plain, truth)}
    for grid_mode in WINDOW_GRID_MODES:
        got, out = kernel_grads(grid_mode)
        if grid_mode == wap.DEFAULT_GRID_MODE:
            rec["forward"] = check_forward(out, want_out, dtype, rec)
        rec[grid_mode] = _check_grads(
            got, plain, truth, name,
            f"backward kernel ({grid_mode}) at {json.dumps(rec)}")
    dflt = rec[wap.DEFAULT_GRID_MODE]["vs_float64"]
    rec["max_abs_err"] = dflt["dqkv"]["max_abs"]
    rec["rel_l2_err"] = dflt["dqkv"]["rel_l2"]
    mode = wap.resolve_mxu(None, dtype)
    with torch.no_grad():
        lse = wap._launch_forward(qkv, ls, bias, mask, nH, True, True)[1]
        delta = wap._backward_passes(qkv, ls, bias, mask, lse, g, nH, False,
                                     1, mode, False)[3]

        def k3():
            return wap._launch_dbias(qkv, ls, bias, mask, lse, g, delta, nH)
        got = k3()

        def plain_k3(mxu=mode):
            return wap.cosine_window_attention_packed_dbias_plain(
                qkv, ls, bias, mask, g, num_heads=nH, mxu=mxu)
        rec["k3"] = check_k3(got, k3(), plain_k3(), plain_k3("bf16"),
                             truth[2], TOL_BWD[name]["dbias"],
                             TOL_BWD[name]["dbias"], mode,
                             f"K3 {json.dumps(rec)}")
        del got
    del truth, want_out
    if timed:
        leaves = [t.detach().clone().requires_grad_() for t in (qkv, ls, bias)]
        # the forward as training launches it (graph recorded, stats written)
        fwd = rec["forward"]
        fwd["ms"] = time_ms(lambda: wap.cosine_window_attention_packed(
            leaves[0], leaves[1], leaves[2], mask, num_heads=nH))
        with torch.no_grad():
            fwd["plain_ms"] = time_ms(
                lambda: wap.cosine_window_attention_packed_plain(
                    qkv, ls, bias, mask, num_heads=nH), reps=5, warm=1)
        fwd.update(kernel_bound(shape["B_"], shape["N"], shape["C"], nH,
                                rec["nW"], dtype, bias.dtype, stats=True))
        # the yardstick in qkv's type
        lib = library_yardstick(
            *wap._split_heads(qkv, 3, nH), ls, bias, mask,
            g=wap._split_heads(g, 1, nH)[0])
        fwd.update({k: v for k, v in lib.items() if k != "library_bwd_ms"})
        rec.update({k: v for k, v in lib.items() if k != "library_ms"})
        rec["library_ms"] = lib["library_bwd_ms"]
        # time the backward launch alone: forward once, backward repeatedly
        for grid_mode in WINDOW_GRID_MODES:
            out = wap.cosine_window_attention_packed(
                leaves[0], leaves[1], leaves[2], mask, num_heads=nH,
                grid_mode=grid_mode)
            ms = time_ms(lambda: torch.autograd.grad(
                out, leaves, g, retain_graph=True), reps=8, warm=2)
            rec["ms" if grid_mode == wap.DEFAULT_GRID_MODE
                else f"ms_{grid_mode}"] = ms
        qleaf = qkv.detach().clone().requires_grad_()   # frozen RPE: no dbias
        out = wap.cosine_window_attention_packed(qleaf, ls, bias, mask,
                                                 num_heads=nH)
        rec["ms_no_dbias"] = time_ms(lambda: torch.autograd.grad(
            out, qleaf, g, retain_graph=True), reps=8, warm=2)
        with torch.no_grad():
            rec["plain_ms"] = time_ms(
                lambda: wap.cosine_window_attention_packed_backward_plain(
                    qkv, ls, bias, mask, g, num_heads=nH), reps=3, warm=1)
            # K3 alone, each body launched on its own forward's statistic
            # and its own dq pass's delta
            lse_k = wap._launch_forward(qkv, ls, bias, mask, nH, True, True,
                                        _fma=True)[1]
            delta_k = wap._backward_passes(qkv, ls, bias, mask, lse_k, g, nH,
                                           False, 1, mode, True)[3]
            rec.update(k3_turns(k3, lambda: wap._launch_dbias(
                qkv, ls, bias, mask, lse_k, g, delta_k, nH, _fma=True)))
            rec["k3_plain_ms"] = time_ms(plain_k3, reps=3, warm=1)
            rec["k3_tc"] = tc_work(shape["B_"], shape["N"], nH,
                                   12.0 if dtype == torch.float32 else 2.0)
            del lse_k, delta_k
            if dtype == torch.float32:
                # the tensor-core kernels and the fp32-FMA bodies in turns,
                # each backward on its own forward's statistic
                lse_f = wap._launch_forward(qkv, ls, bias, mask, nH, True,
                                            True, _fma=True)[1]

                def f1(fma):
                    return lambda: wap._launch_forward(
                        qkv, ls, bias, mask, nH, True, True, _fma=fma)

                def b2(fma):
                    return lambda: wap._launch_backward(
                        qkv, ls, bias, mask, lse_f if fma else lse, g, nH,
                        "window_resident", True, _fma=fma)
                ft = [time_ms(f1(False)), time_ms(f1(True)),
                      time_ms(f1(True)), time_ms(f1(False))]
                bt = [time_ms(b2(f), reps=8, warm=2)
                      for f in (False, True, True, False)]
                fwd.update({"ms_launch": (ft[0] + ft[3]) / 2,
                            "fma_ms": (ft[1] + ft[2]) / 2, "ms_turns": ft})
                rec.update({"ms_launch": (bt[0] + bt[3]) / 2,
                            "fma_ms": (bt[1] + bt[2]) / 2, "ms_turns": bt})
        rec["k3_bound"] = dbias_bound(shape["B_"], shape["N"], shape["C"], nH,
                                      rec["nW"], dtype, bias.dtype)
        rec.update(backward_bound(shape["B_"], shape["N"], shape["C"], nH,
                                  rec["nW"], dtype, bias.dtype))
    torch.cuda.empty_cache()
    return rec


def phase_env() -> dict:
    from mmde_tpu_torch.ops import cuda_build
    from mmde_tpu_torch.ops import window_attention_packed as wap
    from mmde_tpu_torch.ops import window_attention_slab as was
    from mmde_tpu_torch.tools.bench_attention import ptxas_summary
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    from concurrent.futures import ThreadPoolExecutor
    from mmde_tpu_torch.tools import bench_attention_variants as tbv
    from mmde_tpu_torch.tools import probe_layouts as tpl
    from mmde_tpu_torch.tools import roofline as trl
    t0 = time.time()
    # one nvcc per library (forward, backward, K4), all side by side; then
    # the tools' libraries in the background, through the kernel phases
    # (tool_libraries() waits for them)
    recs = wap.build_kernels()
    tools = dict(**tpl.library_specs(), **tbv.library_specs(),
                 **trl.library_specs())
    _TOOL_BUILD.append(ThreadPoolExecutor(1).submit(
        cuda_build.load_libraries, tools))
    # and the data path's host library (g++), also in the background
    _HOST_BUILD.append(ThreadPoolExecutor(1).submit(_build_host_library))
    env = {"nvidia_smi": smi, "python": sys.version.split()[0],
           "torch": torch.__version__, "cuda": torch.version.cuda,
           "nvcc": cuda_build.nvcc_version(),
           "build_seconds": round(time.time() - t0, 3),
           "nvcc_seconds": {n: round(r["seconds"], 3)
                            for n, r in recs.items()},
           "libraries": [os.path.relpath(r["path"]) for r in recs.values()],
           # registers / spills / shared memory per kernel, as ptxas says
           "ptxas": [ln for r in recs.values()
                     for ln in ptxas_summary(r["log"])],
           # K3 over MapRows (the slab path's dbias pass) on its own line
           "k3_map_rows_ptxas": [ln for r in recs.values()
                                 for ln in ptxas_summary(r["log"])
                                 if "bwd_dbias_tc_kernel<MapRows" in ln],
           # blocks an SM holds of each tensor-core slab kernel, by map
           # type and mask (the CUDA occupancy calculator)
           "slab_occupancy": {
               str(dt).replace("torch.", ""): {
                   "masked" if m else "unmasked": was.occupancy(dt, m)
                   for m in (False, True)}
               for dt in (torch.float32, torch.bfloat16)},
           "cudnn_allow_tf32": torch.backends.cudnn.allow_tf32,
           "matmul_allow_tf32": torch.backends.cuda.matmul.allow_tf32}
    emit("env", env)
    return env


_TOOL_BUILD: list = []     # the tools' background build (phase_env)


def tool_libraries() -> dict:
    """Wait for the tools' libraries; {name: nvcc seconds}."""
    from mmde_tpu_torch.ops import cuda_build
    return {n: round(cuda_build.BUILD_LOG[n]["seconds"], 3)
            for n in _TOOL_BUILD[0].result()}


def packed_stages(backbone: str, batch: int = 1) -> list:
    return [s for s in stage_shapes(backbone, batch=batch)
            if s["layout"] == "packed"]


def phase_kernels(timed: bool = True) -> list:
    """K1 at the flagship's four stage shapes and swin_large's packed
    stages 2-4 (1 frame pair, as served)."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(1234)
    cases = []
    shapes = stage_shapes()
    for shape in shapes + packed_stages("swin_large_v2"):
        for dtype in (torch.float32, torch.bfloat16):
            for with_mask in (False, True):
                cases.append(compare_kernel(shape, dtype, with_mask, gen,
                                            timed=timed))
    # the row-maximum form (bias not bounded by 16*sigmoid), ragged N = 225
    # and N = 900, both types
    for shape in (shapes[3], shapes[2]):
        for dtype in (torch.float32, torch.bfloat16):
            cases.append(compare_kernel(shape, dtype, True, gen,
                                        maxfree=False, timed=timed))
    emit("kernel_cases", {"cases": cases,
                          "timing": "CUDA events, 3 warm + 20 launches, "
                                    "median; inputs stay in L2 between "
                                    "launches"})
    return cases


def phase_kernels_backward(timed: bool = True) -> list:
    """K2 at the four flagship stage shapes, at 2 frame pairs (what the
    train phase runs) and at 1, and at swin_large's packed stages 2-4 at 2
    pairs; float32 and bfloat16, masked where the stage shifts. Timed at 2
    pairs only (the trained shapes), to keep the script inside its time."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(4321)
    cases = []
    for batch, shapes in (
            (2, stage_shapes(batch=2) + packed_stages("swin_large_v2", 2)),
            (1, stage_shapes(batch=1))):
        for shape in shapes:
            for dtype in (torch.float32, torch.bfloat16):
                case = compare_backward(shape, dtype, gen,
                                        timed=timed and batch == 2)
                case["frame_pairs"] = batch
                cases.append(case)
    emit("kernel_cases_backward", {
        "cases": cases,
        "timing": "CUDA events around the backward launch (dq pass, dk/dv "
                  "pass, dbias) of an autograd graph built once; 2 warm + 8 "
                  "launches, median"})
    return cases


# F3 in the packed FMA body: dlogit_scale against float64 (rel-L2) with
# every head at scale 60, where one rounding of a row's lse ~ 60 (half an
# fp32 ulp, 2e-6) would scale the whole row's p (the head-split and slab
# repairs measured 1.09e-5 / 5.2e-6)
TOL_F3 = 2e-5


def phase_f3_packed() -> dict:
    """F3 on both packed bodies at W = 1, fp32, through the autograd
    Function at flagship stage 1 (2 frame pairs, masked) with every head at
    scale 60: the tensor-core K1 (writing its statistic) and K2 - the
    model's path - and the fp32-FMA bodies (the Function's private `fma`),
    each checked by its launches. The statistic is (2, B_, nH, N), hi + lo,
    and each body's dlogit_scale lies within TOL_F3 of float64 autograd.
    Under "split" each body's K3 after its passes (`dbias_split`, on its own
    forward's statistic): dbias within TOL_BWD's fp32 dbias limit of
    float64.
    Beside them (`one_number`) the FMA backward on the one-number statistic
    the packed body wrote before its repair, hi + lo rounded to one fp32 and
    lo 0 - at best that body's figure (its lse was m + logf(l) in fp32)."""
    from mmde_tpu_torch.ops import window_attention_packed as wap
    gen = torch.Generator(device="cuda")
    gen.manual_seed(3131)
    shape = stage_shapes(batch=2)[0]
    dtype, nH = torch.float32, shape["nH"]
    qkv, ls, bias, mask = make_kernel_inputs(shape, dtype, True, gen)
    ls[:] = math.log(60.0)
    g = torch.randn((shape["B_"], shape["N"], shape["C"]), device="cuda",
                    generator=gen)
    rec = _case_head(shape, dtype, mask)
    rec.update({"every_head_scale_60": True, "frame_pairs": 2, "W": 1,
                "tolerance_dlogit_scale_rel_l2": TOL_F3})
    truth = _float64_grads(qkv, ls, bias, mask, g, nH)
    for body, fma, want in (
            ("tensor_core", False, {"window_attention_fwd_tc+lse": 1,
                                    "window_attention_bwd_tc": 1}),
            ("fma", True, {"window_attention_fwd+lse": 1,
                           "window_attention_bwd": 1})):
        leaves = [t.detach().clone().requires_grad_() for t in (qkv, ls, bias)]
        before = dict(wap.LAUNCHES_BY_KERNEL)
        out = wap._PackedWindowAttention.apply(
            leaves[0], leaves[1], leaves[2], mask, nH, wap.SOFTMAX_MAXFREE,
            "window_resident", 1, "fp32", fma)
        out.backward(g)
        torch.cuda.synchronize()
        _tc_launched(before, want, f"f3_packed ({body})")
        with torch.no_grad():
            lse = wap._launch_forward(qkv, ls, bias, mask, nH, True, True,
                                      _fma=fma)[1]
            before = dict(wap.LAUNCHES_BY_KERNEL)
            dbias = wap._launch_backward(qkv, ls, bias, mask, lse, g, nH,
                                         "split", True, _fma=fma)[2]
            torch.cuda.synchronize()
            sfx = "" if fma else "_tc"
            _tc_launched(before, {f"window_attention_bwd{sfx}": 1,
                                  f"window_attention_dbias{sfx}": 1},
                         f"f3_packed split ({body})")
        rec[body] = {"statistic_shape": list(lse.shape),
                     "dlogit_scale": _errs(leaves[1].grad, truth[1]),
                     "dqkv": _errs(leaves[0].grad, truth[0]),
                     "dbias_split": _errs(dbias, truth[2])}
        del leaves, out, dbias
    with torch.no_grad():
        one = torch.stack([(lse[0].double() + lse[1].double()).float(),
                           torch.zeros_like(lse[1])])
        old = wap._launch_backward(qkv, ls, bias, mask, one, g, nH,
                                   "window_resident", True, _fma=True)
    rec["one_number"] = {"dlogit_scale": _errs(old[1], truth[1]),
                         "dqkv": _errs(old[0], truth[0])}
    rec["tolerance_dbias_split_rel_l2"] = TOL_BWD["float32"]["dbias"]
    del truth, old
    torch.cuda.empty_cache()
    emit("f3_packed", rec)
    if not all(rec[b]["statistic_shape"][0] == 2
               and rec[b]["dlogit_scale"]["rel_l2"] <= TOL_F3
               and rec[b]["dbias_split"]["rel_l2"]
               <= TOL_BWD["float32"]["dbias"]
               for b in ("tensor_core", "fma")):
        raise RuntimeError(f"f3_packed: {json.dumps(rec)}")
    return rec


def headsplit_shapes() -> list:
    """Every head-split stage shape of the real swin variants at 480x640 and
    1 frame pair (swin_tiny 1-2, swin_large 1, swin_huge 1-2), and
    swin_large's stage 1 at 2 pairs, the train shape."""
    out = [dict(s, frame_pairs=1) for b in ("swin_tiny_v2", "swin_large_v2",
                                            "swin_huge_v2")
           for s in stage_shapes(b) if s["layout"] == "headsplit"]
    out += [dict(s, frame_pairs=2)
            for s in stage_shapes("swin_large_v2", batch=2)
            if s["layout"] == "headsplit"]
    return out


def make_headsplit_inputs(shape: dict, dtype, with_mask: bool, gen):
    """q, k, v as the model hands them over: strided views of one
    (B_, N, 3C) qkv tensor; g likewise a view of a (B_, N, C) gradient.
    Bias and mask float32 (head-split stages keep them so). Head 0 above
    the ln(100) clamp, head 1 hot (scale e^4 = 54.6)."""
    dev = "cuda"
    B_, N, C, nH = shape["B_"], shape["N"], shape["C"], shape["nH"]
    qkv = torch.randn((B_, N, 3 * C), device=dev, generator=gen).to(dtype)
    ls = torch.randn((nH, 1, 1), device=dev, generator=gen) * 0.5 + 2.0
    ls[0], ls[1] = 5.0, 4.0
    bias = 16.0 * torch.sigmoid(torch.randn((nH, N, N), device=dev,
                                            generator=gen))
    mask = None
    if with_mask:
        m = torch.rand((shape["nW"], N, N), device=dev, generator=gen) < 0.3
        eye = torch.eye(N, device=dev, dtype=torch.bool)
        mask = torch.where(m & ~eye, -100.0, 0.0).contiguous()
    g = torch.randn((B_, N, C), device=dev, generator=gen).to(dtype)
    g = g.reshape(B_, N, nH, C // nH).permute(0, 2, 1, 3)
    return qkv, ls, bias, mask, g


def _views(qkv, nH):
    B_, N, C3 = qkv.shape
    return qkv.reshape(B_, N, 3, nH, C3 // 3 // nH).permute(2, 0, 3, 1,
                                                            4).unbind(0)


def headsplit_split(qkv, ls, bias, mask, g, plain, truth, dtype,
                    timed: bool, what: str) -> dict:
    """Under MMDE_ATTN_GRID=split (the packed module's DEFAULT_GRID_MODE,
    set for the call) the head-split backward through the autograd
    Function: the tensor-core passes without dbias, then the tensor-core K3
    (its launches checked); dqkv, dlogit_scale and dbias against the plain
    backward and float64 at TOL_BWD; K3's dbias bitwise equal over two
    launches on the passes' delta. Timed: K3 alone beside its plain
    version, its bound and its products (2 units bf16, 12 fp32)."""
    from mmde_tpu_torch.ops import window_attention_headsplit as ths
    nH, name = ls.numel(), str(dtype).replace("torch.", "")
    leaves = [t.detach().clone().requires_grad_() for t in (qkv, ls, bias)]
    before = dict(ths.LAUNCHES_BY_KERNEL)
    with _packed_settings({"DEFAULT_GRID_MODE": "split"}):
        out = ths.cosine_window_attention_headsplit(
            *_views(leaves[0], nH), leaves[1], leaves[2], mask)
        out.backward(g)
    torch.cuda.synchronize()
    _tc_launched(before, {"window_attention_headsplit_fwd_tc+lse": 1,
                          "window_attention_headsplit_bwd_tc": 1,
                          "window_attention_headsplit_dbias_tc": 1},
                 f"split {what}", ths)
    rec = _check_against([t.grad for t in leaves], {
        "vs_plain": (plain, TOL_BWD[name]),
        "vs_float64": (truth, TOL_BWD[name])}, f"split {what}")
    del leaves, out
    q, k, v = _views(qkv, nH)
    with torch.no_grad():
        lse = ths._launch_forward(q, k, v, ls, bias, mask, True)[1]
        delta = ths._backward_passes(q, k, v, ls, bias, mask, lse, g, True,
                                     True, False)[5]

        def k3():
            return ths._launch_dbias(q, k, v, g, ls, bias, mask, lse, delta)
        got = k3()
        rec["k3_bitwise_equal_over_two_launches"] = bool(
            torch.equal(got, k3()))
        if not rec["k3_bitwise_equal_over_two_launches"]:
            raise RuntimeError(f"head-split K3 not bitwise equal over two "
                               f"launches at {what}")
        if timed:
            B_, N = qkv.shape[:2]
            rec["k3_ms"] = time_ms(k3, reps=8, warm=2)
            rec["k3_plain_ms"] = time_ms(
                lambda: ths.cosine_window_attention_headsplit_dbias_plain(
                    q, k, v, ls, bias, mask, g), reps=3, warm=1)
            rec["k3_bound"] = dbias_bound(
                B_, N, qkv.shape[2] // 3, nH,
                0 if mask is None else mask.shape[0], dtype, torch.float32)
            rec["k3_tc"] = tc_work(B_, N, nH, 12.0 if dtype == torch.float32
                                   else 2.0)
        del got, lse, delta
    return rec


def compare_headsplit(shape: dict, dtype, with_mask: bool, gen,
                      timed: bool = True, split: bool = False) -> dict:
    """K6' (serving entry, and the training entry that also writes the
    log-sum-exp) against the plain forward; K7' against the plain backward
    and against float64 autograd of the plain forward, at K1 / K2's
    tolerances. Gradients are taken through the model's views, into one
    (B_, N, 3C) dqkv. Both types run the tensor-core kernels (checked by
    their launch counters; fp32 operands in three bf16 pieces), which must
    also lie MXU_APART times nearer the "fp32" plain version than the
    "bf16"-mode one (bf16: forward and dqkv; fp32: the forward and every
    gradient, as the slab cases hold bf16 - a kernel that quietly rounds
    its operands fails). Timed (timed=True): the kernel, plain, bound, the
    FMA body (`_fma`) in turns with the kernel (kernel, FMA, FMA, kernel),
    the SDPA yardstick in q's type and the products the design needs
    (tc_work: bf16 K1's 3 units, K2's 8; fp32 12 and 30). `split`: also
    the backward under MMDE_ATTN_GRID=split (headsplit_split)."""
    from mmde_tpu_torch.ops import window_attention_headsplit as ths
    qkv, ls, bias, mask, g = make_headsplit_inputs(shape, dtype, with_mask,
                                                   gen)
    nH = shape["nH"]
    q, k, v = _views(qkv, nH)
    if not all(ths.rows_layout_ok(t) for t in (q, k, v, g)):
        raise RuntimeError(f"the model's views need a copy at {shape}")
    name = str(dtype).replace("torch.", "")
    f32 = dtype == torch.float32
    rec = {"model": shape["model"], "stage": shape["stage"],
           "frame_pairs": shape["frame_pairs"], "B_": shape["B_"],
           "N": shape["N"], "C": shape["C"], "nH": nH,
           "nW": mask.shape[0] if mask is not None else 0, "dtype": name,
           "body": "tensor cores" + (", three bf16 pieces" if f32 else ""),
           "mxu": "fp32", "tolerance_rel_l2": TOL_BWD[name]}
    with torch.no_grad():
        want = ths.cosine_window_attention_headsplit_plain(q, k, v, ls, bias,
                                                           mask)
        before = dict(ths.LAUNCHES_BY_KERNEL)
        got = ths.cosine_window_attention_headsplit(q, k, v, ls, bias, mask)
        torch.cuda.synchronize()
        _tc_launched(before, {"window_attention_headsplit_fwd_tc": 1},
                     f"serving forward at {rec}", ths)
        rec["forward"] = check_forward(got, want, dtype, rec)

    leaves = [qkv.detach().clone().requires_grad_(), ls.clone()
              .requires_grad_(), bias.clone().requires_grad_()]
    before = dict(ths.LAUNCHES_BY_KERNEL)
    out = ths.cosine_window_attention_headsplit(*_views(leaves[0], nH),
                                                leaves[1], leaves[2], mask)
    rec["forward_stats"] = check_forward(out.detach(), want, dtype, rec)
    out.backward(g)
    torch.cuda.synchronize()
    _tc_launched(before, {"window_attention_headsplit_fwd_tc+lse": 1,
                          "window_attention_headsplit_bwd_tc": 1},
                 f"training forward and backward at {rec}", ths)
    grads = [t.grad for t in leaves]
    out = out.detach()

    def stacked(dq, dk, dv):
        return torch.stack([dq, dk, dv], 2).permute(0, 3, 2, 1, 4).reshape(
            qkv.shape)

    with torch.no_grad():
        dq, dk, dv, dls, dbias = \
            ths.cosine_window_attention_headsplit_backward_plain(
                q, k, v, ls, bias, mask, g)
        plain = [stacked(dq, dk, dv), dls, dbias]
        del dq, dk, dv
    leaves64 = [t.detach().double().requires_grad_() for t in (qkv, ls,
                                                               bias)]
    out64 = ths.cosine_window_attention_headsplit_plain(
        *_views(leaves64[0], nH), leaves64[1], leaves64[2],
        None if mask is None else mask.double(), compute_dtype=torch.float64)
    truth = torch.autograd.grad(out64, leaves64, g.double())
    del out64, leaves64
    names = ("dqkv", "dlogit_scale", "dbias")
    rec["plain_vs_float64"] = {n: _errs(p, t)
                               for n, p, t in zip(names, plain, truth)}
    rec.update(_check_against(grads, {
        "vs_plain": (plain, TOL_BWD[name]),
        "vs_float64": (truth, TOL_BWD[name])},
        f"head-split backward ({rec['body']}) at {json.dumps(rec)}"))
    rec["max_abs_err"] = rec["vs_float64"]["dqkv"]["max_abs"]
    rec["rel_l2_err"] = rec["vs_float64"]["dqkv"]["rel_l2"]
    # the "bf16" mode's plain version: what a kernel rounding its operands
    # to bf16 would compute
    with torch.no_grad():
        want_o = ths.cosine_window_attention_headsplit_plain(
            q, k, v, ls, bias, mask, mxu="bf16")
        dq, dk, dv, dls_o, dbias_o = \
            ths.cosine_window_attention_headsplit_backward_plain(
                q, k, v, ls, bias, mask, g, mxu="bf16")
        others = [stacked(dq, dk, dv), dls_o, dbias_o]
        del dq, dk, dv
    _nearer(rec, "out", out, want, want_o)
    for n, a, own, other in list(zip(names, grads, plain, others))[
            :3 if f32 else 1]:
        _nearer(rec, n, a, own, other)
    del want_o, others
    if split:
        rec["split"] = headsplit_split(qkv, ls, bias, mask, g, plain, truth,
                                       dtype, timed, json.dumps(rec))
    del got, plain, truth, leaves, grads, out, want
    if timed:
        B_, N, C, nW = shape["B_"], shape["N"], shape["C"], rec["nW"]
        fwd, fst = rec["forward"], rec["forward_stats"]
        with torch.no_grad():
            for r, stats in ((fwd, False), (fst, True)):
                def kern(fma=False, stats=stats):
                    return ths._launch_forward(q, k, v, ls, bias, mask,
                                               stats, _fma=fma)
                turns = [time_ms(kern), time_ms(lambda: kern(True)),
                         time_ms(lambda: kern(True)), time_ms(kern)]
                r.update({"ms": (turns[0] + turns[3]) / 2,
                          "fma_ms": (turns[1] + turns[2]) / 2,
                          "ms_turns": turns})
                r.update(tc_work(B_, N, nH, tc_units("fp32", False, ls,
                                                     f32=f32)))
                r.update(kernel_bound(B_, N, C, nH, nW, dtype, torch.float32,
                                      stats=stats))
                r["library_ms"] = None
            fwd["plain_ms"] = fst["plain_ms"] = time_ms(
                lambda: ths.cosine_window_attention_headsplit_plain(
                    q, k, v, ls, bias, mask), reps=5, warm=1)
            lse = ths._launch_forward(q, k, v, ls, bias, mask, True)[1]
            lse_f = ths._launch_forward(q, k, v, ls, bias, mask, True,
                                        _fma=True)[1]

            # the backward entry alone (its passes, the dbias buffer and
            # the dlogit_scale sum), on the forward's saved statistics
            def bwd(dbias=True, fma=False):
                saved = lse_f if fma else lse
                return lambda: ths._launch_backward(
                    q, k, v, ls, bias, mask, saved, g, dbias, _fma=fma)
            turns = [time_ms(bwd(), reps=8, warm=2),
                     time_ms(bwd(fma=True), reps=8, warm=2),
                     time_ms(bwd(fma=True), reps=8, warm=2),
                     time_ms(bwd(), reps=8, warm=2)]
            rec.update({"ms": (turns[0] + turns[3]) / 2,
                        "fma_ms": (turns[1] + turns[2]) / 2,
                        "ms_turns": turns})
            rec.update(tc_work(B_, N, nH, tc_units("fp32", True, ls,
                                                   f32=f32)))
            rec["ms_no_dbias"] = time_ms(bwd(dbias=False), reps=8, warm=2)
            rec["plain_ms"] = time_ms(
                lambda: ths.cosine_window_attention_headsplit_backward_plain(
                    q, k, v, ls, bias, mask, g), reps=3, warm=1)
            del lse, lse_f
        rec.update(backward_bound(B_, N, C, nH, nW, dtype, torch.float32))
        # the yardstick in q's type
        lib = library_yardstick(q, k, v, ls, bias, mask, g=g)
        for r in (fwd, fst):
            r.update({k_: v_ for k_, v_ in lib.items()
                      if k_ != "library_bwd_ms"})
        rec.update({k_: v_ for k_, v_ in lib.items() if k_ != "library_ms"})
        rec["library_ms"] = lib["library_bwd_ms"]
    torch.cuda.empty_cache()
    return rec


def f3_headsplit(gen) -> dict:
    """F3 on both head-split bodies, fp32, through the autograd Function at
    swin_large's stage-1 train shape (2 frame pairs, masked) with every
    head at scale 60: the tensor-core K6' (writing its statistic) and K7' -
    the model's path - and the fp32-FMA bodies (the Function's private
    `fma`), each checked by its launches. The statistic is (2, B_, nH, N),
    hi + lo, and each body's dlogit_scale lies within TOL_F3 of float64
    autograd of the plain forward."""
    from mmde_tpu_torch.ops import window_attention_headsplit as ths
    shape = next(s for s in headsplit_shapes()
                 if s["model"] == "swin_large_v2" and s["frame_pairs"] == 2)
    nH = shape["nH"]
    qkv, ls, bias, mask, g = make_headsplit_inputs(shape, torch.float32,
                                                   True, gen)
    ls[:] = math.log(60.0)
    rec = {"model": shape["model"], "stage": shape["stage"],
           "frame_pairs": 2, "B_": shape["B_"], "N": shape["N"],
           "C": shape["C"], "nH": nH, "nW": mask.shape[0],
           "dtype": "float32", "every_head_scale_60": True,
           "tolerance_dlogit_scale_rel_l2": TOL_F3}
    leaves64 = [t.detach().double().requires_grad_() for t in (qkv, ls,
                                                               bias)]
    out64 = ths.cosine_window_attention_headsplit_plain(
        *_views(leaves64[0], nH), leaves64[1], leaves64[2], mask.double(),
        compute_dtype=torch.float64)
    truth = torch.autograd.grad(out64, leaves64, g.double())
    del out64, leaves64
    for body, fma, sfx in (("tensor_core", False, "_tc"),
                           ("fma", True, "")):
        leaves = [t.detach().clone().requires_grad_() for t in (qkv, ls,
                                                                bias)]
        before = dict(ths.LAUNCHES_BY_KERNEL)
        out = ths._HeadSplitWindowAttention.apply(
            *_views(leaves[0], nH), leaves[1], leaves[2], mask, fma)
        out.backward(g)
        torch.cuda.synchronize()
        _tc_launched(before, {f"window_attention_headsplit_fwd{sfx}+lse": 1,
                              f"window_attention_headsplit_bwd{sfx}": 1},
                     f"f3 head-split ({body})", ths)
        with torch.no_grad():
            lse = ths._launch_forward(*_views(qkv, nH), ls, bias, mask, True,
                                      _fma=fma)[1]
        rec[body] = {"statistic_shape": list(lse.shape),
                     "dlogit_scale": _errs(leaves[1].grad, truth[1]),
                     "dqkv": _errs(leaves[0].grad, truth[0]),
                     "dbias": _errs(leaves[2].grad, truth[2])}
        del leaves, out, lse
    del truth
    torch.cuda.empty_cache()
    rec["ok"] = all(rec[b]["statistic_shape"][0] == 2
                    and rec[b]["dlogit_scale"]["rel_l2"] <= TOL_F3
                    for b in ("tensor_core", "fma"))
    return rec


def phase_kernels_headsplit(timed: bool = True) -> list:
    """K6' / K7' at every head-split shape, bf16 and fp32 (both on the
    tensor-core kernels), masked and unmasked; timed at swin_large's (the
    served and trained paths), the others checked only, to keep the script
    inside its time; masked swin_large and swin_tiny stage 1 also under
    MMDE_ATTN_GRID=split (the tensor-core K3); then F3 on both fp32 bodies
    (f3_headsplit). The phase's line is printed, then it fails if the F3
    case missed."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(2468)
    cases = []
    for shape in headsplit_shapes():
        for dtype in (torch.float32, torch.bfloat16):
            for with_mask in (False, True):     # every such stage shifts
                cases.append(compare_headsplit(
                    shape, dtype, with_mask, gen,
                    timed=timed and shape["model"] == "swin_large_v2",
                    split=with_mask and shape["stage"] == 1
                    and shape["model"] in ("swin_large_v2",
                                           "swin_tiny_v2")))
    f3 = f3_headsplit(gen)
    emit("kernel_cases_headsplit", {
        "cases": cases, "f3": f3,
        "timing": "CUDA events, median: serving forward 3 warm + 20, "
                  "forward with statistics the same, backward entry 2 warm "
                  "+ 8; kernel, FMA body, FMA body, kernel in turns "
                  "(ms_turns); inputs stay in L2 between launches"})
    if not f3["ok"]:
        raise RuntimeError(f"kernel_cases_headsplit: F3 case {json.dumps(f3)}")
    return cases


def slab_shapes() -> list:
    """The slab kernels' shapes: the flagship's four stages served (1 frame
    pair: forward only) and trained (2 pairs), swin_large's slab stages 2-4
    trained (stage 1, C 192, fails `slab_plan` and stays head-split)."""
    out = [dict(s, frame_pairs=1)
           for s in stage_shapes(batch=1, attn_impl="cuda_slab")]
    out += [dict(s, frame_pairs=2)
            for b in ("swin_base_v2", "swin_large_v2")
            for s in stage_shapes(b, batch=2, attn_impl="cuda_slab")
            if s["layout"] == "slab"]
    return out


def make_slab_inputs(shape: dict, dtype, gen, hot: bool = False):
    """The qkv map (B, Hp, Wp, 3C) and output gradient map (B, Hp, Wp, C)
    as the model hands them over, float32 16*sigmoid bias and, where the
    stage shifts, a float32 0/-100 mask with one row per window of an image
    (the slab path keeps both float32 in bf16 models). Head 0 above the
    ln(100) clamp, head 1 hot (scale e^4 = 54.6); `hot`: every head but the
    clamped one at scale 60, where one fp32 rounding of a row's
    log-sum-exp (~60) shows in dlogit_scale (F3)."""
    dev = "cuda"
    B, (Hp, Wp) = shape["images"], shape["padded"]
    N, C, nH = shape["N"], shape["C"], shape["nH"]
    qkv = torch.randn((B, Hp, Wp, 3 * C), device=dev, generator=gen).to(dtype)
    ls = torch.randn((nH, 1, 1), device=dev, generator=gen) * 0.5 + 2.0
    ls[0], ls[1] = 5.0, 4.0
    if hot:
        ls[1:] = math.log(60.0)
    bias = 16.0 * torch.sigmoid(torch.randn((nH, N, N), device=dev,
                                            generator=gen))
    mask = None
    if shape["nW"]:
        m = torch.rand((shape["nW"], N, N), device=dev, generator=gen) < 0.3
        eye = torch.eye(N, device=dev, dtype=torch.bool)
        mask = torch.where(m & ~eye, -100.0, 0.0).contiguous()
    g = torch.randn((B, Hp, Wp, C), device=dev, generator=gen).to(dtype)
    return qkv, ls, bias, mask, g


def compare_slab(shape: dict, dtype, gen, timed: bool = True) -> dict:
    """K8' (serving entry) against the slab plain forward; at the train
    shapes (2 frame pairs) also K8' through the training entry (with the
    log-sum-exp) and K9' against the plain backward and against float64
    autograd of the plain forward, at K1 / K2's tolerances (TOL_*). Both
    types run the tensor-core kernels (the `_tc` slab entries, checked by
    their launch counters; fp32 operands in three bf16 pieces, hi + lo
    log-sum-exp: F3), which must also lie MXU_APART times nearer the fp32
    function's plain version than the "bf16"-mode head-split plain version
    on the partitioned windows (output and every gradient). Timed: the
    kernel, plain, bound, the library call on the partitioned windows in
    the map's type, the FMA body (`_fma`) in turns with the kernel (kernel,
    FMA, FMA, kernel) and the products the design needs (tc_work: bf16 K8'
    3 units, K9' 8; fp32 12 and 30). At the train shapes also K3 over
    `MapRows` (`k3`, the slab path's dbias under MMDE_ATTN_GRID=split and
    in deterministic mode): its dbias on the atomics-free passes' delta
    against the plain backward's and float64 at TOL_BWD, MXU_APART times
    nearer than the "bf16"-mode one, bitwise over two launches; timed
    alone (k3_ms) beside its plain version, its bound and its products
    (2 units bf16, 12 fp32). Times: median of single launches; bounds
    count float32 bias and mask bytes."""
    from mmde_tpu_torch.ops import window_attention_headsplit as ths
    from mmde_tpu_torch.ops import window_attention_packed as wap
    from mmde_tpu_torch.ops import window_attention_slab as was
    qkv, ls, bias, mask, g = make_slab_inputs(shape, dtype, gen)
    nH, ws = shape["nH"], shape["ws"]
    B_, N, C = shape["B_"], shape["N"], shape["C"]
    Hp, Wp = shape["padded"]
    kw = dict(num_heads=nH, window_size=ws)
    name = str(dtype).replace("torch.", "")
    nW = mask.shape[0] if mask is not None else 0
    f32 = dtype == torch.float32
    rec = {"model": shape["model"], "stage": shape["stage"],
           "frame_pairs": shape["frame_pairs"], "map": list(qkv.shape),
           "B_": B_, "N": N, "C": C, "nH": nH, "nW": nW, "dtype": name,
           "body": "tensor cores" + (", three bf16 pieces" if f32 else ""),
           "mxu": "fp32", "heads": "clamped, scale 54.6, cool",
           "tolerance_rel_l2": TOL_BWD[name]}
    with torch.no_grad():
        want = was.cosine_window_attention_slab_plain(qkv, ls, bias, mask,
                                                      **kw)
        before = dict(was.LAUNCHES_BY_KERNEL)
        got = was.cosine_window_attention_slab(qkv, ls, bias, mask, **kw)
        torch.cuda.synchronize()
        _tc_launched(before, {"window_attention_slab_fwd_tc": 1},
                     f"slab serving forward at {rec}", was)
        rec["forward"] = check_forward(got, want, dtype, rec)
    train = shape["frame_pairs"] > 1
    names = ("dqkv", "dlogit_scale", "dbias")
    if train:
        leaves = [qkv.detach().clone().requires_grad_(),
                  ls.clone().requires_grad_(), bias.clone().requires_grad_()]
        before = dict(was.LAUNCHES_BY_KERNEL)
        out = was.cosine_window_attention_slab(*leaves, mask, **kw)
        rec["forward_stats"] = check_forward(out.detach(), want, dtype, rec)
        out.backward(g)
        torch.cuda.synchronize()
        _tc_launched(before, {"window_attention_slab_fwd_tc+lse": 1,
                              "window_attention_slab_bwd_tc": 1},
                     f"slab training forward and backward at {rec}", was)
        grads = [t.grad for t in leaves]
        del out, leaves
        with torch.no_grad():
            plain = was.cosine_window_attention_slab_backward_plain(
                qkv, ls, bias, mask, g, **kw)
        leaves64 = [t.detach().double().requires_grad_()
                    for t in (qkv, ls, bias)]
        out64 = was.cosine_window_attention_slab_plain(
            *leaves64, None if mask is None else mask.double(),
            compute_dtype=torch.float64, **kw)
        truth = torch.autograd.grad(out64, leaves64, g.double())
        del out64, leaves64
        rec["plain_vs_float64"] = {n: _errs(p_, t)
                                   for n, p_, t in zip(names, plain, truth)}
        rec.update(_check_against(grads, {
            "vs_plain": (plain, TOL_BWD[name]),
            "vs_float64": (truth, TOL_BWD[name])},
            f"slab backward ({rec['body']}) at {json.dumps(rec)}"))
        rec["max_abs_err"] = rec["vs_float64"]["dqkv"]["max_abs"]
        rec["rel_l2_err"] = rec["vs_float64"]["dqkv"]["rel_l2"]
        truth_db = truth[2]
        del truth
    # the "bf16" mode's head-split plain version on the partitioned
    # windows, reversed: what a kernel rounding its operands to bf16
    # would compute
    with torch.no_grad():
        qw = was._heads(was.window_partition(qkv, ws), 3, nH)
        o = ths.cosine_window_attention_headsplit_plain(
            *qw, ls, bias, mask, mxu="bf16")
        want_o = was.window_reverse(
            o.permute(0, 2, 1, 3).reshape(-1, N, C), ws, Hp, Wp)
        del o
        _nearer(rec, "out", got, want, want_o)
        del want_o
        if train:
            gw = was._heads(was.window_partition(g, ws), 1, nH)[0]
            dq, dk, dv, dls_o, dbias_o = \
                ths.cosine_window_attention_headsplit_backward_plain(
                    *qw, ls, bias, mask, gw, mxu="bf16")
            dqkv_o = torch.stack([dq, dk, dv], 0).permute(1, 3, 0, 2, 4)
            dqkv_o = was.window_reverse(dqkv_o.reshape(-1, N, 3 * C), ws,
                                        Hp, Wp)
            del dq, dk, dv
            for n, a, own, other in zip(names, grads, plain,
                                        (dqkv_o, dls_o, dbias_o)):
                _nearer(rec, n, a, own, other)
            # K3 over MapRows: the passes without atomics, then dbias
            # window after window on their delta (MMDE_ATTN_GRID=split,
            # deterministic mode)
            lse = was._launch_forward(qkv, ls, bias, mask, nH, ws, True)[1]
            delta = was._backward_passes(qkv, ls, bias, mask, lse, g, nH, ws,
                                         atomics=False, tc=True)[3]
            before = dict(was.LAUNCHES_BY_KERNEL)

            def k3():
                return was._launch_dbias(qkv, ls, bias, mask, lse, g, delta,
                                         nH, ws)
            got_k3 = k3()
            _tc_launched(before, {"window_attention_slab_dbias_tc": 1},
                         f"slab K3 at {rec}", was)
            rec["k3"] = check_k3(got_k3, k3(), plain[2], dbias_o, truth_db,
                                 TOL_BWD[name]["dbias"],
                                 TOL_BWD[name]["dbias"], "fp32",
                                 f"K3 over MapRows {json.dumps(rec)}")
            del dqkv_o, dls_o, dbias_o, gw, got_k3
        del qw
    if train:
        del grads, plain, truth_db
    del want, got
    if timed:
        fwd = rec["forward"]
        records = [(fwd, False)]
        if train:
            records.append((rec["forward_stats"], True))
        with torch.no_grad():
            for r, stats in records:
                def kern(fma=False, stats=stats):
                    return was._launch_forward(qkv, ls, bias, mask, nH, ws,
                                               stats, _fma=fma)
                turns = [time_ms(kern), time_ms(lambda: kern(True)),
                         time_ms(lambda: kern(True)), time_ms(kern)]
                r.update({"ms": (turns[0] + turns[3]) / 2,
                          "fma_ms": (turns[1] + turns[2]) / 2,
                          "ms_turns": turns})
                r.update(tc_work(B_, N, nH, tc_units("fp32", False, ls,
                                                     f32=f32)))
                r.update(kernel_bound(B_, N, C, nH, nW, dtype, torch.float32,
                                      stats=stats))
            plain_ms = time_ms(lambda: was.cosine_window_attention_slab_plain(
                qkv, ls, bias, mask, **kw), reps=5, warm=1)
            for r, _ in records:
                r["plain_ms"] = plain_ms
            if train:
                lse = was._launch_forward(qkv, ls, bias, mask, nH, ws,
                                          True)[1]
                lse_f = was._launch_forward(qkv, ls, bias, mask, nH, ws,
                                            True, _fma=True)[1]

                # the backward entry alone (both passes, the dbias buffer
                # and the dlogit_scale sum), on its forward's statistic
                def bwd(dbias=True, fma=False):
                    saved = lse_f if fma else lse
                    return lambda: was._launch_backward(
                        qkv, ls, bias, mask, saved, g, nH, ws, dbias,
                        _fma=fma)
                turns = [time_ms(bwd(), reps=8, warm=2),
                         time_ms(bwd(fma=True), reps=8, warm=2),
                         time_ms(bwd(fma=True), reps=8, warm=2),
                         time_ms(bwd(), reps=8, warm=2)]
                rec.update({"ms": (turns[0] + turns[3]) / 2,
                            "fma_ms": (turns[1] + turns[2]) / 2,
                            "ms_turns": turns})
                rec.update(tc_work(B_, N, nH, tc_units("fp32", True, ls,
                                                       f32=f32)))
                rec["ms_no_dbias"] = time_ms(bwd(dbias=False), reps=8,
                                             warm=2)
                rec["plain_ms"] = time_ms(
                    lambda: was.cosine_window_attention_slab_backward_plain(
                        qkv, ls, bias, mask, g, **kw), reps=3, warm=1)
                rec.update(backward_bound(B_, N, C, nH, nW, dtype,
                                          torch.float32))
                # K3 over MapRows alone on the dq pass's delta; its plain
                # version: the packed layout's on the partitioned windows
                delta = was._backward_passes(qkv, ls, bias, mask, lse, g,
                                             nH, ws, atomics=False,
                                             tc=True)[3]
                rec["k3_ms"] = time_ms(
                    lambda: was._launch_dbias(qkv, ls, bias, mask, lse, g,
                                              delta, nH, ws), reps=8, warm=2)
                qp = was.window_partition(qkv, ws)
                gp = was.window_partition(g, ws)
                rec["k3_plain_ms"] = time_ms(
                    lambda: wap.cosine_window_attention_packed_dbias_plain(
                        qp, ls, bias, mask, gp, num_heads=nH, mxu="fp32"),
                    reps=3, warm=1)
                rec["k3_tc"] = tc_work(B_, N, nH, 12.0 if f32 else 2.0)
                rec["k3_bound"] = dbias_bound(B_, N, C, nH, nW, dtype,
                                              torch.float32)
                del lse, lse_f, delta, qp, gp
        # on the partitioned windows: the library call has no map layout
        qw = was._heads(was.window_partition(qkv, ws), 3, nH)
        gw = (was._heads(was.window_partition(g, ws), 1, nH)[0]
              if train else None)
        lib = library_yardstick(*qw, ls, bias, mask, g=gw)
        lib["library_call"] += " on window_partition(qkv_map)"
        for r, _ in records:
            r.update({k_: v_ for k_, v_ in lib.items()
                      if k_ != "library_bwd_ms"})
        if train:
            rec.update({k_: v_ for k_, v_ in lib.items()
                        if k_ != "library_ms"})
            rec["library_ms"] = lib["library_bwd_ms"]
        del qw, gw
    torch.cuda.empty_cache()
    return rec


def f3_slab(gen) -> dict:
    """F3 on both fp32 slab bodies at the flagship's stage-1 train shape (2
    frame pairs, masked) with every head but the clamped one at scale 60:
    the tensor-core K8' / K9' - the model's path - and the fp32-FMA bodies
    (`_fma`, the Function's private last argument), each checked by its
    launches. Each body is held as compare_slab holds a case: its serving
    forward and its forward with the statistic to the plain forward
    (check_forward); its dqkv, dlogit_scale and dbias, through the autograd
    Function, to the plain backward and to float64 autograd of the plain
    forward (TOL_BWD; raises on a miss). Its statistic is (2, B*nW, nH, N),
    hi + lo, and `ok` also wants each body's dlogit_scale within TOL_F3 of
    float64."""
    from mmde_tpu_torch.ops import window_attention_slab as was
    shape = next(s for s in slab_shapes()
                 if s["model"] == "swin_base_v2" and s["frame_pairs"] == 2
                 and s["stage"] == 1)
    nH, ws = shape["nH"], shape["ws"]
    kw = dict(num_heads=nH, window_size=ws)
    qkv, ls, bias, mask, g = make_slab_inputs(shape, torch.float32, gen,
                                              hot=True)
    rec = {"model": shape["model"], "stage": shape["stage"],
           "frame_pairs": 2, "map": list(qkv.shape), "B_": shape["B_"],
           "N": shape["N"], "C": shape["C"], "nH": nH, "nW": mask.shape[0],
           "dtype": "float32", "heads": "clamped, then scale 60",
           "tolerance_rel_l2": TOL_BWD["float32"],
           "tolerance_dlogit_scale_rel_l2": TOL_F3}
    names = ("dqkv", "dlogit_scale", "dbias")
    with torch.no_grad():
        want = was.cosine_window_attention_slab_plain(qkv, ls, bias, mask,
                                                      **kw)
        plain = was.cosine_window_attention_slab_backward_plain(
            qkv, ls, bias, mask, g, **kw)
    leaves64 = [t.detach().double().requires_grad_() for t in (qkv, ls,
                                                               bias)]
    out64 = was.cosine_window_attention_slab_plain(
        *leaves64, mask.double(), compute_dtype=torch.float64, **kw)
    truth = torch.autograd.grad(out64, leaves64, g.double())
    del out64, leaves64
    rec["plain_vs_float64"] = {n: _errs(p_, t)
                               for n, p_, t in zip(names, plain, truth)}
    for body, fma, sfx in (("tensor_core", False, "_tc"),
                           ("fma", True, "")):
        where = dict(rec, body=body)
        r = {}
        with torch.no_grad():
            before = dict(was.LAUNCHES_BY_KERNEL)
            got = was._launch_forward(qkv, ls, bias, mask, nH, ws, False,
                                      _fma=fma)[0]
            torch.cuda.synchronize()
            _tc_launched(before, {f"window_attention_slab_fwd{sfx}": 1},
                         f"f3 slab serving forward ({body})", was)
            r["forward"] = check_forward(got, want, torch.float32, where)
            del got
        leaves = [t.detach().clone().requires_grad_() for t in (qkv, ls,
                                                                bias)]
        before = dict(was.LAUNCHES_BY_KERNEL)
        out = was._SlabWindowAttention.apply(*leaves, mask, nH, ws, fma)
        r["forward_stats"] = check_forward(out.detach(), want,
                                           torch.float32, where)
        out.backward(g)
        torch.cuda.synchronize()
        _tc_launched(before, {f"window_attention_slab_fwd{sfx}+lse": 1,
                              f"window_attention_slab_bwd{sfx}": 1},
                     f"f3 slab ({body})", was)
        r.update(_check_against([t.grad for t in leaves], {
            "vs_plain": (plain, TOL_BWD["float32"]),
            "vs_float64": (truth, TOL_BWD["float32"])},
            f"f3 slab backward ({body}) at {json.dumps(where)}"))
        with torch.no_grad():
            lse = was._launch_forward(qkv, ls, bias, mask, nH, ws, True,
                                      _fma=fma)[1]
        r["statistic_shape"] = list(lse.shape)
        rec[body] = r
        del leaves, out, lse
    del truth, plain, want
    torch.cuda.empty_cache()
    rec["ok"] = all(
        rec[b]["statistic_shape"][0] == 2
        and rec[b]["vs_float64"]["dlogit_scale"]["rel_l2"] <= TOL_F3
        for b in ("tensor_core", "fma"))
    return rec


def phase_kernels_slab(timed: bool = True) -> list:
    """K8' / K9' at every slab shape, bf16 and fp32 (both on the
    tensor-core kernels, fp32 in three bf16 pieces); then F3 on both fp32
    bodies (f3_slab, which raises where a body misses TOL_FP32_MAX_ABS or
    TOL_BWD). The phase's line is printed, then it fails if a body's
    dlogit_scale missed TOL_F3."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(1357)
    cases = []
    for shape in slab_shapes():
        for dtype in (torch.float32, torch.bfloat16):
            cases.append(compare_slab(shape, dtype, gen, timed=timed))
    f3 = f3_slab(gen)
    emit("kernel_cases_slab", {
        "cases": cases, "f3": f3,
        "timing": "CUDA events, median: serving forward 3 warm + 20 (1 pair "
                  "and 2), forward with statistics the same, backward entry "
                  "2 warm + 8 (2 pairs); kernel, FMA body, FMA body, kernel "
                  "in turns (ms_turns); inputs stay in L2 between "
                  "launches"})
    if not f3["ok"]:
        raise RuntimeError(f"kernel_cases_slab: F3 case {json.dumps(f3)}")
    return cases


def randomize_weights(model, seed: int) -> None:
    """Fill the model from a seeded generator at scales that keep
    activations O(1) through the network: the package's own init (conv std
    0.001, identity BatchNorm) yields a near-constant depth map of
    max_depth/2, on which any comparison passes vacuously."""
    import torch.nn as nn
    dev = next(model.parameters()).device
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)

    def randn(shape, std=1.0, mean=0.0):
        return torch.randn(tuple(shape), device=dev, generator=gen) * std + mean

    with torch.no_grad():
        for name, m in model.named_modules():
            if isinstance(m, (nn.Linear, nn.Conv2d)):
                fan_in = m.weight[0].numel()
                gain = math.sqrt(2.0) if isinstance(m, nn.Conv2d) else 1.0
                m.weight.copy_(randn(m.weight.shape, gain / math.sqrt(fan_in)))
                if m.bias is not None:
                    m.bias.copy_(randn(m.bias.shape, 0.1))
            elif isinstance(m, nn.ConvTranspose2d):
                # each output pixel of a stride-2 deconv sums in_ch * (k/2)^2
                fan_in = m.weight.shape[0] * max(
                    (m.weight.shape[2] // 2) ** 2, 1)
                m.weight.copy_(randn(m.weight.shape,
                                     math.sqrt(2.0 / fan_in)))
            elif isinstance(m, nn.LayerNorm):
                m.weight.copy_(randn(m.weight.shape, 0.1, 1.0))
                m.bias.copy_(randn(m.bias.shape, 0.1))
            elif isinstance(m, nn.BatchNorm2d):
                m.weight.copy_(randn(m.weight.shape, 0.1, 1.0))
                m.bias.copy_(randn(m.bias.shape, 0.1))
                m.running_mean.copy_(randn(m.running_mean.shape, 0.1))
                m.running_var.copy_(torch.rand(
                    tuple(m.running_var.shape), device=dev,
                    generator=gen) + 0.5)
        for name, p in model.named_parameters():
            if name.endswith(("q_bias", "v_bias")):
                p.copy_(randn(p.shape, 0.1))
            elif name.endswith("logit_scale"):
                p.copy_(randn(p.shape, 0.5, 2.0))


def make_frames(seed: int, batch: int = 1, h: int = 480, w: int = 640):
    rng = np.random.default_rng(seed)
    # smooth structure + noise, so windows differ from one another
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    frames = []
    for k in range(2):
        base = (127 + 80 * np.sin(xx / (17.0 + 3 * k) + yy / 29.0)
                )[None, :, :, None]
        noise = rng.integers(-40, 40, size=(batch, h, w, 3))
        frames.append(np.clip(base + noise, 0, 255).astype(np.uint8))
    return frames


def flagship_cfg(dtype: str = "bfloat16", attn_impl: str = "cuda",
                 depths=(2, 2, 18, 2), backbone: str = "swin_base_v2"):
    from mmde_tpu_torch.config import ModelConfig, SwinConfig
    swin = SwinConfig(depths=tuple(depths), window_size=(30, 30, 30, 15),
                      pretrain_window_size=(12, 12, 12, 6),
                      use_shift=(True, True, False, False),
                      drop_path_rate=0.3)
    return ModelConfig(backbone=backbone, decoder="decoder_v2",
                       model_scale=32, max_depth=10.0, swin=swin,
                       dtype=dtype, attn_impl=attn_impl)


EXPECT_SHAPES = {"pred_d1": (1, 480, 640, 1), "pred_d2": (1, 480, 640, 1),
                 "pred_r12": (1, 9), "pred_r21": (1, 9),
                 "pred_t12": (1, 3), "pred_t21": (1, 3)}


def check_outputs(out: dict, what: str) -> dict:
    info = {}
    for k, shp in EXPECT_SHAPES.items():
        a = out[k]
        if tuple(a.shape) != shp:
            raise RuntimeError(f"{what}: {k} has shape {a.shape}, not {shp}")
        if not np.isfinite(a).all():
            raise RuntimeError(f"{what}: {k} is not finite")
        info[k] = list(a.shape)
    d = out["pred_d1"]
    if not (d.min() >= 0.0 and d.max() <= 10.0):
        raise RuntimeError(f"{what}: depth outside [0, max_depth]")
    return info


def _kernel_modules() -> dict:
    """{layout: the wrapper module that counts its kernels' launches}"""
    from mmde_tpu_torch.ops import window_attention_headsplit as ths
    from mmde_tpu_torch.ops import window_attention_packed as wap
    from mmde_tpu_torch.ops import window_attention_slab as was
    return {"packed": wap, "headsplit": ths, "slab": was}


def _reset_launch_counts():
    for m in _kernel_modules().values():
        m.reset_launch_counts()


def _launches(backward: bool = False) -> dict:
    """{layout: {(B_, N, C, nH): launches}} since the last reset."""
    attr = "LAUNCHES_BWD_BY_SHAPE" if backward else "LAUNCHES_BY_SHAPE"
    return {lay: dict(getattr(m, attr))
            for lay, m in _kernel_modules().items()}


def _total(by_layout: dict) -> int:
    return sum(n for d in by_layout.values() for n in d.values())


def expected_launches(backbone: str, batch: int, times: int,
                      attn_impl: str = "cuda") -> dict:
    """{layout: {(B_, N, C, nH): launches}} of `times` forwards (or
    backwards): one per block of each stage, in the stage's layout."""
    want = {"packed": {}, "headsplit": {}, "slab": {}}
    for sh in stage_shapes(backbone, batch=batch, attn_impl=attn_impl):
        key = (sh["B_"], sh["N"], sh["C"], sh["nH"])
        want[sh["layout"]][key] = sh["blocks"] * times
    return want


def _per_forward(want: dict, times: int) -> dict:
    return {layout: sum(d.values()) // times for layout, d in want.items()}


@contextlib.contextmanager
def _launch_dtypes(seen: dict):
    """Count the packed, head-split and slab wrappers' launches by (layout,
    direction, operand type) into `seen` for a `with` block (the autograd
    Functions and the served forward call the modules' launch functions by
    name)."""
    layouts = {m: lay for lay, m in _kernel_modules().items()}
    saved = [(m, n, getattr(m, n)) for m in layouts
             for n in ("_launch_forward", "_launch_backward")]

    def counted(fn, key):
        def call(x, *a, **k):
            kk = f"{key} {str(x.dtype).replace('torch.', '')}"
            seen[kk] = seen.get(kk, 0) + 1
            return fn(x, *a, **k)
        return call
    for m, n, fn in saved:
        direction = "forward" if n.endswith("forward") else "backward"
        setattr(m, n, counted(fn, f"{layouts[m]} {direction}"))
    try:
        yield
    finally:
        for m, n, fn in saved:
            setattr(m, n, fn)


def _check_launch_dtypes(tag: str, seen: dict, dtype: str) -> dict:
    """Every packed, head-split and slab launch `seen` ran on operands of
    the model's `dtype`."""
    if any(not k.endswith(" " + dtype) for k in seen):
        raise RuntimeError(f"{tag}: launches by type {seen}, expected "
                           f"{dtype} only")
    return dict(seen)


def phase_serve(backbone: str = "swin_base_v2", requests: int = 3,
                flip: bool = True, tag: str = "serve",
                attn_impl: str = "cuda", dtype: str = "bfloat16") -> dict:
    """`backbone` + decoder_v2 (`dtype`, the flagship's windows and depths,
    attention `attn_impl`) built at full width from a seed, answering
    `requests` requests of two 480x640 frames through tools.infer.predict,
    with every kernel's launch counter read around them; with `flip`, also
    a flip-averaged request."""
    from mmde_tpu_torch.tools import infer
    t0 = time.time()
    model = infer.build(flagship_cfg(dtype, attn_impl, backbone=backbone),
                        device="cuda", seed=0)
    randomize_weights(model, seed=7)
    build_s = time.time() - t0
    n_params = sum(p.numel() for p in model.parameters())
    f1, f2 = make_frames(seed=11)
    infer.predict(model, f1, f2)                          # warm-up request
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    _reset_launch_counts()
    ms, dev_ms, shapes, seen = [], [], None, {}
    for i in range(requests):
        g1, g2 = make_frames(seed=100 + i)
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        t = time.time()
        e0.record()
        with _launch_dtypes(seen):
            out = infer.predict(model, g1, g2)
        e1.record()
        torch.cuda.synchronize()
        ms.append((time.time() - t) * 1e3)
        dev_ms.append(e0.elapsed_time(e1))
        shapes = check_outputs(out, f"{tag} request {i}")
    by_layout = _launches()
    want = expected_launches(backbone, 1, requests, attn_impl)
    if by_layout != want:
        raise RuntimeError(f"{tag}: kernel launches by layout and shape "
                           f"{by_layout} for {requests} forwards, expected "
                           f"{want}")
    by_kernel = _by_kernel()
    want_k = expected_kernels(backbone, 1, requests, False, attn_impl)
    if by_kernel != want_k:
        # every packed launch at the W the JAX rule gives (MMDE_ATTN_W), every
        # packed launch at W = 1 on the tensor cores
        raise RuntimeError(f"{tag}: launches by kernel {by_kernel}, "
                           f"expected {want_k}")
    by_mxu = _check_mxu(tag, by_kernel, getattr(torch, dtype))
    per_forward = _per_forward(want, requests)
    if attn_impl == "cuda_slab" and backbone == "swin_base_v2" and (
            per_forward != {"packed": 0, "headsplit": 0, "slab": 24}):
        # every block of the flagship takes the slab kernels: no route back
        # to the packed or head-split kernel
        raise RuntimeError(f"{tag}: launches per forward {per_forward}, "
                           "expected 24 slab and no packed or head-split")
    depth_std = float(out["pred_d1"].std())
    if depth_std <= 0.1:
        raise RuntimeError(f"{tag}: depth map is near-constant (std "
                           f"{depth_std})")
    rec = {"model": f"{backbone} + decoder_v2, {dtype}, depths 2/2/18/2",
           "attn_impl": attn_impl,
           "params": n_params, "build_seconds": round(build_s, 2),
           "input": "2 x uint8 (1, 480, 640, 3)", "request_ms": ms,
           "request_ms_cuda_events": dev_ms, "outputs": shapes,
           "finite": True, "depth_std": depth_std,
           "launches_per_forward": per_forward,
           "launches_by_shape": {lay: {str(k): v for k, v in d.items()}
                                 for lay, d in by_layout.items()},
           "launches_by_kernel": _str_keys(by_kernel),
           "launches_by_mxu": by_mxu,
           "launches_by_type": _check_launch_dtypes(tag, seen, dtype),
           "peak_memory_bytes": torch.cuda.max_memory_allocated()}
    if flip:
        infer.predict(model, f1, f2, flip_tta=True)       # warm-up
        torch.cuda.synchronize()
        before = _total(_launches())
        t = time.time()
        out_flip = infer.predict(model, f1, f2, flip_tta=True)
        torch.cuda.synchronize()
        rec["flip_request_ms"] = (time.time() - t) * 1e3
        check_outputs(out_flip, f"{tag} flip request")
        n_flip = _total(_launches()) - before
        if n_flip != 2 * sum(per_forward.values()):
            raise RuntimeError(f"{tag}: {n_flip} launches for a "
                               f"flip-averaged request, expected "
                               f"{2 * sum(per_forward.values())}")
        rec["launches_flip_request"] = n_flip
    emit(tag, rec)
    rec["backbone"] = backbone
    rec["_by_shape"] = by_layout
    rec["_attn_impl"] = attn_impl
    del model
    torch.cuda.empty_cache()
    return rec


# Paths A and B, profiled beside the default path on the same model and
# trainer: {tag: (the settings MMDE_ATTN_GRID / MMDE_ATTN_W give
# ops/window_attention_packed.py at import, what runs)}. The wrapper reads
# both module settings at each call, so setting them for a call is the
# variable's path.
PROFILED_PATHS = {
    "profile_resident": ({"DEFAULT_GRID_MODE": "bias_resident"},
                         "Path A (MMDE_ATTN_GRID=bias_resident): K1 without "
                         "lse + K4, on the tensor cores"),
    "profile_w": ({"WINDOWS_PER_CELL": "auto"},
                  "Path B (MMDE_ATTN_W=auto): K5 on the tensor cores at "
                  "the rule's W"),
}


@contextlib.contextmanager
def _packed_settings(settings: dict):
    """Module settings of ops/window_attention_packed.py for a `with` block,
    restored after it."""
    from mmde_tpu_torch.ops import window_attention_packed as wap
    old = {k: getattr(wap, k) for k in settings}
    for k, v in settings.items():
        setattr(wap, k, v)
    try:
        yield
    finally:
        for k, v in old.items():
            setattr(wap, k, v)


def phase_profile(path: str, backbone: str = "swin_base_v2",
                  tag: str = "profile", attn_impl: str = "cuda",
                  paths: dict = None, dtype: str = "bfloat16") -> dict:
    """Optional (--profile PATH): device time by kernel group of one served
    request and of one train step (2 frame pairs) of `backbone` under
    `attn_impl`, in `dtype`. Every row goes to PATH (the served request's
    at top level, the train step's under "train_step"). `paths` ({tag:
    (settings, what)}, PROFILED_PATHS): the same request and step again
    under each path's settings, on the same model and trainer, rows to PATH
    with the tag's suffix (_resident, _w) before its extension."""
    from mmde_tpu_torch.tools import infer
    from mmde_tpu_torch.tools import train_steps as ts
    from mmde_tpu_torch.tools.profile_step import profile_call
    runs = {tag: ({}, None)}
    runs.update(paths or {})
    model = infer.build(flagship_cfg(dtype, attn_impl, backbone=backbone),
                        device="cuda", seed=0)
    randomize_weights(model, seed=7)
    f1, f2 = make_frames(seed=11)
    serve = {}
    for t, (settings, _) in runs.items():
        with _packed_settings(settings):
            for _ in range(2):
                infer.predict(model, f1, f2)
            torch.cuda.synchronize()
            serve[t] = profile_call(lambda: infer.predict(model, f1, f2))
    del model
    torch.cuda.empty_cache()

    state, step = ts.build_trainer(
        ts.flagship_config(dtype, attn_impl=attn_impl, batch_size=2,
                           backbone=backbone), device="cuda", seed=0)
    randomize_weights(state.model, seed=7)
    batch = ts.synthetic_batch(2, 480, 640, seed=31, device="cuda")
    root, ext = os.path.splitext(path)
    out = {}
    for t, (settings, what) in runs.items():
        with _packed_settings(settings):
            for _ in range(2):
                state, _ = step(state, batch)
            torch.cuda.synchronize()
            t0 = time.time()
            train = profile_call(lambda: step(state, batch))
            train["profiled_step_ms_host"] = (time.time() - t0) * 1e3
        p = path if t == tag else f"{root}_{t.split('_', 1)[1]}{ext}"
        os.makedirs(os.path.dirname(os.path.abspath(p)), exist_ok=True)
        with open(p, "w") as f:
            json.dump({**serve[t], "train_step": train}, f, indent=1)
        rec = {k: v for k, v in serve[t].items() if k != "rows"}
        rec["train_step"] = {k: v for k, v in train.items() if k != "rows"}
        if what is not None:
            rec.update(path=what, settings=settings)
        emit(t, rec)
        out[t] = rec
    del state, step
    torch.cuda.empty_cache()
    return out[tag]


# outputs of the plain path ("torch"), which parity and parity_slab share:
# {(phase, backbone, dtype or frame pairs): result}
_PLAIN_RUNS: dict = {}
# the parity phases' models and trainers, built once per (backbone, dtype)
# and switched between attention paths in place (the modules read attn_impl
# at each forward): the same weights for every path, no rebuild
_PARITY_MODELS: dict = {}


def _set_attn_impl(model, impl: str) -> None:
    from mmde_tpu_torch.nn.swin_v2 import WindowAttention
    for m in model.modules():
        if isinstance(m, WindowAttention):
            m.attn_impl = impl


def _parity_model(backbone: str, dtype: str):
    """The served model for the parity phases (depths PARITY_DEPTHS),
    weights drawn from seed 7."""
    from mmde_tpu_torch.tools import infer
    key = ("model", backbone, dtype)
    if key not in _PARITY_MODELS:
        model = infer.build(flagship_cfg(dtype, "cuda", PARITY_DEPTHS,
                                         backbone=backbone),
                            device="cuda", seed=0)
        randomize_weights(model, seed=7)
        _PARITY_MODELS[key] = model
    return _PARITY_MODELS[key]


def _parity_trainer(backbone: str, pairs: int,
                    dtype: str = "float32") -> list:
    """[state, step, initial weights and buffers, batch] of the
    deterministic trainer (`dtype`) the train-parity phases step from."""
    from mmde_tpu_torch.tools import train_steps as ts
    key = ("trainer", backbone, pairs, dtype)
    if key not in _PARITY_MODELS:
        cfg = ts.flagship_config(dtype, "cuda", PARITY_DEPTHS,
                                 batch_size=pairs, backbone=backbone)
        state, step = ts.build_trainer(cfg, device="cuda", seed=0,
                                       deterministic=True)
        randomize_weights(state.model, seed=7)
        init = {n: t.detach().clone()
                for n, t in state.model.state_dict().items()}
        batch = ts.synthetic_batch(pairs, 480, 640, seed=33, device="cuda")
        _PARITY_MODELS[key] = [state, step, init, batch]
    return _PARITY_MODELS[key]


def phase_parity(backbone: str = "swin_base_v2",
                 dtypes=("float32", "bfloat16"), tag: str = "parity",
                 impl: str = "cuda") -> dict:
    """Kernel path (`impl`) vs plain path through the whole model (depths
    PARITY_DEPTHS); every launch of the kernel path a tensor-core kernel.
    fp32 convolutions go through cuDNN in TF32 by default; for this phase
    TF32 is switched off so that both paths are true fp32 outside the
    attention."""
    from mmde_tpu_torch.tools import infer
    old = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    f1, f2 = make_frames(seed=21)
    torch.cuda.empty_cache()
    res = {"cudnn_allow_tf32": False, "attn_impl": impl,
           "depths": list(PARITY_DEPTHS)}
    try:
        for dtype in dtypes:
            outs = {}
            for path in (impl, "torch"):
                key = ("parity", backbone, dtype)
                if path == "torch" and key in _PLAIN_RUNS:
                    outs[path] = _PLAIN_RUNS[key]
                    continue
                model = _parity_model(backbone, dtype)
                _set_attn_impl(model, path)
                _reset_launch_counts()
                outs[path] = infer.predict(model, f1, f2)
                check_outputs(outs[path], f"parity {dtype} {path}")
                if path == "torch":
                    _PLAIN_RUNS[key] = outs[path]
                else:
                    launches = {k: sum(d.values())
                                for k, d in _by_kernel().items()}
            std = float(outs["torch"]["pred_d1"].std())
            if std <= 0.1:
                raise RuntimeError(f"parity {dtype}: depth map is "
                                   f"near-constant (std {std})")
            diffs = {k: float(np.abs(outs[impl][k].astype(np.float64)
                                     - outs["torch"][k]).max())
                     for k in EXPECT_SHAPES}
            tol = TOL_MODEL[dtype]
            for k, v in diffs.items():
                lim = tol["depth"] if k.startswith("pred_d") else tol["pose"]
                if not v <= lim:
                    raise RuntimeError(f"parity {dtype}: {k} differs by {v} "
                                       f"> {lim}")
            mean_d = float(np.abs(outs[impl]["pred_d1"]
                                  - outs["torch"]["pred_d1"]).mean())
            if not mean_d <= tol.get("depth_mean", tol["depth"]):
                raise RuntimeError(f"parity {dtype}: pred_d1 differs by "
                                   f"{mean_d} on average")
            # every launch of either type on the tensor cores
            if not launches or any("_tc" not in k for k in launches):
                raise RuntimeError(f"parity {dtype}: kernel path's launches "
                                   f"{launches}, expected tensor-core "
                                   "kernels only")
            res[dtype] = {"max_abs_diff": diffs, "mean_abs_diff_d1": mean_d,
                          "depth_std": std, "tolerance": tol,
                          "launches": launches}
    finally:
        torch.backends.cudnn.allow_tf32 = old
    if tag:
        emit(tag, res)
    return res


# train_parity: one fp32 step, kernel path vs plain path. The two differ by
# the order of fp32 sums inside the attention (forward ~1e-6 per block,
# backward ~1e-5, see TOL_BWD). The forward difference reaches the outputs
# at ~5e-6 relative, and the gradients amplify it: the decoder conv, whose
# gradient passes through no attention backward at all, already differs by
# 1e-4; qkv / RPE weights by 5e-4..9e-4; logit_scale gradients (cancelling
# sums) by 6e-4..2.3e-3 (measured, H100).
TOL_TRAIN_PARITY = {"loss_rel": 1e-4, "grad_rel_l2": 5e-3}
# The same step in bfloat16 (parity_large's bf16 case, stage-1 gradients,
# which only the head-split backward reaches): the plain path rounds p to
# bf16 before p v and takes autograd through bf16 tensors, the kernels keep
# p and ds in fp32, the output rounded once - the forward's difference that
# TOL_MODEL["bfloat16"] bounds, carried into a loss and its gradients. The
# two bf16 paths' gradients differ by what bf16 leaves of them (measured
# 4.4e-2 .. 6.7e-2 rel-L2, H100), so they are held to the same step in
# float32 (plain path) instead: every parameter's kernel-path gradient
# within `to_float32_ratio` times the distance of the plain bf16 path's
# farthest one (measured on an H100: plain 4.8e-2 .. 1.7e-1, kernel 7.4e-2
# .. 1.2e-1; a cancelling sum such as dlogit_scale falls on either side
# parameter by parameter); the loss to `loss_rel`.
TOL_TRAIN_PARITY_BF16 = {"loss_rel": 1e-2, "to_float32_ratio": 1.5}
PARITY_PARAMS = (
    "encoder.layers.0.blocks.1.attn.qkv.weight",
    "encoder.layers.2.blocks.5.attn.rpe_mlp.0.weight",
    "encoder.layers.0.blocks.0.attn.logit_scale",
    "encoder.layers.1.blocks.1.attn.logit_scale",
    "encoder.layers.2.blocks.9.attn.logit_scale",
    "encoder.layers.3.blocks.0.attn.logit_scale",
    "decoder.decoder_depth.conv_layers.0.weight",
)


# the parity phases' depths: stage 3 cut from 18 blocks to 10 (every layout
# and kernel of the full model still runs; blocks 0-9 hold PARITY_PARAMS),
# to keep the whole script inside its time
PARITY_DEPTHS = (2, 2, 10, 2)

# stage 1 of swin_large runs the head-split backward: its RPE MLP and q bias
LARGE_PARITY_PARAMS = PARITY_PARAMS + (
    "encoder.layers.0.blocks.1.attn.rpe_mlp.0.weight",
    "encoder.layers.0.blocks.0.attn.q_bias")
# the stage-1 parameters among them: parity_large's bf16 gradients
LARGE_STAGE1_PARAMS = tuple(n for n in LARGE_PARITY_PARAMS
                            if n.startswith("encoder.layers.0."))


def phase_train(backbone: str = "swin_base_v2", steps: int = 6,
                pairs: int = 2, deterministic_run: bool = True,
                tag: str = "train", attn_impl: str = "cuda",
                dtype: str = "bfloat16") -> dict:
    """The trainer on the card: `steps` steps of make_train_step at `pairs`
    frame pairs (`dtype`, train mode, drop path 0.3, seeded generator,
    attention `attn_impl`) on one synthetic batch, every kernel's launches
    counted per step; then, with `deterministic_run`, a short deterministic
    run whose loss must fall."""
    from mmde_tpu_torch.tools import train_steps as ts
    cfg = ts.flagship_config(dtype, attn_impl, batch_size=pairs,
                             backbone=backbone)
    t0 = time.time()
    state, step = ts.build_trainer(cfg, device="cuda", seed=0)
    randomize_weights(state.model, seed=7)
    build_s = time.time() - t0
    batch = ts.synthetic_batch(pairs, 480, 640, seed=31, device="cuda")
    watch = {n: p.detach().clone() for n, p in state.model.named_parameters()
             if n in LARGE_PARITY_PARAMS}
    per_step = _per_forward(expected_launches(backbone, pairs, 1,
                                              attn_impl), 1)
    if attn_impl == "cuda_slab" and backbone == "swin_base_v2" and (
            per_step != {"packed": 0, "headsplit": 0, "slab": 24}):
        raise RuntimeError(f"{tag}: expected 24 slab launches a step and no "
                           f"packed or head-split, planned {per_step}")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    _reset_launch_counts()
    losses, ms, seen = [], [], {}
    for i in range(steps):
        before = (_launches(), _launches(backward=True))
        torch.cuda.synchronize()
        t = time.time()
        with _launch_dtypes(seen):
            state, aux = step(state, batch)
        torch.cuda.synchronize()
        ms.append((time.time() - t) * 1e3)
        aux = {k: float(v) for k, v in aux.items()}
        if not all(math.isfinite(v) for v in aux.values()):
            raise RuntimeError(f"{tag} step {i}: loss not finite: {aux}")
        losses.append(aux)
        for bwd, prev in ((False, before[0]), (True, before[1])):
            now = _launches(backward=bwd)
            got = {lay: sum(now[lay].values()) - sum(prev[lay].values())
                   for lay in now}
            if got != per_step:
                raise RuntimeError(
                    f"{tag} step {i}: {'backward' if bwd else 'forward'} "
                    f"launches by layout {got}, expected {per_step}")
    fwd_by_shape, bwd_by_shape = _launches(), _launches(backward=True)
    want = expected_launches(backbone, pairs, steps, attn_impl)
    if fwd_by_shape != want or bwd_by_shape != want:
        raise RuntimeError(f"{tag}: forward launches {fwd_by_shape}, "
                           f"backward {bwd_by_shape}, expected {want} each")
    by_kernel = _by_kernel()
    want_k = expected_kernels(backbone, pairs, steps, True, attn_impl)
    if by_kernel != want_k:
        raise RuntimeError(f"{tag}: launches by kernel {by_kernel}, "
                           f"expected {want_k}")
    by_mxu = _check_mxu(tag, by_kernel, getattr(torch, dtype))
    peak = torch.cuda.max_memory_allocated()
    moved = {n: float((p.detach() - watch[n]).abs().max())
             for n, p in state.model.named_parameters() if n in watch}
    if not all(v > 0 for v in moved.values()):
        raise RuntimeError(f"{tag}: parameters did not change: {moved}")
    steady = ms[1:]
    rec = {"model": f"{backbone} + decoder_v2, {dtype}, depths 2/2/18/2, "
                    "train mode, drop path 0.3, remat none",
           "attn_impl": attn_impl, "frame_pairs": pairs, "steps": steps,
           "params": sum(p.numel() for p in state.model.parameters()),
           "build_seconds": round(build_s, 2), "losses": losses,
           "first_step_ms": ms[0], "step_ms": steady,
           "step_ms_median": statistics.median(steady),
           "images_per_s": 2 * pairs / (statistics.median(steady) / 1e3),
           "launches_fwd_per_step": per_step,
           "launches_bwd_per_step": per_step,
           "launches_fwd_by_shape": {lay: {str(k): v for k, v in d.items()}
                                     for lay, d in fwd_by_shape.items()},
           "launches_bwd_by_shape": {lay: {str(k): v for k, v in d.items()}
                                     for lay, d in bwd_by_shape.items()},
           "launches_by_kernel": _str_keys(by_kernel),
           "launches_by_mxu": by_mxu,
           "launches_by_type": _check_launch_dtypes(tag, seen, dtype),
           "param_max_abs_change": moved, "peak_memory_bytes": peak}
    del state, step
    torch.cuda.empty_cache()

    if deterministic_run:
        # eval-mode modules, same batch every step -> loss falls
        state, step = ts.build_trainer(cfg, device="cuda", seed=0,
                                       deterministic=True)
        randomize_weights(state.model, seed=7)
        det = []
        for _ in range(4):
            state, aux = step(state, batch)
            det.append(float(aux["loss_total"]))
        if not (all(math.isfinite(v) for v in det) and det[-1] < det[0]):
            raise RuntimeError(f"{tag} deterministic run: loss did not "
                               f"fall: {det}")
        rec["deterministic_loss_total"] = det
        del state, step
        torch.cuda.empty_cache()
    emit(tag, rec)
    rec["backbone"] = backbone
    rec["_attn_impl"] = attn_impl
    rec["_bwd_by_shape"] = bwd_by_shape
    rec["_fwd_by_shape"] = fwd_by_shape
    return rec


def phase_train_parity(backbone: str = "swin_base_v2", pairs: int = 1,
                       params=PARITY_PARAMS, tag: str = "train_parity",
                       impl: str = "cuda", dtype: str = "float32") -> dict:
    """One deterministic step (fp32, or `dtype`) at full width (depths
    PARITY_DEPTHS), kernel path (`impl`) against plain path from the same
    weights and batch: the loss and the gradients of a named set of
    parameters, at TOL_TRAIN_PARITY (bf16: TOL_TRAIN_PARITY_BF16, the
    gradients against the float32 step's). cuDNN TF32 is off for this
    phase (matmul TF32 is off by default)."""
    tol = TOL_TRAIN_PARITY if dtype == "float32" else TOL_TRAIN_PARITY_BF16
    (la, ga), (lb, gb) = (train_step_grads(backbone, pairs, path, dtype)
                          for path in (impl, "torch"))
    ga = {n: t for n, t in ga.items() if n in params}
    gb = {n: t for n, t in gb.items() if n in params}
    if set(ga) != set(params):
        raise RuntimeError(f"parity parameters missing: "
                           f"{set(params) - set(ga)}")
    loss_rel = abs(la["loss_total"] - lb["loss_total"]) / abs(lb["loss_total"])
    grad_rel = {n: float((ga[n] - gb[n]).norm()
                         / gb[n].norm().clamp_min(1e-300)) for n in ga}
    launches = _STEP_LAUNCHES[("train_step", backbone, pairs, impl, dtype)]
    rec = {"model": backbone, "dtype": dtype, "frame_pairs": pairs,
           "depths": list(PARITY_DEPTHS), "cudnn_allow_tf32": False,
           "attn_impl": impl, "loss_cuda": la, "loss_torch": lb,
           "loss_rel_diff": loss_rel,
           "grad_rel_l2": grad_rel,
           "grad_norm": {n: float(gb[n].norm()) for n in gb},
           "launches": launches, "tolerance": tol}
    # "cuda" / "cuda_slab": every packed, head-split and slab launch of
    # either type on the tensor cores, none on an FMA body
    if impl != "torch" and (not launches or any(
            "_tc" not in k for k in launches)):
        raise RuntimeError(f"train parity: kernel path's launches "
                           f"{launches}, expected tensor-core kernels only")
    if not loss_rel <= tol["loss_rel"]:
        raise RuntimeError(f"train parity: loss differs: {json.dumps(rec)}")
    if dtype != "float32":
        # each path's distance to the float32 step's gradients
        _, g32 = train_step_grads(backbone, pairs, "torch", "float32")
        rec["grad_rel_l2_to_float32"] = {
            n: {path: float((g[n] - g32[n]).norm() / g32[n].norm())
                for path, g in ((impl, ga), ("torch", gb))} for n in ga}
    for n, v in grad_rel.items():
        if dtype == "float32":
            ok = v <= tol["grad_rel_l2"]
        else:
            d = rec["grad_rel_l2_to_float32"]
            ok = d[n][impl] <= tol["to_float32_ratio"] * max(
                e["torch"] for e in d.values())
        if not (ok and float(gb[n].norm()) > 0):
            raise RuntimeError(f"train parity: gradient of {n} differs or is "
                               f"zero: {json.dumps(rec)}")
    if tag:
        emit(tag, rec)
    return rec


def k7_block0() -> dict:
    """The bf16 swin_large stage-1 dlogit_scale of parity_large's bf16 step
    (ROADMAP Queue C): block 0's attention inputs - q, k, v, logit_scale,
    bias, mask and the gradient of its output - captured from that step's
    kernel path (the deterministic trainer, the same weights and batch);
    on those exact inputs K7' (the head-split tensor-core backward, through
    the autograd Function) and the plain bf16 path (the "torch"
    attention's autograd in bf16) against float64 autograd of the plain
    forward: dlogit_scale (rel-L2 over the heads and max abs), dq / dk / dv
    and dbias (rel-L2). Raises if K7' lies more than twice as far from
    float64 as the plain bf16 path and outside TOL_BWD's bf16 limit."""
    from mmde_tpu_torch.ops import window_attention_headsplit as ths
    from mmde_tpu_torch.ops.window_attention import cosine_window_attention
    state, step, init, batch = _parity_trainer("swin_large_v2", 1,
                                               "bfloat16")
    fn = ths._HeadSplitWindowAttention
    apply, cap = fn.apply, {}

    def spy(*args):
        out = apply(*args)
        if not cap:
            cap["x"] = [a.detach().clone() if torch.is_tensor(a) else a
                        for a in args[:6]]
            out.register_hook(lambda g: cap.setdefault("g", g.detach()
                                                       .clone()))
        return out
    old = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    with torch.no_grad():
        state.model.load_state_dict(init)
    _set_attn_impl(state.model, "cuda")
    fn.apply = spy
    try:
        step(state, batch)
        torch.cuda.synchronize()
    finally:
        del fn.apply
        torch.backends.cudnn.allow_tf32 = old
        with torch.no_grad():
            state.model.load_state_dict(init)
    (q, k, v, ls, bias, mask), g = cap["x"], cap["g"]

    def grads(attn, dt=None, **kw):
        leaves = [t.detach().to(dt or t.dtype).requires_grad_()
                  for t in (q, k, v, ls, bias)]
        m = None if mask is None else mask.to(dt or mask.dtype)
        out = attn(*leaves, m, **kw)
        return torch.autograd.grad(out, leaves, g.to(out.dtype))
    truth = grads(ths.cosine_window_attention_headsplit_plain, torch.float64,
                  compute_dtype=torch.float64)
    rec = {"model": "swin_large_v2", "block": "encoder.layers.0.blocks.0",
           "B_": q.shape[0], "N": q.shape[2], "nH": q.shape[1],
           "dtype": str(q.dtype).replace("torch.", ""),
           "masked": mask is not None,
           "logit_scale": [float(x) for x in ls.flatten()]}
    for path, attn in (("k7_tensor_core", ths.cosine_window_attention_headsplit),
                       ("plain_bf16", cosine_window_attention)):
        got = grads(attn)
        dls = _errs(got[3], truth[3])
        rec[path] = {"dlogit_scale": dls,
                     "dlogit_scale_by_head": [float(x) for x in
                                              got[3].flatten()],
                     "dqkv": _errs(torch.stack(got[:3]),
                                   torch.stack(truth[:3])),
                     "dbias": _errs(got[4], truth[4])}
    rec["float64_dlogit_scale_by_head"] = [float(x) for x in
                                           truth[3].flatten()]
    k7 = rec["k7_tensor_core"]["dlogit_scale"]["rel_l2"]
    plain = rec["plain_bf16"]["dlogit_scale"]["rel_l2"]
    rec["k7_over_plain"] = k7 / max(plain, 1e-300)
    rec["ok"] = k7 <= max(2.0 * plain, TOL_BWD["bfloat16"]["dlogit_scale"])
    if not rec["ok"]:
        raise RuntimeError(f"K7' dlogit_scale on block 0's inputs: "
                           f"{json.dumps(rec)}")
    del cap, truth
    torch.cuda.empty_cache()
    return rec


def _entry(name, shape, source, replaces, n, c, pairs=1,
           dtype="bf16") -> dict:
    where = (f"[{shape['model'].rsplit('_', 1)[0]} stage{shape['stage']} "
             f"B_={shape['B_']} N={shape['N']} C={shape['C']} "
             f"nH={shape['nH']} {dtype}{' mask' if shape['nW'] else ''}"
             f"{' train' if pairs > 1 else ''}")
    if shape["layout"] == "slab":
        where += " map {}x{}x{}".format(shape["images"], *shape["padded"])
    where += "]"
    if n == 0:
        raise RuntimeError(f"the path never launched {name}{where}")
    entry = {"name": name + where, "route": "cuda", "source": source,
             "replaces": replaces, "launches": n,
             "max_abs_err": c["max_abs_err"], "rel_l2_err": c["rel_l2_err"],
             "ms": c["ms"], "plain_ms": c["plain_ms"],
             "bound_ms": c["bound_ms"], "bound_by": c["bound_by"],
             "library_ms": c["library_ms"]}
    # the yardstick's own numbers: the normalisation it needs first and the
    # SDPA backend that ran; for the tensor-core kernels the fp32-FMA body's
    # time in the same call and the products' bound at the mma.sync rate
    entry.update({k: c[k] for k in ("library_norm_ms", "library_backend",
                                    "fma_ms", "tc_units", "tc_bound_ms",
                                    "tc_rate_TFLOP_s")
                  if k in c})
    return entry


def _tc_case(tc_cases, shape, pairs, mxu="fold", dtype="bfloat16"):
    """kernel_cases_tc's case at this flagship shape (None elsewhere)."""
    return next((c for c in tc_cases
                 if c["model"] == shape["model"]
                 and c["stage"] == shape["stage"] and c["dtype"] == dtype
                 and c["frame_pairs"] == pairs and c["mxu"] == mxu), None)


def _find(cases, shape, pairs, dtype="bfloat16", **want):
    return next(c for c in cases
                if c["model"] == shape["model"]
                and c["stage"] == shape["stage"] and c["dtype"] == dtype
                and c.get("frame_pairs", 1) == pairs
                and all(c[k] == v for k, v in want.items()))


def contract_serve(k1_cases: list, hs_cases: list, slab_cases: list,
                   serve: dict, tc_cases: list,
                   dtype: str = "bfloat16") -> list:
    """One entry per (kernel, served shape): the served model is `dtype`
    (bfloat16, or float32 for serve_large_fp32 and serve_slab_fp32),
    stages 1-2 alternate unmasked and masked blocks (the masked case is
    listed), stages 3-4 are unmasked. Packed stages: the tensor-core
    forward, with kernel_cases_tc's numbers (the model's mode, "fold" /
    "fp32") at the flagship's shapes, kernel_cases' elsewhere; slab stages
    kernel_cases_slab's in the model's type."""
    entries = []
    label = "fp32" if dtype == "float32" else "bf16"
    for shape in stage_shapes(serve["backbone"],
                              attn_impl=serve["_attn_impl"]):
        key = (shape["B_"], shape["N"], shape["C"], shape["nH"])
        n = serve["_by_shape"][shape["layout"]].get(key, 0)
        nW = shape["nW"]
        if shape["layout"] == "slab":
            c = _find(slab_cases, shape, 1, dtype, nW=nW)["forward"]
            entries.append(_entry("window_attention_slab_fwd_tc", shape,
                                  KERNEL_TC_SOURCE, KERNEL_SLAB_REPLACES, n,
                                  c, dtype=label))
        elif shape["layout"] == "packed":
            c = _tc_case(tc_cases, shape, 1, "fp32" if label == "fp32"
                         else "fold", dtype) or next(
                c for c in k1_cases
                if c["model"] == shape["model"]
                and c["stage"] == shape["stage"]
                and c["dtype"] == dtype
                and c["softmax"] == "maxfree" and (c["nW"] > 0) == (nW > 0))
            entries.append(_entry("window_attention_fwd_tc", shape,
                                  KERNEL_TC_SOURCE, KERNEL_REPLACES, n, c,
                                  dtype=label))
        else:
            c = _find(hs_cases, shape, 1, dtype, nW=nW)["forward"]
            entries.append(_entry("window_attention_headsplit_fwd_tc", shape,
                                  KERNEL_TC_SOURCE, KERNEL_HS_REPLACES, n, c,
                                  dtype=label))
    for e in entries:
        e["dtype"] = dtype
    return entries


def contract_train(k2_cases: list, hs_cases: list, slab_cases: list,
                   train: dict, tc_cases: list,
                   dtype: str = "bfloat16") -> list:
    """Two entries per trained shape, the forward through its training entry
    point (output and log-sum-exp) and the backward: the trained model is
    `dtype` (bfloat16, or float32 for train_large_fp32 and
    train_slab_fp32) at 2 frame pairs,
    stages 1-2 masked in every other block (the masked case is listed).
    Errors: the forward's output against the plain forward, the backward's
    dqkv against float64 autograd."""
    entries = []
    pairs = train["frame_pairs"]
    label = "fp32" if dtype == "float32" else "bf16"
    mode = "fp32" if label == "fp32" else "fold"
    for shape in stage_shapes(train["backbone"], batch=pairs,
                              attn_impl=train["_attn_impl"]):
        key = (shape["B_"], shape["N"], shape["C"], shape["nH"])
        lay = shape["layout"]
        nf = train["_fwd_by_shape"][lay].get(key, 0)
        nb = train["_bwd_by_shape"][lay].get(key, 0)
        if lay == "slab":
            # the tensor-core kernels (either type), kernel_cases_slab's
            # numbers
            c = _find(slab_cases, shape, pairs, dtype, nW=shape["nW"])
            entries.append(_entry("window_attention_slab_fwd_tc+lse", shape,
                                  KERNEL_TC_SOURCE, KERNEL_SLAB_REPLACES, nf,
                                  c["forward_stats"], pairs, dtype=label))
            e = _entry("window_attention_slab_bwd_tc", shape,
                       KERNEL_TC_BWD_SOURCE, KERNEL_SLAB_BWD_REPLACES, nb, c,
                       pairs, dtype=label)
            e["ms_no_dbias"] = c["ms_no_dbias"]
        elif lay == "packed":
            # the tensor-core kernels: kernel_cases_tc's numbers (the
            # model's mode) at the flagship's shapes, kernel_cases_backward's
            # elsewhere
            c = _find(k2_cases, shape, pairs, dtype)
            t = _tc_case(tc_cases, shape, pairs, mode, dtype) or c
            entries.append(_entry("window_attention_fwd_tc+lse", shape,
                                  KERNEL_TC_SOURCE, KERNEL_REPLACES, nf,
                                  t["forward"], pairs, dtype=label))
            e = _entry("window_attention_bwd_tc", shape, KERNEL_TC_BWD_SOURCE,
                       KERNEL_BWD_REPLACES, nb, t, pairs, dtype=label)
            if "ms_no_dbias" in t:
                e["ms_no_dbias"] = t["ms_no_dbias"]
            # the backward under "split": the passes and K3 (its own
            # entries: contract_k3)
            e["ms_split_dbias"] = c["ms_split"]
        else:
            # the tensor-core kernels (either type),
            # kernel_cases_headsplit's numbers
            c = _find(hs_cases, shape, pairs, dtype, nW=shape["nW"])
            entries.append(_entry("window_attention_headsplit_fwd_tc+lse",
                                  shape, KERNEL_TC_SOURCE, KERNEL_HS_REPLACES,
                                  nf, c["forward_stats"], pairs,
                                  dtype=label))
            e = _entry("window_attention_headsplit_bwd_tc", shape,
                       KERNEL_TC_BWD_SOURCE, KERNEL_HS_BWD_REPLACES, nb, c,
                       pairs, dtype=label)
            e["ms_no_dbias"] = c["ms_no_dbias"]
        entries.append(e)
    for e in entries:
        e["dtype"] = dtype
    return entries


def contract_k3(cases: list, train_split: dict, *, slab: bool = False
                ) -> list:
    """The tensor-core K3 on the bf16 flagship's step under
    MMDE_ATTN_GRID=split, one entry per stage shape (2 frame pairs, stages
    1-2 masked): launches from train_split (its slab step's when `slab`);
    error against float64, K3 alone on the dq pass's delta, K3's plain
    version's time, its bound and its products' bound from the bf16 case
    at that shape of kernel_cases_backward (packed: fma_ms the FMA body in
    turns) or, with `slab`, of kernel_cases_slab (K3 over MapRows; its
    plain version the packed layout's on the partitioned windows). No
    PyTorch call computes dbias alone (library_ms null)."""
    pairs = train_split["frame_pairs"]
    if slab:
        name, replaces = ("window_attention_slab_dbias_tc",
                          KERNEL_SLAB_BWD_REPLACES)
        by_kernel = train_split["slab"]["_by_kernel"]
        shapes = stage_shapes(batch=pairs, attn_impl="cuda_slab")
    else:
        name, replaces = "window_attention_dbias_tc", KERNEL_K3_REPLACES
        by_kernel = train_split["_by_kernel"]
        shapes = stage_shapes(batch=pairs)
    entries = []
    for shape in shapes:
        key = (shape["B_"], shape["N"], shape["C"], shape["nH"])
        c = _find(cases, shape, pairs)
        k3 = c["k3"]["vs_float64"]
        rec = {"max_abs_err": k3["max_abs"], "rel_l2_err": k3["rel_l2"],
               "ms": c["k3_ms"], "plain_ms": c["k3_plain_ms"],
               "bound_ms": c["k3_bound"]["bound_ms"],
               "bound_by": c["k3_bound"]["bound_by"], "library_ms": None}
        if not slab:
            rec["fma_ms"] = c["k3_fma_ms"]
        rec.update({k: c["k3_tc"][k] for k in ("tc_units", "tc_bound_ms",
                                                "tc_rate_TFLOP_s")})
        e = _entry(name, shape, KERNEL_TC_BWD_SOURCE, replaces,
                   by_kernel.get(name, {}).get(key, 0), rec, pairs)
        e.update(dtype="bfloat16",
                 bitwise_equal_over_two_launches=c["k3"][
                     "bitwise_equal_over_two_launches"])
        if slab:
            e["layout"] = "MapRows"
        entries.append(e)
    return entries


def contract_fp32_w1(serve: dict, train: dict, tc_cases: list) -> list:
    """The fp32 flagship's K1 (served), K1+lse and K2 (trained, 2 frame
    pairs) on the tensor cores, dtype float32: launches from serve_fp32 /
    train_fp32, errors, times and bounds from kernel_cases_tc's fp32 cases
    in mode "fp32" (the fp32 model's) at the same shapes, the fp32-FMA body
    in the same call (fma_ms) and the fp32 library call."""
    entries = []
    for shape in stage_shapes(batch=1):
        key = (shape["B_"], shape["N"], shape["C"], shape["nH"])
        c = _tc_case(tc_cases, shape, 1, "fp32", "float32")
        entries.append(_entry("window_attention_fwd_tc", shape,
                              KERNEL_TC_SOURCE, KERNEL_REPLACES,
                              serve["_by_shape"]["packed"].get(key, 0), c,
                              dtype="fp32"))
    for shape in stage_shapes(batch=train["frame_pairs"]):
        key = (shape["B_"], shape["N"], shape["C"], shape["nH"])
        t = _tc_case(tc_cases, shape, train["frame_pairs"], "fp32",
                     "float32")
        entries.append(_entry("window_attention_fwd_tc+lse", shape,
                              KERNEL_TC_SOURCE, KERNEL_REPLACES,
                              train["_fwd_by_shape"]["packed"].get(key, 0),
                              t["forward"], train["frame_pairs"],
                              dtype="fp32"))
        e = _entry("window_attention_bwd_tc", shape, KERNEL_TC_BWD_SOURCE,
                   KERNEL_BWD_REPLACES,
                   train["_bwd_by_shape"]["packed"].get(key, 0), t,
                   train["frame_pairs"], dtype="fp32")
        e["ms_no_dbias"] = t["ms_no_dbias"]
        entries.append(e)
    for e in entries:
        e["dtype"] = "float32"
    return entries


# configs/convergence_gate_swin.yaml's model, trained at 2 frame pairs:
# stages 1-2 (C 96 / 192) head-split, 3-4 (C 384 / 768) packed at N = 36
# and N = 9
TINY_PARITY_PARAMS = (
    "encoder.layers.0.blocks.1.attn.qkv.weight",
    "encoder.layers.1.blocks.0.attn.logit_scale",
    "encoder.layers.2.blocks.1.attn.qkv.weight",
    "encoder.layers.2.blocks.3.attn.rpe_mlp.0.weight",
    "encoder.layers.2.blocks.5.attn.logit_scale",
    "encoder.layers.3.blocks.0.attn.logit_scale",
    "encoder.layers.3.blocks.1.attn.qkv.weight",
    "decoder.decoder_depth.conv_layers.0.weight",
)


def phase_train_parity_tiny(pairs: int = 2) -> dict:
    """One deterministic fp32 step of configs/convergence_gate_swin.yaml's
    model (swin_tiny_v2 + decoder_v2, depths 2/2/6/2, windows 6/6/6/3, its
    96x128 crop, `pairs` frame pairs, weights from seed 7), kernel path
    against plain path from the same weights and batch: the loss and the
    gradients of TINY_PARITY_PARAMS at TOL_TRAIN_PARITY, cuDNN TF32 off.
    The kernel path's launches: the packed stages (3-4, N 36 and 9, below
    one 64-row tile) on the tensor-core K1+lse / K2, the head-split stages
    (1-2) on the tensor-core K6'+lse / K7' - no FMA body in the step."""
    from mmde_tpu_torch.config import load_yaml
    from mmde_tpu_torch.tools import train_steps as ts
    root = os.path.dirname(os.path.abspath(__file__))
    cfg = load_yaml(os.path.join(root, "configs",
                                 "convergence_gate_swin.yaml"))
    if cfg.model.dtype != "float32":
        raise RuntimeError(f"train_parity_tiny: the config's type is "
                           f"{cfg.model.dtype}, not float32")
    old = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        state, step = ts.build_trainer(cfg, device="cuda", seed=0,
                                       deterministic=True)
        randomize_weights(state.model, seed=7)
        init = {n: t.detach().clone()
                for n, t in state.model.state_dict().items()}
        batch = ts.synthetic_batch(pairs, 96, 128, seed=35, device="cuda")
        res, launches = {}, {}
        for path in ("cuda", "torch"):
            with torch.no_grad():
                state.model.load_state_dict(init)
            _set_attn_impl(state.model, path)
            _reset_launch_counts()
            state, aux = step(state, batch)
            torch.cuda.synchronize()
            launches[path] = _str_keys(_by_kernel())
            res[path] = ({k: float(v) for k, v in aux.items()},
                         {n: p.grad.detach().double().clone()
                          for n, p in state.model.named_parameters()
                          if n in TINY_PARITY_PARAMS})
    finally:
        torch.backends.cudnn.allow_tf32 = old
    del state, step
    torch.cuda.empty_cache()
    (la, ga), (lb, gb) = res["cuda"], res["torch"]
    if set(ga) != set(TINY_PARITY_PARAMS):
        raise RuntimeError(f"train_parity_tiny: parameters missing: "
                           f"{set(TINY_PARITY_PARAMS) - set(ga)}")
    depths = cfg.model.swin.depths
    want = {"window_attention_fwd_tc+lse": depths[2] + depths[3],
            "window_attention_bwd_tc": depths[2] + depths[3],
            "window_attention_headsplit_fwd_tc+lse": depths[0] + depths[1],
            "window_attention_headsplit_bwd_tc": depths[0] + depths[1]}
    got = {k: sum(d.values()) for k, d in launches["cuda"].items()}
    loss_rel = abs(la["loss_total"] - lb["loss_total"]) / abs(lb["loss_total"])
    grad_rel = {n: float((ga[n] - gb[n]).norm()
                         / gb[n].norm().clamp_min(1e-300)) for n in ga}
    rec = {"model": "swin_tiny_v2 + decoder_v2 (configs/"
                    "convergence_gate_swin.yaml), float32, depths "
                    f"{'/'.join(map(str, depths))}, windows "
                    f"{'/'.join(map(str, cfg.model.swin.window_size))}",
           "input": f"{pairs} frame pairs, 96x128", "cudnn_allow_tf32": False,
           "launches": launches["cuda"], "loss_cuda": la, "loss_torch": lb,
           "loss_rel_diff": loss_rel, "grad_rel_l2": grad_rel,
           "grad_norm": {n: float(gb[n].norm()) for n in gb},
           "tolerance": TOL_TRAIN_PARITY}
    emit("train_parity_tiny", rec)
    if got != want or launches["torch"]:
        raise RuntimeError(f"train_parity_tiny: launches {got} (plain path "
                           f"{launches['torch']}), expected {want}")
    if not loss_rel <= TOL_TRAIN_PARITY["loss_rel"] or not all(
            v <= TOL_TRAIN_PARITY["grad_rel_l2"] and float(gb[n].norm()) > 0
            for n, v in grad_rel.items()):
        raise RuntimeError(f"train_parity_tiny: {json.dumps(rec)}")
    return rec


# ---------------------------------------------------------------------------
# K4 (MMDE_ATTN_GRID=bias_resident) and K5 (MMDE_ATTN_W)
# ---------------------------------------------------------------------------

def compare_resident(shape, dtype, gen, *, timed=True, hot=False) -> dict:
    """K4 at one train shape through the autograd Function under
    grid_mode="bias_resident" (forward: K1 without the log-sum-exp, checked
    against the plain forward under rec["forward"]), against the plain
    backward and float64 autograd; dbias bitwise equal over two launches.
    bf16 and fp32 run the tensor-core K4 after the tensor-core K1 (the
    launches are checked by name). Head 0 above the ln(100) clamp, head 1
    hot (scale e^4); `hot`: every head at scale 60, and dlogit_scale held
    to TOL_F3 of float64 (F3). Times (medians of single
    launches): K4 and the FMA body at the same inputs, in turns (kernel,
    FMA body, FMA body, kernel), its bound on the tensor cores (tc_units:
    K4_TC_UNITS, fp32 K4_FP32_TC_UNITS) and the SDPA backward in qkv's type;
    K2 in the same call."""
    from mmde_tpu_torch.ops import window_attention_packed as wap
    qkv, ls, bias, mask = make_kernel_inputs(shape, dtype, shape["nW"] > 0,
                                             gen)
    ls[1] = 4.0
    if hot:
        ls[:] = math.log(60.0)
    nH = shape["nH"]
    g = torch.randn((shape["B_"], shape["N"], shape["C"]), device="cuda",
                    generator=gen).to(dtype)
    name = str(dtype).replace("torch.", "")
    tc = dtype == torch.bfloat16
    kernel = "window_attention_bwd_resident_tc"
    rec = _case_head(shape, dtype, mask)
    rec["kernel"] = kernel
    rec["every_head_scale_60"] = hot
    rec["tolerance_rel_l2"] = TOL_BWD[name]
    with torch.no_grad():
        plain = wap.cosine_window_attention_packed_backward_plain(
            qkv, ls, bias, mask, g, num_heads=nH)
        want_out = wap.cosine_window_attention_packed_plain(
            qkv, ls, bias, mask, num_heads=nH)
    truth = _float64_grads(qkv, ls, bias, mask, g, nH)
    leaves = [t.detach().clone().requires_grad_() for t in (qkv, ls, bias)]
    before = (wap.LAUNCHES_RESIDENT, wap.LAUNCHES_BWD)
    before_k = dict(wap.LAUNCHES_BY_KERNEL)
    out = wap.cosine_window_attention_packed(
        leaves[0], leaves[1], leaves[2], mask, num_heads=nH,
        grid_mode="bias_resident")
    out.backward(g)
    torch.cuda.synchronize()
    if (wap.LAUNCHES_RESIDENT - before[0], wap.LAUNCHES_BWD - before[1]) \
            != (1, 0):
        raise RuntimeError("bias_resident backward did not launch K4 alone")
    _tc_launched(before_k, {"window_attention_fwd_tc": 1, kernel: 1},
                 f"K4 at {json.dumps(rec)}")
    rec["forward"] = check_forward(out.detach(), want_out, dtype, rec)
    got = [t.grad for t in leaves]
    rec.update(_check_grads(got, plain, truth, name,
                            f"K4 at {json.dumps(rec)}", clamped=not hot))
    if hot:
        # F3: K4's own m and l, difference-first exp, centred dlogit_scale
        rec["tolerance_f3_dlogit_scale_rel_l2"] = TOL_F3
        if not rec["vs_float64"]["dlogit_scale"]["rel_l2"] <= TOL_F3:
            raise RuntimeError(f"K4 F3 case: dlogit_scale against float64 "
                               f"above {TOL_F3}: {json.dumps(rec)}")
    with torch.no_grad():
        d1 = wap._launch_backward_resident(qkv, ls, bias, mask, g, nH)[2]
        d2 = wap._launch_backward_resident(qkv, ls, bias, mask, g, nH)[2]
    rec["dbias_bitwise_equal"] = bool(torch.equal(d1, d2))
    if not rec["dbias_bitwise_equal"]:
        raise RuntimeError(f"K4 dbias differs between two launches at "
                           f"{json.dumps(rec)}")
    rec["splits"] = wap.resident_splits(shape["N"], nH, shape["B_"], True)
    rec["max_abs_err"] = rec["vs_float64"]["dqkv"]["max_abs"]
    rec["rel_l2_err"] = rec["vs_float64"]["dqkv"]["rel_l2"]
    del truth, want_out, d1, d2, out, leaves
    if timed:
        with torch.no_grad():
            def k4(fma=False):
                return lambda: wap._launch_backward_resident(
                    qkv, ls, bias, mask, g, nH, _fma=fma)
            turns = [time_ms(k4(), reps=8, warm=2),
                     time_ms(k4(True), reps=8, warm=2),
                     time_ms(k4(True), reps=8, warm=2),
                     time_ms(k4(), reps=8, warm=2)]
            rec.update({"ms": (turns[0] + turns[3]) / 2,
                        "fma_ms": (turns[1] + turns[2]) / 2,
                        "ms_turns": turns})
            rec.update(tc_work(shape["B_"], shape["N"], nH,
                               K4_TC_UNITS if tc else K4_FP32_TC_UNITS))
            lse = wap._launch_forward(qkv, ls, bias, mask, nH, True, True)[1]
            rec["k2_ms"] = time_ms(lambda: wap._launch_backward(
                qkv, ls, bias, mask, lse, g, nH, "window_resident", True),
                reps=8, warm=2)
            rec["plain_ms"] = time_ms(
                lambda: wap.cosine_window_attention_packed_backward_plain(
                    qkv, ls, bias, mask, g, num_heads=nH), reps=3, warm=1)
            fwd = rec["forward"]
            fwd["ms"] = time_ms(lambda: wap._launch_forward(
                qkv, ls, bias, mask, nH, True, False))
            fwd["plain_ms"] = time_ms(
                lambda: wap.cosine_window_attention_packed_plain(
                    qkv, ls, bias, mask, num_heads=nH), reps=5, warm=1)
        rec.update(backward_bound(shape["B_"], shape["N"], shape["C"], nH,
                                  rec["nW"], dtype, bias.dtype, lse=False))
        fwd.update(kernel_bound(shape["B_"], shape["N"], shape["C"], nH,
                                rec["nW"], dtype, bias.dtype))
        if tc:
            fwd.update(tc_work(shape["B_"], shape["N"], nH,
                               tc_units("fold", False, ls)))
        lib = library_yardstick(*wap._split_heads(qkv, 3, nH), ls, bias,
                                mask, g=wap._split_heads(g, 1, nH)[0])
        fwd.update({k: v for k, v in lib.items() if k != "library_bwd_ms"})
        rec.update({k: v for k, v in lib.items() if k != "library_ms"})
        rec["library_ms"] = lib["library_bwd_ms"]
    torch.cuda.empty_cache()
    return rec


def phase_kernels_resident(timed: bool = True) -> list:
    """K4 at the four flagship train shapes (2 frame pairs), bfloat16 and
    float32 (both on the tensor cores), masked where the stage shifts;
    float32 at stage 1 with every head at scale 60 (F3: dlogit_scale within
    TOL_F3 of float64); and float32 at the four train shapes of 1 frame
    pair (the fp32 Path A step's)."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(5151)
    shapes = stage_shapes(batch=2)
    cases = [compare_resident(s, dt, gen, timed=timed)
             for dt in (torch.bfloat16, torch.float32) for s in shapes]
    cases.append(compare_resident(shapes[0], torch.float32, gen,
                                  timed=False, hot=True))
    for c in cases:
        c["frame_pairs"] = 2
    # fp32 at the 1-pair train shapes: those of the fp32 Path A step
    for s in stage_shapes(batch=1):
        cases.append(dict(compare_resident(s, torch.float32, gen,
                                           timed=timed), frame_pairs=1))
    emit("kernel_cases_resident", {
        "cases": cases,
        "timing": "CUDA events around one launch (K4 and the k-normalise "
                  "VJP after it; K2's dq, dk/dv passes), 2 warm + 8 "
                  "launches, median; inputs stay in L2; in turns kernel, "
                  "FMA body, FMA body, kernel (ms_turns)"})
    return cases


def _w_of(shape, bwd: bool, masked: bool, setting="auto") -> int:
    from mmde_tpu_torch.ops import window_attention_packed as wap
    return wap.windows_per_block(shape["B_"], shape["N"], shape["C"],
                                 shape["nH"], shape["nW"] if masked else 0,
                                 bwd, setting)


def compare_w(shape, dtype, gen, w_fwd, w_bwd, train: bool,
              with_mask: bool, timed=True, mxu=None, pairs=None,
              hot=False) -> list:
    """K5 at one shape: the forward at each W of `w_fwd` (with the
    log-sum-exp when `train`) against the plain forward; the backward at
    each W of `w_bwd` against the plain backward and float64 autograd. bf16
    and fp32 run the tensor-core K5 (launches checked by name and W; fp32
    operands in three bf16 pieces, its statistic hi + lo). Precision mode
    `mxu` (None: the type's default): fold / fp32 at K1's / K2's tolerances
    for the type, "bf16" at TOL_MXU_BF16 (autograd: TOL_MXU_BF16_AUTOGRAD),
    every case MXU_APART times nearer its own mode's plain version than the
    other's (_nearer). Times: K5 and the FMA body at the same inputs in
    turns (kernel, FMA body, FMA body, kernel), the products' bound on the
    tensor cores (tc_units) and the SDPA yardstick in qkv's type; K1 / K2
    (W = 1) in the same call. With the stage's mask or without (the W of a
    shifted stage's blocks depends on it); head 0 clamped, head 1 hot.
    Every backward also under grid_mode="split" (K5's passes, then the
    tensor-core K3 at one window on the tensor-core forward's statistic),
    held to the same limits. `pairs`: the frame pairs of the
    shape (default 2 when `train`, else 1). `hot`: every head at scale 60,
    and (fp32 / fold) each backward's dlogit_scale held to TOL_F3 of
    float64 (F3)."""
    from mmde_tpu_torch.ops import window_attention_packed as wap
    qkv, ls, bias, mask = make_kernel_inputs(shape, dtype, with_mask, gen)
    ls[1] = 4.0
    if hot:
        ls[:] = math.log(60.0)
    nH, B_, N, C = shape["nH"], shape["B_"], shape["N"], shape["C"]
    name = str(dtype).replace("torch.", "")
    f32 = dtype == torch.float32   # every launch at W > 1: tensor cores
    mode = wap.resolve_mxu(mxu, dtype)
    rb = mode == "bf16"
    other = "fold" if rb else "bf16"
    head = _case_head(shape, dtype, mask)
    head["frame_pairs"] = pairs or (2 if train else 1)
    head["mxu"] = mode
    head["every_head_scale_60"] = hot
    recs, fwd_common = [], {}
    stats = train

    def fwd_call(w, fma=False):
        return lambda: wap._launch_forward(qkv, ls, bias, mask, nH, True,
                                           stats, w=w, mxu=mode, _fma=fma)

    with torch.no_grad():
        want_out = wap.cosine_window_attention_packed_plain(
            qkv, ls, bias, mask, num_heads=nH, mxu=mode)
        other_out = wap.cosine_window_attention_packed_plain(
            qkv, ls, bias, mask, num_heads=nH, mxu=other)
        if timed:
            fwd_common["k1_ms"] = time_ms(fwd_call(1))
            fwd_common["plain_ms"] = time_ms(
                lambda: wap.cosine_window_attention_packed_plain(
                    qkv, ls, bias, mask, num_heads=nH, mxu=mode), reps=5,
                warm=1)
            fwd_common.update(kernel_bound(B_, N, C, nH, head["nW"], dtype,
                                           bias.dtype, stats=train))
            fwd_common.update(library_yardstick(
                *wap._split_heads(qkv, 3, nH), ls, bias, mask))
            fwd_common.update(tc_work(B_, N, nH, tc_units(mode, False, ls,
                                                          f32=f32)))
        for w in w_fwd:
            before = dict(wap.LAUNCHES_BY_KERNEL)
            out, _ = fwd_call(w)()
            torch.cuda.synchronize()
            rec = dict(head, direction="forward", W=w, lse=train)
            kname = (f"window_attention_fwd_tc_w{w}"
                     + ("+lse" if train else ""))
            _tc_launched(before, {kname: 1}, f"K5 {json.dumps(rec)}")
            rec["kernel"] = kname
            if rb:
                rec.update({"max_abs_err": _errs(out, want_out)["max_abs"],
                            "rel_l2_err": _errs(out, want_out)["rel_l2"],
                            "tolerance": {"rel_l2": TOL_MXU_BF16["out"]}})
                if not (rec["rel_l2_err"] <= TOL_MXU_BF16["out"]
                        and bool(torch.isfinite(out).all())):
                    raise RuntimeError(f"K5 forward (mxu=bf16) disagrees "
                                       f"with its plain version: "
                                       f"{json.dumps(rec)}")
            else:
                rec.update(check_forward(out, want_out, dtype, rec))
            _nearer(rec, "out", out, want_out, other_out)
            if timed:
                turns = [time_ms(fwd_call(w)), time_ms(fwd_call(w, True)),
                         time_ms(fwd_call(w, True)), time_ms(fwd_call(w))]
                rec.update({"ms": (turns[0] + turns[3]) / 2,
                            "fma_ms": (turns[1] + turns[2]) / 2,
                            "ms_turns": turns})
                rec.update(fwd_common)
            recs.append(rec)
        del want_out, other_out
    if w_bwd:
        g = torch.randn((B_, N, C), device="cuda", generator=gen).to(dtype)
        with torch.no_grad():
            plain = wap.cosine_window_attention_packed_backward_plain(
                qkv, ls, bias, mask, g, num_heads=nH, mxu=mode)
            plain_o = wap.cosine_window_attention_packed_backward_plain(
                qkv, ls, bias, mask, g, num_heads=nH, mxu=other)
        truth = _float64_grads(qkv, ls, bias, mask, g, nH, mode)
        bwd_common = {}
        if timed:
            # the yardstick's backward needs autograd: outside no_grad
            bwd_common["library_bwd_ms"] = library_yardstick(
                *wap._split_heads(qkv, 3, nH), ls, bias, mask,
                g=wap._split_heads(g, 1, nH)[0])["library_bwd_ms"]
        # the statistic of the forward the model runs before these blocks'
        # backward: K5 at the forward's W (the JAX rule gives W > 1 to a
        # block's forward exactly where it gives it to its backward). The
        # tensor cores round each product's sum toward zero, so their
        # logits sit a few fp32 ulps below the FMA body's: the backward
        # rebuilds p against the statistic of the arithmetic that wrote it
        w_stat = w_fwd[0] if w_fwd else _w_of(shape, False, with_mask)
        with torch.no_grad():
            lse = wap._launch_forward(qkv, ls, bias, mask, nH, True, True,
                                      w=w_stat, mxu=mode)[1]
            lse_f = wap._launch_forward(qkv, ls, bias, mask, nH, True, True,
                                        w=w_stat, mxu=mode, _fma=True)[1]

            def bwd_call(w, fma=False, grid="window_resident"):
                return lambda: wap._launch_backward(
                    qkv, ls, bias, mask, lse_f if fma else lse, g, nH,
                    grid, True, w=w, mxu=mode, _fma=fma)
            if timed:
                bwd_common["k2_ms"] = time_ms(bwd_call(1), reps=8, warm=2)
                bwd_common["plain_ms"] = time_ms(
                    lambda: wap.cosine_window_attention_packed_backward_plain(
                        qkv, ls, bias, mask, g, num_heads=nH, mxu=mode),
                    reps=3, warm=1)
                bwd_common.update(backward_bound(B_, N, C, nH, head["nW"],
                                                 dtype, bias.dtype))
                bwd_common["library_ms"] = bwd_common.pop("library_bwd_ms",
                                                          None)
                bwd_common.update(tc_work(B_, N, nH, tc_units(
                    mode, True, ls, f32=f32)))
            for w in w_bwd:
                before = dict(wap.LAUNCHES_BY_KERNEL)
                got = bwd_call(w)()
                torch.cuda.synchronize()
                kname = f"window_attention_bwd_tc_w{w}"
                rec = dict(head, direction="backward", W=w, kernel=kname,
                           tolerance_rel_l2=TOL_MXU_BF16 if rb
                           else TOL_BWD[name])
                _tc_launched(before, {kname: 1}, f"K5 {json.dumps(rec)}")
                what = f"K5 backward at {json.dumps(rec)}"
                if rb:
                    rec.update(_check_against(got, {
                        "vs_plain": (plain, TOL_MXU_BF16),
                        "vs_float64": (truth, TOL_MXU_BF16_AUTOGRAD)}, what))
                else:
                    rec.update(_check_grads(got, plain, truth, name, what,
                                            clamped=not hot))
                if hot and not rb:
                    rec["tolerance_f3_dlogit_scale_rel_l2"] = TOL_F3
                    if not rec["vs_float64"]["dlogit_scale"]["rel_l2"] \
                            <= TOL_F3:
                        raise RuntimeError(f"K5 F3 case: dlogit_scale "
                                           f"against float64 above {TOL_F3}"
                                           f": {json.dumps(rec)}")
                _nearer(rec, "dqkv", got[0], plain[0], plain_o[0])
                # "split": the tensor-core K3 after K5's passes, on the
                # statistic the tensor-core forward wrote
                before = dict(wap.LAUNCHES_BY_KERNEL)
                got_s = bwd_call(w, grid="split")()
                torch.cuda.synchronize()
                _tc_launched(before, {kname: 1,
                                      "window_attention_dbias_tc": 1},
                             f"K5 split {json.dumps(rec)}")
                rec["split"] = (_check_against(got_s, {
                    "vs_plain": (plain, TOL_MXU_BF16),
                    "vs_float64": (truth, TOL_MXU_BF16_AUTOGRAD)},
                    f"split {what}") if rb else
                    _check_grads(got_s, plain, truth, name,
                                 f"split {what}", clamped=not hot))
                del got_s
                rec["max_abs_err"] = rec["vs_float64"]["dqkv"]["max_abs"]
                rec["rel_l2_err"] = rec["vs_float64"]["dqkv"]["rel_l2"]
                if timed:
                    turns = [time_ms(bwd_call(w), reps=8, warm=2),
                             time_ms(bwd_call(w, True), reps=8, warm=2),
                             time_ms(bwd_call(w, True), reps=8, warm=2),
                             time_ms(bwd_call(w), reps=8, warm=2)]
                    rec.update({"ms": (turns[0] + turns[3]) / 2,
                                "fma_ms": (turns[1] + turns[2]) / 2,
                                "ms_turns": turns})
                    rec.update(bwd_common)
                recs.append(rec)
        del plain, plain_o, truth
    torch.cuda.empty_cache()
    return recs


def phase_kernels_w(timed: bool = True) -> list:
    """K5 at every (shape, W) that choose_w("auto") gives the flagship's
    served (1 pair) and trained (2 pairs) stages, masked and unmasked
    blocks alike, plus W = 2 at stage 1 trained (bf16) and the masked
    backward at W = 8 there (fp32); bfloat16 (served in each precision
    mode, trained in the model's, "fold") and float32 (served and trained
    in each mode, timed in "fp32", its model's; trained at 1 pair too, the
    fp32 Path B step's shapes), both on the tensor-core K5; and the fp32
    F3 case (every head at scale 60, stage 1 trained, masked, backward at
    the rule's W and at 8) in fp32 and fold. Every case runs; the phase's
    line is printed, then it fails if any case disagreed."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(6262)
    cases, failed = [], []

    def by_mask(shape, bwd, extra=()):
        """{with mask: W values} of a shape's blocks, each W once (with the
        mask where both kinds of block take it)"""
        masked = shape["nW"] > 0
        ws = {True: set(), False: set()}
        ws[masked].add(_w_of(shape, bwd, masked))
        ws[masked].update(extra)
        if masked:
            ws[False].add(_w_of(shape, bwd, False))
            ws[False] -= ws[True]
        return {m: sorted(w - {1}) for m, w in ws.items()}

    def run(*args, **kw):
        try:
            cases.extend(compare_w(*args, **kw))
        except RuntimeError as e:
            failed.append(str(e))
        torch.cuda.empty_cache()

    for dtype in (torch.bfloat16, torch.float32):
        for shape in stage_shapes(batch=1):
            for m, ws in by_mask(shape, False).items():
                if ws:
                    for mxu in ("fold", "fp32", "bf16"):
                        run(shape, dtype, gen, ws, [], False, m,
                            timed and (dtype == torch.bfloat16
                                       or mxu == "fp32"), mxu=mxu)
    for dtype in (torch.bfloat16, torch.float32):
        # fp32: every mode (its model's, "fp32", timed)
        modes = ((None,) if dtype == torch.bfloat16
                 else ("fp32", "fold", "bf16"))
        for shape in stage_shapes(batch=2):
            bf = dtype == torch.bfloat16
            extra = (2,) if shape["stage"] == 1 and bf else ()
            # fp32 at stage 1: the backward at W = 8 with the mask too
            # (MMDE_ATTN_W=8; its dk/dv pass holds 4 windows a block)
            wf = by_mask(shape, False, extra)
            wb = by_mask(shape, True, extra if bf else
                         (8,) if shape["stage"] == 1 else ())
            for m in (True, False):
                if wf[m] or wb[m]:
                    for mxu in modes:
                        run(shape, dtype, gen, wf[m], wb[m], True, m,
                            timed and mxu in (None, "fp32"), mxu=mxu)
    # fp32 at the train shapes of one frame pair, in its model's mode: the
    # W and B_ of the fp32 Path B step (train_parity_w), timed there
    for shape in stage_shapes(batch=1):
        wf, wb = by_mask(shape, False), by_mask(shape, True)
        for m in (True, False):
            if wf[m] or wb[m]:
                run(shape, torch.float32, gen, wf[m], wb[m], True, m, timed,
                    mxu="fp32", pairs=1)
    # F3 on fp32 K5: every head at scale 60, stage 1 trained with its mask,
    # the forward at the rule's W (its statistic feeds the backward), the
    # backward at the rule's W and at W = 8, in the two modes that compute
    # the fp32 function (the "bf16" mode's roundings of its operands flip
    # between fp32 and float64, so float64 is no F3 oracle for it)
    s1 = stage_shapes(batch=2)[0]
    for mxu in ("fp32", "fold"):
        run(s1, torch.float32, gen, by_mask(s1, False)[True],
            sorted({_w_of(s1, True, True), 8} - {1}), True, True, False,
            mxu=mxu, hot=True)
    emit("kernel_cases_w", {
        "cases": cases, "failed": failed,
        "timing": "CUDA events around one launch (forward; backward: the dq "
                  "and dk/dv passes), median of 20 (forward) / 8 (backward) "
                  "after warm-up; bf16 in turns kernel, FMA body, FMA body, "
                  "kernel (ms_turns); k1_ms / k2_ms: the same at W = 1"})
    if failed:
        raise RuntimeError(f"kernel_cases_w: {len(failed)} case(s) "
                           f"disagree: {failed[0]}")
    return cases


def expected_kernels(backbone: str, batch: int, times: int, train: bool,
                     attn_impl: str = "cuda") -> dict:
    """{kernel name: {(B_, N, C, nH): launches}} of the packed, head-split
    and slab kernels over `times` forwards (or train steps) under this
    process's MMDE_ATTN_GRID and MMDE_ATTN_W: each packed block's W by the
    JAX rule, for its own mask (the shifted blocks of stages 1-2 have one,
    the others not); every head-split and every slab block of either type
    on the tensor cores; every packed block of either type on the tensor
    cores: no FMA body."""
    from mmde_tpu_torch.ops import window_attention_packed as wap
    resident = train and wap.DEFAULT_GRID_MODE == "bias_resident"
    want: dict = {}

    def add(kernel, key, n):
        want.setdefault(kernel, {})
        want[kernel][key] = want[kernel].get(key, 0) + n

    for sh in stage_shapes(backbone, batch=batch, attn_impl=attn_impl):
        key = (sh["B_"], sh["N"], sh["C"], sh["nH"])
        if sh["layout"] in ("headsplit", "slab"):
            base = "window_attention_" + sh["layout"]
            add(base + "_fwd_tc" + ("+lse" if train else ""), key,
                sh["blocks"] * times)
            if train:
                add(base + "_bwd_tc", key, sh["blocks"] * times)
        if sh["layout"] != "packed":
            continue
        masked = sh["blocks"] // 2 if sh["nW"] else 0
        for has_mask, n in ((False, sh["blocks"] - masked), (True, masked)):
            if n == 0:
                continue
            wf = 1 if resident else _w_of(sh, False, has_mask,
                                          wap.WINDOWS_PER_CELL)
            # every packed launch (bf16 or fp32) runs the tensor-core
            # kernels, K5 at its W
            fwd = "window_attention_fwd_tc" + (f"_w{wf}" if wf > 1 else "") \
                + ("+lse" if train and not resident else "")
            add(fwd, key, n * times)
            if not train:
                continue
            if resident:
                add("window_attention_bwd_resident_tc", key, n * times)
            else:
                wb = _w_of(sh, True, has_mask, wap.WINDOWS_PER_CELL)
                add("window_attention_bwd_tc" + (f"_w{wb}" if wb > 1 else ""),
                    key, n * times)
    if train and wap.DEFAULT_GRID_MODE == "split":
        # the tensor-core K3 after every packed (any W), head-split and
        # slab backward
        for name, by_shape in list(want.items()):
            k3 = ("window_attention_headsplit_dbias_tc"
                  if name == "window_attention_headsplit_bwd_tc" else
                  "window_attention_slab_dbias_tc"
                  if name == "window_attention_slab_bwd_tc" else
                  "window_attention_dbias_tc"
                  if name.startswith("window_attention_bwd_tc") else None)
            for key, n in by_shape.items() if k3 else ():
                add(k3, key, n)
    return want


def _check_mxu(tag: str, by_kernel: dict,
               dtype: torch.dtype = torch.bfloat16) -> dict:
    """Every packed launch since the reset in this process's precision mode
    for a model of `dtype` (bf16: MMDE_ATTN_MXU, "fold" unless set; fp32:
    "fp32"); K4 in fp32. Returns {mode: {shape: launches}} (string keys)."""
    from mmde_tpu_torch.ops import window_attention_packed as wap
    mode = wap.resolve_mxu(None, dtype)
    want: dict = {}
    for kernel, d in by_kernel.items():
        if kernel.startswith(("window_attention_headsplit",
                              "window_attention_slab")):
            continue        # one function ("fp32"), counted by its module
        m = "fp32" if "resident" in kernel else mode
        for key, n in d.items():
            want[(m, key)] = want.get((m, key), 0) + n
    if wap.LAUNCHES_BY_MXU != want:
        raise RuntimeError(f"{tag}: packed launches by mode "
                           f"{wap.LAUNCHES_BY_MXU}, expected {want}")
    out: dict = {}
    for (m, key), n in want.items():
        out.setdefault(m, {})[str(key)] = n
    return out


def _by_kernel() -> dict:
    """{kernel: {(B_, N, C, nH): launches}} of the packed, head-split and
    slab kernels since the last reset."""
    out: dict = {}
    for m in _kernel_modules().values():
        for (kernel, key), n in m.LAUNCHES_BY_KERNEL.items():
            out.setdefault(kernel, {})[key] = n
    return out


def _str_keys(d: dict) -> dict:
    return {k: {str(s): n for s, n in v.items()} for k, v in d.items()}


def _start_child(argv: list, env_extra: dict) -> dict:
    """Start this checkout's python `argv` with `env_extra` in the
    environment (the kernel settings are read at import: a process of their
    own), its output to temporary files."""
    root = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, **env_extra)
    env["PYTHONPATH"] = root + os.pathsep + env.get("PYTHONPATH", "")
    out, err = tempfile.TemporaryFile("w+"), tempfile.TemporaryFile("w+")
    proc = subprocess.Popen([sys.executable] + argv, env=env, cwd=root,
                            stdout=out, stderr=err, text=True)
    return {"proc": proc, "out": out, "err": err,
            "what": f"{env_extra} {' '.join(argv)}"}


def _child_lines(child: dict, timeout: int) -> list:
    """Wait for a started child; its JSON lines. Raises when it fails or
    outlives `timeout` (then it is killed)."""
    try:
        rc = child["proc"].wait(timeout=timeout)
    except subprocess.TimeoutExpired:
        child["proc"].kill()
        child["proc"].wait()
        raise RuntimeError(f"{child['what']} ran over {timeout} s")
    child["out"].seek(0)
    child["err"].seek(0)
    out, err = child["out"].read(), child["err"].read()
    if rc != 0:
        raise RuntimeError(f"{child['what']} exited {rc}:\n{out[-3000:]}\n"
                           f"{err[-6000:]}")
    return [json.loads(ln) for ln in out.splitlines() if ln.startswith("{")]


# Path A, Path B and the bf16 mode run in processes of their own, all three
# side by side on the card: their request and step times share it and do
# not compare with the default path's (this script is the correctness gate;
# timing those paths is the bench's)
SHARED_CARD = ("train_resident, serve_w / train_w and serve_mxu / "
               "train_mxu ran side by side, each in its own process: "
               "request and step times share the card")


def phase_children(resident_steps: int = 4) -> tuple:
    """Start the three children at once (`phase_resident_child`'s,
    `phase_w_child`'s, `phase_mxu_child`'s), wait for all three, then read
    each; returns (train_resident, Path A's fp32 step, serve_w, train_w,
    Path B's fp32 step, serve_mxu, train_mxu); a step: its loss,
    gradients and launches by kernel and shape."""
    me = os.path.basename(__file__)
    with tempfile.TemporaryDirectory() as tmp:
        grads = os.path.join(tmp, "grads.pt")
        grads_w = os.path.join(tmp, "grads_w.pt")
        children = {
            "resident": _start_child(
                [me, "--child", "resident", "--steps", str(resident_steps),
                 "--out", grads], {"MMDE_ATTN_GRID": "bias_resident"}),
            "w": _start_child([me, "--child", "w", "--out", grads_w],
                              {"MMDE_ATTN_W": "auto"}),
            "mxu": _start_child([me, "--child", "mxu"],
                                {"MMDE_ATTN_MXU": "bf16"})}
        try:
            lines = {k: _child_lines(c, 900) for k, c in children.items()}
        finally:
            for c in children.values():
                if c["proc"].poll() is None:
                    c["proc"].kill()
                    c["proc"].wait()
        resident = torch.load(grads)
        w_child = torch.load(grads_w)
    train_res, resident = phase_resident_child(lines["resident"], resident,
                                               resident_steps)
    serve_w, train_w = phase_w_child(lines["w"])
    w_child["child_lines"] = len(lines["w"])
    serve_mxu, train_mxu = phase_mxu_child(lines["mxu"])
    return (train_res, resident, serve_w, train_w, w_child, serve_mxu,
            train_mxu)



def phase_resident_child(lines: list, child: dict, steps: int) -> tuple:
    """Path A, read off its process (under MMDE_ATTN_GRID=bias_resident):
    the trainer entry point `mmde_tpu_torch.tools.train_steps.main(
    ["--steps", "4"])` (the flagship, bf16, 2 frame pairs: every step 24 K1
    launches without the log-sum-exp and 24 K4, both on the tensor cores,
    no K2), then one fp32 step's
    gradients (`child`) for train_parity_resident. Returns (the
    train_resident record, the child's gradients)."""
    recs = [ln for ln in lines if "step" in ln]
    if len(recs) != steps:
        raise RuntimeError(f"train_resident: {len(recs)} step lines")
    for r in recs:
        if not all(math.isfinite(r[k]) for k in r if k.startswith("loss")):
            raise RuntimeError(f"train_resident: loss not finite: {r}")
    last = recs[-1]
    pairs = 2
    want = {k: {f"{b}x{n}x{c}/{h}": v for (b, n, c, h), v in d.items()}
            for k, d in _expected_resident(pairs, steps).items()}
    if last["launches"] != {k: sum(d.values()) for k, d in want.items()} \
            or last["launches_by_shape"] != want:
        raise RuntimeError(f"train_resident: launches {last['launches']} "
                           f"{last['launches_by_shape']}, expected {want}")
    ms = [r["ms"] for r in recs]
    rec = {"command": "mmde_tpu_torch.tools.train_steps.main(['--steps', "
                      f"'{steps}']) under MMDE_ATTN_GRID=bias_resident",
           "model": "swin_base_v2 + decoder_v2, bfloat16, depths 2/2/18/2, "
                    "train mode, 2 frame pairs, fresh weights from seed 0",
           "shared_card": SHARED_CARD,
           "first_step_ms": ms[0], "step_ms": ms[1:],
           "step_ms_median": statistics.median(ms[1:]),
           "images_per_s": 2 * pairs / (statistics.median(ms[1:]) / 1e3),
           "peak_memory_bytes": last["peak_memory_bytes"],
           "losses": [r["loss_total"] for r in recs],
           "launches": last["launches"],
           "launches_by_shape": last["launches_by_shape"]}
    emit("train_resident", rec)
    rec["_by_shape"] = {k: {tuple(int(x) for x in
                                  s.replace("/", "x").split("x")): n
                            for s, n in d.items()}
                        for k, d in last["launches_by_shape"].items()}
    child["child_lines"] = len(lines)
    return rec, child


def _expected_resident(pairs: int, steps: int) -> dict:
    want: dict = {}
    for sh in stage_shapes(batch=pairs):
        key = (sh["B_"], sh["N"], sh["C"], sh["nH"])
        for k in ("window_attention_fwd_tc",
                  "window_attention_bwd_resident_tc"):
            want.setdefault(k, {})[key] = sh["blocks"] * steps
    return want


def phase_w_child(lines: list) -> tuple:
    """Path B, read off its process: the flagship under MMDE_ATTN_W=auto,
    `serve_w` (2 requests) and `train_w` (4 steps), every packed launch at
    the JAX rule's W (checked in the child)."""
    got = {k: v for ln in lines for k, v in ln.items()
           if k in ("serve_w", "train_w")}
    if set(got) != {"serve_w", "train_w"}:
        raise RuntimeError(f"W child printed {[list(ln) for ln in lines]}")
    for tag in ("serve_w", "train_w"):
        emit(tag, dict(got[tag], shared_card=SHARED_CARD))
        got[tag]["_by_kernel"] = {
            k: {tuple(int(x) for x in s.strip("()").split(",")): n
                for s, n in d.items()}
            for k, d in got[tag]["launches_by_kernel"].items()}
    return got["serve_w"], got["train_w"]


# {train_step_grads' key: {kernel: launches}} of each step it took
_STEP_LAUNCHES: dict = {}


def train_step_grads(backbone: str, pairs: int, path: str,
                     dtype: str = "float32") -> tuple:
    """(losses, {name: gradient}) of one deterministic train step (fp32, or
    `dtype`) of `backbone` at full width (depths PARITY_DEPTHS) under
    attention `path`, weights and batch from fixed seeds, cuDNN TF32 off;
    cached per process. The step's launches by kernel go to
    _STEP_LAUNCHES."""
    key = ("train_step", backbone, pairs, path, dtype)
    if key in _PLAIN_RUNS:
        return _PLAIN_RUNS[key]
    old = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        trainer = _parity_trainer(backbone, pairs, dtype)
        state, step, init, batch = trainer
        with torch.no_grad():       # every path steps from the same weights
            state.model.load_state_dict(init)
        _set_attn_impl(state.model, path)
        _reset_launch_counts()
        state, aux = step(state, batch)
        torch.cuda.synchronize()
        _STEP_LAUNCHES[key] = {k: sum(d.values())
                               for k, d in _by_kernel().items()}
        trainer[0] = state
        grads = {n: p.grad.detach().double().clone()
                 for n, p in state.model.named_parameters()
                 if n in LARGE_PARITY_PARAMS}
        res = ({k: float(v) for k, v in aux.items()}, grads)
    finally:
        torch.backends.cudnn.allow_tf32 = old
    _PLAIN_RUNS[key] = res
    return res


def phase_train_parity_resident(child: dict, tag="train_parity_resident",
                                setting="MMDE_ATTN_GRID=bias_resident"
                                ) -> dict:
    """One deterministic fp32 flagship step (TF32 off, 1 frame pair,
    depths PARITY_DEPTHS) in a child process under `setting` - Path A (K1
    without lse + K4) or Path B (MMDE_ATTN_W=auto: K5 where W > 1) - against
    the plain fp32 path's (this process): loss and the gradients of
    PARITY_PARAMS at TOL_TRAIN_PARITY. Its launches: Path A every backward
    on the tensor-core K4, Path B every K5 launch on the tensor-core K5, and
    neither an fp32 launch of their FMA bodies."""
    counts = child["launches"]
    blocks = sum(PARITY_DEPTHS)
    if tag == "train_parity_resident":
        ok = (counts.get("window_attention_bwd_resident_tc", 0) == blocks
              and not any(k.startswith("window_attention_bwd")
                          and k != "window_attention_bwd_resident_tc"
                          for k in counts))
        want = f"{blocks} tensor-core K4, no K2 and no FMA K4"
    else:
        ok = (any(k.startswith("window_attention_bwd_tc_w") for k in counts)
              and any(k.startswith("window_attention_fwd_tc_w")
                      for k in counts)
              and not any(k.startswith(("window_attention_fwd_w",
                                        "window_attention_bwd_w"))
                          for k in counts))
        want = "tensor-core K5 forwards and backwards, no FMA K5"
    fma = sum(n for k, n in counts.items()
              if k == "window_attention_bwd_resident"
              or k.startswith(("window_attention_fwd_w",
                               "window_attention_bwd_w")))
    if not ok or fma:
        raise RuntimeError(f"{tag}: the child's launches {counts}, "
                           f"expected {want}")
    la, ga = child["loss"], child["grads"]
    lb, gb = train_step_grads("swin_base_v2", 1, "torch")
    loss_rel = abs(la["loss_total"] - lb["loss_total"]) / abs(lb["loss_total"])
    grad_rel = {n: float((ga[n].cuda() - gb[n]).norm()
                         / gb[n].norm().clamp_min(1e-300))
                for n in PARITY_PARAMS}
    rec = {"model": "swin_base_v2", "dtype": "float32", "frame_pairs": 1,
           "depths": list(PARITY_DEPTHS), "cudnn_allow_tf32": False,
           "child_lines": child["child_lines"], "setting": setting,
           "launches": counts, "fma_k4_k5_launches": fma,
           "loss_kernel_path": la, "loss_plain_path": lb,
           "loss_rel_diff": loss_rel, "grad_rel_l2": grad_rel,
           "tolerance": TOL_TRAIN_PARITY}
    if not loss_rel <= TOL_TRAIN_PARITY["loss_rel"]:
        raise RuntimeError(f"{tag}: loss differs: {json.dumps(rec)}")
    for n, v in grad_rel.items():
        if not (v <= TOL_TRAIN_PARITY["grad_rel_l2"]
                and float(gb[n].norm()) > 0):
            raise RuntimeError(f"{tag}: gradient of {n} differs or is "
                               f"zero: {json.dumps(rec)}")
    emit(tag, rec)
    return rec


def train_split_child(pairs: int = 2, warm: int = 1, steps: int = 2) -> None:
    """`train_split`, in a process of its own under MMDE_ATTN_GRID=split:
    the bf16 flagship trainer at full width (480x640, `pairs` frame pairs,
    train mode, weights from seed 7), `warm` steps, then `steps` timed
    steps (host clock to torch.cuda.synchronize(), peak bytes, launches by
    kernel and shape - tensor-core kernels only: K1+lse, K2's passes and
    K3 after each backward, `expected_kernels`), one step profiled (device
    ms by kernel group, K3's own), and one more step in which every
    attention backward is launched twice on the same inputs (the same
    weights and batch): dbias, dqkv and dlogit_scale of the two calls
    compared bit for bit, block by block. Then the same trainer on the
    slab path: one step (its launches: K8'+lse, K9' and K3 over MapRows a
    block) and one with each slab backward launched twice, compared the
    same way. Prints one JSON line."""
    from mmde_tpu_torch.ops import window_attention_packed as wap
    from mmde_tpu_torch.tools import train_steps as ts
    from mmde_tpu_torch.tools.profile_step import profile_call
    state, step = ts.build_trainer(ts.flagship_config("bfloat16", "cuda",
                                                      batch_size=pairs),
                                   device="cuda", seed=0)
    randomize_weights(state.model, seed=7)
    batch = ts.synthetic_batch(pairs, 480, 640, seed=31, device="cuda")
    for _ in range(warm):
        state, _ = step(state, batch)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_launch_counts()
    ms, losses = [], []
    for _ in range(steps):
        t = time.time()
        state, aux = step(state, batch)
        torch.cuda.synchronize()
        ms.append((time.time() - t) * 1e3)
        losses.append(float(aux["loss_total"]))
    if not all(math.isfinite(v) for v in losses):
        raise RuntimeError(f"train_split: loss not finite: {losses}")
    peak = torch.cuda.max_memory_allocated()
    by_kernel = _by_kernel()
    want = expected_kernels("swin_base_v2", pairs, steps, True)
    if by_kernel != want:
        raise RuntimeError(f"train_split: launches by kernel {by_kernel}, "
                           f"expected {want}")
    prof = profile_call(lambda: step(state, batch))
    same = []
    launch = wap._launch_backward

    def twice(*a, **kw):
        first, second = launch(*a, **kw), launch(*a, **kw)
        same.append([bool(torch.equal(x, y)) for x, y in zip(first, second)])
        return first
    wap._launch_backward = twice
    try:
        state, _ = step(state, batch)
        torch.cuda.synchronize()
    finally:
        wap._launch_backward = launch
    names = ("dqkv", "dlogit_scale", "dbias")
    # the same trainer on the slab path: every block's K9' passes without
    # atomics and K3 over MapRows after them; one counted step, then one
    # with every slab backward launched twice
    from mmde_tpu_torch.ops import window_attention_slab as was
    _set_attn_impl(state.model, "cuda_slab")
    _reset_launch_counts()
    state, aux = step(state, batch)
    torch.cuda.synchronize()
    slab_by_kernel = _by_kernel()
    slab_want = expected_kernels("swin_base_v2", pairs, 1, True,
                                 attn_impl="cuda_slab")
    if slab_by_kernel != slab_want or not math.isfinite(
            float(aux["loss_total"])):
        raise RuntimeError(f"train_split slab step: launches by kernel "
                           f"{slab_by_kernel}, expected {slab_want}; loss "
                           f"{float(aux['loss_total'])}")
    slab_same = []
    slab_launch = was._launch_backward

    def slab_twice(*a, **kw):
        first, second = slab_launch(*a, **kw), slab_launch(*a, **kw)
        slab_same.append([bool(torch.equal(x, y))
                          for x, y in zip(first, second)])
        return first
    was._launch_backward = slab_twice
    try:
        state, _ = step(state, batch)
        torch.cuda.synchronize()
    finally:
        was._launch_backward = slab_launch
    _set_attn_impl(state.model, "cuda")
    rec = {"command": "chip_smoke.py --child split under "
                      "MMDE_ATTN_GRID=split",
           "model": "swin_base_v2 + decoder_v2, bfloat16, depths 2/2/18/2, "
                    "train mode, 480x640, weights from seed 7",
           "frame_pairs": pairs, "warm_steps": warm, "step_ms": ms,
           "step_ms_mean": statistics.mean(ms), "losses": losses,
           "images_per_s": 2 * pairs / (statistics.mean(ms) / 1e3),
           "peak_memory_bytes": peak,
           "launches": {k: sum(d.values()) for k, d in by_kernel.items()},
           "launches_by_kernel": _str_keys(by_kernel),
           "device_ms_total": prof["device_ms_total"],
           "device_launches": prof["launches"],
           "device_ms_by_group": prof["device_ms_by_group"],
           "k3_device_ms": prof["device_ms_by_group"].get(
               "window_attention_dbias (this repo's kernel)", 0.0),
           "profile_top": prof["top"],
           "backward_calls_twice": len(same),
           "bitwise_equal_blocks": {n: sum(r[i] for r in same)
                                    for i, n in enumerate(names)},
           "slab": {"attn_impl": "cuda_slab", "launches": {
               k: sum(d.values()) for k, d in slab_by_kernel.items()},
               "launches_by_kernel": _str_keys(slab_by_kernel),
               "backward_calls_twice": len(slab_same),
               "bitwise_equal_blocks": {n: sum(r[i] for r in slab_same)
                                        for i, n in enumerate(names)}}}
    print(json.dumps({"train_split": rec}), flush=True)


def phase_train_split(pairs: int = 2, steps: int = 2) -> dict:
    """Start `train_split_child` (this script under MMDE_ATTN_GRID=split)
    once the other children are done, so that it has the card alone; wait,
    check and emit its record: every block's dbias bitwise equal over its
    two backward calls, no FMA launch (its launches were checked against
    `expected_kernels` in the child), K3 on the device; on the slab path
    (`slab`) K3 over MapRows once a block and step, and every block's
    dqkv, dlogit_scale and dbias bitwise over two calls."""
    child = _start_child([os.path.basename(__file__), "--child", "split"],
                         {"MMDE_ATTN_GRID": "split"})
    try:
        lines = _child_lines(child, 600)
    finally:
        if child["proc"].poll() is None:
            child["proc"].kill()
            child["proc"].wait()
    got = [ln["train_split"] for ln in lines if "train_split" in ln]
    if len(got) != 1:
        raise RuntimeError(f"split child printed {[list(ln) for ln in lines]}")
    rec = got[0]
    blocks = sum(sh["blocks"] for sh in stage_shapes())
    fma = [k for k in rec["launches"] if "_tc" not in k]
    slab = rec["slab"]
    rec["ok"] = (rec["backward_calls_twice"] == blocks
                 and rec["bitwise_equal_blocks"]["dbias"] == blocks
                 and not fma and rec["k3_device_ms"] > 0
                 and rec["launches"].get("window_attention_dbias_tc", 0)
                 == blocks * steps
                 and slab["backward_calls_twice"] == blocks
                 and all(v == blocks
                         for v in slab["bitwise_equal_blocks"].values())
                 and slab["launches"].get("window_attention_slab_dbias_tc",
                                          0) == blocks
                 and not [k for k in slab["launches"] if "_tc" not in k])
    emit("train_split", rec)
    if not rec["ok"]:
        raise RuntimeError(f"train_split: {json.dumps(rec)}")
    for r in (rec, slab):
        r["_by_kernel"] = {
            k: {tuple(int(x) for x in sh.strip("()").split(",")): n
                for sh, n in d.items()}
            for k, d in r["launches_by_kernel"].items()}
    return rec


def child_main(args) -> int:
    """The processes phase_w_child, phase_mxu_child, phase_resident_child
    and phase_train_split start, with their environment variable set."""
    from mmde_tpu_torch.ops import window_attention_packed as wap
    if args.child == "split":
        if wap.DEFAULT_GRID_MODE != "split":
            raise RuntimeError("the split child needs MMDE_ATTN_GRID=split")
        train_split_child()
        return 0
    if args.child == "mxu":
        if wap.MXU_BF16_DEFAULT != "bf16":
            raise RuntimeError("the mxu child needs MMDE_ATTN_MXU=bf16")
        phase_serve(requests=1, flip=False, tag="serve_mxu")
        phase_train(steps=3, deterministic_run=False, tag="train_mxu")
        return 0
    if args.child == "w":
        if wap.WINDOWS_PER_CELL != "auto":
            raise RuntimeError("the W child needs MMDE_ATTN_W=auto")
        phase_serve(requests=2, flip=False, tag="serve_w")
        phase_train(steps=4, deterministic_run=False, tag="train_w")
    else:
        if wap.DEFAULT_GRID_MODE != "bias_resident":
            raise RuntimeError("the resident child needs MMDE_ATTN_GRID="
                               "bias_resident")
        from mmde_tpu_torch.tools import train_steps
        train_steps.main(["--steps", str(args.steps)])
    # one fp32 step of the flagship under this process's setting: K4 or K5
    # on the tensor cores in fp32
    torch.cuda.empty_cache()
    wap.reset_launch_counts()
    loss, grads = train_step_grads("swin_base_v2", 1, "cuda")
    torch.save({"loss": loss, "grads": {n: t.cpu() for n, t in grads.items()},
                "launches": wap.launch_counts(),
                "launches_by_kernel": {f"{k}|{','.join(map(str, key))}": n
                                       for (k, key), n in
                                       wap.LAUNCHES_BY_KERNEL.items()}},
               args.out)
    print(json.dumps({"grads_child": {"loss": loss}}), flush=True)
    return 0


def _w_case(cases, shape, pairs, direction, w, lse=None):
    """kernel_cases_w's bf16 case in the model's mode ("fold")."""
    return next(c for c in cases
                if c["model"] == shape["model"]
                and c["stage"] == shape["stage"] and c["dtype"] == "bfloat16"
                and c["frame_pairs"] == pairs and c["direction"] == direction
                and c["W"] == w and c["mxu"] == "fold"
                and (lse is None or c["lse"] == lse))


def contract_w(kw_cases: list, serve_w: dict, train_w: dict) -> list:
    """One entry per (K5 kernel, W, shape) launched on Path B: the served
    forward, the trained forward (with lse) and the backward."""
    entries = []
    for rec, pairs in ((serve_w, 1), (train_w, 2)):
        for kernel, by_shape in sorted(rec["_by_kernel"].items()):
            if "_w" not in kernel:
                continue
            w = int(kernel.split("_w")[1].split("+")[0])
            bwd = "_bwd" in kernel
            for shape in stage_shapes(batch=pairs):
                key = (shape["B_"], shape["N"], shape["C"], shape["nH"])
                n = by_shape.get(key, 0)
                if n == 0:
                    continue
                c = _w_case(kw_cases, shape, pairs,
                            "backward" if bwd else "forward", w,
                            None if bwd else pairs > 1)
                # the blocks at this W with the case's mask, or without
                entries.append(_entry(
                    kernel, dict(shape, nW=c["nW"]),
                    KERNEL_TC_BWD_SOURCE if bwd else KERNEL_TC_SOURCE,
                    KERNEL_W_BWD_REPLACES if bwd else KERNEL_W_REPLACES,
                    n, c, pairs))
    return entries


def contract_resident(k4_cases: list, train_res: dict) -> list:
    """Path A's entries: K1 without the log-sum-exp and K4 at each trained
    shape, launches from train_resident."""
    entries = []
    for shape in stage_shapes(batch=2):
        key = (shape["B_"], shape["N"], shape["C"], shape["nH"])
        c = _find(k4_cases, shape, 2)
        nf = train_res["_by_shape"]["window_attention_fwd_tc"].get(key, 0)
        nb = train_res["_by_shape"]["window_attention_bwd_resident_tc"].get(
            key, 0)
        entries.append(_entry("window_attention_fwd_tc (bias_resident)",
                              shape, KERNEL_TC_SOURCE, KERNEL_REPLACES, nf,
                              c["forward"], 2))
        e = _entry("window_attention_bwd_resident_tc", shape,
                   KERNEL_RESIDENT_TC_SOURCE, KERNEL_RESIDENT_REPLACES, nb, c,
                   2)
        e["k2_ms"] = c["k2_ms"]
        e["dbias_bitwise_equal"] = c["dbias_bitwise_equal"]
        entries.append(e)
    return entries


def contract_fp32(k4_cases: list, kw_cases: list, res_child: dict,
                  w_child: dict) -> list:
    """The fp32 steps' entries (Paths A and B, 1 frame pair, depths
    PARITY_DEPTHS): K4 and K5 on the tensor cores with dtype float32,
    launches by kernel and shape from the children; ms, bounds and errors
    from the fp32 kernel case timed at the same shape and W (1 frame pair,
    mode "fp32"); a launch without one raises."""
    entries = []
    for child in (res_child, w_child):
        for key, n in sorted(child["launches_by_kernel"].items()):
            kernel, dims = key.split("|")
            if not ("resident_tc" in kernel or "_tc_w" in kernel):
                continue
            B_, N, C, nH = (int(x) for x in dims.split(","))
            shape = next(s for s in stage_shapes(batch=1)
                         if (s["B_"], s["N"], s["C"], s["nH"])
                         == (B_, N, C, nH))
            if "resident" in kernel:
                want = {"direction": None, "W": None}
                src, rep = KERNEL_RESIDENT_TC_SOURCE, KERNEL_RESIDENT_REPLACES
            else:
                bwd = "_bwd" in kernel
                want = {"direction": "backward" if bwd else "forward",
                        "W": int(kernel.split("_w")[1].split("+")[0]),
                        "lse": None if bwd else "+lse" in kernel}
                src = KERNEL_TC_BWD_SOURCE if bwd else KERNEL_TC_SOURCE
                rep = KERNEL_W_BWD_REPLACES if bwd else KERNEL_W_REPLACES
            cases = [x for x in (k4_cases if "resident" in kernel
                                 else kw_cases)
                     if x["dtype"] == "float32" and x["frame_pairs"] == 1
                     and x.get("mxu", "fp32") == "fp32" and "ms" in x
                     and x["stage"] == shape["stage"] and x["B_"] == B_
                     and not x.get("every_head_scale_60")
                     and all(x.get(k) == v for k, v in want.items()
                             if v is not None)]
            if not cases:
                raise RuntimeError(f"no fp32 kernel case timed at {key} "
                                   f"{want}")
            # the masked blocks' case where both kinds launch at this W
            c = max(cases, key=lambda x: x["nW"])
            e = _entry(kernel, dict(shape, nW=c["nW"]), src, rep, n, c, 1,
                       dtype="fp32")
            e["dtype"] = "float32"
            entries.append(e)
    return entries


# ---------------------------------------------------------------------------
# the tools' kernels (T1-T3) and the packed kernels' precision modes
# ---------------------------------------------------------------------------

def _tool_entry(name: str, source: str, replaces: str, launches: int,
                rec: dict, **extra) -> dict:
    if launches == 0:
        raise RuntimeError(f"the tool run never launched {name}")
    entry = {"name": name, "route": "cuda", "source": source,
             "replaces": replaces, "launches": launches,
             "max_abs_err": rec["max_abs_err"], "ms": rec["ms"],
             "plain_ms": rec["plain_ms"], "bound_ms": rec["bound_ms"],
             "bound_by": rec["bound_by"], "library_ms": rec["library_ms"]}
    if "rel_l2_err" in rec:
        entry["rel_l2_err"] = rec["rel_l2_err"]
    entry.update(extra)
    return entry


def phase_probes() -> list:
    """T1: the probe tool's entry point (all six probes, stdout captured)
    with the launch counts read around it, then each kernel timed beside
    its plain version and the PyTorch call computing the same function."""
    import contextlib
    import io
    from mmde_tpu_torch.tools import probe_layouts as tpl
    builds = tool_libraries()
    tpl.LAUNCHES.clear()
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = tpl.main([])
    launches = dict(tpl.LAUNCHES)
    lines = buf.getvalue().splitlines()
    if rc != 0 or sum(ln.startswith("PASS ") for ln in lines) != 7:
        raise RuntimeError(f"probes: exit {rc}: {lines}")
    recs = tpl.run(timed=True, time_fn=lambda fn: time_ms(fn, reps=10))
    if not all(r["ok"] for r in recs):
        raise RuntimeError(f"probes (timed run): {recs}")
    entries = [_tool_entry(f"probe {r['name']}", tpl.SOURCE, r["replaces"],
                           launches.get(r["name"], 0), r) for r in recs]
    emit("probes", {"tool_output": lines, "launches": launches,
                    "cases": recs,
                    "tool_libraries_nvcc_seconds": builds})
    return entries


def phase_variants() -> list:
    """T2 at the tool's four stages: v0 / v1 / v3 bitwise equal to the
    production library's K1 fp32-FMA body launched with mxu fp32 / fold /
    bf16 (serving entry, maxfree=False as the tool's body; the model's bf16
    launches take the tensor-core kernel), every variant within K1's bf16
    tolerance of its plain version, v3 and v4 also tbv.APART times nearer
    their own plain version than v1's; launches by (mode, shape) read
    around the tool's run."""
    from mmde_tpu_torch.ops import window_attention_packed as wap
    from mmde_tpu_torch.tools import bench_attention_variants as tbv
    wap.reset_launch_counts()
    recs = tbv.run(list(tbv.STAGES))
    counts = dict(wap.LAUNCHES_BY_MXU)
    entries, cases = [], []
    for stage in tbv.STAGES:
        qkv, ls, bias, mask, nH = tbv.make_inputs(stage)
        key = tuple(qkv.shape[:2]) + (qkv.shape[2] // 3, nH)
        by_v = {r["variant"]: r for r in recs if r["stage"] == stage}
        for v, rec in by_v.items():
            if not rec["ok"]:
                raise RuntimeError(f"variants: {stage} {v} disagrees with "
                                   f"its plain version: {rec}")
            if v in ("v0", "v1", "v3"):
                with torch.no_grad():
                    prod = wap._launch_forward(qkv, ls, bias, mask, nH, False,
                                               False, mxu=rec["mxu"],
                                               _fma=True)[0]
                rec["bitwise_equal_to_production"] = bool(
                    torch.equal(prod, rec["_out"]))
                if not rec["bitwise_equal_to_production"]:
                    raise RuntimeError(f"variants: {stage} {v} differs from "
                                       f"the production K1 (mxu="
                                       f"{rec['mxu']})")
        if not torch.equal(by_v["v1"]["_out"], by_v["v2"]["_out"]):
            raise RuntimeError(f"variants: {stage} v2 differs from v1")
        for v, rec in by_v.items():
            del rec["_out"]
            cases.append(rec)
            if v == "v2":           # v1's launch (see the tool's docstring)
                continue
            entries.append(_tool_entry(
                f"window_attention_fwd variant {v}{'/v2' if v == 'v1' else ''}"
                f" (mxu={rec['mxu']}) [{stage} B_={key[0]} N={key[1]} "
                f"C={key[2]} nH={nH} bf16{' mask' if mask is not None else ''}"
                "]", KERNEL_SOURCE, tbv.REPLACES,
                counts.get((rec["mxu"], key), 0), dict(rec, library_ms=None)))
    emit("variants", {"cases": cases,
                      "launches_by_mxu": {f"{m} {k}": n for (m, k), n
                                          in counts.items()},
                      "timing": "CUDA events, 3 warm + 20 launches, median"})
    return entries


def phase_roofline() -> tuple:
    """T3: the micro-kernels against their plain versions (16 iterations),
    then `microbench` (launches counted around it): the rates, none above
    105 % of its published peak; the port's K1 / K2 work at the flagship's
    train shapes (2 frame pairs) at those rates beside their measured ms;
    the fixed buckets."""
    from mmde_tpu_torch.tools import roofline as trl
    checks = trl.check(timed=True)
    if not all(r["ok"] for r in checks):
        raise RuntimeError(f"roofline micro-kernels disagree with their "
                           f"plain versions: {checks}")
    trl.LAUNCHES.clear()
    rates = trl.microbench()
    launches = dict(trl.LAUNCHES)
    attn = {}
    for stage, (B_, nH, N, C, nW, blocks) in trl.stages(2).items():
        attn[stage] = {"shape": [B_, nH, N, C, nW], "blocks": blocks,
                       "cost": trl.attention_cost(B_, nH, N, C, nW, rates),
                       "measured_ms": trl.measure_stage(B_, nH, N, C, nW)}
    rec = {"rates": {k: v for k, v in rates.items() if k != "_detail"},
           "peaks_105pct_of": trl.PEAKS, "detail": rates["_detail"],
           "launches": launches, "checks": checks,
           "attention_2_pairs": attn,
           "fixed_buckets_2_pairs": trl.fixed_buckets(rates, 2)}
    emit("roofline", rec)
    entries = []
    for r in checks:
        kind = "mxu" if r["name"].startswith("dot") else "vpu"
        replaces = (trl.REPLACES[kind] if r["name"] != "copy" else
                    "tools/roofline.py:149 (microbench's HBM copy; XLA, "
                    "no pallas_call)")
        size = "256 MB" if r["name"] == "copy" else f"iters {r['iters']}"
        entries.append(_tool_entry(f"roofline {r['name']} ({size})",
                                   trl.SOURCE, replaces,
                                   launches.get(r["name"], 0), r))
    return entries, rec


# mxu="bf16" is held to its own plain version (forward and plain backward;
# for fp32 qkv also the backward's formulas in float64, where bf16 qkv
# would add their own output rounding, ~1.7e-3) at limits near the
# geometric mean of the sound kernels' largest error and the distance
# between the bf16 and the fold plain versions (rel-L2 over these cases:
# out 7.6e-5 / 5.7e-3, dqkv 3.1e-4 / 1.8e-2, dlogit_scale 2.4e-4 / 4.1e-3,
# dbias 1.9e-4 / 5.7e-3; PERF.md, Findings), so that a kernel computing
# another mode fails; and the kernel must lie MXU_APART times nearer to the
# bf16 plain version than to the fold one (forward and dqkv).
TOL_MXU_BF16 = {"out": 6e-4, "dqkv": 2e-3, "dlogit_scale": 1e-3,
                "dbias": 1e-3}
MXU_APART = 4.0
# mxu="bf16" against float64 autograd of its own forward: the mode's
# backward formulas (the JAX package's) round ds and take dlogit_scale as
# sum(ds * sc) with sc built from the rounded q^ * scale, while the exact
# derivative of the rounded forward uses the unrounded one, so dlogit_scale
# is read there but held only to the formulas above.
TOL_MXU_BF16_AUTOGRAD = {"dqkv": 4e-3, "dbias": 4e-3}


def _check_against(got, refs: dict, what: str,
                   clamped: bool = True) -> dict:
    """dqkv, dlogit_scale, dbias of a backward kernel against each
    reference of `refs` ({name: (tensors, {output: rel-L2 tolerance})}; an
    output without a tolerance is read, not held); raises on disagreement,
    a value that is not finite, or (`clamped`: head 0 above the clamp) a
    clamped head's dlogit_scale not 0."""
    names = ("dqkv", "dlogit_scale", "dbias")
    if not all(bool(torch.isfinite(t).all()) for t in got):
        raise RuntimeError(f"{what}: backward output not finite")
    if clamped and float(got[1].flatten()[0]) != 0.0:
        raise RuntimeError(f"{what}: dlogit_scale of the clamped head is "
                           f"{float(got[1].flatten()[0])}, not 0")
    out = {ref: {n: _errs(k, w) for n, k, w in zip(names, got, want)}
           for ref, (want, _) in refs.items()}
    for ref, (_, tol) in refs.items():
        for n, e in out[ref].items():
            if n in tol and not e["rel_l2"] <= tol[n]:
                raise RuntimeError(f"{what} disagrees ({ref}, {n}): "
                                   f"{json.dumps(out)}")
    return out


def _plain_mode(qkv, ls, bias, mask, g, nH, mxu):
    """The plain forward and the plain backward in mode `mxu`."""
    from mmde_tpu_torch.ops import window_attention_packed as wap
    with torch.no_grad():
        return (wap.cosine_window_attention_packed_plain(
                    qkv, ls, bias, mask, num_heads=nH, mxu=mxu),
                wap.cosine_window_attention_packed_backward_plain(
                    qkv, ls, bias, mask, g, num_heads=nH, mxu=mxu))


def _apart(out, grads, want, plain, qkv, ls, bias, mask, g, nH) -> dict:
    """The bf16-mode kernel's rel-L2 distance to the bf16 plain version, to
    the fold one, and the two plain versions' distance, for the forward
    and each gradient; raises unless the kernel lies MXU_APART times nearer
    to the bf16 plain version (forward and dqkv)."""
    want_f, plain_f = _plain_mode(qkv, ls, bias, mask, g, nH, "fold")
    rec = {}
    for n, k, w, f in zip(("out", "dqkv", "dlogit_scale", "dbias"),
                          (out,) + tuple(grads), (want,) + tuple(plain),
                          (want_f,) + tuple(plain_f)):
        rec[n] = {"to_bf16_plain": _errs(k, w)["rel_l2"],
                  "to_fold_plain": _errs(k, f)["rel_l2"],
                  "bf16_plain_to_fold_plain": _errs(w, f)["rel_l2"]}
    for n in ("out", "dqkv"):
        r = rec[n]
        if not r["to_fold_plain"] >= MXU_APART * r["to_bf16_plain"]:
            raise RuntimeError(f"mxu=bf16 kernel not {MXU_APART}x nearer "
                               f"to the bf16 plain version than to the "
                               f"fold one ({n}): {json.dumps(rec)}")
    return rec


def compare_mxu(shape, dtype, mxu: str, gen, timed=True) -> dict:
    """K1 (+ log-sum-exp) and K2 through the autograd Function, and K5 at
    the rule's W, in precision mode `mxu` at one train shape: forwards
    against the plain forward of that mode, backwards against the plain
    backward and float64 autograd of the plain forward in that mode, and
    against the mode's formulas evaluated in float64 (the plain backward at
    float64). "bf16" at TOL_MXU_BF16 (float64 at TOL_BWD's bf16 limits for
    bf16 qkv, autograd at TOL_MXU_BF16_AUTOGRAD) and MXU_APART (_apart);
    the other modes at the bf16 tolerances where the type is bf16, else
    fp32's. Head 0 clamped (scale 100: the row maximum), head 1 hot."""
    from mmde_tpu_torch.ops import window_attention_packed as wap
    masked = shape["nW"] > 0
    qkv, ls, bias, mask = make_kernel_inputs(shape, dtype, masked, gen)
    ls[1] = 4.0
    nH, B_, N, C = shape["nH"], shape["B_"], shape["N"], shape["C"]
    g = torch.randn((B_, N, C), device="cuda", generator=gen).to(dtype)
    tol = ("mxu_bf16" if mxu == "bf16" else
           "bfloat16" if dtype == torch.bfloat16 else "float32")
    tol_b = TOL_MXU_BF16 if mxu == "bf16" else TOL_BWD[tol]
    rec = dict(_case_head(shape, dtype, mask), mxu=mxu, tolerance=tol,
               tolerance_rel_l2=tol_b, frame_pairs=2)
    want, plain = _plain_mode(qkv, ls, bias, mask, g, nH, mxu)
    truth = _float64_grads(qkv, ls, bias, mask, g, nH, mxu)
    with torch.no_grad():
        formulas = wap.cosine_window_attention_packed_backward_plain(
            qkv.double(), ls, bias.double(),
            None if mask is None else mask.double(), g.double(),
            num_heads=nH, compute_dtype=torch.float64, mxu=mxu)
    refs = {"vs_plain": (plain, tol_b),
            "vs_float64_formulas": (formulas, TOL_BWD[
                "bfloat16"] if dtype == torch.bfloat16 else tol_b),
            "vs_float64_autograd": (truth, TOL_MXU_BF16_AUTOGRAD
                                    if mxu == "bf16" else tol_b)}
    leaves = [t.detach().clone().requires_grad_() for t in (qkv, ls, bias)]
    out = wap.cosine_window_attention_packed(leaves[0], leaves[1], leaves[2],
                                             mask, num_heads=nH, mxu=mxu)
    out.backward(g)
    torch.cuda.synchronize()
    grads = [t.grad for t in leaves]
    if mxu == "bf16":
        rec["apart"] = _apart(out.detach(), grads, want, plain, qkv, ls,
                              bias, mask, g, nH)

    def forward_ok(got):
        if mxu != "bf16":
            return check_forward(got, want, torch.bfloat16 if tol ==
                                 "bfloat16" else torch.float32, rec)
        e = {"max_abs_err": _errs(got, want)["max_abs"],
             "rel_l2_err": _errs(got, want)["rel_l2"],
             "tolerance": {"rel_l2": TOL_MXU_BF16["out"]}}
        if not (e["rel_l2_err"] <= TOL_MXU_BF16["out"]
                and bool(torch.isfinite(got).all())):
            raise RuntimeError(f"K1 (mxu=bf16) disagrees with its plain "
                               f"version: {json.dumps(e)} at "
                               f"{json.dumps(rec)}")
        return e

    rec["forward"] = forward_ok(out.detach())
    rec["backward"] = _check_against(grads, refs,
                                     f"K2 (mxu={mxu}) at {json.dumps(rec)}")
    w_f, w_b = _w_of(shape, False, masked), _w_of(shape, True, masked)
    rec["W"] = [w_f, w_b]
    with torch.no_grad():
        out_w, _ = wap._launch_forward(qkv, ls, bias, mask, nH, True, True,
                                       w=w_f, mxu=mxu)
        rec["forward_w"] = forward_ok(out_w)
        # K5's backward reads the statistic of K5's forward, as in the
        # model (see compare_w)
        lse = wap._launch_forward(qkv, ls, bias, mask, nH, True, True,
                                  w=w_f, mxu=mxu)[1]
        got_w = wap._launch_backward(qkv, ls, bias, mask, lse, g, nH,
                                     "window_resident", True, w=w_b,
                                     mxu=mxu)
        torch.cuda.synchronize()
        rec["backward_w"] = _check_against(got_w, refs,
                                           f"K5 (mxu={mxu}) at "
                                           f"{json.dumps(rec)}")
        err = rec["backward"]["vs_float64_formulas"]["dqkv"]
        rec["max_abs_err"], rec["rel_l2_err"] = err["max_abs"], err["rel_l2"]
        if timed:
            # the exact mode at the same inputs, in the same call
            for m in dict.fromkeys(("fp32", mxu)):
                sfx = "" if m == mxu else "_fp32"
                rec["fwd_lse_ms" + sfx] = time_ms(lambda: wap._launch_forward(
                    qkv, ls, bias, mask, nH, True, True, mxu=m))
                lse_m = wap._launch_forward(qkv, ls, bias, mask, nH, True,
                                            True, mxu=m)[1]
                rec["bwd_ms" + sfx] = time_ms(lambda: wap._launch_backward(
                    qkv, ls, bias, mask, lse_m, g, nH, "window_resident",
                    True, mxu=m), reps=8, warm=2)
            rec[f"fwd_lse_w{w_f}_ms"] = time_ms(lambda: wap._launch_forward(
                qkv, ls, bias, mask, nH, True, True, w=w_f, mxu=mxu))
            rec[f"bwd_w{w_b}_ms"] = time_ms(lambda: wap._launch_backward(
                qkv, ls, bias, mask, lse, g, nH, "window_resident", True,
                w=w_b, mxu=mxu), reps=8, warm=2)
            rec["forward"]["ms"] = rec["fwd_lse_ms"]
            rec["forward"]["plain_ms"] = time_ms(
                lambda: wap.cosine_window_attention_packed_plain(
                    qkv, ls, bias, mask, num_heads=nH, mxu=mxu), reps=3,
                warm=1)
            rec["ms"] = rec["bwd_ms"]
            rec["plain_ms"] = time_ms(
                lambda: wap.cosine_window_attention_packed_backward_plain(
                    qkv, ls, bias, mask, g, num_heads=nH, mxu=mxu), reps=3,
                warm=1)
            rec["forward"].update(kernel_bound(B_, N, C, nH, rec["nW"],
                                               dtype, bias.dtype, stats=True))
            rec.update(backward_bound(B_, N, C, nH, rec["nW"], dtype,
                                      bias.dtype))
            rec["forward"]["library_ms"] = rec["library_ms"] = None
    del truth, formulas, plain, want, leaves, out, grads
    torch.cuda.empty_cache()
    return rec


def phase_kernels_mxu(timed: bool = True) -> list:
    """K1+lse, K2 and K5 under "fold" and "bf16" (and, for bfloat16, the
    exact "fp32", which the model's default no longer takes) at flagship
    stages 1 and 4 (train shape, 2 frame pairs), float32 and bfloat16.
    Every case runs; the phase's line is printed, then it fails if any
    case disagreed."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(7373)
    shapes = stage_shapes(batch=2)
    cases, failed = [], []
    for shape in (shapes[0], shapes[3]):
        for dtype, modes in ((torch.bfloat16, ("fp32", "fold", "bf16")),
                             (torch.float32, ("fold", "bf16"))):
            for mxu in modes:
                try:
                    cases.append(compare_mxu(shape, dtype, mxu, gen, timed))
                except RuntimeError as e:
                    failed.append(str(e))
                torch.cuda.empty_cache()
    emit("kernel_cases_mxu", {
        "cases": cases, "failed": failed,
        "timing": "CUDA events around one launch (forward with lse; "
                  "backward: the dq and dk/dv passes), median of 20 / 8; "
                  "*_fp32 keys: the exact mode at the same inputs"})
    if failed:
        raise RuntimeError(f"kernel_cases_mxu: {len(failed)} case(s) "
                           f"disagree: {failed[0]}")
    return cases


def phase_mxu_child(lines: list) -> tuple:
    """The bf16 mode, read off its process: the flagship under
    MMDE_ATTN_MXU=bf16, `serve_mxu` (1 request) and `train_mxu` (3 steps),
    every packed launch in the bf16 mode (checked in the child)."""
    got = {k: v for ln in lines for k, v in ln.items()
           if k in ("serve_mxu", "train_mxu")}
    if set(got) != {"serve_mxu", "train_mxu"}:
        raise RuntimeError(f"mxu child printed {[list(ln) for ln in lines]}")
    for tag in ("serve_mxu", "train_mxu"):
        if set(got[tag]["launches_by_mxu"]) != {"bf16"}:
            raise RuntimeError(f"{tag}: launches by mode "
                               f"{got[tag]['launches_by_mxu']}")
        emit(tag, dict(got[tag], shared_card=SHARED_CARD))
    return got["serve_mxu"], got["train_mxu"]


def contract_mxu(mxu_cases: list, train_mxu: dict) -> list:
    """The bf16 mode's K1 (served; with lse, trained) and K2 at the shapes
    kernel_cases_mxu measured (stages 1 and 4), launches from the
    MMDE_ATTN_MXU=bf16 child."""
    entries = []
    for shape in stage_shapes(batch=2):
        if shape["stage"] not in (1, 4):
            continue
        c = next(c for c in mxu_cases if c["stage"] == shape["stage"]
                 and c["dtype"] == "bfloat16" and c["mxu"] == "bf16")
        key = str((shape["B_"], shape["N"], shape["C"], shape["nH"]))
        by_kernel = train_mxu["launches_by_kernel"]
        entries.append(_entry(
            "window_attention_fwd_tc+lse [mxu=bf16]", shape, KERNEL_TC_SOURCE,
            KERNEL_REPLACES,
            by_kernel.get("window_attention_fwd_tc+lse", {}).get(key, 0),
            c["forward"], 2))
        entries.append(_entry(
            "window_attention_bwd_tc [mxu=bf16]", shape, KERNEL_TC_BWD_SOURCE,
            KERNEL_BWD_REPLACES,
            by_kernel.get("window_attention_bwd_tc", {}).get(key, 0), c, 2))
    return entries


# ---------------------------------------------------------------------------
# K1 and K2 on the tensor cores (bf16 mma.sync)
# ---------------------------------------------------------------------------

def tc_units(mxu: str, train: bool, ls, maxfree: bool = True,
             f32: bool = False) -> float:
    """N x N x 32 bf16 products the design needs (a split operand, bf16 hi
    and lo, counts as two), not what the kernels issue: forward S and p v
    (fp32 / fold: p split, 3; bf16: 2, and one more S sweep for each head
    that takes the exact row maximum, as a share of the heads); backward S,
    dP, dv, dq and dk (fp32 / fold: the last three split, 8; bf16: 5). The
    kernels issue 3 / 2 + share forward and 12 / 9 backward: the dq pass
    sweeps S and dP twice (delta first), the dk/dv pass recomputes them.
    `f32` (fp32 qkv, fp32 / fold): every operand in three bf16 pieces, six
    piece products a product - forward 12, backward 30 (the kernels issue
    12 and 54)."""
    from mmde_tpu_torch.ops.window_attention import MAX_LOGIT_SCALE
    if f32 and mxu != "bf16":
        return 30.0 if train else 12.0
    if train:
        return 5.0 if mxu == "bf16" else 8.0
    if mxu != "bf16":
        return 3.0
    scale = torch.exp(torch.clamp(ls.flatten().float(), max=MAX_LOGIT_SCALE))
    hot = float(((scale > 30.0) | (not maxfree)).float().mean())
    return 2.0 + hot


def tc_work(B_, N, nH, units: float) -> dict:
    """The products' flops, on the 64-row tiles the kernels compute (N
    padded); their time (tc_bound_ms) is set by `tc_bounds` from the
    roofline phase's measured bf16 mma.sync rate."""
    np_ = -(-N // 64) * 64
    return {"tc_units": units,
            "tc_flops": units * 2 * B_ * nH * np_ * np_ * 32}


def tc_bounds(tc_cases: list, tflops: float) -> None:
    """tc_bound_ms of every tensor-core record of kernel_cases_tc,
    kernel_cases_headsplit, kernel_cases_slab, kernel_cases_resident and
    kernel_cases_w (served: the case; trained: its forward, the
    forward with statistics and the backward): its products at `tflops`,
    the bf16 mma.sync dot pattern's rate that this run's roofline phase
    measured (tools/roofline.py, dot_bf16_TFLOP_s)."""
    for c in tc_cases:
        for r in (c, c.get("forward"), c.get("forward_stats")):
            if r is not None and "tc_flops" in r:
                r["tc_rate_TFLOP_s"] = tflops
                r["tc_bound_ms"] = r["tc_flops"] / (tflops * 1e12) * 1e3


def k3_bounds(k2_cases: list, rates: dict) -> None:
    """K3's bounds beside each K2 case that timed it: its two N x N x 32
    products (S and dP; K3 sums ds into dbias with windows innermost) on
    64-row tiles, at the fp32 rates this run's roofline phase measured -
    the FMA dot pattern's (k3_fma_bound_ms) and the FMA chain's
    (k3_fma_chain_bound_ms) - and the tensor-core K3's products (2 units
    bf16, 12 fp32 in three pieces: k3_tc) at its bf16 mma.sync rate
    (k3_tc["tc_bound_ms"])."""
    for c in k2_cases:
        for r in (c, c.get("split")):     # head-split cases: their split leg
            if not r or "k3_ms" not in r:
                continue
            flops = tc_work(c["B_"], c["N"], c["nH"], 2.0)["tc_flops"]
            r["k3_fma_bound_ms"] = flops / (rates["dot_fp32_TFLOP_s"] * 1e9)
            r["k3_fma_chain_bound_ms"] = flops / (rates["fma_TFLOP_s"] * 1e9)
            tc_bounds([r["k3_tc"]], rates["dot_bf16_TFLOP_s"])


def _nearer(rec: dict, what: str, got, own, other) -> None:
    """The kernel must lie MXU_APART times nearer the plain version of its
    own mode than the other one's (fold / fp32 against "bf16", "bf16"
    against "fold"): a kernel that rounds what its mode does not, or does
    not round what it does, fails."""
    r = {"to_own_plain": _errs(got, own)["rel_l2"],
         "to_other_plain": _errs(got, other)["rel_l2"],
         "own_plain_to_other_plain": _errs(own, other)["rel_l2"]}
    rec.setdefault("apart", {})[what] = r
    if not r["to_other_plain"] >= MXU_APART * r["to_own_plain"]:
        raise RuntimeError(f"tensor-core kernel (mxu={rec['mxu']}) not "
                           f"{MXU_APART}x nearer its own plain version "
                           f"({what}): {json.dumps(rec)}")


def _tc_launched(before: dict, want: dict, what: str, module=None) -> None:
    """The kernels the wrapper `module` (the packed one by default) counted
    since `before` (a copy of its LAUNCHES_BY_KERNEL) must be `want`
    ({kernel: launches})."""
    if module is None:
        from mmde_tpu_torch.ops import window_attention_packed as module
    got = {}
    for (kernel, _), n in module.LAUNCHES_BY_KERNEL.items():
        got[kernel] = got.get(kernel, 0) + n
    for (kernel, _), n in before.items():
        got[kernel] -= n
    got = {k: n for k, n in got.items() if n}
    if got != want:
        raise RuntimeError(f"{what}: launched {got}, expected {want}")


def compare_tc(shape, mxu: str, train: bool, gen, timed=True,
               dtype=torch.bfloat16) -> dict:
    """The tensor-core kernels at one flagship shape (qkv, bias and mask of
    `dtype`, the model's mask where it has one; head 0 clamped at scale
    100, head 1 hot at scale 54.6 - both the online maximum, or in "bf16"
    the exact-maximum sweep - the others cool, the static shift) in mode
    `mxu`, through the wrapper as the model calls it: served, the forward
    alone; trained, the forward with its log-sum-exp and the backward under
    autograd. Held to the plain version of the mode (fold / fp32:
    TOL_BF16_REL_L2 and TOL_BWD's bf16 limits for bf16 qkv, TOL_FP32_MAX_ABS
    and TOL_BWD's fp32 limits for fp32 qkv; bf16: TOL_MXU_BF16) and to
    float64 autograd of it (TOL_BWD / TOL_MXU_BF16_AUTOGRAD), and MXU_APART
    times nearer its own mode's plain version than the other's (_nearer).
    Timed in the same call: the kernel, the fp32-FMA body (`_fma`), the
    kernel and the FMA body again (ms = the two turns' mean), the plain
    version, the SDPA yardstick in qkv's type; trained also the backward
    without dbias. The products' bound: tc_units (fp32 qkv in three bf16
    pieces: 12 / 30 in fp32 and fold). Trained, also the tensor-core K3 of
    the mode ("split", `k3`: check_k3 at TOL_BWD / TOL_MXU_BF16, float64
    at TOL_BWD / TOL_MXU_BF16_AUTOGRAD, the mode rule, bitwise)."""
    from mmde_tpu_torch.ops import window_attention_packed as wap
    masked = shape["nW"] > 0
    qkv, ls, bias, mask = make_kernel_inputs(shape, dtype, masked, gen)
    ls[1] = 4.0
    nH, B_, N, C = shape["nH"], shape["B_"], shape["N"], shape["C"]
    other = "fold" if mxu == "bf16" else "bf16"
    name = str(dtype).replace("torch.", "")
    f32 = dtype == torch.float32
    rec = dict(_case_head(shape, dtype, mask), mxu=mxu,
               frame_pairs=2 if train else 1)
    with torch.no_grad():
        want = wap.cosine_window_attention_packed_plain(
            qkv, ls, bias, mask, num_heads=nH, mxu=mxu)
        want_o = wap.cosine_window_attention_packed_plain(
            qkv, ls, bias, mask, num_heads=nH, mxu=other)
    before = dict(wap.LAUNCHES_BY_KERNEL)
    if train:
        g = torch.randn((B_, N, C), device="cuda", generator=gen).to(dtype)
        leaves = [t.detach().clone().requires_grad_() for t in (qkv, ls, bias)]
        out = wap.cosine_window_attention_packed(
            leaves[0], leaves[1], leaves[2], mask, num_heads=nH, mxu=mxu)
        out.backward(g)
        torch.cuda.synchronize()
        grads = [t.grad for t in leaves]
        _tc_launched(before, {"window_attention_fwd_tc+lse": 1,
                              "window_attention_bwd_tc": 1}, f"{rec}")
    else:
        with torch.no_grad():
            out = wap.cosine_window_attention_packed(qkv, ls, bias, mask,
                                                     num_heads=nH, mxu=mxu)
        torch.cuda.synchronize()
        _tc_launched(before, {"window_attention_fwd_tc": 1}, f"{rec}")
    out = out.detach()
    if mxu == "bf16":
        fwd = {"max_abs_err": _errs(out, want)["max_abs"],
               "rel_l2_err": _errs(out, want)["rel_l2"],
               "tolerance": {"rel_l2": TOL_MXU_BF16["out"]}}
        if not (fwd["rel_l2_err"] <= TOL_MXU_BF16["out"]
                and bool(torch.isfinite(out).all())):
            raise RuntimeError(f"tensor-core forward (mxu=bf16) disagrees "
                               f"with its plain version: {json.dumps(fwd)} "
                               f"at {json.dumps(rec)}")
    else:
        fwd = check_forward(out, want, dtype, rec)
    _nearer(rec, "out", out, want, want_o)
    if train:
        with torch.no_grad():
            plain = wap.cosine_window_attention_packed_backward_plain(
                qkv, ls, bias, mask, g, num_heads=nH, mxu=mxu)
            plain_o = wap.cosine_window_attention_packed_backward_plain(
                qkv, ls, bias, mask, g, num_heads=nH, mxu=other)
        truth = _float64_grads(qkv, ls, bias, mask, g, nH, mxu)
        rb = mxu == "bf16"
        rec["backward"] = _check_against(grads, {
            "vs_plain": (plain, TOL_MXU_BF16 if rb else TOL_BWD[name]),
            "vs_float64_autograd": (truth, TOL_MXU_BF16_AUTOGRAD if rb
                                    else TOL_BWD[name])},
            f"tensor-core backward (mxu={mxu}) at {json.dumps(rec)}")
        _nearer(rec, "dqkv", grads[0], plain[0], plain_o[0])
        err = rec["backward"]["vs_float64_autograd"]["dqkv"]
        rec["max_abs_err"], rec["rel_l2_err"] = err["max_abs"], err["rel_l2"]
        rec["forward"] = fwd
        # "split": the tensor-core K3 in this mode, after the passes, on
        # their delta and the tensor-core forward's statistic
        with torch.no_grad():
            lse = wap._launch_forward(qkv, ls, bias, mask, nH, True, True,
                                      mxu=mxu)[1]
            delta = wap._backward_passes(qkv, ls, bias, mask, lse, g, nH,
                                         False, 1, mxu, False)[3]

            def k3():
                return wap._launch_dbias(qkv, ls, bias, mask, lse, g, delta,
                                         nH, mxu)

            def plain_k3(m):
                return wap.cosine_window_attention_packed_dbias_plain(
                    qkv, ls, bias, mask, g, num_heads=nH, mxu=m)
            before = dict(wap.LAUNCHES_BY_KERNEL)
            got = k3()
            torch.cuda.synchronize()
            _tc_launched(before, {"window_attention_dbias_tc": 1},
                         f"K3 {json.dumps(rec)}")
            rec["k3"] = check_k3(
                got, k3(), plain_k3(mxu), plain_k3(other), truth[2],
                TOL_MXU_BF16["dbias"] if rb else TOL_BWD[name]["dbias"],
                TOL_MXU_BF16_AUTOGRAD["dbias"] if rb
                else TOL_BWD[name]["dbias"], mxu, f"{json.dumps(rec)}")
            del got, lse, delta
        del truth, plain, plain_o, leaves, grads
    else:
        rec.update(fwd)
    del want, want_o
    if timed:
        with torch.no_grad():
            stats = train

            def tc():
                return wap._launch_forward(qkv, ls, bias, mask, nH, True,
                                           stats, mxu=mxu)

            def fma():
                return wap._launch_forward(qkv, ls, bias, mask, nH, True,
                                           stats, mxu=mxu, _fma=True)
            turns = [time_ms(tc), time_ms(fma), time_ms(fma), time_ms(tc)]
            f = {"ms": (turns[0] + turns[3]) / 2,
                 "fma_ms": (turns[1] + turns[2]) / 2, "ms_turns": turns,
                 "plain_ms": time_ms(
                     lambda: wap.cosine_window_attention_packed_plain(
                         qkv, ls, bias, mask, num_heads=nH, mxu=mxu),
                     reps=3, warm=1)}
            f.update(kernel_bound(B_, N, C, nH, rec["nW"], dtype,
                                  bias.dtype, stats=stats))
            f.update(tc_work(B_, N, nH, tc_units(mxu, False, ls, f32=f32)))
        lib = library_yardstick(*wap._split_heads(qkv, 3, nH), ls, bias,
                                mask, g=wap._split_heads(g, 1, nH)[0]
                                if train else None)
        f.update({k: v for k, v in lib.items() if k != "library_bwd_ms"})
        if not train:
            rec.update(f)
        else:
            rec["forward"].update(f)
            with torch.no_grad():
                lse = tc()[1]
                lse_f = fma()[1]

                def bwd(dbias=True, **kw):
                    saved = lse_f if kw.get("_fma") else lse
                    return lambda: wap._launch_backward(
                        qkv, ls, bias, mask, saved, g, nH, "window_resident",
                        dbias, mxu=mxu, **kw)
                turns = [time_ms(bwd(), reps=8, warm=2),
                         time_ms(bwd(_fma=True), reps=8, warm=2),
                         time_ms(bwd(_fma=True), reps=8, warm=2),
                         time_ms(bwd(), reps=8, warm=2)]
                rec.update({
                    "ms": (turns[0] + turns[3]) / 2,
                    "fma_ms": (turns[1] + turns[2]) / 2, "ms_turns": turns,
                    "ms_no_dbias": time_ms(bwd(dbias=False), reps=8, warm=2),
                    "plain_ms": time_ms(
                        lambda: wap.cosine_window_attention_packed_backward_plain(
                            qkv, ls, bias, mask, g, num_heads=nH, mxu=mxu),
                        reps=3, warm=1)})
            rec.update(backward_bound(B_, N, C, nH, rec["nW"], dtype,
                                      bias.dtype))
            rec.update(tc_work(B_, N, nH, tc_units(mxu, True, ls, f32=f32)))
            rec.update({k: v for k, v in lib.items() if k != "library_ms"})
            rec["library_ms"] = lib["library_bwd_ms"]
    torch.cuda.empty_cache()
    return rec


def phase_kernels_tc(timed: bool = True) -> list:
    """The tensor-core K1 / K2 at the flagship's four stages, served (1
    frame pair, forward) and trained (2 pairs, forward with log-sum-exp and
    backward), bf16 and fp32 qkv, in modes fold (the bf16 model's), fp32
    (the fp32 model's) and bf16 (compare_tc). Every case runs; the phase's
    line is printed, then it fails if any case disagreed."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(4242)
    cases, failed = [], []
    for dtype in (torch.bfloat16, torch.float32):
        for train in (False, True):
            for shape in stage_shapes(batch=2 if train else 1):
                for mxu in ("fold", "fp32", "bf16"):
                    try:
                        cases.append(compare_tc(shape, mxu, train, gen,
                                                timed, dtype))
                    except RuntimeError as e:
                        failed.append(str(e))
                    torch.cuda.empty_cache()
    emit("kernel_cases_tc", {
        "cases": cases, "failed": failed,
        "timing": "CUDA events around one launch (forward; backward: the dq "
                  "and dk/dv passes), median of 20 / 8 after warm-up, in "
                  "turns kernel, FMA body, FMA body, kernel (ms_turns); "
                  "inputs stay in L2"})
    if failed:
        raise RuntimeError(f"kernel_cases_tc: {len(failed)} case(s) "
                           f"disagree: {failed[0]}")
    return cases


# ----------------------------------------------- the training loop's entries

LOOP_PAIRS, LOOP_STEPS, LOOP_VAL = 2, 3, 8      # pairs a step, steps an epoch,
                                                # held-out samples


def _merge_launches(*dicts) -> dict:
    out = {"packed": {}, "headsplit": {}, "slab": {}}
    for d in dicts:
        for lay, by in d.items():
            for k, n in by.items():
                out[lay][k] = out[lay].get(k, 0) + n
    return out


def _loop_config(tmp: str) -> str:
    """configs/flagship_synth.yaml's model (bf16, 480x640, full depth)
    with validation and a checkpoint every epoch, every step printed and
    RESUME_FROM "auto", written to `tmp`."""
    import yaml
    root = os.path.dirname(os.path.abspath(__file__))
    with open(os.path.join(root, "configs", "flagship_synth.yaml")) as f:
        y = yaml.safe_load(f)
    y.update(VALIDATION_FREQUENCY=1, SAVE_FREQUENCY=1, SAVE_MODEL=True,
             PRINT_FREQUENCY=1, RESUME_FROM="auto")
    path = os.path.join(tmp, "flagship_loop.yaml")
    with open(path, "w") as f:
        yaml.safe_dump(y, f)
    return path


def _loop_log(log_dir: str) -> dict:
    """The run's logs.txt step lines ({epoch: [img/s ...]}) and its
    scalars.jsonl ({tag: {epoch: value}})."""
    import re
    rates: dict = {}
    with open(os.path.join(log_dir, "logs.txt")) as f:
        for line in f:
            m = re.match(r"Epoch \[(\d+)/\d+\] step \d+ .* ([\d.]+) img/s",
                         line)
            if m:
                rates.setdefault(int(m.group(1)), []).append(
                    float(m.group(2)))
    scalars: dict = {}
    with open(os.path.join(log_dir, "scalars.jsonl")) as f:
        for line in f:
            r = json.loads(line)
            scalars.setdefault(r["tag"], {})[r["step"]] = r["value"]
    return {"images_per_s_by_epoch": rates, "scalars": scalars}


def _state_tensors(state) -> dict:
    out = {f"model.{k}": v for k, v in state.model.state_dict().items()}
    opt = state.optimizer.state_dict()
    for i, st in opt["state"].items():
        for k, v in st.items():
            out[f"optimizer.{i}.{k}"] = v
    out["generator"] = state.generator.get_state()
    return out


def phase_loop(tmp: str) -> dict:
    """`python -m mmde_tpu_torch.tools.train` in this process on
    configs/flagship_synth.yaml's model (bf16, 480x640, full depth, weights
    from the config's seed): --batch-size 2, 2 epochs of 3 steps, each
    followed by a checkpoint and validation on the 8 synthetic held-out
    samples; the saved epoch-2 state restored into a fresh trainer and
    held bitwise to the state the run ended with; then the CLI again in
    the same log directory to 3 epochs, which resumes (RESUME_FROM "auto")
    at epoch 3 with the optimizer's count at 6. Launch counters set to 0
    before each run and read after: K1+lse / K2 once a block a step, K1
    once a block a validation sample."""
    from mmde_tpu_torch.ckpt import io
    from mmde_tpu_torch.config import load_yaml, replace
    from mmde_tpu_torch.tools import train as train_cli
    from mmde_tpu_torch.train import loop
    cfg_path = _loop_config(tmp)
    log_dir = os.path.join(tmp, "run")
    ckpt_dir = os.path.join(log_dir, "ckpt")
    free_before = shutil.disk_usage(tmp).free
    saves, restores, held = [], [], {}
    real_save, real_restore = io.save_epoch, io.restore

    def save(d, state, epoch):
        torch.cuda.synchronize()
        t = time.time()
        path = real_save(d, state, epoch)
        saves.append({"epoch": epoch, "seconds": time.time() - t,
                      "bytes": os.path.getsize(path)})
        held["state"] = state
        return path

    def restore(d, state, epoch=None):
        t = time.time()
        got, e = real_restore(d, state, epoch)
        torch.cuda.synchronize()
        restores.append({"epoch": e, "seconds": time.time() - t,
                         "count": got.optimizer.count, "step": got.step})
        return got, e

    argv = ["--config", cfg_path, "--synthetic", "--batch-size",
            str(LOOP_PAIRS), "--max-steps", str(LOOP_STEPS), "--log-dir",
            log_dir, "--device", "cuda"]
    rec = {"command": "python -m mmde_tpu_torch.tools.train "
                      + " ".join(argv[:1] + ["<flagship_synth.yaml + val, "
                                             "save every epoch, resume "
                                             "auto>"] + argv[2:]),
           "model": "swin_base_v2 + decoder_v2, bfloat16, 480x640, depths "
                    "2/2/18/2, weights from the config's seed",
           "frame_pairs": LOOP_PAIRS, "steps_per_epoch": LOOP_STEPS,
           "val_samples": LOOP_VAL}
    io.save_epoch, io.restore = save, restore
    try:
        runs = []
        for epochs in (2, 3):
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            _reset_launch_counts()
            n_save, n_restore = len(saves), len(restores)
            t = time.time()
            val = train_cli.main(argv + ["--epochs", str(epochs)])
            torch.cuda.synchronize()
            seconds = time.time() - t
            trained = epochs - (2 if epochs == 3 else 0)
            want_fwd = _merge_launches(
                expected_launches("swin_base_v2", LOOP_PAIRS,
                                  trained * LOOP_STEPS),
                expected_launches("swin_base_v2", 1, trained * LOOP_VAL))
            want_bwd = expected_launches("swin_base_v2", LOOP_PAIRS,
                                         trained * LOOP_STEPS)
            fwd, bwd = _launches(), _launches(backward=True)
            if fwd != want_fwd or bwd != want_bwd:
                raise RuntimeError(f"loop: launches forward {fwd}, backward "
                                   f"{bwd}; expected {want_fwd} / {want_bwd}")
            kernels = {k: sum(d.values()) for k, d in _by_kernel().items()}
            if any("_tc" not in k for k in kernels):
                raise RuntimeError(f"loop: an FMA body ran: {kernels}")
            runs.append({"epochs": epochs, "seconds": seconds,
                         "peak_memory_bytes": torch.cuda.max_memory_allocated(),
                         "launches": kernels,
                         "saves": saves[n_save:],
                         "restores": restores[n_restore:],
                         "last_val": val,
                         "_fwd": fwd, "_bwd": bwd})
            if epochs == 2:
                # the saved epoch-2 state into a fresh trainer, against the
                # state the run ended with (saving is the epoch's last
                # change; validation leaves the state alone)
                trained_state = held.pop("state")
                cfg = load_yaml(cfg_path)
                cfg = replace(cfg, train=replace(cfg.train, epochs=2,
                                                 batch_size=LOOP_PAIRS))
                fresh, _ = loop.build_state(cfg, LOOP_STEPS, "cuda")
                t = time.time()
                fresh, e = real_restore(ckpt_dir, fresh)
                torch.cuda.synchronize()
                want, got = _state_tensors(trained_state), \
                    _state_tensors(fresh)
                differ = [k for k in want if got.get(k) is None
                          or got[k].dtype != want[k].dtype
                          or not torch.equal(got[k].to(want[k].device),
                                             want[k])]
                rec["restore_check"] = {
                    "epoch": e, "seconds": time.time() - t,
                    "tensors": len(want), "bitwise_equal": len(want) - len(
                        differ), "differ": differ[:5],
                    "count": fresh.optimizer.count,
                    "step": fresh.step,
                    "param_dtypes": sorted({str(p.dtype) for p in
                                            fresh.model.parameters()}),
                    "parameters": sum(p.numel() for p in
                                      fresh.model.parameters())}
                del trained_state, fresh, want, got
                held.clear()
        rec["free_disk_bytes_before"] = free_before
        rec["free_disk_bytes_after"] = shutil.disk_usage(tmp).free
        rec["checkpoint_files"] = {
            os.path.relpath(os.path.join(d, n), ckpt_dir):
                os.path.getsize(os.path.join(d, n))
            for d, _, names in os.walk(ckpt_dir) for n in names}
        rec.update(_loop_log(log_dir))
    finally:
        io.save_epoch, io.restore = real_save, real_restore
        held.clear()
    rec["runs"] = [{k: v for k, v in r.items() if not k.startswith("_")}
                   for r in runs]
    resume = runs[1]["restores"]
    best = sorted(os.listdir(os.path.join(ckpt_dir, "best")))
    scal = rec["scalars"]
    finite = all(math.isfinite(v) for tag in scal.values()
                 for v in tag.values())
    rc = rec["restore_check"]
    rec["ok"] = (finite and rc["bitwise_equal"] == rc["tensors"]
                 and rc["epoch"] == 2 and rc["count"] == 2 * LOOP_STEPS
                 and len(resume) == 1 and resume[0]["epoch"] == 2
                 and resume[0]["count"] == 2 * LOOP_STEPS
                 and sorted(scal["train/loss_total"]) == [1, 2, 3]
                 and sorted(scal["val/rmse"]) == [1, 2, 3]
                 and len(best) == 1)
    emit("loop", rec)
    if not rec["ok"]:
        raise RuntimeError(f"loop: {json.dumps(rec)[:3000]}")
    rec["_cfg"], rec["_ckpt"], rec["_best"] = cfg_path, ckpt_dir, best[0]
    rec["_train"] = {"backbone": "swin_base_v2", "frame_pairs": LOOP_PAIRS,
                     "_attn_impl": "cuda", "_fwd_by_shape": runs[0]["_fwd"],
                     "_bwd_by_shape": runs[0]["_bwd"]}
    rec["_serve"] = {"backbone": "swin_base_v2", "_attn_impl": "cuda",
                     "_by_shape": runs[0]["_fwd"]}
    return rec


def phase_eval_ckpt(loop_rec: dict) -> dict:
    """`python -m mmde_tpu_torch.tools.eval --ckpt <the loop's ckpt/>
    --flip-tta --shift-window-tta` in this process on the loop's config
    (the 8 held-out samples, 480x640, crops of 480 at x = 0 and 160,
    flipped over the composition): the restored checkpoint must be the
    best one (ckpt/best/), its epoch the best file's; every attention
    launch K1 at the crops' shapes (2 crops a sample, 2 passes: 48 a
    sample). Then one request as `tools.infer --ckpt` serves it:
    infer.build, ckpt.io.restore_eval (best first), infer.predict on a
    480x640 pair. Then (`save`) the eval CLI again, on SAVE_BATCHES
    samples, with --save-pngs and --save-viz: each 16-bit PNG decodes to
    the eval step's depth (make_eval_step of the restored model, this
    process) x 1000 truncated, each panel is (4 x 480 + 12) x 1280 RGB, a
    pose file per sample in each directory."""
    from mmde_tpu_torch.ckpt import io
    from mmde_tpu_torch.config import load_yaml
    from mmde_tpu_torch.tools import eval as eval_cli
    from mmde_tpu_torch.tools import infer
    cfg_path, ckpt = loop_rec["_cfg"], loop_rec["_ckpt"]
    best_epoch = int(loop_rec["_best"][len("epoch_"):-len(".pt")])
    torch.cuda.empty_cache()
    _reset_launch_counts()
    t = time.time()
    res = eval_cli.main(["--config", cfg_path, "--ckpt", ckpt, "--synthetic",
                         "--flip-tta", "--shift-window-tta", "--device",
                         "cuda"])
    torch.cuda.synchronize()
    seconds = time.time() - t
    kernels = {k: sum(d.values()) for k, d in _by_kernel().items()}
    crops = [{"B_": s["B_"], "N": s["N"], "C": s["C"], "nH": s["nH"]}
             for s in stage_shapes(h=480, w=480, batch=2)]
    want = sum(s["blocks"] for s in stage_shapes()) * 2 * LOOP_VAL
    _reset_launch_counts()
    model = infer.build(load_yaml(cfg_path), device="cuda", seed=0)
    epoch, kind = io.restore_eval(ckpt, model)
    f1, f2 = make_frames(seed=3)
    t = time.time()
    out = infer.predict(model, f1, f2)
    torch.cuda.synchronize()
    request_ms = (time.time() - t) * 1e3
    rec = {"command": "python -m mmde_tpu_torch.tools.eval --ckpt <loop "
                      "ckpt/> --synthetic --flip-tta --shift-window-tta",
           "seconds": seconds, "restored": res["restored"],
           "best_epoch_file": best_epoch,
           "latest_epoch": io.latest_epoch(ckpt),
           "metrics": res["metrics"], "losses": res["losses"],
           "tta_launches": kernels, "tta_k1_launches": kernels.get(
               "window_attention_fwd_tc", 0),
           "tta_k1_expected": want, "crop_shapes": crops,
           "infer": {"restored": {"epoch": epoch, "kind": kind},
                     "request_ms": request_ms,
                     "outputs": check_outputs(out, "eval_ckpt infer"),
                     "launches": {k: sum(d.values())
                                  for k, d in _by_kernel().items()}}}
    finite = all(math.isfinite(v) for v in res["metrics"].values())
    rec["ok"] = (finite and res["restored"] == {"epoch": best_epoch,
                                                "kind": "best"}
                 and (epoch, kind) == (best_epoch, "best")
                 and kernels == {"window_attention_fwd_tc":
                                 rec["tta_k1_launches"]}
                 and rec["tta_k1_launches"] == want)
    rec["save"] = _eval_saves(cfg_path, ckpt, model)
    rec["ok"] = rec["ok"] and rec["save"]["ok"]
    del model
    emit("eval_ckpt", rec)
    if not rec["ok"]:
        raise RuntimeError(f"eval_ckpt: {json.dumps(rec)[:3000]}")
    return rec


SAVE_BATCHES = 2        # eval_ckpt: samples of its --save-pngs / --save-viz


def _eval_saves(cfg_path: str, ckpt: str, model) -> dict:
    """`tools.eval --ckpt <ckpt> --save-pngs DIR --save-viz DIR` on
    SAVE_BATCHES samples (no TTA), its files held to `model`'s eval step
    (the same restored checkpoint) on the same samples."""
    from mmde_tpu_torch.config import load_yaml
    from mmde_tpu_torch.data import codec
    from mmde_tpu_torch.data.loader import DataLoader
    from mmde_tpu_torch.tools import eval as eval_cli
    from mmde_tpu_torch.train.loop import batch_tensors, build_datasets
    from mmde_tpu_torch.train.step import TrainState, make_eval_step
    base = os.path.dirname(cfg_path)
    pngs, panels = os.path.join(base, "pngs"), os.path.join(base, "viz")
    _reset_launch_counts()
    t = time.time()
    res = eval_cli.main(["--config", cfg_path, "--ckpt", ckpt, "--synthetic",
                         "--max-batches", str(SAVE_BATCHES), "--save-pngs",
                         pngs, "--save-viz", panels, "--device", "cuda"])
    torch.cuda.synchronize()
    seconds = time.time() - t
    launches = {k: sum(d.values()) for k, d in _by_kernel().items()}
    cfg = load_yaml(cfg_path)
    step = make_eval_step(model, decoder=cfg.model.decoder,
                          lambda_rot=cfg.train.loss_lambda1,
                          lambda_trans=cfg.train.loss_lambda2, device="cuda")
    _, val = build_datasets(cfg, synthetic=True)
    counts, stds = [], []
    for n, batch in zip(range(SAVE_BATCHES), DataLoader(val, 1,
                                                        shuffle=False)):
        preds, _ = step(TrainState(model, None), batch_tensors(batch, "cuda"))
        for k in ("d1", "d2"):
            d = preds[f"pred_{k}"][0, ..., 0].float().cpu().numpy()
            got = codec.imread_unchanged(os.path.join(pngs,
                                                      f"{n:05d}_{k}.png"))
            want = (d * 1000.0).astype(np.uint16)
            counts.append(int(np.abs(got.astype(np.int64) - want).max())
                          if got.shape == want.shape else None)
            stds.append(float(got.std()))
    shapes = sorted({tuple(codec.imread_rgb(os.path.join(panels, f)).shape)
                     for f in os.listdir(panels) if f.endswith(".png")})
    poses = sorted(f for f in os.listdir(pngs) if f.endswith(".txt"))
    rec = {"command": "python -m mmde_tpu_torch.tools.eval --ckpt <loop "
                      f"ckpt/> --synthetic --max-batches {SAVE_BATCHES} "
                      "--save-pngs DIR --save-viz DIR",
           "seconds": seconds, "files_written": len(res["written"]),
           "png_max_abs_counts_vs_eval_step": counts,
           "png_std_counts": stds, "panel_shapes": [list(x) for x in shapes],
           "pose_files": poses, "launches": launches}
    rec["ok"] = bool(all(c is not None and c <= 1 for c in counts)
                     and len(counts) == 2 * SAVE_BATCHES
                     and shapes == [(4 * 480 + 12, 2 * 640, 3)]
                     and len(os.listdir(panels)) == 2 * SAVE_BATCHES
                     and len(poses) == SAVE_BATCHES
                     and len(res["written"]) == 5 * SAVE_BATCHES
                     and launches.get("window_attention_fwd_tc", 0) > 0)
    return rec


def phase_deterministic() -> dict:
    """Under torch.use_deterministic_algorithms(True, warn_only=True): the
    stage-1 attention backward of the flagship (packed, C 128, 4 heads) and
    of swin_large (head-split, C 192, 6 heads), bf16, 2 frame pairs, each
    of the stage's two blocks (unshifted; shifted, masked) through the
    autograd Function twice on the same inputs: dqkv, dlogit_scale and
    dbias bitwise equal, K3 (the tensor-core dbias pass) launched once a
    backward, the passes never asked for atomics. Then, under strict mode,
    the slab backward on flagship stage 1's map (2 pairs, C 128), bf16 and
    fp32, each block: the same three bitwise checks, K3 over MapRows once a
    backward, no atomics."""
    from mmde_tpu_torch.ops import window_attention_headsplit as ths
    from mmde_tpu_torch.ops import window_attention_packed as wap
    from mmde_tpu_torch.ops import window_attention_slab as was
    gen = torch.Generator(device="cuda")
    gen.manual_seed(5)
    atomics_seen = []
    real_wap, real_ths = wap._backward_passes, ths._backward_passes
    real_was = was._backward_passes

    def wap_spy(*a, **kw):
        atomics_seen.append(("packed", a[7]))
        return real_wap(*a, **kw)

    def ths_spy(*a, **kw):
        atomics_seen.append(("headsplit", a[8] and not a[9]))
        return real_ths(*a, **kw)

    def was_spy(*a, **kw):
        atomics_seen.append(("slab", kw["atomics"]))
        return real_was(*a, **kw)

    def grads(fn, leaves, g):
        for x in leaves:
            x.grad = None
        fn().backward(g)
        torch.cuda.synchronize()
        return [x.grad.clone() for x in leaves]

    cases = []
    was_on = torch.are_deterministic_algorithms_enabled()
    was_warn = torch.is_deterministic_algorithms_warn_only_enabled()
    wap._backward_passes, ths._backward_passes = wap_spy, ths_spy
    was._backward_passes = was_spy
    try:
        torch.use_deterministic_algorithms(True, warn_only=True)
        for backbone in ("swin_base_v2", "swin_large_v2"):
            shape = stage_shapes(backbone, batch=2)[0]
            for masked in (False, True):
                _reset_launch_counts()
                atomics_seen.clear()
                if shape["layout"] == "packed":
                    qkv, ls, bias, mask = make_kernel_inputs(
                        shape, torch.bfloat16, masked, gen)
                    g = torch.randn(qkv.shape[:2] + (shape["C"],),
                                    device="cuda", generator=gen
                                    ).to(torch.bfloat16)
                    leaves = [qkv.requires_grad_(), ls.requires_grad_(),
                              bias.requires_grad_()]

                    def fn():
                        return wap.cosine_window_attention_packed(
                            qkv, ls, bias, mask, num_heads=shape["nH"])
                    k3 = "window_attention_dbias_tc"
                else:
                    qkv, ls, bias, mask, g = make_headsplit_inputs(
                        shape, torch.bfloat16, masked, gen)
                    leaves = [qkv.requires_grad_(), ls.requires_grad_(),
                              bias.requires_grad_()]

                    def fn():
                        q, k, v = _views(qkv, shape["nH"])
                        return ths.cosine_window_attention_headsplit(
                            q, k, v, ls, bias, mask)
                    k3 = "window_attention_headsplit_dbias_tc"
                first = grads(fn, leaves, g)
                again = grads(fn, leaves, g)
                same = {n: bool(torch.equal(a, b)) for n, a, b in
                        zip(("dqkv", "dlogit_scale", "dbias"), first, again)}
                counts = {k: sum(d.values())
                          for k, d in _by_kernel().items()}
                cases.append({
                    "model": backbone, "stage": 1, "layout": shape["layout"],
                    "B_": shape["B_"], "N": shape["N"], "C": shape["C"],
                    "nH": shape["nH"], "masked": masked, "bitwise": same,
                    "k3_launches": counts.get(k3, 0),
                    "atomics_asked": sum(bool(a) for _, a in atomics_seen),
                    "launches": counts})
        # the slab path (flagship stage 1's map), strict mode, both types:
        # K3 over MapRows after atomics-free passes
        torch.use_deterministic_algorithms(True)
        shape = stage_shapes(attn_impl="cuda_slab", batch=2)[0]
        for dtype in (torch.bfloat16, torch.float32):
            for masked in (False, True):
                _reset_launch_counts()
                atomics_seen.clear()
                qkv, ls, bias, mask, g = make_slab_inputs(
                    dict(shape, nW=shape["nW"] if masked else 0), dtype, gen)
                leaves = [qkv.requires_grad_(), ls.requires_grad_(),
                          bias.requires_grad_()]

                def fn():
                    return was.cosine_window_attention_slab(
                        qkv, ls, bias, mask, num_heads=shape["nH"],
                        window_size=shape["ws"])
                first = grads(fn, leaves, g)
                again = grads(fn, leaves, g)
                same = {n: bool(torch.equal(a, b)) for n, a, b in
                        zip(("dqkv", "dlogit_scale", "dbias"), first, again)}
                counts = {k: sum(d.values())
                          for k, d in _by_kernel().items()}
                cases.append({
                    "model": "swin_base_v2", "stage": 1, "layout": "slab",
                    "map": list(qkv.shape), "B_": shape["B_"],
                    "N": shape["N"], "C": shape["C"], "nH": shape["nH"],
                    "masked": masked,
                    "dtype": str(dtype).replace("torch.", ""),
                    "bitwise": same,
                    "k3_launches": counts.get(
                        "window_attention_slab_dbias_tc", 0),
                    "atomics_asked": sum(bool(a) for _, a in atomics_seen),
                    "launches": counts})
    finally:
        (wap._backward_passes, ths._backward_passes,
         was._backward_passes) = real_wap, real_ths, real_was
        torch.use_deterministic_algorithms(was_on, warn_only=was_warn)
    rec = {"flags": "torch.use_deterministic_algorithms(True, "
                    "warn_only=True); the slab cases strict",
           "cases": cases}
    rec["ok"] = (len(cases) == 8 and all(
        all(c["bitwise"].values()) and c["k3_launches"] == 2
        and c["atomics_asked"] == 0 for c in cases))
    emit("deterministic", rec)
    if not rec["ok"]:
        raise RuntimeError(f"deterministic: {json.dumps(rec)[:3000]}")
    return rec


# ---------------------------------------------------------------------------
# The other encoders and model families: configs/void.yaml's model
# (cnn_transformer_multi_scale, resnet50 trunk), configs/
# void_downscale16_completion.yaml's (glpdepth_scale16 over swin_base_v2
# stages 1-3, sparse depth fused into the input) and the single-frame
# GLPDepth, each at full width on the card.
# ---------------------------------------------------------------------------

ROOT = os.path.dirname(os.path.abspath(__file__))
# void_downscale16_completion's attention: stages 1-3 of swin_base_v2 at
# 480x480 (maps 120 / 60 / 30, one window row at stage 3), 4 frame pairs
COMPLETION_PAIRS = 4
COMPLETION_PARAMS = (
    "net.encoder.patch_embed.proj.weight",
    "net.encoder.layers.0.blocks.1.attn.qkv.weight",
    "net.encoder.layers.0.blocks.0.attn.logit_scale",
    "net.encoder.layers.1.blocks.1.attn.rpe_mlp.0.weight",
    "net.encoder.layers.2.blocks.17.attn.logit_scale",
    "net.depth_stack.conv.weight",
    "net.pos1a.weight")


def _yaml_config(name: str, **model):
    """configs/<name> through the port's loader, model fields replaced."""
    from mmde_tpu_torch.config import load_yaml
    cfg = load_yaml(os.path.join(ROOT, "configs", name))
    return dataclasses.replace(cfg, model=dataclasses.replace(cfg.model,
                                                              **model))


def _glpdepth_cfg(dtype: str = "float32"):
    """The single-frame GLPDepth over the flagship's swin_base_v2 (depths
    2/2/18/2, windows 30/30/30/15, shift on stages 1-2); no config file of
    the repo names this family."""
    from mmde_tpu_torch.config import Config, TrainConfig
    m = dataclasses.replace(flagship_cfg(dtype), family="glpdepth")
    return Config(model=m, train=TrainConfig(batch_size=2))


def _model_shapes(h: int, w: int, images: int, stages: int) -> list:
    """stage_shapes of the flagship's widths for `images` images at h x w,
    the first `stages` stages (each shape's B_ for that many images)."""
    out = []
    for s in stage_shapes(h=h, w=w, batch=1)[:stages]:
        out.append(dict(s, B_=s["B_"] // 2 * images, images=images,
                        frame_pairs=images / 2))
    return out


def _packed_kernels(shapes: list, times: int, train: bool) -> dict:
    """expected_kernels' count for the packed stages of `shapes` (W = 1)."""
    want: dict = {}
    for sh in shapes:
        key = (sh["B_"], sh["N"], sh["C"], sh["nH"])
        names = (["window_attention_fwd_tc+lse", "window_attention_bwd_tc"]
                 if train else ["window_attention_fwd_tc"])
        for n in names:
            want.setdefault(n, {})[key] = sh["blocks"] * times
    return want


def _sparse(depth: np.ndarray, rng) -> np.ndarray:
    """VIO-style sparse depth: ~5 % of the valid pixels kept."""
    return np.where((depth > 0) & (rng.random(depth.shape) < 0.05), depth,
                    0.0).astype(np.float32)


def _model_batch(pairs: int, h: int, w: int, seed: int, sparse: bool,
                 device: str = "cuda") -> dict:
    """train_steps.synthetic_batch, with sparse_depth1 / 2 when `sparse`."""
    from mmde_tpu_torch.tools import train_steps as ts
    batch = ts.synthetic_batch(pairs, h, w, seed=seed, device="cpu")
    if sparse:
        rng = np.random.default_rng(seed + 1)
        for k in (1, 2):
            batch[f"sparse_depth{k}"] = torch.from_numpy(
                _sparse(batch[f"depth{k}"].numpy(), rng))
    return {k: v.to(device) for k, v in batch.items()}


def phase_kernels_models(timed: bool = True) -> dict:
    """The attention kernels at the shapes only the new model paths give
    them, float32 (the configs' type): K1 served at the single-frame
    GLPDepth's shapes (one 480x640 image: B_ 24 / 6 / 2 / 2, stages 1-2
    masked) against its plain version; K1+lse and K2 at
    void_downscale16_completion's (4 pairs at 480x480, stages 1-3: B_ 128 /
    32 / 8, stages 1-2 masked) against the plain forward / backward and
    float64 autograd (compare_backward, K3 included). The GLPDepth train
    step's shapes (4 images) are the flagship's 2-pair shapes of
    kernel_cases_backward."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(4242)
    served = [compare_kernel(sh, torch.float32, sh["nW"] > 0, gen,
                             timed=timed)
              for sh in _model_shapes(480, 640, 1, 4)]
    trained = [compare_backward(sh, torch.float32, gen, timed=timed)
               for sh in _model_shapes(480, 480, 2 * COMPLETION_PAIRS, 3)]
    for c, sh in zip(served, _model_shapes(480, 640, 1, 4)):
        c.update(path="glpdepth served", images=1)
    for c in trained:
        c.update(path="void_downscale16_completion trained",
                 frame_pairs=COMPLETION_PAIRS)
    rec = {"served": served, "trained": trained}
    emit("kernel_cases_models", rec)
    return rec


def _timed_requests(fn, requests: int) -> tuple:
    """(host ms, CUDA-event ms, last output) of `requests` calls of fn()."""
    ms, dev_ms, out = [], [], None
    for _ in range(requests):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        t = time.time()
        e0.record()
        out = fn()
        e1.record()
        torch.cuda.synchronize()
        ms.append((time.time() - t) * 1e3)
        dev_ms.append(e0.elapsed_time(e1))
    return ms, dev_ms, out


def _finite_outputs(out: dict, shapes: dict, what: str) -> dict:
    for k, shp in shapes.items():
        a = out[k]
        if shp is None:
            if a is not None:
                raise RuntimeError(f"{what}: {k} should be None")
            continue
        if tuple(a.shape) != shp or not np.isfinite(a).all():
            raise RuntimeError(f"{what}: {k} shape {np.shape(a)} (want "
                               f"{shp}) or not finite")
    d = out["pred_d1" if "pred_d1" in shapes else "pred_d"]
    if not (d.min() >= 0.0 and d.max() <= 10.0 and d.std() > 0.1):
        raise RuntimeError(f"{what}: depth outside [0, 10] or near-constant "
                           f"(std {d.std()})")
    return {k: None if v is None else list(v) for k, v in shapes.items()}


def condition_cnn(model, seed: int = 12) -> None:
    """Weights from `randomize_weights` under which a deep ResNet trunk is
    a well-conditioned function, for a card-vs-CPU comparison: each
    residual block's last BatchNorm scale x 0.2 (torchvision's
    zero_init_residual idea, not zero) and every BatchNorm's running
    statistics calibrated on one eval-mode forward of a 480x480 pair from
    `seed` (cumulative average, then momentum 0.1 again). Drawn running
    statistics do not normalise: the trunk's output reached std 1372 at
    void.yaml's width and the encoder's attention softmax saturated
    (`phase_serve_cnn` records the card-vs-CPU gap and the CPU's own
    witnesses under both sets of weights)."""
    from mmde_tpu_torch.nn.resnet import BasicBlock, Bottleneck
    from mmde_tpu_torch.train.step import _image
    dev = next(model.parameters()).device
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, Bottleneck):
                m.bn3.weight.mul_(0.2)
            elif isinstance(m, BasicBlock):
                m.bn2.weight.mul_(0.2)
    bns = [m for m in model.modules()
           if isinstance(m, torch.nn.BatchNorm2d)]
    model.eval()
    for m in bns:
        m.reset_running_stats()
        m.momentum = None
        m.train()
    g1, g2 = make_frames(seed=seed, h=480, w=480)
    with torch.no_grad():
        model(_image(torch.from_numpy(g1).to(dev)),
              _image(torch.from_numpy(g2).to(dev)))
    for m in bns:
        m.momentum = 0.1
        m.eval()


def _card_vs_cpu(model, cpu, f1, f2) -> dict:
    """Max |card - CPU| of depth and pose on the card model's weights,
    TF32 off, with cuDNN on (the served path: the gate) and off; beside
    them two witnesses of the function's own conditioning on the CPU alone:
    its change under a 1e-6 relative change of frame 1, and with mkldnn
    off (other convolution algorithms, the same arithmetic)."""
    from mmde_tpu_torch.tools import infer
    keys = ("pred_d1", "pred_d2", "pred_r12", "pred_t12")
    cpu.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()})
    t = time.time()
    host = infer.predict(cpu, f1, f2)
    res = {"cpu_request_s": time.time() - t}

    def gap(out):
        return {k: float(np.abs(out[k] - host[k]).max()) for k in keys}

    flags = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.enabled)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        for on in (False, True):
            torch.backends.cudnn.enabled = on
            card = infer.predict(model, f1, f2)
            res["cudnn_on" if on else "cudnn_off"] = gap(card)
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.enabled) = flags
    res["pose_max_rel"] = {
        k: float(np.abs(card[k] - host[k]).max()
                 / max(np.abs(host[k]).max(), 1e-30))
        for k in ("pred_r12", "pred_t12")}
    res["pose_close"] = all(np.allclose(card[k], host[k], rtol=1e-4,
                                        atol=1e-4)
                            for k in ("pred_r12", "pred_t12"))
    rng = np.random.default_rng(0)
    x1 = f1.astype(np.float32) / 255.0
    res["cpu_under_1e-6_input"] = gap(infer.predict(
        cpu, x1 * (1 + 1e-6 * rng.standard_normal(x1.shape)).astype(
            np.float32), f2.astype(np.float32) / 255.0))
    old = torch.backends.mkldnn.enabled
    torch.backends.mkldnn.enabled = False
    try:
        res["cpu_mkldnn_off"] = gap(infer.predict(cpu, f1, f2))
    finally:
        torch.backends.mkldnn.enabled = old
    return res


def phase_serve_cnn(requests: int = 3) -> dict:
    """configs/void.yaml's model at full width (cnn_transformer_multi_scale:
    resnet50 trunk, hidden 512, 8 heads, feed-forward 4096, 6 encoder
    layers; decoder_v1, scale 16; float32), weights from seed 7
    (`condition_cnn`), serving one 480x480 uint8 pair a request through
    tools.infer.predict: request ms (host clock and CUDA events), peak
    bytes. The path launches no window-attention kernel (its attention is
    the global one, plain PyTorch products, as XLA's in the JAX package).
    Then the card's fp32 forward, TF32 off and cuDNN on as served, against
    the same weights on the CPU: depth atol 1e-3, pose rtol / atol 1e-4
    (`_card_vs_cpu`, which also records cuDNN off and the CPU's own
    witnesses); the same record for the drawn weights before
    `condition_cnn`, ungated."""
    from mmde_tpu_torch.tools import infer
    cfg = _yaml_config("void.yaml")
    t0 = time.time()
    model = infer.build(cfg, device="cuda", seed=0)
    randomize_weights(model, seed=7)
    build_s = time.time() - t0
    f1, f2 = make_frames(seed=11, h=480, w=480)
    cpu = infer.build(cfg, device="cpu", seed=0)
    drawn = _card_vs_cpu(model, cpu, f1, f2)
    condition_cnn(model)
    infer.predict(model, f1, f2)                          # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_launch_counts()
    ms, dev_ms, out = _timed_requests(
        lambda: infer.predict(model, f1, f2), requests)
    launches = {k: sum(d.values()) for k, d in _by_kernel().items()}
    shapes = {"pred_d1": (1, 480, 480, 1), "pred_d2": (1, 480, 480, 1),
              "pred_r12": (1, 9), "pred_t12": (1, 3), "pred_r21": None,
              "pred_t21": None}
    rec = {"model": "configs/void.yaml: cnn_transformer_multi_scale "
                    "(resnet50, hidden 512, 8 heads, ff 4096, 6 layers) + "
                    "decoder_v1, scale 16, float32",
           "params": sum(p.numel() for p in model.parameters()),
           "build_seconds": round(build_s, 2),
           "input": "2 x uint8 (1, 480, 480, 3)", "request_ms": ms,
           "request_ms_cuda_events": dev_ms,
           "outputs": _finite_outputs(out, shapes, "serve_cnn"),
           "depth_std": float(out["pred_d1"].std()),
           "launches": launches,
           "peak_memory_bytes": torch.cuda.max_memory_allocated()}
    check = _card_vs_cpu(model, cpu, f1, f2)
    rec["card_vs_cpu"] = dict(check, tolerance={"depth_atol": 1e-3,
                                                "pose_rtol_atol": 1e-4},
                              tf32=False, gate="cudnn_on")
    rec["card_vs_cpu_drawn_weights"] = drawn
    on = check["cudnn_on"]
    ok = (on["pred_d1"] <= 1e-3 and on["pred_d2"] <= 1e-3
          and check["pose_close"] and not launches)
    rec["ok"] = bool(ok)
    del model, cpu
    torch.cuda.empty_cache()
    emit("serve_cnn", rec)
    if not rec["ok"]:
        raise RuntimeError(f"serve_cnn: {json.dumps(rec)[:3000]}")
    return rec


def _train_steps(state, step, batch, steps: int, tag: str) -> dict:
    """`steps` steps on one batch: host ms, losses (finite), peak bytes,
    launches by kernel, parameters moved."""
    watch = {n: p.detach().clone()
             for n, p in list(state.model.named_parameters())[::25]}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_launch_counts()
    ms, losses = [], []
    for i in range(steps):
        torch.cuda.synchronize()
        t = time.time()
        state, aux = step(state, batch)
        torch.cuda.synchronize()
        ms.append((time.time() - t) * 1e3)
        aux = {k: float(v) for k, v in aux.items()}
        if not all(math.isfinite(v) for v in aux.values()):
            raise RuntimeError(f"{tag} step {i}: loss not finite: {aux}")
        losses.append(aux)
    moved = sum(bool((p.detach() - watch[n]).abs().max() > 0)
                for n, p in state.model.named_parameters() if n in watch)
    if moved == 0:
        raise RuntimeError(f"{tag}: no watched parameter changed")
    steady = ms[1:] or ms
    return {"steps": steps, "losses": losses, "first_step_ms": ms[0],
            "step_ms": steady, "step_ms_median": statistics.median(steady),
            "peak_memory_bytes": torch.cuda.max_memory_allocated(),
            "params_watched_moved": f"{moved}/{len(watch)}",
            "_by_kernel": _by_kernel(), "_state": state}


def phase_train_cnn(steps: int = 4) -> dict:
    """configs/void.yaml's trainer at full width: BATCH_SIZE 4 pairs of
    480x480 synthetic frames, float32, train mode (BatchNorm batch
    statistics), weights from seed 7; step ms, images/s (an image is one
    frame), peak bytes; no window-attention launch."""
    from mmde_tpu_torch.tools import train_steps as ts
    cfg = _yaml_config("void.yaml")
    pairs = cfg.train.batch_size
    state, step = ts.build_trainer(cfg, device="cuda", seed=0)
    randomize_weights(state.model, seed=7)
    batch = _model_batch(pairs, 480, 480, seed=31, sparse=False)
    r = _train_steps(state, step, batch, steps, "train_cnn")
    launches = {k: sum(d.values()) for k, d in r.pop("_by_kernel").items()}
    r.pop("_state")
    rec = {"model": "configs/void.yaml (cnn_transformer_multi_scale, "
                    "resnet50) + decoder_v1, float32, train mode",
           "frame_pairs": pairs, "input": "480x480",
           "images_per_s": 2 * pairs / (r["step_ms_median"] / 1e3),
           "launches": launches, **r}
    rec["ok"] = not launches
    del state, step
    torch.cuda.empty_cache()
    emit("train_cnn", rec)
    if not rec["ok"]:
        raise RuntimeError(f"train_cnn: {json.dumps(rec)[:3000]}")
    return rec


def _completion_config(tmp: str) -> str:
    """configs/void_downscale16_completion.yaml on the synthetic data
    (sparse depth in the batches), one epoch, a checkpoint and validation,
    written to `tmp`."""
    import yaml
    with open(os.path.join(ROOT, "configs",
                           "void_downscale16_completion.yaml")) as f:
        y = yaml.safe_load(f)
    y.update(DATASET_NAME="synthetic", EPOCH=1, VALIDATION_FREQUENCY=1,
             SAVE_FREQUENCY=1, SAVE_MODEL=True, PRINT_FREQUENCY=1,
             WORKERS=2, RESUME_FROM="")
    path = os.path.join(tmp, "completion.yaml")
    with open(path, "w") as f:
        yaml.safe_dump(y, f)
    return path


def phase_train_completion(steps: int = 3, loop_steps: int = 3) -> dict:
    """configs/void_downscale16_completion.yaml's model at full width
    (glpdepth_scale16: swin_base_v2 stages 1-3, embed 128, windows 30, 5
    input channels - the frame, sparse / max_depth, sparse > 0 -, float32)
    on 4 pairs of 480x480 synthetic frames with sparse depth: `steps` train
    steps (step ms, images/s, peak bytes; every attention launch K1+lse /
    K2 on the tensor cores, 22 a step each at B_ 128 / 32 / 8); one
    deterministic step on the kernel path against the plain path from the
    same weights, cuDNN TF32 off (TOL_TRAIN_PARITY on the loss and
    COMPLETION_PARAMS' gradients); then `python -m
    mmde_tpu_torch.tools.train --synthetic --max-steps 3` of the config
    (one epoch, 8 held-out pairs, a checkpoint) and `python -m
    mmde_tpu_torch.tools.eval --flip-tta` of its checkpoint (sparse depth
    mirrored with the frames: 2 passes x 22 K1 launches a pair)."""
    from mmde_tpu_torch.tools import eval as eval_cli
    from mmde_tpu_torch.tools import train as train_cli
    from mmde_tpu_torch.tools import train_steps as ts
    cfg = _yaml_config("void_downscale16_completion.yaml")
    pairs = cfg.train.batch_size
    shapes = _model_shapes(480, 480, 2 * pairs, 3)
    state, step = ts.build_trainer(cfg, device="cuda", seed=0)
    randomize_weights(state.model, seed=7)
    batch = _model_batch(pairs, 480, 480, seed=41, sparse=True)
    r = _train_steps(state, step, batch, steps, "train_completion")
    by_kernel = r.pop("_by_kernel")
    r.pop("_state")
    want = _packed_kernels(shapes, steps, True)
    rec = {"model": "configs/void_downscale16_completion.yaml: "
                    "glpdepth_scale16, swin_base_v2 stages 1-3 (depths "
                    "2/2/18, windows 30), sparse depth fused (5 input "
                    "channels), float32, train mode",
           "frame_pairs": pairs, "input": "480x480 + sparse depth (~5 %)",
           "params": sum(p.numel() for p in state.model.parameters()),
           "images_per_s": 2 * pairs / (r["step_ms_median"] / 1e3),
           "launches_by_kernel": _str_keys(by_kernel),
           "launches_expected": _str_keys(want), **r}
    if by_kernel != want:
        raise RuntimeError(f"train_completion: launches {by_kernel}, "
                           f"expected {want}")
    del state, step
    torch.cuda.empty_cache()
    # one deterministic step, kernel path against plain path
    state, step = ts.build_trainer(cfg, device="cuda", seed=0,
                                   deterministic=True)
    randomize_weights(state.model, seed=7)
    init = {n: t.detach().clone() for n, t in state.model.state_dict().items()}
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    res = {}
    try:
        for path in ("cuda", "torch"):
            with torch.no_grad():
                state.model.load_state_dict(init)
            _set_attn_impl(state.model, path)
            _reset_launch_counts()
            state, aux = step(state, batch)
            torch.cuda.synchronize()
            res[path] = (float(aux["loss_total"]),
                         {n: p.grad.detach().double().clone()
                          for n, p in state.model.named_parameters()
                          if n in COMPLETION_PARAMS},
                         {k: sum(d.values())
                          for k, d in _by_kernel().items()})
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    (la, ga, kl), (lb, gb, pl) = res["cuda"], res["torch"]
    if set(ga) != set(COMPLETION_PARAMS):
        raise RuntimeError(f"train_completion: parity parameters missing "
                           f"{set(COMPLETION_PARAMS) - set(ga)}")
    grad_rel = {n: float((ga[n] - gb[n]).norm() / gb[n].norm()) for n in ga}
    rec["parity"] = {"loss_cuda": la, "loss_torch": lb,
                     "loss_rel_diff": abs(la - lb) / abs(lb),
                     "grad_rel_l2": grad_rel, "launches_cuda": kl,
                     "launches_torch": pl, "tolerance": TOL_TRAIN_PARITY,
                     "cudnn_allow_tf32": False}
    parity_ok = (rec["parity"]["loss_rel_diff"] <= TOL_TRAIN_PARITY["loss_rel"]
                 and all(v <= TOL_TRAIN_PARITY["grad_rel_l2"]
                         for v in grad_rel.values())
                 and all(float(g.norm()) > 0 for g in gb.values())
                 and kl and all("_tc" in k for k in kl) and not pl)
    del state, step, init, res, ga, gb
    torch.cuda.empty_cache()
    # the loop and the eval CLI on the config
    tmp = tempfile.mkdtemp(prefix="mmde_smoke_completion_")
    try:
        path = _completion_config(tmp)
        log_dir = os.path.join(tmp, "run")
        _reset_launch_counts()
        t = time.time()
        final = train_cli.main(["--config", path, "--synthetic",
                                "--max-steps", str(loop_steps), "--log-dir",
                                log_dir, "--device", "cuda"])
        loop_s = time.time() - t
        loop_launches = {k: sum(d.values()) for k, d in _by_kernel().items()}
        torch.cuda.empty_cache()
        _reset_launch_counts()
        t = time.time()
        ev = eval_cli.main(["--config", path, "--ckpt",
                            os.path.join(log_dir, "ckpt"), "--synthetic",
                            "--flip-tta", "--device", "cuda"])
        eval_s = time.time() - t
        eval_launches = {k: sum(d.values()) for k, d in _by_kernel().items()}
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    blocks = sum(sh["blocks"] for sh in shapes)
    rec["loop"] = {"command": "python -m mmde_tpu_torch.tools.train "
                              "--synthetic --max-steps 3 (1 epoch)",
                   "seconds": loop_s, "final": final,
                   "launches": loop_launches}
    rec["eval"] = {"command": "python -m mmde_tpu_torch.tools.eval --ckpt "
                              "<run>/ckpt --synthetic --flip-tta",
                   "seconds": eval_s, "restored": ev["restored"],
                   "metrics": ev["metrics"], "losses": ev["losses"],
                   "launches": eval_launches,
                   "k1_expected": 8 * 2 * blocks}
    loop_ok = (loop_launches.get("window_attention_bwd_tc") == blocks
               * loop_steps and all(math.isfinite(v)
                                    for v in (final or {}).values()))
    eval_ok = (ev["restored"] is not None
               and eval_launches == {"window_attention_fwd_tc":
                                     8 * 2 * blocks}
               and all(math.isfinite(v) for v in ev["metrics"].values()))
    rec["ok"] = bool(parity_ok and loop_ok and eval_ok)
    rec["_shapes"] = shapes
    rec["_by_kernel"] = by_kernel
    emit("train_completion", {k: v for k, v in rec.items()
                              if not k.startswith("_")})
    if not rec["ok"]:
        raise RuntimeError(f"train_completion: parity {parity_ok}, loop "
                           f"{loop_ok}, eval {eval_ok}: "
                           f"{json.dumps(rec, default=str)[:3000]}")
    return rec


def phase_serve_glpdepth(requests: int = 3, steps: int = 2) -> dict:
    """The single-frame GLPDepth over the flagship's swin_base_v2 (float32,
    full depth), weights from seed 7: `requests` requests of one 480x640
    uint8 frame through tools.infer.predict (pred_d; 24 K1 launches each at
    B_ 24 / 6 / 2 / 2) and a flip-averaged one; then `steps` steps of
    train.single_frame.make_single_train_step on 4 frames (SiLog; K1+lse /
    K2 at the flagship's 2-pair shapes, B_ 96 / 24 / 8 / 8)."""
    from mmde_tpu_torch.tools import infer
    from mmde_tpu_torch.train.optim import build_optimizer
    from mmde_tpu_torch.train.single_frame import make_single_train_step
    from mmde_tpu_torch.train.step import TrainState
    cfg = _glpdepth_cfg()
    model = infer.build(cfg, device="cuda", seed=0)
    randomize_weights(model, seed=7)
    f1, _ = make_frames(seed=13)
    infer.predict(model, f1)                              # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_launch_counts()
    ms, dev_ms, out = _timed_requests(lambda: infer.predict(model, f1),
                                      requests)
    served = _by_kernel()
    shapes = _model_shapes(480, 640, 1, 4)
    want = _packed_kernels(shapes, requests, False)
    rec = {"model": "glpdepth (single frame): swin_base_v2, depths "
                    "2/2/18/2, windows 30/30/30/15, float32",
           "params": sum(p.numel() for p in model.parameters()),
           "input": "uint8 (1, 480, 640, 3)", "request_ms": ms,
           "request_ms_cuda_events": dev_ms,
           "outputs": _finite_outputs(out, {"pred_d": (1, 480, 640, 1)},
                                      "serve_glpdepth"),
           "depth_std": float(out["pred_d"].std()),
           "peak_memory_bytes": torch.cuda.max_memory_allocated(),
           "launches_by_kernel": _str_keys(served),
           "launches_expected": _str_keys(want)}
    t = time.time()
    flip = infer.predict(model, f1, flip_tta=True)
    torch.cuda.synchronize()
    rec["flip_request_ms"] = (time.time() - t) * 1e3
    _finite_outputs(flip, {"pred_d": (1, 480, 640, 1)}, "glpdepth flip")
    # the single-frame train step: SiLog, 2 frames
    model.train()
    optimizer, _ = build_optimizer(
        model, backbone=cfg.model.backbone, depths=cfg.model.swin.depths,
        max_lr=cfg.train.max_lr, min_lr=cfg.train.min_lr,
        weight_decay=cfg.train.weight_decay,
        layer_decay=cfg.train.layer_decay, steps_per_epoch=100,
        epochs=cfg.train.epochs, device="cuda")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    state = TrainState.create(model, optimizer, gen)
    step = make_single_train_step(model, optimizer, device="cuda")
    b = _model_batch(2, 480, 640, seed=43, sparse=False)
    batch = {"image": torch.cat([b["image1"], b["image2"]]),
             "depth": torch.cat([b["depth1"], b["depth2"]])}
    r = _train_steps(state, step, batch, steps, "serve_glpdepth train")
    trained = r.pop("_by_kernel")
    r.pop("_state")
    want_t = _packed_kernels(_model_shapes(480, 640, 4, 4), steps, True)
    rec["train"] = {"step": "train.single_frame.make_single_train_step, "
                            "4 frames 480x640, SiLog",
                    "images_per_s": 4 / (r["step_ms_median"] / 1e3),
                    "launches_by_kernel": _str_keys(trained),
                    "launches_expected": _str_keys(want_t), **r}
    rec["ok"] = served == want and trained == want_t
    rec["_served"], rec["_trained"] = served, trained
    del model, optimizer, state, step
    torch.cuda.empty_cache()
    emit("serve_glpdepth", {k: v for k, v in rec.items()
                            if not k.startswith("_")})
    if not rec["ok"]:
        raise RuntimeError(f"serve_glpdepth: {json.dumps(rec)[:3000]}")
    return rec


def contract_models(model_cases: dict, k2_cases: list, completion: dict,
                    glpdepth: dict) -> list:
    """The new paths' kernels, float32: K1 served at the single-frame
    GLPDepth's shapes (launches from serve_glpdepth), K1+lse / K2 at its
    train step's (the flagship's 2-pair shapes, kernel_cases_backward's
    fp32 cases) and at void_downscale16_completion's (kernel_cases_models'
    cases; launches from train_completion's timed steps)."""
    entries = []
    for c, sh in zip(model_cases["served"], _model_shapes(480, 640, 1, 4)):
        key = (sh["B_"], sh["N"], sh["C"], sh["nH"])
        e = _entry("window_attention_fwd_tc", sh, KERNEL_TC_SOURCE,
                   KERNEL_REPLACES, glpdepth["_served"].get(
                       "window_attention_fwd_tc", {}).get(key, 0), c,
                   dtype="fp32")
        e.update(dtype="float32", path="glpdepth served (1 image)")
        entries.append(e)
    for path, by_kernel, cases in (
            ("glpdepth single-frame train step (4 images)",
             glpdepth["_trained"],
             [_find(k2_cases, sh, 2, "float32")
              for sh in _model_shapes(480, 640, 4, 4)]),
            ("void_downscale16_completion train step (4 pairs)",
             completion["_by_kernel"], model_cases["trained"])):
        for c in cases:
            sh = dict(c, layout="packed")
            key = (c["B_"], c["N"], c["C"], c["nH"])
            for name, src, rep, r in (
                    ("window_attention_fwd_tc+lse", KERNEL_TC_SOURCE,
                     KERNEL_REPLACES, c["forward"]),
                    ("window_attention_bwd_tc", KERNEL_TC_BWD_SOURCE,
                     KERNEL_BWD_REPLACES, c)):
                e = _entry(name, sh, src, rep,
                           by_kernel.get(name, {}).get(key, 0), r, 2,
                           dtype="fp32")
                e.update(dtype="float32", path=path)
                entries.append(e)
    return entries


def phase_models() -> tuple:
    """serve_cnn, train_cnn, train_completion, serve_glpdepth; returns
    (train_completion's record, serve_glpdepth's)."""
    phase_serve_cnn()
    phase_train_cnn()
    completion = phase_train_completion()
    glpdepth = phase_serve_glpdepth()
    torch.cuda.empty_cache()
    return completion, glpdepth


def phase_loop_entries() -> dict:
    """loop, eval_ckpt (in a temporary directory, removed in `finally`)
    and deterministic; returns loop's record."""
    tmp = tempfile.mkdtemp(prefix="mmde_smoke_loop_")
    try:
        rec = phase_loop(tmp)
        phase_eval_ckpt(rec)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    torch.cuda.empty_cache()
    phase_deterministic()
    return rec


# ------------------------------------------------------------------------
# The data path (ROADMAP M5): VOID, KITTI and NYU trees written by
# mmde_tpu_torch.testing into one temporary data root, read by the port's
# readers (its own PNG / JPEG codec and undistortion, no cv2 and no PIL)
# and trained on through tools.train.
# ------------------------------------------------------------------------

# a VOID release at VOID's size, IMU at 200 Hz, the test scene's IMU in
# raw.bag only; 5 train scenes of 43 pairs: 53 steps of void.yaml's 4 pairs
# in one epoch, long enough for the loader's steady state (train_void)
DATA_VOID = dict(scenes=6, frames=48, height=480, width=640, imu_hz=200.0,
                 bag_scenes=(5,), test_scenes=1)
WARMUP_STEPS = 10       # train_void: steps left out of the steady state
VOID_INTERVAL = 5                   # configs/void.yaml IMAGE_INTERVAL_RANGE
JPEG_DIR = os.path.join(ROOT, "tests", "fixtures", "jpeg")
# the CPU tests' limits on the JPEG decode against cv2, by sampling mode
JPEG_LIMITS = {"444": 2, "grey": 2, "420": 3, "422": 3, "440": 3}
VOID_KEYS = {"filename", "foldername", "timestamp1", "timestamp2",
             "image1_raw", "image2_raw", "depth1_raw", "depth2_raw",
             "image1", "image2", "depth1", "depth2", "T12", "R12", "w12",
             "AxisAngle12", "T21", "R21", "w21", "AxisAngle21",
             "imu_timestamp", "imu_data", "imu_len"}
_HOST_BUILD: list = []      # the host library's background build (env)


def _build_host_library() -> float:
    """Build (or load) csrc/preprocess.cpp's library; seconds taken."""
    from mmde_tpu_torch.data import native
    t = time.time()
    native.load()
    return time.time() - t


def host_info() -> dict:
    """The card's name and power limit beside the host's CPUs: every time
    of the data phases depends on both."""
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    return {"nvidia_smi": smi, "cpu_count": os.cpu_count(),
            "cpus_usable": len(os.sched_getaffinity(0))}


def _jpeg_frames() -> list:
    """The committed 480 x 640 JPEG frames (4:2:0, quality 90)."""
    return sorted(os.path.join(JPEG_DIR, f) for f in os.listdir(JPEG_DIR)
                  if f.startswith("frame") and f.endswith(".jpg"))


def _frame_err(path: str, got: np.ndarray):
    """Max abs difference of a decode of a committed frame from cv2's
    decode of it at every 13th row and column (frames_cv2_stride13.npz,
    written beside the frames by make_jpeg_fixtures.py); None where the
    shape is not the frame's."""
    want = np.load(os.path.join(JPEG_DIR, "frames_cv2_stride13.npz"))[
        os.path.basename(path).split("_")[0]]
    if got.shape != (480, 640, 3):
        return None
    return int(np.abs(got[::13, ::13].astype(np.int64) - want).max())


def _median_ms(fn, n: int = 5) -> float:
    times = []
    for _ in range(n):
        t = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t) * 1e3)
    return statistics.median(times)


def phase_codec() -> dict:
    """The port's codec and undistortion on the card's host: the committed
    JPEGs (tests/fixtures/jpeg) against cv2's decodes saved beside them at
    the CPU tests' limits; PNG write then read, bitwise, for grey, RGB and
    RGBA at 8 and 16 bits under every row filter; the undistortion maps of
    VOID's camera at 640 x 480 against the closed form evaluated here in
    float64, and every output pixel inside the source image (alpha 0, to
    0.05 px);
    decode / encode ms of VOID-sized files."""
    from mmde_tpu_torch import testing
    from mmde_tpu_torch.data import codec, imgproc, native
    build_s = _HOST_BUILD.pop().result() if _HOST_BUILD else None
    lib = native.load()
    jpeg = {}
    for npy in sorted(os.listdir(JPEG_DIR)):
        if not npy.endswith(".npy"):
            continue
        name = npy[:-4]
        want = np.load(os.path.join(JPEG_DIR, npy))
        path = os.path.join(JPEG_DIR, name + ".jpg")
        if want.ndim == 2:
            got, mode = native.jpeg_decode(np.fromfile(path, np.uint8)), \
                "grey"
        else:
            got, mode = codec.imread_rgb(path), name.split("_")[0]
        err = (int(np.abs(got.astype(np.int64) - want).max())
               if got.shape == want.shape else None)
        jpeg[name] = {"shape": list(got.shape), "max_abs_err": err,
                      "limit": JPEG_LIMITS[mode]}
    frames = _jpeg_frames()
    big = [codec.imread_rgb(f) for f in frames]
    frame_err = {os.path.basename(f): _frame_err(f, b)
                 for f, b in zip(frames, big)}
    rng = np.random.default_rng(0)
    arrays = {"grey8": rng.integers(0, 256, (61, 83), np.uint8),
              "rgb8": rng.integers(0, 256, (61, 83, 3), np.uint8),
              "rgba8": rng.integers(0, 256, (61, 83, 4), np.uint8),
              "grey16": rng.integers(0, 65536, (61, 83), np.uint16),
              "rgb16": rng.integers(0, 65536, (61, 83, 3), np.uint16),
              "rgba16": rng.integers(0, 65536, (61, 83, 4), np.uint16)}
    png = {}
    for name, a in arrays.items():
        png[name] = all(
            np.array_equal(codec.decode_png(codec.encode_png(a, filter_type=ft)
                                            )["pixels"], a)
            for ft in (None, 0, 1, 2, 3, 4))
    cam = testing.VOID_CAMERA
    K = testing.VOID_K
    dist = np.array([cam["k_0"], cam["k_1"], cam["p_x"], cam["p_y"],
                     cam["k_2"]])
    new_K = imgproc.optimal_new_camera_matrix(K, dist, (640, 480))
    mx, my = imgproc.undistort_rectify_maps(K, dist, new_K, (640, 480))
    # the closed form again, written out here: pixel -> ray through new_K
    # -> radtan -> pixel through K, float64
    v, u = np.mgrid[0:480, 0:640].astype(np.float64)
    x = (u - new_K[0, 2]) / new_K[0, 0]
    y = (v - new_K[1, 2]) / new_K[1, 1]
    r2 = x * x + y * y
    radial = 1 + dist[0] * r2 + dist[1] * r2 ** 2 + dist[4] * r2 ** 3
    xd = x * radial + 2 * dist[2] * x * y + dist[3] * (r2 + 2 * x * x)
    yd = y * radial + dist[2] * (r2 + 2 * y * y) + 2 * dist[3] * x * y
    map_err = max(float(np.abs(mx - (K[0, 0] * xd + K[0, 2])).max()),
                  float(np.abs(my - (K[1, 1] * yd + K[1, 2])).max()))
    # alpha 0: every output pixel inside the source, to within 0.05 px (the
    # rectangle is cv2's, from a 9 x 9 grid of the border)
    inside = bool(mx.min() > -0.05 and mx.max() < 639.05
                  and my.min() > -0.05 and my.max() < 479.05)
    frame = testing.smooth_image(rng, 480, 640)
    depth = np.rint(testing.smooth_field(rng, 480, 640, 1, 0.3, 5.0) * 256
                    ).astype(np.uint16)
    rgb_png, depth_png = codec.encode_png(frame), codec.encode_png(depth)
    jpg = open(frames[0], "rb").read()
    rec = {"library": os.path.relpath(native.library_path(), ROOT),
           "build_seconds": build_s, "jpeg": jpeg,
           "jpeg_frames": {os.path.basename(f): list(b.shape)
                           for f, b in zip(frames, big)},
           "jpeg_frames_max_abs_err_stride13": frame_err,
           "png_round_trip_bitwise": png,
           "new_K": new_K.tolist(), "map_max_abs_err_px": map_err,
           "map_tolerance_px": 1e-4, "maps_inside_source": inside,
           "ms": {"jpeg_decode_480x640": _median_ms(
                      lambda: codec.imdecode_rgb(jpg)),
                  "png_decode_rgb_480x640": _median_ms(
                      lambda: codec.decode_png(rgb_png)),
                  "png_decode_depth16_480x640": _median_ms(
                      lambda: codec.decode_png(depth_png)),
                  "png_encode_rgb_480x640": _median_ms(
                      lambda: codec.encode_png(frame)),
                  "undistort_maps_480x640": _median_ms(
                      lambda: imgproc.undistort_rectify_maps(
                          K, dist, new_K, (640, 480)), 3),
                  "remap_u8_480x640": _median_ms(
                      lambda: imgproc.remap(frame, mx, my))},
           "bytes": {"png_rgb_480x640": len(rgb_png),
                     "png_depth16_480x640": len(depth_png),
                     "jpeg_480x640": len(jpg)},
           **host_info()}
    rec["ok"] = bool(lib is not None and len(jpeg) >= 6
                     and all(j["max_abs_err"] is not None
                             and j["max_abs_err"] <= j["limit"]
                             for j in jpeg.values())
                     and all(b.shape == (480, 640, 3) for b in big)
                     and len(big) == 2 and all(png.values())
                     and all(e is not None and e <= JPEG_LIMITS["420"]
                             for e in frame_err.values())
                     and map_err <= 1e-4 and inside)
    emit("codec", rec)
    if not rec["ok"]:
        raise RuntimeError(f"codec: {json.dumps(rec)[:3000]}")
    return rec


def _void_sample_check(s: dict, info: dict, train: bool) -> dict:
    """A VoidV3 sample against the tree that wrote it: keys, shapes and
    dtypes; R12 / T12 / R21 / T21 against the generating poses; the IMU
    count against the generating stamps in [t1, t2]."""
    from mmde_tpu_torch import geometry
    scene = s["foldername"]
    names = [f"{t:.4f}.png" for t in info["stamps"][scene]]
    o1 = names.index(s["filename"])
    o2 = o1 + VOID_INTERVAL
    poses = info["poses"][scene]
    _, T12, R12, _, _ = geometry.relative_pose_parts(poses[o1], poses[o2])
    _, T21, R21, _, _ = geometry.relative_pose_parts(poses[o2], poses[o1])
    pose_err = max(float(np.abs(s["R12"] - R12).max()),
                   float(np.abs(s["T12"] - T12.reshape(3)).max()),
                   float(np.abs(s["R21"] - R21).max()),
                   float(np.abs(s["T21"] - T21.reshape(3)).max()))
    imu_t = np.round(info["imu"][scene][0] * 1e9).astype(np.int64) * 1e-9
    t1, t2 = float(s["timestamp1"]), float(s["timestamp2"])
    want_n = int(((imu_t >= t1) & (imu_t <= t2)).sum())
    h, w = (480, 480) if train else (480, 640)
    shapes = {"image1": (h, w, 3), "depth1": (h, w),
              "image1_raw": (480, 640, 3), "depth1_raw": (480, 640),
              "R12": (3, 3), "T12": (3,), "imu_data": (256, 7)}
    bad = [k for k, sh in shapes.items()
           if s[k].shape != sh or s[k].dtype != np.float32]
    return {"scene": scene, "order": o1, "keys_ok": set(s) == VOID_KEYS,
            "bad_shapes_or_dtypes": bad, "pose_max_abs_err": pose_err,
            "imu_len": int(s["imu_len"]), "imu_expected": min(want_n, 256),
            "timestamps_float64": np.asarray(s["timestamp1"]).dtype
            == np.float64,
            "finite": bool(all(np.isfinite(s[k]).all() for k in shapes))}


def phase_data_void(root: str) -> dict:
    """write_void_release at 640 x 480 (DATA_VOID) into `root`; VoidV3's
    train (crop 480 x 480, void.yaml's) and test samples checked against
    the tree (_void_sample_check; the test scene's IMU comes from raw.bag,
    converted on first use); the reader's pairs/s through the DataLoader,
    batches of 4, with one thread (10 batches) and with void.yaml's 8
    workers (the rest of an epoch: 52 batches, 208 pairs), start-up
    outside the window (every scene's cache - maps, IMU - first, then the
    loader's first batch)."""
    from mmde_tpu_torch import testing
    from mmde_tpu_torch.data.loader import DataLoader
    from mmde_tpu_torch.data.void_v3 import VoidV3
    t = time.time()
    info = testing.write_void_release(root, **DATA_VOID)
    write_s = time.time() - t
    meta = info["meta"]
    calib = os.path.join(meta, "calibration.json")

    def void(split: str) -> VoidV3:
        return VoidV3(root, os.path.join(meta, f"{split}_image.txt"), calib,
                      is_train=split == "train", crop_size=(480, 480),
                      image_interval_range=(VOID_INTERVAL, VOID_INTERVAL),
                      imu_max_len=256)

    train, test = void("train"), void("test")
    checks = []
    for ds, is_train in ((train, True), (test, False)):
        for i in (0, len(ds) - 1):
            checks.append(_void_sample_check(ds[i], info, is_train))
    rates = {}
    per_scene = DATA_VOID["frames"] - VOID_INTERVAL
    for workers, batches in ((0, 10), (8, None)):
        ds = void("train")
        for i in range(0, len(ds), per_scene):
            ds[i]                   # every scene's cache (maps, IMU) first
        batches_left = iter(DataLoader(ds, 4, shuffle=True,
                                       num_workers=workers, seed=0))
        next(batches_left)          # the loader's start and first batch
        t = time.perf_counter()
        n = 0
        for k, b in enumerate(batches_left):
            n += len(b["filename"])
            if batches is not None and k + 1 >= batches:
                break
        seconds = time.perf_counter() - t
        batches_left.close()
        rates[f"{max(workers, 1)}_thread" + ("s" if workers else "")] = {
            "pairs": n, "seconds": seconds, "pairs_per_s": n / seconds}
    rec = {"tree": {k: v for k, v in DATA_VOID.items()},
           "write_seconds": write_s, "train_samples": len(train),
           "test_samples": len(test), "samples": checks,
           "loader": rates, **host_info()}
    test_scenes = DATA_VOID["test_scenes"]
    bag_scene = f"scene_{DATA_VOID['bag_scenes'][0]:02d}"
    rec["ok"] = bool(
        len(train) == (DATA_VOID["scenes"] - test_scenes) * per_scene
        and len(test) == test_scenes * per_scene
        and rates["8_threads"]["pairs"] == (len(train) // 4 - 1) * 4
        and all(c["keys_ok"] and not c["bad_shapes_or_dtypes"]
                and c["pose_max_abs_err"] <= 1e-6 and c["finite"]
                and c["imu_len"] == c["imu_expected"] > 0
                and c["timestamps_float64"] for c in checks)
        and os.path.isfile(os.path.join(root, "void_raw", bag_scene,
                                        "raw.csv")))
    emit("data_void", rec)
    if not rec["ok"]:
        raise RuntimeError(f"data_void: {json.dumps(rec)[:3000]}")
    rec["_info"] = info
    return rec


@contextlib.contextmanager
def _loader_waits(out: list):
    """Record, for every batch train.loop asks device_prefetch for, when it
    asked and when it got it (out: [(t_asked, t_got)]; t_got None where the
    epoch had ended)."""
    from mmde_tpu_torch.train import loop
    real = loop.device_prefetch

    def timed(iterator, device="cuda", size=2):
        gen = real(iterator, device, size)
        try:
            while True:
                t = time.perf_counter()
                try:
                    b = next(gen)
                except StopIteration:
                    out.append((t, None))
                    return
                out.append((t, time.perf_counter()))
                yield b
        finally:
            gen.close()

    loop.device_prefetch = timed
    try:
        yield
    finally:
        loop.device_prefetch = real


def _void_config(tmp: str, name: str, base: str, root: str, **extra) -> str:
    """configs/<base> pointed at the VOID tree under `root` (its meta/),
    written to `tmp`/<name>."""
    import yaml
    with open(os.path.join(ROOT, "configs", base)) as f:
        y = yaml.safe_load(f)
    y.update(DATASET_NAME="void", DATA_PATH=root, EPOCH=1, RESUME_FROM="",
             PRINT_FREQUENCY=1, IMAGE_INTERVAL_RANGE=[VOID_INTERVAL] * 2,
             **extra)
    path = os.path.join(tmp, name)
    with open(path, "w") as f:
        yaml.safe_dump(y, f)
    return path


def _wait_share(waits: list, steps: int, warmup: int = 0) -> dict:
    """The loop's wait for the loader over its `steps` steps, from what
    _loader_waits recorded. The first wait is start-up (the workers' first
    batch). The share of time spent waiting counts from getting batch
    `warmup` (the first `warmup` steps left out: every scene's cache is
    built on first use) to asking for the one after the last step; the
    time between batches is a step (the loop prints every step, which
    waits for the card)."""
    if len(waits) <= steps or any(w[1] is None for w in waits[:steps]):
        return {"batches_asked": len(waits)}

    def share(first: int):
        span = waits[steps][0] - waits[first][1]
        waited = sum(b - a for a, b in waits[first + 1:steps])
        return waited / span if span > 0 else None

    between = [1e3 * (waits[i + 1][0] - waits[i][1]) for i in range(steps)]
    return {"steps": steps, "warmup_steps": warmup,
            "first_batch_s": waits[0][1] - waits[0][0],
            "wait_ms": [1e3 * (b - a) for a, b in waits[1:steps]],
            "step_ms_between_batches": between,
            "step_ms_median": statistics.median(between[warmup:]),
            "loader_wait_share_after_first": share(0),
            "loader_wait_share": share(warmup)}


def phase_train_void(root: str, tmp: str) -> dict:
    """`python -m mmde_tpu_torch.tools.train --config` of configs/void.yaml
    (cnn_transformer_multi_scale + decoder_v1, float32, 480x480 crop,
    batch 4, 8 workers) on the VOID tree: one epoch (53 steps), validation
    on the test list and a checkpoint; the loop's wait for the loader
    timed around each batch (the loop prints every step, which syncs the
    card), its share after WARMUP_STEPS steps and the pairs/s the median
    step needs, the step's images/s from its log; then `tools.eval` of the
    checkpoint on the test list. The cnn model launches no window-attention
    kernel."""
    from mmde_tpu_torch.tools import eval as eval_cli
    from mmde_tpu_torch.tools import train as train_cli
    path = _void_config(tmp, "void.yaml", "void.yaml", root,
                        VALIDATION_FREQUENCY=1, SAVE_FREQUENCY=1,
                        SAVE_MODEL=True, WORKERS=8)
    log_dir = os.path.join(tmp, "void_run")
    waits: list = []
    _reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    t = time.time()
    with _loader_waits(waits):
        final = train_cli.main(["--config", path, "--log-dir", log_dir,
                                "--device", "cuda"])
    train_s = time.time() - t
    launches = {k: sum(d.values()) for k, d in _by_kernel().items()}
    torch.cuda.empty_cache()
    t = time.time()
    ev = eval_cli.main(["--config", path, "--ckpt",
                        os.path.join(log_dir, "ckpt"), "--device", "cuda"])
    eval_s = time.time() - t
    log = _loop_log(log_dir)
    steps = (DATA_VOID["scenes"] - DATA_VOID["test_scenes"]) * (
        DATA_VOID["frames"] - VOID_INTERVAL) // 4
    rec = {"command": "python -m mmde_tpu_torch.tools.train --config "
                      "<configs/void.yaml on the VOID tree>",
           "model": "configs/void.yaml: cnn_transformer_multi_scale "
                    "(resnet50) + decoder_v1, float32, crop 480x480",
           "frame_pairs": 4, "steps": steps, "seconds": train_s,
           "peak_memory_bytes": torch.cuda.max_memory_allocated(),
           "final_val": final, "launches": launches,
           "loader": _wait_share(waits, steps, WARMUP_STEPS),
           "images_per_s_logged": log["images_per_s_by_epoch"],
           "pairs_per_s_needed": None,
           "eval": {"seconds": eval_s, "restored": ev["restored"],
                    "metrics": ev["metrics"]}, **host_info()}
    if "step_ms_median" in rec["loader"]:
        rec["pairs_per_s_needed"] = 4e3 / rec["loader"]["step_ms_median"]
    rec["ok"] = bool(
        not launches and final and ev["restored"] is not None
        and rec["loader"].get("steps") == steps
        and all(math.isfinite(v) for v in final.values())
        and all(math.isfinite(v) for v in ev["metrics"].values())
        and sorted(log["scalars"]["train/loss_total"]) == [1])
    emit("train_void", rec)
    if not rec["ok"]:
        raise RuntimeError(f"train_void: {json.dumps(rec, default=str)[:3000]}")
    return rec


def phase_train_void_flagship(root: str, tmp: str, steps: int = 3) -> dict:
    """configs/flagship_synth.yaml's model (swin_base_v2 + decoder_v2,
    bfloat16, full depth) with DATASET_NAME void at 480 x 640, 2 pairs,
    `steps` steps through tools.train (no validation); its launches are
    the tensor-core K1+lse and K2, once a block a step."""
    from mmde_tpu_torch.tools import train as train_cli
    path = _void_config(tmp, "void_flagship.yaml", "flagship_synth.yaml",
                        root, CROP_HEIGHT=480, CROP_WIDTH=640, WORKERS=8,
                        VALIDATION_FREQUENCY=99, SAVE_MODEL=False)
    waits: list = []
    _reset_launch_counts()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t = time.time()
    with _loader_waits(waits):
        train_cli.main(["--config", path, "--batch-size", str(LOOP_PAIRS),
                        "--max-steps", str(steps), "--log-dir",
                        os.path.join(tmp, "flagship_run"), "--device",
                        "cuda"])
    seconds = time.time() - t
    fwd, bwd = _launches(), _launches(backward=True)
    want = expected_launches("swin_base_v2", LOOP_PAIRS, steps)
    kernels = {k: sum(d.values()) for k, d in _by_kernel().items()}
    log = _loop_log(os.path.join(tmp, "flagship_run"))
    rec = {"command": "python -m mmde_tpu_torch.tools.train --config "
                      "<flagship_synth.yaml, DATASET_NAME void> "
                      f"--batch-size {LOOP_PAIRS} --max-steps {steps}",
           "model": "swin_base_v2 + decoder_v2, bfloat16, 480x640, depths "
                    "2/2/18/2", "frame_pairs": LOOP_PAIRS, "steps": steps,
           "seconds": seconds,
           "peak_memory_bytes": torch.cuda.max_memory_allocated(),
           "launches": kernels, "launches_expected_per_layout": {
               lay: sum(d.values()) for lay, d in want.items()},
           "loader": _wait_share(waits, steps),
           "images_per_s_logged": log["images_per_s_by_epoch"],
           "losses": log["scalars"].get("train/loss_total"), **host_info()}
    rec["ok"] = bool(fwd == want and bwd == want and kernels
                     and set(kernels) == {"window_attention_fwd_tc+lse",
                                          "window_attention_bwd_tc"}
                     and all(math.isfinite(v) for v in
                             log["scalars"]["train/loss_total"].values()))
    emit("train_void_flagship", rec)
    if not rec["ok"]:
        raise RuntimeError(f"train_void_flagship: launches {fwd} / {bwd}, "
                           f"expected {want}: {json.dumps(rec)[:2000]}")
    return rec


def phase_data_mixed(root: str) -> dict:
    """A KITTI tree at 375 x 1242 through KITTIEigen (KB crop to 352 x
    1216), an NYU tree of the committed 480 x 640 JPEGs through
    NYUDepthV2Pairs, then build_datasets of configs/mixed_bf16_dp.yaml
    over NYU + KITTI + VOID (the VOID tree already in `root`): every
    source joins; one batch of 2 from each source, at the config's 480 x
    640."""
    from mmde_tpu_torch import testing
    from mmde_tpu_torch.data.datasets import KITTIEigen, NYUDepthV2Pairs
    from mmde_tpu_torch.data.loader import collate
    from mmde_tpu_torch.train.loop import build_datasets
    t = time.time()
    testing.write_kitti_tree(root, n_train=2, n_test=1)
    testing.write_nyu_tree(root, _jpeg_frames(), frames_per_scene=3,
                           train_scenes=2)
    write_s = time.time() - t
    fn = os.path.join(root, "filenames")
    kitti = KITTIEigen(root, fn, False, (352, 704))[0]
    nyu = NYUDepthV2Pairs(root, fn, True, (480, 640))[0]
    cfg = _yaml_config("mixed_bf16_dp.yaml")
    cfg = dataclasses.replace(cfg, data=dataclasses.replace(
        cfg.data, data_path=root))
    train, val = build_datasets(cfg)
    batches = {}
    for src in train.sources:
        b = collate([src[i] for i in range(2)])
        batches[str(int(b["dataset_id"][0]))] = {
            "kind": src.kind,
            "shapes": {k: list(v.shape) for k, v in b.items()},
            "finite": bool(all(np.isfinite(v).all() for v in b.values())),
            "pose_valid": b["pose_valid"].tolist()}
    hw = [cfg.data.crop_h, cfg.data.crop_w]
    rec = {"write_seconds": write_s,
           "kitti_eval_image": list(kitti["image"].shape),
           "kitti_valid_depth_share": float((kitti["depth"] > 0).mean()),
           "nyu_pair_image": list(nyu["image1"].shape),
           "mixed_sources": len(train.sources), "mixed_val_sources":
               len(val.sources), "epoch_size": len(train),
           "batches": batches, **host_info()}
    rec["ok"] = bool(
        list(kitti["image"].shape) == [352, 1216, 3]
        and list(nyu["image1"].shape) == [480, 640, 3]
        and sorted(batches) == ["0", "1", "2"]
        and all(b["finite"] and b["shapes"]["image1"] == [2] + hw + [3]
                and b["shapes"]["depth1"] == [2] + hw
                for b in batches.values()))
    emit("data_mixed", rec)
    if not rec["ok"]:
        raise RuntimeError(f"data_mixed: {json.dumps(rec)[:3000]}")
    return rec


INFER_MM = 2            # infer_cli: CLI PNG vs predict(), mm (16-bit counts)
COLOR_MISMATCH = 1e-3   # infer_cli: share of _color.png pixels off predict()'s


def phase_infer_cli(tmp: str) -> dict:
    """`python -m mmde_tpu_torch.tools.infer --config
    configs/flagship_synth.yaml --weights <state dict>` (in this process:
    the flagship, bf16, with randomize_weights' seed-7 weights saved as a
    state dict, under which depth depends on the frame) on a folder of a
    487 x 651 PNG, which the CLI resizes to 480 x 640, and a committed 480 x
    640 JPEG. Each 16-bit PNG it writes is held, within INFER_MM, to
    `infer.predict` of the same weights in this process on the frame read
    another way: the PNG's pixels as drawn here (the PNG round trip is
    bitwise in `codec`), resized by imgproc.resize_linear; the JPEG's
    decode, held first to cv2's at every 13th pixel
    (frames_cv2_stride13.npz). The two depth maps must each vary and differ
    from each other by far more than INFER_MM, so that a wrong decode or
    resize fails; K1 launched. With --colormap the CLI also writes each
    frame's rainbow-coloured depth (`<name>_color.png`, 480 x 640 RGB),
    held to utils.viz.colorize_depth of `infer.predict`'s depth (at most
    COLOR_MISMATCH of the pixels apart: a depth a float ulp across a
    colour bin's edge). cv2 is never imported (where it is installed on
    this machine its path is recorded)."""
    from mmde_tpu_torch import testing
    from mmde_tpu_torch.data import codec
    from mmde_tpu_torch.data.imgproc import resize_linear
    from mmde_tpu_torch.tools import infer
    from mmde_tpu_torch.utils import viz
    images, out = os.path.join(tmp, "frames"), os.path.join(tmp, "depth")
    os.makedirs(images)
    cfg = os.path.join(ROOT, "configs", "flagship_synth.yaml")
    model = infer.build(cfg, device="cuda", seed=0)
    randomize_weights(model, seed=7)
    weights = os.path.join(tmp, "flagship_seed7.pth")
    torch.save(model.state_dict(), weights)
    png = testing.smooth_image(np.random.default_rng(5), 487, 651)
    codec.write_png(os.path.join(images, "a.png"), png)
    jpeg = _jpeg_frames()[0]
    shutil.copyfile(jpeg, os.path.join(images, "b.jpg"))
    jpeg_rgb = codec.imread_rgb(jpeg)
    jpeg_err = _frame_err(jpeg, jpeg_rgb)
    _reset_launch_counts()
    t = time.time()
    infer.main(["--images", images, "--out", out, "--config", cfg,
                "--weights", weights, "--colormap", "--device", "cuda"])
    seconds = time.time() - t
    launches = {k: sum(d.values()) for k, d in _by_kernel().items()}
    frames = {"a.png": resize_linear(png, 640, 480), "b.png": jpeg_rgb}
    written, maps, colored = {}, {}, {}
    for name in sorted(os.listdir(out)):
        if name.endswith("_color.png"):
            rgb = codec.imread_rgb(os.path.join(out, name))
            frame = frames.get(name[:-len("_color.png")] + ".png")
            rec_c = {"shape": list(rgb.shape), "dtype": str(rgb.dtype)}
            if frame is not None and rgb.shape == (480, 640, 3):
                x = frame[None]
                want = viz.colorize_depth(
                    infer.predict(model, x, x)["pred_d1"][0, ..., 0])
                rec_c["pixels_apart"] = float(
                    np.any(rgb != want[..., ::-1], axis=-1).mean())
                rec_c["colours"] = int(len(np.unique(
                    rgb.reshape(-1, 3), axis=0)))
            colored[name] = rec_c
            continue
        d = codec.imread_unchanged(os.path.join(out, name))
        written[name] = {"shape": list(d.shape), "dtype": str(d.dtype),
                         "min": int(d.min()), "max": int(d.max()),
                         "std_mm": float(d.std())}
        if name in frames and d.shape == (480, 640):
            x = frames[name][None]
            want = np.clip(infer.predict(model, x, x)["pred_d1"][0, ..., 0]
                           * 1000.0, 0, 65535).astype(np.uint16)
            written[name]["max_abs_mm_vs_predict"] = int(
                np.abs(d.astype(np.int64) - want).max())
            maps[name] = d.astype(np.int64)
    between = (int(np.abs(maps["a.png"] - maps["b.png"]).max())
               if len(maps) == 2 else None)
    import importlib.util
    spec = importlib.util.find_spec("cv2")       # found, never imported
    rec = {"command": "python -m mmde_tpu_torch.tools.infer --images "
                      "<a.png 487x651, b.jpg 480x640> --out <dir> --config "
                      "configs/flagship_synth.yaml --weights <seed 7> "
                      "--colormap --device cuda",
           "seconds": seconds, "written": written, "tolerance_mm": INFER_MM,
           "colormap": colored, "colormap_tolerance": COLOR_MISMATCH,
           "jpeg_max_abs_err_stride13": jpeg_err,
           "max_abs_mm_between_frames": between, "launches": launches,
           "cv2_on_this_machine": spec.origin if spec else None,
           **host_info()}
    rec["ok"] = bool(sorted(written) == ["a.png", "b.png"] and len(maps) == 2
                     and jpeg_err is not None
                     and jpeg_err <= JPEG_LIMITS["420"]
                     and all(w["dtype"] == "uint16" and w["std_mm"] > 100
                             and w.get("max_abs_mm_vs_predict",
                                       INFER_MM + 1) <= INFER_MM
                             for w in written.values())
                     and between > 100 * INFER_MM
                     and launches.get("window_attention_fwd_tc", 0) > 0
                     and sorted(colored) == ["a_color.png", "b_color.png"]
                     and all(c.get("pixels_apart", 1.0) <= COLOR_MISMATCH
                             and c["colours"] > 16
                             for c in colored.values()))
    del model
    torch.cuda.empty_cache()
    emit("infer_cli", rec)
    if not rec["ok"]:
        raise RuntimeError(f"infer_cli: {json.dumps(rec)[:3000]}")
    return rec


def phase_data() -> dict:
    """codec, data_void, train_void, train_void_flagship, data_mixed and
    infer_cli in one temporary directory (the data root and the runs),
    removed at the end."""
    phase_codec()
    tmp = tempfile.mkdtemp(prefix="mmde_smoke_data_")
    try:
        root = os.path.join(tmp, "data")
        os.makedirs(root)
        phase_data_void(root)
        phase_train_void(root, tmp)
        torch.cuda.empty_cache()
        phase_train_void_flagship(root, tmp)
        torch.cuda.empty_cache()
        phase_data_mixed(root)
        phase_infer_cli(tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    torch.cuda.empty_cache()
    return {}


# ------------------------------------------------------------------------
# Pretrained backbones (ROADMAP M7), the remat policies that keep named
# intermediates (M2) and the profiling tool (M9).
# ------------------------------------------------------------------------

PRETRAINED_STEPS = 2            # tools.train steps from the pretrained file
REMAT_POLICIES = ("none", "full", "mlp_only", "attn_out", "attn_qkv")
REMAT_STEPS = 3                 # timed steps a policy (the median is kept)


def _simmim_file(path: str, encoder, pretrain_windows) -> tuple:
    """Write a SimMIM-style checkpoint of `encoder` (a swin_base_v2) to
    `path`: {"model": ..., "epoch": ...} holding every tensor of its state
    dict under `module.encoder.`, each block's static buffers
    (relative_position_index, relative_coords_table) at its stage's
    pretraining window (`pretrain_windows`), the pretraining head's
    mask_token, and for layers.0.blocks.0 a discrete relative-position
    table pretrained at window 12 (rpe_table_type "none"'s, drawn).
    Returns (the encoder's tensors, that table), on the CPU."""
    from mmde_tpu_torch.nn.swin_v2 import (relative_coords_table,
                                           relative_position_index)
    sd = {k: v.detach().cpu() for k, v in encoder.state_dict().items()}
    out = {f"module.encoder.{k}": v for k, v in sd.items()}
    for i, layer in enumerate(encoder.layers):
        w = (pretrain_windows[i],) * 2
        for j in range(len(layer.blocks)):
            a = f"module.encoder.layers.{i}.blocks.{j}.attn."
            out[a + "relative_position_index"] = torch.from_numpy(
                relative_position_index(w)).long()
            out[a + "relative_coords_table"] = torch.from_numpy(
                relative_coords_table(w, w[0]))[None]
    nH = encoder.layers[0].blocks[0].attn.num_heads
    gen = torch.Generator().manual_seed(12)
    table = torch.randn((2 * 12 - 1) ** 2, nH, generator=gen)
    out["module.encoder.layers.0.blocks.0.attn."
        "relative_position_bias_table"] = table
    out["module.encoder.mask_token"] = torch.zeros(
        1, 1, encoder.num_features[0])
    torch.save({"model": out, "epoch": 100}, path)
    return sd, table


def _nyu_config(tmp: str, root: str, pretrained: str) -> str:
    """configs/nyu_swin_decoder_v1.yaml (swin_base_v2 + decoder_v1, bf16,
    480 x 640, USE_CHECKPOINT_SWIN: "full" remat) pointed at the NYU tree
    under `root` with PRETRAINED_SWIN `pretrained`; one epoch, no
    validation, no checkpoint. The NYU pairs are read through the mix
    (DATASET_NAME "mixed", NYU its only source), which gives them the pose
    keys the loss reads: the "nyudepthv2" reader has none, in either
    package (ROADMAP Queue C)."""
    import yaml
    with open(os.path.join(ROOT, "configs", "nyu_swin_decoder_v1.yaml")) as f:
        y = yaml.safe_load(f)
    y.update(DATASET_NAME="mixed", DATA_PATH=root, EPOCH=1, RESUME_FROM="",
             PRINT_FREQUENCY=1, VALIDATION_FREQUENCY=99, SAVE_MODEL=False,
             WORKERS=2)
    y["SWIN"]["PRETRAINED_SWIN"] = pretrained
    path = os.path.join(tmp, "nyu_pretrained.yaml")
    with open(path, "w") as f:
        yaml.safe_dump(y, f)
    return path


def phase_pretrained(tmp: str) -> dict:
    """ckpt.pretrained.load_pretrained on the card. A SimMIM-style
    swin_base_v2 checkpoint (`_simmim_file`: buffers at the pretraining
    windows 12 / 12 / 12 / 6, weights drawn by
    randomize_weights) into the flagship encoder of
    nyu_swin_decoder_v1.yaml's model: every encoder tensor bitwise the
    file's; the report (the window-12 table unexpected in the MLP-RPE
    model, the mask_token a note). Its window-12 table into the model's
    first stage built with rpe_table_type "none" (window 30): bitwise the
    float64 interpolate_rpe_table (geo) result in float32; the stage's
    output norm and its other blocks' tables reported missing. Then
    PRETRAINED_STEPS steps through `python -m mmde_tpu_torch.tools.train`
    with that config (2 pairs, an NYU tree of the committed JPEGs,
    PRETRAINED_SWIN the file): the loader's report printed, K1+lse twice a
    block a step (USE_CHECKPOINT_SWIN: "full" remat replays each block),
    K2 once, finite losses."""
    import io as stdio
    from mmde_tpu_torch import testing
    from mmde_tpu_torch.ckpt import pretrained, torch_convert
    from mmde_tpu_torch.config import load_yaml
    from mmde_tpu_torch.models.two_frame import SWIN_VARIANTS
    from mmde_tpu_torch.nn.swin_v2 import SwinTransformerV2
    from mmde_tpu_torch.tools import infer
    from mmde_tpu_torch.tools import train as train_cli
    cfg = load_yaml(os.path.join(ROOT, "configs", "nyu_swin_decoder_v1.yaml"))
    path = os.path.join(tmp, "swin_v2_base_simmim.pth")
    t = time.time()
    src = infer.build(cfg, device="cuda", seed=1)
    randomize_weights(src, seed=9)
    sd, table = _simmim_file(path, src.encoder,
                             cfg.model.swin.pretrain_window_size)
    del src
    write_s = time.time() - t
    model = infer.build(cfg, device="cuda", seed=0)
    torch.cuda.synchronize()
    t = time.time()
    missing, unexpected, notes = pretrained.load_pretrained(
        model, cfg.model, path, verbose=False)
    torch.cuda.synchronize()
    load_s = time.time() - t
    got = model.encoder.state_dict()
    unequal = [k for k in got if not torch.equal(got[k].cpu(), sd[k])]
    del model, got

    variant = next(v for v in SWIN_VARIANTS if v in cfg.model.backbone)
    embed, heads = SWIN_VARIANTS[variant]
    depth = cfg.model.swin.depths[0]

    class Discrete(torch.nn.Module):
        """The model's first stage with rpe_table_type "none"."""

        def __init__(self):
            super().__init__()
            self.encoder = SwinTransformerV2(
                embed_dim=embed, depths=(depth,), num_heads=heads[:1],
                window_size=cfg.model.swin.window_size[:1],
                pretrain_window_size=(12,), out_indices=(0,),
                rpe_table_type="none", drop_path_rate=0.0)

    disc = Discrete().cuda()
    d_missing, d_unexpected, _ = pretrained.load_pretrained(
        disc, cfg.model, path, verbose=False)
    loaded = disc.encoder.layers[0].blocks[0].attn \
        .relative_position_bias_table.detach().cpu()
    want = torch.from_numpy(torch_convert.interpolate_rpe_table(
        table.double().numpy(), 12, cfg.model.swin.window_size[0]
    ).astype(np.float32))
    del disc

    root = os.path.join(tmp, "nyu")
    testing.write_nyu_tree(root, _jpeg_frames())
    cfg_path = _nyu_config(tmp, root, path)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    _reset_launch_counts()
    printed = stdio.StringIO()
    t = time.time()
    with contextlib.redirect_stdout(printed):
        train_cli.main(["--config", cfg_path, "--batch-size",
                        str(LOOP_PAIRS), "--max-steps",
                        str(PRETRAINED_STEPS), "--log-dir",
                        os.path.join(tmp, "nyu_run"), "--device", "cuda"])
    torch.cuda.synchronize()
    train_s = time.time() - t
    fwd, bwd = _launches(), _launches(backward=True)
    want_fwd = expected_launches("swin_base_v2", LOOP_PAIRS,
                                 2 * PRETRAINED_STEPS)
    want_bwd = expected_launches("swin_base_v2", LOOP_PAIRS,
                                 PRETRAINED_STEPS)
    kernels = {k: sum(d.values()) for k, d in _by_kernel().items()}
    log = _loop_log(os.path.join(tmp, "nyu_run"))
    losses = log["scalars"].get("train/loss_total", {})
    lines = [ln for ln in printed.getvalue().splitlines()
             if ln.startswith("[pretrained]")]
    rec = {"file": "SimMIM-style swin_base_v2 state dict under "
                   "module.encoder. + buffers + mask_token + a window-12 "
                   "table (layers.0.blocks.0)",
           "file_bytes": os.path.getsize(path), "write_seconds": write_s,
           "load_seconds": load_s, "tensors": len(sd),
           "not_bitwise": unequal[:8], "report": {
               "missing": len(missing), "unexpected": unexpected,
               "notes": notes},
           "discrete": {"missing": d_missing,
                        "unexpected_count": len(d_unexpected),
                        "table_shape": list(loaded.shape),
                        "table_bitwise_float64_geo": torch.equal(loaded,
                                                                 want),
                        "table_max_abs_vs_float64": float(
                            (loaded.double() - want.double()).abs().max())},
           "train": {"command": "python -m mmde_tpu_torch.tools.train "
                                "--config <nyu_swin_decoder_v1.yaml, an NYU "
                                "tree through the mix, PRETRAINED_SWIN the "
                                "file> "
                                f"--batch-size {LOOP_PAIRS} --max-steps "
                                f"{PRETRAINED_STEPS}",
                     "seconds": train_s, "printed": lines,
                     "launches": kernels,
                     "k1_lse_launches": kernels.get(
                         "window_attention_fwd_tc+lse", 0),
                     "k2_launches": kernels.get("window_attention_bwd_tc",
                                                0),
                     "peak_memory_bytes": torch.cuda.max_memory_allocated(),
                     "losses": losses}}
    tab = "layers.0.blocks.0.attn.relative_position_bias_table"
    rec["ok"] = bool(
        not unequal and not missing and unexpected == [tab]
        and notes == ["unmapped: mask_token"]
        and set(d_missing) == {"norm0.weight", "norm0.bias"} | {
            f"layers.0.blocks.{i}.attn.relative_position_bias_table"
            for i in range(1, depth)}
        and rec["discrete"]["table_bitwise_float64_geo"]
        and lines == [f"[pretrained] loaded {path}: 0 missing, "
                      "1 unexpected"]
        and fwd == want_fwd and bwd == want_bwd
        and set(kernels) == {"window_attention_fwd_tc+lse",
                             "window_attention_bwd_tc"}
        and len(losses) > 0
        and all(math.isfinite(v) for v in losses.values()))
    emit("pretrained", rec)
    if not rec["ok"]:
        raise RuntimeError(f"pretrained: launches {fwd} / {bwd}, expected "
                           f"{want_fwd} / {want_bwd}: "
                           f"{json.dumps(rec)[:3000]}")
    return rec


def _set_remat(model, policy: str) -> None:
    """Every swin stage of `model` under remat `policy`, in place (the
    stages read it at each forward)."""
    from mmde_tpu_torch.nn.swin_v2 import BasicLayer
    for m in model.modules():
        if isinstance(m, BasicLayer):
            m.remat = policy
            for blk in m.blocks:
                blk.remat_mlp = policy == "mlp_only"


def phase_remat(steps: int = REMAT_STEPS) -> dict:
    """The bf16 flagship trainer at 2 pairs (deterministic: eval-mode
    modules, weights from randomize_weights' seed 7, one batch) under each
    remat policy of REMAT_POLICIES in turn, every policy's first step from
    the same weights and under torch.use_deterministic_algorithms (warn
    only: the attention backward then sums dbias by K3, cuDNN and the
    index_add take their deterministic algorithms; bf16 gradients carry the
    atomics' order otherwise, ~an ulp of bf16): that step's loss and the
    gradients of PARITY_PARAMS against "none"'s (loss at
    TOL_TRAIN_PARITY_BF16, gradients at TOL_TRAIN_PARITY's rel-L2), its
    K1+lse / K2 / K3 launches (the replay: K1+lse twice a block under
    "full", "attn_out" and "attn_qkv", once otherwise; K2 and K3 once).
    Then `steps` steps as a user runs them (atomics): peak bytes
    (max_memory_allocated over those steps) and the median step ms (host
    clock to synchronize)."""
    from mmde_tpu_torch.tools import train_steps as ts
    cfg = ts.flagship_config("bfloat16", batch_size=LOOP_PAIRS)
    state, step = ts.build_trainer(cfg, device="cuda", seed=0,
                                   deterministic=True)
    randomize_weights(state.model, seed=7)
    init = {n: t.detach().clone() for n, t in state.model.state_dict().items()}
    batch = ts.synthetic_batch(LOOP_PAIRS, 480, 640, seed=33, device="cuda")
    state, _ = step(state, batch)           # warm: kernels, moments
    blocks = sum(s["blocks"] for s in stage_shapes())
    was_deterministic = torch.are_deterministic_algorithms_enabled()
    res, base = {}, None
    for policy in REMAT_POLICIES:
        with torch.no_grad():
            state.model.load_state_dict(init)
        _set_remat(state.model, policy)
        torch.cuda.synchronize()
        _reset_launch_counts()
        torch.use_deterministic_algorithms(True, warn_only=True)
        try:
            state, aux = step(state, batch)
            torch.cuda.synchronize()
        finally:
            torch.use_deterministic_algorithms(was_deterministic)
        loss = {k: float(v) for k, v in aux.items()}
        grads = {n: p.grad.detach().double().clone()
                 for n, p in state.model.named_parameters()
                 if n in PARITY_PARAMS}
        launches = {k: sum(d.values()) for k, d in _by_kernel().items()}
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        ms = []
        for _ in range(steps):
            torch.cuda.synchronize()
            t = time.time()
            state, _ = step(state, batch)
            torch.cuda.synchronize()
            ms.append((time.time() - t) * 1e3)
        replays = policy in ("full", "attn_out", "attn_qkv")
        rec = {"peak_memory_bytes": torch.cuda.max_memory_allocated(),
               "step_ms_median": statistics.median(ms), "step_ms": ms,
               "loss": loss, "launches_first_step": launches,
               "k1_lse_launches": launches.get(
                   "window_attention_fwd_tc+lse", 0),
               "k2_launches": launches.get("window_attention_bwd_tc", 0),
               "k3_launches": launches.get("window_attention_dbias_tc", 0),
               "k1_lse_expected": blocks * (2 if replays else 1),
               "k2_expected": blocks}
        if base is None:
            base = (loss, grads)
        rec["loss_rel_diff"] = abs(loss["loss_total"]
                                   - base[0]["loss_total"]) / abs(
                                       base[0]["loss_total"])
        rec["grad_rel_l2"] = {n: float((grads[n] - base[1][n]).norm()
                                       / base[1][n].norm().clamp_min(1e-300))
                              for n in base[1]}
        rec["ok"] = bool(
            rec["k1_lse_launches"] == rec["k1_lse_expected"]
            and rec["k2_launches"] == rec["k3_launches"] == blocks
            and set(launches) == {"window_attention_fwd_tc+lse",
                                  "window_attention_bwd_tc",
                                  "window_attention_dbias_tc"}
            and math.isfinite(loss["loss_total"])
            and rec["loss_rel_diff"] <= TOL_TRAIN_PARITY_BF16["loss_rel"]
            and all(v <= TOL_TRAIN_PARITY["grad_rel_l2"]
                    for v in rec["grad_rel_l2"].values())
            and set(grads) == set(PARITY_PARAMS)
            and all(float(g.norm()) > 0 for g in grads.values()))
        res[policy] = rec
    peaks = {p: r["peak_memory_bytes"] for p, r in res.items()}
    out = {"model": "swin_base_v2 + decoder_v2, bfloat16, 480x640, depths "
                    "2/2/18/2, deterministic trainer",
           "frame_pairs": LOOP_PAIRS, "steps_timed": steps,
           "policies": res, "peak_bytes": peaks,
           "peak_order": sorted(peaks, key=peaks.get, reverse=True),
           "tolerance": {"loss_rel": TOL_TRAIN_PARITY_BF16["loss_rel"],
                         "grad_rel_l2": TOL_TRAIN_PARITY["grad_rel_l2"]}}
    out["ok"] = bool(all(r["ok"] for r in res.values())
                     and peaks["full"] < peaks["none"]
                     and peaks["attn_out"] < peaks["none"])
    del state, step
    torch.cuda.empty_cache()
    emit("remat", out)
    if not out["ok"]:
        raise RuntimeError(f"remat: {json.dumps(out)[:3000]}")
    return out


def phase_profile_step() -> dict:
    """`python -m mmde_tpu_torch.tools.profile_step --batch 2 --steps 2`
    in this process: the flagship's train step under torch.profiler,
    device ms a step by kernel group (the grouping the --profile phases
    use); the attention groups must carry time."""
    import io as stdio
    from mmde_tpu_torch.tools import profile_step
    printed = stdio.StringIO()
    t = time.time()
    with contextlib.redirect_stdout(printed):
        rep = profile_step.main(["--batch", str(LOOP_PAIRS), "--steps", "2"])
    rec = {"command": "python -m mmde_tpu_torch.tools.profile_step "
                      f"--batch {LOOP_PAIRS} --steps 2",
           "seconds": time.time() - t,
           "printed": json.loads(printed.getvalue().strip().splitlines()[-1]),
           "top": rep["top"][:6]}
    groups = rec["printed"]["device_ms_by_group"]
    rec["ok"] = bool(rec["printed"]["device_ms_total"] > 0
                     and groups.get("window_attention_fwd (this repo's "
                                    "kernel)", 0) > 0
                     and groups.get("window_attention_bwd (this repo's "
                                    "kernel)", 0) > 0)
    torch.cuda.empty_cache()
    emit("profile_step", rec)
    if not rec["ok"]:
        raise RuntimeError(f"profile_step: {json.dumps(rec)[:3000]}")
    return rec


def phase_modules() -> dict:
    """pretrained (in a temporary directory, removed in `finally`), remat
    and profile_step."""
    tmp = tempfile.mkdtemp(prefix="mmde_smoke_modules_")
    try:
        phase_pretrained(tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    torch.cuda.empty_cache()
    phase_remat()
    phase_profile_step()
    return {}



def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--only", choices=["kernels", "loop", "models", "data",
                                       "modules"],
                    default=None,
                    help="kernels: build the kernels, compare them with "
                         "their plain versions (no timing); loop: the "
                         "training and evaluation entry points (loop, "
                         "eval_ckpt, deterministic); models: the slab "
                         "kernels (K3 over MapRows among them), the other "
                         "encoders and families (kernel_cases_models, "
                         "serve_cnn, train_cnn, train_completion, "
                         "serve_glpdepth) and deterministic; data: the "
                         "data path (codec, data_void, train_void, "
                         "train_void_flagship, data_mixed, infer_cli); "
                         "modules: pretrained, remat, profile_step; "
                         "then stop (prints no final ok line)")
    ap.add_argument("--profile", metavar="PATH", default=None,
                    help="also profile one served request and one train "
                         "step with torch.profiler, of the flagship, of "
                         "swin_large, of the flagship's slab path, of Paths "
                         "A and B, of the fp32 flagship, of fp32 swin_large "
                         "and of the fp32 flagship's slab path, and write "
                         "their rows to PATH and PATH with _large / _slab / "
                         "_resident / _w / _fp32 / _large_fp32 / _slab_fp32 "
                         "before its extension (JSON)")
    ap.add_argument("--child", choices=["w", "resident", "mxu", "split"],
                    default=None,
                    help=argparse.SUPPRESS)     # the script's own children
    ap.add_argument("--out", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--steps", type=int, default=4, help=argparse.SUPPRESS)
    args = ap.parse_args()

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False); this script runs on the GPU only", file=sys.stderr)
        return 1
    t_start = time.time()
    torch.manual_seed(0)
    if args.child:
        return child_main(args)
    phase_env()
    if args.only == "data":
        phase_data()
        emit("phase_seconds", PHASE_SECONDS)
        return 0
    if args.only == "modules":
        phase_modules()
        emit("phase_seconds", PHASE_SECONDS)
        return 0
    if args.only == "loop":
        phase_loop_entries()
        emit("phase_seconds", PHASE_SECONDS)
        return 0
    if args.only == "models":
        phase_kernels_slab(timed=False)
        phase_kernels_models(timed=False)
        phase_models()
        phase_deterministic()
        emit("phase_seconds", PHASE_SECONDS)
        return 0
    timed = args.only is None
    k1_cases = phase_kernels(timed=timed)
    k2_cases = phase_kernels_backward(timed=timed)
    phase_f3_packed()
    hs_cases = phase_kernels_headsplit(timed=timed)
    slab_cases = phase_kernels_slab(timed=timed)
    k4_cases = phase_kernels_resident(timed=timed)
    kw_cases = phase_kernels_w(timed=timed)
    mxu_cases = phase_kernels_mxu(timed=timed)
    tc_cases = phase_kernels_tc(timed=timed)
    model_cases = phase_kernels_models(timed=timed)
    if args.only == "kernels":
        emit("phase_seconds", PHASE_SECONDS)
        return 0
    tool_entries = phase_probes() + phase_variants()
    roof_entries, roof = phase_roofline()
    tc_bounds(tc_cases + hs_cases + slab_cases + k4_cases + kw_cases,
              roof["rates"]["dot_bf16_TFLOP_s"])
    k3_bounds(k2_cases + hs_cases + slab_cases, roof["rates"])
    serve = phase_serve()
    train = phase_train()
    serve_large = phase_serve("swin_large_v2", flip=False, tag="serve_large")
    train_large = phase_train("swin_large_v2", steps=4,
                              deterministic_run=False, tag="train_large")
    serve_slab = phase_serve(tag="serve_slab", attn_impl="cuda_slab")
    train_slab = phase_train(steps=4, deterministic_run=False,
                             tag="train_slab", attn_impl="cuda_slab")
    # the fp32 flagship (the JAX package's default type), full depth
    serve_fp32 = phase_serve(requests=1, flip=False, tag="serve_fp32",
                             dtype="float32")
    train_fp32 = phase_train(steps=6, deterministic_run=False,
                             tag="train_fp32", dtype="float32")
    # swin_large in float32: stage 1 on the fp32 head-split tensor-core
    # kernels, stages 2-4 on the fp32 packed ones
    serve_large_fp32 = phase_serve("swin_large_v2", requests=1, flip=False,
                                   tag="serve_large_fp32", dtype="float32")
    train_large_fp32 = phase_train("swin_large_v2", steps=3,
                                   deterministic_run=False,
                                   tag="train_large_fp32", dtype="float32")
    # the fp32 flagship on the slab path: every block's K8' / K9' on the
    # fp32 tensor-core kernels
    serve_slab_fp32 = phase_serve(requests=1, flip=False,
                                  tag="serve_slab_fp32",
                                  attn_impl="cuda_slab", dtype="float32")
    train_slab_fp32 = phase_train(steps=3, deterministic_run=False,
                                  tag="train_slab_fp32",
                                  attn_impl="cuda_slab", dtype="float32")
    (train_res, resident_child, serve_w, train_w, w_child, _,
     train_mxu) = phase_children()
    # after the three side-by-side children: the card to itself
    train_split = phase_train_split()
    loop_rec = phase_loop_entries()
    completion, glpdepth = phase_models()
    phase_data()
    phase_modules()
    if args.profile:
        phase_profile(args.profile, paths=PROFILED_PATHS)
        root, ext = os.path.splitext(args.profile)
        phase_profile(f"{root}_large{ext}", "swin_large_v2", "profile_large")
        phase_profile(f"{root}_slab{ext}", tag="profile_slab",
                      attn_impl="cuda_slab")
        phase_profile(f"{root}_fp32{ext}", tag="profile_fp32",
                      dtype="float32")
        phase_profile(f"{root}_large_fp32{ext}", "swin_large_v2",
                      "profile_large_fp32", dtype="float32")
        phase_profile(f"{root}_slab_fp32{ext}", tag="profile_slab_fp32",
                      attn_impl="cuda_slab", dtype="float32")
    phase_parity()
    phase_train_parity()
    phase_train_parity_tiny()
    emit("parity_large", {
        "forward": phase_parity("swin_large_v2", ("float32", "bfloat16"),
                                tag=None),
        "train_step": phase_train_parity("swin_large_v2",
                                         params=LARGE_PARITY_PARAMS,
                                         tag=None),
        # bf16: stage 1 on the head-split tensor-core kernels
        "train_step_bf16": phase_train_parity(
            "swin_large_v2", params=LARGE_STAGE1_PARAMS, tag=None,
            dtype="bfloat16"),
        # and K7' on that step's block-0 inputs against float64
        "block0_k7_dlogit_scale": k7_block0()})
    emit("parity_slab", {
        # either type: every block on the tensor-core slab kernels (fp32:
        # three bf16 pieces, hi + lo log-sum-exp)
        "forward": phase_parity(tag=None, impl="cuda_slab"),
        "train_step": phase_train_parity(tag=None, impl="cuda_slab")})
    phase_train_parity_resident(resident_child)
    phase_train_parity_resident(w_child, "train_parity_w", "MMDE_ATTN_W=auto")
    _PARITY_MODELS.clear()
    torch.cuda.empty_cache()
    entries = []
    for sv, tr in ((serve, train), (serve_large, train_large),
                   (serve_slab, train_slab)):
        entries += contract_serve(k1_cases, hs_cases, slab_cases, sv,
                                  tc_cases)
        entries += contract_train(k2_cases, hs_cases, slab_cases, tr,
                                  tc_cases)
    entries += contract_resident(k4_cases, train_res)
    entries += contract_w(kw_cases, serve_w, train_w)
    entries += contract_fp32(k4_cases, kw_cases, resident_child, w_child)
    entries += contract_fp32_w1(serve_fp32, train_fp32, tc_cases)
    entries += contract_serve(k1_cases, hs_cases, slab_cases,
                              serve_large_fp32, tc_cases, "float32")
    entries += contract_train(k2_cases, hs_cases, slab_cases,
                              train_large_fp32, tc_cases, "float32")
    entries += contract_serve(k1_cases, hs_cases, slab_cases,
                              serve_slab_fp32, tc_cases, "float32")
    entries += contract_train(k2_cases, hs_cases, slab_cases,
                              train_slab_fp32, tc_cases, "float32")
    entries += contract_mxu(mxu_cases, train_mxu)
    entries += contract_k3(k2_cases, train_split)
    entries += contract_k3(slab_cases, train_split, slab=True)
    entries += contract_models(model_cases, k2_cases, completion, glpdepth)
    # the training loop's own launches (tools.train: 6 steps, 16 held-out
    # forwards), at the shapes and with the numbers of the train / serve
    # entries
    for e in (contract_train(k2_cases, hs_cases, slab_cases,
                             loop_rec["_train"], tc_cases)
              + contract_serve(k1_cases, hs_cases, slab_cases,
                               loop_rec["_serve"], tc_cases)):
        e["path"] = "loop (tools.train, 2 epochs; validation)"
        entries.append(e)
    entries += tool_entries + roof_entries
    print(json.dumps({"kernels": entries}), flush=True)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    emit("phase_seconds", PHASE_SECONDS)
    emit("total_seconds", round(time.time() - t_start, 1))
    print(smi.splitlines()[0], flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
