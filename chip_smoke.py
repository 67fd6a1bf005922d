"""Drive the PyTorch port's main path once on a CUDA card, and check it.

    python3 chip_smoke.py

Phases, each ending in torch.cuda.synchronize(); any failure raises and the
exit code is not 0:
  1. device: require CUDA, print the card's name and power limit, turn
     TF32 off for convolutions and matrix products;
  2. build the CUDA kernels from tdanet_tpu_torch/csrc and, beside them,
     the native batch loader from tdanet_tpu_torch/native/loader.cc (g++),
     and meanwhile count the MACs audio_train prints for the configs of
     phases 16 and 23;
     print the registers of every kernel, and the occupancy figure and
     the grid of dw_conv_glob_ln's cooperative launch at each site shape;
     print the backward kernel's plan at the recipe's K5 stride-1 sites (grid,
     slots, shared memory, the planned share of tiles staged again);
  3. dw_conv_glob_ln against its plain PyTorch version at every main-path
     site shape, B 1 and 4, in the model's (B, C, T) layout and in
     (B, T, C): fp32, bf16 with bf16 and with fp32 parameters; a second
     run equal bit for bit, and a CUDA-graph replay equal to the eager
     call; the chunked entry;
  4. serve: a full-width TDANetBest (out 128, in 512, 16 blocks, depth 5,
     4 ms encoder, 2 sources, 16 kHz) with seeded random weights is saved
     in the reference checkpoint schema, loaded with from_pretrain, moved
     to the card, and answers three ``separate`` requests and one
     ``separate_batched`` call; the kernel's launch count must rise by
     32 x 16 per forward;
  5. agreement of the card's fp32 output with the same model in float64
     on the CPU through the plain path;
  6. times from CUDA events: dw_conv_glob_ln against plain at every site
     shape (B 1 fp32), at the finest K5 stride-1 site B 4 fp32 and B 24
     bf16, summed over one forward's 512 sites beside their bound; the
     forward, eager and replayed from one CUDA graph, and profiled: 512
     device kernels of dw_conv_glob_ln, and their device time;
  7. the two UConvBlock-half kernels (pyramid_fused, fuse_expand_fused)
     against their plain versions at full width (T 2010, C_out 128, C 512,
     depth 5), B 1 and 4 (fp32 with TF32 off, and bf16) and B 24 bf16, and
     at two ragged shapes (T 1999 depth 5, T 1001 depth 4): every output,
     pad rows included; a second run equal bit for bit and a CUDA-graph
     replay equal to the eager call (probes/uconv_halves.py);
  8. the fused block path (pyramid_fused -> GA -> fuse_expand_fused),
     with its launch counts set to 0 just before: one block against
     UConvBlock.forward at B 1 and 4 (fp32), and 20 chained blocks against
     20 module blocks at B 24 in bf16 and B 1 in fp32; each wrapper's
     count must rise by exactly 1 per block;
  9. times: each half-block kernel alone against its plain version (B 1
     and 4 fp32, B 24 bf16), its device kernels per call and a per-launch
     profile, each half's bound at the three cases; ms/block of the
     module, hybrid and fused blocks (B 1 fp32, B 24 bf16), eager and
     replayed from a CUDA graph, and a profile of the fused block.
  10. the window kernels (roll_and_window_partition, window_merge_and_roll)
     against their plain versions at the seven site shapes of Swin-UNet
     tiny, B 1, 2 (the Swin path's batch) and 8, fp32, bf16 and fp64:
     bit-exact, with the round trip and the gradients through each
     autograd Function;
  11. the Swin path, with its launch counts set to 0 just before: a
     full-width SwinTransformerSys (img 224, patch 4, embed 96, depths
     (2, 2, 2, 2), heads (3, 6, 12, 24), window 7) with seeded weights,
     B 2 fp32, three forwards and two forward-and-backward steps of a
     mean-of-squares loss; each window kernel must launch exactly 14 times
     per forward and 28 per forward + backward; output and two gradients
     against the same model in float64 on the CPU; one SwinTransformer
     classifier forward (12 launches each);
  12. every micro-kernel of the two op probes against its plain version at
     (24, 2032, 512) bf16, the products' SNR printed, and the count of
     wgmma (HGMMA) instructions in the built micro-kernel and UConvBlock
     libraries, none of which may be 0;
  13. times: the window kernels against plain, the Swin forward and
     forward + backward, and, with their launch counts set to 0 just
     before, the two probes through their entry points.
  14. the backward kernel of dw_conv_glob_ln against its plain backward at
     the 20 site shapes of the training recipe's block (8 kHz, 3 s):
     bf16 activations over fp32 parameters at B 8 (SNR of dx, dweight,
     dbias, dgamma, dbeta >= 40 dB against plain in fp32 on the same
     bf16-rounded values) and fp32 at B 2 (max abs <= 1e-4 max abs of
     plain); a rerun equal bit for bit and a CUDA-graph replay equal to
     eager (probes/dw_backward.py);
  15. gradients of the recipe's model at full width (out 128, in 512,
     depth 5, 4 ms, 8 kHz, 2 sources, seeded weights) and 4 of its 16
     blocks (a cut for the time limit: the CPU float64 step), B 2, 1 s,
     fp32, stochastic layers off, PIT neg-SNR: every parameter's gradient
     against the same model in float64 on the CPU through the plain path,
     taken at the card step's side of every activation kink (SNR >= 50
     dB); #1's launches per step exactly 128 forward / 116
     backward without checkpointing, 256 / 116 with full checkpointing
     and 232 / 116 under remat "scales" (the coarsest LA fusion's 3 sites
     a block never reach the loss: "scales" skips them, and recomputes
     each live site once); with dropout on, the gradients under full
     checkpointing and under "scales" agree with those without (SNR >= 60
     dB);
  16. the training CLI from a corpus on disk, with the launch counts set
     to 0 just before: synthetic tone-plus-noise data (16 train, 8
     validation utterances of 3.5 s at 8 kHz) written with the port's
     write_wav as a LibriMix tree ({split}/{mix_clean,s1,s2}/*.wav), its
     manifests built by the port's preprocess_dataset (held row for row),
     configs/tdanet.yml read by the port's parser with overrides (the
     manifest dirs, 2 epochs, an experiment dir under a temp dir),
     tdanet_tpu_torch.audio_train.main at full width, B 8, 3 s, bf16,
     remat "scales" (the trainer's default), every batch from the native
     loader; #1's launches over the run exact (928 / 464 a step, 512 a
     validation batch); the batches the native loader delivered counted
     and each held bit for bit against the loader's draws in plain Python
     (native_loader.plain_batches); the history, best_model.pth
     (from_pretrain gives the trained best model's forward) and a resume
     that runs one more epoch; then 20 steps on one fixed batch, whose
     last loss must be below the first;
  17. times: the backward kernel against its plain version at the finest
     site (B 8 bf16, B 2 fp32) and at each of the 14 site shapes a step
     runs (us, GB/s, share of the bound, planned share staged twice), summed
     over a step's 464 launches, beside the bound; the train step under
     each checkpoint policy, none, full and "scales"
     (probes/train_remat.py): the median of 5 after 2 warm-up steps, its
     peak allocated memory, #1's launches a step held exact, and one
     profiled step (device ms, device kernels, #1's kernels held to the
     launches), with the copies of dy the autograd Function made in it.
  18. the corpus eval (probes/eval_path.py) on phase 16's trained
     best_model.pth: 24 synthetic utterances of 2.4-6 s from three cells of
     the stride lattice (11, 8, 5); first #1 against plain at every site
     of the three bucket lengths at 1-8 rows (fp32, (B,C,T), phase 3's
     limit); then tdanet_tpu_torch.audio_test.main as a stream (batch 8),
     a loop (batch 1), at --num_blocks 8, and progressively
     (--progressive_depth 8 at thresholds 0, inf and the median delta),
     each from a launch count of 0, each run's #1 sites all among those
     checked: every metrics.csv 24 rows + avg, std, finite; stream against
     loop (estimates >= 60 dB, metrics within 0.01 dB), progressive at 0
     against the stream, at inf against depth 8, and at the median each
     utterance against the stream (escalated) or depth 8 (>= 60 dB); #1's
     launches exactly 32 x the block iterations of each run's batches; the
     shortest utterance against CPU float64 (>= 60 dB, SI-SNRi within
     0.01 dB; the longest's 23 s of CPU cut for the time limit); wall
     times, realtime factors, the stream's time split and
     the progressive census printed;
  19. long-form CSS: #1 against plain at every site of a 4 s segment at
     1-8 rows; tdanet_tpu_torch.audio_test_css.main on two recordings of
     about 30 s and 47 s, 4 s segments, overlap 0.25, plain and
     progressive (depth 8, at the median of stage 1's segment deltas):
     every stream of its input's length, each run's #1 sites among those
     checked, #1's launches
     exactly 32 x the block iterations of the batches of 8 segments (stage
     2's from the escalations stage 1's deltas predict), the first 2 of
     the 10 segments of the plain run's 30 s recording against float64
     stitching on the CPU (the same swap decision, >= 60 dB; the other 8
     cut for the time limit), the plain run against stitching of its segments
     separated again on the card (>= 100 dB) and the progressive run
     against stitching of its segments at full depth where escalated, else
     at depth 8 (>= 60 dB); the realtime factor printed.
  20. the serving engines (probes/serve_path.py) on phase 4's checkpoint,
     loaded again with from_pretrain onto the card, each forward shape a
     CUDA graph: first #1 against plain at every site the forwards of
     phases 20 and 21 run (fp32 to phase 3's limit, bf16 >= 40 dB); then,
     with #1's launch counts set to 0 and its call sites recorded:
     StreamingSeparator (a 7.3 s mixture in ragged chunks against
     stitch_segments, >= 60 dB, the input's length), MultiStreamSeparator
     (4 streams against the StreamingSeparator, >= 60 dB; bf16 with int16
     emission, each graph forward against the eager one, >= 60 dB, and
     against fp32 printed), AsyncBatchServer (the ladder 8/16/24 with four
     length buckets: 48 requests of 1-4 s from 8 client threads, then 48
     at once; each against separate_batched, >= 60 dB; the rung grows;
     then 48 of one bucket go through a grown rung's graphs, no background
     build failed; the graph pool's size), a 1 ms deadline (some shed, the
     rest answered), close and a malformed submit; #1's wrapper launches
     exactly 2 x 512 per graph (set-up and capture), its sites all among
     those checked, and in one profiled window the device kernels named
     dw_conv_glob_ln exactly 512 per replay;
  21. serving times, #1's sites recorded and all among those phase 20
     checked, every request answered: MultiStream per-hop p50/p90/p99 at
     1, 4 and 8 streams (bf16, int16) beside the eager hop;
     AsyncBatchServer's closed loop (2 s clips, fp32 and bf16, max_batch 8
     and the ladder to 24), its open loop at 50% and 90% of saturation,
     the forward eager and replayed; a lone 2 s request's latency; the
     device's busy share.
  22. the TDANet variant family (probes/variants.py), from #1's launch
     counts at 0: the eleven classes at configs/tdanet_origin.yml's widths
     (16 blocks, depth 5) at 16 kHz, seeded weights through a .pth and
     from_pretrain; each model's sites found on the plain path and held
     against plain first (phase 3's limit), then ``separate`` on a 2 s
     clip through #1, its sites recorded and all checked, #1's launches
     exactly 17 x 16 a forward (13 x 16 for TDANetULayerNum), the output
     against the card's plain path >= 60 dB (the classes' B=1 CPU
     float64 forwards are cut for the time limit); TDANetYang also at
     B=2 without per_utterance against float64 on the CPU >= 60 dB,
     through the inference CLI, and in
     a profiled window of graph replays (#1's device kernels 272 a
     replay);
  23. the family's training: audio_train on configs/tdanet_origin.yml
     (TDANetOrigin, B 8, 3 s, bf16, remat "scales") on phase 16's data, 2
     epochs and a resume, #1's forward and backward launches exact over
     the run and per step (544, 272: the inject block's fusions hold no
     site, so "scales" recomputes every site once, as full checkpointing
     does); TDANetYang's gradients at 4 of its 16 blocks (B 2, 1 s,
     fp32) against CPU float64 at the card's kinks >= 50 dB, launches per
     step exact under each checkpoint policy; times: TDANetYang's
     forward (B 1, 2 s, fp32) eager and replayed with #1's share of
     device time, the train step (B 8, 3 s, bf16) of TDANetOrigin under
     remat "scales" and TDANetYang without, as audio_train builds each;
     every site the phase launched #1 at (training, validation,
     gradients, timed runs) recorded and held against plain, forward and
     backward.
  24. the EMCAD-era family (probes/era.py), from #1's launch counts at 0:
     the 22 classes of models/tdanet_emcad.py at configs/tdanet_origin.yml's
     widths (16 blocks, depth 5) at 16 kHz, feat_len for a 2 s clip,
     seeded weights through a .pth and from_pretrain; each model's sites
     (with their channels and eps) found on the plain path and held
     against plain first, then ``separate`` on a 2 s clip through #1,
     #1's launches exactly the class's sites x 16 a forward (22 x 16 for
     TDANetEMCADv1_6); TDANetEMCADv1_6 against float64 on the CPU at 4
     of its 16 blocks (>= 90 dB; the 16-block CPU forward cut for the time
     limit), the other 21 at 2 blocks (the same .pth) against
     the card's plain path (>= 60 dB; no CPU float64 reference, for the
     script's time limit);
     TDANetEMCADv1_6's forward eager and replayed, and a profiled window
     of replays (#1's device kernels 352 a replay, its share, the top
     kernels);
  25. the EMCAD-era family's training: TDANetEMCADv1_6's gradients at the
     recipe's widths and 4 of its 16 blocks (B 2, 1 s, fp32) against CPU
     float64 at the card's kinks >= 50 dB, launches per step exact under
     each checkpoint policy; #1 at every site's own operands of that step
     against float64, within 6 dB of its plain version; audio_train on
     configs/tdanet.yml with the model swapped (a config in the temp dir
     with feat_len for 3 s) on phase 16's data, 2 epochs and a resume,
     #1's forward and backward launches exact over the run (the era block
     has no landmark stages, so "scales" checkpoints it whole); the train
     step (B 8, 3 s, bf16, checkpointing) timed with its peak memory and
     launches; every site the phase launched #1 at held against plain,
     forward and backward, at its channels and eps.
  26. deployment bundles (probes/deploy_path.py), from #1's launch counts
     at 0: five exports at once through the CLI (python -m
     tdanet_tpu_torch.export_bundle, a subprocess each): phase 4's bench
     model at 2.0 s, batch 8, early exit 8, the progressive pair at depth 8
     and a 1 s x 4-stream streaming program, and again in bf16;
     TDANetYang and TDANetEMCADv1_6 at configs/tdanet_origin.yml's widths
     and 2 blocks; phase 16's model at every length of phase 18's corpus.
     The bench bundle served in a fresh interpreter that must not import
     tdanet_tpu_torch.models (probes/deploy_serve.py): 8 utterances of 2 s
     against separate_batched on the model (>= 60 dB; the model itself
     is held against CPU float64 in phase 5); E8 against separate_batched
     at depth
     8, the progressive pair at thresholds 0, inf and the median delta
     against separate_progressive (and its census), load_streaming on 4
     streams against the model's MultiStreamSeparator (>= 60 dB, each of
     its input's length); #1 inside every program: op nodes exactly 512
     (T, S) and 256 (E8, each stage), wrapper launches 2 x the nodes at
     each set-up (a forward and a capture) and none in replays, and the
     profiler's #1 device kernels per replay exactly the nodes; the bf16
     bundle against separate_batched(compute_dtype=bf16), both on cuDNN's
     deterministic algorithms (>= 120 dB; the default algorithms' run-to-
     run spread and bf16 against fp32 printed beside it), and the two
     family bundles against their models' separate (>= 60 dB; 512, 34 and
     44 nodes); audio_test --bundle on phase 18's corpus, every metric
     within 0.01 dB of the model-code stream; times: the bundle's B=8
     2 s replay beside the model's, its load-to-first-result seconds, and
     the eager B=1 2 s forward with #1 through the registered op and
     called directly, in turns.
  27. data parallelism (probes/dp_path.py) at the recipe's full width:
     first #1 forward (fp32; bf16 at (c)'s sites) and its backward
     against plain at every site shape of the phase; then (a) an NCCL
     process group of one rank in this process: a train step under the
     mesh against one without (B 4, 1 s, fp32, dropout on, the same
     seeds), every gradient >= 100 dB, #1's launches 512 / 464; (b) two
     ranks on the one card over gloo through launch_multihost (global B
     4, 2 a rank, the same rows and seeds): the loss equal on both ranks,
     the parameters after the step equal bit for bit, #1's launches 512 /
     464 a rank, every gradient against (a)'s one-process step >= 90 dB
     as it stands and >= 100 dB with each activation's side pinned to
     that step's (train_step.Kinks; the flipped elements printed), two
     broken controls (the attention's gather made the identity; masks
     drawn per rank) below both, each rank's step ms beside the
     one-process step's; (c)
     launch_multihost --nprocs 2 -- audio_train on configs/tdanet.yml
     (global B 8, bf16, remat "scales") over phase 16's utterances, one
     epoch: both ranks' history rows equal, #1's launches on each rank
     exact (928 / 464 a step, 512 a validation batch), one best_model.pth
     whose forward equals rank 0's best checkpoint's (1e-6 of max abs);
     (d)
     audio_test --dp 2 over [cuda:0, cuda:0] on phase 18's corpus
     against --dp 1 (every metric within 0.01 dB, #1's launches twice),
     and AsyncBatchServer(mesh=...) on 12 requests of 1-4 s against the
     server without a mesh (>= 60 dB each; 2 x 512 launches a graph, one
     graph a replica and bucket); the phase's seconds.
  28. the studies on phase 16's best_model.pth (probes/studies.py): the
     convergence-corpus generator at n_train 16 (dev and tt 100 each), one
     native-loader batch of it equal to the plain draws; early exit,
     progressive depth and 8-bit activation storage through their mains
     at n 8, batch 8, bf16, short timing loops: every printed line with
     its keys and finite values, #1's launches exactly 32 a block
     iteration of the study's forwards (from 0 before each); #1 against
     plain at every site they ran (bf16 over fp32 parameters, >= 40 dB);
     store_activation on the card equal to the CPU bit for bit (fp32,
     bf16; int8, fp8_e4m3 with its NaN past 464, fp8_e5m2).
  29. every optimizer name, the AV loader and an n_src=6 step
     (probes/train_options.py), from #1's launch counts at 0: (a) the 32
     names of the optimizer factory, 3 steps each from the recipe model's
     parameters (16 blocks at full width) with the gradients of one
     backward (B 2, 1 s, fp32), -0.5 of them and a seeded permutation,
     the learning rate halved before the third, clip 5, against the same
     code in float64 on the CPU: the parameter change's SNR within 10 dB
     of the floor that fp32 storage sets for each name, Lion's sign flips
     at most 1e-5 of the elements; (b) each name's step() ms on the 2.34 M
     parameters (median of 5 after 2) and its device kernels in a profiled
     step held by #1 marks through counted_windows; (c) audio_train on
     phase 16's corpus with optimizer.optim_name=adafactor, one epoch and
     a resume for another: the loaded optimizer state equal to the saved
     one bit for bit, finite losses, #1's launches phase 16's a step and
     a validation batch; (d) a 6-source TDANetBest at 4 blocks (recipe
     widths), B 2, 1 s, fp32: the Hungarian assignments equal CPU
     float64's, the loss within 1e-3 dB, every gradient >= 50 dB at the
     card's kinks, the train step's ms; (e) an audio-visual split written
     here (stored and deflated float32 archives, stored uint8; 88 x 88
     mouth frames): every native AV batch equal to the dataset's items and
     the plain draws, a garbled archive raising with its path; and
     scripts.profile_train (scales, adafactor, 2 steps) on the card.
Every phase header prints the seconds since the script started.
The kernels are built at first use from tdanet_tpu_torch/csrc, all sources
at once in phase 2. The last two lines are the kernels' JSON record and
the result line.
"""

import contextlib
import copy
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from tdanet_tpu_torch.datas import native_loader, preprocess_dataset
from tdanet_tpu_torch.datas.native_loader import NativeLoader, plain_batches
from tdanet_tpu_torch.kernels import _build, micro_ops
from tdanet_tpu_torch.kernels.dw_conv_glob_ln import (
    dw_conv_glob_ln, dw_conv_glob_ln_chunked,
    dw_conv_glob_ln_reference)
from tdanet_tpu_torch.kernels.uconv_block import (
    fuse_expand_fused, kernels_per_call, pyramid_fused, scale_lengths, to_raw)
from tdanet_tpu_torch.kernels.window_process import (
    roll_and_window_partition, roll_and_window_partition_reference,
    window_merge_and_roll, window_merge_and_roll_reference)
from tdanet_tpu_torch.models import (
    BaseModel, SwinTransformer, SwinTransformerSys, TDANetBest)
from tdanet_tpu_torch.kernels import dw_conv_glob_ln as dw
from tdanet_tpu_torch.probes import (
    deploy_path, dp_path, dw_backward, dw_sites, era, eval_path, hybrid,
    mosaic_ops, mosaic_ops2, serve_path, studies, train_options,
    train_remat, train_step, uconv_halves, uconv_kernel, variants)
from tdanet_tpu_torch.probes.dw_sites import SCALES, VARIANTS, site_inputs
from tdanet_tpu_torch.probes.train_step import tone_mix
from tdanet_tpu_torch.utils import separate, separate_batched
from tdanet_tpu_torch.utils.timing import (
    bound_ms, card_line, counted_windows, cuda_time, graph_time, nbytes,
    profiled, snr_db)

CFG = dict(out_channels=128, in_channels=512, num_blocks=16,
           upsampling_depth=5, enc_kernel_size=4, num_sources=2,
           sample_rate=16000)
SITES_PER_BLOCK = 32  # 5 pyramid stages + 5 LA x 3 + 4 LA x 3
DEAD_PER_BLOCK = 3    # the coarsest LA fusion's sites: no backward
C = 512
REQUEST_SECONDS = (1.0, 2.0, 2.7)
SOURCES = ("dw_conv_glob_ln", "dw_conv_glob_ln_backward", "uconv_pyramid",
           "uconv_fuse_expand", "window_process", "micro_ops")
UCONV = dict(T=2010, Cout=128, depth=5)  # C as above: the bench's block
CHAIN = 20
# Swin-UNet tiny's window sites (H = W, C, shift), window 7: two blocks per
# resolution, the second shifted, except at 7 x 7 (one window, no shift)
WINDOW = 7
WINDOW_SITES = ((56, 96, 0), (56, 96, 3), (28, 192, 0), (28, 192, 3),
                (14, 384, 0), (14, 384, 3), (7, 768, 0))
SWIN_BLOCKS = 14      # SwinTransformerSys: 8 encoder + 6 decoder blocks
CLASSIFIER_BLOCKS = 12  # SwinTransformer, depths (2, 2, 6, 2)
SWIN_BATCH = 2
# the training recipe, configs/tdanet.yml, at full width
RECIPE = train_step.RECIPE
TRAIN_UTTERANCES, VALID_UTTERANCES = 16, 8  # 2 and 1 batches of 8
FIXED_STEPS = 20
TRAIN_BATCH = 8  # the recipe's batch, timed under each checkpoint policy
# phase 15's depth: the CPU float64 step of 16 blocks took 46-73 s, so it
# runs 4 (the sites a block are the same; phases 16 and 17 hold the
# 16-block step's launches)
GRAD_BLOCKS = 4


T_START = time.perf_counter()


def count_training_macs():
    """audio_train's parameter and MAC line for the configs phases 16 and
    23 train, while phase 2's builds run: audio_train keeps each count by
    model and config, so those runs find it made."""
    from tdanet_tpu_torch import audio_train, models
    from tdanet_tpu_torch.utils.parser import parse_config
    t0 = time.perf_counter()
    for conf in ("configs/tdanet.yml", variants.TRAIN_CONF):
        config = parse_config(["--conf_dir", conf])
        net = config["audionet"]
        model = models.get(net["audionet_name"])(
            sample_rate=config["datamodule"]["data_config"]["sample_rate"],
            **net["audionet_config"])
        print(f"  {conf}: {audio_train.model_size(model, config)}")
    print(f"  MACs counted in {time.perf_counter() - t0:.1f} s of host time "
          f"while the sources build")


def build_loader():
    """The native batch loader's library: (path, g++ seconds)."""
    t0 = time.perf_counter()
    so = native_loader.build_library()
    return so, time.perf_counter() - t0


def phase(name):
    print(f"== {name} (at {time.perf_counter() - T_START:.1f} s)",
          flush=True)


def check_site(x, params, stride, K):
    """dw_conv_glob_ln against its plain version on one site's operands:
    fp32 max |d| <= 1e-4 max |ref|; bf16 x with bf16 and with fp32
    parameters (plain in fp32 on the same values) SNR >= 40 dB; a second
    run equal bit for bit; x's layout kept. Returns (fp32 max |d|, its
    limit, the two SNRs)."""
    kw = dict(stride=stride, K=K)
    got = dw_conv_glob_ln(x, *params, **kw)
    again = dw_conv_glob_ln(x, *params, **kw)
    ref = dw_conv_glob_ln_reference(x, *params, **kw)
    err = (got - ref).abs().max().item()
    lim = 1e-4 * ref.abs().max().item()
    x16 = x.bfloat16()
    snrs, same = [], torch.equal(got, again)
    for ps in ([None if p is None else p.bfloat16() for p in params],
               params):
        got16 = dw_conv_glob_ln(x16, *ps, **kw)
        same = same and torch.equal(got16, dw_conv_glob_ln(x16, *ps, **kw))
        ref16 = dw_conv_glob_ln_reference(
            x16.float(), *[None if p is None else p.float() for p in ps],
            **kw)
        snrs.append(snr_db(ref16, got16))
    inner = 1 if x.stride(1) == 1 else 2
    if got.stride(inner) != 1 or got16.stride(inner) != 1:
        raise AssertionError(f"output layout {got.stride()} for x "
                             f"{x.stride()}")
    if not (err <= lim and min(snrs) >= 40.0):
        raise AssertionError(f"kernel disagrees with plain: {err} {snrs}")
    if not same:
        raise AssertionError("a second run differs from the first")
    return err, lim, snrs


def graph_equals_eager(x, params, stride, K):
    """One call captured in a CUDA graph: its replay must give the eager
    output bit for bit."""
    call = (lambda: dw_conv_glob_ln(x, *params, stride=stride, K=K))
    eager = call()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        call()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = call()
    graph.replay()
    torch.cuda.synchronize()
    if not torch.equal(out, eager):
        raise AssertionError(f"graph replay differs from eager at "
                             f"{tuple(x.shape)} K={K} s={stride}")


def dev_us(event):
    """A profiler average's self device time in us."""
    return event.self_device_time_total


# (B, dtype, T, depth) of phase 7: the request and the bench batch at full
# width, and two ragged lengths
HALF_CASES = ((1, torch.float32, 2010, 5), (1, torch.bfloat16, 2010, 5),
              (4, torch.float32, 2010, 5), (4, torch.bfloat16, 2010, 5),
              (24, torch.bfloat16, 2010, 5), (3, torch.float32, 1999, 5),
              (2, torch.bfloat16, 1001, 4))


def check_halves():
    """Both kernels against their plain versions on the same inputs, every
    output with its pad rows (fp32 max |d| <= 2e-3 max |ref|, bf16 SNR >=
    30 dB), a rerun equal bit for bit, a graph replay equal to eager
    (probes/uconv_halves.py). Returns each kernel's largest fp32 max |d|
    and lowest bf16 SNR."""
    worst = {n: 0.0 for n in uconv_halves.NAMES}
    low = {n: float("inf") for n in uconv_halves.NAMES}
    for B, dtype, T, depth in HALF_CASES:
        for name, v in uconv_halves.check(B, dtype, seed=B, T0=T,
                                          depth=depth).items():
            if dtype == torch.float32:
                worst[name] = max(worst[name], v)
            else:
                low[name] = min(low[name], v)
    torch.cuda.synchronize()
    return worst, low


def count_blocks(fn, n):
    """Run fn, which makes n fused blocks; each wrapper must have launched
    exactly n times."""
    before = (pyramid_fused.launches, fuse_expand_fused.launches)
    out = fn()
    torch.cuda.synchronize()
    got = (pyramid_fused.launches - before[0],
           fuse_expand_fused.launches - before[1])
    if got != (n, n):
        raise AssertionError(f"{got} launches of (pyramid_fused, "
                             f"fuse_expand_fused) for {n} blocks")
    return out


def drive_fused_path(gen):
    """The fused block path against the module block; returns each
    wrapper's launches in this phase."""
    T, Cout, depth = UCONV["T"], UCONV["Cout"], UCONV["depth"]
    pyramid_fused.launches = fuse_expand_fused.launches = 0
    with torch.inference_mode():
        for B in (1, 4):
            block = uconv_kernel.seeded_block(Cout, C, depth, seed=10 + B)
            block = block.cuda()
            x = torch.randn(B, Cout, T, generator=gen).cuda()
            got = count_blocks(lambda: uconv_kernel.fused_block(block, x), 1)
            want = block(x)
            snr = snr_db(want, got)
            print(f"one fused block B={B} fp32 vs UConvBlock.forward: "
                  f"SNR {snr:.2f} dB (limit 60), finite "
                  f"{bool(torch.isfinite(got).all())}")
            if not (snr >= 60.0 and torch.isfinite(got).all()):
                raise AssertionError("fused block disagrees with the module")
        for B, dtype in ((24, torch.bfloat16), (1, torch.float32)):
            block = uconv_kernel.seeded_block(Cout, C, depth, seed=0).cuda()
            x = torch.randn(B, Cout, T, generator=gen).cuda().to(dtype)
            snr, err = count_blocks(
                lambda: uconv_kernel.compare_chain(block, x, CHAIN), CHAIN)
            print(f"{CHAIN} chained fused blocks B={B} {str(dtype)[6:]} vs "
                  f"{CHAIN} module blocks: SNR {snr:.2f} dB (limit 40), max "
                  f"abs {err:.4e}")
            if not snr >= 40.0:
                raise AssertionError("fused chain disagrees with the module")
    torch.cuda.synchronize()
    launches = {"pyramid_fused": pyramid_fused.launches,
                "fuse_expand_fused": fuse_expand_fused.launches}
    print(f"launches in this phase: {launches}")
    return launches


def time_halves():
    """Each kernel alone against its plain version (B 1 and 4 fp32, B 24
    bf16) with its device kernels per call and a per-launch profile
    (probes/uconv_halves.py), then the blocks' ms and a profile of the
    fused block at B 24 bf16. Returns {case: {name: row}}."""
    cases = {}
    with torch.inference_mode():
        for B, dtype in uconv_halves.CASES:
            cases[(B, dtype)] = uconv_halves.time_case(B, dtype)
        # the profiler may drop events (a count a little below the true
        # one); it never invents kernels
        want = kernels_per_call(UCONV["depth"])
        for name in uconv_halves.NAMES:
            got = [r[name]["kernels"] for r in cases.values()]
            if max(got) != want:
                raise AssertionError(f"{name}: {got} device kernels per call"
                                     f", expected {want}")
        for B, dtype in ((1, torch.float32), (24, torch.bfloat16)):
            block, x = uconv_kernel.setup(B, dtype)
            rows = {**hybrid.time_blocks(block, x),
                    **uconv_kernel.time_blocks(block, x)}
            for name, (g_ms, e_ms) in rows.items():
                print(f"{name} B={B} {str(dtype)[6:]}: {g_ms:.3f} ms/block "
                      f"CUDA graph, {e_ms:.3f} ms/block eager")
        x_raw = to_raw(x)
        kernels, rows, memsets = uconv_halves.profile_call(
            lambda: uconv_kernel.fused_block_raw(block, x_raw, UCONV["T"]),
            n=5)
        print(f"profiled fused block B=24 bf16: {kernels:g} device kernels "
              f"and {memsets:g} memsets, {sum(r[2] for r in rows) / 1e3:.3f}"
              f" ms device time, per block")
        for key, count, us in rows[:12]:
            print(f"  {us / 1e3:8.3f} ms {count:5.2f}x {key[:90]}")
    torch.cuda.synchronize()
    return cases


def params_bytes(*modules):
    return sum(nbytes(*m.parameters()) for m in modules)


def uconv_bounds(B, dtype):
    """The card's bound for each UConvBlock half from this run's operands:
    every input and parameter read once, every output written once,
    against the operations of the 1x1 product (fp32 on the SIMT cores,
    bf16 on the tensor cores) and of the depthwise taps (fp32)."""
    T, Cout, depth = UCONV["T"], UCONV["Cout"], UCONV["depth"]
    Ts = scale_lengths(T, depth)
    block, x_raw, scales, g = uconv_halves.half_inputs(B, dtype, seed=1)
    with torch.inference_mode():
        got_s, got_g = pyramid_fused(x_raw, block, depth=depth, raw=True,
                                     raw_in=True, T0=T)
        out = fuse_expand_fused(scales, g, x_raw, block, Ts=Ts)
    product = 2.0 * B * T * Cout * C
    taps = sum(2.0 * 5 * B * t * C for t in Ts)
    la = sum(2.0 * 3 * B * t * C for t in Ts) + 3 * taps
    peak = "bf16" if dtype is torch.bfloat16 else "fp32"
    halves = {
        "pyramid_fused": (
            nbytes(x_raw, *got_s, got_g)
            + params_bytes(block.proj_1x1, block.spp_dw), taps),
        "fuse_expand_fused": (
            nbytes(x_raw, g, out, *scales)
            + params_bytes(block.loc_glo_fus, block.last_layer,
                           block.res_conv), la)}
    result = {}
    for name, (n_bytes, simt) in halves.items():
        by_bytes = bound_ms(n_bytes)[0]
        by_ops = bound_ms(0, product, peak)[0] + bound_ms(0, simt)[0]
        result[name] = max((by_ops, "operations"), (by_bytes, "bytes"))
        print(f"{name} B={B} {str(dtype)[6:]}: {n_bytes / 1e6:.2f} MB -> "
              f"{by_bytes * 1e3:.2f} us by bytes; {product / 1e9:.3f} GFLOP "
              f"of {peak} product and {simt / 1e9:.3f} GFLOP of taps -> "
              f"{by_ops * 1e3:.2f} us by operations; bound "
              f"{result[name][0] * 1e3:.2f} us ({result[name][1]})")
    return result


def check_windows(gen):
    """Both window kernels against their plain versions, bit for bit, at
    every site shape; the round trip; the gradients through each autograd
    Function. Returns the largest abs difference seen (0)."""
    worst = 0.0
    for B in (1, SWIN_BATCH, 8):  # SWIN_BATCH: the Swin path's own shapes
        for H, Cw, shift in WINDOW_SITES:
            for dtype in (torch.float32, torch.bfloat16, torch.float64):
                x = torch.randn(B, H, H, Cw, generator=gen).to(dtype).cuda()
                x.requires_grad_()
                wins = roll_and_window_partition(x, shift, WINDOW)
                ref = roll_and_window_partition_reference(x, shift, WINDOW)
                back = window_merge_and_roll(wins, shift, WINDOW, H, H)
                back_ref = window_merge_and_roll_reference(ref, shift,
                                                           WINDOW, H, H)
                gx, = torch.autograd.grad(wins.pow(3).sum(), x,
                                          retain_graph=True)
                gx_ref, = torch.autograd.grad(ref.pow(3).sum(), x)
                w = wins.detach().requires_grad_()
                gw, = torch.autograd.grad(window_merge_and_roll(
                    w, shift, WINDOW, H, H).pow(3).sum(), w)
                gw_ref, = torch.autograd.grad(
                    window_merge_and_roll_reference(
                        w, shift, WINDOW, H, H).pow(3).sum(), w)
                pairs = {"partition": (wins, ref), "merge": (back, back_ref),
                         "round trip": (back, x),
                         "partition gradient": (gx, gx_ref),
                         "merge gradient": (gw, gw_ref)}
                for what, (a, b) in pairs.items():
                    worst = max(worst, (a.double() - b.double()).abs().max()
                                .item())
                    if not torch.equal(a, b):
                        raise AssertionError(
                            f"window {what} differs at B={B} H={H} C={Cw} "
                            f"shift={shift} {dtype}")
        print(f"B={B}: {len(WINDOW_SITES)} sites x fp32, bf16, fp64: "
              f"partition, merge, round trip and both gradients bit-exact")
    # a channel count that no 16-byte vector divides, and a strided input
    x = torch.randn(2, 8, 12, 37, generator=gen).bfloat16().cuda()
    for v in (x, x.transpose(1, 2)):
        if not torch.equal(roll_and_window_partition(v, 3, 4),
                           roll_and_window_partition_reference(v, 3, 4)):
            raise AssertionError("window partition differs at C=37")
    print("C=37 bf16 (2-byte vectors), contiguous and transposed: bit-exact")
    torch.cuda.synchronize()
    return worst


def window_counts():
    return (roll_and_window_partition.launches,
            window_merge_and_roll.launches)


def expect_window_launches(fn, n, what):
    """Run fn; each window kernel must have launched exactly n times."""
    before = window_counts()
    out = fn()
    torch.cuda.synchronize()
    got = tuple(a - b for a, b in zip(window_counts(), before))
    if got != (n, n):
        raise AssertionError(f"{got} launches of (roll_and_window_partition, "
                             f"window_merge_and_roll) for {what}, expected "
                             f"{n} each")
    return out


def swin_step(model, x):
    """One forward-and-backward step of a mean-of-squares loss."""
    model.zero_grad(set_to_none=True)
    out = model(x)
    out.square().mean().backward()
    return out


def drive_swin(gen):
    """The Swin path on the card; returns the two kernels' launches on it,
    the model and its input."""
    model = SwinTransformerSys(drop_rate=0.0, attn_drop_rate=0.0,
                               drop_path_rate=0.0)
    model.reset_parameters(torch.Generator().manual_seed(4321))
    model = model.cuda()
    n_params = sum(p.numel() for p in model.parameters())
    x = torch.randn(SWIN_BATCH, 3, 224 * 224, generator=gen).cuda()
    roll_and_window_partition.launches = window_merge_and_roll.launches = 0
    t0 = time.perf_counter()
    with torch.no_grad():
        for _ in range(3):
            out = expect_window_launches(lambda: model(x), SWIN_BLOCKS,
                                         "one forward")
    for _ in range(2):
        out_train = expect_window_launches(
            lambda: swin_step(model, x), 2 * SWIN_BLOCKS,
            "one forward + backward")
    launches = dict(zip(("roll_and_window_partition",
                         "window_merge_and_roll"), window_counts()))
    want_shape = (SWIN_BATCH, 1000, 224 * 224)
    for o in (out, out_train):
        if o.shape != want_shape or not torch.isfinite(o).all():
            raise AssertionError(f"bad Swin output {tuple(o.shape)}")
    print(f"SwinTransformerSys ({n_params / 1e6:.1f} M parameters), input "
          f"{tuple(x.shape)} -> {tuple(out.shape)}: 3 forwards and 2 forward"
          f" + backward steps in {time.perf_counter() - t0:.2f} s (first "
          f"calls included); launches {launches} ({SWIN_BLOCKS} each per "
          f"forward, {2 * SWIN_BLOCKS} per forward + backward)")

    cpu64 = copy.deepcopy(model).cpu().double()
    want = swin_step(cpu64, x.cpu().double())
    checks = [("output", want.detach(), out, 60.0)]
    for name in ("patch_embed.proj.weight",
                 "layers.0.blocks.1.attn.relative_position_bias_table"):
        checks.append((f"gradient of {name}",
                       cpu64.get_parameter(name).grad,
                       model.get_parameter(name).grad, 50.0))
    for what, ref, got, limit in checks:
        snr = snr_db(ref, got.cpu())
        print(f"{what}: card fp32 vs CPU float64 plain path SNR = "
              f"{snr:.2f} dB (limit {limit:.0f})")
        if not snr >= limit:
            raise AssertionError(f"Swin {what} disagrees with the CPU")

    clf = SwinTransformer(drop_path_rate=0.0)
    clf.reset_parameters(torch.Generator().manual_seed(99))
    clf = clf.cuda().eval()
    img = torch.randn(SWIN_BATCH, 3, 224, 224, generator=gen).cuda()
    with torch.no_grad():
        logits = expect_window_launches(lambda: clf(img), CLASSIFIER_BLOCKS,
                                        "one classifier forward")
    if logits.shape != (SWIN_BATCH, 1000) or not torch.isfinite(logits).all():
        raise AssertionError(f"bad classifier output {tuple(logits.shape)}")
    print(f"SwinTransformer (depths (2, 2, 6, 2)) forward {tuple(img.shape)}"
          f" -> {tuple(logits.shape)}: {CLASSIFIER_BLOCKS} launches each")
    torch.cuda.synchronize()
    return launches, model, x


def time_windows_and_swin(gen, model, x):
    """The window kernels against plain (fp32, shift 3), the Swin forward
    (graph replay and eager) and forward + backward (eager). Returns each
    kernel's (kernel ms, plain ms, bound ms, bound by) at the main path's
    largest site, (SWIN_BATCH, 56, 56, 96)."""
    result = {}
    H, Cw, shift = 56, 96, 3
    with torch.inference_mode():
        for B in (1, SWIN_BATCH, 8):
            img = torch.randn(B, H, H, Cw, generator=gen).cuda()
            wins = roll_and_window_partition(img, shift, WINDOW)
            calls = {
                "roll_and_window_partition": (
                    lambda: roll_and_window_partition(img, shift, WINDOW),
                    lambda: roll_and_window_partition_reference(
                        img, shift, WINDOW)),
                "window_merge_and_roll": (
                    lambda: window_merge_and_roll(wins, shift, WINDOW, H, H),
                    lambda: window_merge_and_roll_reference(
                        wins, shift, WINDOW, H, H))}
            bms, by = bound_ms(nbytes(img, wins))
            for name, (kern, plain) in calls.items():
                kg, pg = graph_time(kern), graph_time(plain)
                ke, pe = cuda_time(kern, reps=50), cuda_time(plain, reps=50)
                print(f"{name} ({B}, {H}, {H}, {Cw}) fp32 shift {shift}, us "
                      f"per call, device (graph replay) / eager: kernel "
                      f"{kg[0] * 1e3:.2f} / {ke[0] * 1e3:.2f}, plain "
                      f"{pg[0] * 1e3:.2f} / {pe[0] * 1e3:.2f}; bound "
                      f"{bms * 1e3:.2f} ({by})")
                if B == SWIN_BATCH:
                    result[name] = (kg[0], pg[0], bms, by)
    model.eval()
    with torch.no_grad():
        gms, gruns, _ = graph_time(lambda: model(x), reps=2, runs=7)
        ems, eruns, _ = cuda_time(lambda: model(x), reps=1, runs=7, warmup=2)
    tms, truns, _ = cuda_time(lambda: swin_step(model, x), reps=1, runs=7,
                              warmup=2)
    with torch.no_grad(), profiled() as prof:
        model(x)
    events = [e for e in prof.key_averages()
              if getattr(e, "device_type", None)
              == torch.autograd.DeviceType.CUDA]
    dev_ms = sum(dev_us(e) for e in events) / 1e3
    win = [e for e in events if "window_kernel" in e.key]
    print(f"profiled Swin forward: {sum(e.count for e in events)} device "
          f"kernels, {dev_ms:.3f} ms device time; window kernels "
          f"{sum(e.count for e in win)} launches, "
          f"{sum(dev_us(e) for e in win) / 1e3:.3f} ms")
    for e in sorted(events, key=dev_us, reverse=True)[:8]:
        print(f"  {dev_us(e) / 1e3:8.3f} ms {e.count:4d}x {e.key[:90]}")
    print(f"SwinTransformerSys forward B={SWIN_BATCH} fp32: CUDA graph "
          f"replay {gms:.2f} ms (runs {[round(t, 2) for t in gruns]}), "
          f"eager {ems:.2f} ms (runs {[round(t, 2) for t in eruns]}); "
          f"forward + backward eager {tms:.2f} ms "
          f"(runs {[round(t, 2) for t in truns]})")
    torch.cuda.synchronize()
    return result


def count_hgmma():
    """The wgmma (SASS: HGMMA) instructions in each built library whose bf16
    products run on the tensor cores (the micro-kernels and both UConvBlock
    halves), where the toolkit's ``cuobjdump`` is there to list them: none
    may be 0."""
    tool = shutil.which("cuobjdump") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "cuobjdump")
    if not os.path.exists(tool):
        print("no cuobjdump on this machine: HGMMA not counted")
        return
    for name in ("micro_ops", "uconv_pyramid", "uconv_fuse_expand"):
        so = _build.library_path(name)
        sass = subprocess.run([tool, "-sass", str(so)], capture_output=True,
                              text=True, timeout=120, check=True).stdout
        n = sum("HGMMA" in line for line in sass.splitlines())
        print(f"HGMMA instructions in {os.path.relpath(so)}: {n}")
        if n == 0:
            raise AssertionError(f"the bf16 products of {name} did not reach "
                                 "wgmma")


def drive_probes():
    """The two op probes through their entry points, with every
    micro-kernel's launch count set to 0 just before; returns their
    records. Every variant must have launched its kernel."""
    for w in micro_ops.WRAPPERS:
        w.launches = 0
    records = {"probe_mosaic_ops": mosaic_ops.main([]),
               "probe_mosaic_ops2": mosaic_ops2.main([])}
    torch.cuda.synchronize()
    counts = {w.__name__: w.launches for w in micro_ops.WRAPPERS}
    print(f"launches on the probes' path: {counts}")
    for rows in records.values():
        for row in rows:
            if row["launches"] < 1:
                raise AssertionError(f"{row['name']} never launched")
    if min(counts.values()) < 1:
        raise AssertionError(f"a micro-kernel never launched: {counts}")
    return records


def probe_entry(name, script, line, rows):
    """One kernels-line entry for a probe: sums over its variants;
    ``library_ms`` sums the variants that one PyTorch call computes."""
    library = [r["library_ms"] for r in rows if r["library_ms"] is not None]
    by_ops = sum(r["bound_ms"] for r in rows if r["bound_by"] == "operations")
    total = sum(r["bound_ms"] for r in rows)
    return {
        "name": name, "route": "cuda",
        "source": "tdanet_tpu_torch/csrc/micro_ops.cu",
        "replaces": f"scripts/{script}.py:{line}",
        "launches": sum(r["launches"] for r in rows),
        "max_abs_err": max(r["max_abs_err"] for r in rows),
        "ms": sum(r["ms"] for r in rows),
        "plain_ms": sum(r["plain_ms"] for r in rows),
        "bound_ms": total,
        "bound_by": "operations" if by_ops > total - by_ops else "bytes",
        "library_ms": sum(library) if library else None, "variants": rows}


def print_backward_plans():
    """The backward kernel's plan, from its library, at the recipe's K5
    stride-1 sites, B 8 bf16 (T innermost)."""
    for T in dw_backward.recipe_scales():
        rows = dw.backward_rows(T, 1, True)
        bp = dw.backward_plan(1, 5, 1, True, rows, TRAIN_BATCH, T, C, 0)
        print(f"  backward B={TRAIN_BATCH} T={T} K5 s1 bf16: {rows} rows a "
              f"thread, grid {bp.grid}, {bp.n_tiles} tiles, {bp.max_slots} "
              f"slots of {bp.slot} B, {bp.smem} B of shared memory; planned:"
              f" {100 * (1 - bp.kept / bp.n_tiles):.1f}% of the tiles staged"
              " again in phase 2")


def drive_gradients():
    """Phase 15: the recipe model's gradients at full width and
    ``GRAD_BLOCKS`` blocks on the card against float64 on the CPU, #1's
    launches per step under each checkpoint policy, and checkpointed
    gradients (full and "scales") with dropout on. Returns the lowest
    SNR."""
    model = TDANetBest(**dict(RECIPE, num_blocks=GRAD_BLOCKS))
    model.reset_parameters(torch.Generator().manual_seed(77))
    # the coarsest scale's LA fusion (loc_glo_fus[depth - 1], 3 sites a
    # block) never reaches the loss: the expansion pairs the finer scales
    # (the reference's quirk), so autograd runs no backward there
    return train_step.check_gradients(
        model, SITES_PER_BLOCK * GRAD_BLOCKS,
        dead=DEAD_PER_BLOCK * GRAD_BLOCKS, seed=3)[0]


# phase 16's corpus: (LibriMix split, utterances, seed)
CORPUS_SPLITS = (("train-100", TRAIN_UTTERANCES, 0),
                 ("dev", VALID_UTTERANCES, 1))


def write_corpus(tmp):
    """Phase 16's utterances as a LibriMix tree on disk,
    ``tmp/corpus/{split}/{mix_clean,s1,s2}/utt{i}.wav``, and their
    manifests built by the port's ``preprocess_dataset`` under
    ``tmp/manifests``. Returns the train and validation manifest dirs."""
    corpus = os.path.join(tmp, "corpus")
    manifests = os.path.join(tmp, "manifests")
    for split, n, seed in CORPUS_SPLITS:
        train_step.write_split(os.path.join(corpus, split), n, seed=seed,
                               manifests=False)
    t0 = time.perf_counter()
    preprocess_dataset(corpus, manifests, "librimix")
    dirs = []
    for split, n, _ in CORPUS_SPLITS:
        d = os.path.join(manifests, split)
        for key in ("mix_clean", "s1", "s2"):
            with open(os.path.join(d, f"{key}.json")) as f:
                rows = json.load(f)
            # every wav in file-name order, with its frames
            want = [[os.path.join(os.path.abspath(corpus), split, key,
                                  name), int(3.5 * 8000)]
                    for name in sorted(f"utt{i}.wav" for i in range(n))]
            if rows != want:
                raise AssertionError(f"the {split}/{key} manifest lists "
                                     f"{rows[:2]}..., expected {want[:2]}...")
        dirs.append(d)
    print(f"preprocess_dataset: manifests of {len(CORPUS_SPLITS)} splits x 3 "
          f"channels ({sum(n for _, n, _ in CORPUS_SPLITS)} utterances) in "
          f"{time.perf_counter() - t0:.2f} s")
    return tuple(dirs)


@contextlib.contextmanager
def recorded_batches():
    """Inside, every batch a NativeLoader yields is recorded beside its
    loader's draws: (dataset, batch size, shuffle, seed, epoch, index,
    mixtures, sources)."""
    seen, real = [], NativeLoader.__iter__

    def recording(self):
        epoch = self.epoch
        for b, (mix, src, names) in enumerate(real(self)):
            seen.append((self.ds, self.batch_size, self.shuffle, self.seed,
                         epoch, b, mix.copy(), src.copy()))
            yield mix, src, names
    NativeLoader.__iter__ = recording
    try:
        yield seen
    finally:
        NativeLoader.__iter__ = real


def check_batches(seen):
    """Every recorded batch against the plain draws of its loader's epoch
    (``native_loader.plain_batches``), bit for bit."""
    plain = {}
    for ds, B, shuffle, seed, epoch, b, mix, src in seen:
        key = (id(ds), B, shuffle, seed, epoch)
        if key not in plain:
            plain[key] = list(plain_batches(ds, B, shuffle, seed, epoch))
        want_mix, want_src, _ = plain[key][b]
        if not (np.array_equal(mix, want_mix)
                and np.array_equal(src, want_src)):
            raise AssertionError(f"the native loader's batch {b} of epoch "
                                 f"{epoch} (shuffle {shuffle}) differs from "
                                 f"the plain draws")


def drive_training(tmp):
    """Phase 16: audio_train.main on the recipe from manifests that
    preprocess_dataset built, its batches from the native loader, from
    launch counts of 0; returns #1's (forward, backward) launches in that
    run and the train and validation manifest dirs."""
    tr, cv = write_corpus(tmp)
    NativeLoader.delivered = 0
    with recorded_batches() as seen:
        trainer, resumed, launches = train_step.train_and_resume(
            "configs/tdanet.yml", tr, cv, os.path.join(tmp, "exp"))
    model = trainer.state.model
    if not (model.sm.remat == "scales" and model.sm.landmarked):
        raise AssertionError(f"audio_train ran remat {model.sm.remat}, "
                             f"expected the landmarked \"scales\"")
    steps = len(trainer.datamodule.train_dataloader())
    vals = len(trainer.datamodule.val_dataloader())
    sites = SITES_PER_BLOCK * RECIPE["num_blocks"]
    fwd, bwd = train_step.expected_launches(
        "scales", sites, DEAD_PER_BLOCK * RECIPE["num_blocks"])
    # 2 epochs: a step the first pass and each stage again, a validation
    # batch one forward
    want = (2 * steps * fwd + 2 * vals * sites, 2 * steps * bwd)
    print(f"{2 * steps} steps and {2 * vals} validation batches under "
          f"remat \"scales\": #1 launches {launches} (expected {want})")
    if tuple(launches) != want:
        raise AssertionError(f"#1 launches {launches}, expected {want}")
    # the 2-epoch run and the resumed epoch
    delivered = NativeLoader.delivered
    print(f"the native loader delivered {delivered} batches (expected "
          f"{3 * (steps + vals)}); holding each against the plain draws")
    if delivered != len(seen) or delivered != 3 * (steps + vals):
        raise AssertionError(f"{delivered} batches delivered, {len(seen)} "
                             f"recorded, expected {3 * (steps + vals)}")
    t0 = time.perf_counter()
    check_batches(seen)
    print(f"{len(seen)} batches equal to the plain draws bit for bit "
          f"({time.perf_counter() - t0:.1f} s)")
    state, step = resumed.state, resumed.train_step
    mix, src, _ = next(iter(resumed.datamodule.train_dataloader()))
    mix = torch.from_numpy(mix).cuda()
    src = torch.from_numpy(src).cuda()
    losses = []
    for i in range(FIXED_STEPS):
        state, loss = step(state, mix, src, torch.Generator().manual_seed(i))
        losses.append(loss.item())
    print(f"{FIXED_STEPS} steps on one fixed batch: loss "
          f"{losses[0]:.3f} -> {losses[-1]:.3f} "
          f"({[round(v, 2) for v in losses]})")
    if not losses[-1] < losses[0]:
        raise AssertionError("the loss did not fall on a fixed batch")
    torch.cuda.synchronize()
    return launches, (tr, cv)


def drive_train_slice(card, tmp):
    """Phases 14-17; phase 16's experiment is left under ``tmp`` for the
    eval phases. Returns the backward kernel's entry of the kernels line,
    #1's (forward, backward) launches on the training path and phase 16's
    train and validation manifest dirs."""
    gen = torch.Generator().manual_seed(14)
    phase("14 the backward of dw_conv_glob_ln against plain (recipe sites)")
    bwd_worst, bwd_abs, bwd_low = dw_backward.check_all(gen)
    phase("15 gradients of the full-width recipe model")
    grad_snr = drive_gradients()
    phase("16 training CLI from a corpus on disk (launch counts from 0)")
    train_launches, data = drive_training(tmp)
    phase(f"17 times (card: {card})")
    finest, step_sums, site_rows = dw_backward.time_all(gen)
    steps = {p: train_remat.measure(p, TRAIN_BATCH)
             for p in train_remat.POLICIES}
    prof = steps["scales"]["profile"]
    torch.cuda.synchronize()
    b8 = finest[0]
    return {
        "name": "dw_conv_glob_ln_backward", "route": "cuda",
        "source": "tdanet_tpu_torch/csrc/dw_conv_glob_ln_backward.cu",
        "replaces": "tdanet_tpu/kernels/fused_pyramid.py:72",
        "note": "the backward of #1; the JAX package has no kernel for it",
        "launches": train_launches[1], "max_abs_err": bwd_abs,
        "max_err_over_max_abs_fp32": bwd_worst,
        "min_bf16_snr_db": bwd_low, "model_grad_min_snr_db": grad_snr,
        "ms": b8["ms"], "plain_ms": b8["plain_ms"],
        "bound_ms": b8["bound_ms"], "bound_by": b8["bound_by"],
        "library_ms": None, "case": "B=8 T=3010 K=5 s=1 bias bf16",
        "ms_b2_fp32": finest[1]["ms"],
        "plain_ms_b2_fp32": finest[1]["plain_ms"],
        "bound_ms_b2_fp32": finest[1]["bound_ms"],
        "step_ms": step_sums["ms"], "step_plain_ms": step_sums["plain_ms"],
        "step_bound_ms": step_sums["bound_ms"],
        "step_sites": [{k: r[k] for k in ("T", "K", "stride", "bias", "ms",
                                          "bound_ms")}
                       for r in site_rows],
        "step_profiled_ms": prof["backward_ms"],
        "step_profiled_forward_ms": prof["forward_ms"],
        "step_profiled_device_ms": prof["device_ms"],
        "step_dy_copies": prof["dy_copies"],
        "train_step_ms": {p: r["ms"] for p, r in steps.items()},
        "train_step_peak_gib": {p: r["peak_gib"] for p, r in steps.items()},
        "train_step_launches": {p: r["launches_per_step"]
                                for p, r in steps.items()},
        "train_step_profiled": {
            p: {k: r["profile"][k] for k in ("kernels", "device_ms",
                                             "wall_ms", "ranges_ms")}
            for p, r in steps.items()}}, train_launches, data


def main():
    phase("1 device")
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA card: chip_smoke.py runs only on a GPU")
    card = card_line()
    print(card)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    print("TF32 off for cuDNN convolutions and CUDA matmuls; torch "
          f"{torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)} x {torch.cuda.device_count()}")
    torch.cuda.synchronize()

    phase("2 build (one nvcc per source and g++ for the loader, all at "
          "once)")
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(SOURCES) + 1) as pool:
        loader = pool.submit(build_loader)
        builds = pool.map(_build.build, SOURCES)
        count_training_macs()
        built = list(builds)
        so, seconds = loader.result()
    print(f"built {len(SOURCES)} sources and the native loader in "
          f"{time.perf_counter() - t0:.2f} s wall")
    print(f"  {os.path.relpath(so)}: g++ {seconds:.2f} s, zlib linked "
          f"({' '.join(native_loader.LIBS)}) for the AV .npz reader")
    for so, seconds, report in built:
        print(f"  {os.path.relpath(so)}: nvcc {seconds:.2f} s")
        entry = spill = ""
        for line in report.splitlines():  # one line per kernel
            if "Compiling entry function" in line:  # the name's tail
                entry = line.split("'")[1][-90:]
            elif "spill" in line:
                spill = line.strip()
            elif "registers" in line and entry:
                print(f"    ptxas: {entry}: {line.split(':', 1)[1].strip()}"
                      f"; {spill}")
                entry = ""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for K, stride, bias in VARIANTS:  # fp32, the model's (B, C, T) layout
        cap = dw.capacity(0, 0, K, stride, True, 0)
        grids = [dw.plan(1, (T - 1) // stride + 1, C, cap).grid
                 for T in SCALES]
        print(f"dw_conv_glob_ln K={K} s={stride} fp32: occupancy "
              f"{cap // sms} CTAs an SM x {sms} SMs = {cap} co-resident CTAs;"
              f" grid at B=1 T={SCALES}: {grids}, at B=24 T=2010: "
              f"{dw.plan(24, (2010 - 1) // stride + 1, C, cap).grid}")
    print_backward_plans()
    torch.cuda.synchronize()

    phase("3 dw_conv_glob_ln against plain (C=512, both layouts)")
    gen = torch.Generator().manual_seed(0)
    max_err, graphs = 0.0, 0
    with torch.inference_mode():
        for B in (1, 4):
            for T in SCALES:
                for K, stride, bias in VARIANTS:
                    for layout in ("(B,C,T)", "(B,T,C)"):
                        x, *params = site_inputs(B, T, K, bias, gen)
                        if layout == "(B,T,C)":
                            x = x.contiguous()
                        err, lim, snrs = check_site(x, params, stride, K)
                        print(f"B={B} T={T:4d} K={K} s={stride} "
                              f"bias={bias!s:5} {layout} fp32 max|d|="
                              f"{err:.3e} (limit {lim:.3e}), bf16 SNR "
                              f"{snrs[0]:.1f} dB (bf16 parameters), "
                              f"{snrs[1]:.1f} dB (fp32); rerun equal")
                        max_err = max(max_err, err)
                        if T == SCALES[0] or T == SCALES[-1]:
                            graph_equals_eager(x, params, stride, K)
                            graphs += 1
        print(f"{graphs} CUDA-graph replays equal to the eager call")
        chunked_err = 0.0
        for B in (1, 4):  # the chunked entry, channels-last (B, T, C)
            x, w, b, g, be = site_inputs(B, 2010, 5, True, gen)
            x = x.contiguous()
            got = dw_conv_glob_ln_chunked(x, w, b, g, be)
            ref = dw_conv_glob_ln_reference(x, w, b, g, be)
            err = (got - ref).abs().max().item()
            print(f"chunked B={B} T=2010 (B,T,C)-contiguous "
                  f"max|d|={err:.3e}")
            if not err <= 1e-4 * ref.abs().max().item():
                raise AssertionError("chunked kernel disagrees with plain")
            chunked_err = max(chunked_err, err)
    torch.cuda.synchronize()

    phase("4 serve (full width, 16 blocks)")
    model = TDANetBest(**CFG)
    model.reset_parameters(torch.Generator().manual_seed(1234))
    checkpoint = model.serialize()  # phase 20 serves it again
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "best_model.pth")
        torch.save(checkpoint, path)
        model = BaseModel.from_pretrain(path).to("cuda")
    per_forward = SITES_PER_BLOCK * CFG["num_blocks"]
    mixes = [tone_mix(s, seed=i) for i, s in enumerate(REQUEST_SECONDS)]
    dw_conv_glob_ln.launches = 0
    t0 = time.perf_counter()
    outs = []
    for mix in mixes:
        before = dw_conv_glob_ln.launches
        est = separate(model, mix)
        if dw_conv_glob_ln.launches - before != per_forward:
            raise AssertionError(
                f"{dw_conv_glob_ln.launches - before} kernel launches for "
                f"one forward, expected {per_forward}")
        if est.shape != (2, mix.shape[-1]) or not np.isfinite(est).all():
            raise AssertionError(f"bad output {est.shape}")
        outs.append(est)
    before = dw_conv_glob_ln.launches
    batched = separate_batched(model, mixes)
    n_buckets = len({-(-m.shape[-1] // model.lcm) for m in mixes})
    if dw_conv_glob_ln.launches - before != per_forward * n_buckets:
        raise AssertionError("separate_batched missed the kernel")
    for mix, est, one in zip(mixes, batched, outs):
        if est.shape != (2, mix.shape[-1]) or not np.isfinite(est).all():
            raise AssertionError(f"bad batched output {est.shape}")
        if np.abs(est - one).max() > 1e-3 * np.abs(one).max():
            raise AssertionError("separate_batched differs from separate")
    torch.cuda.synchronize()
    main_path_launches = dw_conv_glob_ln.launches
    print(f"answered {len(mixes)} separate requests of {REQUEST_SECONDS} s "
          f"and one separate_batched call ({n_buckets} buckets) in "
          f"{time.perf_counter() - t0:.2f} s (first calls included); "
          f"dw_conv_glob_ln launches: {main_path_launches} "
          f"({per_forward} per forward)")

    phase("5 agreement with float64 on the CPU")
    cpu64 = copy.deepcopy(model).cpu().double()
    want = separate(cpu64, mixes[0])
    agree = snr_db(torch.from_numpy(want), torch.from_numpy(outs[0]))
    print(f"1.0 s request: card fp32 vs CPU float64 plain path "
          f"SNR = {agree:.2f} dB (limit 60)")
    if not agree >= 60.0:
        raise AssertionError("card output disagrees with the CPU reference")
    torch.cuda.synchronize()

    phase(f"6 times (CUDA events, median of 7 runs; card: {card})")
    rows = dw_sites.time_sites(gen)
    site_us, site_bound_us, site_bytes, n_sites = dw_sites.forward_sums(rows)
    print(f"one forward's {n_sites} dw_conv_glob_ln sites, summed from the "
          f"B=1 rows: kernel {site_us:.1f} us, bound {site_bound_us:.1f} us "
          f"({site_bytes / 1e6:.1f} MB moved at least), "
          f"{100 * site_bound_us / site_us:.0f}% of the bound")
    with torch.inference_mode():
        # 32000 samples: the finest scale is the (1, 512, 2010) timed above
        wav = torch.from_numpy(tone_mix(2.0, seed=9)).cuda()[None]
        fms, fruns, fflag = cuda_time(lambda: model(wav), reps=1, runs=9,
                                      warmup=2)
        print(f"forward B=1, 2.0 s clip: median {fms:.2f} ms "
              f"(runs {[round(t, 2) for t in fruns]}), "
              f"{2.0 / (fms / 1e3):.1f}x realtime"
              + (f"; runs over 2x median: {fflag}" if fflag else ""))
        # the same forward replayed from one CUDA graph: its device time
        # without the host's per-launch cost
        gms, gruns, gflag = graph_time(lambda: model(wav), reps=1, runs=9)
        print(f"forward B=1, 2.0 s clip, CUDA graph replay: median "
              f"{gms:.2f} ms (runs {[round(t, 2) for t in gruns]}), "
              f"{2.0 / (gms / 1e3):.1f}x realtime"
              + (f"; runs over 2x median: {gflag}" if gflag else ""))
    # a second profiled forward if the first is short: the profiler may
    # drop an event from a window (ROADMAP C #8)
    def read():
        prof = dw_sites.profile_forward(model, wav)
        return prof["dw_kernels"], per_forward, prof
    first = read()
    prof = first[2]
    if prof["device_ms"] > 0:
        prof = counted_windows(read, "phase 6 forward", first)
        dw_sites.print_profile(prof)
        print(f"device busy {100 * prof['device_ms'] / prof['wall_ms']:.0f}%"
              f" of the profiled forward's wall time")
    else:
        print("profiled forward: device time not measured "
              "(the profiler recorded no CUDA kernels)")
    torch.cuda.synchronize()

    row = next(r for r in rows if (r["B"], r["T"], r["K"], r["stride"],
                                   r["bias"]) == (1, 2010, 5, 1, True))
    # no single PyTorch call computes any of kernels #1-#6 (conv + norm,
    # roll + permuting copy are two calls each, the plain versions). One
    # entry for the one kernel behind both depthwise wrappers: the served
    # path calls dw_conv_glob_ln, so the launches, error and times are that
    # wrapper's; dw_conv_glob_ln_chunked, its stride-1 form, has its own
    # check above and its error beside.
    kernels = [{
        "name": "dw_conv_glob_ln", "route": "cuda",
        "source": "tdanet_tpu_torch/csrc/dw_conv_glob_ln.cu",
        "replaces": "tdanet_tpu/kernels/fused_pyramid.py:72",
        "also_replaces": "tdanet_tpu/kernels/fused_pyramid_chunked.py:106",
        "launches": main_path_launches, "max_abs_err": max_err,
        "chunked_max_abs_err": chunked_err,
        "ms": row["us"] / 1e3, "plain_ms": row["plain_us"] / 1e3,
        "bound_ms": row["bound_us"] / 1e3, "bound_by": row["bound_by"],
        "library_ms": None, "forward_ms": site_us / 1e3,
        "forward_bound_ms": site_bound_us / 1e3,
        "forward_profiled_ms": prof["dw_ms"]}]

    gen = torch.Generator().manual_seed(5)
    phase("7 UConvBlock halves against plain (every output, reruns, graphs)")
    half_err, half_snr = check_halves()
    phase("8 fused block path (launch counts from 0)")
    half_launches = drive_fused_path(gen)
    phase(f"9 times (CUDA events, median of 7 runs; card: {card})")
    half_times = time_halves()
    bounds = {(B, dtype): uconv_bounds(B, dtype)
              for B, dtype in uconv_halves.CASES}
    for name, replaces in (("pyramid_fused", 521), ("fuse_expand_fused", 455)):
        src = "uconv_pyramid" if name == "pyramid_fused" else \
            "uconv_fuse_expand"
        row = {k: r[name] for k, r in half_times.items()}
        b1, b4 = (1, torch.float32), (4, torch.float32)
        b24 = (24, torch.bfloat16)
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"tdanet_tpu_torch/csrc/{src}.cu",
            "replaces": f"tdanet_tpu/kernels/uconv_block.py:{replaces}",
            "launches": half_launches[name], "max_abs_err": half_err[name],
            "min_bf16_snr_db": half_snr[name],
            "ms": row[b1]["us"] / 1e3, "plain_ms": row[b1]["plain_us"] / 1e3,
            "bound_ms": bounds[b1][name][0], "bound_by": bounds[b1][name][1],
            "library_ms": None,
            "device_kernels_per_call": row[b1]["kernels"],
            "memsets_per_call": row[b1]["memsets"],
            "eager_ms": row[b1]["eager_us"] / 1e3,
            "ms_b4_fp32": row[b4]["us"] / 1e3,
            "plain_ms_b4_fp32": row[b4]["plain_us"] / 1e3,
            "bound_ms_b4_fp32": bounds[b4][name][0],
            "ms_b24_bf16": row[b24]["us"] / 1e3,
            "plain_ms_b24_bf16": row[b24]["plain_us"] / 1e3,
            "bound_ms_b24_bf16": bounds[b24][name][0],
            "bound_by_b24_bf16": bounds[b24][name][1]})
    torch.cuda.synchronize()

    gen = torch.Generator().manual_seed(10)
    phase("10 window kernels against plain (bit-exact)")
    window_err = check_windows(gen)
    phase("11 Swin path (launch counts from 0)")
    window_launches, swin, swin_x = drive_swin(gen)
    phase("12 micro-kernels against plain ((24, 2032, 512) bf16)")
    with torch.inference_mode():
        operands = mosaic_ops.inputs()
        for probe in (mosaic_ops, mosaic_ops2):
            for v in probe.variants(*operands):
                mosaic_ops.check(v)
        del operands
    count_hgmma()
    torch.cuda.synchronize()
    phase(f"13 times (CUDA events, median of 7 runs; card: {card})")
    window_times = time_windows_and_swin(gen, swin, swin_x)
    del swin, swin_x
    probe_records = drive_probes()
    for name, line in (("roll_and_window_partition", 103),
                       ("window_merge_and_roll", 133)):
        kms, pms, bms, by = window_times[name]
        kernels.append({
            "name": name, "route": "cuda",
            "source": "tdanet_tpu_torch/csrc/window_process.cu",
            "replaces": f"tdanet_tpu/kernels/window_process.py:{line}",
            "launches": window_launches[name], "max_abs_err": window_err,
            "ms": kms, "plain_ms": pms, "bound_ms": bms, "bound_by": by,
            "library_ms": None})
    kernels.append(probe_entry("probe_mosaic_ops", "probe_mosaic_ops", 42,
                               probe_records["probe_mosaic_ops"]))
    kernels.append(probe_entry("probe_mosaic_ops2", "probe_mosaic_ops2", 38,
                               probe_records["probe_mosaic_ops2"]))
    torch.cuda.synchronize()

    with tempfile.TemporaryDirectory() as tmp:
        backward_entry, train_launches, data = drive_train_slice(card, tmp)
        conf = os.path.join(tmp, "exp", "conf.yml")
        phase("18 corpus eval on phase 16's model (launch counts from 0)")
        evaluated = eval_path.drive_eval(card, conf, tmp)
        phase("19 long-form CSS on phase 16's model (launch counts from 0)")
        css = eval_path.drive_css(card, conf, tmp)
        torch.cuda.synchronize()
        phase("20 serving engines on phase 4's checkpoint (launch counts "
              "from 0)")
        path = os.path.join(tmp, "served.pth")
        torch.save(checkpoint, path)
        served = BaseModel.from_pretrain(path).to("cuda").eval()
        serve = serve_path.drive_serve(served)
        phase(f"21 serving times (card: {card})")
        serve_times = serve_path.time_serve(card, served)
        del served
        torch.cuda.synchronize()
        phase("22 TDANet variant family (launch counts from 0)")
        family, variant_launches = variants.drive_family(tmp)
        torch.cuda.synchronize()
        phase(f"23 the family's training on the card (card: {card})")
        family_training, variant_train = variants.drive_family_training(
            card, tmp, data=data)
        torch.cuda.synchronize()
        phase("24 EMCAD-era family (launch counts from 0)")
        era_family, era_launches = era.drive_family(card, tmp)
        torch.cuda.synchronize()
        phase(f"25 the EMCAD-era family's training (card: {card})")
        era_training, era_train = era.drive_family_training(
            card, tmp, data=data)
        torch.cuda.synchronize()
        phase("26 deployment bundles (launch counts from 0)")
        path = os.path.join(tmp, "bench.pth")
        torch.save(checkpoint, path)
        deployed, deploy_launches = deploy_path.drive_deploy(
            card, tmp, path, os.path.join(tmp, "eval_conf.yml"))
        torch.cuda.synchronize()
        phase(f"27 data parallelism (launch counts from 0; card: {card})")
        parallel = dp_path.drive_dp(card, tmp, data=data)
        torch.cuda.synchronize()
        phase("28 the studies on phase 16's model (launch counts from 0)")
        studied = studies.drive_studies(
            os.path.join(tmp, "exp", "best_model.pth"), tmp)
        torch.cuda.synchronize()
        phase("29 every optimizer name, the AV loader and an n_src=6 step "
              f"(launch counts from 0; card: {card})")
        options = train_options.drive_phase(card, tmp, data)
        torch.cuda.synchronize()
    print(json.dumps({"eval": evaluated, "css": css}))
    print(json.dumps({"serve": serve, "serve_times": serve_times}))
    print(json.dumps({"variants": family, "variant_training":
                      family_training}))
    print(json.dumps({"era": era_family, "era_training": era_training}))
    print(json.dumps({"deploy": deployed}))
    print(json.dumps({"parallel": parallel}))
    print(json.dumps({"studies": studied}))
    print(json.dumps({"train_options": options}))
    kernels[0]["train_launches"] = train_launches[0]
    kernels[0]["eval_launches"] = evaluated["eval_launches"]
    kernels[0]["css_launches"] = css["css_launches"]
    # phase 20: the wrapper's launches (each graph's set-up forward and
    # capture); the engines' replays, which the wrapper does not see; and
    # the profiler's device kernels of #1 in its window of replays
    kernels[0]["serve_launches"] = serve["wrapper_launches"]
    kernels[0]["serve_replays"] = serve["replays"]
    kernels[0]["serve_profiled_replays"] = serve["profiled_replays"]
    kernels[0]["serve_profiled_dw_kernels"] = serve["profiled_dw_kernels"]
    # phase 22: #1's launches over the eleven models' forwards (checks
    # excluded); phase 23: its (forward, backward) launches over the
    # audio_train run on configs/tdanet_origin.yml
    kernels[0]["variant_launches"] = variant_launches
    kernels[0]["variant_train_launches"] = list(variant_train)
    # phase 24: #1's launches over the 22 era models' forwards (the 16-block
    # requests and the 2-block ones held against float64; checks
    # excluded); phase 25: its (forward, backward) launches over the
    # audio_train run of TDANetEMCADv1_6
    kernels[0]["era_launches"] = era_launches
    kernels[0]["era_train_launches"] = list(era_train)
    # phase 26: #1's op nodes in each loaded program; the wrapper's
    # launches on the bundle paths (each program's set-up forward and
    # capture; replays pass no wrapper); the profiler's #1 device kernels
    # per replay of each bench program
    kernels[0]["deploy_nodes"] = {
        **deployed["bench"]["nodes"], "bf16": deployed["bf16"]["nodes"],
        **{k: v["nodes"] for k, v in deployed["family"].items()}}
    kernels[0]["deploy_launches"] = deploy_launches
    kernels[0]["deploy_profiled_dw_kernels"] = deployed["bench"]["profiled"]
    # phase 27: #1's launches on the data-parallel paths: a rank's step of
    # (b) and (a)'s NCCL step (both 512 forward), an audio_train rank of
    # (c), audio_test --dp 2 of (d) and the mesh server's set-ups
    kernels[0]["ddp_launches"] = parallel["dw_launches"]
    # phase 28: #1's launches in each study's run
    kernels[0]["studies_launches"] = {
        k: studied[k]["launches"]
        for k in ("early_exit", "progressive", "act_quant")}
    # phase 29: #1's (forward, backward) launches over (c)'s two
    # audio_train runs with adafactor, and the 6-source step of (d)
    adafactor = options["adafactor_training"]
    runs = (adafactor["run0_launches"], adafactor["run1_launches"])
    kernels[0]["optim_train_launches"] = [r[0] for r in runs]
    kernels[0]["many_sources_launches"] = \
        options["many_sources"]["dw_launches"][0]
    backward_entry["ddp_launches"] = parallel["backward_launches"]
    backward_entry["optim_train_launches"] = [r[1] for r in runs]
    backward_entry["many_sources_launches"] = \
        options["many_sources"]["dw_launches"][1]
    kernels.append(backward_entry)
    print(f"total: {time.perf_counter() - T_START:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    sys.exit(main())
