#!/usr/bin/env python3
"""Smoke run of the PyTorch port (etude_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each announced with a flushed line when it starts and ends:

  1. environment    card name and power limit (nvidia-smi), torch/CUDA
                    versions; TF32 off for matmuls and cuDNN
  2. build          nvcc builds every CUDA source of the port and g++ the DBN
                    decoder, all at once; a second build must be a cache hit
  3. kernels        each hand kernel against its plain PyTorch version on the
                    card at the main path's shapes, with timings (L2 flushed,
                    device time) beside its bound and a library call where
                    one exists, and at its designs' edge cases; two
                    launches on the same inputs must give the same bits
  4. serving        the streaming engine at full decoder width (random weights
                    from a seed through the weight bridge) over 24 real corpus
                    bars, 16 lockstep streams, greedy then sampled; the K1
                    launch count must equal the engine's S = 1 chunks x
                    layers; a short window under torch.profiler shows where a
                    step's time goes; then the same chunks on the card and on
                    the CPU must agree
  5. structuralize  `InferencePipeline._run_stage2_structuralize` at full
                    separator and Beat-Transformer width (random weights from
                    a seed) on a 240 s click track synthesized from a seed:
                    span times, 9 K2 launches per forward, a well-formed
                    tempo.json; then, on a short input, the card's f32
                    separation features and bf16 beat activations against
                    the port's CPU f32 path, each beside a control it must
                    catch
  6. extract        `AMTAPC_Extractor.extract` at the committed extractor's
                    full width (random weights from a seed) on the same 240 s
                    click track, cold, warm and profiled: spans (resample
                    apart), segments and groups, notes before and after the
                    minimum-duration filter, peak device memory, the top
                    device operations and the device's idle share; a
                    well-formed extract.json; the front end's matmul against
                    `F.conv2d` of the same filter, timed; then, on a short
                    input, the card's bf16 head activations against the
                    port's CPU f32 path, beside controls it must catch (one
                    attention layer's output zeroed at a time)
  7. pipeline       `etude_tpu_torch.infer --input` in-process on the 240 s
                    song at full width (bars capped at 32 tokens): the five
                    outputs exist and are well formed, the MIDI parses, the
                    timing summary (audio decode, the concurrent stage 1+2
                    span with its stage spans, decode); 9 K2 launches and
                    some K1 launches
  8. prepare        `etude_tpu_torch.prepare --start-from preprocess`
                    in-process on a two-song corpus synthesized from seeds
                    (240 s origin.wav piano renders; cover.wav the same
                    notes transposed and time-warped), every model at full
                    width under random weights with PREP_THRESHOLDS: the
                    span of every stage and song (the first song cold, the
                    second warm), 9 K2 launches per song, and the outputs
                    checked (a kept alignment that recovers each cover's
                    transposition and warp, notes, in-range token ids);
                    then the coarse (1/16) and a full 30 s wavefront timed
                    (warm wall, device kernels, device time), the aligner's
                    spans on the 30 s pair, the hFT stride transcription's
                    device time against its operation bound; and, each
                    beside a control it must catch, card against CPU f32:
                    chroma and onset features (tuning + a semitone), the
                    wavefront's codes bit for bit (one cost row perturbed),
                    the aligner's path and WPD (a segment re-warped), the
                    hFT stride maps in bf16 within HFT_ATOL (one attention
                    layer's output zeroed)
  9. evaluate       `etude_tpu_torch.evaluate` in-process on the prepare
                    phase's songs with three versions each (the cover with
                    the notes it was rendered from; the cover with its
                    stage-2 transcription; the pipeline phase's MIDI and
                    its render): a CSV row per song and version with finite
                    WPD, RGC and IPE (but where a metric declines what random
                    weights give, for the reason it states: RGC the
                    transcription, RGC and IPE a MIDI without notes), and
                    the wall per song
 10. cli            `etude_tpu_torch.infer --decode-only` in-process on the
                    pipeline's work dir cut to its first 30 s of bars, with
                    synthetic condition notes, to a MIDI file that parses
 11. train          `etude_tpu_torch.train` in-process at the published decoder
                    widths on dataset_distill/tokenized (500 songs, 1024-token
                    chunks) with configs/distill.yaml's train settings, 40
                    steps, `latest` saved every 20, host syncs an error in
                    the steady steps: dataset load time, median warm step,
                    tokens/s, peak memory, the step's operations, then a
                    profiled window (idle share, top operations); checks,
                    each beside a control it must catch: finite losses and no
                    skip (a NaN bias must skip), no host sync (an .item()
                    must raise), learning on one fixed micro-batch (lr 0
                    changes nothing), one step on the card against the CPU
                    (labels shifted by one), a resume across an epoch within
                    the card's run-to-run spread (Adam moments zeroed), and
                    `--decode-only` serving the run's own export
 12. aux_train      the backward kernel K2b against autograd of K2's plain
                    version at the training shape (B = 40, T = 512, all 9
                    dilations) and the serving shape (B = 5, T = 12,288,
                    three dilations), head7_bug both ways, timed, each
                    beside a control (the gradient at another dilation)
                    that it must catch, and K2's forward at the training
                    shape; then `etude_tpu_torch.train_aux` in-process for
                    beat, amt and separator at the published widths and
                    the script's batches and frames, 30 steps each, with 2
                    held-out clips: warm step time, the host's share of
                    it, peak memory, a profiled window's device idle share,
                    9 K2 and 9 K2b launches per beat step; checks, each
                    beside a control it must catch: learning on one fixed
                    batch (rate 0 changes nothing), one step on the card
                    against the CPU (labels shifted), and `--input` on a
                    30 s click track served from the phase's own exports
                    (loaded, no random weights; 9 K2 launches)
 13. recipe         the decoder's recipe through the scripts, at full width:
                    `dagger_rollouts --batch 16` in-process on 16 corpus
                    songs cut to 6 bars, from the train phase's export
                    (wall, tok/s, K1 launches = the engine's S = 1 chunks
                    x 8; one int32 file per song of 6 bars opening with
                    Bar_BOS, ids in range; a second run without --force
                    writes nothing; bars 0-1 equal a direct
                    `generate_batch` at the script's shapes with the
                    phase's global-edge bins, control: per-song edges);
                    the DAgger fine-tune (configs/dagger.yaml's train
                    settings, 4 steps) as a child of `supervise_train`:
                    finite losses, no skip, chunks with rollout history
                    (control: dagger_history false gives none), the
                    child's CPU share per poll; `train_attr_prior` on all
                    500 songs on the card (features and fit timed apart,
                    held-out accuracy beside the majority baseline), the
                    card's f64 fit against the CPU's on 30 songs (control:
                    another seed), `--decode-only --attrs-prior` from it;
                    the remap onto dataset_distill_r4's vocabulary
                    (logits at the mapped columns and Note_103-105 within
                    one bf16 ulp; control: padded without the remap);
                    publish (f16) and `--decode-only` from it; the
                    separation CLI on a 30 s click track from the
                    aux_train phase's separator export, equal to
                    `separate_features` bit for bit (control: another
                    seed's track); `entry()` on the card, bf16 vs the
                    CPU's f32 (control: one layer's attention zeroed)
 14. options        the serving CLI's other options, each check beside a
                    control it must catch: `--decode-only --engine rebuild`
                    on the cli phase's work dir (K1 launches = the S = 1
                    steps counted from outside the engine x 8 layers; the
                    MIDI parses); the rebuild and stream engines timed on
                    16 streams x 8 corpus bars (64-token cap), bar 0's greedy
                    agreement reported, K1 timed at the rebuild cache
                    lengths; the rebuild path's teacher-forced logits card
                    vs CPU (controls: one layer's attention output zeroed);
                    `--attrs-prior` (the engine's per-bar bins equal the
                    CPU's predictor's; logits under them card vs CPU, a
                    constant combo the control); the int8 KV cache against
                    bf16 on 16 streams x 24 bars (64-token cap): tok/s,
                    cache bytes, int8 logits card vs CPU within
                    QUANT_LOGIT_ATOL; the separator bypass card vs CPU
                    within BYPASS_DB_ATOL (control: a frame late) and
                    `detect` on its saved `.npy` (the array's beats, the
                    file removed); synthetic reference `.pth`/`.pkl`
                    weights at the published widths loaded through
                    `paths.*`: decoder logits, hFT heads (`.pkl` = `.pth`),
                    and the Beat-Transformer with 9 K2 launches with head
                    7's keys from head 6 (control: without the compat)

It prints a `{"kernels": [...]}` line, whose launches are those of the
serving, structuralize, pipeline, prepare, cli, train, aux_train, recipe and options runs,
each counted from 0 (K2b's: the aux_train beat run's), then
`{"ok": true, "device": ...}` as its last line, and exits 0. Any failure
raises and exits non-zero with no result line; so does a machine without
CUDA, and a directory that holds this script without the package. It
imports nothing of JAX or of etude_tpu.
"""

from __future__ import annotations

import contextlib
import json
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path
from typing import Optional

ROOT = Path(__file__).resolve().parent
T0 = time.perf_counter()

LOGIT_ATOL, LOGIT_RTOL = 2e-2, 2e-2   # card vs CPU logits, both bf16 paths
# Card (bf16) vs CPU (f32) beat activations: sigmoid outputs near 0.5 with
# a spread of about 6e-3 under the random weights. The port's bf16 path
# differs from its f32 path by 1.5e-3 on the CPU (3 f16 ulps); zeroing one
# layer's attention output moves them by 1.6e-2 to 9.6e-2 (CPU f32, 12 s
# click track). Faults finer than that (head 7's keys, a wrong dilation) are
# held by the kernels phase, which checks every dilation and head7_bug.
ACT_ATOL = 5e-3
# Card f32 (TF32 off) vs CPU f32 separation features, in dB. Under random
# weights the quiet bins amplify rounding: on the CPU, the port's f32
# features and the JAX package's differ by up to 0.077 dB on the 12 s click
# track (mean 0.0014 dB), while scaling the first conv's weights by 1.01
# moves them by 1.6 dB and by 1.001 still by 0.16 dB.
SEP_DB_ATOL = 0.1
# Card (bf16) vs CPU (f32) hFT head activations (the six sigmoid maps), one
# 512-frame segment of a 12 s click track under random weights: they differ
# by 3.4e-3, while zeroing one attention layer's output moves them by
# 1.2e-2 (a decoder self-attention) to 0.27 (the first cross-attention).
HFT_ATOL = 6e-3
# Card vs CPU separator-bypass features (no U-Net: the mix's f32 DFT and mel
# on both), in dB.
BYPASS_DB_ATOL = 1e-3
# Card vs CPU logits of the int8-cache chunks (both plain PyTorch with exact
# integer dots; q, K, V and the probabilities quantized from bf16 values that
# differ by rounding between the devices). Measured first, on an H100 with
# this limit unset: 0.0152 (the bf16 chunks: 0.0124); zeroing layer 0's
# attention output moves them by 1.18. Twice the reading.
QUANT_LOGIT_ATOL = 3e-2
BF16_PEAK, F32_PEAK = 989e12, 67e12   # H100 SXM data sheet, dense, at 700 W
SONG_SECONDS = 240.0          # a 4-minute song: 10,336 frames at 44.1 kHz / 1024
ORIGIN_SR, ALIGN_SR = 44100, 22050
# The prepare phase's covers: the origin's notes shifted and swung by
# ±WARP_SECONDS over WARP_PERIOD, which keeps the WP-Std of a grid through
# the path under the filter's 1.0 s.
WARP_SECONDS, WARP_PERIOD = 0.5, 60.0
# Random weights score every frame alike: on a piano render (the port's CPU
# f32 path, seed 0), the hFT's onset map sits at 0.48-0.64 and the
# extractor's MPE map at 0.40-0.50, so at the published thresholds the
# transcriber keeps no note and every note of the extractor falls under its
# 0.08 s minimum duration; the stages after them would then have nothing to
# tokenize. These thresholds, read by both CLIs, keep some: 9 and 19 notes
# per second of a 3 s render on the CPU.
PREP_THRESHOLDS = {"hft": {"infer": {"thred_onset": 0.63}},
                   "extractor": {"infer": {"onset_threshold": 0.59, "frame_threshold": 0.42}}}
# Card vs CPU f32 alignment features: the onsets divide differences of log
# chroma by each frame's largest one and normalise, so they amplify the
# f32 DFT's rounding; on the CPU, two GEMM libraries (XLA's and MKL's) give
# chroma 5.5e-6 and onsets 5.5e-3 apart. A semitone of tuning moves both by
# about 1.
CHROMA_ATOL, ONSET_ATOL = 1e-4, 2e-2
# Card vs CPU warping paths of a 30 s pair: largest gap in frames (20 ms
# each) and WPD gap in seconds.
PATH_FRAMES, WPD_ATOL = 2, 5e-3
TRAIN_STEPS, TRAIN_SAVE_EVERY = 40, 20
# 30 steps of the published decoder on one fixed micro-batch of 8 corpus
# chunks (peak rate 2e-4 after 3 warmup steps) must lower its loss by this
# fraction (4.68 -> 1.62, 65%, on an H100); at rate 0 the loss and every
# parameter must stay as they were.
LEARN_STEPS, LEARN_DROP = 30, 0.5
# One optimizer step (the second of a run, the first at rate > 0) of the
# published decoder on 2 corpus rows, card bf16 against the port's CPU f32:
# relative limits on the losses and gradient norms, on the first Adam moment
# (0.1 x the gradient after one step) and on the parameter update (Adam's
# first updates are nearly sign(g) x rate, so entries with tiny gradients
# flip with bf16 rounding). Measured on an H100: 2.6e-4, 1.9e-5, 6.7e-3,
# 0.093; with the labels shifted by one position: 1.1e-2, 0.13, 0.63, 1.03,
# each of which must exceed its limit.
STEP_LOSS_RTOL, STEP_NORM_RTOL, STEP_MOMENT_RTOL, STEP_UPDATE_RTOL = 2e-3, 1e-3, 0.03, 0.3
# A resumed run's losses against two straight runs', on the same batches:
# its largest gap over the run to the nearer of them at most this multiple
# of the straight runs' own largest gap, plus 8 f32 ulps of the loss (for a
# card that happens to be deterministic). The card is not: two straight
# runs of 42 steps part by 1.4e-4 to 3.3e-4 in a loss of 3.0 on an H100.
RESUME_SPREAD_FACTOR = 3.0
# Aux training: optimizer steps of each CLI run, held-out clips, and the
# dilations of K2b's check at the serving bucket.
AUX_STEPS, AUX_EVAL_CLIPS, AUX_SERVE_SECONDS = 30, 2, 30.0
# K2b against autograd of the plain version in f32 from the same bf16
# inputs: dq, dk, dv within two bf16 ulps of each one's largest |value|
# (kernel_tolerance: they are rounded once), der within this share of its
# largest |value| (f32 sums over B*T in another order).
DER_RTOL = 1e-3
# Learning on one fixed batch of each model: AUX_STEPS steps at the mode's
# rate must lower the loss by this fraction (on an H100: beat 6.45 -> 2.26,
# amt 19.74 -> 7.83, separator 0.157 -> 0.040).
AUX_LEARN_DROP = 0.5
# One aux step (the second of a run, the first at rate > 0) at the published
# widths on one row, against the port's CPU f32: relative limits on the
# losses, the gradient norms and the parameter update, for the card at bf16
# (the production path) and, for the separator, at f32 (TF32 off). Both
# losses and both gradient norms are read before the first update at a rate
# above 0, so only the update gap sees the optimizer step: a step that
# applies no update reads exactly 1.0 there, a half-size one about 0.5. Each
# row must catch two controls, the labels shifted and the rate halved; a row
# whose update is not held (None) catches only the first. Measured on an
# H100, card / labels shifted / rate halved:
#   beat bf16       7.2e-5 / 2.3e-2 / 7.2e-5, 2.0e-3 / 3.7e-2 / 2.0e-3, 0.089 / 1.33 / 0.504
#   amt bf16        5.6e-4 / 7.7e-4 / 5.6e-4, 1.5e-3 / 7.5e-4 / 1.5e-3, 0.086 / 0.315 / 0.504
#   separator bf16  5.6e-4 / 6.4e-2,          1.5e-2 / 0.506,           0.57  / 1.46
#   separator f32   9.5e-8 / 6.4e-2 / 9.5e-8, 3.0e-6 / 0.537 / 3.3e-6, 0.0037 / 1.46 / 0.500
# At initialisation the hFT scores every frame alike, so shifting its labels
# in time moves only the update's direction. The separator's bf16 update is
# reported, not held: the card's f32 update is within 0.0037 of the CPU's,
# so its bf16 gap of 0.57 is the bf16 U-Net's own, as large as a missing
# update's.
AUX_STEP_LIMITS = {"beat": {"bf16": (5e-3, 2e-2, 0.3)}, "amt": {"bf16": (5e-3, 2e-2, 0.2)},
                   "separator": {"bf16": (5e-3, 0.1, None), "f32": (1e-5, 1e-4, 0.05)}}
# The recipe phase: the rollouts' songs (every RECIPE_STRIDE-th corpus song
# with RECIPE_BARS bar pairs, cut to them), the DAgger fine-tune's steps, the
# attribute prior's card-vs-CPU fit (songs, steps; f64 on both, weights
# stored as f32: held to 1e-6 relative with a 1e-7 floor; equal bit for
# bit on an H100, another seed 0.0198 away),
# and the remap check's chunk of corpus tokens.
RECIPE_SONGS, RECIPE_BARS, RECIPE_STRIDE, RECIPE_STEPS = 16, 6, 25, 4
PRIOR_SUBSET_SONGS, PRIOR_STEPS, PRIOR_RTOL, PRIOR_ATOL = 30, 300, 1e-6, 1e-7
REMAP_TOKENS = 256
# `entry()`: the default decoder's logits (std about 0.45, largest 2.1,
# under seed 0's weights), card bf16 against CPU f32, as LOGIT_ATOL and
# LOGIT_RTOL hold the serving logits. Measured on an H100: 0.0234 (inside
# through the relative term); zeroing layer 3's attention output: 0.66.
ENTRY_ATOL, ENTRY_RTOL = LOGIT_ATOL, LOGIT_RTOL


def say(msg: str) -> None:
    print(msg, flush=True)


@contextlib.contextmanager
def phase(name: str):
    t = time.perf_counter()
    say(f"[phase] {name}: start (t={t - T0:.1f}s)")
    yield
    say(f"[phase] {name}: done in {time.perf_counter() - t:.2f}s "
        f"(t={time.perf_counter() - T0:.1f}s)")


def check_kernel(B, C, seed, flush, timed=True):
    """K1 against its plain version on the card (inputs made on the card
    from a seed, H = 8, D = 64), within two bf16 ulps of the largest |o|; two
    launches on the same inputs must give the same bits. `timed` adds the
    kernel's, the plain version's and masked SDPA's times."""
    import torch
    import torch.nn.functional as F
    from etude_tpu_torch.ops.decode_attention import (
        decode_attention, decode_attention_plain,
    )
    from etude_tpu_torch.utils.kernel_bench import (
        attention_inputs, decode_bound, kernel_tolerance, time_ms,
    )

    q, k, v, bias = attention_inputs(B, C, seed)
    H, D = k.shape[1], k.shape[3]
    out = decode_attention(q, k, v, bias)
    again = decode_attention(q, k, v, bias)
    torch.cuda.synchronize()
    ref = decode_attention_plain(q, k, v, bias)
    if not torch.isfinite(out.float()).all():
        raise RuntimeError(f"decode_attention B={B} C={C}: non-finite output")
    if not torch.equal(out, again):
        raise RuntimeError(f"decode_attention B={B} C={C}: two launches differ")
    err = (out.float() - ref.float()).abs().max().item()
    tol = kernel_tolerance(ref)
    if err > tol:
        raise RuntimeError(f"decode_attention B={B} C={C}: max|kernel-plain| "
                           f"{err:.3g} > {tol:.3g}")
    row = {"B": B, "C": C, "max_abs_err": err, "tol": tol}
    if not timed:
        say(f"  decode_attention B={B:2d} C={C:4d}: max_abs_err={err:.3g} (tol {tol:.3g}), "
            f"deterministic")
        return row
    q4 = q.to(torch.bfloat16)[:, :, None]
    mask = bias.to(torch.bfloat16)[:, None, None, :]
    row["bound_ms"], row["bound_by"], n_bytes = decode_bound(B, H, C, D)
    row["ms"] = time_ms(lambda: decode_attention(q, k, v, bias), flush=flush)
    row["plain_ms"] = time_ms(lambda: decode_attention_plain(q, k, v, bias), flush=flush)
    row["library_ms"] = time_ms(
        lambda: F.scaled_dot_product_attention(q4, k, v, attn_mask=mask), flush=flush)
    say(f"  decode_attention B={B:2d} C={C:4d}: max_abs_err={err:.3g} (tol {tol:.3g}) "
        f"kernel={row['ms']:.4f} ms plain={row['plain_ms']:.4f} ms "
        f"sdpa={row['library_ms']:.4f} ms bound={row['bound_ms']:.4f} ms "
        f"({n_bytes / 1e6:.1f} MB, {row['bound_by']})")
    return row


def check_dilated(B, T, dilation, seed, flush, head7_bug=False):
    """K2 against its plain version on the card at the Beat-Transformer's
    widths (H = 8, d = 32), bf16 q/k/v made on the card from a seed, within
    two bf16 ulps of the largest |o|; two launches must give the same bits."""
    import torch
    from etude_tpu_torch.ops.dilated_attention import (
        dilated_attention, dilated_attention_plain,
    )
    from etude_tpu_torch.utils.kernel_bench import (
        dilated_bound, dilated_inputs, kernel_tolerance, time_ms,
    )

    q, k, v, er = dilated_inputs(B, T, seed)
    H, d = q.shape[1], q.shape[3]
    out = dilated_attention(q, k, v, er, dilation, head7_bug=head7_bug)
    again = dilated_attention(q, k, v, er, dilation, head7_bug=head7_bug)
    torch.cuda.synchronize()
    ref = dilated_attention_plain(q, k, v, er, dilation, head7_bug=head7_bug)
    name = f"dilated_attention B={B} T={T} dilation={dilation} head7_bug={head7_bug}"
    if not torch.isfinite(out.float()).all():
        raise RuntimeError(f"{name}: non-finite output")
    if not torch.equal(out, again):
        raise RuntimeError(f"{name}: two launches differ")
    err = (out.float() - ref.float()).abs().max().item()
    tol = kernel_tolerance(ref)
    if err > tol:
        raise RuntimeError(f"{name}: max|kernel-plain| {err:.3g} > {tol:.3g}")
    bound_ms, bound_by, n_bytes = dilated_bound(B, H, T, d)
    row = {
        "T": T, "dilation": dilation, "head7_bug": head7_bug,
        "max_abs_err": err, "tol": tol,
        "ms": time_ms(lambda: dilated_attention(q, k, v, er, dilation,
                                                head7_bug=head7_bug), flush=flush),
        "plain_ms": time_ms(lambda: dilated_attention_plain(
            q, k, v, er, dilation, head7_bug=head7_bug), iters=10, flush=flush),
        "bound_ms": bound_ms,
        "bound_by": bound_by,
    }
    say(f"  dilated_attention B={B} T={T:5d} dil={dilation:3d}"
        f"{' head7_bug' if head7_bug else ''}: max_abs_err={err:.3g} (tol {tol:.3g}) "
        f"kernel={row['ms']:.4f} ms plain={row['plain_ms']:.4f} ms "
        f"bound={row['bound_ms']:.4f} ms ({n_bytes / 1e6:.1f} MB, {row['bound_by']})")
    return row


def host_launch_us(n: int = 20000) -> float:
    """Host cost of one eager launch: microseconds per in-place add on a
    one-element card tensor, with one synchronize at the end. The S = 1 step
    is a few hundred such launches, so this says how fast the host that
    feeds the card is, for comparing runs on different machines."""
    import torch

    x = torch.zeros(1, device="cuda")
    for _ in range(1000):
        x.add_(1.0)
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(n):
        x.add_(1.0)
    torch.cuda.synchronize()
    return 1e6 * (time.perf_counter() - t) / n


def corpus_bars(vocab, n_bars):
    import numpy as np
    from etude_tpu_torch.data.tokenizer import split_sequence_into_bars

    ids = np.load(ROOT / "dataset_distill/tokenized/0001/0001_src.npy").tolist()
    bars = split_sequence_into_bars(ids, vocab.bar_bos_id, vocab.bar_eos_id)
    if len(bars) < n_bars:
        raise RuntimeError(f"corpus song has {len(bars)} bars, need {n_bars}")
    return bars[:n_bars]


def check_streams(outs, n_bars, bos, eos, vocab_size, max_new):
    for s, bars in enumerate(outs):
        if len(bars) != n_bars:
            raise RuntimeError(f"stream {s}: {len(bars)} bars, expected {n_bars}")
        for bar in bars:
            if bar[0] != bos or len(bar) > 1 + max_new:
                raise RuntimeError(f"stream {s}: malformed bar {bar[:8]}...")
            if not all(0 <= t < vocab_size for t in bar):
                raise RuntimeError(f"stream {s}: token out of range")
            if eos in bar and bar.index(eos) != len(bar) - 1:
                raise RuntimeError(f"stream {s}: Bar_EOS not terminal")


def serve(engine, model, bars, attrs, **kw):
    import torch
    from etude_tpu_torch.ops.decode_attention import decode_attention

    engine.stats["single_token_chunks"] = 0
    decode_attention.launches = 0
    torch.cuda.synchronize()
    t = time.perf_counter()
    outs = engine.generate_batch(model, [bars] * len(attrs), attrs, **kw)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t
    chunks = engine.stats["single_token_chunks"]
    launches = decode_attention.launches
    expected = chunks * model.config.num_hidden_layers
    tokens = sum(len(b) - 1 for s in outs for b in s)
    say(f"  {kw}: {tokens} tokens in {seconds:.2f} s = {tokens / seconds:.1f} tok/s; "
        f"{chunks} S=1 chunks, {1e3 * seconds / max(chunks, 1):.3f} ms per chunk "
        f"(wall, condition chunks included); kernel launches {launches} "
        f"(expected {expected})")
    if launches != expected or launches == 0:
        raise RuntimeError(f"decode_attention launched {launches} times, "
                           f"expected {expected}")
    return outs, launches


def profile_window(model, config, vocab, bars, attrs):
    """Where a decode step's time goes: 16 greedy streams x 2 bars of at
    most 64 steps, timed once without and once under torch.profiler (the
    same work). Prints device time per S = 1 chunk, the top kernels, and
    the device's idle share: 1 - device time / unprofiled wall."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from etude_tpu_torch.models.generate_stream import StreamingGenerationEngine

    engine = StreamingGenerationEngine(
        config, bar_bos_id=vocab.bar_bos_id, bar_eos_id=vocab.bar_eos_id,
        pad_id=vocab.pad_id, max_bar_token_limit=64,
    )
    window = ([bars[:2]] * len(attrs), [a[:2] for a in attrs])
    engine.generate_batch(model, *window)  # warm-up
    torch.cuda.synchronize()
    t = time.perf_counter()
    engine.generate_batch(model, *window)
    torch.cuda.synchronize()
    wall_ms = 1e3 * (time.perf_counter() - t)
    engine.stats["single_token_chunks"] = 0
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        engine.generate_batch(model, *window)
        torch.cuda.synchronize()
    chunks = engine.stats["single_token_chunks"]
    kernels = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    total_us = sum(e.self_device_time_total for e in kernels)
    if total_us <= 0:
        say("  profiler: no device time recorded; device busy share not measured")
        return
    say(f"  profiler: {chunks} S=1 chunks (seed and condition chunks included): "
        f"device {total_us / 1e3 / chunks:.4f} ms per chunk, unprofiled wall "
        f"{wall_ms / chunks:.4f} ms per chunk -> device idle share "
        f"{1 - total_us / 1e3 / wall_ms:.3f}")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:8]:
        say(f"    {e.self_device_time_total / total_us:6.1%}  {e.count:7d} launches  "
            f"{e.key[:90]}")


def chunk_logits(m, config, bars, attr, device, quant=False):
    """Seed, condition and S = 1 chunks of the stream engine on one device
    (teacher-forced: Bar_BOS, then a corpus bar's tokens, so a near-tie on
    one device cannot steer two runs apart); each chunk's logits, f32 on
    the host. `quant` runs them on an int8 cache."""
    import numpy as np
    import torch
    from etude_tpu_torch.data.tokenizer import SRC_CLASS_ID, TGT_CLASS_ID
    from etude_tpu_torch.models.decoder import ATTRIBUTE_ORDER
    from etude_tpu_torch.models.generate_stream import init_stream_cache, stream_chunk

    B, hist, X = 2, 64, 64
    cache = init_stream_cache(config, B, hist + X + 1 + 8, device=device, quant=quant)
    zero = torch.zeros(B, dtype=torch.long, device=device)

    def t(a):
        return torch.tensor(np.asarray(a), dtype=torch.long, device=device)

    with torch.no_grad():
        seed_ids = t([[bars[0][0], bars[0][-1]] * 8] * B)
        seed_cls = t([[SRC_CLASS_ID] * 2 + [TGT_CLASS_ID] * 2] * 4 * B).reshape(B, 16)
        ones = {n: torch.ones_like(seed_ids) for n in ATTRIBUTE_ORDER}
        outs = [stream_chunk(m, cache, seed_ids, seed_cls, ones, zero, zero, 0)[0]]
        x = np.zeros((B, X), np.int64)
        lens = [len(bars[1][:X]), len(bars[2][:X])]
        x[0, :lens[0]] = bars[1][:X]
        x[1, :lens[1]] = bars[2][:X]
        attrs = {n: t([[attr[n]] * X] * B) for n in ATTRIBUTE_ORDER}
        outs.append(stream_chunk(m, cache, t(x), t([[SRC_CLASS_ID] * X] * B), attrs,
                                 zero + 16, zero, hist, valid_len=t(lens))[0])
        pos = zero + 16 + t(lens)
        attr1 = {n: a[:, :1] for n, a in attrs.items()}
        for step, tok in enumerate([bars[0][0]] + bars[3][1:4]):
            outs.append(stream_chunk(m, cache, t([[tok]] * B), t([[TGT_CLASS_ID]] * B),
                                     attr1, pos + step, zero, hist + X + step)[0])
    return [o.float().cpu() for o in outs]


def chunk_parity(model, config, bars, attr):
    """Seed, condition and S = 1 chunks at full width: card (kernel) vs CPU
    (plain version), same weights and inputs."""
    import copy

    card = chunk_logits(model, config, bars, attr, "cuda")
    host = chunk_logits(copy.deepcopy(model).cpu(), config, bars, attr, "cpu")
    worst = 0.0
    for a, b in zip(card, host):
        if not bool(a.isfinite().all()):
            raise RuntimeError("non-finite logits on the card")
        excess = ((a - b).abs() - (LOGIT_ATOL + LOGIT_RTOL * b.abs())).max().item()
        worst = max(worst, (a - b).abs().max().item())
        if excess > 0:
            raise RuntimeError(f"card vs CPU logits differ by {worst:.3g} "
                               f"(atol {LOGIT_ATOL}, rtol {LOGIT_RTOL})")
    say(f"  card vs CPU chunk logits: max|diff| {worst:.3g} over {len(card)} chunks "
        f"(atol {LOGIT_ATOL}, rtol {LOGIT_RTOL})")


def write_click_wav(path: Path, seconds: float, seed: int, bpm: float = 120.0,
                    sr: int = 44100) -> None:
    """A click track as 16-bit PCM: a quiet noise floor from `seed`, a 30 ms
    decaying 880 Hz click on every beat and a louder 1760 Hz one on every
    fourth (the downbeats)."""
    import numpy as np
    from etude_tpu_torch.utils.audio import save_wav

    rng = np.random.default_rng(seed)
    wave = 0.01 * rng.standard_normal(int(seconds * sr))
    n = int(0.03 * sr)
    t = np.arange(n) / sr
    env = np.exp(-t / 0.005)
    for i, start in enumerate(np.arange(0.25, seconds - 0.05, 60.0 / bpm)):
        s = int(start * sr)
        down = i % 4 == 0
        click = (0.8 if down else 0.4) * env * np.sin(2 * np.pi * (1760 if down else 880) * t)
        wave[s:s + n] += click[:len(wave) - s]
    save_wav(path, wave.astype(np.float32), sr)


def check_tempo(tempo, seconds):
    """tempo.json's contract: a list of regions {time_sig, bpm, start,
    downbeats} with finite numbers, positive tempo and increasing downbeats
    inside the song."""
    import math

    if not isinstance(tempo, list) or not tempo:
        raise RuntimeError(f"tempo.json holds no regions: {tempo!r:.200}")
    for r in tempo:
        if set(r) != {"time_sig", "bpm", "start", "downbeats"}:
            raise RuntimeError(f"tempo region keys {sorted(r)}")
        dbs = r["downbeats"]
        if not (isinstance(r["time_sig"], int) and r["time_sig"] > 0
                and math.isfinite(r["bpm"]) and r["bpm"] > 0
                and all(math.isfinite(x) and -1.0 <= x <= seconds + 1.0 for x in dbs)
                and all(a < b for a, b in zip(dbs, dbs[1:]))):
            raise RuntimeError(f"malformed tempo region {r!r:.200}")


def structuralize(root: Path, wav: Path) -> int:
    """Drive the port's Structuralize entry point on the card at full width
    on the 240 s click track, twice (the first run includes cuDNN's and the
    allocator's first-use costs), then once under the profiler; returns the
    warm run's K2 launches."""
    import torch
    from etude_tpu_torch.config import load_config
    from etude_tpu_torch.infer import InferencePipeline
    from etude_tpu_torch.ops.dilated_attention import dilated_attention

    config = load_config(None, {"paths": {
        "infer_output_dir": str(root / "outputs" / "infer"),
        "separator_model": str(root / "no_separator.ckpt"),
        "beat_detector_model": str(root / "no_beat.ckpt"),
    }})
    pipeline = InferencePipeline(config, device="cuda", allow_random_weights=True)
    walls = {}
    for run in ("cold", "warm"):
        pipeline.timer.spans.clear()
        torch.cuda.reset_peak_memory_stats()
        dilated_attention.launches = 0
        torch.cuda.synchronize()
        t = time.perf_counter()
        pipeline._run_stage2_structuralize(wav)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        launches = dilated_attention.launches
        spans = pipeline.timer.summary()
        say(f"  {run}: {wall:.3f} s wall, peak device memory "
            f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB, "
            f"K2 launches {launches} (expected 9)")
        for name, seconds in spans.items():
            say(f"    {name:<26s} {1e3 * seconds:10.2f} ms")
        if launches != 9:
            raise RuntimeError(f"dilated_attention launched {launches} times in one "
                               "Beat-Transformer forward, expected 9")
        walls[run] = wall
    profile_device(lambda: pipeline._run_stage2_structuralize(wav), walls["warm"])
    work = pipeline.work_dir
    beats = json.loads((work / "beat_pred.json").read_text())
    tempo = json.loads((work / "tempo.json").read_text())
    if set(beats) != {"beat_pred", "downbeat_pred"} or not beats["beat_pred"]:
        raise RuntimeError(f"beat_pred.json malformed or empty: {str(beats)[:200]}")
    check_tempo(tempo, SONG_SECONDS)
    say(f"  beat_pred.json: {len(beats['beat_pred'])} beats, "
        f"{len(beats['downbeat_pred'])} downbeats; tempo.json: {len(tempo)} region(s), "
        f"{sum(len(r['downbeats']) for r in tempo)} downbeats, "
        f"first {tempo[0]['time_sig']}/4 at {tempo[0]['bpm']:.2f} BPM")
    return launches


def device_kernels(run):
    """The device kernels of one call under torch.profiler (key averages)
    and their device time in us."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    return kernels, sum(e.self_device_time_total for e in kernels)


def profile_device(run, warm_wall: float):
    """One more warm run under torch.profiler: the device's busy time
    against the unprofiled warm wall, and the kernels that take it; returns
    the busy time in ms, or None when the profiler saw no device time."""
    kernels, total_us = device_kernels(run)
    if total_us <= 0:
        say("  profiler: no device time recorded; device busy share not measured")
        return None
    say(f"  profiler: device busy {total_us / 1e3:.2f} ms against an unprofiled warm "
        f"wall of {1e3 * warm_wall:.2f} ms -> device idle share "
        f"{1 - total_us / 1e6 / warm_wall:.3f}")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:10]:
        say(f"    {e.self_device_time_total / total_us:6.1%} {e.self_device_time_total / 1e3:9.3f} ms "
            f"{e.count:6d} launches  {e.key[:80]}")
    return total_us / 1e3


def hft_operations(c, n_segments: int):
    """(bf16, f32) operations of the hFT forward over `n_segments`: two per
    multiply-add of its matmuls and attention products, the heads in f32."""
    H, P, T, nb, nn = c.hid_dim, c.pf_dim, c.n_frame, c.n_bin, c.n_note
    cross = 2 * nn * H * H + 2 * nb * H * H + 2 * nn * nb * H     # q, o; k, v; QK, PV
    per_frame = (nb * c.n_proc * H
                 + c.encoder_n_layer * (4 * nb * H * H + 2 * nb * nb * H + 2 * nb * H * P)
                 + cross + 2 * nn * H * P
                 + (c.decoder_n_layer - 1) * (4 * nn * H * H + 2 * nn * nn * H + cross
                                              + 2 * nn * H * P)
                 + c.decoder_n_layer * (4 * nn * H * H + 2 * nn * T * H + 2 * nn * H * P))
    heads = 2 * nn * H * (3 + c.n_velocity)
    return 2 * per_frame * T * n_segments, 2 * heads * T * n_segments


def stage2_parity(root: Path):
    """The card against the port's CPU f32 path on a 12 s click track, with
    the same seeded random weights, each check beside a control that it must
    catch:

    - separation features: the card's separator at f32 (TF32 is off) against
      the CPU's, within SEP_DB_ATOL; the control scales the first conv's
      weights by 1.01. The card's production bf16 features are reported, not
      held: with random weights the U-Net's bf16 masks differ from its f32
      masks by tens of dB in some bins, in the JAX package as in the port;
    - beat activations: the card's bf16 forward (the production path, K2 in
      every layer) against the CPU's f32 one on the CPU's features, within
      ACT_ATOL; the controls zero one layer's K2 output at a time."""
    import numpy as np
    import torch
    import etude_tpu_torch.models.beat_transformer as beat_transformer
    from etude_tpu_torch.config import BeatDetectorConfig
    from etude_tpu_torch.data.beat_detector import BeatDetector
    from etude_tpu_torch.data.separation import SourceSeparator

    wav = root / "click_12s.wav"
    write_click_wav(wav, 12.0, seed=1)
    feats_cpu = SourceSeparator(device="cpu", allow_random_weights=True
                                ).separate_features(wav)
    card = SourceSeparator(device="cuda", allow_random_weights=True)
    feats_bf16 = card.separate_features(wav)
    diff = np.abs(feats_bf16 - feats_cpu)
    loud = np.minimum(feats_bf16, feats_cpu) > -40.0
    say(f"  separation features (dB), card bf16 vs CPU f32 (reported only): "
        f"max|diff| {diff.max():.3g}, mean {diff.mean():.3g}; over the "
        f"{loud.mean():.1%} of bins above -40 dB in both: max {diff[loud].max():.3g}, "
        f"mean {diff[loud].mean():.3g}")
    card.compute_dtype = torch.float32
    feats_f32 = card.separate_features(wav)
    if feats_f32.shape != feats_cpu.shape or not np.isfinite(feats_f32).all():
        raise RuntimeError(f"card f32 features non-finite or of shape {feats_f32.shape}")
    gap = float(np.abs(feats_f32 - feats_cpu).max())
    card.model.enc[0]["down"].conv.weight.data.mul_(1.01)
    control = float(np.abs(card.separate_features(wav) - feats_cpu).max())
    say(f"  separation features {feats_cpu.shape}, card f32 vs CPU f32: max|diff| "
        f"{gap:.3g} dB (limit {SEP_DB_ATOL}); control, first conv x1.01: {control:.3g} dB")
    if gap > SEP_DB_ATOL:
        raise RuntimeError(f"card vs CPU f32 features differ by {gap:.3g} dB > {SEP_DB_ATOL}")
    if control <= SEP_DB_ATOL:
        raise RuntimeError(f"the feature check missed its control ({control:.3g} dB)")

    act = {device: BeatDetector(BeatDetectorConfig(), device=device,
                                allow_random_weights=True)
           for device in ("cuda", "cpu")}
    ref = act["cpu"].activations(feats_cpu)
    out = act["cuda"].activations(feats_cpu)
    if not np.isfinite(out).all() or out.shape != ref.shape:
        raise RuntimeError("card beat activations non-finite or of the wrong shape")
    err = float(np.abs(out - ref).max())
    real = beat_transformer.dilated_attention
    controls = []
    try:
        for layer in range(9):
            def zeroed(q, k, v, er, dilation, head7_bug=False, layer=layer):
                if dilation == 2 ** layer:
                    return torch.zeros_like(q)
                return real(q, k, v, er, dilation, head7_bug=head7_bug)
            beat_transformer.dilated_attention = zeroed
            controls.append(float(np.abs(act["cuda"].activations(feats_cpu) - ref).max()))
    finally:
        beat_transformer.dilated_attention = real
    say(f"  beat activations [{ref.shape[0]} frames, 2], card bf16 vs CPU f32: "
        f"max|diff| {err:.3g} (atol {ACT_ATOL}); controls, one layer's K2 output "
        f"zeroed: {' '.join(f'{c:.3g}' for c in controls)}")
    if err > ACT_ATOL:
        raise RuntimeError(f"card vs CPU beat activations differ by {err:.3g} > {ACT_ATOL}")
    if min(controls) <= ACT_ATOL:
        raise RuntimeError(f"the activation check missed a control ({min(controls):.3g})")


def check_notes(notes, seconds, min_duration=0.08):
    """extract.json's contract: {onset, offset, pitch, velocity} per note,
    finite times inside the song, at least the minimum duration, piano
    pitches, MIDI velocities, sorted by (onset, pitch)."""
    import math

    if not isinstance(notes, list):
        raise RuntimeError(f"extract.json holds no list: {notes!r:.200}")
    for n in notes:
        if (set(n) != {"onset", "offset", "pitch", "velocity"}
                or not (math.isfinite(n["onset"]) and math.isfinite(n["offset"]))
                or not -1e-9 <= n["onset"] < n["offset"] <= seconds + 1.0
                or n["offset"] - n["onset"] < min_duration
                or not (21 <= n["pitch"] <= 108 and 1 <= n["velocity"] <= 127)):
            raise RuntimeError(f"malformed note {n!r:.200}")
    if notes != sorted(notes, key=lambda n: (n["onset"], n["pitch"])):
        raise RuntimeError("extract.json is not sorted by (onset, pitch)")


def extract(root: Path, wav: Path) -> None:
    """Drive the port's Extract entry point on the card at the committed
    extractor's full width (random weights from seed 0) on the 240 s click
    track, cold and warm, then once under the profiler."""
    import torch
    from etude_tpu_torch.config import ExtractorConfig
    from etude_tpu_torch.data.extractor import AMTAPC_Extractor
    from etude_tpu_torch.utils.profiling import StageTimer

    extractor = AMTAPC_Extractor(ExtractorConfig(), model_path=root / "no_extractor.ckpt",
                                 device="cuda", allow_random_weights=True)
    c = extractor.amt_config
    say(f"  hFT: {sum(p.numel() for p in extractor.model.parameters())} parameters, hidden "
        f"{c.hid_dim}, {c.encoder_n_layer}+{c.decoder_n_layer}+{c.decoder_n_layer} layers of "
        f"{c.encoder_n_head} heads, {c.n_frame}-frame segments, {extractor.segment_batch} "
        f"per forward")
    timer = StageTimer(torch.device("cuda"))
    out = root / "extract.json"
    walls = {}
    for run in ("cold", "warm"):
        timer.spans.clear()
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        t = time.perf_counter()
        notes = extractor.extract(wav, out, timer=timer)
        torch.cuda.synchronize()
        walls[run] = time.perf_counter() - t
        st = extractor.stats
        say(f"  {run}: {walls[run]:.3f} s wall, peak device memory "
            f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; {st['segments']} segments "
            f"in {st['groups']} groups; {st['notes_picked']} notes picked, "
            f"{st['notes_kept']} kept after the minimum-duration filter")
        for name, seconds in timer.summary().items():
            say(f"    {name:<26s} {1e3 * seconds:10.2f} ms")
        if st["notes_picked"] == 0:
            raise RuntimeError("the peak picker found no onset in the hFT's maps")
    busy = profile_device(lambda: extractor.extract(wav, out), walls["warm"])
    st = extractor.stats
    bf16, f32 = hft_operations(c, st["groups"] * extractor.segment_batch)
    bound_ms = 1e3 * (bf16 / BF16_PEAK + f32 / F32_PEAK)
    say(f"  hFT forward over {st['groups'] * extractor.segment_batch} segments: "
        f"{bf16 / 1e12:.2f} TFLOP bf16 + {f32 / 1e12:.3f} TFLOP f32 -> at the card's peaks "
        f"{bound_ms:.2f} ms; the device was busy {busy or float('nan'):.2f} ms for all of "
        f"Extract ({(busy or float('nan')) / bound_ms:.1f}x)")
    loaded = json.loads(out.read_text())
    check_notes(loaded, SONG_SECONDS)
    if loaded != notes:
        raise RuntimeError("extract.json differs from the notes extract returned")
    frontend_ab(extractor)


def frontend_ab(extractor) -> None:
    """The folded front end as the port computes it (one matmul over the
    n_proc-frame windows, its output already [B, T, bin, H]) against
    `F.conv2d` of the same filter and the copy to that layout, at the main
    path's shape, bf16, L2 flushed."""
    import torch
    import torch.nn.functional as F
    from etude_tpu_torch.utils.kernel_bench import L2Flush, time_ms

    c = extractor.amt_config
    gen = torch.Generator(device="cuda").manual_seed(3)
    spec = torch.randn(extractor.segment_batch, c.n_bin, c.n_frame + 2 * c.n_margin,
                       device="cuda", generator=gen).to(torch.bfloat16)
    wf = extractor.model.folded_frontend()[0].to(torch.bfloat16)

    def matmul():
        return spec.transpose(1, 2).unfold(1, c.n_proc, 1) @ wf

    def conv():
        return F.conv2d(spec[:, None], wf.T[:, None, None, :]).permute(0, 3, 2, 1).contiguous()

    a, b = matmul(), conv()
    err = (a.float() - b.float()).abs().max().item()
    flush = L2Flush()
    say(f"  front end at [{spec.shape[0]}, {c.n_bin}, {spec.shape[2]}] x [{c.n_proc}, "
        f"{c.hid_dim}] bf16: unfold+matmul {time_ms(matmul, flush=flush):.4f} ms, "
        f"F.conv2d+copy {time_ms(conv, flush=flush):.4f} ms, max|diff| {err:.3g}")


def extract_parity(root: Path, model_path: Optional[Path] = None) -> None:
    """The card's bf16 hFT heads against the port's CPU f32 path on the first
    segment of a 12 s click track, same weights (`model_path`, else seeded
    random ones), beside controls it must catch: one attention layer's
    output zeroed at a time on the card. The card's f32 log-mel (TF32 off)
    against the CPU's is reported."""
    import numpy as np
    import torch
    import etude_tpu_torch.models.amt as amt
    from etude_tpu_torch.config import ExtractorConfig
    from etude_tpu_torch.data.extractor import AMTAPC_Extractor

    wav = root / "click_12s.wav"
    write_click_wav(wav, 12.0, seed=1)
    make = {device: AMTAPC_Extractor(ExtractorConfig(), model_path=model_path or root / "none.ckpt",
                                     device=device, allow_random_weights=model_path is None)
            for device in ("cpu", "cuda")}
    feature = make["cpu"]._wav2feature(wav)
    mel_gap = (make["cuda"]._wav2feature(wav).cpu() - feature).abs().max().item()
    segs, _ = make["cpu"]._segment(feature.numpy())
    spec = torch.from_numpy(segs[:1])
    keys = [f"{h}_{b}" for h in amt.HEADS for b in ("freq", "time")]

    def heads(device):
        x = make[device]
        with torch.inference_mode():
            out = x.model(spec.to(x.device), x.compute_dtype)
        return {k: out[k].cpu().numpy() for k in keys}

    ref, out = heads("cpu"), heads("cuda")
    if not all(np.isfinite(out[k]).all() and out[k].shape == ref[k].shape for k in keys):
        raise RuntimeError("card hFT heads non-finite or of the wrong shape")
    err = max(float(np.abs(out[k] - ref[k]).max()) for k in keys)
    model = make["cuda"].model
    layers = ([(f"enc{i}", layer.attn) for i, layer in enumerate(model.enc_layers)]
              + [("dec0.cross", model.dec_zero.cross)]
              + [(f"dec{i + 1}.{n}", getattr(layer, a)) for i, layer in enumerate(model.dec_layers)
                 for n, a in (("self", "self_attn"), ("cross", "cross"))]
              + [(f"time{i}", layer.attn) for i, layer in enumerate(model.time_layers)])
    real = amt._mha
    controls = {}
    try:
        for name, target in layers:
            def zeroed(q_in, kv_in, p, n_heads, dtype, target=target):
                out = real(q_in, kv_in, p, n_heads, dtype)
                return torch.zeros_like(out) if p is target else out
            amt._mha = zeroed
            got = heads("cuda")
            controls[name] = max(float(np.abs(got[k] - ref[k]).max()) for k in keys)
    finally:
        amt._mha = real
    say(f"  log-mel [{feature.shape[0]}, {feature.shape[1]}], card f32 vs CPU f32 (reported "
        f"only): max|diff| {mel_gap:.3g}")
    say(f"  hFT heads [1 segment, {spec.shape[2]} frames], card bf16 vs CPU f32: max|diff| "
        f"{err:.3g} (atol {HFT_ATOL}); controls, one attention layer's output zeroed: "
        + " ".join(f"{n} {v:.3g}" for n, v in controls.items()))
    if err > HFT_ATOL:
        raise RuntimeError(f"card vs CPU hFT heads differ by {err:.3g} > {HFT_ATOL}")
    if min(controls.values()) <= HFT_ATOL:
        raise RuntimeError(f"the hFT check missed a control ({min(controls.values()):.3g})")


def pipeline_settings(root: Path, repo: Path) -> Path:
    """A settings file that points the CLI at `root`, with every model path
    missing (random weights from seed 0), the full-width decoder config, and
    bars capped at 32 tokens: the tempo grid of a 240 s song holds over a
    hundred bars, and random weights rarely end a bar early."""
    settings = root / "settings.json"
    root.mkdir(parents=True, exist_ok=True)
    settings.write_text(json.dumps({
        "paths": {
            "infer_output_dir": str(root / "outputs" / "infer"),
            "extractor_model": str(root / "no_extractor.ckpt"),
            "separator_model": str(root / "no_separator.ckpt"),
            "beat_detector_model": str(root / "no_beat.ckpt"),
            "decoder_config": str(repo / "checkpoints/decoder/etude_decoder_config.json"),
            "decoder_vocab": str(repo / "checkpoints/decoder/vocab.json"),
            "decoder_model": str(root / "no_decoder.ckpt"),
        },
        "decoder": {"max_bar_token_limit": 32},
    }))
    return settings


def pipeline(root: Path, wav: Path):
    """`python -m etude_tpu_torch.infer --input` in-process on the 240 s song;
    returns the work dir and the run's K1 and K2 launches."""
    import torch
    from etude_tpu_torch import infer
    from etude_tpu_torch.ops.decode_attention import decode_attention
    from etude_tpu_torch.ops.dilated_attention import dilated_attention
    from etude_tpu_torch.utils.midi import read_midi_notes

    settings = pipeline_settings(root, ROOT)
    decode_attention.launches = dilated_attention.launches = 0
    torch.cuda.synchronize()
    t = time.perf_counter()
    rc = infer.main(["--config", str(settings), "--input", str(wav), "--allow-random-weights",
                     "--output_name", "pipeline", "--seed", "7"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    k1, k2 = decode_attention.launches, dilated_attention.launches
    work = root / "outputs" / "infer" / "temp"
    midi = root / "outputs" / "infer" / "pipeline.mid"
    if rc != 0 or not midi.exists():
        raise RuntimeError(f"infer --input exited {rc}; {midi} exists: {midi.exists()}")
    notes = json.loads((work / "extract.json").read_text())
    check_notes(notes, SONG_SECONDS)
    volume = json.loads((work / "volume.json").read_text())
    if (len(volume) != 1 + int(SONG_SECONDS * 22050) // (22050 // 20)
            or not all(0.0 <= v <= 1.0 for v in volume)):
        raise RuntimeError(f"volume.json malformed: {len(volume)} values")
    beats = json.loads((work / "beat_pred.json").read_text())
    if set(beats) != {"beat_pred", "downbeat_pred"} or not beats["beat_pred"]:
        raise RuntimeError(f"beat_pred.json malformed or empty: {str(beats)[:200]}")
    tempo = json.loads((work / "tempo.json").read_text())
    check_tempo(tempo, SONG_SECONDS)
    played = read_midi_notes(midi)
    say(f"  --input wall {wall:.3f} s; extract.json {len(notes)} notes, volume.json "
        f"{len(volume)} values, {len(beats['beat_pred'])} beats, tempo.json "
        f"{len(tempo)} region(s); {midi.name}: {midi.stat().st_size} bytes, {len(played)} "
        f"notes; launches K1 {k1}, K2 {k2} (expected 9)")
    if k2 != 9:
        raise RuntimeError(f"dilated_attention launched {k2} times, expected 9")
    if k1 == 0 or k1 % 8:
        raise RuntimeError(f"decode_attention launched {k1} times, not 8 per S=1 chunk")
    return work, k1, k2


PREP_SONGS = ((10, 2, 0.2), (11, -3, 0.1))   # (seed, transposition, cover offset in s)


def cover_warp(t, offset, bump=None):
    """The cover's time for origin time t: shifted by `offset` and swung by
    ±WARP_SECONDS over WARP_PERIOD; `bump` = (start, end, seconds) adds a
    smooth detour of `seconds` between start and end (a re-warped
    segment)."""
    import numpy as np

    w = t + offset + WARP_SECONDS * np.sin(2 * np.pi * t / WARP_PERIOD)
    if bump is not None:
        lo, hi, amount = bump
        if lo < t < hi:
            w += amount * np.sin(np.pi * (t - lo) / (hi - lo)) ** 2
    return float(w)


def pair_notes(seed, seconds, transpose, offset, bump=None):
    """(origin notes, cover notes) from a seed: random piano notes, and the
    same transposed by `transpose` semitones and time-warped by
    `cover_warp`."""
    import numpy as np
    from etude_tpu_torch.data.synthetic import synth_piano_notes

    notes = synth_piano_notes(np.random.default_rng(seed), seconds)
    return notes, [{"onset": cover_warp(n["onset"], offset, bump),
                    "offset": cover_warp(n["offset"], offset, bump),
                    "pitch": min(max(n["pitch"] + transpose, 21), 108),
                    "velocity": n["velocity"]} for n in notes]


def render_pair(seed, seconds, transpose, offset, origin_sr=ORIGIN_SR, bump=None):
    """(origin, cover): the piano renders of `pair_notes`, the cover at the
    aligner's 22.05 kHz."""
    from etude_tpu_torch.data.synthetic import render_piano

    notes, cover_notes = pair_notes(seed, seconds, transpose, offset, bump)
    return (render_piano(notes, seconds, sr=origin_sr),
            render_piano(cover_notes, cover_warp(seconds, offset) + 0.5, sr=ALIGN_SR))


def prepare_settings(root: Path) -> Path:
    """The corpus dirs under `root`, every model path missing (random
    weights from seed 0) and PREP_THRESHOLDS."""
    settings = root / "prepare.json"
    settings.write_text(json.dumps({
        "paths": {"raw_dir": str(root / "raw"), "processed_dir": str(root / "processed"),
                  "aligned_dir": str(root / "aligned"), "tokenized_dir": str(root / "tokenized"),
                  "dataset_vocab": str(root / "vocab.json"),
                  "hft_model": str(root / "no_hft.ckpt"),
                  "separator_model": str(root / "no_separator.ckpt"),
                  "beat_detector_model": str(root / "no_beat.ckpt"),
                  "extractor_model": str(root / "no_extractor.ckpt")},
        **PREP_THRESHOLDS,
    }))
    return settings


def device_profile(run):
    """(device kernels launched, their device time in ms) of one call;
    (None, None) when the profiler saw no device time."""
    kernels, total_us = device_kernels(run)
    if total_us <= 0:
        return None, None
    return sum(e.count for e in kernels), total_us / 1e3


def warm_wall(run) -> float:
    """Wall seconds of a second, warm call."""
    import torch

    run()
    torch.cuda.synchronize()
    t = time.perf_counter()
    run()
    torch.cuda.synchronize()
    return time.perf_counter() - t


def check_prepared(root: Path) -> None:
    """The outputs of stages 2-5: transcriptions, beat grids, a kept
    alignment per song that recovers the cover's known transposition and
    warp, condition notes, the vocabulary and in-range token ids."""
    import numpy as np
    from etude_tpu_torch.data.vocab import Vocab

    meta = json.loads((root / "aligned" / "metadata.json").read_text())
    names = [f"{k + 1:04d}" for k in range(len(PREP_SONGS))]
    if [m["dir_name"] for m in meta] != names or any(m["status"] != "kept" for m in meta):
        raise RuntimeError(f"stage 3 did not keep every song: {meta}")
    vocab = Vocab.load(root / "vocab.json")
    for name, m, (seed, transpose, offset) in zip(names, meta, PREP_SONGS):
        processed, aligned = root / "processed" / name, root / "aligned" / name
        transcription = json.loads((processed / "transcription.json").read_text())
        check_tempo(json.loads((processed / "tempo.json").read_text()), SONG_SECONDS)
        align = json.loads((processed / "wp.json").read_text())["cover"]
        wp = np.asarray(align["wp"], float)
        if align["pitch_shift"] != -transpose:
            raise RuntimeError(f"{name}: pitch shift {align['pitch_shift']}, the cover is "
                               f"transposed by {transpose}")
        # Origin time at the path's cover frames against the known warp.
        origin_t, cover_t = wp[1] / 50.0, wp[0] / 50.0
        grid = np.linspace(0.0, SONG_SECONDS, 2401)
        expected = np.interp(cover_t, [cover_warp(t, offset) for t in grid], grid)
        inner = (origin_t > 5.0) & (origin_t < SONG_SECONDS - 5.0)
        if not inner.any():
            raise RuntimeError(f"{name}: the path has no point inside the song")
        dev = float(np.median(np.abs(origin_t[inner] - expected[inner])))
        cover_notes = json.loads((aligned / "cover.json").read_text())
        extract = json.loads((aligned / "extract.json").read_text())
        # The extractor peak-picks its maps padded to the last 512-frame
        # segment's end (as the reference does), so the last note's offset
        # may lie past the song.
        check_notes(extract, -(-(int(SONG_SECONDS * 16000) // 256 + 1) // 512) * 512 * 256 / 16000)
        ids = {side: np.load(root / "tokenized" / name / f"{name}_{side}.npy")
               for side in ("src", "tgt")}
        say(f"  {name}: transcription.json {len(transcription)} notes; WP-Std "
            f"{m['wp_std']:.4f} s; path {wp.shape[1]} points, pitch shift "
            f"{align['pitch_shift']}, median |origin time - known warp| {dev:.4f} s; "
            f"cover.json {len(cover_notes)} notes; extract.json {len(extract)} notes; "
            f"tokens src {ids['src'].size}, tgt {ids['tgt'].size}")
        if not (transcription and cover_notes and extract):
            raise RuntimeError(f"{name}: a stage kept no note")
        if dev > 0.2:
            raise RuntimeError(f"{name}: the path is {dev:.3f} s from the known warp")
        for side, x in ids.items():
            if x.dtype != np.int32 or x.size == 0 or x.min() < 0 or x.max() >= len(vocab):
                raise RuntimeError(f"{name}_{side}: {x.size} ids of {x.dtype} outside "
                                   f"the vocabulary of {len(vocab)}")
    say(f"  vocab.json: {len(vocab)} tokens")


def wavefront_cost(origin, cover, device):
    """cost(factor): the aligner's cost matrix of a pair at 22.05 kHz on
    `device`, from its features (tuning, chroma, key shift) as
    `compute_warping_path` builds them, averaged over `factor` frames
    (16 is MrMsDTW's coarsest level, 1 the full DTW)."""
    import numpy as np
    from etude_tpu_torch.ops import chroma as ch
    from etude_tpu_torch.ops.dtw import _smooth_downsample, dtw_cost

    tc, to = ch.estimate_tuning(cover), ch.estimate_tuning(origin)
    c_c, c_o = ch.chroma_features(cover, tuning_cents=tc, device=device)
    o_c, o_o = ch.chroma_features(origin, tuning_cents=to, device=device)
    shift = ch.optimal_chroma_shift(c_c, o_c)
    o_c, o_o = np.roll(o_c, shift, axis=1), np.roll(o_o, shift, axis=1)
    return lambda factor: dtw_cost(*_smooth_downsample(c_c, c_o, factor),
                                   *_smooth_downsample(o_c, o_o, factor), device=device)


def wavefront_timing(label, cost) -> None:
    """The wavefront on one cost matrix on the card: warm wall, device
    kernels and their time."""
    from etude_tpu_torch.ops.dtw import _dtw_scan

    N, M = cost.shape
    wall = warm_wall(lambda: _dtw_scan(cost))
    launches, busy = device_profile(lambda: _dtw_scan(cost))
    say(f"  wavefront {label} [{N} x {M}], {N + M - 2} diagonals: warm wall "
        f"{1e3 * wall:.2f} ms; " + (
            f"{launches} device kernels ({launches / (N + M - 2):.2f} per diagonal), device "
            f"busy {busy:.2f} ms, idle share {1 - busy / 1e3 / wall:.3f}"
            if launches else "profiler saw no device time"))


def hft_timing(root: Path) -> None:
    """The hFT stride transcription of song 0001's 240 s cover on the card
    at the HFT settings: warm wall and device time against the forward's
    operation bound."""
    import torch
    from etude_tpu_torch.config import load_config
    from etude_tpu_torch.data.hft import HFT_Transformer

    config = load_config(root / "prepare.json")
    hft = HFT_Transformer(config.hft, model_path=config.paths.hft_model, device="cuda",
                          allow_random_weights=True)
    feature = hft._wav2feature(root / "raw" / "0001" / "cover.wav")
    wall = warm_wall(lambda: hft._transcript_stride(feature))
    _, busy = device_profile(lambda: hft._transcript_stride(feature))
    st, c = hft.stats, hft.amt_config
    bf16, f32 = hft_operations(c, st["groups"] * hft.segment_batch)
    bound_ms = 1e3 * (bf16 / BF16_PEAK + f32 / F32_PEAK)
    say(f"  hFT stride transcription, {feature.shape[0]} frames: {st['segments']} windows of "
        f"{c.n_frame + 2 * c.n_margin} frames in {st['groups']} groups of "
        f"{hft.segment_batch}; warm wall {1e3 * wall:.2f} ms, device busy "
        f"{busy or float('nan'):.2f} ms; {bf16 / 1e12:.2f} TFLOP bf16 + {f32 / 1e12:.3f} TFLOP "
        f"f32 -> bound {bound_ms:.2f} ms ({(busy or float('nan')) / bound_ms:.1f}x)")
    del hft
    torch.cuda.empty_cache()


def path_deviation(a, b) -> float:
    """Largest gap, in origin frames, between two paths read as functions of
    the cover frame."""
    import numpy as np

    grid = np.arange(max(a[0][-1], b[0][-1]) + 1)
    return float(np.abs(np.interp(grid, a[0], a[1]) - np.interp(grid, b[0], b[1])).max())


def align_parity() -> None:
    """The card against the port's CPU f32 path on a 30 s pair, each check
    beside a control that it must catch:

    - chroma and onset features (control: the tuning shifted by a
      semitone), within CHROMA_ATOL and ONSET_ATOL;
    - the wavefront's codes on the CPU's cost matrix, equal bit for bit
      (control: one row of the cost perturbed on the card);
    - the aligner's path and WPD, within PATH_FRAMES and WPD_ATOL
      (control: the cover with one segment re-warped by 0.6 s)."""
    import numpy as np
    import torch
    from etude_tpu_torch.data.aligner import AudioAligner
    from etude_tpu_torch.evaluation.metrics import WPDCalculator
    from etude_tpu_torch.ops import chroma as ch
    from etude_tpu_torch.ops.dtw import _dtw_scan

    seed, transpose, offset = 12, 4, 0.15
    origin, cover = render_pair(seed, 30.0, transpose, offset, origin_sr=ALIGN_SR)
    tuning = ch.estimate_tuning(cover)
    ref = ch.chroma_features(cover, tuning_cents=tuning, device="cpu")
    got = ch.chroma_features(cover, tuning_cents=tuning, device="cuda")
    moved = ch.chroma_features(cover, tuning_cents=tuning + 100.0, device="cuda")
    gaps = [float(np.abs(g - r).max()) for g, r in zip(got, ref)]
    controls = [float(np.abs(g - r).max()) for g, r in zip(moved, ref)]
    say(f"  chroma / onset features [{ref[0].shape[0]}, 12], card vs CPU f32: max|diff| "
        f"{gaps[0]:.3g} / {gaps[1]:.3g} (limits {CHROMA_ATOL} / {ONSET_ATOL}); control, "
        f"tuning + 100 cents: {controls[0]:.3g} / {controls[1]:.3g}")
    if gaps[0] > CHROMA_ATOL or gaps[1] > ONSET_ATOL:
        raise RuntimeError(f"card vs CPU features differ by {gaps}")
    if controls[0] <= CHROMA_ATOL or controls[1] <= ONSET_ATOL:
        raise RuntimeError(f"the feature check missed its control ({controls})")

    cost = wavefront_cost(origin, cover, "cpu")(1)
    _, codes = _dtw_scan(cost)
    final_card, codes_card = _dtw_scan(cost.cuda())
    perturbed = cost.cuda()
    perturbed[cost.shape[0] // 2] += 0.25
    _, codes_control = _dtw_scan(perturbed)
    equal = torch.equal(codes_card.cpu(), codes)
    control_equal = torch.equal(codes_control.cpu(), codes)
    say(f"  wavefront codes [{codes.shape[0]} x {codes.shape[1]}] uint8 on the CPU's cost "
        f"[{cost.shape[0]} x {cost.shape[1]}]: card equal to CPU: {equal}; control, one row "
        f"+0.25 on the card: equal {control_equal} "
        f"({int((codes_control.cpu() != codes).sum())} codes differ)")
    if not equal:
        raise RuntimeError(f"card wavefront codes differ from the CPU's in "
                           f"{int((codes_card.cpu() != codes).sum())} places")
    if control_equal:
        raise RuntimeError("the wavefront check missed its control")

    wpd = WPDCalculator(trim_seconds=0)
    cpu = AudioAligner(device="cpu").compute_warping_path(origin, cover)
    card = AudioAligner(device="cuda").compute_warping_path(origin, cover)
    _, rewarped = render_pair(seed, 30.0, transpose, offset, origin_sr=ALIGN_SR,
                              bump=(10.0, 16.0, 0.6))
    control = AudioAligner(device="cuda").compute_warping_path(origin, rewarped)
    scores = [wpd.calculate(r)["wpd_score"] for r in (cpu, card, control)]
    dev, control_dev = path_deviation(card["wp"], cpu["wp"]), path_deviation(
        control["wp"], cpu["wp"])
    say(f"  aligner path [{cpu['wp'].shape[1]} points], card vs CPU: largest gap {dev:.1f} "
        f"frames (limit {PATH_FRAMES}), WPD {scores[1]:.5f} vs {scores[0]:.5f} s (limit "
        f"{WPD_ATOL}); control, one segment re-warped by 0.6 s: gap {control_dev:.1f} "
        f"frames, WPD {scores[2]:.5f} s; pitch shift {card['pitch_shift']} (cover "
        f"transposed by {transpose})")
    if dev > PATH_FRAMES or abs(scores[1] - scores[0]) > WPD_ATOL:
        raise RuntimeError(f"card vs CPU alignment differs: {dev} frames, WPD {scores}")
    if control_dev <= PATH_FRAMES or abs(scores[2] - scores[0]) <= WPD_ATOL:
        raise RuntimeError(f"the alignment check missed its control ({control_dev} frames, "
                           f"WPD {scores})")
    if card["pitch_shift"] != -transpose:
        raise RuntimeError(f"card pitch shift {card['pitch_shift']}")


def hft_parity() -> None:
    """The card's bf16 hFT stride maps against the port's CPU f32 path on
    the first 96 frames of a 12 s cover render (three windows, one group
    of four), same seeded weights, within HFT_ATOL, beside controls it must
    catch: one attention layer's output zeroed at a time on the card."""
    import numpy as np
    import torch
    import etude_tpu_torch.models.amt as amt
    from etude_tpu_torch.config import HFTConfig
    from etude_tpu_torch.data.hft import HFT_Transformer
    from etude_tpu_torch.utils.audio import save_wav

    with tempfile.TemporaryDirectory() as tmp:
        wav = Path(tmp) / "cover.wav"
        save_wav(wav, render_pair(13, 12.0, 0, 0.0)[1], ALIGN_SR)
        make = {device: HFT_Transformer(HFTConfig(), model_path=Path(tmp) / "none.ckpt",
                                        segment_batch=4, device=device,
                                        allow_random_weights=True)
                for device in ("cpu", "cuda")}
        feature = make["cpu"]._wav2feature(wav)[:96]
    ref = make["cpu"]._transcript_stride(feature)
    keys = [k for k in ref if not k.startswith("velocity")]

    def gap(maps):
        return max(float(np.abs(maps[k] - ref[k]).max()) for k in keys)

    out = make["cuda"]._transcript_stride(feature)
    if not all(np.isfinite(out[k]).all() and out[k].shape == ref[k].shape for k in ref):
        raise RuntimeError("card hFT stride maps non-finite or of the wrong shape")
    err = gap(out)
    velocity = float((out["velocity_time"] != ref["velocity_time"]).mean())
    model = make["cuda"].model
    layers = ([(f"enc{i}", layer.attn) for i, layer in enumerate(model.enc_layers)]
              + [("dec0.cross", model.dec_zero.cross)]
              + [(f"dec{i + 1}.{n}", getattr(layer, a)) for i, layer in enumerate(model.dec_layers)
                 for n, a in (("self", "self_attn"), ("cross", "cross"))]
              + [(f"time{i}", layer.attn) for i, layer in enumerate(model.time_layers)])
    real = amt._mha
    controls = {}
    try:
        for name, target in layers:
            def zeroed(q_in, kv_in, p, n_heads, dtype, target=target):
                o = real(q_in, kv_in, p, n_heads, dtype)
                return torch.zeros_like(o) if p is target else o
            amt._mha = zeroed
            controls[name] = gap(make["cuda"]._transcript_stride(feature))
    finally:
        amt._mha = real
    say(f"  hFT stride maps [{feature.shape[0]} frames, 3 windows], card bf16 vs CPU f32: "
        f"max|diff| {err:.3g} (atol {HFT_ATOL}), velocity argmax differs in {velocity:.2%}; "
        "controls, one attention layer's output zeroed: "
        + " ".join(f"{n} {v:.3g}" for n, v in controls.items()))
    if err > HFT_ATOL:
        raise RuntimeError(f"card vs CPU hFT stride maps differ by {err:.3g} > {HFT_ATOL}")
    if min(controls.values()) <= HFT_ATOL:
        raise RuntimeError(f"the stride-map check missed a control ({min(controls.values()):.3g})")


def prepare_phase(root: Path) -> int:
    """`python -m etude_tpu_torch.prepare --start-from preprocess` in-process
    on a synthesized two-song corpus at 240 s, at full width under random
    weights (PREP_THRESHOLDS), with the spans of every stage and song (song
    0001 is cold, 0002 warm: stage 2 makes its models once); then the
    wavefront and the hFT timed alone and the card-against-CPU checks.
    Returns the run's K2 launches."""
    import torch
    from etude_tpu_torch import prepare
    from etude_tpu_torch.ops.dilated_attention import dilated_attention
    from etude_tpu_torch.utils.audio import decode_audio, save_wav
    from etude_tpu_torch.utils.profiling import StageTimer

    t = time.perf_counter()
    for k, (seed, transpose, offset) in enumerate(PREP_SONGS):
        origin, cover = render_pair(seed, SONG_SECONDS, transpose, offset)
        save_wav(root / "raw" / f"{k + 1:04d}" / "origin.wav", origin, ORIGIN_SR)
        save_wav(root / "raw" / f"{k + 1:04d}" / "cover.wav", cover, ALIGN_SR)
    say(f"  corpus: {len(PREP_SONGS)} songs, {SONG_SECONDS:.0f} s origin.wav at {ORIGIN_SR} Hz, "
        f"cover.wav transposed {[s[1] for s in PREP_SONGS]} and warped ±{WARP_SECONDS} s at "
        f"{ALIGN_SR} Hz (set-up {time.perf_counter() - t:.2f} s); settings {PREP_THRESHOLDS}")
    settings = prepare_settings(root)
    timer = StageTimer(torch.device("cuda"))
    dilated_attention.launches = 0
    torch.cuda.synchronize()
    t = time.perf_counter()
    rc = prepare.main(["--config", str(settings), "--start-from", "preprocess",
                       "--allow-random-weights"], timer=timer)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    launches = dilated_attention.launches
    say(f"  prepare --start-from preprocess: rc {rc}, wall {wall:.3f} s, K2 launches "
        f"{launches} (expected {9 * len(PREP_SONGS)})")
    for span in timer.spans:
        say(f"    {span['name']:<40s} {1e3 * span['seconds']:10.2f} ms")
    if rc != 0:
        raise RuntimeError(f"prepare exited {rc}")
    if launches != 9 * len(PREP_SONGS):
        raise RuntimeError(f"dilated_attention launched {launches} times in stage 2, expected "
                           f"9 per song")
    check_prepared(root)

    origin, _ = decode_audio(root / "raw" / "0001" / "origin.wav", target_sr=ALIGN_SR)
    cover, _ = decode_audio(root / "raw" / "0001" / "cover.wav", target_sr=ALIGN_SR)
    wavefront_timing("coarse (song 0001 at 1/16)", wavefront_cost(origin, cover, "cuda")(16))
    n30 = 30 * ALIGN_SR
    wavefront_timing("full (its first 30 s)",
                     wavefront_cost(origin[:n30], cover[:n30], "cuda")(1))
    from etude_tpu_torch.data.aligner import AudioAligner

    spans = StageTimer(torch.device("cuda"))
    AudioAligner(device="cuda").compute_warping_path(origin[:n30], cover[:n30], timer=spans)
    say("  aligner on the 30 s pair (full wavefront): " + ", ".join(
        f"{s['name']} {1e3 * s['seconds']:.2f} ms" for s in spans.spans))
    hft_timing(root)
    align_parity()
    hft_parity()
    return launches


def evaluate_phase(root: Path, prepared: Path, midi: Path) -> None:
    """`python -m etude_tpu_torch.evaluate` in-process on an eval dir of the
    prepare phase's songs, each with origin.wav and three versions: `human`
    (the cover's .wav and the notes it was rendered from, as a .mid),
    `transcribed` (the same .wav and its stage-2 transcription .json) and
    `etude_d` (the pipeline phase's MIDI and its render). Every row must
    hold a finite WPD, RGC and IPE but where the metric itself declines, for
    a reason that random weights give and that is printed: the
    transcriber's onsets come in clusters of pitches on the same frames,
    whose most common intervals lie under RGC's 0.01 s floor; the random
    decoder runs every bar to its token cap without a note, so its MIDI has
    no onset for RGC and IPE (its render is silence)."""
    import csv
    import math
    import shutil

    import torch
    from etude_tpu_torch import evaluate
    from etude_tpu_torch.data.synthetic import render_piano
    from etude_tpu_torch.evaluation.metrics import IPECalculator, RGCCalculator
    from etude_tpu_torch.utils.audio import save_wav
    from etude_tpu_torch.utils.midi import read_midi_notes, write_midi
    from etude_tpu_torch.utils.profiling import StageTimer

    notes = read_midi_notes(midi)
    render = render_piano(notes, max([n["offset"] + 1.0 for n in notes] + [SONG_SECONDS]),
                          sr=ALIGN_SR)
    names = [f"{k + 1:04d}" for k in range(len(PREP_SONGS))]
    versions = ("human", "transcribed", "etude_d")
    for name, (seed, transpose, offset) in zip(names, PREP_SONGS):
        song = root / "songs" / name
        song.mkdir(parents=True)
        shutil.copy(prepared / "raw" / name / "origin.wav", song / "origin.wav")
        for version in ("human", "transcribed"):
            shutil.copy(prepared / "raw" / name / "cover.wav", song / f"{version}.wav")
        write_midi(pair_notes(seed, SONG_SECONDS, transpose, offset)[1], song / "human.mid")
        shutil.copy(prepared / "processed" / name / "transcription.json",
                    song / "transcribed.json")
        shutil.copy(midi, song / "etude_d.mid")
        save_wav(song / "etude_d.wav", render, ALIGN_SR)
    (root / "songs" / "metadata.json").write_text(json.dumps([{"dir_name": n} for n in names]))
    settings = root / "evaluate.json"
    settings.write_text(json.dumps({
        "paths": {"eval_output_dir": str(root / "out")},
        "eval": {"eval_dir": str(root / "songs"),
                 "metadata_path": str(root / "songs" / "metadata.json"),
                 "versions": {"human": "Human", "transcribed": "Transcribed (stage 2)",
                              "etude_d": "Etude Decoder - Prompted"}},
    }))
    timer = StageTimer(torch.device("cuda"))
    t = time.perf_counter()
    rc = evaluate.main(["--config", str(settings)], timer=timer)
    wall = time.perf_counter() - t
    path = root / "out" / "evaluation_results.csv"
    if rc != 0 or not path.exists():
        raise RuntimeError(f"evaluate exited {rc}; {path} exists: {path.exists()}")
    with open(path, newline="") as f:
        rows = list(csv.DictReader(f))
    say(f"  evaluate: wall {wall:.3f} s for {len(names)} songs x {len(versions)} versions ("
        + ", ".join(f"{s['name']} {s['seconds']:.3f} s" for s in timer.spans) + ")")
    for row in rows:
        say(f"    {row['song']} {row['version']:<12s} WPD {row['wpd']} RGC {row['rgc'] or '-'} "
            f"IPE {row['ipe']}")
    if [(r["song"], r["version"]) for r in rows] != [(n, v) for n in names for v in versions]:
        raise RuntimeError(f"evaluation rows {[(r['song'], r['version']) for r in rows]}")
    declines = {("transcribed", "rgc"): "could not infer a grid period"}
    if not notes:
        declines.update({("etude_d", "rgc"): "not enough onsets",
                         ("etude_d", "ipe"): "not enough onsets"})
    calculators = {"rgc": RGCCalculator(), "ipe": IPECalculator()}
    for row in rows:
        song, version = root / "songs" / row["song"], row["version"]
        for key in ("wpd", "rgc", "ipe"):
            if row[key] and math.isfinite(float(row[key])):
                continue
            if (version, key) in declines:
                file = song / (f"{version}.json" if version == "transcribed" else f"{version}.mid")
                reason = calculators[key].calculate(file).get("error")
                if reason == declines[version, key]:
                    say(f"    {row['song']} {version}: {key.upper()} declined ({reason})")
                    continue
            raise RuntimeError(f"{row['song']}/{version}: {key} is {row[key]!r}")


def cli_work_dir(root: Path, src: Path, seconds: float) -> Path:
    """A decode-only work dir: `src`'s tempo.json cut to the bars of its
    first `seconds` and its volume.json, with 40 synthetic condition notes
    (random extractor weights keep no note of the click track)."""
    work = root / "outputs" / "infer" / "temp"
    work.mkdir(parents=True)
    tempo = []
    for region in json.loads((src / "tempo.json").read_text()):
        downbeats = [d for d in region["downbeats"] if d < seconds]
        if downbeats:
            tempo.append(dict(region, downbeats=downbeats))
    (work / "tempo.json").write_text(json.dumps(tempo))
    notes = [{"onset": 1.0 + 0.5 * i, "offset": 1.4 + 0.5 * i,
              "pitch": 48 + (7 * i) % 36, "velocity": 80} for i in range(40)]
    (work / "extract.json").write_text(json.dumps(notes))
    (work / "volume.json").write_bytes((src / "volume.json").read_bytes())
    return pipeline_settings(root, ROOT)


def train_settings(root: Path, tokenized: Path) -> Path:
    """configs/distill.yaml's train settings as .json (PyYAML is not
    promised on the card's machine): 30 epochs, batch 8 x accumulation 4,
    peak rate 2e-4 after 2 warmup epochs, 1024-token chunks; the decoder at
    the published widths (the settings' defaults, which
    checkpoints/decoder/etude_decoder_config.json holds)."""
    root.mkdir(parents=True, exist_ok=True)
    settings = root / "distill.json"
    settings.write_text(json.dumps({
        "paths": {"dataset_vocab": str(ROOT / "dataset_distill/vocab.json"),
                  "tokenized_dir": str(tokenized),
                  "train_output_dir": str(root / "out")},
        "train": {"num_epochs": 30, "batch_size": 8, "gradient_accumulation_steps": 4,
                  "learning_rate": 2.0e-4, "warmup_epochs": 2},
    }))
    return settings


def train_operations(config, rows: int, T: int):
    """(bf16, f32) operations of one optimizer step over `rows` chunks of T
    positions: 6 per parameter of the matmuls per position (forward 2,
    backward 4), and attention over the full T (QK^T and PV, 2 T hidden
    multiply-adds per position and layer forward, 3x with the backward);
    the port's QK^T runs as an f32 GEMM of bf16-rounded values."""
    H, L, I, V = (config.hidden_size, config.num_hidden_layers,
                  config.intermediate_size, config.vocab_size)
    matmul = L * (3 * H * H + H * H + 2 * H * I) + H * V + 4 * config.attribute_emb_dim * H
    positions = rows * T
    attention = 3 * 2 * 2 * T * H * L * positions
    return 6 * matmul * positions + attention // 2, attention // 2


def corpus_subset(root: Path, min_steps: int, global_batch: int):
    """The first corpus songs, copied until one epoch holds `min_steps`
    optimizer steps at 1024-token chunks; returns (dir, dataset, steps per
    epoch)."""
    import shutil

    from etude_tpu_torch.data.dataset import EtudeDataset
    from etude_tpu_torch.data.vocab import Vocab

    vocab = Vocab.load(ROOT / "dataset_distill/vocab.json")
    out = root / "tokenized"
    for song in sorted((ROOT / "dataset_distill/tokenized").iterdir()):
        shutil.copytree(song, out / song.name)
        dataset = EtudeDataset(out, vocab, max_seq_len=1024)
        if len(dataset) // global_batch >= min_steps:
            return out, dataset, len(dataset) // global_batch
    raise RuntimeError("the corpus is too small for the resume check")


def fresh_training(config, device, dtype, lr=2e-4, warmup=3, total=1000):
    """A train state of the decoder from seed 0 on `device`, and its step."""
    from etude_tpu_torch.parallel.train_step import (
        init_train_state, make_optimizer, make_train_step,
    )
    from etude_tpu_torch.weights import decoder_from_jax, init_decoder_params_np

    model = decoder_from_jax(init_decoder_params_np(config, seed=0), config, device)
    tx, _ = make_optimizer(learning_rate=lr, warmup_steps=warmup, total_steps=total)
    state = init_train_state(model, tx)
    return state, make_train_step(config, tx, compute_dtype=dtype)


def device_batch(host, accum, device, rows=None):
    """The first `rows` rows of a host batch as [accum, rows/accum, T]
    tensors on `device`."""
    import torch
    from etude_tpu_torch.parallel.train_step import reshape_for_accum

    host = {k: v[:rows] for k, v in host.items()} if rows else host
    return {k: torch.from_numpy(v).to(device) for k, v in reshape_for_accum(host, accum).items()}


def train_main_run(root: Path):
    """The CLI at full width on the whole corpus: 40 steps, `latest` every
    20, with --strict-sync."""
    import math

    import torch
    from etude_tpu_torch import train

    settings = train_settings(root, ROOT / "dataset_distill/tokenized")
    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    run = train.run(["--config", str(settings), "--run-id", "main", "--max-steps",
                     str(TRAIN_STEPS), "--save-every-steps", str(TRAIN_SAVE_EVERY),
                     "--strict-sync"])
    wall = time.perf_counter() - t
    if run is None:
        raise RuntimeError("etude_tpu_torch.train failed")
    peak = torch.cuda.max_memory_allocated() / 2**30
    metrics = [json.loads(x) for x in (run.ckpt_dir / "metrics.jsonl").read_text().splitlines()]
    warm = run.step_seconds[1:]
    median = statistics.median(warm)
    steps = len(run.losses)
    rows, T = 32, 1024
    say(f"  dataset: 500 songs loaded in {run.load_seconds:.2f} s; run wall {wall:.2f} s "
        f"(load, init, {steps} steps, 3 saves, export)")
    say(f"  optimizer step (32 x 1024 positions, 4 micro-batches): first "
        f"{1e3 * run.step_seconds[0]:.2f} ms, warm median {1e3 * median:.3f} ms "
        f"(min {1e3 * min(warm):.3f}, max {1e3 * max(warm):.3f}) over {len(warm)} steps "
        f"(CUDA events between steps)")
    say(f"  tokens/s at the warm median: {rows * T / median:,.0f} positions, "
        f"{run.label_tokens / steps / median:,.0f} label tokens ({run.label_tokens / steps:.1f} "
        f"per step); metrics.jsonl tokens_per_sec {metrics[-1]['tokens_per_sec']:,.0f} "
        f"(its epoch wall, first step and saves included)")
    say(f"  peak device memory {peak:.2f} GiB; losses {run.losses[0]:.4f} -> "
        f"{run.losses[-1]:.4f}; metrics.jsonl {metrics[-1]}")
    if steps != TRAIN_STEPS or metrics[-1]["step"] != TRAIN_STEPS:
        raise RuntimeError(f"the run took {steps} steps, expected {TRAIN_STEPS}")
    if not all(math.isfinite(x) for x in run.losses) or metrics[-1]["skipped_updates"]:
        raise RuntimeError(f"non-finite loss or skipped update: {metrics[-1]}")
    return run, median


def train_profile(config, batches, median_s):
    """Where a step's time goes: 5 warm steps of the CLI's step function on
    corpus batches, unprofiled, then the same 5 under torch.profiler; the
    device time per step against the CLI's warm median gives the CLI's idle
    share too."""
    import torch

    state, step = fresh_training(config, "cuda", torch.bfloat16)
    for b in batches[:2]:
        step(state, b)

    def window():
        for b in batches:
            step(state, b)

    torch.cuda.synchronize()
    t = time.perf_counter()
    window()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    n = len(batches)
    say(f"  profiled window: {n} steps, unprofiled wall {1e3 * wall:.2f} ms "
        f"({1e3 * wall / n:.2f} ms per step; the CLI's warm median {1e3 * median_s:.2f} ms)")
    busy = profile_device(window, wall)
    if busy is not None:
        say(f"  device time per step {busy / n:.2f} ms -> idle share of the CLI's warm step "
            f"{1 - busy / n / (1e3 * median_s):.3f}")


def train_learning(config, host):
    """30 steps on one fixed micro-batch lower its loss; at rate 0 nothing
    moves."""
    import torch

    batch = device_batch(host, 1, "cuda", rows=8)
    runs = {}
    for lr in (2e-4, 0.0):
        state, step = fresh_training(config, "cuda", torch.bfloat16, lr=lr, total=LEARN_STEPS)
        before = [p.detach().clone() for p in state.params()]
        losses = [step(state, batch)["loss"] for _ in range(LEARN_STEPS)]
        losses = [float(x) for x in losses]
        same = all(torch.equal(a, b) for a, b in zip(before, state.params()))
        runs[lr] = (losses, same)
        del state, step
    (learn, _), (still, same) = runs[2e-4], runs[0.0]
    say(f"  learning, one fixed micro-batch of 8 x 1024: loss {learn[0]:.4f} -> {learn[-1]:.4f} "
        f"in {LEARN_STEPS} steps (must fall by {LEARN_DROP:.0%}); control at rate 0: "
        f"{still[0]:.6f} -> {still[-1]:.6f}, parameters unchanged: {same}")
    if not learn[-1] <= (1 - LEARN_DROP) * learn[0]:
        raise RuntimeError(f"the loss fell from {learn[0]:.4f} to {learn[-1]:.4f} only")
    if not same or max(still) != min(still):
        raise RuntimeError("at rate 0 the parameters or the loss moved")


def train_parity(config, host):
    """One optimizer step of the published decoder on 2 corpus rows, card
    bf16 against the port's CPU f32, beside a control with the labels
    shifted by one position; then a NaN in a bias must skip the update on
    the card."""
    import numpy as np
    import torch

    def two_steps(device, dtype, labels_shift=0):
        rows = {k: v[:2] for k, v in host.items()}
        rows["labels"] = np.roll(rows["labels"], labels_shift, axis=-1)
        batch = device_batch(rows, 1, device)
        state, step = fresh_training(config, device, dtype, warmup=1)
        start = [p.detach().clone() for p in state.params()]
        metrics = [step(state, batch) for _ in range(2)]  # rates 0, then 2e-4
        out = {
            "loss": [float(m["loss"]) for m in metrics],
            "grad_norm": [float(m["grad_norm"]) for m in metrics],
            "update": torch.cat([(p.detach() - s).flatten().float().cpu()
                                 for p, s in zip(state.params(), start)]),
            "mu": torch.cat([m.flatten().cpu() for m in state.opt_state.mu]),
        }
        return out, state, step, batch

    def rel(a, b):
        return float(torch.linalg.vector_norm(a - b) / torch.linalg.vector_norm(b))

    ref = two_steps("cpu", torch.float32)[0]
    card, state, step, batch = two_steps("cuda", torch.bfloat16)
    shifted = two_steps("cuda", torch.bfloat16, labels_shift=1)[0]

    def gaps(x):
        return (max(abs(a / b - 1) for a, b in zip(x["loss"], ref["loss"])),
                max(abs(a / b - 1) for a, b in zip(x["grad_norm"], ref["grad_norm"])),
                rel(x["mu"], ref["mu"]), rel(x["update"], ref["update"]))

    limits = (STEP_LOSS_RTOL, STEP_NORM_RTOL, STEP_MOMENT_RTOL, STEP_UPDATE_RTOL)
    got, control = gaps(card), gaps(shifted)
    say(f"  one step (2 x 1024), CPU f32 then card bf16: losses {ref['loss']}, {card['loss']}; "
        f"grad norms {ref['grad_norm']}, {card['grad_norm']}")
    say("  relative gaps (loss, grad norm, first moment, update): "
        + ", ".join(f"{g:.3g}" for g in got) + " (limits "
        + ", ".join(f"{x:g}" for x in limits) + "); control, labels shifted by one: "
        + ", ".join(f"{g:.3g}" for g in control))
    if any(g > x for g, x in zip(got, limits)):
        raise RuntimeError("the card's step differs from the CPU's beyond the limits")
    if any(g <= x for g, x in zip(control, limits)):
        raise RuntimeError("the step check missed its control (labels shifted by one)")

    # A NaN in the attribute-projection bias: every gradient non-finite,
    # the update skipped on the device.
    with torch.no_grad():
        state.model.attr_proj.bias[0] = float("nan")
    before = [p.detach().clone() for p in state.params()]
    moments = [m.clone() for m in state.opt_state.mu + state.opt_state.nu]
    count = int(state.opt_state.count)
    m = step(state, batch)
    kept = (all(torch.equal(a.nan_to_num(), b.nan_to_num()) for a, b in zip(before, state.params()))
            and all(torch.equal(a, b) for a, b in
                    zip(moments, state.opt_state.mu + state.opt_state.nu)))
    say(f"  NaN bias: grads_finite {int(m['grads_finite'])}, skipped {int(state.skipped)}, "
        f"step {int(state.step)}, count {int(state.opt_state.count)} (was {count}), "
        f"parameters and moments kept: {kept}")
    if int(m["grads_finite"]) or int(state.skipped) != 1 or not kept \
            or int(state.opt_state.count) != count:
        raise RuntimeError("a non-finite gradient did not skip the update on the card")


def train_resume(root: Path, subset: Path, k: int):
    """A run resumed at an epoch's end against two straight runs: on the
    same batches (a resume restarts its epoch, so the check resumes at one's
    end), its losses must stay within the straight runs' own spread; the
    control resumes from a copy of the checkpoint with the Adam moments
    zeroed. Returns the first straight run's directory."""
    import shutil

    import numpy as np
    from etude_tpu_torch import train

    settings = train_settings(root, subset)
    out = root / "out"

    def run(run_id, steps, *extra):
        r = train.run(["--config", str(settings), "--run-id", run_id,
                       "--max-steps", str(steps), *extra])
        if r is None:
            raise RuntimeError(f"resume check: run {run_id} failed")
        return r.losses

    s1, s2 = run("s1", 2 * k), run("s2", 2 * k)
    head = run("r", k)
    shutil.copytree(out / "r", out / "bad")
    opt = out / "bad" / "latest" / "opt_state.npz"
    with np.load(opt) as f:
        zeroed = {key: (np.zeros_like(f[key]) if key.startswith(("mu/", "nu/")) else f[key])
                  for key in f.files}
    np.savez(opt, **zeroed)
    resumed = head + run("r", 2 * k, "--resume", str(out / "r"))
    bad = head + run("bad", 2 * k, "--resume", str(out / "bad"))

    def gap(a, b):
        return max(abs(x - y) for x, y in zip(a, b, strict=True))

    spread = gap(s1, s2)
    got = min(gap(resumed, s1), gap(resumed, s2))
    control = min(gap(bad, s1), gap(bad, s2))
    limit = RESUME_SPREAD_FACTOR * spread + 8 * float(np.spacing(np.float32(max(s1))))
    say(f"  resume: {k} steps per epoch on {len(list(subset.iterdir()))} songs; step {2 * k} "
        f"loss straight {s1[-1]:.6f} / {s2[-1]:.6f}, resumed {resumed[-1]:.6f}; largest gap "
        f"over {2 * k} steps: straight vs straight {spread:.3g}, resumed vs the nearer "
        f"straight run {got:.3g} (limit {limit:.3g}); control, moments zeroed: {control:.3g}")
    if got > limit:
        raise RuntimeError(f"the resumed run left the straight runs' spread ({got:.3g} > {limit:.3g})")
    if control <= limit:
        raise RuntimeError(f"the resume check missed its control ({control:.3g})")
    return out / "s1"


def train_serve(run_dir: Path, cli_root: Path, name: str, model: str = "model",
                checkpoints_dir: Optional[Path] = None) -> int:
    """`--decode-only` on the cli phase's work dir from a run's own export
    (`run_dir`/`model`, the config and vocabulary beside it), with no
    random-weight flag, to `name`.mid; with `checkpoints_dir`, also
    `--attrs-prior` from its `attr_prior/`. Returns the K1 launches."""
    from etude_tpu_torch import infer
    from etude_tpu_torch.ops.decode_attention import decode_attention
    from etude_tpu_torch.utils.midi import read_midi_notes

    paths = {"infer_output_dir": str(cli_root / "outputs" / "infer"),
             "decoder_model": str(run_dir / model),
             "decoder_config": str(run_dir / "etude_decoder_config.json"),
             "decoder_vocab": str(run_dir / "vocab.json")}
    flags = []
    if checkpoints_dir is not None:
        paths["checkpoints_dir"] = str(checkpoints_dir)
        flags = ["--attrs-prior"]
    settings = cli_root / f"{name}.json"
    settings.write_text(json.dumps({"paths": paths, "decoder": {"max_bar_token_limit": 32}}))
    decode_attention.launches = 0
    rc = infer.main(["--config", str(settings), "--decode-only", "--output_name", name,
                     "--seed", "7", *flags])
    launches = decode_attention.launches
    out = cli_root / "outputs" / "infer" / f"{name}.mid"
    if rc != 0 or not out.exists():
        raise RuntimeError(f"infer from the trained export exited {rc}; {out} exists: "
                           f"{out.exists()}")
    notes = read_midi_notes(out)
    say(f"  served from {run_dir / model}: {out.name} {out.stat().st_size} bytes, "
        f"{len(notes)} notes; K1 launches {launches}")
    if launches == 0 or launches % 8:
        raise RuntimeError(f"decode_attention launched {launches} times, not 8 per S=1 chunk")
    return launches


def train_phase(root: Path, cli_root: Path):
    """The train phase; returns the K1 launches of serving the exports (the
    main run's: 40 steps, its rate still below 2.2e-6 in its warmup; the
    resume check's first straight run's: 42 steps on 7 songs, warmed up to
    2e-4) and the latter run's directory, for the recipe phase."""
    import itertools

    import torch
    from etude_tpu_torch.models.decoder import EtudeDecoderConfig

    run, median = train_main_run(root / "main")
    config = EtudeDecoderConfig.from_json_file(run.ckpt_dir / "etude_decoder_config.json")
    bf16, f32 = train_operations(config, 32, 1024)
    say(f"  step operations: {bf16 / 1e12:.3f} TFLOP at bf16 + {f32 / 1e12:.3f} TFLOP of f32 "
        f"QK^T = {(bf16 + f32) / 1e12:.3f} TFLOP -> {1e3 * (bf16 + f32) / BF16_PEAK:.2f} ms all "
        f"at the bf16 peak, {1e3 * (bf16 / BF16_PEAK + f32 / F32_PEAK):.2f} ms with the f32 "
        f"share at the f32 peak; the warm median is {1e3 * median:.2f} ms")

    torch.cuda.set_sync_debug_mode("error")
    try:
        torch.zeros(1, device="cuda").item()
        caught = False
    except RuntimeError:
        caught = True
    finally:
        torch.cuda.set_sync_debug_mode("default")
    say(f"  control of --strict-sync: an .item() under the same mode raised: {caught}")
    if not caught:
        raise RuntimeError("set_sync_debug_mode('error') did not catch an .item()")

    subset, dataset, k = corpus_subset(root / "subset", 20, 32)
    host = list(itertools.islice(dataset.batches(32, shuffle=True, seed=1234), 5))
    batches = [device_batch(h, 4, "cuda") for h in host]
    train_profile(config, batches, median)
    del batches
    train_learning(config, host[0])
    train_parity(config, host[0])
    torch.cuda.empty_cache()
    trained = train_resume(root / "resume", subset, k)
    return (train_serve(run.ckpt_dir, cli_root, "trained")
            + train_serve(trained, cli_root, "trained_subset")), trained


def check_dilated_backward(B, T, dilation, seed, flush, head7_bug=False):
    """K2b against autograd of K2's plain version in f32 from the same bf16
    inputs and dO (made on the card from a seed): dq, dk, dv within two bf16
    ulps of each one's largest |value|, der within DER_RTOL of its largest
    |value|; two launches must give the same bits; the gradient at another
    dilation must fail the same check (the control). Timed with L2 flushed."""
    import torch
    from etude_tpu_torch.ops.dilated_attention import (
        dilated_attention_backward, dilated_attention_backward_plain,
    )
    from etude_tpu_torch.utils.kernel_bench import (
        dilated_backward_bound, dilated_inputs, kernel_tolerance, time_ms,
    )

    q, k, v, er = dilated_inputs(B, T, seed)
    g = torch.randn(q.shape, device="cuda",
                    generator=torch.Generator(device="cuda").manual_seed(seed)).bfloat16()
    H, d = q.shape[1], q.shape[3]
    got = dilated_attention_backward(q, k, v, er, g, dilation, head7_bug)
    again = dilated_attention_backward(q, k, v, er, g, dilation, head7_bug)
    other = dilation * 2 if dilation * 2 <= 256 else dilation // 2
    wrong = dilated_attention_backward(q, k, v, er, g, other, head7_bug)
    torch.cuda.synchronize()
    ref = dilated_attention_backward_plain(q, k, v, er, g, dilation, head7_bug)
    name = f"K2b B={B} T={T} dilation={dilation} head7_bug={head7_bug}"

    def tolerance(r, i):
        top = r.abs().max().item()
        return DER_RTOL * top if i == 3 else (kernel_tolerance(r) if top > 0 else 0.0)

    tols = [tolerance(r, i) for i, r in enumerate(ref)]
    errs = [(a.float() - r).abs().max().item() for a, r in zip(got, ref)]
    control = [(a.float() - r).abs().max().item() for a, r in zip(wrong, ref)]
    for a, b in zip(got, again):
        if not torch.isfinite(a.float()).all():
            raise RuntimeError(f"{name}: non-finite gradient")
        if not torch.equal(a, b):
            raise RuntimeError(f"{name}: two launches differ")
    if any(e > t for e, t in zip(errs, tols)):
        raise RuntimeError(f"{name}: max|kernel-plain| (dq, dk, dv, der) {errs} > {tols}")
    if not any(c > t for c, t in zip(control, tols)):
        raise RuntimeError(f"{name}: the control at dilation {other} passed the check")
    if head7_bug and got[1][:, 7].any():
        raise RuntimeError(f"{name}: head 7's keys received a gradient")
    bound_ms, bound_by, n_bytes = dilated_backward_bound(B, H, T, d)
    row = {
        "B": B, "T": T, "dilation": dilation, "head7_bug": head7_bug,
        "max_abs_err": max(errs),
        "ms": time_ms(lambda: dilated_attention_backward(q, k, v, er, g, dilation, head7_bug),
                      flush=flush),
        "plain_ms": time_ms(lambda: dilated_attention_backward_plain(
            q, k, v, er, g, dilation, head7_bug), iters=5, flush=flush),
        "bound_ms": bound_ms, "bound_by": bound_by,
    }
    scratch = 4 * B * H * T * 5 * 4
    say(f"  K2b B={B:2d} T={T:5d} dil={dilation:3d}{' head7_bug' if head7_bug else ''}: "
        f"max|err| dq {errs[0]:.3g} dk {errs[1]:.3g} dv {errs[2]:.3g} der {errs[3]:.3g} "
        f"(tol {', '.join(f'{t:.3g}' for t in tols)}); control at dilation {other}: "
        f"{', '.join(f'{c:.3g}' for c in control)}; kernel {row['ms']:.4f} ms, plain "
        f"{row['plain_ms']:.4f} ms, bound {bound_ms:.4f} ms ({n_bytes / 1e6:.1f} MB, "
        f"{bound_by}; with the f32 scratch {(n_bytes + scratch) / 1e6:.1f} MB)")
    return row


def aux_args(mode, **overrides):
    """The CLI's settings for `mode` as `train_aux.TASKS` reads them."""
    import argparse
    from etude_tpu_torch import train_aux

    batch, lr = train_aux.DEFAULTS[mode]
    settings = dict(seed=0, batch=batch, lr=lr, steps=AUX_STEPS, eval_clips=AUX_EVAL_CLIPS,
                    beat_frames=512, sep_frames=256, init_from=None)
    settings.update(overrides)
    return argparse.Namespace(**settings)


def aux_cli_run(out: Path, mode: str):
    """`python -m etude_tpu_torch.train_aux <mode>` in-process at the
    published widths: 30 steps, 2 held-out clips. Returns the run, its warm
    median step and its K2 and K2b launches."""
    import math

    import torch
    from etude_tpu_torch import train_aux
    from etude_tpu_torch.ops.dilated_attention import (
        dilated_attention, dilated_attention_backward,
    )

    torch.cuda.reset_peak_memory_stats()
    dilated_attention.launches = dilated_attention_backward.launches = 0
    t = time.perf_counter()
    run, = train_aux.run([mode, "--steps", str(AUX_STEPS), "--eval-clips", str(AUX_EVAL_CLIPS),
                          "--output-dir", str(out)])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    k2, k2b = dilated_attention.launches, dilated_attention_backward.launches
    warm, waits = run.step_seconds[1:], run.wait_seconds[1:]
    median = statistics.median(warm)
    meta = json.loads((out / train_aux.EXPORT_NAMES[mode] / "metadata.json").read_text())
    held_out = {k: v for k, v in meta.items() if k.endswith(("f_measure", "f1", "sdr_db"))}
    say(f"  {mode}: {AUX_STEPS} steps in {wall:.2f} s (build, steps, evaluation, export); "
        f"warm step median {1e3 * median:.2f} ms (min {1e3 * min(warm):.2f}, max "
        f"{1e3 * max(warm):.2f}; CUDA events between steps); the host's batch wait "
        f"{sum(waits) / sum(warm):.3f} of the warm steps' time (median wait "
        f"{1e3 * statistics.median(waits):.2f} ms); peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; loss {run.losses[0]:.4f} -> "
        f"{run.losses[-1]:.4f}; held-out {held_out}; K2 launches {k2}, K2b {k2b}")
    if len(run.losses) != AUX_STEPS or not all(math.isfinite(x) for x in run.losses):
        raise RuntimeError(f"{mode}: {len(run.losses)} steps, losses {run.losses}")
    if not held_out or not all(math.isfinite(v) for v in held_out.values()):
        raise RuntimeError(f"{mode}: held-out evaluation {held_out}")
    # K2b: two kernel launches per call, one call per layer and step.
    expect = ((9 * (AUX_STEPS + AUX_EVAL_CLIPS), 2 * 9 * AUX_STEPS) if mode == "beat"
              else (0, 0))
    if (k2, k2b) != expect:
        raise RuntimeError(f"{mode}: K2/K2b launched {k2}/{k2b} times, expected {expect}")
    return run, median, k2, k2b


def aux_state(mode, device, config=None, lr=None, steps=AUX_STEPS, loss=None, **overrides):
    """A fresh model of `mode` from seed 0 on `device`, training, with its
    AdamW state, step function (of `loss`, else the task's) and task."""
    import torch
    from etude_tpu_torch import train_aux
    from etude_tpu_torch.parallel.train_step import make_aux_optimizer, make_aux_train_step

    args = aux_args(mode, **overrides)
    task = train_aux.TASKS[mode](args, torch.device(device), config=config)
    tx = make_aux_optimizer(args.lr if lr is None else lr, steps)
    model = task.model.train().requires_grad_(True)
    step = make_aux_train_step(tx, loss or task.loss, torch.device(device))
    return task, tx.init(list(model.parameters())), step


def device_aux_batch(host, device):
    from etude_tpu_torch import train_aux

    return train_aux.to_device(train_aux.host_tensors(host, False), device)


def aux_profile(mode, median_s):
    """3 warm steps of `mode` on pre-built batches, unprofiled then under
    the profiler: device time per step against the CLI's warm median."""
    import torch

    task, opt, step = aux_state(mode, "cuda")
    batches = [device_aux_batch(task.gen(i), "cuda") for i in range(5)]
    for b in batches[:2]:
        step(task.model, opt, b)

    def window():
        for b in batches[2:]:
            step(task.model, opt, b)

    torch.cuda.synchronize()
    t = time.perf_counter()
    window()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    say(f"  {mode} profiled window: 3 steps on pre-built batches, unprofiled wall "
        f"{1e3 * wall / 3:.2f} ms per step")
    busy = profile_device(window, wall)
    if busy is not None:
        say(f"  {mode}: device time per step {busy / 3:.2f} ms -> device idle share of the "
            f"CLI's warm step {1 - busy / 3 / (1e3 * median_s):.3f}")


def aux_learning(mode):
    """AUX_STEPS steps on one fixed batch lower its loss; at rate 0 the loss
    and every parameter keep their bits."""
    import torch
    from etude_tpu_torch import train_aux

    runs = {}
    for lr in (None, 0.0):
        task, _, _ = aux_state(mode, "cuda")
        batch = task.gen(0)
        rate = aux_args(mode).lr if lr is None else lr
        before = [p.detach().clone() for p in task.model.parameters()]
        losses, *_ = train_aux.train_loop(mode, task.model, task.loss, lambda i: batch,
                                          AUX_STEPS, rate, "cuda", log_every=AUX_STEPS)
        same = all(torch.equal(a, b) for a, b in zip(before, task.model.parameters()))
        runs[lr] = (losses, same)
        del task
    (learn, _), (still, same) = runs[None], runs[0.0]
    say(f"  {mode} learning, one fixed batch: loss {learn[0]:.4f} -> {learn[-1]:.4f} in "
        f"{AUX_STEPS} steps (must fall by {AUX_LEARN_DROP:.0%}); control at rate 0: "
        f"{still[0]:.6f} -> {still[-1]:.6f}, parameters unchanged: {same}")
    if not learn[-1] <= (1 - AUX_LEARN_DROP) * learn[0]:
        raise RuntimeError(f"{mode}: the loss fell from {learn[0]:.4f} to {learn[-1]:.4f} only")
    if not same or max(still) != min(still):
        raise RuntimeError(f"{mode}: at rate 0 the parameters or the loss moved")


def shift_labels(mode, batch):
    """The control of the card-vs-CPU step: the labels moved by 7 frames
    (beat, amt; the tempo class by 17) or the stems rotated (separator)."""
    import numpy as np

    out = dict(batch)
    if mode == "beat":
        out["activations"] = np.roll(batch["activations"], 7, axis=1)
        out["tempo"] = (batch["tempo"] + 17) % 300
    elif mode == "amt":
        for key in ("onset", "offset", "mpe", "velocity"):
            out[key] = np.roll(batch[key], 7, axis=1)
    else:
        out["stem_mags"] = np.roll(batch["stem_mags"], 1, axis=1)
    return out


def aux_parity(mode):
    """One optimizer step (the second of a run, the first at rate > 0) of
    `mode` at the published widths on one row, on the card against the
    port's CPU f32, at each precision of AUX_STEP_LIMITS, beside controls
    with the labels shifted and with the rate halved. The hFT runs 128-frame
    segments here (its widths kept) to bound the CPU's time."""
    import torch
    from etude_tpu_torch.models import separator as sep
    from etude_tpu_torch.models.amt import AMTConfig

    config = AMTConfig(n_frame=128) if mode == "amt" else None
    host = aux_state(mode, "cpu", config=config, batch=1)[0].gen(0)
    rate = aux_args(mode).lr

    def two_steps(device, batch, f32=False, lr=rate):
        loss = (lambda m, b: sep.loss_fn(m, b, torch.float32)) if f32 else None
        task, opt, step = aux_state(mode, device, config=config, lr=lr, batch=1, steps=2,
                                    loss=loss)
        start = [p.detach().clone() for p in task.model.parameters()]
        b = device_aux_batch(batch, device)
        metrics = [step(task.model, opt, b) for _ in range(2)]
        return {"loss": [float(m["loss"]) for m in metrics],
                "grad_norm": [float(m["grad_norm"]) for m in metrics],
                "update": torch.cat([(p.detach() - s).flatten().float().cpu()
                                     for p, s in zip(task.model.parameters(), start)])}

    def gaps(x, ref):
        return (max(abs(a / b - 1) for a, b in zip(x["loss"], ref["loss"])),
                max(abs(a / b - 1) for a, b in zip(x["grad_norm"], ref["grad_norm"])),
                float(torch.linalg.vector_norm(x["update"] - ref["update"])
                      / torch.linalg.vector_norm(ref["update"])))

    def over(g, limits):
        return any(x is not None and a > x for a, x in zip(g, limits))

    def show(g):
        return ", ".join(f"{a:.3g}" for a in g)

    ref = two_steps("cpu", host)
    for precision, limits in AUX_STEP_LIMITS[mode].items():
        f32 = precision == "f32"
        got = gaps(two_steps("cuda", host, f32), ref)
        controls = {"labels shifted": gaps(two_steps("cuda", shift_labels(mode, host), f32), ref)}
        if limits[2] is not None:
            controls["rate halved"] = gaps(two_steps("cuda", host, f32, lr=rate / 2), ref)
        say(f"  {mode} one step, card {precision} vs CPU f32: losses {ref['loss']}; relative "
            f"gaps (loss, grad norm, update) {show(got)} (limits "
            + ", ".join("not held" if x is None else f"{x:g}" for x in limits) + "); controls: "
            + "; ".join(f"{name} {show(g)}" for name, g in controls.items()))
        if over(got, limits):
            raise RuntimeError(f"{mode}: the card's {precision} step differs from the CPU's "
                               "beyond the limits")
        for name, g in controls.items():
            if not over(g, limits):
                raise RuntimeError(f"{mode}: the {precision} step check missed its control "
                                   f"({name})")


def aux_serve(root: Path, exports: Path) -> int:
    """`--input` on a 30 s click track with the separator, beat model and
    extractor read from the phase's exports and the decoder from a params-
    only export of seeded random weights, without --allow-random-weights
    (a model that did not load raises); returns the run's K2 launches."""
    from etude_tpu_torch import infer
    from etude_tpu_torch.models.decoder import EtudeDecoderConfig
    from etude_tpu_torch.ops.dilated_attention import (
        dilated_attention, dilated_attention_backward,
    )
    from etude_tpu_torch.utils.training import save_params_only
    from etude_tpu_torch.weights import init_decoder_params_np

    config = EtudeDecoderConfig.from_json_file(
        ROOT / "checkpoints/decoder/etude_decoder_config.json")
    save_params_only(root / "decoder" / "model", init_decoder_params_np(config, seed=0), config)
    wav = root / "click_30s.wav"
    write_click_wav(wav, AUX_SERVE_SECONDS, seed=2)
    settings = root / "served.json"
    settings.write_text(json.dumps({
        "paths": {
            "infer_output_dir": str(root / "outputs" / "infer"),
            "separator_model": str(exports / "separator" / "latest"),
            "beat_detector_model": str(exports / "beat_detector" / "latest"),
            "extractor_model": str(exports / "extractor" / "latest"),
            "decoder_model": str(root / "decoder" / "model"),
            "decoder_config": str(root / "decoder" / "etude_decoder_config.json"),
            "decoder_vocab": str(ROOT / "checkpoints/decoder/vocab.json"),
        },
        "decoder": {"max_bar_token_limit": 32},
    }))
    dilated_attention.launches = dilated_attention_backward.launches = 0
    t = time.perf_counter()
    rc = infer.main(["--config", str(settings), "--input", str(wav), "--output_name", "aux",
                     "--seed", "7"])
    wall = time.perf_counter() - t
    k2, k2b = dilated_attention.launches, dilated_attention_backward.launches
    work = root / "outputs" / "infer" / "temp"
    midi = root / "outputs" / "infer" / "aux.mid"
    if rc != 0 or not midi.exists():
        raise RuntimeError(f"infer --input from the aux exports exited {rc}")
    notes = json.loads((work / "extract.json").read_text())
    check_notes(notes, AUX_SERVE_SECONDS)
    tempo = json.loads((work / "tempo.json").read_text())
    check_tempo(tempo, AUX_SERVE_SECONDS)
    say(f"  --input from the exports ({exports}): {wall:.2f} s, extract.json {len(notes)} "
        f"notes, tempo.json {len(tempo)} region(s); K2 launches {k2} (expected 9), K2b {k2b}")
    if k2 != 9 or k2b != 0:
        raise RuntimeError(f"serving the exports launched K2 {k2} and K2b {k2b} times")
    return k2


def aux_train_phase(root: Path, flush):
    """The aux_train phase; returns (K2 launches, K2b launches, K2b rows,
    the separator's export)."""
    import torch

    # K2's forward at the training shape first: its backward rests on it.
    for i in range(9):
        check_dilated(40, 512, 2 ** i, 300 + i, flush)
    rows = [check_dilated_backward(40, 512, 2 ** i, 400 + i, flush) for i in range(9)]
    rows += [check_dilated_backward(40, 512, dil, 500 + dil, flush, head7_bug=True)
             for dil in (1, 8, 256)]
    rows += [check_dilated_backward(5, 12288, dil, 600 + dil, flush) for dil in (1, 16, 256)]
    train = [r for r in rows if r["T"] == 512 and not r["head7_bug"]]
    say(f"  K2b, one beat training step at B=40 T=512 (9 calls, 18 launches): kernel "
        f"{sum(r['ms'] for r in train):.4f} ms, plain {sum(r['plain_ms'] for r in train):.4f} ms, "
        f"bound {sum(r['bound_ms'] for r in train):.4f} ms")

    exports = root / "exports"
    k2 = k2b = 0
    for mode in ("beat", "amt", "separator"):
        run, median, a, b = aux_cli_run(exports, mode)
        k2, k2b = k2 + a, k2b + b
        aux_profile(mode, median)
        torch.cuda.empty_cache()
    for mode in ("beat", "amt", "separator"):
        aux_learning(mode)
        aux_parity(mode)
        torch.cuda.empty_cache()
    k2 += aux_serve(root / "serve", exports)
    return k2, k2b, rows, exports / "separator" / "latest"


# ---------------------------------------------------------------- recipe
def recipe_dataset(root: Path) -> Path:
    """RECIPE_SONGS corpus songs, every RECIPE_STRIDE-th with at least
    RECIPE_BARS bar pairs (variants of one base song are adjacent and bin
    alike), their `_src`/`_tgt` cut to the first RECIPE_BARS bars, with the
    corpus vocabulary: the full songs' width, a smaller depth."""
    import numpy as np
    from etude_tpu_torch.data.dataset import split_ids_into_bars
    from etude_tpu_torch.data.vocab import Vocab

    vocab = Vocab.load(ROOT / "dataset_distill/vocab.json")
    corpus = sorted((ROOT / "dataset_distill/tokenized").iterdir())[::RECIPE_STRIDE]
    picked = 0
    for song in corpus:
        cut = {}
        for kind in ("src", "tgt"):
            ids = np.load(song / f"{song.name}_{kind}.npy")
            bars = split_ids_into_bars(ids.astype(int).tolist(), vocab.bar_bos_id,
                                       vocab.bar_eos_id)[:RECIPE_BARS]
            cut[kind] = np.asarray([t for b in bars for t in b], ids.dtype), len(bars)
        if min(n for _, n in cut.values()) < RECIPE_BARS:
            continue
        (root / "tokenized" / song.name).mkdir(parents=True)
        for kind, (ids, _) in cut.items():
            np.save(root / "tokenized" / song.name / f"{song.name}_{kind}.npy", ids)
        picked += 1
        if picked == RECIPE_SONGS:
            (root / "vocab.json").write_bytes((ROOT / "dataset_distill/vocab.json").read_bytes())
            return root
    raise RuntimeError(f"the corpus holds {picked} songs of {RECIPE_BARS} bars at this stride")


def engine_bars(flat, bos, eos, max_new):
    """A rollout file's bars by the engine's contract: Bar_BOS, then tokens
    up to and including Bar_EOS or `max_new` of them."""
    bars, p = [], 0
    while p < len(flat):
        if flat[p] != bos:
            raise RuntimeError(f"a rollout bar opens with {flat[p]} at {p}, not Bar_BOS")
        end = p + 1
        while end < len(flat) and end - p - 1 < max_new:
            end += 1
            if flat[end - 1] == eos:
                break
        bars.append(list(flat[p:end]))
        p = end
    return bars


def recipe_rollouts(root: Path, run_dir: Path):
    """`dagger_rollouts --batch 16` in-process on RECIPE_SONGS songs cut to
    RECIPE_BARS bars, from the train phase's export at full width; checks
    beside their controls. Returns (dataset dir, K1 launches)."""
    import numpy as np
    import torch
    from etude_tpu_torch.data.dataset import calculate_bin_edges, split_ids_into_bars
    from etude_tpu_torch.data.vocab import Vocab
    from etude_tpu_torch.models.generate_stream import StreamingGenerationEngine
    from etude_tpu_torch.ops.decode_attention import decode_attention
    from etude_tpu_torch.scripts import dagger_rollouts
    from etude_tpu_torch.utils.model_loader import load_etude_decoder

    data = recipe_dataset(root / "data")
    vocab = Vocab.load(data / "vocab.json")
    argv = ["--run", str(run_dir), "--dataset-dir", str(data), "--batch", "16"]
    decode_attention.launches = 0
    t = time.perf_counter()
    run = dagger_rollouts.run(argv)
    wall = time.perf_counter() - t
    launches = decode_attention.launches
    model, config = load_etude_decoder(run_dir / "etude_decoder_config.json", run_dir / "model")
    layers = config.num_hidden_layers
    generated = run.tokens - run.bars
    say(f"  rollouts: {len(run.written)} songs x {RECIPE_BARS} bars at full width, 16 streams: "
        f"{wall:.2f} s in the script ({run.seconds:.2f} s generating); {run.bars} bars, "
        f"{run.tokens} tokens ({generated / run.bars:.1f} generated per bar) = "
        f"{generated / run.seconds:.1f} tok/s; {run.single_token_chunks} S=1 chunks, "
        f"{1e3 * run.seconds / run.single_token_chunks:.3f} ms each; K1 launches {launches} "
        f"(expected {run.single_token_chunks * layers})")
    if launches == 0 or launches != run.single_token_chunks * layers:
        raise RuntimeError(f"the rollouts launched K1 {launches} times, expected "
                           f"{run.single_token_chunks} x {layers}")
    if len(run.written) != RECIPE_SONGS:
        raise RuntimeError(f"the rollouts wrote {len(run.written)} files")
    engine = StreamingGenerationEngine(config, bar_bos_id=vocab.bar_bos_id,
                                       bar_eos_id=vocab.bar_eos_id, pad_id=vocab.pad_id)
    files = {}
    for path in run.written:
        flat = np.load(path)
        bars = engine_bars(flat.tolist(), vocab.bar_bos_id, vocab.bar_eos_id,
                           engine.max_bar_token_limit)
        if flat.dtype != np.int32 or len(bars) != RECIPE_BARS or flat.max() >= len(vocab) \
                or flat.min() < 0:
            raise RuntimeError(f"{path}: {flat.dtype}, {len(bars)} bars, ids {flat.min()}.."
                               f"{flat.max()}")
        files[path.parent.name] = (bars, path.stat().st_mtime_ns)
    # The training dataset keeps a rollout whose Bar_BOS-split bars pair
    # 1:1 with the teacher's (a generated Bar_BOS inside a bar breaks that).
    usable = sum(len(split_ids_into_bars(np.load(p).tolist(), vocab.bar_bos_id,
                                         vocab.bar_eos_id)) == RECIPE_BARS
                 for p in run.written)
    say(f"  rollout files: {len(files)} of {RECIPE_BARS} bars each, int32, ids in range; "
        f"{usable} pair 1:1 with the teacher's bars (usable as DAgger history)")

    again = dagger_rollouts.run(argv)
    kept = all(p.stat().st_mtime_ns == files[p.parent.name][1] for p in run.written)
    say(f"  a second run without --force wrote {len(again.written)} files; mtimes kept: {kept}")
    if again.written or not kept:
        raise RuntimeError("the second rollout run rewrote files")

    # The script's bars 0-1 against a direct generate_batch on the same 16
    # streams (the script's order) with the phase's own global-edge bins, at
    # the script's condition bucket so every chunk has the script's shapes.
    songs = dagger_rollouts.load_songs(data / "tokenized", vocab)
    songs.sort(key=lambda s: len(s["src_bars"]), reverse=True)
    edges = calculate_bin_edges([a for s in songs for a in s["attrs"]])
    own = [dagger_rollouts.bin_maps(s["attrs"], calculate_bin_edges(s["attrs"])) for s in songs]
    glob = [dagger_rollouts.bin_maps(s["attrs"], edges) for s in songs]
    moved = [n for n, (a, b) in enumerate(zip(own, glob)) if a[:2] != b[:2]]
    if not moved:
        raise RuntimeError("per-song edges bin the first two bars as the global ones do")
    X = engine.pack([s["src_bars"] for s in songs], glob)["X"]
    direct = StreamingGenerationEngine(config, bar_bos_id=vocab.bar_bos_id,
                                       bar_eos_id=vocab.bar_eos_id, pad_id=vocab.pad_id,
                                       x_len_buckets=(X,))
    heads = [s["src_bars"][:2] for s in songs]
    t = time.perf_counter()
    got = direct.generate_batch(model, heads, [g[:2] for g in glob])
    control = direct.generate_batch(model, heads, [o[:2] for o in own])
    torch.cuda.synchronize()
    script = [files[s["dir"].name][0][:2] for s in songs]
    same = sum(a == b for a, b in zip(got, script))
    ctrl = sum(a == b for a, b in zip(control, script))
    say(f"  direct generate_batch (bars 0-1, 16 streams, X = {X}, {time.perf_counter() - t:.2f} s "
        f"for two runs): {same}/16 streams equal the script's files; control, bins from "
        f"per-song edges (differing in bars 0-1 for {len(moved)} songs): {ctrl}/16 equal")
    if same != RECIPE_SONGS:
        raise RuntimeError("the script's rollouts differ from a direct generate_batch")
    if ctrl == RECIPE_SONGS:
        raise RuntimeError("the rollout check missed its control (per-song edges)")
    return data, launches


def finetune_settings(root: Path, data: Path, init_from: Path, dagger: bool) -> Path:
    """configs/dagger.yaml's train settings as .json (5 epochs, batch 8 x
    accumulation 4, rate 3e-5 with no warmup, rollout history, warm start)
    on `data`, the decoder at the published widths."""
    settings = root / f"dagger_{dagger}.json"
    settings.write_text(json.dumps({
        "paths": {"dataset_vocab": str(data / "vocab.json"),
                  "tokenized_dir": str(data / "tokenized"),
                  "train_output_dir": str(root / "out")},
        "train": {"num_epochs": 5, "batch_size": 8, "gradient_accumulation_steps": 4,
                  "learning_rate": 3.0e-5, "warmup_epochs": 0, "dagger_history": dagger,
                  "init_from": str(init_from)},
    }))
    return settings


def recipe_finetune(root: Path, data: Path, init_from: Path) -> Path:
    """The DAgger fine-tune: the train CLI as a child of supervise_train,
    RECIPE_STEPS steps on the rollouts' dataset; its chunks with rollout
    history beside a control without `dagger_history`. Returns the run."""
    import math
    import re
    import shlex

    from etude_tpu_torch import train
    from etude_tpu_torch.scripts import supervise_train

    root.mkdir(parents=True)
    run_dir, log = root / "out" / "dagger", root / "child.log"
    child = (f"exec {shlex.quote(sys.executable)} -m etude_tpu_torch.train \"$@\" "
             f"2>{shlex.quote(str(log))}")
    shares = []
    t = time.perf_counter()
    code = supervise_train.run(
        ["--ckpt-dir", str(run_dir), "--poll-seconds", "1", "--",
         "bash", "-c", child, "train", "--config",
         str(finetune_settings(root, data, init_from, True)), "--run-id", "dagger",
         "--max-steps", str(RECIPE_STEPS)],
        on_poll=lambda burn, poll: shares.append(burn / poll))
    wall = time.perf_counter() - t
    text = log.read_text()
    history = [tuple(map(int, m)) for m in re.findall(r"history: (\d+)/(\d+) chunks", text)]
    metrics = [json.loads(x) for x in (run_dir / "metrics.jsonl").read_text().splitlines()]
    say(f"  DAgger fine-tune under supervise_train: exit {code} in {wall:.2f} s (the child's "
        f"start, load, {RECIPE_STEPS} steps, saves, export); the child's CPU share per 1 s "
        f"poll: {' '.join(f'{s:.2f}' for s in shares)}")
    say(f"  metrics.jsonl: {metrics}; chunks with rollout history: {history[-1] if history else None}")
    if code != 0:
        say(text[-3000:])
        raise RuntimeError(f"the supervised fine-tune exited {code}")
    if not all(math.isfinite(m["loss"]) for m in metrics) or metrics[-1]["skipped_updates"] \
            or metrics[-1]["step"] != RECIPE_STEPS:
        raise RuntimeError(f"the fine-tune's metrics: {metrics}")
    if not history or history[-1][0] == 0:
        raise RuntimeError("no fine-tune chunk took the rollout history")
    control = train.run(["--config", str(finetune_settings(root, data, init_from, False)),
                         "--run-id", "control", "--max-steps", "1"])
    say(f"  control, dagger_history false: {control.rollout_chunks}/{control.chunks} chunks")
    if control is None or control.rollout_chunks != 0 or control.chunks == 0:
        raise RuntimeError("the control fine-tune drew rollout history")
    return run_dir


def recipe_prior(root: Path, run_dir: Path, cli_root: Path) -> int:
    """`train_attr_prior` on all 500 songs on the card; the card's f64 fit
    against the CPU's on a subset (another seed the control); then
    `--decode-only --attrs-prior` from the new prior. Returns K1 launches."""
    import shutil

    import numpy as np
    from etude_tpu_torch.data.dataset import EtudeDataset
    from etude_tpu_torch.data.vocab import Vocab
    from etude_tpu_torch.models.attr_prior import AttrPrior
    from etude_tpu_torch.scripts import train_attr_prior

    run = train_attr_prior.run(["--out", str(root / "attr_prior")])
    meta = run.meta
    say(f"  attribute prior, {meta['bar_pairs']} bar pairs of {meta['songs']} songs: features "
        f"{run.feature_seconds:.2f} s on the host (the edges' dataset load included), fit "
        f"{meta['steps']} steps {run.fit_seconds:.2f} s on the card (f64)")
    say(f"  held-out accuracy {meta['heldout_accuracy']}; majority baseline "
        f"{meta['majority_baseline']}")

    subset = root / "subset"
    for song in sorted((ROOT / "dataset_distill/tokenized").iterdir())[:PRIOR_SUBSET_SONGS]:
        shutil.copytree(song, subset / song.name, ignore=shutil.ignore_patterns("*_hist.npy"))
    vocab = Vocab.load(ROOT / "dataset_distill/vocab.json")
    edges = EtudeDataset(subset, vocab, max_seq_len=1024).attribute_bin_edges
    X, y, _, _ = train_attr_prior.bar_pairs(subset, vocab, edges)

    def gap(a, b):
        return max(float(np.max(np.abs(a.weights[n] - b.weights[n]) - PRIOR_ATOL
                                - PRIOR_RTOL * np.abs(b.weights[n]))) for n in b.weights)

    host = AttrPrior.fit(X, y, steps=PRIOR_STEPS, seed=0, device="cpu")
    card = AttrPrior.fit(X, y, steps=PRIOR_STEPS, seed=0, device="cuda")
    other = AttrPrior.fit(X, y, steps=PRIOR_STEPS, seed=1, device="cuda")
    same_stats = np.array_equal(card.mean, host.mean) and np.array_equal(card.std, host.std)
    diff = max(float(np.max(np.abs(card.weights[n] - host.weights[n]))) for n in host.weights)
    ctrl = max(float(np.max(np.abs(other.weights[n] - host.weights[n]))) for n in host.weights)
    say(f"  fit, card vs CPU (f64, {len(X)} rows of {PRIOR_SUBSET_SONGS} songs, {PRIOR_STEPS} "
        f"steps): weights max|diff| {diff:.3g} (limit {PRIOR_ATOL:g} + {PRIOR_RTOL:g} x |w|), "
        f"mean/std equal "
        f"{same_stats}; control, seed 1 on the card: {ctrl:.3g}")
    if gap(card, host) > 0 or not same_stats:
        raise RuntimeError(f"the card's prior fit differs from the CPU's by {diff:.3g}")
    if gap(other, host) <= 0:
        raise RuntimeError("the prior check missed its control (seed 1)")
    from etude_tpu_torch.models.generate_stream import StreamingGenerationEngine

    seen = {}
    real = StreamingGenerationEngine.generate

    def spy(self, m, bars, attrs, **kw):
        seen["bars"], seen["attrs"] = bars, attrs
        return real(self, m, bars, attrs, **kw)

    StreamingGenerationEngine.generate = spy
    try:
        launches = train_serve(run_dir, cli_root, "recipe_prior", checkpoints_dir=root)
    finally:
        StreamingGenerationEngine.generate = real
    want = AttrPrior.load(root / "attr_prior").predict_bins(seen["bars"], vocab, seed=7)
    say(f"  --attrs-prior from the new prior: the engine's per-bar bins equal its "
        f"predictions: {seen['attrs'] == want}")
    if seen["attrs"] != want:
        raise RuntimeError("--attrs-prior did not condition on the new prior's bins")
    return launches


def recipe_remap(root: Path, run_dir: Path) -> None:
    """`remap_decoder_warmstart` of the fine-tuned run onto
    dataset_distill_r4's vocabulary; teacher-forced logits of a corpus chunk
    of shared tokens: the remapped model's at the mapped columns equal the
    original's within one bf16 ulp of the largest |logit|, Note_103-105's
    equal Note_102's; the control pads the original to 119 without the
    remap."""
    import numpy as np
    import torch
    from etude_tpu_torch.data.vocab import Vocab
    from etude_tpu_torch.models.decoder import ATTRIBUTE_ORDER
    from etude_tpu_torch.scripts import remap_decoder_warmstart
    from etude_tpu_torch.utils.model_loader import load_etude_decoder
    from etude_tpu_torch.utils.training import load_params_only
    from etude_tpu_torch.weights import decoder_from_jax

    old_vocab = Vocab.load(ROOT / "dataset_distill/vocab.json")
    new_vocab = Vocab.load(ROOT / "dataset_distill_r4/vocab.json")
    out = root / "remap"
    t = time.perf_counter()
    rc = remap_decoder_warmstart.main(["--run", str(run_dir), "--old-vocab",
                                       str(ROOT / "dataset_distill/vocab.json"), "--new-vocab",
                                       str(ROOT / "dataset_distill_r4/vocab.json"), "--out",
                                       str(out)])
    wall = time.perf_counter() - t
    if rc != 0:
        raise RuntimeError(f"remap_decoder_warmstart exited {rc}")
    original, config = load_etude_decoder(run_dir / "etude_decoder_config.json", run_dir / "model")
    remapped, new_config = load_etude_decoder(out / "etude_decoder_config.json", out / "model")
    params = load_params_only(run_dir / "model")
    pad = len(new_vocab) - len(old_vocab)
    params["word_emb"] = np.pad(params["word_emb"], ((0, pad), (0, 0)))
    params["lm_head"] = np.pad(params["lm_head"], ((0, 0), (0, pad)))
    padded = decoder_from_jax(params, new_config, "cuda")

    ids = np.load(ROOT / "dataset_distill/tokenized/0001/0001_tgt.npy")[:REMAP_TOKENS]
    shared = [t for t in old_vocab.token_to_id if t in new_vocab.token_to_id]
    old_ids = [old_vocab.token_to_id[t] for t in shared]
    new_ids = [new_vocab.token_to_id[t] for t in shared]
    to_new = dict(zip(old_ids, new_ids))
    if not all(int(i) in to_new for i in ids):
        raise RuntimeError("the remap chunk holds a token the new vocabulary lacks")

    def logits(model, tokens):
        tok = torch.tensor(np.asarray(tokens)[None], dtype=torch.long, device="cuda")
        ones = torch.ones_like(tok)
        with torch.no_grad():
            return model(tok, ones, {n: ones for n in ATTRIBUTE_ORDER}, ones).float().cpu()

    ref = logits(original, ids)[..., old_ids]
    ulp = float(np.spacing(np.float32(ref.abs().max().item()))) * 2 ** 16   # bf16: 8 bits
    new_tokens = [to_new[int(i)] for i in ids]
    added = [new_vocab.token_to_id[t] for t in ("Note_103", "Note_104", "Note_105")]
    n102 = new_vocab.token_to_id["Note_102"]

    def check(model):
        out = logits(model, new_tokens)
        return (max(float((out[..., new_ids] - ref).abs().max()),
                    max(float((out[..., a] - out[..., n102]).abs().max()) for a in added)))

    got, control = check(remapped), check(padded)
    say(f"  remap {len(old_vocab)} -> {len(new_vocab)} tokens in {wall:.2f} s; teacher-forced "
        f"logits of {len(ids)} shared tokens (bf16 forward), mapped columns and Note_103-105 "
        f"against Note_102: max|diff| {got:.3g} (limit one bf16 ulp of max|logit| {ulp:.3g}); "
        f"control, padded without the remap: {control:.3g}")
    if got > ulp:
        raise RuntimeError(f"the remapped logits differ by {got:.3g}")
    if control <= ulp:
        raise RuntimeError("the remap check missed its control")


def recipe_separation(root: Path, separator: Path) -> None:
    """`run_separation` on a 30 s click track from the aux_train phase's
    separator export: its .npy equals an in-process `separate_features` on
    the same file bit for bit; another seed's track (the control) differs."""
    import numpy as np
    from etude_tpu_torch.data.separation import SourceSeparator
    from etude_tpu_torch.scripts import run_separation

    root.mkdir(parents=True)
    wav, other = root / "click.wav", root / "other.wav"
    write_click_wav(wav, AUX_SERVE_SECONDS, seed=5)
    write_click_wav(other, AUX_SERVE_SECONDS, seed=6)
    t = time.perf_counter()
    rc = run_separation.main(["--input", str(wav), "--output", str(root / "cli.npy"),
                              "--model", str(separator)])
    wall = time.perf_counter() - t
    if rc != 0:
        raise RuntimeError(f"run_separation exited {rc}")
    cli = np.load(root / "cli.npy")
    sep = SourceSeparator(model_path=separator, device="cuda")
    direct = sep.separate_features(wav)
    control = sep.separate_features(other)
    same = cli.shape == direct.shape and np.array_equal(cli, direct)
    moved = cli.shape != control.shape or not np.array_equal(cli, control)
    say(f"  run_separation on a {AUX_SERVE_SECONDS:.0f} s click track: {wall:.2f} s, {cli.shape} "
        f"{cli.dtype}; equal to separate_features bit for bit: {same}; control, seed 6's "
        f"track, differs: {moved}")
    if not same or cli.dtype != np.float32 or cli.shape[0] != 5 or cli.shape[2] != 128:
        raise RuntimeError("the separation CLI's features differ from separate_features")
    if not moved:
        raise RuntimeError("the separation check missed its control")


def recipe_entry() -> None:
    """`entry()` on the card (bf16) against the CPU's f32 forward within
    ENTRY_ATOL + ENTRY_RTOL x |logit|; the control zeroes one layer's
    attention output."""
    import torch
    from etude_tpu_torch.entry import entry

    fn, args = entry()
    fn_cpu, args_cpu = entry("cpu")
    card = fn(*args).cpu()
    host = fn_cpu(*args_cpu)
    with zeroed_attention(args[0], 3):
        control = fn(*args).cpu()

    def excess(a):
        return float(((a - host).abs() - (ENTRY_ATOL + ENTRY_RTOL * host.abs())).max())

    gap, moved = float((card - host).abs().max()), float((control - host).abs().max())
    say(f"  entry(): logits {tuple(card.shape)} {card.dtype}, finite "
        f"{bool(card.isfinite().all())}; card bf16 vs CPU f32 max|diff| {gap:.3g} (atol "
        f"{ENTRY_ATOL}, rtol {ENTRY_RTOL}); control, layer 3's attention output zeroed: "
        f"{moved:.3g}")
    if tuple(card.shape) != (2, 64, 3000) or not bool(card.isfinite().all()) or excess(card) > 0:
        raise RuntimeError(f"entry(): card logits off by {gap:.3g}")
    if excess(control) <= 0:
        raise RuntimeError("the entry() check missed its control")


def recipe_phase(root: Path, run_dir: Path, separator: Path, cli_root: Path) -> int:
    """The recipe phase; returns its K1 launches (rollouts, --attrs-prior,
    the published export served)."""
    import torch

    from etude_tpu_torch.scripts import publish_decoder

    times = {}

    def timed(name, fn, *args):
        t = time.perf_counter()
        out = fn(*args)
        times[name] = time.perf_counter() - t
        return out

    data, k1 = timed("rollouts", recipe_rollouts, root / "rollouts", run_dir)
    torch.cuda.empty_cache()
    tuned = timed("fine-tune", recipe_finetune, root / "finetune", data, run_dir / "model")
    k1 += timed("attribute prior", recipe_prior, root / "prior", tuned, cli_root)
    timed("remap", recipe_remap, root, tuned)

    def publish():
        out = root / "published"
        rc = publish_decoder.main(["--run", str(tuned), "--out", str(out), "--meta",
                                   json.dumps({"corpus": "chip_smoke recipe"})])
        meta = json.loads((out / "metadata.json").read_text())
        say(f"  published {tuned} -> {out}: exit {rc}, metadata {meta}")
        if rc != 0:
            raise RuntimeError(f"publish_decoder exited {rc}")
        return train_serve(out, cli_root, "published", model="latest.ckpt")

    k1 += timed("publish and serve", publish)
    timed("separation CLI", recipe_separation, root / "separation", separator)
    timed("entry", recipe_entry)
    say("  recipe spans: " + ", ".join(f"{k} {v:.2f} s" for k, v in times.items()))
    return k1


# --------------------------------------------------------------- options
def options_settings(cli_root: Path) -> Path:
    """The cli phase's settings with the attribute prior's directory named
    (the committed `checkpoints/attr_prior` beside this script)."""
    settings = json.loads((cli_root / "settings.json").read_text())
    settings["paths"]["checkpoints_dir"] = str(ROOT / "checkpoints")
    path = cli_root / "options.json"
    path.write_text(json.dumps(settings))
    return path


class _StepCounter:
    """Counts the S = 1 forwards of the rebuild engine by wrapping
    `models.generate.forward_with_cache`, independently of the engine's own
    accounting; restores it on exit."""

    def __enter__(self):
        import etude_tpu_torch.models.generate as generate

        self.module, self.real, self.steps = generate, generate.forward_with_cache, 0

        def counted(model, cache, input_ids, *args, **kw):
            self.steps += int(input_ids.shape[1] == 1)
            return self.real(model, cache, input_ids, *args, **kw)

        generate.forward_with_cache = counted
        return self

    def __exit__(self, *exc):
        self.module.forward_with_cache = self.real


def teacher_forced_logits(model, config, vocab, bars, attrs, device):
    """The rebuild path on one device: two left-padded prompts (bars[2]
    after the history pair (bars[0], bars[1]), and bars[3] alone)
    prefilled, then 8 S = 1 steps teacher-forced with bars[4]'s tokens (so a
    near-tie cannot steer the devices apart); every logits vector, f32 on
    the host."""
    import numpy as np
    import torch
    from etude_tpu_torch.data.tokenizer import TGT_CLASS_ID
    from etude_tpu_torch.models.decoder import forward_with_cache, init_cache
    from etude_tpu_torch.models.generate import _ATTR_KEY_TO_NAME, GenerationEngine

    engine = GenerationEngine(config, vocab.bar_bos_id, vocab.bar_eos_id, vocab.pad_id,
                              prompt_buckets=(64, 128, 256, 512), max_bar_token_limit=64)
    prompts = [engine.build_prompt([(bars[0], bars[1], attrs)], bars[2], attrs),
               engine.build_prompt([], bars[3], attrs)]
    ids, cls, attrs_np, visible_from, P = engine._pack_prompts(prompts)

    def t(a):
        return torch.tensor(np.asarray(a), dtype=torch.long, device=device)

    step_attrs = {_ATTR_KEY_TO_NAME[k]: t([[v], [v]]) for k, v in attrs.items()}
    positions = np.maximum(np.arange(P)[None] - visible_from[:, None], 0)
    with torch.no_grad():
        cache = init_cache(config, 2, P + 8, device)
        logits, _ = forward_with_cache(
            model, cache, t(ids), t(cls),
            {_ATTR_KEY_TO_NAME[k]: t(v) for k, v in attrs_np.items()}, 0, t(positions),
            t(visible_from))
        outs = [logits[:, -1]]
        for step, tok in enumerate(bars[4][1:9]):
            logits, _ = forward_with_cache(
                model, cache, t([[tok], [tok]]), t([[TGT_CLASS_ID]] * 2), step_attrs, P + step,
                t((P + step - visible_from)[:, None]), t(visible_from))
            outs.append(logits[:, 0])
    return torch.stack(outs).float().cpu()


def logit_excess(a, b) -> float:
    """How far card logits `a` lie outside LOGIT_ATOL + LOGIT_RTOL x |b| of
    the CPU's `b` (positive: outside)."""
    return ((a - b).abs() - (LOGIT_ATOL + LOGIT_RTOL * b.abs())).max().item()


def zeroed_attention(model, layer):
    """A context that zeroes one decoder layer's attention output (its
    out-projection's weight and bias) and restores it."""
    @contextlib.contextmanager
    def ctx():
        proj = model.layers[layer].attn_out
        saved = proj.weight.clone(), proj.bias.clone()
        proj.weight.zero_()
        proj.bias.zero_()
        try:
            yield
        finally:
            proj.weight.copy_(saved[0])
            proj.bias.copy_(saved[1])
    return ctx()


def decoder_parity(name, card, host_model, config, vocab, bars, attrs):
    """`teacher_forced_logits` on the card (K1 on every S = 1 step) and on a
    CPU copy (the plain version), within LOGIT_ATOL; controls: one layer's
    attention output zeroed on the card, each layer in turn."""
    host = teacher_forced_logits(host_model, config, vocab, bars, attrs, "cpu")
    out = teacher_forced_logits(card, config, vocab, bars, attrs, "cuda")
    if not bool(out.isfinite().all()):
        raise RuntimeError(f"{name}: non-finite logits on the card")
    gap, excess = (out - host).abs().max().item(), logit_excess(out, host)
    controls = []
    for layer in range(config.num_hidden_layers):
        with zeroed_attention(card, layer):
            got = teacher_forced_logits(card, config, vocab, bars, attrs, "cuda")
        controls.append(((got - host).abs().max().item(), logit_excess(got, host)))
    say(f"  {name}: teacher-forced logits (prefill + 8 S=1 steps, B=2), card vs CPU max|diff| "
        f"{gap:.3g} (atol {LOGIT_ATOL}, rtol {LOGIT_RTOL}); controls, one layer's attention "
        f"output zeroed: {' '.join(f'{c:.3g}' for c, _ in controls)}")
    if excess > 0:
        raise RuntimeError(f"{name}: card vs CPU logits differ by {gap:.3g}")
    if min(e for _, e in controls) <= 0:
        raise RuntimeError(f"{name}: the logit check missed a control")


def engine_run(engine, model, bars, attrs, **kw):
    """One timed greedy run of an engine, a stream per entry of `attrs`;
    (outputs, tokens, seconds, K1 launches)."""
    import torch
    from etude_tpu_torch.ops.decode_attention import decode_attention

    decode_attention.launches = 0
    torch.cuda.synchronize()
    t = time.perf_counter()
    outs = engine.generate_batch(model, [bars] * len(attrs), attrs, **kw)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t
    return outs, sum(len(b) - 1 for s in outs for b in s), seconds, decode_attention.launches


def options_rebuild(cli_root, model, host_model, config, vocab, bars, attrs, flush):
    """`--engine rebuild` through the CLI on the cli phase's work dir (K1
    launches = S = 1 steps x layers, the MIDI parses); the rebuild and
    stream engines timed on 16 streams x 8 corpus bars (bars capped at 64
    tokens), bar 0's greedy agreement between them reported; K1 timed at the
    rebuild cache length; card vs CPU teacher-forced logits. Returns the K1
    launches of the driven runs."""
    from etude_tpu_torch import infer
    from etude_tpu_torch.models.generate import GenerationEngine
    from etude_tpu_torch.models.generate_stream import StreamingGenerationEngine
    from etude_tpu_torch.ops.decode_attention import decode_attention
    from etude_tpu_torch.utils.midi import read_midi_notes

    decode_attention.launches = 0
    with _StepCounter() as counter:
        t = time.perf_counter()
        rc = infer.main(["--config", str(options_settings(cli_root)), "--decode-only",
                         "--engine", "rebuild", "--allow-random-weights", "--output_name",
                         "rebuild", "--seed", "7"])
        wall = time.perf_counter() - t
    cli_launches = decode_attention.launches
    out = cli_root / "outputs" / "infer" / "rebuild.mid"
    if rc != 0 or not out.exists():
        raise RuntimeError(f"infer --engine rebuild exited {rc}; {out} exists: {out.exists()}")
    notes = read_midi_notes(out)
    expected = counter.steps * config.num_hidden_layers
    say(f"  --engine rebuild CLI: {wall:.2f} s wall; {out.name} {out.stat().st_size} bytes, "
        f"{len(notes)} notes; {counter.steps} S=1 steps, K1 launches {cli_launches} "
        f"(expected {expected})")
    if cli_launches != expected or cli_launches == 0:
        raise RuntimeError(f"decode_attention launched {cli_launches} times in the rebuild "
                           f"run, expected {expected}")

    kw = dict(bar_bos_id=vocab.bar_bos_id, bar_eos_id=vocab.bar_eos_id, pad_id=vocab.pad_id,
              max_bar_token_limit=64)
    rebuild = GenerationEngine(config, prompt_buckets=(128, 256, 512, 1024), **kw)
    stream = StreamingGenerationEngine(config, **kw)
    window = (bars[:8], [a[:8] for a in attrs])
    launches = cli_launches
    results = {}
    for name, engine in (("stream", stream), ("rebuild", rebuild)):
        engine_run(engine, model, window[0], window[1][:2])  # warm-up
        outs, tokens, seconds, n = engine_run(engine, model, *window)
        check_streams(outs, 8, vocab.bar_bos_id, vocab.bar_eos_id, config.vocab_size, 64)
        launches += n
        results[name] = outs
        say(f"  {name} engine, {len(attrs)} streams x 8 bars (64-token cap), greedy: {tokens} "
            f"tokens in {seconds:.2f} s = {tokens / seconds:.1f} tok/s, "
            f"{1e3 * seconds / 8:.1f} ms per bar; K1 launches {n}")
    same = sum(a[0] == b[0] for a, b in zip(results["stream"], results["rebuild"]))
    prefix = [next((i for i, (x, y) in enumerate(zip(a[0], b[0])) if x != y),
                   min(len(a[0]), len(b[0])))
              for a, b in zip(results["stream"], results["rebuild"])]
    say(f"  bar 0, rebuild vs stream engine (greedy, reported): {same} of {len(attrs)} streams "
        f"identical; common prefix {min(prefix)}-{max(prefix)} tokens")
    prompt_cap = config.max_position_embeddings - 64
    for C in sorted({prompt_cap + 64, 128 + 64}):
        check_kernel(16, C, 70 + C, flush)
    decoder_parity("rebuild path", model, host_model, config, vocab, bars,
                   {"polyphony_bin": 1, "rhythm_intensity_bin": 1, "sustain_bin": 1,
                    "pitch_overlap_bin": 2})
    return launches


def options_attrs_prior(cli_root, model, host_model, config, vocab):
    """`--attrs-prior` through the CLI: the per-bar bins the engine gets
    equal the CPU's predictor's on the same bars, exactly; the card's
    Bar_BOS logits under them match the CPU's, and a constant combo changes
    them (the control). Returns the run's K1 launches."""
    import torch
    from etude_tpu_torch import infer
    from etude_tpu_torch.models.attr_prior import AttrPrior
    from etude_tpu_torch.models.generate_stream import StreamingGenerationEngine
    from etude_tpu_torch.ops.decode_attention import decode_attention

    seen = {}
    real = StreamingGenerationEngine.generate

    def spy(self, m, bars, attrs, **kw):
        seen["bars"], seen["attrs"] = bars, attrs
        return real(self, m, bars, attrs, **kw)

    StreamingGenerationEngine.generate = spy
    decode_attention.launches = 0
    try:
        rc = infer.main(["--config", str(options_settings(cli_root)), "--decode-only",
                         "--attrs-prior", "--allow-random-weights", "--output_name", "prior",
                         "--seed", "7"])
    finally:
        StreamingGenerationEngine.generate = real
    launches = decode_attention.launches
    if rc != 0 or "attrs" not in seen:
        raise RuntimeError(f"infer --attrs-prior exited {rc}")
    want = AttrPrior.load(ROOT / "checkpoints" / "attr_prior").predict_bins(
        seen["bars"], vocab, seed=7)
    if seen["attrs"] != want:
        raise RuntimeError("the per-bar bins of the CLI run differ from the CPU's")
    combos = [tuple(sorted(a.items())) for a in want]
    constant = {"polyphony_bin": 1, "rhythm_intensity_bin": 1, "sustain_bin": 1,
                "pitch_overlap_bin": 2}
    i = next((i for i, a in enumerate(want) if a != constant), 0)
    bars = seen["bars"]
    window = [bars[max(i - 2, 0)], bars[max(i - 1, 0)], bars[i], bars[i], bars[i]]
    card = teacher_forced_logits(model, config, vocab, window, want[i], "cuda")
    host = teacher_forced_logits(host_model, config, vocab, window, want[i], "cpu")
    control = teacher_forced_logits(model, config, vocab, window, constant, "cuda")
    gap, excess = (card - host).abs().max().item(), logit_excess(card, host)
    moved, moved_excess = (control - host).abs().max().item(), logit_excess(control, host)
    say(f"  --attrs-prior CLI: {len(want)} bars, {len(set(combos))} distinct bin combos, equal "
        f"to the CPU's predictor; K1 launches {launches}. Bar {i} ({want[i]}): card vs CPU "
        f"logits max|diff| {gap:.3g}; control, constant combo {constant}: {moved:.3g}")
    if excess > 0:
        raise RuntimeError(f"attrs-prior logits: card vs CPU differ by {gap:.3g}")
    if moved_excess <= 0:
        raise RuntimeError(f"the attrs-prior check missed its control ({moved:.3g})")
    if launches == 0 or launches % config.num_hidden_layers:
        raise RuntimeError(f"decode_attention launched {launches} times, not 8 per S=1 chunk")
    return launches


def reference_files(root: Path, config):
    """Synthetic reference checkpoints at the published widths, drawn from
    seed 1 and written as a user holds them: the decoder's `.pth`
    ({"model_state_dict": ...}), the hFT's `.pth` and whole-model `.pkl`,
    the Beat-Transformer's `.pth` ({"state_dict": ...}) with its dilated
    layers' query and key weights x8, so that each head's softmax over its
    5 keys is peaked and head 7's keys matter. Returns the settings that
    name them, as a user's would."""
    import torch
    from etude_tpu_torch.config import ExtractorConfig, load_config
    from etude_tpu_torch.data.extractor import amt_config_from
    from etude_tpu_torch.models.beat_transformer import BeatTransformerConfig
    from etude_tpu_torch.tools import reference_state as rs
    from etude_tpu_torch.weights import (init_amt_params_np, init_beat_params_np,
                                         init_decoder_params_np)

    root.mkdir(parents=True, exist_ok=True)
    torch.save({"model_state_dict": rs.decoder_state_dict(
        init_decoder_params_np(config, seed=1), config)}, root / "decoder.pth")
    amt_config = amt_config_from(ExtractorConfig())
    hft = rs.amt_state_dict(init_amt_params_np(amt_config, seed=1), amt_config)
    torch.save(hft, root / "hft.pth")
    rs.save_whole_model(hft, root / "hft.pkl")
    beat_config = BeatTransformerConfig()
    beat = init_beat_params_np(beat_config, seed=1)
    for layer in beat["layers"]:
        layer["q"]["w"] *= 8.0
        layer["k"]["w"] *= 8.0
    torch.save({"state_dict": rs.beat_state_dict(beat, beat_config)}, root / "beat.pth")
    return load_config(None, {"paths": {
        "decoder_model": str(root / "decoder.pth"),
        "decoder_config": str(ROOT / "checkpoints/decoder/etude_decoder_config.json"),
        "extractor_model": str(root / "hft.pth"),
        "beat_detector_model": str(root / "beat.pth"),
    }})


def options_reference(root: Path, vocab, bars, features):
    """Reference weights through the loaders as a user names them: the
    decoder on the rebuild path (card vs CPU within LOGIT_ATOL, beside the
    zeroed-attention controls), the hFT from `.pth` and `.pkl` (equal
    weights; card bf16 heads vs CPU f32 within HFT_ATOL, beside its
    controls), the Beat-Transformer with head-7 compat (9 K2 launches, each
    with head 7's keys from head 6; card bf16 activations vs CPU f32 within
    ACT_ATOL; control: the same weights without the compat). Returns the K2
    launches."""
    import numpy as np
    import torch
    import etude_tpu_torch.models.beat_transformer as beat_transformer
    from etude_tpu_torch.data.beat_detector import BeatDetector
    from etude_tpu_torch.data.extractor import AMTAPC_Extractor
    from etude_tpu_torch.ops.dilated_attention import dilated_attention
    from etude_tpu_torch.utils.model_loader import load_etude_decoder
    from etude_tpu_torch.utils.torch_port import load_torch_beat_checkpoint

    from etude_tpu_torch.models.decoder import EtudeDecoderConfig

    config = EtudeDecoderConfig.from_json_file(
        ROOT / "checkpoints/decoder/etude_decoder_config.json")
    settings = reference_files(root, config)
    paths = settings.paths
    model, config = load_etude_decoder(paths.decoder_config, paths.decoder_model, "cuda")
    host_model, _ = load_etude_decoder(paths.decoder_config, paths.decoder_model, "cpu")
    decoder_parity("reference decoder .pth", model, host_model, config, vocab, bars,
                   {"polyphony_bin": 0, "rhythm_intensity_bin": 2, "sustain_bin": 1,
                    "pitch_overlap_bin": 2})
    del model, host_model

    pkl = AMTAPC_Extractor(settings.extractor, model_path=root / "hft.pkl", device="cpu")
    pth = AMTAPC_Extractor(settings.extractor, model_path=paths.extractor_model, device="cpu")
    for (name, a), b in zip(pkl.model.state_dict().items(), pth.model.state_dict().values()):
        if not torch.equal(a, b):
            raise RuntimeError(f"hFT .pkl and .pth weights differ at {name}")
    say("  reference hFT: .pkl (a pickled whole model of unknown classes) and .pth load "
        "the same weights")
    extract_parity(root, model_path=paths.extractor_model)

    real = beat_transformer.dilated_attention
    flags = []

    def recorded(q, k, v, er, dilation, head7_bug=False):
        flags.append(head7_bug)
        return real(q, k, v, er, dilation, head7_bug=head7_bug)

    card = BeatDetector(settings.beat_detector, model_path=paths.beat_detector_model,
                        device="cuda")
    host = BeatDetector(settings.beat_detector, model_path=paths.beat_detector_model,
                        device="cpu")
    if not (card.model.config.compat_head7_bug and host.model.config.compat_head7_bug):
        raise RuntimeError("reference beat weights loaded without the head-7 compat")
    ref = host.activations(features)
    dilated_attention.launches = 0
    beat_transformer.dilated_attention = recorded
    try:
        out = card.activations(features)
    finally:
        beat_transformer.dilated_attention = real
    launches = dilated_attention.launches
    plain = BeatDetector(settings.beat_detector, device="cuda", params=load_torch_beat_checkpoint(
        paths.beat_detector_model, host.model_config))
    control = float(np.abs(plain.activations(features) - ref).max())
    err = float(np.abs(out - ref).max())
    say(f"  reference Beat-Transformer .pth: K2 launches {launches} (expected 9), head7_bug "
        f"{flags}; activations [{ref.shape[0]}, 2], card bf16 vs CPU f32 max|diff| {err:.3g} "
        f"(atol {ACT_ATOL}); control, the same weights without the compat: {control:.3g}")
    if launches != 9 or flags != [True] * 9:
        raise RuntimeError(f"K2 launched {launches} times with head7_bug {flags}")
    if not np.isfinite(out).all() or err > ACT_ATOL:
        raise RuntimeError(f"card vs CPU reference beat activations differ by {err:.3g}")
    if control <= ACT_ATOL:
        raise RuntimeError(f"the head-7 check missed its control ({control:.3g})")
    return launches


def quant_parity(model, host_model, config, bars, attr):
    """`chunk_parity`'s chunks on int8 caches, card vs CPU (both plain
    PyTorch with exact integer dots): within QUANT_LOGIT_ATOL; control: one
    layer's attention output zeroed on the card."""
    import torch
    from etude_tpu_torch.ops.decode_attention import decode_attention

    before = decode_attention.launches
    card = chunk_logits(model, config, bars, attr, "cuda", quant=True)
    host = chunk_logits(host_model, config, bars, attr, "cpu", quant=True)
    with zeroed_attention(model, 0):
        control = chunk_logits(model, config, bars, attr, "cuda", quant=True)
    if decode_attention.launches != before:
        raise RuntimeError("the int8 path launched the decode-attention kernel")
    gap = max((a - b).abs().max().item() for a, b in zip(card, host))
    moved = max((a - b).abs().max().item() for a, b in zip(control, host))
    say(f"  int8 cache chunks, card vs CPU logits: max|diff| {gap:.3g} (atol "
        f"{QUANT_LOGIT_ATOL}); control, layer 0's attention output zeroed: {moved:.3g}")
    if not all(bool(a.isfinite().all()) for a in card) or gap > QUANT_LOGIT_ATOL:
        raise RuntimeError(f"int8 card vs CPU logits differ by {gap:.3g}")
    if moved <= QUANT_LOGIT_ATOL:
        raise RuntimeError(f"the int8 logit check missed its control ({moved:.3g})")


def options_kv_quant(model, host_model, config, vocab, bars, attrs):
    """16 streams x 24 corpus bars (bars capped at 64 tokens), greedy, with
    the bf16 cache (K1) and the int8 cache (no kernel): tok/s and cache
    bytes of each; then int8 card vs CPU logits. Returns the bf16 run's K1
    launches."""
    from etude_tpu_torch.models.generate_stream import (StreamingGenerationEngine,
                                                        init_stream_cache)

    kw = dict(bar_bos_id=vocab.bar_bos_id, bar_eos_id=vocab.bar_eos_id, pad_id=vocab.pad_id,
              max_bar_token_limit=64)
    engines = {q: StreamingGenerationEngine(config, kv_quant=q, **kw) for q in (False, True)}
    C = engines[False].pack([bars] * len(attrs), attrs)["cache_len"]
    launches = 0
    for quant in (False, True):
        engine = engines[quant]
        engine.stats["single_token_chunks"] = 0
        outs, tokens, seconds, n = engine_run(engine, model, bars, attrs)
        check_streams(outs, len(bars), vocab.bar_bos_id, vocab.bar_eos_id, config.vocab_size, 64)
        expected = 0 if quant else engine.stats["single_token_chunks"] * config.num_hidden_layers
        if n != expected:
            raise RuntimeError(f"kv_quant={quant}: K1 launched {n} times, expected {expected}")
        launches += n
        cache = init_stream_cache(config, len(attrs), C, device="meta", quant=quant)
        kv_bytes = sum(t.numel() * t.element_size() for k, t in cache.items() if k != "slot_pos")
        say(f"  {'int8' if quant else 'bf16'} cache: {tokens} tokens in {seconds:.2f} s = "
            f"{tokens / seconds:.1f} tok/s; K/V{' + scales' if quant else ''} "
            f"{kv_bytes / 2**20:.1f} MiB at C = {C}; K1 launches {n}")
    quant_parity(model, host_model, config, bars, {"pitch_overlap": 2, "polyphony": 1,
                                                   "sustain": 1, "rhythm_intensity": 1})
    return launches


def options_bypass(root: Path):
    """The separator bypass on the card against the CPU on a 12 s click
    track, within BYPASS_DB_ATOL (control: the card's features one frame
    late); the features saved as `.npy` give `detect` the same beats as the
    array, and the file is gone afterwards (control: `cleanup_input=False`
    keeps it). Returns (features, K2 launches)."""
    import numpy as np
    from etude_tpu_torch.config import BeatDetectorConfig
    from etude_tpu_torch.data.beat_detector import BeatDetector
    from etude_tpu_torch.data.separation import SourceSeparator
    from etude_tpu_torch.ops.dilated_attention import dilated_attention

    wav = root / "click_12s.wav"
    write_click_wav(wav, 12.0, seed=1)
    npy = root / "bypass.npy"
    host = SourceSeparator(bypass=True, device="cpu").separate_features(wav)
    card = SourceSeparator(bypass=True, device="cuda").separate_features(
        wav, output_npy_path=npy)
    gap = float(np.abs(card - host).max())
    control = float(np.abs(np.roll(card, 1, axis=1) - host).max())
    say(f"  bypass features {card.shape}, card vs CPU max|diff| {gap:.3g} dB (limit "
        f"{BYPASS_DB_ATOL}); control, one frame late: {control:.3g} dB")
    if card.shape != host.shape or gap > BYPASS_DB_ATOL:
        raise RuntimeError(f"bypass features: card vs CPU differ by {gap:.3g} dB")
    if control <= BYPASS_DB_ATOL:
        raise RuntimeError(f"the bypass check missed its control ({control:.3g} dB)")
    detector = BeatDetector(BeatDetectorConfig(), device="cuda", allow_random_weights=True)
    dilated_attention.launches = 0
    want = detector.detect(card)
    kept = detector.detect(npy, cleanup_input=False)
    if not npy.exists():
        raise RuntimeError("detect removed its .npy input with cleanup_input=False")
    got = detector.detect(npy)
    launches = dilated_attention.launches
    if got != want or kept != want or npy.exists():
        raise RuntimeError(f"detect on the .npy: beats equal {got == want}, file left "
                           f"{npy.exists()}")
    say(f"  detect on {npy.name}: the array's {len(want['beat_pred'])} beats, the file "
        f"removed (kept with cleanup_input=False); K2 launches {launches}")
    return card, launches


def options_phase(root: Path, cli_root: Path, model, config, vocab, bars, attrs, flush):
    """The serving CLI's options; returns (K1, K2) launches of the runs that
    drive them."""
    import copy

    host_model = copy.deepcopy(model).cpu()
    k1 = options_rebuild(cli_root, model, host_model, config, vocab, bars, attrs, flush)
    k1 += options_attrs_prior(cli_root, model, host_model, config, vocab)
    k1 += options_kv_quant(model, host_model, config, vocab, bars, attrs)
    features, k2 = options_bypass(root)
    k2 += options_reference(root / "reference", vocab, bars, features)
    return k1, k2


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        say("chip_smoke: torch.cuda.is_available() is False; this run needs a GPU")
        return 1
    if not (ROOT / "etude_tpu_torch" / "__init__.py").exists():
        say(f"chip_smoke: the package etude_tpu_torch is not beside {__file__}")
        return 1
    sys.path.insert(0, str(ROOT))

    with phase("environment"):
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, check=True, timeout=60,
        ).stdout.strip()
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        kind = torch.cuda.get_device_name(0)
        say(f"  python {sys.version.split()[0]}, torch {torch.__version__}, "
            f"CUDA {torch.version.cuda}, {torch.cuda.device_count()} device(s): {kind}")
        say(f"  allow_tf32: matmul {torch.backends.cuda.matmul.allow_tf32}, "
            f"cudnn {torch.backends.cudnn.allow_tf32}")

    from etude_tpu_torch.ops import _build

    with phase("build"):
        for name, (seconds, log) in _build.build().items():
            compiler = "nvcc" if name in _build.CUDA_SOURCES else "g++"
            say(f"  {compiler} {_build.source_path(name).name}: {seconds:.2f} s")
            for line in log.splitlines():
                if "registers" in line or "spill" in line or "smem" in line:
                    say(f"    {line.strip()}")
        again = _build.build()
        if again:
            raise RuntimeError(f"rebuild with unchanged sources compiled {list(again)}")
        say("  rebuild: cache hit")

    from etude_tpu_torch.data.vocab import Vocab
    from etude_tpu_torch.models.decoder import EtudeDecoderConfig
    from etude_tpu_torch.models.generate_stream import StreamingGenerationEngine
    from etude_tpu_torch.weights import decoder_from_jax, init_decoder_params_np

    config = EtudeDecoderConfig.from_json_file(
        ROOT / "checkpoints/decoder/etude_decoder_config.json")
    vocab = Vocab.load(ROOT / "checkpoints/decoder/vocab.json")
    bars = corpus_bars(vocab, 24)
    engine = StreamingGenerationEngine(
        config, bar_bos_id=vocab.bar_bos_id, bar_eos_id=vocab.bar_eos_id,
        pad_id=vocab.pad_id, max_bar_token_limit=512,
    )
    attrs = [[{"polyphony_bin": s % 3, "rhythm_intensity_bin": (s // 3) % 3,
               "sustain_bin": (s // 9) % 3, "pitch_overlap_bin": 2}] * len(bars)
             for s in range(16)]
    main_C = engine.pack([bars] * 16, attrs)["cache_len"]
    input_C = engine.pack([bars], attrs[:1])["cache_len"]   # one stream, as --input runs

    with phase("kernels"):
        from etude_tpu_torch.ops.decode_attention import max_cache_len
        from etude_tpu_torch.utils.kernel_bench import L2Flush

        flush = L2Flush()
        shapes = [(B, C) for B in (1, 16, 27) for C in (769, 1353)] + [(16, main_C)]
        rows = [check_kernel(B, C, seed, flush) for seed, (B, C) in enumerate(shapes)]
        # `--input` decodes one stream: B = 1 at the stream engine's C.
        input_row = check_kernel(1, input_C, 40, flush)
        rows.append(input_row)
        say(f"  decode_attention at the --input shape (B=1, C={input_C}): kernel "
            f"{input_row['ms']:.4f} ms, masked SDPA {input_row['library_ms']:.4f} ms, plain "
            f"{input_row['plain_ms']:.4f} ms, bound {input_row['bound_ms']:.4f} ms")
        # The cluster's edges (4 chunks of ceil(C / 4) slots): C = 1 leaves
        # three blocks with no slot, C = 7 one short chunk, C = 9 one empty;
        # the serving C at B = 1 and 27; the largest C the wrapper accepts.
        edges = [(1, 1), (1, 7), (16, 9), (1, main_C), (27, main_C), (1, max_cache_len())]
        rows += [check_kernel(B, C, 50 + i, flush, timed=False)
                 for i, (B, C) in enumerate(edges)]
        # K2 at B = 5 stems: a 2048-frame bucket, a 240 s song's 10,336
        # frames (classes of two lengths at every dilation) and its
        # 12,288-frame bucket, whose 9 dilations are one Beat-Transformer
        # forward; T below the dilation; head7_bug at both ends.
        k2_cases = ([(2048, d) for d in (1, 256)] + [(10336, 2 ** i) for i in range(9)]
                    + [(12288, 2 ** i) for i in range(9)] + [(77, 128), (200, 256)])
        k2_rows = [check_dilated(5, T, dil, 100 + i, flush)
                   for i, (T, dil) in enumerate(k2_cases)]
        k2_rows += [check_dilated(5, 12288, dil, 200 + dil, flush, head7_bug=True)
                    for dil in (1, 8, 256)]
        k2_main = [r for r in k2_rows if r["T"] == 12288 and not r["head7_bug"]]
        say(f"  dilated_attention, one forward at T=12288 (9 launches): kernel "
            f"{sum(r['ms'] for r in k2_main):.4f} ms, plain "
            f"{sum(r['plain_ms'] for r in k2_main):.4f} ms, bound "
            f"{sum(r['bound_ms'] for r in k2_main):.4f} ms")
        del flush

    with phase("serving"):
        model = decoder_from_jax(init_decoder_params_np(config, seed=0), config, "cuda")
        say(f"  decoder: {sum(p.numel() for p in model.parameters())} parameters, "
            f"{len(bars)} corpus bars, 16 streams, cache C = {main_C}")
        say(f"  host: {host_launch_us():.2f} us per eager launch (1-element add)")
        launches = 0
        for kw in ({"temperature": 0.0}, {"temperature": 1.0, "top_p": 0.9, "seed": 1234}):
            outs, n = serve(engine, model, bars, attrs, **kw)
            check_streams(outs, len(bars), vocab.bar_bos_id, vocab.bar_eos_id,
                          config.vocab_size, engine.max_bar_token_limit)
            launches += n
        profile_window(model, config, vocab, bars, attrs)
        chunk_parity(model, config, bars, {"pitch_overlap": 2, "polyphony": 1,
                                           "sustain": 1, "rhythm_intensity": 1})

    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        song = tmp / "click_240s.wav"
        write_click_wav(song, SONG_SECONDS, seed=0)
        with phase("structuralize"):
            k2_launches = structuralize(tmp / "stage2", song)
            stage2_parity(tmp)

        with phase("extract"):
            extract(tmp / "stage1", song)
            extract_parity(tmp)

        with phase("pipeline"):
            work, k1, k2 = pipeline(tmp / "pipeline", song)
            launches += k1
            k2_launches += k2

        with phase("prepare"):
            k2_launches += prepare_phase(tmp / "prepare")

        with phase("evaluate"):
            evaluate_phase(tmp / "evaluate", tmp / "prepare",
                           tmp / "pipeline" / "outputs" / "infer" / "pipeline.mid")

        with phase("cli"):
            from etude_tpu_torch import infer
            from etude_tpu_torch.ops.decode_attention import decode_attention
            from etude_tpu_torch.utils.midi import read_midi_notes

            settings = cli_work_dir(tmp / "cli", work, 30.0)
            decode_attention.launches = 0
            rc = infer.main(["--config", str(settings), "--decode-only",
                             "--allow-random-weights", "--output_name", "smoke",
                             "--seed", "7"])
            launches += decode_attention.launches
            out = tmp / "cli" / "outputs" / "infer" / "smoke.mid"
            if rc != 0 or not out.exists():
                raise RuntimeError(f"infer exited {rc}; {out} exists: {out.exists()}")
            notes = read_midi_notes(out)
            say(f"  {out.name}: {out.stat().st_size} bytes, {len(notes)} notes; K1 launches "
                f"{decode_attention.launches}")

        with phase("train"):
            k1, trained = train_phase(tmp / "train", tmp / "cli")
            launches += k1

        with phase("aux_train"):
            from etude_tpu_torch.utils.kernel_bench import L2Flush

            aux_k2, k2b_launches, k2b_rows, separator = aux_train_phase(tmp / "aux", L2Flush())
            k2_launches += aux_k2

        with phase("recipe"):
            launches += recipe_phase(tmp / "recipe", trained, separator, tmp / "cli")

        with phase("options"):
            from etude_tpu_torch.utils.kernel_bench import L2Flush

            k1, k2 = options_phase(tmp / "options", tmp / "cli", model, config, vocab, bars,
                                   attrs, L2Flush())
            launches += k1
            k2_launches += k2

    main_row = rows[len(shapes) - 1]
    k2b_train = [r for r in k2b_rows if r["T"] == 512 and not r["head7_bug"]]
    say(json.dumps({"kernels": [{
        "name": "decode_attention",
        "route": "cuda",
        "source": "etude_tpu_torch/csrc/decode_attention.cu",
        "replaces": "etude_tpu/ops/decode_attention.py:56",
        "launches": launches,
        "max_abs_err": max(r["max_abs_err"] for r in rows),
        "ms": main_row["ms"],
        "plain_ms": main_row["plain_ms"],
        "bound_ms": main_row["bound_ms"],
        "bound_by": main_row["bound_by"],
        "library_ms": main_row["library_ms"],
    }, {
        # Per launch on the main path: the mean over the 9 dilations of one
        # forward at the 12,288-frame bucket of a 240 s song.
        "name": "dilated_attention",
        "route": "cuda",
        "source": "etude_tpu_torch/csrc/dilated_attention.cu",
        "replaces": "etude_tpu/ops/dilated_attention.py:276",
        "launches": k2_launches,
        "max_abs_err": max(r["max_abs_err"] for r in k2_rows),
        "ms": statistics.mean(r["ms"] for r in k2_main),
        "plain_ms": statistics.mean(r["plain_ms"] for r in k2_main),
        "bound_ms": statistics.mean(r["bound_ms"] for r in k2_main),
        "bound_by": k2_main[0]["bound_by"],
        "library_ms": None,
    }, {
        # K2's backward, per call (two launches) on the main path: the mean
        # over the 9 dilations of one beat training step (B = 40, T = 512).
        "name": "dilated_attention_backward",
        "route": "cuda",
        "source": "etude_tpu_torch/csrc/dilated_attention_bwd.cu",
        "replaces": "etude_tpu/ops/dilated_attention.py:276",
        "launches": k2b_launches,
        "max_abs_err": max(r["max_abs_err"] for r in k2b_rows),
        "ms": statistics.mean(r["ms"] for r in k2b_train),
        "plain_ms": statistics.mean(r["plain_ms"] for r in k2b_train),
        "bound_ms": statistics.mean(r["bound_ms"] for r in k2b_train),
        "bound_by": k2b_train[0]["bound_by"],
        "library_ms": None,
    }]}))
    say(smi)
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
