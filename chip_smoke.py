#!/usr/bin/env python3
"""Smoke run of the PyTorch port (etude_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each announced with a flushed line when it starts and ends:

  1. environment    card name and power limit (nvidia-smi), torch/CUDA
                    versions; TF32 off for matmuls and cuDNN; the size of
                    this checkout and of its checkpoints_torch/
  2. build          nvcc builds every CUDA source of the port and g++ the
                    host sources (the DBN decoder, the banded DTW, the FIR
                    resampler), all at once; a second build must be a cache
                    hit
  3. kernels        each hand kernel against its plain PyTorch version on the
                    card at the main path's shapes, with timings (L2 flushed,
                    device time) beside its bound and a library call where
                    one exists, and at its designs' edge cases; two
                    launches on the same inputs must give the same bits;
                    the backward kernel K2b against autograd of K2's plain
                    version at the training shape (B = 40, T = 512, all 9
                    dilations) and the serving shape (B = 5, T = 12,288,
                    three dilations), head7_bug both ways, timed, each
                    beside a control (the gradient at another dilation)
                    that it must catch, and K2's forward at the training
                    shape
  4. serving        the streaming engine with the shipped decoder
                    (checkpoints_torch/decoder) over GREEDY_BARS real corpus
                    bars, 16 lockstep streams, greedy, then sampled over the
                    first SAMPLED_BARS of them; tokens per bar and the share
                    of bars ended by Bar_EOS; the K1 launch count must equal
                    the engine's S = 1 chunks x layers; a short window under
                    torch.profiler shows where a step's time goes; then the
                    same chunks on the card and on the CPU must agree
  5. structuralize  `InferencePipeline._run_stage2_structuralize` from the
                    shipped separator and Beat-Transformer (the default
                    paths) on the song: 240 s of seed 0's `grid_song` at
                    100 BPM rendered by the piano synth at 44.1 kHz
                    (`write_song`): span times, 9 K2 launches per forward, a
                    well-formed tempo.json; then, on the song's first
                    CLIP_SECONDS, the card's f32 separation features and bf16
                    beat activations against the port's CPU f32 path, each
                    beside a control it must catch, and the card's
                    tempo.json against the CPU's
  6. extract        `AMTAPC_Extractor.extract` from the shipped extractor on
                    the song, cold, warm, profiled: spans (resample apart),
                    segments and groups, notes before and after the
                    minimum-duration filter, peak device memory, the top
                    device operations and the device's idle share; a
                    well-formed extract.json; the front end's matmul against
                    `F.conv2d` of the same filter, timed; then, on the clip,
                    the card's bf16 head activations against the port's CPU
                    f32 path, beside controls it must catch (one attention
                    layer's output zeroed at a time), and the card's
                    extract.json against the CPU's on the song's first
                    NOTES_CLIP_SECONDS
  7. shipped        `etude_tpu_torch.infer --input` in-process on the song
                    from the default model paths (the shipped exports, each
                    params.npz's sha256 held to checkpoints_torch/
                    manifest.json), without --allow-random-weights, at the
                    512-token bar cap: the native FIR resampler timed
                    against scipy on the song; the five outputs exist and
                    are well formed, the MIDI parses; the notes and their
                    onset F1 against the rendered notes, the beats and
                    downbeats against the rendered grid, the bars and tempo
                    of tempo.json, tokens per bar and the share ended by
                    Bar_EOS, the wall of each stage; 9 K2 launches and K1
                    launches a multiple of 8; then `--input SONG_URL` with
                    the same settings and seed through YTDLP_STUB on PATH,
                    a stand-in for yt-dlp that copies the song (no network):
                    one call with the JAX package's argv, origin.wav the
                    song bit for bit, the file run's checks, extract.json,
                    tempo.json, beat_pred.json, volume.json and the MIDI
                    equal to the file run's bit for bit; control: with no
                    yt-dlp on PATH it exits 1 and writes no MIDI
  8. prepare        `etude_tpu_torch.prepare` from its default `--start-from
                    download`, in-process: stage 1 fetches a CSV's ids
                    through YTDLP_STUB (the stub's argv, the warning's list
                    of failed songs: the third, whose id it fails on; the
                    raw/ tree the renders bit for bit), on a two-song corpus
                    synthesized from seeds
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
                    shipped phase's work dir cut to its first 30 s (bars
                    capped at 32 tokens), from the shipped decoder, to a
                    MIDI file that parses
 11. train          `etude_tpu_torch.train` in-process at the published decoder
                    widths on dataset_distill/tokenized (500 songs, 1024-token
                    chunks) with configs/distill.yaml's train settings, 10
                    steps, `latest` saved every 5, host syncs an error in
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
 12. multigpu       multi-GPU decoder training and the sweep over cards; it
                    prints the world size it ran at (the number of visible
                    cards). An NCCL world of one: the FSDP state
                    (`init_sharded_state(fsdp=True)`; its step gathers the
                    parameters and reduce-scatters the gradients over the
                    group) against the plain step without a group, for 3
                    steps of configs/distill.yaml's batch at the published
                    widths, under torch's deterministic algorithms (the
                    card's default backward is not), equal bit for bit in
                    bf16, no host sync after the first step (control: one
                    row's labels shifted); an FSDP checkpoint restored onto
                    other weights resumes bit for bit (control: moments
                    zeroed); `dryrun_multichip`
                    over every card; the 27-combo sweep over 4 corpus bars
                    (64-token cap) on one card and spread over the cards
                    (two threads on card 0 when there is one), greedy tokens
                    equal up to near-ties (counted), K1 launches = S = 1
                    chunks x layers; `infer --decode-only --sweep` batched
                    on one card (the engine gets no devices; 27 MIDI
                    files); each op of the training step run twice at the
                    distill micro-batch's shapes, the ops whose backward
                    differs run to run, by default and under deterministic
                    algorithms. With two or more cards, also the mesh step
                    over every card against one card for 8 steps of real
                    learning (losses and gradient norms within measured
                    limits; control: the gradients' all-reduce skipped),
                    the training CLI with `mesh.data_parallel` = the card
                    count against one card (10 steps, losses within the
                    card-vs-CPU step limit), and `tools/mesh_bench.py` at
                    1, 2 and all ranks (and FSDP at all; its losses held
                    to one rank's): warm step, tokens/s, the collectives'
                    share of device time, peak memory per card
 13. aux_train      `etude_tpu_torch.train_aux` in-process for
                    beat, amt and separator at the published widths and
                    the script's batches and frames (AUX_CLI_STEPS: beat
                    30 steps, amt and separator 15), with 2
                    held-out clips: warm step time, the host's share of
                    it, peak memory, a profiled window's device idle share,
                    9 K2 and 9 K2b launches per beat step; checks, each
                    beside a control it must catch: learning on one fixed
                    batch (rate 0 changes nothing), one step on the card
                    against the CPU (labels shifted), and `--input` on a
                    30 s click track served from the phase's own exports
                    (loaded, no random weights; 9 K2 launches)
 14. corpus         the aux models' corpus training at the published widths,
                    from the aux_train phase's exports (the separator of the
                    features, the warm starts), on a synthetic corpus of
                    CORPUS_SONGS songs of about a minute written from a seed
                    (`tools/synthetic_corpus.py`, at
                    `corpus_render.CORPUS_ROOT`): the scene and pseudo-pop
                    scripts (`gen_beat_scenes`, `gen_pseudopop_scenes`
                    render and features, `gen_pseudopop_sep_examples`),
                    whose shards must hold the JAX scripts' keys, shapes
                    and dtypes; `train_aux` in-process for `beat-corpus
                    --corpus-limit 2`, `beat --scenes-dir`, `amt-corpus`
                    and `separator --pseudopop-mix 0.5` with and without
                    `--pseudopop-cache`, CORPUS_STEPS steps each at the
                    published batch: the warm step with the batch wait's
                    share, the device's idle share (against the aux_train
                    phase's profiled device time per step of the same
                    model at the same batch shape), exports
                    whose metadata have the JAX keys with finite values in
                    range, the feature cache's files; `validate_beat_corpus`
                    and `eval_separator_pseudopop` on the held-out songs;
                    in every stage K2 launches = 9 per Beat-Transformer
                    forward (forwards counted apart) and K2b launches = 9
                    per beat training step; one beat-corpus batch's loss,
                    card bf16 against CPU f32, within aux_train's limit
                    (control: the labels shifted); the wall of each stage
                    and the render's seconds per audio second
 15. decoder_corpus the decoder-corpus scripts in-process on a synthetic
                    corpus of DC_SONGS songs of 20-25 s from seed 0, each
                    timed with its K1 and K2 launches counted from 0 (K2 = 9
                    per Beat-Transformer forward), its outputs holding the
                    JAX scripts' keys and its MIDIs parsing:
                    `distill_dataset --grid rgc` with DC_AUGMENT on the card
                    and on the CPU, equal bit for bit, and `--grid tracker`
                    from the aux_train phase's exports (the songs that picked
                    the tracker); `TrackerGrid` on one song card vs CPU
                    (the shipped separator and beat model): the refined
                    downbeats within DC_DOWNBEAT_ATOL and the same grid
                    picked (control: the audio one activation frame later);
                    `eval_distilled --engine rebuild --teacher-forced-history`
                    on DC_EVAL_SONGS songs from the train phase's run (K1 =
                    S = 1 steps x 8), the device's idle share on a window of
                    it, and its first song's bars against the CPU's, each
                    equal or first differing at a near-tie (TIE_MARGIN);
                    `eval_engine_parity`; `sweep_sampling` (2 songs, T 0 and
                    0.7) and `eval_full_pipeline` (1 song) from the shipped
                    extractor, separator and beat model with the run's
                    decoder; `validate_wpd_audio_path` (2 songs) and
                    `diagnose_wpd_outliers` (one song, its three ablations)
 16. recipe         the decoder's recipe through the scripts, at full width:
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
                    child's CPU share per poll; `train_attr_prior` on the
                    first PRIOR_SONGS corpus songs on the card (features
                    and fit timed apart,
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
 17. options        the serving CLI's other options, each check beside a
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
                    bf16 on 16 streams x QUANT_BARS (64-token cap): tok/s,
                    cache bytes, int8 logits card vs CPU within
                    SHIPPED_QUANT_ATOL; the separator bypass card vs CPU
                    within BYPASS_DB_ATOL (control: a frame late) and
                    `detect` on its saved `.npy` (the array's beats, the
                    file removed); synthetic reference `.pth`/`.pkl`
                    weights at the published widths loaded through
                    `paths.*`: decoder logits, hFT heads (`.pkl` = `.pth`),
                    and the Beat-Transformer with 9 K2 launches with head
                    7's keys from head 6 (control: without the compat)

After the kernels phase the phases run in two lanes, two processes on
the one card, since each phase is bound by its host thread: this one runs
serving, structuralize, extract, shipped, evaluate, cli, train, multigpu,
recipe and options; the second (`chip_smoke.py --lane DIR T0`, started
here, its output printed at the end) runs prepare, aux_train, corpus and
decoder_corpus. A phase that needs another lane's output waits for it:
evaluate for prepare's songs, decoder_corpus for the train phase's run,
recipe for the aux_train phase's exports. Times taken beside the other
lane (every phase's but the kernels phase's, whose timings the kernels
line reports) share the card and the host's cores with it.

It prints a `{"kernels": [...]}` line, whose launches are those of the
serving, structuralize, shipped, prepare, cli, train, multigpu, aux_train,
corpus, decoder_corpus, recipe and options runs,
each counted from 0 (K2b's: the aux_train and corpus phases' beat runs'), then
`{"ok": true, "device": ...}` as its last line, and exits 0. Any failure
raises and exits non-zero with no result line; so does a machine without
CUDA, and a directory that holds this script without the package. It
imports nothing of JAX or of etude_tpu.
"""

from __future__ import annotations

import contextlib
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path
from typing import Optional

ROOT = Path(__file__).resolve().parent
T0 = time.perf_counter()

# Card vs CPU logits of seeded decoder weights (the synthetic reference
# .pth, entry()), both bf16 paths; the shipped decoder's have limits of
# their own (SHIPPED_LOGIT_ATOL below).
LOGIT_ATOL, LOGIT_RTOL = 2e-2, 2e-2
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
# Card vs CPU with the shipped weights, whose outputs are sharper than seed
# 0's, so the limits above are too tight for them. Measured on H100s (NVIDIA
# H100 80GB HBM3, 700 W), the same in each run; each limit is at least twice
# its reading and far below every control's, but for the beat activations,
# whose limit is 1.6 times the reading and 0.69 times the nearest control:
# - decoder logits, both bf16 paths: the serving chunks 0.180, the
#   rebuild path's teacher-forced chunks 0.162, the --attrs-prior
#   chunks 0.181; one layer's attention output zeroed moves them by 6.8 to
#   19.7 (a constant combo instead of the prior's: 12.6);
# - the int8 cache's chunks: 0.413; layer 0's attention output zeroed: 23.7;
# - beat activations, card bf16 vs CPU f32 on the clip: 0.0438; one layer's
#   K2 output zeroed: 0.101 to 0.742;
# - hFT heads, card bf16 vs CPU f32 on the clip's first segment: 0.0732;
#   one attention layer's output zeroed: 0.495 to 1.
SHIPPED_LOGIT_ATOL, SHIPPED_QUANT_ATOL = 0.5, 1.0
SHIPPED_ACT_ATOL, SHIPPED_HFT_ATOL = 0.07, 0.2
# Card vs CPU on the song's first CLIP_SECONDS from the shipped weights:
# tempo.json's downbeats within one beat-activation frame (1024 samples at
# 44.1 kHz) and tempi within 1%; extract.json's notes matched one to one
# (pitch exact, onsets within one 16 kHz / 256 frame) at an F1 of at least
# NOTE_PARITY_F1.
TEMPO_DOWNBEAT_ATOL, TEMPO_BPM_RTOL = 1024 / 44100, 1e-2
NOTE_ONSET_ATOL, NOTE_PARITY_F1 = 256 / 16000, 0.98
# The shipped phase's floor on what real weights give (random weights keep
# no note and rarely end a bar): the onset F1 of extract.json against the
# rendered notes, and the share of decoded bars that end at Bar_EOS.
SHIPPED_MIN_F1, SHIPPED_MIN_EOS = 0.5, 0.5
# The shipped phase's URL input and the prepare phase's stage 1 run through
# YTDLP_STUB, a stand-in for yt-dlp that fetches nothing (it copies a local
# file named for each URL), so no run touches the network. YTDLP_ARGV is
# the command `utils/download.py` gives yt-dlp after its path, as the JAX
# package's module gives it (tests/test_torch_download.py holds the two).
YTDLP_ARGV = ("-f", "bestaudio", "--extract-audio", "--audio-format", "wav",
              "-o", "{stem}.%(ext)s", "{url}")
SONG_URL = "https://example.invalid/song"
YTDLP_STUB = '''#!{python}
"""A stand-in for yt-dlp that fetches nothing: it appends its argv to
calls.jsonl beside it, then copies the file that sources.json beside it
names for the URL (the last argument) to the -o template with %(ext)s made
wav. A URL named there as null writes nothing; one not named fails with a
line on stderr and exit 1."""
import json
import shutil
import sys
from pathlib import Path

here = Path(__file__).resolve().parent
with open(here / "calls.jsonl", "a", encoding="utf-8") as log:
    log.write(json.dumps(sys.argv) + "\\n")
url, template = sys.argv[-1], sys.argv[sys.argv.index("-o") + 1]
sources = json.loads((here / "sources.json").read_text(encoding="utf-8"))
if url not in sources:
    sys.exit("ERROR: [generic] Unable to download " + url + ": no such source")
if sources[url] is not None:
    shutil.copyfile(sources[url], template.replace("%(ext)s", "wav"))
'''
# Card vs CPU separator-bypass features (no U-Net: the mix's f32 DFT and mel
# on both), in dB.
BYPASS_DB_ATOL = 1e-3
# The int8 and bf16 caches are timed over the first QUANT_BARS corpus bars
# (24 until the corpus phase needed the room).
QUANT_BARS = 16
BF16_PEAK, F32_PEAK = 989e12, 67e12   # H100 SXM data sheet, dense, at 700 W
SONG_SECONDS = 240.0          # a 4-minute song: 10,336 frames at 44.1 kHz / 1024
# The song of the structuralize, extract and shipped phases (`write_song`):
# seed 0's grid_song with an eighth of SHIPPED_EIGHTH s (100 BPM, a tempo
# the shipped beat model tracks on these renders; a 120 BPM render it
# tracked at a slower tempo), and the clip of its first CLIP_SECONDS that
# the card-vs-CPU checks run on.
SHIPPED_EIGHTH, CLIP_SECONDS = 0.3, 30.0
# The card-vs-CPU notes run on the song's first NOTES_CLIP_SECONDS: two
# 512-frame segments, which the CPU's extractor takes as one group of
# NOTES_CPU_GROUP (the same notes as in the production group of 8). A group
# is padded to its size, so the full-width CPU extract in a group of 8 took
# 61-63 s on the card's host for four segments or two; the 30 s clip in a
# group of 8 was used until the URL run needed the room.
NOTES_CLIP_SECONDS, NOTES_CPU_GROUP = 16.0, 2
# The serving phase decodes its 24 corpus bars greedily (GREEDY_BARS; the
# cache is C = 1217), then samples over the first SAMPLED_BARS: enough to
# check both, and it keeps the whole run inside its time limit on a slow
# host beside the corpus phase.
GREEDY_BARS, SAMPLED_BARS = 24, 4
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
# 10 steps (40, then 20, each cut to make room for a later phase).
TRAIN_STEPS, TRAIN_SAVE_EVERY = 10, 5
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
# Aux training: optimizer steps of the learning check and of the schedule
# elsewhere, held-out clips, the served track's seconds, and each mode's CLI
# steps (the hFT's and the separator's at 15, half the beat model's, to
# keep the run inside its time limit). The beat model keeps 30: `--input`
# from the exports needs its downbeats, which 10 steps did not give.
AUX_STEPS, AUX_EVAL_CLIPS, AUX_SERVE_SECONDS = 30, 2, 30.0
AUX_CLI_STEPS = {"beat": 30, "amt": 15, "separator": 15}
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
# The corpus phase: CORPUS_SONGS synthetic songs of CORPUS_SECONDS from seed
# 0, CORPUS_STEPS steps of each corpus mode at the published batch, one
# held-out synthetic clip, the held-out corpus evaluations' horizon in
# seconds, and the shards of the scripts (scenes of each kind, separator
# rows).
CORPUS_SONGS, CORPUS_SECONDS, CORPUS_STEPS = 6, (55.0, 65.0), 10
CORPUS_EVAL_SECONDS, CORPUS_SCENES, CORPUS_SEP_ROWS = 30.0, 4, 8
# The metadata keys of each corpus run beside the loop's (first_loss,
# final_loss, steps, seconds), as the JAX script writes them.
CORPUS_META = {
    "beat-corpus": {"beat_f_corpus", "beat_f_corpus_octave", "beat_f_per_song",
                    "beat_f_synthetic", "corpus", "corpus_frac", "train_song_versions",
                    "eval_songs", "warm_start", "train_frames", "model"},
    "beat": {"beat_f_measure", "corpus", "corpus_mix", "train_frames", "model",
             "beat_f_corpus", "beat_f_corpus_octave", "beat_f_per_song", "eval_songs"},
    "amt-corpus": {"onset_f1_corpus", "onset_f1_per_song", "eval_seconds", "corpus",
                   "corpus_frac", "train_songs", "eval_songs", "warm_start", "model"},
    "separator": {"stem_sdr_db", "baseline_sdr_db", "corpus", "train_frames", "model"},
}
# The recipe phase: the rollouts' songs (every RECIPE_STRIDE-th corpus song
# with RECIPE_BARS bar pairs, cut to them), the DAgger fine-tune's steps, the
# attribute prior's songs (the first PRIOR_SONGS of the corpus: its
# features are host work, about 31 s for all 500 songs on an H100's host)
# and its card-vs-CPU fit (songs, steps; f64 on both, weights stored as f32:
# held to 1e-6 relative with a 1e-7 floor; equal bit for bit on an H100,
# another seed 0.0198 away), and the remap check's chunk of corpus tokens.
RECIPE_SONGS, RECIPE_BARS, RECIPE_STRIDE, RECIPE_STEPS = 16, 6, 25, 4
PRIOR_SONGS = 100
PRIOR_SUBSET_SONGS, PRIOR_STEPS, PRIOR_RTOL, PRIOR_ATOL = 30, 300, 1e-6, 1e-7
REMAP_TOKENS = 256
# The multigpu phase: steps of the mesh step against the plain one, the
# split sweep's bars and per-bar token cap (the serving phase runs the
# 512-token cap), steps of the CLI's data-parallel run, and the near-tie
# margin that a greedy divergence between the split and the one-device
# sweep must fall under (tests/test_torch_generate_stream.py TIE_MARGIN).
MESH_STEPS, SWEEP_BARS, SWEEP_TOKENS, DP_CLI_STEPS = 3, 4, 64, 10
# The decoder_corpus phase: a synthetic corpus of DC_SONGS songs from seed
# 0; distill_dataset's augmentations; the tracker's card-vs-CPU song, the
# beat activations' frame (44.1 kHz / 1024) and the refined downbeats'
# limit, half a frame (the DBN lands beats on frames; the least-squares fit
# over a region's downbeats averages a flipped frame away; from the shipped
# weights on an H100 the gap reads 0 and the control gives another count of
# downbeats); eval_distilled's and eval_engine_parity's songs; the pipeline
# scripts' song length.
DC_SONGS, DC_SECONDS = 4, (20.0, 25.0)
DC_AUGMENT = ["--transpose", "1", "--phase-shifts", "1", "--double-time"]
DC_TRACKER_SONG, DC_FRAME = "CPOP01", 1024 / 44100
DC_DOWNBEAT_ATOL = DC_FRAME / 2
DC_EVAL_SONGS, DC_PIPELINE_SECONDS, DC_IDLE_BARS = 2, 20.0, 1
# The JAX scripts' output keys.
DC_EVAL_KEYS = {"songs", "mean_rgc", "mean_ipe", "mean_onset_f1_vs_target", "mean_notes",
                "oracle_attrs", "predicted_attrs", "temperature", "engine"}
DC_PARITY_KEYS = {"songs", "mean_cross_f1", "mean_rgc_rebuild", "mean_rgc_stream",
                  "mean_ipe_rebuild", "mean_ipe_stream", "temperature", "seed", "rows"}
TIE_MARGIN = 1.75e-2
# The mesh step over N cards against one card: MESH_LEARN_STEPS steps of the
# distill batch from seed 0's weights at rate 2e-4 after one warmup step
# (the loss falls 4.69 -> 3.93), the largest relative gap of the per-step
# losses and gradient norms. Measured on four H100s: two one-card runs
# 1.11e-5 and 1.16e-4 apart (the backward is not deterministic), 4 cards
# against one 2.23e-5 and 3.02e-4; with the gradients' all-reduce skipped
# 0.014 and 0.877. The limits are about ten times the measured gaps (and
# hold mesh_bench's losses too: within 3e-5 across 1, 2 and 4 ranks).
MESH_LEARN_STEPS, MESH_LOSS_RTOL, MESH_NORM_RTOL = 8, 2e-4, 3e-3
# `entry()`: the default decoder's logits (std about 0.45, largest 2.1,
# under seed 0's weights), card bf16 against CPU f32, within LOGIT_ATOL and
# LOGIT_RTOL. Measured on an H100: 0.0234 (inside
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
        f"(expected {expected}); "
        + bar_stats([b for s in outs for b in s], engine.bar_eos_id, engine.max_bar_token_limit))
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
    """Seed, condition and S = 1 chunks of the shipped decoder: card (kernel)
    vs CPU (plain version), same inputs, within SHIPPED_LOGIT_ATOL."""
    import copy

    card = chunk_logits(model, config, bars, attr, "cuda")
    host = chunk_logits(copy.deepcopy(model).cpu(), config, bars, attr, "cpu")
    worst = 0.0
    for a, b in zip(card, host):
        if not bool(a.isfinite().all()):
            raise RuntimeError("non-finite logits on the card")
        excess = logit_excess(a, b, SHIPPED_LOGIT_ATOL)
        worst = max(worst, (a - b).abs().max().item())
        if excess > 0:
            raise RuntimeError(f"card vs CPU logits differ by {worst:.3g} "
                               f"(atol {SHIPPED_LOGIT_ATOL}, rtol {LOGIT_RTOL})")
    say(f"  card vs CPU chunk logits: max|diff| {worst:.3g} over {len(card)} chunks "
        f"(atol {SHIPPED_LOGIT_ATOL}, rtol {LOGIT_RTOL})")


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
    """Drive the port's Structuralize entry point on the card from the
    shipped separator and beat model (the default paths) on the 240 s song,
    twice (the first run includes cuDNN's and the allocator's first-use
    costs), then once under the profiler; returns the warm run's K2
    launches."""
    import torch
    from etude_tpu_torch.config import load_config
    from etude_tpu_torch.infer import InferencePipeline
    from etude_tpu_torch.ops.dilated_attention import dilated_attention

    config = load_config(None, {"paths": {"infer_output_dir": str(root / "outputs" / "infer")}})
    pipeline = InferencePipeline(config, device="cuda")
    pipeline._require_weights("structuralize")
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


def stage2_parity(root: Path, wav: Path):
    """The card against the port's CPU f32 path on the song's first
    CLIP_SECONDS (`wav`), with the shipped separator and beat model, each
    check beside a control that it must catch:

    - separation features: the card's separator at f32 (TF32 is off) against
      the CPU's, within SEP_DB_ATOL; the control scales the first conv's
      weights by 1.01. The card's production bf16 features are reported, not
      held;
    - beat activations: the card's bf16 forward (the production path, K2 in
      every layer) against the CPU's f32 one on the CPU's features, within
      SHIPPED_ACT_ATOL; the controls zero one layer's K2 output at a time;
    - tempo.json: the card's production path (bf16 features, bf16 beat
      model, the DBN and the tempo analysis) against the CPU's f32 path:
      the same regions and time signatures, downbeats within
      TEMPO_DOWNBEAT_ATOL and tempi within TEMPO_BPM_RTOL."""
    import numpy as np
    import torch
    import etude_tpu_torch.models.beat_transformer as beat_transformer
    from etude_tpu_torch.config import BeatDetectorConfig, PathConfig
    from etude_tpu_torch.data.beat_analyzer import BeatAnalyzer
    from etude_tpu_torch.data.beat_detector import BeatDetector
    from etude_tpu_torch.data.separation import SourceSeparator

    paths = PathConfig()
    feats_cpu = SourceSeparator(model_path=paths.separator_model, device="cpu"
                                ).separate_features(wav)
    card = SourceSeparator(model_path=paths.separator_model, device="cuda")
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

    act = {device: BeatDetector(BeatDetectorConfig(), model_path=paths.beat_detector_model,
                                device=device)
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
        f"max|diff| {err:.3g} (atol {SHIPPED_ACT_ATOL}); controls, one layer's K2 output "
        f"zeroed: {' '.join(f'{c:.3g}' for c in controls)}")
    if err > SHIPPED_ACT_ATOL:
        raise RuntimeError(f"card vs CPU beat activations differ by {err:.3g} > "
                           f"{SHIPPED_ACT_ATOL}")
    if min(controls) <= SHIPPED_ACT_ATOL:
        raise RuntimeError(f"the activation check missed a control ({min(controls):.3g})")

    production = act["cuda"].activations(feats_bf16)
    tempos = {}
    for device, activations in (("cpu", ref), ("cuda", production)):
        detector = act[device]
        detector.activations = lambda features, a=activations: a
        try:
            detector.detect(feats_cpu, root / f"beat_{device}.json")
        finally:
            del detector.activations
        tempos[device] = BeatAnalyzer().analyze(root / f"beat_{device}.json")
        check_tempo(tempos[device], CLIP_SECONDS)
    cpu, got = tempos["cpu"], tempos["cuda"]
    same = (len(cpu) == len(got)
            and all(a["time_sig"] == b["time_sig"] and len(a["downbeats"]) == len(b["downbeats"])
                    for a, b in zip(cpu, got)))
    gaps = ([abs(x - y) for a, b in zip(cpu, got) for x, y in zip(a["downbeats"], b["downbeats"])]
            if same else [float("inf")])
    bpm_gap = max((abs(a["bpm"] - b["bpm"]) / b["bpm"] for a, b in zip(cpu, got)), default=0.0)
    say(f"  tempo.json on the {CLIP_SECONDS:.0f} s clip, card production path vs CPU f32: "
        f"{len(got)} vs {len(cpu)} region(s), "
        f"{sum(len(r['downbeats']) for r in got)} vs {sum(len(r['downbeats']) for r in cpu)} "
        f"downbeats, largest downbeat gap {max(gaps, default=0.0):.4f} s "
        f"(limit {TEMPO_DOWNBEAT_ATOL:.4f}), tempo gap {bpm_gap:.2e} (limit {TEMPO_BPM_RTOL})")
    if not cpu:
        raise RuntimeError("the CPU path found no tempo region on the clip")
    if not same or max(gaps) > TEMPO_DOWNBEAT_ATOL or bpm_gap > TEMPO_BPM_RTOL:
        raise RuntimeError(f"card vs CPU tempo.json differ: {got!r:.300} vs {cpu!r:.300}")


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
    """Drive the port's Extract entry point on the card from the shipped
    extractor (the default path) on the 240 s song, cold and warm, then once
    under the profiler."""
    import torch
    from etude_tpu_torch.config import ExtractorConfig, PathConfig
    from etude_tpu_torch.data.extractor import AMTAPC_Extractor
    from etude_tpu_torch.utils.profiling import StageTimer

    extractor = AMTAPC_Extractor(ExtractorConfig(), model_path=PathConfig().extractor_model,
                                 device="cuda")
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


def extract_parity(root: Path, wav: Path, model_path: Path, atol: float,
                   notes: Optional[Path] = None) -> None:
    """The card's bf16 hFT heads against the port's CPU f32 path on the first
    segment of `wav`, same weights (`model_path`), within `atol`, beside
    controls it must
    catch: one attention layer's output zeroed at a time on the card. The
    card's f32 log-mel (TF32 off) against the CPU's is reported. With
    `notes` (the song's first NOTES_CLIP_SECONDS), its extract.json too: the
    card's notes against the CPU's (in groups of NOTES_CPU_GROUP segments),
    matched one to one by pitch with onsets within NOTE_ONSET_ATOL, their F1
    at least NOTE_PARITY_F1."""
    import numpy as np
    import torch
    import etude_tpu_torch.models.amt as amt
    from etude_tpu_torch.config import ExtractorConfig
    from etude_tpu_torch.data.extractor import AMTAPC_Extractor
    from etude_tpu_torch.evaluation.metrics.onset_f1 import onset_f1

    make = {device: AMTAPC_Extractor(ExtractorConfig(), model_path=model_path, device=device,
                                     segment_batch=NOTES_CPU_GROUP if device == "cpu" else None)
            for device in ("cpu", "cuda")}
    if notes is not None:
        found = {}
        for device, x in make.items():
            t = time.perf_counter()
            found[device] = x.extract(notes, root / f"extract_{device}.json")
            check_notes(found[device], NOTES_CLIP_SECONDS)
            say(f"  extract.json of the song's first {NOTES_CLIP_SECONDS:.0f} s on the {device}: "
                f"{len(found[device])} notes in {time.perf_counter() - t:.2f} s")
        match = onset_f1(found["cpu"], found["cuda"], tolerance=NOTE_ONSET_ATOL)
        say(f"  card bf16 vs CPU f32 notes: F1 {match['f1']:.4f} ({match['n_match']} matched, "
            f"pitch exact, onsets within {NOTE_ONSET_ATOL} s; limit {NOTE_PARITY_F1})")
        if not found["cpu"] or match["f1"] < NOTE_PARITY_F1:
            raise RuntimeError(f"card vs CPU notes: F1 {match['f1']:.4f} < {NOTE_PARITY_F1}")
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
        f"{err:.3g} (atol {atol}); controls, one attention layer's output zeroed: "
        + " ".join(f"{n} {v:.3g}" for n, v in controls.items()))
    if err > atol:
        raise RuntimeError(f"card vs CPU hFT heads differ by {err:.3g} > {atol}")
    if min(controls.values()) <= atol:
        raise RuntimeError(f"the hFT check missed a control ({min(controls.values()):.3g})")


def serve_settings(root: Path, cap: Optional[int] = None) -> Path:
    """A settings file that points the CLI at `root` and keeps the default
    model paths (the shipped exports in checkpoints_torch/); `cap` caps bars
    at that many tokens (the default is 512)."""
    settings = root / "settings.json"
    root.mkdir(parents=True, exist_ok=True)
    body = {"paths": {"infer_output_dir": str(root / "outputs" / "infer")}}
    if cap is not None:
        body["decoder"] = {"max_bar_token_limit": cap}
    settings.write_text(json.dumps(body))
    return settings


def write_song(path: Path, seconds: float):
    """The song: `grid_song` (tools/synthetic_corpus.py) from seed 0 with an
    eighth of SHIPPED_EIGHTH s (4/4, the first downbeat at LEAD_SECONDS),
    240 s of it drawn and the notes that start in the first `seconds`
    rendered by the additive piano synth at 44.1 kHz over `seconds` and
    written as 16-bit PCM (the corpus render's chain up to its resample);
    returns those notes."""
    import numpy as np
    from etude_tpu_torch.data.synthetic import render_piano
    from etude_tpu_torch.tools.synthetic_corpus import grid_song
    from etude_tpu_torch.utils.audio import save_wav

    notes = [n for n in grid_song(np.random.default_rng(0), SHIPPED_EIGHTH, SONG_SECONDS)
             if n["onset"] < seconds]
    save_wav(path, render_piano(notes, seconds, sr=ORIGIN_SR), ORIGIN_SR)
    return notes


def song_grid(seconds: float):
    """The rendered song's beats and downbeats in seconds."""
    import numpy as np
    from etude_tpu_torch.tools.synthetic_corpus import LEAD_SECONDS

    beats = np.arange(LEAD_SECONDS, seconds - 1.0, 2 * SHIPPED_EIGHTH)
    return beats, beats[::4]


def shipped_weights(paths) -> None:
    """The exports the default paths name (`paths`, a PathConfig): each
    params.npz's sha256 and size against the manifest beside them."""
    import hashlib

    manifest = json.loads((paths.decoder_model.parent / "manifest.json").read_text())
    for model, entry in manifest["models"].items():
        path = getattr(paths, f"{model}_model") / "params.npz"
        digest = hashlib.sha256(path.read_bytes()).hexdigest()
        say(f"  {path}: {path.stat().st_size} bytes, sha256 {digest} "
            f"({entry['parameters']} parameters in {entry['leaves']} leaves, from "
            f"{entry['source']})")
        if digest != entry["sha256"] or path.stat().st_size != entry["bytes"]:
            raise RuntimeError(f"{path} does not match the manifest ({entry['sha256']})")


def resample_timing(wav: Path) -> None:
    """The native FIR against scipy's resample_poly on the song, at the two
    rates the pipeline resamples to (best of three each)."""
    import numpy as np
    from scipy.signal import resample_poly
    from etude_tpu_torch.utils.audio import load_wav, resample_audio

    wave, sr = load_wav(wav)
    for target in (16000, 22050):
        g = np.gcd(sr, target)
        runs = {"native": lambda: resample_audio(wave, sr, target),
                "scipy": lambda: resample_poly(wave, target // g, sr // g).astype(np.float32)}
        ms, out = {}, {}
        for name, run in runs.items():
            times = []
            for _ in range(3):
                t = time.perf_counter()
                out[name] = run()
                times.append(1e3 * (time.perf_counter() - t))
            ms[name] = min(times)
        gap = float(np.abs(out["native"] - out["scipy"]).max())
        say(f"  resample {sr} -> {target} Hz of {len(wave) / sr:.0f} s: native FIR "
            f"{ms['native']:.1f} ms, scipy resample_poly {ms['scipy']:.1f} ms, max|diff| {gap:.3g}")
        if out["native"].shape != out["scipy"].shape or gap > 1e-5:
            raise RuntimeError(f"the native resampler is {gap:.3g} from scipy's")


@contextlib.contextmanager
def recorded_bars(seen: dict):
    """Keep the bars the streaming engine's `generate` returns in `seen`."""
    from etude_tpu_torch.models.generate_stream import StreamingGenerationEngine

    generate = StreamingGenerationEngine.generate

    def spy(self, *args, **kw):
        out = generate(self, *args, **kw)
        seen.update(bars=out, cap=self.max_bar_token_limit, eos=self.bar_eos_id)
        return out

    StreamingGenerationEngine.generate = spy
    try:
        yield seen
    finally:
        StreamingGenerationEngine.generate = generate


def bar_stats(bars, eos: int, cap: int) -> str:
    """Tokens per bar (mean, max) and the share of bars ended by Bar_EOS."""
    import numpy as np

    lengths = np.array([len(b) - 1 for b in bars])
    ended = sum(1 for b in bars if b[-1] == eos)
    return (f"{len(bars)} bars, tokens per bar mean {lengths.mean():.1f} max {lengths.max()} "
            f"(cap {cap}), {ended / len(bars):.3f} ended by Bar_EOS, "
            f"{int((lengths >= cap).sum())} at the cap")


def ytdlp_stub(directory: Path, sources: dict) -> Path:
    """YTDLP_STUB written as `directory`/yt-dlp, with `sources` ({URL: the
    file to copy, or None to write nothing}) beside it; returns its call
    log, emptied."""
    directory.mkdir(parents=True, exist_ok=True)
    stub = directory / "yt-dlp"
    stub.write_text(YTDLP_STUB.replace("{python}", sys.executable), encoding="utf-8")
    stub.chmod(0o755)
    (directory / "sources.json").write_text(json.dumps(
        {url: None if path is None else str(path) for url, path in sources.items()}))
    log = directory / "calls.jsonl"
    log.unlink(missing_ok=True)
    return log


def stub_calls(log: Path) -> list:
    """The argv of every call of the stub, in order."""
    return [json.loads(line) for line in log.read_text().splitlines()] if log.exists() else []


def ytdlp_argv(stub: Path, output: Path, url: str) -> list:
    """The argv that `download_audio_from_url(url, output)` runs yt-dlp with."""
    return [str(stub)] + [a.format(stem=Path(output).with_suffix(""), url=url)
                          for a in YTDLP_ARGV]


@contextlib.contextmanager
def search_path(directory: Path, keep: bool = True):
    """`directory` first on PATH (with `keep` False, alone on it)."""
    old = os.environ.get("PATH", "")
    os.environ["PATH"] = str(directory) + (os.pathsep + old if keep else "")
    try:
        yield
    finally:
        os.environ["PATH"] = old


def serve_input(settings: Path, source: str):
    """`infer --input source --output_name pipeline --seed 7` in-process;
    returns (exit code, wall s, K1 launches, K2 launches, spans, the decoded
    bars as `recorded_bars` keeps them)."""
    import torch
    from etude_tpu_torch import infer
    from etude_tpu_torch.ops.decode_attention import decode_attention
    from etude_tpu_torch.ops.dilated_attention import dilated_attention
    from etude_tpu_torch.utils.profiling import StageTimer

    spans, seen = {}, {}
    print_summary = StageTimer.print_summary
    StageTimer.print_summary = lambda self, title="": spans.update(self.summary())
    decode_attention.launches = dilated_attention.launches = 0
    torch.cuda.synchronize()
    t = time.perf_counter()
    try:
        with recorded_bars(seen):
            rc = infer.main(["--config", str(settings), "--input", source,
                             "--output_name", "pipeline", "--seed", "7"])
    finally:
        StageTimer.print_summary = print_summary
    torch.cuda.synchronize()
    return (rc, time.perf_counter() - t, decode_attention.launches,
            dilated_attention.launches, spans, seen)


def check_served(out: Path, rc: int, k1: int, k2: int, seen: dict, truth) -> None:
    """What an `--input` run of the song is held to (`out` its
    infer_output_dir): exit 0, five well-formed outputs, the notes' onset F1
    against the rendered `truth` and the share of bars ended by Bar_EOS at
    least SHIPPED_MIN_F1 and SHIPPED_MIN_EOS, 9 K2 launches and K1 launches
    a multiple of 8; prints what it read."""
    import numpy as np
    from etude_tpu_torch.data.synthetic import beat_f_measure
    from etude_tpu_torch.evaluation.metrics.onset_f1 import onset_f1
    from etude_tpu_torch.utils.midi import read_midi_notes

    work, midi = out / "temp", out / "pipeline.mid"
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
    f1 = onset_f1(truth, notes)
    say(f"  {midi.name}: {midi.stat().st_size} bytes, {len(played)} notes; launches K1 {k1}, "
        f"K2 {k2} (expected 9)")
    say(f"  extract.json: {len(notes)} notes; onset F1 against the {len(truth)} rendered "
        f"notes (50 ms, pitch exact) {f1['f1']:.4f} (precision {f1['precision']:.4f}, "
        f"recall {f1['recall']:.4f})")
    ref_beats, ref_downbeats = song_grid(SONG_SECONDS)
    downbeats = [d for r in tempo for d in r["downbeats"]]
    say(f"  beat_pred.json: {len(beats['beat_pred'])} beats (F {beat_f_measure(np.asarray(beats['beat_pred']), ref_beats):.4f} "
        f"against the rendered {len(ref_beats)}), {len(beats['downbeat_pred'])} downbeats "
        f"(F {beat_f_measure(np.asarray(beats['downbeat_pred']), ref_downbeats):.4f}); "
        f"tempo.json: {len(tempo)} region(s), {len(downbeats)} bars, "
        + ", ".join(f"{r['time_sig']}/4 at {r['bpm']:.2f} BPM from {r['start']:.2f} s"
                    for r in tempo)
        + f" (rendered: 4/4 at {30.0 / SHIPPED_EIGHTH:.2f} BPM)")
    say(f"  decode: {bar_stats(seen['bars'], seen['eos'], seen['cap'])}")
    ended = sum(1 for b in seen["bars"] if b[-1] == seen["eos"]) / max(len(seen["bars"]), 1)
    if f1["f1"] < SHIPPED_MIN_F1 or ended < SHIPPED_MIN_EOS:
        raise RuntimeError(f"the shipped weights gave an onset F1 of {f1['f1']:.3f} and "
                           f"{ended:.3f} of bars ended by Bar_EOS")
    if k2 != 9:
        raise RuntimeError(f"dilated_attention launched {k2} times, expected 9")
    if k1 == 0 or k1 % 8:
        raise RuntimeError(f"decode_attention launched {k1} times, not 8 per S=1 chunk")


def pipeline(root: Path, wav: Path, truth):
    """`python -m etude_tpu_torch.infer --input` in-process on the song from
    the default model paths (the shipped exports), without
    --allow-random-weights, at the default 512-token bar cap; `truth` is the
    rendered notes. Returns the work dir and the run's K1 and K2 launches."""
    from etude_tpu_torch.config import PathConfig

    shipped_weights(PathConfig())
    resample_timing(wav)
    rc, wall, k1, k2, spans, seen = serve_input(serve_settings(root), str(wav))
    say(f"  --input {wav.name} from the shipped exports (no random-weight flag): wall "
        f"{wall:.3f} s")
    check_served(root / "outputs" / "infer", rc, k1, k2, seen, truth)
    for name, seconds in spans.items():
        say(f"    {name:<26s} {1e3 * seconds:10.2f} ms")
    return root / "outputs" / "infer" / "temp", k1, k2


# What a URL run must give as the file run gave it (the work dir's files and
# the MIDI); the volume map and beat_pred.json are compared too.
SERVED_FILES = ("temp/extract.json", "temp/tempo.json", "pipeline.mid",
                "temp/beat_pred.json", "temp/volume.json")


def served_files(out: Path) -> dict:
    return {name: (out / name).read_bytes() for name in SERVED_FILES}


def url_input(root: Path, wav: Path, file_out: Path, truth):
    """`infer --input SONG_URL` in-process through YTDLP_STUB (which copies
    the song) with the file run's settings and seed (`file_out` its
    infer_output_dir): the stub ran once with the JAX package's argv, the
    work dir's origin.wav is the song bit for bit, the run passes the file
    run's checks and its SERVED_FILES equal the file run's bit for bit (a
    run of the song on one card repeats itself bit for bit on an H100).
    Control: with no yt-dlp on PATH the same call exits 1 and writes no
    MIDI. Returns the URL run's K1 and K2 launches."""
    from etude_tpu_torch import infer

    log = ytdlp_stub(root / "bin", {SONG_URL: wav})
    out = root / "url" / "outputs" / "infer"
    with search_path(log.parent):
        rc, wall, k1, k2, _, seen = serve_input(serve_settings(root / "url"), SONG_URL)
    calls = stub_calls(log)
    say(f"  --input {SONG_URL} through the yt-dlp stand-in: wall {wall:.3f} s, "
        f"{len(calls)} call(s) of the stub: {calls}")
    want = [ytdlp_argv(log.parent / "yt-dlp", out / "temp" / "origin.wav", SONG_URL)]
    if calls != want:
        raise RuntimeError(f"yt-dlp ran with {calls}, expected {want}")
    if (out / "temp" / "origin.wav").read_bytes() != wav.read_bytes():
        raise RuntimeError("the URL run's origin.wav is not the song")
    check_served(out, rc, k1, k2, seen, truth)
    first, got = served_files(file_out), served_files(out)
    differ = [n for n in SERVED_FILES if got[n] != first[n]]
    say(f"  URL run against the file run: origin.wav equal; differ in {differ or 'nothing'} "
        f"of {list(SERVED_FILES)}")
    if differ:
        raise RuntimeError(f"the URL run differs from the file run in {differ}")

    control = root / "control"
    (root / "empty").mkdir()
    t = time.perf_counter()
    with search_path(root / "empty", keep=False):
        try:
            code = infer.main(["--config", str(serve_settings(control)), "--input", SONG_URL,
                               "--output_name", "pipeline", "--seed", "7"])
        except SystemExit as exc:
            code = exc.code
    written = sorted(str(p.relative_to(control)) for p in control.rglob("*.mid"))
    say(f"  control, no yt-dlp on PATH: exit {code} in {time.perf_counter() - t:.3f} s, "
        f"MIDI written {written}, stub calls {len(stub_calls(log)) - len(calls)}")
    if code != 1 or written or len(stub_calls(log)) != len(calls):
        raise RuntimeError("without yt-dlp the URL run did not exit 1 before writing a MIDI")
    return k1, k2


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


# The id of the prepare phase's third song, which the yt-dlp stand-in fails
# on (in both columns), so stage 1 warns of it and stages 2-5 leave it out.
PREP_BAD_ID = "unavailable"


@contextlib.contextmanager
def recorded_warnings(seen: list):
    """Keep the port's logger's warnings in `seen` (still printed)."""
    from etude_tpu_torch.utils.logger import logger

    warn = logger.warn
    logger.warn = lambda msg: (seen.append(msg), warn(msg))
    try:
        yield seen
    finally:
        del logger.warn


def check_downloads(root: Path, log: Path, rows, sources: dict, warnings) -> None:
    """Stage 1 of the prepare phase: the stub ran once per id, in the CSV's
    order, with the JAX package's argv; raw/NNNN/{cover,origin}.wav are the
    renders bit for bit; the third song's dir is empty and the warning names
    it alone."""
    from etude_tpu_torch import prepare

    want = [ytdlp_argv(log.parent / "yt-dlp", root / "raw" / f"{k + 1:04d}" / name,
                       prepare.YOUTUBE_URL + row[j])
            for k, row in enumerate(rows) for j, (_, name) in enumerate(prepare.DOWNLOADS)]
    calls = stub_calls(log)
    failed = [w for w in warnings if "downloads failed" in w]
    say(f"  stage 1: {len(calls)} calls of the stub ({sum(c == w for c, w in zip(calls, want))} "
        f"with the expected argv), warnings {failed}")
    if calls != want:
        raise RuntimeError(f"yt-dlp ran with {calls}, expected {want}")
    if failed != [f"1 downloads failed: {len(rows):04d}"]:
        raise RuntimeError(f"stage 1 warned {failed}, expected song {len(rows):04d} alone")
    for k, row in enumerate(rows[:-1]):
        for j, (_, name) in enumerate(prepare.DOWNLOADS):
            got = root / "raw" / f"{k + 1:04d}" / name
            if got.read_bytes() != sources[prepare.YOUTUBE_URL + row[j]].read_bytes():
                raise RuntimeError(f"{got} is not the render it was fetched from")
    if list((root / "raw" / f"{len(rows):04d}").iterdir()):
        raise RuntimeError(f"song {len(rows):04d} failed but its raw dir is not empty")


def prepare_settings(root: Path) -> Path:
    """The dataset CSV and the corpus dirs under `root`, every model path
    missing (random weights from seed 0) and PREP_THRESHOLDS."""
    settings = root / "prepare.json"
    settings.write_text(json.dumps({
        "paths": {"dataset_csv": str(root / "dataset.csv"), "raw_dir": str(root / "raw"),
                  "processed_dir": str(root / "processed"), "aligned_dir": str(root / "aligned"),
                  "tokenized_dir": str(root / "tokenized"),
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
    """`python -m etude_tpu_torch.prepare` in-process from its default
    `--start-from download` on a synthesized two-song corpus at 240 s, at
    full width under random weights (PREP_THRESHOLDS), with the spans of
    every stage and song (song 0001 is cold, 0002 warm: stage 2 makes its
    models once). Stage 1 reads a CSV of the two songs' ids and a third
    song's (PREP_BAD_ID in both columns) and fetches each through
    YTDLP_STUB, which copies the renders and fails on PREP_BAD_ID: the
    stub's calls, the warning's failed list and the raw/ tree are checked.
    Then the wavefront and the hFT timed alone and the card-against-CPU
    checks. Returns the run's K2 launches."""
    import torch
    from etude_tpu_torch import prepare
    from etude_tpu_torch.ops.dilated_attention import dilated_attention
    from etude_tpu_torch.utils.audio import decode_audio, save_wav
    from etude_tpu_torch.utils.profiling import StageTimer

    t = time.perf_counter()
    sources, rows = {}, []
    for seed, transpose, offset in PREP_SONGS:
        origin, cover = render_pair(seed, SONG_SECONDS, transpose, offset)
        ids = (f"cover{seed}", f"origin{seed}")
        save_wav(root / "sources" / f"{ids[0]}.wav", cover, ALIGN_SR)
        save_wav(root / "sources" / f"{ids[1]}.wav", origin, ORIGIN_SR)
        sources.update({prepare.YOUTUBE_URL + i: root / "sources" / f"{i}.wav" for i in ids})
        rows.append(ids)
    rows.append((PREP_BAD_ID, PREP_BAD_ID))
    (root / "dataset.csv").write_text(
        "piano_ids,pop_ids\n" + "".join(f"{a},{b}\n" for a, b in rows))
    log = ytdlp_stub(root / "bin", sources)
    say(f"  corpus: {len(PREP_SONGS)} songs, {SONG_SECONDS:.0f} s origin.wav at {ORIGIN_SR} Hz, "
        f"cover.wav transposed {[s[1] for s in PREP_SONGS]} and warped ±{WARP_SECONDS} s at "
        f"{ALIGN_SR} Hz, and {PREP_BAD_ID!r}, which the stub fails on, in dataset.csv "
        f"(set-up {time.perf_counter() - t:.2f} s); settings {PREP_THRESHOLDS}")
    settings = prepare_settings(root)
    timer = StageTimer(torch.device("cuda"))
    warnings = []
    dilated_attention.launches = 0
    torch.cuda.synchronize()
    t = time.perf_counter()
    with search_path(log.parent), recorded_warnings(warnings):
        rc = prepare.main(["--config", str(settings), "--allow-random-weights"], timer=timer)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    launches = dilated_attention.launches
    say(f"  prepare (from --start-from download): rc {rc}, wall {wall:.3f} s, K2 launches "
        f"{launches} (expected {9 * len(PREP_SONGS)})")
    for span in timer.spans:
        say(f"    {span['name']:<40s} {1e3 * span['seconds']:10.2f} ms")
    if rc != 0:
        raise RuntimeError(f"prepare exited {rc}")
    check_downloads(root, log, rows, sources, warnings)
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
    first `seconds`, its extract.json's notes that start before then and its
    volume.json; its settings keep the default model paths (the shipped
    exports) and cap bars at 32 tokens."""
    work = root / "outputs" / "infer" / "temp"
    work.mkdir(parents=True)
    tempo = []
    for region in json.loads((src / "tempo.json").read_text()):
        downbeats = [d for d in region["downbeats"] if d < seconds]
        if downbeats:
            tempo.append(dict(region, downbeats=downbeats))
    (work / "tempo.json").write_text(json.dumps(tempo))
    notes = [n for n in json.loads((src / "extract.json").read_text()) if n["onset"] < seconds]
    (work / "extract.json").write_text(json.dumps(notes))
    (work / "volume.json").write_bytes((src / "volume.json").read_bytes())
    return serve_settings(root, 32)


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
    """The CLI at full width on the whole corpus: TRAIN_STEPS steps, `latest`
    every TRAIN_SAVE_EVERY, with --strict-sync."""
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
    main run's: TRAIN_STEPS steps, its rate still below 2.2e-6 in its warmup; the
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
    say(f"  K2b B={B:2d} T={T:5d} dil={dilation:3d}{' head7_bug' if head7_bug else ''}: "
        f"max|err| dq {errs[0]:.3g} dk {errs[1]:.3g} dv {errs[2]:.3g} der {errs[3]:.3g} "
        f"(tol {', '.join(f'{t:.3g}' for t in tols)}); control at dilation {other}: "
        f"{', '.join(f'{c:.3g}' for c in control)}; kernel {row['ms']:.4f} ms, plain "
        f"{row['plain_ms']:.4f} ms, bound {bound_ms:.4f} ms ({n_bytes / 1e6:.1f} MB, "
        f"{bound_by})")
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
    published widths: AUX_CLI_STEPS[mode] steps, 2 held-out clips. Returns
    the run, its warm median step and its K2 and K2b launches."""
    import math

    import torch
    from etude_tpu_torch import train_aux
    from etude_tpu_torch.ops.dilated_attention import (
        dilated_attention, dilated_attention_backward,
    )

    torch.cuda.reset_peak_memory_stats()
    dilated_attention.launches = dilated_attention_backward.launches = 0
    t = time.perf_counter()
    steps = AUX_CLI_STEPS[mode]
    run, = train_aux.run([mode, "--steps", str(steps), "--eval-clips", str(AUX_EVAL_CLIPS),
                          "--output-dir", str(out)])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    k2, k2b = dilated_attention.launches, dilated_attention_backward.launches
    warm, waits = run.step_seconds[1:], run.wait_seconds[1:]
    median = statistics.median(warm)
    meta = json.loads((out / train_aux.EXPORT_NAMES[mode] / "metadata.json").read_text())
    held_out = {k: v for k, v in meta.items() if k.endswith(("f_measure", "f1", "sdr_db"))}
    say(f"  {mode}: {steps} steps in {wall:.2f} s (build, steps, evaluation, export); "
        f"warm step median {1e3 * median:.2f} ms (min {1e3 * min(warm):.2f}, max "
        f"{1e3 * max(warm):.2f}; CUDA events between steps); the host's batch wait "
        f"{sum(waits) / sum(warm):.3f} of the warm steps' time (median wait "
        f"{1e3 * statistics.median(waits):.2f} ms); peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; loss {run.losses[0]:.4f} -> "
        f"{run.losses[-1]:.4f}; held-out {held_out}; K2 launches {k2}, K2b {k2b}")
    if len(run.losses) != steps or not all(math.isfinite(x) for x in run.losses):
        raise RuntimeError(f"{mode}: {len(run.losses)} steps, losses {run.losses}")
    if not held_out or not all(math.isfinite(v) for v in held_out.values()):
        raise RuntimeError(f"{mode}: held-out evaluation {held_out}")
    # K2b: one kernel launch per call, one call per layer and step.
    expect = ((9 * (steps + AUX_EVAL_CLIPS), 9 * steps) if mode == "beat"
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
    the profiler: device time per step against the CLI's warm median.
    Returns the device time per step in ms, or None when the profiler saw
    no device time."""
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
    if busy is None:
        return None
    say(f"  {mode}: device time per step {busy / 3:.2f} ms -> device idle share of the "
        f"CLI's warm step {1 - busy / 3 / (1e3 * median_s):.3f}")
    return busy / 3


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


def backward_kernel_rows(flush) -> list:
    """K2b against its plain version (K2's forward at the training shape
    first: the backward rests on it); returns the K2b rows."""
    for i in range(9):
        check_dilated(40, 512, 2 ** i, 300 + i, flush)
    rows = [check_dilated_backward(40, 512, 2 ** i, 400 + i, flush) for i in range(9)]
    rows += [check_dilated_backward(40, 512, dil, 500 + dil, flush, head7_bug=True)
             for dil in (1, 8, 256)]
    rows += [check_dilated_backward(5, 12288, dil, 600 + dil, flush) for dil in (1, 16, 256)]
    train = [r for r in rows if r["T"] == 512 and not r["head7_bug"]]
    say(f"  K2b, one beat training step at B=40 T=512 (9 calls, 9 launches): kernel "
        f"{sum(r['ms'] for r in train):.4f} ms, plain {sum(r['plain_ms'] for r in train):.4f} ms, "
        f"bound {sum(r['bound_ms'] for r in train):.4f} ms")
    return rows


def aux_train_phase(root: Path):
    """The aux_train phase; returns (K2 launches, K2b launches, the exports'
    directory, each mode's device ms per warm step)."""
    import torch

    exports = root / "exports"
    k2 = k2b = 0
    device_ms = {}
    for mode in ("beat", "amt", "separator"):
        run, median, a, b = aux_cli_run(exports, mode)
        k2, k2b = k2 + a, k2b + b
        device_ms[mode] = aux_profile(mode, median)
        torch.cuda.empty_cache()
    for mode in ("beat", "amt", "separator"):
        aux_learning(mode)
        aux_parity(mode)
        torch.cuda.empty_cache()
    k2 += aux_serve(root / "serve", exports)
    return k2, k2b, exports, device_ms


# ---------------------------------------------------------------- corpus
class _ForwardCounter:
    """Counts Beat-Transformer forwards (every instance) while active."""

    def __init__(self):
        from etude_tpu_torch.models.beat_transformer import BeatTransformer

        self.cls, self.forward, self.n = BeatTransformer, BeatTransformer.forward, 0

    def __enter__(self):
        counter = self

        def forward(model, *args, **kw):
            counter.n += 1
            return counter.forward(model, *args, **kw)

        self.cls.forward = forward
        return self

    def __exit__(self, *exc):
        self.cls.forward = self.forward


def corpus_stage(walls, name, run, beat_steps=0):
    """Run one stage of the corpus phase with K2, K2b and the forwards
    counted from 0: K2 must launch 9 times per Beat-Transformer forward and
    K2b 9 times per beat training step. Returns (its result, K2, K2b)."""
    import torch
    from etude_tpu_torch.ops.dilated_attention import (
        dilated_attention, dilated_attention_backward,
    )

    dilated_attention.launches = dilated_attention_backward.launches = 0
    t = time.perf_counter()
    with _ForwardCounter() as forwards:
        out = run()
    torch.cuda.synchronize()
    walls[name] = time.perf_counter() - t
    k2, k2b = dilated_attention.launches, dilated_attention_backward.launches
    say(f"  [{name}] {walls[name]:.2f} s; Beat-Transformer forwards {forwards.n}, K2 "
        f"launches {k2}, K2b {k2b} (beat training steps {beat_steps})")
    if (k2, k2b) != (9 * forwards.n, 9 * beat_steps):
        raise RuntimeError(f"{name}: K2/K2b launched {k2}/{k2b} times for {forwards.n} "
                           f"forwards and {beat_steps} beat steps")
    return out, k2, k2b


def check_shards(directory: Path, layout) -> int:
    """Every shard_*.npz under `directory` holds exactly `layout`'s keys
    ({key: (trailing shape, dtype)}), finite, one row count; returns the
    rows."""
    import numpy as np

    shards = sorted(directory.glob("shard_*.npz"))
    rows = 0
    for path in shards:
        with np.load(path) as z:
            if sorted(z.files) != sorted(layout):
                raise RuntimeError(f"{path}: keys {z.files}, expected {sorted(layout)}")
            n = {z[k].shape[0] for k in layout}
            for key, (shape, dtype) in layout.items():
                a = z[key]
                if a.shape[1:] != shape or a.dtype != np.dtype(dtype):
                    raise RuntimeError(f"{path}: {key} {a.shape} {a.dtype}, expected "
                                       f"[n, {shape}] {dtype}")
                if not np.isfinite(a.astype(np.float32)).all():
                    raise RuntimeError(f"{path}: {key} is not finite")
        if len(n) != 1:
            raise RuntimeError(f"{path}: row counts {n}")
        rows += n.pop()
    if not rows:
        raise RuntimeError(f"no shard rows under {directory}")
    return rows


def check_corpus_meta(out: Path, export: str, mode: str, corpus: str) -> dict:
    """The export's metadata: the JAX keys, finite numbers, F-measures in
    [0, 1], the expected `corpus` string; the params load."""
    import math

    from etude_tpu_torch.utils.training import load_params_only

    meta = json.loads((out / export / "metadata.json").read_text())
    want = {"first_loss", "final_loss", "steps", "seconds"} | CORPUS_META[mode]
    if set(meta) != want:
        raise RuntimeError(f"{export} metadata keys {sorted(meta)}, expected {sorted(want)}")
    if meta["corpus"] != corpus or meta["steps"] != CORPUS_STEPS:
        raise RuntimeError(f"{export} metadata: corpus {meta['corpus']!r}, steps "
                           f"{meta['steps']}")

    def numbers(value):
        if isinstance(value, dict):
            return [x for v in value.values() for x in numbers(v)]
        return [value] if isinstance(value, float) else []

    for key, value in meta.items():
        for x in numbers(value):
            if not math.isfinite(x):
                raise RuntimeError(f"{export} metadata {key} = {value}")
            if key.startswith(("beat_f", "onset_f1")) and not 0.0 <= x <= 1.0:
                raise RuntimeError(f"{export} metadata {key} = {value} out of [0, 1]")
    load_params_only(out / export / "latest")
    return meta


def corpus_train(walls, out: Path, label: str, argv, export: str, corpus: str,
                 beat: bool):
    """`train_aux` in-process for CORPUS_STEPS steps: returns (its metadata,
    its warm median step in s, K2, K2b)."""
    from etude_tpu_torch import train_aux

    def run():
        return train_aux.run([*argv, "--steps", str(CORPUS_STEPS), "--eval-clips", "1",
                              "--eval-seconds", str(CORPUS_EVAL_SECONDS),
                              "--output-dir", str(out)])

    (aux_run,), k2, k2b = corpus_stage(walls, label, run, CORPUS_STEPS if beat else 0)
    warm, waits = aux_run.step_seconds[1:], aux_run.wait_seconds[1:]
    median = statistics.median(warm)
    meta = check_corpus_meta(out, export, argv[0], corpus)
    held_out = {k: v for k, v in meta.items() if k.startswith(("beat_f", "onset_f1", "stem_sdr",
                                                               "baseline_sdr"))}
    say(f"  {label}: warm step median {1e3 * median:.2f} ms (min {1e3 * min(warm):.2f}, max "
        f"{1e3 * max(warm):.2f}); the host's batch wait {sum(waits) / sum(warm):.3f} of the "
        f"warm steps' time; loss {aux_run.losses[0]:.4f} -> {aux_run.losses[-1]:.4f}; "
        f"held-out {held_out}")
    return meta, median, k2, k2b


def corpus_loss_parity(out: Path):
    """One beat-corpus batch (step 0 of the task rebuilt on the CPU from the
    run's export and feature cache) through the Beat-Transformer it trained:
    the card's bf16 loss against the CPU's f32 within aux_train's beat loss
    limit; the same batch with its labels shifted must miss it."""
    import torch
    from etude_tpu_torch import train_aux
    from etude_tpu_torch.models import beat_transformer as bt
    from etude_tpu_torch.weights import beat_transformer_from_jax, beat_transformer_to_jax

    args = train_aux.parse_args(["beat-corpus", "--corpus-limit", "2", "--device", "cpu",
                                 "--output-dir", str(out), "--eval-seconds",
                                 str(CORPUS_EVAL_SECONDS)])
    args.batch, args.lr = train_aux.DEFAULTS["beat-corpus"]
    args.output_dir = out
    cpu = train_aux.TASKS["beat-corpus"](args, torch.device("cpu"))
    host = cpu.gen(0)
    card = beat_transformer_from_jax(beat_transformer_to_jax(cpu.model), cpu.model.config,
                                     "cuda")

    def loss(model, batch, device, dtype):
        with torch.no_grad():
            value, _ = bt.loss_fn(model, device_aux_batch(batch, device), dtype)
        return float(value)

    ref = loss(cpu.model, host, "cpu", torch.float32)
    got = loss(card, host, "cuda", torch.bfloat16)
    control = loss(card, shift_labels("beat", host), "cuda", torch.bfloat16)
    limit = AUX_STEP_LIMITS["beat"]["bf16"][0]
    gap, control_gap = abs(got / ref - 1), abs(control / ref - 1)
    say(f"  beat-corpus batch loss, card bf16 {got:.6f} vs CPU f32 {ref:.6f}: relative gap "
        f"{gap:.3g} (limit {limit:g}); control, labels shifted: {control:.6f}, gap "
        f"{control_gap:.3g}")
    if gap > limit:
        raise RuntimeError(f"beat-corpus loss: card {got} vs CPU {ref}")
    if control_gap <= limit:
        raise RuntimeError("beat-corpus loss check missed its control (labels shifted)")


def corpus_phase(root: Path, exports: Path, device_ms):
    """The corpus phase, from the aux_train phase's exports and its device
    ms per warm step of each model (the corpus modes train the same models
    at the same batch shapes, so the device's work per step is the same;
    their steps differ in the host's batches); returns its (K2 launches,
    K2b launches)."""
    import io
    import shutil

    import numpy as np
    import torch
    from etude_tpu_torch.data import corpus_render, synthetic as syn
    from etude_tpu_torch.scripts import (
        eval_separator_pseudopop, gen_beat_scenes, gen_pseudopop_scenes,
        gen_pseudopop_sep_examples, validate_beat_corpus,
    )
    from etude_tpu_torch.tools.synthetic_corpus import write_corpus
    from etude_tpu_torch.utils.midi import read_midi_notes

    walls = {}
    songs = root / "songs"
    t = time.perf_counter()
    write_corpus(songs, CORPUS_SONGS, CORPUS_SECONDS, seed=0)
    walls["corpus"] = time.perf_counter() - t
    corpus_render.CORPUS_ROOT = songs
    meta = json.loads((songs / "songs.json").read_text())
    say(f"  synthetic corpus: {CORPUS_SONGS} songs, "
        + ", ".join(f"{k} {v['bpm']:.1f} bpm {v['seconds']:.1f} s" for k, v in meta.items()))
    notes = [n for n in read_midi_notes(songs / "CPOP02" / "etude_d.mid") if n["onset"] < 15.0]
    horizon = max(n["offset"] for n in notes) + 1.0
    t = time.perf_counter()
    syn.render_piano(notes, horizon, sr=44100)
    render_rate = (time.perf_counter() - t) / horizon
    say(f"  render: {render_rate:.4f} s per audio second (additive synth at 44.1 kHz, "
        f"{len(notes)} notes over {horizon:.1f} s, one thread)")

    out = root / "out"
    shutil.copytree(exports, out)
    separator = ["--separator-model", str(out / "separator" / "latest")]
    k2 = k2b = 0

    def script(name, module, argv, layout=None, shards=None):
        nonlocal k2
        rc, a, _ = corpus_stage(walls, name, lambda: module.main(argv))
        k2 += a
        if rc != 0:
            raise RuntimeError(f"{name} exited {rc}")
        if layout is not None:
            say(f"  {name}: {check_shards(shards, layout)} rows with the JAX keys and shapes")

    scene = {"x": ((5, 512, 128), "float16"), "activations": ((512, 2), "float16"),
             "tempo": ((), "int32")}
    script("gen_beat_scenes", gen_beat_scenes,
           ["--n-scenes", str(CORPUS_SCENES), "--shard-size", "2", "--out",
            str(root / "scenes"), "--corpus", str(songs), *separator], scene, root / "scenes")
    script("gen_pseudopop_scenes render", gen_pseudopop_scenes,
           ["--stage", "render", "--n-scenes", str(CORPUS_SCENES), "--out", str(root / "pp"),
            "--corpus", str(songs)])
    script("gen_pseudopop_scenes features", gen_pseudopop_scenes,
           ["--stage", "features", "--out", str(root / "pp"), *separator], scene, root / "pp")
    script("gen_pseudopop_sep_examples", gen_pseudopop_sep_examples,
           ["--n", str(CORPUS_SEP_ROWS), "--shard-size", "4", "--out", str(root / "ppsep")],
           {"mix_mag": ((256, 2049), "float16"), "stem_mags": ((5, 256, 2049), "float16")},
           root / "ppsep")

    idle = {}
    runs = (
        ("beat-corpus", ["beat-corpus", "--corpus-limit", "2"], "beat_detector",
         "rendered-corpus(serving-chain)+synthetic-scenes", "beat"),
        ("beat --scenes-dir", ["beat", "--scenes-dir", str(root / "scenes")], "beat_detector",
         "synthetic-scenes + corpus-piano-scenes", "beat"),
        ("amt-corpus", ["amt-corpus"], "extractor",
         "rendered-corpus(serving-chain)+synthetic", "amt"),
        ("separator pseudo-pop cache", ["separator", "--pseudopop-mix", "0.5",
                                        "--pseudopop-cache", str(root / "ppsep")],
         "separator", "synthetic-stems", "separator"),
        ("separator pseudo-pop", ["separator", "--pseudopop-mix", "0.5"], "separator",
         "synthetic-stems + pseudo-pop audio stems (mix 0.50)", "separator"),
    )
    for label, argv, export, corpus, model in runs:
        meta, median, a, b = corpus_train(walls, out, label, argv, export, corpus,
                                          model == "beat")
        k2, k2b = k2 + a, k2b + b
        if device_ms.get(model) is not None:
            idle[label] = 1 - device_ms[model] / (1e3 * median)
            say(f"  {label}: device idle share of the warm step {idle[label]:.3f} "
                f"({device_ms[model]:.2f} ms of device time per {model} step, aux_train's "
                f"profiled window)")
        if label == "beat-corpus":
            cache = out / "beat_corpus_cache"
            entries = sorted(cache.glob("*.npz"))
            if meta["warm_start"] != str(out / "beat_detector" / "latest") or \
                    meta["train_song_versions"] != len(entries) or len(entries) != 4:
                raise RuntimeError(f"beat-corpus: warm start {meta['warm_start']}, "
                                   f"{len(entries)} cache files")
            frames = 0
            for path in entries:
                with np.load(path) as z:
                    if sorted(z.files) != ["beat_times", "bpm", "downbeat_times", "features"] \
                            or z["features"].dtype != np.float16 \
                            or z["features"].shape[::2] != (5, 128):
                        raise RuntimeError(f"{path}: {z.files}, {z['features'].shape}")
                    frames += z["features"].shape[1]
            say(f"  feature cache: {len(entries)} files with the JAX keys, {frames} frames")
            corpus_loss_parity(out)
        if label == "amt-corpus" and meta["warm_start"] != str(out / "extractor" / "latest"):
            raise RuntimeError(f"amt-corpus warm start {meta['warm_start']}")
        torch.cuda.empty_cache()

    models = [*separator, "--beat-model", str(out / "beat_detector" / "latest")]
    buffer = io.StringIO()

    def validate():
        with contextlib.redirect_stdout(buffer):
            return validate_beat_corpus.main(["--corpus", str(songs), "--held-out-only",
                                              "--songs", "2", "--seconds",
                                              str(CORPUS_EVAL_SECONDS), *models])

    rc, a, _ = corpus_stage(walls, "validate_beat_corpus", validate)
    k2 += a
    summary = json.loads(buffer.getvalue().strip().splitlines()[-1])
    say(f"  validate_beat_corpus: {json.dumps(summary)}")
    if rc != 0 or [r["song"] for r in summary["songs"]] != ["CPOP01", "CPOP04"] \
            or a != 9 * 2:
        raise RuntimeError(f"validate_beat_corpus: rc {rc}, {summary}")
    pp_json = root / "pp_eval.json"
    rc, a, _ = corpus_stage(walls, "eval_separator_pseudopop", lambda: (
        eval_separator_pseudopop.main(["--songs", "2", "--seconds", str(CORPUS_EVAL_SECONDS),
                                       "--corpus", str(songs), "--out", str(pp_json),
                                       *models])))
    k2 += a
    pp = json.loads(pp_json.read_text())
    say(f"  eval_separator_pseudopop: mean SI-SDR {pp['mean_si_sdr']} (mix as estimate "
        f"{pp['mean_si_sdr_mix_baseline']}), beat F sep {pp['mean_beat_f_sep']} vs bypass "
        f"{pp['mean_beat_f_bypass']}")
    if rc != 0 or len(pp["songs"]) != 2 or a != 9 * 2 * 2:
        raise RuntimeError(f"eval_separator_pseudopop: rc {rc}, {len(pp['songs'])} songs")
    say("  corpus walls: " + ", ".join(f"{k} {v:.2f} s" for k, v in walls.items())
        + f"; render {render_rate:.4f} s per audio s; device idle share "
        + (", ".join(f"{k} {v:.3f}" for k, v in idle.items()) or "not measured"))
    return k2, k2b


# ---------------------------------------------------------------- decoder_corpus
def dc_stage(walls, name, run):
    """One script of the decoder_corpus phase with K1, K2 and the
    Beat-Transformer forwards counted from 0 (K2 = 9 per forward, held by
    corpus_stage); returns (its result, K1, K2)."""
    from etude_tpu_torch.ops.decode_attention import decode_attention

    decode_attention.launches = 0
    out, k2, _ = corpus_stage(walls, name, run)
    say(f"  [{name}] K1 launches {decode_attention.launches}")
    return out, decode_attention.launches, k2


def dc_printed(run):
    """`run()`'s exit code and the JSON object its last stdout line holds."""
    import io

    buffer = io.StringIO()
    with contextlib.redirect_stdout(buffer):
        rc = run()
    lines = buffer.getvalue().strip().splitlines()
    return rc, json.loads(lines[-1]) if lines else None


def dc_keys(name, got, want):
    if set(got) != set(want):
        raise RuntimeError(f"{name}: keys {sorted(got)}, the JAX script's {sorted(want)}")


def dc_midis(name, paths) -> int:
    """Every MIDI in `paths` parses; returns their notes."""
    from etude_tpu_torch.utils.midi import read_midi_notes

    paths = list(paths)
    if not paths:
        raise RuntimeError(f"{name}: no MIDI written")
    return sum(len(read_midi_notes(p)) for p in paths)


def dc_distill(root, walls, songs, exports):
    """distill_dataset: --grid rgc on the card and the CPU (bit-equal), then
    --grid tracker on the card from the exports, with the songs that picked
    the tracker; returns (its output dir, K2)."""
    import numpy as np
    from etude_tpu_torch.scripts import distill_dataset as dd
    from etude_tpu_torch.utils.midi import read_midi_notes

    base = ["--corpus", str(songs), *DC_AUGMENT]
    outs = {}
    for device in ("cuda", "cpu"):
        outs[device] = root / f"rgc_{device}"
        rc, _, _ = dc_stage(walls, f"distill_dataset rgc {device}", lambda: dd.main(
            [*base, "--grid", "rgc", "--out", str(outs[device]), "--device", device]))
        if rc != 0:
            raise RuntimeError(f"distill_dataset --grid rgc --device {device} exited {rc}")
    files = sorted(p.relative_to(outs["cuda"]) for p in outs["cuda"].rglob("*") if p.is_file())
    other = sorted(p.relative_to(outs["cpu"]) for p in outs["cpu"].rglob("*") if p.is_file())
    differ = [f for f in files if (outs["cuda"] / f).read_bytes() != (outs["cpu"] / f).read_bytes()]
    pairs = sum(f.name.endswith("_src.npy") for f in files)
    say(f"  --grid rgc {' '.join(DC_AUGMENT)}: {pairs} pairs; card vs CPU: "
        f"{len(files)} files, {len(differ)} differ")
    if files != other or differ or pairs != DC_SONGS * 3 * 3 or Path("vocab.json") not in files:
        raise RuntimeError(f"distill_dataset rgc: card vs CPU files differ: {differ}")

    tracker = root / "tracker"
    models = ["--separator-model", str(exports / "separator" / "latest"),
              "--beat-model", str(exports / "beat_detector" / "latest")]
    rc, _, k2 = dc_stage(walls, "distill_dataset tracker", lambda: dd.main(
        [*base, "--grid", "tracker", "--out", str(tracker), *models]))
    if rc != 0 or k2 != 9 * DC_SONGS:
        raise RuntimeError(f"distill_dataset --grid tracker exited {rc}, K2 {k2}")
    picked = []
    for song in sorted(p for p in songs.iterdir() if p.is_dir()):
        cached = json.loads((tracker / "tempo" / f"{song.name}.json").read_text())
        if set(cached) != {"tempo", "score"}:
            raise RuntimeError(f"{song.name}: tempo cache keys {sorted(cached)}")
        notes = read_midi_notes(song / "etude_d.mid")
        rgc = dd.estimate_tempo_grid(notes)
        score = np.inf if cached["score"] is None else cached["score"]
        if dd.arbitrate_grid(cached["tempo"], score, rgc, dd.grid_fit_score(notes, rgc))[1] \
                == "tracker":
            picked.append(song.name)
        say(f"    {song.name}: tracker regions {len(cached['tempo'])}, snap "
            f"{cached['score']} vs rgc {dd.grid_fit_score(notes, rgc):.5f}")
    pairs = sum(1 for _ in (tracker / "tokenized").glob("*/*_src.npy"))
    say(f"  --grid tracker: {len(picked)} of {DC_SONGS} songs picked the tracker "
        f"({', '.join(picked) or 'none'}); {pairs} pairs")
    return tracker, k2


def dc_tracker_parity(root, walls, songs):
    """TrackerGrid on one song from the shipped separator and beat model,
    card against the port's CPU: the tracker's refined downbeats (before
    the phase moves onto the notes) within DC_DOWNBEAT_ATOL, the same grid
    picked; control: the notes (so the audio) one activation frame later on
    the card."""
    import numpy as np
    from etude_tpu_torch.config import PathConfig
    from etude_tpu_torch.scripts import distill_dataset as dd
    from etude_tpu_torch.utils.midi import read_midi_notes

    paths = PathConfig()
    models = (paths.separator_model, paths.beat_detector_model)
    if not all((m / "params.npz").is_file() for m in models):
        raise RuntimeError(f"no export at {models}")   # TrackerGrid would run random weights
    notes = read_midi_notes(songs / DC_TRACKER_SONG / "etude_d.mid")
    later = [dict(n, onset=n["onset"] + DC_FRAME, offset=n["offset"] + DC_FRAME) for n in notes]
    grids = {}
    for device in ("cpu", "cuda"):
        t = time.perf_counter()
        grid = dd.TrackerGrid(*models, device)
        grids[device] = grid.track(notes, root / f"parity_{device}.wav")
        walls[f"TrackerGrid {device}"] = time.perf_counter() - t
        if device == "cuda":
            shifted = grid.track(later, root / "parity_later.wav")

    def gap(a, b):
        if len(a) != len(b) or any(x["time_sig"] != y["time_sig"]
                                   or len(x["downbeats"]) != len(y["downbeats"])
                                   for x, y in zip(a, b)):
            return np.inf
        return max((float(np.max(np.abs(np.subtract(x["downbeats"], y["downbeats"]))))
                    for x, y in zip(a, b)), default=0.0)

    rgc = dd.estimate_tempo_grid(notes)
    rgc_score = dd.grid_fit_score(notes, rgc)
    picks = {}
    for device, tempo in grids.items():
        final = dd.TrackerGrid._dephase(tempo, notes)
        picks[device] = dd.arbitrate_grid(final, dd.grid_fit_score(notes, final), rgc,
                                          rgc_score)[1]
    found, control = gap(grids["cuda"], grids["cpu"]), gap(shifted, grids["cpu"])
    say(f"  TrackerGrid on {DC_TRACKER_SONG}, card vs CPU: regions {len(grids['cuda'])} / "
        f"{len(grids['cpu'])}, downbeats {[len(r['downbeats']) for r in grids['cuda']]}, "
        f"largest downbeat gap {found:.4g} s (limit {DC_DOWNBEAT_ATOL:.4g}); picked "
        f"{picks['cuda']} / {picks['cpu']}; control, the audio {1e3 * DC_FRAME:.1f} ms later: "
        f"gap {control:.4g} s")
    if not grids["cpu"]:
        raise RuntimeError(f"the tracker found no region on {DC_TRACKER_SONG}")
    if found > DC_DOWNBEAT_ATOL or picks["cuda"] != picks["cpu"]:
        raise RuntimeError(f"TrackerGrid card vs CPU: gap {found}, picks {picks}")
    if control <= DC_DOWNBEAT_ATOL:
        raise RuntimeError("the tracker check missed its control (the audio a frame later)")


def dc_teacher_forced(root, walls, songs, data, run_dir, vocab):
    """eval_distilled --engine rebuild --teacher-forced-history, greedy, on
    DC_EVAL_SONGS songs on the card (timed, then profiled for the device's
    idle share) and the first on the CPU: bars equal or first differing at
    a near-tie of the CPU's logits. Returns the card run's K1."""
    import numpy as np
    import torch
    from etude_tpu_torch.models import generate
    from etude_tpu_torch.scripts import eval_distilled

    argv = ["--run", str(run_dir), "--vocab", str(vocab), "--corpus", str(songs),
            "--dataset-dir", str(data), "--engine", "rebuild", "--teacher-forced-history"]
    card, k1, _ = dc_stage(walls, "eval_distilled", lambda: eval_distilled.run(
        [*argv, "--songs", str(DC_EVAL_SONGS), "--out", str(root / "eval")]))
    if card is None:
        raise RuntimeError("eval_distilled exited 1")
    steps = card.engine_stats["single_token_steps"]
    if card.agg["songs"] != DC_EVAL_SONGS or k1 != 8 * steps or not steps:
        raise RuntimeError(f"eval_distilled: {card.agg}, K1 {k1}, {steps} steps")
    dc_keys("eval_distilled", card.agg, DC_EVAL_KEYS)
    notes = dc_midis("eval_distilled", (root / "eval").glob("*_ours.mid"))
    say(f"  eval_distilled: {json.dumps(card.agg)}; {notes} notes; {steps} S=1 steps, "
        f"{1e3 * walls['eval_distilled'] / steps:.3f} ms of the script's wall each")
    dc_idle_share(run_dir, vocab, card.songs[0])

    margins, sample = [], generate.sample_token

    def recorded(logits, *args, **kw):
        top2 = logits.float().topk(2, dim=-1).values
        margins.append(float(top2[0, 0] - top2[0, 1]))
        return sample(logits, *args, **kw)

    generate.sample_token = recorded
    try:
        t = time.perf_counter()
        host = eval_distilled.run([*argv, "--songs", "1", "--out", str(root / "eval_cpu"),
                                   "--device", "cpu"])
        walls["eval_distilled cpu"] = time.perf_counter() - t
    finally:
        generate.sample_token = sample
    ours, ref = card.songs[0]["generated"], host.songs[0]["generated"]
    if len(ours) != len(ref) or host.engine_stats["single_token_steps"] != len(margins):
        raise RuntimeError(f"teacher-forced bars {len(ours)} vs {len(ref)}, {len(margins)} "
                           f"margins for {host.engine_stats['single_token_steps']} steps")
    starts = np.cumsum([0] + [len(b) - 1 for b in ref])
    equal, at = 0, []
    for i, (a, b) in enumerate(zip(ours, ref)):
        if a == b:
            equal += 1
            continue
        t = next((t for t, (x, y) in enumerate(zip(a[1:], b[1:])) if x != y),
                 min(len(a), len(b)) - 1)
        at.append(margins[starts[i] + t])
    say(f"  teacher-forced bars of {card.songs[0]['name']}, card vs CPU: {equal} of {len(ref)} "
        f"equal; top-2 margins at the first differing token "
        f"{[round(m, 5) for m in at]} (near-tie limit {TIE_MARGIN}); CPU run "
        f"{walls['eval_distilled cpu']:.2f} s")
    if any(m >= TIE_MARGIN for m in at):
        raise RuntimeError(f"a teacher-forced bar differs past a near-tie: {at}")
    torch.cuda.empty_cache()
    return k1


def dc_idle_share(run_dir, vocab, song) -> None:
    """The device's idle share of eval_distilled's work, on a window of it:
    the first DC_IDLE_BARS bars of `song` through the script's engine
    (rebuild, a 512-token prompt bucket, 64-token bars, teacher-forced
    history), its unprofiled warm wall against its device time under
    torch.profiler (a whole run's million events take the profiler minutes
    to list; `device_busy_us`)."""
    from etude_tpu_torch.data.vocab import Vocab
    from etude_tpu_torch.models.generate import GenerationEngine
    from etude_tpu_torch.scripts.eval_distilled import load_decoder

    model, config = load_decoder(run_dir, "cuda")
    vocab = Vocab.load(vocab)
    engine = GenerationEngine(config, vocab.bar_bos_id, vocab.bar_eos_id, pad_id=vocab.pad_id,
                              prompt_buckets=(512,), max_bar_token_limit=64)

    def run():
        n = DC_IDLE_BARS
        engine.generate_batch(model, [song["src_bars"][:n]], [song["per_bar"][:n]],
                              forced_history_y=[song["tgt_bars"][:n]])

    engine.stats["single_token_steps"] = 0
    wall = warm_wall(run)
    steps = engine.stats["single_token_steps"] // 2
    device_us = device_busy_us(run)
    if device_us <= 0:
        say("  eval_distilled idle share: not measured (the profiler saw no device time)")
        return
    say(f"  eval_distilled, a window of {DC_IDLE_BARS} bars ({steps} S=1 steps): warm wall "
        f"{1e3 * wall:.2f} ms, device busy {device_us / 1e3:.2f} ms -> device idle share "
        f"{1 - device_us / 1e6 / wall:.3f}")


def device_busy_us(run) -> float:
    """The device time of one call of `run` in us: its kernels' and copies'
    durations under torch.profiler, device activity only and read from the
    raw trace (listing a window's host events costs the profiler tens of
    seconds)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    return sum(e.duration_ns() for e in prof.profiler.kineto_results.events()
               if e.device_type() == DeviceType.CUDA) / 1e3


def dc_pipeline_settings(root, run_dir) -> Path:
    """Settings for sweep_sampling and eval_full_pipeline: the train phase's
    decoder, the default (shipped) extractor, separator and beat model;
    64-token bars."""
    settings = root / "settings.json"
    settings.write_text(json.dumps({
        "paths": {"decoder_model": str(run_dir / "model"),
                  "decoder_config": str(run_dir / "etude_decoder_config.json"),
                  "decoder_vocab": str(run_dir / "vocab.json")},
        "decoder": {"max_bar_token_limit": 64}}))
    return settings


def dc_engine_parity(root, walls, songs, data, run_dir, vocab) -> int:
    """eval_engine_parity on DC_EVAL_SONGS songs, greedy; returns its K1."""
    from etude_tpu_torch.scripts import eval_engine_parity

    argv = ["--run", str(run_dir), "--vocab", str(vocab), "--corpus", str(songs),
            "--dataset-dir", str(data), "--songs", str(DC_EVAL_SONGS),
            "--out", str(root / "parity")]
    (rc, parity), k1, _ = dc_stage(walls, "eval_engine_parity", lambda: dc_printed(
        lambda: eval_engine_parity.main(argv)))
    dc_keys("eval_engine_parity", parity, DC_PARITY_KEYS)
    notes = dc_midis("eval_engine_parity", (root / "parity").glob("*/*_ours.mid"))
    say(f"  eval_engine_parity: songs {parity['songs']}, cross F1 {parity['mean_cross_f1']}, "
        f"RGC {parity['mean_rgc_rebuild']} / {parity['mean_rgc_stream']}, IPE "
        f"{parity['mean_ipe_rebuild']} / {parity['mean_ipe_stream']}; {notes} notes")
    if rc != 0 or parity["songs"] != DC_EVAL_SONGS or not k1:
        raise RuntimeError(f"eval_engine_parity exited {rc}: {parity}, K1 {k1}")
    return k1


def dc_pipeline(root, walls, songs, run_dir):
    """sweep_sampling (2 songs, --temps 0 0.7, one seed) and
    eval_full_pipeline (1 song), DC_PIPELINE_SECONDS each; returns (K1,
    K2)."""
    from etude_tpu_torch.scripts import eval_full_pipeline, sweep_sampling

    settings = dc_pipeline_settings(root, run_dir)
    models = ["--config", str(settings), "--corpus", str(songs),
              "--seconds", str(DC_PIPELINE_SECONDS)]
    sweep_out = root / "sweep.json"
    (rc, results), k1, k2 = dc_stage(walls, "sweep_sampling", lambda: dc_printed(
        lambda: sweep_sampling.main([*models, "--songs", "2", "--temps", "0", "0.7",
                                     "--seeds", "1", "--cache", str(root / "sweep_cache"),
                                     "--out", str(sweep_out)])))
    payload = json.loads(sweep_out.read_text())
    dc_keys("sweep_sampling", payload, {"songs", "seconds", "attrs", "refs", "results"})
    notes = dc_midis("sweep_sampling", (root / "sweep_cache").glob("*/T*.mid"))
    say(f"  sweep_sampling: {json.dumps(results)}; refs {json.dumps(payload['refs'])}; "
        f"{notes} notes")
    if rc != 0 or [r["temperature"] for r in results] != [0.0, 0.7] or k2 != 9 * 2 or not k1 \
            or any(set(r) != {"temperature", "top_p", "rgc", "ipe", "seeds"} for r in results):
        raise RuntimeError(f"sweep_sampling exited {rc}: {results}, K1 {k1}, K2 {k2}")

    (rc, full), a, b = dc_stage(walls, "eval_full_pipeline", lambda: dc_printed(
        lambda: eval_full_pipeline.main([*models, "--songs", "1",
                                         "--out", str(root / "full")])))
    dc_keys("eval_full_pipeline", full, {"songs", "song_seconds", "engine", "mean_wall_s",
                                         "rgc", "ipe", "rows"})
    notes = dc_midis("eval_full_pipeline", (root / "full").glob("*/out/ours.mid"))
    say(f"  eval_full_pipeline: wall {full['mean_wall_s']} s, RGC {json.dumps(full['rgc'])}, "
        f"IPE {json.dumps(full['ipe'])}; {notes} notes")
    if rc != 0 or full["songs"] != 1 or b != 9 or not a:
        raise RuntimeError(f"eval_full_pipeline exited {rc}: {full}, K1 {a}, K2 {b}")
    return k1 + a, k2 + b


def dc_wpd(root, walls, songs) -> None:
    """validate_wpd_audio_path on 2 songs; diagnose_wpd_outliers on one
    with its three ablations."""
    from etude_tpu_torch.scripts import diagnose_wpd_outliers, validate_wpd_audio_path

    (rc, wpd), _, _ = dc_stage(walls, "validate_wpd_audio_path", lambda: dc_printed(
        lambda: validate_wpd_audio_path.main(["--songs", "2", "--corpus", str(songs)])))
    dc_keys("validate_wpd_audio_path", wpd, {"songs", "mean_abs_delta", "max_abs_delta"})
    say(f"  validate_wpd_audio_path: {json.dumps(wpd)}")
    if rc != 0 or len(wpd["songs"]) != 2 or wpd["max_abs_delta"] is None:
        raise RuntimeError(f"validate_wpd_audio_path exited {rc}: {wpd}")

    out = root / "wpd_outliers.json"
    (rc, report), _, _ = dc_stage(walls, "diagnose_wpd_outliers", lambda: dc_printed(
        lambda: diagnose_wpd_outliers.main(["--songs", DC_TRACKER_SONG, "--ablate-song",
                                            DC_TRACKER_SONG, "--corpus", str(songs),
                                            "--out", str(out)])))
    dc_keys("diagnose_wpd_outliers", report, {"songs", "ablations"})
    say(f"  diagnose_wpd_outliers: {json.dumps(report)}")
    if rc != 0 or report != json.loads(out.read_text()) or set(report["ablations"]) != {
            "alpha=0.2", "alpha=0.8", "no_tuning"} or "error" in json.dumps(report):
        raise RuntimeError(f"diagnose_wpd_outliers exited {rc}: {report}")


def decoder_corpus_phase(root: Path, exports: Path, run_dir: Path):
    """The decoder_corpus phase, from the aux_train phase's separator and
    beat exports and the train phase's decoder run; returns its (K1, K2)
    launches."""
    from etude_tpu_torch.tools.synthetic_corpus import write_corpus

    walls = {}
    songs = root / "songs"
    write_corpus(songs, DC_SONGS, DC_SECONDS, seed=0)
    vocab = ROOT / "dataset_distill" / "vocab.json"
    data, k2 = dc_distill(root, walls, songs, exports)
    dc_tracker_parity(root, walls, songs)
    k1 = dc_teacher_forced(root, walls, songs, data, run_dir, vocab)
    k1 += dc_engine_parity(root, walls, songs, data, run_dir, vocab)
    a, b = dc_pipeline(root, walls, songs, run_dir)
    dc_wpd(root, walls, songs)
    k1, k2 = k1 + a, k2 + b
    say("  decoder_corpus walls: " + ", ".join(f"{k} {v:.2f} s" for k, v in walls.items())
        + f"; K1 launches {k1}, K2 launches {k2}")
    return k1, k2


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
    """`train_attr_prior` on the first PRIOR_SONGS corpus songs on the card;
    the card's f64 fit against the CPU's on a subset (another seed the
    control); then `--decode-only --attrs-prior` from the new prior.
    Returns K1 launches."""
    import shutil

    import numpy as np
    from etude_tpu_torch.data.dataset import EtudeDataset
    from etude_tpu_torch.data.vocab import Vocab
    from etude_tpu_torch.models.attr_prior import AttrPrior
    from etude_tpu_torch.scripts import train_attr_prior

    data = root / "prior_data"
    for song in sorted((ROOT / "dataset_distill/tokenized").iterdir())[:PRIOR_SONGS]:
        shutil.copytree(song, data / "tokenized" / song.name,
                        ignore=shutil.ignore_patterns("*_hist.npy"))
    shutil.copy(ROOT / "dataset_distill/vocab.json", data / "vocab.json")
    run = train_attr_prior.run(["--dataset", str(data), "--out", str(root / "attr_prior")])
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


def logit_excess(a, b, atol: float = LOGIT_ATOL) -> float:
    """How far card logits `a` lie outside atol + LOGIT_RTOL x |b| of the
    CPU's `b` (positive: outside)."""
    return ((a - b).abs() - (atol + LOGIT_RTOL * b.abs())).max().item()


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


def decoder_parity(name, card, host_model, config, vocab, bars, attrs, atol=LOGIT_ATOL):
    """`teacher_forced_logits` on the card (K1 on every S = 1 step) and on a
    CPU copy (the plain version), within `atol`; controls: one layer's
    attention output zeroed on the card, each layer in turn."""
    host = teacher_forced_logits(host_model, config, vocab, bars, attrs, "cpu")
    out = teacher_forced_logits(card, config, vocab, bars, attrs, "cuda")
    if not bool(out.isfinite().all()):
        raise RuntimeError(f"{name}: non-finite logits on the card")
    gap, excess = (out - host).abs().max().item(), logit_excess(out, host, atol)
    controls = []
    for layer in range(config.num_hidden_layers):
        with zeroed_attention(card, layer):
            got = teacher_forced_logits(card, config, vocab, bars, attrs, "cuda")
        controls.append(((got - host).abs().max().item(), logit_excess(got, host, atol)))
    say(f"  {name}: teacher-forced logits (prefill + 8 S=1 steps, B=2), card vs CPU max|diff| "
        f"{gap:.3g} (atol {atol}, rtol {LOGIT_RTOL}); controls, one layer's attention "
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
                    "pitch_overlap_bin": 2}, atol=SHIPPED_LOGIT_ATOL)
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
    gap, excess = (card - host).abs().max().item(), logit_excess(card, host, SHIPPED_LOGIT_ATOL)
    moved = (control - host).abs().max().item()
    moved_excess = logit_excess(control, host, SHIPPED_LOGIT_ATOL)
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
    wav = root / "click_12s.wav"
    write_click_wav(wav, 12.0, seed=1)
    extract_parity(root, wav, paths.extractor_model, HFT_ATOL)

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
    """`chunk_parity`'s chunks of the shipped decoder on int8 caches, card vs
    CPU (both plain PyTorch with exact integer dots): within
    SHIPPED_QUANT_ATOL; control: one layer's attention output zeroed on the
    card."""
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
        f"{SHIPPED_QUANT_ATOL}); control, layer 0's attention output zeroed: {moved:.3g}")
    if not all(bool(a.isfinite().all()) for a in card) or gap > SHIPPED_QUANT_ATOL:
        raise RuntimeError(f"int8 card vs CPU logits differ by {gap:.3g}")
    if moved <= SHIPPED_QUANT_ATOL:
        raise RuntimeError(f"the int8 logit check missed its control ({moved:.3g})")


def options_kv_quant(model, host_model, config, vocab, bars, attrs):
    """16 streams x the first QUANT_BARS corpus bars (bars capped at 64
    tokens), greedy, with the bf16 cache (K1) and the int8 cache (no
    kernel): tok/s and cache bytes of each; then int8 card vs CPU logits.
    Returns the bf16 run's K1 launches."""
    from etude_tpu_torch.models.generate_stream import (StreamingGenerationEngine,
                                                        init_stream_cache)

    kw = dict(bar_bos_id=vocab.bar_bos_id, bar_eos_id=vocab.bar_eos_id, pad_id=vocab.pad_id,
              max_bar_token_limit=64)
    engines = {q: StreamingGenerationEngine(config, kv_quant=q, **kw) for q in (False, True)}
    timed = bars[:QUANT_BARS]
    C = engines[False].pack([timed] * len(attrs), attrs)["cache_len"]
    launches = 0
    for quant in (False, True):
        engine = engines[quant]
        engine.stats["single_token_chunks"] = 0
        outs, tokens, seconds, n = engine_run(engine, model, timed, attrs)
        check_streams(outs, len(timed), vocab.bar_bos_id, vocab.bar_eos_id, config.vocab_size,
                      64)
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
    from etude_tpu_torch.config import BeatDetectorConfig, PathConfig
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
    detector = BeatDetector(BeatDetectorConfig(), model_path=PathConfig().beat_detector_model,
                            device="cuda")
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


def mesh_training(config, mesh, fsdp):
    """A state of the published decoder from seed 0 over `mesh` (replicated,
    or FSDP), with the mesh step; the rate warms up in one step."""
    import torch
    from etude_tpu_torch.parallel.train_step import (
        init_sharded_state, make_optimizer, make_train_step,
    )
    from etude_tpu_torch.weights import decoder_from_jax, init_decoder_params_np

    model = decoder_from_jax(init_decoder_params_np(config, seed=0), config, mesh.device)
    tx, _ = make_optimizer(learning_rate=2e-4, warmup_steps=1, total_steps=1000)
    return (init_sharded_state(model, tx, mesh, fsdp=fsdp),
            make_train_step(config, tx, compute_dtype=torch.bfloat16, mesh=mesh))


def whole_state(state):
    """Every parameter and both moments, whole, as one flat list of tensors."""
    from etude_tpu_torch.parallel.train_step import full_params
    from etude_tpu_torch.utils.training import full_moments

    mu, nu = full_moments(state)
    return [t.clone() for d in (full_params(state), mu, nu) for t in d.values()]


@contextlib.contextmanager
def deterministic():
    """`torch.use_deterministic_algorithms(True, warn_only=True)` inside;
    yields the list of the warnings it raised (ops without a deterministic
    form)."""
    import warnings

    import torch

    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.use_deterministic_algorithms(True, warn_only=True)
        try:
            yield caught
        finally:
            torch.use_deterministic_algorithms(False)


def nondeterministic_ops(config) -> None:
    """Each op of the decoder's training step at the distill micro-batch's
    shapes (8 x 1024 positions, the config's widths), forward and backward
    twice on the same inputs and a random output gradient: the ops whose
    input gradients differ between the two, by default and under torch's
    deterministic algorithms (which warn of no op here); then the same for
    the whole decoder, by parameter."""
    import torch
    import torch.nn.functional as F

    g = torch.Generator(device="cuda").manual_seed(0)
    B, T, H, V = 8, 1024, config.hidden_size, config.vocab_size
    n_heads, D = config.num_attention_heads, config.head_dim

    def rand(*shape, dtype=torch.float32):
        return torch.randn(*shape, generator=g, device="cuda").to(dtype).requires_grad_()

    ids = torch.randint(0, V, (B, T), generator=g, device="cuda")
    bins = torch.randint(0, 3, (B, T), generator=g, device="cuda")
    labels = torch.randint(0, V, (B, T, 1), generator=g, device="cuda")
    bf16 = torch.bfloat16
    cases = {
        "embedding (word, V rows)": (lambda w: F.embedding(ids, w), [rand(V, H)]),
        "embedding (3 rows: class, attribute)": (lambda w: F.embedding(bins, w),
                                                  [rand(3, H)]),
        "linear bf16 with bias (qkv)": (lambda x, w, b: F.linear(x, w, b),
                                        [rand(B, T, H, dtype=bf16), rand(3 * H, H, dtype=bf16),
                                         rand(3 * H, dtype=bf16)]),
        "linear f32 (lm head)": (lambda x, w: F.linear(x, w), [rand(B, T, H), rand(V, H)]),
        "layer_norm f32": (lambda x, w, b: F.layer_norm(x, (H,), w, b),
                           [rand(B, T, H), rand(H), rand(H)]),
        "einsum QK^T f32": (lambda q, k: torch.einsum("bqhd,bkhd->bhqk", q, k),
                            [rand(B, T, n_heads, D), rand(B, T, n_heads, D)]),
        "einsum PV bf16": (lambda p, v: torch.einsum("bhqk,bkhd->bqhd", p, v),
                           [rand(B, n_heads, T, T, dtype=bf16), rand(B, T, n_heads, D,
                                                                     dtype=bf16)]),
        "log_softmax + gather": (lambda x: torch.log_softmax(x, -1).gather(-1, labels),
                                 [rand(B, T, V)]),
    }

    def differing():
        out = []
        for name, (fn, leaves) in cases.items():
            gy = torch.randn(fn(*leaves).shape, generator=g, device="cuda")
            grads = [torch.autograd.grad(fn(*leaves), leaves, gy.to(leaves[0].dtype))
                     for _ in range(2)]
            if not all(torch.equal(a, b) for a, b in zip(*grads)):
                out.append(name)
        return out

    plain = differing()
    with deterministic() as caught:
        flagged = differing()
    say(f"  ops of the training step whose backward differs between two identical runs: "
        f"{plain}; under deterministic algorithms: {flagged} (warnings: {len(caught)})")

    # The whole forward and backward of the decoder (seed 0's weights) on
    # one such micro-batch, twice: the parameters whose gradients differ.
    from etude_tpu_torch.models.decoder import ATTRIBUTE_ORDER, loss_fn
    from etude_tpu_torch.weights import decoder_from_jax, init_decoder_params_np

    model = decoder_from_jax(init_decoder_params_np(config, seed=0), config, "cuda")
    model.requires_grad_(True)
    batch = {"input_ids": ids, "class_ids": bins % 2 + 1, "labels": labels[..., 0],
             "attention_mask": torch.ones_like(ids),
             **{f"{name}_bin_ids": bins for name in ATTRIBUTE_ORDER}}

    def step_grads():
        out = []
        for _ in range(2):
            model.zero_grad(set_to_none=True)
            loss, _ = loss_fn(model, batch, torch.bfloat16)
            loss.backward()
            out.append({n: p.grad.clone() for n, p in model.named_parameters()})
        return [n for n in out[0] if not torch.equal(out[0][n], out[1][n])]

    plain = step_grads()
    with deterministic():
        flagged = step_grads()
    say(f"  the decoder's whole backward twice: {len(plain)} of "
        f"{len(list(model.parameters()))} parameters' gradients differ ({plain[:6]}"
        f"{' ...' if len(plain) > 6 else ''}); under deterministic algorithms {len(flagged)} "
        f"({flagged[:6]})")


def mesh_parity(root: Path, config, hosts):
    """An NCCL world of one: the FSDP state (its parameters gathered and its
    gradients reduce-scattered over the group, its norm from per-parameter
    squares) against the plain step without a group, for MESH_STEPS steps
    from the same weights and batches, bit for bit in bf16 (control: one
    row's labels shifted); then an FSDP checkpoint saved and restored onto
    a state from other weights, whose next two steps equal the direct
    state's in every bit (control: the moments zeroed in a copy). The
    card's backward is not deterministic by default, so the checks run
    under torch's deterministic algorithms. Leaves no process group."""
    import numpy as np
    import torch
    import torch.distributed as dist
    from etude_tpu_torch.parallel.mesh import initialize_multihost, make_mesh, shard_batch
    from etude_tpu_torch.parallel.train_step import reshape_for_accum

    initialize_multihost(f"file://{root}/store", 1, 0, device="cuda")
    try:
        mesh = make_mesh(data_parallel=1)
        say(f"  process group: world size {dist.get_world_size()}, backend "
            f"{dist.get_backend()}, rank 0 on {mesh.device}")

        def batches(shift_row=None):
            out = []
            for host in hosts:
                host = reshape_for_accum(host, 4)
                if shift_row is not None:
                    host = {**host, "labels": host["labels"].copy()}
                    host["labels"][0, shift_row] = np.roll(host["labels"][0, shift_row], 1)
                out.append({k: torch.from_numpy(v).cuda()
                            for k, v in shard_batch(host, mesh).items()})
            return out

        def run(kind, data):
            if kind == "plain":
                state, step = fresh_training(config, "cuda", torch.bfloat16, warmup=1)
                data = [{k: v for k, v in b.items() if k != "n_labels"} for b in data]
            else:
                state, step = mesh_training(config, mesh, fsdp=True)
            losses = [step(state, data[0])["loss"]]
            # The step reads nothing back to the host: after the first step
            # a synchronization raises, as under the CLI's --strict-sync.
            torch.cuda.set_sync_debug_mode("error")
            try:
                losses += [step(state, b)["loss"] for b in data[1:MESH_STEPS]]
            finally:
                torch.cuda.set_sync_debug_mode("default")
            return [float(x) for x in losses], whole_state(state), state, step

        with deterministic() as caught:
            mesh_checks(root, config, mesh, batches, run)
        ops = sorted({str(w.message).split(" does not have")[0][:80] for w in caught})
        say(f"  under deterministic algorithms; warned ops without a deterministic form: {ops}")
        nondeterministic_ops(config)
    finally:
        dist.destroy_process_group()
        torch.cuda.empty_cache()


def mesh_checks(root: Path, config, mesh, batches, run):
    """The body of `mesh_parity`, under deterministic algorithms."""
    import shutil

    import numpy as np
    import torch
    from etude_tpu_torch.utils.training import load_checkpoint, save_checkpoint

    plain = run("plain", batches())
    rows = {}
    for kind, data in (("FSDP", batches()),
                       ("control, one row's labels shifted", batches(shift_row=0))):
        losses, tensors, state, step = run("fsdp", data)
        same = losses == plain[0] and all(torch.equal(a, b) for a, b in zip(tensors, plain[1]))
        rows[kind] = same
        say(f"  mesh step ({kind}), {MESH_STEPS} steps of 32 x 1024 in bf16: losses "
            f"{losses} vs plain {plain[0]}; losses, parameters and moments equal "
            f"bit for bit: {same}")
        if kind == "FSDP":
            fsdp_state, fsdp_step = state, step
        else:
            del state, step
    if not rows["FSDP"]:
        raise RuntimeError("the FSDP step at world 1 differs from the plain step")
    if rows["control, one row's labels shifted"]:
        raise RuntimeError("the mesh step check missed its control (labels shifted)")
    del plain
    torch.cuda.empty_cache()

    # The FSDP checkpoint: direct, resumed onto other weights, and the
    # control with zeroed moments; two more steps each.
    data = batches()[MESH_STEPS:MESH_STEPS + 2]
    ckpt, bad = root / "ckpt", root / "ckpt_zeroed"
    t = time.perf_counter()
    save_checkpoint(ckpt, fsdp_state, epoch=0, global_step=MESH_STEPS, model_config=config)
    save_s = time.perf_counter() - t
    shutil.copytree(ckpt, bad)
    opt = bad / "latest" / "opt_state.npz"
    with np.load(opt) as f:
        zeroed = {k: (np.zeros_like(f[k]) if k.startswith(("mu/", "nu/")) else f[k])
                  for k in f.files}
    np.savez(opt, **zeroed)
    results = {}
    for name, source in (("direct", None), ("resumed", ckpt), ("control", bad)):
        if source is None:
            state, step = fsdp_state, fsdp_step
        else:
            state, step = mesh_training(config, mesh, True)
            load_checkpoint(source, state)
        losses = [float(step(state, b)["loss"]) for b in data]
        results[name] = (losses, whole_state(state))
        del state
    direct, resumed, control = results["direct"], results["resumed"], results["control"]

    def equal(a, b):
        return a[0] == b[0] and all(torch.equal(x, y) for x, y in zip(a[1], b[1]))

    say(f"  FSDP checkpoint (saved in {save_s:.2f} s): two steps after the restore, losses "
        f"{resumed[0]} vs direct {direct[0]}, state equal bit for bit: "
        f"{equal(resumed, direct)}; control, moments zeroed: losses {control[0]}, "
        f"equal: {equal(control, direct)}")
    if not equal(resumed, direct):
        raise RuntimeError("the FSDP checkpoint did not resume bit for bit")
    if equal(control, direct):
        raise RuntimeError("the resume check missed its control (moments zeroed)")


class _Margins:
    """While entered, the streaming engine's sampler also records each
    row's top-2 logit margin at every call (on the device)."""

    def __enter__(self):
        from etude_tpu_torch.models import generate_stream

        self.margins, self._module = [], generate_stream
        self._sample = sample = generate_stream.sample_token

        def recorded(logits, *args, **kw):
            top2 = logits.topk(2, dim=-1).values
            self.margins.append(top2[..., 0] - top2[..., 1])
            return sample(logits, *args, **kw)

        generate_stream.sample_token = recorded
        return self

    def __exit__(self, *exc):
        self._module.sample_token = self._sample


def sweep_divergence(one, spread, margins):
    """(streams equal, streams first diverging at a near-tie, the largest
    margin at a first divergence); the margin is the one-device run's at
    the diverging token."""
    steps = [max(len(s[i]) - 1 for s in one) for i in range(len(one[0]))]
    starts = [sum(steps[:i]) for i in range(len(steps))]
    equal = ties = 0
    worst = 0.0
    for b, (a, c) in enumerate(zip(one, spread)):
        if a == c:
            equal += 1
            continue
        i = next(i for i, (x, y) in enumerate(zip(a, c)) if x != y)
        t = next((t for t, (x, y) in enumerate(zip(a[i], c[i])) if x != y),
                 min(len(a[i]), len(c[i])))
        margin = float(margins[starts[i] + t - 1, b])
        worst = max(worst, margin)
        ties += margin < TIE_MARGIN
    return equal, ties, worst


def split_sweep(config, vocab, devices) -> int:
    """The 27-combo sweep over SWEEP_BARS corpus bars at full width, on one
    device and spread over `devices` (one thread each): greedy tokens
    equal up to near-ties, K1 launches = S = 1 chunks x layers in both.
    Returns the K1 launches."""
    import torch
    from etude_tpu_torch.models.generate_stream import StreamingGenerationEngine
    from etude_tpu_torch.ops.decode_attention import decode_attention
    from etude_tpu_torch.weights import decoder_from_jax, init_decoder_params_np

    model = decoder_from_jax(init_decoder_params_np(config, seed=0), config, "cuda:0")
    bars = corpus_bars(vocab, SWEEP_BARS)
    combos = [{"polyphony_bin": p, "rhythm_intensity_bin": r, "sustain_bin": s,
               "pitch_overlap_bin": 1} for p in range(3) for r in range(3) for s in range(3)]
    attrs = [[c] * len(bars) for c in combos]
    engine = StreamingGenerationEngine(config, bar_bos_id=vocab.bar_bos_id,
                                       bar_eos_id=vocab.bar_eos_id, pad_id=vocab.pad_id,
                                       max_bar_token_limit=SWEEP_TOKENS)
    runs, total = {}, 0
    for name, kw in (("one card", {}), (f"{len(devices)} devices", {"devices": devices})):
        engine.stats["single_token_chunks"] = 0
        decode_attention.launches = 0
        with _Margins() if not kw else contextlib.nullcontext() as rec:
            t = time.perf_counter()
            outs = engine.generate_batch(model, [bars] * len(combos), attrs, temperature=0.0, **kw)
            wall = time.perf_counter() - t
        chunks, launches = engine.stats["single_token_chunks"], decode_attention.launches
        check_streams(outs, len(bars), vocab.bar_bos_id, vocab.bar_eos_id, config.vocab_size,
                      SWEEP_TOKENS)
        tokens = sum(len(b) - 1 for o in outs for b in o)
        say(f"  sweep on {name}: 27 streams x {len(bars)} bars, {tokens} tokens in {wall:.3f} s "
            f"= {tokens / wall:.1f} tok/s; {chunks} S=1 chunks, K1 launches {launches} "
            f"(expected {chunks * config.num_hidden_layers})")
        if launches == 0 or launches != chunks * config.num_hidden_layers:
            raise RuntimeError(f"the sweep launched K1 {launches} times")
        runs[name] = (outs, rec)
        total += launches
    (one, rec), (spread, _) = runs.values()
    equal, ties, worst = sweep_divergence(one, spread, torch.stack(rec.margins).cpu())
    say(f"  split sweep over {[str(d) for d in devices]}: {equal}/27 streams equal the "
        f"one-card run, {ties} first diverge at a near-tie (top-2 margin < {TIE_MARGIN}); "
        f"largest margin at a divergence {worst:.4g}")
    if equal + ties != len(combos):
        raise RuntimeError("the split sweep diverged from one card's away from a near-tie")
    return total


def learning_run(config, mesh, hosts_path: str) -> dict:
    """MESH_LEARN_STEPS steps of the mesh step (`mesh_training`, replicated)
    on the host batches saved at `hosts_path`, this rank's rows of each;
    the per-step losses and gradient norms, read back at the end."""
    import numpy as np
    import torch
    from etude_tpu_torch.parallel.mesh import shard_batch
    from etude_tpu_torch.parallel.train_step import reshape_for_accum

    with np.load(hosts_path) as f:
        hosts = [{k.split("/", 1)[1]: f[k] for k in f.files if k.startswith(f"b{i}/")}
                 for i in range(MESH_LEARN_STEPS)]
    state, step = mesh_training(config, mesh, fsdp=False)
    metrics = [step(state, {k: torch.from_numpy(v).to(mesh.device)
                            for k, v in shard_batch(reshape_for_accum(h, 4), mesh).items()})
               for h in hosts]
    return {key: [float(m[key]) for m in metrics] for key in ("loss", "grad_norm")}


def _mesh_learning_rank(rank: int, world: int, address: str, out: str, fields: dict,
                        hosts_path: str, control: bool) -> None:
    """One rank of `mesh_learning`; rank 0 writes `learning_run`'s record to
    `out`. The control skips the gradients' all-reduce (every reduction
    but the two-element sum of the loss and accuracy)."""
    import torch.distributed as dist
    from etude_tpu_torch.models.decoder import EtudeDecoderConfig
    from etude_tpu_torch.parallel.mesh import initialize_multihost, make_mesh

    initialize_multihost(address, world, rank, device="cuda")
    try:
        if control:
            all_reduce = dist.all_reduce
            dist.all_reduce = (lambda t, *a, **kw:
                               all_reduce(t, *a, **kw) if t.numel() <= 2 else None)
        record = learning_run(EtudeDecoderConfig(**fields), make_mesh(data_parallel=world),
                              hosts_path)
        if rank == 0:
            Path(out).write_text(json.dumps(record))
    finally:
        dist.destroy_process_group()


def mesh_learning(root: Path, config, hosts, n: int) -> None:
    """The mesh step over n cards (one NCCL rank each) against one card,
    MESH_LEARN_STEPS steps of real learning from the same weights and
    batches: every step's loss within MESH_LOSS_RTOL and gradient norm
    within MESH_NORM_RTOL of one card's (two one-card runs printed for the
    card's own spread); the control, the gradients' all-reduce skipped,
    must leave one of the limits."""
    import dataclasses

    import numpy as np
    from etude_tpu_torch.parallel.mesh import make_mesh, spawn_ranks

    path = root / "learning_hosts.npz"
    np.savez(path, **{f"b{i}/{k}": v for i, h in enumerate(hosts[:MESH_LEARN_STEPS])
                      for k, v in h.items()})

    def gaps(a, b):
        return {k: max(abs(x / y - 1) for x, y in zip(a[k], b[k], strict=True)) for k in a}

    one = [learning_run(config, make_mesh(data_parallel=1), str(path)) for _ in range(2)]
    fields = dataclasses.asdict(config)
    t = time.perf_counter()
    spread = spawn_ranks(_mesh_learning_rank, n, fields, str(path), False)
    spread_s = time.perf_counter() - t
    control = spawn_ranks(_mesh_learning_rank, n, fields, str(path), True)
    rows = {"one card again": gaps(one[1], one[0]), f"{n} cards": gaps(spread, one[0]),
            "control, all-reduce skipped": gaps(control, one[0])}
    say(f"  mesh step over {n} cards vs one, {MESH_LEARN_STEPS} steps of 32 x 1024 at "
        f"rate 2e-4 ({spread_s:.2f} s with the ranks' start): one card's losses "
        f"{[round(x, 6) for x in one[0]['loss']]}, gradient norms "
        f"{[round(x, 6) for x in one[0]['grad_norm']]}; {n} cards' losses "
        f"{[round(x, 6) for x in spread['loss']]}")
    for name, gap in rows.items():
        say(f"    {name}: largest relative gap, losses {gap['loss']:.3g} (limit "
            f"{MESH_LOSS_RTOL}), gradient norms {gap['grad_norm']:.3g} (limit {MESH_NORM_RTOL})")
    if not one[0]["loss"][-1] < one[0]["loss"][0]:
        raise RuntimeError("the learning check's loss did not fall")
    gap = rows[f"{n} cards"]
    if gap["loss"] > MESH_LOSS_RTOL or gap["grad_norm"] > MESH_NORM_RTOL:
        raise RuntimeError(f"the mesh step over {n} cards left one card's run ({gap})")
    gap = rows["control, all-reduce skipped"]
    if gap["loss"] <= MESH_LOSS_RTOL and gap["grad_norm"] <= MESH_NORM_RTOL:
        raise RuntimeError("the mesh learning check missed its control (all-reduce skipped)")


def dp_cli_parity(root: Path, n: int) -> None:
    """The training CLI over n cards (`mesh.data_parallel` = n, one rank per
    card) against one card, DP_CLI_STEPS steps of the same global batch at
    full width under --strict-sync: every step's loss within the card-vs-CPU
    step limit."""
    from etude_tpu_torch import train

    runs = {}
    for dp in (1, n):
        settings = train_settings(root / f"dp{dp}", ROOT / "dataset_distill/tokenized")
        cfg = json.loads(settings.read_text())
        settings.write_text(json.dumps({**cfg, "mesh": {"data_parallel": dp}}))
        t = time.perf_counter()
        run = train.run(["--config", str(settings), "--run-id", "r", "--max-steps",
                         str(DP_CLI_STEPS), "--strict-sync"])
        if run is None:
            raise RuntimeError(f"the CLI over {dp} card(s) failed")
        runs[dp] = run
        say(f"  CLI, mesh.data_parallel {dp}: {DP_CLI_STEPS} steps in "
            f"{time.perf_counter() - t:.2f} s of wall, warm median step "
            f"{1e3 * statistics.median(run.step_seconds[1:]):.2f} ms; losses "
            f"{run.losses[0]:.5f} .. {run.losses[-1]:.5f}")
    gap = max(abs(a / b - 1) for a, b in zip(runs[n].losses, runs[1].losses, strict=True))
    say(f"  CLI over {n} cards vs one: largest relative loss gap {gap:.3g} "
        f"(limit {STEP_LOSS_RTOL})")
    if gap > STEP_LOSS_RTOL:
        raise RuntimeError(f"the data-parallel CLI left the one-card losses ({gap:.3g})")


def sweep_cli(root: Path) -> int:
    """`infer --decode-only --sweep` on a synthetic 8-bar work dir at full
    decoder width (random weights, 32-token bars): batched on one card
    (the streaming engine gets no devices), 27 MIDI files parse. Returns
    the K1 launches."""
    from etude_tpu_torch import infer
    from etude_tpu_torch.models.generate_stream import StreamingGenerationEngine
    from etude_tpu_torch.ops.decode_attention import decode_attention
    from etude_tpu_torch.utils.midi import read_midi_notes

    work = root / "outputs" / "infer" / "temp"
    work.mkdir(parents=True)
    (work / "tempo.json").write_text(json.dumps([{
        "time_sig": 4, "bpm": 120.0, "start": 1.0,
        "downbeats": [1.0 + 2.0 * i for i in range(8)]}]))
    (work / "extract.json").write_text(json.dumps([
        {"onset": 1.0 + 0.5 * i, "offset": 1.4 + 0.5 * i, "pitch": 48 + (7 * i) % 36,
         "velocity": 80} for i in range(30)]))
    (work / "volume.json").write_text(json.dumps([0.5] * 2000))
    settings = serve_settings(root, 32)
    seen = []
    generate_batch = StreamingGenerationEngine.generate_batch

    def spy(self, *args, **kw):
        seen.append(kw.get("devices"))
        return generate_batch(self, *args, **kw)

    StreamingGenerationEngine.generate_batch = spy
    decode_attention.launches = 0
    t = time.perf_counter()
    try:
        rc = infer.main(["--config", str(settings), "--decode-only", "--sweep",
                         "--output_name", "sweep", "--seed", "7"])
    finally:
        StreamingGenerationEngine.generate_batch = generate_batch
    wall = time.perf_counter() - t
    launches = decode_attention.launches
    mids = sorted((root / "outputs" / "infer").glob("sweep_p*.mid"))
    for m in mids:
        read_midi_notes(m)
    say(f"  infer --decode-only --sweep: rc {rc}, {len(mids)} MIDI files in {wall:.2f} s, "
        f"devices passed {seen}, K1 launches {launches}")
    if rc != 0 or len(mids) != 27 or seen != [None] or launches == 0:
        raise RuntimeError("the CLI sweep did not run batched on one card")
    return launches


def multigpu_phase(root: Path, config, vocab, serve_config, serve_vocab) -> int:
    """The multigpu phase; returns its K1 launches."""
    import itertools

    import torch
    from etude_tpu_torch.entry import dryrun_multichip

    n = torch.cuda.device_count()
    say(f"  multigpu phase at world size {n}: {n} card(s) visible"
        + ("" if n > 1 else "; the checks over several cards need two or more"))
    count = max(MESH_STEPS + 2, MESH_LEARN_STEPS if n > 1 else 0)
    _, dataset, _ = corpus_subset(root / "subset", count, 32)
    hosts = list(itertools.islice(dataset.batches(32, shuffle=True, seed=1234), count))
    mesh_parity(root, config, hosts)
    t = time.perf_counter()
    dryrun_multichip(n)
    say(f"  dryrun_multichip({n}): ok in {time.perf_counter() - t:.2f} s")
    devices = ([torch.device("cuda", i) for i in range(n)] if n > 1
               else [torch.device("cuda", 0)] * 2)
    launches = split_sweep(serve_config, serve_vocab, devices)
    launches += sweep_cli(root / "sweep_cli")
    if n > 1:
        mesh_learning(root, config, hosts, n)
        dp_cli_parity(root, n)
        from etude_tpu_torch.tools import mesh_bench

        runs = {}
        for ranks, fsdp in sorted({(1, False), (2, False), (n, False), (n, True)}):
            runs[ranks, fsdp] = r = mesh_bench.run(ranks, fsdp=fsdp)
            say(f"  mesh_bench {ranks} rank(s){' FSDP' if fsdp else ''}: warm step median "
                f"{r['step_ms_median']:.2f} ms (min {r['step_ms_min']:.2f}, max "
                f"{r['step_ms_max']:.2f}), {r['tokens_per_s']:,.0f} positions/s; collectives' "
                f"share of device time {[round(x, 4) for x in r['collective_share']]}; peak "
                f"memory per card {[round(p['peak_gib'], 3) for p in r['per_rank']]} GiB")
            say("  mesh_bench " + json.dumps(r))
        one = runs[1, False]["losses"]
        gap = max(abs(a / b - 1) for r in runs.values() for a, b in zip(r["losses"], one,
                                                                        strict=True))
        say(f"  mesh_bench losses against one rank's: largest relative gap {gap:.3g} "
            f"(limit {MESH_LOSS_RTOL})")
        if gap > MESH_LOSS_RTOL:
            raise RuntimeError(f"mesh_bench's losses left one rank's ({gap:.3g})")
    say(f"  multigpu phase ran at world size {n}")
    return launches


# ----------------------------------------------------------------- lanes
# The prepare, aux_train, corpus and decoder_corpus phases run in a second
# process (`chip_smoke.py --lane DIR T0`), beside the others: each phase is
# bound by its host thread launching small kernels, so the card and the
# host's cores have room for two. The lanes share the work dir and hand
# each other what one needs from the other as small JSON files in it.
LANE_WAIT_SECONDS = 1200.0


def handoff(path: Path, value: dict) -> None:
    part = path.with_name(path.name + ".part")
    part.write_text(json.dumps(value))
    part.replace(path)


def await_handoff(path: Path, lane=None) -> dict:
    """Waits for `path` (written by `handoff`) and returns what it holds;
    raises if `lane`, the second lane's process, exits first."""
    deadline = time.monotonic() + LANE_WAIT_SECONDS
    while not path.exists():
        if lane is not None and lane.poll() is not None:
            raise RuntimeError(f"the second lane exited {lane.returncode} before {path.name}")
        if time.monotonic() > deadline:
            raise RuntimeError(f"no {path.name} after {LANE_WAIT_SECONDS:.0f} s")
        time.sleep(0.5)
    return json.loads(path.read_text())


def start_lane(tmp: Path):
    """Starts the second lane in its own session, its output to
    tmp/lane.log; it is killed if this process dies."""
    import ctypes
    import signal

    libc = ctypes.CDLL(None, use_errno=True)
    with open(tmp / "lane.log", "w") as log:
        return subprocess.Popen(
            [sys.executable, str(Path(__file__).resolve()), "--lane", str(tmp), repr(T0)],
            stdout=log, stderr=subprocess.STDOUT, start_new_session=True,
            preexec_fn=lambda: libc.prctl(1, signal.SIGKILL))   # PR_SET_PDEATHSIG


def stop_lane(lane, tmp: Path) -> None:
    """Kills the second lane's session if it still runs, and prints its log."""
    import signal

    if lane.poll() is None:
        os.killpg(lane.pid, signal.SIGKILL)
        lane.wait()
    say(f"[lane] the second lane's output (exit {lane.returncode}):")
    say((tmp / "lane.log").read_text().rstrip())
    say("[lane] end of the second lane's output")


def lane_main(tmp: Path) -> int:
    """The second lane: prepare, aux_train, corpus, then decoder_corpus once
    the train phase's run is handed over. Hands over aux.json (the aux
    exports, for the recipe phase), prepared.json (for the evaluate phase)
    and, last, lane.json (its launches)."""
    import torch

    sys.path.insert(0, str(ROOT))
    os.chdir(ROOT)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    with phase("prepare"):
        k2 = prepare_phase(tmp / "prepare")
    handoff(tmp / "prepared.json", {"root": str(tmp / "prepare")})
    with phase("aux_train"):
        a, k2b, exports, device_ms = aux_train_phase(tmp / "aux")
        k2 += a
    handoff(tmp / "aux.json", {"exports": str(exports)})
    with phase("corpus"):
        a, b = corpus_phase(tmp / "corpus", exports, device_ms)
        k2, k2b = k2 + a, k2b + b
    trained = Path(await_handoff(tmp / "trained.json")["run_dir"])
    with phase("decoder_corpus"):
        k1, a = decoder_corpus_phase(tmp / "decoder_corpus", exports, trained)
        k2 += a
    handoff(tmp / "lane.json", {"k1": k1, "k2": k2, "k2b": k2b})
    return 0


def first_lane(tmp: Path, lane, shipped, config, vocab, engine, bars, attrs, main_C):
    """The phases beside the second lane, in order: serving, structuralize,
    extract, shipped, evaluate (once the second lane's prepare phase is
    done), cli, train (its run handed over for decoder_corpus), multigpu,
    recipe (once the aux exports are handed over), options. Returns the
    (K1, K2) launches of its runs."""
    from etude_tpu_torch.data.vocab import Vocab
    from etude_tpu_torch.utils.model_loader import load_etude_decoder

    with phase("serving"):
        model, _ = load_etude_decoder(shipped.decoder_config, shipped.decoder_model,
                                      device="cuda")
        say(f"  decoder (shipped): {sum(p.numel() for p in model.parameters())} parameters, "
            f"{len(bars)} corpus bars, 16 streams, cache C = {main_C}")
        say(f"  host: {host_launch_us():.2f} us per eager launch (1-element add)")
        launches = 0
        for kw, n_bars in (({"temperature": 0.0}, GREEDY_BARS),
                           ({"temperature": 1.0, "top_p": 0.9, "seed": 1234}, SAMPLED_BARS)):
            outs, n = serve(engine, model, bars[:n_bars], attrs, **kw)
            check_streams(outs, n_bars, vocab.bar_bos_id, vocab.bar_eos_id,
                          config.vocab_size, engine.max_bar_token_limit)
            launches += n
        profile_window(model, config, vocab, bars, attrs)
        chunk_parity(model, config, bars, {"pitch_overlap": 2, "polyphony": 1,
                                           "sustain": 1, "rhythm_intensity": 1})

    song, clip = tmp / "song_240s.wav", tmp / "song_30s.wav"
    truth = write_song(song, SONG_SECONDS)
    write_song(clip, CLIP_SECONDS)
    notes_clip = tmp / "song_notes.wav"
    write_song(notes_clip, NOTES_CLIP_SECONDS)
    say(f"  the song: {len(truth)} notes of seed 0's grid_song at {30.0 / SHIPPED_EIGHTH:.0f} "
        f"BPM over {SONG_SECONDS:.0f} s, {song.stat().st_size} bytes of 16-bit PCM")
    with phase("structuralize"):
        k2_launches = structuralize(tmp / "stage2", song)
        stage2_parity(tmp, clip)

    with phase("extract"):
        extract(tmp / "stage1", song)
        extract_parity(tmp, clip, shipped.extractor_model, SHIPPED_HFT_ATOL,
                       notes=notes_clip)

    with phase("shipped"):
        work, k1, k2 = pipeline(tmp / "pipeline", song, truth)
        launches += k1
        k2_launches += k2
        t = time.perf_counter()
        k1, k2 = url_input(tmp / "url", song, tmp / "pipeline" / "outputs" / "infer", truth)
        say(f"  the URL checks: {time.perf_counter() - t:.2f} s")
        launches += k1
        k2_launches += k2

    prepared = Path(await_handoff(tmp / "prepared.json", lane)["root"])
    with phase("evaluate"):
        evaluate_phase(tmp / "evaluate", prepared,
                       tmp / "pipeline" / "outputs" / "infer" / "pipeline.mid")

    with phase("cli"):
        from etude_tpu_torch import infer
        from etude_tpu_torch.ops.decode_attention import decode_attention
        from etude_tpu_torch.utils.midi import read_midi_notes

        settings = cli_work_dir(tmp / "cli", work, 30.0)
        decode_attention.launches = 0
        rc = infer.main(["--config", str(settings), "--decode-only",
                         "--output_name", "smoke", "--seed", "7"])
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
    handoff(tmp / "trained.json", {"run_dir": str(trained)})

    with phase("multigpu"):
        from etude_tpu_torch.config import load_config
        from etude_tpu_torch.train import build_model_config

        distill_vocab = Vocab.load(ROOT / "dataset_distill/vocab.json")
        distill = build_model_config(load_config(None), len(distill_vocab))
        launches += multigpu_phase(tmp / "multigpu", distill, distill_vocab, config, vocab)

    exports = Path(await_handoff(tmp / "aux.json", lane)["exports"])
    with phase("recipe"):
        launches += recipe_phase(tmp / "recipe", trained, exports / "separator" / "latest",
                                 tmp / "cli")

    with phase("options"):
        from etude_tpu_torch.utils.kernel_bench import L2Flush

        k1, k2 = options_phase(tmp / "options", tmp / "cli", model, config, vocab, bars,
                               attrs, L2Flush())
        launches += k1
        k2_launches += k2
    return launches, k2_launches


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        say("chip_smoke: torch.cuda.is_available() is False; this run needs a GPU")
        return 1
    if not (ROOT / "etude_tpu_torch" / "__init__.py").exists():
        say(f"chip_smoke: the package etude_tpu_torch is not beside {__file__}")
        return 1
    sys.path.insert(0, str(ROOT))
    os.chdir(ROOT)   # the default model paths are relative, as the JAX package's

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
        from etude_tpu_torch.config import PathConfig

        shipped = PathConfig()
        files = [f for f in ROOT.rglob("*") if f.is_file()]
        exports = sum(f.stat().st_size for f in shipped.decoder_model.parent.rglob("*")
                      if f.is_file())
        say(f"  this checkout: {len(files)} files, {sum(f.stat().st_size for f in files) / 2**20:.1f} "
            f"MiB, of which {shipped.decoder_model.parent}/ {exports / 2**20:.1f} MiB")

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
        k2b_rows = backward_kernel_rows(flush)
        del flush

    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        lane = start_lane(tmp)
        say(f"[lane] the second lane (prepare, aux_train, corpus, decoder_corpus) started: "
            f"pid {lane.pid}, output at the end")
        try:
            launches, k2_launches = first_lane(
                tmp, lane, shipped, config, vocab, engine, bars, attrs, main_C)
            t = time.perf_counter()
            counts = await_handoff(tmp / "lane.json", lane)
            if lane.wait() != 0:
                raise RuntimeError(f"the second lane exited {lane.returncode}")
            say(f"[lane] waited {time.perf_counter() - t:.2f} s for the second lane "
                f"(t={time.perf_counter() - T0:.1f}s)")
        finally:
            stop_lane(lane, tmp)
        launches += counts["k1"]
        k2_launches += counts["k2"]
        k2b_launches = counts["k2b"]

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
        # K2's backward, per call (one launch) on the main path: the mean
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
    if sys.argv[1:2] == ["--lane"]:
        T0 = float(sys.argv[3])
        sys.exit(lane_main(Path(sys.argv[2])))
    sys.exit(main())
