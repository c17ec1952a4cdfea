"""Dataset preparation on one GPU:
`python -m etude_tpu_torch.prepare [--start-from download] [--device cpu] ...`.

The port of the repository's `prepare.py`: five resumable, idempotent
stages, each of which skips the work whose outputs already exist —

  1 download   CSV of (piano, pop) YouTube ids → raw/NNNN/{cover,origin}.wav
               through yt-dlp (utils/download.py; it needs yt-dlp, ffmpeg
               and the network); failed songs are warned of and left out
  2 preprocess hFT stride transcription of covers (data/hft.py); separation,
               Beat-Transformer and DBN beat grid of origins
  3 align      origin↔cover chroma DTW (data/aligner.py), WP-Std filter,
               weakly-aligned cover notes
  4 extract    condition notes from origin audio (data/extractor.py)
  5 tokenize   REMI-encode both sides, build the vocab, save id sequences

It runs the models on CUDA unless `--device cpu` is given; with no GPU it
raises rather than carry on on the CPU. With no `--config`, the settings
are the defaults of `etude_tpu_torch.config`. Missing checkpoints of the
stages to run are refused unless `--allow-random-weights` is given.
"""

from __future__ import annotations

import argparse
import csv
import json
import sys
from pathlib import Path
from typing import Optional

import torch

from .config import EtudeConfig, load_config
from .data.aligner import AudioAligner
from .data.beat_analyzer import BeatAnalyzer
from .data.beat_detector import BeatDetector
from .data.extractor import AMTAPC_Extractor
from .data.hft import HFT_Transformer
from .data.separation import SourceSeparator
from .data.tokenizer import TinyREMITokenizer
from .data.vocab import Vocab
from .utils.device import resolve_device
from .utils.download import download_audio_from_url
from .utils.logger import logger
from .utils.preprocess import (
    compute_wp_std,
    create_time_map_from_downbeats,
    weakly_align,
)
from .utils.profiling import StageTimer, maybe_span

STAGES = ("download", "preprocess", "align", "extract", "tokenize")


YOUTUBE_URL = "https://www.youtube.com/watch?v="
# (CSV column, file in raw/NNNN/), in the order they are fetched.
DOWNLOADS = (("piano_ids", "cover.wav"), ("pop_ids", "origin.wav"))


def _is_blank(row) -> bool:
    """A line pandas skips: empty, or whitespace alone (not a quoted "")."""
    return not row or (len(row) == 1 and row[0] != "" and not row[0].strip())


def read_song_ids(csv_path: Path) -> list:
    """The dataset CSV's rows as {column: id} for the DOWNLOADS columns,
    read as `pandas.read_csv` reads them: blank and whitespace-only lines
    are skipped and take no position, a UTF-8 BOM is dropped, quoted fields
    are unquoted, of two columns of one name the first counts, and a
    missing column or a row longer than the header fails before any
    download. Unlike pandas, an id keeps its text as written: pandas makes
    a column of digits integers (`007` → 7) and an empty cell, or a short
    row's missing one, NaN (which turns a column of digits into floats,
    `123.0`); here they stay `007`, `123` and an empty id."""
    with open(csv_path, newline="", encoding="utf-8-sig") as f:
        reader = csv.reader(f)
        rows = []
        for row in reader:
            if _is_blank(row):
                continue
            if rows and len(row) > len(rows[0]):
                raise ValueError(f"{csv_path}: expected {len(rows[0])} fields in line "
                                 f"{reader.line_num}, saw {len(row)}")
            rows.append(row)
    if not rows:
        raise ValueError(f"{csv_path}: no columns to parse from file")
    header = rows[0]
    for column, _ in DOWNLOADS:
        if column not in header:
            raise KeyError(f"{csv_path} has no column {column!r} (columns: {header})")
    at = {column: header.index(column) for column, _ in DOWNLOADS}
    return [{column: row[i] if i < len(row) else "" for column, i in at.items()}
            for row in rows[1:]]


def run_stage_1_download(config: EtudeConfig, timer=None, **_) -> None:
    logger.stage("Downloading raw audio")
    csv_path = Path(config.paths.dataset_csv)
    out_dir = Path(config.paths.raw_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    if not csv_path.exists():
        logger.error(f"dataset CSV not found: {csv_path}")
        sys.exit(1)

    failed = []
    for index, row in enumerate(read_song_ids(csv_path)):
        song_dir = out_dir / f"{index + 1:04d}"
        song_dir.mkdir(exist_ok=True)
        ok = True
        for column, name in DOWNLOADS:
            target = song_dir / name
            if target.exists():
                continue
            with maybe_span(timer, f"download {song_dir.name}: {name}"):
                ok = download_audio_from_url(YOUTUBE_URL + row[column], target) and ok
        if not ok:
            failed.append(song_dir.name)
    if failed:
        logger.warn(f"{len(failed)} downloads failed: {', '.join(failed[:10])}")


def run_stage_2_preprocess(config: EtudeConfig, device=None,
                           allow_random_weights: bool = False, timer=None) -> None:
    logger.stage("Preprocessing (transcription + beat grid)")
    raw_dir = Path(config.paths.raw_dir)
    processed_dir = Path(config.paths.processed_dir)
    processed_dir.mkdir(parents=True, exist_ok=True)

    paths = config.paths
    with maybe_span(timer, "preprocess: models"):
        transcriber = HFT_Transformer(config.hft, model_path=paths.hft_model, device=device,
                                      allow_random_weights=allow_random_weights)
        separator = SourceSeparator(model_path=paths.separator_model, device=device,
                                    allow_random_weights=allow_random_weights)
        detector = BeatDetector(config.beat_detector, model_path=paths.beat_detector_model,
                                device=device, allow_random_weights=allow_random_weights)
    analyzer = BeatAnalyzer()

    for song_dir in sorted(d for d in raw_dir.iterdir() if d.is_dir()):
        name = song_dir.name
        out_dir = processed_dir / name
        out_dir.mkdir(exist_ok=True)

        cover = song_dir / "cover.wav"
        transcription = out_dir / "transcription.json"
        if transcription.exists():
            logger.skip(f"{name}: transcription.json exists")
        elif not cover.exists():
            logger.warn(f"{name}: cover.wav missing; skipping transcription")
        else:
            try:
                with maybe_span(timer, f"preprocess {name}: transcription"):
                    transcriber.transcribe(cover, transcription, timer=timer)
            except Exception as exc:
                logger.error(f"{name}: transcription failed: {exc}")

        origin = song_dir / "origin.wav"
        tempo_path = out_dir / "tempo.json"
        if tempo_path.exists():
            logger.skip(f"{name}: tempo.json exists")
        elif not origin.exists():
            logger.warn(f"{name}: origin.wav missing; skipping beat grid")
        else:
            try:
                with maybe_span(timer, f"preprocess {name}: beat grid"):
                    features = separator.separate_features(origin, return_device=True)
                    beat_pred_path = out_dir / "beat_pred.json"
                    detector.detect(features, beat_pred_path)
                    tempo = analyzer.analyze(beat_pred_path)
                    analyzer.save_tempo_data(tempo, tempo_path)
            except Exception as exc:
                logger.error(f"{name}: beat grid failed: {exc}")


def run_stage_3_align_and_filter(config: EtudeConfig, device=None, timer=None,
                                 **_) -> None:
    logger.stage("Align & filter")
    raw_dir = Path(config.paths.raw_dir)
    processed_dir = Path(config.paths.processed_dir)
    synced_dir = Path(config.paths.aligned_dir)
    synced_dir.mkdir(parents=True, exist_ok=True)
    threshold = config.prepare.align.wp_std_threshold

    aligner = AudioAligner(device=device)
    metadata = []
    for song_dir in sorted(d for d in processed_dir.iterdir() if d.is_dir()):
        name = song_dir.name
        final_json = synced_dir / name / "cover.json"
        if final_json.exists():
            metadata.append({"dir_name": name, "status": "kept"})
            logger.skip(f"{name}: already aligned")
            continue

        origin = raw_dir / name / "origin.wav"
        cover = raw_dir / name / "cover.wav"
        beat_pred = song_dir / "beat_pred.json"
        transcription = song_dir / "transcription.json"
        if not all(p.exists() for p in (origin, cover, beat_pred, transcription)):
            logger.warn(f"{name}: missing inputs; skipping")
            continue

        with maybe_span(timer, f"align {name}"):
            align_result = aligner.align(origin, cover, song_dir, timer=timer)
        if not align_result:
            logger.warn(f"{name}: alignment failed")
            continue

        with open(beat_pred, "r", encoding="utf-8") as f:
            downbeats = json.load(f)["downbeat_pred"]
        time_map = create_time_map_from_downbeats(downbeats, align_result)
        wp_std = compute_wp_std(time_map)
        if wp_std > threshold:
            logger.info(f"{name}: filtered (WP-Std {wp_std:.3f} > {threshold})")
            continue

        with open(transcription, "r", encoding="utf-8") as f:
            notes = json.load(f)
        aligned = weakly_align(notes, time_map)
        final_json.parent.mkdir(exist_ok=True)
        with open(final_json, "w", encoding="utf-8") as f:
            json.dump(aligned, f, indent=4)
        metadata.append({"dir_name": name, "status": "kept", "wp_std": wp_std})

    with open(synced_dir / "metadata.json", "w", encoding="utf-8") as f:
        json.dump(metadata, f, indent=4)
    logger.success(f"aligned {len(metadata)} songs")


def run_stage_4_extract(config: EtudeConfig, device=None,
                        allow_random_weights: bool = False, timer=None) -> None:
    logger.stage("Extracting condition notes")
    raw_dir = Path(config.paths.raw_dir)
    synced_dir = Path(config.paths.aligned_dir)
    meta_path = synced_dir / "metadata.json"
    if not meta_path.exists():
        logger.error(f"metadata not found: {meta_path} (run stage 3 first)")
        sys.exit(1)
    with open(meta_path, "r", encoding="utf-8") as f:
        songs = json.load(f)

    extractor = AMTAPC_Extractor(
        config.extractor, model_path=config.paths.extractor_model, device=device,
        allow_random_weights=allow_random_weights)
    for info in songs:
        if info.get("status") != "kept":
            continue
        name = info["dir_name"]
        out_json = synced_dir / name / "extract.json"
        origin = raw_dir / name / "origin.wav"
        if out_json.exists():
            logger.skip(f"{name}: extract.json exists")
            continue
        if not origin.exists():
            logger.warn(f"{name}: origin.wav missing")
            continue
        with maybe_span(timer, f"extract {name}"):
            extractor.extract(origin, out_json)


def run_stage_5_tokenize(config: EtudeConfig, timer=None, **_) -> None:
    logger.stage("Tokenizing final dataset")
    synced_dir = Path(config.paths.aligned_dir)
    processed_dir = Path(config.paths.processed_dir)
    tokenized_dir = Path(config.paths.tokenized_dir)
    tokenized_dir.mkdir(parents=True, exist_ok=True)
    vocab_path = Path(config.paths.dataset_vocab)
    fmt = config.prepare.tokenize.save_format

    meta_path = synced_dir / "metadata.json"
    if not meta_path.exists():
        logger.error(f"metadata not found: {meta_path}")
        sys.exit(1)
    with open(meta_path, "r", encoding="utf-8") as f:
        songs = json.load(f)

    all_src, all_tgt, names = [], [], []
    for info in songs:
        if info.get("status") != "kept":
            continue
        name = info["dir_name"]
        tempo = processed_dir / name / "tempo.json"
        src = synced_dir / name / "extract.json"
        tgt = synced_dir / name / "cover.json"
        if not all(p.exists() for p in (tempo, src, tgt)):
            logger.warn(f"{name}: missing tokenization inputs")
            continue
        with maybe_span(timer, f"tokenize {name}"):
            src_events = TinyREMITokenizer(tempo).encode(src, with_grace_note=True)
            tgt_events = TinyREMITokenizer(tempo).encode(tgt, with_grace_note=True)
        if src_events and tgt_events:
            all_src.append(src_events)
            all_tgt.append(tgt_events)
            names.append(name)

    if not names:
        logger.error("no valid song pairs to tokenize")
        sys.exit(1)

    if vocab_path.exists():
        vocab = Vocab.load(vocab_path)
    else:
        vocab = Vocab()
        vocab.build_from_events(all_src + all_tgt)
        vocab.save(vocab_path)
        logger.info(f"vocabulary built: {len(vocab)} tokens → {vocab_path}")

    for i, _name in enumerate(names):
        subdir = tokenized_dir / f"{i + 1:04d}"
        subdir.mkdir(parents=True, exist_ok=True)
        vocab.save_id_sequence(all_src[i], subdir / f"{i + 1:04d}_src.{fmt}", fmt)
        vocab.save_id_sequence(all_tgt[i], subdir / f"{i + 1:04d}_tgt.{fmt}", fmt)
    logger.success(f"tokenized {len(names)} pairs → {tokenized_dir}")


RUNNERS = {
    "download": run_stage_1_download,
    "preprocess": run_stage_2_preprocess,
    "align": run_stage_3_align_and_filter,
    "extract": run_stage_4_extract,
    "tokenize": run_stage_5_tokenize,
}


def main(argv=None, timer: Optional[StageTimer] = None) -> int:
    """The CLI; `timer` (a StageTimer) records a span per stage and per
    song, for callers that read them (a summary is printed either way)."""
    parser = argparse.ArgumentParser(description="Data preparation pipeline (PyTorch port)")
    parser.add_argument("--config", type=str, default=None,
                        help="settings file (.json, or YAML with PyYAML)")
    parser.add_argument("--start-from", type=str, choices=STAGES, default="download")
    parser.add_argument("--run-only", type=str, choices=STAGES, default=None)
    parser.add_argument("--allow-random-weights", action="store_true",
                        help="proceed with random init when model checkpoints "
                             "are missing (smoke/testing only)")
    parser.add_argument("--device", type=str, default="cuda", choices=["cuda", "cpu"])
    args = parser.parse_args(argv)

    config = load_config(args.config)

    # Missing model checkpoints are a hard error: a dataset prepared with
    # randomly initialized transcription/beat models is silently worthless.
    stage_models = {
        "preprocess": [("hft transcriber", config.paths.hft_model),
                       ("separator", config.paths.separator_model),
                       ("beat detector", config.paths.beat_detector_model)],
        "extract": [("extractor", config.paths.extractor_model)],
    }
    start_idx = STAGES.index(args.start_from)
    will_run = [s for i, s in enumerate(STAGES)
                if i >= start_idx and (not args.run_only or args.run_only == s)]
    missing = [(n, p) for s in will_run for n, p in stage_models.get(s, [])
               if not Path(p).exists()]
    if missing and not args.allow_random_weights:
        for n, p in missing:
            logger.error(f"{n} checkpoint not found: {p}")
        logger.error(
            "refusing to prepare data with randomly initialized models; "
            "train checkpoints first (python -m etude_tpu_torch.train_aux) or "
            "pass --allow-random-weights to override"
        )
        return 1
    for n, p in missing:
        logger.warn(f"{n}: running with RANDOM weights ({p} missing)")

    device = resolve_device(args.device)
    timer = timer or StageTimer(device)
    with torch.no_grad():
        for stage in will_run:
            with timer.span(f"stage {stage}"):
                RUNNERS[stage](config, device=device,
                               allow_random_weights=args.allow_random_weights, timer=timer)
    timer.print_summary("Preparation timing")
    logger.success("data preparation finished")
    return 0


if __name__ == "__main__":
    sys.exit(main())
