"""Piano-cover generation on one GPU:
`python -m etude_tpu_torch.infer --input song.wav|URL [--device cpu] ...` or
`... --decode-only ...`.

The port of the repository's `infer.py`. `--input` runs the whole pipeline
(`run` :283-352): a local file is copied into the work dir as `origin.wav`,
an http(s) URL is fetched there by `yt-dlp` (`utils/download.py`; it needs
`yt-dlp`, `ffmpeg` and the network, and without them the run exits 1), and
the audio is decoded once; Extract (audio → `extract.json`, :104-114),
Structuralize (audio → separation features → beat activations → DBN →
`beat_pred.json` and `tempo.json`, :121-142) and the volume map
(`volume.json`, :116-119) run as three concurrent threads, each on a CUDA
stream of its own, while a fourth makes the decoder; then Decode (:144-275) reads the work-dir
contract, tokenizes the condition, runs the generation engine and writes
`<infer_output_dir>/<name>.mid` with the port's own tokenizer and MIDI
writer. `--decode-only` runs Decode alone on the work dir's intermediates;
`--sweep` decodes all 27 polyphony/rhythm/sustain combinations as 27
streams batched on one card (the JAX CLI shards them over every device,
:212-219; `generate_batch(devices=...)` can spread them over cards, but
while a step is eager launches from one interpreter the spread is slower
than one card's batch). `--engine stream` (the default) is the persistent-KV
engine; `--engine rebuild` prefills every bar's prompt again (the
reference's exact semantics, :174-196). `--attrs-prior` conditions each bar
on the bins that the predictor in `<paths.checkpoints_dir>/attr_prior`
gives its source bar (:247-256). Reference `.pth`/`.pt`/`.pkl` weights load
from the model paths.

It runs on CUDA unless `--device cpu` is given; with no GPU it raises rather
than carry on on the CPU. With no `--config`, the settings are the defaults
of `etude_tpu_torch.config`. `ETUDE_TRACE_DIR` writes a `torch.profiler`
trace of the run there.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import contextlib
import shutil
import sys
from pathlib import Path
from typing import Optional
from urllib.parse import urlparse

import torch

from .config import EtudeConfig, load_config
from .data.beat_analyzer import BeatAnalyzer
from .data.beat_detector import BeatDetector
from .data.extractor import AMTAPC_Extractor
from .data.separation import SourceSeparator
from .data.tokenizer import TinyREMITokenizer, split_sequence_into_bars
from .data.vocab import Vocab
from .models.attr_prior import AttrPrior
from .models.generate import GenerationEngine
from .models.generate_stream import StreamingGenerationEngine
from .utils.audio import analyze_volume, decode_audio, save_volume_map
from .utils.device import resolve_device
from .utils.download import download_audio_from_url
from .utils.logger import logger
from .utils.model_loader import load_etude_decoder
from .utils.profiling import StageTimer, trace

_INTERMEDIATES = ("extract.json", "tempo.json", "volume.json")


class InferencePipeline:
    """Audio (file or URL) → piano-cover MIDI."""

    def __init__(self, config: EtudeConfig, device=None,
                 allow_random_weights: bool = False, engine_kind: str = "stream",
                 attrs_prior: bool = False):
        self.config = config
        self.device = resolve_device(device)
        self.allow_random_weights = allow_random_weights
        self.engine_kind = engine_kind
        self.attrs_prior = attrs_prior
        self.output_dir = Path(config.paths.infer_output_dir)
        self.work_dir = self.output_dir / "temp"
        self.output_dir.mkdir(parents=True, exist_ok=True)
        self.work_dir.mkdir(parents=True, exist_ok=True)
        self.timer = StageTimer(self.device)
        name = (torch.cuda.get_device_name(self.device)
                if self.device.type == "cuda" else "cpu")
        logger.info(f"Device: {self.device} ({name})")
        logger.info(f"Output directory: {self.output_dir.resolve()}")

    def _require_weights(self, *stages: str) -> None:
        """A missing checkpoint of a named stage is a hard error unless
        random weights are explicitly allowed (smoke runs and tests)."""
        paths = {
            "extract": [("extractor", self.config.paths.extractor_model)],
            "structuralize": [("separator", self.config.paths.separator_model),
                              ("beat detector", self.config.paths.beat_detector_model)],
            "decode": [("decoder", self.config.paths.decoder_model)],
        }
        missing = [(name, p) for stage in stages for name, p in paths[stage]
                   if not Path(p).exists()]
        if missing and not self.allow_random_weights:
            for name, p in missing:
                logger.error(f"{name} checkpoint not found: {p}")
            logger.error("refusing to run with randomly initialized weights; "
                         "pass --allow-random-weights to override")
            sys.exit(1)

    @contextlib.contextmanager
    def _stage_stream(self):
        """A CUDA stream of its own for a stage run on another thread, so
        that its spans synchronize its work only; a no-op on the CPU."""
        if self.device.type != "cuda":
            yield
            return
        stream = torch.cuda.Stream(self.device)
        with torch.cuda.stream(stream):
            yield
        stream.synchronize()

    def _timed(self, name: str, fn, *args):
        with self._stage_stream(), self.timer.span(name, nested=True):
            return fn(*args)

    def _prepare_audio(self, source: str) -> Path:
        """The input, downloaded or copied, in the work dir as `origin.wav`."""
        logger.step("Preparing source audio")
        local = self.work_dir / "origin.wav"
        if urlparse(source).scheme in ("http", "https"):
            if not download_audio_from_url(source, local):
                logger.error("audio download failed")
                sys.exit(1)
        elif Path(source).is_file():
            shutil.copy(source, local)
        else:
            logger.error(f"input '{source}' is neither a URL nor a local file")
            sys.exit(1)
        return local

    def _run_stage1_extract(self, audio_path: Path, wave_sr=None) -> None:
        """Audio → `extract.json` in the work dir."""
        logger.stage("Extract: audio → feature notes")
        extractor = AMTAPC_Extractor(
            self.config.extractor, model_path=self.config.paths.extractor_model,
            device=self.device, allow_random_weights=self.allow_random_weights)
        extractor.extract(audio_path, self.work_dir / "extract.json",
                          timer=self.timer, wave_sr=wave_sr)

    def _run_volume(self, audio_path: Path, wave_sr=None) -> None:
        """Audio → `volume.json` in the work dir (host only)."""
        with self.timer.span("extract: volume analysis", nested=True):
            volume = analyze_volume(audio_path, wave_sr=wave_sr)
            save_volume_map(volume, self.work_dir / "volume.json")

    def _load_decoder(self):
        with self._stage_stream():
            return load_etude_decoder(
                self.config.paths.decoder_config, self.config.paths.decoder_model,
                device=self.device, allow_random_weights=self.allow_random_weights)

    def _run_stage2_structuralize(self, audio_path: Path, wave_sr=None) -> None:
        """Audio → `beat_pred.json` and `tempo.json` in the work dir; the
        separation features stay on the device for the beat model."""
        logger.stage("Structuralize: separation + beat grid")
        paths = self.config.paths
        logger.step("Source separation (in-process)")
        separator = SourceSeparator(model_path=paths.separator_model, device=self.device,
                                    allow_random_weights=self.allow_random_weights)
        features = separator.separate_features(audio_path, return_device=True,
                                               timer=self.timer, wave_sr=wave_sr)

        logger.step("Beat/downbeat detection")
        detector = BeatDetector(self.config.beat_detector,
                                model_path=paths.beat_detector_model, device=self.device,
                                allow_random_weights=self.allow_random_weights)
        detector.detect(features, self.work_dir / "beat_pred.json", timer=self.timer)

        logger.step("Tempo analysis")
        with self.timer.span("tempo: analysis", nested=True):
            analyzer = BeatAnalyzer()
            tempo = analyzer.analyze(self.work_dir / "beat_pred.json")
            analyzer.save_tempo_data(tempo, self.work_dir / "tempo.json")

    def _run_stage3_decode(self, target_attributes: dict, final_filename: str,
                           sweep: bool = False, seed: int = 0, decoder=None) -> None:
        """The work dir's intermediates → MIDI; `decoder` is a (model,
        config) pair made beforehand, else it is loaded here."""
        logger.stage("Decode: conditional generation")
        with self.timer.span("decode: model load", nested=True):
            vocab = Vocab.load(self.config.paths.decoder_vocab)
            model, model_config = decoder or self._load_decoder()
        with self.timer.span("decode: tokenize condition", nested=True):
            tokenizer = TinyREMITokenizer(tempo_path=self.work_dir / "tempo.json")
            condition_events = tokenizer.encode(self.work_dir / "extract.json")
            condition_ids = vocab.encode_sequence(condition_events)
            all_x_bars = split_sequence_into_bars(
                condition_ids, vocab.bar_bos_id, vocab.bar_eos_id
            )
        logger.info(f"prepared {len(all_x_bars)} condition bars")
        if not all_x_bars:
            logger.warn("no condition bars; nothing to decode")
            return

        d = self.config.decoder
        if self.engine_kind == "stream":
            engine = StreamingGenerationEngine(
                model_config, bar_bos_id=vocab.bar_bos_id, bar_eos_id=vocab.bar_eos_id,
                pad_id=vocab.pad_id, max_bar_token_limit=d.max_bar_token_limit)
        else:
            engine = GenerationEngine(
                model_config, bar_bos_id=vocab.bar_bos_id, bar_eos_id=vocab.bar_eos_id,
                pad_id=vocab.pad_id, prompt_buckets=tuple(d.prompt_buckets),
                max_bar_token_limit=d.max_bar_token_limit)
        if sweep:
            combos = [
                {"polyphony_bin": p, "rhythm_intensity_bin": r, "sustain_bin": s,
                 "pitch_overlap_bin": target_attributes["pitch_overlap_bin"]}
                for p in range(3) for r in range(3) for s in range(3)
            ]
            logger.step(f"Batched sweep over {len(combos)} attribute combos")
            streams = engine.generate_batch(
                model, [all_x_bars] * len(combos),
                [[c] * len(all_x_bars) for c in combos],
                temperature=d.temperature, top_p=d.top_p,
                max_output_tokens=d.max_output_tokens, seed=seed, progress=True,
            )
            for combo, bars in zip(combos, streams):
                name = (f"{final_filename}_p{combo['polyphony_bin']}"
                        f"r{combo['rhythm_intensity_bin']}s{combo['sustain_bin']}")
                self._write_midi(vocab, tokenizer, bars, name, keep_empty=True)
            logger.success(f"sweep MIDI files saved to {self.output_dir}")
            return

        per_bar_attrs = [target_attributes] * len(all_x_bars)
        if self.attrs_prior:
            prior_path = Path(self.config.paths.checkpoints_dir) / "attr_prior"
            per_bar_attrs = AttrPrior.load(prior_path).predict_bins(all_x_bars, vocab,
                                                                    seed=seed)
            logger.info("per-bar attributes from the trained predictor")

        with self.timer.span("decode: generate", nested=True):
            bars = engine.generate(
                model, all_x_bars, per_bar_attrs,
                temperature=d.temperature, top_p=d.top_p,
                max_output_tokens=d.max_output_tokens, seed=seed, progress=True,
            )
        logger.info(f"generated {sum(len(b) for b in bars)} tokens")
        with self.timer.span("decode: detokenize+midi", nested=True):
            out = self._write_midi(vocab, tokenizer, bars, final_filename)
        if out is not None:
            logger.success(f"final MIDI saved to {out.resolve()}")

    def _write_midi(self, vocab, tokenizer, bars, name,
                    keep_empty: bool = False) -> Optional[Path]:
        """Writes `name`.mid; an empty sequence is skipped with a warning
        unless `keep_empty` (a sweep writes one file per combo, as the JAX
        package does)."""
        events = [e for bar in bars for e in vocab.decode_sequence_to_events(bar)]
        if not events and not keep_empty:
            logger.warn(f"{name}: model generated an empty sequence")
            return None
        notes = tokenizer.decode_to_notes(
            events, volume_map_path=self.work_dir / "volume.json"
        )
        out = self.output_dir / f"{name}.mid"
        TinyREMITokenizer.note_to_midi(notes, out)
        return out

    def _run_stages_1_2(self, audio_path: Path):
        """Extract, Structuralize and the volume map on three threads, each
        on a stream of its own, over one decode of the audio, while a fourth
        makes the decoder; returns the decoder (JAX `run` :296-339)."""
        with self.timer.span("audio decode"):
            wave_sr = decode_audio(audio_path, target_sr=None, mono=True)
        with self.timer.span("stage1+2_concurrent"), \
                concurrent.futures.ThreadPoolExecutor(4) as pool:
            stages = [
                pool.submit(self._timed, "stage1_extract", self._run_stage1_extract,
                            audio_path, wave_sr),
                pool.submit(self._timed, "stage2_structuralize",
                            self._run_stage2_structuralize, audio_path, wave_sr),
                pool.submit(self._run_volume, audio_path, wave_sr),
            ]
            decoder = pool.submit(self._load_decoder)
            for stage in stages:
                stage.result()
            return decoder.result()

    def run(self, audio_source: Optional[str], target_attributes: dict,
            final_filename: str = "output", decode_only: bool = False,
            sweep: bool = False, seed: int = 0) -> None:
        """Audio → MIDI, or with `decode_only` the work dir's intermediates
        → MIDI."""
        decoder = None
        with trace(), torch.no_grad():
            if not decode_only:
                self._require_weights("extract", "structuralize", "decode")
                decoder = self._run_stages_1_2(self._prepare_audio(audio_source))
            else:
                logger.skip("stages 1 & 2 (decode-only mode)")
                self._require_weights("decode")
                for name in _INTERMEDIATES:
                    if not (self.work_dir / name).exists():
                        logger.error(f"missing intermediate '{name}' in {self.work_dir}")
                        sys.exit(1)
            with self.timer.span("stage3_decode"):
                self._run_stage3_decode(target_attributes, final_filename, sweep, seed,
                                        decoder=decoder)
        self.timer.print_summary("Pipeline timing")
        logger.success("inference pipeline finished")


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        description="Piano cover generation on one GPU (PyTorch port)."
    )
    parser.add_argument("--config", type=str, default=None,
                        help="settings file (.json, or YAML with PyYAML)")
    parser.add_argument("--output_name", type=str, default="output")

    source = parser.add_mutually_exclusive_group(required=True)
    source.add_argument("--input", type=str,
                        help="path or http(s) URL of the source audio (WAV; "
                             "other formats need ffmpeg; a URL needs yt-dlp, "
                             "ffmpeg and the network)")
    source.add_argument("--decode-only", action="store_true",
                        help="reuse intermediates in the work dir")

    attrs = parser.add_argument_group("Target Attribute Controls")
    attrs.add_argument("--polyphony", type=int, default=1, choices=[0, 1, 2])
    attrs.add_argument("--rhythm", type=int, default=1, choices=[0, 1, 2])
    attrs.add_argument("--sustain", type=int, default=1, choices=[0, 1, 2])
    attrs.add_argument("--overlap", type=int, default=2, choices=[0, 1, 2])

    gen = parser.add_argument_group("Generation Parameters")
    gen.add_argument("--temperature", type=float, default=None)
    gen.add_argument("--top-p", type=float, default=None)
    gen.add_argument("--device", type=str, default="cuda", choices=["cuda", "cpu"])
    gen.add_argument("--seed", type=int, default=0)
    gen.add_argument("--attrs-prior", action="store_true",
                     help="per-bar attribute bins from the trained "
                          "source-conditioned predictor (<checkpoints_dir>/"
                          "attr_prior) instead of the fixed "
                          "--polyphony/--rhythm/--sustain combo")
    gen.add_argument("--sweep", action="store_true",
                     help="decode all 27 attribute combinations (batched)")
    gen.add_argument("--engine", choices=["stream", "rebuild"], default="stream",
                     help="decode engine: 'stream' = whole-song persistent-KV "
                          "engine; 'rebuild' = per-bar prompt rebuild (exact "
                          "reference semantics)")
    gen.add_argument("--allow-random-weights", action="store_true",
                     help="proceed with random weights when the checkpoint "
                          "is missing (smoke runs and tests only)")
    args = parser.parse_args(argv)

    overrides = {}
    if args.temperature is not None:
        overrides.setdefault("decoder", {})["temperature"] = args.temperature
    if args.top_p is not None:
        overrides.setdefault("decoder", {})["top_p"] = args.top_p
    config = load_config(args.config, overrides)

    target_attributes = {
        "polyphony_bin": args.polyphony,
        "rhythm_intensity_bin": args.rhythm,
        "sustain_bin": args.sustain,
        "pitch_overlap_bin": args.overlap,
    }
    InferencePipeline(
        config, device=args.device,
        allow_random_weights=args.allow_random_weights,
        engine_kind=args.engine, attrs_prior=args.attrs_prior,
    ).run(args.input, target_attributes, final_filename=args.output_name,
          decode_only=args.decode_only, sweep=args.sweep, seed=args.seed)
    return 0


if __name__ == "__main__":
    sys.exit(main())
