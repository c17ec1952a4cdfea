"""Piano-cover generation on one GPU, as far as it is ported:
`python -m etude_tpu_torch.infer --decode-only [--device cpu] ...`

The port of the repository's `infer.py`. Decode (:144-275, CLI :359-440)
reads the work-dir contract (`extract.json`, `tempo.json`, `volume.json`
under `<infer_output_dir>/temp`), tokenizes the condition, runs the streaming
engine and writes `<infer_output_dir>/<name>.mid` with the port's own
tokenizer and MIDI writer; `--sweep` decodes all 27 polyphony/rhythm/sustain
combinations as 27 streams on one card. Structuralize (:121-142) is
`InferencePipeline._run_stage2_structuralize(audio_path)`: audio →
separation features → beat activations → DBN → `beat_pred.json` and
`tempo.json` in the work dir. Extract, and with it the `--input` pipeline,
is not ported yet; nor are `--engine rebuild` and `--attrs-prior`.

It runs on CUDA unless `--device cpu` is given; with no GPU it raises rather
than carry on on the CPU. With no `--config`, the settings are the defaults
of `etude_tpu_torch.config`.
"""

from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path
from typing import Optional

import torch

from .config import EtudeConfig, load_config
from .data.beat_analyzer import BeatAnalyzer
from .data.beat_detector import BeatDetector
from .data.separation import SourceSeparator
from .data.tokenizer import TinyREMITokenizer, split_sequence_into_bars
from .data.vocab import Vocab
from .models.generate_stream import StreamingGenerationEngine
from .utils.device import resolve_device
from .utils.logger import logger
from .utils.model_loader import load_etude_decoder
from .utils.profiling import StageTimer

_INTERMEDIATES = ("extract.json", "tempo.json", "volume.json")


class InferencePipeline:
    """Audio → Structuralize outputs; work dir (Extract + Structuralize
    outputs) → piano-cover MIDI."""

    def __init__(self, config: EtudeConfig, device=None,
                 allow_random_weights: bool = False):
        self.config = config
        self.device = resolve_device(device)
        self.allow_random_weights = allow_random_weights
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

    def _run_stage2_structuralize(self, audio_path: Path) -> None:
        """Audio → `beat_pred.json` and `tempo.json` in the work dir; the
        separation features stay on the device for the beat model."""
        logger.stage("Structuralize: separation + beat grid")
        paths = self.config.paths
        logger.step("Source separation (in-process)")
        separator = SourceSeparator(model_path=paths.separator_model, device=self.device,
                                    allow_random_weights=self.allow_random_weights)
        features = separator.separate_features(audio_path, return_device=True,
                                               timer=self.timer)

        logger.step("Beat/downbeat detection")
        detector = BeatDetector(self.config.beat_detector,
                                model_path=paths.beat_detector_model, device=self.device,
                                allow_random_weights=self.allow_random_weights)
        detector.detect(features, self.work_dir / "beat_pred.json", timer=self.timer)

        logger.step("Tempo analysis")
        with self.timer.span("tempo: analysis"):
            analyzer = BeatAnalyzer()
            tempo = analyzer.analyze(self.work_dir / "beat_pred.json")
            analyzer.save_tempo_data(tempo, self.work_dir / "tempo.json")

    def _run_stage3_decode(self, target_attributes: dict, final_filename: str,
                           sweep: bool = False, seed: int = 0) -> None:
        logger.stage("Decode: conditional generation")
        t0 = time.perf_counter()
        paths = self.config.paths
        vocab = Vocab.load(paths.decoder_vocab)
        model, model_config = load_etude_decoder(
            paths.decoder_config, paths.decoder_model, device=self.device,
            allow_random_weights=self.allow_random_weights,
        )
        tokenizer = TinyREMITokenizer(tempo_path=self.work_dir / "tempo.json")
        condition_events = tokenizer.encode(self.work_dir / "extract.json")
        condition_ids = vocab.encode_sequence(condition_events)
        all_x_bars = split_sequence_into_bars(
            condition_ids, vocab.bar_bos_id, vocab.bar_eos_id
        )
        logger.info(f"prepared {len(all_x_bars)} condition bars "
                    f"({time.perf_counter() - t0:.2f} s)")
        if not all_x_bars:
            logger.warn("no condition bars; nothing to decode")
            return

        d = self.config.decoder
        engine = StreamingGenerationEngine(
            model_config,
            bar_bos_id=vocab.bar_bos_id,
            bar_eos_id=vocab.bar_eos_id,
            pad_id=vocab.pad_id,
            max_bar_token_limit=d.max_bar_token_limit,
        )
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

        t1 = time.perf_counter()
        bars = engine.generate(
            model, all_x_bars, [target_attributes] * len(all_x_bars),
            temperature=d.temperature, top_p=d.top_p,
            max_output_tokens=d.max_output_tokens, seed=seed, progress=True,
        )
        logger.info(f"generated {sum(len(b) for b in bars)} tokens in "
                    f"{time.perf_counter() - t1:.2f} s")
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

    def run(self, target_attributes: dict, final_filename: str = "output",
            sweep: bool = False, seed: int = 0) -> None:
        """Decode-only: the work dir's intermediates → MIDI."""
        logger.skip("stages 1 & 2 (decode-only mode)")
        self._require_weights("decode")
        for name in _INTERMEDIATES:
            if not (self.work_dir / name).exists():
                logger.error(f"missing intermediate '{name}' in {self.work_dir}")
                sys.exit(1)
        with torch.no_grad():
            self._run_stage3_decode(target_attributes, final_filename, sweep, seed)
        logger.success("inference pipeline finished")


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        description="Decode-only piano cover generation (PyTorch port)."
    )
    parser.add_argument("--config", type=str, default=None,
                        help="settings file (.json, or YAML with PyYAML)")
    parser.add_argument("--output_name", type=str, default="output")

    source = parser.add_mutually_exclusive_group(required=True)
    source.add_argument("--input", type=str,
                        help="path or URL of the source audio (needs Extract, "
                             "not yet ported)")
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
                     help="per-bar attribute bins from the trained predictor "
                          "(not yet ported)")
    gen.add_argument("--sweep", action="store_true",
                     help="decode all 27 attribute combinations (batched)")
    gen.add_argument("--engine", choices=["stream", "rebuild"], default="stream",
                     help="'stream' = persistent-KV engine; 'rebuild' is not "
                          "yet ported")
    gen.add_argument("--allow-random-weights", action="store_true",
                     help="proceed with random weights when the checkpoint "
                          "is missing (smoke runs and tests only)")
    args = parser.parse_args(argv)

    if args.engine != "stream":
        raise NotImplementedError("--engine rebuild is not yet ported to etude_tpu_torch")
    if args.attrs_prior:
        raise NotImplementedError("--attrs-prior is not yet ported to etude_tpu_torch")

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
    if not args.decode_only:
        raise NotImplementedError(
            "the full --input pipeline needs Extract, which is not yet "
            "ported to etude_tpu_torch; use --decode-only"
        )
    InferencePipeline(
        config, device=args.device,
        allow_random_weights=args.allow_random_weights,
    ).run(target_attributes, final_filename=args.output_name,
          sweep=args.sweep, seed=args.seed)
    return 0


if __name__ == "__main__":
    sys.exit(main())
