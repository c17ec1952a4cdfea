"""Settings of the ported paths (Extract, Structuralize, Decode), as plain
dataclasses.

Copied from the JAX package's pydantic schema (etude_tpu/config/schema.py:
the model paths :46-53, ExtractorConfig :71-125 with its five sections,
BeatDetectorConfig :140 with its model config,
SeparatorConfig :154 and the DecoderConfig generation fields :196-216),
without pydantic: the port runs where neither pydantic nor PyYAML is
installed. A settings file is read only when the caller names one: a `.json`
file with the json module, anything else as YAML, which then needs PyYAML.
"""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path
from typing import Any, Dict, List, Optional, Union


@dataclasses.dataclass
class PathConfig:
    extractor_model: Path = Path("checkpoints/extractor/latest.ckpt")
    beat_detector_model: Path = Path("checkpoints/beat_detector/latest.ckpt")
    separator_model: Path = Path("checkpoints/separator/latest.ckpt")
    decoder_model: Path = Path("checkpoints/decoder/latest.ckpt")
    decoder_config: Path = Path("checkpoints/decoder/etude_decoder_config.json")
    decoder_vocab: Path = Path("checkpoints/decoder/vocab.json")
    infer_output_dir: Path = Path("outputs/infer")


@dataclasses.dataclass
class ExtractorFeatureConfig:
    sr: int = 16000
    hop_sample: int = 256
    mel_bins: int = 256
    n_bins: int = 256
    fft_bins: int = 2048
    window_length: int = 2048
    log_offset: float = 1e-8
    window: str = "hann"
    pad_mode: str = "constant"


@dataclasses.dataclass
class ExtractorInputConfig:
    margin_b: int = 32
    margin_f: int = 32
    num_frame: int = 512
    min_value: float = -18.0


@dataclasses.dataclass
class ExtractorMidiConfig:
    note_min: int = 21
    note_max: int = 108
    num_note: int = 88
    num_velocity: int = 128


@dataclasses.dataclass
class ExtractorModelConfig:
    cnn_channel: int = 4
    cnn_kernel: int = 5
    dropout: float = 0.1
    transformer_hid_dim: int = 256
    transformer_pf_dim: int = 512
    encoder_n_head: int = 4
    encoder_n_layer: int = 3
    decoder_n_head: int = 4
    decoder_n_layer: int = 3
    sv_dim: int = 24


@dataclasses.dataclass
class ExtractorInferConfig:
    onset_threshold: float = 0.5
    offset_threshold: float = 1.0
    frame_threshold: float = 0.5
    min_duration: float = 0.08
    # Segments of num_frame frames per forward.
    segment_batch: int = 8


@dataclasses.dataclass
class ExtractorConfig:
    feature: ExtractorFeatureConfig = dataclasses.field(
        default_factory=ExtractorFeatureConfig)
    input: ExtractorInputConfig = dataclasses.field(default_factory=ExtractorInputConfig)
    midi: ExtractorMidiConfig = dataclasses.field(default_factory=ExtractorMidiConfig)
    model: ExtractorModelConfig = dataclasses.field(default_factory=ExtractorModelConfig)
    infer: ExtractorInferConfig = dataclasses.field(default_factory=ExtractorInferConfig)


@dataclasses.dataclass
class BeatDetectorModelConfig:
    attn_len: int = 5
    instr: int = 5
    ntoken: int = 2
    dmodel: int = 256
    nhead: int = 8
    d_hid: int = 1024
    nlayers: int = 9
    norm_first: bool = True


@dataclasses.dataclass
class BeatDetectorConfig:
    min_bpm: float = 70.0
    max_bpm: float = 250.0
    fps_divisor: int = 1024
    threshold: float = 0.2
    beats_per_bar: List[int] = dataclasses.field(default_factory=lambda: [3, 4])
    # Tempo-octave disambiguation pass over the DBN output
    # (ops/beat_octave.py); off by default, as in the JAX package.
    octave_disambiguation: bool = False
    model: BeatDetectorModelConfig = dataclasses.field(
        default_factory=BeatDetectorModelConfig)


@dataclasses.dataclass
class SeparatorConfig:
    """Separation settings of the schema; the Structuralize stage runs the
    separator model's own defaults (models/separator.py), as in the JAX
    package."""

    sr: int = 44100
    n_fft: int = 4096
    hop: int = 1024
    num_stems: int = 5
    mel_bins: int = 128
    mel_fmin: float = 30.0
    mel_fmax: float = 11000.0
    base_channels: int = 24
    depth: int = 5
    freq_bins: int = 1024
    channel_cap: int = 192


@dataclasses.dataclass
class DecoderConfig:
    temperature: float = 0.0
    top_p: float = 0.9
    max_output_tokens: int = 25600
    max_bar_token_limit: int = 512


@dataclasses.dataclass
class EtudeConfig:
    paths: PathConfig = dataclasses.field(default_factory=PathConfig)
    extractor: ExtractorConfig = dataclasses.field(default_factory=ExtractorConfig)
    beat_detector: BeatDetectorConfig = dataclasses.field(
        default_factory=BeatDetectorConfig)
    separator: SeparatorConfig = dataclasses.field(default_factory=SeparatorConfig)
    decoder: DecoderConfig = dataclasses.field(default_factory=DecoderConfig)


def _read_settings(path: Path) -> Dict[str, Any]:
    text = path.read_text(encoding="utf-8")
    if path.suffix == ".json":
        return json.loads(text) or {}
    try:
        import yaml
    except ImportError as exc:
        raise RuntimeError(
            f"reading {path} needs PyYAML, which is not installed; "
            "pass a .json settings file instead"
        ) from exc
    return yaml.safe_load(text) or {}


def _apply(section, values: Dict[str, Any], where: str):
    fields = {f.name: f for f in dataclasses.fields(section)}
    for key, value in values.items():
        if key not in fields:
            continue  # settings of stages the port does not run yet
        current = getattr(section, key)
        if dataclasses.is_dataclass(current):
            if not isinstance(value, dict):
                raise ValueError(f"{where}{key} must be a mapping")
            _apply(current, value, f"{where}{key}.")
        elif isinstance(current, Path):
            setattr(section, key, Path(value))
        elif isinstance(current, list):
            setattr(section, key, [type(current[0])(v) for v in value])
        else:
            setattr(section, key, type(current)(value))


def load_config(path: Optional[Union[str, Path]] = None,
                overrides: Optional[Dict[str, Any]] = None) -> EtudeConfig:
    """Defaults, then the settings file (if named), then `overrides`."""
    config = EtudeConfig()
    if path is not None:
        _apply(config, _read_settings(Path(path)), "")
    if overrides:
        _apply(config, overrides, "")
    return config
