"""Settings of the ported paths (Extract, Structuralize, Decode, decoder
training, data preparation, evaluation), as plain dataclasses.

Copied from the JAX package's pydantic schema (etude_tpu/config/schema.py:
EnvConfig's seed and compute dtype :19-25, MeshConfig :28-42, the paths
:46-68 (`checkpoints_dir` :47 holds `attr_prior/`), ExtractorConfig :71-125
with its five sections, BeatDetectorConfig :140 with its model config,
SeparatorConfig :154, HFTConfig :172-193, DecoderConfig :196-217,
PrepareConfig :221-232, TrainConfig :234-273 and EvalConfig :280-306),
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
class EnvConfig:
    seed: int = 1234
    # bf16 compute for the model matmuls; f32 masters either way.
    compute_dtype: str = "bfloat16"


@dataclasses.dataclass
class MeshConfig:
    """The training mesh (JAX schema :28-42): `data_parallel` ranks (one
    per card; -1 sizes the axis as the JAX CLI does, `train.
    data_parallel_size`), `model_parallel` (shards nothing, as in JAX:
    its ranks hold replicas), and `fsdp`, which shards the parameters and
    Adam moments over the data axis (parallel/train_step.py)."""

    data_axis: str = "data"
    model_axis: str = "model"
    # -1 = all available devices on the data axis.
    data_parallel: int = -1
    model_parallel: int = 1
    fsdp: bool = False


@dataclasses.dataclass
class PathConfig:
    """The JAX schema's paths, but for the four models' weights: the JAX
    package reads `checkpoints/<model>/latest.ckpt` (orbax), the port the
    params-only exports of the same trees in `checkpoints_torch/<model>`
    (written by the repository's `export_weights.py`)."""

    checkpoints_dir: Path = Path("checkpoints")
    extractor_model: Path = Path("checkpoints_torch/extractor")
    beat_detector_model: Path = Path("checkpoints_torch/beat_detector")
    separator_model: Path = Path("checkpoints_torch/separator")
    decoder_model: Path = Path("checkpoints_torch/decoder")
    decoder_config: Path = Path("checkpoints/decoder/etude_decoder_config.json")
    decoder_vocab: Path = Path("checkpoints/decoder/vocab.json")
    hft_model: Path = Path("checkpoints/hft_transformer/latest.ckpt")

    dataset_dir: Path = Path("dataset")
    raw_dir: Path = Path("dataset/raw")
    processed_dir: Path = Path("dataset/processed")
    aligned_dir: Path = Path("dataset/aligned")
    tokenized_dir: Path = Path("dataset/tokenized")
    dataset_vocab: Path = Path("dataset/vocab.json")
    dataset_csv: Path = Path("assets/dataset.csv")

    outputs_dir: Path = Path("outputs")
    train_output_dir: Path = Path("outputs/train")
    infer_output_dir: Path = Path("outputs/infer")
    eval_output_dir: Path = Path("outputs/evaluation")


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
class HFTInputConfig:
    margin_b: int = 32
    margin_f: int = 32
    num_frame: int = 128
    min_value: float = -80.0


@dataclasses.dataclass
class HFTInferConfig:
    mode: str = "combination"
    thred_mpe: float = 0.5
    thred_onset: float = 0.75
    thred_offset: float = 0.5
    n_stride: int = 32
    bpm: float = 120.0


@dataclasses.dataclass
class HFTConfig:
    """The transcriber of dataset preparation: the extractor's model at the
    reference hFT's settings (128-frame segments, stride 32)."""

    feature: ExtractorFeatureConfig = dataclasses.field(
        default_factory=ExtractorFeatureConfig)
    input: HFTInputConfig = dataclasses.field(default_factory=HFTInputConfig)
    midi: ExtractorMidiConfig = dataclasses.field(default_factory=ExtractorMidiConfig)
    infer: HFTInferConfig = dataclasses.field(default_factory=HFTInferConfig)


@dataclasses.dataclass
class DecoderConfig:
    hidden_size: int = 512
    num_hidden_layers: int = 8
    num_attention_heads: int = 8
    intermediate_size: int = 2048
    max_position_embeddings: int = 1024

    num_classes: int = 3
    num_attribute_bins: int = 3
    attribute_emb_dim: int = 64
    pad_class_id: int = 0
    attribute_pad_id: int = 0
    context_num_past_xy_pairs: int = 4

    temperature: float = 0.0
    top_p: float = 0.9
    max_output_tokens: int = 25600
    max_bar_token_limit: int = 512

    # Prompt-length buckets of the rebuild engine (`--engine rebuild`): a
    # bar's prompt is left-padded to the smallest bucket that holds it.
    prompt_buckets: List[int] = dataclasses.field(
        default_factory=lambda: [128, 256, 512, 1024])


@dataclasses.dataclass
class PrepareAlignConfig:
    wp_std_threshold: float = 1.0


@dataclasses.dataclass
class PrepareTokenizeConfig:
    save_format: str = "npy"


@dataclasses.dataclass
class PrepareConfig:
    align: PrepareAlignConfig = dataclasses.field(default_factory=PrepareAlignConfig)
    tokenize: PrepareTokenizeConfig = dataclasses.field(
        default_factory=PrepareTokenizeConfig)


@dataclasses.dataclass
class TrainConfig:
    run_id: str = ""
    resume_from_checkpoint: Optional[str] = None

    data_format: str = "npy"
    num_workers: int = 4

    batch_size: int = 8
    learning_rate: float = 2e-4
    weight_decay: float = 0.01
    adam_beta1: float = 0.9
    adam_beta2: float = 0.98
    num_epochs: int = 200
    # Fractional values are allowed (warmup_steps = steps_per_epoch * this).
    warmup_epochs: float = 10.0
    gradient_accumulation_steps: int = 4
    clip_grad_norm: float = 1.0
    scheduler: str = "cosine_with_warmup"
    max_seq_len: int = 1024

    save_every_n_epochs: int = 10

    # DAgger history from NNNN_hist.npy rollouts (data/dataset.py), used
    # for a chunk with probability dagger_history_prob.
    dagger_history: bool = False
    dagger_history_prob: float = 1.0
    # Probability of replacing a chunk's attribute bins by the neutral bin.
    attr_dropout: float = 0.0
    # Warm-start params from a params-only export (fresh optimizer and
    # schedule, unlike resume_from_checkpoint, which restores both).
    init_from: Optional[Path] = None


@dataclasses.dataclass
class EvalMetricsConfig:
    wpd_subsample_step: int = 1
    wpd_trim_seconds: int = 10
    rgc_top_k: int = 8
    ipe_n_gram: int = 8
    ipe_n_clusters: int = 16


@dataclasses.dataclass
class EvalConfig:
    eval_dir: Path = Path("docs/songs")
    metadata_path: Path = Path("docs/songs/metadata.json")
    report_image_filename: str = "evaluation_summary.png"
    report_csv_filename: str = "evaluation_results.csv"
    versions: Dict[str, str] = dataclasses.field(default_factory=lambda: {
        "human": "Human",
        "etude_e": "Etude Extractor",
        "etude_d_d": "Etude Decoder - Default",
        "etude_d": "Etude Decoder - Prompted",
        "picogen": "PiCoGen",
        "amtapc": "AMT-APC",
        "music2midi": "Music2MIDI",
    })
    metrics: EvalMetricsConfig = dataclasses.field(default_factory=EvalMetricsConfig)


@dataclasses.dataclass
class EtudeConfig:
    env: EnvConfig = dataclasses.field(default_factory=EnvConfig)
    mesh: MeshConfig = dataclasses.field(default_factory=MeshConfig)
    paths: PathConfig = dataclasses.field(default_factory=PathConfig)
    extractor: ExtractorConfig = dataclasses.field(default_factory=ExtractorConfig)
    beat_detector: BeatDetectorConfig = dataclasses.field(
        default_factory=BeatDetectorConfig)
    separator: SeparatorConfig = dataclasses.field(default_factory=SeparatorConfig)
    hft: HFTConfig = dataclasses.field(default_factory=HFTConfig)
    decoder: DecoderConfig = dataclasses.field(default_factory=DecoderConfig)
    prepare: PrepareConfig = dataclasses.field(default_factory=PrepareConfig)
    train: TrainConfig = dataclasses.field(default_factory=TrainConfig)
    eval: EvalConfig = dataclasses.field(default_factory=EvalConfig)


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


_SCALARS = {"int": int, "float": float, "str": str, "bool": bool}


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
        elif "Path" in str(fields[key].type):
            setattr(section, key, None if value is None else Path(value))
        elif current is None or value is None:
            setattr(section, key, value)  # an Optional field
        elif isinstance(current, list):
            setattr(section, key, [type(current[0])(v) for v in value])
        else:
            # The declared type, not the default's (a float field may have an
            # int default).
            cast = _SCALARS.get(str(fields[key].type), type(current))
            setattr(section, key, cast(value))


def load_config(path: Optional[Union[str, Path]] = None,
                overrides: Optional[Dict[str, Any]] = None) -> EtudeConfig:
    """Defaults, then the settings file (if named), then `overrides`."""
    config = EtudeConfig()
    if path is not None:
        _apply(config, _read_settings(Path(path)), "")
    if overrides:
        _apply(config, overrides, "")
    return config
