"""Stage-2 part 2: beat/downbeat detection (JAX counterpart:
etude_tpu/data/beat_detector.py).

One Beat-Transformer forward over the separated-stem features (bf16 on the
card, f32 on the CPU), sigmoid beat/downbeat activations handed to the host
in f16 as in the JAX package, then DBN decoding (the beat tracker on the
beat activation; the downbeat tracker on [max(beat − downbeat, 0),
downbeat]) and JSON output {beat_pred, downbeat_pred}.
"""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path
from typing import Dict, Optional, Union

import numpy as np
import torch
import torch.nn.functional as F

from ..config import BeatDetectorConfig
from ..models.beat_transformer import BeatTransformerConfig
from ..ops.dbn import DBNBeatTracker, DBNDownBeatTracker
from ..utils import model_loader
from ..utils.device import compute_dtype_for, resolve_device
from ..utils.logger import logger
from ..utils.profiling import maybe_span
from ..utils.torch_port import load_torch_beat_checkpoint
from ..weights import beat_transformer_from_jax, init_beat_params_np

FRAME_BUCKET = 2048


def beat_model_config_from(config: BeatDetectorConfig) -> BeatTransformerConfig:
    m = config.model
    return BeatTransformerConfig(
        attn_len=m.attn_len, instr=m.instr, ntoken=m.ntoken, dmodel=m.dmodel,
        nhead=m.nhead, d_hid=m.d_hid, nlayers=m.nlayers,
    )


class BeatDetector:
    """Separated-stem features → beat/downbeat timestamps."""

    def __init__(
        self,
        config: BeatDetectorConfig,
        model_path: Optional[Union[str, Path]] = None,
        params=None,
        device=None,
        allow_random_weights: bool = False,
    ):
        """`params` (a JAX-layout numpy tree) wins over `model_path`. Runs on
        CUDA unless `device` is the CPU."""
        self.config = config
        self.model_config = beat_model_config_from(config)
        self.device = resolve_device(device)
        self.compute_dtype = compute_dtype_for(self.device)

        def load_reference(path):
            # Reference weights were trained with the head-7 key-slice bug:
            # run them with it (JAX :60-76).
            self.model_config = dataclasses.replace(self.model_config,
                                                    compat_head7_bug=True)
            return load_torch_beat_checkpoint(path, self.model_config)

        if params is None:
            params = model_loader.load_params(
                "beat model", model_path,
                lambda seed: init_beat_params_np(self.model_config, seed),
                allow_random_weights,
                reference=dict.fromkeys((".pth", ".pt"), load_reference))
        self.model = beat_transformer_from_jax(params, self.model_config, self.device)

        fps = 44100 / config.fps_divisor
        self.beat_tracker = DBNBeatTracker(
            min_bpm=config.min_bpm, max_bpm=config.max_bpm, fps=fps,
            threshold=config.threshold,
        )
        self.downbeat_tracker = DBNDownBeatTracker(
            beats_per_bar=tuple(config.beats_per_bar),
            min_bpm=config.min_bpm, max_bpm=config.max_bpm, fps=fps,
            threshold=config.threshold,
        )

    @torch.inference_mode()
    def activations(self, features) -> np.ndarray:
        """[instr, T, mel] features (numpy or a tensor) → sigmoid activations
        [T, 2] f32 (rounded through f16).

        T is padded to a multiple of 2048 frames (silence = −80 dB), as in
        the JAX package, and the activations are trimmed back."""
        feats = torch.as_tensor(features, dtype=torch.float32, device=self.device)
        T = feats.shape[1]
        target = max(-(-T // FRAME_BUCKET) * FRAME_BUCKET, FRAME_BUCKET)
        if target > T:
            feats = F.pad(feats, (0, 0, 0, target - T), value=-80.0)
        logits, _ = self.model(feats[None], self.compute_dtype)
        act = torch.sigmoid(logits[0]).to(torch.float16)
        return act.float().cpu().numpy()[:T]

    def detect(
        self,
        features: Union[np.ndarray, torch.Tensor, str, Path],
        output_json_path: Optional[Union[str, Path]] = None,
        cleanup_input: bool = True,
        timer=None,
    ) -> Dict:
        """Features (an array, a device tensor, or the path of a `.npy` file
        that `SourceSeparator.separate_features` saved) → {beat_pred,
        downbeat_pred}. A `.npy` input is deleted afterwards unless
        `cleanup_input` is False (JAX :122-190)."""
        input_file = None
        if isinstance(features, (str, Path)):
            input_file = Path(features)
            features = np.load(input_file).astype(np.float32)
        with maybe_span(timer, "beat: forward"):
            act = self.activations(features)
        beat_act, down_act = act[:, 0], act[:, 1]

        with maybe_span(timer, "beat: DBN decode"):
            applied = None
            beats = self.beat_tracker(beat_act)
            if self.config.octave_disambiguation:
                from ..ops.beat_octave import disambiguate_octave

                beats, applied = disambiguate_octave(
                    np.asarray(beats, float), beat_act,
                    fps=44100 / self.config.fps_divisor,
                    min_bpm=self.config.min_bpm,
                    max_bpm=self.config.max_bpm,
                )
                if applied:
                    logger.debug(f"beat octave corrected: {applied}")
            combined = np.stack([np.maximum(beat_act - down_act, 0.0), down_act], axis=-1)
            downbeat_events = self.downbeat_tracker(combined)
        downbeats = (
            downbeat_events[downbeat_events[:, 1] == 1][:, 0]
            if downbeat_events.size else np.empty(0)
        )
        if applied and len(downbeats) and len(beats):
            # The downbeat tracker decoded the ORIGINAL activations; after an
            # octave correction its grid can disagree with the corrected
            # beats by a tempo octave. Snap each downbeat to the nearest
            # corrected beat so downbeats stay a subset of the beat grid.
            beats_arr = np.asarray(beats, float)
            idx = np.abs(beats_arr[None, :] - np.asarray(downbeats, float)[:, None]).argmin(axis=1)
            downbeats = np.unique(beats_arr[idx])

        results = {
            "beat_pred": np.asarray(beats, float).tolist(),
            "downbeat_pred": np.asarray(downbeats, float).tolist(),
        }
        if output_json_path is not None:
            output_json_path = Path(output_json_path)
            output_json_path.parent.mkdir(parents=True, exist_ok=True)
            with open(output_json_path, "w", encoding="utf-8") as f:
                json.dump(results, f, indent=4)
        if cleanup_input and input_file is not None and input_file.exists():
            input_file.unlink()
        return results
