"""Stage 1, Extract: audio → note events through the hFT transcriber (JAX
counterpart: etude_tpu/data/extractor.py).

Log-mel on the device (ops/mel.py) → margin-padded segments of n_frame
frames, gathered on the device in groups of `segment_batch` → the model's
time-branch heads → peak-picked notes → `extract.json` (and MIDI on
request), with the reference's thresholds and minimum duration. The heads
leave the device as the JAX package ships them: clipped logits in f16 and
velocity argmaxes in uint8; the peak picker sees the sigmoids of those f16
values.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from ..config import ExtractorConfig
from ..models.amt import HEADS, AMTConfig
from ..ops.mel import log_mel_spectrogram
from ..ops.peakpick import activations_to_notes
from ..utils import model_loader
from ..utils.audio import decode_audio, resample_audio
from ..utils.device import compute_dtype_for, resolve_device
from ..utils.logger import logger
from ..utils.midi import write_midi
from ..utils.profiling import maybe_span
from ..utils.torch_port import load_torch_amt_checkpoint
from ..weights import amt_from_jax, init_amt_params_np

LOGIT_CLIP = 18.0


def amt_config_from(config: ExtractorConfig, n_frame: Optional[int] = None) -> AMTConfig:
    """The model config of the extractor settings (JAX :34)."""
    if config.input.margin_b != config.input.margin_f:
        # Segments are margin_b + frames + margin_b wide; an asymmetric
        # margin would read past the end of each window.
        raise ValueError(
            f"asymmetric margins unsupported: margin_b={config.input.margin_b} "
            f"!= margin_f={config.input.margin_f}"
        )
    m = config.model
    return AMTConfig(
        n_margin=config.input.margin_b,
        n_frame=n_frame or config.input.num_frame,
        n_bin=config.feature.n_bins,
        cnn_channel=m.cnn_channel,
        cnn_kernel=m.cnn_kernel,
        hid_dim=m.transformer_hid_dim,
        encoder_n_layer=m.encoder_n_layer,
        encoder_n_head=m.encoder_n_head,
        decoder_n_layer=m.decoder_n_layer,
        decoder_n_head=m.decoder_n_head,
        pf_dim=m.transformer_pf_dim,
        n_note=config.midi.num_note,
        n_velocity=config.midi.num_velocity,
    )


def wire_format(out: Dict[str, torch.Tensor], branches: Tuple[str, ...]
                ) -> Dict[str, torch.Tensor]:
    """The heads as they leave the device (JAX `_transcribe_batch_impl`
    :76): the sigmoids as logits log(p) − log1p(−p) clipped to ±18 and
    rounded to f16 (f16 sigmoids would saturate to 1.0 and make plateaus of
    distinct peaks), velocities as their argmax in uint8."""
    result = {}
    for branch in branches:
        for head in HEADS:
            p = out[f"{head}_{branch}"]
            logit = torch.log(p) - torch.log1p(-p)
            result[f"{head}_{branch}"] = logit.clamp(-LOGIT_CLIP, LOGIT_CLIP).half()
        result[f"velocity_{branch}"] = out[f"velocity_{branch}"].argmax(-1).to(torch.uint8)
    return result


def widen_maps(chunks: List[Dict[str, np.ndarray]]) -> Dict[str, np.ndarray]:
    """Concatenate the groups' outputs and widen the wire format: f16
    logits → f32 sigmoids, uint8 velocities → int32 (JAX :134)."""
    maps = {}
    for k in chunks[0]:
        v = np.concatenate([c[k] for c in chunks], axis=0)
        if k.startswith("velocity"):
            maps[k] = v.astype(np.int32)
        else:
            maps[k] = 1.0 / (1.0 + np.exp(-v.astype(np.float32)))
    return maps


class AMTAPC_Extractor:
    """Audio → notes (JAX :148)."""

    def __init__(
        self,
        config: ExtractorConfig,
        model_path: Optional[Union[str, Path]] = None,
        params=None,
        segment_batch: Optional[int] = None,
        device=None,
        allow_random_weights: bool = False,
    ):
        """`params` (a JAX-layout numpy tree) wins over `model_path`. Runs on
        CUDA unless `device` is the CPU."""
        self.config = config
        self.amt_config = amt_config_from(config)
        self.segment_batch = segment_batch or config.infer.segment_batch
        self.device = resolve_device(device)
        self.compute_dtype = compute_dtype_for(self.device)
        if params is None:
            params = model_loader.load_params(
                "extractor", model_path,
                lambda seed: init_amt_params_np(self.amt_config, seed),
                allow_random_weights,
                reference=dict.fromkeys(
                    (".pth", ".pt", ".pkl"),
                    lambda path: load_torch_amt_checkpoint(path, self.amt_config)))
        self.model = amt_from_jax(params, self.amt_config, self.device)
        self.stats: Dict[str, int] = {}

    # ---- steps ---------------------------------------------------------
    def _wav2feature(self, audio_path: Union[str, Path, None], wave_sr=None,
                     timer=None) -> torch.Tensor:
        """Audio → log-mel [T, n_mels] f32 on the device (JAX :188)."""
        fc = self.config.feature
        with maybe_span(timer, "extract: resample"):
            if wave_sr is not None:
                wave, native_sr = wave_sr
                wave = resample_audio(wave, native_sr, fc.sr)
            else:
                wave, _ = decode_audio(audio_path, target_sr=fc.sr, mono=True)
        return log_mel_spectrogram(
            wave, sr=fc.sr, n_fft=fc.fft_bins, hop=fc.hop_sample,
            win_length=fc.window_length, n_mels=fc.mel_bins,
            log_offset=fc.log_offset, device=self.device,
        )

    def _segment(self, feature: np.ndarray) -> Tuple[np.ndarray, int]:
        """[T, n_bin] → ([n_segments, n_bin, margin+num_frame+margin], T)
        on the host (JAX :209)."""
        ic = self.config.input
        n_frame, n_bin = self.amt_config.n_frame, self.amt_config.n_bin
        T = feature.shape[0]
        n_seg = max(-(-T // n_frame), 1)
        full = np.full((ic.margin_b + n_seg * n_frame + ic.margin_f, n_bin),
                       ic.min_value, dtype=np.float32)
        full[ic.margin_b:ic.margin_b + T] = feature
        segs = np.stack([
            full[i * n_frame: i * n_frame + ic.margin_b + n_frame + ic.margin_f].T
            for i in range(n_seg)
        ])
        return segs, T

    @torch.inference_mode()
    def _transcript(self, feature, branches: Tuple[str, ...] = ("time",)
                    ) -> Dict[str, np.ndarray]:
        """Every segment through the model, `segment_batch` at a time, and
        the maps stitched [n_seg · n_frame, n_note] (JAX :227).

        `feature` [T, n_bin] (host or device) gets a margin-padded copy on
        the device, filled with min_value; each group's segments are strided
        views of it. The last group is padded to `segment_batch` segments
        and those rows are dropped. (The JAX package also rounds the group
        count up to a few sizes so that songs share compiled programs.) The
        maps stay padded to the segment boundary, not trimmed to T: the
        reference peak-picks them so (etude/data/extractor.py:210-248), and
        the last note's fallback offset depends on it."""
        ic = self.config.input
        n_frame = self.amt_config.n_frame
        if not isinstance(feature, torch.Tensor):
            feature = torch.from_numpy(np.array(feature, dtype=np.float32))
        feature = feature.to(self.device, torch.float32)
        T, n_bin = feature.shape
        n_seg = max(-(-T // n_frame), 1)
        B = self.segment_batch
        n_groups = -(-n_seg // B)
        self.stats.update(segments=n_seg, groups=n_groups)

        padded = torch.full((ic.margin_b + n_groups * B * n_frame + ic.margin_f, n_bin),
                            ic.min_value, dtype=torch.float32, device=self.device)
        padded[ic.margin_b:ic.margin_b + T] = feature
        win = 2 * ic.margin_b + n_frame
        chunks = []
        for g in range(n_groups):
            window = padded[g * B * n_frame: g * B * n_frame + (B - 1) * n_frame + win]
            spec = window.unfold(0, win, n_frame)            # [B, n_bin, win]
            out = self.model(spec, self.compute_dtype)
            chunks.append(wire_format(out, branches))
        stacked = {k: torch.cat([c[k] for c in chunks]).cpu().numpy() for k in chunks[0]}
        maps = widen_maps([stacked])
        return {k: v.reshape(-1, *v.shape[2:])[:n_seg * n_frame] for k, v in maps.items()}

    def _mpe2note(self, maps: Dict[str, np.ndarray], branch: str = "time") -> List[Dict]:
        ic = self.config.infer
        return activations_to_notes(
            maps[f"onset_{branch}"], maps[f"offset_{branch}"],
            maps[f"mpe_{branch}"], maps[f"velocity_{branch}"],
            hop_sec=self.config.feature.hop_sample / self.config.feature.sr,
            note_min=self.config.midi.note_min,
            thred_onset=ic.onset_threshold,
            thred_offset=ic.offset_threshold,
            thred_mpe=ic.frame_threshold,
        )

    # ---- public API ----------------------------------------------------
    def extract(self, audio_path: Union[str, Path, None],
                output_json_path: Union[str, Path],
                output_midi_path: Optional[Union[str, Path]] = None,
                timer=None, wave_sr=None) -> List[Dict]:
        """Transcribe audio; write the note JSON (and MIDI on request).
        `wave_sr=(wave, native_sr)` reuses a decoded waveform."""
        with maybe_span(timer, "extract: wav→mel"):
            feature = self._wav2feature(audio_path, wave_sr=wave_sr, timer=timer)
        with maybe_span(timer, "extract: hFT forward"):
            maps = self._transcript(feature)
        # The refined time-branch heads, as the reference uses
        # (etude/data/extractor.py:161).
        with maybe_span(timer, "extract: peak picking"):
            notes = self._mpe2note(maps, branch="time")

        min_dur = self.config.infer.min_duration
        kept = [n for n in notes if n["offset"] - n["onset"] >= min_dur]
        filtered = [{k: n[k] for k in ("onset", "offset", "pitch", "velocity")}
                    for n in kept]
        self.stats.update(notes_picked=len(notes), notes_kept=len(filtered))
        output_json_path = Path(output_json_path)
        output_json_path.parent.mkdir(parents=True, exist_ok=True)
        with open(output_json_path, "w", encoding="utf-8") as f:
            json.dump(filtered, f, ensure_ascii=False, indent=2)
        logger.info(f"extracted {len(filtered)} notes ({len(notes)} picked) → "
                    f"{output_json_path}")
        if output_midi_path:
            write_midi(kept, output_midi_path)
        return filtered
