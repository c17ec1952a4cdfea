"""Transcription of piano covers for dataset preparation (JAX counterpart:
etude_tpu/data/hft.py).

The extractor's hFT model (models/amt.py) run at the reference hFT's
settings (128-frame segments, min_value −80, onset threshold 0.75) in its
overlapping-stride mode: segment k's window starts k·n_stride frames
further, and only its central n_stride output frames are kept, so every
frame is predicted with context on both sides (reference
_transcript_stride:282-441).

On the device: the log-mel (ops/mel.py), the windows (strided views of one
margin-padded feature map, as the extractor gathers its segments), the
time-branch heads in groups of `segment_batch` windows, and the heads' wire
format (data/extractor.py `wire_format`); the stitching and the peak
picking run on the host.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, List, Optional, Union

import numpy as np
import torch

from ..config import HFTConfig
from ..models.amt import AMTConfig
from ..ops.mel import log_mel_spectrogram
from ..ops.peakpick import activations_to_notes
from ..utils import model_loader
from ..utils.audio import decode_audio
from ..utils.device import compute_dtype_for, resolve_device
from ..utils.logger import logger
from ..utils.midi import write_midi
from ..utils.profiling import maybe_span
from ..utils.torch_port import load_torch_amt_checkpoint
from ..weights import amt_from_jax, init_amt_params_np
from .extractor import widen_maps, wire_format


def hft_amt_config(config: HFTConfig) -> AMTConfig:
    """The model config of the HFT settings (JAX :34): the extractor's
    model widths, the HFT's segment and margin."""
    return AMTConfig(
        n_margin=config.input.margin_b,
        n_frame=config.input.num_frame,
        n_bin=config.feature.n_bins,
        n_note=config.midi.num_note,
        n_velocity=config.midi.num_velocity,
    )


class HFT_Transformer:
    """Cover audio → note transcription with stride stitching (JAX :44)."""

    def __init__(
        self,
        config: HFTConfig,
        model_path: Optional[Union[str, Path]] = None,
        params=None,
        segment_batch: int = 16,
        device=None,
        allow_random_weights: bool = False,
    ):
        """`params` (a JAX-layout numpy tree) wins over `model_path`, which
        may be a reference `.pth`/`.pt`/`.pkl` or a params-only export.
        Runs on CUDA unless `device` is the CPU."""
        self.config = config
        self.amt_config = hft_amt_config(config)
        self.segment_batch = segment_batch
        self.device = resolve_device(device)
        self.compute_dtype = compute_dtype_for(self.device)
        if params is None:
            params = model_loader.load_params(
                "hft transcriber", model_path,
                lambda seed: init_amt_params_np(self.amt_config, seed),
                allow_random_weights,
                reference=dict.fromkeys(
                    (".pth", ".pt", ".pkl"),
                    lambda path: load_torch_amt_checkpoint(path, self.amt_config)))
        self.model = amt_from_jax(params, self.amt_config, self.device)
        self.stats: Dict[str, int] = {}

    def _wav2feature(self, audio_path: Union[str, Path]) -> torch.Tensor:
        """Audio → log-mel [T, n_mels] f32 on the device (JAX :81)."""
        fc = self.config.feature
        wave, _ = decode_audio(audio_path, target_sr=fc.sr, mono=True)
        return log_mel_spectrogram(
            wave, sr=fc.sr, n_fft=fc.fft_bins, hop=fc.hop_sample,
            win_length=fc.window_length, n_mels=fc.mel_bins,
            log_offset=fc.log_offset, device=self.device,
        )

    @torch.inference_mode()
    def _transcript_stride(self, feature) -> Dict[str, np.ndarray]:
        """Overlapping-stride transcription keeping each segment's center
        (JAX :91).

        Segment k's input window starts at k·stride in the (margin+offset)-
        padded feature; output frames [offset, offset+stride) of its
        num_frame predictions map exactly onto original frames
        [k·stride, (k+1)·stride). The windows go through the model
        `segment_batch` at a time, the last group padded with windows of
        min_value, as in the JAX package."""
        ic = self.config.input
        stride = self.config.infer.n_stride
        num_frame = ic.num_frame
        offset = (num_frame - stride) // 2
        if not isinstance(feature, torch.Tensor):
            feature = torch.from_numpy(np.array(feature, dtype=np.float32))
        feature = feature.to(self.device, torch.float32)
        T, n_bin = feature.shape

        n_chunks = max(-(-T // stride), 1)
        front = ic.margin_b + offset
        back = (
            n_chunks * stride - T            # stride padding
            + (num_frame - offset - stride)  # rest of the final window
            + ic.margin_f
        )
        padded = torch.full((front + T + back, n_bin), ic.min_value,
                            dtype=torch.float32, device=self.device)
        padded[front:front + T] = feature
        win = ic.margin_b + num_frame + ic.margin_f
        windows = padded.unfold(0, win, stride)               # [n_chunks, n_bin, win]

        B = self.segment_batch
        n_groups = -(-n_chunks // B)
        self.stats.update(segments=n_chunks, groups=n_groups)
        chunks = []
        for g in range(n_groups):
            segs = windows[g * B:(g + 1) * B]
            if segs.shape[0] < B:
                segs = torch.cat([segs, torch.full((B - segs.shape[0], n_bin, win),
                                                   ic.min_value, device=self.device)])
            out = self.model(segs, self.compute_dtype)
            chunks.append(wire_format(out, ("time",)))
        maps = widen_maps([{k: torch.cat([c[k] for c in chunks]).cpu().numpy()
                            for k in chunks[0]}])

        # Keep the central [offset, offset+stride) of each segment.
        out = {}
        for key, v in maps.items():
            center = v[:, offset:offset + stride]          # [chunks(+pad), stride, ...]
            out[key] = center.reshape(-1, *v.shape[2:])[:T]
        return out

    def transcribe(
        self,
        input_wav_path: Union[str, Path],
        output_json_path: Union[str, Path],
        output_midi_path: Optional[Union[str, Path]] = None,
        timer=None,
    ) -> List[Dict]:
        """Audio → notes; writes the note JSON (and MIDI on request) (JAX
        :145). `timer` (a StageTimer) gets the spans "hft: wav→mel",
        "hft: forward" and "hft: peak picking"."""
        with maybe_span(timer, "hft: wav→mel"):
            feature = self._wav2feature(input_wav_path)
        with maybe_span(timer, "hft: forward"):
            maps = self._transcript_stride(feature)
        ic = self.config.infer
        hop_sec = self.config.feature.hop_sample / self.config.feature.sr
        with maybe_span(timer, "hft: peak picking"):
            notes = activations_to_notes(
                maps["onset_time"], maps["offset_time"], maps["mpe_time"],
                maps["velocity_time"],
                hop_sec=hop_sec,
                note_min=self.config.midi.note_min,
                thred_onset=ic.thred_onset,
                thred_offset=ic.thred_offset,
                thred_mpe=ic.thred_mpe,
            )
        self.stats.update(notes=len(notes))
        output_json_path = Path(output_json_path)
        output_json_path.parent.mkdir(parents=True, exist_ok=True)
        with open(output_json_path, "w", encoding="utf-8") as f:
            json.dump(
                [{k: n[k] for k in ("onset", "offset", "pitch", "velocity")}
                 for n in notes],
                f, ensure_ascii=False, indent=2,
            )
        if output_midi_path:
            write_midi(notes, output_midi_path)
        logger.debug(f"transcribed {len(notes)} notes → {output_json_path}")
        return notes
