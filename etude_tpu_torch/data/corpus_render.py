"""Rendered-corpus training windows for the aux models' corpus modes (JAX
counterpart: etude_tpu/data/corpus_render.py).

The corpus is the reference's `docs/songs/<SONG>/<version>.mid`: piano
covers and performances of pop songs. Its MIDIs are rendered to 44.1 kHz
with the additive synth and sent through the serving signal chain (int16
WAV quantization, polyphase resample to the extractor's 16 kHz), so that
training windows see what serving sees.

`CORPUS_ROOT` is the corpus's `docs/songs` under the repository's root,
where the reference keeps it; `corpus_song_dirs()` reads it when it is
called, so a caller (a test, `chip_smoke.py`) may point it at another
corpus first. The song-level split keeps the eval songs (CPOP01 and every
8th song) out of every training pool, so full-path numbers on them are
held-out measurements.
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..utils.audio import resample_audio
from ..utils.midi import read_midi_notes
from .synthetic import AMT_SR, render_piano

CORPUS_ROOT = Path(__file__).resolve().parents[2] / "docs" / "songs"
RENDER_SR = 44100

# Corpus MIDI versions usable as piano ground truth (all are piano covers or
# performances; docs/songs/<SONG>/<version>.mid).
VERSIONS = (
    "human", "etude_d", "etude_d_d", "etude_e",
    "amtapc", "picogen", "music2midi",
)


def corpus_song_dirs(root: Optional[Path] = None) -> List[Path]:
    """Sorted song directories that contain a human.mid, under `root`
    (default: `CORPUS_ROOT` as it is at the call)."""
    root = Path(CORPUS_ROOT if root is None else root)
    if not root.exists():
        return []
    return sorted(d for d in root.iterdir()
                  if d.is_dir() and (d / "human.mid").exists())


def split_songs(
    dirs: Sequence[Path], n_eval: int = 12, pin_eval: Sequence[str] = ("CPOP01",)
) -> Tuple[List[Path], List[Path]]:
    """Deterministic song-level split: every 8th song (plus pinned names)
    goes to eval, the rest to train."""
    eval_dirs = [d for d in dirs if d.name in pin_eval]
    for i, d in enumerate(dirs):
        if len(eval_dirs) >= n_eval:
            break
        if i % 8 == 3 and d not in eval_dirs:
            eval_dirs.append(d)
    train_dirs = [d for d in dirs if d not in eval_dirs]
    return train_dirs, eval_dirs


class CorpusNotePool:
    """Lazily-parsed cache of corpus note lists, keyed by (song, version)."""

    def __init__(self, song_dirs: Sequence[Path],
                 versions: Sequence[str] = VERSIONS):
        self.entries: List[Tuple[Path, str]] = [
            (d, v) for d in song_dirs for v in versions
            if (d / f"{v}.mid").exists()
        ]
        if not self.entries:
            raise ValueError("no corpus MIDI files found")
        self._cache: Dict[Tuple[str, str], List[Dict]] = {}

    def notes(self, entry: Tuple[Path, str]) -> List[Dict]:
        d, v = entry
        key = (d.name, v)
        if key not in self._cache:
            self._cache[key] = read_midi_notes(d / f"{v}.mid")
        return self._cache[key]

    def sample_window(self, rng: np.random.Generator, dur: float) -> List[Dict]:
        """Random (song, version) → random `dur`-second window of its notes,
        times shifted so the window starts at 0. Notes still sounding at the
        window start are kept (their tails are audible); labels derived via
        amt_targets clip out-of-window marks naturally."""
        for _ in range(8):  # retry songs shorter than the window / empty cuts
            entry = self.entries[int(rng.integers(len(self.entries)))]
            notes = self.notes(entry)
            if not notes:
                continue
            song_end = max(n["offset"] for n in notes)
            if song_end <= dur + 1.0:
                t0 = 0.0
            else:
                t0 = float(rng.uniform(0.0, song_end - dur))
            cut = [
                {
                    "onset": n["onset"] - t0,
                    "offset": min(n["offset"] - t0, dur),
                    "pitch": n["pitch"],
                    "velocity": n["velocity"],
                }
                for n in notes
                if n["offset"] > t0 + 0.02 and n["onset"] < t0 + dur - 0.05
            ]
            if cut:
                return cut
        return []


def render_serving(notes: List[Dict], dur: float) -> np.ndarray:
    """Render through the serving signal chain: 44.1 kHz additive synth →
    int16 WAV quantization round-trip (save_wav/load_wav semantics) →
    polyphase resample to the extractor rate (16 kHz).

    Notes may start before t=0 (window-straddling sustain tails): rendering
    runs with a lead-in so their envelopes decay from the true onset, then
    the lead is cropped."""
    lead = max(0.0, -min((n["onset"] for n in notes), default=0.0))
    if lead > 0.0:
        notes = [dict(n, onset=n["onset"] + lead, offset=n["offset"] + lead)
                 for n in notes]
    wave = render_piano(notes, dur + lead, sr=RENDER_SR)
    wave = wave[int(round(lead * RENDER_SR)):]
    wave = (np.clip(wave, -1.0, 1.0) * 32767.0).astype(np.int16)
    wave = wave.astype(np.float32) / 32768.0
    return resample_audio(wave, RENDER_SR, AMT_SR)
