"""Synthetic training corpora for the three auxiliary models (own copy of
etude_tpu/data/synthetic.py: the beat scenes, the additive piano clips
with their hFT targets, the separation stems and the pseudo-pop audio
stems, with the held-out metrics).

Ground truth is exact by construction:

  * beat tracking  — procedural multi-stem scenes rendered to mel features
    with a known beat/downbeat grid (drums/bass pulse on the grid, melodic
    stems and distractor bursts off it);
  * transcription  — additive-synthesis piano clips rendered from random note
    lists, with onset/offset/frame/velocity label grids from the same notes;
  * separation     — five spectrally distinct stem magnitude tracks
    (vocals / piano / guitar / bass / drums) whose sum is the mixture.

The pseudo-pop audio stem renderers (`render_vocal`, `render_bass`,
`render_pad`, `render_drums`) make the five-stem mixtures of
data/pseudopop.py.

Given the same `np.random.Generator`, every function returns arrays
bit-equal to the JAX package's (tests/test_torch_synthetic.py,
tests/test_torch_corpus_data.py).
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np

from ..ops.mel import mel_filterbank

BEAT_FPS = 44100.0 / 1024.0          # beat-feature frame rate (sep contract)
AMT_SR = 16000                        # extractor sample rate
AMT_HOP = 256                         # extractor hop → fps 62.5
SEP_N_FFT = 4096
SEP_F = SEP_N_FFT // 2 + 1


# ===================================================================== beat
def _power_to_db_np(S: np.ndarray, top_db: float = 80.0,
                     amin: float = 1e-10) -> np.ndarray:
    """librosa power_to_db(ref=max) — the serving feature normalization
    (data/separation.py power_to_db)."""
    ref = max(float(S.max()), amin)
    log_spec = 10.0 * np.log10(np.maximum(amin, S))
    log_spec -= 10.0 * np.log10(ref)
    return np.maximum(log_spec, log_spec.max() - top_db)


def synth_beat_example(
    rng: np.random.Generator,
    T: int = 512,
    mel: int = 128,
    n_stems: int = 5,
    fps: float = BEAT_FPS,
    min_bpm: float = 70.0,
    max_bpm: float = 250.0,
) -> Dict[str, np.ndarray]:
    """One synthetic musical SCENE rendered straight to separated-stem
    magnitude spectrograms and pushed through the SERVING feature transform
    (slaney 30-11000 Hz mel + per-stem-max dB — data/separation.py).

    Earlier versions emitted sparse click-track bursts on a -80 dB floor;
    real separated features are dense harmonic sustains normalized to a 0 dB
    per-stem peak, and a model trained on clicks returned all-zero
    activations on real music. Scenes: piano chords comping on the grid,
    sustained guitar pads, bass pulses, optional drums (35% of clips are
    percussion-less), a free-running vocal glide as a distractor, and 5%
    cross-stem leakage imitating imperfect separation masks.

    Returns {x [stems, T, mel] f32 dB in [-80, 0], activations [T, 2],
    tempo int, beat_times [K], downbeat_times [K']}.
    """
    bpm = float(np.exp(rng.uniform(np.log(min_bpm), np.log(max_bpm))))
    period = 60.0 / bpm
    time_sig = int(rng.choice([3, 4], p=[0.25, 0.75]))
    phase = float(rng.uniform(0, period))
    down_offset = int(rng.integers(time_sig))

    dur = T / fps
    ks = np.arange(int(dur / period) + 2)
    beat_times = phase + ks * period
    keep = beat_times < dur - 1.0 / fps
    beat_times = beat_times[keep]
    is_down = (ks[: len(beat_times)] % time_sig) == down_offset
    down_times = beat_times[is_down]
    frames = np.round(beat_times * fps).astype(int)
    beat_len = max(int(round(period * fps)), 2)

    F = 1024  # <= 11 kHz band of the SEP_N_FFT rfft grid
    freqs = np.fft.rfftfreq(SEP_N_FFT, 1.0 / 44100.0)[:F].astype(np.float32)
    mag = np.zeros((n_stems, T, F), np.float32)

    drumless = rng.random() < 0.35

    def note_shape(pitch, n_h=6, width=12.0):
        f0 = 440.0 * 2.0 ** ((pitch - 69) / 12.0)
        return _harmonic_stack(freqs, f0, n_h, width)

    def add_event(stem, frame, shape, level, decay_frames):
        if frame < 0 or frame >= T:
            return
        L = min(max(int(decay_frames), 1), T - frame)
        env = (level * np.exp(
            -np.arange(L, dtype=np.float32) / max(decay_frames / 3.0, 1.0)
        )).astype(np.float32)
        mag[stem, frame:frame + L] += env[:, None] * shape[None, :]

    # Piano (stem 1): chords comping on the grid, re-voiced on downbeats,
    # stronger there; low root doubles in drumless clips.
    chord = None
    for fr, down in zip(frames, is_down):
        if drumless or rng.random() < 0.8:
            if down or chord is None or rng.random() < 0.4:
                root = int(rng.integers(48, 72))
                chord = [root, root + int(rng.choice([3, 4])), root + 7]
                if rng.random() < 0.5:
                    chord.append(root + 12)
            lvl = (1.0 if down else 0.55) * rng.uniform(0.7, 1.3)
            for pitch in chord:
                add_event(1, fr, note_shape(pitch), lvl * rng.uniform(0.7, 1.0),
                          beat_len + int(rng.integers(0, beat_len)))
            if drumless and rng.random() < 0.6:
                add_event(1, fr, note_shape(chord[0] - 12, n_h=5),
                          lvl * 0.8, beat_len)
        # Off-grid ornaments (syncopation distractors).
        if rng.random() < 0.4:
            add_event(1, fr + beat_len // 2,
                      note_shape(int(rng.integers(60, 90)), n_h=4),
                      0.3 * rng.uniform(0.5, 1.2), max(beat_len // 2, 2))

    # Guitar/other (stem 2): sustained pad chords re-voiced on downbeats.
    pad = None
    for fr, down in zip(frames, is_down):
        if down or pad is None:
            root = int(rng.integers(45, 65))
            pad = sum(note_shape(root + iv, n_h=5, width=18.0)
                      for iv in (0, 4, 7))
        if not drumless or rng.random() < 0.5:
            add_event(2, fr, pad, 0.35 * rng.uniform(0.6, 1.2),
                      beat_len * time_sig)

    # Bass (stem 3): low pulses on the beat (often absent in drumless clips).
    if not drumless or rng.random() < 0.4:
        for fr in frames:
            add_event(3, fr,
                      _harmonic_stack(freqs, float(rng.uniform(40, 110)), 4, 8.0),
                      0.8 * rng.uniform(0.6, 1.2), beat_len)

    # Vocals (stem 0): free-running glide phrase — NOT locked to the grid.
    f0 = float(rng.uniform(150, 380))
    tt = np.arange(T, dtype=np.float32)
    glide = f0 * (1 + 0.2 * np.sin(2 * np.pi * tt / float(rng.uniform(80, 200))))
    env = (rng.random(T) < 0.7).astype(np.float32)
    env = np.convolve(env, np.ones(15) / 15, mode="same") * 0.5
    for t in range(0, T, 2):
        if env[t] > 0.05:
            v = (env[t] * _harmonic_stack(freqs, glide[t], 8, 25.0)).astype(
                np.float32
            )
            mag[0, t] += v
            if t + 1 < T:
                mag[0, t + 1] += v

    # Drums (stem 4): kicks/snares on beats, off-beat hats.
    if not drumless:
        kick = np.exp(-freqs / 120.0).astype(np.float32)
        noise = ((freqs > 800) * np.exp(-freqs / 9000.0)).astype(np.float32)
        for fr, down in zip(frames, is_down):
            shape = kick if rng.random() < 0.6 else noise
            add_event(4, fr, shape, (1.6 if down else 1.0) * rng.uniform(0.7, 1.3), 4)
        for fr in frames:
            if rng.random() < 0.7:
                add_event(4, fr + beat_len // 2, noise,
                          0.35 * rng.uniform(0.6, 1.2), 3)

    # Cross-stem leakage (imperfect separation masks at serving).
    mix = mag.sum(axis=0)
    mag += 0.05 * mix[None]

    # SERVING transform: slaney mel power + per-stem-max dB.
    fb = mel_filterbank(44100, SEP_N_FFT, mel, fmin=30.0, fmax=11000.0,
                        norm="slaney", mel_scale="slaney")[:F]
    mel_power = np.einsum("stf,fm->stm", mag ** 2, fb)
    x = np.stack([_power_to_db_np(m) for m in mel_power]).astype(np.float32)

    act = np.zeros((T, 2), np.float32)
    for t, down in zip(beat_times, is_down):
        frame = int(round(t * fps))
        for d, w in ((-1, 0.5), (0, 1.0), (1, 0.5)):  # madmom-style widening
            f = frame + d
            if 0 <= f < T:
                act[f, 0] = max(act[f, 0], w)
                if down:
                    act[f, 1] = max(act[f, 1], w)

    return {
        "x": x,
        "activations": act,
        "tempo": np.int32(np.clip(round(bpm), 0, 299)),
        "beat_times": beat_times.astype(np.float32),
        "downbeat_times": down_times.astype(np.float32),
    }


def beat_batch(rng: np.random.Generator, batch: int, T: int = 512,
               mel: int = 128) -> Dict[str, np.ndarray]:
    ex = [synth_beat_example(rng, T=T, mel=mel) for _ in range(batch)]
    return {
        "x": np.stack([e["x"] for e in ex]),
        "activations": np.stack([e["activations"] for e in ex]),
        "tempo": np.stack([e["tempo"] for e in ex]),
    }


def beat_f_measure(est: np.ndarray, ref: np.ndarray,
                   tol: float = 0.07) -> float:
    """Standard beat-tracking F-measure (±70 ms window, 1-1 matching)."""
    if len(ref) == 0 or len(est) == 0:
        return 0.0
    used = np.zeros(len(ref), bool)
    tp = 0
    for t in est:
        d = np.abs(ref - t)
        d[used] = np.inf
        i = int(np.argmin(d))
        if d[i] <= tol:
            used[i] = True
            tp += 1
    precision = tp / len(est)
    recall = tp / len(ref)
    return 0.0 if tp == 0 else 2 * precision * recall / (precision + recall)


# ====================================================================== AMT
def synth_piano_notes(
    rng: np.random.Generator,
    dur: float,
    notes_per_sec: float = 3.0,
    pitch_lo: int = 30,
    pitch_hi: int = 100,
) -> List[Dict]:
    """Random piano-roll note list {onset, offset, pitch, velocity}."""
    n = max(int(rng.poisson(notes_per_sec * dur)), 1)
    notes = []
    for _ in range(n):
        onset = float(rng.uniform(0.05, dur - 0.2))
        length = float(rng.uniform(0.12, min(2.0, dur - onset - 0.05)))
        # Mid-keyboard-weighted pitch choice.
        pitch = int(np.clip(round(rng.normal(64, 15)), pitch_lo, pitch_hi))
        vel = int(rng.integers(30, 121))
        notes.append({"onset": onset, "offset": onset + length,
                      "pitch": pitch, "velocity": vel})
    notes.sort(key=lambda d: (d["onset"], d["pitch"]))
    # Drop same-pitch overlaps (the synth can't voice them separately).
    out: List[Dict] = []
    last_off: Dict[int, float] = {}
    for note in notes:
        if note["onset"] < last_off.get(note["pitch"], -1.0) + 0.05:
            continue
        last_off[note["pitch"]] = note["offset"]
        out.append(note)
    return out


def _add_seg(wave: np.ndarray, i0: int, seg: np.ndarray) -> None:
    """Mix `seg` into `wave` starting at sample `i0`, clipping both ends.

    A plain `wave[i0:i0+len(seg)] += seg[:len(wave)-i0]` breaks on the
    edges callers legitimately produce: an onset at/past the buffer end
    makes the slice length negative, and a jittered onset just before 0
    makes `i0` negative (Python wraps it to the buffer tail)."""
    if len(seg) == 0:
        return
    lo = max(i0, 0)
    hi = min(i0 + len(seg), len(wave))
    if hi <= lo:
        return
    wave[lo:hi] += seg[lo - i0:hi - i0]


def render_piano(notes: List[Dict], dur: float, sr: int = AMT_SR,
                 n_harmonics: int = 6) -> np.ndarray:
    """Additive-synthesis rendering: harmonics with exponential decay and a
    5 ms attack ramp — piano-like enough for mel-domain transcription."""
    wave = np.zeros(int(dur * sr) + 1, np.float32)
    for note in notes:
        f0 = 440.0 * 2.0 ** ((note["pitch"] - 69) / 12.0)
        amp = 0.25 * note["velocity"] / 127.0
        length = note["offset"] - note["onset"]
        t = np.arange(int(length * sr)) / sr
        tau = 0.2 + 200.0 / f0  # lower notes ring longer
        env = np.exp(-t / tau)
        env *= np.minimum(t / 0.005, 1.0)  # attack
        sig = np.zeros_like(t)
        for h in range(1, n_harmonics + 1):
            fh = f0 * h
            if fh >= sr / 2:
                break
            sig += (0.6 ** (h - 1)) * np.sin(2 * np.pi * fh * t)
        i0 = int(note["onset"] * sr)
        _add_seg(wave, i0, (amp * env * sig).astype(np.float32))
    peak = np.abs(wave).max()
    if peak > 1.0:
        wave /= peak
    return wave


# ==================================================== pseudo-pop audio stems
# Audio-domain stem renderers (JAX :312-419) for the pseudo-pop mixtures of
# data/pseudopop.py: corpus MIDI supplies the musical content (piano / bass /
# melody), synthetic drums ride the song's known beat grid, and a
# vocal-formant lead carries the top line.


def render_vocal(notes: List[Dict], dur: float, sr: int = 44100) -> np.ndarray:
    """Monophonic formant-weighted lead with 5.5 Hz vibrato and soft
    attack/release — a vocal-ish spectral envelope (bumps near 500/1600 Hz)
    rather than the piano's geometric harmonic rolloff."""
    wave = np.zeros(int(dur * sr) + 1, np.float32)
    for note in notes:
        f0 = 440.0 * 2.0 ** ((note["pitch"] - 69) / 12.0)
        amp = 0.30 * note["velocity"] / 127.0
        length = min(note["offset"] - note["onset"], dur - note["onset"])
        if length <= 0.02:
            continue
        t = np.arange(int(length * sr)) / sr
        vib = 1.0 + 0.006 * np.sin(2 * np.pi * 5.5 * t)
        env = np.minimum(t / 0.04, 1.0) * np.minimum((length - t) / 0.08, 1.0)
        env = np.clip(env, 0.0, 1.0)
        sig = np.zeros_like(t)
        phase = 2 * np.pi * f0 * np.cumsum(vib) / sr
        for h in range(1, 11):
            fh = f0 * h
            if fh >= sr / 2:
                break
            formant = (np.exp(-0.5 * ((fh - 500.0) / 250.0) ** 2)
                       + 0.7 * np.exp(-0.5 * ((fh - 1600.0) / 500.0) ** 2)
                       + 0.08)
            sig += formant * np.sin(phase * h)
        i0 = int(note["onset"] * sr)
        _add_seg(wave, i0, (amp * env * sig).astype(np.float32))
    return wave


def render_bass(notes: List[Dict], dur: float, sr: int = 44100) -> np.ndarray:
    """Near-sinusoidal sustained bass (fundamental + soft 2nd/3rd harmonic,
    mild tanh saturation) — spectrally disjoint from the piano stem."""
    wave = np.zeros(int(dur * sr) + 1, np.float32)
    for note in notes:
        f0 = 440.0 * 2.0 ** ((note["pitch"] - 69) / 12.0)
        amp = 0.35 * note["velocity"] / 127.0
        length = min(note["offset"] - note["onset"], dur - note["onset"])
        if length <= 0.02:
            continue
        t = np.arange(int(length * sr)) / sr
        env = np.minimum(t / 0.01, 1.0) * np.exp(-t / max(length, 0.3))
        sig = (np.sin(2 * np.pi * f0 * t)
               + 0.35 * np.sin(2 * np.pi * 2 * f0 * t)
               + 0.15 * np.sin(2 * np.pi * 3 * f0 * t))
        sig = np.tanh(1.5 * sig)
        i0 = int(note["onset"] * sr)
        _add_seg(wave, i0, (amp * env * sig).astype(np.float32))
    return wave


def render_pad(notes: List[Dict], dur: float, sr: int = 44100) -> np.ndarray:
    """Slow-attack sustained chord pad (1/h harmonic weights) — the
    'guitar' slot's sustained mid-register texture."""
    wave = np.zeros(int(dur * sr) + 1, np.float32)
    for note in notes:
        f0 = 440.0 * 2.0 ** ((note["pitch"] - 69) / 12.0)
        amp = 0.16 * note["velocity"] / 127.0
        length = min(note["offset"] - note["onset"], dur - note["onset"])
        if length <= 0.05:
            continue
        t = np.arange(int(length * sr)) / sr
        env = np.minimum(t / 0.12, 1.0) * np.clip(
            (length - t) / 0.15, 0.0, 1.0)
        sig = np.zeros_like(t)
        for h in range(1, 9):
            fh = f0 * h
            if fh >= sr / 2:
                break
            sig += (1.0 / h) * np.sin(2 * np.pi * fh * t)
        i0 = int(note["onset"] * sr)
        _add_seg(wave, i0, (amp * env * sig).astype(np.float32))
    return wave


def render_drums(beat_times: np.ndarray, down_times: np.ndarray, dur: float,
                 sr: int = 44100, seed: int = 0) -> np.ndarray:
    """Kick on beats (pitch-swept sine), snare off-downbeat beats
    (band-shaped noise), closed hats on 8ths (short high noise)."""
    rng = np.random.default_rng(seed)
    wave = np.zeros(int(dur * sr) + 1, np.float32)
    downs = set(np.round(np.asarray(down_times, float), 3))

    def add(t0: float, seg: np.ndarray) -> None:
        _add_seg(wave, int(t0 * sr), seg)

    beats = np.asarray(beat_times, float)
    for i, b in enumerate(beats):
        # Kick: 120→45 Hz sweep over 120 ms.
        t = np.arange(int(0.12 * sr)) / sr
        f_inst = 45.0 + 75.0 * np.exp(-t / 0.03)
        kick = 0.8 * np.exp(-t / 0.05) * np.sin(
            2 * np.pi * np.cumsum(f_inst) / sr)
        add(b, kick.astype(np.float32))
        # Snare on non-downbeat alternating beats.
        if round(b, 3) not in downs and i % 2 == 1:
            t = np.arange(int(0.09 * sr)) / sr
            noise = rng.standard_normal(len(t)).astype(np.float32)
            noise = np.diff(noise, prepend=0.0)       # high-pass tilt
            noise = np.convolve(noise, np.ones(8) / 8, mode="same")  # band
            body = 0.3 * np.exp(-t / 0.012) * np.sin(2 * np.pi * 190.0 * t)
            add(b, (0.5 * np.exp(-t / 0.03) * noise + body).astype(np.float32))
        # Hats on this beat and the following 8th.
        step = (beats[i + 1] - b) / 2 if i + 1 < len(beats) else 0.25
        for ht in (b, b + step):
            t = np.arange(int(0.03 * sr)) / sr
            noise = rng.standard_normal(len(t)).astype(np.float32)
            noise = np.diff(np.diff(noise, prepend=0.0), prepend=0.0)
            add(ht, (0.12 * np.exp(-t / 0.008) * noise).astype(np.float32))
    return wave


def amt_targets(
    notes: List[Dict],
    T: int,
    fps: float = AMT_SR / AMT_HOP,
    n_note: int = 88,
    note_min: int = 21,
) -> Dict[str, np.ndarray]:
    """Note list → hFT supervision grids (onset/offset sharpness-weighted at
    the two nearest frames, frame-level MPE, velocity class at sounding
    frames)."""
    onset = np.zeros((T, n_note), np.float32)
    offset = np.zeros((T, n_note), np.float32)
    mpe = np.zeros((T, n_note), np.float32)
    velocity = np.zeros((T, n_note), np.int32)
    for note in notes:
        j = note["pitch"] - note_min
        if not 0 <= j < n_note:
            continue

        def mark(grid, tsec):
            f = tsec * fps
            f0, frac = int(np.floor(f)), f - np.floor(f)
            if 0 <= f0 < T:
                grid[f0, j] = max(grid[f0, j], 1.0 - frac)
            if 0 <= f0 + 1 < T:
                grid[f0 + 1, j] = max(grid[f0 + 1, j], frac)

        mark(onset, note["onset"])
        mark(offset, note["offset"])
        a = int(np.round(note["onset"] * fps))
        b = int(np.round(note["offset"] * fps))
        mpe[max(a, 0):min(b + 1, T), j] = 1.0
        velocity[max(a, 0):min(b + 1, T), j] = note["velocity"]
    return {"onset": onset, "offset": offset, "mpe": mpe, "velocity": velocity}


# =============================================================== separation
def _harmonic_stack(freqs: np.ndarray, f0: float, n_h: int, width: float,
                    rolloff: float = 0.7) -> np.ndarray:
    """Gaussian bumps at the first n_h harmonics of f0 over the bin grid."""
    out = np.zeros_like(freqs)
    for h in range(1, n_h + 1):
        out += (rolloff ** (h - 1)) * np.exp(
            -0.5 * ((freqs - f0 * h) / width) ** 2
        )
    return out


def synth_separation_example(
    rng: np.random.Generator,
    T: int = 256,
    F: int = SEP_F,
    sr: int = 44100,
    n_fft: int = SEP_N_FFT,
) -> Dict[str, np.ndarray]:
    """Five spectrally distinct stem magnitude tracks + their sum.

    Stem order matches the pipeline contract (vocals, piano, guitar, bass,
    drums). Returns {mix_mag [T, F], stem_mags [5, T, F]} (f32, linear mag).
    """
    freqs = np.fft.rfftfreq(n_fft, 1.0 / sr)[:F].astype(np.float32)
    tt = np.arange(T, dtype=np.float32)
    stems = np.zeros((5, T, F), np.float32)

    # Vocals: gliding f0 with vibrato, phrase on/off envelope.
    f0 = float(rng.uniform(150, 380))
    glide = f0 * (1 + 0.2 * np.sin(2 * np.pi * tt / rng.uniform(80, 200)))
    vib = 1 + 0.01 * np.sin(2 * np.pi * tt / 8.0)
    env = (rng.random(T) < 0.8).astype(np.float32)
    env = np.convolve(env, np.ones(9) / 9, mode="same")
    for t in range(T):
        stems[0, t] = env[t] * _harmonic_stack(freqs, glide[t] * vib[t], 8, 25.0)

    # Piano: decaying harmonic events.
    for _ in range(int(rng.integers(6, 14))):
        t0 = int(rng.integers(0, T - 4))
        p_f0 = 440.0 * 2.0 ** ((rng.integers(40, 88) - 69) / 12.0)
        length = int(rng.integers(8, 40))
        shape = _harmonic_stack(freqs, p_f0, 6, 15.0)
        dec = np.exp(-np.arange(length) / (length / 3.0)).astype(np.float32)
        for d in range(min(length, T - t0)):
            stems[1, t0 + d] += dec[d] * shape

    # Guitar: sustained mid-register chords (2–3 simultaneous stacks).
    for _ in range(int(rng.integers(3, 7))):
        t0 = int(rng.integers(0, T - 10))
        length = int(rng.integers(30, 90))
        chord = sum(
            _harmonic_stack(
                freqs, 440.0 * 2.0 ** ((rng.integers(45, 70) - 69) / 12.0),
                5, 18.0,
            )
            for _ in range(int(rng.integers(2, 4)))
        )
        stems[2, t0:t0 + length] += 0.6 * chord[None, :]

    # Bass: low f0, note changes on a slow grid.
    t0 = 0
    while t0 < T:
        length = int(rng.integers(20, 60))
        b_f0 = float(rng.uniform(40, 120))
        stems[3, t0:t0 + length] += _harmonic_stack(freqs, b_f0, 4, 8.0)[None, :]
        t0 += length

    # Drums: broadband hits (snare/hat) + low kicks, fast decay.
    kick_shape = np.exp(-freqs / 120.0).astype(np.float32)
    noise_shape = (freqs > 800).astype(np.float32) * np.exp(-freqs / 9000.0)
    for _ in range(int(rng.integers(15, 40))):
        t0 = int(rng.integers(0, T - 3))
        shape = kick_shape if rng.random() < 0.4 else noise_shape
        lvl = float(rng.uniform(0.5, 1.5))
        for d, dec in enumerate((1.0, 0.35, 0.1)):
            if t0 + d < T:
                stems[4, t0 + d] += lvl * dec * shape

    # Per-stem loudness variation; drums/bass kept audible.
    gains = rng.uniform(0.4, 1.2, size=5).astype(np.float32)
    stems *= gains[:, None, None]
    mix = stems.sum(axis=0)
    return {"mix_mag": mix, "stem_mags": stems}


def separation_batch(rng: np.random.Generator, batch: int, T: int = 256,
                     F: int = SEP_F) -> Dict[str, np.ndarray]:
    ex = [synth_separation_example(rng, T=T, F=F) for _ in range(batch)]
    return {
        "mix_mag": np.stack([e["mix_mag"] for e in ex]),
        "stem_mags": np.stack([e["stem_mags"] for e in ex]),
    }


def stem_sdr(est: np.ndarray, ref: np.ndarray, eps: float = 1e-8) -> np.ndarray:
    """Per-stem magnitude-domain SDR in dB: est/ref [S, T, F]."""
    num = (ref ** 2).sum(axis=(1, 2))
    den = ((ref - est) ** 2).sum(axis=(1, 2))
    return 10.0 * np.log10((num + eps) / (den + eps))
