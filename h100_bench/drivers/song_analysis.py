"""Song analysis: one client sends whole songs through Extract and
Structuralize, one after another.

Each request is one `InferencePipeline._run_stages_1_2` of the port on a
song file (Extract, Structuralize and the volume map on three threads, each
on a CUDA stream of its own, while a fourth loads the decoder), with the
shipped models from the configuration's paths. At set-up the seed renders
`songs` grid songs (tempo drawn from the traffic's range, 4/4, 16-bit PCM)
into a work dir under TMPDIR and one song warms the path; the window then
alternates between them.

Correctness, after the window, against the plain float32 reference
(`reference/analysis.py`), computed once per song rendered:
  * the hFT's note maps as they leave the device (the onset, offset and
    frame sigmoids of every frame, captured at `AMTAPC_Extractor.
    _transcript`'s return) against the reference's maps from the samples;
  * `extract.json` against the reference's peak picking of those maps;
  * the Beat-Transformer's activations (captured at `BeatDetector.
    activations`' return) against the reference's, from the samples
    through its own separation;
  * `beat_pred.json` against the reference's DBN decoding of those
    activations.
"""

from __future__ import annotations

import gc
import hashlib
import json
import shutil
import tempfile
import threading
import time
from pathlib import Path
from typing import Dict, List

import numpy as np

from h100_bench.drivers.catalog import seed_sequence
from h100_bench.frozen.counts import beat_transformer_flops, hft_flops, separator_flops
from h100_bench.frozen.render import song_pcm
from h100_bench.harness import Check, note, synchronize
from h100_bench.reference import analysis as ref
from h100_bench.reference.precision import exact_float32
from h100_bench.trace import thread_ids

STAGES = {"_run_stage1_extract": "bench.extract",
          "_run_stage2_structuralize": "bench.structuralize",
          "_run_volume": "bench.volume", "_load_decoder": "bench.decoder_load"}


def abs_diff(got: np.ndarray, want: np.ndarray) -> np.ndarray:
    """|got - want| elementwise; all infinite where the shapes differ."""
    got = np.asarray(got, np.float32)
    if got.shape != want.shape:
        return np.full(1, np.inf, np.float32)
    return np.abs(got - want).ravel()


def diff_stats(diffs: List[np.ndarray]) -> Dict[str, float]:
    """The largest, the 99.9th percentile and the mean of differences."""
    if not diffs:
        return {"max": float("inf"), "q999": float("inf"), "mean": float("inf")}
    d = np.concatenate(diffs)
    return {"max": float(d.max()), "q999": float(np.quantile(d, 0.999)),
            "mean": float(d.mean())}


class Driver:
    def __init__(self, ctx):
        self.ctx = ctx
        self.cfg = ctx.config
        self.traffic = ctx.traffic
        self.pipeline = None
        self._captured: Dict[str, object] = {}
        self._lock = threading.Lock()
        self._restore = []
        self.spans: List[tuple] = []   # (stage, thread ids, start ns, end ns)

    # ---- set-up ------------------------------------------------------------
    def render(self) -> None:
        """Draw and render the run's songs, and write them into a work dir
        under TMPDIR."""
        from scipy.io import wavfile

        t = self.traffic
        rng = np.random.default_rng(seed_sequence(self.ctx.seed, 0))
        self.work = Path(tempfile.mkdtemp(prefix="h100_bench_analysis_"))
        self.songs = []
        for i in range(t["songs"]):
            bpm = float(rng.uniform(*t["bpm_range"]))
            pcm = song_pcm(rng, bpm, t["seconds_per_song"], t["sample_rate"], self.ctx.device)
            path = self.work / f"song_{i}.wav"
            wavfile.write(path, t["sample_rate"], pcm)
            self.songs.append({"path": path, "pcm": pcm, "bpm": bpm})

    def _capture(self, owner, name: str, key: str) -> None:
        """Wrap `owner.name` so that each call's return value is kept under
        `key` for the request in flight."""
        original = getattr(owner, name)

        def wrapper(*args, **kwargs):
            out = original(*args, **kwargs)
            with self._lock:
                self._captured[key] = out
            return out

        setattr(owner, name, wrapper)
        self._restore.append((owner, name, original))

    def setup(self) -> None:
        from etude_tpu_torch.config import load_config
        from etude_tpu_torch.data.beat_detector import BeatDetector
        from etude_tpu_torch.data.extractor import AMTAPC_Extractor
        from etude_tpu_torch.infer import InferencePipeline

        t0 = time.perf_counter()
        self.render()
        note(f"rendered {len(self.songs)} songs in {time.perf_counter() - t0:.3f} s "
             f"(bpm {[round(s['bpm'], 3) for s in self.songs]})")
        root = self.ctx.root
        paths = {k: str(root / v) for k, v in self.cfg["paths"].items()}
        paths["infer_output_dir"] = str(self.work / "out")
        config = load_config(None, {"paths": paths, **self.cfg.get("program_settings", {})})
        self.pipeline = InferencePipeline(config, device=self.ctx.device)
        for method, span in STAGES.items():
            bound = getattr(self.pipeline, method)

            def spanned(*args, _bound=bound, _span=span, **kwargs):
                start = time.time_ns()
                try:
                    return _bound(*args, **kwargs)
                finally:
                    self.spans.append((_span, thread_ids(threading.get_native_id(),
                                                         threading.get_ident()),
                                       start, time.time_ns()))

            setattr(self.pipeline, method, spanned)
        self._capture(AMTAPC_Extractor, "_transcript", "maps")
        self._capture(BeatDetector, "activations", "act")
        t0 = time.perf_counter()
        self.pipeline._run_stages_1_2(self.songs[0]["path"])
        synchronize(self.ctx.device)
        self.spans.clear()
        note(f"warm-up song: {time.perf_counter() - t0:.3f} s")

    # ---- requests ------------------------------------------------------------
    def request(self, index: int) -> dict:
        song = index % len(self.songs)
        self._captured.clear()
        t0 = time.perf_counter()
        self.pipeline._run_stages_1_2(self.songs[song]["path"])
        seconds = time.perf_counter() - t0
        work = self.pipeline.work_dir
        record = {"attempted": 1, "failed": 0, "seconds": seconds, "song": song,
                  "summary": f"song {song}",
                  "audio_s": len(self.songs[song]["pcm"]) / self.traffic["sample_rate"],
                  "maps": self._captured.get("maps"), "act": self._captured.get("act")}
        try:
            with open(work / "extract.json", encoding="utf-8") as f:
                record["notes"] = json.load(f)
            with open(work / "beat_pred.json", encoding="utf-8") as f:
                record["beats"] = json.load(f)
        except (OSError, ValueError):
            record["failed"] = 1
        if record["maps"] is None or record["act"] is None:
            record["failed"] = 1
        return record

    def release(self) -> None:
        for owner, name, original in reversed(self._restore):
            setattr(owner, name, original)
        self._restore.clear()
        self.pipeline = None
        shutil.rmtree(self.work, ignore_errors=True)
        gc.collect()

    # ---- what the metrics read -------------------------------------------------
    def audio_seconds(self, records: List[dict]) -> float:
        return float(sum(r["audio_s"] for r in records))

    def _frames(self, record: dict):
        """(hFT segments, separation frames) of a request's song."""
        h, s = self.cfg["hft"], self.cfg["separator"]
        n = len(self.songs[record["song"]]["pcm"])
        n16 = -(-n * h["sample_rate"] // self.traffic["sample_rate"])
        segments = -(-(n16 // h["hop"] + 1) // h["num_frame"])
        return segments, 1 + n // s["hop"]

    def beat_frames(self) -> int:
        """The frames the beat model runs on: the song's, padded to its
        bucket."""
        _, frames = self._frames({"song": 0})
        bucket = self.cfg["beat_model"]["frame_bucket"]
        return -(-frames // bucket) * bucket

    def song_flops(self, record: dict) -> int:
        """The three forwards' FLOPs for a song, at the sizes the song needs."""
        segments, frames = self._frames(record)
        return hft_flops(segments) + separator_flops(frames) + beat_transformer_flops(frames)

    # ---- correctness ---------------------------------------------------------------
    def check(self, records: List[dict]) -> List[Check]:
        import scipy.signal
        import torch

        spec, cfg = self.traffic["check"], self.cfg
        dev = self.ctx.device
        t0 = time.perf_counter()
        hft_s, sep_s, beat_s = ref.settings(cfg)
        root = self.ctx.root
        expected = {}
        with exact_float32(), torch.no_grad():
            for song in sorted({r["song"] for r in records if not r["failed"]}):
                wave = self.songs[song]["pcm"].astype(np.float64) / 32768.0
                p = ref.load_params(root / cfg["paths"]["extractor_model"] / "params.npz", dev)
                maps = ref.hft_maps(scipy.signal.resample_poly(wave, 160, 441), p, hft_s, dev)
                p = ref.load_params(root / cfg["paths"]["separator_model"] / "params.npz", dev)
                feats = ref.separation_features(wave, p, sep_s, dev)
                p = ref.load_params(root / cfg["paths"]["beat_detector_model"] / "params.npz",
                                    dev)
                act = ref.beat_activations(feats, p, beat_s)
                expected[song] = (maps, act)
                del p, feats
        if torch.cuda.is_available():
            torch.cuda.empty_cache()
        t_models = time.perf_counter() - t0

        maps_diffs, act_diffs = [], []
        notes_wrong = beats_wrong = 0
        beats_of: Dict[str, dict] = {}
        pick = cfg["peak_picking"]
        dbn = cfg["dbn"]
        for r in records:
            if r["failed"]:
                continue
            maps, act = expected[r["song"]]
            for head in ("onset", "offset", "mpe"):
                maps_diffs.append(abs_diff(r["maps"][f"{head}_time"], maps[head]))
            notes = ref.maps_to_notes(
                r["maps"]["onset_time"], r["maps"]["offset_time"], r["maps"]["mpe_time"],
                r["maps"]["velocity_time"], hop_sec=pick["hop_seconds"],
                note_min=pick["note_min"], thred_onset=pick["onset_threshold"],
                thred_offset=pick["offset_threshold"], thred_mpe=pick["frame_threshold"],
                min_duration=pick["min_duration"])
            notes_wrong += notes != r["notes"]
            got_act = np.asarray(r["act"], np.float32)
            act_diffs.append(abs_diff(got_act, act))
            key = hashlib.sha256(got_act.tobytes()).hexdigest()
            if key not in beats_of:
                beats_of[key] = ref.beats_from_activations(
                    got_act, fps=dbn["fps"], min_bpm=dbn["min_bpm"], max_bpm=dbn["max_bpm"],
                    threshold=dbn["threshold"], beats_per_bar=dbn["beats_per_bar"])
            beats_wrong += beats_of[key] != r["beats"]
        self.diagnostics = {"hft_maps": diff_stats(maps_diffs), "beat_act": diff_stats(act_diffs)}
        note(f"reference: {len(expected)} songs through the models in {t_models:.3f} s, "
             f"{len(records)} songs' outputs judged in {time.perf_counter() - t0:.3f} s")
        d = self.diagnostics
        return [Check("hft_maps_q999_abs_diff", d["hft_maps"]["q999"],
                      spec["hft_maps_q999_abs_diff"]),
                Check("beat_act_q999_abs_diff", d["beat_act"]["q999"],
                      spec["beat_act_q999_abs_diff"]),
                Check("notes_not_rederived", float(notes_wrong), 0.0),
                Check("beats_not_rederived", float(beats_wrong), 0.0)]
