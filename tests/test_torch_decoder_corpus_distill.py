"""The port's distillation-corpus builder
(etude_tpu_torch/scripts/distill_dataset.py) against the JAX script
(scripts/distill_dataset.py, imported through `sys.path`), on the CPU, on a
synthetic corpus (etude_tpu_torch/tools/synthetic_corpus.py), and the
corpus writer's own contract.

Tolerances:
- `--grid rgc` with `--transpose 1 --phase-shifts 1 --double-time`:
  `vocab.json` and every `NNNN_{src,tgt}.npy` bit-equal (numpy only).
- The tracker grid: `TrackerGrid.estimate` with the committed separator and
  Beat-Transformer (read through orbax, the JAX side's forwards held to f32
  as in tests/test_torch_corpus_validate.py) on a song whose grid the
  tracker finds: the same number of regions, the same time signatures and
  downbeat counts, downbeats within DOWNBEAT_ATOL (a tenth of a 23 ms
  activation frame; measured: equal), and the same grid picked. Then the
  port's `--grid tracker` run on the JAX run's `tempo/` cache is bit-equal
  to the JAX run.
- The helpers (`arbitrate_grid`, `_refine_region`, `_dephase`, the grid
  variants, `_transpose_notes`) return what the JAX functions return, on
  the committed `dataset_distill/tempo/*.json` grids and synthetic notes.
"""

import hashlib
import json
import shutil
import sys
from pathlib import Path

import numpy as np
import pytest

from etude_tpu_torch.scripts import distill_dataset as dd
from etude_tpu_torch.tools import synthetic_corpus
from etude_tpu_torch.utils.midi import read_midi_notes

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO / "scripts"))

import distill_dataset as jdd  # noqa: E402

DOWNBEAT_ATOL = 2.3e-3
AUGMENT = ["--transpose", "1", "--phase-shifts", "1", "--double-time"]
# tools/synthetic_corpus.py's files at its defaults (6 songs of 20-30 s,
# seed 0), as the parent commit of the decoder-corpus slice wrote them:
# the sha256 over each file's name and sha256, in name order.
PARENT_CORPUS_SHA256 = "b71cc8e61c95b89d8ab319975e7bcab7e2010b565585fcffadcde0ca7d7b3507"
PARENT_FILES = [f"CPOP0{i}/{v}.mid" for i in range(1, 7)
                for v in ("etude_d", "etude_d_d", "human", "music2midi")] + ["songs.json"]
COMMITTED_GRIDS = sorted((REPO / "dataset_distill" / "tempo").glob("*.json"))[:12]


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = tmp_path_factory.mktemp("songs")
    synthetic_corpus.write_corpus(root, n_songs=4, seconds=(20.0, 25.0), seed=0)
    return root


def _tree_equal(a: Path, b: Path):
    files_a = sorted(p.relative_to(a) for p in a.rglob("*") if p.is_file())
    files_b = sorted(p.relative_to(b) for p in b.rglob("*") if p.is_file())
    assert files_a == files_b
    for rel in files_a:
        assert (a / rel).read_bytes() == (b / rel).read_bytes(), rel
    return files_a


# ------------------------------------------------------------ the corpus
def test_synthetic_corpus_keeps_the_parents_files(tmp_path):
    assert synthetic_corpus.main(["--out", str(tmp_path), "--seed", "0"]) == 0
    digest = hashlib.sha256()
    for rel in sorted(PARENT_FILES):
        digest.update(rel.encode())
        digest.update(hashlib.sha256((tmp_path / rel).read_bytes()).digest())
    assert digest.hexdigest() == PARENT_CORPUS_SHA256


def test_synthetic_corpus_decoder_side(tmp_path):
    """etude_e on the song's grid, the reference's metadata.json, and a
    wp.json whose human entry is the diagonal the aligner's cache reads."""
    from etude_tpu_torch.data.aligner import AudioAligner

    dirs = synthetic_corpus.write_corpus(tmp_path, n_songs=3, seconds=(20.0, 22.0), seed=3)
    assert json.loads((tmp_path / "metadata.json").read_text()) == [
        {"dir_name": d.name} for d in dirs]
    meta = json.loads((tmp_path / "songs.json").read_text())
    for d in dirs:
        notes = read_midi_notes(d / "etude_e.mid")
        eighth = meta[d.name]["eighth_s"]
        assert len(notes) >= 32
        # On the grid, up to the MIDI file's tick (under 0.5 ms).
        onsets = np.array([n["onset"] for n in notes]) - synthetic_corpus.LEAD_SECONDS
        np.testing.assert_allclose(onsets, eighth * np.round(onsets / eighth), atol=5e-4)
        assert notes != read_midi_notes(d / "etude_d.mid")
        entry = AudioAligner(device="cpu")._load_from_cache(d, "human")
        n = int(round(meta[d.name]["seconds"] * 50))
        assert entry["num_frames_cover"] == entry["num_frames_origin"] == n
        np.testing.assert_array_equal(entry["wp"], np.stack([np.arange(n)] * 2))
        assert entry["pitch_shift"] == 0


# ------------------------------------------------------------ the helpers
def test_arbitrate_grid_matches_jax():
    grid = [{"time_sig": 4, "bpm": 120.0, "start": 0.5, "downbeats": [0.5, 2.5]}]
    rgc = [{"time_sig": 4, "bpm": 100.0, "start": 0.4, "downbeats": [0.4]}]
    cases = [(grid, 0.01, rgc, 0.008), (grid, 0.02, rgc, 0.005), (grid, np.inf, rgc, np.inf),
             (grid, None, rgc, 0.01), ([], 0.0, rgc, 0.01), (grid, 0.014, rgc, 0.001)]
    for case in cases:
        assert dd.arbitrate_grid(*case) == jdd.arbitrate_grid(*case)
    assert dd.arbitrate_grid(grid, np.inf, rgc, np.inf) == (rgc, "rgc")
    assert dd.arbitrate_grid(grid, 0.01, rgc, 0.008) == (grid, "tracker")


@pytest.mark.parametrize("path", COMMITTED_GRIDS, ids=lambda p: p.stem)
def test_grid_helpers_match_jax_on_committed_grids(path):
    tempo = json.loads(path.read_text())["tempo"]
    assert tempo
    for region in tempo:
        noisy = dict(region, downbeats=list(np.asarray(region["downbeats"])
                                            + np.resize([0.01, -0.012, 0.004], len(
                                                region["downbeats"]))))
        assert dd.TrackerGrid._refine_region(noisy) == jdd.TrackerGrid._refine_region(noisy)
        assert dd.TrackerGrid._refine_region(region) == jdd.TrackerGrid._refine_region(region)
    for k in (1, 2, 3):
        assert dd._phase_shift_tempo(tempo, k) == jdd._phase_shift_tempo(tempo, k)
    assert dd._double_time_tempo(tempo) == jdd._double_time_tempo(tempo)
    # Notes on the first region's slots moved by less than half a slot:
    # _dephase moves that region onto them (and the whole grid as JAX does).
    first = tempo[:1]
    slots = dd.grid_slot_times(first, horizon=60.0)[::3][:200]
    spacing = 60.0 / first[0]["bpm"] / 8
    for bias in (-0.3 * spacing, 0.2 * spacing):
        notes = [{"onset": float(t + bias), "offset": float(t + bias + 0.2), "pitch": 60,
                  "velocity": 80} for t in slots]
        ours = dd.TrackerGrid._dephase(first, notes)
        assert ours == jdd.TrackerGrid._dephase(first, notes)
        moved = ours[0]["downbeats"][0] - first[0]["downbeats"][0]
        assert moved == pytest.approx(bias, abs=1e-6)
        assert dd.TrackerGrid._dephase(tempo, notes) == jdd.TrackerGrid._dephase(tempo, notes)


def test_refine_region_short_or_reversed_region_is_kept():
    for region in ({"time_sig": 3, "bpm": 90.0, "start": 1.0, "downbeats": [1.0, 3.0]},
                   {"time_sig": 4, "bpm": 90.0, "start": 5.0, "downbeats": [5.0, 4.0, 3.0]}):
        assert dd.TrackerGrid._refine_region(region) is region
        assert jdd.TrackerGrid._refine_region(region) is region


def test_transpose_and_grid_helpers_on_synthetic_notes(corpus):
    notes = read_midi_notes(corpus / "CPOP02" / "etude_d.mid")
    for shift in (0, 1, -1, 30, -30):
        assert dd._transpose_notes(notes, shift) == jdd._transpose_notes(notes, shift)
    assert dd._transpose_notes(notes, 0) is notes
    assert len(dd._transpose_notes(notes, 30)) < len(notes)
    tempo = dd.estimate_tempo_grid(notes)
    assert tempo == jdd.estimate_tempo_grid(notes)
    assert dd.grid_fit_score(notes, tempo) == jdd.grid_fit_score(notes, tempo) < 1e-3
    # Exact by construction: the same slots (from the shifted first
    # downbeat on), so the same snap, up to the grid's bpm rounded to 4
    # decimals (a microsecond here).
    shifted = dd._phase_shift_tempo(tempo, 1)
    later = [n for n in notes if n["onset"] >= shifted[0]["downbeats"][0]]
    for variant, part in ((dd._double_time_tempo(tempo), notes), (shifted, later)):
        assert dd.grid_fit_score(part, variant) == pytest.approx(
            dd.grid_fit_score(part, tempo), abs=1e-6)


# ------------------------------------------------------------ --grid rgc
def test_rgc_grid_with_augmentations_equals_jax(tmp_path, corpus):
    argv = ["--corpus", str(corpus), "--grid", "rgc", *AUGMENT]
    assert dd.main([*argv, "--out", str(tmp_path / "port"), "--device", "cpu"]) == 0
    assert jdd.main([*argv, "--out", str(tmp_path / "jax")]) == 0
    files = _tree_equal(tmp_path / "port", tmp_path / "jax")
    # 4 songs x (1 + 2 transpositions) x (grid, one phase shift, double time)
    assert sum(1 for f in files if f.name.endswith("_src.npy")) == 4 * 3 * 3
    assert Path("vocab.json") in files
    assert not (tmp_path / "port" / "distill_grid.wav").exists()


# ------------------------------------------------------------ --grid tracker
@pytest.fixture(scope="module")
def tracker_runs(tmp_path_factory, corpus):
    """The JAX script in tracker mode on the first song with the committed
    separator and beat model in f32 (its `TrackerGrid._stack` set, and its
    render path inside the run's directory); the port's TrackerGrid on the
    same song with the same weights; the port CLI on the JAX run's cache."""
    import functools

    import jax.numpy as jnp

    import etude_tpu.data.beat_detector as jax_bd
    import etude_tpu.data.separation as jax_sep
    from etude_tpu.config.schema import BeatDetectorConfig as JaxBeatDetectorConfig
    from etude_tpu.data.beat_analyzer import BeatAnalyzer as JaxBeatAnalyzer
    from etude_tpu.models import beat_transformer as jbt
    from etude_tpu.models import separator as jsep
    from etude_tpu_torch.config import BeatDetectorConfig
    from etude_tpu_torch.data.beat_analyzer import BeatAnalyzer
    from etude_tpu_torch.data.beat_detector import BeatDetector
    from etude_tpu_torch.data.separation import SourceSeparator
    from test_torch_corpus_validate import _committed

    tmp = tmp_path_factory.mktemp("tracker")
    separator_params, beat_params = _committed(jsep, "separator"), _committed(jbt, "beat_detector")
    mp = pytest.MonkeyPatch()
    mp.setattr(jax_sep, "forward", functools.partial(jsep.forward, compute_dtype=jnp.float32))
    mp.setattr(jax_bd, "forward", functools.partial(jbt.forward, compute_dtype=jnp.float32))
    caches = (jax_sep._separate_mel_jit, jax_bd._beat_activations_jit)
    for jitted in caches:
        jitted.clear_cache()
    jax_stack = (jax_sep.SourceSeparator(params=separator_params),
                 jax_bd.BeatDetector(JaxBeatDetectorConfig(), params=beat_params),
                 JaxBeatAnalyzer())
    estimate = jdd.TrackerGrid.estimate

    def jax_estimate(self, notes, work_wav):
        self._stack = jax_stack
        return estimate(self, notes, tmp / "jax_grid.wav")

    mp.setattr(jdd.TrackerGrid, "estimate", jax_estimate)
    try:
        argv = ["--corpus", str(corpus), "--grid", "tracker", "--limit", "1", *AUGMENT]
        assert jdd.main([*argv, "--out", str(tmp / "jax")]) == 0
    finally:
        mp.undo()
        for jitted in caches:
            jitted.clear_cache()

    tracker = dd.TrackerGrid(None, None, "cpu")
    tracker._stack = (SourceSeparator(params=separator_params, device="cpu"),
                      BeatDetector(BeatDetectorConfig(), params=beat_params, device="cpu"),
                      BeatAnalyzer())
    notes = read_midi_notes(corpus / "CPOP01" / "etude_d.mid")
    ours = tracker.estimate(notes, tmp / "port_grid.wav")
    shutil.copytree(tmp / "jax" / "tempo", tmp / "port" / "tempo")
    assert dd.main([*argv, "--out", str(tmp / "port"), "--device", "cpu"]) == 0
    return tmp, notes, ours


def test_tracker_grid_matches_jax(tracker_runs):
    tmp, notes, ours = tracker_runs
    cached = json.loads((tmp / "jax" / "tempo" / "CPOP01.json").read_text())
    ref = cached["tempo"]
    assert ref, "the tracker found no grid on the song"
    assert len(ours) == len(ref)
    for a, b in zip(ours, ref):
        assert a["time_sig"] == b["time_sig"]
        assert len(a["downbeats"]) == len(b["downbeats"]) >= 3
        np.testing.assert_allclose(a["downbeats"], b["downbeats"], atol=DOWNBEAT_ATOL, rtol=0)
        assert a["bpm"] == pytest.approx(b["bpm"], rel=1e-4)
    score = dd.grid_fit_score(notes, ours)
    assert score == pytest.approx(cached["score"], abs=DOWNBEAT_ATOL)
    rgc = dd.estimate_tempo_grid(notes)
    rgc_score = dd.grid_fit_score(notes, rgc)
    assert (dd.arbitrate_grid(ours, score, rgc, rgc_score)[1]
            == jdd.arbitrate_grid(ref, cached["score"], rgc, rgc_score)[1])


def test_tracker_run_on_the_jax_cache_equals_jax(tracker_runs):
    tmp, _, _ = tracker_runs
    files = _tree_equal(tmp / "port", tmp / "jax")
    assert Path("tempo/CPOP01.json") in files and Path("tokenized/0009/0009_tgt.npy") in files
